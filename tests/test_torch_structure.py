"""The PyTorch port stands alone: no JAX, no reference package, and no
silent fall-back from the card to the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax",
                                   "ml_dtypes"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"nhsic.cu", "flash_attention.cu", "slstm_scan.cu"} <= {
        p.name for p in (ROOT / "src" / "repro_torch").rglob("*.cu")}
    assert {"chip_smoke.py", "bridge.py", "server.py", "ops.py",
            "kernels_bench.py", "common.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "benchmarks" / "kernels_bench.py"
            in PORT_FILES)


def test_resolve_device_never_falls_back(monkeypatch):
    from repro_torch.common.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch import bridge
    from repro_torch.core.progressive import make_adapter
    from repro_torch.federated.client import run_local_training
    from repro_torch.models.cnn import CNNConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adapter = make_adapter(CNNConfig(name="r", arch="resnet18",
                                     num_classes=4, image_size=8,
                                     width_mult=0.125), 2)
    with pytest.raises(RuntimeError):
        adapter.init_params(0)
    with pytest.raises(RuntimeError):
        bridge.from_reference({"w": [[1.0]]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local_training(None, None, {}, {}, None, 1)
    from repro_torch.benchmarks import (fig7_time, table1_accuracy,
                                        table2_complexity)
    from repro_torch.federated import baselines as tb
    from repro_torch.federated.server import FLConfig
    flc = FLConfig(n_devices=2, clients_per_round=1, num_stages=2)
    for name in tb.BASELINES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.BASELINES[name](adapter.cfg, [], None, flc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table1_accuracy.run(rounds=1, archs=("resnet18",), width=0.125,
                            image_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table2_complexity.run(rounds=1, width=0.125, image_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig7_time.run(archs=("resnet18",), sizes=((0.125, 8),))
    from repro_torch.examples import federated_heterogeneous
    monkeypatch.delenv("FEDHET_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        federated_heterogeneous.main()
    from repro_torch.benchmarks import (fig2_hsic_plane, fig5_scale_vit,
                                        fig8_ablation)
    from repro_torch.examples import quickstart
    for run in (lambda: fig2_hsic_plane.run(steps=1, width=0.125,
                                            image_size=8),
                lambda: fig5_scale_vit.run(rounds=1, width=0.125,
                                           image_size=8),
                lambda: fig8_ablation.run(rounds=1, width=0.125,
                                          image_size=8),
                lambda: quickstart.main(rounds=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    path = save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(path, {"w": torch.zeros(2)}, device=None)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels.hsic_gram import kernel, ops, ref
    kernel.reset_launches()
    g = torch.Generator().manual_seed(0)
    x, z = torch.randn(8, 3, generator=g), torch.randn(8, 5, generator=g)
    s2 = torch.tensor([1.0, 2.0])
    for a, b in zip(kernel.nhsic_rowsums(x, z, s2),
                    ref.nhsic_rowsums(x, z, s2)):
        assert torch.equal(a, b)
    kx = kernel.gram(x, s2[0])
    assert torch.equal(kx, ref.gram(x, s2[0], False))
    kz = kernel.gram(z, s2[1], linear=True)
    assert torch.equal(kz, ref.gram(z, s2[1], True))
    assert torch.equal(kernel.gram_stats(kx, kz), ref.gram_stats(kx, kz))
    ops.nhsic_unfused(x, z, kernel_z="linear")
    assert kernel.LAUNCHES == {"nhsic_rowsums": 0, "nhsic_stats_feats": 0,
                               "nhsic_grad": 0, "gram": 0, "gram_stats": 0}


def test_a_refused_kernel_launch_raises_and_counts_nothing(monkeypatch):
    """An entry point that returns a CUDA error (a cluster the card cannot
    place, say) makes the wrapper raise; nothing takes the plain version
    or another kernel instead, and the launch is not counted."""
    from repro_torch.kernels.hsic_gram import kernel
    kernel.reset_launches()
    monkeypatch.setattr(kernel, "_lib", object())
    for name in ("nhsic_stats_feats", "nhsic_grad"):
        monkeypatch.setitem(kernel._fns, name, lambda *args: 1)
        with pytest.raises(RuntimeError, match=f"{name}: .*CUDA error 1"):
            kernel._launch(name, 0)
    assert kernel.LAUNCHES["nhsic_stats_feats"] == 0
    assert kernel.LAUNCHES["nhsic_grad"] == 0


def test_flash_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    kernel.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 4, 8, generator=g)
    k = torch.randn(2, 7, 2, 8, generator=g)
    v = torch.randn(2, 7, 2, 8, generator=g)
    assert torch.equal(kernel.flash_attention_fwd(q, k, v, causal=True),
                       ref.attention_ref(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v, causal=False, window=3),
                       ref.attention_ref(q, k, v, causal=False, window=3))
    assert kernel.LAUNCHES == {"flash_attention_fwd": 0}


def test_slstm_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    from repro_torch.kernels.slstm_scan import kernel, ops, ref
    kernel.reset_launches()
    g = torch.Generator().manual_seed(0)
    g_in = torch.randn(2, 5, 4, 2, 3, generator=g)
    r = torch.randn(4, 2, 3, 3, generator=g) * 0.1
    b = torch.randn(4, 2, 3, generator=g)
    st = {k: torch.randn(2, 2, 3, generator=g) for k in "cnmh"}
    hs, fin = ref.slstm_scan_ref(g_in, r, b, st)
    got = kernel.slstm_scan_fwd(g_in, r, b, *st.values())
    assert all(torch.equal(a, w) for a, w in
               zip(got, [hs, fin["c"], fin["n"], fin["m"], fin["h"]]))
    assert torch.equal(ops.slstm_scan(g_in, r, b, st)[0], hs)
    assert kernel.LAUNCHES == {"slstm_scan_fwd": 0, "slstm_scan_bwd": 0}


def test_kernel_inputs_are_checked():
    from repro_torch.common.device import check_kernel_inputs
    with pytest.raises(ValueError, match="CUDA"):
        check_kernel_inputs("k", torch.device("cpu"), x=torch.zeros(2))


def test_unported_model_config_fields_raise():
    from repro_torch.configs.paper_models import vit
    from repro_torch.configs.xlstm_1_3b import config as xlstm_1_3b
    from repro_torch.models.config import (ModelConfig, XLSTMConfig,
                                           xlstm_pattern)
    base = dict(name="t", family="dense", num_layers=2, d_model=16,
                num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=8)
    ModelConfig(**base)
    vit()
    xlstm_1_3b()
    # mlstm/slstm construct with an XLSTMConfig; mamba still raises
    ModelConfig(**{**base, "num_layers": 8}, pattern=xlstm_pattern(),
                xlstm=XLSTMConfig())
    with pytest.raises(ValueError, match="not yet ported.*mamba"):
        ModelConfig(**base, pattern=(("mamba", "none"), ("slstm", "none")),
                    xlstm=XLSTMConfig())
    for kw, what in [({"attn_impl": "mla"}, "MLA"),
                     ({"mla": object()}, "MLA"),
                     ({"moe": object()}, "MoE"),
                     ({"pattern": (("attn", "moe"),)}, "MoE"),
                     ({"pattern": (("mamba", "mlp"),)}, "mamba"),
                     ({"pattern": (("mlstm", "none"),)}, "mlstm"),
                     ({"pattern": (("slstm", "none"),)}, "slstm"),
                     ({"modality": "audio"}, "audio"),
                     ({"modality": "vlm"}, "vlm"),
                     ({"qk_norm": True}, "qk-norm")]:
        with pytest.raises(ValueError, match=f"not yet ported.*{what}"):
            ModelConfig(**base, **kw)


def test_unported_archs_and_runtimes_raise():
    from repro_torch.federated.runtime import make_runtime
    from repro_torch.federated.selection import make_policy
    from repro_torch.models.cnn import CNNConfig, build_units
    with pytest.raises(ValueError, match="alexnet"):
        build_units(CNNConfig(name="a", arch="alexnet"))
    for name in ("sharded", "async"):
        with pytest.raises(ValueError, match="not yet ported.*sequential"):
            make_runtime(name, None, None, None, torch.device("cpu"))
    # every policy of the reference is ported: an unknown name raises and
    # lists all three
    with pytest.raises(ValueError,
                       match=r"unknown selection policy 'fedprox'.*"
                             r"\['oort', 'random', 'tifl'\]"):
        make_policy("fedprox")
