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
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"nhsic.cu"} <= {p.name for p in
                            (ROOT / "src" / "repro_torch").rglob("*.cu")}
    assert {"chip_smoke.py", "bridge.py", "server.py", "ops.py"} <= names


def test_resolve_device_never_falls_back(monkeypatch):
    from repro_torch.common.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
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


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels.hsic_gram import kernel, ref
    kernel.reset_launches()
    g = torch.Generator().manual_seed(0)
    x, z = torch.randn(8, 3, generator=g), torch.randn(8, 5, generator=g)
    s2 = torch.tensor([1.0, 2.0])
    for a, b in zip(kernel.nhsic_rowsums(x, z, s2),
                    ref.nhsic_rowsums(x, z, s2)):
        assert torch.equal(a, b)
    assert kernel.LAUNCHES == {"nhsic_rowsums": 0, "nhsic_stats_feats": 0,
                               "nhsic_grad": 0}


def test_kernel_inputs_are_checked():
    from repro_torch.common.device import check_kernel_inputs
    with pytest.raises(ValueError, match="CUDA"):
        check_kernel_inputs("k", torch.device("cpu"), x=torch.zeros(2))


def test_unported_archs_and_runtimes_raise():
    from repro_torch.federated.runtime import make_runtime
    from repro_torch.federated.selection import make_policy
    from repro_torch.models.cnn import CNNConfig, build_units
    with pytest.raises(ValueError, match="not ported"):
        build_units(CNNConfig(name="v", arch="vgg11"))
    with pytest.raises(ValueError, match="sequential"):
        make_runtime("vectorized", None, None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="random"):
        make_policy("oort")
