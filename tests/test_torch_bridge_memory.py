"""Params cross the bridge exactly, and the port's memory model gives the
reference's byte counts, as integers (the fleet's budgets and the cohort
draw depend on them)."""
import jax
import numpy as np
import pytest

from repro.core import make_adapter as r_make_adapter
from repro.core import memory as r_mem
from repro.models.cnn import CNNConfig as RConfig
from repro_torch import bridge
from repro_torch.common import paramdef as t_pd
from repro_torch.common.tree import tree_leaves
from repro_torch.core import memory as t_mem
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.models.cnn import CNNConfig as TConfig


def test_bridge_round_trip_is_exact(cnn_setup):
    _, params, _ = cnn_setup
    ref_np = jax.device_get(params)
    port = bridge.from_reference(ref_np, "cpu")
    # conv weights are OIHW in the port
    w = port["model"]["units"][0]["conv"]["w"]
    assert tuple(w.shape) == np.asarray(
        ref_np["model"]["units"][0]["conv"]["w"]).shape[::-1][:2] + (3, 3)
    back = bridge.to_reference(port)
    ref_leaves, ref_def = jax.tree.flatten(ref_np)
    back_leaves, back_def = jax.tree.flatten(back)
    assert ref_def == back_def
    for a, b in zip(ref_leaves, back_leaves, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _adapters(width, image, classes, stages):
    kw = dict(name="r18", arch="resnet18", num_classes=classes,
              image_size=image, width_mult=width)
    return (r_make_adapter(RConfig(**kw), stages),
            t_make_adapter(TConfig(**kw), stages))


@pytest.mark.parametrize("width,image,classes,stages,batch", [
    (1.0, 32, 10, 4, 32),       # the paper's ResNet18, main-path cell
    (0.125, 8, 4, 2, 16),       # cnn_setup
])
def test_memory_model_identical(width, image, classes, stages, batch):
    ra, ta = _adapters(width, image, classes, stages)
    from repro.common import paramdef as r_pd
    assert r_pd.nbytes(ra.defs) == t_pd.nbytes(ta.defs)
    assert r_pd.nparams(ra.defs) == t_pd.nparams(ta.defs)
    for t in range(stages):
        r_est = r_mem.estimate_stage_memory(ra, t, batch)
        t_est = t_mem.estimate_stage_memory(ta, t, batch)
        assert (r_est.params_bytes, r_est.grads_bytes, r_est.opt_bytes,
                r_est.act_bytes) == (t_est.params_bytes, t_est.grads_bytes,
                                     t_est.opt_bytes, t_est.act_bytes)
        assert r_est.total == t_est.total
    assert (r_mem.estimate_full_memory(ra, batch).total
            == t_mem.estimate_full_memory(ta, batch).total)


def test_port_init_matches_defs_and_seed():
    _, ta = _adapters(0.125, 8, 4, 2)
    p0 = ta.init_params(0, "cpu")
    p1 = ta.init_params(0, "cpu")
    leaves0 = tree_leaves(p0)
    assert sum(t.numel() * t.element_size() for t in leaves0) \
        == t_pd.nbytes(ta.defs)
    for a, b in zip(leaves0, tree_leaves(p1), strict=True):
        assert a.equal(b)
    gn = p0["model"]["units"][0]["gn"]
    assert gn["scale"].eq(1).all() and gn["bias"].eq(0).all()


def _assert_round_trip(ref_np):
    port = bridge.from_reference(ref_np, "cpu")
    back = bridge.to_reference(port)
    ref_leaves, ref_def = jax.tree.flatten(ref_np)
    back_leaves, back_def = jax.tree.flatten(back)
    assert ref_def == back_def
    for a, b in zip(ref_leaves, back_leaves, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return port


def test_bridge_keeps_transformer_layouts(tx_setup):
    """The stacked 4-D attention weights cross unchanged (only CNN conv
    weights are permuted), on tx_setup and on the shrunk ViT."""
    from repro.configs.paper_models import vit
    _, params, _ = tx_setup
    vit_params = r_make_adapter(vit(num_classes=10, image_size=32,
                                    num_layers=6, d_model=48), 3) \
        .init_params(jax.random.PRNGKey(0))
    for ref_params in (params, vit_params):
        ref_np = jax.device_get(ref_params)
        port = _assert_round_trip(ref_np)
        mixer = ref_np["model"]["layers"]["sub0"]["mixer"]
        for k in ("wq", "wk", "wv", "wo"):
            assert mixer[k].ndim == 4
            np.testing.assert_array_equal(
                port["model"]["layers"]["sub0"]["mixer"][k].numpy(),
                mixer[k])


def _tx_adapters(which, stages):
    from repro.configs.paper_models import vit as r_vit
    from repro.models.config import ModelConfig as RModelConfig
    from repro_torch.configs.paper_models import vit as t_vit
    from repro_torch.models.config import ModelConfig as TModelConfig
    if which == "vit12":
        return r_make_adapter(r_vit(), stages), t_make_adapter(t_vit(), stages)
    kw = dict(name="t", family="dense", num_layers=4, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
              dtype="float32")                   # conftest's tx_setup
    return (r_make_adapter(RModelConfig(**kw), stages),
            t_make_adapter(TModelConfig(**kw), stages))


@pytest.mark.parametrize("which,stages,batch,seq", [
    ("vit12", 3, 32, 0),        # the paper's ViT-12, image data: seq 0
    ("vit12", 3, 32, 8),
    ("tx_setup", 2, 8, 0),
    ("tx_setup", 2, 8, 8),      # tx_setup's token windows: seq 8
])
def test_transformer_memory_model_identical(which, stages, batch, seq):
    from repro.common import paramdef as r_pd
    ra, ta = _tx_adapters(which, stages)
    assert r_pd.nbytes(ra.defs) == t_pd.nbytes(ta.defs)
    assert r_pd.nparams(ra.defs) == t_pd.nparams(ta.defs)
    for t in range(stages):
        r_est = r_mem.estimate_stage_memory(ra, t, batch, seq)
        t_est = t_mem.estimate_stage_memory(ta, t, batch, seq)
        assert (r_est.params_bytes, r_est.grads_bytes, r_est.opt_bytes,
                r_est.act_bytes) == (t_est.params_bytes, t_est.grads_bytes,
                                     t_est.opt_bytes, t_est.act_bytes)
        # the reference charges a transformer no activations at seq 0
        assert (t_est.act_bytes == 0) == (seq == 0)
    r_full = r_mem.estimate_full_memory(ra, batch, seq)
    t_full = t_mem.estimate_full_memory(ta, batch, seq)
    assert (r_full.total, r_full.act_bytes) == (t_full.total,
                                                t_full.act_bytes)


def test_server_passes_sequence_length_to_memory_model(tx_setup):
    """Text data: the fleet and every stage requirement use seq =
    tokens.shape[1] - 1, as the reference's server does."""
    from repro.data import make_lm_dataset
    from repro.federated.server import FLConfig as RFLConfig
    from repro.federated.server import NeuLiteServer as RServer
    from repro_torch.federated.server import FLConfig as TFLConfig
    from repro_torch.federated.server import NeuLiteServer as TServer
    ra, ta = _tx_adapters("tx_setup", 2)
    ds = make_lm_dataset(0, 96, 8, 64)
    idx = np.arange(len(ds))
    clients = [ds.subset(idx[i::3]) for i in range(3)]
    fl = dict(n_devices=10, clients_per_round=2, batch_size=8, seed=0)
    ref = RServer(ra, clients, RFLConfig(**fl), data_kind="lm")
    port = TServer(ta, clients, TFLConfig(**fl), data_kind="lm",
                   params=ta.init_params(0, "cpu"), device="cpu")
    assert port._seq_len() == ref._seq_len() == 8
    for t in range(2):
        assert port.stage_mem_requirement(t) == ref.stage_mem_requirement(t)
        assert port.stage_mem_requirement(t) > \
            t_mem.estimate_stage_memory(ta, t, 8).total
    assert [vars(port.fleet.profile(i)) for i in range(10)] == \
        [vars(ref.fleet.profile(i)) for i in range(10)]
