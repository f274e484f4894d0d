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
