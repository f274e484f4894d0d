"""The nine baselines of Tables 1-2: the port's ``federated.baselines``
against the JAX reference's on the same numpy inputs.

Width slicing is held through the bridge's permutation: the reference
slices HWIO conv leaves on axes (2, 3), the port OIHW leaves on axes
(1, 0), so a slice converted back must equal the reference's to the bit,
and an axis mix-up cannot pass.  One ``round()`` of each baseline starts
both sides from the reference's params (and heads) through the bridge, on
``cnn_setup``-sized models (ResNet18 at width 0.125, 4 classes, at 16x16; plus
SqueezeNet for the approximate fire-module slice): the same candidates
and cohort, and params within 1e-3 of the largest update (the round rule
of ``test_torch_round.py``); FedRolex also at round 1, where its window
has rolled.  Then one ``evaluate()`` per baseline class,
with the same accuracy.
"""
import jax
import numpy as np
import pytest
import torch

import repro.federated.baselines as rb
import repro_torch.federated.baselines as tb
from repro.data import Batcher as RBatcher
from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.server import FLConfig as RFLConfig
from repro.models.cnn import CNNConfig as RConfig
from repro_torch import bridge
from repro_torch.data.loader import Batcher as TBatcher
from repro_torch.federated.server import FLConfig as TFLConfig
from repro_torch.models.cnn import CNNConfig as TConfig

TOL = 1e-3
FL = dict(n_devices=20, clients_per_round=5, local_epochs=1, batch_size=16,
          num_stages=4, rounds_per_stage=1, seed=0)
# 16x16, not cnn_setup's 8x8: at 8x8 the last stage's maps are 1x1, so a
# sliced model's GroupNorm takes its variance over one or two values, and
# the reference's HeteroFL round moves by 0.7-1.9e-2 of its update (ProgFed's
# by 3-8e-3) for a 1e-7 relative change of its params; at 16x16 by 1e-6 to
# 9e-5.  At E = 2 SqueezeNet's HeteroFL round moves by 0.11 (E = 1, as in
# Table 1: 8e-5).  SqueezeNet's fire module at 1x1 with one channel a group is exactly
# its GroupNorm bias in the reference and that bias plus the f32 residual of
# PyTorch's fused x * a + b in the port, a kink at ReLU's 0.
SIZE = dict(num_classes=4, image_size=16, width_mult=0.125)
METHODS = list(rb.BASELINES)
# (method, arch, round): FedRolex's window rolls with the round (its
# offset is r, HeteroFL's 0), so it is also held at round 1
CASES = ([(m, "resnet18", 0) for m in METHODS]
         + [("fedrolex", "resnet18", 1), ("heterofl", "squeezenet", 0),
            ("fedrolex", "squeezenet", 0)])
# the reference's steps with the same function share one compile: its full
# step (FedAvg, ExclusiveFL, TiFL, Oort) and its width steps (HeteroFL,
# FedRolex) per arch
_FULL_STEP = ("fedavg", "exclusivefl", "tifl", "oort")
_WIDTH_STEPS = ("heterofl", "fedrolex")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one thread here: the port's side is many small ops, which
    several test processes sharing the cores slow down many times over
    when each runs a pool of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (RConfig(name=arch, arch=arch, **SIZE),
            TConfig(name=arch, arch=arch, **SIZE))


@pytest.fixture(scope="module")
def data():
    ds = make_image_dataset(0, 400, num_classes=4, image_size=16)
    parts = dirichlet_partition(0, ds.labels, FL["n_devices"], alpha=1.0)
    test = make_image_dataset(1, 64, num_classes=4, image_size=16)
    return [ds.subset(p) for p in parts], test


def _to_port(tree):
    return bridge.from_reference(jax.device_get(tree), "cpu")


def _leaves(ref_tree, port_tree):
    r_leaves, r_def = jax.tree.flatten(jax.device_get(ref_tree))
    t_leaves, t_def = jax.tree.flatten(bridge.to_reference(port_tree))
    assert r_def == t_def
    return ([np.asarray(a, np.float64) for a in r_leaves],
            [np.asarray(b, np.float64) for b in t_leaves])


def _state(b):
    """What a round moves: the params, and a depth method's heads."""
    return {"params": b.params, "heads": getattr(b, "heads", None)}


_PAIRS, _REF_STEPS = {}, {}


def _share_reference_steps(ref, method, arch):
    if method in _FULL_STEP:
        ref._full_step = _REF_STEPS.setdefault(("full", arch),
                                               ref.full_step())
    elif method in _WIDTH_STEPS:
        ref._sub_steps = _REF_STEPS.setdefault(("width", arch),
                                               ref._sub_steps)


def _play(ref, port, r):
    """Round ``r`` on both sides: the candidates, the cohort and the round;
    returns them."""
    r_cands, t_cands = ref.candidates(r), port.candidates(r)
    ref.feasible_hist.append(len(r_cands))
    port.feasible_hist.append(len(t_cands))
    r_sel = [int(c) for c in ref.select(r_cands, r)]
    t_sel = [int(c) for c in port.select(t_cands, r)]
    ref.round(r, r_sel)
    port.round(r, t_sel)
    return (r_cands, r_sel), (t_cands, t_sel)


def _pair(method, arch, data, r=0):
    """The reference's and the port's baseline, each after round ``r`` from
    the same state (the port restarted from the reference's state after
    the rounds before); with the cohort, candidates and start state."""
    key = (method, arch, r)
    if key not in _PAIRS:
        clients, test = data
        r_cfg, t_cfg = _cfgs(arch)
        ref = rb.BASELINES[method](r_cfg, clients, RBatcher(test, 16, seed=0),
                                   RFLConfig(**FL))
        _share_reference_steps(ref, method, arch)
        kw = {}
        if hasattr(ref, "heads"):
            kw["heads"] = [_to_port(h) for h in ref.heads]
        port = tb.BASELINES[method](t_cfg, clients, TBatcher(test, 16, seed=0),
                                    TFLConfig(**FL), params=_to_port(ref.params),
                                    device="cpu", **kw)
        for q in range(r):
            _play(ref, port, q)
            port.params = _to_port(ref.params)
            if hasattr(ref, "heads"):
                port.heads = [_to_port(h) for h in ref.heads]
        start = jax.device_get(_state(ref))
        _PAIRS[key] = (ref, port, start) + _play(ref, port, r)
    return _PAIRS[key]


@pytest.mark.parametrize("method,arch,r", CASES)
def test_baseline_round_matches_reference(method, arch, r, data):
    ref, port, start, (r_cands, r_sel), (t_cands, t_sel) = _pair(
        method, arch, data, r)
    assert [int(c) for c in r_cands] == [int(c) for c in t_cands]
    assert r_sel == t_sel and r_sel
    assert ref.full_req == port.full_req
    assert [vars(d) for d in ref.devices] == [vars(d) for d in port.devices]
    r_new, t_new = _leaves(_state(ref), _state(port))
    r_old, _ = _leaves(start, _state(port))
    t_old = [np.asarray(a, np.float64) for a in jax.tree.leaves(start)]
    r_upd = [a - s for a, s in zip(r_new, r_old)]
    t_upd = [b - s for b, s in zip(t_new, t_old)]
    scale = max(np.abs(u).max() for u in r_upd)
    assert scale > 0
    err = max(float(np.abs(a - b).max()) for a, b in zip(r_upd, t_upd))
    assert err <= TOL * scale, (method, arch, err / scale)


@pytest.mark.parametrize("method", METHODS)
def test_baseline_evaluate_matches_reference(method, data):
    ref, port, *_ = _pair(method, "resnet18", data)
    assert port.evaluate() == ref.evaluate()


def test_participation_rates_match(data):
    """Each baseline's participation rate over its first round (candidates
    over the fleet) equals the reference's."""
    for method in METHODS:
        ref, port, *_ = _pair(method, "resnet18", data)
        assert ref.feasible_hist == port.feasible_hist, method


@pytest.mark.parametrize("c,ratio,offset", [
    (8, 1.0, 0), (8, 0.5, 0), (8, 0.25, 3), (16, 0.125, 15), (3, 0.5, 2),
    (64, 0.5, 40), (10, 0.33, 7)])
def test_channel_idx_matches_reference(c, ratio, offset):
    np.testing.assert_array_equal(tb._channel_idx(c, ratio, offset),
                                  rb._channel_idx(c, ratio, offset))


# the reference's HWIO conv axes -> the port's OIHW axes
_CONV_AXES = {2: 1, 3: 0}


@pytest.mark.parametrize("arch", ["resnet18", "squeezenet"])
@pytest.mark.parametrize("ratio,offset", [(0.5, 0), (0.25, 3), (0.125, 1)])
def test_extract_submodel_through_the_bridge(arch, ratio, offset):
    from repro.common import paramdef as RPD
    from repro.models import cnn as rcnn
    r_cfg, _ = _cfgs(arch)
    params = jax.device_get(RPD.init_params(jax.random.PRNGKey(0),
                                            rcnn.cnn_defs(r_cfg)))
    r_sub, r_maps = rb._extract_submodel(params, ratio, offset, 4, 3)
    t_sub, t_maps = tb._extract_submodel(_to_port(params), ratio, offset, 4,
                                         3)
    got, want = _leaves(r_sub, t_sub)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert r_maps.keys() == t_maps.keys()
    n_conv = 0
    for path, r_m in r_maps.items():
        t_m = t_maps[path]
        conv = np.ndim(_leaf_at(params, path)) == 4
        n_conv += conv
        want_axes = [(_CONV_AXES[ax] if conv else ax) for ax, _ in r_m]
        assert [ax for ax, _ in t_m] == want_axes, path
        for (_, a), (_, b) in zip(r_m, t_m, strict=True):
            np.testing.assert_array_equal(a, b)
    assert n_conv > 0


def _leaf_at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_width_scatter_mean_matches_numpy_add_at():
    """The device scatter-average against the reference's float64
    ``np.add.at`` on the same client trees (two clients, two ratios and
    two offsets, so that windows overlap and wrap)."""
    from repro.common import paramdef as RPD
    from repro.models import cnn as rcnn
    r_cfg, _ = _cfgs("squeezenet")
    params = jax.device_get(RPD.init_params(jax.random.PRNGKey(1),
                                            rcnn.cnn_defs(r_cfg)))
    t_params = _to_port(params)
    acc = tb.WidthScatterMean(t_params)
    sums = {p: np.zeros(np.shape(_leaf_at(params, p)), np.float64)
            for p in _paths(params)}
    counts = {p: np.zeros_like(v) for p, v in sums.items()}
    rng = np.random.default_rng(0)
    for ratio, offset in ((0.5, 3), (0.25, 13)):
        r_sub, r_maps = rb._extract_submodel(params, ratio, offset, 4, 3)
        # a trained client: the slice moved by noise
        r_sub = jax.tree.map(
            lambda a: np.asarray(a) + rng.standard_normal(np.shape(a)).astype(
                np.float32), jax.device_get(r_sub))
        _, t_maps = tb._extract_submodel(t_params, ratio, offset, 4, 3)
        acc.add(_to_port(r_sub), t_maps)
        for p in sums:
            arr = np.asarray(_leaf_at(r_sub, p), np.float64)
            idxs = r_maps[p]
            if idxs:
                ix = [slice(None)] * arr.ndim
                for j, (ax, m) in enumerate(idxs):
                    shape = [1] * len(idxs)
                    shape[j] = len(m)
                    ix[ax] = m.reshape(shape)
                np.add.at(sums[p], tuple(ix), arr)
                np.add.at(counts[p], tuple(ix), 1.0)
            else:
                sums[p] += arr
                counts[p] += 1.0
    got = bridge.to_reference(acc.result())
    for p in sums:
        base = np.asarray(_leaf_at(params, p), np.float64)
        want = np.where(counts[p] > 0, sums[p] / np.maximum(counts[p], 1),
                        base).astype(np.float32)
        np.testing.assert_array_equal(_leaf_at(got, p), want)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [q for i, t in enumerate(tree) for q in _paths(
            t, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]
