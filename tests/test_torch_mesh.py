"""The port's mesh layout and sharding policy (``repro_torch.launch``)
against the JAX reference's (``repro.launch.mesh`` / ``repro.launch.
sharding``).

``host_mesh_shape`` against the reference's ``make_host_mesh`` for 1-8
devices and requests 1-9 (the reference's ``jax`` replaced in its module by
a stand-in that reports n devices and returns the shape asked for); every
leaf's logical ``spec`` against the reference's ``spec_tree`` on the
paper's models and xlstm-1.3b (a conv weight permuted: HWIO there, OIHW
here); ``fit_spec``, ``batch_spec`` and the stacked placements against the
reference's on (data, model) meshes (1,1), (2,1), (2,2), (4,2), (1,4) and
a (pod, data, model) mesh (the reference's ``fit_spec`` reads only
``axis_names`` and ``shape``, so a namespace serves both);
``per_device_nbytes`` against the shard shapes the reference's specs
give; ``pad_cohorts`` against the reference's; the contradicting-mesh
refusal with the reference's message; and ``fl_round_throughput``'s
sharded row and its ``--model-parallel 2`` mode (a spawned world of 4).
"""
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import paramdef as RPD
from repro.common.tree import map_with_path as r_map_with_path
from repro.configs import paper_models as rpm
from repro.configs import xlstm_1_3b as rx
from repro.core import make_adapter as r_make_adapter
from repro.federated import runtime as rrt
from repro.launch import mesh as rmesh
from repro.launch import sharding as rsh
from repro_torch import bridge
from repro_torch.common.tree import flatten_paths
from repro_torch.configs import paper_models as tpm
from repro_torch.configs import xlstm_1_3b as tx
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.data.loader import RoundStack
from repro_torch.federated import runtime as trt
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import host_mesh_shape

AXES = ("data", "model")
MESHES = [(1, 1), (2, 1), (2, 2), (4, 2), (1, 4)]
POD = SimpleNamespace(axis_names=("pod", "data", "model"),
                      shape={"pod": 2, "data": 2, "model": 4})


def _mesh(d, m):
    return SimpleNamespace(axis_names=AXES, shape={"data": d, "model": m})


@pytest.mark.parametrize("n", range(1, 9))
def test_host_mesh_shape_matches_reference(n, monkeypatch):
    monkeypatch.setattr(rmesh, "jax", SimpleNamespace(
        devices=lambda: list(range(n)),
        make_mesh=lambda shape, axes: (tuple(shape), tuple(axes))))
    for req in range(1, 10):
        with warnings.catch_warnings(record=True) as r_warn:
            warnings.simplefilter("always")
            shape, axes = rmesh.make_host_mesh(req)
        with warnings.catch_warnings(record=True) as t_warn:
            warnings.simplefilter("always")
            assert host_mesh_shape(n, req) == shape, (n, req)
        assert axes == AXES
        assert len(t_warn) == len(r_warn), (n, req)


def _conv_flags(defs):
    """{path: whether the leaf is a CNN conv weight} of a port tree."""
    flags = bridge._map_with_conv(lambda leaf, conv: conv, defs)
    return flatten_paths(flags)


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _to_port(spec, ndim, conv):
    """A reference spec in the port's layout (HWIO -> OIHW for a conv)."""
    full = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if conv:
        full = tuple(full[a] for a in (3, 2, 0, 1))
    return _strip(full)


MODELS = {
    "resnet18": (rpm.resnet18, tpm.resnet18, 4),
    "resnet34": (rpm.resnet34, tpm.resnet34, 4),
    "vgg11": (rpm.vgg11, tpm.vgg11, 4),
    "squeezenet": (rpm.squeezenet, tpm.squeezenet, 4),
    "vit12": (rpm.vit, tpm.vit, 3),
    "xlstm-1.3b": (rx.config, tx.config, 3),
}


@pytest.fixture(scope="module")
def defs():
    """Per model: (reference def leaves by path, port def leaves by path,
    conv flags by path)."""
    out = {}
    for name, (r_cfg, t_cfg, stages) in MODELS.items():
        r_defs = r_make_adapter(r_cfg(), stages).defs
        t_defs = t_make_adapter(t_cfg(), stages).defs
        r_flat = {}
        r_map_with_path(r_flat.__setitem__, r_defs)
        out[name] = (r_flat, flatten_paths(t_defs), _conv_flags(t_defs))
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_specs_match_reference(model, defs):
    r_flat, t_flat, conv = defs[model]
    assert sorted(r_flat) == sorted(t_flat)
    n_model = 0
    for path, d in t_flat.items():
        r = r_flat[path]
        assert isinstance(r, RPD.ParamDef)
        want = _to_port(r.spec, len(r.shape), conv[path])
        assert d.spec == want, (path, d.spec, tuple(r.spec))
        n_model += "model" in d.spec
    assert n_model > 0
    # nbytes and nparams do not see the specs
    from repro_torch.common import paramdef as TPD
    assert TPD.nbytes(list(t_flat.values())) == RPD.nbytes(
        list(r_flat.values()))


def test_stacking_keeps_the_spec():
    from repro_torch.common.paramdef import ParamDef, stack_defs
    d = stack_defs({"w": ParamDef((3, 4), spec=(None, "model"))}, 5)["w"]
    assert d.shape == (5, 3, 4) and d.spec == (None, None, "model")
    assert d[1:3].spec == d.spec and d[1:3].shape == (2, 3, 4)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in
                                                MESHES])
def test_fit_spec_and_placements_match_reference(shape, defs):
    mesh = _mesh(*shape)
    for model in ("resnet18", "squeezenet", "vit12", "xlstm-1.3b"):
        r_flat, t_flat, conv = defs[model]
        for path, d in t_flat.items():
            r = r_flat[path]
            want = rsh.fit_spec(r.shape, r.spec, mesh)
            got = tsh.fit_spec(d.shape, d.spec, mesh)
            assert got == _to_port(want, len(r.shape), conv[path]), path
            # the stacked placement: P(lead, *fit_spec) in the reference
            lead = "data" if shape[0] > 1 else None
            stacked = (lead, *got)
            p = tsh.stacked_tree_placements({"x": d}, mesh)["x"]
            assert p.cohort_axis == lead
            assert p.model_dim == (stacked.index("model")
                                   if "model" in stacked else None)


FIT_CASES = [((8, 6), (("pod", "data"), "model")),
             ((4, 6), (("pod", "data"), "model")),
             ((2, 8), (("pod", "data"), None)),
             ((3, 5), ("data", "model")),
             ((16,), ("model",)),
             ((6, 4, 2), (None, "model", "data")),
             ((2,), (("data", "model"),))]


@pytest.mark.parametrize("mesh", [_mesh(*s) for s in MESHES] + [POD],
                         ids=[f"{d}x{m}" for d, m in MESHES] + ["pod"])
def test_fit_and_batch_spec_rules_match_reference(mesh):
    for shape, spec in FIT_CASES:
        want = tuple(rsh.fit_spec(shape, jax.sharding.PartitionSpec(*spec),
                                  mesh))
        assert tsh.fit_spec(shape, spec, mesh) == want, (shape, spec)
    for shape in [(), (1,), (2, 5), (3, 5), (4, 8), (8, 1), (16, 3)]:
        for policy in ("tp", "fsdp"):
            want = tuple(rsh.batch_spec(shape, mesh, policy))
            assert tsh.batch_spec(shape, mesh, policy) == want, (shape,
                                                                 policy)


def test_per_device_nbytes_counts_shards(defs):
    """Bytes per rank of whole leaves under their placements equal the
    reference's shard shapes (its specs fitted to the same mesh)."""
    mesh = _mesh(2, 2)
    r_flat, t_flat, _ = defs["resnet18"]
    leaves = {p: torch.zeros(d.shape) for p, d in t_flat.items()}
    placements = tsh.tree_placements(t_flat, mesh)
    got = tsh.per_device_nbytes(leaves, placements, mesh)
    want = 0
    for path, r in r_flat.items():
        fitted = rsh.fit_spec(r.shape, r.spec, mesh)
        shard = [n // (mesh.shape[e] if e in AXES else 1) for n, e in
                 zip(r.shape, tuple(fitted) + (None,) * len(r.shape))]
        want += int(np.prod(shard)) * 4
    assert got == want
    assert got < 0.65 * tsh.per_device_nbytes(leaves)


def test_pad_cohorts_matches_reference():
    rng = np.random.default_rng(0)
    stack = RoundStack(
        batches={"inputs": {"images": rng.normal(size=(3, 2, 4, 5, 5, 3))
                            .astype(np.float32)},
                 "labels": rng.integers(0, 4, (3, 2, 4)).astype(np.int32)},
        step_mask=np.asarray([[True, True], [True, False], [True, True]]),
        weights=np.asarray([4.0, 2.0, 5.0], np.float32),
        num_batches=[2, 1, 2])
    for shards in (1, 2, 4):
        padded = trt.pad_cohorts(stack, shards)
        b, w, m = rrt.pad_cohorts(jax.tree.map(jnp.asarray, stack.batches),
                                  jnp.asarray(stack.weights),
                                  jnp.asarray(stack.step_mask), shards)
        assert padded.num_cohorts % shards == 0
        assert padded.num_batches[:3] == [2, 1, 2]
        assert all(n == 0 for n in padded.num_batches[3:])
        np.testing.assert_array_equal(padded.weights, np.asarray(w))
        np.testing.assert_array_equal(padded.step_mask, np.asarray(m))
        for x, y in zip(jax.tree.leaves(padded.batches), jax.tree.leaves(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, np.asarray(y))


def test_contradicting_mesh_raises_as_reference():
    mesh = _mesh(2, 2)
    with pytest.raises(ValueError) as r_err:
        rrt.resolve_round_mesh(mesh, 4)
    with pytest.raises(ValueError) as t_err:
        trt.resolve_round_mesh(mesh, 4, torch.device("cpu"))
    assert str(t_err.value) == str(r_err.value)
    # agreeing or unset requests take the explicit mesh
    assert trt.resolve_round_mesh(mesh, 2, torch.device("cpu")) is mesh
    assert trt.resolve_round_mesh(mesh, 1, torch.device("cpu")) is mesh
    with pytest.raises(ValueError, match="contradicts"):
        trt.ShardedRuntime(None, None, None, torch.device("cpu"), mesh=mesh,
                           model_parallel=4)
    with pytest.raises(ValueError, match="contradicts"):
        trt.AsyncBufferedRuntime(None, None, None, torch.device("cpu"),
                                 mesh=mesh, model_parallel=4)


def test_shard_and_unshard_on_one_rank_are_identities():
    mesh = _mesh(1, 1)
    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.shard(x, 0, mesh) is x and tsh.unshard(x, 1, mesh) is x
    assert tsh.block(8, 2, 1) == (4, 8)
    with pytest.raises(ValueError, match="equal blocks"):
        tsh.block(5, 2, 0)


def test_throughput_rows_of_the_sharded_runtime(tmp_path):
    """``fl_round_throughput``: the cohort mode's ``sharded`` row (this
    process's one-rank mesh), and ``--model-parallel 2`` in a spawned world
    of 4: the replicated and the (2, 2)-sharded rows, the sharded one
    holding half the trainable bytes (GroupNorm scales and biases whole)."""
    from repro_torch.benchmarks import fl_round_throughput as flr
    rps = flr.bench("cnn", "reference", 2, 2, 1, torch.device("cpu"),
                    iters=1)
    assert set(rps) == set(flr.VARIANTS) and rps["sharded"] > 0
    out = tmp_path / "mp.json"
    row, = flr.run_model_parallel("cpu", str(out), 2,
                                  settings=[("cnn", 4, 2, 1)], iters=1)
    assert row["mesh"] == {"data": 2, "model": 2} and row["backend"] == "gloo"
    held = {k: r["held_trainable_bytes"] for k, r in row["rows"].items()}
    assert held["model-sharded x2"] < 0.65 * held["replicated"]
    assert all(r["rounds_per_s"] > 0 for r in row["rows"].values())
    import json
    assert json.loads(out.read_text())["model_parallel"][0]["mesh"] == \
        row["mesh"]
