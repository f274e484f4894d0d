"""The port's LLM training launch against the JAX reference's, on the CPU:
``configs/shapes.py``, ``common/sharding.py``, ``launch/steps.py``,
``launch/train.py`` and ``federated/runtime.cohort_batches_specs``.

* ``SHAPES`` equal the reference's; ``pad_heads_for_tp`` and
  ``resolve_config`` equal it field by field for all ten arch ids at
  every shape.
* ``token_inputs``, ``label_specs``, ``decode_inputs``, ``cache_specs``,
  ``cache_part_specs`` and ``input_specs`` give the reference's shapes,
  dtypes and specs for all ten archs (meta tensors: nothing is allocated,
  full widths included).
* ``align_moe_dispatch`` gives the three MoE archs' configs the mesh's
  batch shards as dispatch groups, as the reference's does.
* ``filter_spec`` and ``shard``'s fitted spec (``shard_spec``, both
  policies) equal the reference's on the duck-typed meshes of
  ``tests/test_torch_mesh.py``; the port's ``shard`` is the identity.
* Each builder's abstract arguments and placements against the
  reference's shapes, dtypes and specs (the reference's shardings read as
  specs); one AdamW step of ``build_neulite_train`` and of
  ``build_full_train`` on qwen3-1.7b's smoke config against the
  reference's jitted step from the same params at rtol 1e-4.
* ``launch/train.main`` at ``--rounds 2 --clients 64 --cohort 2 --batch 64
  --seq 16`` (NeuLite, and ``--e2e``) from the reference's params: its
  ``metrics.json`` losses against the reference's own ``main`` at 1e-3 of
  the largest; a run checkpointed every round, stopped after round 1 and
  continued with ``--resume``, gives the straight run's bits.
"""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as r_configs
from repro.common import paramdef as r_pd
from repro.common import sharding as r_sharding
from repro.configs import shapes as r_shapes
from repro.federated import runtime as r_runtime
from repro.launch import sharding as r_lsh
from repro.launch import steps as r_steps
from repro.launch import train as r_train
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common import sharding as t_sharding
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import shapes as t_shapes
from repro_torch.core import progressive as t_prog
from repro_torch.federated import runtime as t_runtime
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train

PORTED = ["musicgen-large", "xlstm-1.3b", "llava-next-34b", "granite-3-8b",
          "h2o-danube-3-4b", "qwen1.5-4b", "qwen3-1.7b"]
# the archs of MLA, MoE and Mamba (ported after the other seven)
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b",
             "jamba-1.5-large-398b"]
AXES = ("data", "model")
POD = SimpleNamespace(axis_names=("pod", "data", "model"),
                      shape={"pod": 2, "data": 2, "model": 4})
TRAIN_ARGV = ["--rounds", "2", "--clients", "64", "--cohort", "2",
              "--batch", "64", "--seq", "16"]


def _mesh(d, m):
    return SimpleNamespace(axis_names=AXES, shape={"data": d, "model": m})


MESHES = [_mesh(1, 1), _mesh(2, 2), _mesh(4, 2), POD]
MESH_IDS = ["1x1", "2x2", "4x2", "pod"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg, names):
    out = {n: getattr(cfg, n) for n in names}
    for k in ("xlstm", "moe", "mla", "ssm"):
        if out.get(k) is not None:
            out[k] = dataclasses.asdict(out[k])
    return out


def _same_config(r_cfg, t_cfg):
    names = ({f.name for f in dataclasses.fields(r_cfg)}
             & {f.name for f in dataclasses.fields(t_cfg)})
    assert {"num_heads", "num_kv_heads", "head_dim", "window",
            "num_output_heads", "num_vision_patches",
            "long_context_window"} <= names
    assert _fields(t_cfg, names) == _fields(r_cfg, names)


def _dtype_name(dt):
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _same_abstract(r_tree, t_tree):
    r_leaves = jax.tree.leaves(r_tree)
    t_leaves = tree_leaves(t_tree)
    assert len(r_leaves) == len(t_leaves)
    for r, t in zip(r_leaves, t_leaves):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(r.shape)
        assert _dtype_name(t.dtype) == _dtype_name(r.dtype), (r, t)


def test_shapes_equal_reference():
    assert list(t_shapes.SHAPES) == list(r_shapes.SHAPES)
    for name, r in r_shapes.SHAPES.items():
        assert dataclasses.asdict(t_shapes.SHAPES[name]) == \
            dataclasses.asdict(r)


@pytest.mark.parametrize("arch", PORTED + MOE_ARCHS)
def test_pad_heads_and_resolve_config_match_reference(arch):
    r_cfg = r_configs.get_config(arch)
    t_cfg = t_configs.get_config(arch)
    for tp in (16, 8, 6):
        _same_config(r_shapes.pad_heads_for_tp(r_cfg, tp),
                     t_shapes.pad_heads_for_tp(t_cfg, tp))
    for shape in r_shapes.SHAPES:
        for tp in (16, 0):
            _same_config(
                r_shapes.resolve_config(r_cfg, r_shapes.SHAPES[shape], tp),
                t_shapes.resolve_config(t_cfg, t_shapes.SHAPES[shape], tp))
    if arch == "llava-next-34b":       # GQA: the group grows, 56 -> 64 / 8
        padded = t_shapes.pad_heads_for_tp(t_cfg)
        assert (padded.num_heads, padded.num_kv_heads, padded.head_dim) == \
            (64, 8, 128)
    if arch == "qwen1.5-4b":           # MHA: q and kv pad together
        padded = t_shapes.pad_heads_for_tp(t_cfg)
        assert (padded.num_heads, padded.num_kv_heads) == (32, 32)


@pytest.mark.parametrize("arch", PORTED + MOE_ARCHS)
def test_input_specs_match_reference(arch):
    for smoke in (False, True):
        get = "get_smoke_config" if smoke else "get_config"
        r_cfg = getattr(r_configs, get)(arch)
        t_cfg = getattr(t_configs, get)(arch)
        for B, S in ((2, 48), (3, 4096)):
            _same_abstract(r_shapes.token_inputs(r_cfg, B, S),
                           t_shapes.token_inputs(t_cfg, B, S))
            _same_abstract(r_shapes.label_specs(r_cfg, B, S),
                           t_shapes.label_specs(t_cfg, B, S))
            _same_abstract(r_shapes.decode_inputs(r_cfg, B),
                           t_shapes.decode_inputs(t_cfg, B))
            _same_abstract(r_shapes.cache_specs(r_cfg, B, S),
                           t_shapes.cache_specs(t_cfg, B, S))
            r_specs = jax.tree.leaves(
                r_shapes.cache_part_specs(r_cfg, B, S),
                is_leaf=lambda x: isinstance(x, P))
            t_specs = jax.tree.leaves(
                t_shapes.cache_part_specs(t_cfg, B, S),
                is_leaf=lambda x: isinstance(x, tuple))
            assert len(r_specs) == len(t_specs)
            for r, t in zip(r_specs, t_specs):
                r = list(r)
                while r and r[-1] is None:
                    r.pop()
                assert t == tuple(r)
        for shape in r_shapes.SHAPES:
            _same_abstract(r_shapes.input_specs(r_cfg, shape),
                           t_shapes.input_specs(t_cfg, shape))


AXES_CASES = [(("pod", "data"), None, None), (("pod", "data"), None, "model"),
              ("data", "model", None), (None, ("data", "model"), None),
              ("model", None, "pod"), (None, None, None)]
SHARD_SHAPES = [(8, 6, 4), (2, 16, 8), (3, 5, 7), (16, 2, 1)]


@pytest.mark.parametrize("policy", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_filter_spec_and_shard_match_reference(mesh, policy, monkeypatch):
    for axes in AXES_CASES:
        assert t_sharding.filter_spec(axes, mesh) == tuple(
            r_sharding.filter_spec(P(*axes), mesh))
    # the reference's shard on this mesh, its constraint read as a spec
    monkeypatch.setattr(r_sharding, "_current_mesh", lambda: mesh)
    monkeypatch.setattr(r_sharding, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(r_sharding, "jax", SimpleNamespace(
        lax=SimpleNamespace(with_sharding_constraint=lambda x, s: s)))
    if policy == "fsdp":
        monkeypatch.setenv("REPRO_SHARDING_POLICY", "fsdp")
    x = torch.zeros(1)
    for shape in SHARD_SHAPES:
        for axes in AXES_CASES:
            want = tuple(r_sharding.shard(np.zeros(shape), *axes))
            assert t_sharding.shard_spec(shape, axes, mesh) == want, (
                shape, axes)
    assert t_sharding.shard(x, "data") is x


def test_shard_is_the_identity_outside_a_mesh():
    x = jnp.ones((4, 2))
    assert r_sharding.shard(x, ("pod", "data"), None) is x
    y = torch.ones(4, 2)
    assert t_sharding.shard(y, ("pod", "data"), None) is y


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large",
                                  "llava-next-34b"])
def test_cohort_batches_specs_match_reference(arch):
    r_cfg = r_configs.get_smoke_config(arch)
    t_cfg = t_configs.get_smoke_config(arch)
    _same_abstract(r_runtime.cohort_batches_specs(r_cfg, 3, 4, 2, 48),
                   t_runtime.cohort_batches_specs(t_cfg, 3, 4, 2, 48))


# --------------------------------------------------------------------------- #
# the builders
# --------------------------------------------------------------------------- #
@pytest.fixture
def spec_shardings(monkeypatch):
    """The reference's builders on duck-typed meshes: each sharding read
    as its fitted spec."""
    def tree_specs(defs, mesh):
        return jax.tree.map(lambda d: r_lsh.fit_spec(d.shape, d.spec, mesh),
                            defs, is_leaf=r_pd.is_def)

    def batch_specs(sds, mesh, policy="tp"):
        return jax.tree.map(lambda s: r_lsh.batch_spec(s.shape, mesh,
                                                       policy), sds)

    monkeypatch.setattr(r_steps, "tree_shardings", tree_specs)
    monkeypatch.setattr(r_steps, "batch_shardings", batch_specs)
    monkeypatch.setattr(r_steps, "replicated", lambda mesh: P())
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda m, s: s)


def _spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _same_placements(r_specs, t_placements, batch_like):
    """A param leaf's "model" dim, or a batch leaf's leading axis, against
    the reference's spec of the same leaf."""
    r_leaves = _spec_leaves(r_specs)
    t_leaves = tree_leaves(t_placements)
    assert len(r_leaves) == len(t_leaves)
    for r, t in zip(r_leaves, t_leaves):
        r = tuple(r)
        if batch_like:
            assert t.model_dim is None
            assert t.cohort_axis == (r[0] if r else None), (r, t)
        else:
            names = [e if isinstance(e, tuple) else (e,) for e in r]
            dims = [i for i, n in enumerate(names) if "model" in n]
            assert t.model_dim == (dims[0] if dims else None), (r, t)
            assert t.cohort_axis is None


BUILD_ARGS = {"train": "train_4k", "neulite": "train_4k",
              "prefill": "prefill_32k", "decode": "decode_32k",
              "flround": "train_4k"}
# per builder, which of its arguments are batches
BATCH_ARGS = {"train": (2,), "neulite": (3,), "prefill": (1,),
              "decode": (1, 3), "flround": (2, 3)}


@pytest.mark.parametrize("policy", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large",
                                  "llava-next-34b"])
def test_builders_abstract_and_placements_match_reference(
        arch, mesh, policy, spec_shardings, monkeypatch):
    if policy == "fsdp":
        monkeypatch.setenv("REPRO_SHARDING_POLICY", "fsdp")
    r_cfg = r_configs.get_smoke_config(arch)
    t_cfg = t_configs.get_smoke_config(arch)
    for kind, shape in BUILD_ARGS.items():
        _, r_abs, r_sh, r_out = r_steps.BUILDERS[kind](r_cfg, shape, mesh)
        _, t_abs, t_pl, t_out = t_steps.BUILDERS[kind](t_cfg, shape, mesh,
                                                       device="cpu")
        assert len(r_abs) == len(t_abs) == len(r_sh) == len(t_pl)
        for i, (ra, ta, rs, tp) in enumerate(zip(r_abs, t_abs, r_sh, t_pl)):
            _same_abstract(ra, ta)
            _same_placements(rs, tp, i in BATCH_ARGS[kind])
        assert len(r_out) == len(t_out)
        for rs, tp in zip(r_out, t_out):
            _same_placements(rs, tp, False)
    for shape in r_shapes.SHAPES:
        assert t_steps.builder_for(shape) == r_steps.builder_for(shape)
        assert t_steps.builder_for(shape, True) == \
            r_steps.builder_for(shape, True)
    assert t_steps.align_moe_dispatch(t_cfg, mesh) is t_cfg


def _init(defs, seed):
    """A reference ParamDef tree drawn by the reference's init rules, from
    numpy (no compile per leaf)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(
                d.shape, np.float32)
        scale = d.scale if d.scale is not None else (
            0.02 if d.init == "embed" else
            1 / np.sqrt(max(d.shape[-2] if len(d.shape) >= 2
                            else d.shape[-1], 1)))
        return (scale * rng.standard_normal(d.shape)).astype(np.float32)
    return jax.tree.map(draw, defs, is_leaf=r_pd.is_def)


def _rel(ref, port):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.detach().float() if torch.is_tensor(port)
                      else port, np.float64)
    assert ref.shape == port.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)


def _close(ref, port, tol):
    err = _rel(ref, port)
    assert err <= tol, err


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}


def _t(tree):
    return bridge.from_reference(tree, "cpu")


@pytest.mark.parametrize("kind", ["neulite", "train"])
def test_builder_steps_match_reference(kind, spec_shardings):
    """One AdamW step of the builder's step on qwen3-1.7b's smoke config
    (its heads TP-padded by ``resolve_config``, 16 of 64) at B = 4, S =
    16, against the reference's jitted step from the same params."""
    mesh = _mesh(1, 1)
    r_cfg = r_configs.get_smoke_config("qwen3-1.7b")
    t_cfg = t_configs.get_smoke_config("qwen3-1.7b")
    r_step, r_abs, _, _ = r_steps.BUILDERS[kind](r_cfg, "train_4k", mesh)
    t_step, _, _, _ = t_steps.BUILDERS[kind](t_cfg, "train_4k", mesh,
                                             device="cpu")
    from repro.core import make_transformer_adapter as r_make
    res = r_shapes.resolve_config(r_cfg, r_shapes.SHAPES["train_4k"])
    assert res.num_heads == 16
    r_ad = r_make(res, num_stages=4)
    t_ad = t_prog.make_transformer_adapter(
        t_shapes.resolve_config(t_cfg, t_shapes.SHAPES["train_4k"]), 4)
    params = _init(r_ad.defs, 0)
    batch = _batch(res, 4, 16, 1)
    opt_r, opt_t = (r_steps.make_optimizer("adamw"),
                    t_steps.make_optimizer("adamw"))
    if kind == "neulite":
        t = r_ad.plan.num_stages // 2
        r_fr, r_tr = r_ad.split_stage(params, t)
        t_fr, t_tr = t_ad.split_stage(_t(params), t)
        r_args = (opt_r.init(r_tr), r_tr, r_fr, batch, r_tr)
        t_args = (opt_t.init(t_tr), t_tr, t_fr, _t(batch), t_tr)
    else:
        r_args = (opt_r.init(params), params, batch)
        t_args = (opt_t.init(_t(params)), _t(params), _t(batch))
    _same_abstract(jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        a.shape, a.dtype), r_args[0]), t_steps._defs_to_abstract(
        t_steps._opt_state_defs("adamw", t_ad.defs if kind == "train"
                                else t_ad.split_stage(t_ad.defs, t)[1])))
    jitted = jax.jit(r_step)
    r_opt, r_new, r_m = jitted(*r_args)
    t_opt, t_new, t_m = t_step(*t_args)
    _close(r_m["loss"], t_m["loss"], 1e-4)
    # the gradients (AdamW's m = 0.1 g after one step) at 1e-4
    for a, b in zip(jax.tree.leaves(r_opt["m"]), tree_leaves(t_opt["m"])):
        _close(a, b, 1e-4)
    assert int(t_opt["step"]) == int(r_opt["step"]) == 1
    # the new params at 1e-4, or 10x the reference's own movement under a
    # random 1e-7 change of its params where that exceeds 1e-5: a first
    # AdamW update is about lr * sign(g), so a gradient entry near 0
    # flips it (the reference moves 2.6e-4 of a leaf's largest entry)
    rng = np.random.default_rng(7)
    noisy = jax.tree.map(lambda a: a if a.dtype.kind != "f" else (
        a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(a.dtype),
        r_args[1:])
    _, r_moved, _ = jitted(r_args[0], *noisy)

    def rel(x, y):
        return max(_rel(a, b) for a, b in zip(jax.tree.leaves(x), y))

    moved = rel(r_new, jax.tree.leaves(r_moved))
    bar = max(1e-4, 10 * moved) if moved > 1e-5 else 1e-4
    err = rel(r_new, tree_leaves(t_new))
    assert err <= bar, (err, moved)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_align_moe_dispatch_refuses_moe(arch, monkeypatch):
    """Without MoE the config passes as it is (the builders' test above);
    a MoE config no longer raises: it gets the mesh's batch shards as its
    dispatch groups, as the reference's does (``test_torch_moe.py`` holds
    it on a ``HostMesh``)."""
    monkeypatch.delenv("REPRO_MOE_GROUPS", raising=False)
    for mesh in MESHES:
        t_cfg = t_steps.align_moe_dispatch(t_configs.get_config(arch), mesh)
        r_cfg = r_steps.align_moe_dispatch(r_configs.get_config(arch), mesh)
        _same_config(r_cfg, t_cfg)
        assert t_cfg.moe.dispatch_groups == (
            mesh.shape["data"] * mesh.shape.get("pod", 1))


# --------------------------------------------------------------------------- #
# launch/train.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's ``main`` at TRAIN_ARGV, NeuLite and ``--e2e``:
    {"neulite" | "e2e": metrics.json}, and its init params (numpy)."""
    out = {}
    for leg, extra in (("neulite", []), ("e2e", ["--e2e"])):
        d = str(tmp_path_factory.mktemp(f"ref_{leg}"))
        argv = sys.argv
        sys.argv = ["train"] + TRAIN_ARGV + extra + ["--out", d]
        try:
            r_train.main()
        finally:
            sys.argv = argv
        with open(os.path.join(d, "metrics.json")) as f:
            out[leg] = json.load(f)
    from repro.core import make_transformer_adapter as r_make
    adapter = r_make(r_configs.get_smoke_config("qwen3-1.7b"), num_stages=4)
    out["params"] = jax.device_get(adapter.init_params(
        jax.random.PRNGKey(0)))
    return out


@pytest.fixture
def reference_init(reference_runs, monkeypatch):
    """``train.main`` starting from the reference's init params."""
    make = t_prog.make_transformer_adapter

    def with_reference_params(cfg, num_stages, boundary_units=1):
        adapter = make(cfg, num_stages, boundary_units)
        adapter.init_params = (lambda seed, device=None, **kw:
                               bridge.from_reference(
                                   reference_runs["params"], device))
        return adapter

    monkeypatch.setattr(t_train, "make_transformer_adapter",
                        with_reference_params)


def _losses(metrics, key):
    return np.array([m[key] for m in metrics], np.float64)


@pytest.mark.parametrize("leg", ["neulite", "e2e"])
def test_train_main_matches_reference(leg, reference_runs, reference_init,
                                      tmp_path):
    extra = ["--e2e"] if leg == "e2e" else []
    out = t_train.main(TRAIN_ARGV + extra + ["--out", str(tmp_path)],
                       device="cpu")
    with open(tmp_path / "metrics.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(out["metrics"]))
    want = reference_runs[leg]
    key = "loss" if leg == "e2e" else "mean_loss"
    assert len(got) == len(want) == (8 if leg == "e2e" else 2)
    g, w = _losses(got, key), _losses(want, key)
    assert np.all(np.isfinite(g))
    assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), (g, w)
    if leg == "neulite":
        for a, b in zip(got, want):
            assert {k: a[k] for k in ("round_idx", "stage", "n_selected",
                                      "n_feasible", "upload_bytes")} == \
                {k: b[k] for k in ("round_idx", "stage", "n_selected",
                                   "n_feasible", "upload_bytes")}
        assert os.path.exists(tmp_path / "ckpt_00000002.npz")


def test_train_resume_gives_the_straight_run_s_bits(reference_init,
                                                    tmp_path):
    straight = t_train.main(TRAIN_ARGV + ["--out", str(tmp_path / "a")],
                            device="cpu")
    argv = TRAIN_ARGV + ["--checkpoint-every", "1", "--out",
                         str(tmp_path / "b")]
    first = list(argv)
    first[first.index("--rounds") + 1] = "1"
    t_train.main(first, device="cpu")
    resumed = t_train.main(argv + ["--resume"], device="cpu")
    assert resumed["metrics"] == straight["metrics"]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)
