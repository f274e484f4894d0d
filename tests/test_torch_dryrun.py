"""The port's dry-run slice against the JAX reference, on the CPU.

* ``launch.analytic`` equals the reference's for every arch x shape x
  kind at rel 1e-12 (pure Python);
* ``launch.roofline.Roofline`` on the H100's constants (the reference's
  roofline tests, its constants swapped), and the analytic step costs'
  ordering;
* ``common.tree``'s mask helpers, ``abstract_like`` and
  ``RoundProgramSpec.abstract_args`` against the reference's;
* ``launch.dryrun`` in a child process (a fake process group is one per
  process, and a test process may hold a real one): ``shard_abstract``
  against ``launch.sharding.shard`` on a (2, 2) fake world, ``run_one`` of
  a smoke config in all five modes on that world (its collectives, K1-K5's
  counted FLOPs against their formulas), the fake count and peak against
  a real CPU run of the same program, and the counted forward FLOPs of
  the reference's one-layer dense config against the analytic estimate,
  in the reference's 0.4-2.5 band.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.common import tree as r_tree
from repro.configs import shapes as r_shapes
from repro.federated import runtime as r_runtime
from repro.launch import analytic as r_analytic
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common import tree as t_tree
from repro_torch.configs import shapes as t_shapes
from repro_torch.federated import runtime as t_runtime
from repro_torch.kernels.flash_attention import work as fw
from repro_torch.kernels.hsic_gram import work as hw
from repro_torch.kernels.slstm_scan import work as sw
from repro_torch.launch import analytic as t_analytic
from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16, link_bw
from repro_torch.launch.roofline import Roofline

KINDS = ("train", "neulite", "prefill", "decode")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


# --------------------------------------------------------------------------- #
# (a) the analytic model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_analytic_equals_reference(arch):
    r_cfg, t_cfg = r_configs.get_config(arch), t_configs.get_config(arch)
    for name, shape in r_shapes.SHAPES.items():
        rc = r_shapes.resolve_config(r_cfg, shape, tp=0)
        tc = t_shapes.resolve_config(t_cfg, t_shapes.SHAPES[name], tp=0)
        B, S = shape.global_batch, shape.seq_len
        for kind in KINDS:
            r, t = (r_analytic.step_cost(rc, kind, B, S),
                    t_analytic.step_cost(tc, kind, B, S))
            assert _rel(r.flops_global, t.flops_global) <= 1e-12
            assert _rel(r.hbm_bytes_global, t.hbm_bytes_global) <= 1e-12
            assert r.per_chip(256) == t.per_chip(256)
        for ctx in (1.0, S / 2.0, float(S)):
            assert _rel(r_analytic.layer_flops_per_token(rc, ctx),
                        t_analytic.layer_flops_per_token(tc, ctx)) <= 1e-12
        assert r_analytic.head_flops_per_token(rc) == \
            t_analytic.head_flops_per_token(tc)


# --------------------------------------------------------------------------- #
# (b) the roofline on the H100's constants
# --------------------------------------------------------------------------- #
def test_roofline_terms_and_bottleneck():
    rf = Roofline(flops_per_chip=PEAK_FLOPS_BF16, hbm_bytes_per_chip=HBM_BW,
                  collective_bytes_per_chip=0, chips=256,
                  model_flops=PEAK_FLOPS_BF16 * 256 * 0.5)
    assert abs(rf.compute_s - 1.0) < 1e-9
    assert abs(rf.memory_s - 1.0) < 1e-9
    assert rf.bottleneck in ("compute", "memory")
    assert abs(rf.useful_flops_ratio - 0.5) < 1e-9
    # collectives at each axis's link rate: a group inside one host of 8
    # cards over NVLink, any other over the network
    assert link_bw(range(8)) == 450e9 and link_bw([0, 16]) == NET_BW
    rf = Roofline(1.0, 1.0, 9e11, 256,
                  collective_bytes_by_axis={"model": 4.5e11, "data": 4.5e11},
                  link_bw_by_axis={"model": 450e9, "data": NET_BW})
    assert abs(rf.collective_s - (1.0 + 9.0)) < 1e-9
    assert rf.bottleneck == "collective"
    assert set(rf.to_dict()) >= {"compute_s", "memory_s", "collective_s",
                                 "bottleneck", "useful_flops_ratio"}


def test_step_cost_ordering():
    cfg = t_configs.get_config("granite-3-8b")
    train = t_analytic.step_cost(cfg, "train", 256, 4096)
    neulite = t_analytic.step_cost(cfg, "neulite", 256, 4096)
    prefill = t_analytic.step_cost(cfg, "prefill", 32, 32768)
    decode = t_analytic.step_cost(cfg, "decode", 128, 32768)
    assert neulite.flops_global < train.flops_global
    assert decode.flops_global < prefill.flops_global / 10
    assert decode.hbm_bytes_global / decode.flops_global > \
        train.hbm_bytes_global / train.flops_global


# --------------------------------------------------------------------------- #
# (c) the tree mask helpers
# --------------------------------------------------------------------------- #
def _tree(rng):
    return {"model": {"units": [{"w": rng.standard_normal((3, 4)),
                                 "b": rng.standard_normal(4)}
                                for _ in range(3)],
                      "head": {"w": rng.standard_normal((4, 2))
                               .astype(np.float32)}},
            "steps": np.arange(5, dtype=np.int64)}


def test_mask_helpers_equal_reference():
    rng = np.random.default_rng(0)
    tree, other = _tree(rng), _tree(rng)

    def pred(p):
        return "units/1" in p or p.endswith("head/w")

    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    keys = [[getattr(k, "key", getattr(k, "idx", None)) for k in p]
            for p in paths]
    assert [t_tree.path_str(k) for k in keys] == \
        [r_tree.path_str(p) for p in paths]
    r_mask = r_tree.mask_from_predicate(tree, pred)
    t_mask = t_tree.mask_from_predicate(tree, pred)
    assert t_tree.tree_leaves(t_mask) == jax.tree.leaves(r_mask)
    assert sum(t_tree.tree_leaves(t_mask)) == 3

    def same(r, t):
        r_leaves, t_leaves = jax.tree.leaves(r), t_tree.tree_leaves(t)
        assert len(r_leaves) == len(t_leaves)
        for a, b in zip(r_leaves, t_leaves):
            np.testing.assert_array_equal(a, b)

    same(r_tree.select(tree, r_mask), t_tree.select(tree, t_mask))
    same(r_tree.merge(tree, other, r_mask),
         t_tree.merge(tree, other, t_mask))
    same(r_tree.where_mask(tree, other, r_mask),
         t_tree.where_mask(tree, other, t_mask))
    assert t_tree.count_leaves(tree) == r_tree.count_leaves(tree) == 8
    assert t_tree.count_leaves(tree, t_mask) == \
        r_tree.count_leaves(tree, r_mask)
    assert t_tree.masked_nbytes(tree, t_mask) == \
        r_tree.masked_nbytes(tree, r_mask)
    # the same bytes of torch leaves and of ParamDefs
    t_torch = t_tree.tree_map(torch.from_numpy, tree)
    assert t_tree.masked_nbytes(t_torch, t_mask) == \
        r_tree.masked_nbytes(tree, r_mask)


# --------------------------------------------------------------------------- #
# (d), (e) abstract arguments
# --------------------------------------------------------------------------- #
def _same_abstract(r_tree_, t_tree_):
    r_leaves = jax.tree.leaves(r_tree_)
    t_leaves = t_tree.tree_leaves(t_tree_)
    assert len(r_leaves) == len(t_leaves)
    for r, t in zip(r_leaves, t_leaves):
        assert t.device.type == "meta"
        assert tuple(r.shape) == tuple(t.shape)
        assert str(r.dtype) == str(t.dtype).replace("torch.", ""), (r, t)


def test_abstract_like_canonicalises_as_the_reference():
    rng = np.random.default_rng(1)
    tree = {"f64": rng.standard_normal((2, 3)),
            "i64": np.arange(6, dtype=np.int64).reshape(3, 2),
            "mask": rng.standard_normal(4) > 0,
            "f32": rng.standard_normal(5).astype(np.float32),
            "i32": np.zeros((2,), np.int32),
            "scalar": 0.5, "count": 3, "flag": True}
    _same_abstract(r_runtime.abstract_like(tree),
                   t_runtime.abstract_like(tree))
    # tensors keep their shape; f64 / i64 tensors canonicalise too
    t = t_runtime.abstract_like({"a": torch.zeros(2, dtype=torch.float64),
                                 "b": torch.zeros(3, dtype=torch.bfloat16)})
    assert (t["a"].dtype, t["b"].dtype) == (torch.float32, torch.bfloat16)


def test_sequential_spec_abstract_args_equal_reference():
    """The sequential runtime's stage step on the reference's audit
    transformer: the port's ``abstract_args`` have the reference spec's
    shapes and dtypes (the reference's from bridged params: an abstract
    spec reads only shapes and dtypes)."""
    from repro.core import make_transformer_adapter as r_adapter
    from repro.core.curriculum import CurriculumHP as RHP
    from repro.data import Batcher as RBatcher
    from repro.data.loader import stack_round as r_stack_round
    from repro.models.config import ModelConfig as RModelConfig
    from repro.optim import sgd as r_sgd
    from repro_torch.analysis.harness import tiny_setup
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.data.loader import Batcher, stack_round
    from repro_torch.optim.optimizers import sgd

    adapter, params, datasets, _, kind, bs = tiny_setup("tx", "cpu")
    c = adapter.cfg
    r_cfg = RModelConfig(name="t", family="dense", num_layers=c.num_layers,
                         d_model=c.d_model, num_heads=c.num_heads,
                         num_kv_heads=c.num_kv_heads, d_ff=c.d_ff,
                         vocab_size=c.vocab_size, dtype="float32")
    r_params = bridge.to_reference(params)
    stack = stack_round([Batcher(ds, bs, seed=i, kind=kind)
                         for i, ds in enumerate(datasets)], local_steps=2)
    r_stack = r_stack_round([RBatcher(ds, bs, seed=i, kind=kind)
                             for i, ds in enumerate(datasets)],
                            local_steps=2)
    port = t_runtime.make_runtime("sequential", adapter, sgd(0.05),
                                  CurriculumHP(), torch.device("cpu"))
    ref = r_runtime.make_runtime("sequential", r_adapter(r_cfg, 4),
                                 r_sgd(0.05), RHP())
    for t in (0, 3):
        (t_spec,), (r_spec,) = (port.trace_specs(params, t, stack),
                                ref.trace_specs(r_params, t, r_stack))
        _same_abstract(r_spec.abstract_args, t_spec.abstract_args)
    _same_abstract(ref.full_reference_spec(r_params, r_stack).abstract_args,
                   port.full_reference_spec(params, stack).abstract_args)


# --------------------------------------------------------------------------- #
# (d), (f), (g) the dry-run in a child process
# --------------------------------------------------------------------------- #
CHILD = r'''
import dataclasses, functools, json, sys
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.configs import shapes as sh
from repro_torch.federated.runtime import shard_abstract
from repro_torch.launch import dryrun as D, sharding
from repro_torch.launch.mesh import make_production_mesh

sh.SHAPES["tiny_train"] = sh.InputShape("tiny_train", 16, 4, "train")
sh.SHAPES["tiny_prefill"] = sh.InputShape("tiny_prefill", 16, 4, "prefill")
sh.SHAPES["tiny_decode"] = sh.InputShape("tiny_decode", 16, 4, "decode")
SHAPE = {"train": "tiny_train", "neulite": "tiny_train",
         "flround": "tiny_train", "prefill": "tiny_prefill",
         "decode": "tiny_decode"}
# one local step a round: the round's collectives do not depend on it
D.steps_mod.BUILDERS["flround"] = functools.partial(
    D.steps_mod.build_fl_round, local_steps=1)
out = {}

PART = sys.argv[2]     # "a" or "b": the two halves run side by side


def shallow(arch):
    """The smoke config cut to one period."""
    c = get_smoke_config(arch)
    return dataclasses.replace(c, num_layers=len(c.pattern))


D.get_config = shallow

# shard_abstract against sharding.shard on a (2, 2) world
mesh = make_production_mesh(False, (2, 2))
cfg = get_smoke_config("qwen3-1.7b")
_, abstract, placements, _ = D.steps_mod.build_full_train(
    cfg, "tiny_train", mesh, device="cpu")
got, want = [], []
for a, p in zip(abstract, placements):
    got += [list(t.shape) for t in
            sharding.tree_leaves(shard_abstract(a, p, mesh))]
    for t, q in zip(sharding.tree_leaves(a), sharding.tree_leaves(p)):
        x = sharding.shard(torch.empty(t.shape), q.model_dim, mesh)
        if q.cohort_axis:
            x = sharding.shard(x, q.cohort_dim, mesh, q.cohort_axis)
        want.append(list(x.shape))
out["shard"] = {"got": got, "want": want}
RUNS = {"a": (("qwen3-1.7b", ("train", "neulite", "prefill", "decode",
                              "flround")),),
        "b": (("xlstm-1.3b", ("train", "prefill")),)}[PART]
for arch, modes in RUNS:
    for mode in modes:
        rec = D.run_one(arch, SHAPE[mode], False, mode, save=False,
                        verbose=False, world=(2, 2))
        rec.pop("traceback", None)
        out[f"{arch}/{mode}"] = rec
if PART == "a":
    rec = D.run_one("qwen3-1.7b", "tiny_train", True, "train", save=False,
                    verbose=False, world=(2, 2, 2))
    rec.pop("traceback", None)
    out["multipod/train"] = rec
    json.dump(out, open(sys.argv[1], "w"), default=str)
    sys.exit(0)

# the fake count and peak against a real CPU run of the same program
for mode in ("prefill", "train"):
    prog = D.rank_program(shallow("qwen3-1.7b"), SHAPE[mode], mode, mesh)
    fake = D.trace(prog, mesh, "cpu", fake=True)
    real = D.trace(prog, mesh, "cpu", fake=False)
    out[f"real/{mode}"] = {"fake": [fake.flops, fake.peak_bytes,
                                    fake.flops_by_op],
                           "real": [real.flops, real.peak_bytes,
                                    real.flops_by_op]}
# the reference's one-layer dense config, its forward counted
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.common import paramdef as PD
from repro_torch.launch import analytic
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=128,
                  num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
                  dtype="float32")
B, S = 4, 64
params = PD.init_params(0, M.model_defs(cfg), "cpu")
with FlopCounterMode(display=False) as fc, torch.no_grad():
    M.forward(params, cfg, {"tokens": torch.zeros((B, S), dtype=torch.int32)})
out["one_layer"] = [fc.get_total_flops(), S * B * (
    cfg.num_layers * analytic.layer_flops_per_token(cfg, S / 2)
    + analytic.head_flops_per_token(cfg))]
json.dump(out, open(sys.argv[1], "w"), default=str)
'''


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The child's two halves, run side by side, their results merged."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", CHILD, str(tmp / f"{part}.json"), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("a", "b")}
    out = {}
    for part, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        with open(tmp / f"{part}.json") as f:
            out.update(json.load(f))
    return out


def test_shard_abstract_equals_shard_on_a_fake_world(child):
    assert child["shard"]["got"] == child["shard"]["want"]
    assert len(child["shard"]["got"]) > 40


MODES = ("train", "neulite", "prefill", "decode", "flround")


@pytest.mark.parametrize("mode", MODES)
def test_run_one_on_a_fake_world(child, mode):
    rec = child[f"qwen3-1.7b/{mode}"]
    assert rec["ok"], rec.get("error")
    checks = rec["checks"]
    assert checks["model_sharded_leaves"] > 0
    # one all-gather over "model" a model-sharded leaf (flround: and its
    # Eq. 1 aggregate), one all-reduce over "data" a trainable leaf
    assert checks["model_all_gathers"] == checks["model_sharded_leaves"]
    assert checks["data_all_reduces"] == checks["expected_data_all_reduces"]
    if mode in ("prefill", "decode"):
        assert checks["data_all_reduces"] == 0
    else:
        assert checks["data_all_reduces"] > 0
    coll = rec["collectives"]
    assert set(coll["by_axis"]) <= {"model", "data"}
    assert coll["all-gather"]["count"] == checks["model_all_gathers"]
    assert rec["world"] == [2, 2] and rec["chips"] == 4
    ma = rec["memory_analysis"]
    assert 0 < ma["argument_size_in_bytes"] < ma["peak_bytes"]
    assert ma["fits_h100"]
    rf = rec["roofline"]
    assert rf["flops_per_chip"] == rec["counted"]["flops_per_chip"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    # K4 on every attention layer (no attention in a decode step's prompt)
    kernels = rec["counted"]["flops_by_kernel"]
    if mode != "decode":
        assert kernels["K4"] > 0
    if mode in ("neulite", "flround"):
        assert kernels["K1"] > 0 and kernels["K2"] > 0 and kernels["K3"] > 0


def _formula(call):
    """Product FLOPs of one recorded kernel call, from its formula."""
    name, args, kw = call["op"], call["args"], call["kwargs"]
    if name == "flash_attention_fwd":
        B, Sq, H, D = args[0]
        return fw.flash_work(B, Sq, args[1][1], H, args[1][2], D,
                             kw["causal"], kw.get("window", 0),
                             "float32")[1]
    if name.startswith("slstm_scan"):
        *lead, B, S, _, H, Dh = args[0]
        fn = sw.slstm_work if name.endswith("fwd") else sw.slstm_bwd_work
        return int(np.prod(lead)) * fn(B, S, H, Dh)[1]
    *lead, B, Dx = args[0]
    return int(np.prod(lead)) * hw.nhsic_work(
        name, B, Dx, args[1][-1], kw.get("linear_x", False),
        kw.get("linear_z", False))[1]


NAMES = {"flash_attention_fwd": "K4", "slstm_scan_fwd": "K5",
         "slstm_scan_bwd": "K5 bwd", "nhsic_rowsums": "K1",
         "nhsic_stats_feats": "K2", "nhsic_grad": "K3"}


@pytest.mark.parametrize("case", ["qwen3-1.7b/neulite", "qwen3-1.7b/flround",
                                  "xlstm-1.3b/train", "xlstm-1.3b/prefill"])
def test_kernel_flops_equal_their_formulas(child, case):
    """Every kernel call the run recorded, at its own shapes, through the
    formula of the kernel's bound: the sums are the counted FLOPs."""
    rec = child[case]
    assert rec["ok"], rec.get("error")
    want = {}
    for call in rec["counted"]["kernel_calls"]:
        k = NAMES[call["op"]]
        want[k] = want.get(k, 0) + call["calls"] * _formula(call)
    assert want and all(v > 0 for v in want.values())
    assert rec["counted"]["flops_by_kernel"] == want
    if case.startswith("xlstm"):
        assert want["K5"] > 0
    if case == "xlstm-1.3b/train":
        assert want["K5 bwd"] > 0


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_fake_run_counts_what_a_real_run_counts(child, mode):
    fake, real = child[f"real/{mode}"]["fake"], child[f"real/{mode}"]["real"]
    assert fake[0] == real[0] > 0
    assert fake[2] == real[2]
    assert abs(fake[1] - real[1]) <= 0.05 * real[1], (fake[1], real[1])


def test_counted_forward_flops_within_the_analytic_band(child):
    """The reference's ``test_analytic_flops_match_xla_dense`` with the
    port's ``FlopCounterMode`` count in place of XLA's: the one-layer
    dense config's forward at B 4, S 64."""
    counted, analytic = child["one_layer"]
    assert 0.4 < analytic / max(counted, 1) < 2.5, (analytic, counted)


def test_run_one_on_a_multi_pod_world(child):
    """On (pod 2, data 2, model 2) the gradient's all-reduces cross the
    pod and data axes together, one group of 4 ranks a leaf."""
    rec = child["multipod/train"]
    assert rec["ok"], rec.get("error")
    checks = rec["checks"]
    assert checks["data_all_reduces"] == \
        checks["expected_data_all_reduces"] > 0
    assert checks["model_all_gathers"] == checks["model_sharded_leaves"] > 0
    assert set(rec["collectives"]["by_axis"]) == {"model", "pod,data"}
    assert rec["world"] == [2, 2, 2] and rec["chips"] == 8
