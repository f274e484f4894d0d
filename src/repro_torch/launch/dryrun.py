"""The dry-run: what each (architecture x input shape x mesh) would cost
one rank of the port, with nothing allocated on any device (port of
``repro.launch.dryrun``).

The reference lowers and compiles each combination's GSPMD program for a
TPU pod and reads XLA's analyses.  The port has no compiler and no
partitioner: a rank runs its own program eagerly.  So the dry-run runs
**rank 0's program** of the production mesh (``launch.mesh.
make_production_mesh``: (data=16, model=16) or (pod=2, data=16,
model=16), over a fake process group) on fake tensors
(``FakeTensorMode``), and counts what that program does:

* its arguments are the per-rank shards of the step builder's abstract
  arguments (``launch.steps.BUILDERS``; ``federated.runtime.
  shard_abstract`` of their placements): model-sharded leaves cut over
  "model", batch leaves (a decode cache's batch too) cut to this rank's
  block of the data axes;
* before the step every model-sharded leaf is all-gathered over "model",
  and after it this rank keeps its slice of the state it carries, as
  ``federated.runtime.ShardedRuntime`` does every step: the port splits
  storage over "model", not compute;
* train and neulite average the gradient over the data axes, one
  all-reduce a trainable leaf before the optimizer's update (the
  reduction GSPMD inserts in the reference's program); flround trains
  this rank's block of cohorts and runs Eq. 1 over the data axes as the
  sharded runtime does (one all-reduce a trainable leaf, of its model
  shard, then a gather over "model", and one of the loss vector);
* the kernels are on (K4 in attention, K5 in the sLSTM scan, K1-K3 in
  the curriculum's nHSIC): on fake tensors their custom ops run their
  fake implementations and build nothing; ``FlopCounterMode`` counts
  them through the formulas of their bounds (``kernels/*/work.py``);
* host values the abstract only stands for are concrete: the decode
  position (``seq_len - 1``) and the Eq. 1 sample counts.

Measured per rank: FLOPs (``FlopCounterMode``); bytes, each op's inputs
and outputs summed (an unfused upper bound of HBM traffic; views and
empty allocations move none); the peak of live bytes (every storage from
the arguments' and each op's outputs' on, until it is freed), which
``memory_analysis`` splits into argument, output and temp bytes beside
``fits_h100``; and every collective (``analysis.collectives.
record_collectives``), classified by the mesh axes it crosses.  The
roofline (``launch.roofline``) reads these on the H100's constants.  The
FLOPs are counted per rank and not divided over the chips: every rank
computes its whole step, so the counted FLOPs are what a rank pays.  The
reference's partitioned ideal, ``launch.analytic``'s global count over
the chips, stays beside them; their ratio is what splitting only the
storage over "model" costs.

The fake tensors are CUDA tensors where torch is built with CUDA (no card
is needed) and CPU tensors where it is not: a CPU build of torch has no
device guard for CUDA, so indexing a fake CUDA tensor with a tensor raises
and autograd on one aborts the process.  The kernels' custom ops take
their fake implementations on either device, so the counts are the same;
the record names the device.

A combination that fails, or runs past ``--time-limit`` seconds (600 by
default; the plain Mamba scan's per-step loop is the slow part), is
recorded ``ok: false`` with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape prefill_32k --mesh pod
  python -m repro_torch.launch.dryrun --sweep --jobs 8   # 10 archs x 4 shapes x {pod, multipod}
  python -m repro_torch.launch.dryrun --arch ... --mode neulite --devices 2x2
  python -m repro_torch.launch.dryrun --table            # the records as a table
  python -m repro_torch.launch.dryrun --calibrate qwen3-1.7b:prefill_32k:pod   # real, on the card

Results: results/dryrun_torch/<arch>__<shape>__<mesh>__<mode>.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import collectives as col
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import resolve_config
from repro_torch.federated.runtime import eq1_over_mesh, shard_abstract
# the kernel modules register their ops' FLOP formulas when imported, and
# a FlopCounterMode copies the registry when it is made
from repro_torch.kernels.flash_attention import kernel as _k4  # noqa: F401
from repro_torch.kernels.hsic_gram import kernel as _k1_3  # noqa: F401
from repro_torch.kernels.slstm_scan import kernel as _k5  # noqa: F401
from repro_torch.launch import analytic, sharding
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.roofline import roofline_from_trace
from repro_torch.models import model as tx
from repro_torch.optim.optimizers import Optimizer

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results", "dryrun_torch")
TIME_LIMIT_S = 600
# archs whose plain recurrent loops (Mamba's step loop, the chunkwise
# mLSTM) make their long-sequence traces the slowest
RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
MODES = ("train", "neulite", "prefill", "decode", "flround")
KERNEL_OPS = {"flash_attention_fwd": "K4", "slstm_scan_fwd": "K5",
              "slstm_scan_bwd": "K5 bwd", "nhsic_rowsums": "K1",
              "nhsic_stats_feats": "K2", "nhsic_grad": "K3"}


# --------------------------------------------------------------------------- #
# what one rank's program does: bytes moved and bytes live
# --------------------------------------------------------------------------- #
class TimeLimit(Exception):
    """A trace ran past its time limit."""


_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_unsafe_view", "is_contiguous", "is_strides_like_format",
               "is_non_overlapping_and_dense", "size", "sym_size", "stride",
               "sym_stride", "storage_offset", "sym_storage_offset",
               "numel", "sym_numel", "dim"}
# metadata (prim.device, prim.layout) and collectives (counted apart)
_NO_TRAFFIC_NAMESPACES = ("prim", "c10d", "_c10d_functional")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class TraceCounter(TorchDispatchMode):
    """Sums each op's input and output bytes (``hbm_bytes``: views, empty
    allocations, metadata queries and collectives move none) and keeps
    the live bytes: every storage ``track``ed or made by an op counts from
    then until it is freed; ``peak_bytes`` is the most at once.  ``kernel_calls`` counts
    the port's kernel ops by (name, argument shapes, keywords).  ``limit``
    seconds after it is made, the next op raises ``TimeLimit``."""

    def __init__(self, limit: Optional[float] = None):
        super().__init__()
        self.limit_s = limit
        self.deadline = time.monotonic() + limit if limit else None
        self.hbm_bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self.kernel_calls: Dict[tuple, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live; returns their
        bytes (each storage once)."""
        total = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            total += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        moves = (func.namespace not in _NO_TRAFFIC_NAMESPACES
                 and not func.is_view
                 and func.overloadpacket.__name__ not in _NO_TRAFFIC)
        # checked at every op that moves data, in whichever thread runs it
        # (autograd's device threads too, where no signal handler runs);
        # a metadata query may come from C++ that cannot take an exception
        if moves and self.deadline is not None \
                and time.monotonic() > self.deadline:
            raise TimeLimit(f"ran past its time limit of {self.limit_s} s")
        out = func(*args, **(kwargs or {}))
        if func.namespace == "repro_torch":
            key = (func.overloadpacket.__name__,
                   tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                         else a for a in args),
                   tuple(sorted((kwargs or {}).items())))
            self.kernel_calls[key] = self.kernel_calls.get(key, 0) + 1
        if moves:
            self.hbm_bytes += sum(t.numel() * t.element_size() for t in
                                  _tensors((args, kwargs, out)))
        self.track(out)
        return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


# --------------------------------------------------------------------------- #
# rank 0's program
# --------------------------------------------------------------------------- #
def data_axes(mesh):
    """The mesh's batch axes: ("pod", "data") on a multi-pod mesh."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def data_mean(optimizer: Optimizer, mesh, axis) -> Optimizer:
    """``optimizer`` whose update first averages each gradient leaf over
    ``axis`` (one all-reduce a leaf)."""
    n = sharding.axes_size(mesh, axis)

    def update(grads, state, params):
        grads = tree_map(
            lambda g: mesh.all_reduce(g.contiguous(), axis).div_(n), grads)
        return optimizer.update(grads, state, params)

    return Optimizer(optimizer.init, update)


def mesh_eq1(mesh, axis, placements):
    """The ``aggregate`` of rank 0's flround program: its whole locals cut
    to their model shards, as ``ShardedRuntime`` holds them, then the
    runtime's own seam, ``eq1_over_mesh``, on this rank's block of
    cohorts.  ``placements`` (a list) gets the trainable tree's
    ``Placement``s once the builder has given them."""
    def aggregate(locals_, weights, losses):
        n = losses.shape[0]
        held = tree_map(lambda x, p: sharding.shard(
            x, None if p.model_dim is None else p.model_dim + 1, mesh),
            locals_, placements[0])
        new, mean_loss, _ = eq1_over_mesh(
            mesh, axis, sharding.MODEL, placements[0],
            sharding.axes_index(mesh, axis) * n, len(weights), held,
            weights, losses)
        return new, mean_loss

    return aggregate


def _is_tree(p) -> bool:
    return not isinstance(p, sharding.Placement)


def _model_leaves(placements, mesh) -> int:
    if mesh.shape.get(sharding.MODEL, 1) == 1:
        return 0
    return sum(1 for p in placements if _is_tree(p)
               for q in tree_leaves(p) if q.model_dim is not None)


@dataclasses.dataclass
class RankProgram:
    """Rank 0's program of one combination: ``run(*args)`` on the per-rank
    ``abstract`` arguments (meta tensors; ``None`` where ``host`` holds a
    host value), and what it must issue: ``model_gathers`` all-gathers
    over "model" (one a model-sharded leaf before the step; flround's Eq. 1
    gathers its aggregate whole again), ``data_all_reduces`` all-reduces
    over the data axes (one a trainable leaf; flround's loss vector too)."""
    mode: str
    run: Callable
    abstract: tuple
    host: tuple
    model_gathers: int
    data_all_reduces: int

    def arguments(self, device, fake: bool):
        """The arguments on ``device``: empty tensors on a fake mode, zeros
        (token ids 0, valid in every vocabulary) on a real one."""
        def make(a):
            if fake:
                return torch.empty(a.shape, dtype=a.dtype, device=device)
            return torch.zeros(a.shape, dtype=a.dtype, device=device)
        return tuple(h if a is None else tree_map(make, a)
                     for a, h in zip(self.abstract, self.host))


def rank_program(cfg, shape_name: str, mode: str, mesh) -> RankProgram:
    """Rank 0's program of ``cfg`` at ``shape_name`` in ``mode`` on
    ``mesh`` (the module docstring)."""
    shape = SHAPES[shape_name]
    cfg = dataclasses.replace(cfg, use_flash_kernel=True,
                              use_slstm_kernel=True)
    axis = data_axes(mesh)
    kw = {}
    if mode in ("train", "neulite"):
        kw["wrap_optimizer"] = lambda opt: data_mean(opt, mesh, axis)
    if mode in ("neulite", "flround"):
        kw["use_hsic_kernel"] = True
    trainable_placements = []
    if mode == "flround":
        kw["aggregate"] = mesh_eq1(mesh, axis, trainable_placements)
    step, abstract, placements, out_placements = steps_mod.BUILDERS[mode](
        cfg, shape_name, mesh, device="cpu", **kw)
    step = step.step
    placements = list(placements)
    host = [None] * len(abstract)
    if mode == "decode":
        B, S = shape.global_batch, shape.seq_len
        placements[2] = sharding.data_tree_placements(
            tx.cache_defs(resolve_config(cfg, shape), B, S), mesh)
        host[3] = S - 1
    if mode == "flround":
        trainable_placements.append(placements[0])
        C, E, b = tree_leaves(abstract[2])[0].shape[:3]
        host[3] = np.full(C, float(b * E))
    per_rank = tuple(
        None if h is not None else
        (shard_abstract(a, p, mesh) if _is_tree(p) else a)
        for a, p, h in zip(abstract, placements, host))

    def run(*args):
        whole = [tree_map(lambda x, q: sharding.unshard(
            x, q.model_dim, mesh), a, p) if _is_tree(p) and h is None
            else a for a, p, h in zip(args, placements, host)]
        outs = step(*whole)
        return tuple(tree_map(lambda x, q: sharding.shard(
            x, q.model_dim, mesh), o, p) if _is_tree(p) else o
            for o, p in zip(outs, out_placements))

    gathers = _model_leaves(placements, mesh)
    n_reduce = 0
    if mode in ("train", "neulite"):
        n_reduce = len(tree_leaves(abstract[1]))
    elif mode == "flround":
        n_reduce = len(tree_leaves(abstract[0])) + 1    # + the loss vector
        gathers += _model_leaves(placements[:1], mesh)  # Eq. 1's aggregate
    return RankProgram(mode, run, per_rank, tuple(host), gathers, n_reduce)


# --------------------------------------------------------------------------- #
# one run of the program
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Trace:
    flops: int
    flops_by_op: Dict[str, int]
    hbm_bytes: int
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    collectives: list
    kernel_calls: List[dict]


def fake_device() -> torch.device:
    """CUDA where torch is built with it, else the CPU (the module
    docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def trace(program: RankProgram, mesh, device=None, fake: bool = True,
          limit: Optional[float] = None) -> Trace:
    """Run ``program`` once on ``device`` (fake tensors unless ``fake`` is
    False: then real ones, which a real run needs room for) and count
    what it does; past ``limit`` seconds it raises ``TimeLimit``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    device = torch.device(fake_device() if device is None else device)
    mode = (FakeTensorMode(allow_non_fake_inputs=True) if fake
            else contextlib.nullcontext())
    with mode:
        args = program.arguments(device, fake)
        counter = TraceCounter(limit)
        arg_bytes = counter.track(args)
        flops = FlopCounterMode(display=False)
        with col.record_collectives() as records, flops, counter:
            out = program.run(*args)
        out_bytes = storage_bytes(out)
        del out
    by_op = {str(k).split(".")[-1]: int(v) for k, v in
             flops.get_flop_counts().get("Global", {}).items()}
    col.classify(records, col.mesh_coords(mesh), mesh.axis_names)
    calls = [{"op": name, "args": list(a), "kwargs": dict(kw), "calls": n}
             for (name, a, kw), n in counter.kernel_calls.items()]
    return Trace(int(flops.get_total_flops()), by_op, counter.hbm_bytes,
                 counter.peak_bytes, arg_bytes, out_bytes, list(records),
                 calls)


def axis_counts(records, kind: str, axes) -> int:
    """Calls of ``kind`` whose group crosses exactly the axes ``axes``."""
    want = (axes,) if isinstance(axes, str) else tuple(axes)
    return sum(1 for r in records if r.kind == kind
               and tuple(r.crossed_axes) == want)


# --------------------------------------------------------------------------- #
# the combinations
# --------------------------------------------------------------------------- #
def mesh_name(multi_pod: bool) -> str:
    return "multipod" if multi_pod else "pod"


def result_path(arch, shape_name, mesh, mode, tag="") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape_name}__{mesh}__{mode}{suffix}.json")


def run_one(arch: str, shape_name: str, multi_pod: bool, mode: str = "auto",
            save: bool = True, verbose: bool = True, tag: str = "",
            world=None, device=None,
            limit: Optional[float] = TIME_LIMIT_S,
            out_path: Optional[str] = None) -> dict:
    """Trace rank 0's program of one combination and record it (saved with
    ``save`` to ``out_path``, by default ``result_path`` in
    ``RESULTS_DIR``, the sweep's set).  ``world``: a smaller mesh of the
    same axes; ``device``: the fake tensors' device (``fake_device`` by
    default)."""
    shape = SHAPES[shape_name]
    if mode == "auto":
        mode = steps_mod.builder_for(shape_name)
    mesh_label = mesh_name(multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_label,
              "mode": mode, "tag": tag, "ok": False}
    t0 = time.perf_counter()
    try:
        cfg = get_config(arch)
        rcfg = resolve_config(cfg, shape, tp=0)        # logical: no padding
        mesh = make_production_mesh(multi_pod, world)
        chips = mesh.size
        program = rank_program(cfg, shape_name, mode, mesh)
        tr = trace(program, mesh, device, limit=limit)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        factor = 6.0 if mode in ("train", "neulite") else 2.0
        model_flops = factor * tx.active_param_count(rcfg) * tokens
        cost_kind = mode if mode == "neulite" else shape.kind
        if mode == "flround":
            cost_kind = "neulite"      # per-local-step cost model applies
        cost = analytic.step_cost(rcfg, cost_kind, shape.global_batch,
                                  shape.seq_len)
        rf, coll = roofline_from_trace(tr, chips, model_flops)
        axis = data_axes(mesh)
        partitioned = cost.flops_global / chips
        record.update({
            "ok": True,
            "trace_s": round(time.perf_counter() - t0, 1),
            "fake_device": str(fake_device() if device is None
                               else device),
            "world": list(mesh.shape.values()),
            "chips": chips,
            "tokens_per_step": tokens,
            "memory_analysis": {
                "argument_size_in_bytes": tr.argument_bytes,
                "output_size_in_bytes": tr.output_bytes,
                "temp_size_in_bytes": tr.peak_bytes - tr.argument_bytes,
                "peak_bytes": tr.peak_bytes,
                "fits_h100": tr.peak_bytes <= HBM_BYTES},
            "counted": {"flops_per_chip": tr.flops,
                        "hbm_bytes_per_chip": tr.hbm_bytes,
                        "flops_by_kernel": {
                            KERNEL_OPS[k]: v for k, v in
                            tr.flops_by_op.items() if k in KERNEL_OPS},
                        "flops_by_op": tr.flops_by_op,
                        "kernel_calls": tr.kernel_calls},
            "analytic": {"flops_global": cost.flops_global,
                         "hbm_bytes_global": cost.hbm_bytes_global,
                         "flops_per_chip_partitioned": partitioned,
                         "counted_over_partitioned":
                             tr.flops / partitioned if partitioned else None},
            "checks": {
                "model_sharded_leaves": program.model_gathers,
                "model_all_gathers": axis_counts(tr.collectives,
                                                 "all_gather", "model"),
                "expected_data_all_reduces": program.data_all_reduces,
                "data_all_reduces": axis_counts(tr.collectives,
                                                "all_reduce", axis)},
            "collectives": coll,
            "roofline": rf.to_dict(),
        })
        if verbose:
            ma = record["memory_analysis"]
            print(f"[OK] {arch} x {shape_name} x {mesh_label} ({mode}) "
                  f"trace={record['trace_s']:.1f}s "
                  f"flops/chip={tr.flops:.3e} (partitioned "
                  f"{partitioned:.3e}) peak={ma['peak_bytes'] / 1e9:.2f}GB "
                  f"fits_h100={ma['fits_h100']} "
                  f"coll/chip={rf.collective_bytes_per_chip:.3e}B "
                  f"bottleneck={rf.bottleneck}", flush=True)
    except Exception as e:                # TimeLimit too
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        record["trace_s"] = round(time.perf_counter() - t0, 1)
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_label} ({mode}): "
                  f"{record['error']}", flush=True)
    if save:
        path = out_path or result_path(arch, shape_name, mesh_label, mode,
                                       tag)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def calibrate(arch: str, shape_name: str, multi_pod: bool,
              mode: str = "auto", world=None, launches=None) -> dict:
    """Rank 0's program of one combination run once for real on the card,
    its collectives over the same fake group (they move nothing; a
    gathered leaf is allocated whole, as on a real mesh): the allocator's
    peak from an empty cache, the ``FlopCounterMode`` count, the
    live-bytes peak and the run's milliseconds (CUDA events around the
    counted run: the counters' host cost included).  ``launches``: the
    kernels' ``LAUNCHES`` dicts, read around the run."""
    if mode == "auto":
        mode = steps_mod.builder_for(shape_name)
    mesh = make_production_mesh(multi_pod, world)
    program = rank_program(get_config(arch), shape_name, mode, mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for counts in launches or ():
        for k in counts:
            counts[k] = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tr = trace(program, mesh, dev, fake=False)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counted = [dict(c) for c in launches or ()]
    torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            "mode": mode, "max_memory_allocated": peak,
            "tracked_peak_bytes": tr.peak_bytes, "flops": tr.flops,
            "flops_by_kernel": {KERNEL_OPS[k]: v for k, v in
                                tr.flops_by_op.items() if k in KERNEL_OPS},
            "ms": start.elapsed_time(end), "launches": counted}


def _child(arch, shape, mesh, mode, limit, devices):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--mode", mode,
           "--time-limit", str(limit)]
    if devices:
        cmd += ["--devices", devices]
    return subprocess.Popen(cmd)


def sweep(archs, shapes, meshes, modes=("auto",), skip_existing=True,
          jobs: int = 1, limit: Optional[float] = TIME_LIMIT_S,
          devices: Optional[str] = None):
    """Every combination, ``jobs`` at a time (each in a process of its own
    when ``jobs > 1``, killed 60 s past its limit)."""
    todo, results = [], []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                for mode in modes:
                    eff = steps_mod.builder_for(shape) if mode == "auto" \
                        else mode
                    fn = result_path(arch, shape, mesh, eff)
                    if skip_existing and os.path.exists(fn):
                        with open(fn) as f:
                            rec = json.load(f)
                        if rec.get("ok"):
                            results.append(rec)
                            continue
                    todo.append((arch, shape, mesh, eff))
    # the long traces first (recurrent step loops at long sequences), so
    # that they do not end the sweep alone
    todo.sort(key=lambda c: (c[0] not in RECURRENT,
                             -SHAPES[c[1]].seq_len
                             * (SHAPES[c[1]].kind != "decode")))
    if jobs <= 1:
        for arch, shape, mesh, mode in todo:
            results.append(run_one(arch, shape, mesh == "multipod", mode,
                                   world=_world(devices, mesh == "multipod"),
                                   limit=limit))
    else:
        running = []
        queue = list(todo)
        while queue or running:
            while queue and len(running) < jobs:
                c = queue.pop(0)
                running.append((c, _child(*c, limit, devices),
                                time.monotonic()))
            time.sleep(0.5)
            for item in list(running):
                c, proc, start = item
                late = limit and time.monotonic() - start > limit + 60
                if proc.poll() is None and not late:
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                running.remove(item)
                fn = result_path(*c)
                rec = None
                if os.path.exists(fn):
                    with open(fn) as f:
                        rec = json.load(f)
                if rec is None or (late and not rec.get("ok")):
                    why = (f"TimeLimit: killed {limit + 60:.0f} s in"
                           if late else f"process ended without a record "
                           f"(exit {proc.returncode})")
                    rec = {"arch": c[0], "shape": c[1], "mesh": c[2],
                           "mode": c[3], "tag": "", "ok": False,
                           "error": why}
                    os.makedirs(RESULTS_DIR, exist_ok=True)
                    with open(fn, "w") as f:
                        json.dump(rec, f, indent=1)
                results.append(rec)
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\nsweep: {ok}/{len(results)} combinations traced", flush=True)
    return results


def table(records) -> str:
    """A markdown table of sweep records, one row a combination: ok (or
    the error's type), trace seconds, peak GB per rank, ``fits_h100``,
    counted and partitioned FLOPs per rank and their ratio, collective
    bytes per rank, bottleneck."""
    rows = ["| arch | shape | mesh | mode | ok | trace s | peak GB/rank | "
            "fits_h100 | FLOPs/rank counted | partitioned | ratio | "
            "collective B/rank | bottleneck |",
            "| --- " * 13 + "|"]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    shapes = list(SHAPES)
    for r in sorted(records, key=lambda r: (order.get(r["arch"], 99),
                                            shapes.index(r["shape"]),
                                            r["mesh"] != "pod")):
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['mode']} "
        if not r.get("ok"):
            why = str(r.get("error", "")).split(":")[0]
            rows.append(head + f"| no: {why} | {r.get('trace_s', '')} |"
                        + " |" * 7)
            continue
        ma, a, rf = r["memory_analysis"], r["analytic"], r["roofline"]
        rows.append(
            head + f"| yes | {r['trace_s']} | {ma['peak_bytes'] / 1e9:.2f} "
            f"| {ma['fits_h100']} | {r['counted']['flops_per_chip']:.3e} | "
            f"{a['flops_per_chip_partitioned']:.3e} | "
            f"{a['counted_over_partitioned']:.2f} | "
            f"{rf['collective_bytes_per_chip']:.3e} | {rf['bottleneck']} |")
    return "\n".join(rows)


def _world(devices: Optional[str], multi_pod: bool):
    """``--devices AxB`` (``AxBxC`` multi-pod): a smaller mesh of the same
    axes, one size an axis; ``None`` for the production mesh."""
    if not devices:
        return None
    return tuple(int(n) for n in devices.split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES.keys()) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--mode", default="auto", choices=["auto", *MODES])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run even if a result file exists")
    ap.add_argument("--devices", default=None,
                    help="a smaller mesh of the same axes: AxB (AxBxC "
                         "multi-pod)")
    ap.add_argument("--tag", default="",
                    help="suffix for the result filename (ablation runs)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once in a sweep")
    ap.add_argument("--time-limit", type=float, default=TIME_LIMIT_S,
                    help="seconds a combination may take (0: none)")
    ap.add_argument("--calibrate", nargs="+", metavar="ARCH:SHAPE:MESH",
                    help="run rank 0's program of each combination for "
                         "real on the card (calibrate)")
    ap.add_argument("--out", default=None,
                    help="with --calibrate: write the rows here as JSON; "
                         "for one combination: write its record here, "
                         "outside the sweep's set")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records as a markdown table")
    args = ap.parse_args(argv)

    if args.table:
        records = []
        for fn in sorted(os.listdir(RESULTS_DIR)):
            with open(os.path.join(RESULTS_DIR, fn)) as f:
                rec = json.load(f)
            if not rec.get("tag"):
                records.append(rec)
        print(table(records))
        return

    if args.calibrate:
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.hsic_gram import kernel as hk
        from repro_torch.kernels.slstm_scan import kernel as sk
        rows = []
        for spec in args.calibrate:
            arch, shape, mesh, *mode = spec.split(":")
            multi = mesh == "multipod"
            rows.append(calibrate(arch, shape, multi, *(mode or ["auto"]),
                                  world=_world(args.devices, multi),
                                  launches=(hk.LAUNCHES, fk.LAUNCHES,
                                            sk.LAUNCHES)))
            print(json.dumps(rows[-1]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
        return

    if args.sweep:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES.keys())
        meshes = ["pod", "multipod"] if args.arch is None and \
            args.shape is None else [args.mesh]
        sweep(archs, shapes, meshes, modes=(args.mode,),
              skip_existing=not args.force, jobs=args.jobs,
              limit=args.time_limit, devices=args.devices)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --sweep)")
        multi = args.mesh == "multipod"
        run_one(args.arch, args.shape, multi, args.mode, tag=args.tag,
                world=_world(args.devices, multi), limit=args.time_limit,
                out_path=args.out)


if __name__ == "__main__":
    main()
