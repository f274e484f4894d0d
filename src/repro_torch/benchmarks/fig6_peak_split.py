"""Where a Fig. 6 peak goes: the blocks live at the allocator's peak of a
measurement, by what allocated them.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_peak_split \\
        [--arch squeezenet ...] --out FILE

For each named CNN of the paper at batch 128 (``fig6_memory``'s
measurement: two local steps on the same two batches, from an empty cache,
nHSIC through K1-K3) it measures every stage's and the full step's peak
twice: with cuDNN's convolutions in f32 (as ``fig6_memory`` runs them) and
with cuDNN's TF32 allowed (PyTorch's default).  Each measurement records
the allocator's history (``torch.cuda.memory._record_memory_history``),
replays it to the moment of the peak and sums the blocks live there:

- ``held tree``: what ``measure_local_training`` put on the card before
  the first step;
- ``cuDNN workspace``: blocks allocated under a native frame whose name
  holds ``workspace`` or ``run_conv_plan`` (cuDNN's scratch space of a
  convolution, freed when the convolution returns);
- the rest by the innermost frame of the port that allocated it, and the
  operator (``at::_ops::...``) under it.

It also names the allocation that set the peak.  A card is needed.
"""
from __future__ import annotations

import argparse
import collections
import re
from typing import List

import torch

from repro_torch.analysis.memory import measure_local_training
from repro_torch.benchmarks import fig6_memory as fig6
from repro_torch.benchmarks.common import write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.optim.optimizers import sgd

MIB = 2 ** 20
WORKSPACE = re.compile(r"workspace|run_conv_plan", re.I)


def _names(frames) -> List[str]:
    return [f.get("name", "") for f in frames]


def _category(frames) -> str:
    names = _names(frames)
    if "measure_local_training" in names and not any(
            n.startswith("run_local_training") for n in names):
        return "held tree"
    if any(WORKSPACE.search(n) for n in names):
        return "cuDNN workspace"
    port = next((f for f in frames if "repro_torch" in f.get("filename", "")
                 and "analysis/memory.py" not in f["filename"]), None)
    op = next((n.split("(")[0] for n in names if n.startswith("at::_ops::")),
              "")
    where = (f"{port['filename'].split('repro_torch/')[-1]}:{port['line']} "
             f"{port['name']}" if port else "outside the port")
    return f"{where} [{op}]" if op else where


def peak_split(trace, baseline: int) -> dict:
    """Replays ``trace`` (one device's allocator events) from ``baseline``
    bytes allocated and returns the bytes live at the peak by category,
    and the allocation that set the peak."""
    live, cur, peak, at = set(), baseline, baseline, None
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live.add(ev["addr"])
            cur += ev["size"]
            if cur > peak:
                peak, at = cur, i
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            live.remove(ev["addr"])
            cur -= ev["size"]
    # the blocks live just after event ``at``
    alive = {}
    for ev in trace[:at + 1] if at is not None else []:
        if ev["action"] == "alloc":
            alive[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            alive.pop(ev["addr"], None)
    by = collections.Counter()
    for ev in alive.values():
        by[_category(ev["frames"])] += ev["size"]
    setter = trace[at] if at is not None else None
    return {"replay_peak_bytes": peak, "baseline_bytes": baseline,
            "by_category": dict(by.most_common()),
            "peak_set_by": None if setter is None else {
                "size": setter["size"],
                "category": _category(setter["frames"]),
                "frames": [n for n in _names(setter["frames"])
                           if n.startswith("at::")][:12]}}


def measure_split(adapter, params, batches, opt, hp, stage, device) -> dict:
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated(device)
    torch.cuda.memory._record_memory_history(
        enabled="all", context="all", stacks="all", max_entries=1_000_000)
    try:
        m = measure_local_training(adapter, params, batches, opt,
                                   stage=stage, hp=hp, device=device)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    split = peak_split(snap["device_traces"][device.index or 0], baseline)
    return dict(split, peak_bytes=m.peak_bytes,
                resident_bytes=m.resident_bytes)


def run(archs, device=None, out_path=None) -> dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("fig6_peak_split reads the CUDA allocator")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in archs:
        stages = dict(fig6.CNNS)[arch]
        adapter = fig6.cnn_adapter(arch, stages)
        params = adapter.init_params(fig6.SEED, "cpu")
        batches = fig6.image_batches(adapter, fig6.PAPER_BATCH)
        opt, hp = sgd(fig6.LR), CurriculumHP(use_hsic_kernel=True)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            key = f"{arch} cudnn.allow_tf32={tf32}"
            out[key] = {}
            for stage in list(range(stages)) + [None]:
                label = "full" if stage is None else f"stage {stage}"
                r = measure_split(adapter, params, batches, opt, hp, stage,
                                  device)
                out[key][label] = r
                print(f"  {key} {label}: peak {r['peak_bytes'] / MIB:.1f} "
                      f"MiB (replayed {r['replay_peak_bytes'] / MIB:.1f}), "
                      f"resident {r['resident_bytes'] / MIB:.1f} MiB",
                      flush=True)
                for cat, b in list(r["by_category"].items())[:8]:
                    print(f"      {b / MIB:9.1f} MiB  {cat}", flush=True)
                s = r["peak_set_by"]
                if s is not None:
                    print(f"      peak set by a {s['size'] / MIB:.1f} MiB "
                          f"block: {s['category']}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    if out_path is not None:
        write_bench_json(out_path, {"rows": out}, device,
                         batch=fig6.PAPER_BATCH)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", action="append",
                   choices=[a for a, _ in fig6.CNNS],
                   help="CNN to split (repeatable; default squeezenet)")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None, help="JSON file to write")
    args = p.parse_args(argv)
    run(args.arch or ["squeezenet"], device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
