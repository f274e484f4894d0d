"""Paper Fig. 7: training time of each NeuLite stage's step against the
full-model step (port of the reference's ``benchmarks/fig7_time.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_time \
        [--width W] [--image-size S] [--batch B] [--device cpu] [--out FILE]

The paper reports a 1.84-2.31x per-round speedup on a Jetson TX2.  For
each arch: the full-model step (``make_full_step``) and each of the 4
stage steps (``make_stage_step``, the curriculum loss with nHSIC through
the kernels K1-K3, mu = 0) on one random batch, at each (width, image
size) of ``sizes``, each the median of 5 calls
after one warm-up, as the reference times them.  On the card the calls
are timed with CUDA events, for the eager step and for the captured one
(``jit_stage_step`` / ``jit_full_step``: one CUDA-graph replay a step,
its warm-ups and capture in the warm-up call); on the CPU with the host
clock, eager only (the CPU has no captured step).  Speedup = full / stage.
The defaults are the reference's (width 0.5, 16x16 images, batch 32).
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import ensure_dir, write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (donation_supported, jit_full_step,
                                          jit_stage_step, make_adapter,
                                          make_full_step, make_stage_step)
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim.optimizers import sgd

WARMUP, ITERS = 1, 5
STAGES = 4
PAPER_SPEEDUP = (1.84, 2.31)


def step_ms(fn, device, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Median ms of one call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(ts))


def _times(ad, params, batch, device, captured: bool) -> dict:
    opt = sgd(0.05)
    hp = CurriculumHP(mu=0.0, use_hsic_kernel=True)
    if captured:
        full_step = jit_full_step(ad, opt, device=device)
    else:
        full_step = make_full_step(ad, opt)
    ostate = opt.init(params)
    full = step_ms(lambda: full_step(ostate, params, batch), device)
    getattr(full_step, "release", lambda: None)()
    stages = []
    for t in range(STAGES):
        frozen, trainable = ad.split_stage(params, t)
        if captured:
            step = jit_stage_step(ad, opt, hp, t, device=device)
        else:
            step = make_stage_step(ad, opt, hp, t)
        st = opt.init(trainable)
        stages.append(step_ms(
            lambda: step(st, trainable, frozen, batch, trainable), device))
        getattr(step, "release", lambda: None)()
    return {"full_ms": full, "stage_ms": stages,
            "speedups": [full / s for s in stages]}


def size_label(width: float, image_size: int) -> str:
    return f"width {width}, {image_size}x{image_size}"


def run(archs=("resnet18", "vgg11"), batch: int = 32, quiet: bool = False,
        device=None, sizes=((0.5, 16),), out_path=None) -> dict:
    """Rows keyed by ``size_label(width, image_size)`` for each of
    ``sizes``, then by arch."""
    device = resolve_device(device)
    out = {}
    for width, image_size in sizes:
        label = size_label(width, image_size)
        out[label] = rows = {}
        rng = np.random.default_rng(0)
        for arch in archs:
            ccfg = CNNConfig(name=arch, arch=arch, image_size=image_size,
                             width_mult=width)
            ad = make_adapter(ccfg, num_stages=STAGES)
            params = ad.init_params(0, device)
            batch_data = {
                "inputs": {"images": torch.as_tensor(rng.standard_normal(
                    (batch, image_size, image_size, 3)), dtype=torch.float32,
                    device=device)},
                "labels": torch.as_tensor(rng.integers(0, 10, batch),
                                          dtype=torch.int32, device=device)}
            row = {"eager": _times(ad, params, batch_data, device, False),
                   "captured": (_times(ad, params, batch_data, device, True)
                                if donation_supported(device)
                                else "not measured (no captured step off "
                                     "the card)")}
            rows[arch] = row
            if quiet:
                continue
            for kind, r in row.items():
                if isinstance(r, str):
                    continue
                sp = r["speedups"]
                print(f"fig7 {label} {arch} {kind}: full="
                      f"{r['full_ms']:.3f}ms stages="
                      f"{[f'{s:.3f}' for s in r['stage_ms']]}ms speedup="
                      f"{min(sp):.2f}-{max(sp):.2f}x (paper "
                      f"{PAPER_SPEEDUP[0]}-{PAPER_SPEEDUP[1]}x)", flush=True)
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"), "fig7_time.json")
    write_bench_json(out_path, {"rows": out, "paper_speedup": PAPER_SPEEDUP},
                     device, batch=batch, warmup=WARMUP, iters=ITERS,
                     clock="cuda events" if device.type == "cuda"
                     else "host")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=float, default=0.5)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/fig7_time.json)")
    a = ap.parse_args(argv)
    run(batch=a.batch, device=a.device, sizes=((a.width, a.image_size),),
        out_path=a.out)


if __name__ == "__main__":
    main()
