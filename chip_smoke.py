#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/hsic_gram/csrc/
   nhsic.cu`` with ``nvcc`` and prints the build time.
2. Kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card (forward, and the autograd backward of nHSIC), at the main
   path's shapes and at batches/widths off the 32-row tile, with TF32 off.
   Bar: scale-relative 1e-3 in f32.  Times each kernel and its plain version
   at the main path's shapes (CUDA events, median of 30 calls).
3. Main path: the port's ``NeuLiteServer`` (sequential runtime, nHSIC
   through the kernels) on the paper's ResNet18 at full width, 32x32x3,
   10 classes, batch 32, 4 stages: four rounds, one per stage, over a
   100-device fleet, then an evaluation.  The kernels' launch counts are set
   to 0 just before and read just after; every kernel must have launched.
4. Checks the kernel path against the plain nHSIC on one full-width step of
   each stage, then profiles five steps of each stage (``torch.profiler``):
   wall time, device busy time, idle share, the nHSIC kernels' share.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.realpath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = 1e-3
SEED = 0

# (B, Dx, Dz, linear_x): h_xz at the four ResNet18 stages, then h_yz
MAIN_PATH_SHAPES = [(32, 3, 64, False), (32, 64, 128, False),
                    (32, 128, 256, False), (32, 256, 512, False),
                    (32, 10, 64, True)]
# off the tile: B in {48, 256}, D in {1, 512}; then identical rows
EXTRA_SHAPES = [(48, 1, 512, False), (48, 512, 1, True), (256, 1, 512, False),
                (256, 512, 1, True), (256, 512, 512, False)]
DEGENERATE_SHAPES = [(32, 5, 8, False), (48, 10, 64, True)]
TIMED_SHAPE = (32, 256, 512, False)   # the main path's largest call


class SmokeError(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeError(what)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, runs=30, warmup=5):
    """Median of ``runs`` CUDA-event timings of one call each (the event
    pair also spans the host's launch gap, which bounds these calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --------------------------------------------------------------------------- #
# least time of each kernel: bytes each input read once and each output
# written once, FLOPs the function needs; bound = max of the two times
# --------------------------------------------------------------------------- #
def gram_flops(B, D, linear):
    # dot products, plus |a|^2+|b|^2-2ab, clamp, scale and exp per entry
    return 2 * B * B * D + (0 if linear else 6 * B * B)


def work(name, B, Dx, Dz, lx, lz=False):
    grams = gram_flops(B, Dx, lx) + gram_flops(B, Dz, lz)
    act = 4 * B * (Dx + Dz)
    if name == "nhsic_rowsums":
        return act + 8 + 8 * B, grams + 2 * B * B
    if name == "nhsic_stats_feats":
        # centring (3 per entry per Gram) and three products with sums
        return act + 8 * B + 16 + 12, grams + 12 * B * B
    # centring, G (3 each), W (2 each), W.x and the row-sum term
    return (act + 8 * B + 28 + act,
            grams + 16 * B * B + 2 * B * B * (Dx + Dz) + 4 * B * (Dx + Dz))


def bound_ms(name, shape):
    nbytes, flops = work(name, *shape)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
def inputs(torch, B, Dx, Dz, lx, degenerate=False):
    g = torch.Generator().manual_seed(B * 7919 + Dx * 31 + Dz)
    if lx:
        x = torch.eye(Dx)[torch.randint(0, Dx, (B,), generator=g)]
    else:
        x = torch.randn(B, Dx, generator=g)
    z = torch.randn(B, Dz, generator=g)
    if degenerate:
        x, z = x[:1].repeat(B, 1), z[:1].repeat(B, 1)
    return x.cuda(), z.cuda()


def kernel_args(torch, hsic, ref, x, z, lx):
    """Inputs of each kernel as the nHSIC forward/backward builds them."""
    B = x.shape[0]
    one = torch.ones((), device=x.device)
    s2 = torch.stack([one if lx else hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = ref.nhsic_rowsums(x, z, s2, linear_x=lx)
    rx, rz = rxs / B, rzs / B
    s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=x.device)])
    return {"nhsic_rowsums": ((x, z, s2), {"linear_x": lx}),
            "nhsic_stats_feats": ((x, z, rx, rz, s), {"linear_x": lx}),
            "nhsic_grad": ((x, z, rx, rz, scal), {"linear_x": lx})}


def rel_abs(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    rel = ab = 0.0
    for a, b in zip(got, want):
        d = float((a - b).abs().max())
        ab = max(ab, d)
        rel = max(rel, d / max(float(b.abs().max()), 1e-6))
    return rel, ab


def kernel_phase(torch, kernel, ops, ref, hsic):
    names = list(kernel.LAUNCHES)
    max_abs = {n: 0.0 for n in names}
    cases = ([(s, False) for s in MAIN_PATH_SHAPES + EXTRA_SHAPES]
             + [(s, True) for s in DEGENERATE_SHAPES])
    for (B, Dx, Dz, lx), degenerate in cases:
        x, z = inputs(torch, B, Dx, Dz, lx, degenerate)
        args = kernel_args(torch, hsic, ref, x, z, lx)
        line = []
        for n in names:
            a, kw = args[n]
            rel, ab = rel_abs(getattr(kernel, n)(*a, **kw),
                              getattr(ref, n)(*a, **kw))
            torch.cuda.synchronize()
            check(rel <= TOL, f"{n} at {(B, Dx, Dz, lx)}: rel err {rel}")
            max_abs[n] = max(max_abs[n], ab)
            line.append(f"{n} {rel:.2e}")
        kx = "linear" if lx else "rbf"
        xa, za = x.clone().requires_grad_(), z.clone().requires_grad_()
        xb, zb = x.clone().requires_grad_(), z.clone().requires_grad_()
        v = ops.nhsic(xa, za, kernel_x=kx)
        v.backward()
        vb = hsic.nhsic(xb, zb, kernel_x=kx)
        vb.backward()
        v, vb = float(v.detach()), float(vb.detach())
        rel_v = abs(v - vb) / max(abs(vb), 1e-6)
        rel_g, _ = rel_abs((xa.grad, za.grad), (xb.grad, zb.grad))
        check(rel_v <= TOL and rel_g <= TOL,
              f"autograd nHSIC at {(B, Dx, Dz, lx)}: {rel_v}, {rel_g}")
        check(bool(torch.isfinite(xa.grad).all() & torch.isfinite(za.grad)
                   .all()), "non-finite nHSIC grad")
        tag = " degenerate" if degenerate else ""
        print(f"  check B={B} Dx={Dx} Dz={Dz} linear_x={lx}{tag}: "
              + ", ".join(line)
              + f", nhsic value {rel_v:.2e} grad {rel_g:.2e}", flush=True)
    a, _ = kernel_args(torch, hsic, ref, *inputs(torch, 256, 64, 128, False),
                       False)["nhsic_stats_feats"]
    first = kernel.nhsic_stats_feats(*a)
    check(all(torch.equal(first, kernel.nhsic_stats_feats(*a))
              for _ in range(3)), "nhsic_stats_feats differs between runs")
    return max_abs


def timing_phase(torch, kernel, ref, hsic):
    rows = []
    for shape in MAIN_PATH_SHAPES:
        B, Dx, Dz, lx = shape
        x, z = inputs(torch, B, Dx, Dz, lx)
        args = kernel_args(torch, hsic, ref, x, z, lx)
        for n in kernel.LAUNCHES:
            a, kw = args[n]
            ms = time_ms(torch, lambda: getattr(kernel, n)(*a, **kw))
            plain = time_ms(torch, lambda: getattr(ref, n)(*a, **kw))
            b_ms, b_by = bound_ms(n, (B, Dx, Dz, lx))
            rows.append({"name": n, "shape": [B, Dx, Dz, lx], "ms": ms,
                         "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"  time {n} B={B} Dx={Dx} Dz={Dz} linear_x={lx}: "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {b_ms:.2e} ms ({b_by})", flush=True)
    return rows


def main_path(torch, kernel, np):
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer
    from repro_torch.models.cnn import CNNConfig

    ccfg = CNNConfig(name="resnet18", arch="resnet18", num_classes=10,
                     image_size=32, width_mult=1.0)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=4, use_hsic_kernel=True,
                   runtime="sequential", seed=SEED)
    adapter = make_adapter(ccfg, flc.num_stages)
    ds = make_image_dataset(SEED, 16000, num_classes=10, image_size=32)
    parts = dirichlet_partition(SEED, ds.labels, flc.n_devices,
                                alpha=flc.alpha)
    test = Batcher(make_image_dataset(SEED + 1, 512, num_classes=10,
                                      image_size=32), 32, seed=SEED)
    server = NeuLiteServer(adapter, [ds.subset(p) for p in parts], flc,
                           test_batcher=test)
    steps = [b.steps_per_epoch for b in server.batchers]
    print(f"  clients: {len(steps)}, local steps per epoch: min {min(steps)} "
          f"median {int(np.median(steps))} max {max(steps)}", flush=True)

    kernel.reset_launches()
    rounds = []
    for r in range(flc.num_stages):
        before = dict(kernel.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rr = server.run_round(r)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: kernel.LAUNCHES[n] - before[n] for n in before}
        row = dict(vars(rr), seconds=sec, peak_bytes=peak,
                   launches=launches)
        rounds.append(row)
        print(f"  round {r}: {rr}", flush=True)
        print(f"    {sec:.3f} s, peak allocated {peak / 2**20:.1f} MiB, "
              f"launches {launches}", flush=True)
    counts = dict(kernel.LAUNCHES)

    check(all(c > 0 for c in counts.values()), f"a kernel never ran: {counts}")
    check(len(set(counts.values())) == 1 and counts["nhsic_grad"] % 2 == 0,
          f"expected 2 launches of each kernel per step: {counts}")
    check(any(r["n_feasible"] > 0 for r in rounds), "no feasible round")
    check(all(math.isfinite(r["mean_loss"]) for r in rounds
              if r["n_selected"] > 0), "non-finite round loss")
    check(all(bool(torch.isfinite(p).all()) for p in
              _leaves(server.params)), "non-finite params")
    acc = rounds[-1]["test_acc"]
    check(acc is not None and 0.0 <= acc <= 1.0, f"bad accuracy {acc}")
    return server, rounds, counts


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def step_check(torch, server):
    """One full-width step per stage: nHSIC through the kernels against the
    plain nHSIC, same params and batch."""
    from repro_torch.common.device import to_device
    from repro_torch.core.progressive import make_stage_step
    from repro_torch.optim.optimizers import sgd
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    out = []
    for t in range(server.adapter.plan.num_stages):
        frozen, trainable = server.adapter.split_stage(server.params, t)
        res = []
        for use_kernel in (True, False):
            opt = sgd(server.flc.lr)
            hp = dataclasses.replace(server.hp, use_hsic_kernel=use_kernel)
            step = make_stage_step(server.adapter, opt, hp, t)
            _, new, m = step(opt.init(trainable), trainable, frozen, batch,
                             trainable)
            res.append((new, m))
        (kn, km), (pn, pm) = res
        loss_rel = abs(float(km["loss"] - pm["loss"])) / max(
            abs(float(pm["loss"])), 1e-6)
        scale = max(float(p.abs().max()) for p in _leaves(pn))
        tree_rel = max(float((a - b).abs().max())
                       for a, b in zip(_leaves(kn), _leaves(pn))) / scale
        check(loss_rel <= TOL and tree_rel <= TOL,
              f"stage {t} kernel vs plain step: {loss_rel}, {tree_rel}")
        out.append({"stage": t, "loss_rel": loss_rel, "params_rel": tree_rel,
                    "nhsic_xz": float(km["nhsic_xz"]),
                    "nhsic_yz": float(km["nhsic_yz"])})
        print(f"  stage {t} step, kernel vs plain nHSIC: loss rel "
              f"{loss_rel:.2e}, params rel {tree_rel:.2e}", flush=True)
    return out


NHSIC_KERNELS = ("rowsums_kernel", "stats_kernel", "sum_partials_kernel",
                 "grad_kernel")


def step_profile(torch, server, steps=5):
    """Where a full-width local step's time goes: ``torch.profiler`` over
    ``steps`` steps of each stage (after two warm-up steps).  Device busy
    time is the sum of the card's kernel and copy times; the rest of the
    host-clock wall time the card sits idle."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.device import to_device
    from repro_torch.core.progressive import make_stage_step
    from repro_torch.optim.optimizers import sgd
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    out = []
    for t in range(server.adapter.plan.num_stages):
        frozen, trainable = server.adapter.split_stage(server.params, t)
        opt = sgd(server.flc.lr)
        step = make_stage_step(server.adapter, opt, server.hp, t)
        state = opt.init(trainable)
        for _ in range(2):
            state, trainable, _ = step(state, trainable, frozen, batch,
                                       trainable)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, trainable, _ = step(state, trainable, frozen, batch,
                                           trainable)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / steps)
        busy = sum(by_name.values())
        nhsic = sum(v for k, v in by_name.items()
                    if any(n in k for n in NHSIC_KERNELS))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row = {"stage": t, "wall_ms_per_step": wall_ms,
               "device_busy_ms_per_step": busy if by_name else None,
               "nhsic_kernels_ms_per_step": nhsic if by_name else None,
               "idle_share": 1.0 - busy / wall_ms if by_name else None,
               "device_kernels_per_step": sum(
                   1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
               "top": [[k[:90], v] for k, v in top]}
        out.append(row)
        if by_name:
            print(f"  stage {t}: {wall_ms:.2f} ms/step wall, device busy "
                  f"{busy:.2f} ms (nHSIC kernels {nhsic:.3f} ms), idle "
                  f"{row['idle_share']:.1%}, "
                  f"{row['device_kernels_per_step']:.0f} device ops/step",
                  flush=True)
        else:
            print(f"  stage {t}: {wall_ms:.2f} ms/step wall; the profiler "
                  f"recorded no device time", flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.core import hsic
    from repro_torch.kernels.hsic_gram import kernel, ops, ref

    smi = smi_line()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    t0 = time.perf_counter()
    kernel.library()
    build_s = time.perf_counter() - t0
    print(f"built {os.path.relpath(kernel.SOURCE, ROOT)} in {build_s:.2f} s",
          flush=True)

    print("kernel phase", flush=True)
    max_abs = kernel_phase(torch, kernel, ops, ref, hsic)
    timing = timing_phase(torch, kernel, ref, hsic)
    print("main path", flush=True)
    server, rounds, counts = main_path(torch, kernel, np)
    print("step check", flush=True)
    steps = step_check(torch, server)
    print("step profile", flush=True)
    profiles = step_profile(torch, server)

    source = os.path.relpath(kernel.SOURCE, ROOT)
    replaces = {"nhsic_rowsums":
                "src/repro/kernels/hsic_gram/kernel.py:232",
                "nhsic_stats_feats":
                "src/repro/kernels/hsic_gram/kernel.py:304",
                "nhsic_grad": "src/repro/kernels/hsic_gram/kernel.py:403"}
    kernels = []
    for n in kernel.LAUNCHES:
        row = next(r for r in timing if r["name"] == n
                   and tuple(r["shape"]) == TIMED_SHAPE)
        kernels.append({"name": n, "route": "cuda", "source": source,
                        "replaces": replaces[n], "launches": counts[n],
                        "max_abs_err": max_abs[n], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None,
                        "shape": row["shape"]})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"smi": smi, "torch": torch.__version__,
                   "build_seconds": build_s, "timing": timing,
                   "rounds": rounds, "launches": counts, "step_check": steps,
                   "step_profile": profiles, "kernels": kernels,
                   "device": device}, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
