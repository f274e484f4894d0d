"""Where a call of the sLSTM scan kernels (K5, ``kernels/slstm_scan``)
spends its device time: the forward and the backward kernel timed as built
and with one part cut out at a time, on one card.

    python src/repro_torch/benchmarks/slstm_parts.py [--out <file.jsonl>]

The card's profilers (``ncu``, ``nsys``) are not available, so this builds
copies of ``csrc/slstm_scan.cu`` with one part removed each (under
``build/kernels/parts/``, one ``nvcc`` per copy, started together) and
times every copy at the xlstm-1.3b shape (B=16, S=256, H=4, Dh=512) with
the same inputs.  A cut copy computes wrong numbers; only its time means
something: the full kernel's time less the cut copy's is what the part
costs.  The parts:

* ``products``: the recurrent products (in the forward with their reads
  of h_{t-1} from L2);
* ``barrier``: the per-head barrier between steps (a block-local
  ``__syncthreads`` instead);
* ``partial_sums``: the backward's sums of the other blocks' partial
  dh_{t-1};
* ``two_of_three_mmas``: two of the three ``mma.sync`` of each 3xTF32
  product (both kernels), what the accuracy of 3xTF32 costs over one TF32
  pass.

Prints one JSON line per copy: the forward's and the backward's device ms
per call (the profiler's time of the kernel, mean of 10 calls), and the
card's name.  The full kernel is timed first and last.  Needs a CUDA card
and ``nvcc``; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (16, 256, 4, 512)

# (part, [(text in csrc/slstm_scan.cu, its replacement)]); every text must
# occur once, so an edit of the kernel that moves it fails here loudly
CUTS = [
    ("products", [
        ("fwd_product(acc, h_prev, stride, b0, r_s, 0, d.Dh16 / 16, d);", ""),
        ("bwd_product(dst, dg_s, rt_s, 0, d.Dh64 / 64, b0, d);", "")]),
    ("barrier", [
        ("if (t + 1 < d.S) head_barrier(counters + head, (t + 1) * d.Gh);",
         "__syncthreads();"),
        ("    head_barrier(counters + head, (d.S - t) * d.Gh);",
         "    __syncthreads();")]),
    ("partial_sums", [
        ("""carry = sum_partials(part((t + 1) & 1, 0) +
                                   static_cast<size_t>(b) * d.Dh + j,
                               tile_stride, d.T);""", "carry = 0.0f;")]),
    ("two_of_three_mmas", [
        ("""    mma_tf32(c[nt], al, bh0, bh1);
    mma_tf32(c[nt], ah, bl0, bl1);
""", "")]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("slstm_parts: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.build import (BUILD_DIR, NVCC_FLAGS, nvcc,
                                           open_library)
    from repro_torch.kernels.slstm_scan import kernel
    torch.backends.cuda.matmul.allow_tf32 = False

    source = kernel.SOURCE.read_text()
    out_dir = BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = {"full": source}
    for part, edits in CUTS:
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"slstm_parts: the cut {part!r} no longer "
                                   f"matches {kernel.SOURCE}")
            text = text.replace(old, new)
        copies[part] = text
    jobs = {}
    for name, text in copies.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"slstm_parts: nvcc failed on {name}:\n{log}")

    B, S, H, Dh = SHAPE
    gen = torch.Generator().manual_seed(0)
    g_in = torch.randn((B, S, 4, H, Dh), generator=gen).cuda()
    r = (torch.randn((4, H, Dh, Dh), generator=gen) * Dh ** -0.5).cuda()
    b = (torch.randn((4, H, Dh), generator=gen) * 0.1).cuda()
    st = [torch.zeros((B, H, Dh), device="cuda") + v
          for v in (0.0, 0.0, -30.0, 0.0)]
    cot = [torch.randn((B, S, H, Dh), generator=gen).cuda()] + [
        torch.randn((B, H, Dh), generator=gen).cuda() for _ in range(4)]

    def device_ms(fn, name, runs=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name)
        return us / 1e3 / runs if us else None

    saved = None
    lines = []
    for name in ["full", *(p for p, _ in CUTS), "full"]:
        lib = open_library(out_dir / f"{name}.so")
        for fn, argtypes in kernel._ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernel._lib = lib
        if saved is None:     # the full kernel's saved states feed every run
            saved = kernel.slstm_scan_fwd(g_in, r, b, *st, save=True)[5:]
        row = {"copy": name, "shape": list(SHAPE),
               "fwd_device_ms": device_ms(
                   lambda: kernel.slstm_scan_fwd(g_in, r, b, *st),
                   "slstm_fwd_kernel"),
               "bwd_device_ms": device_ms(
                   lambda: kernel.slstm_scan_bwd(*saved, r, *st[:3], *cot),
                   "slstm_bwd_kernel"),
               "card": torch.cuda.get_device_name(0)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
