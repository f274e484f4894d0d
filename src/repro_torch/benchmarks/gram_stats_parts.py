"""Where a call of the dense-Gram statistics kernel (K7, ``gram_stats`` in
``kernels/hsic_gram/csrc/nhsic.cu``) spends its device time: the kernel
timed as built and with one part cut out at a time, on one card.

    python src/repro_torch/benchmarks/gram_stats_parts.py [--out <file.jsonl>]

The card's profilers (``ncu``, ``nsys``) are not available, so this builds
copies of ``nhsic.cu`` with one part of K7 removed each (under
``build/kernels/gram_stats_parts/``, one ``nvcc`` per copy, started
together) and times every copy at B = 256 and 32 on the Grams
``chip_smoke.py``'s gram timing builds (the RBF Gram of (B, 256) rows and
the linear Gram of (B, 64)).  A cut copy computes wrong numbers; only its
time means something: the full kernel's time less the cut copy's is what
the part costs.  The parts:

* ``band_copy``: the cp.async copy of a rank's band of both Grams into
  its shared memory;
* ``row_sums``: pass 1's row sums (a warp a row, four rows at once);
* ``column_sums``: pass 1's partial column sums (a thread a column);
* ``column_means``: pass 2's reads of the C ranks' partial column sums
  through distributed shared memory (the rank's own instead);
* ``pass_2``: the centring and the three products;
* ``block_sum``: the block's reduction of its three sums.

Prints one JSON line per (copy, B): the device ms per call (the profiler's
time of every device op of the wrapper call, mean of 20 calls) and the
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

BATCHES = (256, 32)

# (part, [(text in csrc/nhsic.cu, its replacement)]); every text must occur
# once, so an edit of the kernel that moves it fails here loudly
CUTS = [
    ("band_copy", [
        ("""    load_slab(cache, ld, kx, B, B, rank * TILE, 0, B, vec);
    load_slab(cache + TILE * ld, ld, kz, B, B, rank * TILE, 0, B, vec);
""", "")]),
    ("row_sums", [
        ("""    for (int j = lane; j < B; j += 32)
#pragma unroll
      for (int h = 0; h < RPW; ++h) {
        const int r = warp + h * (THREADS / 32);
        if (r < nrows) {
          sx[h] += bx[(size_t)r * bld + j];
          sz[h] += bz[(size_t)r * bld + j];
        }
      }
""", "")]),
    ("column_sums", [
        ("""      for (int r = 0; r < nrows; ++r) {
        cx += bx[(size_t)r * bld + j];
        cz += bz[(size_t)r * bld + j];
      }
""", "")]),
    ("column_means", [
        ("rank_sum(colx, j, C) / B", "colx[j] / B"),
        ("rank_sum(colz, j, C) / B", "colz[j] / B")]),
    ("pass_2", [
        ("""      for (int r = 0; r < nrows; ++r) {
        const float kxc = bx[(size_t)r * bld + j] - cmx - rmx[r] + mx;
        const float kzc = bz[(size_t)r * bld + j] - cmz - rmz[r] + mz;
        ps[0] += (double)kxc * kzc;
        ps[1] += (double)kxc * kxc;
        ps[2] += (double)kzc * kzc;
      }
""", """      ps[0] += cmx;
      ps[2] += cmz;
""")]),
    ("block_sum", [("  block_sum3(ps, red);\n", "")]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gram_stats_parts: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import hsic
    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc
    from repro_torch.kernels.hsic_gram import kernel
    torch.backends.cuda.matmul.allow_tf32 = False

    source = kernel.SOURCE.read_text()
    out_dir = BUILD_DIR / "gram_stats_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = {"full": source}
    for part, edits in CUTS:
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"gram_stats_parts: the cut {part!r} no "
                                   f"longer matches {kernel.SOURCE}")
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
            raise RuntimeError(f"gram_stats_parts: nvcc failed on "
                               f"{name}:\n{log}")

    def bind(name):
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, argtypes in kernel._ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernel._lib = lib
        kernel._fns.update({fn: getattr(lib, fn) for fn in kernel._ARGTYPES})

    def device_ms(fn, runs=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / 1e3 / runs if us else None

    bind("full")
    gen = torch.Generator().manual_seed(0)
    grams = {}
    for B in BATCHES:
        x = torch.randn((B, 256), generator=gen).cuda()
        z = torch.randn((B, 64), generator=gen).cuda()
        grams[B] = (kernel.gram(x, hsic.rbf_sigma2(x)),
                    kernel.gram(z, 1.0, linear=True))
    lines = []
    for name in ["full", *(p for p, _ in CUTS), "full"]:
        bind(name)
        for B, (kx, kz) in grams.items():
            row = {"copy": name, "B": B,
                   "device_ms": device_ms(lambda: kernel.gram_stats(kx, kz)),
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
