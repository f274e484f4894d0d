"""How the device time of K1 (``nhsic_rowsums``), K2
(``nhsic_stats_feats``) and K3 (``nhsic_grad``) depends on the size of
their thread-block clusters, on one card.

    python src/repro_torch/benchmarks/nhsic_cluster.py [--out <file.jsonl>]

K1, K2 and K3 split the columns of x and z over the C blocks of a cluster
(``kernels/hsic_gram/csrc/nhsic.cu``, ``cluster_size``, one rule for
the three).  This builds copies of ``nhsic.cu`` whose ``cluster_size``
returns a fixed C (1, 2, 4, 8, 16; under ``build/kernels/cluster/``, one
``nvcc`` per copy, started together) beside the source as it is, and
times the three kernels of every copy at the training paths' shapes
(``SHAPES``) with the same inputs: the profiler's device time of all the
wrapper's launches, mean of 20 calls.  Each copy's results are checked
against the source's own (scale-relative 1e-3), so a copy that computes
something else fails here.  Prints one JSON line per (copy, kernel, shape)
with the card's name.  Needs a CUDA card and ``nvcc``; exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (B, Dx, Dz, linear_x): h_xz at the four ResNet18 stages, h_yz, the
# ViT-12's h_xz, xlstm-1.3b's h_xz and h_yz, and the kernel benchmark's
# largest nHSIC row
SHAPES = [(32, 3, 64, False), (32, 64, 128, False), (32, 128, 256, False),
          (32, 256, 512, False), (32, 10, 64, True), (32, 384, 384, False),
          (16, 2048, 2048, False), (16, 256, 64, True), (256, 256, 64, False)]
SIZES = (1, 2, 4, 8, 16)
RULE = """  const int cols = (Dx > Dz ? Dx : Dz) / 64;
  int c = 4;
  while (c < cols && c < MAX_CLUSTER) c *= 2;
  return c;"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("nhsic_cluster: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import hsic
    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc
    from repro_torch.kernels.hsic_gram import kernel, ref
    torch.backends.cuda.matmul.allow_tf32 = False

    source = kernel.SOURCE.read_text()
    if source.count(RULE) != 1:
        raise RuntimeError(f"nhsic_cluster: cluster_size no longer reads "
                           f"{RULE!r} in {kernel.SOURCE}")
    out_dir = BUILD_DIR / "cluster"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = {"rule": source}
    copies.update({f"C={c}": source.replace(RULE, f"return {c};")
                   for c in SIZES})
    jobs = {}
    for name, text in copies.items():
        src = out_dir / f"{name.replace('=', '')}.cu"
        src.write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(src.with_suffix(".so")),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nhsic_cluster: nvcc failed on {name}:\n{log}")

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

    gen = torch.Generator().manual_seed(0)
    cases = []
    for B, Dx, Dz, lx in SHAPES:
        x = (torch.eye(Dx)[torch.randint(0, Dx, (B,), generator=gen)] if lx
             else torch.randn((B, Dx), generator=gen)).cuda()
        z = torch.randn((B, Dz), generator=gen).cuda()
        one = torch.ones((), device="cuda")
        s2 = torch.stack([one if lx else hsic.rbf_sigma2(x),
                          hsic.rbf_sigma2(z)])
        rxs, rzs = ref.nhsic_rowsums(x, z, s2, linear_x=lx)
        s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
        scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device="cuda")])
        cases.append(((B, Dx, Dz, lx),
                      (x, z, rxs / B, rzs / B, s), (x, z, rxs / B, rzs / B,
                                                    scal)))
    want = {}
    lines = []
    for name in copies:
        lib = ctypes.CDLL(str(out_dir / f"{name.replace('=', '')}.so"))
        for fn, argtypes in kernel._ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernel._lib = lib
        kernel._fns.update({fn: getattr(lib, fn) for fn in kernel._ARGTYPES})
        for shape, sargs, gargs in cases:
            lx = shape[3]
            for kname, fn in (
                    ("nhsic_rowsums", lambda: kernel.nhsic_rowsums(
                        *sargs[:2], sargs[4][:2], linear_x=lx)),
                    ("nhsic_stats_feats", lambda: kernel.nhsic_stats_feats(
                        *sargs, linear_x=lx)),
                    ("nhsic_grad", lambda: kernel.nhsic_grad(
                        *gargs, linear_x=lx))):
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                ref_out = want.setdefault((kname, shape), got)
                rel = max(float((a - b).abs().max())
                          / max(float(b.abs().max()), 1e-6)
                          for a, b in zip(got, ref_out))
                if rel > 1e-3:
                    raise RuntimeError(f"nhsic_cluster: {name} {kname} at "
                                       f"{shape} differs by {rel}")
                row = {"copy": name, "name": kname, "shape": list(shape),
                       "device_ms": device_ms(fn),
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
