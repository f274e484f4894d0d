"""Kernel microbenchmarks of the port (port of the reference's
``benchmarks/kernels_bench.py``): the plain PyTorch versions against the
hand-written CUDA kernels, with the same row names and keys as the
reference's JSON so the two files line up.

- ``attn_ref_S256`` / ``attn_ref_S1024``: causal f32 attention, the plain
  version (``s``, ``gflops``) and the flash-attention kernel K4 through
  ``flash_attention.ops`` (``kernel_s``, ``kernel_gflops``).
- ``nhsic_B64_D128`` / ``nhsic_B256_D256``: plain ``core.hsic.nhsic``
  (``fwd_ref_s``, ``grad_ref_s``) against the streaming kernels K1+K2
  (``fwd_pallas_s``, the reference's name for its kernel path) and K1-K3
  (``grad_pallas_s``), and the forward-only dense-Gram path K6 x 2 + K7
  (``fwd_unfused_s``).  The rows also check what the differentiable path
  keeps for its backward: O(B·D) residuals, no B×B Gram.
- ``conv_lax_C16`` / ``conv_im2col_C16``: the unit conv under
  ``torch.func.vmap`` over per-cohort weights, forward and the gradient of
  the sum.  The port's native conv (``F.conv2d``, cuDNN on the card) stands
  in for the reference's ``lax`` conv.

    python -m repro_torch.benchmarks.kernels_bench --out results/bench.json

runs on the card (``--device cpu`` runs the plain versions on the CPU,
which times the CPU, not a kernel).
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch.benchmarks.common import csv_row, timeit, write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.core import hsic
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.hsic_gram import ops as kops
from repro_torch.models.cnn import conv

SEED = 0
# (B, S, H, KV, D), causal, f32
ATTN_SHAPES = [(2, 256, 8, 2, 64), (1, 1024, 8, 8, 64)]
# (B, Dx); z is (B, NHSIC_DZ)
NHSIC_SHAPES = [(64, 128), (256, 256)]
NHSIC_DZ = 64
# cohorts, batch, height = width, cin, cout, kernel size
CONV_SHAPE = (16, 16, 8, 8, 8, 3)
NOTES = {
    "fwd_pallas_s": "the streaming CUDA kernels K1+K2 (ops.nhsic forward)",
    "grad_pallas_s": "K1-K3 (autograd through ops.nhsic)",
    "fwd_unfused_s": "the dense-Gram CUDA kernels, gram x 2 + gram_stats "
                     "(ops.nhsic_unfused)",
    "conv_lax": "the port's native conv (F.conv2d; cuDNN on the card) in "
                "place of lax.conv_general_dilated",
}


def _grad_of(f):
    """(x, z) -> the gradient of f(x, z) with respect to both."""
    def g(x, z):
        x = x.detach().requires_grad_(True)
        z = z.detach().requires_grad_(True)
        return torch.autograd.grad(f(x, z), (x, z))
    return g


def _attn_rows(gen, device, out, quiet):
    for B, S, H, KV, D in ATTN_SHAPES:
        q, k, v = (torch.randn(s, generator=gen).to(device)
                   for s in [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)])
        t = timeit(functools.partial(fref.attention_ref, causal=True),
                   q, k, v)
        tk = timeit(functools.partial(fops.flash_attention, causal=True),
                    q, k, v)
        flops = 4 * B * S * S / 2 * H * D
        out[f"attn_ref_S{S}"] = {"s": t, "gflops": flops / t / 1e9,
                                 "kernel_s": tk,
                                 "kernel_gflops": flops / tk / 1e9}
        if not quiet:
            print(f"attn B{B} S{S}: plain {t * 1e3:.3f} ms "
                  f"({flops / t / 1e9:.1f} GFLOP/s), kernel {tk * 1e3:.3f} "
                  f"ms ({flops / tk / 1e9:.1f} GFLOP/s)", flush=True)


def _nhsic_rows(gen, device, out, quiet):
    for B, Dx in NHSIC_SHAPES:
        x = torch.randn((B, Dx), generator=gen).to(device)
        z = torch.randn((B, NHSIC_DZ), generator=gen).to(device)
        row = {"fwd_ref_s": timeit(hsic.nhsic, x, z),
               "fwd_pallas_s": timeit(kops.nhsic, x, z),
               "fwd_unfused_s": timeit(kops.nhsic_unfused, x, z),
               "grad_ref_s": timeit(_grad_of(hsic.nhsic), x, z),
               "grad_pallas_s": timeit(_grad_of(kops.nhsic), x, z)}
        # what the differentiable path keeps for its backward: the
        # activations, two row-mean vectors and a few scalars; naive
        # autodiff keeps the two raw and two centred B×B Grams
        _, res = kops.nhsic_residuals(x, z)
        res_elems = sum(t.numel() for t in res)
        if res_elems > x.numel() + z.numel() + 2 * B + 16:
            raise RuntimeError(f"nhsic B{B} D{Dx}: the backward keeps "
                               f"{res_elems} elements, a B×B residual")
        res_bytes = sum(t.numel() * t.element_size() for t in res)
        row["bwd_residual_bytes"] = res_bytes
        row["naive_gram_bytes"] = 4 * B * B * 4
        row["residual_ratio"] = res_bytes / row["naive_gram_bytes"]
        out[f"nhsic_B{B}_D{Dx}"] = row
        if not quiet:
            print(f"nhsic B{B} D{Dx}: fwd plain "
                  f"{row['fwd_ref_s'] * 1e3:.3f} ms, fused "
                  f"{row['fwd_pallas_s'] * 1e3:.3f} ms, unfused "
                  f"{row['fwd_unfused_s'] * 1e3:.3f} ms | grad plain "
                  f"{row['grad_ref_s'] * 1e3:.3f} ms, fused "
                  f"{row['grad_pallas_s'] * 1e3:.3f} ms | bwd residuals "
                  f"{res_bytes / 1024:.0f} KiB vs "
                  f"{row['naive_gram_bytes'] / 1024:.0f} KiB of Grams",
                  flush=True)


def _conv_rows(gen, device, out, quiet):
    C, B, H, cin, cout, k = CONV_SHAPE
    wv = (torch.randn((C, cout, cin, k, k), generator=gen) * 0.1).to(device)
    xv = torch.randn((C, B, cin, H, H), generator=gen).to(device)
    for name, impl in (("lax", "native"), ("im2col", "im2col")):
        def unit(w, x, impl=impl):
            return conv({"w": w}, x, 1, impl)
        fwd = torch.func.vmap(unit)
        bwd = torch.func.grad(lambda w, x: torch.func.vmap(unit)(w, x).sum())
        row = {"fwd_s": timeit(fwd, wv, xv), "bwd_s": timeit(bwd, wv, xv)}
        out[f"conv_{name}_C{C}"] = row
        if not quiet:
            print(f"conv[{name}] vmap C{C} {H}x{H}x{cin}: fwd "
                  f"{row['fwd_s'] * 1e3:.3f} ms, bwd "
                  f"{row['bwd_s'] * 1e3:.3f} ms", flush=True)


def run(device=None, quiet: bool = False, out_path=None) -> dict:
    """Every row on ``device`` (``None``: the CUDA card); writes the rows
    and the device's description to ``out_path`` when one is given."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    _attn_rows(gen, device, out, quiet)
    _nhsic_rows(gen, device, out, quiet)
    _conv_rows(gen, device, out, quiet)
    if out_path is not None:
        write_bench_json(
            out_path, {"rows": out}, device, notes=NOTES,
            cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
            matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return out


def quick(device=None):
    """One CSV line: microseconds per row and two derived numbers."""
    t0 = time.time()
    out = run(device=device, quiet=True)
    dt = (time.time() - t0) * 1e6
    r64 = out["nhsic_B64_D128"]
    csv_row("kernels_bench", dt / max(len(out), 1),
            f"attn_S1024_gflops={out['attn_ref_S1024']['gflops']:.1f} "
            f"nhsic_grad_residual_ratio={r64['residual_ratio']:.2f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=None, help="JSON file to write")
    p.add_argument("--quick", action="store_true",
                   help="print one CSV summary line instead of the rows")
    args = p.parse_args(argv)
    if args.quick:
        quick(args.device)
    else:
        run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
