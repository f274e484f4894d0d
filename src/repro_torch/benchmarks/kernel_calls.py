"""Times one call of the K2, K3, K4, K6 and K5 wrappers, and of the sLSTM
scan's backward, of a checkout of the port, so that two checkouts can be
compared on one card.

    python src/repro_torch/benchmarks/kernel_calls.py --src <checkout>/src \
        --label <name> [--out <file.jsonl>]

imports ``repro_torch`` from ``--src`` (so an older checkout, unpacked
beside this one, is timed with its own wrappers and kernels) and, for
``nhsic_stats_feats`` (K2) and ``nhsic_grad`` (K3) at the ResNet path's
largest call (B, Dx, Dz) = (32, 256, 512), the xlstm-1.3b's h_xz (16,
2048, 2048) and the kernel benchmark's largest nHSIC row (256, 256, 64),
with their inputs as the nHSIC forward and backward build
them, ``flash_attention_fwd`` at the ViT-12 shape, ``gram`` at (B, D) =
(256, 256) and (32, 256), linear and RBF, ``slstm_scan_fwd`` at the
xlstm-1.3b shape (B=16, S=256, H=4, Dh=512) and ``slstm_scan_bwd``, the
backward of ``ops.slstm_scan`` at that shape for a cotangent of every
output (whatever the checkout's backward is: autograd of the plain loop
before the backward kernel, the kernel and two products after), prints one
JSON line each:

* ``event_ms``: CUDA events around one call, median of 30 (the host's
  launch gap included, as ``chip_smoke.py`` times every kernel);
* ``host_ms``: the host clock per call over 200 calls issued back to back
  without a synchronisation, the wrapper's own Python and launch time;
* ``device_ms``: the profiler's device time of the kernel per call (for
  K2 and K3, of all their launches, and for ``slstm_scan_bwd``, of every
  device op of the backward);
* ``device_ops``: the device ops (kernels, copies, fills) the profiler
  records per call.

Needs a CUDA card; exits 2 without one.  TF32 is off.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_calls: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import hsic
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.hsic_gram import kernel as hkernel
    from repro_torch.kernels.hsic_gram import ref as href
    from repro_torch.kernels.slstm_scan import kernel as skernel
    from repro_torch.kernels.slstm_scan import ops as sops
    torch.backends.cuda.matmul.allow_tf32 = False

    def event_ms(fn, runs=30):
        for _ in range(5):
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

    def host_ms(fn, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / calls
        torch.cuda.synchronize()
        return t

    def device_ms(fn, name, runs=30):
        """(device ms of the kernels whose names contain ``name``, or of
        all when it is None; device ops) per call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in dev
                 if name is None or name in e.name)
        return (us / 1e3 / runs if us else None), len(dev) / runs

    gen = torch.Generator().manual_seed(0)
    calls = []
    for B, Dx, Dz in ((32, 256, 512), (16, 2048, 2048), (256, 256, 64)):
        x = torch.randn((B, Dx), generator=gen).cuda()
        z = torch.randn((B, Dz), generator=gen).cuda()
        s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
        rxs, rzs = href.nhsic_rowsums(x, z, s2)
        rx, rz = rxs / B, rzs / B
        s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
        scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device="cuda")])
        calls.append(("nhsic_stats_feats", [B, Dx, Dz, False], None,
                      lambda x=x, z=z, rx=rx, rz=rz, s=s:
                      hkernel.nhsic_stats_feats(x, z, rx, rz, s)))
        calls.append(("nhsic_grad", [B, Dx, Dz, False], None,
                      lambda x=x, z=z, rx=rx, rz=rz, scal=scal:
                      hkernel.nhsic_grad(x, z, rx, rz, scal)))
    q, k, v = (torch.randn((32, 64, 6, 64), generator=gen).cuda()
               for _ in range(3))
    calls.append(("flash_attention_fwd", [32, 64, 64, 6, 6, 64, False, 0],
                  "flash_fwd_kernel",
                  lambda: fkernel.flash_attention_fwd(q, k, v, causal=False)))
    for B, D in ((256, 256), (32, 256)):
        x = torch.randn((B, D), generator=gen).cuda()
        s2 = torch.full((), 2.0 * D, device="cuda")
        for linear in (True, False):
            calls.append(("gram", [B, D, linear], "gram_kernel",
                          lambda x=x, s2=s2, linear=linear:
                          hkernel.gram(x, s2, linear=linear)))
    shape = [16, 256, 4, 512]
    B, S, H, Dh = shape
    g_in = torch.randn((B, S, 4, H, Dh), generator=gen).cuda()
    r = (torch.randn((4, H, Dh, Dh), generator=gen) * Dh ** -0.5).cuda()
    b = (torch.randn((4, H, Dh), generator=gen) * 0.1).cuda()
    st = [torch.zeros((B, H, Dh), device="cuda") + v
          for v in (0.0, 0.0, -30.0, 0.0)]
    calls.append(("slstm_scan_fwd", shape, "slstm",
                  lambda: skernel.slstm_scan_fwd(g_in, r, b, *st)))
    leaves = [t.clone().requires_grad_() for t in (g_in, r, b, *st)]
    hs, fin = sops.slstm_scan(*leaves[:3], dict(zip("cnmh", leaves[3:])))
    outs = [hs, *fin.values()]
    cot = [torch.randn(o.shape, generator=gen).cuda() for o in outs]
    calls.append(("slstm_scan_bwd", shape, None,
                  lambda: torch.autograd.grad(outs, leaves, cot,
                                              retain_graph=True)))
    lines = []
    for name, shape, kname, fn in calls:
        slow = name == "slstm_scan_bwd"
        dev, ops = device_ms(fn, kname, runs=3 if slow else 30)
        row = {"label": args.label, "name": name, "shape": shape,
               "event_ms": event_ms(fn, runs=5 if slow else 30),
               "host_ms": host_ms(fn, calls=5 if slow else 200),
               "device_ms": dev, "device_ops": ops,
               "card": torch.cuda.get_device_name(0)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
