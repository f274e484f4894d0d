"""Paper Fig. 2: the nHSIC plane (port of the reference's
``benchmarks/fig2_hsic_plane.py``).  Naive progressive training (PT)
discards input information (a low nHSIC(X;Z)) against end-to-end training
(E2E); the Curriculum Mentor's λ1 term restores it.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_hsic_plane \
        [--steps N] [--width W] [--image-size S] [--device cpu] [--out FILE]

ResNet18 trains three ways on batches of 32 from one seeded stream: E2E
(``make_full_step``), naive PT and NeuLite-CA (stage 0's step, curriculum
off and on, mu = 0).  Every 10 steps a probe of 128 fixed images logs
(nHSIC(X;Z), nHSIC(Y;Z)) of the first block's output, through the plain
``core.hsic.nhsic``, as the reference's probe.  NeuLite-CA's step takes
nHSIC through the kernels K1-K3 (``use_hsic_kernel=True``; on the CPU the
wrappers take their plain versions).  The defaults are the reference's
(width 0.25, 16x16 images, 60 steps).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.benchmarks.common import ensure_dir, write_bench_json
from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import hsic
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (make_adapter, make_full_step,
                                          make_stage_step)
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.models import cnn as C
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim.optimizers import sgd

MODES = ("e2e", "pt_naive", "neulite_ca")
PROBE_EVERY = 10


def first_block_feats(ad, params, images):
    """(B, C) pooled output of the first block on NHWC ``images``."""
    metas = C.unit_meta(ad.cfg)
    s, e = ad.plan.bounds[0]
    x = C.cnn_apply_units(ad.cfg, metas[s:e], params["model"]["units"][s:e],
                          C.nchw(images))
    return hsic.pool_features(C.nhwc(x))


@torch.no_grad()
def _probe(ad, params, probe_x, x_feat, probe_y):
    z = first_block_feats(ad, params, probe_x)
    return torch.stack([hsic.nhsic(x_feat, z),
                        hsic.nhsic(probe_y, z, kernel_x="linear")])


def run(steps: int = 60, quiet: bool = False, device=None,
        width: float = 0.25, image_size: int = 16, params=None,
        out_path=None) -> dict:
    """{mode: [[nHSIC(X;Z), nHSIC(Y;Z)] every 10 steps]}.  ``params``
    (optional) starts every mode from the given adapter params (e.g. the
    reference's through the bridge); by default the adapter's own init
    from seed 0."""
    device = resolve_device(device)
    ds = make_image_dataset(0, 1024, num_classes=10, image_size=image_size)
    rng = np.random.default_rng(0)
    ccfg = CNNConfig(name="resnet18", arch="resnet18", image_size=image_size,
                     width_mult=width)
    probe_idx = rng.integers(0, len(ds), 128)
    probe_x = to_device(ds.images[probe_idx], device)
    probe_y = hsic.label_features(to_device(ds.labels[probe_idx], device), 10)
    x_feat = hsic.pool_features(probe_x)

    def batch():
        sel = rng.integers(0, len(ds), 32)
        return to_device({"inputs": {"images": ds.images[sel]},
                          "labels": ds.labels[sel]}, device)

    traces = {}
    for mode in MODES:
        ad = make_adapter(ccfg, num_stages=4)
        # the steps return new tensors: the given params are not written
        p = ad.init_params(0, device) if params is None else params
        opt = sgd(0.05)
        probes = []
        if mode == "e2e":
            step = make_full_step(ad, opt)
            st = opt.init(p)
            for i in range(steps):
                st, p, _ = step(st, p, batch())
                if i % PROBE_EVERY == 0:
                    probes.append(_probe(ad, p, probe_x, x_feat, probe_y))
        else:
            hp = CurriculumHP(enabled=(mode == "neulite_ca"), mu=0.0,
                              use_hsic_kernel=True)
            # stage 0 only (the block Fig. 2a analyses)
            step = make_stage_step(ad, opt, hp, 0)
            frozen, trainable = ad.split_stage(p, 0)
            st = opt.init(trainable)
            for i in range(steps):
                st, trainable, _ = step(st, trainable, frozen, batch(),
                                        trainable)
                if i % PROBE_EVERY == 0:
                    p = ad.merge_stage(p, trainable, 0)
                    probes.append(_probe(ad, p, probe_x, x_feat, probe_y))
        # one read of the device per mode
        traces[mode] = trace = torch.stack(probes).cpu().tolist()
        if not quiet:
            print(f"fig2 {mode}: nHSIC(X;Z) {trace[0][0]:.3f}->"
                  f"{trace[-1][0]:.3f}  nHSIC(Y;Z) {trace[0][1]:.3f}->"
                  f"{trace[-1][1]:.3f}", flush=True)
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"),
                                "fig2_hsic_plane.json")
    write_bench_json(out_path, {"traces": traces}, device, steps=steps,
                     width=width, image_size=image_size)
    return traces


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/fig2_hsic_plane.json)")
    a = ap.parse_args(argv)
    run(steps=a.steps, width=a.width, image_size=a.image_size,
        device=a.device, out_path=a.out)


if __name__ == "__main__":
    main()
