"""Paper Fig. 5 (port of the reference's ``benchmarks/fig5_scale_vit.py``):
(a) a FEMNIST-like task across device scales; (b) the ViT (3 blocks of
encoders) on the vectorized round.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_scale_vit \
        [--rounds N] [--width W] [--image-size S] [--d-model D] \
        [--num-layers L] [--device cpu] [--out FILE]

(a) ``make_femnist_like`` (62 classes; another ``image_size`` draws the
same way at that size) over each scale's Dirichlet split, ResNet18, one
server a scale on the sequential runtime, a tenth of the scale (at least
2) a round, E = 1, B = 32, 4 stages.  (b) ``paper_models.vit`` at 32
classes over 16 clients, 4 a round, on ``runtime="vectorized"`` (every
cohort in one vmapped step), 3 stages; attention through K4
(``use_flash_kernel=True``, the cohorts folded into its batch).  Both take
nHSIC through K1-K3 (``use_hsic_kernel=True``; batched over the cohorts
in (b)); on the CPU the wrappers take their plain versions.  Synthetic
data: the paper's FEMNIST and Mini-ImageNet accuracies wait for the
datasets.  Each accuracy is a server's last evaluation.  The defaults are
the reference's (width 0.25, 32x32, a ViT of d_model 96 and 6 layers);
the paper's ViT-12 is ``--d-model 384 --num-layers 12``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.benchmarks.common import ensure_dir, write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.configs.paper_models import vit
from repro_torch.core.progressive import make_adapter
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_femnist_like, make_image_dataset
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models.cnn import CNNConfig


def femnist_like(seed: int, n: int, image_size: int = 32):
    """``make_femnist_like``, or its draw at another image size."""
    if image_size == 32:
        return make_femnist_like(seed, n)
    return make_image_dataset(seed, n, num_classes=62, image_size=image_size,
                              noise=0.3)


def _last_acc(hist) -> float:
    accs = [h.test_acc for h in hist if h.test_acc is not None]
    return float(accs[-1]) if accs else 0.0


def run_scale(scales=(24, 48), rounds: int = 4, quiet: bool = False,
              device=None, width: float = 0.25, image_size: int = 32,
              params=None, hooks=None) -> dict:
    """{scale: accuracy}.  ``params`` (optional) starts every scale's server
    from the given adapter params; ``hooks(f"scale {n}", server)`` is
    called before each server's rounds."""
    device = resolve_device(device)
    out = {}
    ds = femnist_like(0, 4000, image_size)
    test = femnist_like(1, 512, image_size)
    for n in scales:
        parts = dirichlet_partition(0, ds.labels, n, alpha=1.0)
        clients = [ds.subset(p) for p in parts]
        ccfg = CNNConfig(name="resnet18", arch="resnet18", num_classes=62,
                         image_size=image_size, width_mult=width)
        flc = FLConfig(n_devices=n, clients_per_round=max(n // 10, 2),
                       local_epochs=1, batch_size=32, num_stages=4, seed=0,
                       runtime="sequential", use_hsic_kernel=True)
        srv = NeuLiteServer(make_adapter(ccfg, 4), clients, flc,
                            test_batcher=Batcher(test, 128, kind="image"),
                            params=params, device=device)
        if hooks is not None:
            hooks(f"scale {n}", srv)
        out[n] = _last_acc(srv.run(rounds))
        del srv
        if not quiet:
            print(f"fig5a scale={n}: acc={out[n]:.3f}", flush=True)
    return out


def vit_config(image_size: int = 32, d_model: int = 96, num_layers: int = 6):
    """Fig. 5b's ViT: ``paper_models.vit`` at 32 classes, attention through
    K4."""
    return dataclasses.replace(
        vit(num_classes=32, image_size=image_size, num_layers=num_layers,
            d_model=d_model), use_flash_kernel=True)


def run_vit(rounds: int = 4, quiet: bool = False, device=None,
            image_size: int = 32, d_model: int = 96, num_layers: int = 6,
            params=None, hooks=None) -> float:
    """The ViT's accuracy after ``rounds`` vectorized rounds.  ``params``
    and ``hooks`` (called as ``hooks("vit", server)``) as in
    ``run_scale``."""
    device = resolve_device(device)
    ds = make_image_dataset(0, 2000, num_classes=32, image_size=image_size)
    test = make_image_dataset(1, 512, num_classes=32, image_size=image_size)
    parts = dirichlet_partition(0, ds.labels, 16, alpha=1.0)
    clients = [ds.subset(p) for p in parts]
    cfg = vit_config(image_size, d_model, num_layers)
    flc = FLConfig(n_devices=16, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=3, seed=0, runtime="vectorized",
                   use_hsic_kernel=True)
    srv = NeuLiteServer(make_adapter(cfg, 3), clients, flc,
                        test_batcher=Batcher(test, 128, kind="image"),
                        params=params, device=device)
    if hooks is not None:
        hooks("vit", srv)
    acc = _last_acc(srv.run(rounds))
    if not quiet:
        print(f"fig5b vit: acc={acc:.3f} (3 blocks x {cfg.num_layers // 3} "
              f"encoders)", flush=True)
    return acc


def run(rounds: int = 4, quiet: bool = False, device=None,
        width: float = 0.25, image_size: int = 32, d_model: int = 96,
        num_layers: int = 6, out_path=None) -> dict:
    device = resolve_device(device)
    out = {"scale": run_scale(rounds=rounds, quiet=quiet, device=device,
                              width=width, image_size=image_size),
           "vit_acc": run_vit(rounds, quiet, device, image_size, d_model,
                              num_layers)}
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"), "fig5.json")
    write_bench_json(out_path, {"scale": {str(k): v for k, v in
                                          out["scale"].items()},
                                "vit_acc": out["vit_acc"]}, device,
                     rounds=rounds, width=width, image_size=image_size,
                     d_model=d_model, num_layers=num_layers)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=96)
    ap.add_argument("--num-layers", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/fig5.json)")
    a = ap.parse_args(argv)
    run(rounds=a.rounds, width=a.width, image_size=a.image_size,
        d_model=a.d_model, num_layers=a.num_layers, device=a.device,
        out_path=a.out)


if __name__ == "__main__":
    main()
