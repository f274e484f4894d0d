"""Paper Fig. 8: the ablation of NeuLite's two mechanisms (port of the
reference's ``benchmarks/fig8_ablation.py``): full NeuLite, w/o the
curriculum-aware loss (CA: ``curriculum=False``), w/o parameter
co-adaptation (PC: ``co_adaptation=False``, the sequential schedule) and
FedAvg.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig8_ablation \
        [--rounds N] [--width W] [--image-size S] [--device cpu] [--out FILE]

On synthetic data (``make_fl_setup``: 20 clients, Dirichlet 1.0, 5 a
round, E = 1, B = 32, 4 stages): the paper's accuracies on CIFAR-10 and
FEMNIST wait for the datasets.  NeuLite and w/o PC take nHSIC through the
kernels K1-K3 (``use_hsic_kernel=True``; on the CPU the wrappers take their
plain versions); w/o CA and FedAvg compute no nHSIC.  A NeuLite variant's
accuracy is the mean of its last three evaluations, FedAvg's its final
one, as the reference reports them.  The defaults are the reference's
(width 0.25, 16x16 images, 8 rounds).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.benchmarks.common import (ensure_dir, make_fl_setup,
                                           write_bench_json)
from repro_torch.common.device import resolve_device
from repro_torch.core.progressive import make_adapter
from repro_torch.federated.baselines import FedAvg
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models.cnn import CNNConfig

VARIANTS = {"neulite": {}, "wo_ca": {"curriculum": False},
            "wo_pc": {"co_adaptation": False}}


def run(rounds: int = 8, seed: int = 0, quiet: bool = False, device=None,
        width: float = 0.25, image_size: int = 16, params=None,
        out_path=None, hooks=None) -> dict:
    """{variant: accuracy}.  ``params`` (optional) is
    ``{"neulite": adapter params, "fedavg": model params}``, the start of
    the three NeuLite variants and of FedAvg (e.g. the reference's through
    the bridge); by default each inits from ``seed``.  ``hooks``
    (optional) is called as ``hooks(name, runner)`` with each server and
    FedAvg before its rounds."""
    device = resolve_device(device)
    params = params or {}
    clients, test_b = make_fl_setup(seed, image_size=image_size)
    ccfg = CNNConfig(name="resnet18", arch="resnet18", image_size=image_size,
                     width_mult=width)
    out = {}
    for name, kw in VARIANTS.items():
        flc = FLConfig(n_devices=len(clients), clients_per_round=5,
                       local_epochs=1, batch_size=32, num_stages=4,
                       rounds_per_stage=max(rounds // 4, 1), seed=seed,
                       use_hsic_kernel=True, **kw)
        srv = NeuLiteServer(make_adapter(ccfg, flc.num_stages), clients,
                            flc, test_batcher=test_b,
                            params=params.get("neulite"), device=device)
        if hooks is not None:
            hooks(name, srv)
        hist = srv.run(rounds)
        accs = [h.test_acc for h in hist if h.test_acc is not None][-3:]
        out[name] = float(sum(accs) / max(len(accs), 1))
        del srv
        if not quiet:
            print(f"fig8 {name}: acc={out[name]:.3f}", flush=True)
    flc = FLConfig(n_devices=len(clients), clients_per_round=5,
                   local_epochs=1, batch_size=32, num_stages=4, seed=seed)
    fa = FedAvg(ccfg, clients, test_b, flc, params=params.get("fedavg"),
                device=device)
    if hooks is not None:
        hooks("fedavg", fa)
    out["fedavg"] = fa.run(rounds).final_acc
    if not quiet:
        print(f"fig8 fedavg: acc={out['fedavg']:.3f}", flush=True)
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"), "fig8_ablation.json")
    write_bench_json(out_path, {"acc": out}, device, rounds=rounds,
                     width=width, image_size=image_size, seed=seed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/fig8_ablation.json)")
    a = ap.parse_args(argv)
    run(rounds=a.rounds, width=a.width, image_size=a.image_size,
        device=a.device, out_path=a.out)


if __name__ == "__main__":
    main()
