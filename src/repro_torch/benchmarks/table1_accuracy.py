"""Paper Table 1: NeuLite against the nine baselines across models, non-IID
(port of the reference's ``benchmarks/table1_accuracy.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_accuracy \
        [--rounds N] [--width W] [--image-size S] [--device cpu] [--out FILE]

On synthetic data (the paper's CIFAR-10 and FEMNIST are not in the
repository): participation rates and the methods' relative order are the
signal, not absolute accuracy.  Each arch gets the reference's fleet
(``make_fl_setup``: 20 clients, Dirichlet 1.0), 5 clients a round, E = 1,
B = 32, 4 stages.  NeuLite's rows run nHSIC through the kernels K1-K3
(``use_hsic_kernel=True``; on the CPU the wrappers take their plain
versions) and the server's captured steps; the baselines train on
cross-entropy alone, with eager steps.  The defaults are the reference's
(width 0.25, 16x16 images); the card runs the paper's size with
``--width 1.0 --image-size 32``.  Each row holds the accuracy (the mean of
the last three NeuLite evaluations, a baseline's ``final_acc``), the
participation rate and the host seconds of its rounds.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.benchmarks.common import (ensure_dir, make_fl_setup,
                                           write_bench_json)
from repro_torch.common.device import resolve_device
from repro_torch.core.progressive import make_adapter
from repro_torch.federated.baselines import BASELINES
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models.cnn import CNNConfig

ARCHS = ("resnet18", "vgg11", "squeezenet")
METHODS = ("fedavg", "exclusivefl", "allsmall", "depthfl", "heterofl",
           "fedrolex", "tifl", "oort", "progfed")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run(rounds: int = 6, archs=ARCHS, methods=METHODS, width: float = 0.25,
        seed: int = 0, quiet: bool = False, device=None,
        image_size: int = 16, out_path=None, hooks=None):
    """Rows keyed ``(arch, method)``.  ``hooks`` (optional) is called as
    ``hooks(arch, method, runner)`` with each server or baseline before
    its rounds (``chip_smoke.py`` counts kernel launches through it)."""
    device = resolve_device(device)
    out = {}
    clients, test_b = make_fl_setup(seed, image_size=image_size)
    for arch in archs:
        ccfg = CNNConfig(name=arch, arch=arch, image_size=image_size,
                         width_mult=width)
        flc = FLConfig(n_devices=len(clients), clients_per_round=5,
                       local_epochs=1, batch_size=32, num_stages=4,
                       rounds_per_stage=max(rounds // 4, 1), seed=seed,
                       use_hsic_kernel=True)
        srv = NeuLiteServer(make_adapter(ccfg, flc.num_stages), clients,
                            flc, test_batcher=test_b, device=device)
        if hooks is not None:
            hooks(arch, "neulite", srv)
        t0 = time.perf_counter()
        hist = srv.run(rounds)
        _sync(device)
        accs = [h.test_acc for h in hist if h.test_acc is not None]
        out[(arch, "neulite")] = {
            "acc": float(sum(accs[-3:]) / max(len(accs[-3:]), 1)),
            "pr": srv.participation_rate,
            "time_s": time.perf_counter() - t0}
        del srv
        if not quiet:
            print(f"table1 {arch} neulite acc={out[(arch,'neulite')]['acc']:.3f}"
                  f" pr={out[(arch, 'neulite')]['pr']:.2f}", flush=True)
        for m in methods:
            b = BASELINES[m](ccfg, clients, test_b, flc, device=device)
            if hooks is not None:
                hooks(arch, m, b)
            t0 = time.perf_counter()
            res = b.run(rounds)
            _sync(device)
            out[(arch, m)] = {"acc": res.final_acc,
                              "pr": res.participation_rate,
                              "time_s": time.perf_counter() - t0}
            del b
            if not quiet:
                print(f"table1 {arch} {m} acc={res.final_acc:.3f} "
                      f"pr={res.participation_rate:.2f}", flush=True)
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"), "table1.json")
    write_bench_json(out_path, {"rows": {f"{a}|{m}": v
                                         for (a, m), v in out.items()}},
                     device, rounds=rounds, width=width,
                     image_size=image_size, seed=seed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/table1.json)")
    a = ap.parse_args(argv)
    run(rounds=a.rounds, width=a.width, image_size=a.image_size,
        device=a.device, out_path=a.out)


if __name__ == "__main__":
    main()
