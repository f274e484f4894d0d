"""Paper Table 2: task complexity, ResNet18 against ResNet34 (port of the
reference's ``benchmarks/table2_complexity.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_complexity \
        [--rounds N] [--width W] [--image-size S] [--device cpu] [--out FILE]

A deeper model raises the memory wall: ResNet34 runs on ResNet18's fleet
(its device budgets, set through the server's ``devices`` setter), so no
device fits full-model training and the exclusive methods have no one
left (the paper's "NA" for ExclusiveFL, TiFL and Oort), while NeuLite's
stages still fit.  NeuLite runs nHSIC through the kernels K1-K3
(``use_hsic_kernel=True``).  The defaults are the reference's (width 0.25,
16x16 images); the card runs ``--width 1.0 --image-size 32``.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.benchmarks.common import (ensure_dir, make_fl_setup,
                                           write_bench_json)
from repro_torch.common.device import resolve_device
from repro_torch.core.memory import estimate_full_memory
from repro_torch.core.progressive import make_adapter
from repro_torch.federated.selection import memory_feasible
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models.cnn import CNNConfig


def run(rounds: int = 6, seed: int = 0, quiet: bool = False, device=None,
        width: float = 0.25, image_size: int = 16, out_path=None,
        hooks=None):
    """Rows keyed by arch.  ``hooks`` (optional) is called as
    ``hooks(arch, "neulite", server)`` with each server before its rounds,
    as ``table1_accuracy.run`` calls it."""
    device = resolve_device(device)
    clients, test_b = make_fl_setup(seed, image_size=image_size)
    out = {}
    prev_devices = None
    for arch in ("resnet18", "resnet34"):
        ccfg = CNNConfig(name=arch, arch=arch, image_size=image_size,
                         width_mult=width)
        flc = FLConfig(n_devices=len(clients), clients_per_round=5,
                       local_epochs=1, batch_size=32, num_stages=4,
                       seed=seed, use_hsic_kernel=True)
        srv = NeuLiteServer(make_adapter(ccfg, flc.num_stages), clients,
                            flc, test_batcher=test_b, device=device)
        # the paper's deeper memory wall: the same device fleet, a bigger
        # model (ResNet18's budgets => full-model training infeasible)
        if arch == "resnet34":
            srv.devices = prev_devices
        if hooks is not None:
            hooks(arch, "neulite", srv)
        t0 = time.perf_counter()
        hist = srv.run(rounds)
        accs = [h.test_acc for h in hist if h.test_acc is not None][-3:]
        full_req = estimate_full_memory(srv.adapter, flc.batch_size).total
        n_full = len(memory_feasible(srv.devices, full_req))
        out[arch] = {"neulite_acc": float(sum(accs) / max(len(accs), 1)),
                     "neulite_pr": srv.participation_rate,
                     "full_model_feasible_devices": n_full,
                     "time_s": time.perf_counter() - t0}
        prev_devices = srv.devices
        del srv
        if not quiet:
            print(f"table2 {arch}: acc={out[arch]['neulite_acc']:.3f} "
                  f"pr={out[arch]['neulite_pr']:.2f} "
                  f"full-model-capable devices={n_full}", flush=True)
    if out_path is None:
        out_path = os.path.join(ensure_dir("benchmarks"), "table2.json")
    write_bench_json(out_path, {"rows": out}, device, rounds=rounds,
                     width=width, image_size=image_size, seed=seed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="JSON file to write "
                    "(default: results/benchmarks/table2.json)")
    a = ap.parse_args(argv)
    run(rounds=a.rounds, width=a.width, image_size=a.image_size,
        device=a.device, out_path=a.out)


if __name__ == "__main__":
    main()
