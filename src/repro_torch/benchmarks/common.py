"""Shared benchmark utilities (port of the reference's
``benchmarks/common.py``).

Times are host-clock seconds around one call each, with the card
synchronised before and after, so a time covers the launches and the work
they queue.  Every result file names the device it ran on; a result from
the CPU is never a time of the card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "results")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall seconds of ``fn(*args)``, synchronising the card (when
    CUDA is in use) before and after each call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def csv_row(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_meta(device: torch.device) -> dict:
    """What a result must name: the torch version and the device; on the
    card also its name, the number of cards and ``nvidia-smi``'s name and
    power limit."""
    meta = {"torch": torch.__version__, "device": str(device)}
    if device.type == "cuda":
        meta.update(device_name=torch.cuda.get_device_name(device),
                    device_count=torch.cuda.device_count(),
                    smi=smi_line())
    return meta


def write_bench_json(path, payload: dict, device: torch.device,
                     **meta) -> str:
    """Write ``payload`` to ``path`` with a ``meta`` entry holding
    ``device_meta(device)`` and ``meta``.  There is no default path: the
    caller names the file."""
    doc = {"meta": {**device_meta(device), **meta}, **payload}
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=float)
        f.write("\n")
    return path


def ensure_dir(*parts) -> str:
    """``results/<parts>`` at the repository's root, made if missing."""
    p = os.path.join(RESULTS_DIR, *parts)
    os.makedirs(p, exist_ok=True)
    return p


def make_fl_setup(seed=0, n_clients=20, n_train=2000, n_test=512,
                  num_classes=10, image_size=16, alpha=1.0):
    """The reference's benchmark fleet data (numpy only): a synthetic image
    set split over ``n_clients`` by a Dirichlet(``alpha``) partition, and a
    test batcher of 128."""
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    ds = make_image_dataset(seed, n_train, num_classes=num_classes,
                            image_size=image_size)
    test = make_image_dataset(seed + 1, n_test, num_classes=num_classes,
                              image_size=image_size)
    parts = dirichlet_partition(seed, ds.labels, n_clients, alpha=alpha)
    clients = [ds.subset(p) for p in parts]
    test_batcher = Batcher(test, 128, kind="image")
    return clients, test_batcher
