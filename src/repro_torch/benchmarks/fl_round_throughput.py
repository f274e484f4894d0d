"""FL round throughput of the port's client runtimes (port of the cohort
mode of ``benchmarks/fl_round_throughput.py``, its ``bench``).

One NeuLite round = C cohorts x E local steps + the Eq. 1 aggregation.
Rounds/s of one stage-t round on the same pre-built cohort stack (data
made once, before timing), for:

  sequential-eager     ``SequentialRuntime(capture=False)``: C·E eager
                       steps, every op issued from Python
  sequential-captured  ``SequentialRuntime``: the stage step captured as
                       a CUDA graph, then C·E replays of it
  vectorized           ``VectorizedRuntime``: one step of all C cohorts
                       (``torch.func.vmap``) captured, E replays of it,
                       then the Eq. 1 sum

at the reference's settings (ResNet18 at width 0.0625 on 8x8 images, a
ViT of 4 layers at d_model 64 on 16x16 images; 4 stages, C = 16, B = 4,
E = 2, stage 1) and at the smoke run's full-width configs (ResNet18 at
width 1.0 on 32x32, 4 stages; ViT-12, d_model 384, on 64x64, 3 stages,
attention through the flash kernel; B = 32, E = 2, stage 1) with C = 4
and C = 16.  nHSIC runs through the kernels.  Each time is the median of
``iters`` rounds after one warm-up round, with the card synchronised
around each round.  Every round captures its graphs anew and drops them
after its last local step, as a server's round does.

  PYTHONPATH=src python -m repro_torch.benchmarks.fl_round_throughput \
      --out chiprun_out/bench_fl_round.json

On the card only: the times are the card's.  The population, async and
model-parallel modes of the reference's script wait for the port's
streaming fleet, async runtime and sharded runtime.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.benchmarks.common import timeit, write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_leaves

VARIANTS = ("sequential-eager", "sequential-captured", "vectorized")
# (model, scale, cohorts, batch, local steps)
SETTINGS = [("cnn", "reference", 16, 4, 2), ("vit", "reference", 16, 4, 2),
            ("cnn", "full", 4, 32, 2), ("cnn", "full", 16, 32, 2),
            ("vit", "full", 4, 32, 2), ("vit", "full", 16, 32, 2)]
STAGE = 1
SEED = 0


def _config(kind: str, scale: str):
    """(model config, stages, image size) of a setting."""
    from repro_torch.configs.paper_models import resnet18, vit
    if kind == "cnn":
        if scale == "reference":
            return resnet18(num_classes=10, image_size=8,
                            width_mult=0.0625), 4, 8
        return resnet18(num_classes=10, image_size=32), 4, 32
    if scale == "reference":
        return vit(num_classes=10, image_size=16, num_layers=4,
                   d_model=64), 4, 16
    return dataclasses.replace(vit(), use_flash_kernel=True), 3, 64


def setup(kind: str, scale: str, num_cohorts: int, batch_size: int,
          local_steps: int, device: torch.device):
    """Adapter, params, optimizer, curriculum settings and the round's
    (C, E, ...) stack, as the reference's ``_setup`` builds them."""
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher, stack_round
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.optim.optimizers import sgd

    cfg, stages, size = _config(kind, scale)
    adapter = make_adapter(cfg, stages)
    params = adapter.init_params(SEED, device)
    classes = adapter.num_classes
    n = num_cohorts * batch_size * local_steps
    ds = make_image_dataset(SEED, n, num_classes=classes, image_size=size)
    batchers = [Batcher(ds.subset(p), batch_size, seed=SEED + i,
                        kind="image")
                for i, p in enumerate(iid_partition(SEED, n, num_cohorts))]
    stack = stack_round(batchers, range(num_cohorts),
                        local_steps=local_steps)
    return (adapter, params, sgd(0.05),
            CurriculumHP(mu=0.01, use_hsic_kernel=True), stack)


def bench(kind: str, scale: str, num_cohorts: int, batch_size: int,
          local_steps: int, device: torch.device, iters: int = 3) -> dict:
    """Rounds/s of each of ``VARIANTS`` on one stage-``STAGE`` round."""
    from repro_torch.federated.runtime import (SequentialRuntime,
                                               VectorizedRuntime)
    adapter, params, opt, hp, stack = setup(kind, scale, num_cohorts,
                                            batch_size, local_steps, device)
    runtimes = {
        "sequential-eager": SequentialRuntime(adapter, opt, hp, device,
                                              capture=False),
        "sequential-captured": SequentialRuntime(adapter, opt, hp, device),
        "vectorized": VectorizedRuntime(adapter, opt, hp, device)}
    out = {}
    for name, runtime in runtimes.items():
        def one_round(rt=runtime):
            new, metrics = rt.run_stacked(params, STAGE, stack)
            return tree_leaves(new)[0], metrics["mean_local_loss"]

        out[name] = 1.0 / timeit(one_round, warmup=1, iters=iters)
    return out


def run(device=None, out=None, iters: int = 3, settings=SETTINGS) -> list:
    """Every setting on ``device`` (the card by default): one row each,
    printed and, with ``out``, written with the device's name."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True   # as the server sets
        torch.backends.cudnn.benchmark = False
    rows = []
    for kind, scale, C, B, E in settings:
        rps = bench(kind, scale, C, B, E, device, iters)
        row = {"model": kind, "scale": scale, "cohorts": C, "batch": B,
               "local_steps": E, "stage": STAGE, "rounds_per_s": rps,
               "vectorized_over_sequential_eager":
                   rps["vectorized"] / rps["sequential-eager"],
               "captured_over_eager":
                   rps["sequential-captured"] / rps["sequential-eager"]}
        rows.append(row)
        print(f"  {kind} {scale} C={C} B={B} E={E}: " + ", ".join(
            f"{n} {rps[n]:.2f} rounds/s" for n in VARIANTS), flush=True)
    if out is not None:
        write_bench_json(out, {"rows": rows}, device, iters=iters,
                         variants=list(VARIANTS))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run(args.device, args.out, args.iters)


if __name__ == "__main__":
    main()
