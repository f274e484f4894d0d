"""FL round throughput of the port's client runtimes (port of the cohort,
async and population modes of ``benchmarks/fl_round_throughput.py``).

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
  sharded              ``ShardedRuntime`` on this process's one-rank mesh:
                       the vectorized round, then Eq. 1 as one all-reduce
                       per leaf over one rank

at the reference's settings (ResNet18 at width 0.0625 on 8x8 images, a
ViT of 4 layers at d_model 64 on 16x16 images; 4 stages, C = 16, B = 4,
E = 2, stage 1) and at the smoke run's full-width configs (ResNet18 at
width 1.0 on 32x32, 4 stages; ViT-12, d_model 384, on 64x64, 3 stages,
attention through the flash kernel; B = 32, E = 2, stage 1) with C = 4
and C = 16.  nHSIC runs through the kernels.  Each time is the median of
``iters`` rounds after one warm-up round, with the card synchronised
around each round.  Every round captures its graphs anew and drops them
after its last local step, as a server's round does.

``--runtime async`` reports instead the buffered-async (FedBuff) server
over ``--rounds`` stateful rounds at the reference's sizes (C = 16, B = 4,
E = 2, stage 1, K = 3C/4 unless ``--buffer``): cohorts deliver at
``steps / speed`` under the fleet's speed mix (``sample_devices``), the
server flushes every K arrivals, stragglers carry into the next round;
the simulated time (round open to last flush) against the synchronous
barrier (the slowest cohort), the carried and pending entries, the server
version, the flushed tree's trainable bytes and each round's wall
seconds.

``--model-parallel K`` spawns instead a world of max(4, 2K) ranks
(``launch.mesh.spawn_world``; on one card they share it, over gloo) and
reports, on the reference's settings, rounds/s of the replicated
vectorized round on every rank beside the sharded round on the (W/K, K)
mesh, and each one's ``held_trainable_bytes`` (one copy of the stage's
trainable tree as a rank holds it); with ``--runtime async`` the async
mode runs the same way on that mesh.

``--population N ...`` sweeps the population instead: full NeuLite rounds
(vectorized runtime, nHSIC through the kernels) at a fixed cohort of 8
over the streaming ``Fleet`` and ``ProceduralClients`` of N devices;
rounds/s after a warm-up of one round a stage, the Python heap's peak
(``tracemalloc``) over building a server and one round, and the process's
``ru_maxrss``: what must stay flat when opening a round is O(cohort).

  PYTHONPATH=src python -m repro_torch.benchmarks.fl_round_throughput \
      --out chiprun_out/bench_fl_round.json

Every mode adds its rows to ``--out`` beside the rows already there.  On
the card only: the times are the card's.  Ranks sharing one card time
gloo on one card, not NCCL across cards.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (device_meta, timeit,
                                          write_bench_json)
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_leaves

VARIANTS = ("sequential-eager", "sequential-captured", "vectorized",
            "sharded")
# (model, scale, cohorts, batch, local steps)
SETTINGS = [("cnn", "reference", 16, 4, 2), ("vit", "reference", 16, 4, 2),
            ("cnn", "full", 4, 32, 2), ("cnn", "full", 16, 32, 2),
            ("vit", "full", 4, 32, 2), ("vit", "full", 16, 32, 2)]
STAGE = 1
SEED = 0
# async mode: (model, cohorts, batch, local steps), the reference's sizes
ASYNC_SETTINGS = [("cnn", 16, 4, 2), ("vit", 16, 4, 2)]
POPULATIONS = (1e2, 1e4, 1e6)


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
                                               ShardedRuntime,
                                               VectorizedRuntime)
    adapter, params, opt, hp, stack = setup(kind, scale, num_cohorts,
                                            batch_size, local_steps, device)
    runtimes = {
        "sequential-eager": SequentialRuntime(adapter, opt, hp, device,
                                              capture=False),
        "sequential-captured": SequentialRuntime(adapter, opt, hp, device),
        "vectorized": VectorizedRuntime(adapter, opt, hp, device),
        "sharded": ShardedRuntime(adapter, opt, hp, device)}
    out = {}
    for name, runtime in runtimes.items():
        def one_round(rt=runtime):
            new, metrics = rt.run_stacked(params, STAGE, stack)
            return tree_leaves(new)[0], metrics["mean_local_loss"]

        out[name] = 1.0 / timeit(one_round, warmup=1, iters=iters)
    return out


def bench_model_parallel(device: torch.device, kind: str,
                         model_parallel: int, num_cohorts: int,
                         batch_size: int, local_steps: int,
                         iters: int = 3) -> dict:
    """Per rank of a world: the replicated vectorized round (every rank
    the whole round, no collective) against the sharded round on the
    (W/K, K) mesh, as the reference's ``bench_model_parallel``: rounds/s
    (the ranks meet at a barrier before each timed round) and
    ``held_trainable_bytes``."""
    from repro_torch.federated.runtime import (ShardedRuntime,
                                               VectorizedRuntime)
    from repro_torch.launch import sharding
    adapter, params, opt, hp, stack = setup(kind, "reference", num_cohorts,
                                            batch_size, local_steps, device)
    sharded = ShardedRuntime(adapter, opt, hp, device,
                             model_parallel=model_parallel)
    runtimes = {"replicated": VectorizedRuntime(adapter, opt, hp, device),
                f"model-sharded x{sharded.model_shards}": sharded}
    trainable = adapter.split_stage(params, STAGE)[1]
    out = {}
    for name, rt in runtimes.items():
        def one_round(rt=rt):
            sharded.mesh.barrier()
            new, metrics = rt.run_stacked(params, STAGE, stack)
            return tree_leaves(new)[0], metrics["mean_local_loss"]

        rps = 1.0 / timeit(one_round, warmup=1, iters=iters)
        held = getattr(rt, "held_trainable_bytes", None)
        out[name] = {"rounds_per_s": rps, "held_trainable_bytes":
                     sharding.per_device_nbytes(trainable)
                     if held is None else held}
    return {"model": kind, "cohorts": num_cohorts, "batch": batch_size,
            "local_steps": local_steps, "stage": STAGE,
            "mesh": dict(sharded.mesh.shape),
            "backend": sharded.mesh.backend, "rows": out}


def _rank_threads(device: torch.device):
    """One torch thread a rank on the CPU, where the ranks share the
    cores; the default on the card."""
    return 1 if device.type == "cpu" else None


def world_size(model_parallel: int) -> int:
    """The world the model-parallel modes spawn: max(4, 2K) ranks."""
    return max(4, 2 * int(model_parallel))


def run_model_parallel(device=None, out=None, model_parallel: int = 2,
                       settings=ASYNC_SETTINGS, iters: int = 3) -> list:
    """``bench_model_parallel`` of each setting in a spawned world of
    ``world_size(model_parallel)`` ranks; rank 0's rows, printed and, with
    ``out``, added to it under ``"model_parallel"``."""
    from repro_torch.launch.mesh import spawn_world
    device = resolve_device(device)
    rows = []
    for kind, C, B, E in settings:
        row = spawn_world(bench_model_parallel, world_size(model_parallel),
                          device, kind, model_parallel, C, B, E, iters,
                          threads=_rank_threads(device))[0]
        rows.append(row)
        base = row["rows"]["replicated"]["held_trainable_bytes"]
        for name, r in row["rows"].items():
            print(f"  {kind} C={C} mesh {row['mesh']} {name}: "
                  f"{r['rounds_per_s']:.2f} rounds/s, held "
                  f"{r['held_trainable_bytes']} bytes "
                  f"({r['held_trainable_bytes'] / base:.2f}x)", flush=True)
    if out is not None:
        merge_bench_json(out, {"model_parallel": rows}, device)
    return rows


def bench_async(kind: str, num_cohorts: int, batch_size: int,
                local_steps: int, device: torch.device,
                buffer_size: int = 0, rounds: int = 2,
                model_parallel: int = 1) -> dict:
    """Simulated speedup of ``rounds`` buffered-async rounds of one server
    over the synchronous barrier, on one stage-``STAGE`` stack at the
    reference's scale, as the reference's ``bench_async``; in a world of
    ranks (or with ``model_parallel > 1``) on the mesh, with the held
    trainable bytes of a rank."""
    from repro_torch.federated import aggregation as agg
    from repro_torch.federated.devices import sample_devices
    from repro_torch.federated.runtime import AsyncBufferedRuntime
    if buffer_size <= 0:
        buffer_size = max(1, (3 * num_cohorts) // 4)
    rounds = max(1, int(rounds))
    adapter, params, opt, hp, stack = setup(kind, "reference", num_cohorts,
                                            batch_size, local_steps, device)
    # a heterogeneous fleet's speed mix (device tiers)
    speeds = np.asarray([d.speed for d in
                         sample_devices(SEED, num_cohorts, 1)])
    sim_times = np.asarray(stack.num_batches, float) / speeds
    sync_time = float(sim_times.max()) * rounds
    runtime = AsyncBufferedRuntime(adapter, opt, hp, device,
                                   buffer_size=buffer_size,
                                   model_parallel=model_parallel)
    async_time, n_carried, n_uploads, seconds = 0.0, 0, 0, []
    for _ in range(rounds):
        t0 = time.perf_counter()
        new_tr, metrics = runtime.run_stacked(params, STAGE, stack,
                                              sim_times=sim_times)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        async_time += metrics["sim_round_time"]
        n_carried += metrics["n_carried"]
        n_uploads += metrics["n_uploads"]
    return {"model": kind, "cohorts": num_cohorts, "batch": batch_size,
            "local_steps": local_steps, "stage": STAGE,
            "buffer_size": buffer_size, "rounds": rounds,
            "sync_time": sync_time, "async_time": async_time,
            "speedup": sync_time / max(async_time, 1e-12),
            "n_pending": metrics["n_pending"], "n_carried": n_carried,
            "n_uploads": n_uploads,
            "server_version": metrics["server_version"],
            "trainable_bytes": agg.tree_bytes(new_tr),
            "model_shards": runtime.model_shards,
            "mesh": None if runtime.mesh is None else dict(runtime.mesh.shape),
            "held_trainable_bytes": runtime.held_trainable_bytes,
            "round_seconds": seconds}


def bench_population(populations, device: torch.device,
                     clients_per_round: int = 8, rounds: int = 8,
                     selection: str = "random") -> list:
    """Round cost against the population on the streaming fleet, as the
    reference's ``bench_population``: per population a ``NeuLiteServer``
    over ``Fleet`` and ``ProceduralClients``, one warm-up round a stage,
    then ``rounds`` timed rounds at a fixed cohort; then a fresh server's
    construction and one round under ``tracemalloc``."""
    import gc
    import resource
    import tracemalloc

    from repro_torch.core.memory import estimate_stage_memory
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.partition import ProceduralClients
    from repro_torch.federated.devices import Fleet
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg, stages, _ = _config("cnn", "reference")
    adapter = make_adapter(cfg, stages)
    # budgets against the largest stage's need (this tiny config's stages
    # exceed its full-model training): the top tier fits every stage
    max_req = max(estimate_stage_memory(adapter, t, 4, seq=0).total
                  for t in range(stages))
    budget = int(max_req / 0.99) + 1
    flc_kw = dict(clients_per_round=clients_per_round, local_epochs=1,
                  batch_size=4, num_stages=stages, seed=SEED,
                  runtime="vectorized", selection=selection,
                  use_hsic_kernel=True)

    def server(pop):
        flc = FLConfig(n_devices=pop, **flc_kw)
        # one cached client: every population derives each cohort's data
        bank = ProceduralClients(SEED, pop, batch_size=flc.batch_size,
                                 samples_per_client=16, cache_size=1)
        return NeuLiteServer(adapter, bank, flc,
                             fleet=Fleet(SEED, pop, budget), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rows = []
    for pop in populations:
        pop = int(pop)
        srv = server(pop)
        for r in range(stages):
            srv.run_round(r)
        sync()
        t0 = time.perf_counter()
        for r in range(stages, stages + rounds):
            srv.run_round(r)
        sync()
        dt = (time.perf_counter() - t0) / rounds
        del srv
        gc.collect()
        tracemalloc.start()
        srv = server(pop)
        srv.run_round(0)
        sync()
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        del srv
        gc.collect()
        rows.append({
            "population": pop, "clients_per_round": clients_per_round,
            "selection": selection, "rounds": rounds,
            "rounds_per_s": 1.0 / dt, "server_peak_mb": peak / 2 ** 20,
            "ru_maxrss_mb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0})
    return rows


def merge_bench_json(path, payload: dict, device: torch.device,
                     **meta) -> str:
    """``write_bench_json`` of ``payload`` beside the keys already in
    ``path``, so that the async and population rows join the cohort mode's
    file (which ``run`` starts afresh) and keep its meta.  A file written
    on another device is started afresh too."""
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
        old, here = doc.pop("meta", {}), device_meta(device)
        if all(old.get(k) == v for k, v in here.items()):
            meta = {**{k: v for k, v in old.items() if k not in here},
                    **meta}
        else:
            doc = {}
    doc.update(payload)
    return write_bench_json(path, doc, device, **meta)


def _bench_async_rank(device, kind, num_cohorts, batch_size, local_steps,
                      buffer_size, rounds, model_parallel):
    """``bench_async`` on one rank of a spawned world."""
    return bench_async(kind, num_cohorts, batch_size, local_steps, device,
                       buffer_size, rounds, model_parallel)


def run_async(device=None, out=None, settings=ASYNC_SETTINGS,
              buffer_size: int = 0, rounds: int = 2,
              model_parallel: int = 1) -> list:
    """``bench_async`` of each setting, printed and, with ``out``, added
    to it under ``"async"`` (``"async_model_parallel"`` with
    ``model_parallel > 1``: rank 0's rows of a spawned world of
    ``world_size(model_parallel)`` ranks)."""
    from repro_torch.launch.mesh import spawn_world
    device = resolve_device(device)
    rows = []
    for kind, C, B, E in settings:
        if model_parallel > 1:
            row = spawn_world(_bench_async_rank, world_size(model_parallel),
                              device, kind, C, B, E, buffer_size, rounds,
                              model_parallel,
                              threads=_rank_threads(device))[0]
        else:
            row = bench_async(kind, C, B, E, device, buffer_size, rounds)
        rows.append(row)
        print(f"  async {kind} C={C} K={row['buffer_size']}: version "
              f"{row['server_version']}, carried {row['n_carried']}, "
              f"pending {row['n_pending']}, sync {row['sync_time']:.2f} s, "
              f"async {row['async_time']:.2f} s (simulated), speedup "
              f"{row['speedup']:.2f}x, trainable {row['trainable_bytes']} "
              f"bytes, mesh {row['mesh']} held "
              f"{row['held_trainable_bytes']} bytes, wall s/round "
              f"{statistics.median(row['round_seconds']):.4f}", flush=True)
    if out is not None:
        key = "async_model_parallel" if model_parallel > 1 else "async"
        merge_bench_json(out, {key: rows}, device)
    return rows


def run_population(device=None, out=None, populations=POPULATIONS,
                   rounds: int = 8, selection: str = "random") -> list:
    """``bench_population``, printed and, with ``out``, added to it under
    ``"population"``."""
    device = resolve_device(device)
    rows = bench_population(populations, device, rounds=rounds,
                            selection=selection)
    for row in rows:
        print(f"  population {row['population']}: "
              f"{row['rounds_per_s']:.2f} rounds/s, heap peak "
              f"{row['server_peak_mb']:.2f} MB, maxrss "
              f"{row['ru_maxrss_mb']:.0f} MB", flush=True)
    if out is not None:
        merge_bench_json(out, {"population": rows}, device)
    return rows


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
    ap.add_argument("--runtime", choices=["all", "async"], default="all",
                    help="'async': the buffered-async server's simulated "
                         "speedup")
    ap.add_argument("--buffer", type=int, default=0,
                    help="async buffer size K (0: 3/4 of the cohort)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="async: stateful server rounds")
    ap.add_argument("--population", type=float, nargs="+", default=None,
                    metavar="N", help="sweep full rounds over these "
                    "population sizes (e.g. 1e2 1e4 1e6)")
    ap.add_argument("--selection", choices=["random", "tifl", "oort"],
                    default="random", help="cohort policy of --population")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="K",
                    help="the sharded round on a (W/K, K) mesh of "
                         "W = max(4, 2K) spawned ranks against the "
                         "replicated round (with --runtime async: the "
                         "async mode on that mesh)")
    args = ap.parse_args()
    if args.population:
        run_population(args.device, args.out, args.population,
                       selection=args.selection)
    elif args.runtime == "async":
        run_async(args.device, args.out, buffer_size=args.buffer,
                  rounds=args.rounds, model_parallel=args.model_parallel)
    elif args.model_parallel > 1:
        run_model_parallel(args.device, args.out, args.model_parallel,
                           iters=args.iters)
    else:
        run(args.device, args.out, args.iters)


if __name__ == "__main__":
    main()
