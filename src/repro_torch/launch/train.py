"""NeuLite progressive FL training entry point (port of
``repro.launch.train``).

Runs the paper's pipeline on a registered architecture (the reduced smoke
variant by default; ``--full`` for the full config):

    python -m repro_torch.launch.train --arch qwen3-1.7b --rounds 20
    python -m repro_torch.launch.train --arch qwen3-1.7b --e2e   # baseline
    python -m repro_torch.launch.train --device cpu              # the CPU

The FL simulation maps clients onto synthetic non-IID LM shards
(``make_lm_dataset``, ``dirichlet_partition``) and drives
``NeuLiteServer`` (Alg. 1: round-robin growth, curriculum loss, boundary
co-training, memory-aware selection over a ``Fleet`` anchored at 2.5x the
largest stage's estimate).  ``--e2e`` runs SGD full-model steps instead.
Attention runs through the flash kernel (K4), the sLSTM scan through its
kernel (K5) and the curriculum's nHSIC through K1-K3; on the CPU each
takes its plain version.  Params are random from ``--seed``, drawn on
the device they live on.  Checkpoints and ``metrics.json`` land in
``--out``; with ``--checkpoint-every N`` the server's round-loop state is
checkpointed every N rounds and ``--resume`` continues a stopped run to
the bit from the newest checkpoint in ``<out>/ckpt``.  It trains text
only: an audio or VLM arch trains as text, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, save_checkpoint
from repro_torch.common import paramdef as PD
from repro_torch.common.device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.memory import estimate_stage_memory
from repro_torch.core.progressive import (make_full_step,
                                          make_transformer_adapter)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.federated.devices import Fleet
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.optim.optimizers import sgd


def lm_batches(ds, idx, batch, seed, device=None):
    """``batch`` sequences of ``ds`` drawn from ``idx`` by numpy's
    generator at ``seed`` (the reference's draw): inputs the tokens but
    the last, labels the tokens but the first."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(idx, batch)
    toks = torch.from_numpy(ds.tokens[sel]).to(device)
    return {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}


def main(argv=None, device=None) -> dict:
    """Train; ``device`` (or ``--device``) as ``resolve_device`` takes it.
    Returns the run's log (``metrics``), the final ``params`` and the
    seconds it took."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--runtime", default="sequential",
                    choices=["sequential", "vectorized", "sharded", "async"])
    ap.add_argument("--e2e", action="store_true",
                    help="vanilla FedAvg baseline instead of NeuLite")
    ap.add_argument("--no-curriculum", action="store_true")
    ap.add_argument("--out", default="results/train")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the full server state to <out>/ckpt every N "
                         "rounds (0 = only at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in <out>/ckpt "
                         "(bit-exact; falls back to a fresh run if none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.modality != "text":
        cfg = dataclasses.replace(cfg, modality="text")  # text only
    cfg = dataclasses.replace(cfg, use_flash_kernel=True,
                              use_slstm_kernel=True)
    adapter = make_transformer_adapter(cfg, num_stages=args.stages)
    params = adapter.init_params(args.seed, dev,
                                 draw_on_device=dev.type == "cuda")
    n_params = PD.nparams(adapter.defs["model"])
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"stages={adapter.plan.num_stages} units={adapter.plan.num_units}",
          flush=True)

    ds = make_lm_dataset(args.seed, 4096, args.seq, cfg.vocab_size)
    parts = dirichlet_partition(args.seed, ds.topics, args.clients, 1.0)
    os.makedirs(args.out, exist_ok=True)
    metrics_log = []
    t_start = time.perf_counter()

    if args.e2e:
        optimizer = sgd(args.lr, momentum=0.9, weight_decay=5e-4)
        step = make_full_step(adapter, optimizer)
        opt_state = optimizer.init(params)
        for r in range(args.rounds * args.local_steps):
            batch = lm_batches(ds, np.arange(len(ds)), args.batch,
                               args.seed + r, dev)
            t0 = time.time()
            opt_state, params, m = step(opt_state, params, batch)
            loss = float(m["loss"])
            if r % 10 == 0:
                print(f"step {r:4d} loss {loss:.4f} "
                      f"({time.time()-t0:.2f}s)", flush=True)
            metrics_log.append({"step": r, "loss": loss})
    else:
        ckpt_dir = os.path.join(args.out, "ckpt")
        # Fleet budgets are tier fractions (0.25-1.10) of the base budget.
        # Smoke transformers have stage memory ~= full memory (the head and
        # embeddings dominate), which would leave every device infeasible:
        # the base is anchored to the LARGEST stage requirement instead, so
        # the run keeps the relative memory wall and always progresses.
        req = max(estimate_stage_memory(adapter, t, args.batch,
                                        seq=args.seq - 1).total
                  for t in range(adapter.plan.num_stages))
        fleet = Fleet(args.seed, args.clients, int(2.5 * req))
        flc = FLConfig(n_devices=args.clients,
                       clients_per_round=args.cohort,
                       local_epochs=args.local_epochs,
                       batch_size=args.batch, lr=args.lr,
                       num_stages=args.stages,
                       curriculum=not args.no_curriculum,
                       use_hsic_kernel=True,
                       runtime=args.runtime, seed=args.seed,
                       checkpoint_dir=ckpt_dir,
                       checkpoint_every=args.checkpoint_every)
        clients = [ds.subset(p) for p in parts]
        built = dict(data_kind="lm", fleet=fleet, params=params, device=dev)
        if args.resume and latest_checkpoint(ckpt_dir) is not None:
            server = NeuLiteServer.restore(adapter, clients, flc, ckpt_dir,
                                           **built)
            print(f"resumed from {latest_checkpoint(ckpt_dir)} "
                  f"at round {server.next_round}", flush=True)
        else:
            server = NeuLiteServer(adapter, clients, flc, **built)
        del params
        remaining = args.rounds - server.next_round
        if remaining > 0:
            server.run(remaining, log_every=1)
        server.save_state(ckpt_dir)
        metrics_log = [dataclasses.asdict(rr) for rr in server.history]
        params = server.params
        save_checkpoint(args.out, args.rounds, params,
                        meta={"arch": cfg.name, "rounds": args.rounds})

    seconds = time.perf_counter() - t_start
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics_log, f, indent=1)
    print(f"wrote {args.out}/metrics.json", flush=True)
    return {"arch": cfg.name, "n_params": n_params, "metrics": metrics_log,
            "params": params, "seconds": seconds, "out": args.out}


if __name__ == "__main__":
    main()
