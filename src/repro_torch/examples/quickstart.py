"""Quickstart: NeuLite's elastic progressive training in a page (port of the
reference's ``examples/quickstart.py``).

Trains a small decoder-only transformer (12 layers, d_model 128, causal
GQA with 4 query heads over 2 kv heads of 32) on synthetic LM data with
the paper's pipeline: block partitioning, the curriculum-aware loss
(CE − λ1·nHSIC(X;Z) − λ2·nHSIC(Y;Z)), surrogate output modules and
round-robin model growth (Alg. 1).  It prints the analytic peak-memory
saving against end-to-end training, each round's losses, and one FL
round of 4 cohorts on the sequential and the vectorized runtime.
Attention runs through the flash kernel K4 and nHSIC through K1-K3 (on
the CPU the wrappers take their plain versions).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.memory import estimate_full_memory, stage_memory_table
from repro_torch.core.progressive import make_adapter, make_stage_step
from repro_torch.core.schedule import RoundRobinSchedule
from repro_torch.data.loader import Batcher, stack_round
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.federated.runtime import make_runtime
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import sgd

NUM_STAGES, BATCH, SEQ, COHORTS = 4, 8, 64, 4


def config() -> ModelConfig:
    return ModelConfig(name="quickstart-12L", family="dense", num_layers=12,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=512, dtype="float32",
                       use_flash_kernel=True)


def memory_line(adapter) -> str:
    """The analytic peak training memory, full model against the largest
    stage (``core.memory``)."""
    full = estimate_full_memory(adapter, BATCH, SEQ)
    peak = max(e.total for e in stage_memory_table(adapter, BATCH, SEQ))
    return (f"peak training memory: full={full.total/1e6:.1f}MB -> "
            f"progressive={peak/1e6:.1f}MB "
            f"({100*(1-peak/full.total):.1f}% reduction)")


def main(device=None, rounds: int = 16, params=None) -> dict:
    """Runs the quickstart on ``device`` (the CUDA card unless given) from
    ``params`` (default: the adapter's init from seed 0); returns what it
    printed: the memory line, each round's (stage, ce, nHSIC(X;Z),
    nHSIC(Y;Z)) and each runtime's (loss, s/round)."""
    device = resolve_device(device)
    cfg = config()
    adapter = make_adapter(cfg, num_stages=NUM_STAGES)
    if params is None:
        params = adapter.init_params(0, device)
    optimizer = sgd(0.1, momentum=0.9)
    hp = CurriculumHP(lambda1_max=1.0, lambda2_max=0.5, mu=0.0,
                      use_hsic_kernel=True)
    schedule = RoundRobinSchedule(NUM_STAGES)
    ds = make_lm_dataset(0, 1024, SEQ, cfg.vocab_size)
    rng = np.random.default_rng(0)
    out = {"memory_line": memory_line(adapter), "rounds": [],
           "runtimes": {}}

    # --- memory story ------------------------------------------------------
    print(out["memory_line"] + "\n")

    # --- progressive training (Alg. 1) -------------------------------------
    steps = {t: make_stage_step(adapter, optimizer, hp, t)
             for t in range(NUM_STAGES)}
    for r in range(rounds):
        t = schedule.stage(r)
        frozen, trainable = adapter.split_stage(params, t)
        opt_state = optimizer.init(trainable)
        for _ in range(4):
            toks = ds.tokens[rng.integers(0, len(ds), BATCH)]
            batch = to_device({"inputs": {"tokens": toks[:, :-1]},
                               "labels": toks[:, 1:]}, device)
            opt_state, trainable, m = steps[t](opt_state, trainable, frozen,
                                               batch, trainable)
        params = adapter.merge_stage(params, trainable, t)
        ce, xz, yz = (float(m[k]) if k in m else float("nan")
                      for k in ("ce", "nhsic_xz", "nhsic_yz"))
        out["rounds"].append((t, ce, xz, yz))
        print(f"round {r:3d} | stage {t} | ce {ce:.4f} | "
              f"nHSIC(X;Z) {xz:.3f} | nHSIC(Y;Z) {yz:.3f}")
    print("\ndone — the full model is assembled in `params`.")

    # --- runtime selection (federated rounds) ------------------------------
    # One FL round over 4 cohorts: "sequential" runs the clients one after
    # another (captured steps on the card), "vectorized" every cohort in one
    # vmapped step (K1-K3 batched over the cohorts, K4 over their folded
    # batches), with the Eq. 1 FedAvg after.
    batchers = [Batcher(ds.subset(np.arange(c, len(ds), COHORTS)), BATCH,
                        seed=c, kind="lm") for c in range(COHORTS)]
    stack = stack_round(batchers, range(COHORTS), local_steps=2)
    print(f"\nFL round, {COHORTS} cohorts x {stack.max_steps} local steps:")
    for name in ("sequential", "vectorized"):
        runtime = make_runtime(name, adapter, optimizer, hp, device)
        runtime.run_stacked(params, 0, stack)            # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, metrics = runtime.run_stacked(params, 0, stack)
        loss = float(metrics["mean_local_loss"])      # waits for the round
        sec = time.perf_counter() - t0
        out["runtimes"][name] = (loss, sec)
        print(f"  {name:11s} loss {loss:.4f} ({sec:.3f}s/round)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=16)
    a = ap.parse_args()
    main(a.device, a.rounds)
