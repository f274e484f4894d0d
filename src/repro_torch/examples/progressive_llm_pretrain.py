"""Progressively pre-train a ~100M-param decoder LM on synthetic data,
NeuLite's stage steps against end-to-end training, on wall-clock per step
and loss (port of ``examples/progressive_llm_pretrain.py``).

    python -m repro_torch.examples.progressive_llm_pretrain --steps 200
    python -m repro_torch.examples.progressive_llm_pretrain --device cpu \\
        --steps 8 --d-model 64 --layers 4 --vocab 256

The default model is 12 layers of d_model 640 (d_ff 2560, 10 heads over 5
kv heads of 64), vocab 32768, float32.  NeuLite runs AdamW at 3e-4 on the
round-robin stages, 4 steps a stage, the curriculum loss with nHSIC through
K1-K3 and attention through K4 (on the CPU their plain versions); then the
same steps end to end from the same init.  Steps are eager on both sides,
timed on the host clock after a synchronize, the first five left out.
Scale note: the paper's 1.84-2.31x per-round speedup is measured on
memory-bound edge devices, where the frozen prefix's savings dominate; at
toy widths the nHSIC terms and the surrogate output module are a fixed
overhead that can exceed them (``--no-curriculum`` isolates the compute
saving).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import paramdef as PD
from repro_torch.common.device import resolve_device
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (make_adapter, make_full_step,
                                          make_stage_step)
from repro_torch.core.schedule import RoundRobinSchedule
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=640,
                    help="640 -> ~100M params; reduce on slow CPUs")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--no-curriculum", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device=None) -> dict:
    """Run both legs; ``device`` (or ``--device``) as ``resolve_device``
    takes it.  Returns the config, ms/step, the final CEs, the per-step
    speedup, each leg's losses and the stage of each NeuLite step."""
    args = parser().parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    # default ~100M params: 12L x d640 x ff2560, 32k vocab
    cfg = ModelConfig(name="pretrain-lm", family="dense",
                      num_layers=args.layers, d_model=args.d_model,
                      num_heads=max(2, args.d_model // 64),
                      num_kv_heads=max(1, args.d_model // 128),
                      d_ff=args.d_model * 4, vocab_size=args.vocab,
                      dtype="float32", use_flash_kernel=True)
    adapter = make_adapter(cfg, num_stages=args.stages)
    n_params = PD.nparams(adapter.defs["model"])
    print(f"model: {n_params/1e6:.0f}M params", flush=True)

    ds = make_lm_dataset(0, 8192, args.seq, cfg.vocab_size)
    rng = np.random.default_rng(0)

    def batch(i):
        sel = rng.integers(0, len(ds), args.batch)
        t = torch.from_numpy(ds.tokens[sel]).to(dev)
        return {"inputs": {"tokens": t[:, :-1]}, "labels": t[:, 1:]}

    # --- NeuLite progressive ----------------------------------------------
    params = adapter.init_params(0, dev, draw_on_device=dev.type == "cuda")
    opt = adamw(3e-4)
    hp = CurriculumHP(lambda1_max=1.0, lambda2_max=0.5, mu=0.0,
                      enabled=not args.no_curriculum, use_hsic_kernel=True)
    sched = RoundRobinSchedule(args.stages)
    steps = {}
    times, losses, stages = [], [], []
    r = i = 0
    while i < args.steps:
        t = sched.stage(r)
        r += 1
        frozen, trainable = adapter.split_stage(params, t)
        if t not in steps:
            steps[t] = make_stage_step(adapter, opt, hp, t)
        opt_state = opt.init(trainable)
        for _ in range(4):
            b = batch(i)
            _sync(dev)
            t0 = time.perf_counter()
            opt_state, trainable, m = steps[t](opt_state, trainable, frozen,
                                               b, trainable)
            _sync(dev)
            if i > 4:
                times.append(time.perf_counter() - t0)
            losses.append(float(m["ce"]))
            stages.append(t)
            i += 1
        params = adapter.merge_stage(params, trainable, t)
        if r % 4 == 0:
            print(f"[NeuLite] step {i:4d} stage {t} ce {losses[-1]:.3f}",
                  flush=True)
    neulite_t = float(np.mean(times))
    neulite_ce = float(np.mean(losses[-8:]))

    # --- E2E baseline -------------------------------------------------------
    del params, frozen, trainable, opt_state
    params = adapter.init_params(0, dev, draw_on_device=dev.type == "cuda")
    full = make_full_step(adapter, opt)
    opt_state = opt.init(params)
    times2, losses2 = [], []
    for i in range(args.steps):
        b = batch(i)
        _sync(dev)
        t0 = time.perf_counter()
        opt_state, params, m = full(opt_state, params, b)
        _sync(dev)
        if i > 4:
            times2.append(time.perf_counter() - t0)
        losses2.append(float(m["loss"]))
        if i % 16 == 0:
            print(f"[E2E]     step {i:4d} loss {losses2[-1]:.3f}", flush=True)
    e2e_t = float(np.mean(times2))
    e2e_ce = float(np.mean(losses2[-8:]))
    speedup = e2e_t / neulite_t

    print(f"\nNeuLite: {neulite_t*1e3:.0f} ms/step, final ce {neulite_ce:.3f}")
    print(f"E2E:     {e2e_t*1e3:.0f} ms/step, final ce {e2e_ce:.3f}")
    print(f"per-step speedup: {speedup:.2f}x "
          f"(paper: 1.84-2.31x per round on-device)", flush=True)
    return {"n_params": n_params, "config": cfg,
            "neulite_ms": neulite_t * 1e3, "e2e_ms": e2e_t * 1e3,
            "neulite_ce": neulite_ce, "e2e_ce": e2e_ce, "speedup": speedup,
            "neulite_losses": losses, "e2e_losses": losses2,
            "stages": stages}


if __name__ == "__main__":
    main()
