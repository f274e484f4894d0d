"""Device memory of the server's rounds, eager against captured steps, on
the card: what a batch that fits one runtime needs in the other.

A ``NeuLiteServer`` of full-width xlstm-1.3b (``xlstm_server``: 48
layers, d_model 2048, vocab 50304, f32, batch 16 at seq 256, 4 of 100
clients, SGD at lr 1e-4, K1-K5 on, 3 stages; ``chip_smoke.py``'s main
path 3 runs it with its depth cut to 24 layers) runs its first rounds twice from the same seed: with the
runtime's captured steps (the default on the card) and with eager steps
(``capture=False``).  Per round: the allocator's peak allocated and
reserved MiB (from an emptied cache; a captured step's graph pool counts
as reserved, not allocated, between its replays), the round's seconds
and its loss.  ``--schedule sequential`` gives each stage two rounds, so
that a round follows one of its own stage (the round-robin schedule,
main path 3's, changes stage every round).

  PYTHONPATH=src python -m repro_torch.benchmarks.round_memory \\
      --schedule sequential --out results/round_memory.json

On the card only.  TF32 off.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import torch

from repro_torch.benchmarks.common import smi_line

SEED = 0
STAGES = 3
BATCH, SEQ_LEN, SEQS = 16, 256, 3200
LR = 1e-4


def xlstm_server(capture: bool = True, schedule: str = "round_robin",
                 rounds_per_stage: int = 2, params=None,
                 num_layers: int = 0):
    """Full-width xlstm-1.3b over a 100-device fleet on synthetic text,
    built from SEED; ``capture=False`` keeps its steps eager,
    ``params`` (on the card) takes the place of the init from SEED, and
    ``num_layers`` (whole periods of 8) cuts its depth."""
    from repro_torch.configs import xlstm_1_3b
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = xlstm_1_3b.config()
    cfg = dataclasses.replace(cfg, use_slstm_kernel=True, dtype="float32",
                              num_layers=num_layers or cfg.num_layers)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=BATCH, lr=LR, num_stages=STAGES,
                   use_hsic_kernel=True, runtime="sequential",
                   schedule=schedule, rounds_per_stage=rounds_per_stage,
                   seed=SEED)
    ds = make_lm_dataset(SEED, SEQS, SEQ_LEN, cfg.vocab_size)
    parts = dirichlet_partition(SEED, ds.topics, flc.n_devices,
                                alpha=flc.alpha)
    server = NeuLiteServer(make_adapter(cfg, flc.num_stages),
                           [ds.subset(p) for p in parts], flc,
                           data_kind="lm", params=params)
    server.runtime.capture = server.runtime.capture and capture
    return server


def run_server(capture: bool, schedule: str, rounds: int):
    """``rounds`` rounds of a fresh server, each from an emptied cache: a
    row per round."""
    server = xlstm_server(capture, schedule)
    name = "captured" if capture else "eager"
    rows = []
    for r in range(rounds):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rr = server.run_round(r)
        torch.cuda.synchronize()
        rows.append({"steps": name, "round": r, "stage": rr.stage,
                     "seconds": time.perf_counter() - t0,
                     "peak_allocated_mib":
                         torch.cuda.max_memory_allocated() / 2**20,
                     "peak_reserved_mib":
                         torch.cuda.max_memory_reserved() / 2**20,
                     "mean_loss": rr.mean_loss})
        row = rows[-1]
        print(f"  {name} round {r} (stage {rr.stage}): "
              f"{row['seconds']:.3f} s, peak allocated "
              f"{row['peak_allocated_mib']:.1f} MiB, reserved "
              f"{row['peak_reserved_mib']:.1f} MiB, loss {rr.mean_loss!r}",
              flush=True)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def run(schedule: str = "sequential", rounds: int = 4, out=None):
    """Captured and eager rounds of one schedule; per round the reserved
    ratio (captured over eager) and whether the losses agree to the bit."""
    if not torch.cuda.is_available():
        raise RuntimeError("round_memory measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    captured = run_server(True, schedule, rounds)
    eager = run_server(False, schedule, rounds)
    pairs = [{"round": c["round"], "stage": c["stage"],
              "reserved_ratio": (c["peak_reserved_mib"]
                                 / e["peak_reserved_mib"]),
              "same_loss": repr(c["mean_loss"]) == repr(e["mean_loss"])}
             for c, e in zip(captured, eager)]
    for p in pairs:
        print(f"  round {p['round']} (stage {p['stage']}): reserved "
              f"captured / eager {p['reserved_ratio']:.4f}, the same loss: "
              f"{p['same_loss']}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({"smi": smi, "torch": torch.__version__,
                       "schedule": schedule, "batch": BATCH,
                       "rows": captured + eager, "pairs": pairs}, f,
                      indent=1)
    return pairs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--schedule", default="sequential",
                    choices=("sequential", "round_robin"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    run(a.schedule, a.rounds, a.out)


if __name__ == "__main__":
    main()
