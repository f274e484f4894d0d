"""Paper Fig. 6: peak training memory of each NeuLite stage against
full-model training (port of the reference's ``benchmarks/fig6_memory.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_memory --out FILE

Six measured models, each at full width: the paper's four CNNs
(ResNet18/34, VGG11, SqueezeNet; 32x32x3, 10 classes, 4 stages) at its
batch of 128; ViT-12 (64x64 images, 100 classes, 3 stages, attention
through K4) at batch 32; xlstm-1.3b (seq 256, 3 stages, the sLSTM scan
through K5, SGD at lr 1e-4) at batch 16.  It always computes the analytic table (``core.memory``:
``stage_memory_table`` and ``estimate_full_memory``).  On the card it adds
the measured peaks (``analysis.memory.measure_local_training``: two local
steps of each stage and of the full-model step on the same two batches,
nHSIC through the kernels K1-K3), with TF32 off for convolutions and
matrix products, as the port's parity bars are held, and the reference's
gate (every stage below the full step).  ``--device cpu`` gives the
analytic table alone; the measured columns then read "not measured".
The reference's transformer row, ``granite-smoke`` (granite-3-8b's smoke
config, 4 stages asked, batch 32, seq 128), is analytic only, on every
device: the reference measures no peak for it, and its own estimate
already peaks above the full step, so it is printed and not gated.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List

import torch

from repro_torch.analysis.memory import (PeakMemory, audit_memory,
                                         measure_local_training)
from repro_torch.benchmarks.common import write_bench_json
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_smoke_config, xlstm_1_3b
from repro_torch.configs.paper_models import vit
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.memory import estimate_full_memory, stage_memory_table
from repro_torch.core.progressive import make_adapter
from repro_torch.data.loader import Batcher
from repro_torch.data.synthetic import make_image_dataset, make_lm_dataset
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim.optimizers import sgd

SEED = 0
PAPER_BATCH = 128
CNNS = (("resnet18", 4), ("resnet34", 4), ("vgg11", 4), ("squeezenet", 4))
LR = 0.05                     # FLConfig's SGD (momentum 0.9, decay 5e-4)
VIT = dict(num_classes=100, image_size=64, num_layers=12, d_model=384)
VIT_BATCH, VIT_STAGES, VIT_PATCHES = 32, 3, 64
# SGD at lr 0.05 diverges on xlstm-1.3b at the reference's init
XLSTM_BATCH, XLSTM_STAGES, XLSTM_SEQ, XLSTM_LR = 16, 3, 256, 1e-4
# the reference's transformer row: analytic only
GRANITE, GRANITE_STAGES, GRANITE_BATCH, GRANITE_SEQ = (
    "granite-3-8b", 4, 32, 128)
MIB = 2 ** 20


def analytic(adapter, batch: int, seq: int = 0) -> dict:
    """The analytic model's bytes: each stage's and the full step's, and
    its reduction 1 - max(stage) / full."""
    stages = [e.total for e in stage_memory_table(adapter, batch, seq)]
    full = estimate_full_memory(adapter, batch, seq).total
    return {"stage_bytes": stages, "full_bytes": full,
            "reduction": 1.0 - max(stages) / full}


def two_batches(batcher: Batcher) -> List[dict]:
    """The host batches every measurement of a model steps through."""
    return list(batcher.batches(2))


def cnn_adapter(arch: str, stages: int):
    """One of the paper's CNNs at full width (32x32x3, 10 classes)."""
    return make_adapter(CNNConfig(name=arch, arch=arch), stages)


def image_batches(adapter, batch: int) -> List[dict]:
    return two_batches(Batcher(make_image_dataset(
        SEED, 2 * batch, num_classes=adapter.num_classes,
        image_size=adapter.cfg.image_size), batch, seed=SEED))


def _entry(m: PeakMemory, estimates: Dict[str, int]) -> dict:
    return dict(dataclasses.asdict(m), estimate_bytes=estimates,
                measured_over_estimate={k: m.peak_bytes / v
                                        for k, v in estimates.items()})


def summarize(name: str, batch: int, stages: List[PeakMemory],
              full: PeakMemory, estimates: Dict[str, dict]) -> dict:
    """One model's row: each stage's and the full step's measured peak
    and resident bytes beside each labelled analytic estimate, the
    measured and estimated reductions and the gate."""
    peaks = {t: m.peak_bytes for t, m in enumerate(stages)}
    table, failures = audit_memory(peaks, full.peak_bytes)
    row = {
        "batch": batch,
        "stages": [_entry(m, {k: e["stage_bytes"][t]
                              for k, e in estimates.items()})
                   for t, m in enumerate(stages)],
        "full": _entry(full, {k: e["full_bytes"]
                              for k, e in estimates.items()}),
        "reduction": 1.0 - max(peaks.values()) / full.peak_bytes,
        "estimate_reduction": {k: e["reduction"]
                               for k, e in estimates.items()},
        "audit": table, "failures": failures}
    print(f"  {name} B={batch}:", flush=True)
    for label, m, e in ([(f"stage {t}", m, row["stages"][t])
                         for t, m in enumerate(stages)]
                        + [("full step", full, row["full"])]):
        est = ", ".join(f"{k} {v / MIB:.1f} MiB (x{m.peak_bytes / v:.2f})"
                        for k, v in e["estimate_bytes"].items())
        print(f"    {label}: peak {m.peak_bytes / MIB:.1f} MiB, resident "
              f"{m.resident_bytes / MIB:.1f} MiB, loss {m.mean_loss:.4f}; "
              f"estimate {est}", flush=True)
    est = ", ".join(f"{k} {v:.1%}"
                    for k, v in row["estimate_reduction"].items())
    print(f"    reduction 1 - max(stage)/full: measured "
          f"{row['reduction']:.1%}; estimate {est}; every stage below the "
          f"full step: {'yes' if not failures else 'NO'}", flush=True)
    return row


def model_row(name: str, adapter, batch: int, estimates: Dict[str, dict],
              make_batches, lr: float, device) -> dict:
    """The analytic estimates and, on the card, every stage's and the full
    step's measured peak over the same two batches (``make_batches()``)."""
    if device.type != "cuda":
        for k, e in estimates.items():
            print(f"  {name} B={batch} ({k}): estimate full "
                  f"{e['full_bytes'] / MIB:.1f} MiB, stages "
                  f"{[round(b / MIB, 1) for b in e['stage_bytes']]} MiB, "
                  f"reduction {e['reduction']:.1%}; measured: not measured "
                  f"(no card)", flush=True)
        return {"batch": batch, "estimate": estimates,
                "measured": "not measured"}
    params = adapter.init_params(SEED, "cpu")
    batches = make_batches()
    opt, hp = sgd(lr), CurriculumHP(use_hsic_kernel=True)
    stages = [measure_local_training(adapter, params, batches, opt, stage=t,
                                     hp=hp, device=device)
              for t in range(adapter.plan.num_stages)]
    full = measure_local_training(adapter, params, batches, opt, hp=hp,
                                  device=device)
    return summarize(name, batch, stages, full, estimates)


def rows(device) -> dict:
    out = {}
    for arch, stages in CNNS:
        adapter = cnn_adapter(arch, stages)
        out[arch] = model_row(
            arch, adapter, PAPER_BATCH,
            {"analytic": analytic(adapter, PAPER_BATCH)},
            lambda: image_batches(adapter, PAPER_BATCH), LR, device)
    # the server charges an image model no activation bytes (seq 0); the
    # estimate is also given at its 64 patches
    adapter = make_adapter(dataclasses.replace(vit(**VIT),
                                               use_flash_kernel=True),
                           VIT_STAGES)
    out["vit12"] = model_row(
        "vit12", adapter, VIT_BATCH,
        {"seq=0 (the server's)": analytic(adapter, VIT_BATCH),
         f"seq={VIT_PATCHES} (patches)": analytic(adapter, VIT_BATCH,
                                                  VIT_PATCHES)},
        lambda: image_batches(adapter, VIT_BATCH), LR, device)
    xadapter = make_adapter(dataclasses.replace(
        xlstm_1_3b.config(), use_slstm_kernel=True, dtype="float32"),
        XLSTM_STAGES)
    out["xlstm-1.3b"] = model_row(
        "xlstm-1.3b", xadapter, XLSTM_BATCH,
        {f"seq={XLSTM_SEQ}": analytic(xadapter, XLSTM_BATCH, XLSTM_SEQ)},
        lambda: two_batches(Batcher(make_lm_dataset(
            SEED, 2 * XLSTM_BATCH, XLSTM_SEQ, xadapter.cfg.vocab_size),
            XLSTM_BATCH, seed=SEED, kind="lm")), XLSTM_LR, device)
    gadapter = make_adapter(get_smoke_config(GRANITE), GRANITE_STAGES)
    est = analytic(gadapter, GRANITE_BATCH, GRANITE_SEQ)
    print(f"  granite-smoke B={GRANITE_BATCH} seq={GRANITE_SEQ} "
          f"({gadapter.plan.num_stages} stages): estimate full "
          f"{est['full_bytes'] / MIB:.1f} MiB, stages "
          f"{[round(b / MIB, 1) for b in est['stage_bytes']]} MiB, "
          f"reduction {est['reduction']:.1%}; not measured (analytic "
          f"only, as in the reference; not gated)", flush=True)
    out["granite-smoke"] = {"batch": GRANITE_BATCH, "seq": GRANITE_SEQ,
                            "estimate": {f"seq={GRANITE_SEQ}": est},
                            "measured": "not measured"}
    return out


def run(device=None, out_path=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        # as NeuLiteServer sets them on a CUDA device, with TF32 off
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = rows(device)
    if out_path is not None:
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        write_bench_json(out_path, {"rows": out},
                         device, cudnn_deterministic=cudnn.deterministic,
                         cudnn_allow_tf32=cudnn.allow_tf32,
                         matmul_allow_tf32=matmul.allow_tf32)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' gives "
                        "the analytic table alone)")
    p.add_argument("--out", default=None, help="JSON file to write")
    args = p.parse_args(argv)
    out = run(device=args.device, out_path=args.out)
    failed = {a: r["failures"] for a, r in out.items() if r.get("failures")}
    if failed:
        raise SystemExit(f"a stage peaks at or above its full step: {failed}")


if __name__ == "__main__":
    main()
