"""Kernel audit: the CUDA kernels against their plain versions on
adversarial draws, and what the card built for each (port of
``repro.analysis.pallas_audit``).

**The differential fuzzer** (``fuzz_families``) draws each case from the
reference's seeded stream, ``np.random.default_rng(1_000_003 * (seed + 1)
+ i_fam)``, in the reference's order, so a seed gives the reference's
shapes and arrays to the bit; the Pallas block sizes it draws are recorded
and not passed (the port's ops take none).  On the card each draw runs the
public op (K4; K5 forward and backward; K1-K3 forward and backward)
against its plain version (``ref.py``, ``core/hsic.py``), forward and
every gradient, TF32 off, at the reference's scale-relative bar: 1e-3 in
f32, 2e-2 in bf16 (``_rel_err``, ``_tol``; bf16 accumulation, the
reference's ``check_accum_dtype``, is what the bf16 K4 draws test).
Findings carry the reference's names and cap (``pallas.fuzz-mismatch``,
``pallas.fuzz-error``, ``MAX_FUZZ_FINDINGS``).

**The resource audit** (``audit_kernels``) replaces the reference's static
Pallas checks (write races, BlockSpec bounds, the VMEM budget), which read
grids a CUDA kernel does not have.  It runs no kernel: each ``.cu`` exports
an entry point that calls ``cudaFuncGetAttributes`` on each of its
``__global__`` kernels, and the ``kernel_resources`` artifact gets, per
kernel, its registers, static shared memory, local (spill) bytes,
``maxThreadsPerBlock`` and the block its launches use.  ``cuda.spill``
(warning) where a thread spills; ``cuda.block-size`` (error) where the
launch's block exceeds what the kernel may take.  Every case of
``AUDIT_CASES`` must name kernels the audit read (``cuda.unknown-kernel``).

Both need the card: ``run_kernel_audits`` raises without one, through
``common.device.resolve_device``.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.report import Report
from repro_torch.common.device import DeviceLike, resolve_device

FAMILIES = ("flash_attention", "hsic_gram", "slstm_scan")
MAX_FUZZ_FINDINGS = 10    # per family: stop reporting after this many
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _module(family: str, part: str):
    return importlib.import_module(f"repro_torch.kernels.{family}.{part}")


# --------------------------------------------------------------------------- #
# the resource audit: what the card built, no kernel run
# --------------------------------------------------------------------------- #
def audit_kernels(report: Report, *,
                  families: Optional[Sequence[str]] = None) -> list:
    """Each built kernel's resources into ``kernel_resources``; spills and
    over-wide blocks as findings."""
    table = []
    for fam in families or FAMILIES:
        kernel = _module(fam, "kernel")
        rows = kernel.kernel_resources()
        for row in rows:
            row["family"] = fam
            where = f"{fam}/{row['kernel']}"
            if row["local_bytes"] > 0:
                report.add(
                    "cuda.spill",
                    f"{row['kernel']} uses {row['local_bytes']} bytes of "
                    f"local memory a thread ({row['registers']} registers):"
                    f" spilled registers or a stack array go through L1 "
                    f"and device memory.", severity="warning",
                    program=where)
            if row["block"] > row["max_threads"]:
                report.add(
                    "cuda.block-size",
                    f"{row['kernel']} is launched with {row['block']} "
                    f"threads a block but takes at most "
                    f"{row['max_threads']} ({row['registers']} registers a "
                    f"thread): every launch would be refused.",
                    program=where)
        built = {r["kernel"].split("<")[0] for r in rows}
        for case in _module(fam, "ops").AUDIT_CASES():
            for name in set(case.kernels) - built:
                report.add("cuda.unknown-kernel",
                           f"audit case {case.name} names {name}, which "
                           f"the built library does not report",
                           program=fam, location=case.location())
        table.extend(rows)
    report.artifacts["kernel_resources"] = table
    return table


# --------------------------------------------------------------------------- #
# differential fuzzing: each kernel's public op against its plain version
# --------------------------------------------------------------------------- #
def _rel_err(a, b) -> float:
    """max |a-b| / max(|b|), floored so near-zero oracles don't explode."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    denom = max(float(np.max(np.abs(b))), 1e-6)
    return float(np.max(np.abs(a - b)) / denom)


def _tol(dtype) -> float:
    return 2e-2 if dtype in _LOW_PRECISION else 1e-3


def _grads(fn, inputs):
    """Gradients of the scalar ``fn(*inputs)`` with respect to each."""
    live = [t.detach().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*live), live)


def draw_flash(rng: np.random.Generator) -> dict:
    """One flash-attention draw, in the reference's order: non-dividing
    shapes, Sq != Skv, GQA groups, degenerate D, bf16 operands; q, k, v and
    the cotangent w in float32 (cast to ``dtype`` on use)."""
    B = int(rng.integers(1, 3))
    KV = int(rng.integers(1, 3))
    G = int(rng.integers(1, 3))
    H = KV * G
    Sq = int(rng.integers(1, 161))
    Skv = int(rng.integers(1, 161))
    D = int(rng.choice([1, 4, 8, 32, 64]))
    bq = int(rng.choice([8, 16, 128]))
    bkv = int(rng.choice([8, 16, 128]))
    causal = bool(rng.integers(0, 2))
    window = int(rng.choice([0, 0, 1, int(rng.integers(1, max(Sq, 2)))]))
    dtype = "bfloat16" if rng.random() < 0.25 else "float32"
    params = dict(B=B, H=H, KV=KV, Sq=Sq, Skv=Skv, D=D, block_q=bq,
                  block_kv=bkv, causal=causal, window=window, dtype=dtype)
    arrays = {"q": rng.standard_normal((B, Sq, H, D), np.float32),
              "k": rng.standard_normal((B, Skv, KV, D), np.float32),
              "v": rng.standard_normal((B, Skv, KV, D), np.float32),
              "w": rng.standard_normal((B, Sq, H, D), np.float32)}
    return {"params": params, "arrays": arrays}


def check_flash(draw: dict, device: torch.device):
    """Forward and gradients of ``ops.flash_attention`` (K4) against
    ``ref.attention_ref`` on one draw."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    params, a = draw["params"], draw["arrays"]
    dtype = getattr(torch, params["dtype"])
    q, k, v = (torch.from_numpy(a[n]).to(device=device, dtype=dtype)
               for n in "qkv")
    w = torch.from_numpy(a["w"]).to(device)
    kw = dict(causal=params["causal"], window=params["window"])
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    results = [("flash fwd", _rel_err(out, ref), _tol(dtype), params)]
    gk = _grads(lambda q_, k_, v_: (flash_attention(q_, k_, v_, **kw)
                                    .float() * w).sum(), (q, k, v))
    gr = _grads(lambda q_, k_, v_: (attention_ref(q_, k_, v_, **kw)
                                    .float() * w).sum(), (q, k, v))
    for name, x, y in zip(("dq", "dk", "dv"), gk, gr):
        results.append((f"flash grad {name}", _rel_err(x, y), _tol(dtype),
                        params))
    return results


def draw_slstm(rng: np.random.Generator) -> dict:
    """One sLSTM-scan draw, in the reference's order: S not a multiple of
    its block, S below one block, degenerate Dh = 1; gates, r, b, the
    initial state and the cotangents of hs and of the final h."""
    B = int(rng.integers(1, 3))
    S = int(rng.integers(1, 97))
    H = int(rng.integers(1, 3))
    Dh = int(rng.choice([1, 3, 8, 16]))
    block_s = int(rng.choice([4, 8, 32, 128]))
    f32 = np.float32
    arrays = {
        "g_in": rng.standard_normal((B, S, 4, H, Dh), f32),
        "r": rng.standard_normal((4, H, Dh, Dh), f32) / np.sqrt(max(Dh, 1)),
        "b": 0.5 * rng.standard_normal((4, H, Dh), f32),
        "c": rng.standard_normal((B, H, Dh), f32),
        "n": rng.uniform(0.5, 2.0, (B, H, Dh)).astype(f32),
        "m": 0.5 * rng.standard_normal((B, H, Dh), f32),
        "h": rng.standard_normal((B, H, Dh), f32)}
    arrays["w"] = rng.standard_normal((B, S, H, Dh), f32)
    arrays["wf"] = rng.standard_normal((B, H, Dh), f32)
    return {"params": dict(B=B, S=S, H=H, Dh=Dh, block_s=block_s),
            "arrays": arrays}


def check_slstm(draw: dict, device: torch.device):
    """The outputs and gradients of ``ops.slstm_scan`` (K5 and its
    backward) against ``ref.slstm_scan_ref`` on one draw."""
    from repro_torch.kernels.slstm_scan.ops import slstm_scan
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

    params = draw["params"]
    a = {n: torch.from_numpy(np.asarray(x, np.float32)).to(device)
         for n, x in draw["arrays"].items()}
    state0 = {n: a[n] for n in "cnmh"}
    hs, fin = slstm_scan(a["g_in"], a["r"], a["b"], state0)
    hs_r, fin_r = slstm_scan_ref(a["g_in"], a["r"], a["b"], state0)
    results = [("slstm fwd hs", _rel_err(hs, hs_r), 1e-3, params)]
    for name in "cnmh":
        results.append((f"slstm fwd fin[{name}]",
                        _rel_err(fin[name], fin_r[name]), 1e-3, params))

    def loss(scan):
        def fn(g_, r_, b_):
            hs_, fin_ = scan(g_, r_, b_, state0)
            return (hs_ * a["w"]).sum() + (fin_["h"] * a["wf"]).sum()
        return fn

    inputs = (a["g_in"], a["r"], a["b"])
    for name, x, y in zip(("dg", "dr", "db"), _grads(loss(slstm_scan), inputs),
                          _grads(loss(slstm_scan_ref), inputs)):
        results.append((f"slstm grad {name}", _rel_err(x, y), 1e-3, params))
    return results


def draw_nhsic(rng: np.random.Generator) -> dict:
    """One streaming-nHSIC draw, in the reference's order: B far from a
    tile multiple or below one tile, degenerate D = 1, RBF / linear
    mixes."""
    B = int(rng.integers(2, 49))
    Dx = int(rng.choice([1, 2, 7, 32]))
    Dz = int(rng.choice([1, 2, 7, 32]))
    kx = str(rng.choice(["rbf", "linear"]))
    kz = str(rng.choice(["rbf", "linear"]))
    block = int(rng.choice([2, 3, 5, 128]))
    arrays = {"x": rng.standard_normal((B, Dx), np.float32),
              "z": rng.standard_normal((B, Dz), np.float32)}
    return {"params": dict(B=B, Dx=Dx, Dz=Dz, kernel_x=kx, kernel_z=kz,
                           block=block), "arrays": arrays}


def check_nhsic(draw: dict, device: torch.device):
    """The value and gradients of ``ops.nhsic`` (K1-K3) against
    ``core.hsic.nhsic``'s autograd on one draw."""
    from repro_torch.core.hsic import nhsic as nhsic_ref
    from repro_torch.kernels.hsic_gram.ops import nhsic as nhsic_kernel

    params = draw["params"]
    kw = dict(kernel_x=params["kernel_x"], kernel_z=params["kernel_z"])
    x, z = (torch.from_numpy(draw["arrays"][n]).to(device) for n in "xz")
    results = [("nhsic fwd", _rel_err(nhsic_kernel(x, z, **kw),
                                      nhsic_ref(x, z, **kw)), 1e-3, params)]
    for name, a, b in zip(("dx", "dz"),
                          _grads(lambda x_, z_: nhsic_kernel(x_, z_, **kw),
                                 (x, z)),
                          _grads(lambda x_, z_: nhsic_ref(x_, z_, **kw),
                                 (x, z))):
        results.append((f"nhsic grad {name}", _rel_err(a, b), 1e-3, params))
    return results


# family -> (draw, check): the reference's _fuzz_*_once split in two
FUZZERS = {
    "flash_attention": (draw_flash, check_flash),
    "hsic_gram": (draw_nhsic, check_nhsic),
    "slstm_scan": (draw_slstm, check_slstm),
}


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fuzz_families(report: Report, *, n_cases: int = 50, seed: int = 0,
                  families: Optional[Sequence[str]] = None,
                  device: DeviceLike = None) -> dict:
    """Each family's public op against its plain version on ``n_cases``
    draws of the reference's stream, forward and gradients, at the
    scale-relative bar (1e-3 f32 / 2e-2 bf16).  A mismatch is a
    ``pallas.fuzz-mismatch`` finding carrying the draw's parameters; a
    draw that raises is ``pallas.fuzz-error``.  Fills the ``kernel_fuzz``
    artifact (checks, failures, errors and the worst relative error a
    family)."""
    dev = resolve_device(device)
    summary = {}
    with tf32_off():
        for i_fam, fam in enumerate(families or FAMILIES):
            rng = np.random.default_rng(1_000_003 * (seed + 1) + i_fam)
            draw, check = FUZZERS[fam]
            checks = failures = errors = 0
            worst, worst_of_bar = 0.0, 0.0
            for i in range(n_cases):
                try:
                    results = check(draw(rng), dev)
                except Exception as e:
                    errors += 1
                    if errors + failures <= MAX_FUZZ_FINDINGS:
                        report.add("pallas.fuzz-error",
                                   f"case {i}: {type(e).__name__}: {e}",
                                   program=fam)
                    continue
                for label, err, tol, params in results:
                    checks += 1
                    worst = max(worst, err)
                    worst_of_bar = max(worst_of_bar, err / tol)
                    if not (err <= tol):
                        failures += 1
                        if errors + failures <= MAX_FUZZ_FINDINGS:
                            report.add(
                                "pallas.fuzz-mismatch",
                                f"{label}: rel err {err:.3e} > tol "
                                f"{tol:.0e} at {params}", program=fam)
            if errors + failures > MAX_FUZZ_FINDINGS:
                report.add("pallas.fuzz-mismatch",
                           f"...{errors + failures - MAX_FUZZ_FINDINGS} "
                           f"further failure(s) suppressed",
                           severity="warning", program=fam)
            summary[fam] = {"cases": n_cases, "checks": checks,
                            "failures": failures, "errors": errors,
                            "seed": seed, "worst_rel_err": worst,
                            "worst_of_bar": worst_of_bar}
    report.artifacts["kernel_fuzz"] = summary
    return summary


def render_tables(report: Report) -> str:
    """The ``kernel_resources`` table and the ``kernel_fuzz`` summary as
    text."""
    lines = []
    rows = report.artifacts.get("kernel_resources", [])
    if rows:
        lines.append(f"{'kernel':34} {'regs':>5} {'smem':>6} {'local':>6} "
                     f"{'max thr':>7} {'block':>5}")
        lines += [f"{r['kernel']:34} {r['registers']:5d} "
                  f"{r['static_smem']:6d} {r['local_bytes']:6d} "
                  f"{r['max_threads']:7d} {r['block']:5d}" for r in rows]
    for fam, f in report.artifacts.get("kernel_fuzz", {}).items():
        lines.append(f"fuzz {fam}: {f['cases']} draws, {f['checks']} "
                     f"checks, {f['failures']} mismatches, {f['errors']} "
                     f"errors, worst rel err {f['worst_rel_err']:.3e} "
                     f"({f['worst_of_bar']:.3f} of the bar)")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# entry point (python -m repro_torch.analysis --kernels)
# --------------------------------------------------------------------------- #
def run_kernel_audits(*, waive: Iterable[str] = (),
                      families: Optional[Sequence[str]] = None,
                      fuzz: int = 0, seed: int = 0,
                      device: DeviceLike = None) -> Report:
    """The resource audit of every family's built kernels, plus (``fuzz >
    0``) ``fuzz`` differential draws a family.  Needs the card: raises
    without one (``resolve_device``), and on any device but CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the kernel audit reads and runs the CUDA "
                           f"kernels; {dev} has none")
    report = Report(waive=waive)
    audit_kernels(report, families=families)
    if fuzz > 0:
        fuzz_families(report, n_cases=fuzz, seed=seed, families=families,
                      device=dev)
    return report
