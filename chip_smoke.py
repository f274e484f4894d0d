#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels (``kernels/hsic_gram/csrc/nhsic.cu``, K1-K3,
   K6 and K7, ``kernels/flash_attention/csrc/flash_attention.cu``, K4, and
   ``kernels/slstm_scan/csrc/slstm_scan.cu``, K5) with ``nvcc``, one
   compiler per source, all started together; prints the build time.
2. Kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card, with TF32 off.  K1-K3 (forward, and the autograd backward of
   nHSIC) at the main paths' shapes, at batches/widths off the 32-row
   tile and at the edges of K2's and K3's thread-block clusters (D below
   the cluster size, off a multiple of 4, 4096 and above; B from 1 to
   256), identical rows (K2 and K3's gradients then exactly 0), and K2's
   and K3's bits over three runs; K4 at the ViT-12 shape, the reference's
   audit shapes (bf16, ragged S=200, windowed), GQA, causal with Sq !=
   Skv, causal+window with empty rows (exactly 0), its tiling (head dims
   1, 3, 20, 100; Sq=5 and 9; Skv=1000 with a window of 300), the same
   bits over three runs, and its autograd gradient; K5 (``hs`` and the four
   final states) at the xlstm-1.3b shape, the reference's audit shapes,
   S=1, ragged S=200, head dims 1, 3 and 48, random initial states and
   gates up to |g| = 100, and its autograd gradient.  Bar: scale-relative
   1e-3 in f32, 2e-2 in bf16.  K6 (the dense RBF and linear Gram) and K7
   (centred statistics of two dense Grams) at the reference's audit shape
   (B=256, D=256), its gram test's draws, the main paths' widths, ragged B
   (1, 33, 200), D=1, K6's tiling (B in {1, 31, 33, 257} x D in {1, 7,
   257, 2048}), non-symmetric Gram pairs and a batch of identical rows;
   every K6 Gram exactly symmetric, identical rows exactly 1, the same bits
   over three runs; ``nhsic_unfused`` (K6 twice, then K7, counted per call) against
   the fused op and plain nHSIC at abs 1e-4.  Times each kernel, its plain
   version and, for K4, ``F.scaled_dot_product_attention`` and, for the
   linear K6, ``x @ x.T`` as yardsticks (CUDA events, median of 30
   calls); for K4 (at the ViT-12 shape and the kernel benchmark's two
   attention shapes), K6 and K7 also the profiler's device time of the
   kernel and of the yardstick, and the host share of each call (event
   time less device time).  Bounds count matrix products at the tensor
   cores' rate (3xTF32 for f32, bf16 for bf16) and all other arithmetic at
   the float32 rate.
3. Main path 1: the port's ``NeuLiteServer`` (sequential runtime, nHSIC
   through the kernels) on the paper's ResNet18 at full width, 32x32x3,
   10 classes, batch 32, 4 stages: four rounds, one per stage, over a
   100-device fleet, then an evaluation.  Then one full-width step per
   stage, kernel path against plain path, and a profile of five steps per
   stage (``torch.profiler``).
4. Main path 2: the paper's ViT-12 at full width (d_model 384, 6 heads of
   64, 64x64x3, 100 classes, 64 patches), attention through K4, batch 32,
   3 stages: three rounds, one per stage, then an evaluation.  K4 must
   launch exactly once per attention layer run per local step (4, 8, 12 at
   stages 0, 1, 2) and K1-K3 twice per step.  Then the same step check
   (kernel path against ``use_flash_kernel=False``, plain nHSIC; the bar
   takes the plain path's own sensitivity into account, see
   ``step_check``), each of the 12 periods alone, kernel path against
   plain path (``period_check``), and the profile.
5. Main path 3: xlstm-1.3b at full width (48 layers in 6 periods of 7
   mLSTM + 1 sLSTM, d_model 2048, 4 heads of 512, vocab 50304, float32),
   the sLSTM scan through K5, synthetic text at seq 256, batch 16, SGD at
   lr 1e-4, 3 stages: three rounds, one per stage, then an evaluation.
   K5 must launch exactly once per sLSTM layer run (2, 4, 6 per local
   step at stages 0, 1, 2; 6 per evaluation batch), K1-K3 twice per step,
   K4 never.  Then the step check against ``use_slstm_kernel=False`` with
   plain nHSIC (with the plain path's own sensitivity), each of the 6
   sLSTM sub-layers alone, kernel path against plain path
   (``slstm_layer_check``), and the profile.
6. Main path 4, the kernel benchmark: ``kernels_bench.run()`` on the card
   (its attention rows through K4, its nHSIC rows through K1-K3 and, in
   ``nhsic_unfused``, K6 and K7; the only path that runs K6 and K7); the
   rows go to ``chiprun_out/bench_kernels.json``.

Each main path is driven with the launch counts set to 0 just before it
and read just after.  Prints the card's name and power limit, a JSON line
of per-kernel numbers (``max_rel_err`` beside ``max_abs_err``), and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.realpath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")
BENCH_OUT = os.path.join(ROOT, "chiprun_out", "bench_kernels.json")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# H100 SXM peak rates (dense): a matrix product in f32 is counted at the
# tensor cores' rate for fp32-accurate products, 3xTF32 (495 / 3 TFLOP/s),
# on bf16 inputs at the bf16 rate; all other arithmetic at the float32
# rate outside the tensor cores
F32_PRODUCT_FLOPS_PER_S = 495e12 / 3
BF16_PRODUCT_FLOPS_PER_S = 989e12
ELEMENTWISE_FLOPS_PER_S = 67e12
TOL = 1e-3
SEED = 0

# (B, Dx, Dz, linear_x): h_xz at the four ResNet18 stages, then h_yz;
# then the ViT-12's h_xz (every stage) and h_yz; then xlstm-1.3b's h_xz
# (every stage) and h_yz (256 label buckets)
MAIN_PATH_SHAPES = [(32, 3, 64, False), (32, 64, 128, False),
                    (32, 128, 256, False), (32, 256, 512, False),
                    (32, 10, 64, True), (32, 384, 384, False),
                    (32, 100, 64, True), (16, 2048, 2048, False),
                    (16, 256, 64, True)]
# off the tile: B in {48, 256}, D in {1, 512}; then identical rows
EXTRA_SHAPES = [(48, 1, 512, False), (48, 512, 1, True), (256, 1, 512, False),
                (256, 512, 1, True), (256, 512, 512, False)]
# the edges of K2's and K3's clusters (4 to 16 ranks, about 64 columns of
# the wider side a rank, each owning a slice of D in multiples of 4, at most
# 256 columns at once): D = 1 and D < C (trailing ranks own nothing), D off
# a multiple of 4 or of the slice, D = 4096 (16 slices of 256), D above
# 16 x 256 (slices taken in segments, 4100 also off a multiple of 4);
# B = 1, 16 (one entry of four computed), 33, 48 and 256 (more than one
# tile).  B = 1 with an RBF z of one column: a single row's mean-distance
# bandwidth clamps to 1e-8, and over more columns the plain version's own
# rounding then turns the diagonal of 1 into 0
CLUSTER_EDGE_SHAPES = [(1, 5, 1, True), (16, 4096, 100, False),
                       (33, 10, 4096, True), (48, 100, 33, True),
                       (256, 1, 4096, False), (33, 4100, 3, False),
                       (48, 8192, 64, False)]
DEGENERATE_SHAPES = [(32, 5, 8, False), (48, 10, 64, True)]
# identical rows, both sides RBF: K2 must give exactly 0 and K3 exactly 0
# gradients (not held against the plain versions, whose rounding makes a
# diagonal distance of identical rows other than 0)
IDENTICAL_SHAPES = [(32, 5, 8), (16, 2048, 2048), (33, 4100, 3),
                    (256, 64, 1), (1, 1, 7)]
TIMED_SHAPE = (32, 256, 512, False)   # the ResNet path's largest call
STREAMING = ("nhsic_rowsums", "nhsic_stats_feats", "nhsic_grad")   # K1-K3

# K6, each (B, D) as an RBF and as a linear Gram: the reference's audit
# shape (ops.AUDIT_CASES), its gram test's draws, ragged B (1, 33, 200) and
# D = 1; the main paths' widths are added from MAIN_PATH_SHAPES
GRAM_CASES = list(dict.fromkeys(
    [(256, 256), (8, 4), (16, 16), (32, 64), (48, 200), (1, 5), (33, 7),
     (200, 64), (64, 1)]
    + [(B, D) for B, Dx, Dz, _ in MAIN_PATH_SHAPES for D in (Dx, Dz)]))
# K7: batches of the Gram pairs (the x and z Grams of each, and the
# non-symmetric cross-Grams of two different sets of rows)
GRAM_STATS_BATCHES = [256, 32, 16, 48, 1, 33, 200]
# K6's tiling: B off the 32-row tile on both sides against D off its
# 16-column chunks and eight warp slices, at the fixed bandwidth
# sigma^2 = D (a single row's mean-distance bandwidth is 0, where the
# plain version's own rounding turns the diagonal of 1 into 0)
GRAM_TILING = [(B, D) for B in (1, 31, 33, 257) for D in (1, 7, 257, 2048)]
GRAM_TIMED = [(256, 256), TIMED_SHAPE[:2]]   # (B, D); K7 at the same B

# K4: (B, Sq, Skv, H, KV, D, causal, window, dtype).  The ViT-12 shape,
# the reference's AUDIT_CASES (kernels/flash_attention/ops.py), GQA with
# H=4, KV=2, causal with Sq != Skv, causal+window with empty rows
FLASH_VIT = (32, 64, 64, 6, 6, 64, False, 0, "float32")
FLASH_CASES = [FLASH_VIT,
               (2, 1024, 1024, 2, 2, 64, True, 0, "float32"),
               (2, 512, 512, 2, 2, 64, True, 0, "bfloat16"),
               (1, 200, 200, 2, 2, 64, True, 0, "float32"),
               (1, 512, 512, 1, 1, 32, False, 64, "float32"),
               (2, 256, 256, 4, 2, 64, True, 0, "float32"),
               (2, 70, 150, 4, 2, 64, True, 0, "float32"),
               (2, 150, 70, 4, 2, 64, True, 0, "float32"),
               (1, 41, 14, 2, 2, 16, True, 4, "float32"),
               (2, 130, 100, 4, 2, 128, True, 7, "float32")]
# K4's tiling: head dims off the MMA's k of 8 (1, 3, 20, 100), fewer
# query rows than one warp's 16, several 32-row kv tiles with a ragged tail
# under causal + window
FLASH_CASES += [(2, 70, 90, 4, 2, 1, True, 0, "float32"),
                (2, 70, 90, 4, 2, 3, False, 0, "float32"),
                (2, 70, 90, 4, 2, 20, True, 0, "float32"),
                (2, 70, 90, 4, 2, 100, False, 0, "float32"),
                (2, 5, 40, 2, 2, 64, False, 0, "float32"),
                (3, 9, 9, 2, 1, 32, True, 0, "float32"),
                (1, 1000, 1000, 2, 2, 64, True, 300, "float32")]
FLASH_GRAD_CASES = [FLASH_VIT, FLASH_CASES[5], FLASH_CASES[8]]
# timed: the ViT-12 shape and the kernel benchmark's two attention rows
# (kernels_bench.ATTN_SHAPES, causal f32)
FLASH_TIMED = [FLASH_VIT, (2, 256, 256, 8, 2, 64, True, 0, "float32"),
               (1, 1024, 1024, 8, 8, 64, True, 0, "float32")]
BF16_TOL = 2e-2

# K5 forward and backward: (B, S, H, Dh, random_state0, gate_scale).  The
# xlstm-1.3b shape, the reference's audit shapes (kernels/slstm_scan/ops.py),
# S=1, S=200 (ragged against the reference's 128-step blocks), head dims 1,
# 3 and 48, random non-zero initial states, gates up to |g| = 100, B = 64
# (four row chunks), H = 8 (256 blocks with r resident: past what the card
# holds at once, so r streams from L2) and Dh = 1024 at H = 16 (r's slice
# does not fit in shared memory; a block owns several column tiles)
SLSTM_MAIN = (16, 256, 4, 512, False, 1.0)
SLSTM_CASES = [SLSTM_MAIN,
               (2, 256, 2, 512, False, 1.0),
               (2, 128, 4, 64, False, 1.0),
               (2, 1, 4, 64, True, 1.0),
               (2, 200, 2, 64, False, 1.0),
               (3, 37, 3, 1, True, 1.0),
               (3, 37, 3, 3, True, 1.0),
               (2, 37, 2, 48, True, 1.0),
               (16, 256, 4, 512, True, 100.0),
               (64, 64, 4, 512, True, 1.0),
               (16, 64, 8, 512, True, 1.0),
               (2, 16, 16, 1024, True, 1.0)]
STATE = ("c", "n", "m", "h")

# main path sizes (a CPU rehearsal shrinks them)
RESNET = dict(arch="resnet18", num_classes=10, image_size=32, width_mult=1.0)
RESNET_IMAGES = 16000
VIT = dict(num_classes=100, image_size=64, num_layers=12, d_model=384)
VIT_IMAGES = 9600
TEST_IMAGES = 512
XLSTM = dict(use_slstm_kernel=True, dtype="float32")
# SGD at the FLConfig default lr 0.05 diverges on xlstm-1.3b at the
# reference's init, in the reference too (tests/test_torch_xlstm.py::
# test_full_width_step_is_sensitive_and_lr_0_05_diverges)
XLSTM_LR = 1e-4
LM_SEQS, LM_SEQ_LEN = 3200, 256
TEST_SEQS = 128


class SmokeError(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeError(what)


START = time.perf_counter()


def phase(name):
    """Print a phase's name with the seconds since the script started."""
    print(f"[{time.perf_counter() - START:.1f} s] {name}", flush=True)


def time_ms(torch, fn, runs=30, warmup=5):
    """Median of ``runs`` CUDA-event timings of one call each (the event
    pair also spans the host's launch gap, which bounds these calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --------------------------------------------------------------------------- #
# least time of each kernel: bytes each input read once and each output
# written once, FLOPs the function needs; bound = max of the two times
# --------------------------------------------------------------------------- #
def gram_flops(B, D, linear):
    """(products, elementwise) FLOPs of the Gram of (B, D) rows with
    themselves.  It is symmetric, so it needs B(B+1)/2 dot products of 2D
    FLOPs; RBF adds the B squared norms (2D each, products too) and
    |a|^2+|b|^2-2ab, clamp, scale and exp (6) per distinct entry."""
    dots = B * (B + 1) * D
    return (dots, 0) if linear else (dots + 2 * B * D, 3 * B * (B + 1))


def flash_work(B, Sq, Skv, H, KV, D, causal, window, dtype):
    """Bytes, product and elementwise FLOPs and the products' rate of one
    K4 call: q, k, v read once, o written once; QK^T and PV (2 D FLOPs
    each per allowed (query, key) pair), the softmax (max, subtract, exp,
    sum, rescale: 5 per pair) and q's scale.  Only the pairs the masks
    allow count."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    pairs = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(Skv - 1, i) if causal else Skv - 1
        pairs += max(0, hi - lo + 1)
    pairs *= B * H
    rate = (BF16_PRODUCT_FLOPS_PER_S if dtype == "bfloat16"
            else F32_PRODUCT_FLOPS_PER_S)
    return nbytes, 4 * pairs * D, 5 * pairs + B * Sq * H * D, rate


def slstm_work(B, S, H, Dh, *_):
    """One K5 call: g_in, r, b and the four initial states read once, hs
    and the four final states written once; the four recurrent products
    (2 Dh^2 FLOPs per gate, step, row and head), ~30 FLOPs of gate
    arithmetic per (step, row, head, column)."""
    nbytes = 4 * (B * S * 4 * H * Dh + 4 * H * Dh * Dh + 4 * H * Dh
                  + 4 * B * H * Dh + B * S * H * Dh + 4 * B * H * Dh)
    return (nbytes, 2 * B * S * H * 4 * Dh * Dh, 30 * B * S * H * Dh,
            F32_PRODUCT_FLOPS_PER_S)


def slstm_bwd_work(B, S, H, Dh, *_):
    """One K5 backward call: the saved g, c, n, m, the cotangent of hs, r,
    the initial c, n, m and the four final-state cotangents read once, dg
    and the four initial-state gradients written once; the recurrent
    products dh = dg r^T (2 Dh^2 FLOPs per gate, step, row and head), ~60
    FLOPs of gate arithmetic per (step, row, head, column).  dr and db are
    plain products outside the kernel."""
    step = B * S * H * Dh
    nbytes = 4 * (4 * step + 3 * step + step + 4 * H * Dh * Dh
                  + 7 * B * H * Dh + 4 * step + 4 * B * H * Dh)
    return (nbytes, 2 * step * 4 * Dh, 60 * step, F32_PRODUCT_FLOPS_PER_S)


def gram_work(B, D, linear):
    """One K6 call: x and sigma^2 read, the Gram written."""
    return (4 * B * D + 4 + 4 * B * B, *gram_flops(B, D, linear),
            F32_PRODUCT_FLOPS_PER_S)


def gram_stats_work(B):
    """One K7 call: two Grams and their row, column and total means read,
    three sums written; the means' reductions, the centring and three
    products per entry, all elementwise."""
    return 8 * B * B + 16 * B + 8 + 12, 0, 18 * B * B, F32_PRODUCT_FLOPS_PER_S


def nhsic_work(name, B, Dx, Dz, lx, lz=False):
    """One K1, K2 or K3 call."""
    (px, ex), (pz, ez) = gram_flops(B, Dx, lx), gram_flops(B, Dz, lz)
    prod, elem = px + pz, ex + ez
    act = 4 * B * (Dx + Dz)
    rate = F32_PRODUCT_FLOPS_PER_S
    if name == "nhsic_rowsums":
        return act + 8 + 8 * B, prod, elem + 2 * B * B, rate
    if name == "nhsic_stats_feats":
        # centring (3 per entry per Gram) and three products with sums
        return act + 8 * B + 16 + 12, prod, elem + 12 * B * B, rate
    # centring, G (3 each), W (2 each), the row-sum term; W.x a product
    return (act + 8 * B + 28 + act, prod + 2 * B * B * (Dx + Dz),
            elem + 16 * B * B + 4 * B * (Dx + Dz), rate)


WORK = {"flash_attention_fwd": flash_work, "slstm_scan_fwd": slstm_work,
        "slstm_scan_bwd": slstm_bwd_work, "gram": gram_work,
        "gram_stats": gram_stats_work}


def bound_ms(name, shape):
    """The least time of one call: the larger of its bytes over the memory
    rate and its arithmetic over the peak rates, products and elementwise
    work each at their own rate (they run on different units, so the
    larger of the two times is the least)."""
    nbytes, prod, elem, rate = (WORK[name](*shape) if name in WORK
                                else nhsic_work(name, *shape))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(prod / rate, elem / ELEMENTWISE_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
def inputs(torch, B, Dx, Dz, lx, degenerate=False):
    g = torch.Generator().manual_seed(B * 7919 + Dx * 31 + Dz)
    if lx:
        x = torch.eye(Dx)[torch.randint(0, Dx, (B,), generator=g)]
    else:
        x = torch.randn(B, Dx, generator=g)
    z = torch.randn(B, Dz, generator=g)
    if degenerate:
        x, z = x[:1].repeat(B, 1), z[:1].repeat(B, 1)
    return x.cuda(), z.cuda()


def kernel_args(torch, hsic, ref, x, z, lx):
    """Inputs of each kernel as the nHSIC forward/backward builds them."""
    B = x.shape[0]
    one = torch.ones((), device=x.device)
    s2 = torch.stack([one if lx else hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = ref.nhsic_rowsums(x, z, s2, linear_x=lx)
    rx, rz = rxs / B, rzs / B
    s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=x.device)])
    return {"nhsic_rowsums": ((x, z, s2), {"linear_x": lx}),
            "nhsic_stats_feats": ((x, z, rx, rz, s), {"linear_x": lx}),
            "nhsic_grad": ((x, z, rx, rz, scal), {"linear_x": lx})}


def track(errs, name, rel, ab):
    """Keep the largest (absolute, scale-relative) error of each kernel."""
    a, r = errs.get(name, (0.0, 0.0))
    errs[name] = (max(a, ab), max(r, rel))


def rel_abs(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    rel = ab = 0.0
    for a, b in zip(got, want):
        d = float((a - b).abs().max())
        ab = max(ab, d)
        rel = max(rel, d / max(float(b.abs().max()), 1e-6))
    return rel, ab


def rel_each(got, want):
    """Largest error of each element against its own plain value (K7's
    three sums differ by orders of magnitude, so each is held alone)."""
    d = (got - want).abs()
    return (float((d / want.abs().clamp_min(1e-6)).max()),
            float(d.max()))


def kernel_phase(torch, kernel, ops, ref, hsic):
    names = STREAMING
    errs = {}
    cases = ([(s, False) for s in MAIN_PATH_SHAPES + EXTRA_SHAPES
              + CLUSTER_EDGE_SHAPES]
             + [(s, True) for s in DEGENERATE_SHAPES])
    for (B, Dx, Dz, lx), degenerate in cases:
        x, z = inputs(torch, B, Dx, Dz, lx, degenerate)
        args = kernel_args(torch, hsic, ref, x, z, lx)
        line = []
        for n in names:
            a, kw = args[n]
            rel, ab = rel_abs(getattr(kernel, n)(*a, **kw),
                              getattr(ref, n)(*a, **kw))
            torch.cuda.synchronize()
            check(rel <= TOL, f"{n} at {(B, Dx, Dz, lx)}: rel err {rel}")
            track(errs, n, rel, ab)
            line.append(f"{n} {rel:.2e}")
        kx = "linear" if lx else "rbf"
        xa, za = x.clone().requires_grad_(), z.clone().requires_grad_()
        xb, zb = x.clone().requires_grad_(), z.clone().requires_grad_()
        v = ops.nhsic(xa, za, kernel_x=kx)
        v.backward()
        vb = hsic.nhsic(xb, zb, kernel_x=kx)
        vb.backward()
        v, vb = float(v.detach()), float(vb.detach())
        rel_v = abs(v - vb) / max(abs(vb), 1e-6)
        rel_g, _ = rel_abs((xa.grad, za.grad), (xb.grad, zb.grad))
        check(rel_v <= TOL and rel_g <= TOL,
              f"autograd nHSIC at {(B, Dx, Dz, lx)}: {rel_v}, {rel_g}")
        check(bool(torch.isfinite(xa.grad).all() & torch.isfinite(za.grad)
                   .all()), "non-finite nHSIC grad")
        tag = " degenerate" if degenerate else ""
        print(f"  check B={B} Dx={Dx} Dz={Dz} linear_x={lx}{tag}: "
              + ", ".join(line)
              + f", nhsic value {rel_v:.2e} grad {rel_g:.2e}", flush=True)
    for B, Dx, Dz in IDENTICAL_SHAPES:
        check(exactly_zero(torch, kernel, hsic,
                           *inputs(torch, B, Dx, Dz, False, True)),
              f"identical rows at {(B, Dx, Dz)}: K2 or K3 not exactly 0")
    print(f"  identical rows at {len(IDENTICAL_SHAPES)} shapes: K2 and K3 "
          f"exactly 0", flush=True)
    for shape in [(256, 64, 128, False), (32, 256, 512, False),
                  (16, 2048, 2048, False)]:
        args = kernel_args(torch, hsic, ref, *inputs(torch, *shape),
                           shape[3])
        for n in ("nhsic_stats_feats", "nhsic_grad"):
            a, kw = args[n]
            check(same_bits(torch, lambda: getattr(kernel, n)(*a, **kw)),
                  f"{n} at {shape}: bits differ between runs")
    print("  nhsic_stats_feats, nhsic_grad at B=256, 32, 16: the same bits "
          "over three runs", flush=True)
    return errs


def exactly_zero(torch, kernel, hsic, x, z):
    """Identical rows, both Grams RBF: K1 gives row sums of exactly B, so
    every centred entry is exactly 0; K2 must then give exactly 0 and K3
    exactly 0 gradients."""
    B = x.shape[0]
    s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = kernel.nhsic_rowsums(x, z, s2)
    s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
    stats = kernel.nhsic_stats_feats(x, z, rxs / B, rzs / B, s)
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=x.device)])
    gx, gz = kernel.nhsic_grad(x, z, rxs / B, rzs / B, scal)
    return bool((stats == 0).all() & (gx == 0).all() & (gz == 0).all())


# device kernel names of each streaming nHSIC wrapper (K2 adds its
# partials in a second launch where B > 32); each is a __global__ function
# of nhsic.cu and no substring of another kernel's name
# (tests/test_torch_profiler_names.py)
STREAMING_KERNELS = {"nhsic_rowsums": ("rowsums_kernel",),
                     "nhsic_stats_feats": ("nhsic_stats_kernel",
                                           "sum_partials_kernel"),
                     "nhsic_grad": ("nhsic_grad_kernel",)}


def timing_phase(torch, kernel, ref, hsic):
    """K1-K3 and their plain versions at the main paths' shapes: CUDA
    events and the profiler's device time of the kernels."""
    rows = []
    for shape in MAIN_PATH_SHAPES:
        B, Dx, Dz, lx = shape
        x, z = inputs(torch, B, Dx, Dz, lx)
        args = kernel_args(torch, hsic, ref, x, z, lx)
        for n in STREAMING:
            a, kw = args[n]
            fn = lambda: getattr(kernel, n)(*a, **kw)
            ms = time_ms(torch, fn)
            dev = device_ms(torch, fn, STREAMING_KERNELS[n])
            plain = time_ms(torch, lambda: getattr(ref, n)(*a, **kw))
            b_ms, b_by = bound_ms(n, (B, Dx, Dz, lx))
            rows.append({"name": n, "shape": [B, Dx, Dz, lx], "ms": ms,
                         "device_ms": dev, "plain_ms": plain,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"  time {n} B={B} Dx={Dx} Dz={Dz} linear_x={lx}: "
                  f"kernel {ms:.4f} ms (device {fmt_ms(dev)}), plain "
                  f"{plain:.4f} ms, bound {b_ms:.2e} ms ({b_by})",
                  flush=True)
    return rows


def gram_input(torch, B, D, seed=0):
    g = torch.Generator().manual_seed(B * 7919 + D * 31 + seed)
    return torch.randn(B, D, generator=g).cuda()


def cross_gram(torch, hsic, ref, a, b):
    """The non-symmetric RBF Gram K_ij = k(a_i, b_j): the off-diagonal
    block of the plain Gram of a and b stacked."""
    ab = torch.cat([a, b])
    return ref.gram(ab, hsic.rbf_sigma2(ab), False)[:len(a), len(a):] \
        .contiguous()


def gram_phase(torch, kernel, ops, ref, hsic):
    """K6 and K7 against their plain versions; ``nhsic_unfused`` against
    the fused op and plain nHSIC, with exactly 2 K6 and 1 K7 launches per
    call.  Returns each kernel's largest (absolute, scale-relative)
    error."""
    errs = {}
    cases = ([(B, D, False) for B, D in GRAM_CASES]
             + [(B, D, True) for B, D in GRAM_TILING])
    for B, D, fixed in cases:
        x = gram_input(torch, B, D)
        for linear in (False, True):
            s2 = (torch.ones((), device=x.device) if linear
                  else torch.full((), float(D), device=x.device) if fixed
                  else hsic.rbf_sigma2(x))
            got = kernel.gram(x, s2, linear=linear)
            rel, ab = rel_abs(got, ref.gram(x, s2, linear))
            torch.cuda.synchronize()
            check(rel <= TOL and tuple(got.shape) == (B, B),
                  f"gram at B={B} D={D} linear={linear}: rel err {rel}")
            check(torch.equal(got, got.T),
                  f"gram at B={B} D={D}: not exactly symmetric")
            check(linear or bool((got.diagonal() == 1).all()),
                  f"gram at B={B} D={D}: diagonal is not exactly 1")
            track(errs, "gram", rel, ab)
    for B, D in ((257, 7), (33, 2048), (64, 1)):
        x = gram_input(torch, 1, D).repeat(B, 1).contiguous()
        check(bool((kernel.gram(x, hsic.rbf_sigma2(x) + 1.0) == 1).all()),
              f"gram: {B} identical rows of width {D} are not exactly 1")
    x = gram_input(torch, 257, 257)
    for linear in (False, True):
        runs = [kernel.gram(x, hsic.rbf_sigma2(x), linear=linear)
                for _ in range(3)]
        check(all(torch.equal(r, runs[0]) for r in runs),
              "gram differs between runs")
    xb = gram_input(torch, 48, 200).bfloat16()
    check(torch.equal(kernel.gram(xb, 2.0), kernel.gram(xb.float(), 2.0)),
          "gram: bf16 input differs from its f32 upcast")
    for B in GRAM_STATS_BATCHES:
        x, z = gram_input(torch, B, 64, 1), gram_input(torch, B, 16, 2)
        y, w = gram_input(torch, B, 64, 3), gram_input(torch, B, 16, 4)
        pairs = [(kernel.gram(x, hsic.rbf_sigma2(x)),
                  kernel.gram(z, 1.0, linear=True)),
                 (cross_gram(torch, hsic, ref, x, y),
                  cross_gram(torch, hsic, ref, z, w))]
        for kx, kz in pairs:
            got = kernel.gram_stats(kx, kz)
            rel, ab = rel_each(got, ref.gram_stats(kx, kz))
            torch.cuda.synchronize()
            check(rel <= TOL, f"gram_stats at B={B}: rel err {rel}")
            track(errs, "gram_stats", rel, ab)
    kx, kz = pairs[0]
    first = kernel.gram_stats(kx, kz)
    check(all(torch.equal(first, kernel.gram_stats(kx, kz))
              for _ in range(3)), "gram_stats differs between runs")
    (ga, gr), (sa, sr) = errs["gram"], errs["gram_stats"]
    print(f"  check gram: {2 * len(cases)} Grams, exactly symmetric, "
          f"identical rows exactly 1, bit-identical over three runs, "
          f"rel err <= {gr:.2e}, "
          f"abs <= {ga:.2e}; gram_stats: {2 * len(GRAM_STATS_BATCHES)} "
          f"pairs, each sum's rel err <= {sr:.2e}, abs <= {sa:.2e}",
          flush=True)
    cases = ([(s, False) for s in MAIN_PATH_SHAPES + EXTRA_SHAPES]
             + [(s, True) for s in DEGENERATE_SHAPES])
    diff = 0.0
    for (B, Dx, Dz, lx), degenerate in cases:
        x, z = inputs(torch, B, Dx, Dz, lx, degenerate)
        kx = "linear" if lx else "rbf"
        kernel.reset_launches()
        v = float(ops.nhsic_unfused(x, z, kernel_x=kx))
        check(kernel.LAUNCHES["gram"] == 2
              and kernel.LAUNCHES["gram_stats"] == 1,
              f"nhsic_unfused at {(B, Dx, Dz, lx)}: launches "
              f"{kernel.LAUNCHES}, expected 2 gram and 1 gram_stats")
        fused = float(ops.nhsic(x, z, kernel_x=kx))
        plain = float(hsic.nhsic(x, z, kernel_x=kx))
        d = max(abs(v - fused), abs(v - plain))
        check(math.isfinite(v) and d <= 1e-4 and (v == 0 or not degenerate),
              f"nhsic_unfused at {(B, Dx, Dz, lx)}: {v}, fused {fused}, "
              f"plain {plain}")
        diff = max(diff, d)
    kernel.reset_launches()
    print(f"  check nhsic_unfused at {len(cases)} shapes: |unfused - fused|, "
          f"|unfused - plain| <= {diff:.2e}, 2 gram + 1 gram_stats launches "
          f"per call", flush=True)
    return errs


def device_ms(torch, fn, names=None, runs=30):
    """Mean device time per call of ``fn`` from ``torch.profiler``: of the
    device kernels whose names contain one of ``names``, or of all of them;
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ms = [v for k, v in device_kernel_ms(torch, prof, runs).items()
          if names is None or any(n in k for n in names)]
    return sum(ms) if ms else None


def device_kernel_ms(torch, prof, runs):
    """Device ms per run of each kernel name a profile recorded."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / runs)
    return by_name


def gram_timing(torch, kernel, ref, hsic):
    """K6 (RBF, and linear beside its ``x @ x.T`` yardstick) and K7, each
    with its plain version, at GRAM_TIMED.  No single PyTorch call computes
    the RBF Gram (``torch.cdist`` returns distances) or K7.  Beside the
    CUDA-event times (which span the host's launch gap) the profiler's
    device time of the kernels alone, and of ``x @ x.T``."""
    rows = []
    for B, D in GRAM_TIMED:
        x = gram_input(torch, B, D)
        s2 = hsic.rbf_sigma2(x)
        one = torch.ones((), device=x.device)
        for linear in (False, True):
            s = one if linear else s2
            ms = time_ms(torch, lambda: kernel.gram(x, s, linear=linear))
            plain = time_ms(torch, lambda: ref.gram(x, s, linear))
            lib = time_ms(torch, lambda: x @ x.T) if linear else None
            dev = device_ms(torch, lambda: kernel.gram(x, s, linear=linear),
                            ("gram_kernel",))
            lib_dev = (device_ms(torch, lambda: x @ x.T) if linear
                       else None)
            b_ms, b_by = bound_ms("gram", (B, D, linear))
            rows.append({"name": "gram", "linear": linear, "shape": [B, D],
                         "ms": ms, "plain_ms": plain, "library_ms": lib,
                         "device_ms": dev, "library_device_ms": lib_dev,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"  time gram B={B} D={D} linear={linear}: kernel "
                  f"{ms:.4f} ms (device {fmt_ms(dev)}, host share "
                  f"{host_share(ms, dev)}), plain {plain:.4f} ms"
                  + (f", x @ x.T {lib:.4f} ms (device {fmt_ms(lib_dev)}, "
                     f"host share {host_share(lib, lib_dev)})"
                     if linear else "")
                  + f", bound {b_ms:.2e} ms ({b_by})", flush=True)
        kx = kernel.gram(x, s2)
        kz = kernel.gram(gram_input(torch, B, 64, 1), 1.0, linear=True)
        ms = time_ms(torch, lambda: kernel.gram_stats(kx, kz))
        plain = time_ms(torch, lambda: ref.gram_stats(kx, kz))
        dev = device_ms(torch, lambda: kernel.gram_stats(kx, kz),
                        ("gram_stats_kernel", "sum_partials_kernel"))
        b_ms, b_by = bound_ms("gram_stats", (B,))
        rows.append({"name": "gram_stats", "shape": [B], "ms": ms,
                     "plain_ms": plain, "library_ms": None, "device_ms": dev,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"  time gram_stats B={B}: kernel {ms:.4f} ms (device {dev}, "
              f"both launches), plain {plain:.4f} ms, bound {b_ms:.2e} ms "
              f"({b_by})", flush=True)
    return rows


def bench_path(torch, kernels):
    """Main path 4: the port's kernel benchmark, ``kernels_bench.run()``,
    on the card.  Per ``timeit`` call (a warm-up and five timed) every
    nHSIC row runs ``nhsic_unfused`` (2 K6 + 1 K7), the fused forward (K1 +
    K2) and the fused gradient (K1 + K2 + K3), and once more the forward
    for its residual check; every attention row runs K4 once per call."""
    from repro_torch.benchmarks import kernels_bench
    calls = 1 + 5
    reset_all(kernels)
    rows = kernels_bench.run(quiet=False, out_path=BENCH_OUT)
    torch.cuda.synchronize()
    counts = read_all(kernels)
    rows_n = len(kernels_bench.NHSIC_SHAPES)
    n = rows_n * calls
    want = {"gram": 2 * n, "gram_stats": n, "nhsic_rowsums": 2 * n + rows_n,
            "nhsic_stats_feats": 2 * n + rows_n, "nhsic_grad": n,
            "flash_attention_fwd": len(kernels_bench.ATTN_SHAPES) * calls,
            "slstm_scan_fwd": 0, "slstm_scan_bwd": 0}
    check(counts == want, f"kernel benchmark launches {counts}, expected "
          f"{want}")
    print(f"  launches {counts}; rows written to "
          f"{os.path.relpath(BENCH_OUT, ROOT)}", flush=True)
    return rows, counts


def flash_inputs(torch, case):
    B, Sq, Skv, H, KV, D, _, _, dtype = case
    g = torch.Generator().manual_seed(Sq * 1009 + Skv * 7 + H)
    q, k, v = (torch.randn(s, generator=g) for s in
               [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)])
    dt = getattr(torch, dtype)
    return q.cuda().to(dt), k.cuda().to(dt), v.cuda().to(dt)


def flash_phase(torch, fkernel, fops, fref):
    """K4 against its plain version at every listed shape; rows with no
    allowed key must be exactly 0.  Then its autograd gradient against
    autograd of the plain version."""
    errs = {}
    for case in FLASH_CASES:
        causal, window, dtype = case[6], case[7], case[8]
        q, k, v = flash_inputs(torch, case)
        got = fkernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        want = fref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        rel, ab = rel_abs(got.float(), want.float())
        tol = BF16_TOL if dtype == "bfloat16" else TOL
        check(got.dtype == q.dtype and rel <= tol,
              f"flash_attention_fwd at {case}: rel err {rel}")
        mask = fref.attention_mask(case[1], case[2], causal, window, q.device)
        empty = ~mask.any(dim=1)
        check(bool((got[:, empty] == 0).all()),
              f"flash_attention_fwd at {case}: empty rows are not 0")
        track(errs, "flash_attention_fwd", rel, ab)
        print(f"  check flash {case}: rel err {rel:.2e}, empty rows "
              f"{int(empty.sum())}", flush=True)
    for case in FLASH_GRAD_CASES:
        causal, window = case[6], case[7]
        q, k, v = flash_inputs(torch, case)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
        g = g.cuda()
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fops.flash_attention(*a, causal=causal, window=window)
        out.backward(g)
        fref.attention_ref(*b, causal=causal, window=window).backward(g)
        rel_o, _ = rel_abs(out.detach(), fref.attention_ref(
            q, k, v, causal=causal, window=window))
        rel_g, _ = rel_abs([x.grad for x in a], [y.grad for y in b])
        check(rel_o <= TOL and rel_g <= TOL,
              f"autograd flash at {case}: {rel_o}, {rel_g}")
        check(all(bool(torch.isfinite(x.grad).all()) for x in a),
              "non-finite flash grad")
        print(f"  check flash autograd {case}: out {rel_o:.2e}, grads "
              f"{rel_g:.2e}", flush=True)
    for case in (FLASH_VIT, FLASH_CASES[-1]):
        q, k, v = flash_inputs(torch, case)
        runs = [fkernel.flash_attention_fwd(q, k, v, causal=case[6],
                                            window=case[7])
                for _ in range(3)]
        check(all(torch.equal(r, runs[0]) for r in runs),
              f"flash_attention_fwd at {case} differs between runs")
    print("  check flash: bit-identical over three runs", flush=True)
    return errs


def flash_timing(torch, fkernel, fref):
    """K4, its plain version and ``F.scaled_dot_product_attention`` (a
    yardstick, timed here only) at FLASH_TIMED: event times of one call,
    and the profiler's device time of K4 and of every kernel SDPA's call
    launches; their difference is the call's host share."""
    import torch.nn.functional as F
    rows = []
    for case in FLASH_TIMED:
        causal, window = case[6], case[7]
        q, k, v = flash_inputs(torch, case)
        ms = time_ms(torch, lambda: fkernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window))
        plain = time_ms(torch, lambda: fref.attention_ref(
            q, k, v, causal=causal, window=window))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=case[3] != case[4])
        lib = time_ms(torch, sdpa)
        dev = device_ms(torch, lambda: fkernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window), ("flash_fwd_kernel",))
        lib_dev = device_ms(torch, sdpa)
        b_ms, b_by = bound_ms("flash_attention_fwd", case)
        rows.append({"name": "flash_attention_fwd", "shape": list(case),
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "device_ms": dev, "library_device_ms": lib_dev,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"  time flash_attention_fwd {case}: kernel {ms:.4f} ms "
              f"(device {fmt_ms(dev)}, host share {host_share(ms, dev)}), "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms (device "
              f"{fmt_ms(lib_dev)}, host share {host_share(lib, lib_dev)}), "
              f"bound {b_ms:.2e} ms ({b_by})", flush=True)
    return rows


def fmt_ms(ms):
    return "not recorded" if ms is None else f"{ms:.4f} ms"


def host_share(event_ms, dev_ms):
    """Event time less device time of one call: the host's launch gap."""
    return ("not recorded" if dev_ms is None
            else f"{event_ms - dev_ms:.4f} ms")


def slstm_inputs(torch, case):
    B, S, H, Dh, random_state0, scale = case
    g = torch.Generator().manual_seed(B * 1000 + S * 10 + Dh)
    if scale > 1:
        g_in = (torch.rand((B, S, 4, H, Dh), generator=g) * 2 - 1) * scale
    else:
        g_in = torch.randn((B, S, 4, H, Dh), generator=g)
    r = torch.randn((4, H, Dh, Dh), generator=g) * (0.5 / math.sqrt(Dh))
    b = torch.randn((4, H, Dh), generator=g) * 0.1
    if random_state0:
        st = [torch.randn((B, H, Dh), generator=g),
              torch.randn((B, H, Dh), generator=g).abs() + 0.1,
              torch.randn((B, H, Dh), generator=g),
              torch.randn((B, H, Dh), generator=g) * 0.5]
    else:
        z = torch.zeros((B, H, Dh))
        st = [z, z, z - 30.0, z]
    return [t.cuda() for t in (g_in, r, b, *st)]


def slstm_cotangents(torch, inputs):
    """A cotangent of hs and of each final state, from a fixed seed."""
    gen = torch.Generator().manual_seed(1)
    B, S, _, H, Dh = inputs[0].shape
    return [torch.randn((B, S, H, Dh), generator=gen).cuda()] + [
        torch.randn((B, H, Dh), generator=gen).cuda() for _ in STATE]


def same_bits(torch, fn, runs=3):
    """Whether ``runs`` calls of ``fn`` give the same bits in every
    output."""
    outs = [fn() for _ in range(runs)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs[1:] for a, b in
               zip(o, outs[0]))


def slstm_phase(torch, skernel, sops, sref):
    """K5 at every listed shape.  The forward against its plain version:
    ``hs``, the four final states and the states it saves for the backward.
    The backward kernel, on the forward kernel's saved states and a
    cotangent of every output, against ``slstm_scan_bwd_ref`` on the same
    inputs.  Then the autograd op (forward and backward kernels, r's and
    b's gradients as products) against autograd of the plain version: the
    gradient to g_in, r, b and the initial state.  At the main shape both
    kernels must give the same bits over three runs."""
    errs = {}
    for case in SLSTM_CASES:
        inputs = slstm_inputs(torch, case)
        g_in, r, b, *st = inputs
        got = skernel.slstm_scan_fwd(*inputs, save=True)
        hs, fin, saved = sref.slstm_scan_ref(g_in, r, b, dict(zip(STATE, st)),
                                             save=True)
        torch.cuda.synchronize()
        want = [hs] + [fin[k] for k in STATE] + [saved[k] for k in "gcnm"]
        rel, ab = rel_abs(got, want)
        check(rel <= TOL and all(bool(torch.isfinite(a).all()) for a in got),
              f"slstm_scan_fwd at {case}: rel err {rel}")
        track(errs, "slstm_scan_fwd", rel, ab)

        cot = slstm_cotangents(torch, inputs)
        bwd_args = [*got[5:], r, *st[:3], *cot]
        dgot = skernel.slstm_scan_bwd(*bwd_args)
        dwant = sref.slstm_scan_bwd_ref(*bwd_args)
        torch.cuda.synchronize()
        rel_b, ab_b = rel_abs(dgot, dwant)
        check(rel_b <= TOL and all(bool(torch.isfinite(a).all())
                                   for a in dgot),
              f"slstm_scan_bwd at {case}: rel err {rel_b}")
        track(errs, "slstm_scan_bwd", rel_b, ab_b)

        a = [t.clone().requires_grad_() for t in inputs]
        p = [t.clone().requires_grad_() for t in inputs]
        hs_k, fin_k = sops.slstm_scan(*a[:3], dict(zip(STATE, a[3:])))
        torch.autograd.backward([hs_k] + [fin_k[k] for k in STATE], cot)
        hs_p, fin_p = sref.slstm_scan_ref(*p[:3], dict(zip(STATE, p[3:])))
        torch.autograd.backward([hs_p] + [fin_p[k] for k in STATE], cot)
        rel_g, _ = rel_abs([x.grad for x in a], [y.grad for y in p])
        check(rel_g <= TOL and all(bool(torch.isfinite(x.grad).all())
                                   for x in a),
              f"autograd slstm at {case}: grads rel err {rel_g}")
        print(f"  check slstm {case}: forward rel err {rel:.2e}, backward "
              f"kernel {rel_b:.2e}, autograd grads {rel_g:.2e}", flush=True)
        del a, p, hs_k, fin_k, hs_p, fin_p, got, saved, dgot, dwant
    inputs = slstm_inputs(torch, SLSTM_MAIN)
    fwd = lambda: skernel.slstm_scan_fwd(*inputs, save=True)
    saved = fwd()[5:]
    cot = slstm_cotangents(torch, inputs)
    check(same_bits(torch, fwd), "slstm_scan_fwd: bits differ between runs")
    check(same_bits(torch, lambda: skernel.slstm_scan_bwd(
        *saved, inputs[1], *inputs[3:6], *cot)),
        "slstm_scan_bwd: bits differ between runs")
    print(f"  slstm_scan_fwd, slstm_scan_bwd at {SLSTM_MAIN}: the same bits "
          f"over three runs", flush=True)
    return errs


def slstm_timing(torch, skernel, sops, sref):
    """K5's forward and backward at the xlstm-1.3b shape: CUDA events,
    the profiler's device time of the kernel, the plain version (for the
    backward: autograd of the plain loop, its backward pass alone) and the
    bound.  No single PyTorch call computes an sLSTM scan or its backward,
    so there is no library time."""
    inputs = slstm_inputs(torch, SLSTM_MAIN)
    g_in, r, b, *st = inputs
    saved = skernel.slstm_scan_fwd(*inputs, save=True)[5:]
    cot = slstm_cotangents(torch, inputs)
    leaves = [t.clone().requires_grad_() for t in inputs]
    hs, fin = sref.slstm_scan_ref(*leaves[:3], dict(zip(STATE, leaves[3:])))
    outs = [hs] + [fin[k] for k in STATE]
    calls = {
        "slstm_scan_fwd": (
            "slstm_fwd_kernel", lambda: skernel.slstm_scan_fwd(*inputs),
            lambda: sref.slstm_scan_ref(g_in, r, b, dict(zip(STATE, st)))),
        "slstm_scan_bwd": (
            "slstm_bwd_kernel",
            lambda: skernel.slstm_scan_bwd(*saved, r, *st[:3], *cot),
            lambda: torch.autograd.grad(outs, leaves, cot,
                                        retain_graph=True))}
    rows = []
    for name, (kname, fn, plain_fn) in calls.items():
        ms = time_ms(torch, fn)
        dev = device_ms(torch, fn, (kname,))
        plain = time_ms(torch, plain_fn, runs=5, warmup=1)
        b_ms, b_by = bound_ms(name, SLSTM_MAIN)
        print(f"  time {name} {SLSTM_MAIN}: kernel {ms:.4f} ms (device "
              f"{fmt_ms(dev)}), plain {plain:.4f} ms, bound {b_ms:.3f} ms "
              f"({b_by})", flush=True)
        rows.append({"name": name, "shape": list(SLSTM_MAIN), "ms": ms,
                     "device_ms": dev, "plain_ms": plain, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def reset_all(kernels):
    for k in kernels:
        k.reset_launches()


def read_all(kernels):
    return {n: c for k in kernels for n, c in k.LAUNCHES.items()}


def record_outcomes(server):
    """Keep each round's ``RoundOutcome`` (its true local step counts)."""
    outcomes = []
    run = server.runtime.run_round

    def recorded(*a, **kw):
        out = run(*a, **kw)
        outcomes.append(out)
        return out

    server.runtime.run_round = recorded
    return outcomes


def run_rounds(torch, server, kernels, n, quiet=False):
    """``n`` rounds; per round the seconds, peak allocated bytes, local
    steps and each kernel's launches."""
    outcomes = record_outcomes(server)
    rounds = []
    for r in range(n):
        before = read_all(kernels)
        done = len(outcomes)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rr = server.run_round(r)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = read_all(kernels)
        launches = {n_: after[n_] - before[n_] for n_ in after}
        steps = sum(sum(o.num_batches) for o in outcomes[done:])
        rounds.append(dict(vars(rr), seconds=sec, peak_bytes=peak,
                           launches=launches, local_steps=steps))
        if not quiet:
            print(f"  round {r}: {rr}", flush=True)
            print(f"    {sec:.3f} s, peak allocated {peak / 2**20:.1f} MiB, "
                  f"{steps} local steps, launches {launches}", flush=True)
    return rounds


def resnet_server(np, quiet=False):
    """Main path 1's server: full-width ResNet18 over a 100-device fleet,
    built from SEED."""
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer
    from repro_torch.models.cnn import CNNConfig

    ccfg = CNNConfig(name="resnet18", **RESNET)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=4, use_hsic_kernel=True,
                   runtime="sequential", seed=SEED)
    adapter = make_adapter(ccfg, flc.num_stages)
    size, classes = ccfg.image_size, ccfg.num_classes
    ds = make_image_dataset(SEED, RESNET_IMAGES, num_classes=classes,
                            image_size=size)
    parts = dirichlet_partition(SEED, ds.labels, flc.n_devices,
                                alpha=flc.alpha)
    test = Batcher(make_image_dataset(SEED + 1, TEST_IMAGES,
                                      num_classes=classes, image_size=size),
                   32, seed=SEED)
    server = NeuLiteServer(adapter, [ds.subset(p) for p in parts], flc,
                           test_batcher=test)
    steps = [b.steps_per_epoch for b in server.batchers]
    if not quiet:
        print(f"  clients: {len(steps)}, local steps per epoch: min "
              f"{min(steps)} median {int(np.median(steps))} max "
              f"{max(steps)}", flush=True)
    return server


def main_path(torch, kernels, np):
    """Main path 1: four rounds of full-width ResNet18, one per stage, with
    an evaluation each round."""
    server = resnet_server(np)
    reset_all(kernels)
    rounds = run_rounds(torch, server, kernels,
                        server.adapter.plan.num_stages)
    counts = read_all(kernels)

    hsic = {n: counts[n] for n in STREAMING}
    n_steps = sum(r["local_steps"] for r in rounds)
    check(all(c > 0 for c in hsic.values()), f"a kernel never ran: {hsic}")
    check(set(hsic.values()) == {2 * n_steps},
          f"expected 2 launches of each nHSIC kernel per step "
          f"({n_steps} steps): {hsic}")
    check(counts["flash_attention_fwd"] == 0, "flash attention in a CNN")
    check(counts["slstm_scan_fwd"] == counts["slstm_scan_bwd"] == 0,
          "an sLSTM scan in a CNN")
    check(counts["gram"] == 0 and counts["gram_stats"] == 0,
          f"a dense-Gram kernel on the ResNet path: {counts}")
    check(any(r["n_feasible"] > 0 for r in rounds), "no feasible round")
    check(all(math.isfinite(r["mean_loss"]) for r in rounds
              if r["n_selected"] > 0), "non-finite round loss")
    check(all(bool(torch.isfinite(p).all()) for p in
              _leaves(server.params)), "non-finite params")
    acc = rounds[-1]["test_acc"]
    check(acc is not None and 0.0 <= acc <= 1.0, f"bad accuracy {acc}")
    return server, rounds, counts


def _same_run(torch, rounds_a, params_a, rounds_b, params_b):
    """Whether two runs gave the same bits: round losses (by repr, which
    round-trips a float and equals itself for NaN) and params."""
    return ([repr(r["mean_loss"]) for r in rounds_a]
            == [repr(r["mean_loss"]) for r in rounds_b]
            and all(torch.equal(a, b) for a, b in zip(_leaves(params_a),
                                                      _leaves(params_b))))


def determinism_phase(torch, kernels, np, rounds, params):
    """Main path 1's four rounds again from the same seed: the port as it
    is (a server on a CUDA device makes cuDNN deterministic) must repeat
    the first run bit for bit, round losses and params.  Then, for the
    record, twice with ``cudnn.deterministic`` back at PyTorch's default
    (what the port did before): their s/round, whether they repeat each
    other, and once more under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the ops on this path that PyTorch names as having
    no deterministic implementation."""
    import warnings

    def run(default_cudnn):
        server = resnet_server(np, quiet=True)
        if default_cudnn:
            torch.backends.cudnn.deterministic = False
        reset_all(kernels)
        out = run_rounds(torch, server, kernels,
                         server.adapter.plan.num_stages, quiet=True)
        return out, server.params

    again, again_params = run(False)
    repeats = _same_run(torch, rounds, params, again, again_params)
    losses = [r["mean_loss"] for r in again]
    print(f"  the port again from seed {SEED}: round losses {losses} and "
          f"params {'identical' if repeats else 'DIFFER'}", flush=True)
    check(repeats, "main path 1 does not repeat itself bit for bit")
    base = [run(True) for _ in range(2)]
    base_repeats = _same_run(torch, base[0][0], base[0][1], base[1][0],
                             base[1][1])
    convs = conv_repeats(torch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = True
    flagged = sorted({str(w.message).split("\n")[0][:200] for w in caught
                      if "determinis" in str(w.message)})

    def per_round(rr):
        return [r["seconds"] for r in rr]

    out = {"repeats": repeats, "seconds": per_round(rounds),
           "again_seconds": per_round(again),
           "default_cudnn_seconds": [per_round(b[0]) for b in base],
           "default_cudnn_losses": [[r["mean_loss"] for r in b[0]]
                                    for b in base],
           "default_cudnn_repeats": base_repeats,
           "conv_repeats": convs, "flagged_ops": flagged}
    print(f"  s/round, deterministic cuDNN: {per_round(rounds)}, "
          f"{per_round(again)}; PyTorch's default cuDNN: "
          f"{out['default_cudnn_seconds']} (losses "
          f"{out['default_cudnn_losses']}, "
          f"{'identical' if base_repeats else 'differ'})", flush=True)
    print(f"  ops without a deterministic implementation: {flagged or 'none'}",
          flush=True)
    print(f"  cuDNN conv passes that repeat their bits over three calls "
          f"(PyTorch's default / deterministic): {convs}", flush=True)
    return out


# ResNet18's 3x3 convs at 32x32 inputs: (channels, side) of each stage
RESNET_CONVS = [(64, 32), (128, 16), (256, 8), (512, 4)]


def conv_repeats(torch):
    """Which passes of a 3x3 conv (batch 32, ResNet18's channels and
    sides) give the same bits over three calls, with PyTorch's default
    cuDNN and with ``cudnn.deterministic``: forward, input gradient,
    weight gradient."""
    import torch.nn.functional as F
    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        for ch, side in RESNET_CONVS:
            g = torch.Generator().manual_seed(ch)
            x = torch.randn((32, ch, side, side), generator=g).cuda()
            w = (torch.randn((ch, ch, 3, 3), generator=g) * 0.05).cuda()
            cot = torch.randn((32, ch, side, side), generator=g).cuda()
            x.requires_grad_()
            w.requires_grad_()
            runs = []
            for _ in range(3):
                y = F.conv2d(x, w, padding=1)
                runs.append((y, *torch.autograd.grad(y, [x, w], cot)))
            same = [all(torch.equal(r[i], runs[0][i]) for r in runs[1:])
                    for i in range(3)]
            key = f"{'deterministic' if det else 'default'} {ch}x{side}"
            out[key] = dict(zip(("forward", "input_grad", "weight_grad"),
                                same))
    torch.backends.cudnn.deterministic = True
    return out


# the kernel that runs once per layer of a kind, in every forward
LAYER_KERNELS = {"attn": "flash_attention_fwd", "slstm": "slstm_scan_fwd"}
# the kernel that runs once per trainable layer of a kind, in every backward
BACKWARD_KERNELS = {"slstm": "slstm_scan_bwd"}


def transformer_rounds(torch, kernels, np, server, test_batcher, t0):
    """One round per stage on ``server``, then an evaluation on
    ``test_batcher``.  Each per-layer kernel must launch once per layer of
    its kind run per local step (the frozen prefix included: a stage runs
    periods [0, end of its active block)) and once per such layer per
    evaluation batch, K1-K3 twice per local step."""
    adapter, cfg = server.adapter, server.adapter.cfg
    steps = [b.steps_per_epoch for b in server.batchers]
    print(f"  data, params and server {time.perf_counter() - t0:.2f} s; "
          f"clients: {len(steps)}, local steps per epoch: min {min(steps)} "
          f"median {int(np.median(steps))} max {max(steps)}; plan "
          f"{adapter.plan.bounds}", flush=True)
    per_period = {name: sum(1 for k, _ in cfg.pattern if k == kind)
                  for kind, name in LAYER_KERNELS.items()}
    per_period_bwd = {name: sum(1 for k, _ in cfg.pattern if k == kind)
                      for kind, name in BACKWARD_KERNELS.items()}

    reset_all(kernels)
    rounds = run_rounds(torch, server, kernels, adapter.plan.num_stages)
    server.test_batcher = test_batcher
    before = read_all(kernels)
    acc = server.evaluate()
    counts = read_all(kernels)
    eval_launches = {n: counts[n] - before[n]
                     for n in [*per_period, *per_period_bwd]}

    for r in rounds:
        periods = adapter.plan.stage_ranges(r["stage"])[2][1]
        r["layer_launches_per_step"] = {n: periods * k
                                        for n, k in per_period.items()}
        n = r["local_steps"]
        check(r["n_selected"] > 0 and n > 0, f"round {r['round_idx']} "
              f"trained no client")
        # the backward runs through the trainable periods only: the
        # boundary unit and the active block (the frozen prefix runs
        # without grad)
        _, (b0, b1), (a0, a1) = adapter.plan.stage_ranges(r["stage"])
        r["layer_launches_per_step"].update(
            {n_: (b1 - b0 + a1 - a0) * k for n_, k in per_period_bwd.items()})
        for name, per_step in r["layer_launches_per_step"].items():
            check(r["launches"][name] == n * per_step,
                  f"round {r['round_idx']}: {r['launches']}, expected {n} "
                  f"steps x {per_step} launches of {name}")
        check(all(r["launches"][k] == 2 * n for k in STREAMING),
              f"round {r['round_idx']}: expected 2 nHSIC launches per step")
    check(counts["gram"] == 0 and counts["gram_stats"] == 0,
          f"a dense-Gram kernel on a transformer path: {counts}")
    n_eval = min(8, test_batcher.steps_per_epoch)
    for name, k in per_period.items():
        check(eval_launches[name] == n_eval * cfg.num_periods * k,
              f"evaluation: {eval_launches}, expected {n_eval} batches x "
              f"{cfg.num_periods * k} launches of {name}")
    check(all(eval_launches[n] == 0 for n in per_period_bwd),
          f"a backward kernel in evaluation: {eval_launches}")
    check(all(math.isfinite(r["mean_loss"]) for r in rounds),
          "non-finite round loss")
    check(all(bool(torch.isfinite(p).all()) for p in
              _leaves(server.params)), "non-finite params")
    check(0.0 <= acc <= 1.0, f"bad accuracy {acc}")
    print(f"  evaluation: accuracy {acc:.4f}, launches {eval_launches}",
          flush=True)
    return rounds, counts, acc


def vit_main_path(torch, kernels, np):
    """Main path 2: three rounds of full-width ViT-12, one per stage,
    attention through K4, then an evaluation."""
    from repro_torch.configs.paper_models import vit
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = dataclasses.replace(vit(**VIT), use_flash_kernel=True)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=3, use_hsic_kernel=True,
                   runtime="sequential", seed=SEED)
    t0 = time.perf_counter()
    ds = make_image_dataset(SEED, VIT_IMAGES, num_classes=cfg.vocab_size,
                            image_size=cfg.image_size)
    parts = dirichlet_partition(SEED, ds.labels, flc.n_devices,
                                alpha=flc.alpha)
    server = NeuLiteServer(make_adapter(cfg, flc.num_stages),
                           [ds.subset(p) for p in parts], flc)
    test = Batcher(make_image_dataset(SEED + 1, TEST_IMAGES,
                                      num_classes=cfg.vocab_size,
                                      image_size=cfg.image_size), 32,
                   seed=SEED)
    return (server, *transformer_rounds(torch, kernels, np, server, test,
                                        t0))


def xlstm_main_path(torch, kernels, np):
    """Main path 3: three rounds of full-width xlstm-1.3b on synthetic
    text, one per stage, the sLSTM scan through K5, then an evaluation."""
    from repro_torch.configs import xlstm_1_3b
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = dataclasses.replace(xlstm_1_3b.config(), **XLSTM)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=16, lr=XLSTM_LR, num_stages=3,
                   use_hsic_kernel=True, runtime="sequential", seed=SEED)
    t0 = time.perf_counter()
    ds = make_lm_dataset(SEED, LM_SEQS, LM_SEQ_LEN, cfg.vocab_size)
    parts = dirichlet_partition(SEED, ds.topics, flc.n_devices,
                                alpha=flc.alpha)
    server = NeuLiteServer(make_adapter(cfg, flc.num_stages),
                           [ds.subset(p) for p in parts], flc,
                           data_kind="lm")
    torch.cuda.synchronize()
    test = Batcher(make_lm_dataset(SEED + 1, TEST_SEQS, LM_SEQ_LEN,
                                   cfg.vocab_size), flc.batch_size,
                   seed=SEED, kind="lm")
    return (server, *transformer_rounds(torch, kernels, np, server, test,
                                        t0))


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def _step(torch, adapter, server, t, params, batch, use_kernel):
    from repro_torch.core.progressive import make_stage_step
    from repro_torch.optim.optimizers import sgd
    frozen, trainable = adapter.split_stage(params, t)
    opt = sgd(server.flc.lr)
    hp = dataclasses.replace(server.hp, use_hsic_kernel=use_kernel)
    step = make_stage_step(adapter, opt, hp, t)
    _, new, m = step(opt.init(trainable), trainable, frozen, batch,
                     trainable)
    return new, m


def _step_diff(a, b):
    """(loss rel, params rel) of step a against step b: params relative
    to the largest trained param."""
    (an, am), (bn, bm) = a, b
    loss_rel = abs(float(am["loss"] - bm["loss"])) / max(
        abs(float(bm["loss"])), 1e-6)
    scale = max(float(p.abs().max()) for p in _leaves(bn) if p.numel())
    params_rel = max(float((x - y).abs().max())
                     for x, y in zip(_leaves(an), _leaves(bn))
                     if x.numel()) / scale
    return loss_rel, params_rel


def step_check(torch, server, plain_adapter=None, sensitivity=False):
    """One full-width step per stage: the kernel path (``server.adapter``,
    nHSIC through K1-K3) against the plain path (``plain_adapter``, plain
    nHSIC), same params and batch.

    With ``sensitivity`` the plain path also runs from params scaled by
    1 + 1e-7, which measures how far f32 rounding alone moves the step at
    these params.  Where that exceeds TOL / 10 (a model whose near one-hot
    attention amplifies rounding from period to period, see
    tests/test_torch_vit.py::test_full_width_vit12_is_chaotic_at_init), the
    bar is 10 times it; otherwise it is TOL."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_map
    plain_adapter = plain_adapter or server.adapter
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    out = []
    for t in range(server.adapter.plan.num_stages):
        kern = _step(torch, server.adapter, server, t, server.params, batch,
                     True)
        plain = _step(torch, plain_adapter, server, t, server.params, batch,
                      False)
        loss_rel, params_rel = _step_diff(kern, plain)
        row = {"stage": t, "loss": float(kern[1]["loss"]),
               "plain_loss": float(plain[1]["loss"]), "loss_rel": loss_rel,
               "params_rel": params_rel,
               "nhsic_xz": float(kern[1]["nhsic_xz"]),
               "nhsic_yz": float(kern[1]["nhsic_yz"])}
        bar_loss = bar_params = TOL
        if sensitivity:
            eps = tree_map(lambda p: p * (1 + 1e-7), server.params)
            moved = _step(torch, plain_adapter, server, t, eps, batch, False)
            s_loss, s_params = _step_diff(moved, plain)
            bar_loss = max(TOL, 10 * s_loss) if s_loss > TOL / 10 else TOL
            bar_params = (max(TOL, 10 * s_params) if s_params > TOL / 10
                          else TOL)
            row.update(plain_eps_loss_rel=s_loss,
                       plain_eps_params_rel=s_params, bar_loss=bar_loss,
                       bar_params=bar_params)
        check(loss_rel <= bar_loss and params_rel <= bar_params,
              f"stage {t} kernel vs plain step: {row}")
        out.append(row)
        extra = (f"; plain vs plain at params x (1 + 1e-7): loss rel "
                 f"{row['plain_eps_loss_rel']:.2e}, params rel "
                 f"{row['plain_eps_params_rel']:.2e}; bars {bar_loss:.1e}, "
                 f"{bar_params:.1e}" if sensitivity else "")
        print(f"  stage {t} step, kernel vs plain path: loss "
              f"{row['loss']:.6f} vs {row['plain_loss']:.6f} (rel "
              f"{loss_rel:.2e}), params rel {params_rel:.2e}{extra}",
              flush=True)
    return out


def period_check(torch, server, plain_adapter):
    """Each period of the full-width transformer alone, fed the same input
    (the plain path's output of the period before): attention through K4
    against the plain path, output and the gradient to the period's params
    and input for one cotangent, at TOL.  Unlike a whole step, this is
    well posed where the model amplifies rounding from period to period."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import model as tx
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    layers = server.params["model"]["layers"]
    with torch.no_grad():
        x, pos, _ = tx.embed_inputs(server.params["model"], plain_adapter.cfg,
                                    batch["inputs"])
    gen = torch.Generator().manual_seed(2)
    out = []
    for i in range(tx.num_stacked(layers)):
        cot = torch.randn(x.shape, generator=gen).to(x.device)
        res = []
        for cfg in (server.adapter.cfg, plain_adapter.cfg):
            lp = tree_map(lambda a, i=i: a[i:i + 1].detach()
                          .requires_grad_(True), layers)
            xi = x.detach().requires_grad_(True)
            y = tx._run_periods(lp, cfg, xi, pos)
            grads = torch.autograd.grad(y, [xi] + tree_leaves(lp), cot)
            res.append((y.detach(), list(grads)))
        (yk, gk), (yp, gp) = res
        rel_y, _ = rel_abs(yk, yp)
        rel_g, _ = rel_abs(gk, gp)
        check(rel_y <= TOL and rel_g <= TOL,
              f"period {i}: kernel vs plain path {rel_y}, {rel_g}")
        out.append({"period": i, "out_rel": rel_y, "grad_rel": rel_g})
        x = yp
    print(f"  {len(out)} periods, kernel vs plain path: output rel <= "
          f"{max(r['out_rel'] for r in out):.2e}, grads rel <= "
          f"{max(r['grad_rel'] for r in out):.2e}", flush=True)
    return out


def slstm_layer_check(torch, server, plain_adapter):
    """Each sLSTM sub-layer of the full-width xLSTM alone, fed the same
    input (the plain path's residual stream before it): the scan through
    K5 against the plain per-step loop, output and the gradient to the
    sub-layer's params and input for one cotangent, at TOL."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import model as tx
    cfg_k, cfg_p = server.adapter.cfg, plain_adapter.cfg
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    layers = server.params["model"]["layers"]
    with torch.no_grad():
        x, pos, _ = tx.embed_inputs(server.params["model"], cfg_p,
                                    batch["inputs"])
    gen = torch.Generator().manual_seed(3)
    out = []
    for i in range(tx.num_stacked(layers)):
        period = tree_map(lambda a, i=i: a[i], layers)
        for j, (kind, ffn) in enumerate(cfg_p.pattern):
            sub = period[f"sub{j}"]
            if kind == "slstm":
                cot = torch.randn(x.shape, generator=gen).to(x.device)
                res = []
                for cfg in (cfg_k, cfg_p):
                    sp = tree_map(lambda a: a.detach().requires_grad_(True),
                                  sub)
                    xi = x.detach().requires_grad_(True)
                    y = tx.sublayer_apply(sp, cfg, kind, ffn, xi, pos)
                    grads = torch.autograd.grad(y, [xi] + tree_leaves(sp),
                                                cot)
                    res.append((y.detach(), list(grads)))
                (yk, gk), (yp, gp) = res
                rel_y, _ = rel_abs(yk, yp)
                rel_g, _ = rel_abs(gk, gp)
                check(rel_y <= TOL and rel_g <= TOL,
                      f"sLSTM layer of period {i}: kernel vs plain path "
                      f"{rel_y}, {rel_g}")
                out.append({"period": i, "out_rel": rel_y,
                            "grad_rel": rel_g})
            with torch.no_grad():
                x = tx.sublayer_apply(sub, cfg_p, kind, ffn, x, pos)
    print(f"  {len(out)} sLSTM layers, kernel vs plain path: output rel <= "
          f"{max(r['out_rel'] for r in out):.2e}, grads rel <= "
          f"{max(r['grad_rel'] for r in out):.2e}", flush=True)
    return out


# device kernel names of the hand-written kernels, for the profile
KERNEL_NAMES = {"nhsic": ("rowsums_kernel", "nhsic_stats_kernel",
                          "sum_partials_kernel", "nhsic_grad_kernel"),
                "flash": ("flash_fwd_kernel",),
                "slstm": ("slstm_fwd_kernel", "slstm_bwd_kernel")}


def step_profile(torch, server, steps=5):
    """Where a full-width local step's time goes: ``torch.profiler`` over
    ``steps`` steps of each stage (after two warm-up steps).  Device busy
    time is the sum of the card's kernel and copy times; the rest of the
    host-clock wall time the card sits idle.  Only CUDA activity is
    traced (each row says so): tracing the CPU too lengthens the wall time,
    so rows that traced other activities do not compare with these."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.device import to_device
    from repro_torch.core.progressive import make_stage_step
    from repro_torch.optim.optimizers import sgd
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    out = []
    for t in range(server.adapter.plan.num_stages):
        frozen, trainable = server.adapter.split_stage(server.params, t)
        opt = sgd(server.flc.lr)
        step = make_stage_step(server.adapter, opt, server.hp, t)
        state = opt.init(trainable)
        for _ in range(2):
            state, trainable, _ = step(state, trainable, frozen, batch,
                                       trainable)
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, trainable, _ = step(state, trainable, frozen, batch,
                                           trainable)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name = device_kernel_ms(torch, prof, steps)
        busy = sum(by_name.values())
        ours = {fam: sum(v for k, v in by_name.items()
                         if any(n in k for n in names))
                for fam, names in KERNEL_NAMES.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row = {"stage": t, "traced": [a.name for a in activities],
               "wall_ms_per_step": wall_ms,
               "device_busy_ms_per_step": busy if by_name else None,
               "nhsic_kernels_ms_per_step": ours["nhsic"] if by_name else None,
               "flash_kernel_ms_per_step": ours["flash"] if by_name else None,
               "slstm_kernel_ms_per_step": ours["slstm"] if by_name else None,
               "idle_share": 1.0 - busy / wall_ms if by_name else None,
               "device_kernels_per_step": sum(
                   1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
               "top": [[k[:90], v] for k, v in top]}
        out.append(row)
        if by_name:
            print(f"  stage {t}: {wall_ms:.2f} ms/step wall, device busy "
                  f"{busy:.2f} ms (nHSIC kernels {ours['nhsic']:.3f} ms, "
                  f"flash kernel {ours['flash']:.3f} ms, sLSTM scan kernel "
                  f"{ours['slstm']:.3f} ms), idle "
                  f"{row['idle_share']:.1%}, "
                  f"{row['device_kernels_per_step']:.0f} device ops/step",
                  flush=True)
        else:
            print(f"  stage {t}: {wall_ms:.2f} ms/step wall; the profiler "
                  f"recorded no device time", flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.benchmarks.common import smi_line
    from repro_torch.core import hsic
    from repro_torch.core.progressive import make_adapter
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.hsic_gram import kernel, ops, ref
    from repro_torch.kernels.slstm_scan import kernel as skernel
    from repro_torch.kernels.slstm_scan import ops as sops
    from repro_torch.kernels.slstm_scan import ref as sref
    kernels = (kernel, fkernel, skernel)

    smi = smi_line()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    t0 = time.perf_counter()
    build_libraries([k.SOURCE for k in kernels])
    for k in kernels:
        k.library()
    build_s = time.perf_counter() - t0
    built = ", ".join(os.path.relpath(k.SOURCE, ROOT) for k in kernels)
    print(f"built {built} in {build_s:.2f} s", flush=True)

    phase("kernel phase")
    errs = kernel_phase(torch, kernel, ops, ref, hsic)
    errs.update(flash_phase(torch, fkernel, fops, fref))
    errs.update(slstm_phase(torch, skernel, sops, sref))
    errs.update(gram_phase(torch, kernel, ops, ref, hsic))
    timing = timing_phase(torch, kernel, ref, hsic)
    timing += flash_timing(torch, fkernel, fref)
    timing += slstm_timing(torch, skernel, sops, sref)
    timing += gram_timing(torch, kernel, ref, hsic)

    phase("main path 1: ResNet18")
    server, rounds, counts = main_path(torch, kernels, np)
    phase("determinism of main path 1")
    determinism = determinism_phase(torch, kernels, np, rounds,
                                    server.params)
    phase("step check")
    steps = step_check(torch, server)
    phase("step profile")
    profiles = step_profile(torch, server)
    del server

    phase("main path 2: ViT-12")
    vserver, vrounds, vcounts, vacc = vit_main_path(torch, kernels, np)
    phase("step check")
    plain = make_adapter(dataclasses.replace(vserver.adapter.cfg,
                                             use_flash_kernel=False),
                         vserver.adapter.plan.num_stages)
    vsteps = step_check(torch, vserver, plain, sensitivity=True)
    phase("period check")
    vperiods = period_check(torch, vserver, plain)
    phase("step profile")
    vprofiles = step_profile(torch, vserver)
    del vserver

    phase("main path 3: xlstm-1.3b")
    xserver, xrounds, xcounts, xacc = xlstm_main_path(torch, kernels, np)
    phase("step check")
    plain = make_adapter(dataclasses.replace(xserver.adapter.cfg,
                                             use_slstm_kernel=False),
                         xserver.adapter.plan.num_stages)
    xsteps = step_check(torch, xserver, plain, sensitivity=True)
    phase("sLSTM layer check")
    xlayers = slstm_layer_check(torch, xserver, plain)
    phase("step profile")
    xprofiles = step_profile(torch, xserver, steps=2)
    del xserver

    phase("main path 4: kernel benchmark")
    bench_rows, bcounts = bench_path(torch, kernels)

    by_path = {"resnet18": counts, "vit12": vcounts, "xlstm": xcounts,
               "kernels_bench": bcounts}
    launches = {n: sum(c[n] for c in by_path.values()) for n in xcounts}
    sources = {n: os.path.relpath(k.SOURCE, ROOT) for k in kernels
               for n in k.LAUNCHES}
    replaces = {"nhsic_rowsums":
                "src/repro/kernels/hsic_gram/kernel.py:232",
                "nhsic_stats_feats":
                "src/repro/kernels/hsic_gram/kernel.py:304",
                "nhsic_grad": "src/repro/kernels/hsic_gram/kernel.py:403",
                "flash_attention_fwd":
                "src/repro/kernels/flash_attention/kernel.py:127",
                "slstm_scan_fwd":
                "src/repro/kernels/slstm_scan/kernel.py:109",
                "slstm_scan_bwd": "src/repro/kernels/slstm_scan/ops.py:28",
                "gram": "src/repro/kernels/hsic_gram/kernel.py:70",
                "gram_stats": "src/repro/kernels/hsic_gram/kernel.py:139"}
    timed = {n: next(r for r in timing if r["name"] == n
                     and tuple(r["shape"]) == TIMED_SHAPE)
             for n in STREAMING}
    timed["flash_attention_fwd"] = next(
        r for r in timing if r["name"] == "flash_attention_fwd"
        and tuple(r["shape"]) == FLASH_VIT)
    for n in ("slstm_scan_fwd", "slstm_scan_bwd"):
        timed[n] = next(r for r in timing if r["name"] == n)
    # K6's entry is the linear Gram, which has a library yardstick
    # (x @ x.T), at the audit shape; its RBF row rides along
    gram_rows = [r for r in timing if r["name"] in ("gram", "gram_stats")
                 and r["shape"][0] == GRAM_TIMED[0][0]]
    timed["gram"] = dict(next(r for r in gram_rows if r.get("linear")),
                         rbf=next(r for r in gram_rows
                                  if r.get("linear") is False))
    timed["gram_stats"] = next(r for r in gram_rows
                               if r["name"] == "gram_stats")
    out_kernels = []
    for n, row in timed.items():
        out_kernels.append({
            "name": n, "route": "cuda", "source": sources[n],
            "replaces": replaces[n], "launches": launches[n],
            "max_abs_err": errs[n][0], "max_rel_err": errs[n][1],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"), "shape": row["shape"],
            "launches_by_path": {p: c[n] for p, c in by_path.items()}})
        if "rbf" in row:
            out_kernels[-1].update(linear=True, rbf={
                k: row["rbf"][k] for k in ("ms", "plain_ms", "device_ms",
                                           "bound_ms", "bound_by")})
        for key in ("device_ms", "library_device_ms"):
            if key in row:
                out_kernels[-1][key] = row[key]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"smi": smi, "torch": torch.__version__,
                   "build_seconds": build_s, "timing": timing,
                   "rounds": rounds, "launches": counts,
                   "determinism": determinism, "step_check": steps,
                   "step_profile": profiles,
                   "vit": {"rounds": vrounds, "launches": vcounts,
                           "test_acc": vacc, "step_check": vsteps,
                           "period_check": vperiods,
                           "step_profile": vprofiles},
                   "xlstm": {"rounds": xrounds, "launches": xcounts,
                             "test_acc": xacc, "step_check": xsteps,
                             "slstm_layer_check": xlayers,
                             "step_profile": xprofiles},
                   "kernels_bench": {"rows": bench_rows,
                                     "launches": bcounts},
                   "kernels": out_kernels, "device": device}, f, indent=1)
    phase("done")
    print(smi, flush=True)
    print(json.dumps({"kernels": out_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
