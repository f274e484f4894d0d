#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels (``kernels/hsic_gram/csrc/nhsic.cu``, K1-K3,
   K6 and K7, ``kernels/flash_attention/csrc/flash_attention.cu``, K4, and
   ``kernels/slstm_scan/csrc/slstm_scan.cu``, K5) with ``nvcc``, one
   compiler per source, all started together; prints the build time.
2. Kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card, with TF32 off.  K1-K3 (forward, and the autograd backward of
   nHSIC) at the main paths' shapes and those of the Fig. 6 CNNs at
   batch 128 (from their block plans), at batches/widths off the 32-row
   tile and at the edges of K1's, K2's and K3's thread-block clusters (D
   below the cluster size, off a multiple of 4, 4096 and above; B from 1
   to 256), identical rows (K1's row sums then exactly B, K2 and K3's
   gradients exactly 0), and K1's, K2's and K3's bits over three runs;
   K4 at the ViT-12 shape, the reference's audit shapes (bf16, ragged
   S=200, windowed), GQA, causal with Sq != Skv, causal+window with empty
   rows (exactly 0), its tiling (head dims 1, 3, 20, 100; Sq=5 and 9;
   Skv=1000 with a window of 300), the same bits over three runs, and its
   autograd gradient; K5 (``hs`` and the four
   final states) at the xlstm-1.3b shape, the reference's audit shapes,
   S=1, ragged S=200, head dims 1, 3 and 48, random initial states and
   gates up to |g| = 100, and its autograd gradient.  Bar: scale-relative
   1e-3 in f32, 2e-2 in bf16.  K6 (the dense RBF and linear Gram) and K7
   (centred statistics of two dense Grams) at the reference's audit shape
   (B=256, D=256), its gram test's draws, the main paths' widths, ragged B
   (1, 33, 200), D=1, K6's tiling (B in {1, 31, 33, 257} x D in {1, 7,
   257, 2048}), non-symmetric Gram pairs, near-constant Grams (1 +- 1e-3),
   K7 past one cluster's bands (B = 512, 513, 1000) and a batch of
   identical rows; every K6 Gram exactly symmetric, identical rows exactly
   1, the same bits over three runs, one device op per K7 call;
   ``nhsic_unfused`` (K6 twice, then K7, counted per call) against the
   fused op and plain nHSIC at abs 1e-4.  Times each kernel, its plain
   version and, for K4, ``F.scaled_dot_product_attention`` and, for the
   linear K6, ``x @ x.T`` as yardsticks (CUDA events, median of 30
   calls); for K4 (at the ViT-12 shape and the kernel benchmark's two
   attention shapes), K6 and K7 also the profiler's device time of the
   kernel (for K7, of every device op of its wrapper) and of the
   yardstick, and the host share of each call (event time less device
   time).  Bounds count matrix products at the tensor cores' rate (3xTF32
   for f32, bf16 for bf16) and all other arithmetic at the float32 rate.
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
   (``slstm_layer_check``), and the profile.  Its rounds each start from
   an emptied cache; then the same server's rounds with eager steps
   (``f2_phase``): each default (captured) round must reserve at most 1.1x
   what the eager round of its stage reserves, with the same loss to the
   bit.
6. Main path 4, the kernel benchmark: ``kernels_bench.run()`` on the card
   (its attention rows through K4, its nHSIC rows through K1-K3 and, in
   ``nhsic_unfused``, K6 and K7; the only path that runs K6 and K7); the
   rows go to ``chiprun_out/bench_kernels.json``.
7. Main path 5: the paper's VGG11 and SqueezeNet at full width, each as
   main path 1 runs ResNet18 (32x32x3, 10 classes, batch 32, 4 stages,
   nHSIC through K1-K3, the same fleet and data): four rounds, one per
   stage, then an evaluation; K1-K3 twice per local step; then the step
   check per stage (with the plain path's own sensitivity) and the
   profile.
8. Main path 6: rounds through ``FLConfig(runtime="vectorized")`` (every
   cohort in one ``torch.func.vmap``ped step) of ResNet18, ViT-12 and a
   24-layer xLSTM at the smoke config's width and at xlstm-1.3b's, each
   held against the sequential round on the same stack (``TOL`` of the
   largest update, or 10x the sequential round's own movement under a
   1e-7 change where that exceeds TOL / 10), each round's first step
   alone, the captured cohort step against the eager one to the bit, and
   the rounds again from the seed to the bit; K1-K3 launch twice per
   vectorized step, K5 once per frozen sLSTM layer (its cohorts folded
   into the rows) and once per cohort group per trainable one.  The
   batched phase holds K1-K3, K4 and K5 (forward and backward, r per
   cohort and shared) under vmap against per-cohort launches to the bit.
   Then round throughput at the reference's sizes
   (``benchmarks/fl_round_throughput.py``).
9. Main path 7: the paper's Tables 1 and 2 at full width
   (``benchmarks/table1_accuracy.py``, ``table2_complexity.py``): NeuLite
   (nHSIC through K1-K3, captured steps) and the nine baselines (FedAvg,
   ExclusiveFL, AllSmall, DepthFL, HeteroFL, FedRolex, TiFL, Oort,
   ProgFed; cross-entropy alone, eager steps) on ResNet18, VGG11 and
   SqueezeNet at 32x32x3, 10 classes, over the reference's fleet (20
   clients, 5 a round, E = 1, B = 32, 4 stages), two rounds a method;
   then ResNet18 and ResNet34, ResNet34 on ResNet18's device budgets.
   K1-K3 launch twice per NeuLite local step and never in a baseline
   round; every loss and accuracy is finite; ResNet18's ten methods run
   again from the seed and repeat params and accuracies bit for bit; each
   distinct baseline step (the full model, AllSmall's width, each HeteroFL
   ratio, each DepthFL level, ProgFed's stage 0) runs once on the card
   against the same step on the CPU (1e-4, or 10x the CPU step's own
   movement under a 1e-7 change); HeteroFL's and FedRolex's
   scatter-average on the card against a numpy float64 ``np.add.at`` copy
   of the reference's at 1e-6; ResNet34 keeps NeuLite's participation
   above 0.  Rows to ``chiprun_out/table1.json`` and ``table2.json``.
10. The Fig. 7 phase: ``benchmarks/fig7_time.py``'s ``run`` on ResNet18
   and VGG11 at the reference's size (width 0.5, 16x16, B = 32) and at
   full width (32x32): each stage step against the full step, eager and
   captured, CUDA events, median of 5 after a warm-up; the speedups are
   printed beside the paper's 1.84-2.31x (no gate).  Rows to
   ``chiprun_out/fig7_time.json``.
11. The Fig. 6 phase, last, after every server is freed: the paper's peak-memory
   claim measured by ``benchmarks/fig6_memory.py``'s ``run``
   (``analysis.memory.measure_local_training``: the allocator's peak over
   two local steps on the same two batches, each from an empty cache with
   nothing else on the card, TF32 off), every stage against the
   full-model step.  ResNet18/34, VGG11 and SqueezeNet at the paper's
   batch of 128, 4 stages; ViT-12 at batch 32, 3 stages, K4 on;
   xlstm-1.3b at batch 16, seq 256, 3 stages, K5 on (an out-of-memory
   error fails the run).  Each peak is printed beside the analytic
   estimate (``core.memory``); every stage must peak below its full step,
   else the run fails.  The table goes to ``chiprun_out/fig6_memory.json``.
   Every shape nHSIC takes there must be one the kernel phase held.  Then
   the step check of the four CNNs at batch 128, one step per stage.

12. Main path 8, after main path 1: kill and resume.  Main path 1's
   ResNet18 (full width, 4 of 100 clients, K1-K3) runs 4 rounds with
   ``checkpoint_every=2`` in a child process (this script with
   ``--resume-child DIR``: the kernels the parent built, loaded, not
   built again), which SIGKILLs itself as round 2 opens; this process
   restores the round-2 checkpoint (``NeuLiteServer.restore``) and runs
   rounds 2-3, and runs the 4 rounds straight.  The resumed params,
   history, server RNG, batcher RNGs and selector state must equal the
   straight run's to the bit, the child's checkpoint the straight run's
   round-2 one (arrays and sidecar), the last checkpoint read on the CPU
   the bits of ``to_reference`` of the card's params; K1-K3 launch twice
   per local step of the resumed rounds.  Prints the checkpoint's bytes
   and the seconds of ``save_state`` and ``restore``; everything lands in
   a temporary directory, removed at the end.
13. The Fig. 2 phase (``benchmarks/fig2_hsic_plane.py``): E2E, naive PT
   and NeuLite-CA on ResNet18 at the reference's size (width 0.25, 16x16)
   and at full width (32x32), 60 steps; K1-K3 twice a NeuLite-CA step,
   never in the other two; each trace's first and last point and whether
   the paper's ordering holds (printed, not a gate).
14. The Fig. 5 phase (``benchmarks/fig5_scale_vit.py``): 5a, ResNet18 at
   full width on 62 classes at scales 24 and 48, 2 rounds (K1-K3 twice a
   local step); 5b, ViT-12's widths (d_model 384, 12 layers in 3 blocks)
   at 32x32 and 32 classes, C = 4 on the vectorized runtime, 2 rounds
   (K1-K3 twice a vectorized step; K4 once a layer run per vectorized
   step and per evaluation batch).
15. The Fig. 8 phase (``benchmarks/fig8_ablation.py``): NeuLite, w/o CA,
   w/o PC and FedAvg on ResNet18 at full width, 4 rounds (one a stage):
   K1-K3 twice a local step in NeuLite and w/o PC, never in the other two.
16. The quickstart (``examples/quickstart.py``) at its own size: the
   progressive loop's 64 steps and the two runtimes' rounds; K1-K3 twice
   a step (a vectorized step's cohorts in one launch), K4 once a layer
   run.  Every nHSIC and K4 shape the phases 13-16 take must be one the
   kernel phase held (``nhsic_shapes``, ``FLASH_CASES``).

Each main path is driven with the launch counts set to 0 just before it
and read just after.  Prints the card's name and power limit, a JSON line
of per-kernel numbers (``max_rel_err`` beside ``max_abs_err``), and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.realpath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")
BENCH_OUT = os.path.join(ROOT, "chiprun_out", "bench_kernels.json")
FIG6_OUT = os.path.join(ROOT, "chiprun_out", "fig6_memory.json")
BENCH_FL_OUT = os.path.join(ROOT, "chiprun_out", "bench_fl_round.json")
TABLE1_OUT = os.path.join(ROOT, "chiprun_out", "table1.json")
TABLE1_REPEAT_OUT = os.path.join(ROOT, "chiprun_out", "table1_repeat.json")
TABLE2_OUT = os.path.join(ROOT, "chiprun_out", "table2.json")
FIG7_OUT = os.path.join(ROOT, "chiprun_out", "fig7_time.json")
# Fig. 7 at the reference's size and at full width: (width, image size)
FIG7_SIZES = ((0.5, 16), (1.0, 32))
FIG7_ARCHS, FIG7_BATCH = ("resnet18", "vgg11"), 32

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
# (every stage) and h_yz (256 label buckets); then the h_xz of VGG11's
# stages and of SqueezeNet's not above (their h_yz is ResNet18's)
MAIN_PATH_SHAPES = [(32, 3, 64, False), (32, 64, 128, False),
                    (32, 128, 256, False), (32, 256, 512, False),
                    (32, 10, 64, True), (32, 384, 384, False),
                    (32, 100, 64, True), (16, 2048, 2048, False),
                    (16, 256, 64, True), (32, 3, 128, False),
                    (32, 64, 256, False), (32, 512, 512, False),
                    (32, 256, 384, False), (32, 384, 512, False)]
# off the tile: B in {48, 256}, D in {1, 512}; then identical rows
EXTRA_SHAPES = [(48, 1, 512, False), (48, 512, 1, True), (256, 1, 512, False),
                (256, 512, 1, True), (256, 512, 512, False)]
# the edges of K1's, K2's and K3's clusters (4 to 16 ranks, about 64 columns of
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
# identical rows, both sides RBF: K1 must give row sums of exactly B, K2
# exactly 0 and K3 exactly 0 gradients (not held against the plain
# versions, whose rounding makes a diagonal distance of identical rows
# other than 0)
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
# K7: batches of the Gram pairs (the x and z Grams of each, the
# non-symmetric cross-Grams of two different sets of rows, and two
# near-constant Grams); 512 is the last B whose bands K7 keeps in shared
# memory, one a rank; above it a rank takes several bands in turn
GRAM_STATS_BATCHES = [256, 32, 16, 48, 1, 33, 200, 512, 513, 1000]
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
FLASH_WINDOWED = FLASH_CASES[-1]      # held to its bits over three runs
# the figures' and the quickstart's shapes, as nHSIC's phases take them
# (under vmap per cohort) and, with 4 cohorts folded into B, as K4 then
# launches: the quickstart's causal GQA (B 8, S 64, H 4 over KV 2, D 32),
# Fig. 5b's ViT at ViT-12's widths (D 64) and at the reference's (D 16),
# 16 patches, batches of 32 and evaluations of 128
FLASH_CASES += [(8, 64, 64, 4, 2, 32, True, 0, "float32"),
                (32, 64, 64, 4, 2, 32, True, 0, "float32"),
                (32, 16, 16, 6, 6, 64, False, 0, "float32"),
                (128, 16, 16, 6, 6, 64, False, 0, "float32"),
                (32, 16, 16, 6, 6, 16, False, 0, "float32"),
                (128, 16, 16, 6, 6, 16, False, 0, "float32")]
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

# the paper's figures on the card: Fig. 2 at the reference's size and at
# full width, 60 steps; Fig. 5a at full width, 62 classes, two scales; 5b
# at ViT-12's published widths on 32x32 (16 patches), C = 4; Fig. 8 at
# full width, one round a stage
FIG2_SIZES = ((0.25, 16), (1.0, 32))
FIG2_STEPS = 60
FIG5_SIZE = dict(width=1.0, image_size=32)
FIG5_SCALES, FIG5_ROUNDS = (24, 48), 2
FIG5_VIT = dict(image_size=32, d_model=384, num_layers=12)
FIG8_SIZE = dict(width=1.0, image_size=32)
FIG8_ROUNDS = 4
# main path 8: main path 1's server killed after its second round
RESUME_ROUNDS, RESUME_EVERY = 4, 2

# main path sizes (a CPU rehearsal shrinks them)
RESNET = dict(arch="resnet18", num_classes=10, image_size=32, width_mult=1.0)
# main path 5: the paper's other two CNNs, as main path 1 runs ResNet18
ZOO = [dict(RESNET, arch="vgg11"), dict(RESNET, arch="squeezenet")]
RESNET_IMAGES = 16000
VIT = dict(num_classes=100, image_size=64, num_layers=12, d_model=384)
VIT_IMAGES = 9600
TEST_IMAGES = 512
XLSTM = dict(use_slstm_kernel=True, dtype="float32")
# SGD at the FLConfig default lr 0.05 diverges on xlstm-1.3b at the
# reference's init, in the reference too (tests/test_torch_xlstm.py::
# test_full_width_step_is_sensitive_and_lr_0_05_diverges)
XLSTM_LR = 1e-4
LM_SEQ_LEN = 256
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
    """One K7 call: two Grams read, three sums written; per entry of each
    Gram its row and column sums (2), its centring (3), and the three
    products with their sums (6 in all), all elementwise."""
    return 8 * B * B + 12, 0, 16 * B * B, F32_PRODUCT_FLOPS_PER_S


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
    cases = ([(s, False) for s in nhsic_shapes() + EXTRA_SHAPES
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
              f"identical rows at {(B, Dx, Dz)}: K1 not exactly B or K2 "
              f"or K3 not exactly 0")
    print(f"  identical rows at {len(IDENTICAL_SHAPES)} shapes: K1 exactly "
          f"B, K2 and K3 exactly 0", flush=True)
    for shape in [(256, 64, 128, False), (32, 256, 512, False),
                  (16, 2048, 2048, False)]:
        args = kernel_args(torch, hsic, ref, *inputs(torch, *shape),
                           shape[3])
        for n in STREAMING:
            a, kw = args[n]
            check(same_bits(torch, lambda: getattr(kernel, n)(*a, **kw)),
                  f"{n} at {shape}: bits differ between runs")
    print("  nhsic_rowsums, nhsic_stats_feats, nhsic_grad at B=256, 32, 16: "
          "the same bits over three runs", flush=True)
    return errs


def exactly_zero(torch, kernel, hsic, x, z):
    """Identical rows, both Grams RBF: K1 must give row sums of exactly B,
    so that every centred entry is exactly 0; K2 must then give exactly 0
    and K3 exactly 0 gradients."""
    B = x.shape[0]
    s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = kernel.nhsic_rowsums(x, z, s2)
    if not bool((rxs == B).all() & (rzs == B).all()):
        return False
    s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
    stats = kernel.nhsic_stats_feats(x, z, rxs / B, rzs / B, s)
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=x.device)])
    gx, gz = kernel.nhsic_grad(x, z, rxs / B, rzs / B, scal)
    return bool((stats == 0).all() & (gx == 0).all() & (gz == 0).all())


# device kernel names of each streaming nHSIC wrapper (K2 adds its
# partials in a second launch where B > 32) and of each dense-Gram
# wrapper; each is a __global__ function of nhsic.cu and no substring of
# another kernel's name (tests/test_torch_profiler_names.py)
STREAMING_KERNELS = {"nhsic_rowsums": ("nhsic_rowsums_kernel",),
                     "nhsic_stats_feats": ("nhsic_stats_kernel",
                                           "sum_partials_kernel"),
                     "nhsic_grad": ("nhsic_grad_kernel",)}
GRAM_KERNELS = {"gram": ("gram_kernel",), "gram_stats": ("gram_stats_kernel",)}


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


def near_constant_grams(torch, B):
    """Two non-symmetric (B, B) Grams with every entry in 1 +- 1e-3, where
    centring cancels all but the last three digits.  They share half their
    variation, so their trace term is about half their norms: between two
    independent ones it is a sum that cancels to f32 rounding noise, the
    plain version's too, and no relative bar holds for it."""
    g = torch.Generator().manual_seed(B)
    u, v = (2 * torch.rand((B, B), generator=g) - 1 for _ in range(2))
    return (1 + 1e-3 * u).cuda(), (1 + 1e-3 * (u + v) / 2).cuda()


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
                  cross_gram(torch, hsic, ref, z, w)),
                 near_constant_grams(torch, B)]
        for kx, kz in pairs:
            got = kernel.gram_stats(kx, kz)
            rel, ab = rel_each(got, ref.gram_stats(kx, kz))
            torch.cuda.synchronize()
            check(rel <= TOL, f"gram_stats at B={B}: rel err {rel}")
            track(errs, "gram_stats", rel, ab)
        if B in (256, 1000):   # bands kept in shared memory, and not
            kx, kz = pairs[0]
            check(same_bits(torch, lambda: (kernel.gram_stats(kx, kz),)),
                  f"gram_stats at B={B} differs between runs")
    (ga, gr), (sa, sr) = errs["gram"], errs["gram_stats"]
    print(f"  check gram: {2 * len(cases)} Grams, exactly symmetric, "
          f"identical rows exactly 1, bit-identical over three runs, "
          f"rel err <= {gr:.2e}, "
          f"abs <= {ga:.2e}; gram_stats: {3 * len(GRAM_STATS_BATCHES)} "
          f"pairs, each sum's rel err <= {sr:.2e}, abs <= {sa:.2e}, "
          f"bit-identical over three runs at B=256 and 1000",
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


def device_ops(torch, fn, runs=10, tries=3):
    """(device ops per call of ``fn``, the set of their names) from
    ``torch.profiler``, or None when it records no device activity.  The
    profiler now and then drops device events (PERF.md, section 7); every
    call here launches at least one op, so a profile with fewer events
    than calls lost some, and is taken again, at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= runs:
            break
    return (len(names) / runs, set(names)) if names else None


def device_kernel_ms(torch, prof, runs):
    """Device ms per run of each kernel name a profile recorded."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / runs)
    return by_name


def device_busy_ms(torch, prof, runs):
    """Device ms per run during which at least one device op ran: the
    union of their intervals.  A replayed CUDA graph runs independent
    nodes at once, so the sum of the ops' times (``device_kernel_ms``) can
    exceed the wall time; the union cannot."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3 / runs


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
                            GRAM_KERNELS["gram"])
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
        # every device op of the wrapper call: K7 alone
        ops = device_ops(torch, lambda: kernel.gram_stats(kx, kz))
        check(ops is None or (ops[0] == 1 and all(
            any(n in k for n in GRAM_KERNELS["gram_stats"]) for k in ops[1])),
            f"gram_stats at B={B}: device ops {ops}, expected one "
            f"{GRAM_KERNELS['gram_stats']} a call")
        dev = device_ms(torch, lambda: kernel.gram_stats(kx, kz))
        b_ms, b_by = bound_ms("gram_stats", (B,))
        rows.append({"name": "gram_stats", "shape": [B], "ms": ms,
                     "plain_ms": plain, "library_ms": None, "device_ms": dev,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"  time gram_stats B={B}: kernel {ms:.4f} ms (device "
              f"{fmt_ms(dev)}, every device op of the call, host share "
              f"{host_share(ms, dev)}), plain {plain:.4f} ms, bound "
              f"{b_ms:.2e} ms ({b_by})", flush=True)
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
    for case in (FLASH_VIT, FLASH_WINDOWED):
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


def record_steps(server):
    """Keep each round's true local step count (from its
    ``RoundOutcome``; not the outcome, which holds the round's params)."""
    steps = []
    run = server.runtime.run_round

    def recorded(*a, **kw):
        out = run(*a, **kw)
        steps.append(sum(out.num_batches))
        return out

    server.runtime.run_round = recorded
    return steps


def record_eval_peaks(torch, server):
    """Split a round's peak at the server's evaluation: keep the
    allocator's peak up to it (local training and aggregation) and its
    peak during it.  The round has already read its losses, so the
    synchronize adds no host sync."""
    peaks = []
    evaluate = server.evaluate

    def measured(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out = evaluate(*a, **kw)
        torch.cuda.synchronize()
        peaks.append((before, torch.cuda.max_memory_allocated(), reserved))
        return out

    server.evaluate = measured
    return peaks


def run_rounds(torch, server, kernels, n, quiet=False, fresh=False):
    """``n`` rounds; per round the seconds, peak allocated bytes (and,
    where the round evaluates, the peak before and during the evaluation),
    local steps and each kernel's launches.  With ``fresh`` each round
    starts from an emptied cache, so that its reserved peak is its own."""
    step_counts = record_steps(server)
    eval_peaks = record_eval_peaks(torch, server)
    rounds = []
    for r in range(n):
        before = read_all(kernels)
        done, evals = len(step_counts), len(eval_peaks)
        if fresh:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rr = server.run_round(r)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # a captured step's memory pool is reserved, not allocated, between
        # its replays: the reserved peak shows what the graphs hold
        reserved = torch.cuda.max_memory_reserved()
        split = {}
        if len(eval_peaks) > evals:
            train, during, train_reserved = eval_peaks[-1]
            peak = max(train, peak)
            reserved = max(train_reserved, reserved)
            split = dict(train_peak_bytes=train, eval_peak_bytes=during)
        after = read_all(kernels)
        launches = {n_: after[n_] - before[n_] for n_ in after}
        steps = sum(step_counts[done:])
        rounds.append(dict(vars(rr), seconds=sec, peak_bytes=peak,
                           peak_reserved_bytes=reserved, **split,
                           launches=launches, local_steps=steps))
        if not quiet:
            where = (f" (before the evaluation "
                     f"{split['train_peak_bytes'] / 2**20:.1f}, during it "
                     f"{split['eval_peak_bytes'] / 2**20:.1f})"
                     if split else "")
            print(f"  round {r}: {rr}", flush=True)
            print(f"    {sec:.3f} s, peak allocated {peak / 2**20:.1f} MiB"
                  f"{where}, reserved {reserved / 2**20:.1f} MiB, {steps} "
                  f"local steps, launches {launches}",
                  flush=True)
    # the wrappers close over the server: drop them, so that no reference
    # cycle keeps its tensors on the card once the caller lets it go
    del server.runtime.run_round, server.evaluate
    return rounds


def cnn_setup(spec=RESNET, runtime="sequential", **flc_kw):
    """The constructor arguments of main path 1's server (adapter, client
    datasets, FLConfig, test batcher): a full-width CNN over a 100-device
    fleet, built from SEED; ``flc_kw`` adds FLConfig fields."""
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig
    from repro_torch.models.cnn import CNNConfig

    ccfg = CNNConfig(name=spec["arch"], **spec)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=4, use_hsic_kernel=True,
                   runtime=runtime, seed=SEED, **flc_kw)
    adapter = make_adapter(ccfg, flc.num_stages)
    size, classes = ccfg.image_size, ccfg.num_classes
    ds = make_image_dataset(SEED, RESNET_IMAGES, num_classes=classes,
                            image_size=size)
    parts = dirichlet_partition(SEED, ds.labels, flc.n_devices,
                                alpha=flc.alpha)
    test = Batcher(make_image_dataset(SEED + 1, TEST_IMAGES,
                                      num_classes=classes, image_size=size),
                   32, seed=SEED)
    return adapter, [ds.subset(p) for p in parts], flc, test


def cnn_server(np, spec=RESNET, quiet=False, runtime="sequential",
               **flc_kw):
    """Main path 1's server (main path 5's with another ``spec``, main path
    6's with ``runtime="vectorized"``, main path 8's with checkpointing in
    ``flc_kw``)."""
    from repro_torch.federated.server import NeuLiteServer
    adapter, clients, flc, test = cnn_setup(spec, runtime, **flc_kw)
    server = NeuLiteServer(adapter, clients, flc, test_batcher=test)
    steps = [b.steps_per_epoch for b in server.batchers]
    if not quiet:
        print(f"  clients: {len(steps)}, local steps per epoch: min "
              f"{min(steps)} median {int(np.median(steps))} max "
              f"{max(steps)}", flush=True)
    return server


def main_path(torch, kernels, np, spec=RESNET):
    """Main path 1: four rounds of full-width ResNet18, one per stage, with
    an evaluation each round (main path 5: VGG11 or SqueezeNet, ``spec``)."""
    server = cnn_server(np, spec)
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
          f"a dense-Gram kernel on a CNN path: {counts}")
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
        server = cnn_server(np, quiet=True)
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


def transformer_rounds(torch, kernels, np, server, test_batcher, t0,
                       fresh=False):
    """One round per stage on ``server`` (``fresh``: each from an emptied
    cache), then an evaluation on ``test_batcher``.  Each per-layer kernel
    must launch once per layer of its kind run per local step (the frozen
    prefix included: a stage runs periods [0, end of its active block))
    and once per such layer per evaluation batch, K1-K3 twice per local
    step."""
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
    rounds = run_rounds(torch, server, kernels, adapter.plan.num_stages,
                        fresh=fresh)
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


def vit_server(runtime="sequential"):
    """Main path 2's server (main path 6's with ``runtime="vectorized"``)
    and its test batcher: full-width ViT-12 over a 100-device fleet, built
    from SEED."""
    from repro_torch.configs.paper_models import vit
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = dataclasses.replace(vit(**VIT), use_flash_kernel=True)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=3, use_hsic_kernel=True,
                   runtime=runtime, seed=SEED)
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
    return server, test


def vit_main_path(torch, kernels, np):
    """Main path 2: three rounds of full-width ViT-12, one per stage,
    attention through K4, then an evaluation."""
    t0 = time.perf_counter()
    server, test = vit_server()
    return (server, *transformer_rounds(torch, kernels, np, server, test,
                                        t0))


def xlstm_server(capture=True, params=None):
    """Main path 3's server: full-width xlstm-1.3b over a 100-device
    fleet on synthetic text, built from SEED (``benchmarks/round_memory.py``
    builds it); ``capture=False`` keeps its steps eager, ``params`` stand
    for the init from SEED."""
    from repro_torch.benchmarks.round_memory import xlstm_server as build
    return build(capture, params=params)


def xlstm_main_path(torch, kernels, np):
    """Main path 3: three rounds of full-width xlstm-1.3b on synthetic
    text, one per stage, the sLSTM scan through K5, each from an emptied
    cache (``f2_phase`` holds their reserved peaks against eager rounds'),
    then an evaluation.  Returns the server's start params too, on the
    host (the F2 phase's eager server starts from them: drawing them from
    the seed again takes seconds of host time)."""
    from repro_torch.data.loader import Batcher
    from repro_torch.data.synthetic import make_lm_dataset

    t0 = time.perf_counter()
    server = xlstm_server()
    start = _on("cpu", server.params)
    test = Batcher(make_lm_dataset(SEED + 1, TEST_SEQS, LM_SEQ_LEN,
                                   server.adapter.cfg.vocab_size),
                   server.flc.batch_size, seed=SEED, kind="lm")
    return (server, start, *transformer_rounds(torch, kernels, np, server,
                                               test, t0, fresh=True))


F2_BAR = 1.1    # a default round may reserve 10% more than an eager one


def f2_phase(torch, kernels, rounds, start):
    """ROADMAP F2: main path 3's default rounds (captured steps) against
    eager rounds (``capture=False``) of the same server, seed, start
    params (``start``) and stages, each round from an emptied cache.  A
    default round's reserved peak must stay within F2_BAR of the eager
    round's, and its loss must be the eager round's to the bit (a replay
    gives the eager step's bits)."""
    server = xlstm_server(capture=False, params=_on("cuda", start))
    del start
    check(not server.runtime.capture, "the eager server captures")
    eager = run_rounds(torch, server, kernels, len(rounds), quiet=True,
                       fresh=True)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for d, e in zip(rounds, eager):
        row = {"stage": d["stage"], "default_seconds": d["seconds"],
               "eager_seconds": e["seconds"],
               "default_allocated_mib": d["peak_bytes"] / 2**20,
               "eager_allocated_mib": e["peak_bytes"] / 2**20,
               "default_reserved_mib": d["peak_reserved_bytes"] / 2**20,
               "eager_reserved_mib": e["peak_reserved_bytes"] / 2**20,
               "same_loss": repr(d["mean_loss"]) == repr(e["mean_loss"])}
        row["reserved_ratio"] = (row["default_reserved_mib"]
                                 / row["eager_reserved_mib"])
        out.append(row)
        print(f"  stage {row['stage']}: default {row['default_seconds']:.3f}"
              f" s, allocated {row['default_allocated_mib']:.1f} MiB, "
              f"reserved {row['default_reserved_mib']:.1f}; eager "
              f"{row['eager_seconds']:.3f} s, allocated "
              f"{row['eager_allocated_mib']:.1f}, reserved "
              f"{row['eager_reserved_mib']:.1f}; reserved ratio "
              f"{row['reserved_ratio']:.4f}; the same loss: "
              f"{row['same_loss']}", flush=True)
    check(all(r["reserved_ratio"] <= F2_BAR for r in out),
          f"F2: a default round reserves more than {F2_BAR} x the eager "
          f"round's: {out}")
    check(all(r["same_loss"] for r in out),
          f"F2: default and eager rounds differ in loss: {out}")
    return out


# main path 6's xLSTM: the smoke config's width (``smoke_config``: d_model
# 256, 4 heads of 64, vocab 512) and xlstm-1.3b's (d_model 2048, 4 heads of
# 512, vocab 50304), each cut to 3 periods (24 layers) in 3 stages: stage 2
# then freezes a period, whose sLSTM layer the cohorts share, beside two
# trainable ones (in 2 stages of 2 periods nothing is frozen; 2 stages of 3
# periods train the embedding and two periods at stage 0, 10.3 GB of
# params for four cohorts, which ran out of the card's 80 GB in the
# vectorized step's backward at batch 8 and at 4).  4 cohorts, f32, lr
# 1e-4, one round a stage.  (B, S, sequences): the full width at batch 4,
# with few sequences a client, so that a round has few vectorized steps.
XLSTM_VEC_LAYERS, XLSTM_VEC_STAGES = 24, 3
XLSTM_VEC = {"smoke": (8, 64, 800), "full": (4, 256, 400)}


def xlstm_vec_server(width, runtime="sequential"):
    """Main path 6's xLSTM server at ``width`` ("smoke" or "full") over a
    100-device fleet on synthetic text, built from SEED."""
    from repro_torch.configs import xlstm_1_3b
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = xlstm_1_3b.config()
    cfg = (cfg.reduced(num_layers=XLSTM_VEC_LAYERS) if width == "smoke"
           else dataclasses.replace(cfg, num_layers=XLSTM_VEC_LAYERS))
    cfg = dataclasses.replace(cfg, **XLSTM)
    B, S, seqs = XLSTM_VEC[width]
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=B, lr=XLSTM_LR, num_stages=XLSTM_VEC_STAGES,
                   use_hsic_kernel=True, runtime=runtime, seed=SEED)
    ds = make_lm_dataset(SEED, seqs, S, cfg.vocab_size)
    parts = dirichlet_partition(SEED, ds.topics, flc.n_devices,
                                alpha=flc.alpha)
    return NeuLiteServer(make_adapter(cfg, flc.num_stages),
                         [ds.subset(p) for p in parts], flc, data_kind="lm")


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def _step(adapter, t, params, batch, lr, hp, use_kernel):
    from repro_torch.core.progressive import make_stage_step
    from repro_torch.optim.optimizers import sgd
    frozen, trainable = adapter.split_stage(params, t)
    opt = sgd(lr)
    hp = dataclasses.replace(hp, use_hsic_kernel=use_kernel)
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
    return loss_rel, _params_rel(an, bn)


def _params_rel(a, b):
    """max |a - b| over the largest entry of b, leaf by leaf."""
    scale = max(float(p.abs().max()) for p in _leaves(b) if p.numel())
    return max(float((x - y).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)) if x.numel()) / scale


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
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    return stage_step_check(server.adapter, plain_adapter or server.adapter,
                            server.params, batch, server.flc.lr, server.hp,
                            sensitivity)


def stage_step_check(adapter, plain_adapter, params, batch, lr, hp,
                     sensitivity):
    """``step_check`` of ``adapter`` at ``params`` on ``batch``."""
    from repro_torch.common.tree import tree_map
    out = []
    for t in range(adapter.plan.num_stages):
        kern = _step(adapter, t, params, batch, lr, hp, True)
        plain = _step(plain_adapter, t, params, batch, lr, hp, False)
        loss_rel, params_rel = _step_diff(kern, plain)
        row = {"stage": t, "loss": float(kern[1]["loss"]),
               "plain_loss": float(plain[1]["loss"]), "loss_rel": loss_rel,
               "params_rel": params_rel,
               "nhsic_xz": float(kern[1]["nhsic_xz"]),
               "nhsic_yz": float(kern[1]["nhsic_yz"])}
        bar_loss = bar_params = TOL
        if sensitivity:
            eps = tree_map(lambda p: p * (1 + 1e-7), params)
            moved = _step(plain_adapter, t, eps, batch, lr, hp, False)
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


def vmap_period_check(torch, server, stack):
    """Each period of the full-width transformer under ``torch.func.vmap``
    over the cohorts of ``stack``, as the vectorized runtime runs it (each
    cohort its own input, its first batch, and its own params, the
    server's scaled by 1 + c / 100; K4 folds the cohorts into its batch):
    output and the gradient to the period's params and input for one
    cotangent, against the same function run on each cohort alone, at
    TOL.  Well posed where a whole round of the ViT is not."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_map
    from repro_torch.models import model as tx
    cfg = server.adapter.cfg
    batches = to_device(stack.batches, server.device)
    layers = server.params["model"]["layers"]
    with torch.no_grad():
        embedded = [tx.embed_inputs(server.params["model"], cfg,
                                    tree_map(lambda a, c=c: a[c, 0],
                                             batches["inputs"]))
                    for c in range(stack.num_cohorts)]
    x = torch.stack([e[0] for e in embedded])
    pos = embedded[0][1]
    scale = torch.arange(stack.num_cohorts, device=x.device) * 1e-2 + 1

    def stacked(a):       # (C, ...): cohort c scaled by 1 + c / 100
        return a[None] * scale.view(-1, *[1] * a.dim())

    def period(lp, xi, cot):
        y, vjp = torch.func.vjp(lambda p, h: tx._run_periods(p, cfg, h, pos),
                                lp, xi)
        return y, vjp(cot)

    gen = torch.Generator().manual_seed(3)
    out = []
    for i in range(tx.num_stacked(layers)):
        lp = tree_map(lambda a, i=i: stacked(a[i:i + 1].detach()), layers)
        xs = x
        cot = torch.randn(xs.shape, generator=gen).to(x.device)
        y, grads = torch.func.vmap(period)(lp, xs, cot)
        rel_y = rel_g = 0.0
        for c in range(stack.num_cohorts):
            yc, gc = period(tree_map(lambda a, c=c: a[c], lp), xs[c], cot[c])
            rel_y = max(rel_y, rel_abs(y[c], yc)[0])
            rel_g = max(rel_g, rel_abs([g[c] for g in _leaves(grads)],
                                       _leaves(gc))[0])
        check(rel_y <= TOL and rel_g <= TOL,
              f"period {i} under vmap: {rel_y}, {rel_g} from the cohorts "
              f"run alone")
        out.append({"period": i, "out_rel": rel_y, "grad_rel": rel_g})
        x = y.detach()
    print(f"  {len(out)} periods under vmap over {stack.num_cohorts} "
          f"cohorts against "
          f"each cohort alone: output rel <= "
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
KERNEL_NAMES = {"nhsic": ("nhsic_rowsums_kernel", "nhsic_stats_kernel",
                          "sum_partials_kernel", "nhsic_grad_kernel"),
                "flash": ("flash_fwd_kernel",),
                "slstm": ("slstm_fwd_kernel", "slstm_bwd_kernel")}


def step_profile(torch, server, steps=5):
    """Where a full-width local step's time goes, captured (the runtime's
    step on the card: one CUDA graph replayed a step) and eager, side by
    side: ``torch.profiler`` over ``steps`` steps of each stage (after a
    warm-up step; the captured step's captures it).  Device busy
    time is the sum of the card's kernel and copy times; the rest of the
    host-clock wall time the card sits idle.  Only CUDA activity is
    traced (each row says so): tracing the CPU too lengthens the wall time,
    so rows that traced other activities do not compare with these."""
    return [row for t in range(server.adapter.plan.num_stages)
            for row in (_stage_profile(torch, server, t, steps, True),
                        _stage_profile(torch, server, t, steps, False))]


def _stage_profile(torch, server, t, steps, captured):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.device import to_device
    from repro_torch.core.progressive import jit_stage_step, make_stage_step
    from repro_torch.optim.optimizers import sgd
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    frozen, trainable = server.adapter.split_stage(server.params, t)
    opt = sgd(server.flc.lr)
    step = (jit_stage_step(server.adapter, opt, server.hp, t,
                           device=server.device) if captured
            else make_stage_step(server.adapter, opt, server.hp, t))
    state, tr = opt.init(trainable), trainable
    # global_ref is the round's start, as a client's local training holds
    # it (a captured step reads it in place: another tensor there would
    # capture anew)
    state, tr, _ = step(state, tr, frozen, batch, trainable)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, tr, _ = step(state, tr, frozen, batch, trainable)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = device_kernel_ms(torch, prof, steps)
    busy = device_busy_ms(torch, prof, steps)
    ours = {fam: sum(v for k, v in by_name.items()
                     if any(n in k for n in names))
            for fam, names in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = {"stage": t, "traced": [a.name for a in activities],
           "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy if by_name else None,
           "device_ops_ms_per_step": (sum(by_name.values()) if by_name
                                      else None),
           "nhsic_kernels_ms_per_step": ours["nhsic"] if by_name else None,
           "flash_kernel_ms_per_step": ours["flash"] if by_name else None,
           "slstm_kernel_ms_per_step": ours["slstm"] if by_name else None,
           "idle_share": 1.0 - busy / wall_ms if by_name else None,
           "device_kernels_per_step": sum(
               1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
           "top": [[k[:90], v] for k, v in top]}
    mode = row["mode"] = "captured" if captured else "eager"
    if by_name:
        print(f"  stage {t} {mode}: {wall_ms:.2f} ms/step wall, device busy "
              f"{busy:.2f} ms (nHSIC kernels {ours['nhsic']:.3f} ms, "
              f"flash kernel {ours['flash']:.3f} ms, sLSTM scan kernel "
              f"{ours['slstm']:.3f} ms), idle "
              f"{row['idle_share']:.1%}, "
              f"{row['device_kernels_per_step']:.0f} device ops/step",
              flush=True)
    else:
        print(f"  stage {t} {mode}: {wall_ms:.2f} ms/step wall; the "
              f"profiler recorded no device time", flush=True)
    return row


def cnn_nhsic_shapes(adapter, B):
    """(B, Dx, Dz, linear_x) of the nHSIC calls of a CNN adapter's stage
    steps, from its block plan: h_xz between the frozen prefix's output
    (the images at stage 0) and the active block's, h_yz between the labels
    and the 64-wide projection."""
    from repro_torch.models.cnn import unit_meta
    cfg, metas, out = adapter.cfg, unit_meta(adapter.cfg), []
    for t in range(adapter.plan.num_stages):
        (_, f1), _, (_, a1) = adapter.plan.stage_ranges(t)
        dx = metas[f1 - 1][1]["cout"] if f1 else cfg.in_channels
        out.append((B, dx, metas[a1 - 1][1]["cout"], False))
    out.append((B, cfg.num_classes, 64, True))
    return out


def fig6_nhsic_shapes():
    """The Fig. 6 CNNs' nHSIC shapes at the paper's batch."""
    from repro_torch.benchmarks import fig6_memory as fig6
    return [s for arch, stages in fig6.CNNS
            for s in cnn_nhsic_shapes(fig6.cnn_adapter(arch, stages),
                                      fig6.PAPER_BATCH)]


def fig7_nhsic_shapes():
    """The Fig. 7 phase's nHSIC shapes: each arch at each of FIG7_SIZES
    (width 0.5 gives other channel counts than the full width)."""
    from repro_torch.benchmarks import fig7_time
    from repro_torch.core.progressive import make_adapter
    from repro_torch.models.cnn import CNNConfig
    return [s for width, size in FIG7_SIZES for arch in FIG7_ARCHS
            for s in cnn_nhsic_shapes(make_adapter(CNNConfig(
                name=arch, arch=arch, image_size=size, width_mult=width),
                fig7_time.STAGES), FIG7_BATCH)]


def tables_nhsic_shapes():
    """Main path 7's nHSIC shapes: NeuLite's stage steps in Tables 1 and 2
    (ResNet34 too) at TABLE_SIZE, 4 stages, the fleet's batch of 32."""
    from repro_torch.core.progressive import make_adapter
    from repro_torch.models.cnn import CNNConfig
    return [s for arch in TABLE1_ARCHS + ("resnet34",)
            for s in cnn_nhsic_shapes(make_adapter(CNNConfig(
                name=arch, arch=arch, image_size=TABLE_SIZE["image_size"],
                width_mult=TABLE_SIZE["width"]), 4), 32)]


def resnet18_nhsic_shapes(width, image_size, num_classes=10, B=32):
    """A 4-stage ResNet18's nHSIC shapes at batch B."""
    from repro_torch.core.progressive import make_adapter
    from repro_torch.models.cnn import CNNConfig
    return cnn_nhsic_shapes(make_adapter(CNNConfig(
        name="resnet18", arch="resnet18", num_classes=num_classes,
        image_size=image_size, width_mult=width), 4), B)


def transformer_nhsic_shapes(cfg, B):
    """A transformer's nHSIC shapes at batch B, any stage: h_xz between
    the pooled d_model-wide input and output of the trained block, h_yz
    between the label features (min(classes, 256) buckets) and the 64-wide
    projection."""
    return [(B, cfg.d_model, cfg.d_model, False),
            (B, min(cfg.vocab_size, 256), 64, True)]


def fig2_nhsic_shapes():
    """The Fig. 2 phase's nHSIC shapes: ResNet18 at each of FIG2_SIZES."""
    return [s for width, size in FIG2_SIZES
            for s in resnet18_nhsic_shapes(width, size)]


def fig5_nhsic_shapes():
    """The Fig. 5 phase's: 5a's ResNet18 on 62 classes, 5b's ViT-12 on 32
    (per cohort under vmap)."""
    from repro_torch.benchmarks.fig5_scale_vit import vit_config
    return (resnet18_nhsic_shapes(FIG5_SIZE["width"],
                                  FIG5_SIZE["image_size"], 62)
            + transformer_nhsic_shapes(vit_config(**FIG5_VIT), 32))


def quickstart_nhsic_shapes():
    from repro_torch.examples import quickstart
    return transformer_nhsic_shapes(quickstart.config(), quickstart.BATCH)


def nhsic_shapes():
    """The training paths' nHSIC shapes, each once: the main paths', then
    the Fig. 6 CNNs', Tables 1-2's, the Fig. 7, 2, 5 and 8 phases' and the
    quickstart's."""
    return list(dict.fromkeys(
        MAIN_PATH_SHAPES + fig6_nhsic_shapes() + tables_nhsic_shapes()
        + fig7_nhsic_shapes() + fig2_nhsic_shapes() + fig5_nhsic_shapes()
        + resnet18_nhsic_shapes(**FIG8_SIZE) + quickstart_nhsic_shapes()))


def fig6_step_check(torch, device):
    """One step per stage of each Fig. 6 CNN at the paper's batch, on the
    phase's first batch, kernel path against plain path (``step_check``,
    with the plain path's own sensitivity)."""
    from repro_torch.benchmarks import fig6_memory as fig6
    from repro_torch.common.device import to_device
    from repro_torch.core.curriculum import CurriculumHP
    out = {}
    for arch, stages in fig6.CNNS:
        adapter = fig6.cnn_adapter(arch, stages)
        print(f"  {arch} B={fig6.PAPER_BATCH}:", flush=True)
        batch = to_device(fig6.image_batches(adapter, fig6.PAPER_BATCH)[0],
                          device)
        out[arch] = stage_step_check(
            adapter, adapter, adapter.init_params(fig6.SEED, device), batch,
            fig6.LR, CurriculumHP(), sensitivity=True)
        gc.collect()
    return out


@contextlib.contextmanager
def nhsic_shapes_seen():
    """The set of (B, Dx, Dz, linear_x, kernel_z) that nHSIC takes while
    the block runs."""
    from repro_torch.kernels.hsic_gram import ops
    seen, nhsic = set(), ops.nhsic

    def recorded(x, z, *, kernel_x="rbf", kernel_z="rbf"):
        seen.add((x.shape[0], x.shape[1], z.shape[1], kernel_x == "linear",
                  kernel_z))
        return nhsic(x, z, kernel_x=kernel_x, kernel_z=kernel_z)

    ops.nhsic = recorded
    try:
        yield seen
    finally:
        ops.nhsic = nhsic


@contextlib.contextmanager
def flash_shapes_seen():
    """The set of K4 cases, as FLASH_CASES lists them, that flash
    attention takes while the block runs (per cohort under vmap)."""
    from repro_torch.kernels.flash_attention import ops as fops
    seen, flash = set(), fops.flash_attention

    def recorded(q, k, v, *, causal=True, window=0):
        seen.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                  k.shape[2], q.shape[3], bool(causal), int(window),
                  str(q.dtype).removeprefix("torch.")))
        return flash(q, k, v, causal=causal, window=window)

    fops.flash_attention = recorded
    try:
        yield seen
    finally:
        fops.flash_attention = flash


def check_flash_held(seen, where):
    """Every K4 case of ``seen`` is one the kernel phase held."""
    unheld = set(seen) - set(FLASH_CASES)
    check(not unheld, f"flash attention shapes of {where} that the kernel "
          f"phase did not hold against the plain version: {unheld}")
    print(f"  K4 took {len(seen)} shapes in {where}, each held in the "
          f"kernel phase", flush=True)


def check_held(seen, where):
    """Every nHSIC shape of ``seen`` was held against the plain version in
    the kernel phase."""
    held = set(nhsic_shapes())
    unheld = {s for s in seen if s[4] != "rbf" or s[:4] not in held}
    check(not unheld, f"nHSIC shapes of {where} that the kernel phase did "
          f"not hold against the plain version: {unheld}")
    print(f"  nHSIC took {len(seen)} shapes in {where}, each held in the "
          f"kernel phase", flush=True)


def fig6_phase(torch, kernels):
    """The paper's Fig. 6 on the card (``fig6_memory.run``), every model's
    measurements from an empty cache with nothing else resident.  The
    shapes nHSIC takes in the phase must all have been held against the
    plain version in the kernel phase; then the step check of the CNNs at
    the paper's batch.  Returns the rows, the kernels' launches in the
    measurements and the step checks."""
    from repro_torch.benchmarks import fig6_memory as fig6

    device = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    print(f"  allocated before the phase: {before} bytes", flush=True)
    reset_all(kernels)
    with nhsic_shapes_seen() as seen:
        rows = fig6.run(device, FIG6_OUT)
    counts = read_all(kernels)
    print(f"  launches {counts}", flush=True)
    for name, r in rows.items():
        check(all(math.isfinite(e["mean_loss"]) and e["num_batches"] == 2
                  for e in r["stages"] + [r["full"]]),
              f"{name}: a step did not take two finite-loss batches")
    stage_steps = sum(2 * len(r["stages"]) for r in rows.values())
    check(all(counts[n] == 2 * stage_steps for n in STREAMING),
          f"expected 2 launches of each nHSIC kernel per stage step "
          f"({stage_steps} steps): {counts}")
    check(all(counts[n] > 0 for n in ("flash_attention_fwd",
                                      "slstm_scan_fwd", "slstm_scan_bwd")),
          f"a per-layer kernel never ran in the Fig. 6 phase: {counts}")
    check_held(seen, "the Fig. 6 phase")
    failures = {name: r["failures"] for name, r in rows.items()
                if r["failures"]}
    check(not failures, f"a stage peaks at or above its full step: "
          f"{failures}")
    print(f"  every stage peaks below its full step; table written to "
          f"{os.path.relpath(FIG6_OUT, ROOT)}", flush=True)
    phase("step check of the Fig. 6 CNNs")
    steps = fig6_step_check(torch, device)
    return {"rows": rows, "launches": counts, "allocated_before": before,
            "step_check": steps}, counts


# --------------------------------------------------------------------------- #
# K1-K3 batched over cohorts and K4 folded (the vectorized runtime's calls)
# --------------------------------------------------------------------------- #
BATCHED_COHORTS = (1, 3, 4)
BATCHED_BATCHES = (16, 32, 128)
# the main paths' widths (Dx, Dz, linear_x): h_xz, and h_yz on the label
# features, which the vectorized runtime also batches over its cohorts
BATCHED_WIDTHS = list(dict.fromkeys((Dx, Dz, lx) for _, Dx, Dz, lx in
                                    MAIN_PATH_SHAPES))
BATCHED_TIMED = (4, *TIMED_SHAPE)   # C = 4 at the ResNet path's largest call


def batched_args(torch, hsic, ref, x, z, lx):
    """Each K1-K3's (C, ...) inputs: each cohort's as ``kernel_args``
    builds them, stacked on a leading cohort axis."""
    per = [kernel_args(torch, hsic, ref, x[c], z[c], lx)
           for c in range(x.shape[0])]
    return {n: (tuple(torch.stack([p[n][0][i] for p in per])
                      for i in range(len(per[0][n][0]))), per[0][n][1])
            for n in STREAMING}


def _tuple(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def batched_phase(torch, kernel, ref, hsic, fkernel, fref):
    """K1-K3 on (C, B, D) stacks, C in BATCHED_COHORTS, B in
    BATCHED_BATCHES, at the main paths' h_xz and h_yz widths (linear x
    for h_yz, as the label features take it): one launch each, every
    cohort's result the same bits as a launch of its own and within TOL of
    the plain version.  Then K4 under ``torch.func.vmap`` over four cohorts
    at the ViT-12 shape: one launch, the same bits as four."""
    errs, cases = {}, 0
    for C in BATCHED_COHORTS:
        for B in BATCHED_BATCHES:
            for Dx, Dz, lx in BATCHED_WIDTHS:
                g = torch.Generator().manual_seed(C * 1000 + B * 10 + Dx + Dz)
                x = torch.randn(C, B, Dx, generator=g).cuda()
                z = torch.randn(C, B, Dz, generator=g).cuda()
                args = batched_args(torch, hsic, ref, x, z, lx)
                for n in STREAMING:
                    a, kw = args[n]
                    before = kernel.LAUNCHES[n]
                    got = _tuple(getattr(kernel, n)(*a, **kw))
                    check(kernel.LAUNCHES[n] == before + 1,
                          f"{n} C={C}: not one launch")
                    for c in range(C):
                        own = _tuple(getattr(kernel, n)(
                            *(t[c] for t in a), **kw))
                        check(all(torch.equal(o[c], w) for o, w in
                                  zip(got, own)),
                              f"{n} C={C} B={B} Dx={Dx} Dz={Dz} lx={lx}: "
                              f"cohort "
                              f"{c} is not the bits of its own launch")
                        rel, ab = rel_abs(
                            tuple(o[c] for o in got),
                            getattr(ref, n)(*(t[c] for t in a), **kw))
                        check(rel <= TOL, f"batched {n} C={C} B={B} "
                              f"Dx={Dx} Dz={Dz} lx={lx} cohort {c}: rel err "
                              f"{rel}")
                        track(errs, n, rel, ab)
                cases += 1
    torch.cuda.synchronize()
    print(f"  batched K1-K3 at {cases} (C, B, Dx, Dz, linear_x): one launch "
          f"each, "
          f"every cohort the bits of its own launch, rel err <= "
          + ", ".join(f"{n} {errs[n][1]:.2e}" for n in STREAMING),
          flush=True)
    B, Sq, Skv, H, KV, D = FLASH_VIT[:6]
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(4, B, s, h, D, generator=g).cuda()
               for s, h in ((Sq, H), (Skv, KV), (Skv, KV)))
    before = fkernel.LAUNCHES["flash_attention_fwd"]
    folded = torch.func.vmap(lambda a, b, c: fkernel.flash_attention_fwd(
        a, b, c, causal=False))(q, k, v)
    check(fkernel.LAUNCHES["flash_attention_fwd"] == before + 1,
          "folded K4: not one launch")
    rel = 0.0
    for c in range(4):
        check(torch.equal(folded[c], fkernel.flash_attention_fwd(
            q[c], k[c], v[c], causal=False)),
            f"folded K4 cohort {c}: not the bits of its own launch")
        rel = max(rel, rel_abs(folded[c], fref.attention_ref(
            q[c], k[c], v[c], causal=False))[0])
    check(rel <= TOL, f"folded K4: rel err {rel}")
    print(f"  K4 under vmap over 4 cohorts at {FLASH_VIT[:6]}: one launch "
          f"of (4 x {B}, ...), the bits of four, rel err {rel:.2e}",
          flush=True)
    return errs, {"cases": cases, "flash_folded_rel": rel}


def batched_timing(torch, kernel, ref, hsic):
    """One batched K1, K2, K3 call at C = 4 against four unbatched calls on
    the same cohorts: event and device time, and the bound of the batched
    call (C times one call's bytes and operations)."""
    C, B, Dx, Dz, lx = BATCHED_TIMED
    g = torch.Generator().manual_seed(5)
    x = torch.randn(C, B, Dx, generator=g).cuda()
    z = torch.randn(C, B, Dz, generator=g).cuda()
    args = batched_args(torch, hsic, ref, x, z, lx)
    rows = []
    for n in STREAMING:
        a, kw = args[n]
        fn = getattr(kernel, n)
        one = lambda: fn(*a, **kw)
        four = lambda: [fn(*(t[c] for t in a), **kw) for c in range(C)]
        ms, ms4 = time_ms(torch, one), time_ms(torch, four)
        dev = device_ms(torch, one, STREAMING_KERNELS[n])
        dev4 = device_ms(torch, four, STREAMING_KERNELS[n])
        plain = time_ms(torch, lambda: getattr(ref, n)(*a, **kw))
        b_ms, b_by = bound_ms(n, (B, Dx, Dz, lx))
        row = {"name": n, "cohorts": C, "shape": [B, Dx, Dz, lx], "ms": ms,
               "device_ms": dev, "four_calls_ms": ms4,
               "four_calls_device_ms": dev4, "plain_ms": plain,
               "bound_ms": C * b_ms, "bound_by": b_by}
        rows.append(row)
        print(f"  time batched {n} C={C} B={B} Dx={Dx} Dz={Dz}: one call "
              f"{ms:.4f} ms (device {fmt_ms(dev)}), four calls {ms4:.4f} ms "
              f"(device {fmt_ms(dev4)}), plain {plain:.4f} ms, bound "
              f"{C * b_ms:.2e} ms ({b_by})", flush=True)
    return rows


# K5 over cohorts under torch.func.vmap, (B, S, H, Dh): the reference's audit
# shapes (kernels/slstm_scan/ops.py), the xLSTM smoke width (16 blocks a
# cohort) and xlstm-1.3b's (128 blocks a cohort, one an SM); main path 6
# runs the last two
SLSTM_BATCHED = [(2, 256, 2, 512), (2, 128, 4, 64), (8, 64, 4, 64),
                 (8, 256, 4, 512)]
SLSTM_SMOKE, SLSTM_FULL = SLSTM_BATCHED[2], SLSTM_BATCHED[3]


def slstm_stack(torch, case, C, shared):
    """C cohorts' (g_in, r, b, c0, n0, m0, h0) with a leading cohort axis,
    each cohort drawn as ``slstm_inputs`` draws them (random initial
    states) from a seed of its own; r and b cohort 0's where ``shared``."""
    B, S, H, Dh = case
    per = []
    for c in range(C):
        g = torch.Generator().manual_seed(1000 * C + c)
        per.append([torch.randn((B, S, 4, H, Dh), generator=g),
                    torch.randn((4, H, Dh, Dh), generator=g)
                    * (0.5 / math.sqrt(Dh)),
                    torch.randn((4, H, Dh), generator=g) * 0.1,
                    torch.randn((B, H, Dh), generator=g),
                    torch.randn((B, H, Dh), generator=g).abs() + 0.1,
                    torch.randn((B, H, Dh), generator=g),
                    torch.randn((B, H, Dh), generator=g) * 0.5])
    stack = [torch.stack(ts).cuda() for ts in zip(*per)]
    if shared:
        stack[1], stack[2] = stack[1][0].contiguous(), stack[2][0].contiguous()
    return stack


def slstm_batched_calls(torch, skernel, case, C, shared):
    """K5's forward (saving the states) and backward under
    ``torch.func.vmap`` over C cohorts: (inputs, cotangents, forward
    outputs, backward outputs, forward launches, backward launches)."""
    g_in, r, b, *st = slstm_stack(torch, case, C, shared)
    rd = None if shared else 0
    fwd = torch.func.vmap(
        lambda g, r_, b_, *s: skernel.slstm_scan_fwd(g, r_, b_, *s,
                                                     save=True),
        in_dims=(0, rd, rd, 0, 0, 0, 0))
    bwd = torch.func.vmap(skernel.slstm_scan_bwd,
                          in_dims=(0, 0, 0, 0, rd) + (0,) * 8)
    before = dict(skernel.LAUNCHES)
    out = fwd(g_in, r, b, *st)
    gen = torch.Generator().manual_seed(C)
    cot = [torch.randn(tuple(t.shape), generator=gen).cuda()
           for t in out[:5]]
    back = bwd(*out[5:], r, *st[:3], *cot)
    torch.cuda.synchronize()
    n = {k: skernel.LAUNCHES[k] - before[k] for k in before}
    return ((g_in, r, b, *st), cot, out, back, n["slstm_scan_fwd"],
            n["slstm_scan_bwd"])


def predicted_slstm_launches(torch, case, C, shared):
    """K5's launches per batched call, as ``slstm_scan.cu`` groups whole
    heads: shared r folds the cohorts into the rows (one cohort's H
    heads), per-cohort r makes C H heads of ceil(Dh / 16) blocks.  At
    Dh <= 64 a block takes ~52 KiB, and every case here fits the card at
    once: one launch; at Dh = 512 it takes ~165 KiB, one block an SM, so a
    launch takes SMs // 32 whole heads (4 on 132 SMs)."""
    B, S, H, Dh = case
    heads = H if shared else C * H
    if Dh <= 64:
        return 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-heads // (sms // -(-Dh // 16)))


def batched_slstm_phase(torch, skernel, sref):
    """K5 forward and backward under vmap over C in BATCHED_COHORTS cohorts
    at every SLSTM_BATCHED shape, with r and b per cohort (a trainable
    layer: the cohorts' heads on the kernels) and shared (a frozen layer:
    the cohorts folded into the rows): each cohort's outputs the bits of a
    launch of its own and within TOL (scale-relative) of ``ref.py``
    (vmapped over the cohorts);
    launches as predicted (``predicted_slstm_launches``)."""
    errs, cases = {}, 0
    launches = {}
    for case in SLSTM_BATCHED:
        for C in BATCHED_COHORTS:
            for shared in (False, True):
                ins, cot, out, back, nf, nb = slstm_batched_calls(
                    torch, skernel, case, C, shared)
                g_in, r, b, *st = ins
                # ``ref.py`` for every cohort at once: the plain loops
                # under vmap (the backward on the kernel's saved states)
                rd = None if shared else 0
                hs, fin, saved = torch.func.vmap(
                    lambda g, r_, b_, *s: sref.slstm_scan_ref(
                        g, r_, b_, dict(zip(STATE, s)), save=True),
                    in_dims=(0, rd, rd, 0, 0, 0, 0))(g_in, r, b, *st)
                ref_f = ([hs] + [fin[k] for k in STATE]
                         + [saved[k] for k in "gcnm"])
                ref_b = torch.func.vmap(
                    sref.slstm_scan_bwd_ref,
                    in_dims=(0, 0, 0, 0, rd) + (0,) * 8)(*out[5:], r,
                                                         *st[:3], *cot)
                want = predicted_slstm_launches(torch, case, C, shared)
                launches[str((*case, C, shared))] = (nf, nb)
                check(nf == nb == want,
                      f"batched K5 {case} C={C} shared={shared}: {nf} "
                      f"forward and {nb} backward launches, expected "
                      f"{want}")
                for c in range(C):
                    rc, bc = (r, b) if shared else (r[c], b[c])
                    stc = [t[c] for t in st]
                    own = skernel.slstm_scan_fwd(g_in[c], rc, bc, *stc,
                                                 save=True)
                    own_b = skernel.slstm_scan_bwd(
                        *own[5:], rc, *stc[:3], *(t[c] for t in cot))
                    check(all(torch.equal(o[c], w) for o, w in
                              zip(out, own)) and
                          all(torch.equal(o[c], w) for o, w in
                              zip(back, own_b)),
                          f"batched K5 {case} C={C} shared={shared}: cohort "
                          f"{c} is not the bits of its own launch")
                    rel, ab = rel_abs([o[c] for o in out],
                                      [w[c] for w in ref_f])
                    rel_b, ab_b = rel_abs([o[c] for o in back],
                                          [w[c] for w in ref_b])
                    check(rel <= TOL and rel_b <= TOL,
                          f"batched K5 {case} C={C} shared={shared} cohort "
                          f"{c}: rel err {rel} forward, {rel_b} backward")
                    track(errs, "slstm_scan_fwd", rel, ab)
                    track(errs, "slstm_scan_bwd", rel_b, ab_b)
                cases += 1
                del ins, cot, out, back, ref_f, ref_b, hs, fin, saved
    print(f"  batched K5 at {cases} (shape, C, shared r): every cohort the "
          f"bits of its own launch, rel err <= forward "
          f"{errs['slstm_scan_fwd'][1]:.2e}, backward "
          f"{errs['slstm_scan_bwd'][1]:.2e}; launches (forward, backward) "
          f"{launches}", flush=True)
    return errs, {"slstm_cases": cases, "slstm_launches": launches}


def batched_slstm_timing(torch, skernel, sref):
    """K5's forward and backward over C = 4 cohorts, one vmapped call
    against four unbatched calls: event and device time, launches.  At
    xlstm-1.3b's width with each cohort's own r (main path 6's trainable
    layers) also the plain versions on the same cohorts (``ref.py``'s
    loops, one cohort after another) and the bound, C times one cohort's:
    the kernel line's rows.  Then device time alone at the smoke width
    and, r shared (folded into the rows), at full width."""
    C = 4
    kname = {"slstm_scan_fwd": "slstm_fwd_kernel",
             "slstm_scan_bwd": "slstm_bwd_kernel"}
    rows = []
    for case, shared in ((SLSTM_FULL, False), (SLSTM_SMOKE, False),
                         (SLSTM_FULL, True)):
        ins, cot, out, _, nf, nb = slstm_batched_calls(torch, skernel, case,
                                                       C, shared)
        g_in, r, b, *st = ins
        rd = None if shared else 0
        fwd = torch.func.vmap(
            lambda *a: skernel.slstm_scan_fwd(*a, save=True),
            in_dims=(0, rd, rd, 0, 0, 0, 0))
        bwd = torch.func.vmap(skernel.slstm_scan_bwd,
                              in_dims=(0, 0, 0, 0, rd) + (0,) * 8)
        bargs = (*out[5:], r, *st[:3], *cot)
        rc = (lambda c: r) if shared else (lambda c: r[c])
        bc = (lambda c: b) if shared else (lambda c: b[c])
        calls = {
            "slstm_scan_fwd": (lambda: fwd(*ins), lambda: [
                skernel.slstm_scan_fwd(g_in[c], rc(c), bc(c),
                                       *(t[c] for t in st), save=True)
                for c in range(C)]),
            "slstm_scan_bwd": (lambda: bwd(*bargs), lambda: [
                skernel.slstm_scan_bwd(*(t[c] for t in out[5:]), rc(c),
                                       *(t[c] for t in st[:3]),
                                       *(t[c] for t in cot))
                for c in range(C)])}
        main = case == SLSTM_FULL and not shared
        for n, (one, four) in calls.items():
            row = {"name": n, "cohorts": C, "shape": list(case),
                   "shared_r": shared,
                   "launches_per_call": nf if n == "slstm_scan_fwd" else nb,
                   "device_ms": device_ms(torch, one, (kname[n],)),
                   "four_calls_device_ms": device_ms(torch, four,
                                                     (kname[n],))}
            if main:
                b_ms, b_by = bound_ms(n, case)
                plain = {"slstm_scan_fwd": lambda: [sref.slstm_scan_ref(
                             g_in[c], r[c], b[c],
                             dict(zip(STATE, (t[c] for t in st))),
                             save=True) for c in range(C)],
                         "slstm_scan_bwd": lambda: [sref.slstm_scan_bwd_ref(
                             *(t[c] for t in bargs)) for c in range(C)]}[n]
                row.update(ms=time_ms(torch, one),
                           four_calls_ms=time_ms(torch, four),
                           plain_ms=time_ms(torch, plain, runs=3, warmup=1),
                           bound_ms=C * b_ms, bound_by=b_by)
            rows.append(row)
            print(f"  time batched {n} C={C} {case} "
                  f"{'shared' if shared else 'own'} r: "
                  + (f"one call {row['ms']:.4f} ms, " if main else "")
                  + f"device {fmt_ms(row['device_ms'])} in "
                  f"{row['launches_per_call']} launches; four calls "
                  + (f"{row['four_calls_ms']:.4f} ms, " if main else "")
                  + f"device {fmt_ms(row['four_calls_device_ms'])}"
                  + (f"; plain {row['plain_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.3f} ms ({row['bound_by']})"
                     if main else ""), flush=True)
        del ins, cot, out
    return rows


# --------------------------------------------------------------------------- #
# the captured step against the eager step
# --------------------------------------------------------------------------- #
def _kernel_sequence(torch, fn):
    """The device kernels' names of one call of ``fn``, in start order;
    copies and fills left out (a captured step's loads of its static
    buffers and writes of its carried outputs are copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events
            if not e.name.startswith(("Memcpy", "Memset"))]


def _kernel_diff(eager, captured):
    """How two kernel sequences differ: the first position where the
    names part, and the names each runs more often than the other (a
    replay may start independent kernels in another order; a kernel that
    only one of them runs is another algorithm)."""
    from collections import Counter
    ce, cc = Counter(eager), Counter(captured)
    return {"eager_kernels": len(eager), "captured_kernels": len(captured),
            "first_differing_kernel": next(
                ((i, a, b) for i, (a, b) in enumerate(zip(eager, captured))
                 if a != b), None),
            "only_eager": sorted((ce - cc).items())[:8],
            "only_captured": sorted((cc - ce).items())[:8]}


def capture_check(torch, server):
    """One stage step per stage from the same state on the test batch,
    eager (``make_stage_step``) and captured (``jit_stage_step``, one CUDA
    graph replayed): new params, optimizer state and loss must be the same
    bits.  Where a stage's are not, the first device kernel whose name
    differs between the eager step's and the replay's profiles is named,
    and that stage is held at the step bar (TOL) instead.  Also times what
    a local step's argument copies cost beside the graph's replay."""
    from repro_torch.common.device import to_device
    from repro_torch.core.progressive import (CapturedStep, jit_stage_step,
                                              make_stage_step)
    from repro_torch.optim.optimizers import sgd
    adapter = server.adapter
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    out = []
    for t in range(adapter.plan.num_stages):
        frozen, trainable = adapter.split_stage(server.params, t)
        opt = sgd(server.flc.lr)
        eager = make_stage_step(adapter, opt, server.hp, t)
        captured = jit_stage_step(adapter, opt, server.hp, t,
                                  device=server.device)
        check(isinstance(captured, CapturedStep), "the step was not captured")
        runs = {}
        for name, step in (("eager", eager), ("captured", captured)):
            state, tr, m = step(opt.init(trainable), trainable, frozen,
                                batch, trainable)
            runs[name] = ([p.clone() for p in _leaves([state, tr])],
                          m["loss"].clone())
        (ea, el), (ca, cl) = runs["eager"], runs["captured"]
        same = (torch.equal(el, cl)
                and all(torch.equal(a, b) for a, b in zip(ea, ca)))
        # what a replay's loads cost: the carried trees are the graph's
        # own buffers after a client's first step, so a local step copies
        # frozen, the batch and global_ref; the batch alone (the graph's
        # own frozen and global_ref buffers passed, which it skips) is what
        # a load that skipped unchanged arguments would copy
        (graph,) = captured.graphs.values()
        own = graph.static
        row = {"stage": t, "bitwise": same, "loss": float(el),
               "load_ms": time_ms(torch, lambda: graph.load(
                   (*own[:graph.carried], frozen, batch, trainable))),
               "load_batch_ms": time_ms(torch, lambda: graph.load(
                   (*own[:graph.carried], own[2], batch, own[4]))),
               "replay_ms": time_ms(torch, graph.graph.replay, runs=3,
                                    warmup=1)}
        del graph, own    # the graph's pool goes with ``captured`` below
        if not same:
            scale = max(float(a.abs().max()) for a in ea if a.numel())
            row["params_rel"] = max(float((a - b).abs().max())
                                    for a, b in zip(ea, ca)
                                    if a.numel()) / scale
            row["loss_rel"] = abs(float(el - cl)) / max(abs(float(el)), 1e-6)
            state0 = opt.init(trainable)
            seq_e = _kernel_sequence(torch, lambda: eager(
                state0, trainable, frozen, batch, trainable))
            seq_c = _kernel_sequence(torch, lambda: captured(
                state0, trainable, frozen, batch, trainable))
            row.update(_kernel_diff(seq_e, seq_c))
            check(row["params_rel"] <= TOL and row["loss_rel"] <= TOL,
                  f"stage {t}: captured vs eager beyond the step bar: {row}")
        out.append(row)
        print(f"  stage {t} step, captured vs eager: "
              + ("the same bits (params, optimizer state, loss)" if same
                 else f"DIFFER: {row}")
              + f"; a replay's loads {row['load_ms']:.4f} ms (the batch "
              f"alone {row['load_batch_ms']:.4f}) beside its graph's "
              f"{row['replay_ms']:.4f} ms", flush=True)
        del captured
        torch.cuda.empty_cache()    # the dropped graph's pool
    return out


# --------------------------------------------------------------------------- #
# main path 6: vectorized rounds
# --------------------------------------------------------------------------- #
def _on(device, tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda p: p.to(device), tree)


def _record_stacks(torch, server, profile_at=None, profile=None):
    """Keep each round's (params, stage, stack, new trainable) as the
    vectorized runtime runs it, the params and the new trainable on the
    host (at xlstm-1.3b's width they are GBs a round).  The round of index
    ``profile_at`` among them runs under the profiler (``_profiled``, into
    the dict ``profile``)."""
    seen = []
    run = server.runtime.run_stacked

    def recorded(params, t, stack):
        if len(seen) == profile_at:
            out = _profiled(torch, profile, lambda: run(params, t, stack))
        else:
            out = run(params, t, stack)
        seen.append((_on("cpu", params), t, stack, _on("cpu", out[0])))
        return out

    server.runtime.run_stacked = recorded
    return seen


def _profiled(torch, into, fn):
    """``fn()`` (a round's local steps and Eq. 1, its captures included,
    as every round captures) under the profiler: its wall ms, device busy
    ms and device ops go into the dict ``into``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_kernel_ms(torch, prof, 1)
    busy = device_busy_ms(torch, prof, 1)
    ops = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    into.update(wall_ms=wall, busy_ms=busy if by_name else None,
                ops_ms=sum(by_name.values()) if by_name else None,
                idle_share=1.0 - busy / wall if by_name else None,
                device_ops=ops)
    return out


def _update_rel(new, ref, start):
    """max |new - ref| over the largest entry of ref's update (ref -
    start), leaf by leaf."""
    scale = max(float((a - s).abs().max()) for a, s in
                zip(_leaves(ref), _leaves(start)) if a.numel())
    return max(float((a - b).abs().max()) for a, b in
               zip(_leaves(new), _leaves(ref)) if a.numel()) / scale


def cohort_step_check(torch, np, server, params, t, stack):
    """The first local step of every cohort of ``stack``, well posed where
    a round is not: the vectorized step (``cohort_stage_step``, eager)
    against each cohort's sequential stage step from the same state, its
    loss (relative) and its params (of the largest trained param) each at
    the step bar: TOL, or 10x the sequential step's own movement at params
    x (1 + 1e-7) where that exceeds TOL / 10, as ``step_check`` sets it;
    and the captured vectorized step (what the runtime replays) against
    the eager one, to the bit."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_map
    from repro_torch.core.progressive import CapturedStep, make_stage_step
    from repro_torch.federated.runtime import cohort_stage_step
    adapter, opt, hp = server.adapter, server.optimizer, server.hp
    C = stack.num_cohorts
    batch = tree_map(lambda x: x[:, 0].contiguous(),   # as the runtime
                     to_device(stack.batches, server.device))
    keep = torch.as_tensor(np.asarray(stack.step_mask)[:, 0],
                           device=server.device)
    frozen, trainable = adapter.split_stage(params, t)
    # as the runtime's first step takes them: views of one copy
    local = tree_map(lambda p: p.expand(C, *p.shape), trainable)
    state = tree_map(lambda v: v.expand(C, *v.shape), opt.init(trainable))
    step = cohort_stage_step(adapter, opt, hp, t)
    # as the runtime captures it: the frozen prefix and global_ref in place
    captured = CapturedStep(step, shared=(2, 4))
    args = (state, local, frozen, batch, trainable, keep)
    eager, em = step(*args)[1:]
    again = step(*args)[1]
    repeats = all(torch.equal(a, b) for a, b in zip(_leaves(eager),
                                                    _leaves(again)))
    del again
    # at full width the cohorts' stacked params are GBs: the eager step's
    # wait on the host while the captured step runs
    eager = tree_map(lambda p: p.cpu(), eager)
    cap, cm = captured(*args)[1:]
    cap = [p.cpu() for p in _leaves(cap)]
    cm = {"loss": cm["loss"].clone()}
    bitwise = (torch.equal(em["loss"], cm["loss"])
               and all(torch.equal(a, b) for a, b in
                       zip(_leaves(eager), cap)))
    row = {"captured_bitwise": bitwise, "eager_repeats_bitwise": repeats}
    if not bitwise:
        # name the first device kernel where the replay's sequence departs
        # from the eager step's, and hold the replay at the step bar
        seq_e = _kernel_sequence(torch, lambda: step(*args))
        seq_c = _kernel_sequence(torch, lambda: captured(*args))
        row.update(captured_params_rel=_params_rel(cap, eager),
                   **_kernel_diff(seq_e, seq_c))
        check(row["captured_params_rel"] <= TOL,
              f"stage {t}: the captured cohort step beyond the step bar: "
              f"{row}")
    captured.release()
    del captured, cap
    torch.cuda.empty_cache()
    seq = make_stage_step(adapter, opt, hp, t)
    moved = tree_map(lambda p: p * (1 + 1e-7), params)
    mfrozen, mtrain = adapter.split_stage(moved, t)
    worst, sens, loss_rel, sens_loss = 0.0, 0.0, 0.0, 0.0
    for c in [c for c in range(C) if bool(keep[c])]:
        b = tree_map(lambda x: x[c], batch)
        want = seq(opt.init(trainable), trainable, frozen, b, trainable)[1:]
        got = (tree_map(lambda p: p[c].to(server.device), eager),
               {"loss": em["loss"][c]})
        far = seq(opt.init(mtrain), mtrain, mfrozen, b, mtrain)[1:]
        loss_c, params_c = _step_diff(got, want)
        far_loss, far_params = _step_diff(far, want)
        worst, loss_rel = max(worst, params_c), max(loss_rel, loss_c)
        sens, sens_loss = max(sens, far_params), max(sens_loss, far_loss)
    bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
    check(worst <= bar, f"stage {t}: a vectorized step is {worst:.2e} from "
          f"the sequential step (bar {bar:.1e})")
    # each cohort's loss is a forward pass from the round's start params
    # on its own batch: it holds every cohort's batch, params and
    # surrogates, at TOL where the loss is well posed (every ResNet18
    # stage, the ViT's stage 0); deeper ViT stages pass a rounding change
    # through 8 or 12 periods, which move it by 1e-3 at params x
    # (1 + 1e-7), so there ``step_check``'s rule sets the bar
    bar_loss = (max(TOL, 10 * sens_loss) if sens_loss > TOL / 10 else TOL)
    check(loss_rel <= bar_loss, f"stage {t}: a cohort's vectorized step "
          f"loss is {loss_rel:.2e} from its sequential step's (bar "
          f"{bar_loss:.1e})")
    row.update(params_rel=worst, plain_eps_params_rel=sens, bar=bar,
               loss_rel=loss_rel, plain_eps_loss_rel=sens_loss,
               bar_loss=bar_loss)
    return row


def slstm_launches_per_step(torch, server, t, stack):
    """K5's launches per vectorized step of stage t: the forward once per
    sLSTM layer run, once for a frozen layer (r shared: the cohorts fold
    into the rows), once per cohort group for a trainable one (each
    cohort's own r: ``predicted_slstm_launches``); the backward once per
    cohort group per trainable layer.  Empty for a model without sLSTM."""
    cfg = server.adapter.cfg
    per_period = sum(1 for k, _ in getattr(cfg, "pattern", ()) if k == "slstm")
    if not per_period:
        return {}
    (f0, f1), (b0, b1), (a0, a1) = server.adapter.plan.stage_ranges(t)
    B, S = stack.batches["inputs"]["tokens"].shape[2:4]
    H = cfg.num_heads
    groups = predicted_slstm_launches(
        torch, (B, S, H, cfg.d_model // H), stack.num_cohorts, False)
    frozen = (f1 - f0) * per_period
    trainable = (b1 - b0 + a1 - a0) * per_period
    return {"slstm_scan_fwd": frozen + trainable * groups,
            "slstm_scan_bwd": trainable * groups}


def vectorized_path(torch, kernels, np, make_server, name, periods=False):
    """Main path 6 on one model: its rounds through ``FLConfig(runtime=
    "vectorized")``, one per stage.  K1-K3 must launch exactly twice per
    vectorized local step, whatever the number of cohorts.  Each round's
    new trainable is held against the sequential runtime's round on the
    same params and stack at TOL of the largest update (the round bar);
    where the sequential round itself moves by more than TOL / 10 when
    its start params are scaled by 1 + 1e-7 (f32 rounding amplified over
    the round's steps), the bar is 10 times that movement, the rule
    ``step_check`` applies to a step.  The first step of each round is
    also held alone (``cohort_step_check``), and the rounds run again from
    the seed must repeat bit for bit.  With ``periods`` (the ViT, whose
    rounds and steps amplify f32 rounding past any useful bar) each period
    is also held under vmap against the cohorts run alone
    (``vmap_period_check``).  The sequential rounds are eager: a captured
    round gives their bits (the capture checks).  Reports s/round (from
    the repeat, which records nothing), the peak, and the idle share of
    one round: the first run's last, profiled."""
    from repro_torch.common.tree import tree_map
    from repro_torch.federated.runtime import SequentialRuntime

    t0 = time.perf_counter()

    def run(profile=None):
        """The server's rounds; with ``profile`` (a dict) each round's
        stack is recorded and the last round profiled."""
        server = make_server("vectorized")
        n = server.adapter.plan.num_stages
        seen = (_record_stacks(torch, server, n - 1, profile)
                if profile is not None else [])
        reset_all(kernels)
        rounds = run_rounds(torch, server, kernels, n,
                            quiet=profile is None)
        if profile is not None:
            del server.runtime.run_stacked
        return server, rounds, seen

    profile = {}
    server, rounds, seen = run(profile)
    counts = read_all(kernels)
    trained = [r for r in rounds if r["n_selected"] > 0]
    check(len(trained) == len(seen) == len(rounds) and profile,
          "a round trained no cohort")
    took = {"rounds": time.perf_counter() - t0}
    for r, (_, t, stack, _) in zip(trained, seen):
        r["vectorized_steps"] = stack.max_steps
        r["cohorts"] = stack.num_cohorts
        check(all(r["launches"][n] == 2 * stack.max_steps for n in STREAMING),
              f"round {r['round_idx']}: {r['launches']}, expected 2 per "
              f"vectorized step ({stack.max_steps} steps of "
              f"{stack.num_cohorts} cohorts)")
        want = slstm_launches_per_step(torch, server, t, stack)
        r["slstm_launches_per_step"] = want
        for n, per_step in want.items():
            check(r["launches"][n] == stack.max_steps * per_step,
                  f"round {r['round_idx']}: {r['launches']}, expected "
                  f"{stack.max_steps} vectorized steps x {per_step} "
                  f"launches of {n}")
    check(all(math.isfinite(r["mean_loss"]) for r in trained),
          "non-finite round loss")
    seq = SequentialRuntime(server.adapter, server.optimizer, server.hp,
                            server.device, capture=False)
    agree, failed, first_steps = [], [], 0.0
    for (params, t, stack, vec), r in zip(seen, trained):
        params = _on(server.device, params)
        new, _ = seq.run_stacked(params, t, stack)
        moved, _ = seq.run_stacked(tree_map(lambda p: p * (1 + 1e-7),
                                            params), t, stack)
        _, start = server.adapter.split_stage(params, t)
        diff = _update_rel(_on(server.device, vec), new, start)
        sens = _update_rel(moved, new, start)
        bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
        # the first-step check captures the cohort step: at full width it
        # needs the card's memory
        del new, moved, start
        gc.collect()
        torch.cuda.empty_cache()
        agree.append(diff)
        t1 = time.perf_counter()
        r.update(vs_sequential_rel=diff, sequential_eps_rel=sens,
                 round_bar=bar,
                 first_step=cohort_step_check(torch, np, server, params,
                                              t, stack))
        first_steps += time.perf_counter() - t1
        print(f"  round {r['round_idx']} (stage {t}): vectorized vs "
              f"sequential {diff:.2e} of the largest update; sequential at "
              f"params x (1 + 1e-7) {sens:.2e}; bar {bar:.1e}; first step "
              f"loss {r['first_step']['loss_rel']:.2e} (bar "
              f"{r['first_step']['bar_loss']:.1e}), "
              f"params {r['first_step']['params_rel']:.2e} (bar "
              f"{r['first_step']['bar']:.1e}), captured cohort step "
              + ("the bits of the eager one" if r["first_step"]
                 ["captured_bitwise"] else
                 f"DIFFERS from the eager one: {r['first_step']}"),
              flush=True)
        if diff > bar:
            failed.append(r["round_idx"])
    check(not failed, f"{name} rounds {failed}: vectorized vs sequential "
          f"beyond the round bar")
    took["first_steps"] = first_steps
    took["sequential"] = (time.perf_counter() - t0 - took["rounds"]
                          - first_steps)
    vperiods = (vmap_period_check(torch, server, seen[0][2]) if periods
                else None)
    del seq
    # the first run's params wait on the host: at full width two servers'
    # params and a round's stacks do not fit the card together
    first = _on("cpu", server.params)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    again, again_rounds, _ = run()
    repeats = _same_run(torch, rounds, first, again_rounds,
                        _on("cpu", again.params))
    check(repeats, f"{name}: the vectorized rounds do not repeat bit for bit")
    took["repeat"] = time.perf_counter() - t1
    # the repeat neither records its stacks (host copies of the params)
    # nor profiles: its seconds are the rounds'
    seconds = [r["seconds"] for r in again_rounds]
    print(f"  {name} vectorized: vs sequential <= {max(agree):.2e} of the "
          f"largest update; s/round (the repeat) "
          f"{[round(s_, 4) for s_ in seconds]}; phases (s) "
          f"{ {k: round(v, 1) for k, v in took.items()} }; one round "
          f"(the first run's last, its captures included): wall "
          f"{profile['wall_ms']:.1f} ms, busy {fmt_ms(profile['busy_ms'])}, "
          f"idle {profile['idle_share']}, {profile['device_ops']} device "
          f"ops; repeats bit for bit",
          flush=True)
    del again
    gc.collect()
    return {"rounds": rounds, "seconds": seconds, "profile": profile,
            "repeats": repeats, "vs_sequential_rel": agree,
            "period_check": vperiods, "phase_seconds": took}, counts


# --------------------------------------------------------------------------- #
# main path 7: the paper's Tables 1 and 2 (NeuLite and the nine baselines)
# --------------------------------------------------------------------------- #
TABLE_ROUNDS = 2
TABLE_SIZE = dict(width=1.0, image_size=32)
TABLE1_ARCHS = ("resnet18", "vgg11", "squeezenet")
STEP_CHECK_BATCH = 8       # rows of the baselines' card-vs-CPU step check


class _TableRecorder:
    """``hooks`` of ``table1_accuracy.run`` / ``table2_complexity.run``
    (and, through a lambda, of the figures' modules): for each method the
    kernels' launches over its rounds (snapshots at each hook, the next
    method's construction launching nothing), its true local steps (and a
    server's vectorized steps, its longest cohort's, per round) and its
    local losses (device tensors, read once at the end), and ``keep``'s
    runners."""

    def __init__(self, kernels, keep=()):
        self.kernels, self.keep = kernels, set(keep)
        self.order, self.snaps = [], []
        self.steps, self.losses, self.runners = {}, {}, {}
        self.vsteps = {}    # the longest cohort's steps: a vectorized round

    def __call__(self, arch, method, runner):
        key = (arch, method)
        self.order.append(key)
        self.snaps.append(read_all(self.kernels))
        steps, losses = self.steps.setdefault(key, []), \
            self.losses.setdefault(key, [])
        vsteps = self.vsteps.setdefault(key, [])
        if hasattr(runner, "runtime"):          # a NeuLite server
            run = runner.runtime.run_round

            def recorded(*a, **kw):
                out = run(*a, **kw)
                steps.append(sum(out.num_batches))
                vsteps.append(max(out.num_batches))
                losses.append(out.mean_loss)
                return out

            runner.runtime.run_round = recorded
        else:
            train = runner._train

            def recorded(*a, **kw):
                res = train(*a, **kw)
                steps.append(res.num_batches)
                losses.append(res.mean_loss)
                return res

            runner._train = recorded
        if arch in self.keep:
            self.runners[key] = runner

    def launches(self):
        """{(arch, method): launches over its rounds}."""
        snaps = self.snaps + [read_all(self.kernels)]
        return {key: {n: b[n] - a[n] for n in a}
                for key, a, b in zip(self.order, snaps, snaps[1:])}

    def finite(self, torch):
        """Every local loss of every method finite (one read per method;
        a NeuLite round with no one selected reports NaN by design)."""
        bad = []
        for key, ls in self.losses.items():
            if ls and not bool(torch.isfinite(torch.stack(
                    [x.reshape(()).float() for x in ls])).all()):
                bad.append(key)
        return bad

    def release(self):
        for runner in self.runners.values():
            for name in ("run_round", "_train"):
                for obj in (runner, getattr(runner, "runtime", None)):
                    if obj is not None and name in vars(obj):
                        delattr(obj, name)
        self.runners.clear()


def _state_of(runner):
    """What a method's rounds move: its params (and a depth method's
    heads)."""
    return {"params": runner.params, "heads": getattr(runner, "heads", None)}


def _cpu_tree(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def baseline_step_check(torch, runners, batcher):
    """Each distinct baseline step once on the card against the same step
    on the CPU, from the same params and batch (TF32 off): the full model
    (FedAvg), AllSmall's width, each HeteroFL ratio present, each DepthFL
    level and ProgFed's stage-0 bundle.  Bar: TOL / 10 (1e-4), or 10x the
    CPU step's own movement at params x (1 + 1e-7) where that is larger."""
    from repro_torch.common.device import to_device
    from repro_torch.common.tree import tree_map
    from repro_torch.federated.baselines import _extract_submodel
    host = batcher.sample(STEP_CHECK_BATCH)
    cpu = torch.device("cpu")
    steps = [("fedavg full model", runners["fedavg"].full_step(),
              runners["fedavg"].params, runners["fedavg"].optimizer),
             ("allsmall", runners["allsmall"].full_step(),
              runners["allsmall"].params, runners["allsmall"].optimizer)]
    het = runners["heterofl"]
    for ratio in sorted(set(het.client_ratio.values())):
        sub, _ = _extract_submodel(het.params, ratio, 0, het.ccfg.num_classes,
                                   het.ccfg.in_channels)
        steps.append((f"heterofl ratio {ratio}", het.full_step(), sub,
                      het.optimizer))
    dfl = runners["depthfl"]
    for lvl, end in enumerate(dfl.depth_ends):
        steps.append((f"depthfl level {lvl}", dfl._step(lvl),
                      {"units": dfl.params["units"][:end],
                       "head": dfl.heads[lvl]}, dfl.optimizer))
    pfl = runners["progfed"]
    steps.append(("progfed stage 0", pfl._step(0),
                  {"units": pfl.params["units"][:pfl.depth_ends[0]],
                   "head": pfl.heads[0]}, pfl.optimizer))
    out = []
    for name, step, params, opt in steps:
        def one(p, device):
            return step(opt.init(p), p, to_device(host, device))[1:]

        card = one(params, params_device(params))
        p_cpu = _cpu_tree(params)
        plain = one(p_cpu, cpu)
        moved = one(tree_map(lambda p: p * (1 + 1e-7), p_cpu), cpu)
        loss_rel, params_rel = _step_diff(
            (_cpu_tree(card[0]), {"loss": card[1]["loss"].cpu()}), plain)
        s_loss, s_params = _step_diff(moved, plain)
        bar_loss = max(TOL / 10, 10 * s_loss)
        bar_params = max(TOL / 10, 10 * s_params)
        row = dict(step=name, loss=float(card[1]["loss"]),
                   cpu_loss=float(plain[1]["loss"]), loss_rel=loss_rel,
                   params_rel=params_rel, cpu_eps_loss_rel=s_loss,
                   cpu_eps_params_rel=s_params, bar_loss=bar_loss,
                   bar_params=bar_params)
        print(f"  {name}: card vs CPU loss rel {loss_rel:.2e}, params rel "
              f"{params_rel:.2e} (CPU at params x (1 + 1e-7): "
              f"{s_loss:.2e}, {s_params:.2e}; bars {bar_loss:.1e}, "
              f"{bar_params:.1e})", flush=True)
        check(loss_rel <= bar_loss and params_rel <= bar_params,
              f"baseline step, card vs CPU: {row}")
        out.append(row)
    return out


def params_device(tree):
    return _leaves(tree)[0].device


def numpy_scatter_mean(params, subs):
    """The reference's HeteroFL aggregation (``baselines.py``,
    ``HeteroFL.round``) in numpy float64 with ``np.add.at``, on trees in
    the reference's layout: ``subs`` holds (sub-tree, maps) with the
    reference's axes."""
    import numpy as np

    from repro_torch.common.tree import flatten_paths, map_with_path
    flat = flatten_paths(params)
    sums = {p: np.zeros_like(v, np.float64) for p, v in flat.items()}
    counts = {p: np.zeros(v.shape, np.float64) for p, v in flat.items()}
    for sub, maps in subs:
        for p, leaf in flatten_paths(sub).items():
            arr = np.asarray(leaf, np.float64)
            idxs = maps[p]
            if idxs:
                full_ix = [slice(None)] * sums[p].ndim
                k = len(idxs)
                for j, (ax, m) in enumerate(idxs):
                    shape = [1] * k
                    shape[j] = len(m)
                    full_ix[ax] = m.reshape(shape)
                np.add.at(sums[p], tuple(full_ix), arr)
                np.add.at(counts[p], tuple(full_ix), 1.0)
            else:
                sums[p] += arr
                counts[p] += 1.0
    return map_with_path(lambda p, v: np.where(
        counts[p] > 0, sums[p] / np.maximum(counts[p], 1),
        np.asarray(v, np.float64)).astype(v.dtype), params)


def scatter_check(torch, runner, r):
    """``runner``'s (HeteroFL's or FedRolex's) round-r aggregation on the
    card, on client trees trained on the card, against
    ``numpy_scatter_mean`` of the same trees in the reference's layout, at
    1e-6 relative."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.common.tree import flatten_paths
    from repro_torch.federated.baselines import (WidthScatterMean,
                                                 _extract_submodel)
    # the port's OIHW conv axes -> the reference's HWIO ones
    conv_axes = {1: 2, 0: 3}
    cands = runner.candidates(r)
    cohort = [int(c) for c in np.random.default_rng(r).choice(
        cands, size=min(5, len(cands)), replace=False)]
    acc = WidthScatterMean(runner.params)
    subs = []
    for cid in cohort:
        ratio = runner.client_ratio[cid]
        sub, maps = _extract_submodel(runner.params, ratio, runner._offset(r),
                                      runner.ccfg.num_classes,
                                      runner.ccfg.in_channels)
        res = runner._train(runner.full_step(), sub, cid)
        acc.add(res.trainable, maps)
        flat = flatten_paths(sub)
        ref_maps = {p: tuple((conv_axes[ax] if flat[p].ndim == 4 else ax, m)
                             for ax, m in idxs) for p, idxs in maps.items()}
        subs.append((bridge.to_reference(res.trainable), ref_maps))
    got = bridge.to_reference(acc.result())
    want = numpy_scatter_mean(bridge.to_reference(runner.params), subs)
    from repro_torch.common.tree import tree_leaves
    scale = max(float(np.abs(w).max()) for w in tree_leaves(want))
    err = max(float(np.abs(np.asarray(g, np.float64) - w).max())
              for g, w in zip(tree_leaves(got), tree_leaves(want)))
    rel = err / scale
    ratios = sorted({runner.client_ratio[c] for c in cohort})
    print(f"  {runner.name} round {r} aggregation on the card vs numpy "
          f"np.add.at (float64): rel {rel:.2e}, cohort {cohort}, ratios "
          f"{ratios}", flush=True)
    check(rel <= 1e-6, f"{runner.name} scatter-average: rel {rel}")
    return {"method": runner.name, "round": r, "cohort": cohort,
            "ratios": ratios, "rel": rel}


def tables_path(torch, kernels, np):
    """Main path 7: ``table1_accuracy.run`` (NeuLite and the nine baselines
    on ResNet18, VGG11 and SqueezeNet) and ``table2_complexity.run``
    (ResNet18, then ResNet34 on ResNet18's fleet) at full width, 32x32x3,
    10 classes, the reference's fleet (20 clients, 5 a round, E = 1,
    B = 32, 4 stages), TABLE_ROUNDS rounds a method."""
    from repro_torch.benchmarks import table1_accuracy, table2_complexity
    from repro_torch.common.tree import tree_leaves
    out = {}
    rec = _TableRecorder(kernels, keep=("resnet18",))
    reset_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen:
        t1 = table1_accuracy.run(rounds=TABLE_ROUNDS, archs=TABLE1_ARCHS,
                                 device="cuda", out_path=TABLE1_OUT,
                                 hooks=rec, quiet=True, **TABLE_SIZE)
    t1_s = time.perf_counter() - t0
    counts = read_all(kernels)
    per = rec.launches()
    print(f"  Table 1 in {t1_s:.1f} s; rows written to "
          f"{os.path.relpath(TABLE1_OUT, ROOT)}", flush=True)
    for (arch, m), row in t1.items():
        steps = sum(rec.steps[(arch, m)])
        k = {n: per[(arch, m)][n] for n in STREAMING}
        print(f"  {arch:10s} {m:12s} acc {row['acc']:.4f}  participation "
              f"{row['pr']:.3f}  {row['time_s']:.2f} s  {steps} local steps"
              f"  K1-K3 {sorted(set(k.values()))}", flush=True)
        check(math.isfinite(row["acc"]) and 0.0 <= row["acc"] <= 1.0,
              f"table 1 {arch} {m}: bad accuracy {row['acc']}")
        if m == "neulite":
            # a fleet may have no device for a stage (n_feasible 0)
            check(set(k.values()) == {2 * steps},
                  f"table 1 {arch} NeuLite: expected 2 launches of each "
                  f"nHSIC kernel per local step ({steps}): {k}")
        else:
            check(set(k.values()) == {0},
                  f"table 1 {arch} {m}: an nHSIC kernel ran in a baseline "
                  f"round: {k}")
    check(sum(rec.steps[("resnet18", "neulite")]) > 0,
          "table 1: NeuLite took no local step on ResNet18")
    bad = rec.finite(torch)
    check(not bad, f"non-finite local losses in {bad}")
    first = {m: _cpu_tree(_state_of(r))
             for (a, m), r in rec.runners.items()}
    runners = {m: r for (a, m), r in rec.runners.items()}

    phase("main path 7: the baselines' steps, card against CPU")
    from repro_torch.benchmarks.common import make_fl_setup
    clients, _ = make_fl_setup(0, image_size=TABLE_SIZE["image_size"])
    from repro_torch.data.loader import Batcher
    out["baseline_steps"] = baseline_step_check(
        torch, runners, Batcher(clients[0], STEP_CHECK_BATCH, seed=SEED))
    phase("main path 7: HeteroFL's and FedRolex's scatter-average")
    out["scatter"] = [scatter_check(torch, runners["heterofl"], 0),
                      scatter_check(torch, runners["fedrolex"], 1)]
    rec.release()
    del runners

    phase("main path 7: ResNet18's ten methods again from the seed")
    again = _TableRecorder(kernels, keep=("resnet18",))
    t1b = table1_accuracy.run(rounds=TABLE_ROUNDS, archs=("resnet18",),
                              device="cuda", out_path=TABLE1_REPEAT_OUT,
                              hooks=again, quiet=True, **TABLE_SIZE)
    differ = [m for (a, m), r in again.runners.items()
              if not all(torch.equal(x.cpu(), y) for x, y in zip(
                  tree_leaves(_state_of(r)), tree_leaves(first[m])))
              or repr(t1b[(a, m)]["acc"]) != repr(t1[(a, m)]["acc"])]
    again.release()
    print(f"  params and accuracies {'identical' if not differ else 'DIFFER'}"
          f" ({len(first)} methods){': ' + str(differ) if differ else ''}",
          flush=True)
    check(not differ, f"ResNet18's Table 1 methods do not repeat bit for "
          f"bit: {differ}")
    del first

    phase("main path 7: Table 2")
    rec2 = _TableRecorder(kernels)
    before_t2 = read_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen2:
        t2 = table2_complexity.run(rounds=TABLE_ROUNDS, device="cuda",
                                   out_path=TABLE2_OUT, hooks=rec2,
                                   quiet=True, **TABLE_SIZE)
    t2_s = time.perf_counter() - t0
    per2 = rec2.launches()
    for arch, row in t2.items():
        steps = sum(rec2.steps[(arch, "neulite")])
        k = {n: per2[(arch, "neulite")][n] for n in STREAMING}
        print(f"  {arch}: NeuLite acc {row['neulite_acc']:.4f}, "
              f"participation {row['neulite_pr']:.3f}, full-model-feasible "
              f"devices {row['full_model_feasible_devices']}, "
              f"{row['time_s']:.2f} s, {steps} local steps, K1-K3 "
              f"{sorted(set(k.values()))}", flush=True)
        check(steps > 0 and set(k.values()) == {2 * steps},
              f"table 2 {arch}: expected 2 launches of each nHSIC kernel "
              f"per local step ({steps}): {k}")
        check(math.isfinite(row["neulite_acc"]),
              f"table 2 {arch}: bad accuracy")
    check(not rec2.finite(torch), "non-finite local losses in table 2")
    check_held(seen | seen2, "Tables 1 and 2")
    check(t2["resnet34"]["neulite_pr"] > 0,
          f"table 2: ResNet34 on ResNet18's budgets left NeuLite no "
          f"device: {t2['resnet34']}")
    end = read_all(kernels)
    t2_counts = {n: end[n] - before_t2[n] for n in end}
    counts = {n: counts[n] + t2_counts[n] for n in counts}
    out.update(table1={f"{a}|{m}": v for (a, m), v in t1.items()},
               table1_seconds=t1_s, table2=t2, table2_seconds=t2_s,
               launches_by_method={f"{a}|{m}": v for (a, m), v in
                                   per.items()})
    return out, counts


def fig7_phase(torch, kernels):
    """Paper Fig. 7 on the card: ``fig7_time.run`` on ResNet18 and VGG11
    at the reference's sizes (width 0.5, 16x16, B = 32) and at full width
    (32x32), the captured and the eager step, each stage against the full
    step.  No gate: the speedups are printed beside the paper's.  Every
    shape nHSIC takes here must have been held against the plain version
    in the kernel phase (``fig7_nhsic_shapes``)."""
    from repro_torch.benchmarks import fig7_time
    reset_all(kernels)
    with nhsic_shapes_seen() as seen:
        rows = fig7_time.run(archs=FIG7_ARCHS, batch=FIG7_BATCH,
                             device="cuda", sizes=FIG7_SIZES,
                             out_path=FIG7_OUT, quiet=True)
    counts = read_all(kernels)
    for label, archs in rows.items():
        for arch, row in archs.items():
            for kind, r in row.items():
                sp = r["speedups"]
                check(all(math.isfinite(x) and x > 0 for x in sp),
                      f"fig7 {label} {arch} {kind}: {r}")
                print(f"  {label} {arch:8s} {kind:8s} full {r['full_ms']:.3f}"
                      f" ms, stages {[round(s, 3) for s in r['stage_ms']]} "
                      f"ms, speedup {min(sp):.2f}-{max(sp):.2f}x (paper "
                      f"{fig7_time.PAPER_SPEEDUP[0]}-"
                      f"{fig7_time.PAPER_SPEEDUP[1]}x)", flush=True)
    check(all(counts[n] > 0 for n in STREAMING),
          f"an nHSIC kernel never ran in the Fig. 7 phase: {counts}")
    check_held(seen, "the Fig. 7 phase")
    print(f"  launches {counts}; rows written to "
          f"{os.path.relpath(FIG7_OUT, ROOT)}", flush=True)
    return rows, counts


# --------------------------------------------------------------------------- #
# main path 8: kill and resume (the checkpoint store, save_state, restore)
# --------------------------------------------------------------------------- #
def card_settings(torch):
    """TF32 off for products and convs: every process of the run the
    same, so that their rounds give the same bits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resume_child(directory):
    """Main path 8's killed run, in its own process: main path 1's server
    checkpointing every RESUME_EVERY rounds into ``directory``, killed by
    SIGKILL as its third round opens.  Loads the kernels the parent built;
    never builds them."""
    import signal

    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import library_path
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.hsic_gram import kernel
    from repro_torch.kernels.slstm_scan import kernel as skernel
    card_settings(torch)
    for k in (kernel, fkernel, skernel):
        if not library_path(k.SOURCE).exists():
            print(f"resume child: {k.SOURCE} is not built", file=sys.stderr)
            return 3
        k.library()
    server = cnn_server(np, quiet=True, checkpoint_dir=directory,
                        checkpoint_every=RESUME_EVERY)
    run_round = server.run_round

    def crashing(r):
        if r == RESUME_EVERY:
            os.kill(os.getpid(), signal.SIGKILL)
        return run_round(r)

    server.run_round = crashing
    server.run(RESUME_ROUNDS)
    return 4        # not reached: the kill comes first


def _same_history(a, b):
    """Two round histories equal field by field (NaN equal to NaN)."""
    def same(x, y):
        return x == y or (isinstance(x, float) and isinstance(y, float)
                          and math.isnan(x) and math.isnan(y))
    return len(a) == len(b) and all(
        all(same(v, dataclasses.asdict(hb)[k])
            for k, v in dataclasses.asdict(ha).items())
        for ha, hb in zip(a, b))


def _npz_equal(np, a, b):
    """Two checkpoints' arrays equal to the bit, and their sidecars equal."""
    with np.load(a) as x, np.load(b) as y:
        arrays = (sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x.files))
    with open(a + ".json") as f, open(b + ".json") as g:
        return arrays and json.load(f) == json.load(g)


def resume_path(torch, kernels, np):
    """Main path 8: main path 1's ResNet18 (full width, 32x32, 4 of 100
    clients, nHSIC through K1-K3) runs 4 rounds checkpointing every 2, in
    three parts: a child process (``resume_child``) is killed by SIGKILL
    after its round-2 checkpoint; this process restores it
    (``NeuLiteServer.restore``) and runs rounds 2-3; and runs the 4
    rounds straight.  The resumed params, history, RNG and selector state
    must equal the straight run's to the bit, the child's checkpoint the
    straight run's round-2 checkpoint, and K1-K3 launch twice per local
    step of the resumed rounds.  The checkpoint read on the CPU must give
    the bits of ``to_reference`` of the card's params.  Everything lands
    in a temporary directory, deleted at the end."""
    import signal
    import subprocess
    import tempfile

    from repro_torch import bridge
    from repro_torch.checkpoint import (checkpoint_step, latest_checkpoint,
                                        load_checkpoint)
    from repro_torch.common.tree import tree_leaves
    from repro_torch.federated.server import NeuLiteServer
    out = {}
    with tempfile.TemporaryDirectory(prefix="neulite-resume-") as tmp:
        killed = os.path.join(tmp, "killed")
        straight_dir = os.path.join(tmp, "straight")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.realpath(__file__), "--resume-child",
             killed], capture_output=True, text=True, timeout=600)
        out["child_seconds"] = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL,
              f"the resume child ended with {child.returncode}, not "
              f"SIGKILL:\n{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
        path = latest_checkpoint(killed)
        check(path is not None and checkpoint_step(path) == RESUME_EVERY,
              f"the killed run left no round-{RESUME_EVERY} checkpoint: "
              f"{os.listdir(killed) if os.path.isdir(killed) else None}")
        out["checkpoint_bytes"] = (os.path.getsize(path)
                                   + os.path.getsize(path + ".json"))
        print(f"  child killed by SIGKILL after {out['child_seconds']:.1f} s;"
              f" its checkpoint {os.path.basename(path)}: "
              f"{out['checkpoint_bytes']} bytes", flush=True)

        straight = cnn_server(np, quiet=True, checkpoint_dir=straight_dir,
                              checkpoint_every=RESUME_EVERY)
        save_s, save = [], straight.save_state

        def timed_save(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            written = save(*a, **kw)
            save_s.append(time.perf_counter() - t1)
            return written

        straight.save_state = timed_save
        reset_all(kernels)
        straight.run(RESUME_ROUNDS)
        torch.cuda.synchronize()
        counts = read_all(kernels)
        del straight.save_state
        out["save_state_seconds"] = save_s
        check(len(save_s) == RESUME_ROUNDS // RESUME_EVERY,
              f"run() saved {len(save_s)} times, not every "
              f"{RESUME_EVERY} rounds")
        same_file = _npz_equal(
            np, path, os.path.join(straight_dir,
                                   os.path.basename(path)))
        out["child_checkpoint_is_straight_runs"] = same_file
        check(same_file, "the killed child's round-2 checkpoint differs "
              "from the straight run's")

        adapter, clients, flc, test = cnn_setup(
            checkpoint_dir=killed, checkpoint_every=RESUME_EVERY)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        resumed = NeuLiteServer.restore(adapter, clients, flc, killed,
                                        test_batcher=test)
        torch.cuda.synchronize()
        out["restore_seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        resumed.load_state(path)
        torch.cuda.synchronize()
        out["load_state_seconds"] = time.perf_counter() - t1
        check(resumed.next_round == RESUME_EVERY,
              f"resumed at round {resumed.next_round}")
        steps = record_steps(resumed)
        reset_all(kernels)
        resumed.run(RESUME_ROUNDS - RESUME_EVERY)
        torch.cuda.synchronize()
        rcounts = read_all(kernels)
        del resumed.runtime.run_round
        n_steps = sum(steps)
        out.update(resumed_local_steps=n_steps, resumed_launches=rcounts,
                   straight_launches=counts)
        check(n_steps > 0 and all(rcounts[n] == 2 * n_steps
                                  for n in STREAMING),
              f"resumed rounds: expected 2 launches of each nHSIC kernel "
              f"per local step ({n_steps}): {rcounts}")
        same = {
            "params": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(straight.params), tree_leaves(resumed.params),
                strict=True)),
            "history": _same_history(straight.history, resumed.history),
            "rng": (straight.rng.bit_generator.state
                    == resumed.rng.bit_generator.state),
            "selector": (straight.selector.state_dict()
                         == resumed.selector.state_dict()),
            "batchers": all(
                a.rng.bit_generator.state == b.rng.bit_generator.state
                for a, b in zip(straight.batchers + [straight.test_batcher],
                                resumed.batchers + [resumed.test_batcher]))}
        out["resumed_equals_straight"] = same
        print(f"  save_state {[round(x, 3) for x in save_s]} s, restore "
              f"{out['restore_seconds']:.3f} s (load_state alone "
              f"{out['load_state_seconds']:.3f} s); resumed rounds "
              f"{RESUME_EVERY}-{RESUME_ROUNDS - 1}: {n_steps} local steps, "
              f"launches {rcounts}; resumed vs straight: {same}", flush=True)
        check(all(same.values()), f"the resumed run differs from the "
              f"straight run: {same}")
        for h in resumed.history:
            print(f"  round {h.round_idx}: {h}", flush=True)

        last = latest_checkpoint(straight_dir)
        cpu, _ = load_checkpoint(last, {"params": straight.params},
                                 device="cpu")
        card = bridge.to_reference(straight.params)
        cpu_bits = all(
            torch.equal(a, torch.from_numpy(b)) for a, b in zip(
                tree_leaves(cpu["params"]), tree_leaves(card), strict=True))
        out["cpu_load_is_card_bits"] = cpu_bits
        check(cpu_bits, "the checkpoint read on the CPU differs from "
              "to_reference of the card's params")
        print(f"  {os.path.basename(last)} read on the CPU: the bits of "
              f"to_reference of the card's params", flush=True)
        del straight, resumed
    gc.collect()
    torch.cuda.empty_cache()
    out["directory_removed"] = not os.path.exists(tmp)
    check(out["directory_removed"], f"{tmp} was not removed")
    return out, {n: counts[n] + rcounts[n] for n in counts}


# --------------------------------------------------------------------------- #
# the paper's Fig. 2, 5 and 8 and the quickstart
# --------------------------------------------------------------------------- #
def fig2_phase(torch, kernels):
    """``fig2_hsic_plane.run`` at FIG2_SIZES: E2E, naive PT and NeuLite-CA
    (K1-K3 twice a step, in NeuLite-CA only), the probes plain.  Prints
    each trace's first and last point and whether the paper's ordering
    holds (naive PT ends below E2E in nHSIC(X;Z), and CA reaches E2E): a
    finding, not a gate, as in the reference."""
    from repro_torch.benchmarks import fig2_hsic_plane
    out = {}
    reset_all(kernels)
    with nhsic_shapes_seen() as seen:
        for width, size in FIG2_SIZES:
            before = read_all(kernels)
            traces = fig2_hsic_plane.run(
                steps=FIG2_STEPS, quiet=True, device="cuda", width=width,
                image_size=size, out_path=os.path.join(
                    ROOT, "chiprun_out", f"fig2_w{width}_{size}.json"))
            after = read_all(kernels)
            k = {n: after[n] - before[n] for n in after}
            check(all(k[n] == 2 * FIG2_STEPS for n in STREAMING),
                  f"fig2 {width}, {size}: expected 2 launches of each nHSIC "
                  f"kernel per NeuLite-CA step ({FIG2_STEPS}): {k}")
            check(all(math.isfinite(v) for t in traces.values()
                      for p in t for v in p), f"fig2: non-finite {traces}")
            xz = {m: t[-1][0] for m, t in traces.items()}
            order = {"pt_below_e2e": xz["pt_naive"] < xz["e2e"],
                     "ca_reaches_e2e": xz["neulite_ca"] >= xz["e2e"]}
            label = f"width {width}, {size}x{size}"
            out[label] = {"traces": traces, "ordering": order,
                          "launches": k}
            for m, t in traces.items():
                print(f"  {label} {m:10s} (nHSIC(X;Z), nHSIC(Y;Z)) "
                      f"{t[0][0]:.4f}, {t[0][1]:.4f} -> {t[-1][0]:.4f}, "
                      f"{t[-1][1]:.4f}", flush=True)
            print(f"  {label}: naive PT ends below E2E in nHSIC(X;Z): "
                  f"{order['pt_below_e2e']}; CA reaches E2E: "
                  f"{order['ca_reaches_e2e']}", flush=True)
    check_held(seen, "the Fig. 2 phase")
    return out, read_all(kernels)


def _launches_check(rec, name, per_step, steps_of="steps", **extra):
    """``rec``'s launches for ``name``: K1-K3 ``per_step`` times its local
    (or vectorized) steps, ``extra`` kernels exactly as given."""
    key = ("fig", name)
    steps = sum(getattr(rec, steps_of)[key])
    got = rec.launches()[key]
    want = {n: per_step * steps for n in STREAMING}
    want.update(extra)
    check(all(got[n] == c for n, c in want.items()),
          f"{name}: launches {got}, expected {want} ({steps} {steps_of})")
    return {"launches": got, steps_of: steps}


def fig5_phase(torch, kernels):
    """``fig5_scale_vit`` on the card: 5a (ResNet18 at full width, 62
    classes, FIG5_SCALES, sequential) and 5b (ViT-12's widths at 32x32,
    C = 4, vectorized), FIG5_ROUNDS rounds each.  K1-K3 twice a local step
    in 5a, twice a vectorized step in 5b; K4 once an attention layer run
    per vectorized step (the cohorts folded into its batch) and per
    evaluation batch; every nHSIC and K4 shape held."""
    from repro_torch.benchmarks import fig5_scale_vit
    rec = _TableRecorder(kernels, keep=("fig",))
    hooks = lambda name, srv: rec("fig", name, srv)   # noqa: E731
    reset_all(kernels)
    out = {}
    with nhsic_shapes_seen() as seen, flash_shapes_seen() as fseen:
        t0 = time.perf_counter()
        out["scale"] = fig5_scale_vit.run_scale(
            FIG5_SCALES, FIG5_ROUNDS, True, "cuda", hooks=hooks, **FIG5_SIZE)
        out["scale_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["vit_acc"] = fig5_scale_vit.run_vit(
            FIG5_ROUNDS, True, "cuda", hooks=hooks, **FIG5_VIT)
        out["vit_seconds"] = time.perf_counter() - t0
    for n in FIG5_SCALES:
        out[f"scale {n}"] = _launches_check(rec, f"scale {n}", 2,
                                            flash_attention_fwd=0)
        print(f"  5a scale {n}: acc {out['scale'][n]:.4f}, "
              f"{out[f'scale {n}']}", flush=True)
    srv = rec.runners[("fig", "vit")]
    plan, L = srv.adapter.plan, srv.adapter.cfg.num_layers
    evals = min(8, srv.test_batcher.steps_per_epoch)
    vsteps = rec.vsteps[("fig", "vit")]
    flash = (sum(e * plan.bounds[h.stage][1] for e, h in
                 zip(vsteps, [h for h in srv.history if h.n_selected]))
             + len(srv.history) * evals * L)
    out["vit"] = _launches_check(rec, "vit", 2, "vsteps",
                                 flash_attention_fwd=flash)
    rec.release()
    print(f"  5b ViT ({L} layers, d_model {srv.adapter.cfg.d_model}, C = "
          f"{srv.flc.clients_per_round}): acc {out['vit_acc']:.4f}, "
          f"{out['vit']} (K4: the vectorized steps x the layers run, and "
          f"{evals} evaluation batches x {L} a round); 5a "
          f"{out['scale_seconds']:.1f} s, 5b {out['vit_seconds']:.1f} s",
          flush=True)
    for key, ls in rec.losses.items():
        check(ls and bool(torch.isfinite(torch.stack(
            [x.reshape(()).float() for x in ls])).all()),
              f"fig5 {key}: non-finite local losses")
    del srv
    check_held(seen, "the Fig. 5 phase")
    check_flash_held(fseen, "the Fig. 5 phase")
    return out, read_all(kernels)


def fig8_phase(torch, kernels):
    """``fig8_ablation.run`` on the card at FIG8_SIZE, FIG8_ROUNDS rounds
    (one a stage): K1-K3 twice a local step in NeuLite and w/o PC, never
    in w/o CA and FedAvg."""
    from repro_torch.benchmarks import fig8_ablation
    rec = _TableRecorder(kernels)
    reset_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen:
        accs = fig8_ablation.run(
            rounds=FIG8_ROUNDS, quiet=True, device="cuda",
            out_path=os.path.join(ROOT, "chiprun_out", "fig8_ablation.json"),
            hooks=lambda name, runner: rec("fig", name, runner), **FIG8_SIZE)
    out = {"acc": accs, "seconds": time.perf_counter() - t0}
    for name in accs:
        curriculum = name in ("neulite", "wo_pc")
        out[name] = _launches_check(rec, name, 2 if curriculum else 0,
                                    flash_attention_fwd=0)
        check(math.isfinite(accs[name]) and 0.0 <= accs[name] <= 1.0,
              f"fig8 {name}: bad accuracy {accs[name]}")
        print(f"  {name:8s} acc {accs[name]:.4f}, {out[name]}", flush=True)
    check(not rec.finite(torch), "fig8: non-finite local losses")
    rec.release()
    check_held(seen, "the Fig. 8 phase")
    print(f"  Fig. 8 in {out['seconds']:.1f} s", flush=True)
    return out, read_all(kernels)


def quickstart_phase(torch, kernels):
    """``examples/quickstart.py``'s ``main`` on the card at its own size:
    K1-K3 twice a step (the progressive loop's, the sequential runtime's
    cohort steps, and twice a vectorized step), K4 once an attention layer
    run per step (per vectorized step, its cohorts folded)."""
    from repro_torch.examples import quickstart
    from repro_torch.core.progressive import make_adapter
    reset_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen, flash_shapes_seen() as fseen, \
            contextlib.redirect_stdout(sys.stderr):
        res = quickstart.main(device="cuda")
    seconds = time.perf_counter() - t0
    counts = read_all(kernels)
    plan = make_adapter(quickstart.config(), quickstart.NUM_STAGES).plan
    # the loop: 4 steps a round; each runtime twice (a warm-up, then the
    # timed round) at stage 0, 2 steps of each of the 4 cohorts
    loop_steps = 4 * len(res["rounds"])
    cohort_steps, vec_steps = 2 * 4 * 2, 2 * 2
    layers = sum(4 * plan.bounds[t][1] for t, *_ in res["rounds"]) \
        + (cohort_steps + vec_steps) * plan.bounds[0][1]
    want = {n: 2 * (loop_steps + cohort_steps + vec_steps) for n in STREAMING}
    want["flash_attention_fwd"] = layers
    check(all(counts[n] == c for n, c in want.items()),
          f"quickstart: launches {counts}, expected {want}")
    vals = [v for r in res["rounds"] for v in r[1:]] + [
        loss for loss, _ in res["runtimes"].values()]
    check(all(math.isfinite(v) for v in vals), f"quickstart: {res}")
    seq, vec = (res["runtimes"][k][0] for k in ("sequential", "vectorized"))
    check(abs(seq - vec) <= TOL * abs(seq),
          f"quickstart: sequential {seq} against vectorized {vec}")
    print(f"  {res['memory_line']}; round 0 {res['rounds'][0]}, round 15 "
          f"{res['rounds'][-1]}; runtimes {res['runtimes']}; launches "
          f"{counts}; {seconds:.1f} s", flush=True)
    check_held(seen, "the quickstart")
    check_flash_held(fseen, "the quickstart")
    return dict(res, seconds=seconds, launches=counts), counts


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
    card_settings(torch)
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
    berrs, batched = batched_phase(torch, kernel, ref, hsic, fkernel, fref)
    serrs, sbatched = batched_slstm_phase(torch, skernel, sref)
    batched.update(sbatched)
    for n, (ab, rel) in [*berrs.items(), *serrs.items()]:
        track(errs, n, rel, ab)
    timing = timing_phase(torch, kernel, ref, hsic)
    timing += flash_timing(torch, fkernel, fref)
    timing += slstm_timing(torch, skernel, sops, sref)
    timing += gram_timing(torch, kernel, ref, hsic)
    batched["timing"] = batched_timing(torch, kernel, ref, hsic)
    batched["timing"] += batched_slstm_timing(torch, skernel, sref)

    phase("main path 1: ResNet18")
    server, rounds, counts = main_path(torch, kernels, np)
    phase("determinism of main path 1")
    determinism = determinism_phase(torch, kernels, np, rounds,
                                    server.params)
    phase("step check")
    steps = step_check(torch, server)
    phase("captured step against the eager step")
    captures = {"resnet18": capture_check(torch, server)}
    phase("step profile")
    profiles = step_profile(torch, server)
    del server

    phase("main path 8: ResNet18 killed after round 2 and resumed")
    resume, rescounts = resume_path(torch, kernels, np)

    phase("main path 2: ViT-12")
    vserver, vrounds, vcounts, vacc = vit_main_path(torch, kernels, np)
    phase("step check")
    plain = make_adapter(dataclasses.replace(vserver.adapter.cfg,
                                             use_flash_kernel=False),
                         vserver.adapter.plan.num_stages)
    vsteps = step_check(torch, vserver, plain, sensitivity=True)
    phase("captured step against the eager step")
    captures["vit12"] = capture_check(torch, vserver)
    phase("period check")
    vperiods = period_check(torch, vserver, plain)
    phase("step profile")
    vprofiles = step_profile(torch, vserver)
    del vserver

    phase("main path 3: xlstm-1.3b")
    xserver, xstart, xrounds, xcounts, xacc = xlstm_main_path(torch,
                                                              kernels, np)
    phase("step check")
    plain = make_adapter(dataclasses.replace(xserver.adapter.cfg,
                                             use_slstm_kernel=False),
                         xserver.adapter.plan.num_stages)
    xsteps = step_check(torch, xserver, plain, sensitivity=True)
    phase("sLSTM layer check")
    xlayers = slstm_layer_check(torch, xserver, plain)
    phase("captured step against the eager step")
    captures["xlstm"] = capture_check(torch, xserver)
    phase("step profile")
    xprofiles = step_profile(torch, xserver, steps=1)
    del xserver
    phase("F2: main path 3's rounds against eager rounds")
    f2 = f2_phase(torch, kernels, xrounds, xstart)
    del xstart

    phase("main path 4: kernel benchmark")
    bench_rows, bcounts = bench_path(torch, kernels)

    zoo = {}
    for spec in ZOO:
        arch = spec["arch"]
        phase(f"main path 5: {arch}")
        zserver, zrounds, zcounts = main_path(torch, kernels, np, spec)
        phase("step check")
        zsteps = step_check(torch, zserver, sensitivity=True)
        phase("captured step against the eager step")
        captures[arch] = capture_check(torch, zserver)
        phase("step profile")
        zprofiles = step_profile(torch, zserver)
        zoo[arch] = {"rounds": zrounds, "launches": zcounts,
                     "step_check": zsteps, "step_profile": zprofiles}
        del zserver

    vec = {}
    for name, make in (("resnet18", lambda rt: cnn_server(np, quiet=True,
                                                           runtime=rt)),
                       ("vit12", lambda rt: vit_server(rt)[0]),
                       ("xlstm-smoke", lambda rt: xlstm_vec_server("smoke",
                                                                   rt)),
                       ("xlstm-full", lambda rt: xlstm_vec_server("full",
                                                                  rt))):
        phase(f"main path 6: vectorized rounds of {name}")
        vec[name], vec_counts = vectorized_path(torch, kernels, np, make,
                                                name, name == "vit12")
        vec[name]["launches"] = vec_counts

    phase("round throughput (fl_round_throughput)")
    from repro_torch.benchmarks import fl_round_throughput
    reset_all(kernels)
    # the reference's sizes (the module's full-width rows take most of its
    # time; run it alone for them)
    throughput = fl_round_throughput.run(
        "cuda", BENCH_FL_OUT, iters=2,
        settings=[s for s in fl_round_throughput.SETTINGS
                  if s[1] == "reference"])
    tcounts = read_all(kernels)
    print(f"  rows written to {os.path.relpath(BENCH_FL_OUT, ROOT)}",
          flush=True)

    phase("main path 7: Tables 1 and 2 at full width")
    tables, tabcounts = tables_path(torch, kernels, np)
    phase("Fig. 7: stage step against full step")
    fig7_rows, f7counts = fig7_phase(torch, kernels)

    phase("Fig. 2: the nHSIC plane")
    fig2_out, f2counts = fig2_phase(torch, kernels)
    phase("Fig. 5: device scales and the ViT on the vectorized round")
    fig5_out, f5counts = fig5_phase(torch, kernels)
    phase("Fig. 8: the ablation")
    fig8_out, f8counts = fig8_phase(torch, kernels)
    phase("the quickstart")
    quick_out, qcounts = quickstart_phase(torch, kernels)

    phase("Fig. 6: peak memory of each stage against the full-model step")
    fig6_out, fcounts = fig6_phase(torch, kernels)

    by_path = {"resnet18": counts, "vit12": vcounts, "xlstm": xcounts,
               "kernels_bench": bcounts,
               **{a: z["launches"] for a, z in zoo.items()},
               **{f"{a}_vectorized": v["launches"] for a, v in vec.items()},
               "fl_round_throughput": tcounts, "tables": tabcounts,
               "fig7": f7counts, "fig6": fcounts, "resume": rescounts,
               "fig2": f2counts, "fig5": f5counts, "fig8": f8counts,
               "quickstart": qcounts}
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
    # K5 over 4 cohorts (the reference vmaps its pallas_call): launches are
    # main path 6's on the xLSTM, errors the batched phase's
    for row in batched["timing"]:
        n = row["name"]
        if n not in serrs or "ms" not in row:
            continue
        out_kernels.append({
            "name": f"{n}, C = {row['cohorts']}", "route": "cuda",
            "source": sources[n], "replaces": replaces[n],
            "launches": sum(v["launches"][n] for k, v in vec.items()
                            if k.startswith("xlstm")),
            "max_abs_err": serrs[n][0], "max_rel_err": serrs[n][1],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "device_ms": row["device_ms"],
            "four_calls_ms": row["four_calls_ms"],
            "four_calls_device_ms": row["four_calls_device_ms"],
            "launches_per_call": row["launches_per_call"]})
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
                             "step_profile": xprofiles, "f2": f2},
                   "kernels_bench": {"rows": bench_rows,
                                     "launches": bcounts},
                   "zoo": zoo, "batched": batched,
                   "captured_vs_eager": captures, "vectorized": vec,
                   "fl_round_throughput": throughput, "tables": tables,
                   "fig7": fig7_rows, "fig6": fig6_out, "resume": resume,
                   "fig2": fig2_out, "fig5": fig5_out, "fig8": fig8_out,
                   "quickstart": quick_out,
                   "kernels": out_kernels, "device": device}, f, indent=1)
    phase("done")
    print(smi, flush=True)
    print(json.dumps({"kernels": out_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        sys.exit(resume_child(sys.argv[2]))
    sys.exit(main())
