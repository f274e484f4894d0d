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
5. Main path 3: xlstm-1.3b at full width (d_model 2048, 4 heads of
   512, vocab 50304, float32), its depth cut 48 -> 24 layers (3 periods of
   7 mLSTM + 1 sLSTM, ``XLSTM_LAYERS``; every kernel shape is the full
   depth's), the sLSTM scan through K5, synthetic text at seq 256, batch
   16, SGD at lr 1e-4, 3 stages: three rounds, one per stage, then an
   evaluation.  K5 must launch exactly once per sLSTM layer run (1, 2, 3
   per local step at stages 0, 1, 2; 3 per evaluation batch), K1-K3 twice
   per step, K4 never.  Then the step check against ``use_slstm_kernel=False`` with
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
   cohort in one ``torch.func.vmap``ped step) of ResNet18, ViT-12, a
   24-layer xLSTM at the smoke config's width and, its depth cut to 8
   layers (1 period in 1 stage) for the time limit, at xlstm-1.3b's, each
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
17. Main path 9, after the round throughput: the buffered-async (FedBuff)
   runtime.  Main path 1's ResNet18 with ``runtime="async"`` (K = 3 of 4
   cohorts, polynomial staleness at alpha 0.5, 15% constant dropout), 8
   rounds, two passes of the round-robin schedule: K1-K3 twice a
   vectorized step; every delivered entry flushed exactly once or still
   pending; each flush one version and each staleness the versions since
   its entry's pull; at least one entry carried across rounds; no pending
   entry holding more storage than its own; a fresh ``buffer_size=0``
   server against the vectorized runtime on the first round's stack
   (cohort losses to the bit, the update at TOL or 10x the vectorized
   round's own movement); the rounds again from the seed to the bit,
   checkpointing every 2 rounds; then a child killed as the first round
   opens whose last checkpoint holds a pending entry, restored here and
   run to round 8: params, history, version, clock, pending entries, RNG
   and selector equal the straight run's to the bit, the last checkpoint
   read on the CPU the bits of ``to_reference`` of the card's params and
   buffer.  ViT-12 at full width on the async runtime (C = 4, K = 3, 6
   rounds, an evaluation each): K1-K3 twice a vectorized step, K4 once a
   layer run per vectorized step and per evaluation batch.  The example's
   first two legs (``examples/async_fedbuff.py``, at its own size; its
   third leg runs in main path 10), its simulated sync and async times
   and speedup printed; ``fl_round_throughput``'s async mode
   at the reference's sizes and its population mode at 10^2, 10^4 and
   10^6 clients (rows added to ``chiprun_out/bench_fl_round.json``).
   Every nHSIC and K4 shape held; each part's seconds printed.

18. Main path 10, after main path 9: rounds on a mesh of ranks
   (``runtime="sharded"``, ``launch/mesh.py``), main path 1's server
   throughout.  10a ``resnet18-sharded-1x1``: this process's one-rank
   NCCL mesh, 4 rounds (one a stage), each round's params, cohort losses
   and mean loss the bits of a vectorized run of the same server, K1-K3
   twice a vectorized step, the group destroyed after.  10b
   ``resnet18-sharded-2x1``: two children of this script (``--mesh-child``:
   gloo, the ranks sharing the card, the kernels loaded), 4 rounds and one
   3-cohort round (a cohort padded); the ranks the same bits and 10a's
   stacks, each round against the vectorized round from its own start
   params on the same stack at main path 6's bar (TOL of the largest
   update, or 10x the vectorized round's own movement under a 1e-7
   change), K1-K3 twice a vectorized step on each rank.  10c
   ``resnet18-async-sharded-2x1``: main path 9's async server in that
   world, 8 rounds: the host numbers of main path 9's run to the last
   one, the round after 0, 2, 4 and 6 rounds replayed here by the
   one-process async runtime from the world's state at that bar, the
   round-4 checkpoint restored here to the world's bits.  10d
   ``resnet18-sharded-2x2``: a world of 4 (data 2 x model 2), 4 rounds,
   10b's checks and ``held_trainable_bytes`` below 0.65 of 10a's at every
   stage; in that world the throughput's ``--model-parallel 2`` rows
   (added to ``chiprun_out/bench_fl_round.json``) and the example's third
   leg.
19. Main path 11, after main path 10: serving (``models/model.py``'s
   ``prefill`` and ``decode_step``, ``launch/serve.py``), TF32 off, every
   check at TOL of its largest entry in f32, or 10x the plain side's own
   movement under a random 1e-7 change of its params where that exceeds
   TOL / 10; weights random from a seed.  11a ``qwen3-serve-full``:
   qwen3-1.7b at full width (28 layers, d_model 2048, 16 heads over 8 kv
   heads of 128, qk-norm, vocab 151936) in f32, B = 2, a 256-token
   prompt: the prefill through K4 against the plain prefill (last logits,
   every cache leaf), 16 greedy decode steps against the plain forward
   over the whole sequence at each position, the greedy tokens again from
   the seed to the bit; then ``serve.main`` at ``--full --batch 4
   --prompt-len 512 --gen 64`` in the config's bf16: prefill ms, decode
   ms/step, tokens/s and the allocator peak beside their bounds.  11b
   ``h2o-serve-full-wrap``: h2o-danube-3-4b at full width (24 layers,
   d_model 3840, 32 heads over 8 of 120, window 4096), f32, B = 1, a
   4608-token prompt (the rolled windowed cache), 8 decode steps.  11c
   ``xlstm-serve-full``: xlstm-1.3b, f32, B = 4, a 256-token prompt: each
   sLSTM layer's final (c, n, m, h) through K5 against the plain scan's,
   16 decode steps.  11d: ``examples/serve_decode.main()`` at its own
   size, then its archs, qwen1.5-4b's smoke config (QKV bias) and
   qwen3-1.7b's with 2 kv heads, each decoded against the plain forward
   (the example's tokens the same bits).  K4 launches once a layer per
   prefill, K5 once an sLSTM layer, neither in a decode step, K1-K3
   never; every K4 and K5 shape held by the kernel phase.

20. Main path 12, after main path 11: LLM training (``launch/train.py``,
   ``launch/steps.py``, ``examples/progressive_llm_pretrain.py``, the
   audio and VLM modalities), TF32 off, weights random from SEED drawn on
   the card, every check at TOL of its largest entry or at 10x the plain
   side's own movement under a random 1e-7 change of its params where
   that exceeds TOL / 10 (``bar_of``).  12a ``qwen3-train-full``:
   ``train.main`` on qwen3-1.7b at full width (28 layers, d_model 2048, 16
   over 8 heads of 128, qk-norm, vocab 151936, 2,031,739,904 params) in
   its bf16, 4 rounds (one a stage) over 256 clients, 2 a round, batch 8,
   seq 64, lr 0.05, into a temporary ``--out``: every round's loss finite,
   K4 once per attention layer run and K1-K3 twice per local step
   (``server_rounds``), ``metrics.json`` holding the rounds' losses, the
   final checkpoint read back to the params' bits; then per stage one f32
   step through the kernels against the plain paths (``stage_step_check``
   from the trained params).  12b: ``train.main --e2e``, 3 SGD full steps:
   finite, K4 28 a step, K1-K3 never.  12c: the builders on qwen3-1.7b in
   f32 on a one-rank ``HostMesh`` with AdamW, B 4, S 256:
   ``build_neulite_train`` at its middle stage and ``build_full_train``
   (params, gradients, m and v in f32), each step against the plain path
   (loss, new params and m), the optimizer state the shapes and dtypes of
   ``abstract[0]``; ``build_prefill`` against the plain prefill and one
   ``build_serve`` step against the plain forward.  12d:
   ``progressive_llm_pretrain.main()`` at its own size, ms/step, CE and
   the speedup printed beside the paper's 1.84-2.31x (not gated).  12e
   ``musicgen-train-full``: musicgen-large at full width (since PR 28 its
   depth cut 48 -> 24 layers for the run's time; d_model 2048, 32 heads
   of 64, GELU, 4 codebook heads of 2048) in f32
   on frame embeddings, B 4 (nHSIC is constant below 3 rows), S 256: one
   stage step per stage and the E2E loss against the plain path, each
   period alone (forward and gradients) and each mixer's prefill and
   decode alone (the model is chaotic at init: a whole step moves O(1)
   under a 1e-7 change), a prefill and 3 decode steps from embeddings
   against the plain forward.  12f ``llava-train-full-depth2``:
   llava-next-34b at full width (d_model 7168, 56 -> 64 padded heads over
   8 of 128, d_ff 20480, vocab 64000), its depth cut 60 -> 2 layers (4
   until PR 28, cut for the run's time; the
   whole model, 68.8 GB in bf16, does not train on one card), f32, B 2,
   its 2880 patches and 128 text tokens: one stage step per stage, the
   E2E loss and each period alone against the plain path (each kernel
   step's result moved to host memory before the plain step runs).  K4
   once per attention layer run, K1-K3 twice per stage step; every K4 and
   nHSIC shape held by the kernel phase (``FLASH_TRAIN``,
   ``train_nhsic_shapes``: the kernel phase holds nHSIC at B = 2, where it
   is constant, by its value and a gradient below 1e-5); each leg's
   seconds and allocator peak beside ``core/memory.py``'s estimate.

21. Main path 13, after main path 12: Mamba, MoE and MLA, under main
   path 12's rules (TF32 off, weights random from SEED drawn on the card,
   ``bar_of``, each leg's seconds and allocator peak).  13a
   ``deepseek-lite-serve-full``: ``serve.main --arch deepseek-v2-lite-16b
   --full --batch 4 --prompt-len 512 --gen 32`` in its bf16 at all 27
   layers: prefill ms, decode ms/step, tokens/s and the allocator peak
   beside their bounds (decode: the reference's formulation reads every
   expert's 8-slot buffer; beside it the bytes of the experts each step
   routes to, counted), the greedy tokens and logits of 8 decode steps
   twice from the seed to the bit; then in f32 at full width the MLA
   mixer alone (a prefill of
   512, then 16 absorbed decode steps against the naive forward,
   ``layer_check``) and the MoE FFN alone (64 experts top-6 + 2 shared of
   1408 on 2048 tokens, C = 240) against ``moe_loop``, a per-expert loop
   with its own ranks and drop mask: output, aux losses, every gradient,
   and the same bits over 3 runs.  13b ``deepseek-lite-train-full-depth4``:
   ``train.main`` at full width, depth cut 27 -> 4, bf16, 4 rounds (one a
   stage) over 256 clients, B 8, seq 64: every loss finite, K1-K3 twice a
   local step, K4 never (MLA attends with ``sdpa``, as the reference's);
   per stage an f32 step through the kernels against the plain path and
   the loss's aux term (``moe_aux_check``).  13c ``deepseek-236b-full-
   depth2``: deepseek-v2-236b at full width (q-LoRA 1536, 160 experts),
   depth 60 -> 2, bf16: a prefill of 2 x 256 and 8 greedy decode steps,
   timed beside their bounds, and at capacity factor 8.0 against the
   forward (twice bf16's own movement from f32); the q-LoRA MLA mixer and
   the MoE FFN alone in f32.  13d ``jamba-layers-full``: at
   jamba-1.5-large-398b's full width in f32, B 2, S 512: the Mamba mixer
   (d_in 16384) against ``mamba_plain``, a per-step recurrence (output,
   every gradient), its decode after a prefill of 500 against the
   forward; the attention mixer through K4 against ``sdpa`` (output,
   gradients); one MoE FFN (16 experts top-2 of 24576, 9.66 B params)
   against ``moe_loop`` in f32 (gradients into x and the router); each
   forward timed (the scan's share).  13e ``jamba-smoke``: the smoke config
   whole: greedy decode against the plain forward at capacity factor 8.0
   and each mixer alone, ``serve.main``, ``train.main`` 2 rounds (K4 once
   an attention layer run, K1-K3 twice a local step).  Every K4 and nHSIC
   shape held by the kernel phase (``FLASH_MOE``, ``train_nhsic_shapes``).

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
# main path 12's h_xz, timed too: qwen3-1.7b's in 12a, llava's in 12f
NHSIC_TRAIN_TIMED = [(8, 2048, 2048, False), (2, 7168, 7168, False)]
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
# main path 11's prefills: qwen3-1.7b (16 heads over 8 kv heads of 128) at
# prompts of 256 and 512 in f32 and bf16; h2o-danube-3-4b (32 over 8 of
# 120, window 4096) at a 4608-token prompt; the serving example's smoke
# configs and qwen3-1.7b's with 2 kv heads (4 heads of 64, a 24-token
# prompt, h2o-danube's window 64)
FLASH_QWEN3 = (2, 256, 256, 16, 8, 128, True, 0, "float32")
FLASH_SERVE = (4, 512, 512, 16, 8, 128, True, 0, "bfloat16")
FLASH_H2O = (1, 4608, 4608, 32, 8, 120, True, 4096, "float32")
FLASH_CASES += [FLASH_QWEN3, FLASH_QWEN3[:-1] + ("bfloat16",),
                FLASH_SERVE[:-1] + ("float32",), FLASH_SERVE, FLASH_H2O,
                (2, 24, 24, 4, 4, 64, True, 0, "float32"),
                (2, 24, 24, 4, 4, 64, True, 64, "float32"),
                (2, 24, 24, 4, 2, 64, True, 0, "float32")]
# main path 12's training shapes: qwen3-1.7b (16 over 8 heads of 128) at
# B 8, S 64 in its bf16 (12a, 12b) and in f32 (12a's step check), at B 4,
# S 256 (12c); the example's 10 over 5 heads of 64 at B 8, S 128 (12d);
# musicgen-large's 32 heads of 64 at B 4, S 256 (12e); the padded
# llava-next-34b's 64 over 8 heads of 128 over its 2880 patches and 128
# text tokens at B 2 (12f: K4's longest causal shape without a window)
FLASH_TRAIN = [(8, 64, 64, 16, 8, 128, True, 0, "float32"),
               (4, 256, 256, 16, 8, 128, True, 0, "float32"),
               (8, 128, 128, 10, 5, 64, True, 0, "float32"),
               (4, 256, 256, 32, 32, 64, True, 0, "float32"),
               (2, 3008, 3008, 64, 8, 128, True, 0, "float32")]
FLASH_CASES += FLASH_TRAIN + [FLASH_TRAIN[0][:-1] + ("bfloat16",)]
FLASH_GRAD_CASES += FLASH_TRAIN
# main path 13's: jamba-1.5-large-398b's attention sub-layer at full width
# (64 heads over 8 of 128) at B 2, S 512 (13d, with its gradient), and its
# smoke config's (4 heads of 64) training at B 8, S 64 (13e; its serving
# takes the 24-token prompt above)
FLASH_MOE = [(2, 512, 512, 64, 8, 128, True, 0, "float32"),
             (8, 64, 64, 4, 4, 64, True, 0, "float32")]
FLASH_CASES += FLASH_MOE
FLASH_GRAD_CASES += FLASH_MOE
# timed: the ViT-12 shape and the kernel benchmark's two attention rows
# (kernels_bench.ATTN_SHAPES, causal f32), then main path 11's bf16 serve
# and h2o-danube prefills, main path 12's bf16 qwen3-1.7b training and
# its llava-next-34b, main path 13's full-width jamba attention
FLASH_TIMED = [FLASH_VIT, (2, 256, 256, 8, 2, 64, True, 0, "float32"),
               (1, 1024, 1024, 8, 8, 64, True, 0, "float32"), FLASH_SERVE,
               FLASH_H2O, FLASH_TRAIN[0][:-1] + ("bfloat16",),
               FLASH_TRAIN[4], FLASH_MOE[0]]
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
# main path 11's prefills: xlstm-1.3b at batch 4, and the serving
# example's xLSTM smoke config (4 heads of 64, a 24-token prompt)
SLSTM_SERVE = (4, 256, 4, 512, False, 1.0)
SLSTM_CASES += [SLSTM_SERVE, (2, 24, 4, 64, False, 1.0)]
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
# main path 9: main path 1's server on the buffered-async runtime (K = 3 of
# 4 cohorts, polynomial staleness, 15% constant dropout), two passes of the
# round-robin schedule so that a stage's stragglers flush when it returns
ASYNC_KW = dict(runtime="async", buffer_size=3,
                staleness_schedule="polynomial", staleness_alpha=0.5,
                dropout_schedule="constant", dropout_rate=0.15)
ASYNC_ROUNDS, ASYNC_VIT_ROUNDS, ASYNC_EVERY = 8, 6, 2
# main path 9's checkpoints: every ASYNC_EVERY rounds, all of them kept
ASYNC_CKPT = dict(checkpoint_every=ASYNC_EVERY,
                  keep_checkpoints=ASYNC_ROUNDS // ASYNC_EVERY)
ASYNC_POPULATIONS, ASYNC_POP_ROUNDS = (1e2, 1e4, 1e6), 2

# main path sizes (a CPU rehearsal shrinks them)
RESNET = dict(arch="resnet18", num_classes=10, image_size=32, width_mult=1.0)
# main path 5: the paper's other two CNNs, as main path 1 runs ResNet18
ZOO = [dict(RESNET, arch="vgg11"), dict(RESNET, arch="squeezenet")]
RESNET_IMAGES = 16000
VIT = dict(num_classes=100, image_size=64, num_layers=12, d_model=384)
VIT_IMAGES = 9600
TEST_IMAGES = 512
XLSTM = dict(use_slstm_kernel=True, dtype="float32")
# main path 3 (and its F2 phase): xlstm-1.3b's depth cut 48 -> 24 layers
# (3 periods, one a stage) to keep the whole run inside its time; every
# shape its kernels take is the full depth's
XLSTM_LAYERS = 24
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
        if B < 3:
            # two rows centre to a rank-1 Gram: nHSIC is constant (1, or 0
            # for identical rows) and its gradient 0; both sides' are
            # rounding (the plain side's up to ~2e-7), held absolutely
            rel_g = max(float(g.abs().max()) for g in
                        (xa.grad, za.grad, xb.grad, zb.grad))
            check(rel_v <= TOL and rel_g <= 1e-5,
                  f"autograd nHSIC at {(B, Dx, Dz, lx)}: {rel_v}, "
                  f"gradient {rel_g} (0 expected)")
        else:
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
    """K1-K3 and their plain versions at the main paths' shapes and main
    path 12's h_xz (NHSIC_TRAIN_TIMED): CUDA events and the profiler's
    device time of the kernels."""
    rows = []
    for shape in MAIN_PATH_SHAPES + NHSIC_TRAIN_TIMED:
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
    yardstick, timed here only; a window passed as its boolean mask) at
    FLASH_TIMED: event times of one call,
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
        # a window is a mask SDPA takes as an argument
        mask = (fref.attention_mask(case[1], case[2], causal, window,
                                    q.device) if window > 0 else None)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None,
                enable_gqa=case[3] != case[4])
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
    """K5's forward and backward at the xlstm-1.3b shape, and its forward
    at main path 11's prefill: CUDA events, the profiler's device time of
    the kernel, the plain version (for the backward: autograd of the plain
    loop, its backward pass alone) and the bound.  No single PyTorch call computes an sLSTM scan or its backward,
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
    # the forward alone at main path 11's xlstm-1.3b prefill (no gradient)
    inputs = slstm_inputs(torch, SLSTM_SERVE)
    fn = lambda: skernel.slstm_scan_fwd(*inputs)       # noqa: E731
    ms, dev = time_ms(torch, fn), device_ms(torch, fn, ("slstm_fwd_kernel",))
    plain = time_ms(torch, lambda: sref.slstm_scan_ref(
        *inputs[:3], dict(zip(STATE, inputs[3:]))), runs=5, warmup=1)
    b_ms, b_by = bound_ms("slstm_scan_fwd", SLSTM_SERVE)
    print(f"  time slstm_scan_fwd {SLSTM_SERVE}: kernel {ms:.4f} ms (device "
          f"{fmt_ms(dev)}), plain {plain:.4f} ms, bound {b_ms:.3f} ms "
          f"({b_by})", flush=True)
    rows.append({"name": "slstm_scan_fwd", "shape": list(SLSTM_SERVE),
                 "ms": ms, "device_ms": dev, "plain_ms": plain,
                 "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
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
    """``n`` rounds, each through ``server.run(1)`` (which checkpoints as
    the server's ``FLConfig`` says); per round the seconds, peak allocated
    bytes (and, where the round evaluates, the peak before and during the
    evaluation), local steps and each kernel's launches.  With ``fresh``
    each round starts from an emptied cache, so that its reserved peak is
    its own."""
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
        rr = server.run(1)[-1]
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


def vit_server(runtime="sequential", **flc_kw):
    """Main path 2's server (main path 6's with ``runtime="vectorized"``,
    main path 9's with the async runtime's fields in ``flc_kw``) and its
    test batcher: full-width ViT-12 over a 100-device fleet, built from
    SEED."""
    from repro_torch.configs.paper_models import vit
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    cfg = dataclasses.replace(vit(**VIT), use_flash_kernel=True)
    flc = FLConfig(n_devices=100, clients_per_round=4, local_epochs=1,
                   batch_size=32, num_stages=3, use_hsic_kernel=True,
                   runtime=runtime, seed=SEED, **flc_kw)
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
    """Main path 3's server: full-width xlstm-1.3b, its depth cut to
    XLSTM_LAYERS, over a 100-device fleet on synthetic text, built from
    SEED (``benchmarks/round_memory.py`` builds it); ``capture=False``
    keeps its steps eager, ``params`` stand for the init from SEED."""
    from repro_torch.benchmarks.round_memory import xlstm_server as build
    return build(capture, params=params, num_layers=XLSTM_LAYERS)


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
# 256, 4 heads of 64, vocab 512) cut to 3 periods (24 layers) in 3 stages:
# stage 2 then freezes a period, whose sLSTM layer the cohorts share,
# beside two trainable ones; and xlstm-1.3b's (d_model 2048, 4 heads of
# 512, vocab 50304) cut to 1 period (8 layers) in 1 stage, to keep the
# whole run inside its time (at 3 periods it took 154 s of the run, at 2
# 115 s; its rounds are chaotic, so its first step, launches and bits
# check it, and the shared r of a frozen layer at full width stays held in
# the kernel phase's batched K5 cases; 2 stages of 3 periods train the
# embedding and two periods at stage 0, 10.3 GB of params for four
# cohorts, which ran out of the card's 80 GB in the vectorized step's
# backward at batch 8 and at 4).  4 cohorts, f32, lr 1e-4, one round a stage.  (B, S, sequences,
# layers): the full width at batch 4, with few sequences a client, so
# that a round has few vectorized steps.
XLSTM_VEC_STAGES = 3
XLSTM_VEC = {"smoke": (8, 64, 800, 24), "full": (4, 256, 400, 8)}


def xlstm_vec_server(width, runtime="sequential"):
    """Main path 6's xLSTM server at ``width`` ("smoke" or "full") over a
    100-device fleet on synthetic text, built from SEED."""
    from repro_torch.configs import xlstm_1_3b
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer

    B, S, seqs, layers = XLSTM_VEC[width]
    cfg = xlstm_1_3b.config()
    cfg = (cfg.reduced(num_layers=layers) if width == "smoke"
           else dataclasses.replace(cfg, num_layers=layers))
    cfg = dataclasses.replace(cfg, **XLSTM)
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
    bar is 10 times it; otherwise it is TOL.  The bar is never below TOL,
    so a step within TOL passes whatever the movement: that is measured
    only for a step beyond TOL."""
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
        sensitive = sensitivity and max(loss_rel, params_rel) > TOL
        if sensitive:
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
                 f"{bar_params:.1e}" if sensitive else
                 f"; within {TOL:.0e}" if sensitivity else "")
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
    batch = to_device(next(server.test_batcher.epoch()), server.device)
    return periods_alone(torch, server.params["model"], server.adapter.cfg,
                         plain_adapter.cfg, batch["inputs"])


def periods_alone(torch, model, cfg_kernel, cfg_plain, inputs, name=""):
    """``period_check`` of ``model``'s periods (``cfg_kernel`` against
    ``cfg_plain``) on ``inputs``."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import model as tx
    layers = model["layers"]
    with torch.no_grad():
        x, pos, _ = tx.embed_inputs(model, cfg_plain, inputs)
    gen = torch.Generator().manual_seed(2)
    out = []
    for i in range(tx.num_stacked(layers)):
        cot = torch.randn(x.shape, generator=gen).to(x.device)
        res = []
        for cfg in (cfg_kernel, cfg_plain):
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
              f"{name}period {i}: kernel vs plain path {rel_y}, {rel_g}")
        out.append({"period": i, "out_rel": rel_y, "grad_rel": rel_g})
        x = yp
        del res, yk, gk, gp
    print(f"  {name}{len(out)} periods alone, each fed the plain path's "
          f"input, kernel vs plain path: output rel <= "
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


def async_nhsic_shapes():
    """Main path 9's beyond the main paths': the async example's ResNet18
    (its own size, 2 stages, B = 16) and ``fl_round_throughput``'s
    reference-size ResNet18 and ViT at B = 4 (the async and population
    modes)."""
    from repro_torch.benchmarks import fl_round_throughput as flr
    from repro_torch.core.progressive import make_adapter
    from repro_torch.examples import async_fedbuff as ex
    from repro_torch.models.cnn import CNNConfig
    example = make_adapter(CNNConfig(
        name="resnet18", arch="resnet18", num_classes=10,
        image_size=ex.IMAGE_SIZE, width_mult=ex.WIDTH),
        ex.BASE["num_stages"])
    return (cnn_nhsic_shapes(example, ex.BASE["batch_size"])
            + cnn_nhsic_shapes(make_adapter(*flr._config("cnn",
                                                         "reference")[:2]),
                               4)
            + transformer_nhsic_shapes(flr._config("vit", "reference")[0],
                                       4))


def nhsic_shapes():
    """The training paths' nHSIC shapes, each once: the main paths', then
    the Fig. 6 CNNs', Tables 1-2's, the Fig. 7, 2, 5 and 8 phases', the
    quickstart's, main path 9's and main path 12's."""
    return list(dict.fromkeys(
        MAIN_PATH_SHAPES + fig6_nhsic_shapes() + tables_nhsic_shapes()
        + fig7_nhsic_shapes() + fig2_nhsic_shapes() + fig5_nhsic_shapes()
        + resnet18_nhsic_shapes(**FIG8_SIZE) + quickstart_nhsic_shapes()
        + async_nhsic_shapes() + train_nhsic_shapes()))


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
    # the reference's granite-smoke row is analytic only (not gated)
    measured = {n: r for n, r in rows.items()
                if r.get("measured") != "not measured"}
    for name, r in measured.items():
        check(all(math.isfinite(e["mean_loss"]) and e["num_batches"] == 2
                  for e in r["stages"] + [r["full"]]),
              f"{name}: a step did not take two finite-loss batches")
    stage_steps = sum(2 * len(r["stages"]) for r in measured.values())
    check(all(counts[n] == 2 * stage_steps for n in STREAMING),
          f"expected 2 launches of each nHSIC kernel per stage step "
          f"({stage_steps} steps): {counts}")
    check(all(counts[n] > 0 for n in ("flash_attention_fwd",
                                      "slstm_scan_fwd", "slstm_scan_bwd")),
          f"a per-layer kernel never ran in the Fig. 6 phase: {counts}")
    check_held(seen, "the Fig. 6 phase")
    failures = {name: r["failures"] for name, r in measured.items()
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
    worst, sens, loss_rel, sens_loss = 0.0, 0.0, 0.0, 0.0
    wants = {}
    for c in [c for c in range(C) if bool(keep[c])]:
        b = tree_map(lambda x: x[c], batch)
        want = seq(opt.init(trainable), trainable, frozen, b, trainable)[1:]
        got = (tree_map(lambda p: p[c].to(server.device), eager),
               {"loss": em["loss"][c]})
        loss_c, params_c = _step_diff(got, want)
        worst, loss_rel = max(worst, params_c), max(loss_rel, loss_c)
        wants[c] = want
    # the bars are never below TOL: the sequential step's own movement at
    # params x (1 + 1e-7) is measured only where a cohort is beyond it
    if max(worst, loss_rel) > TOL:
        moved = tree_map(lambda p: p * (1 + 1e-7), params)
        mfrozen, mtrain = adapter.split_stage(moved, t)
        for c, want in wants.items():
            b = tree_map(lambda x: x[c], batch)
            far = seq(opt.init(mtrain), mtrain, mfrozen, b, mtrain)[1:]
            far_loss, far_params = _step_diff(far, want)
            sens, sens_loss = (max(sens, far_params),
                               max(sens_loss, far_loss))
        del moved, mfrozen, mtrain
    del wants
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
        _, start = server.adapter.split_stage(params, t)
        diff = _update_rel(_on(server.device, vec), new, start)
        # the bar is never below TOL: the sequential round's own movement
        # is measured only for a round beyond it
        moved = sens = None
        if diff > TOL:
            moved, _ = seq.run_stacked(tree_map(lambda p: p * (1 + 1e-7),
                                                params), t, stack)
            sens = _update_rel(moved, new, start)
        bar = max(TOL, 10 * sens) if sens and sens > TOL / 10 else TOL
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
              f"params x (1 + 1e-7) "
              f"{'not measured' if sens is None else f'{sens:.2e}'}; bar "
              f"{bar:.1e}; first step "
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


def resume_child(directory, kind="sequential"):
    """Main path 8's killed run, in its own process: main path 1's server
    checkpointing every RESUME_EVERY rounds into ``directory``, killed by
    SIGKILL as its third round opens; with ``kind="async"`` main path 9's
    (``ASYNC_KW``, every ASYNC_EVERY rounds), killed as the first round
    opens whose last checkpoint holds a pending entry.  Loads the kernels
    the parent built; never builds them."""
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
    from repro_torch.checkpoint import (latest_checkpoint,
                                        read_checkpoint_meta)
    if kind == "async":
        server = cnn_server(np, quiet=True, checkpoint_dir=directory,
                            **ASYNC_CKPT, **ASYNC_KW)
        rounds, every = ASYNC_ROUNDS, ASYNC_EVERY
    else:
        server = cnn_server(np, quiet=True, checkpoint_dir=directory,
                            checkpoint_every=RESUME_EVERY)
        rounds, every = RESUME_ROUNDS, RESUME_EVERY
    run_round = server.run_round

    def crashing(r):
        if kind == "async":
            last = latest_checkpoint(directory)
            if (r % every == 0 and last is not None
                    and read_checkpoint_meta(last)["async"]["stages"]):
                os.kill(os.getpid(), signal.SIGKILL)
        elif r == every:
            os.kill(os.getpid(), signal.SIGKILL)
        return run_round(r)

    server.run_round = crashing
    server.run(rounds)
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


# --------------------------------------------------------------------------- #
# main path 9: the buffered-async (FedBuff) runtime
# --------------------------------------------------------------------------- #
def _own_storage(t):
    """Whether ``t`` holds storage of its own, not a view of a larger one."""
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


def watch_async(torch, np, server):
    """Record, as the async runtime runs them, each round's stack (the
    first one's params too), its deliveries and metrics, and each flush:
    its version against the server's before the round, its entries'
    staleness and pulls, the entries themselves (so that an entry flushed
    twice shows); and whether every pending entry holds storage of its
    own after the round."""
    from repro_torch.common.tree import tree_leaves, tree_map
    rt = server.runtime
    log = {"rounds": [], "flushes": [], "flushed": [], "first": None}
    run = rt.run_stacked

    def recorded(params, t, stack, *, sim_times=None, **kw):
        state, v0 = rt.state, rt.state.version
        schedule = state.schedule

        def planned(new, K, stage):
            flushes = schedule(new, K, stage)
            for j, f in enumerate(flushes):
                log["flushes"].append(dict(
                    version=f.version, expected_version=v0 + j,
                    staleness=f.staleness.tolist(),
                    pulled=[e.pulled_version for e in f.entries]))
                log["flushed"].extend(f.entries)
            return flushes

        if log["first"] is None:
            log["first"] = (tree_map(torch.clone, params), t, stack)
        state.schedule = planned
        try:
            out = run(params, t, stack, sim_times=sim_times, **kw)
        finally:
            del state.schedule
        m = out[1]
        log["rounds"].append(dict(
            round=server.next_round, stage=t,
            vectorized_steps=stack.max_steps, cohorts=stack.num_cohorts,
            delivered=int(np.count_nonzero(np.asarray(stack.weights) > 0)),
            staleness=m["staleness"].tolist(),
            **{k: m[k] for k in ("n_uploads", "n_pending", "n_carried",
                                 "n_evicted", "server_version",
                                 "sim_round_time")},
            pending_own_storage=all(
                _own_storage(x) for e in rt.state.entries
                for x in tree_leaves(e.delta) + [e.loss])))
        return out

    rt.run_stacked = recorded
    return log


def check_async_log(log, state, name, carried=True):
    """Main path 9's buffer checks over a run's ``watch_async`` log and its
    final state: every delivered entry flushed exactly once or still
    pending (nothing evicted), each flush one version past the last and
    each staleness the versions since its entry's pull, (with
    ``carried``) at least one entry carried across rounds, no pending
    entry pinning more than its own storage."""
    rounds = log["rounds"]
    delivered = sum(r["delivered"] for r in rounds)
    uploads = sum(r["n_uploads"] for r in rounds)
    flushed = {id(e) for e in log["flushed"]}
    out = dict(delivered=delivered, flushed=uploads, pending=len(state),
               carried=sum(r["n_carried"] for r in rounds),
               flushes=len(log["flushes"]), server_version=state.version)
    check(len(flushed) == len(log["flushed"]) == uploads
          and not flushed & {id(e) for e in state.entries}
          and uploads + len(state) == delivered
          and all(r["n_evicted"] == 0 for r in rounds),
          f"{name}: not every delivery flushed exactly once or pending: "
          f"{out}")
    check(all(f["version"] == f["expected_version"] and all(
        s == f["version"] - p for s, p in zip(f["staleness"], f["pulled"]))
        for f in log["flushes"]) and state.version == len(log["flushes"]),
          f"{name}: a flush's staleness is not the versions since its "
          f"entries' pulls: {log['flushes']}")
    check(not carried or out["carried"] >= 1,
          f"{name}: no entry was carried across rounds: {rounds}")
    check(all(r["pending_own_storage"] for r in rounds),
          f"{name}: a pending entry pins more storage than its own")
    return out


def async_launch_check(rounds, log, per_step, idle=None):
    """Each round's launches: ``per_step(log round)`` for a round the async
    runtime trained (K1-K3 twice a vectorized step), ``idle`` (none of
    K1-K3) for a round it did not (every cohort dropped, or none
    feasible).  A round's loss is finite where it flushed, NaN where it
    flushed nothing."""
    trained = {r["round"]: r for r in log["rounds"]}
    idle = {n: 0 for n in STREAMING} if idle is None else idle
    for r in rounds:
        a = trained.get(r["round_idx"])
        want = per_step(a) if a is not None else idle
        r["async"] = a
        check(all(r["launches"][n] == c for n, c in want.items()),
              f"round {r['round_idx']}: launches {r['launches']}, expected "
              f"{want} ({a and a['vectorized_steps']} vectorized steps)")
        check(math.isfinite(r["mean_loss"]) == bool(a and a["n_uploads"]),
              f"round {r['round_idx']}: loss {r['mean_loss']} after "
              f"{a and a['n_uploads']} flushed entries")


def async_cnn_run(torch, kernels, np, **flc_kw):
    """Main path 9's ResNet18 server (main path 1's with ``ASYNC_KW``):
    ASYNC_ROUNDS rounds, watched (``watch_async``), K1-K3 counted."""
    server = cnn_server(np, quiet=True, **ASYNC_KW, **flc_kw)
    log = watch_async(torch, np, server)
    log["save_seconds"], save = [], server.save_state

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = save(*a, **kw)
        log["save_seconds"].append(time.perf_counter() - t0)
        return written

    server.save_state = timed_save
    reset_all(kernels)
    rounds = run_rounds(torch, server, kernels, ASYNC_ROUNDS, quiet=True)
    counts = read_all(kernels)
    del server.runtime.run_stacked, server.save_state
    async_launch_check(rounds, log, lambda a: {
        n: 2 * a["vectorized_steps"] for n in STREAMING})
    check(counts["flash_attention_fwd"] == 0 and counts["gram"] == 0,
          f"a kernel off the CNN path ran: {counts}")
    check(any(math.isfinite(r["mean_loss"]) for r in rounds)
          and all(bool(torch.isfinite(p).all())
                  for p in _leaves(server.params)),
          "async ResNet18: no round flushed, or a non-finite param")
    return server, rounds, log, counts


def async_k0_check(torch, server, first):
    """``buffer_size=0`` (one flush of every delivery) on a fresh server
    against the vectorized runtime, one round on the first round's params
    and stack: the same cohort step, so the cohort losses to the bit, and
    the new trainable at TOL of the largest update, or 10x the vectorized
    round's own movement at params x (1 + 1e-7) where that exceeds
    TOL / 10."""
    from repro_torch.common.tree import tree_map
    from repro_torch.federated.runtime import (AsyncBufferedRuntime,
                                               VectorizedRuntime)
    params, t, stack = first
    args = (server.adapter, server.optimizer, server.hp, server.device)
    asy = AsyncBufferedRuntime(*args, buffer_size=0,
                               staleness_schedule="polynomial",
                               staleness_alpha=0.5)
    vec = VectorizedRuntime(*args)
    tr_a, m_a = asy.run_stacked(params, t, stack)
    tr_v, m_v = vec.run_stacked(params, t, stack)
    moved, _ = vec.run_stacked(tree_map(lambda p: p * (1 + 1e-7), params),
                               t, stack)
    _, start = server.adapter.split_stage(params, t)
    diff = _update_rel(tr_a, tr_v, start)
    sens = _update_rel(moved, tr_v, start)
    bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
    active = [w > 0 for w in stack.weights]
    row = dict(stage=t, cohorts=stack.num_cohorts, rel=diff,
               vectorized_eps_rel=sens, bar=bar,
               cohort_losses_bitwise=torch.equal(m_a["cohort_losses"],
                                                 m_v["cohort_losses"]),
               mean_loss_rel=abs(float(m_a["mean_local_loss"]
                                       - m_v["mean_local_loss"]))
               / abs(float(m_v["mean_local_loss"])),
               server_version=m_a["server_version"],
               n_pending=m_a["n_pending"])
    check(row["cohort_losses_bitwise"] and diff <= bar
          and row["mean_loss_rel"] <= TOL and m_a["server_version"] == 1
          and m_a["n_pending"] == 0 and all(
              (s == 0) == a for s, a in zip(m_a["staleness"], active)),
          f"K = 0 async against vectorized: {row}")
    return row


def _buffer_on_host(state):
    """A buffer's entries as host values and CPU tensors."""
    return [((e.stage, e.weight, e.pulled_version, e.arrival_time,
              e.cohort), [x.cpu() for x in _leaves(e.delta)], e.loss.cpu())
            for e in state.entries]


def _same_buffer(torch, a, b):
    """Two ``_buffer_on_host`` lists equal to the bit."""
    return len(a) == len(b) and all(
        ka == kb and torch.equal(la, lb) and len(da) == len(db)
        and all(torch.equal(x, y) for x, y in zip(da, db))
        for (ka, da, la), (kb, db, lb) in zip(a, b))


def async_path(torch, kernels, np):
    """Main path 9 on ResNet18 (``ASYNC_KW``, ASYNC_ROUNDS rounds): the
    buffer checks (``check_async_log``: exactly once, version staleness, a
    carried entry, no pinned stack), K1-K3 twice a vectorized step, K = 0
    against the vectorized runtime (``async_k0_check``), the rounds again
    from the seed to the bit (checkpointing every ASYNC_EVERY rounds: the
    straight run of ``async_resume``), then the kill and resume."""
    import tempfile
    took = {}
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen:
        server, rounds, log, counts = async_cnn_run(torch, kernels, np)
    took["rounds"] = time.perf_counter() - t0
    buffer = check_async_log(log, server.runtime.state, "async ResNet18")
    for r in rounds:
        print(f"  round {r['round_idx']} (stage {r['stage']}): loss "
              f"{r['mean_loss']:.4f}, sim {r['sim_time']:.3f} s, version "
              f"{r['server_version']}, {r['seconds']:.3f} s; "
              f"{ {k: r['async'][k] for k in ('delivered', 'n_uploads', 'n_carried', 'n_pending', 'staleness')} if r['async'] else 'nothing delivered'}",
              flush=True)
    print(f"  buffer: {buffer}", flush=True)
    t1 = time.perf_counter()
    k0 = async_k0_check(torch, server, log["first"])
    took["k0"] = time.perf_counter() - t1
    print(f"  K = 0 against vectorized (stage {k0['stage']}): cohort losses "
          f"the same bits; update {k0['rel']:.2e} of the largest (bar "
          f"{k0['bar']:.1e}; vectorized at params x (1 + 1e-7) "
          f"{k0['vectorized_eps_rel']:.2e})", flush=True)
    first = (_on("cpu", server.params), _buffer_on_host(server.runtime.state),
             server.runtime.state.version, server.runtime.state.clock)
    del server, log
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="neulite-async-") as tmp:
        straight_dir = os.path.join(tmp, "straight")
        t1 = time.perf_counter()
        straight, again, log2, counts2 = async_cnn_run(
            torch, kernels, np, checkpoint_dir=straight_dir, **ASYNC_CKPT)
        took["repeat"] = time.perf_counter() - t1
        state = straight.runtime.state
        repeats = (_same_run(torch, rounds, first[0], again,
                             _on("cpu", straight.params))
                   and _same_buffer(torch, first[1], _buffer_on_host(state))
                   and (first[2], first[3]) == (state.version, state.clock))
        check(repeats, "async ResNet18: the rounds do not repeat bit for bit")
        print(f"  the rounds again from the seed: the same losses, params "
              f"and buffer, to the bit; save_state "
              f"{[round(x, 3) for x in log2['save_seconds']]} s", flush=True)
        t1 = time.perf_counter()
        resume, rcounts = async_resume(torch, kernels, np, straight,
                                       straight_dir, tmp)
        resume["save_state_seconds"] = log2["save_seconds"]
        took["resume"] = time.perf_counter() - t1
        del straight
    gc.collect()
    torch.cuda.empty_cache()
    check_held(seen, "main path 9's ResNet18")
    took["total"] = time.perf_counter() - t0
    print(f"  main path 9 ResNet18 phases (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return ({"rounds": rounds, "buffer": buffer, "k0": k0,
             "repeats": repeats, "resume": resume, "seconds": took,
             "final_params": first[0]},
            {n: counts[n] + counts2[n] + rcounts[n] for n in counts})


def async_resume(torch, kernels, np, straight, straight_dir, tmp):
    """Main path 9's kill and resume: a child (``resume_child(..,
    "async")``) runs main path 9's ResNet18 checkpointing every
    ASYNC_EVERY rounds and is killed as the first round opens whose last
    checkpoint holds a pending entry; this process restores it and runs
    to ASYNC_ROUNDS.  The checkpoint's ``async`` slot must be set, the
    child's checkpoint equal the straight run's of its round, and the
    resumed params, history, server version and clock, pending entries
    (deltas to the bit), RNG, selector and batcher states equal the
    straight run's; the straight run's last checkpoint, read on the CPU,
    the bits of ``to_reference`` of the card's params and buffer."""
    import signal
    import subprocess

    from repro_torch import bridge
    from repro_torch.checkpoint import (checkpoint_step, latest_checkpoint,
                                        load_checkpoint,
                                        read_checkpoint_meta)
    from repro_torch.federated.runtime import AsyncServerState
    from repro_torch.federated.server import NeuLiteServer
    out = {}
    killed = os.path.join(tmp, "killed")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.realpath(__file__), "--resume-child",
         killed, "async"], capture_output=True, text=True, timeout=600)
    out["child_seconds"] = time.perf_counter() - t0
    check(child.returncode == -signal.SIGKILL,
          f"the async resume child ended with {child.returncode}, not "
          f"SIGKILL:\n{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
    path = latest_checkpoint(killed)
    check(path is not None, "the killed async run left no checkpoint")
    meta = read_checkpoint_meta(path)
    out.update(checkpoint_step=checkpoint_step(path),
               checkpoint_bytes=os.path.getsize(path)
               + os.path.getsize(path + ".json"),
               pending_stages=meta["async"]["stages"])
    check(bool(meta["async"]["stages"]),
          f"the resumed checkpoint's async slot is empty: {meta['async']}")
    same_file = _npz_equal(np, path, os.path.join(straight_dir,
                                                  os.path.basename(path)))
    out["child_checkpoint_is_straight_runs"] = same_file
    check(same_file, "the killed child's checkpoint differs from the "
          "straight run's")
    print(f"  child killed by SIGKILL after {out['child_seconds']:.1f} s; "
          f"its checkpoint {os.path.basename(path)}: "
          f"{out['checkpoint_bytes']} bytes, pending entries of stages "
          f"{out['pending_stages']}", flush=True)

    adapter, clients, flc, test = cnn_setup(checkpoint_dir=killed,
                                            **ASYNC_CKPT, **ASYNC_KW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    resumed = NeuLiteServer.restore(adapter, clients, flc, killed,
                                    test_batcher=test)
    torch.cuda.synchronize()
    out["restore_seconds"] = time.perf_counter() - t1
    check(len(resumed.runtime.state) == len(meta["async"]["stages"]),
          "the restored buffer is not the checkpoint's")
    log = watch_async(torch, np, resumed)
    reset_all(kernels)
    t1 = time.perf_counter()
    resumed.run(ASYNC_ROUNDS - resumed.next_round)
    torch.cuda.synchronize()
    out["resumed_seconds"] = time.perf_counter() - t1
    counts = read_all(kernels)
    del resumed.runtime.run_stacked
    steps = sum(r["vectorized_steps"] for r in log["rounds"])
    check(steps > 0 and all(counts[n] == 2 * steps for n in STREAMING),
          f"resumed async rounds: {counts}, expected 2 launches of each "
          f"nHSIC kernel per vectorized step ({steps})")
    sa, sb = straight.runtime.state, resumed.runtime.state
    same = {
        "params": all(torch.equal(a, b) for a, b in zip(
            _leaves(straight.params), _leaves(resumed.params), strict=True)),
        "history": _same_history(straight.history, resumed.history),
        "version_clock": (sa.version, sa.clock) == (sb.version, sb.clock),
        "buffer": _same_buffer(torch, _buffer_on_host(sa),
                               _buffer_on_host(sb)),
        "rng": (straight.rng.bit_generator.state
                == resumed.rng.bit_generator.state),
        "selector": (straight.selector.state_dict()
                     == resumed.selector.state_dict()),
        "batchers": all(
            a.rng.bit_generator.state == b.rng.bit_generator.state
            for a, b in zip(straight.batchers + [straight.test_batcher],
                            resumed.batchers + [resumed.test_batcher]))}
    out["resumed_equals_straight"] = same
    check(all(same.values()), f"the resumed async run differs from the "
          f"straight run: {same}")
    last = latest_checkpoint(straight_dir)
    lmeta = read_checkpoint_meta(last)
    like = {"params": straight.params, "async": AsyncServerState.arrays_like(
        adapter, straight.params, lmeta["async"])}
    cpu, _ = load_checkpoint(last, like, device="cpu")
    card = {"params": bridge.reference_layout(straight.params),
            "async": sa.state_dict()[0]}
    cpu_bits = all(torch.equal(a, b) for a, b in zip(
        _leaves(cpu), _leaves(card), strict=True))
    out.update(cpu_load_is_card_bits=cpu_bits,
               last_pending_entries=len(lmeta["async"]["stages"]))
    check(cpu_bits, "the async checkpoint read on the CPU differs from "
          "to_reference of the card's params and buffer")
    print(f"  restore {out['restore_seconds']:.3f} s; resumed rounds "
          f"{checkpoint_step(path)}-{ASYNC_ROUNDS - 1} in "
          f"{out['resumed_seconds']:.2f} s, {steps} vectorized steps, "
          f"launches {counts}; resumed vs straight: {same}; "
          f"{os.path.basename(last)} ({len(lmeta['async']['stages'])} "
          f"pending) read on the CPU: the bits of to_reference of the "
          f"card's params and buffer", flush=True)
    del resumed
    return out, counts


def async_vit_path(torch, kernels, np):
    """Main path 9 on ViT-12 at full width (main path 2's widths, C = 4,
    ``ASYNC_KW``): ASYNC_VIT_ROUNDS rounds with an evaluation each; K1-K3
    twice a vectorized step; K4 once a layer run per vectorized step (its
    cohorts folded into the batch) and per evaluation batch; the buffer's
    exactly-once and staleness checks; every nHSIC and K4 shape held."""
    t0 = time.perf_counter()
    server, test = vit_server(**ASYNC_KW)
    server.test_batcher = test
    plan, cfg = server.adapter.plan, server.adapter.cfg
    n_eval = min(8, test.steps_per_epoch)
    log = watch_async(torch, np, server)
    with nhsic_shapes_seen() as seen, flash_shapes_seen() as fseen:
        reset_all(kernels)
        rounds = run_rounds(torch, server, kernels, ASYNC_VIT_ROUNDS,
                            quiet=True)
    counts = read_all(kernels)
    del server.runtime.run_stacked
    evals = n_eval * cfg.num_periods     # K4 in a round's evaluation

    def per_step(a):
        periods = plan.stage_ranges(a["stage"])[2][1]
        return {**{n: 2 * a["vectorized_steps"] for n in STREAMING},
                "flash_attention_fwd": a["vectorized_steps"] * periods
                + evals}

    async_launch_check(rounds, log, per_step, idle={
        **{n: 0 for n in STREAMING}, "flash_attention_fwd": evals})
    buffer = check_async_log(log, server.runtime.state, "async ViT-12",
                             carried=False)
    check(all(bool(torch.isfinite(p).all()) for p in _leaves(server.params))
          and all(0.0 <= r["test_acc"] <= 1.0 for r in rounds),
          "async ViT-12: a non-finite param or a bad accuracy")
    check_held(seen, "main path 9's ViT-12")
    check_flash_held(fseen, "main path 9's ViT-12")
    seconds = time.perf_counter() - t0
    for r in rounds:
        print(f"  round {r['round_idx']} (stage {r['stage']}): loss "
              f"{r['mean_loss']:.4f}, acc {r['test_acc']:.4f}, version "
              f"{r['server_version']}, {r['seconds']:.3f} s, launches "
              f"{ {n: r['launches'][n] for n in ('nhsic_rowsums', 'flash_attention_fwd')} }",
              flush=True)
    print(f"  buffer: {buffer}; {seconds:.1f} s", flush=True)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"rounds": rounds, "buffer": buffer, "seconds": seconds}, counts


def async_example_phase(torch, kernels):
    """``examples/async_fedbuff.py``'s first two legs on the card at its
    own size (``one_process_legs``: the synchronous (vectorized) leg, then
    the async leg; its third leg runs in main path 10's world of 4);
    prints the simulated times and the speedup; K1-K3 launch alike, K4
    never; every nHSIC shape held."""
    from repro_torch.examples import async_fedbuff
    reset_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen, contextlib.redirect_stdout(sys.stderr):
        res = async_fedbuff.one_process_legs(device="cuda")
    seconds = time.perf_counter() - t0
    counts = read_all(kernels)
    hist = res.pop("history")
    check(len({counts[n] for n in STREAMING}) == 1
          and counts["nhsic_rowsums"] > 0
          and counts["flash_attention_fwd"] == 0,
          f"the async example: launches {counts}")
    check(res["sync_time"] > 0 and math.isfinite(res["speedup"])
          and all(h.server_version is not None for h in hist),
          f"the async example: {res}")
    print(f"  simulated time: sync {res['sync_time']:.2f} s, async "
          f"{res['async_time']:.2f} s, speedup {res['speedup']:.2f}x; "
          f"accuracy sync {res['sync_acc']:.4f}, async "
          f"{res['async_acc']:.4f}; lost rounds {res['lost_rounds']}, "
          f"server version {res['server_version']}, still buffered "
          f"{res['pending']}; launches {counts}; {seconds:.1f} s",
          flush=True)
    check_held(seen, "the async example")
    return dict(res, seconds=seconds, launches=counts), counts


def async_throughput_phase(torch, kernels):
    """``fl_round_throughput``'s async mode at the reference's sizes and
    its population mode at ASYNC_POPULATIONS (ASYNC_POP_ROUNDS timed
    rounds each); rows added to BENCH_FL_OUT.  Every delivery flushed or
    pending; every nHSIC shape held."""
    from repro_torch.benchmarks import fl_round_throughput as flr
    reset_all(kernels)
    t0 = time.perf_counter()
    with nhsic_shapes_seen() as seen:
        rows = flr.run_async("cuda", BENCH_FL_OUT)
        t1 = time.perf_counter()
        pop = flr.run_population("cuda", BENCH_FL_OUT, ASYNC_POPULATIONS,
                                 rounds=ASYNC_POP_ROUNDS)
    took = {"async": t1 - t0, "population": time.perf_counter() - t1}
    counts = read_all(kernels)
    for r in rows:
        check(r["n_uploads"] + r["n_pending"] == r["cohorts"] * r["rounds"]
              and r["server_version"] * r["buffer_size"] == r["n_uploads"]
              and math.isfinite(r["speedup"]) and r["speedup"] > 0,
              f"async throughput row: {r}")
    check(all(r["rounds_per_s"] > 0 for r in pop), f"population rows {pop}")
    check(counts["nhsic_rowsums"] > 0, f"throughput modes: {counts}")
    check_held(seen, "the throughput's async and population modes")
    print(f"  rows added to {os.path.relpath(BENCH_FL_OUT, ROOT)}; "
          f"launches {counts}; phases (s) "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return {"async": rows, "population": pop, "seconds": took}, counts


# --------------------------------------------------------------------------- #
# main path 10: rounds on a mesh of ranks
# --------------------------------------------------------------------------- #
MESH_ROUNDS = 4               # 10a, 10b, 10d: one round a stage
MESH_CHILD_TIMEOUT = 900
MESH_HELD_BAR = 0.65          # the reference's bar (tests/test_runtime.py)
# 10c: a one-process async round replayed from the world's state after
# these many rounds (a fresh server, then its checkpoints)
ASYNC_REPLAYS = (0, 2, 4, 6)


def _digest(tree):
    """sha256 of a tree's leaves' bytes, in leaf order."""
    import hashlib
    h = hashlib.sha256()
    for x in _leaves(tree):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _stack_digest(stack):
    """A round's cohorts' weights, step counts and step mask, hashed."""
    from repro_torch.federated.runtime import _round_digest
    return _round_digest(stack, None).tolist()


def mesh_record(server):
    """Per round, as the runtime runs it: its start params, stage and stack
    (the params on the host), the new trainable (on the host), the cohort
    and mean losses, its vectorized steps and ``held_trainable_bytes``."""
    seen = []
    run = server.runtime.run_stacked

    def recorded(params, t, stack, **kw):
        out = run(params, t, stack, **kw)
        seen.append(dict(start=_on("cpu", params), t=t, stack=stack,
                         new=_on("cpu", out[0]),
                         cohort_losses=out[1]["cohort_losses"].cpu(),
                         mean_loss=out[1]["mean_local_loss"].cpu(),
                         steps=stack.max_steps, held=getattr(
                             server.runtime, "held_trainable_bytes", None)))
        return out

    server.runtime.run_stacked = recorded
    return seen


def _against_vectorized(torch, rt, start, t, stack, new):
    """A round on a mesh (``new``, from ``start`` on ``stack``) against the
    vectorized runtime's round from the same params on the same stack, at
    main path 6's bar: TOL of the vectorized round's largest update, or
    10x its own movement under a 1e-7 relative change of its start where
    that exceeds TOL / 10.  Returns (rel, bar, movement)."""
    from repro_torch.common.tree import tree_map
    on = _on(rt.device, start)
    ref, _ = rt.run_stacked(on, t, stack)
    moved, _ = rt.run_stacked(tree_map(lambda p: p * (1 + 1e-7), on), t,
                              stack)
    ref, moved = _on("cpu", ref), _on("cpu", moved)
    _, begin = rt.adapter.split_stage(start, t)
    sens = _update_rel(moved, ref, begin)
    bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
    return _update_rel(new, ref, begin), bar, sens


def three_cohort_stack(server):
    """10b's padded round: clients 0-2 of main path 1's fleet, one epoch,
    their batchers seeded afresh (the same stack in every process)."""
    from repro_torch.data.loader import Batcher, stack_round
    batchers = [Batcher(server.batchers[c].ds, server.flc.batch_size,
                        seed=SEED + c, kind="image") for c in range(3)]
    return stack_round(batchers, range(3), local_epochs=1)


def mesh_1x1_path(torch, kernels, np):
    """10a, ``resnet18-sharded-1x1``: main path 1's server with
    ``runtime="sharded"`` on this process's one-rank NCCL mesh, MESH_ROUNDS
    rounds, against a vectorized run of the same server: every round's
    params, cohort losses and mean loss the same bits, K1-K3 twice a
    vectorized step.  Returns the rows (the held bytes of each stage) and
    the vectorized rounds' stacks; destroys the process group."""
    import torch.distributed as dist
    out = {}
    vec = cnn_server(np, quiet=True, runtime="vectorized")
    vseen = mesh_record(vec)
    vrounds = run_rounds(torch, vec, kernels, MESH_ROUNDS, quiet=True)
    del vec.runtime.run_stacked
    sh = cnn_server(np, quiet=True, runtime="sharded")
    mesh = sh.runtime.mesh
    out["mesh"] = dict(mesh.shape, backend=mesh.backend)
    check(mesh.shape == {"data": 1, "model": 1} and mesh.backend == "nccl",
          f"10a: a one-rank NCCL mesh expected, got {out['mesh']}")
    sseen = mesh_record(sh)
    reset_all(kernels)
    srounds = run_rounds(torch, sh, kernels, MESH_ROUNDS, quiet=True)
    counts = read_all(kernels)
    del sh.runtime.run_stacked
    rows = []
    for r, (v, s, vr, sr) in enumerate(zip(vseen, sseen, vrounds,
                                           srounds)):
        bits = (all(torch.equal(a, b) for a, b in zip(
            _leaves(v["new"]), _leaves(s["new"]), strict=True))
            and torch.equal(v["cohort_losses"], s["cohort_losses"])
            and torch.equal(v["mean_loss"], s["mean_loss"]))
        rows.append(dict(round=r, stage=s["t"], bits=bits,
                         vectorized_seconds=vr["seconds"],
                         sharded_seconds=sr["seconds"], steps=s["steps"],
                         launches=sr["launches"],
                         held_trainable_bytes=s["held"]))
        print(f"  round {r} (stage {s['t']}): sharded {sr['seconds']:.3f} "
              f"s/round, vectorized {vr['seconds']:.3f}; the same bits: "
              f"{bits}; held {s['held']} bytes", flush=True)
        check(bits, f"10a round {r}: the 1x1 sharded round is not the "
              f"vectorized round's bits")
        check(all(sr["launches"][n] == 2 * s["steps"] for n in STREAMING),
              f"10a round {r}: launches {sr['launches']}, expected 2 a "
              f"vectorized step ({s['steps']})")
    check(all(torch.equal(a, b) for a, b in zip(
        _leaves(vec.params), _leaves(sh.params), strict=True)),
          "10a: the servers' params differ after the rounds")
    out["rounds"] = rows
    dist.destroy_process_group()
    stacks = [v["stack"] for v in vseen]
    del vec, sh, vseen, sseen
    gc.collect()
    torch.cuda.empty_cache()
    return out, stacks, counts


def _run_children(kind, world, directory):
    """``world`` children of this script (``--mesh-child``), started
    together and waited for; each rank's JSON result and the seconds."""
    import subprocess
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(directory, f"{kind}_rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.realpath(__file__), "--mesh-child",
             directory, str(rank), str(world), kind], stdout=log,
            stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=MESH_CHILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    seconds = time.perf_counter() - t0
    if any(codes):
        tails = []
        for rank in range(world):
            with open(os.path.join(directory,
                                   f"{kind}_rank{rank}.log")) as f:
                tails.append(f"--- rank {rank}:\n{f.read()[-3000:]}")
        raise SmokeError(f"{kind} children exited with {codes}:\n"
                         + "\n".join(tails))
    results = []
    for rank in range(world):
        with open(os.path.join(directory, f"{kind}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results, seconds


def _child_rounds(torch, kernels, server, n):
    """``n`` rounds of a mesh child's server, recorded: per round its
    stage, vectorized steps, K1-K3 launches, seconds, held bytes, the
    digests of its stack and new trainable and its losses; and each
    round's (start params, new trainable) on the host."""
    seen = mesh_record(server)
    reset_all(kernels)
    rounds = run_rounds(torch, server, kernels, n, quiet=True)
    del server.runtime.run_stacked
    rows = [dict(stage=s["t"], steps=s["steps"], launches=r["launches"],
                 seconds=r["seconds"], held=s["held"],
                 stack=_stack_digest(s["stack"]), digest=_digest(s["new"]),
                 cohort_losses=s["cohort_losses"].tolist(),
                 mean_loss=float(s["mean_loss"]))
            for s, r in zip(seen, rounds)]
    return rows, [(s["start"], s["new"]) for s in seen]


def _host_numbers(rounds):
    """What a run's host decides, round by round: cohorts' counts,
    feasibility, upload bytes, simulated time, version, whether the round
    flushed (its loss is NaN where not), and the async log's deliveries,
    flushes and staleness."""
    keys = ("round_idx", "stage", "n_selected", "n_feasible",
            "upload_bytes", "sim_time", "server_version")
    log = ("vectorized_steps", "cohorts", "delivered", "staleness",
           "n_uploads", "n_pending", "n_carried", "n_evicted",
           "server_version", "sim_round_time")
    return [dict({k: r[k] for k in keys},
                 lost=math.isnan(r["mean_loss"]),
                 log=None if r["async"] is None
                 else {k: r["async"][k] for k in log})
            for r in rounds]


def mesh_child(directory, rank, world, kind):
    """One rank of main path 10's worlds, in its own process (the ranks
    sharing the card over gloo; the kernels the parent built, loaded):
    ``"2x1"`` runs 10b (main path 1's server on the sharded runtime,
    MESH_ROUNDS rounds, then one 3-cohort round) and 10c (main path 9's
    async server, ASYNC_ROUNDS rounds, checkpointing every ASYNC_EVERY);
    ``"2x2"`` runs 10d (the same server with ``model_parallel=2``), the
    throughput's model-parallel rows and the example's third leg.  Rank 0
    writes the rounds' params; every rank its JSON."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.kernels.build import library_path
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.hsic_gram import kernel
    from repro_torch.kernels.slstm_scan import kernel as skernel
    from repro_torch.launch.mesh import init_rank
    rank, world = int(rank), int(world)
    kernels = (kernel, fkernel, skernel)
    card_settings(torch)
    for k in kernels:
        if not library_path(k.SOURCE).exists():
            print(f"mesh child: {k.SOURCE} is not built", file=sys.stderr)
            return 3
        k.library()
    device = init_rank(rank, world, "cuda", os.path.join(directory,
                                                         "store"))
    out = {"rank": rank}
    saved = {}
    t0 = time.perf_counter()
    if kind == "2x1":
        server = cnn_server(np, quiet=True, runtime="sharded")
        out["mesh"] = dict(server.runtime.mesh.shape)
        out["rounds"], saved["rounds"] = _child_rounds(
            torch, kernels, server, MESH_ROUNDS)
        stack = three_cohort_stack(server)
        params = server.adapter.init_params(SEED, server.device)
        reset_all(kernels)
        new, m = server.runtime.run_stacked(params, 1, stack)
        out["pad"] = dict(digest=_digest(new), launches=read_all(kernels),
                          steps=stack.max_steps,
                          cohort_losses=m["cohort_losses"].tolist())
        saved["pad"] = _on("cpu", new)
        del server, new
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds_10b"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        server = cnn_server(np, quiet=True, checkpoint_dir=os.path.join(
            directory, "async_ckpt"), **ASYNC_CKPT, **ASYNC_KW)
        out["async_mesh"] = dict(server.runtime.mesh.shape)
        log = watch_async(torch, np, server)
        rounds, saved["async"] = [], []
        for _ in range(ASYNC_ROUNDS):
            rounds += run_rounds(torch, server, kernels, 1, quiet=True)
            saved["async"].append(_on("cpu", server.params))
        del server.runtime.run_stacked
        async_launch_check(rounds, log, lambda a: {
            n: 2 * a["vectorized_steps"] for n in STREAMING})
        out["async"] = dict(
            host=_host_numbers(rounds),
            launches={n: sum(r["launches"][n] for r in rounds)
                      for n in rounds[0]["launches"]},
            buffer=check_async_log(log, server.runtime.state,
                                   "10c async ResNet18"),
            digest=_digest(server.params),
            seconds=[r["seconds"] for r in rounds])
        out["seconds_10c"] = time.perf_counter() - t1
    else:
        from repro_torch.benchmarks import fl_round_throughput as flr
        from repro_torch.examples import async_fedbuff
        server = cnn_server(np, quiet=True, runtime="sharded",
                            model_parallel=2)
        out["mesh"] = dict(server.runtime.mesh.shape)
        out["rounds"], saved["rounds"] = _child_rounds(
            torch, kernels, server, MESH_ROUNDS)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds_10d"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out["throughput"] = [flr.bench_model_parallel(
            device, kind_, 2, C, B, E, iters=2)
            for kind_, C, B, E in flr.ASYNC_SETTINGS]
        out["seconds_throughput"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        reset_all(kernels)
        out["example"] = async_fedbuff.mesh_leg(
            device, int(os.environ.get("FEDBUFF_ROUNDS", "6")),
            async_fedbuff.N_TRAIN, async_fedbuff.N_TEST)
        out["example"]["launches"] = read_all(kernels)
        out["seconds_example"] = time.perf_counter() - t1
    if rank == 0:
        torch.save(saved, os.path.join(directory, f"{kind}_params.pt"))
    with open(os.path.join(directory, f"{kind}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _world_rounds_check(torch, name, results, saved, stacks, rt):
    """A world's rounds: every rank the same bits and the stacks of 10a's
    run, each round against the vectorized round from its own start
    params on the same stack (``_against_vectorized``), K1-K3 twice a
    vectorized step on each rank."""
    rows = []
    for r, ((start, new), stack) in enumerate(zip(saved, stacks)):
        mine = results[0]["rounds"][r]
        rel, bar, sens = _against_vectorized(torch, rt, start,
                                             mine["stage"], stack, new)
        row = dict(round=r, stage=mine["stage"], rel=rel, bar=bar,
                   vectorized_eps_rel=sens,
                   ranks_same=len({res["rounds"][r]["digest"]
                                   for res in results}) == 1,
                   stack_is_10a=all(res["rounds"][r]["stack"]
                                    == _stack_digest(stack)
                                    for res in results),
                   launches_ok=all(
                       res["rounds"][r]["launches"][n]
                       == 2 * res["rounds"][r]["steps"]
                       for res in results for n in STREAMING),
                   seconds=[res["rounds"][r]["seconds"] for res in results],
                   held_trainable_bytes=mine["held"])
        rows.append(row)
        print(f"  round {r} (stage {row['stage']}): {rel:.2e} of the "
              f"largest update off the vectorized round from the same "
              f"params (bar {bar:.1e}); s/round by rank "
              f"{[round(x, 3) for x in row['seconds']]}; held "
              f"{row['held_trainable_bytes']} bytes; ranks the same bits: "
              f"{row['ranks_same']}", flush=True)
        check(row["ranks_same"] and row["stack_is_10a"],
              f"{name} round {r}: the ranks differ, or the stack is not "
              f"10a's: {row}")
        check(rel <= bar, f"{name} round {r}: {rel:.2e} of the largest "
              f"update off the vectorized round (bar {bar:.1e})")
        check(row["launches_ok"], f"{name} round {r}: K1-K3 not twice a "
              f"vectorized step on every rank: "
              f"{[res['rounds'][r]['launches'] for res in results]}")
    return rows


def _sum_launches(rows):
    total = {}
    for row in rows:
        for n, c in row["launches"].items():
            total[n] = total.get(n, 0) + c
    return total


def _child_counts(results, *parts):
    """K1-K7 launches of a world's main-path runs, summed over ranks."""
    total = {}
    for res in results:
        for part in parts:
            for n, c in part(res).items():
                total[n] = total.get(n, 0) + c
    return total


def _async_replay(torch, np, directory, k, world_after):
    """10c's round k + 1 replayed in this process (the one-process async
    runtime) from the world's state after k rounds (a fresh server, or
    the world's round-k checkpoint), against the world's params after it
    at main path 6's bar (its own movement from params x (1 + 1e-7))."""
    from repro_torch.checkpoint import checkpoint_path
    from repro_torch.common.tree import tree_map
    from repro_torch.federated.server import NeuLiteServer

    def server():
        if k == 0:
            return cnn_server(np, quiet=True, **ASYNC_KW)
        adapter, clients, flc, test = cnn_setup(**ASYNC_KW)
        return NeuLiteServer.restore(adapter, clients, flc, checkpoint_path(
            os.path.join(directory, "async_ckpt"), k), test_batcher=test)

    srv = server()
    check(srv.runtime.mesh is None and srv.next_round == k,
          f"10c replay {k}: not a one-process async server at round {k}")
    start = _on("cpu", srv.params)
    srv.run(1)
    new = _on("cpu", srv.params)
    srv = server()
    srv.params = tree_map(lambda p: p * (1 + 1e-7), srv.params)
    srv.run(1)
    sens = _update_rel(_on("cpu", srv.params), new, start)
    bar = max(TOL, 10 * sens) if sens > TOL / 10 else TOL
    rel = _update_rel(world_after[k], new, start)
    return dict(after=k, rel=rel, bar=bar, one_process_eps_rel=sens)


def mesh_2x1_path(torch, kernels, np, stacks, rt, asy, directory):
    """10b, ``resnet18-sharded-2x1``, and 10c,
    ``resnet18-async-sharded-2x1``, in one world of 2 (``mesh_child``).
    10b: the ranks the same bits, each round within main path 6's bar of
    the vectorized round from its own start, K1-K3 twice a vectorized
    step on each rank; the 3-cohort round (one cohort padded) likewise.
    10c: the host numbers of main path 9's run to the last one, the ranks
    the same bits, the rounds after ASYNC_REPLAYS replayed in one process
    within the bar, and the round-4 checkpoint restored here giving the
    world's round-4 params and buffer to the bit."""
    from repro_torch.checkpoint import checkpoint_path
    from repro_torch.federated.server import NeuLiteServer
    results, seconds = _run_children("2x1", 2, directory)
    saved = torch.load(os.path.join(directory, "2x1_params.pt"))
    check(results[0]["mesh"] == {"data": 2, "model": 1},
          f"10b: mesh {results[0]['mesh']}")
    out = {"seconds": seconds, "mesh": results[0]["mesh"],
           "child_seconds": {k: results[0][k] for k in ("seconds_10b",
                                                        "seconds_10c")},
           "rounds": _world_rounds_check(torch, "10b", results,
                                         saved["rounds"], stacks, rt)}
    server = cnn_server(np, quiet=True, runtime="vectorized")
    stack = three_cohort_stack(server)
    params = _on("cpu", server.adapter.init_params(SEED, "cpu"))
    del server
    rel, bar, sens = _against_vectorized(torch, rt, params, 1, stack,
                                         saved["pad"])
    pad = [res["pad"] for res in results]
    out["pad"] = dict(rel=rel, bar=bar, vectorized_eps_rel=sens,
                      cohort_losses=pad[0]["cohort_losses"])
    check(len({p["digest"] for p in pad}) == 1 and rel <= bar
          and len(pad[0]["cohort_losses"]) == 3
          and all(p["launches"][n] == 2 * p["steps"] for p in pad
                  for n in STREAMING),
          f"10b: the 3-cohort round: {out['pad']}, {pad}")
    print(f"  3 cohorts on 2 ranks (one padded): {rel:.2e} of the largest "
          f"update off the vectorized round (bar {bar:.1e}), cohort losses "
          f"{pad[0]['cohort_losses']}", flush=True)
    # 10c against main path 9 and the one-process runtime
    a = results[0]["async"]
    want = _host_numbers(asy["rounds"])
    same_host = all(res["async"]["host"] == want for res in results)
    out["async"] = dict(mesh=results[0]["async_mesh"], host_same=same_host,
                        buffer=a["buffer"],
                        ranks_same=len({r["async"]["digest"]
                                        for r in results}) == 1,
                        seconds=a["seconds"])
    print(f"  10c: mesh {results[0]['async_mesh']}; host numbers equal main "
          f"path 9's: {same_host}; buffer {a['buffer']}; s/round "
          f"{[round(x, 3) for x in a['seconds']]}", flush=True)
    check(same_host, f"10c: the host numbers differ from main path 9's: "
          f"{[res['async']['host'] for res in results]} against {want}")
    check(out["async"]["ranks_same"], "10c: the ranks' params differ")
    replays = [_async_replay(torch, np, directory, k, saved["async"])
               for k in ASYNC_REPLAYS]
    out["async"]["replays"] = replays
    shown = ", ".join(f"after {r['after']}: {r['rel']:.2e} (bar "
                      f"{r['bar']:.1e})" for r in replays)
    print(f"  10c: a round replayed in one process from the world's "
          f"state, against the world's: {shown}", flush=True)
    check(all(r["rel"] <= r["bar"] for r in replays),
          f"10c: a replayed round off the world's: {replays}")
    adapter, clients, flc, test = cnn_setup(**ASYNC_KW)
    restored = NeuLiteServer.restore(
        adapter, clients, flc, checkpoint_path(os.path.join(
            directory, "async_ckpt"), 4), test_batcher=test)
    restore_bits = (
        all(torch.equal(x.cpu(), y) for x, y in zip(
            _leaves(restored.params), _leaves(saved["async"][3]),
            strict=True))
        and restored.runtime.mesh is None
        and restored.runtime.state.version
        == a["host"][3]["server_version"])
    out["async"]["round4_restored_bits"] = restore_bits
    check(restore_bits, "10c: the world-2 run's round-4 checkpoint, restored "
          "in one process, is not its round-4 params")
    print("  10c: the round-4 checkpoint restored in this process: the "
          "world's round-4 params to the bit", flush=True)
    del restored, saved
    gc.collect()
    torch.cuda.empty_cache()
    counts = _child_counts(results, lambda r: _sum_launches(r["rounds"]),
                           lambda r: r["pad"]["launches"],
                           lambda r: r["async"]["launches"])
    return out, counts


def mesh_2x2_path(torch, kernels, np, stacks, rt, held_1x1, directory):
    """10d, ``resnet18-sharded-2x2``: a world of 4 (data 2 x model 2,
    ``mesh_child``): the ranks the same bits, each round within the bar of
    the vectorized round from its own start, ``held_trainable_bytes``
    below MESH_HELD_BAR of 10a's at every stage, K1-K3 twice a vectorized
    step on each rank; then, in that world, the throughput's
    ``--model-parallel 2`` rows (added to BENCH_FL_OUT) and the example's
    third leg."""
    from repro_torch.benchmarks import fl_round_throughput as flr
    results, seconds = _run_children("2x2", 4, directory)
    saved = torch.load(os.path.join(directory, "2x2_params.pt"))
    check(results[0]["mesh"] == {"data": 2, "model": 2},
          f"10d: mesh {results[0]['mesh']}")
    rows = _world_rounds_check(torch, "10d", results, saved["rounds"],
                               stacks, rt)
    for row, whole in zip(rows, held_1x1):
        row["held_1x1"] = whole
        row["held_ratio"] = row["held_trainable_bytes"] / whole
        check(row["held_ratio"] < MESH_HELD_BAR,
              f"10d round {row['round']}: held {row['held_ratio']:.3f} of "
              f"10a's (bar {MESH_HELD_BAR})")
    print(f"  held against 10a: "
          f"{[round(r['held_ratio'], 4) for r in rows]}", flush=True)
    tput = results[0]["throughput"]
    flr.merge_bench_json(BENCH_FL_OUT, {"model_parallel": tput},
                         torch.device("cuda"))
    for row in tput:
        base = row["rows"]["replicated"]["held_trainable_bytes"]
        for name, r in row["rows"].items():
            print(f"  throughput {row['model']} mesh {row['mesh']} {name}: "
                  f"{r['rounds_per_s']:.2f} rounds/s, held "
                  f"{r['held_trainable_bytes']} bytes "
                  f"({r['held_trainable_bytes'] / base:.3f}x)", flush=True)
    ex = results[0]["example"]
    check(ex["mesh"] == {"data": 2, "model": 2}
          and 0.0 <= ex["acc"] <= 1.0 and ex["server_version"] > 0,
          f"10d: the example's third leg: {ex}")
    print(f"  the example's third leg: mesh {ex['mesh']}, acc "
          f"{ex['acc']:.4f}, simulated {ex['sim_time']:.1f} s, server "
          f"version {ex['server_version']}", flush=True)
    out = {"seconds": seconds, "rounds": rows, "throughput": tput,
           "example": ex,
           "child_seconds": {k: results[0][k] for k in (
               "seconds_10d", "seconds_throughput", "seconds_example")}}
    return out, _child_counts(results, lambda r: _sum_launches(r["rounds"]))


def mesh_path(torch, kernels, np, asy):
    """Main path 10: 10a in this process, then 10b and 10c in a world of 2
    and 10d in a world of 4, all on this card; each part's seconds."""
    import tempfile
    took, out = {}, {}
    t0 = time.perf_counter()
    out["1x1"], stacks, counts = mesh_1x1_path(torch, kernels, np)
    took["10a"] = time.perf_counter() - t0
    held = [row["held_trainable_bytes"] for row in out["1x1"]["rounds"]]
    # the one-process reference of 10b-10d's rounds
    rt = cnn_server(np, quiet=True, runtime="vectorized").runtime
    with tempfile.TemporaryDirectory(prefix="neulite-mesh-") as tmp:
        t1 = time.perf_counter()
        d2 = os.path.join(tmp, "2x1")
        os.makedirs(d2)
        out["2x1"], c2 = mesh_2x1_path(torch, kernels, np, stacks, rt, asy,
                                       d2)
        took["10b+10c"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        d4 = os.path.join(tmp, "2x2")
        os.makedirs(d4)
        out["2x2"], c4 = mesh_2x2_path(torch, kernels, np, stacks, rt, held,
                                       d4)
        took["10d"] = time.perf_counter() - t1
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    took["total"] = time.perf_counter() - t0
    out["seconds"] = took
    print(f"  main path 10 parts (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return out, {"mesh_1x1": counts, "mesh_2x1": c2, "mesh_2x2": c4}


# --------------------------------------------------------------------------- #
# main path 11: serving (prefill through K4 and K5, one-token decode)
# --------------------------------------------------------------------------- #
# 11a's f32 checks (batch, prompt, decode steps) and its bf16 serve run
SERVE_QWEN3 = (2, 256, 16)
SERVE_ARGV = ["--arch", "qwen3-1.7b", "--full", "--batch", "4",
              "--prompt-len", "512", "--gen", "64"]
SERVE_H2O = (1, 4608, 8)          # 11b: a prompt past the 4096 window
SERVE_XLSTM = (4, 256, 16)        # 11c
SERVE_SMOKE = (2, 24, 12)         # 11d: the serving example's size
SERVE_SEED = 0


@contextlib.contextmanager
def slstm_shapes_seen():
    """The set of K5 cases (B, S, H, Dh), as SLSTM_CASES lists them, that
    the sLSTM scan op takes while the block runs."""
    from repro_torch.kernels.slstm_scan import ops as sops
    seen, scan = set(), sops.slstm_scan

    def recorded(g_in, r, b, state0):
        B, S, _, H, Dh = g_in.shape
        seen.add((B, S, H, Dh))
        return scan(g_in, r, b, state0)

    sops.slstm_scan = recorded
    try:
        yield seen
    finally:
        sops.slstm_scan = scan


def check_slstm_held(seen, where):
    """Every K5 case of ``seen`` is one the kernel phase held."""
    unheld = set(seen) - {c[:4] for c in SLSTM_CASES}
    check(not unheld, f"sLSTM scan shapes of {where} that the kernel phase "
          f"did not hold against the plain version: {unheld}")
    print(f"  K5 took {len(seen)} shapes in {where}, each held in the "
          f"kernel phase", flush=True)


def serve_params(torch, cfg, noise=False):
    """Random params of ``cfg`` drawn on the card from SERVE_SEED, as both
    serving entry points draw them; with ``noise`` each entry times
    (1 + 1e-7 n), n standard normal."""
    from repro_torch.common.paramdef import init_params
    from repro_torch.common.tree import tree_leaves
    from repro_torch.models import model as M
    params = init_params(SERVE_SEED, M.model_defs(cfg), "cuda",
                         draw_on_device=True)
    if noise:
        gen = torch.Generator("cuda").manual_seed(SERVE_SEED + 1)
        for p in tree_leaves(params):
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                          device=p.device, dtype=p.dtype))
    return params


def serve_prompt(torch, np, vocab, B, P):
    """numpy's integers at SERVE_SEED, as both serving entry points draw
    their prompts."""
    rng = np.random.default_rng(SERVE_SEED)
    return torch.from_numpy(rng.integers(0, vocab, (B, P))).cuda()


def serve_greedy(torch, kernels, cfg, params, prompt, steps):
    """Prefill, then ``steps`` greedy decode steps, launches counted per
    phase.  Returns (prefill logits, prefill caches, the fed tokens (B,
    steps): the prefill's argmax, then each step's, the decode steps'
    logits (B, steps, V), launches in the prefill, in the decode steps).
    The prefill caches are read before decode updates the grown ones."""
    from repro_torch.common.tree import tree_map
    from repro_torch.models import model as M
    B, P = prompt.shape
    with torch.no_grad():
        reset_all(kernels)
        logits, caches = M.prefill(params, cfg, {"tokens": prompt})
        torch.cuda.synchronize()
        pre = read_all(kernels)
        first = tree_map(lambda c: c.clone(), caches)
        caches = M.grow_caches(cfg, caches, B, P + steps)
        tok = logits[:, -1].argmax(-1)[:, None]
        fed, outs = [], []
        reset_all(kernels)
        for i in range(steps):
            fed.append(tok)
            lg, caches = M.decode_step(params, cfg, {"tokens": tok}, caches,
                                       P + i)
            tok = lg[:, 0].argmax(-1)[:, None]
            outs.append(lg)
        torch.cuda.synchronize()
        dec = read_all(kernels)
    return logits, first, torch.cat(fed, 1), torch.cat(outs, 1), pre, dec


def plain_logits(torch, cfg, params, tokens, positions):
    """The plain forward (``use_flash_kernel`` and ``use_slstm_kernel``
    off) over ``tokens``; the logits at ``positions``."""
    from repro_torch.models import model as M
    plain = dataclasses.replace(cfg, use_flash_kernel=False,
                                use_slstm_kernel=False)
    with torch.no_grad():
        x, pos, _ = M.embed_inputs(params, plain, {"tokens": tokens})
        x = M._run_periods(params["layers"], plain, x, pos)
        x = M.rmsnorm(params["final_norm"], x[:, positions], plain.norm_eps)
        return M.lm_head(params["head"], x).float()


def bar_of(moved):
    """The check's bar: TOL, or 10x the plain side's own movement under a
    random 1e-7 change of its params where that exceeds TOL / 10."""
    return max(TOL, 10 * moved) if moved > TOL / 10 else TOL


def decode_check(torch, np, kernels, name, cfg, B, P, steps, counts,
                 per_prefill, per_layer=False):
    """One model served greedily on the card against its plain forward:
    the prefill's last logits and each decode step's against the plain
    forward over the prompt and the fed tokens at that position, at the
    bar of ``bar_of`` (the plain forward again from the params with noise);
    the launches: ``per_prefill`` of each kernel in the prefill, none in
    decode; with ``per_layer`` also ``layer_check``.  Adds the launches
    to ``counts``; returns the row and the prompt and the prefill's
    logits and caches."""
    params = serve_params(torch, cfg)
    prompt = serve_prompt(torch, np, cfg.vocab_size, B, P)
    t0 = time.perf_counter()
    logits, caches, fed, steps_lg, pre, dec = serve_greedy(
        torch, kernels, cfg, params, prompt, steps)
    serve_s = time.perf_counter() - t0
    for n in counts:
        counts[n] += pre[n] + dec[n]
    want_pre = {n: per_prefill.get(n, 0) for n in pre}
    check(pre == want_pre and not any(dec.values()),
          f"{name}: launches in the prefill {pre} (expected {want_pre}), "
          f"in {steps} decode steps {dec} (expected none)")
    seq = torch.cat([prompt, fed], 1)
    positions = list(range(P - 1, P + steps))
    got = torch.cat([logits, steps_lg], 1).float()
    want = plain_logits(torch, cfg, params, seq, positions)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    rel, ab = rel_abs(got, want)
    del params
    moved, _ = rel_abs(plain_logits(torch, cfg, serve_params(
        torch, cfg, noise=True), seq, positions), want)
    bar = bar_of(moved)
    check(rel <= bar, f"{name}: decode against the plain forward rel err "
          f"{rel} (bar {bar})")
    layers = (layer_check(torch, name, cfg, serve_params(torch, cfg), seq,
                          P, steps) if per_layer else None)
    row = {"batch": B, "prompt": P, "steps": steps, "rel_err": rel,
           "abs_err": ab, "plain_moved": moved, "bar": bar,
           "prefill_launches": pre, "decode_launches": dec,
           "greedy_s": serve_s, "tokens": fed.cpu().tolist(),
           "layers": layers}
    print(f"  {name} (B {B}, prompt {P}, {steps} decode steps): prefill "
          f"and decode logits against the plain forward rel err {rel:.2e} "
          f"(abs {ab:.2e}; the plain forward moves {moved:.2e} under a "
          f"1e-7 change, bar {bar:.1e}); launches in the prefill "
          f"{ {n: c for n, c in pre.items() if c} }, in decode none; "
          f"prefill + decode {serve_s:.2f} s", flush=True)
    return row, (prompt, logits, caches)


def prefill_check(torch, name, cfg, prompt, logits, caches):
    """The prefill through the kernels (``logits``, ``caches``) against
    the plain prefill on the same params and prompt: the last logits and
    every cache leaf, each at its bar (the plain prefill again from the
    params with noise)."""
    from repro_torch.common.tree import flatten_paths
    from repro_torch.models import model as M
    plain = dataclasses.replace(cfg, use_flash_kernel=False,
                                use_slstm_kernel=False)

    def run(params):
        with torch.no_grad():
            lg, c = M.prefill(params, plain, {"tokens": prompt})
        return {"logits": lg.float(), **flatten_paths(c)}

    want = run(serve_params(torch, cfg))
    got = {"logits": logits.float(), **flatten_paths(caches)}
    moved = run(serve_params(torch, cfg, noise=True))
    rows = {}
    for key, w in want.items():
        rel, ab = rel_abs(got[key].float(), w.float())
        mv, _ = rel_abs(moved[key].float(), w.float())
        bar = bar_of(mv)
        check(rel <= bar and bool(torch.isfinite(got[key]).all()),
              f"{name}: prefill {key} through the kernels against the "
              f"plain prefill rel err {rel} (bar {bar})")
        rows[key] = {"rel_err": rel, "abs_err": ab, "plain_moved": mv,
                     "bar": bar}
    worst = max(rows, key=lambda k: rows[k]["rel_err"] / rows[k]["bar"])
    print(f"  {name}: prefill through the kernels against the plain "
          f"prefill, {len(rows)} outputs (logits and cache leaves) each at "
          f"its bar; worst {worst}: rel err {rows[worst]['rel_err']:.2e} "
          f"(bar {rows[worst]['bar']:.1e})", flush=True)
    return rows


def layer_check(torch, name, cfg, params, seq, P, steps):
    """Each sub-layer's mixer alone, fed the plain forward's own input to
    it (so that a model chaotic at init, whose whole-model logits move by
    O(1) under a 1e-7 change, is still held at TOL): its prefill of the
    first P positions through the kernels (with cache), then its decode
    of positions P .. P + steps - 1, against the plain mixer over the
    whole sequence, at TOL of its largest entry; an sLSTM layer's final
    (c, n, m, h) through K5 against the plain scan's on the same input.
    (The mixer's output, not the sub-layer's less its input: that
    difference loses the stream's f32 digits to cancellation.)  ``seq``
    is the tokens, or a model's inputs dict (audio: its embeddings).
    Returns the worst error of each part."""
    import torch.nn.functional as F
    from repro_torch.common.tree import tree_map
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    plain = dataclasses.replace(cfg, use_flash_kernel=False,
                                use_slstm_kernel=False)
    worst = {"prefill": 0.0, "decode": 0.0, "slstm_state": 0.0}
    with torch.no_grad():
        x, pos, _ = M.embed_inputs(params, plain, seq if isinstance(
            seq, dict) else {"tokens": seq})
        B, S = x.shape[:2]
        for i in range(cfg.num_periods):
            period = tree_map(lambda a, i=i: a[i], params["layers"])
            for j, (kind, ffn) in enumerate(cfg.pattern):
                sub = period[f"sub{j}"]
                h = M.rmsnorm(sub["norm1"], x, cfg.norm_eps)
                want, pc = M._mixer_forward(sub["mixer"], plain, kind, h,
                                            pos, True)
                got, cache = M._mixer_forward(sub["mixer"], cfg, kind,
                                              h[:, :P], pos[:, :P], True)
                rel, _ = rel_abs(got, want[:, :P])
                worst["prefill"] = max(worst["prefill"], rel)
                if kind == "slstm":
                    _, pc = M._mixer_forward(sub["mixer"], plain, kind,
                                             h[:, :P], pos[:, :P], True)
                    rel_s, _ = rel_abs([cache[k] for k in STATE],
                                       [pc[k] for k in STATE])
                    worst["slstm_state"] = max(worst["slstm_state"], rel_s)
                if kind == "attn":        # GQA or MLA: grown along S
                    defs = attn.attn_cache_defs(cfg, B, S)
                    cache = {k: F.pad(c, (0, 0) * (c.dim() - 2) + (
                        0, defs[k].shape[1] - c.shape[1]))
                        for k, c in cache.items()}
                for t in range(P, P + steps):
                    got, cache = M._mixer_decode(sub["mixer"], cfg, kind,
                                                 h[:, t:t + 1], cache, t)
                    rel, _ = rel_abs(got, want[:, t:t + 1])
                    worst["decode"] = max(worst["decode"], rel)
                x = M._ffn_apply(sub, plain, ffn, x + want)
    check(all(v <= TOL for v in worst.values()),
          f"{name}: a layer alone against the plain layer: {worst}")
    print(f"  {name}: each of the {cfg.num_layers} mixers alone on the "
          f"plain forward's input, through the kernels against the plain "
          f"mixer: prefill {worst['prefill']:.2e}, decode "
          f"{worst['decode']:.2e}"
          + (f", sLSTM final states {worst['slstm_state']:.2e}"
             if cfg.xlstm else "") + f" (bar {TOL:.0e})", flush=True)
    return worst


def serve_bounds(cfg, B, P, gen):
    """The least time of one bf16 prefill of B x P tokens and of one decode
    step, on the card's peak rates.  Prefill: the products 2 N' (B P) of
    the params other than the embedding table and the head, the head on B
    last positions, attention's QK^T and PV on the causal pairs (4 D FLOPs
    a pair and head), at the bf16 rate; or every param read once.  Decode:
    every param read once except the embedding table (B rows of it) and
    the valid cache slots read once, averaged over the steps; or its
    products.  Returns (prefill ms, bound by, decode ms, bound by)."""
    from repro_torch.models import model as M
    size = 2
    n = M.total_param_count(cfg)
    table = head = cfg.vocab_size * cfg.d_model
    body = n - table - head
    Dh, L = cfg.resolved_head_dim, cfg.num_layers
    attn = 4 * B * cfg.num_heads * Dh * (P * (P + 1) // 2) * L
    flops = 2 * body * B * P + 2 * head * B + attn
    t_ops = flops / BF16_PRODUCT_FLOPS_PER_S * 1e3
    t_bytes = n * size / HBM_BYTES_PER_S * 1e3
    prefill = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
               else "bytes")
    slots = statistics.mean(P + i + 1 for i in range(gen - 1))
    cache = 2 * L * B * cfg.num_kv_heads * Dh * slots * size
    d_bytes = ((n - table) + B * cfg.d_model) * size + cache
    d_flops = 2 * (n - table) * B + 4 * B * cfg.num_heads * Dh * slots * L
    t_bytes = d_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = d_flops / BF16_PRODUCT_FLOPS_PER_S * 1e3
    decode = (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
              else "bytes")
    return (*prefill, *decode)


def decode_profile(torch, np, cfg, B, P, steps=8):
    """Where an eager decode step's time goes: ``cfg`` on the card after a
    prefill of B x P, two warm-up steps, then the host clock around each
    of ``steps`` greedy steps (a synchronize after each; median), and one
    step under ``torch.profiler`` (CPU and CUDA activity): its device ops,
    device busy ms (``device_busy_ms``), the idle share of the median
    step, and the kernel launches the host made."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    params = serve_params(torch, cfg)
    prompt = serve_prompt(torch, np, cfg.vocab_size, B, P)
    with torch.no_grad():
        logits, caches = M.prefill(params, cfg, {"tokens": prompt})
        caches = M.grow_caches(cfg, caches, B, P + steps + 3)
        tok = logits[:, -1].argmax(-1)[:, None]
        times = []
        for i in range(steps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = M.decode_step(params, cfg, {"tokens": tok}, caches,
                                       P + i)
            tok = lg[:, 0].argmax(-1)[:, None]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            M.decode_step(params, cfg, {"tokens": tok}, caches,
                          P + steps + 2)
            torch.cuda.synchronize()
    ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
              for e in prof.events())
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernelEx")
                   for e in prof.events())
    busy = device_busy_ms(torch, prof, 1)
    wall = statistics.median(times[2:])
    out = {"ms_per_step": wall, "device_ops": ops, "launches": launches,
           "busy_ms": busy, "idle_share": 1 - busy / wall,
           "warmup_ms": times[:2]}
    print(f"  {cfg.name} {cfg.dtype} eager decode, B {B} after {P}: "
          f"{wall:.2f} ms a step (median of {steps}; warm-up steps "
          f"{times[0]:.1f}, {times[1]:.1f} ms); one profiled step: {ops} "
          f"device ops, {launches} kernel launches, device busy "
          f"{busy:.3f} ms, idle {out['idle_share']:.1%} of the step",
          flush=True)
    return out


def serve_qwen3_path(torch, np, kernels, counts):
    """11a qwen3-serve-full: qwen3-1.7b at full width.  In f32: the
    prefill through K4 against the plain prefill (last logits, every cache
    leaf), 16 greedy decode steps against the plain forward, the greedy
    tokens again from the seed to the bit.  Then ``launch/serve.main`` in
    the config's bf16, its times beside their bounds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="float32",
                              use_flash_kernel=True)
    B, P, steps = SERVE_QWEN3
    L = cfg.num_layers
    row, (prompt, logits, caches) = decode_check(
        torch, np, kernels, "11a qwen3-1.7b f32", cfg, B, P, steps, counts,
        {"flash_attention_fwd": L}, per_layer=True)
    row["prefill"] = prefill_check(torch, "11a qwen3-1.7b f32", cfg, prompt,
                                   logits, caches)
    del logits, caches
    again = serve_greedy(torch, kernels, cfg, serve_params(torch, cfg),
                         prompt, steps)
    for n in counts:
        counts[n] += again[4][n] + again[5][n]
    check(again[2].cpu().tolist() == row["tokens"],
          "11a: the greedy tokens from the seed differ between two runs")
    print(f"  11a: the {steps} greedy tokens again from the seed, the same "
          f"bits", flush=True)
    del again
    gc.collect()
    torch.cuda.empty_cache()

    reset_all(kernels)
    out = serve.main(SERVE_ARGV)
    got = read_all(kernels)
    for n in counts:
        counts[n] += got[n]
    bcfg = get_config("qwen3-1.7b")
    want = {n: (bcfg.num_layers if n == "flash_attention_fwd" else 0)
            for n in got}
    check(got == want, f"11a serve.main: launches {got}, expected {want} "
          f"(one K4 a layer in the prefill, none in decode)")
    toks = out.pop("tokens")
    check(toks.shape == (out["batch"], out["gen"])
          and 0 <= int(toks.min()) and int(toks.max()) < bcfg.vocab_size,
          f"11a serve.main: tokens {toks.shape}")
    pre_b, pre_by, dec_b, dec_by = serve_bounds(
        bcfg, out["batch"], out["prompt_len"], out["gen"])
    out.update(prefill_ms=out["prefill_s"] * 1e3,
               decode_ms_per_step=out["decode_s"] / out["decode_steps"] * 1e3,
               prefill_bound_ms=pre_b, prefill_bound_by=pre_by,
               decode_bound_ms=dec_b, decode_bound_by=dec_by,
               launches=got)
    print(f"  11a serve.main {' '.join(SERVE_ARGV)} (bf16): prefill "
          f"{out['prefill_ms']:.2f} ms (bound {pre_b:.2f} ms, {pre_by}), "
          f"decode {out['decode_ms_per_step']:.3f} ms/step (bound "
          f"{dec_b:.3f} ms, {dec_by}), {out['tokens_per_s']:.1f} tokens/s, "
          f"allocator peak {(out['peak_bytes'] or 0) / 2**30:.2f} GiB",
          flush=True)
    row["serve"] = out
    row["decode_profile"] = decode_profile(
        torch, np, dataclasses.replace(bcfg, use_flash_kernel=True),
        out["batch"], out["prompt_len"])
    return row


def serve_h2o_path(torch, np, kernels, counts):
    """11b h2o-serve-full-wrap: h2o-danube-3-4b at full width, f32, a
    4608-token prompt (past the 4096 window, not a multiple of it: the
    rolled cache), 8 decode steps against the plain forward."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"), dtype="float32",
                              use_flash_kernel=True)
    B, P, steps = SERVE_H2O
    row, _ = decode_check(torch, np, kernels, "11b h2o-danube-3-4b f32", cfg,
                          B, P, steps, counts,
                          {"flash_attention_fwd": cfg.num_layers},
                          per_layer=True)
    return row


def serve_xlstm_path(torch, np, kernels, counts):
    """11c xlstm-serve-full: xlstm-1.3b at full width, f32, 16 decode
    steps against the plain forward, then each layer alone: the prefill's
    final (c, n, m, h) of each sLSTM layer through K5 against the plain
    scan's on the same input (``layer_check``)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32",
                              use_slstm_kernel=True)
    B, P, steps = SERVE_XLSTM
    slstm = [f"sub{j}" for j, (k, _) in enumerate(cfg.pattern)
             if k == "slstm"]
    row, _ = decode_check(
        torch, np, kernels, "11c xlstm-1.3b f32", cfg, B, P, steps, counts,
        {"slstm_scan_fwd": cfg.num_periods * len(slstm)}, per_layer=True)
    return row


def serve_smoke_path(torch, np, kernels, counts):
    """11d: ``examples/serve_decode.main()`` at its own size, then each of
    its archs, qwen1.5-4b's smoke config (QKV bias) and qwen3-1.7b's with
    2 kv heads (GQA in decode) served greedily against the plain
    forward; the example's tokens equal the check's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve_decode
    reset_all(kernels)
    example = serve_decode.main()
    got = read_all(kernels)
    for n in counts:
        counts[n] += got[n]
    rows = {"example_launches": got}
    B, P, gen = SERVE_SMOKE
    check((B, P, gen) == (serve_decode.B, serve_decode.PROMPT,
                          serve_decode.GEN), "11d: not the example's size")
    cfgs = {a: get_smoke_config(a) for a in serve_decode.ARCHS}
    cfgs["qwen1.5-4b"] = get_smoke_config("qwen1.5-4b")
    cfgs["qwen3-1.7b-kv2"] = dataclasses.replace(
        get_smoke_config("qwen3-1.7b"), num_kv_heads=2)
    for name, cfg in cfgs.items():
        cfg = dataclasses.replace(cfg, use_flash_kernel=True,
                                  use_slstm_kernel=True)
        per = ({"slstm_scan_fwd": cfg.num_periods} if cfg.xlstm else
               {"flash_attention_fwd": cfg.num_layers})
        # the example's params and prompt
        rows[name], _ = decode_check(torch, np, kernels, f"11d {name}", cfg,
                                     B, P, gen - 1, counts, per)
        if name in example:
            check(example[name][:, :gen - 1].tolist() == rows[name]["tokens"],
                  f"11d {name}: the example's tokens are not the greedy "
                  f"tokens of the same params and prompt")
    return rows


def serving_path(torch, np, kernels):
    """Main path 11: 11a-11d, every K4 and K5 shape held by the kernel
    phase; the launches of the driven runs and the seconds of each part."""
    counts = {n: 0 for n in read_all(kernels)}
    out, took = {}, {}
    t0 = time.perf_counter()
    with flash_shapes_seen() as fseen, slstm_shapes_seen() as sseen:
        for key, fn in (("11a", serve_qwen3_path), ("11b", serve_h2o_path),
                        ("11c", serve_xlstm_path), ("11d", serve_smoke_path)):
            t1 = time.perf_counter()
            out[key] = fn(torch, np, kernels, counts)
            took[key] = time.perf_counter() - t1
            gc.collect()
            torch.cuda.empty_cache()
    check_flash_held(fseen, "main path 11")
    check_slstm_held(sseen, "main path 11")
    check(counts["flash_attention_fwd"] > 0 and counts["slstm_scan_fwd"] > 0
          and not any(counts[n] for n in STREAMING),
          f"main path 11: launches {counts}")
    took["total"] = time.perf_counter() - t0
    out["seconds"] = took
    print(f"  main path 11 parts (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return out, counts


# --------------------------------------------------------------------------- #
# main path 12: LLM training
# --------------------------------------------------------------------------- #
# 12a/12b: ``launch/train.py``'s ``main`` on qwen3-1.7b at full width in its
# bf16: 4 rounds (one a stage) over 256 clients, 2 a round (the 4096
# sequences give a client ~2 local steps), batch 8, seq 64; the E2E leg 3
# SGD full steps.  The reference's lr.
TRAIN_LR = 0.05
TRAIN_ARGV = ["--arch", "qwen3-1.7b", "--full", "--rounds", "4",
              "--clients", "256", "--cohort", "2", "--batch", "8",
              "--seq", "64", "--lr", str(TRAIN_LR), "--seed", str(SEED)]
TRAIN_E2E_ARGV = ["--arch", "qwen3-1.7b", "--full", "--e2e", "--rounds", "1",
                  "--local-steps", "3", "--batch", "8", "--seq", "64",
                  "--lr", str(TRAIN_LR), "--seed", str(SEED)]
BUILDER_BATCH = (4, 256)          # 12c: (B, S) of the builders' steps
BUILDER_PROMPT = (2, 256)         # 12c: the prefill's (B, P), as 11a's
MUSICGEN_TRAIN = (4, 256, 4)      # 12e: B, S, decode steps after S
MUSICGEN_DEPTH = 24               # 12e: depth cut 48 -> 24, for the time
# 12f: llava-next-34b's depth cut 60 -> 2 layers (4 until the run's time
# needed it), B 2, 128 text tokens after its 2880 patches
LLAVA_DEPTH, LLAVA_BATCH, LLAVA_TEXT = 2, 2, 128


def llava_config(depth=LLAVA_DEPTH):
    """12f's config: llava-next-34b at full width, its heads padded by
    ``resolve_config`` (56 -> 64 over 8 of 128), ``depth`` layers, f32,
    attention through K4."""
    from repro_torch.configs import SHAPES, get_config, resolve_config
    cfg = resolve_config(get_config("llava-next-34b"), SHAPES["train_4k"])
    return dataclasses.replace(cfg, num_layers=depth, dtype="float32",
                               use_flash_kernel=True)


def train_nhsic_shapes():
    """Main path 12's nHSIC shapes: qwen3-1.7b's in 12a (B 8) and 12c (B
    4), the example's (d_model 640, B 8), musicgen-large's (B 4) and the
    padded llava-next-34b's (d_model 7168, B 2: nHSIC is constant there,
    its gradient 0); and main path 13's."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.examples import progressive_llm_pretrain as ex
    qwen3 = get_config("qwen3-1.7b")
    d = ex.parser().parse_args([])
    example = dataclasses.replace(qwen3, d_model=d.d_model,
                                  vocab_size=d.vocab)
    return (transformer_nhsic_shapes(qwen3, 8)
            + transformer_nhsic_shapes(qwen3, BUILDER_BATCH[0])
            + transformer_nhsic_shapes(example, d.batch)
            + transformer_nhsic_shapes(get_config("musicgen-large"),
                                       MUSICGEN_TRAIN[0])
            + transformer_nhsic_shapes(llava_config(), LLAVA_BATCH)
            # main path 13: deepseek-v2-lite-16b (B 8, 13b) and jamba's
            # smoke config (B 8, 13e)
            + transformer_nhsic_shapes(get_config("deepseek-v2-lite-16b"), 8)
            + transformer_nhsic_shapes(
                get_smoke_config("jamba-1.5-large-398b"), 8))


@contextlib.contextmanager
def server_rounds(kernels):
    """Every ``NeuLiteServer.run_round`` while the block runs (the servers
    an entry point builds inside it): per round its stage, loss, local steps,
    each kernel's launches and the end of the stage's active block (the
    periods its steps run, the frozen prefix included)."""
    from repro_torch.federated.server import NeuLiteServer
    run_round, rows = NeuLiteServer.run_round, []

    def recorded(self, r):
        steps, rt_run = [], self.runtime.run_round

        def counted(*a, **kw):
            out = rt_run(*a, **kw)
            steps.append(sum(out.num_batches))
            return out

        self.runtime.run_round = counted
        before = read_all(kernels)
        try:
            rr = run_round(self, r)
        finally:
            del self.runtime.run_round
        after = read_all(kernels)
        rows.append({"round": r, "stage": rr.stage, "loss": rr.mean_loss,
                     "local_steps": sum(steps),
                     "periods": self.adapter.plan.stage_ranges(
                         rr.stage)[2][1],
                     "launches": {n: after[n] - before[n] for n in after}})
        return rr

    NeuLiteServer.run_round = recorded
    try:
        yield rows
    finally:
        NeuLiteServer.run_round = run_round


def counted(kernels, counts, fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counts set to 0 before it and
    read after (added to ``counts``).  Returns (its result, launches)."""
    reset_all(kernels)
    out = fn(*args, **kw)
    got = read_all(kernels)
    for n in counts:
        counts[n] += got[n]
    return out, got


def expect_launches(name, got, **per_kernel):
    """``got`` must be ``per_kernel``'s counts (K1-K3 as ``nhsic``), every
    other kernel 0."""
    want = {n: 0 for n in got}
    nhsic = per_kernel.pop("nhsic", 0)
    want.update({n: nhsic for n in STREAMING}, **per_kernel)
    check(got == want, f"{name}: launches {got}, expected {want}")


def leg_memory(torch, name, estimate):
    """The allocator's peak since the last reset beside ``estimate``
    (``core.memory``'s bytes); printed and returned."""
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: allocator peak {peak / 2**30:.2f} GiB, "
          f"core/memory.py's estimate {estimate / 2**30:.2f} GiB",
          flush=True)
    return {"peak_bytes": peak, "estimate_bytes": estimate}


def _tree_rel(a, b):
    """max |a - b| over the largest entry of b, leaf by leaf (0 where
    every leaf is empty)."""
    pairs = [(x, y.to(x.device)) for x, y in
             zip(_leaves(a), _leaves(b), strict=True) if y.numel()]
    return max((float((x.float() - y.float()).abs().max())
                / max(float(y.abs().max()), 1e-6) for x, y in pairs),
               default=0.0)


def _host(tree):
    """``tree``'s tensors copied to host memory (to make room on the
    card for the next step)."""
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _noisy_(torch, tree, seed):
    """Every float leaf of ``tree`` times (1 + 1e-7 n), n standard normal,
    in place; returns ``tree``."""
    gen = torch.Generator("cuda").manual_seed(seed)
    for p in _leaves(tree):
        if p.is_floating_point():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                          device=p.device, dtype=p.dtype))
    return tree


def held(name, rel, moved):
    """``rel`` within the bar the plain side's own movement sets
    (``bar_of``; ``None``: not measured, the bar TOL); returns the row."""
    bar = TOL if moved is None else bar_of(moved)
    check(rel <= bar, f"{name}: kernel path against the plain path rel err "
          f"{rel} (the plain path moves {moved} under a 1e-7 change, bar "
          f"{bar})")
    return {"rel_err": rel, "plain_moved": moved, "bar": bar}


def train_qwen3_leg(torch, np, kernels, counts):
    """12a qwen3-train-full: ``train.main`` at TRAIN_ARGV into a temporary
    ``--out``: every round's loss finite, K4 once a layer run and K1-K3
    twice a local step; ``metrics.json`` holds the rounds' losses and the
    final checkpoint reads back to the params' bits.  Then per stage one
    f32 step through the kernels against the plain paths
    (``stage_step_check``) from the trained params."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import checkpoint_path, load_checkpoint
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.memory import estimate_stage_memory
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.launch import train
    cfg = get_config("qwen3-1.7b")
    adapter = make_transformer_adapter(cfg, 4)
    out_dir = tempfile.mkdtemp(prefix="train_")
    torch.cuda.reset_peak_memory_stats()
    try:
        with server_rounds(kernels) as rows:
            out, got = counted(kernels, counts, train.main,
                               TRAIN_ARGV + ["--out", out_dir])
        mem = leg_memory(torch, "12a", max(
            estimate_stage_memory(adapter, t, 8, seq=64).total
            for t in range(adapter.plan.num_stages)))
        check([r["stage"] for r in rows] == [0, 1, 2, 3], f"12a: {rows}")
        for r in rows:
            n = r["local_steps"]
            check(n > 0 and math.isfinite(r["loss"]), f"12a: {r}")
            expect_launches(f"12a round {r['round']}", r["launches"],
                            flash_attention_fwd=n * r["periods"],
                            nhsic=2 * n)
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics = json.load(f)
        check([m["mean_loss"] for m in metrics] == [r["loss"] for r in rows],
              "12a: metrics.json does not hold the rounds' losses")
        path = checkpoint_path(out_dir, 4)
        back, meta = load_checkpoint(path, out["params"], device="cuda")
        check(meta["arch"] == cfg.name and all(
            torch.equal(a, b) for a, b in zip(_leaves(back),
                                              _leaves(out["params"]))),
              "12a: the final checkpoint does not read back to the params")
        ckpt_bytes = os.path.getsize(path)
        del back
        print(f"  12a train.main {' '.join(TRAIN_ARGV)}: "
              f"{out['n_params']:,} params, {out['seconds']:.1f} s; rounds "
              f"(stage, local steps, loss) "
              f"{[(r['stage'], r['local_steps'], r['loss']) for r in rows]};"
              f" launches {got}; metrics.json and {os.path.basename(path)} "
              f"({ckpt_bytes / 2**30:.2f} GiB) read back to the bit",
              flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    params = tree_map(lambda t: t.float(), out.pop("params"))
    del out
    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype="float32", use_flash_kernel=True)
    kern = make_transformer_adapter(f32, 4)
    plain = make_transformer_adapter(
        dataclasses.replace(f32, use_flash_kernel=False), 4)
    ds = make_lm_dataset(SEED + 1, 8, 64, cfg.vocab_size)
    batch = train.lm_batches(ds, np.arange(8), 8, SEED, "cuda")
    # the server's curriculum (FLConfig's lambdas and mu)
    hp = CurriculumHP(lambda1_max=2.0, lambda2_max=1.0, mu=0.01)
    steps, got = counted(kernels, counts, stage_step_check, kern, plain,
                         params, batch, TRAIN_LR, hp, True)
    expect_launches("12a step check", got, flash_attention_fwd=sum(
        kern.plan.stage_ranges(t)[2][1]
        for t in range(kern.plan.num_stages)),
        nhsic=2 * kern.plan.num_stages)
    return {"rounds": rows, "memory": mem, "checkpoint_bytes": ckpt_bytes,
            "step_check": steps}


def train_e2e_leg(torch, kernels, counts):
    """12b: ``train.main --e2e`` at full width, 3 SGD full steps: finite
    losses, K4 once a layer a step, K1-K3 never."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.memory import estimate_full_memory
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.launch import train
    cfg = get_config("qwen3-1.7b")
    out_dir = tempfile.mkdtemp(prefix="train_e2e_")
    torch.cuda.reset_peak_memory_stats()
    try:
        out, got = counted(kernels, counts, train.main,
                           TRAIN_E2E_ARGV + ["--out", out_dir])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [m["loss"] for m in out["metrics"]]
    check(len(losses) == 3 and all(map(math.isfinite, losses)),
          f"12b: losses {losses}")
    expect_launches("12b", got, flash_attention_fwd=3 * cfg.num_layers)
    mem = leg_memory(torch, "12b", estimate_full_memory(
        make_transformer_adapter(cfg, 4), 8, seq=64).total)
    print(f"  12b train.main {' '.join(TRAIN_E2E_ARGV)}: losses {losses}, "
          f"{out['seconds']:.1f} s, launches {got}", flush=True)
    del out
    return {"losses": losses, "launches": got, "memory": mem}


def builders_leg(torch, np, kernels, counts):
    """12c: the builders on qwen3-1.7b in f32 on a one-rank ``HostMesh``:
    ``build_neulite_train`` at its middle stage and ``build_full_train``
    with AdamW, one step each at BUILDER_BATCH through the kernels against
    the plain paths (loss, the new params and m at the ``bar_of`` bar),
    the optimizer state's leaves against ``abstract[0]``'s meta tensors;
    ``build_prefill`` and ``build_serve``: a prefill through K4 against
    the plain prefill (``prefill_check``) and one decode step against the
    plain forward."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import SHAPES, get_config, resolve_config
    from repro_torch.core.memory import estimate_full_memory
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    mesh = make_host_mesh(1, "cuda")
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="float32",
                              use_flash_kernel=True)
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    adapter = make_transformer_adapter(
        resolve_config(cfg, SHAPES["train_4k"]), 4)
    params = adapter.init_params(SEED, "cuda", draw_on_device=True)
    B, Sq = BUILDER_BATCH
    gen = torch.Generator("cuda").manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, Sq + 1), generator=gen,
                         device="cuda")
    batch = {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}
    opt = S.make_optimizer("adamw")
    rows = {}

    def same_abstract(state, abstract, name):
        ok = all(tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
                 and b.device.type == "meta" for a, b in
                 zip(_leaves(state), _leaves(abstract), strict=True))
        check(ok, f"12c {name}: the optimizer state is not abstract[0]")

    # the NeuLite stage step at its middle stage
    t = adapter.plan.num_stages // 2
    kstep, abstract, placements, _ = S.build_neulite_train(
        cfg, "train_4k", mesh, use_hsic_kernel=True)
    pstep = S.build_neulite_train(plain_cfg, "train_4k", mesh)[0]
    frozen, trainable = adapter.split_stage(params, t)
    state = opt.init(trainable)
    same_abstract(state, abstract[0], "neulite")
    (k_state, k_new, k_met), got = counted(kernels, counts, kstep, state,
                                           trainable, frozen, batch,
                                           trainable)
    expect_launches("12c neulite", got,
                    flash_attention_fwd=adapter.plan.stage_ranges(t)[2][1],
                    nhsic=2)
    p_state, p_new, p_met = pstep(opt.init(trainable), trainable, frozen,
                                  batch, trainable)
    rel = max(_tree_rel(k_new, p_new), _tree_rel(k_state["m"], p_state["m"]))
    p_loss = float(p_met["loss"])
    loss_rel = abs(float(k_met["loss"]) - p_loss) / abs(p_loss)
    moved = None                  # the bar is never below TOL
    if max(rel, loss_rel) > TOL:
        n_frozen = _noisy_(torch, tree_map(torch.clone, frozen), SEED + 2)
        n_train = _noisy_(torch, tree_map(torch.clone, trainable), SEED + 3)
        n_state, n_new, n_met = pstep(opt.init(n_train), n_train, n_frozen,
                                      batch, n_train)
        moved = max(_tree_rel(n_new, p_new), _tree_rel(n_state["m"],
                                                       p_state["m"]),
                    abs(float(n_met["loss"]) - p_loss) / abs(p_loss))
        del n_state, n_new, n_frozen, n_train
    rows["neulite"] = {"stage": t, "loss": float(k_met["loss"]),
                       "loss_rel": loss_rel, "launches": got,
                       **held("12c neulite step", max(rel, loss_rel),
                              moved)}
    del k_state, k_new, p_state, p_new, frozen, trainable, state
    # the full-model step: params, gradients, m and v in f32
    kstep, abstract, _, _ = S.build_full_train(cfg, "train_4k", mesh)
    pstep = S.build_full_train(plain_cfg, "train_4k", mesh)[0]
    state = opt.init(params)
    same_abstract(state, abstract[0], "full")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the loss and the gradient (m = 0.1 g after one step; the new params
    # are about lr * sign(g) + decay, nothing more to learn from them);
    # each step's m goes to host memory before the next step runs
    (k_state, _, k_met), got = counted(kernels, counts, kstep,
                                       opt.init(params), params, batch)
    mem = leg_memory(torch, "12c full AdamW step", estimate_full_memory(
        adapter, B, seq=Sq, opt_slots=2).total)
    expect_launches("12c full", got, flash_attention_fwd=cfg.num_layers)
    k_m = _host(k_state["m"])
    del k_state
    gc.collect()
    torch.cuda.empty_cache()
    p_state, _, p_met = pstep(opt.init(params), params, batch)
    rel = _tree_rel(p_state["m"], k_m)
    p_loss = float(p_met["loss"])
    loss_rel = abs(float(k_met["loss"]) - p_loss) / abs(p_loss)
    del k_m
    moved = None                  # the bar is never below TOL
    if max(rel, loss_rel) > TOL:
        p_m = _host(p_state["m"])
        del p_state
        gc.collect()
        torch.cuda.empty_cache()
        params = _noisy_(torch, params, SEED + 4)  # not used after this
        n_state, _, n_met = pstep(opt.init(params), params, batch)
        moved = max(_tree_rel(n_state["m"], p_m),
                    abs(float(n_met["loss"]) - p_loss) / abs(p_loss))
        del n_state, p_m
    p_state = None
    rows["full"] = {"loss": float(k_met["loss"]), "loss_rel": loss_rel,
                    "launches": got, "memory": mem,
                    **held("12c full step", max(rel, loss_rel), moved)}
    del p_state, params
    gc.collect()
    torch.cuda.empty_cache()
    # prefill and one decode step through the builders
    pre = S.build_prefill(cfg, "prefill_32k", mesh)[0]
    serve = S.build_serve(cfg, "decode_32k", mesh)[0]
    params = serve_params(torch, cfg)
    Bp, P = BUILDER_PROMPT
    prompt = serve_prompt(torch, np, cfg.vocab_size, Bp, P)
    (logits, caches), got_pre = counted(kernels, counts, pre, params,
                                        {"tokens": prompt})
    expect_launches("12c prefill", got_pre,
                    flash_attention_fwd=cfg.num_layers)
    rows["prefill"] = prefill_check(torch, "12c build_prefill", cfg, prompt,
                                    logits, caches)
    caches = M.grow_caches(cfg, caches, Bp, P + 1)
    tok = logits[:, -1].argmax(-1)[:, None]
    (lg, _), got_dec = counted(kernels, counts, serve, params,
                               {"tokens": tok}, caches, P)
    expect_launches("12c decode", got_dec)
    seq = torch.cat([prompt, tok], 1)
    want = plain_logits(torch, cfg, params, seq, [P])
    rel, _ = rel_abs(lg.float(), want)
    del params
    moved = (rel_abs(plain_logits(torch, cfg, serve_params(
        torch, cfg, noise=True), seq, [P]), want)[0] if rel > TOL else None)
    rows["decode"] = held("12c build_serve step", rel, moved)
    print(f"  12c builders (f32, {mesh}): neulite stage {t} step "
          f"{rows['neulite']['rel_err']:.2e} (bar "
          f"{rows['neulite']['bar']:.1e}), full AdamW step "
          f"{rows['full']['rel_err']:.2e} (bar {rows['full']['bar']:.1e}), "
          f"decode {rows['decode']['rel_err']:.2e}; optimizer states the "
          f"shapes and dtypes of abstract[0]", flush=True)
    return rows


def example_leg(torch, kernels, counts):
    """12d: ``examples/progressive_llm_pretrain.main()`` at its own size:
    K4 once a layer run and K1-K3 twice a NeuLite step, K4 once a layer
    an E2E step; its ms/step, CE and speedup printed beside the paper's
    1.84-2.31x (not gated)."""
    from repro_torch.core.memory import estimate_full_memory
    from repro_torch.core.progressive import make_adapter
    from repro_torch.examples import progressive_llm_pretrain as ex
    torch.cuda.reset_peak_memory_stats()
    out, got = counted(kernels, counts, ex.main, [])
    cfg, args = out["config"], ex.parser().parse_args([])
    adapter = make_adapter(cfg, args.stages)
    plan = adapter.plan
    mem = leg_memory(torch, "12d", estimate_full_memory(
        adapter, args.batch, seq=args.seq, opt_slots=2).total)
    n = len(out["stages"])
    expect_launches("12d", got, flash_attention_fwd=sum(
        plan.stage_ranges(t)[2][1] for t in out["stages"])
        + n * cfg.num_layers, nhsic=2 * n)
    check(all(map(math.isfinite, out["neulite_losses"] + out["e2e_losses"])),
          "12d: non-finite losses")
    print(f"  12d example: {out['n_params']:,} params; NeuLite "
          f"{out['neulite_ms']:.2f} ms/step (CE {out['neulite_ce']:.4f}), "
          f"E2E {out['e2e_ms']:.2f} ms/step (CE {out['e2e_ce']:.4f}), "
          f"speedup {out['speedup']:.2f}x (paper: 1.84-2.31x per round "
          f"on-device; not gated); launches {got}", flush=True)
    return {"memory": mem, **{k: out[k] for k in (
        "n_params", "neulite_ms", "e2e_ms", "neulite_ce", "e2e_ce",
        "speedup")}}


def stage_and_loss_checks(torch, kernels, counts, name, cfg, draw, batch,
                          seq, lr=0.05):
    """One SGD stage step per stage of ``cfg`` (K4 on) against the plain
    path (``use_flash_kernel=False``, plain nHSIC) and the E2E
    ``loss_fn``, each at the ``bar_of`` bar, lean on memory: the plain
    step runs first, the kernel step (K4 keeps only q, k and v for its
    backward) beside its result; where the kernel path is beyond TOL (the
    bar is never below it), the plain result waits in host memory while
    the plain path runs again from the params noised in place, and the
    next check draws them again (``draw()``).  Then each period alone
    (``periods_alone``).  K4 once a layer run and K1-K3 twice a kernel
    step.  Each stage's allocator peak beside ``core.memory``'s estimate
    at its batch and ``seq``."""
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.memory import estimate_stage_memory
    from repro_torch.core.progressive import (make_stage_step,
                                              make_transformer_adapter)
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import sgd
    kern = make_transformer_adapter(cfg, 4)
    plain = make_transformer_adapter(
        dataclasses.replace(cfg, use_flash_kernel=False), 4)
    opt = sgd(lr)
    rows = []

    def step(adapter, params, t, kernel):
        hp = CurriculumHP(use_hsic_kernel=kernel)
        frozen, trainable = adapter.split_stage(params, t)
        _, new, m = make_stage_step(adapter, opt, hp, t)(
            opt.init(trainable), trainable, frozen, batch, trainable)
        return new, float(m["loss"])

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    params = None
    for t in range(kern.plan.num_stages):
        params = draw() if params is None else params
        torch.cuda.reset_peak_memory_stats()
        p_new, p_loss = step(plain, params, t, False)
        free()
        (k_new, k_loss), got = counted(kernels, counts, step, kern, params,
                                       t, True)
        expect_launches(f"{name} stage {t}", got,
                        flash_attention_fwd=kern.plan.stage_ranges(t)[2][1],
                        nhsic=2)
        rel = max(_tree_rel(k_new, p_new), abs(k_loss - p_loss) / abs(p_loss))
        del k_new
        moved = None
        if rel > TOL:
            p_new = _host(p_new)
            free()
            params = _noisy_(torch, params, SEED + 10 + t)
            n_new, n_loss = step(plain, params, t, False)
            moved = max(_tree_rel(n_new, p_new),
                        abs(n_loss - p_loss) / abs(p_loss))
            del n_new
            params = None                 # noised: drawn again
        del p_new
        peak = torch.cuda.max_memory_allocated()
        estimate = estimate_stage_memory(kern, t, batch["labels"].shape[0],
                                         seq=seq).total
        free()
        rows.append({"stage": t, "loss": k_loss, "plain_loss": p_loss,
                     "peak_bytes": peak, "estimate_bytes": estimate,
                     **held(f"{name} stage {t} step", rel, moved)})
        print(f"  {name} stage {t} step, kernel vs plain path: loss "
              f"{k_loss:.6f} vs {p_loss:.6f}, rel err {rel:.2e} (the plain "
              f"path moves {_moved(moved)}; bar {rows[-1]['bar']:.1e}); "
              f"allocator peak {peak / 2**30:.2f} GiB, core/memory.py's "
              f"estimate {estimate / 2**30:.2f} GiB", flush=True)
    params = draw() if params is None else params
    plain_cfg = plain.cfg
    with torch.no_grad():
        k_loss, got = counted(kernels, counts, M.loss_fn, params["model"],
                              cfg, batch)
        expect_launches(f"{name} E2E loss", got,
                        flash_attention_fwd=cfg.num_layers)
        p_loss = float(M.loss_fn(params["model"], plain_cfg, batch))
        rel = abs(float(k_loss) - p_loss) / abs(p_loss)
        moved = None
        if rel > TOL:
            n_loss = M.loss_fn(_noisy_(torch, params, SEED + 20)["model"],
                               plain_cfg, batch)
            moved = abs(float(n_loss) - p_loss) / abs(p_loss)
            params = draw()
    loss = held(f"{name} E2E loss_fn", rel, moved)
    print(f"  {name} E2E loss_fn {float(k_loss):.6f}, against the plain "
          f"path rel err {rel:.2e} (the plain path moves {_moved(moved)}; "
          f"bar {loss['bar']:.1e})", flush=True)
    # a model chaotic at init moves O(1) under a 1e-7 change, where the
    # bars above say nothing: each period alone, forward and gradients, at
    # TOL (``period_check``)
    periods, got = counted(kernels, counts, periods_alone, torch,
                           params["model"], cfg, plain_cfg, batch["inputs"],
                           f"{name}: ")
    expect_launches(f"{name} periods alone", got,
                    flash_attention_fwd=cfg.num_periods)
    del params
    free()
    return {"stages": rows, "loss": loss, "periods": periods}


def _moved(moved):
    return "not measured (within TOL)" if moved is None else f"{moved:.2e}"


def musicgen_leg(torch, kernels, counts):
    """12e musicgen-train-full: musicgen-large at full width, its depth
    cut 48 -> MUSICGEN_DEPTH, in f32 on frame embeddings (B 4, S 256,
    labels (B, S, 4)): each stage step, the
    E2E loss and each period alone against the plain path
    (``stage_and_loss_checks``); each mixer's prefill and decode alone
    (``layer_check``); then a prefill of the S positions and 3 decode steps
    from embeddings against the plain forward over the whole sequence."""
    from repro_torch.common.paramdef import init_params
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("musicgen-large"), dtype="float32",
                              use_flash_kernel=True,
                              num_layers=MUSICGEN_DEPTH)
    B, Sq, steps = MUSICGEN_TRAIN
    gen = torch.Generator("cuda").manual_seed(SEED)
    embeds = torch.randn((B, Sq + steps, cfg.d_model), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (B, Sq, cfg.num_output_heads),
                           generator=gen, device="cuda")
    batch = {"inputs": {"embeds": embeds[:, :Sq]}, "labels": labels}
    defs = make_transformer_adapter(cfg, 4).defs

    def draw():
        return init_params(SEED, defs, "cuda", draw_on_device=True)

    out = stage_and_loss_checks(torch, kernels, counts, "12e musicgen-large",
                                cfg, draw, batch, Sq)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    model = draw()["model"]
    # each mixer alone on the plain forward's input: its prefill through K4
    # and its decode from embeddings
    out["layers"], got = counted(kernels, counts, layer_check, torch,
                                 "12e musicgen-large", cfg, model,
                                 {"embeds": embeds}, Sq, steps)
    expect_launches("12e layers alone", got,
                    flash_attention_fwd=cfg.num_layers)
    with torch.no_grad():
        (logits, caches), got = counted(kernels, counts, M.prefill, model,
                                        cfg, {"embeds": embeds[:, :Sq]})
        expect_launches("12e prefill", got,
                        flash_attention_fwd=cfg.num_layers)
        caches = M.grow_caches(cfg, caches, B, Sq + steps)
        outs = [logits]
        reset_all(kernels)
        for i in range(steps - 1):
            lg, caches = M.decode_step(model, cfg, {
                "embeds": embeds[:, Sq + i:Sq + i + 1]}, caches, Sq + i)
            outs.append(lg)
        expect_launches("12e decode", read_all(kernels))
        got = torch.cat(outs, 1).float()
        pos = list(range(Sq - 1, Sq + steps - 1))
        want = M.forward(model, plain, {"embeds": embeds[:, :Sq + steps - 1]}
                         )[:, pos].float()
        rel, _ = rel_abs(got, want)
        noisy = _noisy_(torch, model, SEED + 30)
        moved, _ = rel_abs(M.forward(noisy, plain, {
            "embeds": embeds[:, :Sq + steps - 1]})[:, pos].float(), want)
    del model, noisy, caches
    out["decode"] = held("12e prefill and decode from embeddings", rel,
                         moved)
    print(f"  12e prefill of {Sq} frames and {steps - 1} decode steps from "
          f"embeddings ({cfg.num_output_heads} heads) against the plain "
          f"forward: rel err {rel:.2e} (bar {out['decode']['bar']:.1e})",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def llava_leg(torch, kernels, counts):
    """12f llava-train-full-depth2: llava-next-34b at full width (d_model
    7168, 56 -> 64 padded heads over 8 of 128, d_ff 20480, vocab 64000),
    its depth cut 60 -> LLAVA_DEPTH layers (the whole model, 68.8 GB in
    bf16, does not train on one card), f32, B 2, its 2880 patches and 128 text
    tokens: each stage step, the E2E loss and each period alone against
    the plain path (``stage_and_loss_checks``)."""
    from repro_torch.common.paramdef import init_params
    from repro_torch.core.progressive import make_transformer_adapter
    cfg = llava_config()
    B, St, Pv = LLAVA_BATCH, LLAVA_TEXT, cfg.num_vision_patches
    gen = torch.Generator("cuda").manual_seed(SEED)
    batch = {"inputs": {
        "patches": torch.randn((B, Pv, cfg.d_model), generator=gen,
                               device="cuda"),
        "tokens": torch.randint(0, cfg.vocab_size, (B, St), generator=gen,
                                device="cuda")},
        "labels": torch.randint(0, cfg.vocab_size, (B, St), generator=gen,
                                device="cuda")}
    defs = make_transformer_adapter(cfg, 4).defs

    def draw():
        return init_params(SEED, defs, "cuda", draw_on_device=True)

    return stage_and_loss_checks(torch, kernels, counts,
                                 f"12f llava-next-34b depth {LLAVA_DEPTH}",
                                 cfg, draw,
                                 batch, Pv + St)


def training_path(torch, np, kernels):
    """Main path 12: 12a-12f, TF32 off, every K4 and nHSIC shape held by
    the kernel phase; the launches of the driven runs and each part's
    seconds."""
    counts = {n: 0 for n in read_all(kernels)}
    out, took = {}, {}
    t0 = time.perf_counter()
    legs = (("12a", lambda: train_qwen3_leg(torch, np, kernels, counts)),
            ("12b", lambda: train_e2e_leg(torch, kernels, counts)),
            ("12c", lambda: builders_leg(torch, np, kernels, counts)),
            ("12d", lambda: example_leg(torch, kernels, counts)),
            ("12e", lambda: musicgen_leg(torch, kernels, counts)),
            ("12f", lambda: llava_leg(torch, kernels, counts)))
    with flash_shapes_seen() as fseen, nhsic_shapes_seen() as nseen:
        for key, fn in legs:
            t1 = time.perf_counter()
            out[key] = fn()
            took[key] = time.perf_counter() - t1
            print(f"  {key}: {took[key]:.1f} s", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    check_flash_held(fseen, "main path 12")
    check_held(nseen, "main path 12")
    check(counts["flash_attention_fwd"] > 0
          and all(counts[n] > 0 for n in STREAMING),
          f"main path 12: launches {counts}")
    took["total"] = time.perf_counter() - t0
    out["seconds"] = took
    print(f"  main path 12 parts (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return out, counts

# --------------------------------------------------------------------------- #
# main path 13: Mamba, MoE and MLA (deepseek-v2-lite-16b, deepseek-v2-236b,
# jamba-1.5-large-398b)
# --------------------------------------------------------------------------- #
DSL, DS236, JAMBA = ("deepseek-v2-lite-16b", "deepseek-v2-236b",
                     "jamba-1.5-large-398b")
# 13a: serve.main on deepseek-v2-lite-16b at full width and depth, bf16
MOE_SERVE_ARGV = ["--arch", DSL, "--full", "--batch", "4", "--prompt-len",
                  "512", "--gen", "32"]
MOE_GREEDY_STEPS = 8              # 13a: the greedy runs' decode steps
MLA_CHECK = (2, 512, 16)          # the MLA mixer alone: B, prefill, decodes
MOE_TOKENS = (4, 512)             # the MoE FFN alone: (B, S), 2048 tokens
# 13b: train.main on deepseek-v2-lite-16b at full width, depth 27 -> 4
MOE_TRAIN_DEPTH = 4
MOE_TRAIN_ARGV = ["--arch", DSL, "--full", "--rounds", "4", "--clients",
                  "256", "--cohort", "2", "--batch", "8", "--seq", "64",
                  "--lr", str(TRAIN_LR), "--seed", str(SEED)]
DS236_DEPTH, DS236_SERVE = 2, (2, 256, 8)   # 13c: depth 60 -> 2; B, P, steps
JAMBA_LAYER = (2, 512, 500, 12)   # 13d: B, S, Mamba prefill, decode steps
JAMBA_SERVE = (2, 24, 12)         # 13e: B, prompt, generated tokens
JAMBA_TRAIN_ARGV = ["--arch", JAMBA, "--rounds", "2", "--clients", "256",
                    "--cohort", "2", "--batch", "8", "--seq", "64", "--lr",
                    str(TRAIN_LR), "--seed", str(SEED)]
# the capacity factor of the legs that hold a decode against the forward
# (nothing drops, as the reference's own decode test sets it: Q5)
NO_DROP = 8.0


@contextlib.contextmanager
def depth_cut(module, depth):
    """``module.get_config`` (an entry point's) giving the full width at
    ``depth`` layers while the block runs."""
    get = module.get_config
    module.get_config = lambda arch: dataclasses.replace(get(arch),
                                                         num_layers=depth)
    try:
        yield
    finally:
        module.get_config = get


@contextlib.contextmanager
def experts_routed():
    """The number of distinct experts each ``moe_apply`` call routes its
    tokens to while the block runs (from the same router logits)."""
    import torch
    from repro_torch.models import moe as moe_mod
    seen, apply = [], moe_mod.moe_apply

    def recorded(params, cfg, x):
        logits = x.reshape(-1, x.shape[-1]).float() @ params["router"]
        top_e = torch.topk(torch.softmax(logits, -1), cfg.moe.top_k,
                           dim=-1)[1]
        seen.append(int(torch.unique(top_e).numel()))
        return apply(params, cfg, x)

    moe_mod.moe_apply = recorded
    try:
        yield seen
    finally:
        moe_mod.moe_apply = apply


def no_drop(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=NO_DROP))


def moe_serve_bounds(cfg, B, P, gen, routed=None):
    """The least time of one bf16 prefill of B x P tokens and of one decode
    step of an MLA + MoE decoder, on the card's peak rates.  Prefill: the
    products of the active params (top-k and shared experts, attention's
    projections) on every token, the head on B last positions, and
    attention's QK^T (nope + rope dims) and PV on the causal pairs, at the
    bf16 rate; or every param read once.  Decode, as the reference's
    formulation runs it: every param read once but the embedding table (B
    rows of it), every expert's C-slot buffer computed (C =
    ``expert_capacity(B)``), the latent caches' valid slots read and
    attended (scores over the rank and rope dims, the context over the
    rank), averaged over the steps.  With ``routed`` (the distinct experts
    a step routes to, summed over the layers) also the decode's bytes with
    only those experts read.  Returns (prefill ms, by, decode ms, by,
    routed decode ms or None)."""
    from repro_torch.models import model as M
    from repro_torch.models.moe import expert_capacity
    size, m, moe = 2, cfg.mla, cfg.moe
    L, H = cfg.num_layers, cfg.num_heads
    n = M.total_param_count(cfg)
    table = head = cfg.vocab_size * cfg.d_model
    per_expert = 3 * cfg.d_model * moe.d_ff_expert
    experts = L * moe.num_experts * per_expert
    body = M.active_param_count(cfg) - table - head
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    attn = 2 * (qk + m.v_head_dim) * H * (P * (P + 1) // 2) * B * L
    flops = 2 * body * B * P + 2 * head * B + attn
    t_ops = flops / BF16_PRODUCT_FLOPS_PER_S * 1e3
    t_bytes = n * size / HBM_BYTES_PER_S * 1e3
    prefill = (max(t_ops, t_bytes),
               "operations" if t_ops >= t_bytes else "bytes")
    slots = statistics.mean(P + i + 1 for i in range(gen - 1))
    rank = m.kv_lora_rank + m.qk_rope_head_dim
    cache = L * B * slots * rank * size
    other = (n - table - experts + B * cfg.d_model) * size + cache
    d_bytes = other + experts * size
    C = expert_capacity(B, moe)
    d_flops = (2 * (n - table - experts) * B + 2 * experts * C
               + 2 * (2 * m.kv_lora_rank + m.qk_rope_head_dim) * H * slots
               * B * L)
    t_bytes = d_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = d_flops / BF16_PRODUCT_FLOPS_PER_S * 1e3
    decode = (max(t_ops, t_bytes),
              "operations" if t_ops > t_bytes else "bytes")
    routed_ms = (None if routed is None else
                 (other + routed * per_expert * size) / HBM_BYTES_PER_S
                 * 1e3)
    return (*prefill, *decode, routed_ms)


def moe_loop(torch, params, cfg, x):
    """The plain per-expert version of ``moe_apply``: each token's top-k
    of the renormalised softmax, its rank within each expert counted by a
    running sum over its group's (token, k) assignments in order (not a
    sort), those past the capacity dropped, then for each expert in turn
    its kept tokens through its SwiGLU, added to their rows weighted; the
    shared experts on every token; the aux losses over all tokens."""
    import torch.nn.functional as F
    from repro_torch.models.layers import mlp
    from repro_torch.models.moe import expert_capacity
    moe = cfg.moe
    B, S, d = x.shape
    N, E, K = B * S, moe.num_experts, moe.top_k
    G = max(1, min(moe.dispatch_groups, N))
    while N % G:
        G -= 1
    C = expert_capacity(N // G, moe)
    xt = x.reshape(N, d)
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    w = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = top_e.reshape(G, -1)
    hits = (flat[..., None] == torch.arange(E, device=x.device)).long()
    rank = (hits.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
    keep = (rank < C).reshape(N, K)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, k = torch.nonzero((top_e == e) & keep, as_tuple=True)
        h = xt[tok]
        h = F.silu(h @ params["w_gate"][e]) * (h @ params["w_up"][e])
        out = (h @ params["w_down"][e]).float() * w[tok, k, None]
        y = y.index_add(0, tok, out.to(x.dtype))
    if moe.num_shared:
        y = y + mlp(params["shared"], xt, act="swiglu")
    routed = (top_e[..., None] == torch.arange(E, device=x.device)).float()
    aux = {"load_balance": E * torch.sum(probs.mean(0)
                                         * routed.sum(1).mean(0) / K),
           "router_z": torch.logsumexp(logits, -1).square().mean()}
    return y.reshape(B, S, d), aux, int((~keep).sum())


def moe_alone(torch, name, cfg, B, S, weight_grads=True, tol=TOL):
    """One MoE FFN of ``cfg`` at its width, params random from SEED on the
    card, on x (B, S, d) standard normal: ``moe_apply`` against
    ``moe_loop``, the output, both aux losses and the gradients of a random
    cotangent (+ load_balance + 3 router_z) into x, the router and (with
    ``weight_grads``) every expert and shared weight, at ``tol`` of each
    one's largest entry; then ``moe_apply``'s output and gradients again
    twice, to the bit."""
    from repro_torch.common.paramdef import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe import expert_capacity
    params = init_params(SEED, moe_mod.moe_defs(cfg), "cuda",
                         draw_on_device=True)
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=cfg.param_dtype)
    ct = torch.randn(x.shape, generator=gen, device="cuda",
                     dtype=cfg.param_dtype)
    inputs = [x, params["router"]] + (
        [leaf for k in sorted(params) if k != "router"
         for leaf in _leaves(params[k])] if weight_grads else [])
    for t in inputs:
        t.requires_grad_(True)

    def run(fn):
        y, aux = fn(params, cfg, x)[:2]
        loss = ((y.float() * ct.float()).sum() + aux["load_balance"]
                + 3 * aux["router_z"])
        g = torch.autograd.grad(loss, inputs)
        return [y.detach(), aux["load_balance"].detach(),
                aux["router_z"].detach(), *g]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(moe_mod.moe_apply)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    want = run(lambda p, c, xi: moe_loop(torch, p, c, xi))
    with torch.no_grad():
        dropped = moe_loop(torch, params, cfg, x)[2]
    rel, ab = rel_abs(got, want)
    check(rel <= tol and all(bool(torch.isfinite(t).all()) for t in got),
          f"{name}: moe_apply against the per-expert loop rel err {rel}")
    del want
    same = all(all(torch.equal(a, b) for a, b in zip(got, run(
        moe_mod.moe_apply))) for _ in range(2))
    check(same, f"{name}: moe_apply's output or gradients differ between "
          f"runs")
    C = expert_capacity(B * S, cfg.moe)
    print(f"  {name}: MoE FFN ({cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k}, {cfg.moe.num_shared} shared, of "
          f"{cfg.moe.d_ff_expert}; {B * S} tokens, C = {C}, {dropped} "
          f"(token, k) dropped) {cfg.dtype}: output, aux and "
          f"{len(inputs)} gradients against the per-expert loop rel err "
          f"{rel:.2e} (abs {ab:.2e}, bar {tol:.0e}); the same bits over 3 "
          f"runs; forward + backward {port_s:.3f} s", flush=True)
    del params, got, inputs, x, ct
    return {"rel_err": rel, "abs_err": ab, "bar": tol, "capacity": C,
            "dropped": dropped, "repeat_bits": same, "seconds": port_s}


def mla_alone(torch, name, cfg):
    """The MLA mixer of one layer of ``cfg`` at its width in f32, alone on
    the plain forward's input (``layer_check``): a prefill of P with
    cache, then absorbed decode steps against the naive forward at each
    position; the layer's MoE FFN feeds nothing back (one layer)."""
    one = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    params = serve_params(torch, one)
    B, P, steps = MLA_CHECK
    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    seq = torch.randint(0, one.vocab_size, (B, P + steps), generator=gen,
                        device="cuda")
    out = layer_check(torch, name, one, params, seq, P, steps)
    del params
    return out


def moe_serve_leg(torch, np, kernels, counts):
    """13a deepseek-lite-serve-full: ``serve.main`` at MOE_SERVE_ARGV
    (deepseek-v2-lite-16b, all 27 layers, bf16): prefill ms, decode
    ms/step, tokens/s and the allocator's peak beside their bounds; the
    greedy tokens (and logits) of MOE_GREEDY_STEPS decode steps twice from
    the seed, to the bit, the experts each decode step routes to counted.
    Then in f32 at full width: the MLA mixer alone and the MoE FFN
    alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config(DSL)
    torch.cuda.reset_peak_memory_stats()
    out, got = counted(kernels, counts, serve.main, MOE_SERVE_ARGV)
    expect_launches("13a serve.main", got)       # MLA attends with sdpa
    toks = out.pop("tokens")
    B, P, gen = out["batch"], out["prompt_len"], out["gen"]
    check(tuple(toks.shape) == (B, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"13a tokens {toks.shape}")
    params = serve_params(torch, cfg)
    prompt = serve_prompt(torch, np, cfg.vocab_size, B, P)
    first = serve_greedy(torch, kernels, cfg, params, prompt,
                         MOE_GREEDY_STEPS)
    with experts_routed() as routed:
        again = serve_greedy(torch, kernels, cfg, params, prompt,
                             MOE_GREEDY_STEPS)
    for run in (first, again):
        for n in counts:
            counts[n] += run[4][n] + run[5][n]
    same = (torch.equal(first[2], again[2]) and torch.equal(first[3],
                                                            again[3]))
    check(same and bool(torch.isfinite(first[3]).all()),
          "13a: the greedy tokens or logits from the seed differ between "
          "two runs")
    L = cfg.num_layers
    per_step = routed[L:]                        # the decode steps' calls
    routed_per_step = sum(per_step) / MOE_GREEDY_STEPS
    cache_bytes = sum(math.prod(d.shape) * d.dtype.itemsize for d in
                      _leaves(M.cache_defs(cfg, B, P + gen)))
    params_bytes = sum(p.numel() * p.element_size() for p in
                       _leaves(params))
    del params, first, again
    gc.collect()
    torch.cuda.empty_cache()
    pre_b, pre_by, dec_b, dec_by, dec_routed = moe_serve_bounds(
        cfg, B, P, gen, routed_per_step)
    out.update(prefill_ms=out["prefill_s"] * 1e3,
               decode_ms_per_step=out["decode_s"] / out["decode_steps"] * 1e3,
               prefill_bound_ms=pre_b, prefill_bound_by=pre_by,
               decode_bound_ms=dec_b, decode_bound_by=dec_by,
               decode_routed_bound_ms=dec_routed,
               experts_routed_per_step=routed_per_step,
               peak_bound_bytes=params_bytes + cache_bytes, launches=got,
               greedy_same_bits=same)
    print(f"  13a serve.main {' '.join(MOE_SERVE_ARGV)} (bf16, {L} layers): "
          f"prefill {out['prefill_ms']:.2f} ms (bound {pre_b:.2f} ms, "
          f"{pre_by}), decode {out['decode_ms_per_step']:.3f} ms/step "
          f"(bound {dec_b:.3f} ms, {dec_by}: every expert's C-slot buffer; "
          f"with only the {routed_per_step:.0f} experts a step routes to "
          f"({routed_per_step / L:.1f} of {cfg.moe.num_experts} a layer) "
          f"read, {dec_routed:.3f} ms), {out['tokens_per_s']:.1f} tokens/s, "
          f"allocator peak {(out['peak_bytes'] or 0) / 2**30:.2f} GiB "
          f"(params + caches {out['peak_bound_bytes'] / 2**30:.2f} GiB); "
          f"greedy tokens again from the seed the same bits", flush=True)
    row = {"serve": out}
    row["mla"] = mla_alone(torch, "13a deepseek-v2-lite-16b f32", cfg)
    row["moe"] = moe_alone(torch, "13a deepseek-v2-lite-16b f32",
                           dataclasses.replace(cfg, dtype="float32"),
                           *MOE_TOKENS)
    return row


def moe_aux_check(torch, name, adapter, params, batch, hp):
    """Per stage, from ``params`` (f32): the stage loss through the
    kernels is CE - λ1 nHSIC(X;Z) - λ2 nHSIC(Y;Z) + ``moe_aux_loss`` of the
    stage forward's load_balance and router_z (the proximal term 0 at the
    round's start); both aux sums through the kernel path against the
    plain path (nHSIC and attention plain) at TOL."""
    from repro_torch.core.progressive import make_stage_loss
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_aux_loss
    plain_cfg = dataclasses.replace(adapter.cfg, use_flash_kernel=False)
    rows = []
    for t in range(adapter.plan.num_stages):
        frozen, trainable = adapter.split_stage(params, t)
        with torch.no_grad():
            k_hp = dataclasses.replace(hp, use_hsic_kernel=True)
            loss, m = make_stage_loss(adapter, k_hp, t)(trainable, frozen,
                                                        batch, trainable)
            _, feats = adapter.stage_apply(frozen, trainable,
                                           batch["inputs"])
            _, plain = M.stage_apply(frozen, trainable, plain_cfg,
                                     batch["inputs"])
        aux = feats["aux"]
        term = moe_aux_loss(aux, adapter.cfg.moe)
        rest = (float(m["ce"]) - m["lambda1"] * float(m["nhsic_xz"])
                - m["lambda2"] * float(m["nhsic_yz"]) + float(m["prox"]))
        err = abs(float(loss) - rest - float(term)) / abs(float(loss))
        rel, _ = rel_abs([aux["load_balance"], aux["router_z"]],
                         [plain["aux"]["load_balance"],
                          plain["aux"]["router_z"]])
        check(err <= TOL and rel <= TOL and float(term) > 0,
              f"{name} stage {t}: the loss does not carry the aux term "
              f"({err}) or the aux sums leave the plain path's ({rel})")
        rows.append({"stage": t, "aux_term": float(term),
                     "load_balance": float(aux["load_balance"]),
                     "router_z": float(aux["router_z"]),
                     "decomposition_rel": err, "aux_rel": rel})
    print(f"  {name}: each stage's loss carries moe_aux_loss of its "
          f"trainable periods (aux terms "
          f"{[round(r['aux_term'], 5) for r in rows]}); load_balance and "
          f"router_z against the plain path rel err <= "
          f"{max(r['aux_rel'] for r in rows):.2e}", flush=True)
    return rows


def moe_train_leg(torch, np, kernels, counts):
    """13b deepseek-lite-train-full-depth4: ``train.main`` at
    MOE_TRAIN_ARGV with deepseek-v2-lite-16b's depth cut 27 -> 4 (bf16):
    every round's loss finite, K1-K3 twice a local step and K4 never (MLA
    attends with sdpa); then per stage one f32 step through the kernels
    against the plain path (``stage_step_check``) and the aux term
    (``moe_aux_check``)."""
    import shutil
    import tempfile
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.memory import estimate_stage_memory
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config(DSL), num_layers=MOE_TRAIN_DEPTH)
    adapter = make_transformer_adapter(cfg, 4)
    out_dir = tempfile.mkdtemp(prefix="train_moe_")
    torch.cuda.reset_peak_memory_stats()
    try:
        with depth_cut(train, MOE_TRAIN_DEPTH), \
                server_rounds(kernels) as rows:
            out, got = counted(kernels, counts, train.main,
                               MOE_TRAIN_ARGV + ["--out", out_dir])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    mem = leg_memory(torch, "13b", max(
        estimate_stage_memory(adapter, t, 8, seq=64).total
        for t in range(adapter.plan.num_stages)))
    check([r["stage"] for r in rows] == [0, 1, 2, 3], f"13b: {rows}")
    for r in rows:
        n = r["local_steps"]
        check(n > 0 and math.isfinite(r["loss"]), f"13b: {r}")
        expect_launches(f"13b round {r['round']}", r["launches"],
                        nhsic=2 * n)
    print(f"  13b train.main {' '.join(MOE_TRAIN_ARGV)}, depth "
          f"{MOE_TRAIN_DEPTH}: {out['n_params']:,} params, "
          f"{out['seconds']:.1f} s; rounds (stage, local steps, loss) "
          f"{[(r['stage'], r['local_steps'], r['loss']) for r in rows]}; "
          f"launches {got}", flush=True)
    params = tree_map(lambda t: t.float(), out.pop("params"))
    del out
    gc.collect()
    torch.cuda.empty_cache()
    kern = make_transformer_adapter(dataclasses.replace(cfg,
                                                        dtype="float32"), 4)
    ds = make_lm_dataset(SEED + 1, 8, 64, cfg.vocab_size)
    batch = train.lm_batches(ds, np.arange(8), 8, SEED, "cuda")
    hp = CurriculumHP(lambda1_max=2.0, lambda2_max=1.0, mu=0.01)
    steps, got = counted(kernels, counts, stage_step_check, kern, kern,
                         params, batch, TRAIN_LR, hp, True)
    expect_launches("13b step check", got, nhsic=2 * kern.plan.num_stages)
    aux, _ = counted(kernels, counts, moe_aux_check, torch, "13b", kern,
                     params, batch, hp)
    del params
    return {"rounds": rows, "memory": mem, "step_check": steps, "aux": aux}


def ds236_leg(torch, np, kernels, counts):
    """13c deepseek-236b-full-depth2: deepseek-v2-236b at full width
    (q-LoRA 1536, 160 experts), depth 60 -> 2, bf16: a prefill of B x P
    and greedy decode steps, timed beside their bounds; the same at
    capacity factor NO_DROP against the forward over prompt and fed
    tokens, at twice what bf16 rounding moves that forward from the f32
    forward of the same params (at least BF16_TOL).  Then in f32: the
    q-LoRA MLA mixer alone and the MoE FFN alone."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(DS236), num_layers=DS236_DEPTH)
    B, P, steps = DS236_SERVE
    params = serve_params(torch, cfg)
    prompt = serve_prompt(torch, np, cfg.vocab_size, B, P)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = serve_greedy(torch, kernels, cfg, params, prompt, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for n in counts:
        counts[n] += run[4][n] + run[5][n]
    check(not any(run[4].values()) and not any(run[5].values())
          and bool(torch.isfinite(run[3]).all()),
          f"13c: launches {run[4]}, {run[5]} or non-finite logits")
    del run
    nd = no_drop(cfg)
    _, _, fed, steps_lg, pre, dec = serve_greedy(torch, kernels, nd, params,
                                                 prompt, steps)
    for n in counts:
        counts[n] += pre[n] + dec[n]
    seq = torch.cat([prompt, fed], 1)
    positions = list(range(P, P + steps))
    want = plain_logits(torch, nd, params, seq, positions)
    rel, ab = rel_abs(steps_lg.float(), want)
    # bf16 rounding's own share: the bf16 forward against the f32 forward
    # of the same params
    from repro_torch.common.tree import tree_map
    f32 = tree_map(lambda t: t.float(), params)
    del params
    exact = plain_logits(torch, dataclasses.replace(nd, dtype="float32"),
                         f32, seq, positions)
    moved, _ = rel_abs(want, exact)
    bar = max(BF16_TOL, 2 * moved)
    check(rel <= bar, f"13c: decode against the forward (capacity factor "
          f"{NO_DROP}) rel err {rel} (bf16 moves the forward {moved} from "
          f"f32; bar {bar})")
    del f32, want, exact, steps_lg
    gc.collect()
    torch.cuda.empty_cache()
    pre_b, pre_by, dec_b, dec_by, _ = moe_serve_bounds(cfg, B, P, steps + 1)
    print(f"  13c deepseek-v2-236b bf16, depth {DS236_DEPTH}: prefill of "
          f"{B} x {P} and {steps} greedy decode steps {secs:.2f} s (bounds: "
          f"prefill {pre_b:.3f} ms, {pre_by}; decode {dec_b:.3f} ms a step, "
          f"{dec_by}), allocator peak {peak / 2**30:.2f} GiB; at capacity "
          f"factor {NO_DROP} the decode steps against the forward rel err "
          f"{rel:.2e} (abs {ab:.2e}; bf16 moves the forward {moved:.2e} "
          f"from its f32 value; bar {bar:.1e})", flush=True)
    row = {"serve_s": secs, "peak_bytes": peak, "decode_rel_err": rel,
           "bf16_moved": moved, "bar": bar,
           "prefill_bound_ms": pre_b, "decode_bound_ms": dec_b}
    row["mla"] = mla_alone(torch, "13c deepseek-v2-236b f32 (q-LoRA)", cfg)
    row["moe"] = moe_alone(torch, "13c deepseek-v2-236b f32",
                           dataclasses.replace(cfg, dtype="float32"),
                           *MOE_TOKENS)
    return row


def mamba_plain(torch, params, cfg, x):
    """Mamba-1 as a plain per-step recurrence over the whole sequence (no
    chunks, no padding), in float32: the projections and conv of
    ``mamba_forward``, then h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t and
    y_t = C_t . h_t + D x_t one step at a time."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    d_in, dt_rank, N, K = ssm.mamba_dims(cfg)
    x1, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(ssm.causal_conv(x1, params["conv_w"], params["conv_b"]))
    dt_lo, Bs, Cs = (xc @ params["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = F.softplus((dt_lo @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    h = torch.zeros((x.shape[0], d_in, N), device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * xc[:, t].float())[..., None]
             * Bs[:, t, None].float())
        ys.append((h * Cs[:, t, None].float()).sum(-1))
    y = torch.stack(ys, 1) + params["D"] * xc.float()
    return (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]


def _grads(torch, fn, inputs, ct):
    for t in inputs:
        t.requires_grad_(True)
    y = fn()
    return [y.detach(), *torch.autograd.grad(y, inputs, ct)]


def _event_ms(torch, fn, runs=3):
    """Median CUDA-event ms of ``fn`` over ``runs`` calls after one."""
    fn()
    times = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def jamba_layers_leg(torch, kernels, counts):
    """13d jamba-layers-full: at jamba-1.5-large-398b's full width in f32,
    each sub-layer kind alone, params random from SEED.  The Mamba mixer
    (d_in 16384, N 16, dt_rank 512) at B x S: the chunked forward and its
    gradients (x and every param) against autograd of ``mamba_plain``; a
    prefill of P with cache, then decode steps against the forward at each
    position.  The attention sub-layer's mixer (64 heads over 8 of 128)
    through K4 against the plain ``sdpa``: output and gradients.  One MoE
    FFN (16 experts top-2 of 24576, 9.66 B params) against the per-expert
    loop, in f32 where it fits (gradients into x and the router), else in
    bf16 at BF16_TOL.  Each part's forward timed (CUDA events): the Mamba
    scan's share of the layers."""
    from repro_torch.common.paramdef import init_params
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_config(JAMBA), dtype="float32",
                              use_flash_kernel=True)
    B, S, P, steps = JAMBA_LAYER
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    ct = torch.randn(x.shape, generator=gen, device="cuda")
    row = {}
    # the Mamba mixer
    params = init_params(SEED, ssm.mamba_defs(cfg), "cuda",
                         draw_on_device=True)
    inputs = [x] + [params[k] for k in sorted(params)]
    got = _grads(torch, lambda: ssm.mamba_forward(params, cfg, x, None),
                 inputs, ct)
    want = _grads(torch, lambda: mamba_plain(torch, params, cfg, x), inputs,
                  ct)
    rel_f, _ = rel_abs(got[0], want[0])
    rel_g, _ = rel_abs(got[1:], want[1:])
    full = got[0]
    del got, want
    with torch.no_grad():
        _, cache = ssm.mamba_forward(params, cfg, x[:, :P], None,
                                     with_cache=True)
        rel_d = 0.0
        for t in range(P, P + steps):
            y, cache = ssm.mamba_decode(params, cfg, x[:, t:t + 1], cache, t)
            rel_d = max(rel_d, rel_abs(y, full[:, t:t + 1])[0])
        mamba_ms = _event_ms(torch, lambda: ssm.mamba_forward(
            params, cfg, x, None))
        d_in, dt_rank, N, _ = ssm.mamba_dims(cfg)
        xc = torch.randn((B, S, d_in), generator=gen, device="cuda")
        dt, Bs, Cs = ssm._mamba_ssm_inputs(params, cfg, xc)
        A = -torch.exp(params["A_log"])
        h0 = torch.zeros((B, d_in, N), device="cuda")
        scan_ms = _event_ms(torch, lambda: ssm._mamba_scan(dt, Bs, Cs, xc,
                                                           A, h0))
        del xc, dt, Bs, Cs, cache
    check(max(rel_f, rel_g, rel_d) <= TOL,
          f"13d Mamba: forward {rel_f}, gradients {rel_g}, decode {rel_d}")
    row["mamba"] = {"forward_rel": rel_f, "grad_rel": rel_g,
                    "decode_rel": rel_d, "forward_ms": mamba_ms,
                    "scan_ms": scan_ms}
    del params, inputs, full
    gc.collect()
    torch.cuda.empty_cache()
    # the attention mixer, K4 against sdpa
    params = init_params(SEED + 1, attn.attn_defs(cfg), "cuda",
                         draw_on_device=True)
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    inputs = [x] + [params[k] for k in sorted(params)]
    (k_out, got_k) = counted(kernels, counts, _grads, torch,
                             lambda: attn.attn_forward(params, cfg, x, pos),
                             inputs, ct)
    expect_launches("13d attention", got_k, flash_attention_fwd=1)
    p_out = _grads(torch, lambda: attn.attn_forward(params, plain, x, pos),
                   inputs, ct)
    rel_a, _ = rel_abs(k_out[0], p_out[0])
    rel_ag, _ = rel_abs(k_out[1:], p_out[1:])
    check(max(rel_a, rel_ag) <= TOL,
          f"13d attention through K4: output {rel_a}, gradients {rel_ag}")
    del k_out, p_out
    with torch.no_grad():
        reset_all(kernels)
        attn_ms = _event_ms(torch, lambda: attn.attn_forward(params, cfg, x,
                                                             pos))
        for n, c in read_all(kernels).items():
            counts[n] += c
    row["attention"] = {"forward_rel": rel_a, "grad_rel": rel_ag,
                        "forward_ms": attn_ms}
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    # one MoE FFN: f32 where its 38.7 GB (and the loop's) fit
    moe_bytes = 3 * cfg.d_model * cfg.moe.d_ff_expert * \
        cfg.moe.num_experts * 4
    f32 = torch.cuda.mem_get_info()[0] > 1.5 * moe_bytes
    mcfg = cfg if f32 else dataclasses.replace(cfg, dtype="bfloat16")
    row["moe"] = moe_alone(torch, f"13d jamba-1.5-large-398b {mcfg.dtype}",
                           mcfg, B, S, weight_grads=False,
                           tol=TOL if f32 else BF16_TOL)
    gc.collect()
    torch.cuda.empty_cache()
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"  13d jamba-1.5-large-398b f32 sub-layers at B {B}, S {S}: "
          f"Mamba (d_in {ssm.mamba_dims(cfg)[0]}) forward {rel_f:.2e}, "
          f"gradients {rel_g:.2e} against the plain recurrence, {steps} "
          f"decode steps after a prefill of {P} {rel_d:.2e}; attention "
          f"through K4 against sdpa {rel_a:.2e}, gradients {rel_ag:.2e} "
          f"(bar {TOL:.0e}); forwards (CUDA events): Mamba mixer "
          f"{mamba_ms:.2f} ms (its scan {scan_ms:.2f} ms, "
          f"{scan_ms / mamba_ms:.0%}), attention mixer {attn_ms:.2f} ms; "
          f"allocator peak {row['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return row


def jamba_smoke_leg(torch, np, kernels, counts):
    """13e jamba-smoke: jamba-1.5-large-398b's smoke config whole (16
    layers, 2 periods).  Greedy prefill and decode against the plain
    forward at capacity factor NO_DROP (``decode_check``, each mixer alone
    too), K4 once an attention layer in the prefill; ``serve.main`` at the
    same size; ``train.main`` for 2 rounds: every loss finite, K4 once an
    attention layer run, K1-K3 twice a local step."""
    import shutil
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.memory import estimate_stage_memory
    from repro_torch.core.progressive import make_transformer_adapter
    from repro_torch.launch import serve, train
    cfg = dataclasses.replace(no_drop(get_smoke_config(JAMBA)),
                              use_flash_kernel=True)
    n_attn = cfg.num_periods * sum(k == "attn" for k, _ in cfg.pattern)
    B, P, gen = JAMBA_SERVE
    row = {}
    row["decode"], _ = decode_check(torch, np, kernels, "13e jamba smoke",
                                    cfg, B, P, gen - 1, counts,
                                    {"flash_attention_fwd": n_attn},
                                    per_layer=True)
    out, got = counted(kernels, counts, serve.main, [
        "--arch", JAMBA, "--batch", str(B), "--prompt-len", str(P),
        "--gen", str(gen)])
    expect_launches("13e serve.main", got, flash_attention_fwd=n_attn)
    row["serve"] = {k: out[k] for k in ("prefill_s", "decode_s",
                                        "tokens_per_s")}
    out_dir = tempfile.mkdtemp(prefix="train_jamba_")
    torch.cuda.reset_peak_memory_stats()
    try:
        with server_rounds(kernels) as rows:
            out, got = counted(kernels, counts, train.main,
                               JAMBA_TRAIN_ARGV + ["--out", out_dir])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    adapter = make_transformer_adapter(get_smoke_config(JAMBA), 4)
    row["memory"] = leg_memory(torch, "13e train.main", max(
        estimate_stage_memory(adapter, t, 8, seq=64).total
        for t in range(adapter.plan.num_stages)))
    check(len(rows) == 2, f"13e: {rows}")
    for r in rows:
        n = r["local_steps"]
        check(n > 0 and math.isfinite(r["loss"]), f"13e: {r}")
        expect_launches(f"13e round {r['round']}", r["launches"],
                        flash_attention_fwd=n * r["periods"], nhsic=2 * n)
    print(f"  13e jamba smoke: serve.main {row['serve']['tokens_per_s']:.1f}"
          f" tokens/s; train.main {' '.join(JAMBA_TRAIN_ARGV)}: rounds "
          f"(stage, local steps, loss) "
          f"{[(r['stage'], r['local_steps'], r['loss']) for r in rows]}, "
          f"{out['seconds']:.1f} s", flush=True)
    row["rounds"] = rows
    del out
    return row


def moe_path(torch, np, kernels):
    """Main path 13: 13a-13e, TF32 off, every K4 and nHSIC shape held by
    the kernel phase; the launches of the driven runs and each part's
    seconds."""
    counts = {n: 0 for n in read_all(kernels)}
    out, took = {}, {}
    t0 = time.perf_counter()
    legs = (("13a", lambda: moe_serve_leg(torch, np, kernels, counts)),
            ("13b", lambda: moe_train_leg(torch, np, kernels, counts)),
            ("13c", lambda: ds236_leg(torch, np, kernels, counts)),
            ("13d", lambda: jamba_layers_leg(torch, kernels, counts)),
            ("13e", lambda: jamba_smoke_leg(torch, np, kernels, counts)))
    with flash_shapes_seen() as fseen, nhsic_shapes_seen() as nseen:
        for key, fn in legs:
            t1 = time.perf_counter()
            out[key] = fn()
            took[key] = time.perf_counter() - t1
            print(f"  {key}: {took[key]:.1f} s", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    check_flash_held(fseen, "main path 13")
    check_held(nseen, "main path 13")
    check(counts["flash_attention_fwd"] > 0
          and all(counts[n] > 0 for n in STREAMING),
          f"main path 13: launches {counts}")
    took["total"] = time.perf_counter() - t0
    out["seconds"] = took
    print(f"  main path 13 parts (s): "
          f"{ {k: round(v, 1) for k, v in took.items()} }", flush=True)
    return out, counts


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

    phase("main path 9: ResNet18 on the buffered-async runtime")
    asy, acounts = async_path(torch, kernels, np)
    phase("main path 9: ViT-12 on the buffered-async runtime")
    asy["vit12"], avcounts = async_vit_path(torch, kernels, np)
    phase("main path 9: the async example")
    asy["example"], aecounts = async_example_phase(torch, kernels)
    phase("main path 9: the throughput's async and population modes")
    asy["throughput"], atcounts = async_throughput_phase(torch, kernels)

    phase("main path 10: rounds on a mesh of ranks")
    mesh, mcounts = mesh_path(torch, kernels, np, asy)
    del asy["final_params"]
    gc.collect()
    torch.cuda.empty_cache()

    phase("main path 11: serving")
    serving, servcounts = serving_path(torch, np, kernels)

    phase("main path 12: LLM training")
    training, traincounts = training_path(torch, np, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    phase("main path 13: Mamba, MoE and MLA")
    moe, moecounts = moe_path(torch, np, kernels)
    gc.collect()
    torch.cuda.empty_cache()

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
               "fl_round_throughput": tcounts, "async_resnet18": acounts,
               "async_vit12": avcounts, "async_example": aecounts,
               "async_throughput": atcounts, "tables": tabcounts,
               "fig7": f7counts, "fig6": fcounts, "resume": rescounts,
               "fig2": f2counts, "fig5": f5counts, "fig8": f8counts,
               "quickstart": qcounts, "serving": servcounts,
               "training": traincounts, "moe": moecounts,
               **{p: {n: c.get(n, 0) for n in xcounts}
                  for p, c in mcounts.items()}}
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
                   "quickstart": quick_out, "async": asy, "mesh": mesh,
                   "serving": serving, "training": training, "moe": moe,
                   "kernels": out_kernels, "device": device}, f, indent=1)
    phase("done")
    print(f"main path 11 took {serving['seconds']['total']:.1f} s, main "
          f"path 12 {training['seconds']['total']:.1f} s, main path 13 "
          f"{moe['seconds']['total']:.1f} s; the whole run "
          f"{time.perf_counter() - START:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": out_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        sys.exit(resume_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(*sys.argv[2:6]))
    sys.exit(main())
