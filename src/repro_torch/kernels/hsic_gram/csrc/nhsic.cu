// nHSIC kernels for Hopper (sm_90a): the Curriculum Mentor's
// nHSIC(A; B) = tr(K~a K~b) / (|K~a|_F |K~b|_F) and its gradient.  The
// streaming kernels recompute every Gram tile from the (B, D) activations,
// so no (B, B) matrix is ever written to device memory, forward or
// backward; the two dense-Gram kernels write the Grams out and reduce them
// in a second pass (the forward-only baseline the streaming path is
// benchmarked against).
//
// Which TPU kernel each entry point replaces (src/repro/kernels/hsic_gram/):
//   nhsic_rowsums      <- kernel.py:nhsic_rowsums_pallas     (_rowsums_kernel)
//   nhsic_stats_feats  <- kernel.py:nhsic_stats_feats_pallas (_stats_feats_kernel)
//   nhsic_grad         <- kernel.py:nhsic_grad_pallas        (_grad_kernel)
//   gram               <- kernel.py:gram_pallas              (_rbf_gram_kernel)
//   gram_stats         <- kernel.py:gram_stats_pallas        (_stats_kernel)
//
// What bounds them on the H100: at the training batch (B = 32) each call
// reads at most (32 x 4096) floats and does a few MFLOP, which the card
// moves and computes in about a microsecond, so latency bounds every call:
// the launch, the chain of dependent loads and barriers, and how many SMs
// share the work.  No call synchronises the host: scalars such as sigma^2
// and the Gram means are read from device memory by the kernel.  At large
// B the Gram arithmetic (2 B^2 D FLOPs per matrix) dominates; it runs in
// fp32 on CUDA cores.  The dense-Gram statistics read two (B, B) Grams
// once, so bytes bound them.
// Tensor cores (TF32) are avoided on purpose: a Gram tile is computed as
// |a|^2 + |b|^2 - 2 a.b, clamped at 0, which cancels badly at a 10-bit
// mantissa, and an MMA's internal order of summation would make the
// distance of two identical rows depend on where they sit (see K6 below).
//
// Properties every kernel keeps:
//   * Results are the same from run to run: no atomics, every sum in a
//     fixed order, as resumed training runs require.
//   * B and D are arbitrary.  Rows and columns outside [0, B) are masked in
//     the kernel: a masked entry adds nothing to any sum and is never
//     written.  (A zero pad row would add exp(0) = 1 to an RBF Gram, which
//     is why the TPU version never pads the streaming kernels.)
//   * Row norms are accumulated with the same fma sequence, and added in
//     the same order, as the dot products, so a diagonal distance is
//     exactly 0 and identical rows have an RBF value of exactly 1.
//
// K1, the row sums.  Its first version was a grid of (row tiles, 2)
// blocks, one block summing the rows of Kx and one those of Kz: a call at
// B <= 32 ran on two of the 132 SMs, each walking the whole of D in
// 32-column chunks through shared memory with two block barriers each and
// no asynchronous copies.  That took 0.0410 ms of device time at B = 32,
// Dx = 256, Dz = 512 and 0.1492 ms at B = 16, Dx = Dz = 2048 (NVIDIA H100
// 80GB HBM3, 700.00 W), 1,400-1,900x its bound.  The redesign is K3's
// layout (below): one launch of a cluster of C blocks (`cluster_size`, the
// same C as K2's and K3's) per row tile, both sides in one cluster; each
// rank computes its slice of the tile's dots and norms with `gram_pass`
// and publishes them.  Rank r then owns 32 / C of the tile's rows: it adds
// the ranks' partials of those entries through distributed shared memory
// in rank order (a rank that read the whole tile, as K3's do, moved 3x K2's
// DSMEM traffic and took 0.0090 ms), forms Kx and Kz, adds each row's 32
// entries (a warp a row) to a running sum in registers, column tile 0 to
// nb - 1 in turn, and writes its rows of rx and rz.  So K1's Gram entries
// are the same bits as those K2 and K3 centre, and identical rows give RBF
// row sums of exactly B.  Measured (benchmarks/kernel_calls.py, the first
// version timed in the same run; NVIDIA H100 80GB HBM3, 700.00 W): 0.0064
// / 0.0079 ms of device time at the two shapes above (first version 0.0408
// / 0.1490), 0.036 ms at B = 256, Dx = 256, Dz = 64, where a cluster takes
// the 8 column tiles in turn (0.161).
//
// K2 (statistics) and K3 (gradient).  Their first version was K1's first
// design: a call at B <= 32 (every call of the training paths) ran on one
// block of one of the 132 SMs, walking the whole of D in 32-column chunks
// with two block barriers each; K2 added a second launch, and K3
// zero-filled dx and dz in device memory and added each column tile's
// W . x_j into them there.  That took 0.074 / 0.168 ms of device time at
// B = 32, Dx = 256, Dz = 512 and 0.343 / 0.590 ms at B = 16, Dx = Dz =
// 2048 (NVIDIA H100 80GB HBM3, 700.00 W), 1,000-10,000x their bounds.  The
// redesign:
//   * One launch, and a thread-block cluster of C blocks (4 to 16, about
//     64 columns of D a block, `cluster_size`) for each row tile (K3) or
//     tile pair (K2):
//     rank r of the cluster owns a slice of the columns of x and of z
//     (multiples of 4 floats, so cp.async moves 16 bytes where D % 4 ==
//     0), so a B = 32 call runs on C SMs.  A slice wider than 256 columns
//     is taken in segments (K3 recomputes the Grams per segment); trailing
//     ranks of a narrow D own nothing and add exact zeros.
//   * Each rank loads its slice of the tile's rows into shared memory once
//     (the z rows load while x is multiplied) and computes the partial
//     32 x 32 dot tile (4 entries a thread; a batch of B <= 16 computes
//     only the one entry of each thread that is not masked) and the
//     partial squared norms.  The partials go to the rank's shared memory;
//     after one cluster barrier every rank reads all C partials through
//     distributed shared memory in rank order 0..C-1 and adds them, so
//     every rank holds the same full tile, bit for bit.
//   * K3: every rank forms Kx, Kz, the centred values, G and W of the
//     tile (1,024 entries, redundant across ranks) and the row sums of W,
//     then its own slice of W . x_j from the column tile's rows already in
//     its shared memory, summed over column tiles in registers; dx and dz
//     are written once, coalesced, with the RBF term rowsum(W)_i x_i from
//     the row tile's rows in shared memory: no zero fill, no += through
//     device memory, no second read of x.  A second cluster barrier, whose
//     wait is deferred past the product, keeps each rank's partials alive
//     while the others read them.
//   * K2: rank r takes 1024 / C of the tile's entries for the three
//     centred products; the ranks' three sums are stored into rank 0's
//     shared memory, added there in rank order after a second barrier, and
//     written to `out` where the call has one tile; otherwise to `partial`,
//     which sum_partials_kernel adds in tile order.
//   * A launch that the card refuses (for instance a cluster it cannot
//     place) returns its error; the wrapper raises.
// Measured (benchmarks/kernel_calls.py, the first version timed in the
// same run; NVIDIA H100 80GB HBM3, 700.00 W): K2 0.0074 / 0.0087 ms of
// device time at B = 32, Dx = 256, Dz = 512 and at B = 16, Dx = Dz = 2048
// (first version 0.074 / 0.338), K3 0.0130 / 0.0123 (0.170 / 0.609); both
// remain latency-bound, about 5.5 (K2) and 8 (K3) us at the smallest
// shapes.  Cluster sizes: benchmarks/nhsic_cluster.py and PERF.md.
//
// K6, the dense Gram.  Its work at the benchmark's B = 256, D = 256 is
// 16.8 MFLOP (well under a microsecond on the CUDA cores) and 0.5 MB (0.16
// us at 3.35 TB/s): latency, not work, sets its time.  Its first version
// (one block per 32 x 32 output tile, each block loading, synchronising and
// multiplying its D in eight 32-column chunks in turn, the full square)
// took 26-27 us of device time at B = 256 and at B = 32, 4x `x @ x.T`
// (NVIDIA H100 80GB HBM3, 700.00 W).  The redesign:
//   * Symmetry: one block per tile pair (ti, tj >= ti), nb (nb + 1) / 2
//     blocks; an off-diagonal block writes its tile and, through shared
//     memory so that both writes coalesce, its transpose.  The Gram is
//     exactly symmetric: fmaf(a, b, c) and fmaf(b, a, c) are the same bits.
//   * D split across the block's 8 warps: each warp multiplies the whole
//     32 x 32 tile on its slice of D with a 4 x 8 register tile per lane,
//     so a single-tile batch (B = 32) runs eight independent chains; the
//     warps' partials are then added in warp order in shared memory (the
//     same result on every run, no atomics).
//   * Loads by cp.async, 16 bytes a copy where D % 4 == 0 (else 4), each
//     warp keeping two 16-column chunks in flight, so the next chunk loads
//     while the current one is multiplied; masked rows and columns are
//     filled with zeros by the copy itself.
//   * Exact diagonal: each block sums |x_i|^2 with the fma sequence and the
//     warp order of its dot products, so identical rows anywhere in the
//     batch have a distance of exactly 0 (an RBF value of exactly 1)
//     without a special case; the clamp at 0 stays.  It stays on CUDA cores
//     for that reason: the arithmetic is not what bounds it.
// Measured: PERF.md (chip_smoke.py's gram timing).
//
// K7, the centred statistics of two dense Grams.  Its first version took
// the Grams' row, column and total means from five PyTorch reductions in
// the wrapper, then launched one block per 32 x 32 tile pair and a second
// kernel that added the tiles' sums: 4.0 us of device time for its own
// two kernels at B = 256 and at B = 32 (the reductions' device time not
// measured) and 0.21 / 0.15 ms of event time (NVIDIA H100 80GB HBM3,
// 700.00 W).  The redesign is one launch of one cluster of C = min(16,
// tiles(B)) blocks, which computes the means itself, as the TPU kernel's
// function does:
//   * Rank r owns the 32-row bands r, r + C, ...  Pass 1 reads its rows of
//     both Grams once, coalesced, and forms their row sums (a warp a row)
//     and its partial column sums over its rows (a thread a column, in row
//     order), all in double, so the order of the terms does not matter at
//     the f32 bar.  Up to B = 16 x 32 = 512 a rank owns one band, which is
//     copied into its shared memory by cp.async and read from there; a
//     rank of a larger B reads its bands from device memory (L2), twice.
//   * After a cluster barrier every rank adds the C partial column sums
//     through distributed shared memory in rank order (the C loads issued
//     together), and the ranks' totals of their row sums in rank order for
//     the total means.
//   * Pass 2 centres each entry as K - c_j - r_i + m in f32, the plain
//     version's order of terms, and sums the three products in double; the
//     ranks' sums are added in rank order by rank 0, which writes `out`.
//   * Shared memory holds two doubles per column, so B is at most 13,619
//     (two Grams of 742 MB each); a larger B is refused and the wrapper
//     raises.
// Measured (benchmarks/kernel_calls.py, the first version timed in the same
// run; NVIDIA H100 80GB HBM3, 700.00 W): 0.0107 / 0.0070 ms of device time
// at B = 256 / 32 in one device op, against 0.0351 / 0.0196 ms in nine
// (the wrapper's reductions took 0.031 / 0.016 of it).  About 4.5 us of
// either is the floor every kernel here pays (K6 takes 4.4 us at B = 32);
// benchmarks/gram_stats_parts.py times the rest part by part.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;                  // rows and columns of one Gram tile
                                          // (kernel.py sizes `partial` by it)
constexpr int THREADS = 256;              // 8 warps
constexpr int PER_THREAD = TILE * TILE / THREADS;   // tile entries per thread
constexpr int ROW_STEP = THREADS / TILE;  // rows between a thread's entries

// Thread tid owns tile entries (tid / TILE + q * ROW_STEP, tid % TILE).
__device__ __forceinline__ int entry_row(int q) {
  return threadIdx.x / TILE + q * ROW_STEP;
}

// Sum of v over the block, the same order on every run; valid in thread 0.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// One block: out[k] = sum over blocks of partial[3 * blk + k], fixed order.
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, int nblocks,
                    float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  partial += (size_t)3 * nblocks * blockIdx.x;   // block x: the cohort
  out += 3 * blockIdx.x;
  for (int k = 0; k < 3; ++k) {
    float v = 0.f;
    for (int b = threadIdx.x; b < nblocks; b += THREADS) v += partial[3 * b + k];
    v = block_sum(v, red);
    if (threadIdx.x == 0) out[k] = v;
  }
}

// ---- K6, the dense Gram (see the header: symmetric tiles, D split across
// the warps, cp.async double buffering, an exact diagonal) ----
constexpr int GRAM_WARPS = THREADS / 32;  // 8 warps, one slice of D each
constexpr int GKC = 16;                   // D columns per cp.async chunk
constexpr int GLD = GKC + 4;              // padded smem row: 16-byte aligned,
                                          // 8 rows on 8 distinct bank groups
constexpr int GSTAGES = 2;                // chunks in flight per warp
constexpr int GSTAGE = 2 * TILE * GLD;    // floats of one stage: a and b rows
constexpr int GWARP = GSTAGES * GSTAGE;   // floats of one warp's ring
constexpr int GPART = TILE * (TILE + 1);  // floats of one padded (TILE, TILE)
constexpr size_t GRAM_SMEM = sizeof(float) * GRAM_WARPS * GWARP;
// after the loads the ring is reused: the warps' partial tiles, their
// partial norms, the summed norms and the finished tile
static_assert(GRAM_WARPS * GPART + GRAM_WARPS * 2 * TILE + 2 * TILE + GPART
                  <= GRAM_WARPS * GWARP,
              "K6's reduction must fit in the load ring");

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)  // 16 bytes; src-size 0 writes zeros (masked rows and columns)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies rows [row0, row0 + TILE) x columns [k0, k0 + GKC) of a
// (B, D) into dst (TILE, GLD); rows >= B and columns >= D become 0.
__device__ __forceinline__ void gram_chunk(const float* __restrict__ a, int B,
                                          int D, int row0, int k0, float* dst,
                                          bool vec, int lane) {
  if (vec) {
    for (int e = lane; e < TILE * GKC / 4; e += 32) {
      const int r = e / (GKC / 4), k = k0 + 4 * (e % (GKC / 4));
      const bool in = row0 + r < B && k < D;
      cp_async(dst + r * GLD + (k - k0), in ? a + (size_t)(row0 + r) * D + k
                                            : a, true, in);
    }
  } else {
    for (int e = lane; e < TILE * GKC; e += 32) {
      const int r = e / GKC, k = k0 + e % GKC;
      const bool in = row0 + r < B && k < D;
      cp_async(dst + r * GLD + (k - k0), in ? a + (size_t)(row0 + r) * D + k
                                            : a, false, in);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid: one block per tile pair (ti, tj), tj >= ti, of the Gram of a (B, D)
// into out (B, B) row-major.  s2 points at sigma^2 (read, but unused, for
// the linear Gram).  `vec`: D % 4 == 0 and `a` 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ a, const float* __restrict__ s2,
            float* __restrict__ out, int B, int D, int linear, int vec) {
  extern __shared__ float4 gram_smem4[];
  float* smem = reinterpret_cast<float*>(gram_smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int ti = 0, t = blockIdx.x;
  for (int n = (B + TILE - 1) / TILE; t >= n - ti; ++ti) t -= n - ti;
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int i0 = ti * TILE, j0 = tj * TILE;

  // this warp's slice of D: chunks [c0, c1)
  const int nchunk = (D + GKC - 1) / GKC;
  const int per = (nchunk + GRAM_WARPS - 1) / GRAM_WARPS;
  const int c0 = min(warp * per, nchunk), c1 = min(c0 + per, nchunk);
  float* ring = smem + warp * GWARP;

  // lane owns rows rg + 8 i (i < 4) and columns cg + 4 j (j < 8) of the
  // tile, and the norms of row `lane` of each side
  const int rg = lane / 4, cg = lane % 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float na = 0.f, nb = 0.f;

  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (c0 + s < c1) {
      float* st = ring + s * GSTAGE;
      gram_chunk(a, B, D, i0, (c0 + s) * GKC, st, vec, lane);
      if (!diag) gram_chunk(a, B, D, j0, (c0 + s) * GKC, st + TILE * GLD,
                            vec, lane);
    }
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    const int next = c + GSTAGES - 1;
    if (next < c1) {
      float* st = ring + ((next - c0) % GSTAGES) * GSTAGE;
      gram_chunk(a, B, D, i0, next * GKC, st, vec, lane);
      if (!diag) gram_chunk(a, B, D, j0, next * GKC, st + TILE * GLD, vec,
                            lane);
    }
    cp_async_commit();                   // empty groups keep the count fixed
    cp_async_wait<GSTAGES - 1>();
    __syncwarp();                        // every lane's copies have landed
    const float* as = ring + ((c - c0) % GSTAGES) * GSTAGE;
    const float* bs = diag ? as : as + TILE * GLD;
#pragma unroll
    for (int k = 0; k < GKC; k += 4) {
      float4 av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (rg + 8 * i) * GLD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(bs + (cg + 4 * j) * GLD + k);
      const float4 an = *reinterpret_cast<const float4*>(as + lane * GLD + k);
      const float4 bn = *reinterpret_cast<const float4*>(bs + lane * GLD + k);
      // the same fma sequence for dots and norms: identical rows give a
      // dot equal to their norms, bit for bit
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(lane_of(av[i], kk), lane_of(bv[j], kk),
                             acc[i][j]);
        na = fmaf(lane_of(an, kk), lane_of(an, kk), na);
        nb = fmaf(lane_of(bn, kk), lane_of(bn, kk), nb);
      }
    }
    __syncwarp();                        // stage read before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();                       // every ring is free for reuse

  float* part = smem;                                  // [warp][TILE][TILE+1]
  float* pnorm = part + GRAM_WARPS * GPART;            // [warp][2 TILE]
  float* norm = pnorm + GRAM_WARPS * 2 * TILE;         // [2 TILE]
  float* K = norm + 2 * TILE;                          // [TILE][TILE+1]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      part[warp * GPART + (rg + 8 * i) * (TILE + 1) + cg + 4 * j] = acc[i][j];
  pnorm[warp * 2 * TILE + lane] = na;
  pnorm[warp * 2 * TILE + TILE + lane] = nb;
  __syncthreads();
  // the warps' partials added in warp order, dots and norms alike
  float dot[PER_THREAD];
  const int cc = threadIdx.x % TILE;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = entry_row(q) * (TILE + 1) + cc;
    float v = part[e];
    for (int w = 1; w < GRAM_WARPS; ++w) v += part[w * GPART + e];
    dot[q] = v;
  }
  if (threadIdx.x < 2 * TILE) {
    float v = pnorm[threadIdx.x];
    for (int w = 1; w < GRAM_WARPS; ++w) v += pnorm[w * 2 * TILE + threadIdx.x];
    norm[threadIdx.x] = v;
  }
  __syncthreads();
  const int j = j0 + cc;
  // one division per thread, not per entry: an IEEE division (with its
  // slow path) per entry was most of the RBF mode's extra time
  const float ninv = -0.5f / s2[0];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = entry_row(q), i = i0 + r;
    float v = dot[q];
    if (!linear) {
      const float d2 = fmaxf(norm[r] + norm[TILE + cc] - 2.f * v, 0.f);
      v = expf(d2 * ninv);
    }
    K[r * (TILE + 1) + cc] = v;
    if (i < B && j < B) out[(size_t)i * B + j] = v;
  }
  if (diag) return;
  __syncthreads();
  // the mirror tile, read down K's columns so that the writes coalesce
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = entry_row(q), i = j0 + r, jj = i0 + cc;
    if (i < B && jj < B) out[(size_t)i * B + jj] = K[cc * (TILE + 1) + r];
  }
}

// ---- K2 and K3: the D axis split over a thread-block cluster (see the
// header) ----
constexpr int SEG = 256;          // most columns of a rank's slice that its
                                  // slabs hold at once
constexpr int WLD = TILE + 4;     // row stride of a transposed W tile
constexpr int NORMS = 2 * TILE * TILE;       // offset of the norms in XCH
constexpr int XCH = NORMS + 4 * TILE;        // floats a rank publishes per
                                             // tile pair: the x and z dots,
                                             // then x row, x column, z row,
                                             // z column norms
constexpr int MAX_CLUSTER = 16;

__host__ __device__ constexpr int slice_of(int D, int C) {
  return ((D + C - 1) / C + 3) / 4 * 4;
}
// slab row stride: a multiple of 4 (16-byte rows) with ld / 4 odd, so 8
// rows read at one column fall on 8 distinct bank groups
__host__ __device__ constexpr int ld_of(int slice) {
  return ((slice < SEG ? slice : SEG) + 7) / 8 * 8 + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ float* peer(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// One side (x or z) of the pair as the cluster splits it: rank r owns the
// columns [r * slice, (r + 1) * slice) of D, in nseg segments of at most
// SEG columns; trailing ranks may own none.  `row` and `col` are the
// rank's slabs (TILE x ld) of the row tile's and the column tile's rows
// (`col` only where a call has more than one tile; a diagonal tile pair
// reads `row` twice); the keys say which (tile * nseg + segment) each
// holds, -1 none.  Every field is the same in all threads of a block.
struct Side {
  const float* a;
  int D, slice, nseg, ld;
  bool vec, linear;
  float* row;
  float* col;
  int row_key, col_key;
};

__device__ __forceinline__ Side make_side(const float* a, int D, int C,
                                          int linear, int vec) {
  Side s;
  s.a = a;
  s.D = D;
  s.slice = slice_of(D, C);
  s.nseg = (s.slice + SEG - 1) / SEG;
  s.ld = ld_of(s.slice);
  s.vec = vec;
  s.linear = linear;
  s.row = s.col = nullptr;
  s.row_key = s.col_key = -1;
  return s;
}

__device__ __forceinline__ int seg_col0(const Side& s, int rank, int seg) {
  return rank * s.slice + seg * SEG;
}
__device__ __forceinline__ int seg_width(const Side& s, int rank, int seg) {
  const int end = rank * s.slice + min(s.slice, (seg + 1) * SEG);
  return max(min(s.D, end) - seg_col0(s, rank, seg), 0);
}

// Issues the copies (the caller commits) of rows [row0, row0 + TILE) x
// columns [col0, col0 + width) of a (B, D) into the slab dst, zero-filling
// rows >= B and the columns up to the next multiple of 4.  `vec`: D % 4
// == 0 and `a` 16-byte aligned, so every copy moves 16 bytes.
__device__ void load_slab(float* dst, int ld, const float* __restrict__ a,
                          int B, int D, int row0, int col0, int width,
                          bool vec) {
  const int w4 = (width + 3) / 4 * 4;
  if (vec) {
    const int g = w4 / 4;
    for (int e = threadIdx.x; e < TILE * g; e += THREADS) {
      const int r = e / g, k = 4 * (e % g);
      const bool in = row0 + r < B;
      cp_async(dst + r * ld + k,
               in ? a + (size_t)(row0 + r) * D + col0 + k : a, true, in);
    }
  } else {
    for (int e = threadIdx.x; e < TILE * w4; e += THREADS) {
      const int r = e / w4, k = e % w4;
      const bool in = row0 + r < B && k < width;
      cp_async(dst + r * ld + k,
               in ? a + (size_t)(row0 + r) * D + col0 + k : a, false, in);
    }
  }
}

// Issues the copies that bring segment `seg` of row tile `it` and column
// tile `jt` into s's slabs, unless they hold it already.
__device__ __forceinline__ void issue_side(Side& s, int B, int rank, int it,
                                           int jt, int seg) {
  const int c0 = seg_col0(s, rank, seg), w = seg_width(s, rank, seg);
  if (s.row_key != it * s.nseg + seg) {
    load_slab(s.row, s.ld, s.a, B, s.D, it * TILE, c0, w, s.vec);
    s.row_key = it * s.nseg + seg;
  }
  if (jt != it && s.col_key != jt * s.nseg + seg) {
    load_slab(s.col, s.ld, s.a, B, s.D, jt * TILE, c0, w, s.vec);
    s.col_key = jt * s.nseg + seg;
  }
}

// The slab that holds the rows of `tile` (`it` the row tile), loaded with
// segment `seg` first if it holds another (only where a slice has more
// than one segment).
__device__ __forceinline__ const float* slab_with(Side& s, int B, int rank,
                                                  int it, int tile, int seg) {
  const bool own = tile == it;
  int& key = own ? s.row_key : s.col_key;
  float* slab = own ? s.row : s.col;
  if (key != tile * s.nseg + seg) {
    __syncthreads();                     // the slab's last readers are done
    load_slab(slab, s.ld, s.a, B, s.D, tile * TILE, seg_col0(s, rank, seg),
              seg_width(s, rank, seg), s.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    key = tile * s.nseg + seg;
  }
  return slab;
}

// Thread t owns the tile entries (tr, tc), (tr, tc + 16), (tr + 16, tc),
// (tr + 16, tc + 16), tr = t / 16, tc = t % 16, and adds the products of
// columns [0, w4) of the slabs a (row tile) and b (column tile) to them.
// QUARTER: rows and columns >= 16 are all masked (B <= 16), so only the
// first entry is computed.  NORM (threads < 2 TILE): also the squared norm
// of slab row `nr`, with the fma sequence of the dot products, so that
// identical rows give a dot equal to their norms, bit for bit.
template <bool QUARTER, bool NORM>
__device__ __forceinline__ void slab_dots(const float* a, const float* b,
                                          int ld, int w4, float acc[4],
                                          float& nrm, const float* nr) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float* a0 = a + tr * ld;
  const float* b0 = b + tc * ld;
#pragma unroll 2
  for (int k = 0; k < w4; k += 4) {
    const float4 A0 = ld4(a0 + k), B0 = ld4(b0 + k);
    float4 A1, B1, N;
    if (!QUARTER) {
      A1 = ld4(a0 + 16 * ld + k);
      B1 = ld4(b0 + 16 * ld + k);
    }
    if (NORM) N = ld4(nr + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float av = lane_of(A0, kk), bv = lane_of(B0, kk);
      acc[0] = fmaf(av, bv, acc[0]);
      if (!QUARTER) {
        acc[1] = fmaf(av, lane_of(B1, kk), acc[1]);
        acc[2] = fmaf(lane_of(A1, kk), bv, acc[2]);
        acc[3] = fmaf(lane_of(A1, kk), lane_of(B1, kk), acc[3]);
      }
      if (NORM) nrm = fmaf(lane_of(N, kk), lane_of(N, kk), nrm);
    }
  }
}

__device__ __forceinline__ void side_dots(const Side& s, int rank, int seg,
                                          bool diag, bool quarter,
                                          float acc[4], float& nrm) {
  const int w4 = (seg_width(s, rank, seg) + 3) / 4 * 4;
  const float* b = diag ? s.row : s.col;
  const int t = threadIdx.x;
  if (t < 2 * TILE) {                    // warps 0 and 1: + the norms
    const float* nr = t < TILE ? s.row + t * s.ld : b + (t - TILE) * s.ld;
    if (quarter) slab_dots<true, true>(s.row, b, s.ld, w4, acc, nrm, nr);
    else slab_dots<false, true>(s.row, b, s.ld, w4, acc, nrm, nr);
  } else {
    if (quarter) slab_dots<true, false>(s.row, b, s.ld, w4, acc, nrm, b);
    else slab_dots<false, false>(s.row, b, s.ld, w4, acc, nrm, b);
  }
}

// This rank's partial dot products (4 entries a thread) and norms (threads
// < 2 TILE: row tile row t, then column tile row t - TILE) of the x and z
// Gram tiles (it, jt) over its slices of Dx and Dz.  The z slabs load
// while the last x segment is multiplied.
__device__ __forceinline__ void gram_pass(Side& X, Side& Z, int B, int rank,
                                          int it, int jt, float ax[4],
                                          float az[4], float& nx, float& nz) {
  const bool diag = it == jt;
  const bool quarter = B - it * TILE <= 16 && B - jt * TILE <= 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) ax[q] = az[q] = 0.f;
  nx = nz = 0.f;
  issue_side(X, B, rank, it, jt, 0);
  cp_async_commit();
  for (int s = 0; s < X.nseg; ++s) {
    if (s + 1 == X.nseg) {
      issue_side(Z, B, rank, it, jt, 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    side_dots(X, rank, s, diag, quarter, ax, nx);
    if (s + 1 < X.nseg) {
      __syncthreads();
      issue_side(X, B, rank, it, jt, s + 1);
      cp_async_commit();
    }
  }
  for (int s = 0; s < Z.nseg; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    side_dots(Z, rank, s, diag, quarter, az, nz);
    if (s + 1 < Z.nseg) {
      __syncthreads();
      issue_side(Z, B, rank, it, jt, s + 1);
      cp_async_commit();
    }
  }
}

// Row-major index of entry q of this thread (see slab_dots).
__device__ __forceinline__ int entry_of(int q) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  return (tr + 16 * (q >> 1)) * TILE + tc + 16 * (q & 1);
}

// Writes this rank's partials to its exchange buffer.
__device__ __forceinline__ void publish(float* xch, const float ax[4],
                                        const float az[4], float nx,
                                        float nz) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    xch[entry_of(q)] = ax[q];
    xch[TILE * TILE + entry_of(q)] = az[q];
  }
  const int t = threadIdx.x;
  if (t < 2 * TILE) {
    xch[NORMS + t] = nx;
    xch[NORMS + 2 * TILE + t] = nz;
  }
}

__device__ __forceinline__ float kernel_value(float dot, float nr, float nc,
                                              bool linear, float ninv) {
  return linear ? dot : expf(fmaxf(nr + nc - 2.f * dot, 0.f) * ninv);
}

// K3's W . x_j on one side: acc[q][e] += sum_c Wt[c][rb RPT + q]
// xs[c][4 cg + e] over the ncols valid columns c of the column tile; xs is
// the slab of the column tile's rows.
template <int RPT>
__device__ __forceinline__ void apply_w(const float* Wt, const float* xs,
                                        int ld, int ncols, int cg, int rb,
                                        float (&acc)[8][4]) {
  for (int c = 0; c < ncols; ++c) {
    const float4 xv = ld4(xs + c * ld + 4 * cg);
    const float* wr = Wt + c * WLD + rb * RPT;
    float wv[RPT];
    if constexpr (RPT >= 4) {
#pragma unroll
      for (int h = 0; h < RPT / 4; ++h) {
        const float4 w4 = ld4(wr + 4 * h);
        wv[4 * h] = w4.x;
        wv[4 * h + 1] = w4.y;
        wv[4 * h + 2] = w4.z;
        wv[4 * h + 3] = w4.w;
      }
    } else if constexpr (RPT == 2) {
      const float2 w2 = *reinterpret_cast<const float2*>(wr);
      wv[0] = w2.x;
      wv[1] = w2.y;
    } else {
      wv[0] = wr[0];
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      acc[q][0] = fmaf(wv[q], xv.x, acc[q][0]);
      acc[q][1] = fmaf(wv[q], xv.y, acc[q][1]);
      acc[q][2] = fmaf(wv[q], xv.z, acc[q][2]);
      acc[q][3] = fmaf(wv[q], xv.w, acc[q][3]);
    }
  }
}

// K3's output rows of one side: g[i0 + r][c0 + 4 cg + e] = scale acc[q][e]
// (+ 4 rowsum(W)_r xr[r][4 cg + e] for RBF), r = rb RPT + q, written once.
template <int RPT>
__device__ __forceinline__ void write_rows(float* __restrict__ g,
                                           const float* xr, int ld,
                                           const float* ws, float scale,
                                           bool rbf, int B, int D, int i0,
                                           int c0, int w, int cg, int rb,
                                           bool vec,
                                           const float (&acc)[8][4]) {
  const int k = 4 * cg;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = rb * RPT + q;
    if (i0 + r >= B) break;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = scale * acc[q][e];
      if (rbf) v[e] = fmaf(4.f * ws[r], xr[r * ld + k + e], v[e]);
    }
    float* dst = g + (size_t)(i0 + r) * D + c0 + k;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < w) dst[e] = v[e];
    }
  }
}

// Which columns and rows of a side's segment this thread computes in K3's
// W . x: the segment's w columns as g groups of 4, gp the next power of 2;
// thread t takes group t % gp and rows [rb rpt, rb rpt + rpt), rb = t / gp,
// so that all 256 threads have work once the segment is 32 columns wide.
struct Item {
  int w, cg, rb, rpt;
  bool on;
};

__device__ __forceinline__ Item item_of(const Side& s, int rank, int seg,
                                        int B, int i0) {
  Item m;
  m.w = seg < s.nseg ? seg_width(s, rank, seg) : 0;
  const int g = (m.w + 3) / 4;
  int gp = 1;
  while (gp < g) gp <<= 1;               // g <= SEG / 4 = 64
  m.rpt = gp > 8 ? gp / 8 : 1;
  m.cg = threadIdx.x % gp;
  m.rb = threadIdx.x / gp;
  m.on = m.cg < g && m.rb * m.rpt < min(TILE, B - i0);
  return m;
}

__device__ __forceinline__ void apply_item(const Item& m, const float* Wt,
                                           const float* xs, int ld,
                                           int ncols, float (&acc)[8][4]) {
  if (!m.on) return;
  switch (m.rpt) {
    case 8: apply_w<8>(Wt, xs, ld, ncols, m.cg, m.rb, acc); break;
    case 4: apply_w<4>(Wt, xs, ld, ncols, m.cg, m.rb, acc); break;
    case 2: apply_w<2>(Wt, xs, ld, ncols, m.cg, m.rb, acc); break;
    default: apply_w<1>(Wt, xs, ld, ncols, m.cg, m.rb, acc);
  }
}

__device__ __forceinline__ void write_item(const Item& m, float* g,
                                           const Side& s, const float* xr,
                                           const float* ws, int B, int i0,
                                           int c0, bool vec,
                                           const float (&acc)[8][4]) {
  if (!m.on) return;
  const float scale = s.linear ? 2.f : -4.f;
#define NHSIC_WRITE(R)                                                    \
  write_rows<R>(g, xr, s.ld, ws, scale, !s.linear, B, s.D, i0, c0, m.w,   \
                m.cg, m.rb, vec, acc)
  switch (m.rpt) {
    case 8: NHSIC_WRITE(8); break;
    case 4: NHSIC_WRITE(4); break;
    case 2: NHSIC_WRITE(2); break;
    default: NHSIC_WRITE(1);
  }
#undef NHSIC_WRITE
}

// Floats of dynamic shared memory of each kernel: the slabs (two per side
// where the call has more than one tile), then the kernel's buffers.
__host__ __device__ constexpr int slab_floats(int D, int C, bool two) {
  return (two ? 2 : 1) * TILE * ld_of(slice_of(D, C));
}
constexpr int GRAD_BUFS = 2 * TILE * WLD + XCH + 4 * TILE + 2 * TILE;
constexpr int STATS_BUFS = XCH + 4 * MAX_CLUSTER + THREADS / 32;

// K2.  Grid (C, column tiles, row tiles x cohorts), clusters of C =
// gridDim.x blocks along x, one per tile pair of a cohort; block x is the
// cluster's rank.  s = [s2x,
// s2z, mean Kx, mean Kz]; rx, rz are the Gram row means.  The ranks'
// partial dots are added through DSMEM in rank order, each rank taking
// 1024 / C of the tile's entries; their (sum Kxc Kzc, sum Kxc^2,
// sum Kzc^2) are added in rank order by rank 0, which writes `out` where
// the call has one tile and partial[3 * (row tile * tiles + column tile)]
// otherwise.
__global__ void __launch_bounds__(THREADS)
nhsic_stats_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ rx, const float* __restrict__ rz,
                   const float* __restrict__ s, float* __restrict__ partial,
                   float* __restrict__ out, int B, int Dx, int Dz, int lx,
                   int lz, int vx, int vz) {
  extern __shared__ float4 nhsic_smem4[];
  float* smem = reinterpret_cast<float*>(nhsic_smem4);
  const int C = gridDim.x, rank = blockIdx.x;
  const int nt = gridDim.y, jt = blockIdx.y, it = blockIdx.z % nt;
  const int i0 = it * TILE, j0 = jt * TILE, t = threadIdx.x;
  const int coh = blockIdx.z / nt;       // the cohort, folded into z
  x += (size_t)coh * B * Dx;
  z += (size_t)coh * B * Dz;
  rx += (size_t)coh * B;
  rz += (size_t)coh * B;
  s += 4 * coh;
  partial += (size_t)3 * nt * nt * coh;
  out += 3 * coh;
  Side X = make_side(x, Dx, C, lx, vx), Z = make_side(z, Dz, C, lz, vz);
  float* p = smem;
  X.row = p;
  p += TILE * X.ld;
  if (nt > 1) {
    X.col = p;
    p += TILE * X.ld;
  }
  Z.row = p;
  p += TILE * Z.ld;
  if (nt > 1) {
    Z.col = p;
    p += TILE * Z.ld;
  }
  float* xch = p;
  float* P = xch + XCH;                  // [rank][3], filled in rank 0
  float* red = P + 4 * MAX_CLUSTER;

  float ax[4], az[4], nx, nz;
  gram_pass(X, Z, B, rank, it, jt, ax, az, nx, nz);
  publish(xch, ax, az, nx, nz);
  cluster_arrive();
  cluster_wait();

  const float nix = -0.5f / s[0], niz = -0.5f / s[1];
  const float mx = s[2], mz = s[3];
  const int per = TILE * TILE / C;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  for (int e = rank * per + t; e < (rank + 1) * per; e += THREADS) {
    const int r = e / TILE, c = e % TILE, i = i0 + r, j = j0 + c;
    if (i >= B || j >= B) continue;
    float dxv = 0.f, dzv = 0.f, nxr = 0.f, nxc = 0.f, nzr = 0.f, nzc = 0.f;
#pragma unroll 4
    for (int q = 0; q < C; ++q) {        // rank order: the same bits in
      const float* o = peer(xch, q);     // every rank and on every run
      dxv += o[e];
      dzv += o[TILE * TILE + e];
      nxr += o[NORMS + r];
      nxc += o[NORMS + TILE + c];
      nzr += o[NORMS + 2 * TILE + r];
      nzc += o[NORMS + 3 * TILE + c];
    }
    const float kxc = kernel_value(dxv, nxr, nxc, lx, nix) - rx[i] - rx[j]
                      + mx;
    const float kzc = kernel_value(dzv, nzr, nzc, lz, niz) - rz[i] - rz[j]
                      + mz;
    p0 = fmaf(kxc, kzc, p0);
    p1 = fmaf(kxc, kxc, p1);
    p2 = fmaf(kzc, kzc, p2);
  }
  p0 = block_sum(p0, red);
  p1 = block_sum(p1, red);
  p2 = block_sum(p2, red);
  if (t == 0) {
    float* P0 = peer(P, 0);
    P0[3 * rank + 0] = p0;
    P0[3 * rank + 1] = p1;
    P0[3 * rank + 2] = p2;
  }
  cluster_arrive();                      // every rank's reads and P done
  cluster_wait();
  if (rank == 0 && t < 3) {
    float v = 0.f;
    for (int q = 0; q < C; ++q) v += P[3 * q + t];
    (nt == 1 ? out : partial + 3 * (it * nt + jt))[t] = v;
  }
}

// K3.  Grid (C, row tiles, cohorts), clusters of C = gridDim.x blocks along
// x, one per row tile of a cohort; block x is the cluster's rank.  scal = [s2x, s2z, mean Kx,
// mean Kz, cA, cBx, cBz].  With Kc the centred Grams, G_x = cA Kzc - cBx
// Kxc and G_z = cA Kxc - cBz Kzc.  RBF: W = G o K (-1 / 2 s2), dx_i =
// 4 (rowsum(W)_i x_i - (W x)_i); linear: dx = 2 G x.  For each column
// tile every rank adds the ranks' partial dots in rank order (all ranks
// hold the same tile), forms W, and adds W . x_j on its own columns from
// its slabs; the rows of dx and dz it owns are written once at the end.
__global__ void __launch_bounds__(THREADS)
nhsic_grad_kernel(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ rx, const float* __restrict__ rz,
                  const float* __restrict__ scal, float* __restrict__ dx,
                  float* __restrict__ dz, int B, int Dx, int Dz, int lx,
                  int lz, int vx, int vz) {
  extern __shared__ float4 nhsic_smem4[];
  float* smem = reinterpret_cast<float*>(nhsic_smem4);
  const int C = gridDim.x, rank = blockIdx.x;
  const int it = blockIdx.y, nt = gridDim.y, i0 = it * TILE;
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  const size_t coh = blockIdx.z;         // the cohort
  x += coh * B * Dx;
  z += coh * B * Dz;
  dx += coh * B * Dx;
  dz += coh * B * Dz;
  rx += coh * B;
  rz += coh * B;
  scal += 7 * coh;
  Side X = make_side(x, Dx, C, lx, vx), Z = make_side(z, Dz, C, lz, vz);
  float* p = smem;
  X.row = p;
  p += TILE * X.ld;
  if (nt > 1) {
    X.col = p;
    p += TILE * X.ld;
  }
  Z.row = p;
  p += TILE * Z.ld;
  if (nt > 1) {
    Z.col = p;
    p += TILE * Z.ld;
  }
  float* Wtx = p;                        // W transposed: Wt[c][r]
  float* Wtz = Wtx + TILE * WLD;
  float* xch = Wtz + TILE * WLD;
  float* nrm = xch + XCH;                // the cluster's norms, as in XCH
  float* wsx = nrm + 4 * TILE;           // rowsum(W) of the row tile
  float* wsz = wsx + TILE;

  const float nix = -0.5f / scal[0], niz = -0.5f / scal[1];
  const float mx = scal[2], mz = scal[3];
  const float ca = scal[4], cbx = scal[5], cbz = scal[6];
  const int nseg = max(X.nseg, Z.nseg);  // 1 unless D > C SEG
  bool first = true;
  for (int sg = 0; sg < nseg; ++sg) {
    const Item mx_ = item_of(X, rank, sg, B, i0);
    const Item mz_ = item_of(Z, rank, sg, B, i0);
    float accx[8][4], accz[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) accx[q][e] = accz[q][e] = 0.f;
    if (t < TILE) wsx[t] = wsz[t] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TILE;
      float ax[4], az[4], nx, nz;
      gram_pass(X, Z, B, rank, it, jt, ax, az, nx, nz);
      if (!first) cluster_wait();        // no rank reads xch any more
      first = false;
      publish(xch, ax, az, nx, nz);
      cluster_arrive();
      cluster_wait();
      // the full tile: the ranks' partials added in rank order
      bool valid[4];
      float dxs[4], dzs[4], ns = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = entry_of(q);
        valid[q] = i0 + e / TILE < B && j0 + e % TILE < B;
        dxs[q] = dzs[q] = 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < C; ++r) {
        const float* o = peer(xch, r);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (valid[q]) {
            dxs[q] += o[entry_of(q)];
            dzs[q] += o[TILE * TILE + entry_of(q)];
          }
        if (t < 4 * TILE) ns += o[NORMS + t];
      }
      cluster_arrive();                  // this rank's reads are done
      if (t < 4 * TILE) nrm[t] = ns;
      __syncthreads();
      // W, its row sums, and Wt for the product
      float wx[4], wz[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = entry_of(q), r = e / TILE, c = e % TILE;
        wx[q] = wz[q] = 0.f;
        if (valid[q]) {
          const int i = i0 + r, j = j0 + c;
          const float kx = kernel_value(dxs[q], nrm[r], nrm[TILE + c], lx,
                                        nix);
          const float kz = kernel_value(dzs[q], nrm[2 * TILE + r],
                                        nrm[3 * TILE + c], lz, niz);
          const float kxc = kx - rx[i] - rx[j] + mx;
          const float kzc = kz - rz[i] - rz[j] + mz;
          const float gx = ca * kzc - cbx * kxc;
          const float gz = ca * kxc - cbz * kzc;
          wx[q] = lx ? gx : gx * kx * nix;
          wz[q] = lz ? gz : gz * kz * niz;
        }
        Wtx[c * WLD + r] = wx[q];
        Wtz[c * WLD + r] = wz[q];
      }
      // rows tr and tr + 16, over the 16 lanes that share them
      float sx0 = wx[0] + wx[1], sx1 = wx[2] + wx[3];
      float sz0 = wz[0] + wz[1], sz1 = wz[2] + wz[3];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sx0 += __shfl_xor_sync(0xffffffffu, sx0, off);
        sx1 += __shfl_xor_sync(0xffffffffu, sx1, off);
        sz0 += __shfl_xor_sync(0xffffffffu, sz0, off);
        sz1 += __shfl_xor_sync(0xffffffffu, sz1, off);
      }
      if (tc == 0) {
        wsx[tr] += sx0;
        wsx[tr + 16] += sx1;
        wsz[tr] += sz0;
        wsz[tr + 16] += sz1;
      }
      __syncthreads();
      const int ncols = min(TILE, B - j0);
      if (sg < X.nseg)
        apply_item(mx_, Wtx, slab_with(X, B, rank, it, jt, sg), X.ld, ncols,
                   accx);
      if (sg < Z.nseg)
        apply_item(mz_, Wtz, slab_with(Z, B, rank, it, jt, sg), Z.ld, ncols,
                   accz);
      __syncthreads();                   // slabs and Wt free for the next
    }
    if (sg < X.nseg)
      write_item(mx_, dx, X, slab_with(X, B, rank, it, it, sg), wsx, B, i0,
                 seg_col0(X, rank, sg), X.vec, accx);
    if (sg < Z.nseg)
      write_item(mz_, dz, Z, slab_with(Z, B, rank, it, it, sg), wsz, B, i0,
                 seg_col0(Z, rank, sg), Z.vec, accz);
    __syncthreads();
  }
  cluster_wait();                        // no rank reads this block's xch
}

constexpr int ROWSUM_BUFS = XCH + 4 * TILE;

// Sum of v over a warp; every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K1.  Grid (C, row tiles, cohorts), clusters of C = gridDim.x blocks along
// x, one per row tile of a cohort; block x is the cluster's rank.  s2 = [s2x, s2z].  For each
// column tile, rank r adds the ranks' partial dots of its 32 / C rows of
// the tile in rank order (the same bits as K2's and K3's entries), forms
// Kx and Kz, and adds each row's 32 entries (a warp a row) to a running
// sum over the column tiles; it writes rx and rz of its rows.
__global__ void __launch_bounds__(THREADS)
nhsic_rowsums_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     const float* __restrict__ s2, float* __restrict__ rx,
                     float* __restrict__ rz, int B, int Dx, int Dz, int lx,
                     int lz, int vx, int vz) {
  extern __shared__ float4 nhsic_smem4[];
  float* smem = reinterpret_cast<float*>(nhsic_smem4);
  const int C = gridDim.x, rank = blockIdx.x;
  const int it = blockIdx.y, nt = gridDim.y, i0 = it * TILE;
  const int t = threadIdx.x;
  const size_t coh = blockIdx.z;         // the cohort
  x += coh * B * Dx;
  z += coh * B * Dz;
  rx += coh * B;
  rz += coh * B;
  s2 += 2 * coh;
  Side X = make_side(x, Dx, C, lx, vx), Z = make_side(z, Dz, C, lz, vz);
  float* p = smem;
  X.row = p;
  p += TILE * X.ld;
  if (nt > 1) {
    X.col = p;
    p += TILE * X.ld;
  }
  Z.row = p;
  p += TILE * Z.ld;
  if (nt > 1) {
    Z.col = p;
    p += TILE * Z.ld;
  }
  float* xch = p;
  float* nrm = xch + XCH;                // the cluster's norms, as in XCH

  const float nix = -0.5f / s2[0], niz = -0.5f / s2[1];
  // this rank's entries of the tile: [rank per, (rank + 1) per), thread t
  // taking rank per + t + k THREADS (k < 4: per is 1024 / C, C >= 1)
  const int per = TILE * TILE / C;
  float sx[4] = {0.f, 0.f, 0.f, 0.f}, sz[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TILE;
    float ax[4], az[4], nx, nz;
    gram_pass(X, Z, B, rank, it, jt, ax, az, nx, nz);
    if (jt > 0) cluster_wait();          // no rank reads xch any more
    publish(xch, ax, az, nx, nz);
    cluster_arrive();
    cluster_wait();
    bool valid[4];
    float dxs[4], dzs[4], ns = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = rank * per + t + k * THREADS;
      valid[k] = t + k * THREADS < per && i0 + e / TILE < B
                 && j0 + e % TILE < B;
      dxs[k] = dzs[k] = 0.f;
    }
#pragma unroll 4
    for (int q = 0; q < C; ++q) {        // rank order, as K2 and K3
      const float* o = peer(xch, q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (valid[k]) {
          const int e = rank * per + t + k * THREADS;
          dxs[k] += o[e];
          dzs[k] += o[TILE * TILE + e];
        }
      if (t < 4 * TILE) ns += o[NORMS + t];
    }
    cluster_arrive();                    // this rank's reads are done
    if (t < 4 * TILE) nrm[t] = ns;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k * THREADS >= per) break;
      // a masked entry adds nothing (an RBF value of a zero dot is not 0)
      float kx = 0.f, kz = 0.f;
      if (valid[k]) {
        const int e = rank * per + t + k * THREADS, r = e / TILE,
                  c = e % TILE;
        kx = kernel_value(dxs[k], nrm[r], nrm[TILE + c], lx, nix);
        kz = kernel_value(dzs[k], nrm[2 * TILE + r], nrm[3 * TILE + c], lz,
                          niz);
      }
      sx[k] += warp_sum(kx);
      sz[k] += warp_sum(kz);
    }
  }
  cluster_wait();                        // no rank reads this block's xch
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + (rank * per + t + k * THREADS) / TILE;
    if (t % 32 == 0 && t + k * THREADS < per && i < B) {
      rx[i] = sx[k];
      rz[i] = sz[k];
    }
  }
}

// ---- K7, the centred statistics of two dense Grams (see the header) ----
__device__ __forceinline__ double* peer_d(double* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// Sums of v[0], v[1], v[2] over the block, the same order on every run;
// valid in thread 0.  red: 3 THREADS / 32 doubles.
__device__ void block_sum3(double (&v)[3], double* red) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = warp_sum(v[k]);
    if (threadIdx.x % 32 == 0) red[k * (THREADS / 32) + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = 0.0;
      for (int w = 0; w < THREADS / 32; ++w)
        v[k] += red[k * (THREADS / 32) + w];
    }
}

// Row stride of a band kept in shared memory: whole 16-byte groups.
__host__ __device__ constexpr int band_ld(int B) { return (B + 3) / 4 * 4; }

// Floats of K7's dynamic shared memory: the kept bands of both Grams (B <=
// MAX_CLUSTER TILE), then in doubles the partial column sums, the row sums
// of the owned rows, the rank's two totals, the ranks' three sums (in rank
// 0) and a block reduction's buffer, then in floats the two total means and
// a band's row means.
constexpr int gram_stats_floats(int B) {
  return (B <= MAX_CLUSTER * TILE ? 2 * TILE * band_ld(B) : 0)
         + 2 * (2 * B
                + 2 * TILE * ((B + MAX_CLUSTER * TILE - 1)
                              / (MAX_CLUSTER * TILE))
                + 2 + 3 * MAX_CLUSTER + 3 * THREADS / 32)
         + 2 + 2 * TILE;
}

// sum over q < C of p's element i in rank q, added in rank order; the C
// loads are issued together
__device__ __forceinline__ double rank_sum(double* p, int i, int C) {
  double v[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < C) v[q] = peer_d(p, q)[i];
  double s = 0.0;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < C) s += v[q];
  return s;
}

// K7.  One cluster of C = gridDim.x blocks; rank r owns the 32-row bands
// r, r + C, ... of kx and kz (B, B).  Writes out = [sum Kxc Kzc,
// sum Kxc^2, sum Kzc^2] with Kc_ij = K_ij - c_j - r_i + m (c the column
// means, r the row means, m the mean).  `vec`: B % 4 == 0 and both Grams
// 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
gram_stats_kernel(const float* __restrict__ kx, const float* __restrict__ kz,
                  float* __restrict__ out, int B, int vec) {
  extern __shared__ float4 nhsic_smem4[];
  float* smem = reinterpret_cast<float*>(nhsic_smem4);
  const int C = gridDim.x, rank = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int nb = (B + TILE - 1) / TILE;
  const int mine = (nb - rank + C - 1) / C;        // bands of this rank
  const int per = (nb + C - 1) / C;                // bands of rank 0, the most
  const bool keep = nb <= C;                       // one band a rank
  const int ld = band_ld(B);
  float* cache = smem;                             // [2][TILE][ld] if keep
  double* colx = reinterpret_cast<double*>(smem + (keep ? 2 * TILE * ld : 0));
  double* colz = colx + B;                         // partial column sums
  double* rowx = colz + B;                         // [per][TILE] row sums
  double* rowz = rowx + per * TILE;
  double* tot = rowz + per * TILE;                 // this rank's row sums
  double* P = tot + 2;                             // [rank][3], in rank 0
  double* red = P + 3 * MAX_CLUSTER;
  float* mean = reinterpret_cast<float*>(red + 3 * THREADS / 32);
  float* rmx = mean + 2;                           // a band's row means
  float* rmz = rmx + TILE;

  // the rows of band k of this rank: from shared memory where kept
  auto band = [&](int k, const float*& bx, const float*& bz, int& bld) {
    const int row0 = (rank + k * C) * TILE;
    if (keep) {
      bx = cache;
      bz = cache + TILE * ld;
      bld = ld;
    } else {
      bx = kx + (size_t)row0 * B;
      bz = kz + (size_t)row0 * B;
      bld = B;
    }
    return min(TILE, B - row0);
  };

  if (keep) {
    load_slab(cache, ld, kx, B, B, rank * TILE, 0, B, vec);
    load_slab(cache + TILE * ld, ld, kz, B, B, rank * TILE, 0, B, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // pass 1: row sums (a warp a row: rows warp + 8 h, h < 4) and partial
  // column sums (a thread a column, rows in order, bands in order)
  constexpr int RPW = TILE / (THREADS / 32);       // rows of a warp
  for (int k = 0; k < mine; ++k) {
    const float *bx, *bz;
    int bld;
    const int nrows = band(k, bx, bz, bld);
    double sx[RPW], sz[RPW];
#pragma unroll
    for (int h = 0; h < RPW; ++h) sx[h] = sz[h] = 0.0;
    for (int j = lane; j < B; j += 32)
#pragma unroll
      for (int h = 0; h < RPW; ++h) {
        const int r = warp + h * (THREADS / 32);
        if (r < nrows) {
          sx[h] += bx[(size_t)r * bld + j];
          sz[h] += bz[(size_t)r * bld + j];
        }
      }
#pragma unroll
    for (int h = 0; h < RPW; ++h) {
      const int r = warp + h * (THREADS / 32);
      sx[h] = warp_sum(sx[h]);
      sz[h] = warp_sum(sz[h]);
      if (lane == 0 && r < nrows) {
        rowx[k * TILE + r] = sx[h];
        rowz[k * TILE + r] = sz[h];
      }
    }
    for (int j = t; j < B; j += THREADS) {
      double cx = k ? colx[j] : 0.0, cz = k ? colz[j] : 0.0;
      for (int r = 0; r < nrows; ++r) {
        cx += bx[(size_t)r * bld + j];
        cz += bz[(size_t)r * bld + j];
      }
      colx[j] = cx;
      colz[j] = cz;
    }
  }
  __syncthreads();
  // this rank's totals: its row sums (warp 0: kx, warp 1: kz)
  if (warp < 2) {
    const double* rows = warp ? rowz : rowx;
    double s = 0.0;
    for (int k = 0; k < mine; ++k)
      if ((rank + k * C) * TILE + lane < B) s += rows[k * TILE + lane];
    s = warp_sum(s);
    if (lane == 0) tot[warp] = s;
  }
  cluster_arrive();
  cluster_wait();
  // the total means: the ranks' totals in rank order, the same bits in
  // every rank
  if (t < 2) mean[t] = (float)(rank_sum(tot, t, C) / ((double)B * B));
  __syncthreads();
  const float mx = mean[0], mz = mean[1];
  // pass 2: the centred entries in f32, their products summed in double
  double ps[3] = {0.0, 0.0, 0.0};
  for (int k = 0; k < mine; ++k) {
    const float *bx, *bz;
    int bld;
    const int nrows = band(k, bx, bz, bld);
    if (t < nrows) {
      rmx[t] = (float)(rowx[k * TILE + t] / B);
      rmz[t] = (float)(rowz[k * TILE + t] / B);
    }
    __syncthreads();
    for (int j = t; j < B; j += THREADS) {
      const float cmx = (float)(rank_sum(colx, j, C) / B);
      const float cmz = (float)(rank_sum(colz, j, C) / B);
      for (int r = 0; r < nrows; ++r) {
        const float kxc = bx[(size_t)r * bld + j] - cmx - rmx[r] + mx;
        const float kzc = bz[(size_t)r * bld + j] - cmz - rmz[r] + mz;
        ps[0] += (double)kxc * kzc;
        ps[1] += (double)kxc * kxc;
        ps[2] += (double)kzc * kzc;
      }
    }
    __syncthreads();                     // rmx, rmz free for the next band
  }
  block_sum3(ps, red);
  if (t == 0) {
    double* P0 = peer_d(P, 0);
    P0[3 * rank + 0] = ps[0];
    P0[3 * rank + 1] = ps[1];
    P0[3 * rank + 2] = ps[2];
  }
  cluster_arrive();                      // every rank's reads and P done
  cluster_wait();
  if (rank == 0 && t < 3) {
    double v = 0.0;
    for (int q = 0; q < C; ++q) v += P[3 * q + t];
    out[t] = (float)v;
  }
}

// Cluster size of a K1, K2 or K3 call: about 64 columns of the wider side a
// rank, 4 to 16 ranks.  Timed against fixed sizes 1 to 16 at the training
// paths' shapes by benchmarks/nhsic_cluster.py (see PERF.md): more
// ranks cost cluster-barrier and DSMEM time, fewer leave each rank more
// columns to load and multiply in turn.
int cluster_size(int Dx, int Dz) {
  const int cols = (Dx > Dz ? Dx : Dz) / 64;
  int c = 4;
  while (c < cols && c < MAX_CLUSTER) c *= 2;
  return c;
}

// Sets a cluster kernel's attributes once: the dynamic shared memory it
// may take and clusters of 16 (above the portable 8).
template <typename Kernel>
int allow_clusters(Kernel kernel, bool& done, int smem_max) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int smem_bytes,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the most shared memory K1, K2 or K3 takes: two slabs of SEG columns a
// side
constexpr int SLABS_MAX = 4 * TILE * ld_of(SEG);
// the most dynamic shared memory a block may take (227 KB)
constexpr int SMEM_OPTIN = 227 * 1024;

int tiles(int B) { return (B + TILE - 1) / TILE; }

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers to
// contiguous float32; `stream` is a cudaStream_t.  Each entry returns
// cudaGetLastError() after its launches (0 = launched).
//
// K1, K2 and K3 take `cohorts` independent problems of the same (B, Dx, Dz)
// in one launch, as jax.vmap of a pallas_call adds a grid axis: every
// array is stacked on a leading cohort axis (x (cohorts, B, Dx), s2
// (cohorts, 2), s (cohorts, 4), scal (cohorts, 7), rx (cohorts, B), out
// (cohorts, 3)), so cohort c's arrays start c times one cohort's elements
// in.  Each cohort's blocks run the code of a one-cohort launch on offset
// pointers: its results are the same bits.  The cohort is grid axis z (K2:
// folded into z with the row tiles); the cluster stays along x.

extern "C" int nhsic_rowsums(const void* x, const void* z, const void* s2,
                             void* rx, void* rz, int B, int Dx, int Dz, int lx,
                             int lz, int cohorts, void* stream) {
  static bool ready = false;
  int err = allow_clusters(nhsic_rowsums_kernel, ready,
                           (int)sizeof(float) * (SLABS_MAX + ROWSUM_BUFS));
  if (err != 0) return err;
  const int nb = tiles(B), C = cluster_size(Dx, Dz);
  const int smem = (int)sizeof(float) * (slab_floats(Dx, C, nb > 1)
                                         + slab_floats(Dz, C, nb > 1)
                                         + ROWSUM_BUFS);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C, nb, cohorts), smem, (cudaStream_t)stream, &attr);
  err = (int)cudaLaunchKernelEx(
      &cfg, nhsic_rowsums_kernel, (const float*)x, (const float*)z,
      (const float*)s2, (float*)rx, (float*)rz, B, Dx, Dz, lx, lz,
      (int)(Dx % 4 == 0 && aligned16(x)), (int)(Dz % 4 == 0 && aligned16(z)));
  const int last = (int)cudaGetLastError();
  return err != 0 ? err : last;
}

// `partial` is scratch of 3 * tiles(B)^2 floats a cohort (written where
// tiles(B) > 1, then added by a second launch, one block a cohort); `out`
// receives 3 floats a cohort.
extern "C" int nhsic_stats_feats(const void* x, const void* z, const void* rx,
                                 const void* rz, const void* s, void* partial,
                                 void* out, int B, int Dx, int Dz, int lx,
                                 int lz, int cohorts, void* stream) {
  static bool ready = false;
  int err = allow_clusters(nhsic_stats_kernel, ready,
                           (int)sizeof(float) * (SLABS_MAX + STATS_BUFS));
  if (err != 0) return err;
  const int nb = tiles(B), C = cluster_size(Dx, Dz);
  const int smem = (int)sizeof(float) * (slab_floats(Dx, C, nb > 1)
                                         + slab_floats(Dz, C, nb > 1)
                                         + STATS_BUFS);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C, nb, nb * cohorts), smem, (cudaStream_t)stream, &attr);
  err = (int)cudaLaunchKernelEx(
      &cfg, nhsic_stats_kernel, (const float*)x, (const float*)z,
      (const float*)rx, (const float*)rz, (const float*)s, (float*)partial,
      (float*)out, B, Dx, Dz, lx, lz, (int)(Dx % 4 == 0 && aligned16(x)),
      (int)(Dz % 4 == 0 && aligned16(z)));
  const int last = (int)cudaGetLastError();   // also clears a launch error
  if (err == 0) err = last;
  if (err != 0 || nb == 1) return err;
  sum_partials_kernel<<<cohorts, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nb * nb, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int nhsic_grad(const void* x, const void* z, const void* rx,
                          const void* rz, const void* scal, void* dx, void* dz,
                          int B, int Dx, int Dz, int lx, int lz, int cohorts,
                          void* stream) {
  static bool ready = false;
  int err = allow_clusters(nhsic_grad_kernel, ready,
                           (int)sizeof(float) * (SLABS_MAX + GRAD_BUFS));
  if (err != 0) return err;
  const int nb = tiles(B), C = cluster_size(Dx, Dz);
  const int smem = (int)sizeof(float) * (slab_floats(Dx, C, nb > 1)
                                         + slab_floats(Dz, C, nb > 1)
                                         + GRAD_BUFS);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C, nb, cohorts), smem, (cudaStream_t)stream, &attr);
  err = (int)cudaLaunchKernelEx(
      &cfg, nhsic_grad_kernel, (const float*)x, (const float*)z,
      (const float*)rx, (const float*)rz, (const float*)scal, (float*)dx,
      (float*)dz, B, Dx, Dz, lx, lz,
      (int)(Dx % 4 == 0 && aligned16(x) && aligned16(dx)),
      (int)(Dz % 4 == 0 && aligned16(z) && aligned16(dz)));
  const int last = (int)cudaGetLastError();
  return err != 0 ? err : last;
}

extern "C" int gram(const void* x, const void* s2, void* out, int B, int D,
                    int linear, void* stream) {
  static bool granted = false;           // dynamic shared memory opted into
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)GRAM_SMEM);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const int nb = tiles(B);
  const int vec = D % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  gram_kernel<<<nb * (nb + 1) / 2, THREADS, GRAM_SMEM,
                (cudaStream_t)stream>>>((const float*)x, (const float*)s2,
                                        (float*)out, B, D, linear, vec);
  return (int)cudaGetLastError();
}

// `out` receives 3 floats.  A B whose column sums do not fit in one
// block's shared memory (B > 13,619) returns cudaErrorInvalidValue.
extern "C" int gram_stats(const void* kx, const void* kz, void* out, int B,
                          void* stream) {
  static bool ready = false;
  int err = allow_clusters(gram_stats_kernel, ready, SMEM_OPTIN);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * (size_t)gram_stats_floats(B);
  if (smem > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  const int nb = tiles(B), C = nb < MAX_CLUSTER ? nb : MAX_CLUSTER;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C), (int)smem, (cudaStream_t)stream, &attr);
  err = (int)cudaLaunchKernelEx(
      &cfg, gram_stats_kernel, (const float*)kx, (const float*)kz,
      (float*)out, B, (int)(B % 4 == 0 && aligned16(kx) && aligned16(kz)));
  const int last = (int)cudaGetLastError();
  return err != 0 ? err : last;
}
