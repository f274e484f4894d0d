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
// reads at most (32 x 768) floats and does about 1 MFLOP, which the card
// moves and computes in well under a microsecond, so launch latency bounds
// every call.  The design answers that with one launch per call for the
// row sums, the gradient and the dense Gram (two for each statistics
// kernel, see below) and no host synchronisation: scalars such as sigma^2
// and the Gram means are read from device memory by the kernel.  At large
// B the Gram arithmetic (2 B^2 D FLOPs per matrix) dominates; it runs in
// fp32 on CUDA cores.  The dense-Gram statistics read two (B, B) Grams
// once, so bytes bound them.
// Tensor cores (TF32) are avoided on purpose: a Gram tile is computed as
// |a|^2 + |b|^2 - 2 a.b, clamped at 0, which cancels badly at a 10-bit
// mantissa, and an MMA's internal order of summation would make the
// distance of two identical rows depend on where they sit (see K6 below).
//
// Design, per kernel:
//   * A thread block owns a 32-row tile and loops over the 32-column tiles
//     itself (the TPU grid ran that axis in order), so row sums and gradient
//     rows need no reduction across blocks.
//   * Statistics need a reduction over all (i, j) tiles.  Each block writes
//     its three partial sums to a scratch buffer and a second launch adds
//     them in a fixed order: results are the same from run to run (no
//     atomics), as resumed training runs require.
//   * B and D are arbitrary.  Rows and columns outside [0, B) are masked in
//     the kernel: a masked entry adds nothing to any sum and is never
//     written.  (A zero pad row would add exp(0) = 1 to an RBF Gram, which
//     is why the TPU version never pads the streaming kernels.)
//   * Row norms are accumulated with the same fma sequence as the dot
//     products, so a diagonal distance is exactly 0.
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
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 32;                  // rows and columns of one Gram tile
                                          // (kernel.py sizes `partial` by it)
constexpr int KC = 32;                    // activation columns per smem chunk
constexpr int THREADS = 256;              // 8 warps
constexpr int PER_THREAD = TILE * TILE / THREADS;   // tile entries per thread
constexpr int ROW_STEP = THREADS / TILE;  // rows between a thread's entries

struct TileSmem {
  float a[TILE][KC + 1];                  // row tile chunk
  float b[TILE][KC + 1];                  // column tile chunk
  float na[TILE];                         // squared norms of the row tile
  float nb[TILE];                         // squared norms of the column tile
};

// Thread tid owns tile entries (tid / TILE + q * ROW_STEP, tid % TILE).
__device__ __forceinline__ int entry_row(int q) {
  return threadIdx.x / TILE + q * ROW_STEP;
}

// K[r][c] = k(a[i0 + r], a[j0 + c]) for the (TILE, TILE) tile at (i0, j0) of
// the Gram of a (B, D), row-major.  RBF: exp(-max(|a|^2 + |b|^2 - 2 a.b, 0)
// / (2 s2)); linear: a.b.  Entries outside [0, B)^2 are set to 0.  Ends with
// a barrier, so the caller may read `out` at once.
__device__ void gram_tile(const float* __restrict__ a, int B, int D, int i0,
                          int j0, bool linear, float s2, TileSmem& sm,
                          float (*out)[TILE + 1]) {
  const int tid = threadIdx.x;
  const int c = tid % TILE;
  float acc[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) acc[q] = 0.f;
  float nrm = 0.f;  // tid < TILE: row tile norm; tid < 2 TILE: column tile
  for (int k0 = 0; k0 < D; k0 += KC) {
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC, k = k0 + kk;
      const int ia = i0 + r, ib = j0 + r;
      sm.a[r][kk] = (ia < B && k < D) ? a[(size_t)ia * D + k] : 0.f;
      sm.b[r][kk] = (ib < B && k < D) ? a[(size_t)ib * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float bv = sm.b[c][kk];
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q)
        acc[q] = fmaf(sm.a[entry_row(q)][kk], bv, acc[q]);
      if (tid < TILE) {
        nrm = fmaf(sm.a[tid][kk], sm.a[tid][kk], nrm);
      } else if (tid < 2 * TILE) {
        nrm = fmaf(sm.b[tid - TILE][kk], sm.b[tid - TILE][kk], nrm);
      }
    }
    __syncthreads();
  }
  if (tid < TILE) {
    sm.na[tid] = nrm;
  } else if (tid < 2 * TILE) {
    sm.nb[tid - TILE] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = entry_row(q);
    float v = acc[q];
    if (!linear) {
      const float d2 = fmaxf(sm.na[r] + sm.nb[c] - 2.f * acc[q], 0.f);
      v = expf(-d2 / (2.f * s2));
    }
    out[r][c] = (i0 + r < B && j0 + c < B) ? v : 0.f;
  }
  __syncthreads();
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

// Grid (row tiles, 2): blockIdx.y = 0 sums rows of Kx, 1 rows of Kz.
__global__ void __launch_bounds__(THREADS)
rowsums_kernel(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ s2, float* __restrict__ rx,
               float* __restrict__ rz, int B, int Dx, int Dz, int lx, int lz) {
  __shared__ TileSmem sm;
  __shared__ float K[TILE][TILE + 1];
  const bool is_z = blockIdx.y == 1;
  const float* a = is_z ? z : x;
  const int D = is_z ? Dz : Dx;
  const bool linear = is_z ? lz : lx;
  const float s = s2[is_z ? 1 : 0];
  float* out = is_z ? rz : rx;
  const int i0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  float rsum = 0.f;
  for (int j0 = 0; j0 < B; j0 += TILE) {
    gram_tile(a, B, D, i0, j0, linear, s, sm, K);
    if (tid < TILE)
      for (int c = 0; c < TILE; ++c) rsum += K[tid][c];   // masked: 0
    __syncthreads();
  }
  if (tid < TILE && i0 + tid < B) out[i0 + tid] = rsum;
}

// Grid (column tiles, row tiles).  s = [s2x, s2z, mean Kx, mean Kz]; rx, rz
// are the Gram row means.  Writes this tile's (sum Kxc Kzc, sum Kxc^2,
// sum Kzc^2) to partial[3 * block].
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ x, const float* __restrict__ z,
             const float* __restrict__ rx, const float* __restrict__ rz,
             const float* __restrict__ s, float* __restrict__ partial, int B,
             int Dx, int Dz, int lx, int lz) {
  __shared__ TileSmem sm;
  __shared__ float Kx[TILE][TILE + 1];
  __shared__ float Kz[TILE][TILE + 1];
  __shared__ float red[THREADS / 32];
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  gram_tile(x, B, Dx, i0, j0, lx, s[0], sm, Kx);
  gram_tile(z, B, Dz, i0, j0, lz, s[1], sm, Kz);
  const float mx = s[2], mz = s[3];
  const int c = threadIdx.x % TILE, j = j0 + c;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = entry_row(q), i = i0 + r;
    if (i < B && j < B) {
      const float kxc = Kx[r][c] - rx[i] - rx[j] + mx;
      const float kzc = Kz[r][c] - rz[i] - rz[j] + mz;
      p0 = fmaf(kxc, kzc, p0);
      p1 = fmaf(kxc, kxc, p1);
      p2 = fmaf(kzc, kzc, p2);
    }
  }
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  p0 = block_sum(p0, red);
  p1 = block_sum(p1, red);
  p2 = block_sum(p2, red);
  if (threadIdx.x == 0) {
    partial[3 * blk + 0] = p0;
    partial[3 * blk + 1] = p1;
    partial[3 * blk + 2] = p2;
  }
}

// One block: out[k] = sum over blocks of partial[3 * blk + k], fixed order.
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, int nblocks,
                    float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
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

// Grid (column tiles, row tiles).  Centres the (TILE, TILE) tile at
// (blockIdx.y, blockIdx.x) of the Grams kx and kz (B, B) as K_ij - r_i -
// c_j + m, with r the row means, c the column means and m = [mean kx,
// mean kz], and writes the tile's (sum Kxc Kzc, sum Kxc^2, sum Kzc^2) to
// partial[3 * block].
__global__ void __launch_bounds__(THREADS)
gram_stats_kernel(const float* __restrict__ kx, const float* __restrict__ kz,
                  const float* __restrict__ rx, const float* __restrict__ cx,
                  const float* __restrict__ rz, const float* __restrict__ cz,
                  const float* __restrict__ m, float* __restrict__ partial,
                  int B) {
  __shared__ float red[THREADS / 32];
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int j = j0 + threadIdx.x % TILE;
  const float mx = m[0], mz = m[1];
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = i0 + entry_row(q);
    if (i < B && j < B) {
      const size_t e = (size_t)i * B + j;
      const float kxc = kx[e] - rx[i] - cx[j] + mx;
      const float kzc = kz[e] - rz[i] - cz[j] + mz;
      p0 = fmaf(kxc, kzc, p0);
      p1 = fmaf(kxc, kxc, p1);
      p2 = fmaf(kzc, kzc, p2);
    }
  }
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  p0 = block_sum(p0, red);
  p1 = block_sum(p1, red);
  p2 = block_sum(p2, red);
  if (threadIdx.x == 0) {
    partial[3 * blk + 0] = p0;
    partial[3 * blk + 1] = p1;
    partial[3 * blk + 2] = p2;
  }
}

// Adds W . a[j0:j0+TILE] * scale to the rows of g this block owns.
__device__ void accumulate_rows(const float (*W)[TILE + 1],
                                const float* __restrict__ a,
                                float* __restrict__ g, int B, int D, int i0,
                                int j0, float scale) {
  const int ncols = min(TILE, B - j0);
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e % D, i = i0 + r;
    if (i >= B) break;                       // e only grows from here
    float acc = 0.f;
    for (int c = 0; c < ncols; ++c)
      acc = fmaf(W[r][c], a[(size_t)(j0 + c) * D + d], acc);
    g[(size_t)i * D + d] += scale * acc;
  }
}

// Grid (row tiles).  scal = [s2x, s2z, mean Kx, mean Kz, cA, cBx, cBz].
// With Kc the centred Grams, G_x = cA Kzc - cBx Kxc and G_z = cA Kxc - cBz
// Kzc.  RBF: W = G o K (-1 / 2 s2), dx_i = 4 (rowsum(W)_i x_i - (W x)_i);
// linear: dx = 2 G x.  Each block owns its rows of dx and dz.
__global__ void __launch_bounds__(THREADS)
grad_kernel(const float* __restrict__ x, const float* __restrict__ z,
            const float* __restrict__ rx, const float* __restrict__ rz,
            const float* __restrict__ scal, float* __restrict__ dx,
            float* __restrict__ dz, int B, int Dx, int Dz, int lx, int lz) {
  __shared__ TileSmem sm;
  __shared__ float Wx[TILE][TILE + 1];
  __shared__ float Wz[TILE][TILE + 1];
  __shared__ float wsx[TILE];
  __shared__ float wsz[TILE];
  const float s2x = scal[0], s2z = scal[1], mx = scal[2], mz = scal[3];
  const float ca = scal[4], cbx = scal[5], cbz = scal[6];
  const int i0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, c = tid % TILE;
  if (tid < TILE) {
    wsx[tid] = 0.f;
    wsz[tid] = 0.f;
  }
  for (int e = tid; e < TILE * Dx && i0 + e / Dx < B; e += THREADS)
    dx[(size_t)i0 * Dx + e] = 0.f;
  for (int e = tid; e < TILE * Dz && i0 + e / Dz < B; e += THREADS)
    dz[(size_t)i0 * Dz + e] = 0.f;
  for (int j0 = 0; j0 < B; j0 += TILE) {
    gram_tile(x, B, Dx, i0, j0, lx, s2x, sm, Wx);   // Wx holds Kx for now
    gram_tile(z, B, Dz, i0, j0, lz, s2z, sm, Wz);   // Wz holds Kz for now
    float wx[PER_THREAD], wz[PER_THREAD];
    const int j = j0 + c;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int r = entry_row(q), i = i0 + r;
      wx[q] = 0.f;
      wz[q] = 0.f;
      if (i < B && j < B) {
        const float kx = Wx[r][c], kz = Wz[r][c];
        const float kxc = kx - rx[i] - rx[j] + mx;
        const float kzc = kz - rz[i] - rz[j] + mz;
        const float gx = ca * kzc - cbx * kxc;
        const float gz = ca * kxc - cbz * kzc;
        wx[q] = lx ? gx : gx * kx * (-1.f / (2.f * s2x));
        wz[q] = lz ? gz : gz * kz * (-1.f / (2.f * s2z));
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      Wx[entry_row(q)][c] = wx[q];
      Wz[entry_row(q)][c] = wz[q];
    }
    __syncthreads();
    if (tid < TILE) {
      float sr = 0.f;
      for (int cc = 0; cc < TILE; ++cc) sr += Wx[tid][cc];
      wsx[tid] += sr;
    } else if (tid < 2 * TILE) {
      float sr = 0.f;
      for (int cc = 0; cc < TILE; ++cc) sr += Wz[tid - TILE][cc];
      wsz[tid - TILE] += sr;
    }
    accumulate_rows(Wx, x, dx, B, Dx, i0, j0, lx ? 2.f : -4.f);
    accumulate_rows(Wz, z, dz, B, Dz, i0, j0, lz ? 2.f : -4.f);
    __syncthreads();
  }
  // RBF: the rowsum(W) x_i half of the chain rule, once over all columns
  if (!lx)
    for (int e = tid; e < TILE * Dx && i0 + e / Dx < B; e += THREADS)
      dx[(size_t)i0 * Dx + e] += 4.f * wsx[e / Dx] * x[(size_t)i0 * Dx + e];
  if (!lz)
    for (int e = tid; e < TILE * Dz && i0 + e / Dz < B; e += THREADS)
      dz[(size_t)i0 * Dz + e] += 4.f * wsz[e / Dz] * z[(size_t)i0 * Dz + e];
}

int tiles(int B) { return (B + TILE - 1) / TILE; }

}  // namespace

// C interface, bound with ctypes.  Pointers are device pointers to
// contiguous float32; `stream` is a cudaStream_t.  Each entry returns
// cudaGetLastError() after its launches (0 = launched).

extern "C" int nhsic_rowsums(const void* x, const void* z, const void* s2,
                             void* rx, void* rz, int B, int Dx, int Dz, int lx,
                             int lz, void* stream) {
  rowsums_kernel<<<dim3(tiles(B), 2), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)s2, (float*)rx,
      (float*)rz, B, Dx, Dz, lx, lz);
  return (int)cudaGetLastError();
}

// `partial` is scratch of 3 * tiles(B)^2 floats; `out` receives 3 floats.
extern "C" int nhsic_stats_feats(const void* x, const void* z, const void* rx,
                                 const void* rz, const void* s, void* partial,
                                 void* out, int B, int Dx, int Dz, int lx,
                                 int lz, void* stream) {
  const int nb = tiles(B);
  stats_kernel<<<dim3(nb, nb), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)rx, (const float*)rz,
      (const float*)s, (float*)partial, B, Dx, Dz, lx, lz);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nb * nb, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int nhsic_grad(const void* x, const void* z, const void* rx,
                          const void* rz, const void* scal, void* dx, void* dz,
                          int B, int Dx, int Dz, int lx, int lz, void* stream) {
  grad_kernel<<<tiles(B), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)rx, (const float*)rz,
      (const float*)scal, (float*)dx, (float*)dz, B, Dx, Dz, lx, lz);
  return (int)cudaGetLastError();
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

// rx, cx, rz, cz: the (B,) row and column means of kx and kz; m: [mean kx,
// mean kz].  `partial` is scratch of 3 * tiles(B)^2 floats; `out` receives
// 3 floats.
extern "C" int gram_stats(const void* kx, const void* kz, const void* rx,
                          const void* cx, const void* rz, const void* cz,
                          const void* m, void* partial, void* out, int B,
                          void* stream) {
  const int nb = tiles(B);
  gram_stats_kernel<<<dim3(nb, nb), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kx, (const float*)kz, (const float*)rx, (const float*)cx,
      (const float*)rz, (const float*)cz, (const float*)m, (float*)partial,
      B);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nb * nb, (float*)out);
  return (int)cudaGetLastError();
}
