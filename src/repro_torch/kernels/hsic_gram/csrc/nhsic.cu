// Streaming nHSIC kernels for Hopper (sm_90a): the Curriculum Mentor's
// nHSIC(A; B) = tr(K~a K~b) / (|K~a|_F |K~b|_F) and its gradient, with every
// Gram tile recomputed from the (B, D) activations so that no (B, B) matrix
// is ever written to device memory, forward or backward.
//
// Which TPU kernel each entry point replaces (src/repro/kernels/hsic_gram/):
//   nhsic_rowsums      <- kernel.py:nhsic_rowsums_pallas     (_rowsums_kernel)
//   nhsic_stats_feats  <- kernel.py:nhsic_stats_feats_pallas (_stats_feats_kernel)
//   nhsic_grad         <- kernel.py:nhsic_grad_pallas        (_grad_kernel)
//
// What bounds them on the H100: at the training batch (B = 32) each call
// reads at most (32 x 768) floats and does about 1 MFLOP, which the card
// moves and computes in well under a microsecond, so launch latency bounds
// every call.  The design answers that with one launch per call for the
// row sums and the gradient (two for the statistics, see below) and no
// host synchronisation: scalars such as sigma^2 and the Gram means are read
// from device memory by the kernel.  At large B the Gram arithmetic
// (2 B^2 D FLOPs per matrix) dominates; it runs in fp32 on CUDA cores.
// Tensor cores (TF32) are avoided on purpose: a Gram tile is computed as
// |a|^2 + |b|^2 - 2 a.b, clamped at 0, which cancels badly at a 10-bit
// mantissa.  Making the large-B case fast is left to later work.
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
//     the kernel: a masked entry adds nothing to any sum.  (A zero pad row
//     would add exp(0) = 1 to an RBF Gram, which is why the TPU version
//     never pads.)
//   * Row norms are accumulated with the same fma sequence as the dot
//     products, so a diagonal distance is exactly 0.
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
