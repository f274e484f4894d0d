// sLSTM time scan for Hopper (sm_90a): the stabilised sLSTM recurrence of
// xLSTM over a whole sequence, per (batch row, head), in one launch.
//
// Replaces the TPU kernel src/repro/kernels/slstm_scan/kernel.py:
// slstm_scan_pallas (body _slstm_kernel).  Per step t, for each of the
// four gates g (i, f, z, o) and each column j of the head:
//   g[g][j] = (g_in[t][g][j] + sum_e h[e] * r[g][e][j]) + b[g][j]
//   logf    = log sigmoid(g_f) = min(g_f, 0) - log1p(exp(-|g_f|))
//   m'      = max(logf + m, g_i)
//   i'      = exp(g_i - m');  f' = exp(logf + m - m')
//   c'      = f' c + i' tanh(g_z);  n' = f' n + i'
//   h'      = sigmoid(g_o) c' / max(n', 1e-6)
// It writes h' of every step to hs and the last step's (c, n, m, h) to the
// four final-state outputs.  Unlike the Pallas kernel it runs exactly S
// steps: there is no padding of the sequence, so no gate-neutral pad and no
// fix-up of the final h.
//
// What bounds it on the H100: at the xlstm-1.3b shape of the main path
// (B = 16, S = 256, H = 4, Dh = 512) one call moves 185.6 MB (g_in, r, b,
// the initial states read once; hs and the final states written once),
// 0.055 ms at 3.35 TB/s, and does 3.44e10 FLOP (the four recurrent
// products, 2 B S H 4 Dh^2), 0.513 ms at 67 TFLOP/s on CUDA cores:
// operations bound it.  The TPU kernel kept r, (4, Dh, Dh) per head, in
// VMEM: 4 MiB in f32 at Dh = 512, where one SM has 227 KB of shared memory.
// This first version is simple and right rather than fast: r stays in
// device memory and is read each step (the 16 MiB of all heads stay
// resident in the 50 MB L2), so each block streams 4 MiB per step.
//
// Design: one block per (batch row, head), looping over all S steps.
// Thread t owns columns j = t + k * blockDim.x (k < MAX_COLS) of all four
// gates and keeps c, n and m of its columns in registers.  h lives in shared
// memory, double-buffered: step t reads one buffer and writes the other, so
// one __syncthreads per step suffices.  Reads of r[g][e][j] are coalesced
// over j.  fp32 FMA on CUDA cores, no TF32; expf/log1pf/tanhf without fast
// math, for parity with the plain version.
//
// Layout, all contiguous float32: g_in (B, S, 4, H, Dh), r (4, H, Dh, Dh),
// b (4, H, Dh), c0/n0/m0/h0 and the final states (B, H, Dh),
// hs (B, S, H, Dh).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_COLS = 2;                         // columns per thread
constexpr int MAX_DH = MAX_THREADS * MAX_COLS;      // 1024 (wrapper checks)

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(MAX_THREADS)
slstm_scan_kernel(const float* __restrict__ g_in, const float* __restrict__ r,
                  const float* __restrict__ bias, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ cf, float* __restrict__ nf,
                  float* __restrict__ mf, float* __restrict__ hf, int S,
                  int H, int Dh) {
  extern __shared__ float h_s[];                    // (2, Dh)
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t state = (static_cast<size_t>(row) * H + head) * Dh;
  const size_t gate_stride = static_cast<size_t>(H) * Dh;  // between gates
  const size_t r_gate = static_cast<size_t>(H) * Dh * Dh;
  const float* r_h = r + static_cast<size_t>(head) * Dh * Dh;

  float c[MAX_COLS], n[MAX_COLS], m[MAX_COLS], bg[MAX_COLS][4];
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    const int j = tid + k * nt;
    c[k] = n[k] = m[k] = 0.0f;
    if (j < Dh) {
      c[k] = c0[state + j];
      n[k] = n0[state + j];
      m[k] = m0[state + j];
      h_s[j] = h0[state + j];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        bg[k][g] = bias[g * gate_stride + head * Dh + j];
      }
    }
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < S; ++t) {
    const float* h_prev = h_s + cur * Dh;
    float* h_next = h_s + (cur ^ 1) * Dh;
    const float* g_t = g_in + ((static_cast<size_t>(row) * S + t) * 4 * H
                               + head) * Dh;
    float* hs_t = hs + ((static_cast<size_t>(row) * S + t) * H + head) * Dh;
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      const int j = tid + k * nt;
      if (j >= Dh) continue;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* rj = r_h + j;
#pragma unroll 4
      for (int e = 0; e < Dh; ++e) {
        const float he = h_prev[e];
        const size_t off = static_cast<size_t>(e) * Dh;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g] = fmaf(he, rj[g * r_gate + off], acc[g]);
        }
      }
      float gv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        gv[g] = (g_t[g * gate_stride + j] + acc[g]) + bg[k][g];
      }
      const float logf_ = log_sigmoid(gv[1]);
      const float m_new = fmaxf(logf_ + m[k], gv[0]);
      const float i_s = expf(gv[0] - m_new);
      const float f_s = expf(logf_ + m[k] - m_new);
      c[k] = f_s * c[k] + i_s * tanhf(gv[2]);
      n[k] = f_s * n[k] + i_s;
      m[k] = m_new;
      const float h = sigmoid(gv[3]) * c[k] / fmaxf(n[k], 1e-6f);
      h_next[j] = h;
      hs_t[j] = h;
    }
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    const int j = tid + k * nt;
    if (j >= Dh) continue;
    cf[state + j] = c[k];
    nf[state + j] = n[k];
    mf[state + j] = m[k];
    hf[state + j] = h_s[cur * Dh + j];
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).
int slstm_scan_fwd(const float* g_in, const float* r, const float* b,
                   const float* c0, const float* n0, const float* m0,
                   const float* h0, float* hs, float* cf, float* nf,
                   float* mf, float* hf, int B, int S, int H, int Dh,
                   cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 1 || Dh > MAX_DH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = (Dh + MAX_THREADS - 1) / MAX_THREADS;
  int threads = (Dh + cols - 1) / cols;
  threads = (threads + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(Dh) * sizeof(float);
  dim3 grid(H, B);
  slstm_scan_kernel<<<grid, threads, smem, stream>>>(
      g_in, r, b, c0, n0, m0, h0, hs, cf, nf, mf, hf, S, H, Dh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
