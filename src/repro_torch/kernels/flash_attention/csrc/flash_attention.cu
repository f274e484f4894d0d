// Flash-attention forward for Hopper (sm_90a): grouped-query (GQA)
// scaled-dot-product attention with causal and sliding-window masks,
// computed by online softmax over key/value tiles so that no (Sq, Skv)
// score matrix is ever written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _flash_kernel).  It computes what that kernel
// computes:
//   * the running (m, l, acc) of the online softmax in float32;
//   * q * (1 / sqrt(D)) before the product;
//   * keys at or past Skv masked; causal (kpos <= qpos) and sliding-window
//     (kpos > qpos - window) masks with qpos and kpos both counted from 0,
//     also when Sq != Skv;
//   * key tiles that the causal or window mask covers wholly are skipped;
//   * a row with no allowed key (l = 0) gives 0;
//   * float32 or bfloat16 inputs, float32 arithmetic, output in the input
//     type.
// NEG_INF is finite (-1e30), as in the reference: with -INFINITY a wholly
// masked tile would give exp(-inf - -inf) = NaN.
//
// What bounds it on the H100: at the ViT-12 shape of the main path
// (B = 32, H = 6, S = 64, D = 64, f32, not causal) one call reads q, k, v
// and writes o, 12.6 MB, which takes 3.8 us at 3.35 TB/s, and does 2.0e8
// FLOP, which takes 3.0 us at 67 TFLOP/s on CUDA cores: bytes bound it,
// by a small margin.  This first version is simple and right rather than
// fast: one block per (64-row query tile, head, batch row), 256 threads,
// a loop over 64-row key/value tiles staged in shared memory, fp32 FMA on
// CUDA cores (no tensor cores, no TF32, for parity with the reference).
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, KV, D), o (B, Sq, H, D), all
// contiguous; query head h reads key/value head h / (H / KV).  The layout
// of the model's activations is taken as it is, so the wrapper needs no
// transposes and no repeat of the key/value heads.
//
// Threads: thread t owns query row r = t / 4 of the tile and, within it,
// score columns c = t % 4 + 4 j (j < 16) and output columns
// d = t % 4 + 4 j (j < D / 4).  The four threads of a row are neighbours in
// one warp, so the row's max and sum are two xor-shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // key rows per tile
constexpr int THREADS = 256;
constexpr int LANES = THREADS / BQ;    // threads per query row (4)
constexpr int SCOLS = BK / LANES;      // score columns per thread (16)
constexpr int DMAX = 128;              // largest head dim (wrapper checks)
constexpr int DCOLS = DMAX / LANES;    // output columns per thread, at most
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;                  // padded row: no bank conflicts
  float* qs = smem;                      // (BQ, D + 1), scaled queries
  float* ks = qs + BQ * ld;              // (BK, D + 1)
  float* vs = ks + BK * ld;              // (BK, D)
  float* ps = vs + BK * D;               // (BQ, BK + 1) probabilities

  const int tid = threadIdx.x;
  const int r = tid / LANES;
  const int lane = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int qpos = q0 + r;

  const size_t q_row = (size_t)H * D;    // stride between sequence rows
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int i = e / D, d = e % D;
    qs[i * ld + d] =
        (q0 + i < Sq) ? to_f32(qb[(size_t)(q0 + i) * q_row + d]) * scale : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DCOLS];
#pragma unroll
  for (int j = 0; j < DCOLS; ++j) acc[j] = 0.f;

  const int q_last = q0 + BQ - 1;
  for (int k0 = 0; k0 < Skv; k0 += BK) {
    // the reference's tile skip: wholly above the diagonal, or wholly
    // before the window of the tile's last query row
    if (causal && k0 > q_last) break;
    if (window > 0 && k0 + BK - 1 <= q0 - window) continue;
    __syncthreads();                     // previous tile fully read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int i = e / D, d = e % D;
      const bool in = k0 + i < Skv;
      const size_t g = (size_t)(k0 + i) * kv_row + d;
      ks[i * ld + d] = in ? to_f32(kb[g]) : 0.f;
      vs[i * D + d] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[SCOLS];
#pragma unroll
    for (int j = 0; j < SCOLS; ++j) s[j] = 0.f;
    const float* qr = qs + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j)
        s[j] = fmaf(qd, ks[(lane + LANES * j) * ld + d], s[j]);
    }
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < SCOLS; ++j) {
      const int kpos = k0 + lane + LANES * j;
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? s[j] : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* pr = ps + r * (BK + 1);
#pragma unroll
    for (int j = 0; j < SCOLS; ++j) {
      // a masked entry adds nothing, also while the row has no allowed key
      // yet (then s - m_new = 0 and exp would give 1)
      const float p = (s[j] > NEG_INF) ? expf(s[j] - m_new) : 0.f;
      pr[lane + LANES * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();                        // the row's probabilities written
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[j] *= alpha;
    const int kn = min(BK, Skv - k0);
    for (int c = 0; c < kn; ++c) {
      const float p = pr[c];
      const float* vr = vs + c * D;
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) {
        const int d = lane + LANES * j;
        if (d < D) acc[j] = fmaf(p, vr[d], acc[j]);
      }
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + (size_t)b * Sq * q_row + (size_t)qpos * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) {
      const int d = lane + LANES * j;
      if (d < D) store(orow + d, acc[j] * inv);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int D, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  static size_t granted = 0;             // dynamic shared memory opted into
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return (int)err;
    granted = smem_bytes(DMAX);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, D, causal,
      window, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by kernels/flash_attention/kernel.py.
// q (B, Sq, H, D), k and v (B, Skv, KV, D), o (B, Sq, H, D): contiguous,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), 1 <= D <= 128, H % KV == 0.
// `stream` is a cudaStream_t.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H,
                                   int KV, int D, int causal, int window,
                                   int bf16, void* stream) {
  if (D < 1 || D > DMAX || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D, causal,
                                      window, s)
              : launch<float>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window,
                              s);
}
