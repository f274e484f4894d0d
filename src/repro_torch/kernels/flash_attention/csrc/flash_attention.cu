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
// What bounds it on the H100.  At the ViT-12 shape of the main path
// (B = 32, H = 6, S = 64, D = 64, f32, not causal) one call reads q, k, v
// and writes o, 12.6 MB (3.8 us at 3.35 TB/s), and does 1.0e8 FLOP of
// products (0.6 us at the 165 TFLOP/s of fp32-accurate 3xTF32 products)
// and 6.3e6 of softmax (0.1 us at 67 TFLOP/s): bytes bound it.  The first
// version (fp32 FMA on CUDA cores, one shared-memory load per FMA, loads
// and compute in turn, 66 KB of shared memory a block) took 38.5 us of
// device time there, 10x that bound and 1.6-1.9x slower than
// F.scaled_dot_product_attention (NVIDIA H100 80GB HBM3, 700.00 W).
//
// The design:
//   * O += P V on the tensor cores: mma.sync.m16n8k8 with TF32 operands and
//     an f32 accumulator.  One TF32 pass keeps 10 mantissa bits, too few
//     (tests/test_torch_flash.py pins it at the ViT's init scale), so each
//     operand x is split in registers into hi = x rounded to TF32 and
//     lo = x - hi, and every product is lo*hi + hi*lo + hi*hi (3xTF32), as
//     accurate as fp32 FMA.  Shared memory holds f32 only.
//   * S = (q scale) K^T on the CUDA cores, each score one fmaf chain over
//     d in order, as the plain path's float32 product sums it.  The ViT-12
//     at the reference's init amplifies any change of its logits (std ~64)
//     period by period (ROADMAP, Queue 3); a tensor-core S, accurate as it
//     is, moved each period's output by ~1e-5 against the plain path
//     instead of ~2e-7, and a whole step then left the bar of the smoke
//     run's step check (PERF.md).  Lane (g, t) computes exactly the
//     accumulator fragment it would hold after an MMA, so the softmax and
//     P V read it unchanged.
//   * Each warp owns 16 query rows, the M of the MMA: a row's max and sum
//     are two quad shuffles, and P goes from the accumulator layout to the
//     A layout of P V by quad shuffles too, without shared memory.  A
//     block is 2 warps and one 32-row query tile of one (b, h): the ViT
//     shape's 384 blocks spread over the 132 SMs more evenly than 192
//     blocks of 64 rows would.
//   * Key/value tiles of 32 rows, double-buffered: the next tile's
//     cp.async copies fly while the current one is multiplied (bf16 inputs
//     are upcast to f32 on their way into shared memory, by ordinary loads).
//   * Rows padded (K, Q by 4 floats, V by 8) so that fragment loads hit
//     distinct banks; D is padded with zeros up to 16, 32, 64 or 128 (one
//     instantiation each), which adds nothing to q.k, and the padded output
//     columns are not stored.
//   * At D = 64 a block takes 44.5 KB of shared memory, so 5 blocks fit on
//     an SM and the ViT shape runs in one wave.
// Measured: PERF.md (chip_smoke.py's flash timing).
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, KV, D), o (B, Sq, H, D), all
// contiguous; query head h reads key/value head h / (H / KV).  The layout
// of the model's activations is taken as it is, so the wrapper needs no
// transposes and no repeat of the key/value heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // key rows per tile
constexpr int WARPS = BQ / 16;         // one 16-row MMA tile per warp
constexpr int THREADS = 32 * WARPS;
constexpr int NT = BK / 8;             // 8-wide key columns per tile
constexpr int DMAX = 128;              // largest head dim (wrapper checks)
constexpr float NEG_INF = -1e30f;

template <int DP> struct Smem {        // floats of each region
  static constexpr int LDQ = DP + 4, LDK = DP + 4, LDV = DP + 8;
  static constexpr int Q = BQ * LDQ, K = BK * LDK, V = BK * LDV;
  static constexpr size_t bytes = sizeof(float) * (Q + 2 * K + 2 * V);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// two neighbours at once (p at an even offset of a fresh output)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The 3xTF32 split x = hi + lo.  hi is x rounded to TF32's 10 mantissa
// bits, to nearest with ties away from zero (what cvt.rna.tf32.f32 gives,
// done with integer operations at the full ALU rate, which the conversion
// instruction does not have).  lo = x - hi is exact in f32; the MMA reads
// its top 19 bits, so lo is truncated there, an error below 2^-22 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment (16 x 8), split once for every product it enters
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// d += a b, a (16 x 8) split into (ah, al), b (8 x 8) given as its f32
// fragment: the small terms first, lo*hi + hi*lo, then hi*hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)  // 16 bytes; src-size 0 writes zeros (rows past Skv, D padding)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0));
}

// Rows [k0, k0 + BK) of one key/value head into ks (BK, LDK) and vs
// (BK, LDV), rows >= Skv and columns >= D as zeros.  f32 by cp.async
// (16 bytes a copy where `vec`); bf16 by loads that upcast.
template <int DP>
__device__ __forceinline__ void load_kv(const float* kb, const float* vb,
                                        size_t row, int k0, int Skv, int D,
                                        float* ks, float* vs, bool vec) {
  using S = Smem<DP>;
  if (vec) {
    for (int e = threadIdx.x; e < BK * DP / 4; e += THREADS) {
      const int r = e / (DP / 4), d = 4 * (e % (DP / 4));
      const bool in = k0 + r < Skv && d < D;
      const size_t g = (size_t)(k0 + r) * row + d;
      cp_async(ks + r * S::LDK + d, in ? kb + g : kb, true, in);
      cp_async(vs + r * S::LDV + d, in ? vb + g : vb, true, in);
    }
  } else {
    for (int e = threadIdx.x; e < BK * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      const bool in = k0 + r < Skv && d < D;
      const size_t g = (size_t)(k0 + r) * row + d;
      cp_async(ks + r * S::LDK + d, in ? kb + g : kb, false, in);
      cp_async(vs + r * S::LDV + d, in ? vb + g : vb, false, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int DP>
__device__ __forceinline__ void load_kv(const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb, size_t row,
                                        int k0, int Skv, int D, float* ks,
                                        float* vs, bool) {
  using S = Smem<DP>;
  for (int e = threadIdx.x; e < BK * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    const bool in = k0 + r < Skv && d < D;
    const size_t g = (size_t)(k0 + r) * row + d;
    ks[r * S::LDK + d] = in ? to_f32(kb[g]) : 0.f;
    vs[r * S::LDV + d] = in ? to_f32(vb[g]) : 0.f;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group
}

// Rows [q0, q0 + BQ) of one query head into qs (BQ, LDQ), unscaled, rows
// >= Sq and columns >= D as zeros; f32 by cp.async (committed with the
// first key/value tile), bf16 by loads that upcast.
template <int DP>
__device__ __forceinline__ void load_q(const float* qb, size_t row, int q0,
                                       int Sq, int D, float* qs, bool vec) {
  constexpr int W = 4;                   // floats per 16-byte copy
  for (int e = threadIdx.x; e < BQ * DP / (vec ? W : 1); e += THREADS) {
    const int r = vec ? e / (DP / W) : e / DP;
    const int d = vec ? W * (e % (DP / W)) : e % DP;
    const bool in = q0 + r < Sq && d < D;
    cp_async(qs + r * Smem<DP>::LDQ + d,
             in ? qb + (size_t)(q0 + r) * row + d : qb, vec, in);
  }
}

template <int DP>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qb, size_t row,
                                       int q0, int Sq, int D, float* qs,
                                       bool) {
  for (int e = threadIdx.x; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    qs[r * Smem<DP>::LDQ + d] =
        (q0 + r < Sq && d < D) ? to_f32(qb[(size_t)(q0 + r) * row + d]) : 0.f;
  }
}

// Fragment coordinates of mma.m16n8k8 (PTX ISA): lane = 4 g + t.  A (16 x
// 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).  B (8 x
// 8): b0 (k = t, n = g), b1 (k = t + 4, n = g).  C (16 x 8): c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 4)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int D, int causal, int window, float scale,
                 int vec) {
  using S = Smem<DP>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // (BQ, LDQ), q
  float* kbuf = qs + S::Q;                         // 2 x (BK, LDK)
  float* vbuf = kbuf + 2 * S::K;                   // 2 x (BK, LDV)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);

  const size_t q_row = (size_t)H * D;              // stride between rows
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)hk * D;

  // the reference's tile skip: tiles wholly before the window of the
  // block's first query row, or wholly above the diagonal of its last
  int kt0 = 0, kt1 = (Skv + BK - 1) / BK;
  if (window > 0 && q0 - window - BK + 1 >= 0)
    kt0 = (q0 - window - BK + 1) / BK + 1;
  if (causal) kt1 = min(kt1, (q0 + BQ - 1) / BK + 1);

  if (kt0 < kt1) {                       // q and the first tile in flight
    load_q<DP>(qb, q_row, q0, Sq, D, qs, vec);
    load_kv<DP>(kb, vb, kv_row, kt0 * BK, Skv, D, kbuf, vbuf, vec);
  }

  const int r0 = warp * 16;                        // this warp's rows in qs
  const int qpos0 = q0 + r0 + g, qpos1 = qpos0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1)                              // the next tile in flight
      load_kv<DP>(kb, vb, kv_row, (kt + 1) * BK, Skv, D,
                  kbuf + (buf ^ 1) * S::K, vbuf + (buf ^ 1) * S::V, vec);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                               // this tile (and q) landed
    const float* ks = kbuf + buf * S::K;
    const float* vs = vbuf + buf * S::V;
    const int k0 = kt * BK;

    // S = (q scale) K^T on the CUDA cores, each entry one fmaf chain over d
    // in order, as the plain path's float32 product sums it.  Lane (g, t)
    // holds the accumulator fragment's entries: rows g and g + 8, keys
    // 8 j + 2 t + e.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 q0v =
          *reinterpret_cast<const float4*>(qs + (r0 + g) * S::LDQ + d);
      const float4 q1v =
          *reinterpret_cast<const float4*>(qs + (r0 + g + 8) * S::LDQ + d);
      const float a0[4] = {q0v.x * scale, q0v.y * scale, q0v.z * scale,
                           q0v.w * scale};
      const float a1[4] = {q1v.x * scale, q1v.y * scale, q1v.z * scale,
                           q1v.w * scale};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (8 * j + 2 * t + e) * S::LDK + d);
          const float b[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            s[j][e] = fmaf(a0[u], b[u], s[j][e]);
            s[j][2 + e] = fmaf(a1[u], b[u], s[j][2 + e]);
          }
        }
    }

    // masks, then the online softmax of rows qpos0 (c0, c1), qpos1 (c2, c3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 8 * j + 2 * t + (i & 1);
        const int qpos = i < 2 ? qpos0 : qpos1;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[j][i] = ok ? s[j][i] : NEG_INF;
        mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a masked entry adds nothing, also while the row has no allowed
        // key yet (then s - m = 0 and exp would give 1)
        const float p = s[j][i] > NEG_INF ? expf(s[j][i] - m[i / 2]) : 0.f;
        s[j][i] = p;
        psum[i / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = alpha[r] * l[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V.  P's column c of row g sits in lane 4 g + c / 2, element
    // c % 2 of the accumulator, so the A fragment's columns t and t + 4
    // come from lanes 4 g + t / 2 and 4 g + t / 2 + 2 of the quad
    const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {              // r = 0: row g, 1: g + 8
        const float e0 = __shfl_sync(0xffffffffu, s[j][2 * r], src0);
        const float e1 = __shfl_sync(0xffffffffu, s[j][2 * r + 1], src0);
        const float f0 = __shfl_sync(0xffffffffu, s[j][2 * r], src1);
        const float f1 = __shfl_sync(0xffffffffu, s[j][2 * r + 1], src1);
        a[r] = odd ? e1 : e0;                    // a0, a1: column t
        a[r + 2] = odd ? f1 : f0;                // a2, a3: column t + 4
      }
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const float* vr = vs + (8 * j + t) * S::LDV + 8 * n + g;
        mma3(acc[n], ah, al, vr[0], vr[4 * S::LDV]);
      }
    }
    __syncthreads();                               // tile read before refill
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r ? qpos1 : qpos0;
    if (qpos >= Sq) continue;
    T* orow = o + (size_t)b * Sq * q_row + (size_t)qpos * q_row +
              (size_t)h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      const float x = acc[n][2 * r] * inv[r], y = acc[n][2 * r + 1] * inv[r];
      if (D % 2 == 0) {
        if (d < D) store2(orow + d, x, y);
      } else {
        if (d < D) store(orow + d, x);
        if (d + 1 < D) store(orow + d + 1, y);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int D, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<DP>::bytes;
  static bool granted = false;           // dynamic shared memory opted into
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)              // as many blocks per SM as fit
      err = cudaFuncSetAttribute(
          flash_fwd_kernel<T, DP>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const int vec = D % 4 == 0 && reinterpret_cast<size_t>(q) % 16 == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, D, causal,
      window, 1.f / sqrtf((float)D), vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KV, int D, int causal, int window,
             cudaStream_t s) {
  if (D <= 16)
    return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, s);
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, s);
  return launch<T, DMAX>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, s);
}

// The resources of each __global__ kernel of this file as the card built
// it, for the kernel audit (analysis/kernel_audit.py), which runs none:
// per kernel, 5 ints: registers a thread, static shared bytes, local
// (spill) bytes a thread, cudaFuncAttributes.maxThreadsPerBlock and the
// block its launches use.  `rows` holds `n` kernels' rows; returns the
// CUDA error (0 = read).
int read_attributes(const void* const* fns, const int* blocks, int count,
                    int* rows, int n) {
  if (n < count) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return (int)err;
    int* r = rows + 5 * i;
    r[0] = a.numRegs;
    r[1] = (int)a.sharedSizeBytes;
    r[2] = (int)a.localSizeBytes;
    r[3] = a.maxThreadsPerBlock;
    r[4] = blocks[i];
  }
  return 0;
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
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D,
                                        causal, window, s)
              : launch_d<float>(q, k, v, o, B, Sq, Skv, H, KV, D, causal,
                                window, s);
}

// Each instance's resources (read_attributes), in this order: float at
// head dims 16, 32, 64 and 128, then bfloat16 at the same; every launch
// uses THREADS.
extern "C" int flash_attention_attributes(int* rows, int n) {
  using F = float;
  using H = __nv_bfloat16;
  const void* fns[] = {reinterpret_cast<const void*>(&flash_fwd_kernel<F, 16>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<F, 32>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<F, 64>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<F, DMAX>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<H, 16>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<H, 32>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<H, 64>),
                       reinterpret_cast<const void*>(&flash_fwd_kernel<H, DMAX>)};
  const int blocks[] = {THREADS, THREADS, THREADS, THREADS,
                        THREADS, THREADS, THREADS, THREADS};
  return read_attributes(fns, blocks, 8, rows, n);
}
