// sLSTM time scan for Hopper (sm_90a): the forward and the backward of the
// stabilised sLSTM recurrence of xLSTM over a whole sequence, one
// cooperative launch each.
//
// The forward replaces the TPU kernel src/repro/kernels/slstm_scan/kernel.py:
// slstm_scan_pallas (body _slstm_kernel).  Per step t, for each of the four
// gates g (i, f, z, o) and each column j of a head:
//   g[g][j] = (g_in[t][g][j] + sum_e h[e] * r[g][e][j]) + b[g][j]
//   logf    = log sigmoid(g_f) = min(g_f, 0) - log1p(exp(-|g_f|))
//   m'      = max(logf + m, g_i)
//   i'      = exp(g_i - m');  f' = exp(logf + m - m')
//   c'      = f' c + i' tanh(g_z);  n' = f' n + i'
//   h'      = sigmoid(g_o) c' / max(n', 1e-6)
// It writes h' of every step to hs and the last step's (c, n, m, h) to the
// four final-state outputs, and, when asked, the per-step pre-activations g
// and states c, n, m that the backward takes.  It runs exactly S steps: no
// padding of the sequence.
//
// The backward has no TPU kernel: the reference differentiates its plain
// scan (src/repro/kernels/slstm_scan/ops.py: _scan_bwd, the VJP of
// slstm_scan_ref), which XLA compiles into one reverse loop.  Here that loop
// is a kernel: from t = S - 1 down to 0 it carries (dc, dn, dm, dh), adds
// the cotangent dhs[t], and writes the gate gradients dg[t] (the gradient of
// g_in) and at the end the gradients of (c0, n0, m0, h0).  It matches the
// plain version's autograd: torch.maximum splits a tie half and half,
// clamp(n, min=1e-6) passes the gradient where n >= 1e-6, and the gradient
// flows through m into i' and f'.  dr and db are plain large products
// outside (kernels/slstm_scan/ops.py), as XLA computes them.
//
// What bounds them on the H100: at the xlstm-1.3b shape of the main path
// (B = 16, S = 256, H = 4, Dh = 512) each does 3.44e10 FLOP of recurrent
// products (2 B S H 4 Dh^2), 0.208 ms at the tensor cores' TF32 rate / 3, and
// moves 186 MB (forward) or ~420 MB (backward), 0.06 / 0.13 ms: operations
// bound both.  A head's r is 4 MiB in f32: more than the 227 KB of shared
// memory of an SM and more than a cluster of 16 SMs holds.
//
// Design.  A step of one head is the product (B x Dh) . (Dh x 4 Dh).  The
// head's columns j are split into tiles of TW = 16; a block owns one tile's
// 64 gate columns (g, j) for all B rows, so the nonlinear update of a column
// stays in the block, and keeps that tile's slice of r (4 Dh TW floats,
// 128 KiB at Dh = 512) in shared memory for the whole sequence: r is read
// from device memory once per call and every batch row shares it.  At the
// main shape that is 32 blocks a head, 128 in all, one per SM.  The blocks
// of a head exchange h_{t-1} through L2: it is the output hs[:, t-1], read
// with ld.global.cg after a per-head barrier (an arrival counter with
// release/acquire fences, zeroed by the wrapper), so every block of the
// launch must be resident: it is launched with cudaLaunchCooperativeKernel,
// whose refusal is returned.  Rows go in chunks of RB = 16, so a step of a
// block is the product (16 x Dh) . (Dh x 64): the 8 warps split the
// reduction over e, each warp computes the whole 16 x 64 tile with
// mma.sync m16n8k8 in 3xTF32 (fp32 accuracy on the tensor cores: fp32 FMAs
// were bound by shared memory, 4-row x 8-column lane tiles needing 12
// loads per 32 FMAs), and the 8 partial tiles are added in warp order, so
// every run gives the same bits.  A warp reads its share of h_{t-1} from
// L2 straight into its A fragments (float4 loads; e is permuted within
// each 16 so that a lane's four values are adjacent, r's rows likewise),
// and r's slice sits in shared memory in the B fragments' order.  The
// per-step loads from device memory (g_in; in the backward the saved
// states and dhs) are issued one step ahead.  The backward uses the same
// column split with r transposed, its fragments in shared memory: each
// block computes its partial dh_{t-1} = dg_t . r_slice^T over all Dh,
// writes it to an L2 scratch (double-buffered by step parity), and after
// the barrier each block adds the head's partials for its own columns in
// tile order: no float atomics.
//
// Shapes that do not fit: when the blocks with r resident (H ceil(Dh/TW) of
// them) exceed what the card holds at once, or r's slice does not fit in
// shared memory (Dh > 512 or so), the kernel streams r's slice from L2
// through a staging buffer at every step instead, with as many blocks per
// head as fit (a block then owns several tiles).  The design is chosen from
// one cohort's shape (and the card) alone, the same way every time.
// expf/log1pf/tanhf without fast math.
//
// Cohorts (the vectorized round: the reference vmaps the pallas_call, which
// adds a grid axis).  C independent scans with their own r and b run as C H
// heads: head (c, h) reads and writes cohort c's slices and has its own
// counter.  Blocks per head and resident-or-streamed come from one cohort's
// (B, S, H, Dh), never from C, so a cohort gets the bits of a launch of its
// own; heads beyond what the card holds at once go to further launches, in
// groups of whole heads.  (Cohorts that share r and b fold into B in the
// wrapper: rows are independent, each row the M axis of its own mma.)
//
// Layout, all contiguous float32, each with a leading cohort axis of C:
// g_in, g and dg (C, B, S, 4, H, Dh), r (C, 4, H, Dh, Dh), b (C, 4, H, Dh),
// the initial and final states and their gradients (C, B, H, Dh), hs, dhs
// and the per-step c, n, m (C, B, S, H, Dh); scratch
// (2, C H, ceil(Dh/TW), B, Dh); counters (C H), zero.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 16;        // columns j of a head in a tile
constexpr int TC = 4 * TW;    // a tile's gate columns, c = g * TW + (j - j0)
constexpr int RB = 16;        // batch rows in a chunk
constexpr int FWD_SE = 64;    // rows e of r staged at a time (streamed)
constexpr int BWD_SE = 256;   // columns e of r^T staged at a time (streamed)
constexpr int MAX_DH = 1024;  // the wrapper's MAX_HEAD_DIM
constexpr int KS = 8;         // the MMA's depth k (m16n8k8)
constexpr int FRAG = KS * TC;  // a k-step's 8 x 64 block of B fragments
constexpr int PLD = TC + 8;   // row stride of the forward's partials
constexpr int GLD = TC + 4;   // row stride of the backward's dg

static_assert(RB * TW == THREADS, "one (row, column) pair per thread");

struct Dims {
  int B, S, H, Dh;
  int C;      // cohorts: C H heads in all
  int Dh16;   // Dh rounded up to 2 KS: rows of r in the forward
  int Dh64;   // Dh rounded up to 64: columns of r^T in the backward
  int T;      // tiles of a head, ceil(Dh / TW)
  int Gh;     // blocks per head
  int head0;  // first head (of all C H) of this launch
  // a cohort's elements of a (B, S, 4, H, Dh), (B, S, H, Dh), (B, H, Dh),
  // r and b
  size_t gates, steps, states, rs, bs;
};

// The cohort of this block's head, and its head within the cohort.
struct Head {
  int global, cohort, head;
  __device__ Head(const Dims& d, int block)
      : global(d.head0 + block / d.Gh),
        cohort((d.head0 + block / d.Gh) / d.H),
        head((d.head0 + block / d.Gh) % d.H) {}
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of a head arrives once per step; wait until the head's
// counter reaches `target` arrivals.  The writes before the barrier are
// visible to every block of the head after it.  A wait of more than 10 s
// (a block that is not resident, which the cooperative launch rules out)
// traps, so a fault surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void head_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned long long start = global_ns();
    while (load_acquire(count) < target) {
      if (global_ns() - start > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// x = hi + lo exactly, hi x's sign, exponent and top 10 mantissa bits (a
// TF32 value); the tensor core reads lo's top 10 too, so hi + lo carries
// x to 2^-20 of it, and 3xTF32 keeps close to the fp32 product's accuracy.
// (A mask and a subtraction: cvt.rna.tf32 made the products 1.6x slower.)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for a 16 x 8 A fragment and the 8 x 64 B fragments of one
// k-step (16 floats a lane, 4 float4 loads), in 3xTF32: a_lo b_hi +
// a_hi b_lo + a_hi b_hi, the small terms first.  Fragments as PTX's
// m16n8k8 .tf32: lane = 4 gid + tig; A a0..a3 = (gid, tig), (gid + 8,
// tig), (gid, tig + 4), (gid + 8, tig + 4); B of n-tile nt b0, b1 =
// (tig, 8 nt + gid), (tig + 4, 8 nt + gid); C c0..c3 = (gid, 8 nt +
// 2 tig), (gid, 8 nt + 2 tig + 1), (gid + 8, ...), (gid + 8, ... + 1).
__device__ __forceinline__ void mma_kstep(float (&c)[8][4],
                                          const float (&a)[4],
                                          const float* frag) {
  const int lane = threadIdx.x & 31;
  unsigned ah[4], al[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
  float b[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(frag)[q * 32 + lane];
    b[4 * q] = v.x;
    b[4 * q + 1] = v.y;
    b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned bh0, bl0, bh1, bl1;
    split_tf32(b[2 * nt], bh0, bl0);
    split_tf32(b[2 * nt + 1], bh1, bl1);
    mma_tf32(c[nt], al, bh0, bh1);
    mma_tf32(c[nt], ah, bl0, bl1);
    mma_tf32(c[nt], ah, bh0, bh1);
  }
}

// Where B[k][n] (k < 8, n < 64) of a k-step goes in its fragment block:
// lane 4 (n % 8) + k % 4 holds it as float 2 (n / 8) + k / 4 of its 16,
// stored as float4 q of lane at q * 32 + lane, so a warp's loads are
// conflict-free.
__device__ __forceinline__ int frag_offset(int k, int n) {
  const int lane = (n % 8) * 4 + k % 4, pos = 2 * (n / 8) + k / 4;
  return ((pos / 4) * 32 + lane) * 4 + pos % 4;
}

// ---------------------------------------------------------------- forward

// The forward's k order.  Each pair p of k-steps covers 16 e's; lane
// (gid, tig) reads h[row][16 p + 4 tig .. + 3] as one float4, whose x, y
// are (k, k + 4) = (tig, tig + 4) of k-step 2 p and z, w those of k-step
// 2 p + 1.  So e - e0 = 16 p + 4 tig + 2 s + u is k-step 2 p + s, k =
// tig + 4 u; r's rows follow the same order.
__device__ __forceinline__ int fwd_frag_index(int el, int c) {
  const int p = el / 16, tig = (el % 16) / 4, s = (el % 4) / 2, u = el % 2;
  return (2 * p + s) * FRAG + frag_offset(tig + 4 * u, c);
}

// Rows e in [e0, e1) (multiples of 2 KS) of the tile's r, columns c = g TW
// + jj (r[g][head][e][j0 + jj]), as the B fragments of the chunk's
// k-steps in the forward's k order, zero beyond Dh.
__device__ void load_r_frags(float* r_s, const float* __restrict__ r,
                             int head, int j0, int e0, int e1,
                             const Dims& d) {
  const int n = (e1 - e0) * TC;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int e = e0 + i / TC, c = i % TC, g = c / TW, j = j0 + c % TW;
    r_s[fwd_frag_index(e - e0, c)] =
        (e < d.Dh && j < d.Dh)
            ? r[((static_cast<size_t>(g) * d.H + head) * d.Dh + e) * d.Dh + j]
            : 0.0f;
  }
}

constexpr int LOADS = 8;  // L2 loads a thread keeps in flight

// sum_k p[k * stride] for k < n, in order, LOADS loads in flight at a time
__device__ __forceinline__ float sum_partials(const float* p, size_t stride,
                                              int n) {
  float s = 0.0f;
  for (int k0 = 0; k0 < n; k0 += LOADS) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      v[u] = k0 + u < n ? __ldcg(p + (k0 + u) * stride) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (k0 + u < n) s += v[u];
    }
  }
  return s;
}

// This warp's share of the chunk's pairs of k-steps [0, np): c[nt] +=
// h[rows][e0 + e] r[e0 + e][columns] on the tensor cores, h_{t-1} read
// straight from L2 (``h`` points at the head's row b0; rows ``stride``
// apart; rows past B and e past Dh read as 0), r from the fragments r_s.
// The warps take consecutive ranges of pairs; a lane issues the loads of
// four pairs before it waits on any.
__device__ __forceinline__ void fwd_product(float (&c)[8][4], const float* h,
                                            size_t stride, int b0,
                                            const float* r_s, int e0, int np,
                                            const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int p0 = warp * np / WARPS, p1 = (warp + 1) * np / WARPS;
  const bool top_in = b0 + gid < d.B, bot_in = b0 + gid + 8 < d.B;
  const float* top = h + gid * stride + e0 + 4 * tig;
  const float* bot = top + 8 * stride;
  for (int pa = p0; pa < p1; pa += 4) {
    float4 at[4], ab[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + 16 * (pa + q) + 4 * tig;
      const bool in = pa + q < p1;
      at[q] = ab[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int off = 16 * (pa + q);
      if ((d.Dh & 3) == 0) {
        if (in && e < d.Dh) {
          if (top_in) {
            at[q] = __ldcg(reinterpret_cast<const float4*>(top + off));
          }
          if (bot_in) {
            ab[q] = __ldcg(reinterpret_cast<const float4*>(bot + off));
          }
        }
      } else if (in) {
        float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (e + v < d.Dh) {
            if (top_in) tv[v] = __ldcg(top + off + v);
            if (bot_in) bv[v] = __ldcg(bot + off + v);
          }
        }
        at[q] = make_float4(tv[0], tv[1], tv[2], tv[3]);
        ab[q] = make_float4(bv[0], bv[1], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (pa + q >= p1) break;
      const float a0[4] = {at[q].x, ab[q].x, at[q].y, ab[q].y};
      const float a1[4] = {at[q].z, ab[q].z, at[q].w, ab[q].w};
      mma_kstep(c, a0, r_s + 2 * (pa + q) * FRAG);
      mma_kstep(c, a1, r_s + (2 * (pa + q) + 1) * FRAG);
    }
  }
}

// A block's items are (tile, row chunk) pairs: tiles first, first + Gh, ...
// of its head, row chunks of RB rows.  At the main shape a block has one.
struct Items {
  int first, n_chunks, n;
  __device__ Items(const Dims& d, int first_)
      : first(first_),
        n_chunks((d.B + RB - 1) / RB),
        n(((d.T - first_ + d.Gh - 1) / d.Gh) * ((d.B + RB - 1) / RB)) {}
  __device__ int tile(int i, const Dims& d) const {
    return first + (i / n_chunks) * d.Gh;
  }
  __device__ int b0(int i) const { return (i % n_chunks) * RB; }
};

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
slstm_fwd_kernel(const float* __restrict__ g_in, const float* __restrict__ r,
                 const float* __restrict__ bias,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0, const float* __restrict__ h0,
                 float* hs, float* cf, float* nf, float* mf, float* hf,
                 float* gs, float* cs, float* ns, float* ms,
                 unsigned* counters, Dims d) {
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);  // fragments of (rows, TC)
  float* part = r_s + (RESIDENT ? d.Dh16 : FWD_SE) * TC;  // (WARPS, RB, PLD)
  const Head who(d, blockIdx.x);
  const int head = who.head;
  const Items items(d, blockIdx.x % d.Gh);
  const bool save = gs != nullptr;
  {  // cohort who.cohort's slices
    const size_t c = who.cohort;
    g_in += c * d.gates;
    r += c * d.rs;
    bias += c * d.bs;
    c0 += c * d.states;
    n0 += c * d.states;
    m0 += c * d.states;
    h0 += c * d.states;
    hs += c * d.steps;
    cf += c * d.states;
    nf += c * d.states;
    mf += c * d.states;
    hf += c * d.states;
    if (save) {
      gs += c * d.gates;
      cs += c * d.steps;
      ns += c * d.steps;
      ms += c * d.steps;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bl = threadIdx.x / TW, jj = threadIdx.x % TW;
  const size_t hd = static_cast<size_t>(d.H) * d.Dh;
  // with one item the thread's (c, n, m) stay in registers
  const bool single = items.n == 1;

  // the gate inputs of item i at step t, loaded one item ahead so that
  // their latency hides behind the current item's product
  auto load_gin = [&](int t, int i, float (&v)[4]) {
    const int j = items.tile(i, d) * TW + jj, b = items.b0(i) + bl;
    if (b < d.B && j < d.Dh) {
      const size_t at = (static_cast<size_t>(b) * d.S + t) * 4 * hd +
                        static_cast<size_t>(head) * d.Dh + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = g_in[at + g * hd];
    }
  };

  if (RESIDENT) {
    load_r_frags(r_s, r, head, items.first * TW, 0, d.Dh16, d);
    __syncthreads();
  }
  float gin_next[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  load_gin(0, 0, gin_next);
  float c_r = 0.0f, n_r = 0.0f, m_r = 0.0f;
  if (single) {
    const int j = items.first * TW + jj;
    if (bl < d.B && j < d.Dh) {
      const size_t st = static_cast<size_t>(bl) * hd +
                        static_cast<size_t>(head) * d.Dh + j;
      c_r = c0[st];
      n_r = n0[st];
      m_r = m0[st];
    }
  }

  for (int t = 0; t < d.S; ++t) {
    for (int i = 0; i < items.n; ++i) {
      const int tile = items.tile(i, d), b0 = items.b0(i);
      const int j = tile * TW + jj, b = b0 + bl;
      const bool live = b < d.B && j < d.Dh;
      float gin[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) gin[g] = gin_next[g];
      if (i + 1 < items.n) {
        load_gin(t, i + 1, gin_next);
      } else if (t + 1 < d.S) {
        load_gin(t + 1, 0, gin_next);
      }
      // h_{t-1}: h0 at t = 0, else hs[:, t - 1] (other blocks wrote it)
      const float* h_prev =
          t == 0 ? h0 + (static_cast<size_t>(b0) * d.H + head) * d.Dh
                 : hs + ((static_cast<size_t>(b0) * d.S + t - 1) * d.H +
                         head) * d.Dh;
      const size_t stride = t == 0 ? hd : d.S * hd;
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
      }
      if (RESIDENT) {
        fwd_product(acc, h_prev, stride, b0, r_s, 0, d.Dh16 / 16, d);
      } else {
        for (int e0 = 0; e0 < d.Dh16; e0 += FWD_SE) {
          const int e1 = min(e0 + FWD_SE, d.Dh16);
          load_r_frags(r_s, r, head, tile * TW, e0, e1, d);
          __syncthreads();
          fwd_product(acc, h_prev, stride, b0, r_s, e0, (e1 - e0) / 16,
                      d);
          __syncthreads();
        }
      }
      // the item before may still be reading the partials
      __syncthreads();
      float* pw = part + (warp * RB + gid) * PLD + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<float2*>(pw + nt * 8) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(pw + 8 * PLD + nt * 8) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      __syncthreads();
      if (!live) continue;
      float gv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          s += part[(w * RB + bl) * PLD + g * TW + jj];
        }
        gv[g] = (gin[g] + s) +
                bias[(static_cast<size_t>(g) * d.H + head) * d.Dh + j];
      }
      const size_t st = static_cast<size_t>(b) * hd +
                        static_cast<size_t>(head) * d.Dh + j;
      const float c_p = single ? c_r : (t ? cf[st] : c0[st]);
      const float n_p = single ? n_r : (t ? nf[st] : n0[st]);
      const float m_p = single ? m_r : (t ? mf[st] : m0[st]);
      const float logf_ = log_sigmoid(gv[1]);
      const float m_new = fmaxf(logf_ + m_p, gv[0]);
      const float i_s = expf(gv[0] - m_new);
      const float f_s = expf(logf_ + m_p - m_new);
      const float c = f_s * c_p + i_s * tanhf(gv[2]);
      const float n = f_s * n_p + i_s;
      const float h = sigmoid(gv[3]) * c / fmaxf(n, 1e-6f);
      if (single) {
        c_r = c;
        n_r = n;
        m_r = m_new;
      }
      if (!single || t == d.S - 1) {
        cf[st] = c;
        nf[st] = n;
        mf[st] = m_new;
      }
      const size_t ht = (static_cast<size_t>(b) * d.S + t) * hd +
                        static_cast<size_t>(head) * d.Dh + j;
      hs[ht] = h;
      if (t == d.S - 1) hf[st] = h;
      if (save) {
        const size_t at = (static_cast<size_t>(b) * d.S + t) * 4 * hd +
                          static_cast<size_t>(head) * d.Dh + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) gs[at + g * hd] = gv[g];
        cs[ht] = c;
        ns[ht] = n;
        ms[ht] = m_new;
      }
    }
    if (t + 1 < d.S) head_barrier(counters + who.global, (t + 1) * d.Gh);
  }
}

// --------------------------------------------------------------- backward

// Columns e in [e0, e1) (multiples of 64) of the tile's r, transposed, as
// B fragments: B[c][e] = r[g][head][e][j0 + jj] (c = g TW + jj, the
// k-steps of 8 c's by 64-wide e-tiles): rt_s[(ks * n_et + et) * FRAG +
// frag_offset(c % KS, e % 64)], n_et = (e1 - e0) / 64, zero beyond Dh.
__device__ void load_rt_frags(float* rt_s, const float* __restrict__ r,
                              int head, int j0, int e0, int e1,
                              const Dims& d) {
  const int n = (e1 - e0) * TC, n_et = (e1 - e0) / 64;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int e = e0 + i / TC, c = i % TC, g = c / TW, j = j0 + c % TW;
    const int el = e - e0;
    rt_s[((c / KS) * n_et + el / 64) * FRAG + frag_offset(c % KS, el % 64)] =
        (e < d.Dh && j < d.Dh)
            ? r[((static_cast<size_t>(g) * d.H + head) * d.Dh + e) * d.Dh + j]
            : 0.0f;
  }
}

// dst[b][e] = sum_c dg_s[b - b0][c] r^T[c][e] for the rows of the chunk
// and the chunk's e-tiles [e0, e0 + 64 n_et) (fragments rt_s), on the
// tensor cores; each warp takes e-tiles in turn, summing over c in k-step
// order.
__device__ __forceinline__ void bwd_product(float* dst, const float* dg_s,
                                            const float* rt_s, int e0,
                                            int n_et, int b0,
                                            const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* top = dg_s + gid * GLD + tig;
  const float* bot = top + 8 * GLD;
  for (int et = warp; et < n_et; et += WARPS) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
    }
#pragma unroll 2
    for (int ks = 0; ks < TC / KS; ++ks) {
      const int c = ks * KS;
      const float a[4] = {top[c], bot[c], top[c + 4], bot[c + 4]};
      mma_kstep(acc, a, rt_s + (ks * n_et + et) * FRAG);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + gid + 8 * half;
      if (b >= d.B) continue;
      float* row = dst + static_cast<size_t>(b) * d.Dh;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int e = e0 + et * 64 + nt * 8 + 2 * tig;
        if ((d.Dh & 1) == 0) {
          if (e < d.Dh) {
            *reinterpret_cast<float2*>(row + e) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
          }
        } else {
          if (e < d.Dh) row[e] = acc[nt][2 * half];
          if (e + 1 < d.Dh) row[e + 1] = acc[nt][2 * half + 1];
        }
      }
    }
  }
}

// What the backward reads of one (step, row, column): the cotangent of h,
// the saved pre-activations, the step's c and n, and the previous state.
struct Saved {
  float dh, g[4], c, n, c_p, n_p, m_p;
};

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
slstm_bwd_kernel(const float* __restrict__ gs, const float* __restrict__ cs,
                 const float* __restrict__ ns, const float* __restrict__ ms,
                 const float* __restrict__ r, const float* __restrict__ c0,
                 const float* __restrict__ n0, const float* __restrict__ m0,
                 const float* __restrict__ dhs,
                 const float* __restrict__ dc_t,
                 const float* __restrict__ dn_t,
                 const float* __restrict__ dm_t,
                 const float* __restrict__ dh_t, float* dg, float* dc0,
                 float* dn0, float* dm0, float* dh0, float* scratch,
                 unsigned* counters, Dims d) {
  extern __shared__ float4 smem4[];
  const int ld = RESIDENT ? d.Dh64 : BWD_SE;      // e's of r^T held
  float* rt_s = reinterpret_cast<float*>(smem4);  // fragments of (TC, ld)
  float* dg_s = rt_s + TC * ld;                   // (RB, GLD)
  const Head who(d, blockIdx.x);
  const int head = who.head;
  const Items items(d, blockIdx.x % d.Gh);
  {  // cohort who.cohort's slices
    const size_t c = who.cohort;
    gs += c * d.gates;
    cs += c * d.steps;
    ns += c * d.steps;
    ms += c * d.steps;
    r += c * d.rs;
    c0 += c * d.states;
    n0 += c * d.states;
    m0 += c * d.states;
    dhs += c * d.steps;
    dc_t += c * d.states;
    dn_t += c * d.states;
    dm_t += c * d.states;
    dh_t += c * d.states;
    dg += c * d.gates;
    dc0 += c * d.states;
    dn0 += c * d.states;
    dm0 += c * d.states;
    dh0 += c * d.states;
  }
  const int bl = threadIdx.x / TW, jj = threadIdx.x % TW;
  const size_t hd = static_cast<size_t>(d.H) * d.Dh;
  const size_t tile_stride = static_cast<size_t>(d.B) * d.Dh;
  // with one item the thread's carried (dc, dn, dm) stay in registers
  const bool single = items.n == 1;
  // partials of (step parity, tile) of this head (of all C H)
  auto part = [&](int parity, int tile) {
    return scratch +
           ((static_cast<size_t>(parity) * d.C * d.H + who.global) * d.T +
            tile) *
               tile_stride;
  };
  // item i's reads at step t, loaded one item ahead (they come from
  // device memory; their latency hides behind the current item)
  auto load_saved = [&](int t, int i, Saved& v) {
    const int j = items.tile(i, d) * TW + jj, b = items.b0(i) + bl;
    if (b >= d.B || j >= d.Dh) return;
    const size_t st = static_cast<size_t>(b) * hd +
                      static_cast<size_t>(head) * d.Dh + j;
    const size_t ht = (static_cast<size_t>(b) * d.S + t) * hd +
                      static_cast<size_t>(head) * d.Dh + j;
    const size_t at = (static_cast<size_t>(b) * d.S + t) * 4 * hd +
                      static_cast<size_t>(head) * d.Dh + j;
    v.dh = dhs[ht];
#pragma unroll
    for (int g = 0; g < 4; ++g) v.g[g] = gs[at + g * hd];
    v.c = cs[ht];
    v.n = ns[ht];
    v.c_p = t ? cs[ht - hd] : c0[st];
    v.n_p = t ? ns[ht - hd] : n0[st];
    v.m_p = t ? ms[ht - hd] : m0[st];
  };

  if (RESIDENT) load_rt_frags(rt_s, r, head, items.first * TW, 0, d.Dh64, d);
  Saved next = {};
  load_saved(d.S - 1, 0, next);
  float dc_r = 0.0f, dn_r = 0.0f, dm_r = 0.0f;
  if (single) {
    const int j = items.first * TW + jj;
    if (bl < d.B && j < d.Dh) {
      const size_t st = static_cast<size_t>(bl) * hd +
                        static_cast<size_t>(head) * d.Dh + j;
      dc_r = dc_t[st];
      dn_r = dn_t[st];
      dm_r = dm_t[st];
    }
  }

  for (int t = d.S - 1; t >= 0; --t) {
    for (int i = 0; i < items.n; ++i) {
      const int tile = items.tile(i, d), b0 = items.b0(i);
      const int j = tile * TW + jj, b = b0 + bl;
      const bool live = b < d.B && j < d.Dh;
      const Saved v = next;
      if (i + 1 < items.n) {
        load_saved(t, i + 1, next);
      } else if (t > 0) {
        load_saved(t - 1, 0, next);
      }
      float dgv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live) {
        const size_t st = static_cast<size_t>(b) * hd +
                          static_cast<size_t>(head) * d.Dh + j;
        // dh_t: the cotangent of hs[t] and, through the recurrence, of
        // step t + 1 (the partials of every tile, in tile order)
        float carry;
        if (t == d.S - 1) {
          carry = dh_t[st];
        } else {
          carry = sum_partials(part((t + 1) & 1, 0) +
                                   static_cast<size_t>(b) * d.Dh + j,
                               tile_stride, d.T);
        }
        const float dh = v.dh + carry;
        const bool last = t == d.S - 1;
        float dc = single ? dc_r : (last ? dc_t[st] : dc0[st]);
        float dn = single ? dn_r : (last ? dn_t[st] : dn0[st]);
        const float dm = single ? dm_r : (last ? dm_t[st] : dm0[st]);
        const float gi = v.g[0], gf = v.g[1], gz = v.g[2], go = v.g[3];
        // the forward step, recomputed from the saved states
        const float logf_ = log_sigmoid(gf);
        const float a = logf_ + v.m_p;
        const float m_new = fmaxf(a, gi);
        const float i_s = expf(gi - m_new);
        const float f_s = expf(a - m_new);
        const float tz = tanhf(gz);
        const float o = sigmoid(go);
        const float c = v.c, n = v.n;
        const float nc = fmaxf(n, 1e-6f);
        // h = (o c) / max(n, 1e-6)
        const float dp = dh / nc;
        if (n >= 1e-6f) dn += -dh * ((o * c) / (nc * nc));
        dc += dp * o;
        dgv[3] = dp * c * (o * (1.0f - o));
        // c = f' c_p + i' tanh(g_z);  n = f' n_p + i'
        const float dfs = dc * v.c_p + dn * v.n_p;
        const float dis = dc * tz + dn;
        dgv[2] = dc * i_s * (1.0f - tz * tz);
        // i' = exp(g_i - m);  f' = exp(a - m), a = logf + m_p
        const float x1 = dis * i_s, x2 = dfs * f_s;
        const float dm_tot = dm - x1 - x2;
        // m = max(a, g_i): a tie splits half and half
        const float wa = a > gi ? 1.0f : (a == gi ? 0.5f : 0.0f);
        const float da = x2 + dm_tot * wa;
        dgv[0] = x1 + dm_tot * (1.0f - wa);
        dgv[1] = da * sigmoid(-gf);
        const size_t at = (static_cast<size_t>(b) * d.S + t) * 4 * hd +
                          static_cast<size_t>(head) * d.Dh + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[at + g * hd] = dgv[g];
        if (single) {
          dc_r = dc * f_s;
          dn_r = dn * f_s;
          dm_r = da;
        }
        if (!single || t == 0) {
          dc0[st] = dc * f_s;
          dn0[st] = dn * f_s;
          dm0[st] = da;
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dg_s[bl * GLD + g * TW + jj] = dgv[g];
      __syncthreads();
      float* dst = part(t & 1, tile);
      if (RESIDENT) {
        bwd_product(dst, dg_s, rt_s, 0, d.Dh64 / 64, b0, d);
      } else {
        for (int e0 = 0; e0 < d.Dh64; e0 += BWD_SE) {
          const int e1 = min(e0 + BWD_SE, d.Dh64);
          load_rt_frags(rt_s, r, head, tile * TW, e0, e1, d);
          __syncthreads();
          bwd_product(dst, dg_s, rt_s, e0, (e1 - e0) / 64, b0, d);
          __syncthreads();
        }
      }
      __syncthreads();
    }
    head_barrier(counters + who.global, (d.S - t) * d.Gh);
  }

  // dh0: the partials of step 0, in tile order
  for (int i = 0; i < items.n; ++i) {
    const int j = items.tile(i, d) * TW + jj, b = items.b0(i) + bl;
    if (b >= d.B || j >= d.Dh) continue;
    dh0[static_cast<size_t>(b) * hd + static_cast<size_t>(head) * d.Dh +
        j] = sum_partials(part(0, 0) + static_cast<size_t>(b) * d.Dh + j,
                          tile_stride, d.T);
  }
}

// ------------------------------------------------------------------- host

struct Launch {
  const void* fn;
  size_t smem;
  int Gh;     // blocks per head
  int most;   // blocks the card holds at once
};

// From one cohort's H heads of T tiles: r resident when every block of a
// cohort (one per tile) fits on the card at once and the slice fits in
// shared memory; else r streamed, with as many blocks per head as fit.
// Each launch then takes as many whole heads (of all C H) as the card
// holds at once: most / Gh.
cudaError_t choose(const void* resident_fn, size_t resident_smem,
                   const void* streamed_fn, size_t streamed_smem, int H,
                   int T, Launch* out) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (resident_smem <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(resident_fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(resident_smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resident_fn, THREADS, resident_smem);
    }
    if (err != cudaSuccess) return err;
    if (static_cast<long long>(H) * T <=
        static_cast<long long>(per_sm) * sms) {
      *out = {resident_fn, resident_smem, T, per_sm * sms};
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(streamed_fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(streamed_smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, streamed_fn, THREADS, streamed_smem);
  }
  if (err != cudaSuccess) return err;
  const int most = per_sm * sms;
  if (most < 1) return cudaErrorInvalidConfiguration;
  const int Gh = most >= H ? (T < most / H ? T : most / H) : 1;
  *out = {streamed_fn, streamed_smem, Gh, most};
  return cudaSuccess;
}

Dims dims(int C, int B, int S, int H, int Dh) {
  Dims d;
  d.B = B;
  d.S = S;
  d.H = H;
  d.Dh = Dh;
  d.C = C;
  d.states = static_cast<size_t>(B) * H * Dh;
  d.steps = d.states * S;
  d.gates = d.steps * 4;
  d.rs = static_cast<size_t>(4) * H * Dh * Dh;
  d.bs = static_cast<size_t>(4) * H * Dh;
  d.Dh16 = (Dh + 2 * KS - 1) / (2 * KS) * (2 * KS);
  d.Dh64 = (Dh + 63) / 64 * 64;
  d.T = (Dh + TW - 1) / TW;
  d.Gh = 1;
  d.head0 = 0;
  return d;
}

bool bad_shape(int C, int B, int S, int H, int Dh) {
  return C < 1 || B < 1 || S < 1 || H < 1 || Dh < 1 || Dh > MAX_DH;
}

// Launch L.fn over all C H heads of `d`, L.most / L.Gh whole heads at a
// time; `args` are the kernel's arguments, its last slot left for the
// launch's Dims.  Counts the launches in *launches.
cudaError_t launch_heads(const Launch& L, Dims d, void** args, int nargs,
                         int* launches, cudaStream_t stream) {
  const int total = d.C * d.H, per = L.most / L.Gh;
  d.Gh = L.Gh;
  args[nargs - 1] = &d;
  *launches = 0;
  for (int first = 0; first < total; first += per) {
    d.head0 = first;
    const int nh = per < total - first ? per : total - first;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        L.fn, dim3(nh * L.Gh), dim3(THREADS), args, L.smem, stream);
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward of C cohorts.  gs, cs, ns, ms (the per-step pre-activations and
// states the backward takes) may be null: then nothing is saved.
// counters: C H zeros.  Writes the number of launches to *launches;
// returns the CUDA error of the launches (0 on success).
int slstm_scan_fwd(const float* g_in, const float* r, const float* b,
                   const float* c0, const float* n0, const float* m0,
                   const float* h0, float* hs, float* cf, float* nf,
                   float* mf, float* hf, float* gs, float* cs, float* ns,
                   float* ms, unsigned* counters, int C, int B, int S, int H,
                   int Dh, int* launches, cudaStream_t stream) {
  if (bad_shape(C, B, S, H, Dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d = dims(C, B, S, H, Dh);
  const size_t common =
      static_cast<size_t>(WARPS) * RB * PLD * sizeof(float);
  Launch L;
  cudaError_t err = choose(
      reinterpret_cast<const void*>(&slstm_fwd_kernel<true>),
      static_cast<size_t>(d.Dh16) * TC * sizeof(float) + common,
      reinterpret_cast<const void*>(&slstm_fwd_kernel<false>),
      static_cast<size_t>(FWD_SE) * TC * sizeof(float) + common, H, d.T, &L);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&g_in, &r,  &b,  &c0, &n0, &m0, &h0,       &hs,    &cf,
                  &nf,   &mf, &hf, &gs, &cs, &ns, &ms, &counters, nullptr};
  return static_cast<int>(launch_heads(L, d, args, 18, launches, stream));
}

// Backward of C cohorts.  dhs (C, B, S, H, Dh) and dc, dn, dm, dh
// (C, B, H, Dh) are the cotangents of hs and of the final states; writes
// dg (C, B, S, 4, H, Dh) and dc0, dn0, dm0, dh0 (C, B, H, Dh).  scratch:
// (2, C H, ceil(Dh / 16), B, Dh); counters: C H zeros.  Writes the number
// of launches to *launches; returns the CUDA error of the launches.
int slstm_scan_bwd(const float* gs, const float* cs, const float* ns,
                   const float* ms, const float* r, const float* c0,
                   const float* n0, const float* m0, const float* dhs,
                   const float* dc, const float* dn, const float* dm,
                   const float* dh, float* dg, float* dc0, float* dn0,
                   float* dm0, float* dh0, float* scratch,
                   unsigned* counters, int C, int B, int S, int H, int Dh,
                   int* launches, cudaStream_t stream) {
  if (bad_shape(C, B, S, H, Dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d = dims(C, B, S, H, Dh);
  const size_t dg_smem = static_cast<size_t>(RB) * GLD * sizeof(float);
  Launch L;
  cudaError_t err = choose(
      reinterpret_cast<const void*>(&slstm_bwd_kernel<true>),
      static_cast<size_t>(TC) * d.Dh64 * sizeof(float) + dg_smem,
      reinterpret_cast<const void*>(&slstm_bwd_kernel<false>),
      static_cast<size_t>(TC) * BWD_SE * sizeof(float) + dg_smem, H, d.T,
      &L);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&gs,  &cs,  &ns,  &ms,  &r,  &c0,      &n0,
                  &m0,  &dhs, &dc,  &dn,  &dm, &dh,      &dg,
                  &dc0, &dn0, &dm0, &dh0, &scratch, &counters, nullptr};
  return static_cast<int>(launch_heads(L, d, args, 21, launches, stream));
}

}  // extern "C"
