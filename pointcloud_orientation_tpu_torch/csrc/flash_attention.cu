// Flash attention for Hopper (sm_90a): the forward, dK/dV and dQ kernels,
// f32 and bf16.
//
// Replaces the three Pallas TPU kernels behind the point transformer's
// attention_impl="flash" (pointcloud_orientation_tpu/models/
// point_transformer.py:24 _flash_attention_fn, which calls
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention):
//   forward  _flash_attention_impl            (flash_attention.py:589, pallas_call :758)
//   dK/dV    _flash_attention_bwd_dkv         (:941, pallas_call :1121, body :796)
//   dQ       _flash_attention_bwd_dq          (:1287, pallas_call :1456, body :1146)
// No mask, no bias, not causal; q, k, v (B, H, N, D) contiguous, N a
// multiple of 128.
//
// Arithmetic, as the library's: s = (q . k in f32) * sm_scale, the scale
// after the product. The forward keeps the library's online softmax over
// tiles of 128 keys: per tile m_next = max(m, max_j s_j), p_j = exp(s_j -
// m_next), l_next = sum_j p_j + exp(m - m_next) * l, and the accumulator
// kept normalised, acc = acc * (l_corr / l_next) + (sum_j p_j v_j) / l_next,
// with p rounded to v's type before p.v; it writes o (q's type) and the row
// statistics l and m (f32). The backward recomputes p = exp(s - m) * (1/l);
// dv += p.dO (p rounded to dO's type), dp = dO . v, ds = (dp - di) * p *
// sm_scale, dk += ds.q and dq += ds.k (ds rounded to the operands' type),
// with di = sum(o * dO) computed outside (ops/flash_attention.py), as the
// library computes it outside its kernels. bf16 operands enter every product
// exactly (bf16 products summed in f32), p and ds are rounded to bf16 as the
// library rounds them. The plain PyTorch versions (ops/flash_attention.py)
// follow the same steps; the kernels differ from them in the order of the
// f32 sums, in FMA contraction, in the tensor cores' f32 accumulation and
// in exp, taken as ex2.approx of x * log2(e), a few f32 ulps from expf; so
// they are held by a tolerance.
//
// Bound on this card: a (query, key) pair costs 2D multiply-adds a product
// (two products in the forward, four in dK/dV, three in dQ), a few f32
// operations and one exponential. At D = 16 the products take less time on
// the tensor cores than the exponentials on the special function units (16
// a clock an SM), so the bound is the exponentials and the elementwise work
// (chip_smoke.py flash_cost); the bytes are a few MB.
//
// All three kernels run their products on the tensor cores (mma.sync,
// csrc/mma_sync.cuh), so that a pair's issue slots go to its
// exponential and its few elementwise operations. bf16 as m16n8k16 with f32
// accumulation on bf16 tiles; f32 as 3xTF32 m16n8k8 (x = hi + lo, the
// product lo*hi + hi*lo + hi*hi, about f32's precision). A block is 4 warps
// and owns 64 rows, 16 a warp (query rows in the forward and dQ, key rows
// in dK/dV); its 16 rows' own operands stay in registers as A fragments for
// the whole kernel. The other side is staged 128 rows a tile in its own type by
// 16-byte cp.async, double-buffered: tile t + 1 is in flight while tile t
// computes. Row strides are padded so that the fragment loads (ldmatrix for
// bf16, 32-bit loads for f32) hit distinct banks.
// - Forward: S = Q K^T for the warp's 16 x 128 block of a key tile (64 f32
//   registers a thread), each score once; the row maximum over the thread's
//   values, then over the quad of lanes that shares a row; p = exp(s -
//   m_next) in place; p.v with p as the A operand straight from the score
//   registers (bf16: two 8-key C tiles packed into one k16 A fragment; V
//   read by ldmatrix.trans). The online softmax step per 128-key tile, as
//   the library's.
// - dK/dV: the staged query tile computed as two halves of 64 queries:
//   S^T = K Q^T and dP^T = V dO^T (32 registers each), P^T = exp(S^T scale -
//   m_q) / l_q and dS^T = (dP^T - di_q) P^T scale in place, dV += round(P^T)
//   dO and dK += round(dS^T) Q with P^T and dS^T as A operands from
//   registers. 1/l, m and di of a query tile are loaded into registers while
//   the tile before it computes and written to their stage (1/l taken once
//   a query) before the barrier that ends that tile.
// - dQ: dK/dV turned around. The warp's q and dO rows are its A fragments,
//   m, 1/l and di of its two rows (g, g + 8) stay in each thread's
//   registers, and K and V are staged as the forward stages them. Each key
//   tile runs as two passes of 64 keys: S = Q K^T and dP = dO V^T (32
//   registers each), P = exp(S scale - m) / l and dS = (dP - di) P scale in
//   place, and dQ += round(dS) K with dS as the A operand from registers
//   and K read as the forward reads V.
// Each pass's products of a backward kernel go into zeroed registers and
// are then added to the f32 sums: the tensor cores' own accumulation
// truncates, and chained over all N rows it put f32 dK and dV about 1e-4
// (relative to their largest value) off the plain version at N = 16,384.
// f32 A fragments from C fragments: the TF32 A layout (columns t and t + 4)
// is not the C layout (columns 2t and 2t + 1). Rather than repack within
// the quad (shuffles) or through shared memory, the contraction is
// relabelled: in each 8-wide step, A column t holds C column 2t and column
// t + 4 holds 2t + 1, and the B rows are read in the same order (rows 2t
// and 2t + 1); a sum does not depend on how its terms are numbered, so the
// A fragment is the C fragment's registers reordered, with no data moved.
// No atomics: each output row is summed by one warp in a fixed order, so
// every run gives the same bits.
//
// Head dimensions 8, 16 and 32 (D = 8 fills the upper half of bf16's k16
// step with zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

using namespace pcot;

constexpr int kTile = 128;            // rows a staged tile holds
constexpr int kThreads = 128;         // 4 warps a block
constexpr int kRows = kThreads / 2;  // rows a block owns, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kThreads, "a thread a row of a staged tile (its statistics, its copies)");

// e^x as ex2.approx of x * log2(e) (subnormal results flush to zero)
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// over the four lanes of a quad, which share the rows of a C fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's products on its 16 rows, by element type:
//   load_a  the warp's 16 rows of a (N, D) row-major matrix in device memory
//           as A fragments (q in the forward; k and v in dK/dV);
//   mul_bt  c[nt] += a . b^T over NT tiles of 8 rows of b, b row-major in
//           shared memory (s = q k^T; s^T = k q^T and dp^T = v dO^T);
//   mul_b   c += round(p) . b, p the C fragments of a 16 x 8NT product, used
//           as the A operand from their registers, round to the element type,
//           b (8NT, D) row-major in shared memory (p.v; p^T.dO and ds^T.q).
template <typename T, int D>
struct Mma;

// bf16: m16n8k16, f32 accumulation. A staged row is D + 8 elements apart
// (D = 8: 8, 16 bytes), so the 8 rows an ldmatrix reads fall in distinct
// 16-byte bank groups. D = 8: the upper half of the k16 step is zero.
template <int D>
struct Mma<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static constexpr int kStride = D == 8 ? 8 : D + 8;
  static constexpr int kSteps = (D + 15) / 16;  // k16 steps over the head dimension
  struct A {
    unsigned r[kSteps][4];
  };

  static __device__ __forceinline__ void load_a(A& a, const T* __restrict__ src, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const unsigned* r0 = reinterpret_cast<const unsigned*>(src + g * D + 16 * ks + 2 * t);
      const unsigned* r8 = r0 + 4 * D;  // row g + 8
      a.r[ks][0] = __ldg(r0);
      a.r[ks][1] = __ldg(r8);
      a.r[ks][2] = D > 8 ? __ldg(r0 + 4) : 0u;  // columns 2t + 8, 2t + 9
      a.r[ks][3] = D > 8 ? __ldg(r8 + 4) : 0u;
    }
  }

  template <int NT>
  static __device__ __forceinline__ void mul_bt(float (&c)[NT][4], const A& a, const T* b,
                                                int lane) {
    if constexpr (D == 8) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 4) {  // matrix j: rows 8 (nt + j) .. + 7
        unsigned r[4];
        ldmatrix_x4(r, b + (8 * nt + lane) * kStride);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(c[nt + j], a.r[0], r[j], 0u);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          // matrices: (tile nt, k low), (nt, k high), (nt + 1, low), (nt + 1, high)
          unsigned r[4];
          ldmatrix_x4(r, b + (8 * (nt + (lane >> 4)) + (lane & 7)) * kStride + 16 * ks +
                             8 * ((lane >> 3) & 1));
          mma_bf16(c[nt], a.r[ks], r[0], r[1]);
          mma_bf16(c[nt + 1], a.r[ks], r[2], r[3]);
        }
    }
  }

  template <int NT>
  static __device__ __forceinline__ void mul_b(float (&c)[D / 8][4], const float (&p)[NT][4],
                                               const T* b, int lane) {
    unsigned r8[4];  // D = 8: b0, b1 of two k16 steps
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {  // k16 step j: columns 16j .. 16j + 15 of p
      const unsigned a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      if constexpr (D == 8) {
        if ((j & 1) == 0) ldmatrix_x4_trans(r8, b + (16 * j + lane) * kStride);
        mma_bf16(c[0], a, r8[2 * (j & 1)], r8[2 * (j & 1) + 1]);
      } else {
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          // matrices: (rows 16j .. + 7, tile dt), (16j + 8 .., dt), (16j .., dt + 1), (16j + 8 .., dt + 1)
          unsigned r[4];
          ldmatrix_x4_trans(r, b + (16 * j + 8 * ((lane >> 3) & 1) + (lane & 7)) * kStride +
                                   8 * (dt + (lane >> 4)));
          mma_bf16(c[dt], a, r[0], r[1]);
          mma_bf16(c[dt + 1], a, r[2], r[3]);
        }
      }
    }
  }
};

// f32: 3xTF32 m16n8k8 into the f32 accumulator. A staged row is D + 4 floats
// apart, so a warp's 32-bit fragment loads hit 32 distinct banks. mul_b's A
// fragment is the C fragment relabelled (the note at the top): in k step j,
// A (row, t) = p (row, 8j + 2t), A (row, t + 4) = p (row, 8j + 2t + 1), and
// B rows t and t + 4 are rows 8j + 2t and 8j + 2t + 1 of b.
template <int D>
struct Mma<float, D> {
  using T = float;
  static constexpr int kStride = D + 4;
  static constexpr int kSteps = D / 8;  // k8 steps over the head dimension
  struct A {
    unsigned hi[kSteps][4], lo[kSteps][4];
  };

  static __device__ __forceinline__ void load_a(A& a, const float* __restrict__ src, int lane) {
    const float* r0 = src + (lane >> 2) * D + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const float x[4] = {__ldg(r0 + 8 * ks), __ldg(r0 + 8 * D + 8 * ks), __ldg(r0 + 8 * ks + 4),
                          __ldg(r0 + 8 * D + 8 * ks + 4)};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(x[i]), a.hi[ks][i], a.lo[ks][i]);
    }
  }

  static __device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ahi)[4],
                                              const unsigned (&alo)[4], float b0, float b1) {
    unsigned h0, l0, h1, l1;
    split_tf32(__float_as_uint(b0), h0, l0);
    split_tf32(__float_as_uint(b1), h1, l1);
    mma_tf32(c, alo, h0, h1);
    mma_tf32(c, ahi, l0, l1);
    mma_tf32(c, ahi, h0, h1);
  }

  template <int NT>
  static __device__ __forceinline__ void mul_bt(float (&c)[NT][4], const A& a, const float* b,
                                                int lane) {
    const float* bl = b + (lane >> 2) * kStride + (lane & 3);  // (row g, column t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const float* r = bl + 8 * nt * kStride + 8 * ks;
        mma3(c[nt], a.hi[ks], a.lo[ks], r[0], r[4]);
      }
  }

  template <int NT>
  static __device__ __forceinline__ void mul_b(float (&c)[D / 8][4], const float (&p)[NT][4],
                                               const float* b, int lane) {
    const float* bl = b + 2 * (lane & 3) * kStride + (lane >> 2);  // (row 2t, column g)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float x[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(x[i]), ahi[i], alo[i]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float* r = bl + 8 * j * kStride + 8 * dt;
        mma3(c[dt], ahi, alo, r[0], r[kStride]);
      }
    }
  }
};

// rows [0, kTile) of a (N, D) row-major matrix into shared memory rows
// kStride elements apart, by 16-byte cp.async from kThreads threads
template <typename T, int D, int kStride>
__device__ __forceinline__ void stage_async(T* __restrict__ dst, const T* __restrict__ src) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kCopies = D / kPer;     // copies a row
#pragma unroll
  for (int i = 0; i < kTile * kCopies / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kCopies, e = (c % kCopies) * kPer;
    cp_async16(dst + r * kStride + e, src + r * D + e);
  }
}

// K and V rows [0, kTile) from k and v into their stages, one commit group
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* sk, T* sv, const T* k, const T* v) {
  stage_async<T, D, Mma<T, D>::kStride>(sk, k);
  stage_async<T, D, Mma<T, D>::kStride>(sv, v);
  cp_async_commit();
}

// the forward's and dQ's double buffer: the next K/V tile (from element
// offset next, when there is one) put in flight into the other stages,
// then the current tile waited for and seen by every warp
template <typename T, int D>
__device__ __forceinline__ void kv_tile_ready(T* sk_other, T* sv_other, const T* k, const T* v,
                                              size_t next, bool has_next) {
  if (has_next) {
    stage_kv<T, D>(sk_other, sv_other, k + next, v + next);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

template <typename T, int D>
constexpr size_t kv_smem_bytes() {
  return 4 * kTile * Mma<T, D>::kStride * sizeof(T);  // K and V (dK/dV: Q and dO), two stages each
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return kv_smem_bytes<T, D>() + 2 * 3 * kTile * sizeof(float);  // Q, dO; 1/l, m, di
}

// grid (N / kRows, H, B); warp = 16 query rows; loops over the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int N,
                 float scale) {
  using M = Mma<T, D>;
  constexpr int kElems = kTile * M::kStride;  // a staged tile
  constexpr int NT = kTile / 8;               // 8-key tiles of a warp's scores
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);  // [2][kElems]
  T* sv = sk + 2 * kElems;             // [2][kElems]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  typename M::A qa;
  M::load_a(qa, q + base + (size_t)row0 * D, lane);
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const int tiles = N / kTile;
  stage_kv<T, D>(sk, sv, k + base, v + base);
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    kv_tile_ready<T, D>(sk + (cur ^ 1) * kElems, sv + (cur ^ 1) * kElems, k, v,
                        base + (size_t)(it + 1) * kTile * D, it + 1 < tiles);
    float s[NT][4] = {};
    M::template mul_bt<NT>(s, qa, sk + cur * kElems, lane);
    float m_next[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = __fmul_rn(s[nt][i], scale);
        m_next[i >> 1] = fmaxf(m_next[i >> 1], s[nt][i]);
      }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_next[r] = fmaxf(m[r], quad_max(m_next[r]));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp_approx(s[nt][i] - m_next[i >> 1]);
        psum[i >> 1] += s[nt][i];
      }
    float pv[D / 8][4] = {};
    M::template mul_b<NT>(pv, s, sv + cur * kElems, lane);
    float keep[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_corr = exp_approx(m[r] - m_next[r]) * l[r];
      const float l_next = quad_sum(psum[r]) + l_corr;
      inv[r] = l_next == 0.f ? 1.f : 1.f / l_next;
      keep[r] = l_corr * inv[r];
      m[r] = m_next[r];
      l[r] = l_next;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] = acc[dt][i] * keep[i >> 1] + pv[dt][i] * inv[i >> 1];
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(o + base + (size_t)row * D + 8 * dt + 2 * t, acc[dt][2 * r], acc[dt][2 * r + 1]);
    if (t == 0) {
      l_out[bh * N + row] = l[r];
      m_out[bh * N + row] = m[r];
    }
  }
}

// grid (N / kRows, H, B); warp = 16 key rows; loops over the query tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ l, const float* __restrict__ m,
                     const T* __restrict__ dout, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int N, float scale) {
  using M = Mma<T, D>;
  constexpr int kElems = kTile * M::kStride;
  constexpr int kHalf = kTile / 2;  // queries a pass
  constexpr int NT = kHalf / 8;     // 8-query tiles of a warp's pass
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);                              // [2][kElems]
  T* sdo = sq + 2 * kElems;                                        // [2][kElems]
  float* stat = reinterpret_cast<float*>(sdo + 2 * kElems);        // [2][3][kTile]: 1/l, m, di
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const float* lr = l + bh * N;
  const float* mr = m + bh * N;
  const float* dr = di + bh * N;
  const int row0 = blockIdx.x * kRows + (tid >> 5) * 16;
  typename M::A ka, va;
  M::load_a(ka, k + base + (size_t)row0 * D, lane);
  M::load_a(va, v + base + (size_t)row0 * D, lane);
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  const int tiles = N / kTile;
  stage_async<T, D, M::kStride>(sq, q + base);
  stage_async<T, D, M::kStride>(sdo, dout + base);
  cp_async_commit();
  stat[tid] = 1.f / lr[tid];  // a thread a query of the tile
  stat[kTile + tid] = mr[tid];
  stat[2 * kTile + tid] = dr[tid];
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    float nl = 1.f, nm = 0.f, nd = 0.f;  // the next tile's statistics
    if (it + 1 < tiles) {
      const int next = (it + 1) * kTile;
      stage_async<T, D, M::kStride>(sq + (cur ^ 1) * kElems, q + base + (size_t)next * D);
      stage_async<T, D, M::kStride>(sdo + (cur ^ 1) * kElems, dout + base + (size_t)next * D);
      cp_async_commit();
      nl = lr[next + tid];
      nm = mr[next + tid];
      nd = dr[next + tid];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = stat + cur * 3 * kTile;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const T* qs = sq + cur * kElems + h * kHalf * M::kStride;
      const T* dos = sdo + cur * kElems + h * kHalf * M::kStride;
      float s[NT][4] = {}, dp[NT][4] = {};  // rows: the warp's keys; columns: the pass's queries
      M::template mul_bt<NT>(s, ka, qs, lane);
      M::template mul_bt<NT>(dp, va, dos, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = h * kHalf + 8 * nt + 2 * t;
        const float2 il = *reinterpret_cast<const float2*>(st + c);
        const float2 mq = *reinterpret_cast<const float2*>(st + kTile + c);
        const float2 dq = *reinterpret_cast<const float2*>(st + 2 * kTile + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool odd = i & 1;  // column 2t + 1
          const float p =
              exp_approx(__fmul_rn(s[nt][i], scale) - (odd ? mq.y : mq.x)) * (odd ? il.y : il.x);
          dp[nt][i] = (dp[nt][i] - (odd ? dq.y : dq.x)) * p * scale;
          s[nt][i] = p;
        }
      }
      // each pass's products in zeroed registers, then added to the f32 sums
      // (the note at the top)
      float dvp[D / 8][4] = {}, dkp[D / 8][4] = {};
      M::template mul_b<NT>(dvp, s, dos, lane);
      M::template mul_b<NT>(dkp, dp, qs, lane);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[dt][i] += dvp[dt][i];
          dka[dt][i] += dkp[dt][i];
        }
    }
    if (it + 1 < tiles) {  // this stage's statistics were last read before the last barrier
      float* sn = stat + (cur ^ 1) * 3 * kTile;
      sn[tid] = 1.f / nl;
      sn[kTile + tid] = nm;
      sn[2 * kTile + tid] = nd;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = base + (size_t)(row0 + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      store2(dk + off + 8 * dt, dka[dt][2 * r], dka[dt][2 * r + 1]);
      store2(dv + off + 8 * dt, dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
  }
}

// grid (N / kRows, H, B); warp = 16 query rows; loops over the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ l, const float* __restrict__ m,
                    const T* __restrict__ dout, const float* __restrict__ di,
                    T* __restrict__ dq, int N, float scale) {
  using M = Mma<T, D>;
  constexpr int kElems = kTile * M::kStride;
  constexpr int kHalf = kTile / 2;  // keys a pass
  constexpr int NT = kHalf / 8;     // 8-key tiles of a warp's pass
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);  // [2][kElems]
  T* sv = sk + 2 * kElems;             // [2][kElems]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16;
  typename M::A qa, da;
  M::load_a(qa, q + base + (size_t)row0 * D, lane);
  M::load_a(da, dout + base + (size_t)row0 * D, lane);
  float mq[2], il[2], dr[2];  // rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = bh * N + row0 + g + 8 * r;
    mq[r] = m[i];
    il[r] = 1.f / l[i];
    dr[r] = di[i];
  }
  float dqa[D / 8][4] = {};
  const int tiles = N / kTile;
  stage_kv<T, D>(sk, sv, k + base, v + base);
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    kv_tile_ready<T, D>(sk + (cur ^ 1) * kElems, sv + (cur ^ 1) * kElems, k, v,
                        base + (size_t)(it + 1) * kTile * D, it + 1 < tiles);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const T* ks = sk + cur * kElems + h * kHalf * M::kStride;
      const T* vs = sv + cur * kElems + h * kHalf * M::kStride;
      float s[NT][4] = {}, dp[NT][4] = {};  // rows: the warp's queries; columns: the pass's keys
      M::template mul_bt<NT>(s, qa, ks, lane);
      M::template mul_bt<NT>(dp, da, vs, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;  // row g or g + 8
          const float p = exp_approx(__fmul_rn(s[nt][i], scale) - mq[r]) * il[r];
          dp[nt][i] = (dp[nt][i] - dr[r]) * p * scale;
        }
      // the pass's product in zeroed registers, then added to the f32 sums
      float dqp[D / 8][4] = {};
      M::template mul_b<NT>(dqp, dp, ks, lane);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[dt][i] += dqp[dt][i];
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = base + (size_t)(row0 + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(dq + off + 8 * dt, dqa[dt][2 * r], dqa[dt][2 * r + 1]);
  }
}

bool takes(int B, int H, int N, int D) {
  return B >= 1 && H >= 1 && B <= 65535 && H <= 65535 && N >= kTile && N % kTile == 0 &&
         (D == 8 || D == 16 || D == 32);
}

// a kernel's dynamic shared memory above the default 48 KB needs the opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// LAUNCH(T, D) for the (type, head dimension) pair of the arguments
#define PCOT_FLASH_DISPATCH(D, BF16, LAUNCH)                   \
  do {                                                         \
    if (BF16) {                                                \
      if ((D) == 8) { LAUNCH(__nv_bfloat16, 8); }              \
      else if ((D) == 16) { LAUNCH(__nv_bfloat16, 16); }       \
      else { LAUNCH(__nv_bfloat16, 32); }                      \
    } else {                                                   \
      if ((D) == 8) { LAUNCH(float, 8); }                      \
      else if ((D) == 16) { LAUNCH(float, 16); }               \
      else { LAUNCH(float, 32); }                              \
    }                                                          \
  } while (0)

}  // namespace

// q, k, v (B,H,N,D) f32 or bf16 (bf16 != 0) -> o (B,H,N,D) of the same type,
// l, m (B,H,N) f32. Returns cudaErrorInvalidValue for arguments the kernels
// do not take (N not a positive multiple of 128, D not 8, 16 or 32), else
// cudaGetLastError() after the launch.
extern "C" int pcot_flash_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                              void* m, int B, int H, int N, int D, int bf16, float scale,
                              void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kRows, H, B);
#define PCOT_FLASH_FWD(T, DD)                                                          \
  {                                                                                    \
    constexpr size_t smem = kv_smem_bytes<T, DD>();                                   \
    const cudaError_t e = allow_smem(flash_fwd_kernel<T, DD>, smem);                   \
    if (e != cudaSuccess) return (int)e;                                               \
    flash_fwd_kernel<T, DD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(            \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)l, (float*)m, N, scale); \
  }
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_FWD);
#undef PCOT_FLASH_FWD
  return (int)cudaGetLastError();
}

// the same q, k, v, the forward's l, m, dout (B,H,N,D) and di = sum(o * dout)
// (B,H,N) f32 -> dk, dv (B,H,N,D) of q's type
extern "C" int pcot_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* l,
                                  const void* m, const void* dout, const void* di, void* dk,
                                  void* dv, int B, int H, int N, int D, int bf16, float scale,
                                  void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kRows, H, B);
#define PCOT_FLASH_DKV(T, DD)                                                          \
  {                                                                                    \
    constexpr size_t smem = dkv_smem_bytes<T, DD>();                                   \
    const cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DD>, smem);               \
    if (e != cudaSuccess) return (int)e;                                               \
    flash_bwd_dkv_kernel<T, DD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(        \
        (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,       \
        (const T*)dout, (const float*)di, (T*)dk, (T*)dv, N, scale);                   \
  }
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_DKV);
#undef PCOT_FLASH_DKV
  return (int)cudaGetLastError();
}

// the same inputs -> dq (B,H,N,D) of q's type
extern "C" int pcot_flash_bwd_dq(const void* q, const void* k, const void* v, const void* l,
                                 const void* m, const void* dout, const void* di, void* dq,
                                 int B, int H, int N, int D, int bf16, float scale,
                                 void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kRows, H, B);
#define PCOT_FLASH_DQ(T, DD)                                                           \
  {                                                                                    \
    constexpr size_t smem = kv_smem_bytes<T, DD>();                                    \
    const cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DD>, smem);                \
    if (e != cudaSuccess) return (int)e;                                               \
    flash_bwd_dq_kernel<T, DD><<<grid, kThreads, smem, (cudaStream_t)stream>>>(         \
        (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,       \
        (const T*)dout, (const float*)di, (T*)dq, N, scale);                           \
  }
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_DQ);
#undef PCOT_FLASH_DQ
  return (int)cudaGetLastError();
}
