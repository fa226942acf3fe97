// Recompute backward of the fused shared MLP + neighbour max-pool for
// Hopper (sm_90a) on the tensor cores, f32 (as 3xTF32) and bf16.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// _sa_mlp_max_bwd_impl / _sa_mlp_max_bwd_kernel (the VJP of
// sa_mlp_max_pallas), both its f32 (HIGHEST) variant and its bf16=True
// variant.
//
// Inputs: grouped (B,K,S,C0) neighbour-major, L <= 4 layers (W (Cin,Cout),
// scale, shift) with y = (x @ W) * scale + shift, a = relu(y), and the
// pooled cotangent dpooled (B,S,C_L). Outputs: dgrouped (B,K,S,C0), unless
// the caller passes NULL for it, and every layer's dW (Cin,Cout), dscale
// and dshift (Cout,), summed here.
//
// Semantics, as the TPU kernel: the forward is recomputed here, and the
// max-pool's cotangent is split evenly over the neighbours equal to the
// RECOMPUTED maximum (so a centroid always has at least one), then per layer
// from the last: dy = da * (y > 0); dscale = sum(dy * z) with z = x @ W;
// dshift = sum(dy); dz = dy * scale; dW = x^T dz; da_in = dz W^T.
//
// Products. bf16: mma.sync m16n8k16 with f32 accumulation, both operands
// rounded to bf16 to nearest even, as the TPU kernel's bf16 `mm`. f32:
// mma.sync m16n8k8 tf32 on operands split as hi = rna(x), lo = rna(x - hi)
// and taken as lo*hi + hi*lo + hi*hi (3xTF32), as csrc/sa_mlp_max.cu does
// for the forward. Every MMA step starts from a zeroed accumulator and is
// added to the running f32 sum by a CUDA-core add rounded to nearest. With
// the tensor cores' own accumulation chained over a contraction's up to 32
// steps instead (chip_sweep.py, PERF.md), the f32 kernel lay 5.6x further
// from a float64 product than an f32 product at sa1, and at sa2 and sa3
// 0.25 and 0.009 of the output's scale from it through flipped max
// decisions (the f32 product 0.028 and 4e-7; with the adds 4e-7 and 3e-7);
// a fused bf16 train step's sa3 call lay over the 1% check from the plain
// version in 4 of 12 sampled steps (up to 4.2%), against 1 of 12 (1.2%)
// with the adds. The adds cost 5-14% of the f32 time and at most 1% of the
// bf16 time.
//
// Bound on this card. Products: 6 * rows * sum(Cin * Cout) (recompute, dW,
// da): 4.9 GFLOP at sa1 and 6.5 at sa2 for B=16 (rows = B*K*S = 65,536 and
// 16,384), 0.033 and 0.041 ms as 3xTF32 at 495/3 TFLOP/s. Bytes: the inputs
// and outputs are a few MB, but the products need every layer's activations
// of all rows, and where they live decides the traffic:
// - through device memory (this design): z of every layer written once,
//   read by the next layer's recompute, by dW and by da, its dz written once
//   over it and read twice, the dW partials written and read once: about
//   0.41 GB a call at sa1 (0.12 ms at 3.35 TB/s, nearly four times the
//   products' bound) and 0.25 GB at sa2;
// - on chip, a tile of centroids with all K rows and every layer kept in
//   shared memory as the TPU kernel keeps a cloud in VMEM: a few MB (grouped
//   in, dW partials out), but at sa2 a 64-row tile's layers (128 + 128 + 256
//   channels, f32) and its dz fill the 227 KB a block has, and sa3's
//   1,792 channels a row do not fit at all. Not built; the candidate for sa1.
//
// Design. The only activation scratch is z of every layer (rows x sum Cout
// floats, 67 MB at sa1), from which y, the mask and a = relu(z*s + t)
// follow by the same f32 operations wherever they are needed (mul, then
// add, no FMA, as the plain version). One tiled GEMM kernel computes all
// three products: a 64 x 64 tile a block of 4 warps (32 x 32 each, 2 x 4
// MMA tiles), 32 input channels a stage, register-prefetched double buffer
// in shared memory. Operands are staged as 32-bit words (f32, or a bf16
// pair along the contraction), row-major or contraction-major as they lie in
// device memory, with padded strides so every fragment is one
// conflict-free 32-bit shared load; the transposed operand of dW = x^T dz
// (x read contraction-major) needs no transpose. Ragged widths (c0 = 3,
// 131, 259) and row edges are zero-filled as they are staged. Folded into
// the staging and epilogues:
// - the recompute's input a = relu(z*s + t) of the layer before (A's
//   prologue), so relu(y) is never stored;
// - BatchNorm's backward into the epilogue of the da product that feeds a
//   layer: it reads z of its tile, applies the mask and scale, writes dz over
//   z in place, and writes per-tile column partials of dy*z and dy;
// - the last layer's max/tie split, mask and scale in one pass over z_L that
//   writes dz_L in place and its column partials.
// dW is split over chunks of rows (split-K, the chunk from the caller) into
// partials. One last kernel sums every partial (dW, dscale, dshift of every
// layer) in a fixed order. Per layer from the last, dW (which reads z of the
// layer before as its x) runs before the da product overwrites that z with
// its dz. No float atomics: every sum runs in a fixed order, so two launches
// give the same bits. Launches: 3L + 1 products and passes plus one
// reduction (10 at sa1, 11 with the input gradient).
//
// What holds it back (measured on the H100, PERF.md): at sa1 and sa2 the
// device-memory round trips above (0.25-0.28 ms f32 against a 0.12 ms byte
// floor at sa1); at sa3 (512 rows) the launches and grids of 32-128 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 warp tiles of 32 x 32
constexpr int kBM = 64, kBN = 64;
constexpr int kBKE = 32;       // contraction elements a stage
constexpr int kLdRow = 32 + 4; // words a row of a row-major (contraction-contiguous) tile
constexpr int kLdK = 64 + 8;   // words a contraction row of a contraction-major tile
constexpr int kStageWords = 64 * kLdRow;  // >= kBKE * kLdK: the larger of the two layouts
constexpr int kMaxLayers = 4;
constexpr int kRedThreads = 1024;
constexpr int kTiesWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum { kStore = 0, kBnBwd = 1 };

// tf32_rna, split_tf32, mma_tf32, mma_bf16, pack_bf16
using namespace pcot;

// y = z * s + t as the plain version computes it: two roundings, no FMA
__device__ __forceinline__ float affine(float z, float s, float t) {
  return __fadd_rn(__fmul_rn(z, s), t);
}

// One operand of a product as it lies in device memory: element (r, k), r
// the output row (A) or column (B), k the contraction index, at
// p[r * ld + k] (k_contig) or p[k * ld + r]. Batch z starts at p + z * batch.
// With s (A only), each element enters as relu(v * s[c] + t[c]), c its
// index along the contiguous dimension (the layer's channel).
struct Operand {
  const float* p;
  long ld, batch;
  const float* s;
  const float* t;
  int vec;  // 16-byte loads along the contiguous dimension
};

struct Gemm {
  Operand a, b;
  float* c;
  long ldc, c_batch;
  int M, N, K;     // K: the contraction length of one batch
  long k_total;    // batch z contracts min(K, k_total - z * K)
  int c_vec;       // 8-byte stores of output pairs
  // kBnBwd: the layer's scale and shift, and its column partials (one row
  // of N a row tile, blockIdx.x) of dy * z and dy
  const float* es;
  const float* et;
  float* ps;
  float* pt;
};

// 4 consecutive elements along the contiguous dimension from index c of a
// row whose valid extent is lim (16 bytes at once where allowed)
__device__ __forceinline__ void load4(float (&v)[4], const float* row, int c, int lim, bool vec) {
  if (vec && c + 3 < lim) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < lim ? __ldg(row + c + j) : 0.f;
}

// The 16 elements of a stage this thread stages for one operand. k_contig:
// 64 rows x 8 quads of contraction; quad e = tid + 128 i is row e >> 3,
// contraction 4 * (e & 7). Contraction-major: 32 contraction rows x 16
// quads; item i is contraction row 2 * ((tid >> 4) + 8 * (i >> 1)) + (i & 1)
// and quad tid & 15, so that a thread holds both rows of each bf16 pair.
template <bool KC>
__device__ __forceinline__ void item(int tid, int i, int& r, int& k) {
  if (KC) {
    const int e = tid + kThreads * i;
    r = e >> 3;
    k = 4 * (e & 7);
  } else {
    k = 2 * ((tid >> 4) + 8 * (i >> 1)) + (i & 1);
    r = 4 * (tid & 15);
  }
}

// Load a stage of an operand into registers: rows from r0 (R valid), the
// contraction from k0 (Kz valid). Elements outside are 0; the prologue is
// applied when the values are stored.
template <bool KC>
__device__ __forceinline__ void load_stage(float (&v)[4][4], const Operand& o, const float* base,
                                           int r0, int R, int k0, int Kz, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, k;
    item<KC>(tid, i, r, k);
    if (KC) {
      if (r0 + r < R)
        load4(v[i], base + (size_t)(r0 + r) * o.ld, k0 + k, Kz, o.vec);
      else
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    } else {
      if (k0 + k < Kz)
        load4(v[i], base + (size_t)(k0 + k) * o.ld, r0 + r, R, o.vec);
      else
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    }
  }
}

// Store a loaded stage into shared memory as words: f32 values, or bf16
// pairs along the contraction. With the prologue, every element inside the
// operand becomes relu(v * s + t) by its channel (the contiguous index);
// elements outside stay 0.
template <bool KC, bool kBf16>
__device__ __forceinline__ void store_stage(unsigned* S, float (&v)[4][4], const Operand& o,
                                            int r0, int R, int k0, int Kz, int tid) {
  if (o.s) {  // every item of this thread has the same 4 channels
    int r, k;
    item<KC>(tid, 0, r, k);
    const int ch = KC ? k0 + k : r0 + r;
    const int lim = KC ? Kz : R;
    float sc[4], sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = ch + j < lim ? __ldg(o.s + ch + j) : 0.f;
      sh[j] = ch + j < lim ? __ldg(o.t + ch + j) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      item<KC>(tid, i, r, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = KC ? r0 + r < R && k0 + k + j < Kz : r0 + r + j < R && k0 + k < Kz;
        if (in) v[i][j] = fmaxf(affine(v[i][j], sc[j], sh[j]), 0.f);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, k;
    item<KC>(tid, i, r, k);
    if (KC) {
      if (kBf16) {
        *reinterpret_cast<uint2*>(S + r * (kLdRow - 16) + k / 2) =
            make_uint2(pack_bf16(v[i][0], v[i][1]), pack_bf16(v[i][2], v[i][3]));
      } else {
        *reinterpret_cast<float4*>(S + r * kLdRow + k) =
            make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    } else if (kBf16) {
      if (i & 1) continue;  // rows k and k + 1 together: items i and i + 1
      *reinterpret_cast<uint4*>(S + (k / 2) * kLdK + r) =
          make_uint4(pack_bf16(v[i][0], v[i + 1][0]), pack_bf16(v[i][1], v[i + 1][1]),
                     pack_bf16(v[i][2], v[i + 1][2]), pack_bf16(v[i][3], v[i + 1][3]));
    } else {
      *reinterpret_cast<float4*>(S + k * kLdK + r) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
}

// Add ksteps MMA depths (8 words each) of the stage to the warp's 32 x 32
// tile at (wm, wn). Fragment words: A (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B (t, g), (t+4, g) as (contraction word, column); the same
// positions for m16n8k8 tf32 and, a word being a bf16 pair, m16n8k16 bf16.
template <bool kBf16, bool AKC, bool BKC>
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4], const unsigned* As,
                                          const unsigned* Bs, int wm, int wn, int g, int t,
                                          int ksteps) {
  constexpr int lda = AKC ? (kBf16 ? kLdRow - 16 : kLdRow) : kLdK;
  constexpr int ldb = BKC ? (kBf16 ? kLdRow - 16 : kLdRow) : kLdK;
  constexpr int kMax = kBf16 ? 2 : 4;
#pragma unroll
  for (int ks = 0; ks < kMax; ++ks) {
    if (ks >= ksteps) break;
    const int kw = ks * 8 + t;
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
      if (AKC) {
        a[mt][0] = As[r * lda + kw];
        a[mt][1] = As[(r + 8) * lda + kw];
        a[mt][2] = As[r * lda + kw + 4];
        a[mt][3] = As[(r + 8) * lda + kw + 4];
      } else {
        a[mt][0] = As[kw * lda + r];
        a[mt][1] = As[kw * lda + r + 8];
        a[mt][2] = As[(kw + 4) * lda + r];
        a[mt][3] = As[(kw + 4) * lda + r + 8];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = wn + nt * 8 + g;
      if (BKC) {
        b[nt][0] = Bs[c * ldb + kw];
        b[nt][1] = Bs[c * ldb + kw + 4];
      } else {
        b[nt][0] = Bs[kw * ldb + c];
        b[nt][1] = Bs[(kw + 4) * ldb + c];
      }
    }
    // each tile's products of this step go into a zeroed accumulator and
    // reach the running sum through an f32 add rounded to nearest
    if (kBf16) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, a[mt], b[nt][0], b[nt][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
        }
    } else {
      unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[mt][i], ahi[mt][i], alo[mt][i]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) split_tf32(b[nt][i], bhi[nt][i], blo[nt][i]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {  // the small terms first
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, alo[mt], bhi[nt][0], bhi[nt][1]);
          mma_tf32(part, ahi[mt], blo[nt][0], blo[nt][1]);
          mma_tf32(part, ahi[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
        }
    }
  }
}

// C(m, n) = sum_k A(m, k) B(k, n) over one batch (blockIdx.z), a 64 x 64
// tile (blockIdx.x over M, blockIdx.y over N) a block.
template <bool kBf16, bool AKC, bool BKC, int EPI>
__global__ void __launch_bounds__(kThreads, 4) gemm_kernel(const Gemm g) {
  __shared__ __align__(16) unsigned As[2][kStageWords];
  __shared__ __align__(16) unsigned Bs[2][kStageWords];
  __shared__ float red[2][2][kBN];  // kBnBwd: the two row warps' column sums
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const int Kz = (int)min((long)g.K, g.k_total - (long)z * g.K);
  const float* abase = g.a.p + (size_t)z * g.a.batch;
  const float* bbase = g.b.p + (size_t)z * g.b.batch;
  const int n_st = (Kz + kBKE - 1) / kBKE;
  constexpr int kStepElems = kBf16 ? 16 : 8;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  float va[4][4], vb[4][4];
  load_stage<AKC>(va, g.a, abase, m0, g.M, 0, Kz, tid);
  load_stage<BKC>(vb, g.b, bbase, n0, g.N, 0, Kz, tid);
  store_stage<AKC, kBf16>(As[0], va, g.a, m0, g.M, 0, Kz, tid);
  store_stage<BKC, kBf16>(Bs[0], vb, g.b, n0, g.N, 0, Kz, tid);
  __syncthreads();
  for (int st = 0; st < n_st; ++st) {
    const int cur = st & 1;
    const int k1 = (st + 1) * kBKE;
    if (st + 1 < n_st) {  // the next stage's loads fly during this stage's products
      load_stage<AKC>(va, g.a, abase, m0, g.M, k1, Kz, tid);
      load_stage<BKC>(vb, g.b, bbase, n0, g.N, k1, Kz, tid);
    }
    const int left = Kz - st * kBKE;
    const int ksteps = left >= kBKE ? kBKE / kStepElems : (left + kStepElems - 1) / kStepElems;
    mma_stage<kBf16, AKC, BKC>(acc, As[cur], Bs[cur], wm, wn, gi, ti, ksteps);
    if (st + 1 < n_st) {
      store_stage<AKC, kBf16>(As[cur ^ 1], va, g.a, m0, g.M, k1, Kz, tid);
      store_stage<BKC, kBf16>(Bs[cur ^ 1], vb, g.b, n0, g.N, k1, Kz, tid);
    }
    __syncthreads();
  }

  float* C = g.c + (size_t)z * g.c_batch;
  if (EPI == kStore) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + gi + 8 * h;
        if (m >= g.M) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn + nt * 8 + 2 * ti;
          float* o = C + (size_t)m * g.ldc + n;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (g.c_vec && n + 1 < g.N) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (n < g.N) o[0] = v0;
            if (n + 1 < g.N) o[1] = v1;
          }
        }
      }
    return;
  }

  // kBnBwd: acc is da of the layer whose z is C (row-major, ldc); dz over z
  float cs[4][2], ct[4][2];  // this lane's column sums over its 4 rows
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) cs[nt][0] = cs[nt][1] = ct[nt][0] = ct[nt][1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * ti;
    float sc[2], sh[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j] = n + j < g.N ? __ldg(g.es + n + j) : 0.f;
      sh[j] = n + j < g.N ? __ldg(g.et + n + j) : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + gi + 8 * h;
        if (m >= g.M) continue;
        float* o = C + (size_t)m * g.ldc + n;
        float zv[2] = {0.f, 0.f};
        const bool pair = g.c_vec && n + 1 < g.N;
        if (pair) {
          const float2 q = *reinterpret_cast<const float2*>(o);
          zv[0] = q.x;
          zv[1] = q.y;
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < g.N) zv[j] = o[j];
        }
        float dz[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dy = affine(zv[j], sc[j], sh[j]) > 0.f ? acc[mt][nt][2 * h + j] : 0.f;
          dz[j] = __fmul_rn(dy, sc[j]);
          cs[nt][j] = fmaf(dy, zv[j], cs[nt][j]);
          ct[nt][j] += dy;
        }
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(dz[0], dz[1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < g.N) o[j] = dz[j];
        }
      }
  }
  // over the 8 row groups of the warp (fixed shuffle order), then the two
  // row warps in order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[nt][j] += __shfl_xor_sync(kFull, cs[nt][j], off);
        ct[nt][j] += __shfl_xor_sync(kFull, ct[nt][j], off);
      }
  if (gi == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[0][warp & 1][wn + nt * 8 + 2 * ti + j] = cs[nt][j];
        red[1][warp & 1][wn + nt * 8 + 2 * ti + j] = ct[nt][j];
      }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < g.N) {
    const size_t o = (size_t)blockIdx.x * g.N + n0 + tid;
    g.ps[o] = red[0][0][tid] + red[0][1][tid];
    g.pt[o] = red[1][0][tid] + red[1][1][tid];
  }
}

// The last layer, over z_L (rows x C, row (b*K + k)*S + s): a = relu(z*s + t);
// per centroid and channel the maximum over the K neighbours and how many
// reach it; da = dpooled / count where a equals it, else 0; dy = da * (y > 0);
// dz = dy * s written over z; column partials of dy * z and dy, one row of C
// a group of centroids (blockIdx.y). A block: 32 channels (one a lane) x 8
// warps, each warp a fixed share of the group's centroids, summed in warp
// order.
__global__ void __launch_bounds__(32 * kTiesWarps)
max_ties_kernel(float* __restrict__ zbuf, const float* __restrict__ dpooled,
                const float* __restrict__ s, const float* __restrict__ t, float* __restrict__ ps,
                float* __restrict__ pt, int K, int S, int C, int BS, int per_group) {
  __shared__ float red[2][kTiesWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int q0 = blockIdx.y * per_group;
  const int q1 = min(BS, q0 + per_group);
  float acc_s = 0.f, acc_t = 0.f;
  if (c < C) {
    const float sc = __ldg(s + c), sh = __ldg(t + c);
    const size_t step = (size_t)S * C;
    for (int q = q0 + warp; q < q1; q += kTiesWarps) {
      const int b = q / S;
      float* col = zbuf + ((size_t)b * K * S + (q - b * S)) * C + c;  // row (b, 0, s)
      float mx = 0.f;
      for (int k = 0; k < K; ++k) mx = fmaxf(mx, fmaxf(affine(col[k * step], sc, sh), 0.f));
      float cnt = 0.f;
      for (int k = 0; k < K; ++k)
        cnt += fmaxf(affine(col[k * step], sc, sh), 0.f) == mx ? 1.f : 0.f;
      const float share = __fdiv_rn(__ldg(dpooled + (size_t)q * C + c), cnt);
      for (int k = 0; k < K; ++k) {
        const float zv = col[k * step];
        const float y = affine(zv, sc, sh);
        const float dy = fmaxf(y, 0.f) == mx && y > 0.f ? share : 0.f;
        col[k * step] = __fmul_rn(dy, sc);
        acc_s = fmaf(dy, zv, acc_s);
        acc_t += dy;
      }
    }
  }
  red[0][warp][lane] = acc_s;
  red[1][warp][lane] = acc_t;
  __syncthreads();
  if (warp == 0 && c < C) {
    float vs = 0.f, vt = 0.f;
    for (int w = 0; w < kTiesWarps; ++w) {
      vs += red[0][w][lane];
      vt += red[1][w][lane];
    }
    ps[(size_t)blockIdx.y * C + c] = vs;
    pt[(size_t)blockIdx.y * C + c] = vt;
  }
}

// Sums of partials: out[i] = sum over p of part[p * n + i], for every
// segment (dW, dscale, dshift of every layer) in one launch. `ways` warps
// (a power of two, more for more partials) share 32 consecutive outputs:
// way w adds p = w, w + ways, ... in order, then the first adds the ways'
// sums in order; a block of 32 warps takes 32 / ways such groups.
struct Segment {
  const float* part;
  float* out;
  int P, n, ways, first_block;
};

struct Segments {
  Segment s[3 * kMaxLayers];
  int count;
};

int ways_for(int P) {
  int w = 1;
  while (w < 32 && w * 32 < P) w *= 2;
  return w;
}

__global__ void __launch_bounds__(kRedThreads) reduce_kernel(const Segments sg) {
  __shared__ float red[kRedThreads / 32][32];
  int j = 0;
  while (j + 1 < sg.count && (int)blockIdx.x >= sg.s[j + 1].first_block) ++j;
  const Segment seg = sg.s[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / seg.ways, way = warp - group * seg.ways;
  const int i = (((int)blockIdx.x - seg.first_block) * (32 / seg.ways) + group) * 32 + lane;
  float v = 0.f;
  if (i < seg.n)
    for (int p = way; p < seg.P; p += seg.ways) v += seg.part[(size_t)p * seg.n + i];
  red[warp][lane] = v;
  __syncthreads();
  if (way == 0 && i < seg.n) {
    float acc = 0.f;
    for (int w = 0; w < seg.ways; ++w) acc += red[warp + w][lane];
    seg.out[i] = acc;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

Operand operand(const float* p, long ld, long batch, const float* s = nullptr,
                const float* t = nullptr) {
  return Operand{p, ld, batch, s, t, (int)(ld % 4 == 0 && aligned16(p))};
}

template <bool kBf16, bool AKC, bool BKC, int EPI>
cudaError_t launch_gemm(Gemm g, int batch, cudaStream_t stream) {
  g.c_vec = g.ldc % 2 == 0 && ((uintptr_t)g.c & 7) == 0;
  const dim3 grid((unsigned)((g.M + kBM - 1) / kBM), (unsigned)((g.N + kBN - 1) / kBN),
                  (unsigned)batch);
  if (grid.y > 65535u || batch > 65535) return cudaErrorInvalidValue;
  gemm_kernel<kBf16, AKC, BKC, EPI><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

long tiles_of(long rows) { return (rows + kBM - 1) / kBM; }

template <bool kBf16>
int run_bwd(const float* grouped, const float* dpooled, float* dgrouped, float* scratch,
            long scratch_floats, int chunk_rows, int B, int K, int S, int n_layers,
            const float* const* W, const float* const* Sc, const float* const* Sh,
            float* const* dW, float* const* dS, float* const* dT, const int* c, void* stream) {
  if (B < 1 || K < 1 || S < 1 || n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    if (c[l] < 1 || c[l + 1] < 1) return (int)cudaErrorInvalidValue;
    if (!W[l] || !Sc[l] || !Sh[l] || !dW[l] || !dS[l] || !dT[l])
      return (int)cudaErrorInvalidValue;
  }
  if (!grouped || !dpooled || !scratch || chunk_rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)B * K * S;
  const long BS = (long)B * S;
  if (rows > 2147483647L) return (int)cudaErrorInvalidValue;
  const long chunks = (rows + chunk_rows - 1) / chunk_rows;
  const long tiles = tiles_of(rows);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;

  // scratch: z of every layer, then per layer the dW partials (chunks x cin
  // x cout) and the dscale, dshift partials (tiles x cout each)
  float* z[kMaxLayers];
  float* pw[kMaxLayers];
  float* pst[kMaxLayers];
  float* p = scratch;
  for (int l = 0; l < n_layers; ++l) {
    z[l] = p;
    p += rows * c[l + 1];
  }
  for (int l = 0; l < n_layers; ++l) {
    pw[l] = p;
    p += chunks * c[l] * c[l + 1];
    pst[l] = p;
    p += 2 * tiles * c[l + 1];
  }
  if (p - scratch > scratch_floats) return (int)cudaErrorInvalidValue;

  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;

  // 1. recompute the forward: z_l = a_{l-1} W_l, a_{l-1} = relu(z_{l-1} s + t)
  for (int l = 0; l < n_layers; ++l) {
    Gemm g{};
    g.a = l == 0 ? operand(grouped, c[0], 0)
                 : operand(z[l - 1], c[l], 0, Sc[l - 1], Sh[l - 1]);
    g.b = operand(W[l], c[l + 1], 0);  // (k, n) at W[k * cout + n]
    g.c = z[l];
    g.ldc = c[l + 1];
    g.M = (int)rows;
    g.N = c[l + 1];
    g.K = c[l];
    g.k_total = c[l];
    if ((err = launch_gemm<kBf16, true, false, kStore>(g, 1, st)) != cudaSuccess) return (int)err;
  }

  // 2. the last layer's max/tie split, mask and scale; dz_L over z_L
  const int L = n_layers - 1;
  int P[kMaxLayers];
  for (int l = 0; l < n_layers; ++l) P[l] = (int)tiles;
  {
    const int cl = c[n_layers];
    const int col_blocks = (cl + 31) / 32;
    long groups = 4L * sms / col_blocks;
    groups = groups < 1 ? 1 : (groups > tiles ? tiles : groups);
    long per = (BS + groups - 1) / groups;
    const long min_per = (kBM + K - 1) / K;  // so that groups <= tiles
    per = per < min_per ? min_per : per;
    groups = (BS + per - 1) / per;
    if (groups > 65535) return (int)cudaErrorInvalidValue;
    P[L] = (int)groups;
    const dim3 grid((unsigned)col_blocks, (unsigned)groups);
    max_ties_kernel<<<grid, 32 * kTiesWarps, 0, st>>>(z[L], dpooled, Sc[L], Sh[L], pst[L],
                                                      pst[L] + tiles * cl, K, S, cl, (int)BS,
                                                      (int)per);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // 3. layer by layer from the last: dW (reading z_{l-1} as its x), then
  // da, whose epilogue turns z_{l-1} into dz_{l-1}
  for (int l = n_layers - 1; l >= 0; --l) {
    const int cin = c[l], cout = c[l + 1];
    Gemm gw{};  // dW[p] = x[p]^T dz[p] over chunk p's rows: M = cin, N = cout
    gw.a = l == 0 ? operand(grouped, cin, (long)chunk_rows * cin)
                  : operand(z[l - 1], cin, (long)chunk_rows * cin, Sc[l - 1], Sh[l - 1]);
    gw.b = operand(z[l], cout, (long)chunk_rows * cout);
    gw.c = pw[l];
    gw.ldc = cout;
    gw.c_batch = (long)cin * cout;
    gw.M = cin;
    gw.N = cout;
    gw.K = chunk_rows;
    gw.k_total = rows;
    if ((err = launch_gemm<kBf16, false, false, kStore>(gw, (int)chunks, st)) != cudaSuccess)
      return (int)err;
    if (l == 0 && !dgrouped) break;  // the caller needs no input gradient
    Gemm ga{};  // da = dz W^T: M = rows, N = cin, contraction over cout
    ga.a = operand(z[l], cout, 0);
    ga.b = operand(W[l], cout, 0);  // (k, n) at W[n * cout + k]
    ga.M = (int)rows;
    ga.N = cin;
    ga.K = cout;
    ga.k_total = cout;
    if (l == 0) {
      ga.c = dgrouped;
      ga.ldc = cin;
      err = launch_gemm<kBf16, true, true, kStore>(ga, 1, st);
    } else {
      ga.c = z[l - 1];
      ga.ldc = cin;
      ga.es = Sc[l - 1];
      ga.et = Sh[l - 1];
      ga.ps = pst[l - 1];
      ga.pt = pst[l - 1] + tiles * cin;
      err = launch_gemm<kBf16, true, true, kBnBwd>(ga, 1, st);
    }
    if (err != cudaSuccess) return (int)err;
  }

  // 4. every partial summed in a fixed order
  Segments sg{};
  int blocks = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int cout = c[l + 1];
    const Segment segs[3] = {
        {pw[l], dW[l], (int)chunks, c[l] * cout, ways_for((int)chunks), 0},
        {pst[l], dS[l], P[l], cout, ways_for(P[l]), 0},
        {pst[l] + tiles * cout, dT[l], P[l], cout, ways_for(P[l]), 0}};
    for (const Segment& s : segs) {
      sg.s[sg.count] = s;
      sg.s[sg.count].first_block = blocks;
      const int per_block = 32 * (32 / s.ways);
      blocks += (s.n + per_block - 1) / per_block;
      ++sg.count;
    }
  }
  reduce_kernel<<<blocks, kRedThreads, 0, st>>>(sg);
  return (int)cudaGetLastError();
}

}  // namespace

// grouped (B,K,S,c0), dpooled (B,S,c_L), dgrouped (B,K,S,c0) out or NULL;
// layer l reads w_l (c_l, c_{l+1}) row-major, s_l, t_l (c_{l+1},) and
// writes dw_l (c_l, c_{l+1}), ds_l and dt_l (c_{l+1},); unused layers pass
// NULL and width 0. scratch of scratch_floats floats, at least rows * (c_1
// + ... + c_L) + sum over l of (P * c_l * c_{l+1} + 2 * T * c_{l+1}), rows =
// B*K*S, P = ceil(rows / chunk_rows) (dW's row chunks), T = ceil(rows /
// 64). Returns cudaErrorInvalidValue for arguments the kernels do not take,
// else the first launch error. bf16 != 0 rounds both operands of every
// product to bf16 and accumulates in f32 (the TPU kernel's bf16=True);
// bf16 == 0 multiplies f32 as 3xTF32.
extern "C" int pcot_sa_mlp_max_bwd_f32(
    const void* grouped, const void* dpooled, void* dgrouped, void* scratch, int scratch_floats,
    int chunk_rows, int B, int K, int S, int n_layers, const void* w0, const void* s0,
    const void* t0, const void* w1, const void* s1, const void* t1, const void* w2,
    const void* s2, const void* t2, const void* w3, const void* s3, const void* t3, void* dw0,
    void* ds0, void* dt0, void* dw1, void* ds1, void* dt1, void* dw2, void* ds2, void* dt2,
    void* dw3, void* ds3, void* dt3, int c0, int c1, int c2, int c3, int c4, int bf16,
    void* stream) {
  const float* W[kMaxLayers] = {(const float*)w0, (const float*)w1, (const float*)w2,
                                (const float*)w3};
  const float* Sc[kMaxLayers] = {(const float*)s0, (const float*)s1, (const float*)s2,
                                 (const float*)s3};
  const float* Sh[kMaxLayers] = {(const float*)t0, (const float*)t1, (const float*)t2,
                                 (const float*)t3};
  float* dW[kMaxLayers] = {(float*)dw0, (float*)dw1, (float*)dw2, (float*)dw3};
  float* dS[kMaxLayers] = {(float*)ds0, (float*)ds1, (float*)ds2, (float*)ds3};
  float* dT[kMaxLayers] = {(float*)dt0, (float*)dt1, (float*)dt2, (float*)dt3};
  const int c[kMaxLayers + 1] = {c0, c1, c2, c3, c4};
  auto run = bf16 ? run_bwd<true> : run_bwd<false>;
  return run((const float*)grouped, (const float*)dpooled, (float*)dgrouped, (float*)scratch,
             scratch_floats, chunk_rows, B, K, S, n_layers, W, Sc, Sh, dW, dS, dT, c, stream);
}
