// Fused shared MLP + neighbour max-pool for Hopper (sm_90a) on the tensor
// cores, f32 (as 3xTF32) and bf16.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// _sa_mlp_max_fwd_impl / _sa_mlp_max_fwd_kernel / _sa_mlp_fwd_compute
// (reached through sa_mlp_max_pallas), both its f32 (HIGHEST) variant and
// its bf16=True variant.
//
// grouped (B,K,S,C0) neighbour-major -> L <= 4 layers of relu((x @ W) * s + t)
// -> max over the K neighbours -> (B,S,C_L).
//
// Bound on this card: operations. sa3 alone is 2*32*(259*256 + 256*512 +
// 512*1024) = 46 MFLOP per cloud against ~37 KB read. bf16 products run at
// the tensor cores' 989 TFLOP/s; f32-grade products as three TF32 products
// each, 495/3 = 165 TFLOP/s.
//
// Products. bf16 (T = __nv_bfloat16): mma.sync m16n8k16 bf16 with f32
// accumulation; both operands rounded to bf16 to nearest even
// (__float2bfloat16_rn, as torch's .bfloat16() and XLA round), as the TPU
// kernel's bf16 dot. f32 (T = float): mma.sync m16n8k8 tf32, each operand
// split as hi = rna(x), lo = rna(x - hi), rna the rounding of
// cvt.rna.tf32.f32 (to TF32, ties away from zero), and the product taken as
// lo*hi + hi*lo + hi*hi (3xTF32), the card's counterpart of the TPU's
// HIGHEST f32 dot, itself several bf16 passes of its matrix unit; one TF32
// pass alone keeps about three decimal digits. In both types each MMA step
// (k8 tf32, k16 bf16) of each 16 x 8 tile goes into a zeroed accumulator
// and reaches the running sum through an f32 add rounded to nearest, in
// ascending contraction order; y = z * s + t is formed by two roundings
// (affine, no FMA).
//
// Agreement with the backward. csrc/sa_mlp_max_bwd.cu recomputes this
// forward and routes dpooled to the neighbours equal to ITS maximum, so the
// two must compute the same z, y and maximum bit for bit, or a gradient can
// go to a neighbour whose forward value was not the pooled one. They agree
// because every value that enters an output takes the same operations:
// - the operands: layer 0's input as f32 (or rounded to bf16 to nearest
//   even), a hidden layer's input relu(affine(z, s, t)) in f32 (or rounded
//   to bf16 to nearest even, from that f32 value), W as f32 (or rounded to
//   bf16); the f32 splits hi = rna(x), lo = rna(x - hi) of the same values;
// - the MMA steps: the same fragment positions (A (g, t), (g+8, t),
//   (g, t+4), (g+8, t+4); B (t, g), (t+4, g) in contraction words), the
//   same steps (every step of the MMA depth that starts below the layer's
//   input width, from 0 upwards; the padded tail of the last step holds
//   zeros in A and W on both sides), each into a zeroed part, f32 in the
//   order lo*hi, hi*lo, hi*hi, then acc += part in ascending order;
// - the epilogue: affine, then fmaxf(y, 0); the maximum over the K rows
//   of a centroid is exact whatever its order (max is exact; the atomicMax
//   here, the fmaxf loop there);
// - an output row does not depend on the other rows: the row tiles here
//   (centroid-major chunks, a split over column groups) and there (64-row
//   tiles of the (b, k, s) rows) group rows differently, which changes no
//   row's sum.
// The products run through the same mma.sync instructions on both sides; a
// tensor core's result depends only on its operands, not on the fragment
// slot a row or column occupies. chip_smoke.py checks the agreement on the
// card at every stage's widths (phase mlp_recompute).
//
// Design. One block of 8 warps per (tile of ts centroids, group of the last
// layer's columns), at most 128 registers a thread so that two blocks share
// an SM. Centroids are numbered q = b * S + s over the whole batch, so a
// tile may span clouds (sa3 and the group-all stage have one centroid a
// cloud). The tile's rows (centroid-major: row r = centroid * K +
// neighbour) sit in shared memory as a row-major ping-pong pair of
// activation buffers, in T, so no layer's output touches device memory;
// their row strides are padded so that ldmatrix loads the A fragments
// without bank conflicts, and input widths are zero-padded to the MMA depth
// (c0 = 3, 131, 259, ragged widths). The inputs are staged with 16 loads in
// flight a lane. A layer runs in passes of rc rows x nb columns (rc * nb =
// 8192: 32 x 256, 64 x 128 or 128 x 64), a 32 x 32 warp tile each (2 x 4
// MMA tiles, 32 f32 accumulators a thread). W is staged as f32 through
// cp.async, kStage input channels a stage, in a ring of two or three stages
// that runs over the block's whole sequence of (chunk, layer, pass, stage),
// so the copies stay ahead across passes and layers, with one barrier a
// stage; the B fragments are read from it with conflict-free 32-bit loads
// and split (f32) or rounded to bf16 (bf16) in registers. Every index the
// ring needs is fixed once a block (no division in the stage loop). Scale,
// shift and ReLU run on the accumulators in f32. The last layer is fused
// with the max: each MMA tile's column maximum is taken in registers and
// across the 8 row groups of the warp by shuffles, then one shared
// atomicMax per (centroid, column) per warp folds it into a per-tile
// (ts, C_L) maximum; integer atomicMax orders non-negative floats like their
// bit patterns (they are all >= 0 after the ReLU). A tile whose rows do not
// fit at once (the f32 group-all stage: K = 128 rows of 259 -> 256 -> 512 ->
// 1024 channels) runs through all the layers in chunks of rc rows, each
// folding into the same maximum; max is associative, so the result does not
// depend on the chunks. When the tiles alone give too few blocks to fill the
// card (sa3), the last layer's columns are split over a few blocks that
// each recompute the earlier layers; the host picks the split from the
// occupancy it queries.
//
// What holds it back (measured on the H100, PERF.md): 16 warps an SM and
// short stages leave each stage's latency (the copies, ldmatrix, the
// products' dependent sums, the barrier) exposed, so the products run far
// below the tensor cores' rate; f32 also spends integer ALU time on the
// operand splits. wgmma with 64-row warpgroup tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
constexpr int kWarpRows = 32;                               // 2 MMA tiles of 16 rows
constexpr int kWarpCols = 32;                               // 4 MMA tiles of 8 columns
constexpr int kPassOut = kWarps * kWarpRows * kWarpCols;    // rc * nb
constexpr unsigned kFull = 0xffffffffu;

// smem_addr, ldmatrix_x4, cp_async16, the commit and wait, tf32_rna,
// split_tf32, mma_tf32, mma_bf16, pack_bf16
using namespace pcot;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// y = z * s + t in two roundings, never contracted to an FMA: the
// backward's affine (csrc/sa_mlp_max_bwd.cu), which recomputes this y
__device__ __forceinline__ float affine(float z, float s, float t) {
  return __fadd_rn(__fmul_rn(z, s), t);
}

// What differs between the element types: the MMA, its depth, the stage
// depth, the row strides, and the stores into the activation buffers.
// step() adds one MMA depth of products to the warp's 32 x 32 tile: a points
// at this lane's ldmatrix row of A (channel k), a_mt the distance to the
// second 16-row tile; w at this lane's first B element of the W stage.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kK = 8;       // depth of one m16n8k8
  static constexpr int kStage = 32;  // input channels of W a stage
  static constexpr int kPadW = 8;    // W stage stride nb + 8: conflict-free B loads
  static constexpr int kWRow = 1;    // B fragment rows: lane & 3, + 4
  // act stride: 8-row ldmatrix reads of 16 bytes hit distinct bank groups
  static __host__ int ld(int w) { return (w + 7) / 8 * 8 + 4; }
  static __device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 4; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ void step(float (&acc)[2][4][4], const float* a, int a_mt,
                                              const float* w, int ldw) {
    unsigned ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned r[4];
      ldmatrix_x4(r, a + mt * a_mt);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(r[i], ahi[mt][i], alo[mt][i]);
    }
    // each tile's products of this step go into a zeroed accumulator, the
    // small terms first, and reach the running sum through an f32 add
    // rounded to nearest (csrc/sa_mlp_max_bwd.cu mma_stage, term for term);
    // B is split one column tile at a time, which keeps 12 registers free
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      unsigned bhi[2], blo[2];
      split_tf32(__float_as_uint(w[nt * 8]), bhi[0], blo[0]);
      split_tf32(__float_as_uint(w[4 * ldw + nt * 8]), bhi[1], blo[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, alo[mt], bhi[0], bhi[1]);
        mma_tf32(part, ahi[mt], blo[0], blo[1]);
        mma_tf32(part, ahi[mt], bhi[0], bhi[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }
    }
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;      // depth of one m16n8k16
  static constexpr int kStage = 64;
  static constexpr int kPadW = 4;    // W stage stride nb + 4: conflict-free pairs of rows
  static constexpr int kWRow = 2;    // B fragment rows: 2 (lane & 3), + 1, + 8, + 9
  static __host__ int ld(int w) { return (w + 15) / 16 * 16 + 8; }
  static __device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void step(float (&acc)[2][4][4], const __nv_bfloat16* a,
                                              int a_mt, const float* w, int ldw) {
    unsigned r[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(r[mt], a + mt * a_mt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* wc = w + nt * 8;
      const unsigned b0 = pack_bf16(wc[0], wc[ldw]);
      const unsigned b1 = pack_bf16(wc[8 * ldw], wc[9 * ldw]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {  // as the f32 step: a zeroed part, then an f32 add
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, r[mt], b0, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
      }
    }
  }
};

struct MlpParams {
  const float* w[kMaxLayers];  // (c[l], c[l+1]) row-major
  const float* s[kMaxLayers];  // (c[l+1],)
  const float* t[kMaxLayers];  // (c[l+1],)
  int c[kMaxLayers + 1];
  int vec[kMaxLayers];         // W's rows can be copied 16 bytes at a time
  int wout[kMaxLayers];        // columns a layer produces (the next one's zero-padded depth)
  int passes[kMaxLayers];      // passes of nb columns over them
  int ksteps[kMaxLayers];      // W stages over the input channels
  int n_layers;
};

// Geometry of one launch, fixed by the host.
struct Tiling {
  int ts;                // centroids per tile
  int rows;              // ts * K
  int rc;                // rows per chunk and per pass: 32, 64 or 128
  int nb;                // columns per pass: kPassOut / rc
  int ld0, ld1;          // row strides (elements) of the two activation buffers
  int ldw;               // row stride (floats) of a W stage
  int nst;               // W stages in flight: 2 or 3
  int groups;            // blocks sharing one tile, splitting the last layer's columns
  int off1, offw, offp;  // byte offsets of buffer 1, the W stages and the maximum
};

// Which part of a W stage this thread copies: one column (4 columns with
// 16-byte copies) and every step-th row from row0. nb divides kThreads.
struct WCopy {
  int col, row0, step;
};

// Stage kStage rows (from k0) x nb columns (from n0) of W, zero outside it,
// in 16-byte copies where W's rows allow them (vec), else 4-byte ones (4-byte
// copies alone ran 1.2-2.3x slower on the H100).
template <int kStage>
__device__ __forceinline__ void load_w_stage(const float* __restrict__ W, int cin, int cout,
                                             bool vec, const WCopy& cv, const WCopy& cs,
                                             int k0, int n0, float* dst, int ldw) {
  const WCopy& c = vec ? cv : cs;
  const bool in_col = n0 + c.col < cout;  // vec: cout % 4 == 0, the whole 16 bytes lie inside
  const float* src = W + (size_t)(k0 + c.row0) * cout + n0 + c.col;
  const size_t src_step = (size_t)c.step * cout;
  float* dp = dst + c.row0 * ldw + c.col;
  const int dst_step = c.step * ldw;
  for (int kk = c.row0; kk < kStage; kk += c.step, src += src_step, dp += dst_step) {
    const bool in = in_col && k0 + kk < cin;
    if (vec) {
      if (in)
        cp_async16(dp, src);
      else
        *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (in)
        cp_async4(dp, src);
      else
        *dp = 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max_rows(float v) {  // over the 8 row groups
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 16));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sa_mlp_max_kernel(const float* __restrict__ g, float* __restrict__ out, const MlpParams p,
                  const Tiling tl, int K, int S, int BS) {
  using X = Mma<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);             // inputs of layers 0, 2
  T* buf1 = reinterpret_cast<T*>(smem + tl.off1);   // inputs of layers 1, 3
  float* wst = reinterpret_cast<float*>(smem + tl.offw);
  float* pool = reinterpret_cast<float*>(smem + tl.offp);  // (ts, c_last) running maximum
  int* pool_bits = reinterpret_cast<int*>(pool);
  __shared__ long long row_off[128];                       // a chunk's rows in grouped
  const int n_layers = p.n_layers;
  const int c_last = p.c[n_layers];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps_m = tl.rc / kWarpRows;
  const int wm = warp % warps_m;
  const int wn = warp / warps_m;
  const int tile = blockIdx.x / tl.groups;
  const int grp = blockIdx.x - tile * tl.groups;
  const int q0 = tile * tl.ts;
  const int stage_floats = X::kStage * tl.ldw;
  const int gi = lane >> 2;  // row group of the MMA fragments
  const int ti = lane & 3;   // column pair
  // this lane's B element in a W stage, and its rows of A
  const int w_lane = X::kWRow * ti * tl.ldw + wn * kWarpCols + gi;
  const int a_row = wm * kWarpRows + (lane & 15);
  const WCopy cv = {(tid % (tl.nb / 4)) * 4, tid / (tl.nb / 4), kThreads / (tl.nb / 4)};
  const WCopy cs = {tid % tl.nb, tid / tl.nb, kThreads / tl.nb};
  // this group's share of the last layer's passes (never empty)
  const int per = (p.passes[n_layers - 1] + tl.groups - 1) / tl.groups;
  const int last_pb = min(p.passes[n_layers - 1], grp * per);
  const int last_pe = min(p.passes[n_layers - 1], last_pb + per);

  for (int e = tid; e < tl.ts * c_last; e += kThreads) pool[e] = 0.f;

  // The W stages run as one ring over the block's whole sequence (chunk,
  // layer, pass, stage of kStage input channels): the producer stays nst - 1
  // stages ahead across passes, layers and chunks, and the one barrier of a
  // stage also orders a pass's epilogue before the next layer reads it.
  const int n_chunks = (tl.rows + tl.rc - 1) / tl.rc;
  int pr_chunk = 0, pr_l = 0, pr_ks = 0;  // the producer's stage
  int pr_pc = n_layers == 1 ? last_pb : 0;
  int pr_pe = n_layers == 1 ? last_pe : p.passes[0];
  int slot_w = 0;  // the ring slot the producer fills next
  auto issue = [&]() {
    if (pr_chunk < n_chunks) {
      load_w_stage<X::kStage>(p.w[pr_l], p.c[pr_l], p.c[pr_l + 1], p.vec[pr_l] != 0, cv, cs,
                              pr_ks * X::kStage, pr_pc * tl.nb, wst + slot_w * stage_floats,
                              tl.ldw);
      if (++pr_ks == p.ksteps[pr_l]) {
        pr_ks = 0;
        if (++pr_pc == pr_pe) {
          if (++pr_l == n_layers) {
            pr_l = 0;
            ++pr_chunk;
          }
          const bool lst = pr_l == n_layers - 1;
          pr_pc = lst ? last_pb : 0;
          pr_pe = lst ? last_pe : p.passes[pr_l];
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
    if (++slot_w == tl.nst) slot_w = 0;
  };
  for (int st = 0; st < tl.nst - 1; ++st) issue();
  int slot_r = 0;  // the ring slot the consumer reads next

  const int c0 = p.c[0];
  const int w0 = (c0 + X::kK - 1) / X::kK * X::kK;
  const int lanes_row = w0 <= 8 ? 8 : w0 <= 16 ? 16 : 32;  // lanes loading one input row
  const int rows_warp = 32 / lanes_row;
  const int lane_row = lane / lanes_row;
  const int lane_ch = lane % lanes_row;
  for (int cr0 = 0; cr0 < tl.rows; cr0 += tl.rc) {  // chunks of the tile's rows
    // the chunk's inputs, a warp a row, zero in padded channels, rows and
    // centroids (-1: a row past the tile or the batch)
    if (tid < tl.rc) {
      const int r = cr0 + tid;
      long long off = -1;
      if (r < tl.rows && q0 + r / K < BS) {
        const int q = q0 + r / K;
        const int b = q / S;
        off = (((long long)b * K + (r % K)) * S + (q - b * S)) * c0;
      }
      row_off[tid] = off;
    }
    __syncthreads();  // the row offsets; every warp is done with the last chunk's buffers
    // lanes_row lanes a row (w0 is a multiple of 8), each loading 4 rows x 4
    // channels, all 16 loads in flight before the first store
    for (int cb = 0; cb < w0; cb += 4 * lanes_row) {
      for (int rb = warp * rows_warp; rb < tl.rc; rb += 4 * kWarps * rows_warp) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rl = rb + u * kWarps * rows_warp + lane_row;
          const long long off = rl < tl.rc ? row_off[rl] : -1;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = cb + lane_ch + i * lanes_row;
            v[u][i] = off >= 0 && ch < c0 ? __ldg(g + off + ch) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rl = rb + u * kWarps * rows_warp + lane_row;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = cb + lane_ch + i * lanes_row;
            if (rl < tl.rc && ch < w0) X::store(buf0 + rl * tl.ld0 + ch, v[u][i]);
          }
        }
      }
    }
    // the centroid of each of this warp's MMA tiles when its 16 rows are
    // real rows of one centroid, else -1 (warp-uniform)
    const int rw = cr0 + wm * kWarpRows;  // the warp's first row in the tile
    int cen[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ra = rw + mt * 16;
      const int rb = ra + 15;
      cen[mt] = rb < tl.rows && ra / K == rb / K && q0 + rb / K < BS ? ra / K : -1;
    }
    const bool merged = cen[0] >= 0 && cen[0] == cen[1];

    for (int l = 0; l < n_layers; ++l) {
      const T* in = (l & 1) ? buf1 : buf0;
      const int ldi = (l & 1) ? tl.ld1 : tl.ld0;
      T* nxt = (l & 1) ? buf0 : buf1;
      const int ldn = (l & 1) ? tl.ld0 : tl.ld1;
      const int cin = p.c[l];
      const int cout = p.c[l + 1];
      const bool last = l == n_layers - 1;
      const int wout = p.wout[l];
      const float* __restrict__ sc = p.s[l];
      const float* __restrict__ sh = p.t[l];
      const int p_begin = last ? last_pb : 0;
      const int p_end = last ? last_pe : p.passes[l];
      const int ksteps = p.ksteps[l];
      const T* a_lane = in + a_row * ldi + X::a_col(lane);

      for (int pc = p_begin; pc < p_end; ++pc) {
        const int wc0 = pc * tl.nb + wn * kWarpCols;  // this warp's first column
        const bool active = wc0 < wout;
        float acc[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

        for (int ks = 0, k0 = 0; ks < ksteps; ++ks, k0 += X::kStage) {
          if (tl.nst == 3)
            cp_async_wait<1>();
          else
            cp_async_wait<0>();
          // this stage has landed; every warp is done with the stage before
          // it, with the last epilogue and (first stage) with the inputs
          __syncthreads();
          issue();
          if (active) {
            const float* w = wst + slot_r * stage_floats + w_lane;
            if (k0 + X::kStage <= cin) {  // a full stage: no guard between the steps
#pragma unroll
              for (int kk = 0; kk < X::kStage; kk += X::kK)
                X::step(acc, a_lane + k0 + kk, 16 * ldi, w + kk * tl.ldw, tl.ldw);
            } else {
#pragma unroll
              for (int kk = 0; kk < X::kStage; kk += X::kK)
                if (k0 + kk < cin) X::step(acc, a_lane + k0 + kk, 16 * ldi, w + kk * tl.ldw, tl.ldw);
            }
          }
          if (++slot_r == tl.nst) slot_r = 0;
        }
        if (!active) continue;

        if (!last) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = wc0 + nt * 8 + 2 * ti;
            if (col >= wout) continue;  // wout is even: col + 1 < wout too
            const float s0 = col < cout ? __ldg(sc + col) : 0.f;
            const float s1 = col + 1 < cout ? __ldg(sc + col + 1) : 0.f;
            const float t0 = col < cout ? __ldg(sh + col) : 0.f;
            const float t1 = col + 1 < cout ? __ldg(sh + col + 1) : 0.f;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const int r = wm * kWarpRows + mt * 16 + gi;
              const float* a = acc[mt][nt];
              X::store2(nxt + r * ldn + col, fmaxf(affine(a[0], s0, t0), 0.f),
                        fmaxf(affine(a[1], s1, t1), 0.f));
              X::store2(nxt + (r + 8) * ldn + col, fmaxf(affine(a[2], s0, t0), 0.f),
                        fmaxf(affine(a[3], s1, t1), 0.f));
            }
          }
          continue;
        }

        // last layer: fold into the maximum (the shuffles run on every lane)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = wc0 + nt * 8 + 2 * ti + j;
            const bool in_col = col < cout;
            const float scj = in_col ? __ldg(sc + col) : 0.f;
            const float shj = in_col ? __ldg(sh + col) : 0.f;
            float y[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                y[mt][h] = fmaxf(affine(acc[mt][nt][2 * h + j], scj, shj), 0.f);
            if (merged) {
              const float v =
                  warp_max_rows(fmaxf(fmaxf(y[0][0], y[0][1]), fmaxf(y[1][0], y[1][1])));
              if (gi == 0 && in_col)
                atomicMax(pool_bits + cen[0] * c_last + col, __float_as_int(v));
              continue;
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (cen[mt] >= 0) {
                const float v = warp_max_rows(fmaxf(y[mt][0], y[mt][1]));
                if (gi == 0 && in_col)
                  atomicMax(pool_bits + cen[mt] * c_last + col, __float_as_int(v));
              } else if (in_col) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int r = rw + mt * 16 + gi + 8 * h;
                  if (r < tl.rows && q0 + r / K < BS)
                    atomicMax(pool_bits + (r / K) * c_last + col, __float_as_int(y[mt][h]));
                }
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the maximum is complete

  // this block's columns of the last layer
  const int col_begin = min(c_last, last_pb * tl.nb);
  const int col_end = min(c_last, last_pe * tl.nb);
  const int width = col_end - col_begin;
  for (int e = tid; e < tl.ts * width; e += kThreads) {
    const int sl = e / width;
    const int col = col_begin + (e - sl * width);
    const int q = q0 + sl;
    if (q < BS) out[(size_t)q * c_last + col] = pool[sl * c_last + col];
  }
}

// dynamic shared memory: 227 KB a block can opt into on sm_90, and half the
// SM's 228 KB less the 1 KB reserved a block, each less row_off's 1 KB
constexpr long kMaxSmemBytes = 232448 - 1024;
constexpr long kTwoPerSm = 115712 - 1024;

long align16(long n) { return (n + 15) / 16 * 16; }

// The tiling for ts centroids a tile, chunks of rc rows and nst W stages;
// returns its shared memory in bytes.
template <typename T>
long make_tiling(Tiling* tl, int K, int ts, int rc, int nst, int n_layers, const int* c) {
  using X = Mma<T>;
  tl->ts = ts;
  tl->rows = ts * K;
  tl->rc = rc;
  tl->nb = kPassOut / rc;
  tl->nst = nst;
  tl->groups = 1;
  int wd[2] = {0, 0};
  for (int l = 0; l < n_layers; ++l) {
    const int w = (c[l] + X::kK - 1) / X::kK * X::kK;
    wd[l & 1] = w > wd[l & 1] ? w : wd[l & 1];
  }
  tl->ld0 = X::ld(wd[0]);
  tl->ld1 = wd[1] ? X::ld(wd[1]) : 0;
  tl->ldw = tl->nb + X::kPadW;
  const long e = (long)sizeof(T);
  tl->off1 = (int)align16((long)rc * tl->ld0 * e);
  tl->offw = tl->off1 + (int)align16((long)rc * tl->ld1 * e);
  tl->offp = tl->offw + (int)((long)nst * X::kStage * tl->ldw * 4);
  return tl->offp + 4L * ts * c[n_layers];
}

int chunk_rows(int rows) { return rows <= 32 ? 32 : rows <= 64 ? 64 : 128; }

template <typename T>
int run_sa_mlp_max(const void* grouped, void* out, int B, int K, int S, int n_layers,
                   const void* const* ws, const void* const* ss, const void* const* tt,
                   const int* cs, void* stream) {
  if (B < 1 || K < 1 || S < 1 || n_layers < 1 || n_layers > kMaxLayers || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long)B * S > (1L << 30)) return (int)cudaErrorInvalidValue;
  const int BS = B * S;
  MlpParams p;
  for (int l = 0; l < kMaxLayers; ++l) {
    p.w[l] = (const float*)ws[l];
    p.s[l] = (const float*)ss[l];
    p.t[l] = (const float*)tt[l];
  }
  for (int l = 0; l <= kMaxLayers; ++l) p.c[l] = cs[l];
  p.n_layers = n_layers;
  for (int l = 0; l < kMaxLayers; ++l) p.vec[l] = p.wout[l] = p.passes[l] = p.ksteps[l] = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (!p.w[l] || !p.s[l] || !p.t[l] || p.c[l] < 1 || p.c[l + 1] < 1)
      return (int)cudaErrorInvalidValue;
    p.vec[l] = p.c[l + 1] % 4 == 0 && ((uintptr_t)p.w[l] & 15) == 0;
  }

  // Tiles of about 128 rows, halved while they leave fewer than two blocks
  // an SM (shared memory); failing that the largest that fits; failing that
  // one centroid a tile in chunks of 64 or 32 rows.
  int ts0 = K >= 128 ? 1 : 128 / K;
  if (ts0 > BS) ts0 = BS;
  Tiling tl;
  long bytes = -1;
  const long limits[2] = {kTwoPerSm, kMaxSmemBytes};
  for (long limit : limits) {
    for (int ts = ts0; ts >= 1 && bytes < 0; ts /= 2) {
      for (int nst = 3; nst >= 2 && bytes < 0; --nst) {
        const long b = make_tiling<T>(&tl, K, ts, chunk_rows(ts * K), nst, n_layers, p.c);
        if (b <= limit) bytes = b;
      }
    }
    if (bytes >= 0) break;
  }
  for (int rc = 64; rc >= 32 && bytes < 0; rc /= 2) {
    const long b = make_tiling<T>(&tl, K, 1, rc, 2, n_layers, p.c);
    if (b <= kMaxSmemBytes) bytes = b;
  }
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)bytes;
  for (int l = 0; l < n_layers; ++l) {  // the next layer reads its input zero-padded
    const int kk = Mma<T>::kK;
    p.wout[l] = l == n_layers - 1 ? p.c[l + 1] : (p.c[l + 1] + kk - 1) / kk * kk;
    p.passes[l] = (p.wout[l] + tl.nb - 1) / tl.nb;
    p.ksteps[l] = (p.c[l] + Mma<T>::kStage - 1) / Mma<T>::kStage;
  }
  auto kernel = sa_mlp_max_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;

  // Split the last layer's columns over more blocks when the tiles alone
  // leave the card idle: estimated time = waves * (earlier layers + the
  // block's share of the last layer), in multiply-adds per row.
  int device = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                           smem_bytes)) != cudaSuccess)
    return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const long tiles = (BS + tl.ts - 1) / tl.ts;
  double early = 0.0;
  for (int l = 0; l + 1 < n_layers; ++l) early += (double)p.c[l] * p.c[l + 1];
  const double last = (double)p.c[n_layers - 1] * p.c[n_layers];
  const int passes_last = p.passes[n_layers - 1];
  double best = -1.0;
  for (int groups = 1; groups <= passes_last; groups *= 2) {
    if ((groups - 1) * ((passes_last + groups - 1) / groups) >= passes_last) continue;
    const long slots = (long)sms * occ;
    const long waves = (tiles * groups + slots - 1) / slots;
    const double est = waves * (early + last / groups);
    if (best < 0 || est < best) {
      best = est;
      tl.groups = groups;
    }
  }

  const dim3 grid((unsigned)(tiles * tl.groups));
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)grouped, (float*)out, p, tl, K, S, BS);
  return (int)cudaGetLastError();
}

}  // namespace

// grouped (B,K,S,c0) f32 -> out (B,S,c[n_layers]) f32. Layer l reads
// w_l (c_l, c_{l+1}) row-major, s_l and t_l (c_{l+1},); unused layers pass
// NULL and width 0. Tiles of about 128 rows (ts = min(B*S, max(1, 128 / K))
// centroids), halved while fewer than two blocks fit on an SM, then while
// the tile does not fit in shared memory; a one-centroid tile that still
// does not fit runs its rows in chunks of 64 or 32. Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after launch. bf16 != 0 rounds both operands of every
// product to bf16 and accumulates in f32 (the TPU kernel's bf16=True);
// bf16 == 0 multiplies f32 as 3xTF32.
extern "C" int pcot_sa_mlp_max_f32(const void* grouped, void* out, int B, int K, int S,
                                   int n_layers,
                                   const void* w0, const void* s0, const void* t0,
                                   const void* w1, const void* s1, const void* t1,
                                   const void* w2, const void* s2, const void* t2,
                                   const void* w3, const void* s3, const void* t3,
                                   int c0, int c1, int c2, int c3, int c4, int bf16,
                                   void* stream) {
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  const void* ss[kMaxLayers] = {s0, s1, s2, s3};
  const void* tt[kMaxLayers] = {t0, t1, t2, t3};
  const int cs[kMaxLayers + 1] = {c0, c1, c2, c3, c4};
  if (bf16)
    return run_sa_mlp_max<__nv_bfloat16>(grouped, out, B, K, S, n_layers, ws, ss, tt, cs,
                                         stream);
  return run_sa_mlp_max<float>(grouped, out, B, K, S, n_layers, ws, ss, tt, cs, stream);
}
