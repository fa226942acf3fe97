// Fused shared MLP + neighbour max-pool for Hopper (sm_90a), f32 and bf16.
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
// 512*1024) = 46 MFLOP per cloud against ~37 KB read, far above the f32
// ridge. The JAX side runs full f32, so this kernel uses f32 FMA on the CUDA
// cores (no TF32, no tensor cores).
//
// Design. One block per (cloud, tile of TS centroids, group of output
// columns of the last layer). The tile's rows (centroid-major: row
// r = centroid * K + neighbour) live in shared memory, transposed
// (act[channel * ld + row]), as a ping-pong pair of buffers, so no layer's
// activations touch device memory. Each layer is an SGEMM over the tile:
// 256 threads each own a 4x4 register tile of a 64x64 (or 32x128) output
// tile; the weights are staged through shared memory 32 input channels at a
// time (coalesced loads, the next stage prefetched into registers while the
// current one is used), so the inner step is two 16-byte shared loads for
// 16 FMAs. The last layer is fused with the max: its outputs go straight
// into a per-tile (TS, C_L) shared maximum through integer atomicMax, which
// orders non-negative floats like their bit patterns (they are all >= 0
// after the relu), so they are never stored. When the clouds alone give too
// few blocks to fill the card (sa3: one centroid per cloud), the last
// layer's columns are split over a few blocks that each recompute the
// earlier layers; the host picks the split from the occupancy it queries.
// When a one-centroid tile's rows do not fit at once (the classifier's
// group-all stage: K = 128 rows of 259 -> 256 -> 512 -> 1024 channels would
// need 417,792 B), they run through all the layers in chunks of 64 rows
// (221,184 B), each chunk folding its maxima into the same shared maximum;
// max is associative, so the result does not depend on the chunks.
//
// bf16 (the element type T of the shared buffers): as the TPU kernel's
// bf16 dot, both operands of every product are rounded to bf16 (round to
// nearest even, __float2bfloat16_rn, as torch's .bfloat16() and XLA round)
// and the products are accumulated in f32. The tile's activations and the
// staged W are stored in shared memory as bf16, rounded when they are
// written; they are widened to f32 for the FMAs, where the product of two
// bf16 values is exact. Scale, shift, ReLU and the max stay in f32, and the
// output is f32. Halving the activations' bytes lets the K = 128 group-all
// tile run in one pass (210,944 B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 32;        // input channels of W staged per step
constexpr int kMaxLayers = 4;
constexpr int kMaxPrefetch = 16;  // kStage * 128 columns / kThreads

// Loads and stores of the shared buffers, four consecutive rows at a time.
template <typename T>
struct Smem;

template <>
struct Smem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Smem<__nv_bfloat16> {
  // a bf16 is the top half of the f32 with the same value: widening is a shift
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                                float d) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bits(a) | bits(b) << 16, bits(c) | bits(d) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

struct MlpParams {
  const float* w[kMaxLayers];  // (c[l], c[l+1]) row-major
  const float* s[kMaxLayers];  // (c[l+1],)
  const float* t[kMaxLayers];  // (c[l+1],)
  int c[kMaxLayers + 1];
  int n_layers;
};

// Geometry of one launch, fixed by the host.
struct Tiling {
  int ts;          // centroids per block
  int rows;        // K * ts real rows
  int rows_pad;    // rows rounded up to rt
  int rt;          // rows per pass: 32 or 64
  int chunk;       // rows in shared memory at once: a multiple of rt, at most rows_pad
  int ld;          // row stride of the transposed activations (chunk + 4)
  int groups;      // blocks sharing one tile, splitting the last layer's columns
  int buf0, buf1;  // elements of the two activation buffers
};

// kChunked: the tile's rows run in chunks of tl.chunk. Without it the one
// pass starts at row 0 at compile time, so tiles that fit at once run the
// code they ran before chunks existed. T: the type of the shared
// activations and weights, float or __nv_bfloat16 (the bf16 products).
template <bool kChunked, typename T>
__global__ void __launch_bounds__(kThreads)
sa_mlp_max_kernel(const float* __restrict__ g, float* __restrict__ out, const MlpParams p,
                  const Tiling tl, int K, int S) {
  using M = Smem<T>;
  extern __shared__ float4 smem4[];
  const int tyn = tl.rt / 4;       // 16 or 8 row groups
  const int txn = kThreads / tyn;  // 16 or 32 column groups
  const int ct = 4 * txn;          // 64 or 128 columns per pass
  T* buf0 = reinterpret_cast<T*>(smem4);  // inputs of layers 0, 2
  T* buf1 = buf0 + tl.buf0;               // inputs of layers 1, 3
  T* wS = buf1 + tl.buf1;                 // (kStage, ct) staged weights
  float* pool = reinterpret_cast<float*>(wS + kStage * ct);  // (ts, c_last) running maximum
  const int c_last = p.c[p.n_layers];

  const int tid = threadIdx.x;
  const int ty = tid / txn;
  const int tx = tid - ty * txn;
  const int tile = blockIdx.x / tl.groups;
  const int grp = blockIdx.x - tile * tl.groups;
  const int b = blockIdx.y;
  const int s0 = tile * tl.ts;
  const int ld = tl.ld;

  const int c0 = p.c[0];
  for (int e = tid; e < tl.ts * c_last; e += kThreads) pool[e] = 0.f;

  const int n_chunks = kChunked ? (tl.rows_pad + tl.chunk - 1) / tl.chunk : 1;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int cr0 = kChunked ? ci * tl.chunk : 0;  // first row of the chunk
    // rows of the chunk, a multiple of rt
    const int crows = kChunked ? min(tl.chunk, tl.rows_pad - cr0) : tl.rows_pad;
    for (int e = tid; e < crows * c0; e += kThreads) {
      const int rl = e / c0;
      const int ch = e - rl * c0;
      const int r = cr0 + rl;
      float v = 0.f;
      if (r < tl.rows) {
        const int sl = r / K;
        const int sg = s0 + sl;
        if (sg < S) v = g[(((size_t)b * K + (r - sl * K)) * S + sg) * c0 + ch];
      }
      M::store(buf0 + ch * ld + rl, v);
    }
    __syncthreads();

    for (int l = 0; l < p.n_layers; ++l) {
      const T* in = (l & 1) ? buf1 : buf0;
      T* nxt = (l & 1) ? buf0 : buf1;
      const int cin = p.c[l];
      const int cout = p.c[l + 1];
      const bool last = l == p.n_layers - 1;
      const float* __restrict__ W = p.w[l];
      const float* __restrict__ sc = p.s[l];
      const float* __restrict__ sh = p.t[l];
      const int passes = (cout + ct - 1) / ct;
      int p_begin = 0, p_end = passes;
      if (last) {
        const int per = (passes + tl.groups - 1) / tl.groups;
        p_begin = min(passes, grp * per);
        p_end = min(passes, p_begin + per);
      }
      const int per_thread = kStage * ct / kThreads;  // 8 or 16 staged weights

      for (int r0 = 0; r0 < crows; r0 += tl.rt) {  // rows of this chunk
        for (int pc = p_begin; pc < p_end; ++pc) {
          const int q0 = pc * ct;
          float acc[4][4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

          float pre[kMaxPrefetch];
          auto fetch = [&](int i0) {
#pragma unroll
            for (int q = 0; q < kMaxPrefetch; ++q) {
              if (q < per_thread) {
                const int e = tid + q * kThreads;
                const int ii = e / ct;
                const int col = q0 + (e - ii * ct);
                pre[q] = (i0 + ii < cin && col < cout)
                             ? __ldg(W + (size_t)(i0 + ii) * cout + col)
                             : 0.f;
              }
            }
          };
          fetch(0);
          for (int i0 = 0; i0 < cin; i0 += kStage) {
            __syncthreads();  // every thread is done with the previous stage
#pragma unroll
            for (int q = 0; q < kMaxPrefetch; ++q)
              if (q < per_thread) M::store(wS + tid + q * kThreads, pre[q]);
            __syncthreads();
            if (i0 + kStage < cin) fetch(i0 + kStage);  // in flight during the FMAs
            const int kc = min(kStage, cin - i0);
            const T* xin = in + (size_t)i0 * ld + r0 + 4 * ty;
            const T* win = wS + 4 * tx;
#pragma unroll 4
            for (int ii = 0; ii < kc; ++ii) {
              const float4 xv = M::load4(xin + ii * ld);
              const float4 wv = M::load4(win + ii * ct);
              const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
              const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xs[m], ws[n], acc[m][n]);
            }
          }

          const int r_local = r0 + 4 * ty;
          const int r_first = cr0 + r_local;
          // rows of this thread that belong to real centroids of the tile
          bool valid[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = r_first + m;
            valid[m] = r < tl.rows && s0 + r / K < S;
          }
          const bool one_centroid = valid[0] && valid[3] && r_first / K == (r_first + 3) / K;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = q0 + 4 * tx + n;
            if (col >= cout) continue;
            const float scn = sc[col];
            const float shn = sh[col];
            float y[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) y[m] = fmaxf(acc[m][n] * scn + shn, 0.f);
            if (!last) {
              M::store4(nxt + (size_t)col * ld + r_local, y[0], y[1], y[2], y[3]);
            } else if (one_centroid) {
              const float v = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
              atomicMax(reinterpret_cast<int*>(pool) + (r_first / K) * c_last + col,
                        __float_as_int(v));
            } else {
#pragma unroll
              for (int m = 0; m < 4; ++m)
                if (valid[m])
                  atomicMax(reinterpret_cast<int*>(pool) + ((r_first + m) / K) * c_last + col,
                            __float_as_int(y[m]));
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // this block's columns of the last layer
  const int passes = (c_last + ct - 1) / ct;
  const int per = (passes + tl.groups - 1) / tl.groups;
  const int col_begin = min(c_last, grp * per * ct);
  const int col_end = min(c_last, col_begin + per * ct);
  const int width = col_end - col_begin;
  for (int e = tid; e < tl.ts * width; e += kThreads) {
    const int sl = e / width;
    const int col = col_begin + (e - sl * width);
    const int sg = s0 + sl;
    if (sg < S) out[((size_t)b * S + sg) * c_last + col] = pool[sl * c_last + col];
  }
}

constexpr long kMaxSmemBytes = 232448;  // 227 KB a block can opt into on sm_90

// Tiling for ts centroids per block and chunks of at most max_chunk rows
// (all rows when max_chunk <= 0), with activations and staged weights of
// elem_bytes each; its shared memory in *bytes, -1 if a width is out of
// range.
Tiling make_tiling(int K, int ts, int max_chunk, int n_layers, const int* c, int elem_bytes,
                   long* bytes) {
  Tiling tl;
  tl.ts = ts;
  tl.rows = K * ts;
  tl.rt = tl.rows <= 32 ? 32 : 64;
  tl.rows_pad = (tl.rows + tl.rt - 1) / tl.rt * tl.rt;
  tl.chunk = max_chunk > 0 && max_chunk < tl.rows_pad ? max_chunk : tl.rows_pad;
  tl.ld = tl.chunk + 4;
  tl.groups = 1;
  tl.buf0 = tl.buf1 = 0;
  long b0 = 0, b1 = 0;
  *bytes = -1;
  for (int l = 0; l < n_layers; ++l) {
    if (c[l] < 1 || c[l + 1] < 1) return tl;
    const long need = (long)c[l] * tl.ld;
    if (l % 2 == 0) b0 = need > b0 ? need : b0;
    else b1 = need > b1 ? need : b1;
  }
  tl.buf0 = (int)b0;
  tl.buf1 = (int)b1;
  const int ct = 4 * (kThreads / (tl.rt / 4));
  *bytes = elem_bytes * (b0 + b1 + (long)kStage * ct) + 4L * ts * c[n_layers];
  return tl;
}

template <typename T>
int run_sa_mlp_max(const void* grouped, void* out, int B, int K, int S, int n_layers,
                   const void* const* ws, const void* const* ss, const void* const* tt,
                   const int* cs, void* stream) {
  if (B < 1 || K < 1 || S < 1 || n_layers < 1 || n_layers > kMaxLayers || B > 65535)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  for (int l = 0; l < kMaxLayers; ++l) {
    p.w[l] = (const float*)ws[l];
    p.s[l] = (const float*)ss[l];
    p.t[l] = (const float*)tt[l];
  }
  for (int l = 0; l <= kMaxLayers; ++l) p.c[l] = cs[l];
  p.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l)
    if (!p.w[l] || !p.s[l] || !p.t[l]) return (int)cudaErrorInvalidValue;

  const int eb = (int)sizeof(T);
  int ts = K >= 64 ? 1 : 64 / K;
  if (ts > S) ts = S;
  long bytes = 0;
  Tiling tl = make_tiling(K, ts, 0, n_layers, p.c, eb, &bytes);
  while (bytes >= 0 && bytes > kMaxSmemBytes && ts > 1) {
    ts /= 2;
    tl = make_tiling(K, ts, 0, n_layers, p.c, eb, &bytes);
  }
  while (bytes >= 0 && bytes > kMaxSmemBytes && tl.chunk > tl.rt) {
    const int half = (tl.chunk / 2 + tl.rt - 1) / tl.rt * tl.rt;
    tl = make_tiling(K, ts, half, n_layers, p.c, eb, &bytes);
  }
  if (bytes < 0 || bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)bytes;
  auto kernel = tl.chunk < tl.rows_pad ? sa_mlp_max_kernel<true, T> : sa_mlp_max_kernel<false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
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
  const long tiles = (long)B * ((S + ts - 1) / ts);
  double early = 0.0;
  for (int l = 0; l + 1 < n_layers; ++l) early += (double)p.c[l] * p.c[l + 1];
  const double last = (double)p.c[n_layers - 1] * p.c[n_layers];
  const int ct = 4 * (kThreads / (tl.rt / 4));
  const int passes_last = (p.c[n_layers] + ct - 1) / ct;
  double best = -1.0;
  for (int groups = 1; groups <= passes_last; groups *= 2) {
    const long slots = (long)sms * occ;
    const long waves = (tiles * groups + slots - 1) / slots;
    const double est = waves * (early + last / groups);
    if (best < 0 || est < best) {
      best = est;
      tl.groups = groups;
    }
  }

  const dim3 grid((unsigned)((S + ts - 1) / ts * tl.groups), B);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)grouped, (float*)out, p, tl, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

// grouped (B,K,S,c0) f32 -> out (B,S,c[n_layers]) f32. Layer l reads
// w_l (c_l, c_{l+1}) row-major, s_l and t_l (c_{l+1},); unused layers pass
// NULL and width 0. Tiles of ts = min(S, max(1, 64 / K)) centroids, halved
// until the tile fits in shared memory; a one-centroid tile that still does
// not fit runs its rows in chunks, halved from all of them down to one pass
// of rt rows until they fit. Returns cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after launch.
// bf16 != 0 rounds both operands of every product to bf16 and accumulates
// in f32 (the TPU kernel's bf16=True); bf16 == 0 multiplies in f32.
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
