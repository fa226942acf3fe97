// Fused set-abstraction grouping for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// _sa_group_call / _sa_group_kernel / _select_passes (reached through
// sa_group_coords_pallas and sa_group_feats_pallas).
//
// Per (cloud b, centroid s): gather the centroid by cidx, compute the exact
// f32 squared distances c2 - 2*c.x + x2 to all N points, take the K nearest
// (nearest first, equal distances to the lowest index), gather their
// [xyz | feats] rows and center the xyz on the centroid.
//
// Bound on this card: bytes (the cloud read, the grouped rows written) at
// N=1024 and at sa2, the distances' operations at N=10,000; selecting K of
// N needs about one compare a point. The selection is the exact threshold
// select of csrc/threshold_select.cuh: a few 8-bit radix passes over unique
// (distance, index) keys and a rank sort of the K winners. It replaced K
// dependent block-wide argmin passes (two barriers each), which held the
// kernel at 0.6-12% of its bound (chip_sweep.py times both selections on
// the same distance tiles, PERF.md). Two designs, by cloud size:
// - N <= 1,024 (sa1 at the bench's N=1024, sa2): one warp per centroid,
//   eight centroids of one cloud a block, the cloud staged once in shared
//   memory (12 KB at N=1024); a lane keeps the keys of its N / 32 points in
//   registers and the select needs no block barrier;
// - larger N: one block per centroid, the N keys staged in shared memory
//   (N <= 10,240 gives at most 40 KB, under the 48 KB default), the
//   block-wide select; the rows are gathered from global memory.
//
// Exactness: the products and sums run in one fixed order through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py), and the
// keys are unique, so the selected indices are equal exactly, ties
// included. Distances that are NaN (NaN coordinates) are never selected
// before a number; past the numbers the index is 0.

#include <cuda_runtime.h>

#include "threshold_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // centroids a block of the warp design
constexpr int kMaxK = 128;
constexpr int kMaxN = 10240;     // N keys of shared memory stay under 48 KB
constexpr int kWarpMaxN = 1024;  // the warp design: 32 keys a lane at most

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The centroid's K winners: their rows of [xyz - centroid | feats] into
// grouped (B, K, S, 3 + D), their indices, and the centroid, by threads t,
// t + nt, ... of nt, kInFlight loads in flight a thread; pts is the
// cloud's points (global or staged).
constexpr int kInFlight = 4;

__device__ __forceinline__ void write_group(const float* pts, const float* __restrict__ feats,
                                            const int* winners, float cx, float cy, float cz,
                                            float* __restrict__ new_xyz,
                                            float* __restrict__ grouped,
                                            int* __restrict__ idx_out, int b, int s, int N,
                                            int S, int K, int D, int t, int nt) {
  const int C = 3 + D;
  const size_t row_stride = (size_t)S * C;  // grouped is (B, K, S, C)
  float* out = grouped + ((size_t)b * K * S + s) * C;
  for (int e0 = t; e0 < K * C; e0 += kInFlight * nt) {
    float v[kInFlight];
    size_t o[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * nt;
      if (e >= K * C) break;
      const int k = e / C;
      const int ch = e - k * C;
      const int w = winners[k];
      if (ch < 3) {
        const float cc = ch == 0 ? cx : (ch == 1 ? cy : cz);
        v[u] = __fsub_rn(pts[3 * w + ch], cc);
      } else {
        v[u] = feats[((size_t)b * N + w) * D + (ch - 3)];
      }
      o[u] = k * row_stride + ch;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (e0 + u * nt < K * C) out[o[u]] = v[u];
  }
  for (int k = t; k < K; k += nt) idx_out[((size_t)b * S + s) * K + k] = winners[k];
  if (t < 3) new_xyz[((size_t)b * S + s) * 3 + t] = t == 0 ? cx : (t == 1 ? cy : cz);
}

// One warp a centroid, kWarps centroids of cloud b a block; the cloud in
// dynamic shared memory, each lane's kPer keys in registers.
template <int kPer>
__global__ void __launch_bounds__(kThreads)
sa_group_warp_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
                     const int* __restrict__ cidx, float* __restrict__ new_xyz,
                     float* __restrict__ grouped, int* __restrict__ idx_out, int N, int S,
                     int K, int D, int pbits) {
  extern __shared__ float pts[];  // the cloud, N x 3
  __shared__ unsigned hist[kWarps][pcot_select::kBins];
  __shared__ unsigned long long cand[kWarps][kMaxK];
  __shared__ int winners[kWarps][kMaxK];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = xyz + (size_t)b * N * 3;
  for (int i = threadIdx.x; i < 3 * N; i += kThreads) pts[i] = __ldg(src + i);
  __syncthreads();  // the block's only barrier
  const int s = blockIdx.x * kWarps + warp;
  if (s >= S) return;

  const int c = cidx[(size_t)b * S + s];
  const float cx = pts[3 * c], cy = pts[3 * c + 1], cz = pts[3 * c + 2];
  const float c2 = sq_norm(cx, cy, cz);
  unsigned key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = lane + 32 * j;
    key[j] = 0u;
    if (n < N) {
      const float x = pts[3 * n], y = pts[3 * n + 1], z = pts[3 * n + 2];
      const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)),
                                    __fmul_rn(cz, z));
      key[j] = pcot_select::order_key(
          __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), sq_norm(x, y, z)));
    }
  }
  pcot_select::warp_select_sorted<kPer, kMaxK>(key, N, K, pbits, hist[warp], cand[warp],
                                               winners[warp]);
  write_group(pts, feats, winners[warp], cx, cy, cz, new_xyz, grouped, idx_out, b, s, N, S, K,
              D, lane, 32);
}

// One block a centroid; its N keys in dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
sa_group_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
                const int* __restrict__ cidx, float* __restrict__ new_xyz,
                float* __restrict__ grouped, int* __restrict__ idx_out,
                int N, int S, int K, int D, int pbits) {
  extern __shared__ unsigned keys[];  // N order keys
  __shared__ pcot_select::Shared<kMaxK> sh;
  __shared__ int winners[kMaxK];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* pts = xyz + (size_t)b * N * 3;

  const int c = cidx[(size_t)b * S + s];
  const float cx = pts[3 * c], cy = pts[3 * c + 1], cz = pts[3 * c + 2];
  const float c2 = sq_norm(cx, cy, cz);

  for (int n = tid; n < N; n += kThreads) {
    const float x = pts[3 * n], y = pts[3 * n + 1], z = pts[3 * n + 2];
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)),
                                  __fmul_rn(cz, z));
    const float d = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), sq_norm(x, y, z));
    keys[n] = pcot_select::order_key(d);
  }
  __syncthreads();
  pcot_select::select_sorted<kMaxK>(keys, N, K, pbits, sh, winners);
  write_group(pts, feats, winners, cx, cy, cz, new_xyz, grouped, idx_out, b, s, N, S, K, D, tid,
              kThreads);
}

}  // namespace

// xyz (B,N,3) f32, feats (B,N,D) f32 or NULL when D == 0, cidx (B,S) i32 in
// [0, N). Outputs: new_xyz (B,S,3), grouped (B,K,S,3+D), idx (B,S,K) i32.
// Returns cudaGetLastError() after the launch.
extern "C" int pcot_sa_group_f32(const void* xyz, const void* feats, const void* cidx,
                                 void* new_xyz, void* grouped, void* idx, int B, int N,
                                 int S, int K, int D, void* stream) {
  if (B < 1 || S < 1 || K < 1 || K > kMaxK || N < K || N > kMaxN || D < 0 || S > 65535 || B > 65535 ||
      (D > 0 && feats == nullptr))
    return (int)cudaErrorInvalidValue;
  const int pbits = pcot_select::position_bits(N);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)xyz;
  const float* f = (const float*)feats;
  const int* ci = (const int*)cidx;
  float* nx = (float*)new_xyz;
  float* g = (float*)grouped;
  int* ix = (int*)idx;
  if (N <= kWarpMaxN) {
    const dim3 grid((S + kWarps - 1) / kWarps, B);
    const size_t smem = (size_t)N * 3 * sizeof(float);
    if (N <= 128)
      sa_group_warp_kernel<4><<<grid, kThreads, smem, st>>>(x, f, ci, nx, g, ix, N, S, K, D, pbits);
    else if (N <= 256)
      sa_group_warp_kernel<8><<<grid, kThreads, smem, st>>>(x, f, ci, nx, g, ix, N, S, K, D, pbits);
    else if (N <= 512)
      sa_group_warp_kernel<16><<<grid, kThreads, smem, st>>>(x, f, ci, nx, g, ix, N, S, K, D,
                                                             pbits);
    else
      sa_group_warp_kernel<32><<<grid, kThreads, smem, st>>>(x, f, ci, nx, g, ix, N, S, K, D,
                                                             pbits);
  } else {
    sa_group_kernel<<<dim3(S, B), kThreads, (size_t)N * sizeof(unsigned), st>>>(
        x, f, ci, nx, g, ix, N, S, K, D, pbits);
  }
  return (int)cudaGetLastError();
}
