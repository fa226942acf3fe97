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
// Bound on this card: the work is tiny next to the bytes it must write
// (grouped is K*C floats per centroid); what holds a simple kernel back is
// the K dependent selection passes, each a block-wide argmin. Design: one
// block per centroid, the N distances in shared memory (N <= 10,240 gives at
// most 40 KB, under the 48 KB default). Each thread keeps the minimum of its
// own strided slice in registers, so a pass is one warp-shuffle reduction
// plus a shared-memory merge of 8 warp winners, and only the thread that
// owned the winner rescans its slice. Rows are gathered straight from global
// memory at the end.
//
// Exactness: the products and sums run in one fixed order through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py) and the
// selected indices are equal exactly, ties included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kMaxN = 10240;  // N floats of shared memory stay under 48 KB
constexpr unsigned kFull = 0xffffffffu;

// (d, i) < (od, oi) lexicographically. NaN never compares less, so slots
// marked taken (NaN) are never picked again.
__device__ __forceinline__ bool key_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ void warp_argmin(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(kFull, d, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (key_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sa_group_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
                const int* __restrict__ cidx, float* __restrict__ new_xyz,
                float* __restrict__ grouped, int* __restrict__ idx_out,
                int N, int S, int K, int D) {
  extern __shared__ float dist[];  // N floats
  __shared__ float red_d[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int winners[kMaxK];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + (size_t)b * N * 3;

  const int c = cidx[(size_t)b * S + s];
  const float cx = pts[3 * c], cy = pts[3 * c + 1], cz = pts[3 * c + 2];
  const float c2 = sq_norm(cx, cy, cz);

  float best_d = INFINITY;
  int best_i = INT_MAX;
  for (int n = tid; n < N; n += kThreads) {
    const float x = pts[3 * n], y = pts[3 * n + 1], z = pts[3 * n + 2];
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)),
                                  __fmul_rn(cz, z));
    const float d = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), sq_norm(x, y, z));
    dist[n] = d;
    if (key_less(d, n, best_d, best_i)) {
      best_d = d;
      best_i = n;
    }
  }

  for (int k = 0; k < K; ++k) {
    float d = best_d;
    int i = best_i;
    warp_argmin(d, i);
    if (lane == 0) {
      red_d[warp] = d;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      d = lane < kWarps ? red_d[lane] : INFINITY;
      i = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_argmin(d, i);
      // INT_MAX: no candidate left, which only NaN coordinates can cause;
      // index 0 keeps the gather in bounds.
      if (lane == 0) winners[k] = i == INT_MAX ? 0 : i;
    }
    __syncthreads();
    const int w = winners[k];
    if (w % kThreads == tid) {  // the owner of the winner rescans its slice
      dist[w] = NAN;
      best_d = INFINITY;
      best_i = INT_MAX;
      for (int n = tid; n < N; n += kThreads) {
        const float dn = dist[n];
        if (key_less(dn, n, best_d, best_i)) {
          best_d = dn;
          best_i = n;
        }
      }
    }
  }

  const int C = 3 + D;
  const size_t row_stride = (size_t)S * C;  // grouped is (B, K, S, C)
  float* out = grouped + ((size_t)b * K * S + s) * C;
  for (int e = tid; e < K * C; e += kThreads) {
    const int k = e / C;
    const int ch = e - k * C;
    const int w = winners[k];
    float v;
    if (ch < 3) {
      const float cc = ch == 0 ? cx : (ch == 1 ? cy : cz);
      v = __fsub_rn(pts[3 * w + ch], cc);
    } else {
      v = feats[((size_t)b * N + w) * D + (ch - 3)];
    }
    out[k * row_stride + ch] = v;
  }
  if (tid < K) idx_out[((size_t)b * S + s) * K + tid] = winners[tid];
  if (tid < 3) new_xyz[((size_t)b * S + s) * 3 + tid] = tid == 0 ? cx : (tid == 1 ? cy : cz);
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
  const size_t smem = (size_t)N * sizeof(float);
  sa_group_kernel<<<dim3(S, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)feats, (const int*)cidx, (float*)new_xyz,
      (float*)grouped, (int*)idx, N, S, K, D);
  return (int)cudaGetLastError();
}
