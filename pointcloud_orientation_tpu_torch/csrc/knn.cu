// Exact kNN indices for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// knn_pallas / _knn_kernel, which the JAX package runs for clouds of
// 10,240 < N <= 20,480 points (above the fused grouping kernel's size).
//
// Per (cloud b, centroid s): the squared distances from new_xyz[b, s] to all
// N points of xyz[b] in the difference form ((dx*dx + dy*dy) + dz*dz),
// dx = c.x - p.x (the order of _knn_kernel's `d = d + diff * diff` loop over
// the three coordinates), then the K nearest, nearest first, equal distances
// to the lowest index (jnp.argmin's first occurrence).
//
// Bound on this card: at B=16, S=128, N=16,384, K=32 the distances are
// ~2.7e8 operations and selecting K of N needs about one compare per point,
// ~3e8 in all, ~0.0045 ms at the f32 peak; the bytes are a few MB. What
// holds a simple kernel back is neither: it is the K dependent selection
// passes, each a block-wide argmin with two barriers. Design: one block per centroid, the N distances in
// dynamic shared memory (N <= 20,480 gives at most 80 KB, above the 48 KB
// default, so the host opts in with cudaFuncSetAttribute). Each thread keeps
// the minimum of its own strided slice in registers, so a pass is one
// warp-shuffle reduction plus a shared-memory merge of the warp winners, and
// only the thread that owned the winner rescans its slice (the selection of
// csrc/sa_group.cu).
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py knn_plain) and
// the indices are equal exactly, ties included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kMaxN = 20480;  // N floats of dynamic shared memory: 80 KB
constexpr unsigned kFull = 0xffffffffu;

// (d, i) < (od, oi) lexicographically. NaN never compares less, so slots
// marked taken (NaN) are never picked again.
__device__ __forceinline__ bool key_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
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
knn_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
           int* __restrict__ idx_out, int N, int S, int K) {
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
  const float* c = new_xyz + ((size_t)b * S + s) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];

  float best_d = INFINITY;
  int best_i = INT_MAX;
  for (int n = tid; n < N; n += kThreads) {
    const float dx = __fsub_rn(cx, pts[3 * n]);
    const float dy = __fsub_rn(cy, pts[3 * n + 1]);
    const float dz = __fsub_rn(cz, pts[3 * n + 2]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
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
      // index 0 keeps a later gather in bounds.
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
  if (tid < K) idx_out[((size_t)b * S + s) * K + tid] = winners[tid];
}

}  // namespace

// new_xyz (B,S,3) f32, xyz (B,N,3) f32 -> idx (B,S,K) i32, nearest first.
// Returns cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int pcot_knn_f32(const void* new_xyz, const void* xyz, void* idx, int B, int N,
                            int S, int K, void* stream) {
  if (B < 1 || S < 1 || K < 1 || K > kMaxK || N < K || N > kMaxN || S > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = N * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<<<dim3(S, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)new_xyz, (const float*)xyz, (int*)idx, N, S, K);
  return (int)cudaGetLastError();
}
