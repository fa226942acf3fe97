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
// ~3e8 in all, ~0.0045 ms at the f32 peak; the bytes are a few MB. Design:
// one block per centroid, the N distances staged in dynamic shared memory
// as order keys (N <= 20,480 gives at most 80 KB, above the 48 KB default,
// so the host opts in with cudaFuncSetAttribute), then the exact threshold
// select of csrc/threshold_select.cuh (the selection of csrc/sa_group.cu):
// a few 8-bit radix passes over unique (distance, index) keys and a rank
// sort of the K winners, in place of K dependent block-wide argmin passes
// with two barriers each (chip_sweep.py, PERF.md).
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py knn_plain),
// and the keys are unique, so the indices are equal exactly, ties
// included. NaN distances are never selected before a number; past the
// numbers the index is 0.

#include <cuda_runtime.h>

#include "threshold_select.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 128;
constexpr int kMaxN = 20480;  // N keys of dynamic shared memory: 80 KB

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
           int* __restrict__ idx_out, int N, int S, int K, int pbits) {
  extern __shared__ unsigned keys[];  // N order keys
  __shared__ pcot_select::Shared<kMaxK> sh;
  __shared__ int winners[kMaxK];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* pts = xyz + (size_t)b * N * 3;
  const float* c = new_xyz + ((size_t)b * S + s) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];

  for (int n = tid; n < N; n += kThreads) {
    const float dx = __fsub_rn(cx, pts[3 * n]);
    const float dy = __fsub_rn(cy, pts[3 * n + 1]);
    const float dz = __fsub_rn(cz, pts[3 * n + 2]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    keys[n] = pcot_select::order_key(d);
  }
  __syncthreads();
  pcot_select::select_sorted<kMaxK>(keys, N, K, pbits, sh, winners);
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
  const int smem = N * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(knn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<<<dim3(S, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)new_xyz, (const float*)xyz, (int*)idx, N, S, K,
      pcot_select::position_bits(N));
  return (int)cudaGetLastError();
}
