// Radius ball query for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// ball_query_pallas / _ball_kernel (the grouping of PointNetPPCls's two SA
// stages).
//
// Per (cloud b, centroid s): the nsample points of xyz[b] with the smallest
// indices among those whose squared distance to new_xyz[b, s] is
// <= radius_sq; in ascending index order. Slots beyond the points found hold
// the first index found; a centroid with no point in its radius gets N - 1
// in every slot (the TPU kernel's sentinel N, clipped into range).
//
// Two distance forms, as the JAX package picks them on the TPU by cloud
// size: the difference form ((dx*dx + dy*dy) + dz*dz), dx = c.x - p.x, of
// ball_query_pallas (1024 <= N <= 20,480), and the matmul form
// (c2 - 2*cross) + x2 of its XLA path (every other N, the classifier's
// second stage at N = 512 among them), with c2, x2 and cross each
// ((x*x + y*y) + z*z)-ordered as in sa_group.cu. The two forms round
// differently, so a point on the radius can fall inside in one and outside
// in the other.
//
// Bound on this card: bytes. The TPU kernel computes the whole (S, N)
// distance tile and then takes nsample min-passes over it; the answer only
// needs the points up to the nsample-th one inside the radius, so the work
// depends on the data. Design: one warp per centroid scans the cloud in
// index order, 32 points at a time: each lane tests one point,
// __ballot_sync gathers the in-radius lanes and __popc of the lanes below
// gives each hit its slot, so the hits are written in ascending order with
// no selection pass; the warp stops as soon as nsample are found.
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the in-radius test is
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py
// ball_query_plain) in either form and the indices are equal exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // centroids per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// kMatmul: the matmul form (c2 - 2*cross) + x2; else the difference form.
template <bool kMatmul>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                  int* __restrict__ idx_out, int N, int S, int K, float radius_sq) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= S) return;  // the whole warp
  const float* c = new_xyz + ((size_t)b * S + s) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float c2 = sq_norm(cx, cy, cz);
  const float* pts = xyz + (size_t)b * N * 3;
  int* out = idx_out + ((size_t)b * S + s) * K;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  int count = 0;  // hits so far (the same in every lane)
  int first = N;  // the first hit, N while there is none
  for (int base = 0; base < N && count < K; base += 32) {
    const int n = base + lane;
    bool hit = false;
    if (n < N) {
      const float px = pts[3 * n], py = pts[3 * n + 1], pz = pts[3 * n + 2];
      float d;
      if (kMatmul) {
        const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                                      __fmul_rn(cz, pz));
        d = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), sq_norm(px, py, pz));
      } else {
        d = sq_norm(__fsub_rn(cx, px), __fsub_rn(cy, py), __fsub_rn(cz, pz));
      }
      hit = d <= radius_sq;
    }
    const unsigned mask = __ballot_sync(kFull, hit);
    if (mask != 0u) {
      if (first == N) first = base + __ffs(mask) - 1;
      const int slot = count + __popc(mask & below);
      if (hit && slot < K) out[slot] = n;
      count += __popc(mask);
    }
  }
  const int fill = first < N ? first : N - 1;
  for (int k = count + lane; k < K; k += 32) out[k] = fill;
}

}  // namespace

// new_xyz (B,S,3) f32, xyz (B,N,3) f32 -> idx (B,S,K) i32. radius_sq is the
// squared radius, rounded to f32 by the caller; matmul_form picks the
// matmul-form distance (1) or the difference form (0). Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int pcot_ball_query_f32(const void* new_xyz, const void* xyz, void* idx, int B,
                                   int N, int S, int K, float radius_sq, int matmul_form,
                                   void* stream) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kWarps - 1) / kWarps), (unsigned)B);
  auto kernel = matmul_form ? ball_query_kernel<true> : ball_query_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)new_xyz, (const float*)xyz, (int*)idx, N, S, K, radius_sq);
  return (int)cudaGetLastError();
}
