// Farthest-point sampling for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// fps_pallas / _fps_kernel (the sampling of PointNetPPCls's two FPS stages).
//
// Per cloud b: start at seeds[b]; each of the npoint steps records the
// current point, lowers every point's running minimum squared distance
// (initialised to 1e10) by its distance to that point, in the difference
// form ((dx*dx + dy*dy) + dz*dz), dx = p.x - c.x, and moves to the point
// whose running minimum is largest, equal values to the lowest index
// (jnp.argmax's first occurrence).
//
// Bound on this card: the bytes (the cloud read once, 12 B a point) and the
// operations (~10 a point a step: at B=64, N=1024, npoint=512, ~3e8) are
// microseconds. What holds it back is the npoint dependent steps, each a
// block-wide argmax, on only B of the 132 SMs. Design: one block per cloud;
// each thread keeps the running minimum of its strided slice of points in
// registers (PPT of them, a template so the array stays in registers), and
// the cloud sits in shared memory when it fits (12 B a point, up to
// N = 19,285), else it is read through L1. Clouds of up to 1,024 points get
// at most 256 threads (8 warps: short barriers for the short steps of the
// classifier's stages); larger clouds get up to 1,024 threads, so that the
// many points of a step are spread over 32 warps. A step is a butterfly
// warp argmax, one barrier, and a second butterfly over the warp winners
// that every warp does for itself; the winners alternate between two shared
// buffers, so one barrier a step suffices.
//
// Clouds above kMaxN = 32,768 points (512 threads of 64 registers each)
// take a second kernel: the running minima live in a (B, N) device buffer
// that the caller allocates, the cloud is read from device memory (at
// 65,536 points 786 KB a cloud, which stays in the 50 MB L2 across the
// steps), each of 1,024 threads strides over its points, and the argmax is
// the same two-level butterfly with the lowest index winning ties.
//
// Later work: split one cloud over a thread-block cluster and merge the
// argmax through distributed shared memory, so that a cloud uses several
// SMs and the steps get shorter.
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py fps_plain) and
// the indices are equal exactly, ties included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxN = 32768;            // the register kernel's largest cloud
constexpr int kMaxNGlobal = 1 << 30;    // n + blockDim stays within int
constexpr int kMaxWarps = 32;
constexpr int kMaxCloudSmem = 232448 - 1024;  // leaves room for the static buffers
constexpr unsigned kFull = 0xffffffffu;

// (d, i) before (od, oi): the larger distance, equal distances to the lower index
__device__ __forceinline__ bool key_greater(float d, int i, float od, int oi) {
  return d > od || (d == od && i < oi);
}

// Butterfly: every lane ends with the warp's (d, i) maximum.
__device__ __forceinline__ void warp_argmax(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (key_greater(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// PPT points a thread, at most MAXT threads (the register budget)
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ seeds, int* __restrict__ out,
           int N, int npoint, int cloud_in_smem) {
  extern __shared__ float cloud[];  // (N, 3) when cloud_in_smem
  __shared__ float cand_d[2][kMaxWarps];
  __shared__ int cand_i[2][kMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* g = xyz + (size_t)b * N * 3;
  const float* pts = g;
  if (cloud_in_smem) {
    for (int e = tid; e < 3 * N; e += T) cloud[e] = g[e];
    __syncthreads();
    pts = cloud;
  }

  float dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) dist[j] = 1e10f;
  int far = seeds[b];
  far = far < 0 ? 0 : (far >= N ? N - 1 : far);  // keeps the reads in bounds
  int* o = out + (size_t)b * npoint;

  for (int it = 0;; ++it) {
    if (tid == 0) o[it] = far;
    if (it + 1 == npoint) break;
    const float cx = pts[3 * far], cy = pts[3 * far + 1], cz = pts[3 * far + 2];
    float best_d = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int n = tid + j * T;
      if (n < N) {
        const float dx = __fsub_rn(pts[3 * n], cx);
        const float dy = __fsub_rn(pts[3 * n + 1], cy);
        const float dz = __fsub_rn(pts[3 * n + 2], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(dist[j], d);
        dist[j] = m;
        if (m > best_d) {  // n rises with j: equal values keep the lower index
          best_d = m;
          best_i = n;
        }
      }
    }
    warp_argmax(best_d, best_i);
    const int buf = it & 1;
    if (lane == 0) {
      cand_d[buf][warp] = best_d;
      cand_i[buf][warp] = best_i;
    }
    __syncthreads();
    float d = lane < nwarps ? cand_d[buf][lane] : -INFINITY;
    int i = lane < nwarps ? cand_i[buf][lane] : INT_MAX;
    warp_argmax(d, i);
    far = i == INT_MAX ? 0 : i;  // INT_MAX only when every distance is NaN
  }
}

// Clouds above kMaxN: the running minima in dist (B, N), initialised here.
__global__ void __launch_bounds__(1024)
fps_global_kernel(const float* __restrict__ xyz, const int* __restrict__ seeds,
                  int* __restrict__ out, float* __restrict__ dist_all, int N, int npoint) {
  __shared__ float cand_d[2][kMaxWarps];
  __shared__ int cand_i[2][kMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* pts = xyz + (size_t)b * N * 3;
  float* dist = dist_all + (size_t)b * N;
  for (int n = tid; n < N; n += T) dist[n] = 1e10f;
  int far = seeds[b];
  far = far < 0 ? 0 : (far >= N ? N - 1 : far);
  int* o = out + (size_t)b * npoint;

  for (int it = 0;; ++it) {
    if (tid == 0) o[it] = far;
    if (it + 1 == npoint) break;
    const float cx = pts[3 * (size_t)far], cy = pts[3 * (size_t)far + 1],
                cz = pts[3 * (size_t)far + 2];
    float best_d = -INFINITY;
    int best_i = INT_MAX;
    for (int n = tid; n < N; n += T) {  // each thread sees its own entries only
      const float dx = __fsub_rn(pts[3 * (size_t)n], cx);
      const float dy = __fsub_rn(pts[3 * (size_t)n + 1], cy);
      const float dz = __fsub_rn(pts[3 * (size_t)n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[n], d);
      dist[n] = m;
      if (m > best_d) {  // n rises: equal values keep the lower index
        best_d = m;
        best_i = n;
      }
    }
    warp_argmax(best_d, best_i);
    const int buf = it & 1;
    if (lane == 0) {
      cand_d[buf][warp] = best_d;
      cand_i[buf][warp] = best_i;
    }
    __syncthreads();
    float d = lane < nwarps ? cand_d[buf][lane] : -INFINITY;
    int i = lane < nwarps ? cand_i[buf][lane] : INT_MAX;
    warp_argmax(d, i);
    far = i == INT_MAX ? 0 : i;
  }
}

template <int PPT, int MAXT>
int launch(const float* xyz, const int* seeds, int* out, int B, int N, int npoint,
           cudaStream_t stream) {
  const int threads = ((N + PPT - 1) / PPT + 31) / 32 * 32;
  const int cloud_bytes = 12 * N;
  const int in_smem = cloud_bytes <= kMaxCloudSmem;
  const int smem = in_smem ? cloud_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PPT, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PPT, MAXT><<<B, threads, smem, stream>>>(xyz, seeds, out, N, npoint, in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B,N,3) f32, seeds (B,) i32 start indices in [0, N) -> out (B,npoint)
// i32. dist is a (B,N) f32 buffer for N > 32,768 (its contents are
// overwritten) and may be NULL below that. Returns cudaErrorInvalidValue for
// arguments the kernels do not take, else cudaGetLastError() after the
// launch.
extern "C" int pcot_fps_f32(const void* xyz, const void* seeds, void* out, void* dist, int B,
                            int N, int npoint, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNGlobal || npoint < 1) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const int* s = (const int*)seeds;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 256) return launch<1, 256>(x, s, o, B, N, npoint, st);
  if (N <= 512) return launch<2, 256>(x, s, o, B, N, npoint, st);
  if (N <= 1024) return launch<4, 256>(x, s, o, B, N, npoint, st);
  if (N <= 2048) return launch<2, 1024>(x, s, o, B, N, npoint, st);
  if (N <= 4096) return launch<4, 1024>(x, s, o, B, N, npoint, st);
  if (N <= 8192) return launch<8, 1024>(x, s, o, B, N, npoint, st);
  if (N <= 16384) return launch<16, 1024>(x, s, o, B, N, npoint, st);
  if (N <= kMaxN) return launch<64, 512>(x, s, o, B, N, npoint, st);
  if (!dist) return (int)cudaErrorInvalidValue;
  fps_global_kernel<<<B, 1024, 0, st>>>(x, s, o, (float*)dist, N, npoint);
  return (int)cudaGetLastError();
}
