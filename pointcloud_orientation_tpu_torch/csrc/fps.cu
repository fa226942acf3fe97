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
// microseconds. What holds it back is the npoint dependent steps, each an
// argmax over the whole cloud: a step costs its reductions and barriers, and
// one block a cloud uses only B of the 132 SMs.
//
// Design, by shape:
// - One cloud over a thread-block cluster of C blocks (cudaLaunchKernelEx
//   with a cluster dimension; C = 1 is a plain block, the classifier's
//   clouds of 512 and 1,024 points). Block r of the cluster takes the r-th
//   slice of the cloud: its running minima in registers (PPT a thread, a
//   template so the array stays in registers) and, up to 16 points a
//   thread, its coordinates too (a copy in shared memory serves the lookup
//   of the block's winner); larger slices read their coordinates from shared
//   memory when they fit, else through L1. A step: the block argmax (a
//   butterfly a warp, one barrier, a butterfly over the warp winners); with
//   C > 1, lanes 0..C-1 of warp 0 then push the block's winner record
//   (d, i, x, y, z) into slot [rank] of every block of the cluster
//   (st.shared::cluster through mapa: posted stores, no round trip), one
//   cluster barrier (warp 0 arrives with release semantics, the others
//   relaxed; every thread waits with acquire), and every warp merges the C
//   records from its own shared memory by the same rule. The new centre's
//   coordinates come with its record, so no block fetches them. The merge is
//   a total order on (d, i), so any order of ranks gives the plain
//   version's index. Slots are double-buffered: a block overwrites slot
//   [rank] of a buffer only after the next barrier, which every reader of
//   that buffer has passed. A final cluster barrier keeps every block's
//   shared memory alive until the last remote store has landed.
// - C is the largest power of two up to 16 that keeps B * C within the SMs
//   and at least kMinSlice points a block, raised to what the registers
//   need (kBlockMaxN points a block); a cluster that
//   cudaOccupancyMaxActiveClusters says cannot fit is refused. Measured on
//   the H100 (chip_sweep.py, PERF.md): a cluster step pays its barrier, so
//   at B=16 N=10,000 clusters of 8 take 0.76 ms against 0.90-0.94 for 4, 2
//   or 1 block a cloud; at N=1,024 one block of 256 threads a cloud beats a
//   cluster of 2 (2.0x slower) and 128, 64 or 32 threads a cloud (1.1x,
//   1.7x, 3.8x slower: fewer warps cannot hide the latency of the dependent
//   steps).
// - Clouds above a cluster's registers (16 x 32,768 points): the running
//   minima live in a (B, N) device buffer that the caller allocates, one
//   block of 1,024 threads a cloud strides over them.
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the distances are
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py fps_plain) and
// the indices are equal exactly, ties included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kBlockMaxN = 32768;        // a block's registers: 512 threads x 64
constexpr int kMaxCluster = 16;          // non-portable cluster size on the H100
constexpr int kClusterMaxN = kMaxCluster * kBlockMaxN;
constexpr int kMinSlice = 1024;          // fewer points a block do not pay a merge
constexpr int kMaxNGlobal = 1 << 30;     // n + blockDim stays within int
constexpr int kMaxWarps = 32;
constexpr int kMaxCloudSmem = 232448 - 1024;  // leaves room for the static buffers
constexpr unsigned kFull = 0xffffffffu;

// (d, i) before (od, oi): the larger distance, equal distances to the lower index
__device__ __forceinline__ bool key_greater(float d, int i, float od, int oi) {
  return d > od || (d == od && i < oi);
}

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cloud over a cluster of C blocks (C = 1: one block), block r of the
// cluster on points [r * slice, min(N, (r + 1) * slice)), PPT a thread, at
// most MAXT threads (the register budget).
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ seeds, int* __restrict__ out,
           int N, int npoint, int C, int slice, int cloud_in_smem) {
  extern __shared__ float cloud[];  // (slice, 3) when cloud_in_smem
  __shared__ float cand_d[2][kMaxWarps];
  __shared__ int cand_i[2][kMaxWarps];
  // winner records of the cluster's blocks by rank: {d, i, x, y}, {z, -, -, -}
  __shared__ __align__(16) float4 slot[2][kMaxCluster][2];
  constexpr bool kRegs = PPT <= 16 && MAXT <= 512;  // coordinates in registers

  const int b = blockIdx.x / C;
  const int rank = blockIdx.x - b * C;  // a 1-D cluster of C consecutive blocks
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int lo = rank * slice;
  const int n_here = max(0, min(N - lo, slice));
  const float* g = xyz + (size_t)b * N * 3;
  const float* pts = g + 3 * (size_t)lo;  // this block's points, local index
  if (cloud_in_smem) {
    for (int e = tid; e < 3 * n_here; e += T) cloud[e] = pts[e];
    __syncthreads();
    pts = cloud;
  }

  float dist[PPT];
  float px[kRegs ? PPT : 1], py[kRegs ? PPT : 1], pz[kRegs ? PPT : 1];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    dist[j] = 1e10f;
    if (kRegs) {
      const int n = tid + j * T;
      px[j] = n < n_here ? pts[3 * n] : 0.f;
      py[j] = n < n_here ? pts[3 * n + 1] : 0.f;
      pz[j] = n < n_here ? pts[3 * n + 2] : 0.f;
    }
  }
  int far = seeds[b];
  far = far < 0 ? 0 : (far >= N ? N - 1 : far);  // keeps the reads in bounds
  float cx = g[3 * (size_t)far], cy = g[3 * (size_t)far + 1], cz = g[3 * (size_t)far + 2];
  int* o = out + (size_t)b * npoint;

  for (int it = 0;; ++it) {
    // the last thread writes: not warp 0, whose release would wait for it
    if (rank == 0 && tid == T - 1) o[it] = far;
    if (it + 1 == npoint) break;
    float best_d = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int n = tid + j * T;
      if (n < n_here) {
        const float d = kRegs ? sq_dist(px[j], py[j], pz[j], cx, cy, cz)
                              : sq_dist(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], cx, cy, cz);
        const float m = fminf(dist[j], d);
        dist[j] = m;
        if (m > best_d) {  // n rises with j: equal values keep the lower index
          best_d = m;
          best_i = lo + n;
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
    if (C == 1) {
      float d = lane < nwarps ? cand_d[buf][lane] : -INFINITY;
      int i = lane < nwarps ? cand_i[buf][lane] : INT_MAX;
      warp_argmax(d, i);
      far = i == INT_MAX ? 0 : i;  // INT_MAX only when every distance is NaN
      cx = pts[3 * (size_t)far];
      cy = pts[3 * (size_t)far + 1];
      cz = pts[3 * (size_t)far + 2];
      continue;
    }
    if (warp == 0) {  // the block's winner, pushed to every block of the cluster
      float d = lane < nwarps ? cand_d[buf][lane] : -INFINITY;
      int i = lane < nwarps ? cand_i[buf][lane] : INT_MAX;
      warp_argmax(d, i);
      if (lane < C) {
        float x = 0.f, y = 0.f, z = 0.f;
        if (i != INT_MAX) {
          const int n = i - lo;
          x = pts[3 * n];
          y = pts[3 * n + 1];
          z = pts[3 * n + 2];
        }
        const unsigned dst = map_rank(smem_u32(&slot[buf][rank][0]), (unsigned)lane);
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "f"(d),
                     "f"(__int_as_float(i)), "f"(x), "f"(y)
                     : "memory");
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(dst + 16), "f"(z) : "memory");
      }
      cluster_arrive_release();
    } else {
      cluster_arrive_relaxed();  // these warps published nothing
    }
    cluster_wait();
    float md = -INFINITY;
    int mi = INT_MAX;
    if (lane < C) {
      const float4 r = slot[buf][lane][0];
      md = r.x;
      mi = __float_as_int(r.y);
    }
    warp_argmax(md, mi);
    if (mi == INT_MAX) {  // every distance NaN: point 0, as the plain version
      far = 0;
      cx = g[0];
      cy = g[1];
      cz = g[2];
    } else {
      far = mi;
      const int r = mi / slice;  // the rank that owns the winner
      const float4 w = slot[buf][r][0];
      cx = w.z;
      cy = w.w;
      cz = slot[buf][r][1].x;
    }
  }
  if (C > 1) {  // no block leaves while a remote store into it may be in flight
    cluster_arrive_release();
    cluster_wait();
  }
}

// Clouds above a cluster's registers: the running minima in dist (B, N),
// initialised here.
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
      const float m = fminf(dist[n], sq_dist(pts[3 * (size_t)n], pts[3 * (size_t)n + 1],
                                             pts[3 * (size_t)n + 2], cx, cy, cz));
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

// One cloud over C blocks of slice points each (slice <= PPT * MAXT).
template <int PPT, int MAXT>
int launch_block(const float* xyz, const int* seeds, int* out, int B, int N, int npoint, int C,
                 int slice, cudaStream_t stream) {
  auto kernel = fps_kernel<PPT, MAXT>;
  const int threads = ((slice + PPT - 1) / PPT + 31) / 32 * 32;
  const int in_smem = 12 * slice <= kMaxCloudSmem;
  const int smem = in_smem ? 12 * slice : 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (C == 1) {
    kernel<<<B, threads, smem, stream>>>(xyz, seeds, out, N, npoint, 1, slice, in_smem);
    return (int)cudaGetLastError();
  }
  if (C > 8 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;  // a cluster must fit on the card at once
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg)) !=
      cudaSuccess)
    return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, seeds, out, N, npoint, C, slice, in_smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_cluster(const float* x, const int* s, int* o, int B, int N, int npoint,
                   cudaStream_t st) {
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  int C = 1;
  while (C < kMaxCluster && (long)B * 2 * C <= sms && N / (2 * C) >= kMinSlice) C *= 2;
  while (C < kMaxCluster && (N + C - 1) / C > kBlockMaxN) C *= 2;
  if ((long)B * C > 2147483647L) return (int)cudaErrorInvalidValue;
  const int slice = (N + C - 1) / C;
  if (slice <= 256) return launch_block<1, 256>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 512) return launch_block<2, 256>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 1024) return launch_block<4, 256>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 2048) return launch_block<8, 256>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 4096) return launch_block<16, 256>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 8192) return launch_block<16, 512>(x, s, o, B, N, npoint, C, slice, st);
  if (slice <= 16384) return launch_block<16, 1024>(x, s, o, B, N, npoint, C, slice, st);
  return launch_block<64, 512>(x, s, o, B, N, npoint, C, slice, st);
}

}  // namespace

// xyz (B,N,3) f32, seeds (B,) i32 start indices in [0, N) -> out (B,npoint)
// i32. dist is a (B,N) f32 buffer for N > 16 * 32,768 = 524,288 (its
// contents are overwritten) and may be NULL below that. Returns
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// launch's error.
extern "C" int pcot_fps_f32(const void* xyz, const void* seeds, void* out, void* dist, int B,
                            int N, int npoint, void* stream) {
  if (B < 1 || N < 1 || N > kMaxNGlobal || npoint < 1) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const int* s = (const int*)seeds;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= kClusterMaxN) return launch_cluster(x, s, o, B, N, npoint, st);
  if (!dist) return (int)cudaErrorInvalidValue;
  fps_global_kernel<<<B, 1024, 0, st>>>(x, s, o, (float*)dist, N, npoint);
  return (int)cudaGetLastError();
}
