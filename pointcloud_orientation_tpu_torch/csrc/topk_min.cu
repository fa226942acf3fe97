// K smallest entries of each row of a candidate-distance tile, for Hopper
// (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// topk_min_pallas (:878, body _topk_min_kernel :858), the selection of the
// grid-pruned exact kNN (ops/geometry.py grid_pruned_core): d (rows, M) f32,
// a finite distance or +inf (an empty window slot) per entry -> idx (rows, K)
// int32, the positions of the K smallest, nearest first, equal values to the
// lowest position. The TPU kernel takes K argmin passes and sets each winner
// to +inf; once a row's finite entries are used up every later pass sees an
// all-inf row and returns position 0. This kernel returns the same.
//
// Bound on this card: bytes. At the 8-dir sa1 grid shape (rows = 16 x 128,
// M = 1024, K = 32) the tile is read once and the indices written once,
// 8.65 MB, about 0.0026 ms at 3.35 TB/s; selecting K of M needs on the order
// of one compare per entry, 2.1 M operations, far less.
//
// Design: the threshold select of csrc/threshold_select.cuh (block_select),
// one block a row: unique 64-bit (value, position) keys, the K-th smallest
// found 8 bits a pass from the top (random distances: two or three passes;
// exact ties: the position's digits decide, up to seven), the K keys at or
// below it gathered and put at their ranks. Rows of up to kMaxStaged
// entries (M = 20,000 is 80 KB) are read once, 16 loads in flight a thread,
// and staged in shared memory as order keys; the passes read them there. A
// longer row is read from device memory once a digit pass (L2 holds it).
// Rows of a 16-byte aligned tile with M a multiple of 4 are read as float4,
// others entry by entry. A key of +inf gives position 0, as the TPU kernel
// does past a row's finite entries; NaN sorts after +inf, as in a sort. At
// most 32 registers a thread, so that two 1,024-thread blocks share an SM;
// ptxas spills 84 bytes a thread at that cap on staged rows and 168 on rows
// read from device memory (the kernel with its own select and a bitonic
// sort: 68 and 108). Testing NaN on the bits in order_key spilled less and
// ran slower on the H100 (PERF.md).
//
// What holds it back (measured on the H100, PERF.md): each pass's barriers
// and shared-memory atomics, which serialise where many entries tie on one
// bin; a long row of exact ties read again for each of up to seven digits;
// and one block a row, so a tile of few long rows leaves SMs idle.
//
// The keys are exact and unique, so the indices equal the plain PyTorch
// version's (ops/cuda_kernels.py topk_min_plain, a stable sort) bit for bit,
// ties included.

#include <cuda_runtime.h>

#include <cstdint>

#include "threshold_select.cuh"

namespace {

using pcot_select::order_key;

constexpr int kMaxK = 64;
constexpr int kMaxThreads = 1024;
constexpr int kPerThread = 8;          // entries a thread takes per pass, below 8,192
constexpr int kMaxM = 1 << 24;         // positions fit in 24 bits
constexpr int kMaxStaged = 56 * 1024;  // entries staged in shared memory (224 KB)
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block can opt into on sm_90

using Shared = pcot_select::Shared<kMaxK>;
constexpr int kSharedBytes = (sizeof(Shared) + 15) / 16 * 16;
static_assert(kSharedBytes + kMaxStaged * sizeof(unsigned) <= kMaxSmemBytes,
              "a staged row fits a block's shared memory");

// f4(4 keys, position of the first) for every 4 entries of a row in device
// memory when vec (the row 16-byte aligned: the tile's base aligned and
// M % 4 == 0), else f(key, position) for every entry; 16 loads in flight a
// thread. Scalar loads alone spill under the 32-register cap and ran 2-3x
// slower on the H100.
template <typename F, typename F4>
__device__ __forceinline__ void read_row(const float* __restrict__ src, int M, bool vec, F&& f,
                                         F4&& f4) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int n4 = M >> 2;
    for (int i0 = tid; i0 < n4; i0 += 4 * nt) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nt;
        v[u] = i < n4 ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nt;
        if (i < n4)
          f4(make_uint4(order_key(v[u].x), order_key(v[u].y), order_key(v[u].z),
                        order_key(v[u].w)), 4 * i);
      }
    }
  } else {
    for (int m0 = tid; m0 < M; m0 += 16 * nt) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int m = m0 + u * nt;
        v[u] = m < M ? __ldg(src + m) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int m = m0 + u * nt;
        if (m < M) f(order_key(v[u]), m);
      }
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads, 2)  // 32 registers: two full blocks an SM
topk_min_kernel(const float* __restrict__ d, int* __restrict__ idx, int M, int K, int pbits,
                bool vec) {
  extern __shared__ unsigned long long smem8[];
  Shared& sh = *reinterpret_cast<Shared*>(smem8);
  unsigned* keys = reinterpret_cast<unsigned*>(reinterpret_cast<char*>(smem8) + kSharedBytes);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* src = d + (size_t)blockIdx.x * M;
  auto composite = [&](unsigned k, int m) { return pcot_select::composite(k, m, pbits); };
  // the row's keys, from shared memory (staged) or device memory
  auto visit_row = [&](auto&& f) {
    if (kStaged) {
      for (int m = tid; m < M; m += nt) f(composite(keys[m], m));
    } else {
      read_row(src, M, vec, [&](unsigned k, int m) { f(composite(k, m)); },
               [&](uint4 k, int m) {
                 f(composite(k.x, m));
                 f(composite(k.y, m + 1));
                 f(composite(k.z, m + 2));
                 f(composite(k.w, m + 3));
               });
    }
  };

  if (kStaged)  // one 16-byte store a thread: conflict-free; the first pass's barrier shows it
    read_row(src, M, vec, [&](unsigned k, int m) { keys[m] = k; },
             [&](uint4 k, int m) { *reinterpret_cast<uint4*>(keys + m) = k; });
  int* out = idx + (size_t)blockIdx.x * K;
  pcot_select::block_select<kMaxK>(visit_row, M, K, pbits, sh, [&](int r, unsigned long long c) {
    out[r] = pcot_select::position_or_zero(c, pbits, pcot_select::kInfKey);
  });
}

}  // namespace

// d (rows, M) f32 -> idx (rows, K) i32. One block of min(1024, M / 8)
// threads (at least a warp) per row. Returns cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int pcot_topk_min_f32(const void* d, void* idx, int rows, int M, int K,
                                 void* stream) {
  if (rows < 1 || K < 1 || K > kMaxK || M < K || M > kMaxM) return (int)cudaErrorInvalidValue;
  const int pbits = pcot_select::position_bits(M);
  int threads = (M + kPerThread - 1) / kPerThread;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : (threads + 31) / 32 * 32;
  const bool staged = M <= kMaxStaged;
  const int smem = staged ? kSharedBytes + M * (int)sizeof(unsigned) : kSharedBytes;
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  auto kernel = staged ? topk_min_kernel<true> : topk_min_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, threads, smem, (cudaStream_t)stream>>>((const float*)d, (int*)idx, M, K, pbits,
                                                        vec);
  return (int)cudaGetLastError();
}
