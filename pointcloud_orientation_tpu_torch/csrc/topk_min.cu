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
// Design: a threshold select, then a small sort, one block a row. Each entry
// becomes a unique 64-bit key: the float's bits made order-preserving as an
// unsigned int (-0.0 first canonicalised to +0.0, since a stable sort keeps
// the two in position order), shifted left over the bits of the position,
// or'ed with the position. The row's K-th smallest key is found 8 bits a
// pass from the top, each pass a 256-bin shared-memory histogram of the
// entries that share the digits found so far and one warp's prefix scan of
// the bins; the search stops as soon as the bin holding the K-th key holds
// exactly the keys still to take (random distances: two or three passes;
// exact ties: the position's digits decide, up to seven). The K entries at
// or below the prefix found are then gathered in any order and sorted by one
// warp with a 32- or 64-wide bitonic network. Rows of up to kMaxStaged
// entries (M = 20,000 is 80 KB) are read once, 16 loads in flight a thread,
// and staged in shared memory as keys; the passes read them there. A longer
// row is read from device memory once a digit pass (L2 holds it). Rows of a
// 16-byte aligned tile with M a multiple of 4 are read as float4, others
// entry by entry. A key of +inf gives position 0, as the TPU kernel does
// past a row's finite entries. At most 32 registers a thread, so that two
// 1,024-thread blocks share an SM.
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

namespace {

constexpr int kMaxK = 64;
constexpr int kBins = 256;
constexpr int kMaxThreads = 1024;
constexpr int kPerThread = 8;              // entries a thread takes per pass, below 8,192
constexpr int kMaxM = 1 << 24;             // positions fit in 24 bits
constexpr int kMaxStaged = 56 * 1024;      // entries staged in shared memory (224 KB)
constexpr int kMaxSmemBytes = 232448;      // 227 KB a block can opt into on sm_90
constexpr unsigned kInfKey = 0xff800000u;  // order_key(+inf)
constexpr unsigned kFull = 0xffffffffu;

// Unsigned order equals float order; -0.0 and +0.0 are one key.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Shared {
  unsigned hist[kBins];
  unsigned long long cand[kMaxK];
  unsigned bin, below, count;  // the bin holding the K-th key, the keys before it, its size
  int n;                       // candidates gathered
};
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
  const int lane = tid & 31;
  const float* src = d + (size_t)blockIdx.x * M;
  auto composite = [&](unsigned k, int m) -> unsigned long long {
    return ((unsigned long long)k << pbits) | (unsigned)m;
  };
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

  if (tid == 0) sh.n = 0;
  if (kStaged)  // one 16-byte store a thread: conflict-free
    read_row(src, M, vec, [&](unsigned k, int m) { keys[m] = k; },
             [&](uint4 k, int m) { *reinterpret_cast<uint4*>(keys + m) = k; });

  // The K selected keys are those whose bits above `shift` are <= prefix;
  // krem is the rank of the K-th key among those whose bits equal prefix.
  unsigned long long prefix = 0;
  int shift = 32 + pbits;
  int krem = K;
  // One digit: the histogram of the next 8 bits of the keys that share the
  // prefix, the bin where the count reaches krem. True when that bin holds
  // exactly the keys still to take (no later digit matters).
  auto digit_pass = [&](auto&& visit) -> bool {
    for (int i = tid; i < kBins; i += nt) sh.hist[i] = 0;
    __syncthreads();  // the bins are clear (and the row staged, the counters reset)
    visit([&](unsigned long long c) {
      if ((c >> shift) == prefix) atomicAdd(&sh.hist[(unsigned)(c >> (shift - 8)) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid < 32) {  // the bin where the running count reaches krem
      unsigned h[kBins / 32];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        h[j] = sh.hist[lane * (kBins / 32) + j];
        sum += h[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      unsigned before = incl - sum;
      if (before < (unsigned)krem && (unsigned)krem <= incl) {
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          if ((unsigned)krem <= before + h[j]) {
            sh.bin = lane * (kBins / 32) + j;
            sh.below = before;
            sh.count = h[j];
            break;
          }
          before += h[j];
        }
      }
    }
    __syncthreads();
    krem -= (int)sh.below;
    prefix = (prefix << 8) | sh.bin;
    shift -= 8;
    return (int)sh.count == krem;
  };
  // gather the keys at or below the prefix, in any order
  auto gather = [&](auto&& visit) {
    visit([&](unsigned long long c) {
      if ((c >> shift) <= prefix) {
        const int slot = atomicAdd(&sh.n, 1);
        if (slot < kMaxK) sh.cand[slot] = c;
      }
    });
  };

  bool done = K >= M;
  while (!done && shift > 0) done = digit_pass(visit_row);
  __syncthreads();  // the staged row and the counters, when no digit pass ran
  gather(visit_row);
  __syncthreads();
  if (tid >= 32) return;

  // one warp sorts the K keys (unique; the padding sorts last)
  const int P = K <= 32 ? 32 : 64;
  for (int i = K + lane; i < P; i += 32) sh.cand[i] = ~0ull;
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int i = 2 * j * (t / j) + (t % j);  // the pair (i, i + j), bit j of i clear
        const unsigned long long a = sh.cand[i];
        const unsigned long long b = sh.cand[i + j];
        if ((a > b) == ((i & k) == 0)) {
          sh.cand[i] = b;
          sh.cand[i + j] = a;
        }
      }
      __syncwarp();
    }
  }
  int* out = idx + (size_t)blockIdx.x * K;
  const unsigned long long pos_mask = (1ull << pbits) - 1;
  for (int i = lane; i < K; i += 32) {
    const unsigned long long c = sh.cand[i];
    out[i] = (unsigned)(c >> pbits) == kInfKey ? 0 : (int)(c & pos_mask);
  }
}

}  // namespace

// d (rows, M) f32 -> idx (rows, K) i32. One block of min(1024, M / 8)
// threads (at least a warp) per row. Returns cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int pcot_topk_min_f32(const void* d, void* idx, int rows, int M, int K,
                                 void* stream) {
  if (rows < 1 || K < 1 || K > kMaxK || M < K || M > kMaxM) return (int)cudaErrorInvalidValue;
  int pos_bits = 1;
  while (pos_bits < 24 && (1 << pos_bits) < M) ++pos_bits;
  const int pbits = (pos_bits + 7) / 8 * 8;  // whole digits of position
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
