// Deterministic scatter-add of neighbour-slot cotangents for Hopper (sm_90a),
// f32: the backward of the set-abstraction grouping's feature gather.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// _sa_scatter_call / _sa_scatter_kernel (the VJP that sa_group_feats_pallas
// wires in). The TPU kernel contracts a one-hot (S, N) matrix with each
// neighbour slot's cotangents on the MXU; that spends N times the needed
// operations and is not carried over.
//
// dfeats[b, n, :] = sum over slots (s, k) with idx[b, s, k] == n of
// dg[b, k, s, :], where dg is read at its own row stride (the wrapper passes
// the grouped cotangent at column offset 3, row stride 3 + D, so the slice
// is never copied).
//
// Bound on this card: bytes. Each cotangent is read once and added once;
// at sa2 (B=16, S=32, K=32, D=128) that is 8.4 MB read and 1 MB written.
//
// Design. A cloud's rows are split over G blocks (G = 8 at sa2's B=16: 128
// blocks), and each block first groups its cloud's slots by target row in
// shared memory. The sort is a stable counting sort with no serial step and
// no per-row sort: 8 warps take contiguous ranges of the slots; each warp
// counts its slots of each row (__match_any_sync groups a warp's lanes by
// row and the lowest lane of each group adds the group's size, so no
// atomics), one block-wide exclusive scan (warp shuffles) over the counts
// in (row, warp) order gives every warp its cursor in every row, and each
// warp drops its slots at its cursor plus the rank among its group's lanes
// below. Then a warp owns a row and sums its slots, 128 channels at a time:
// float4 loads where row_stride, D and the pointer allow (4 channels a
// lane), else scalar loads of 4 channels a lane 32 apart (the grouped
// cotangent's row stride 3 + D is odd), 4 slots' loads in flight before
// their adds. Sorting in every block beat sorting once a cloud (the G
// blocks of a cloud as a thread-block cluster, block 0 sorting and the
// others copying their rows' segments through distributed shared memory)
// 1.45x at sa2: the cluster's two barriers and remote copies cost more
// than the sort they save (chip_sweep.py scatter, PERF.md); 1, 2 or 8
// slots in flight and 4 or 16 blocks a cloud were slower too.
//
// Determinism: no floating-point atomics. Every output element is
// 0 + v0 + v1 + ... over its row's slots in ascending slot order
// (s * K + k): the counting sort is stable, so the order depends on idx
// alone. It is the order this kernel's earlier design (a counting sort and
// an insertion sort per row, in every block) used, so the sums are
// bit-equal to that design's. Two launches give the same bits whatever the
// schedule.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;            // channels a warp sums at once: 4 a lane
constexpr int kUnroll = 4;             // slots whose loads are in flight together
constexpr int kMaxRowGroups = 8;       // blocks a cloud at most: each sorts the cloud's slots
constexpr int kBlocksTarget = 264;     // blocks to aim for: two an SM of the H100's 132
constexpr long kMaxSmemBytes = 232448;  // 227 KB a block can opt into on sm_90

// In-place exclusive scan of a[0, m) over the block; where i % ws == 0 the
// scanned value also goes to start[i / ws]. Ends with a barrier.
__device__ void block_exclusive_scan(int* a, int m, int ws, int* start, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(m, tid * per), hi = min(m, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    if (i % ws == 0) start[i / ws] = run;
    run += v;
  }
  __syncthreads();
}

// Stable counting sort of cloud b's S*K slots by target row: on return
// order[start[n], start[n + 1]) lists row n's slots in ascending slot order
// j = s * K + k, each stored as its row of dg's (K, S) layout, k * S + s.
// ws sorting warps, each on a contiguous range of slots; hist[n * ws + w]
// counts warp w's slots of row n, then holds its cursor. Whole block.
__device__ void sort_slots(const int* __restrict__ idx_b, int N, int S, int K, int ws,
                           int* tgt, int* order, int* start, int* hist, int* warp_tot) {
  const int slots = S * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < N * ws; i += kThreads) hist[i] = 0;
  if (tid == 0) start[N] = slots;
  __syncthreads();
  const int per = (slots + ws - 1) / ws;
  const int lo = min(slots, warp * per), hi = min(slots, lo + per);
  if (warp < ws) {
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      int n = -1;
      if (j < hi) {
        n = idx_b[j];
        n = n < 0 ? 0 : (n >= N ? N - 1 : n);  // the grouping kernel never writes these
        tgt[j] = n;
      }
      const unsigned peers = __match_any_sync(kFull, n);
      if (n >= 0 && (peers & below) == 0u) hist[n * ws + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  block_exclusive_scan(hist, N * ws, ws, start, warp_tot);
  if (warp < ws) {
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      const int n = j < hi ? tgt[j] : -1;
      const unsigned peers = __match_any_sync(kFull, n);
      if (n >= 0) {
        const int s = j / K;
        order[hist[n * ws + warp] + __popc(peers & below)] = (j - s * K) * S + s;
      }
      __syncwarp();  // every lane has read its cursor
      if (n >= 0 && (peers & below) == 0u) hist[n * ws + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// Row n's sums over its slots ord[lo, hi) (rows of g, row_stride apart),
// channels [c0, c0 + 128), into o; one warp.
__device__ __forceinline__ void sum_row(const float* __restrict__ g, const int* ord, int lo,
                                        int hi, int D, int row_stride, int c0, bool vec4,
                                        float* __restrict__ o) {
  const int lane = threadIdx.x & 31;
  if (vec4) {
    const int c = c0 + 4 * lane;
    if (c >= D) return;  // D % 4 == 0: c + 3 < D otherwise
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int p = lo;
    for (; p + kUnroll <= hi; p += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = *reinterpret_cast<const float4*>(g + (size_t)ord[p + u] * row_stride + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    for (; p < hi; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(g + (size_t)ord[p] * row_stride + c);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(o + c) = acc;
    return;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int p = lo;
  for (; p + kUnroll <= hi; p += kUnroll) {
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* row = g + (size_t)ord[p + u] * row_stride;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + lane + 32 * q;
        v[u][q] = c < D ? row[c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += v[u][q];
  }
  for (; p < hi; ++p) {
    const float* row = g + (size_t)ord[p] * row_stride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < D) acc[q] += row[c];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + lane + 32 * q;
    if (c < D) o[c] = acc[q];
  }
}

// Block r of cloud b's G blocks (blockIdx.x = b * G + r) sums rows
// [r * rows_per_block, ...). Dynamic shared memory, ints: tgt (S*K), order
// (S*K), start (N + 1), hist (N * ws).
__global__ void __launch_bounds__(kThreads)
sa_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ dg,
                  float* __restrict__ out, int N, int S, int K, int D, int row_stride, int G,
                  int rows_per_block, int ws, int vec4) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[kWarps];
  const int slots = S * K;
  int* tgt = smem;
  int* order = tgt + slots;
  int* start = order + slots;
  int* hist = start + N + 1;
  const int b = blockIdx.x / G;
  const int r = blockIdx.x - b * G;
  const int n0 = min(N, r * rows_per_block);
  const int n_rows = min(rows_per_block, N - n0);
  sort_slots(idx + (size_t)b * slots, N, S, K, ws, tgt, order, start, hist, warp_tot);

  const float* g = dg + (size_t)b * K * S * row_stride;
  const int* st = start + n0;
  for (int i = threadIdx.x >> 5; i < n_rows; i += kWarps) {
    float* o = out + ((size_t)b * N + n0 + i) * D;
    for (int c0 = 0; c0 < D; c0 += kChunk)
      sum_row(g, order, st[i], st[i + 1], D, row_stride, c0, vec4 != 0, o);
  }
}

}  // namespace

// idx (B,S,K) int32 in [0, N); dg (B,K,S,*) f32 with D channels at the
// given pointer and `row_stride` floats between rows (row_stride >= D);
// out (B,N,D) f32. Returns cudaErrorInvalidValue for arguments the kernel
// does not take, else the launch's error.
extern "C" int pcot_sa_scatter_f32(const void* idx, const void* dg, void* out, int B, int N,
                                   int S, int K, int D, int row_stride, void* stream) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || D < 1 || row_stride < D)
    return (int)cudaErrorInvalidValue;
  // row groups a cloud: about kBlocksTarget blocks in all
  int G = kBlocksTarget / B;
  G = G < 1 ? 1 : (G > kMaxRowGroups ? kMaxRowGroups : G);
  if (G > N) G = N;
  const int rows_per_block = (N + G - 1) / G;
  G = (N + rows_per_block - 1) / rows_per_block;
  if ((long)B * G > 2147483647L) return (int)cudaErrorInvalidValue;
  const long fixed = 2L * S * K + N + 1;
  int ws = kWarps;  // sorting warps: as many as the counts' shared memory allows
  while (ws > 1 && 4L * (fixed + (long)N * ws) > kMaxSmemBytes) ws /= 2;
  const long smem = 4L * (fixed + (long)N * ws);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int vec4 = row_stride % 4 == 0 && D % 4 == 0 && (uintptr_t)dg % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(sa_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_scatter_kernel<<<(unsigned)(B * G), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)dg, (float*)out, N, S, K, D, row_stride, G, rows_per_block,
      ws, vec4);
  return (int)cudaGetLastError();
}
