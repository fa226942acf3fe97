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
// Determinism: no floating-point atomics. One block per (cloud, group of 32
// channels, group of target rows) counting-sorts the cloud's S*K slots by
// target row in shared memory (integer atomics give the counts; each row's
// segment is then put in ascending slot order by the thread that owns the
// row), and each output element of its rows sums its row's slots in that
// order. Two launches give the same bits whatever the schedule. Every block
// of a cloud repeats the sort (S*K indices, 4 KB at sa2) so that the sums,
// which carry the bytes, spread over enough blocks to fill the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 32;  // channels per block: one warp's worth of columns

__global__ void __launch_bounds__(kThreads)
sa_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ dg,
                  float* __restrict__ out, int N, int S, int K, int D, int row_stride,
                  int rows_per_block) {
  extern __shared__ int smem[];
  const int slots = S * K;
  int* tgt = smem;              // (slots,) target row of each slot
  int* start = tgt + slots;     // (N + 1,) segment starts
  int* order = start + N + 1;   // (slots,) slots grouped by target row

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int* idx_b = idx + (size_t)b * slots;

  for (int n = tid; n <= N; n += kThreads) start[n] = 0;
  __syncthreads();
  for (int j = tid; j < slots; j += kThreads) {
    int n = idx_b[j];
    n = n < 0 ? 0 : (n >= N ? N - 1 : n);  // the grouping kernel never writes these
    tgt[j] = n;
    atomicAdd(&start[n + 1], 1);
  }
  __syncthreads();
  if (tid == 0) {  // exclusive scan of the counts: N steps, N is at most a few thousand
    for (int n = 1; n <= N; ++n) start[n] += start[n - 1];
  }
  __syncthreads();
  // The slots are dropped into their row's segment through an integer
  // cursor (in any order), then each row's owner sorts its segment by slot
  // index, so the order of the sums below does not depend on the schedule.
  int* cur = order + slots;  // (N,) fill cursors
  for (int n = tid; n < N; n += kThreads) cur[n] = start[n];
  __syncthreads();
  for (int j = tid; j < slots; j += kThreads) {
    const int p = atomicAdd(&cur[tgt[j]], 1);
    order[p] = j;
  }
  __syncthreads();
  const int n0 = blockIdx.z * rows_per_block;  // this block's target rows
  const int n_rows = min(rows_per_block, N - n0);
  for (int n = n0 + tid; n < n0 + n_rows; n += kThreads) {
    const int lo = start[n], hi = start[n + 1];
    for (int p = lo + 1; p < hi; ++p) {  // insertion sort: segments are short
      const int v = order[p];
      int q = p - 1;
      while (q >= lo && order[q] > v) {
        order[q + 1] = order[q];
        --q;
      }
      order[q + 1] = v;
    }
  }
  __syncthreads();

  const int width = min(kChannels, D - c0);
  for (int e = tid; e < n_rows * kChannels; e += kThreads) {
    const int n = n0 + e / kChannels;
    const int c = e % kChannels;
    if (c >= width) continue;
    float acc = 0.f;
    for (int p = start[n]; p < start[n + 1]; ++p) {
      const int j = order[p];
      const int s = j / K;
      const int k = j - s * K;
      acc += dg[(((size_t)b * K + k) * S + s) * row_stride + c0 + c];
    }
    out[((size_t)b * N + n) * D + c0 + c] = acc;
  }
}

constexpr long kMaxSmemBytes = 232448;  // 227 KB a block can opt into on sm_90

}  // namespace

// idx (B,S,K) int32 in [0, N); dg (B,K,S,*) f32 with D channels at the
// given pointer and `row_stride` floats between rows (row_stride >= D);
// out (B,N,D) f32. Returns cudaErrorInvalidValue for arguments the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int pcot_sa_scatter_f32(const void* idx, const void* dg, void* out, int B, int N,
                                   int S, int K, int D, int row_stride, void* stream) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || D < 1 || row_stride < D || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long smem = 4L * (2L * S * K + 2L * N + 1);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sa_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // split the rows over enough blocks to give the card ~4 blocks per SM
  const int chunks = (D + kChannels - 1) / kChannels;
  int groups = 528 / (chunks * B);
  groups = groups < 1 ? 1 : (groups > N ? N : groups);
  const int rows_per_block = (N + groups - 1) / groups;
  groups = (N + rows_per_block - 1) / rows_per_block;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)B, (unsigned)groups);
  sa_scatter_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)dg, (float*)out, N, S, K, D, row_stride, rows_per_block);
  return (int)cudaGetLastError();
}
