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
// Bound on this card: at the 8-dir sa1 grid shape (rows = 16 x 128, M = 1024,
// K = 32) the tile is read once and the indices written once, 8.65 MB, about
// 0.0026 ms at 3.35 TB/s; selecting K of M needs on the order of one compare
// per entry, 2.1 M operations, far less. What holds a simple kernel back is
// the K dependent passes of a row. Design: one warp per row, rows staged in
// shared memory while a block's rows fit in 48 KB (up to 12,288 entries a
// row) and read in place from device memory beyond that. Each lane keeps the
// smallest (value, position) key of its strided share; a pass is one
// butterfly reduction over the warp, and only the lane that owned the winner
// rescans its share. Eviction is implicit: a lane's next candidate is its
// smallest key above the last winner's, so the input is never written and
// needs no scratch copy. A winner of +inf means every finite entry is taken:
// the rest of the row's outputs are 0, as in the TPU kernel.
//
// The comparisons are exact, so the indices equal the plain PyTorch version's
// (ops/cuda_kernels.py topk_min_plain) bit for bit, ties included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxRowsPerBlock = 8;  // one warp a row
constexpr int kSmemFloats = 12288;   // 48 KB of staged rows a block
constexpr int kMaxM = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;

// (v, p) < (ov, op) lexicographically.
__device__ __forceinline__ bool key_less(float v, int p, float ov, int op) {
  return v < ov || (v == ov && p < op);
}

// Every lane ends with the warp's smallest key (a min over a total order).
__device__ __forceinline__ void warp_min(float& v, int& p) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int op = __shfl_xor_sync(kFull, p, off);
    if (key_less(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
}

// The smallest key above (wv, wp) among positions lane, lane + 32, ... of the
// row; (inf, INT_MAX) when there is none.
__device__ __forceinline__ void lane_next(const float* row, int M, int lane, float wv, int wp,
                                          float& bv, int& bp) {
  bv = INFINITY;
  bp = INT_MAX;
  for (int m = lane; m < M; m += 32) {
    const float v = row[m];
    if ((v > wv || (v == wv && m > wp)) && key_less(v, m, bv, bp)) {
      bv = v;
      bp = m;
    }
  }
}

__global__ void __launch_bounds__(kMaxRowsPerBlock * 32)
topk_min_kernel(const float* __restrict__ d, int* __restrict__ idx, int rows, int M, int K,
                int staged) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp: no block-wide barrier follows
  const float* src = d + (size_t)row * M;
  const float* buf = src;
  if (staged) {
    float* s = smem + (size_t)warp * M;
    for (int m = lane; m < M; m += 32) s[m] = src[m];
    __syncwarp();
    buf = s;
  }
  int* out = idx + (size_t)row * K;
  float bv;
  int bp;
  lane_next(buf, M, lane, -INFINITY, -1, bv, bp);
  for (int k = 0; k < K; ++k) {
    float v = bv;
    int p = bp;
    warp_min(v, p);
    if (v == INFINITY) {  // an all-inf row from here on: argmin is position 0
      for (int q = k + lane; q < K; q += 32) out[q] = 0;
      return;
    }
    if (lane == 0) out[k] = p;
    if ((p & 31) == lane) lane_next(buf, M, lane, v, p, bv, bp);
  }
}

}  // namespace

// d (rows, M) f32 -> idx (rows, K) i32. Returns cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int pcot_topk_min_f32(const void* d, void* idx, int rows, int M, int K,
                                 void* stream) {
  if (rows < 1 || K < 1 || K > kMaxK || M < K || M > kMaxM) return (int)cudaErrorInvalidValue;
  const int staged = M <= kSmemFloats;
  int per_block = staged ? kSmemFloats / M : kMaxRowsPerBlock;
  if (per_block > kMaxRowsPerBlock) per_block = kMaxRowsPerBlock;
  const int smem = staged ? per_block * M * (int)sizeof(float) : 0;
  const int blocks = (rows + per_block - 1) / per_block;
  topk_min_kernel<<<blocks, per_block * 32, smem, (cudaStream_t)stream>>>(
      (const float*)d, (int*)idx, rows, M, K, staged);
  return (int)cudaGetLastError();
}
