// Radius ball query for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// ball_query_pallas / _ball_kernel (the grouping of PointNetPPCls's two SA
// stages), and the XLA path of the JAX package's ops/geometry.py ball_query.
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
// Bound on this card: the tests. The answer needs, for each centroid, the
// points up to its nsample-th one inside the radius (all N when it has
// fewer): 9 operations a tested point against a few bytes of indices, so
// at the classifier's shapes the operations bound it (chip_smoke.py
// ball_cost). The TPU kernel computes the whole (S, N) distance tile and
// takes nsample min-passes over it; none of that is carried over. Two
// designs, picked in the C entry point from (B, S, N, K) alone:
//
// - Staged (many centroids a cloud: the classifier's stages): a block of 16
//   warps takes 16 centroids of one cloud and stages the cloud once into
//   shared memory, 4,096 points a tile in index order, as float4
//   {x, y, z, x2} (x2 computed once at staging, in the order the plain
//   version uses; one 16-byte load gives a lane its point); a tile is
//   padded to a multiple of 128 points with NaN, which no test counts in.
//   A warp owns a centroid: its lanes test 32 consecutive points from
//   shared memory, __ballot_sync gathers the hits, __popc of the lanes
//   below gives each its slot, and the warp stops as soon as it holds
//   nsample. A warp a centroid beat a thread a centroid (the 32 lanes
//   reading one point, a broadcast) 1.8-2.0x at sa1 and 4.3-4.9x at sa2
//   (chip_sweep.py ball, PERF.md): a warp of 32 centroids runs until its
//   slowest is done, and at sa1 every such warp holds one that scans all
//   1,024 points (the mean scan is 697). One 32-point group a step and 16
//   centroids a block were the fastest of 1, 2 or 4 groups and 4 to 32
//   centroids. What bounds it is issue: a step is about 19 instructions
//   without a hit and 40 with (SASS), against 9 operations a tested point
//   in the bound.
// - Split (few centroids over a large cloud: N above one tile and B * S
//   under 256 centroids an SM, 33,792 on 132 SMs; the N=24,576 and
//   N=40,000 requests hold 4 and 8 an SM): a block of 16 warps takes one
//   centroid and scans the cloud in index order, 2,048 points a round:
//   each warp tests 4 groups of 32 consecutive points, the next round's
//   points loaded (from L2) while this round's are counted, so that a scan
//   does not wait on one round trip every 32 points. The warps' hit counts
//   go through shared memory, and the prefix over the warps before a warp,
//   plus the running count, gives each hit its slot; the block stops once
//   nsample are found. B * S blocks fill the card where this runs; it was
//   6-7x faster than the staged path at those two requests, and 1.8-8x
//   faster than the scan split further over a thread-block cluster of 2,
//   4 or 8 blocks with the counts in distributed shared memory
//   (chip_sweep.py ball, PERF.md). Between 8 and 256 centroids an SM is
//   not measured: no traffic has such a shape.
//
// Exactness: the differences, products and sums go through the _rn
// intrinsics, which nvcc never contracts into FMAs, so the in-radius test is
// bit-equal to the plain PyTorch version (ops/cuda_kernels.py
// ball_query_plain) in either form; hits are placed by their index order
// alone (a ballot's lanes, or a prefix of the warps' counts in index
// order), so the indices are equal exactly whatever the schedule.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStagedThreads = 512;      // a staged block's largest size
constexpr int kWarpCentroids = 16;       // centroids a staged block holds: a warp each
constexpr int kWarpGroups = 1;           // 32-point groups a warp tests at once
constexpr int kTileMax = 4096;           // points a staged tile holds
constexpr int kTilePad = 128;            // a tile is padded to a multiple of this
constexpr int kSplitWarps = 16;          // a split block's warps
constexpr int kSplitGroups = 4;          // 32-point groups a warp tests a round
constexpr int kSplitRound = kSplitWarps * kSplitGroups * 32;
constexpr int kSplitCentroidsPerSm = 256;  // split below this many centroids an SM
constexpr long kMaxSmemBytes = 232448;   // 227 KB a block can opt into on sm_90

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The squared distance of point p (x2 its squared norm) to centroid c (c2
// its squared norm): the matmul form (c2 - 2*cross) + x2, or the difference
// form.
template <bool kMatmul>
__device__ __forceinline__ float dist2(float cx, float cy, float cz, float c2, float px,
                                       float py, float pz, float x2) {
  if (kMatmul) {
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)), __fmul_rn(cz, pz));
    return __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), x2);
  }
  return sq_norm(__fsub_rn(cx, px), __fsub_rn(cy, py), __fsub_rn(cz, pz));
}

// Points [t0, t0 + tn) of a cloud into pts as {x, y, z, x2}; pts[tn, tp),
// up to a whole number of kTilePad points, as NaN, which no test counts in.
__device__ __forceinline__ void stage_tile(float4* pts, const float* cloud, int t0, int tn,
                                           int tp) {
  const float nan = __int_as_float(0x7fffffff);
  for (int j = threadIdx.x; j < tp; j += blockDim.x) {
    float4 v = make_float4(nan, nan, nan, nan);
    if (j < tn) {
      const float* p = cloud + 3 * (size_t)(t0 + j);
      v.x = p[0];
      v.y = p[1];
      v.z = p[2];
      v.w = sq_norm(v.x, v.y, v.z);
    }
    pts[j] = v;
  }
}

// Staged: a warp a centroid, blockDim.x / 32 centroids of cloud blockIdx.y
// a block; hits written straight to their slots. Dynamic shared memory: the
// tile.
template <bool kMatmul>
__global__ void __launch_bounds__(kStagedThreads)
ball_warp_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                 int* __restrict__ idx_out, int N, int S, int K, float radius_sq, int tile) {
  extern __shared__ float4 smem[];
  float4* pts = smem;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool active = s < S;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* c = new_xyz + ((size_t)b * S + s) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const float c2 = sq_norm(cx, cy, cz);
  const float* cloud = xyz + (size_t)b * N * 3;
  int* out = idx_out + ((size_t)b * S + s) * K;
  const unsigned below = (1u << lane) - 1u;
  int count = active ? 0 : K;  // the same in every lane of a warp
  int first = N - 1;           // the first hit
  for (int t0 = 0; t0 < N; t0 += tile) {
    if (t0 > 0 && !__syncthreads_or(count < K)) break;  // the tile is free again
    const int tn = min(tile, N - t0);
    const int tp = (tn + kTilePad - 1) / kTilePad * kTilePad;
    stage_tile(pts, cloud, t0, tn, tp);
    __syncthreads();
    for (int j0 = 0; j0 < tp && count < K; j0 += 32 * kWarpGroups) {
      unsigned mask[kWarpGroups];
#pragma unroll
      for (int g = 0; g < kWarpGroups; ++g) {  // tp is a multiple of 32 * kWarpGroups
        const float4 p = pts[j0 + g * 32 + lane];
        mask[g] = __ballot_sync(
            kFull, dist2<kMatmul>(cx, cy, cz, c2, p.x, p.y, p.z, p.w) <= radius_sq);
      }
#pragma unroll
      for (int g = 0; g < kWarpGroups; ++g) {
        if (mask[g] == 0u) continue;
        const int base = t0 + j0 + g * 32;
        if (count == 0) first = base + __ffs(mask[g]) - 1;
        const int slot = count + __popc(mask[g] & below);
        if ((mask[g] >> lane & 1u) && slot < K) out[slot] = base + lane;
        count += __popc(mask[g]);
      }
    }
  }
  if (active)
    for (int k = count + lane; k < K; k += 32) out[k] = first;
}

// The points of round `base` a lane tests: group g of warp w is points
// base + (w * kSplitGroups + g) * 32 + lane; past N, NaN.
__device__ __forceinline__ void load_round(const float* cloud, int base, int N, int warp,
                                           int lane, float (&x)[kSplitGroups],
                                           float (&y)[kSplitGroups], float (&z)[kSplitGroups]) {
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int g = 0; g < kSplitGroups; ++g) {
    const int j = base + (warp * kSplitGroups + g) * 32 + lane;
    if (j < N) {
      x[g] = cloud[3 * (size_t)j];
      y[g] = cloud[3 * (size_t)j + 1];
      z[g] = cloud[3 * (size_t)j + 2];
    } else {
      x[g] = y[g] = z[g] = nan;
    }
  }
}

// Split: a block of kSplitWarps warps a centroid (blockIdx.x = b * S + s),
// scanning the whole cloud in rounds of kSplitRound points.
template <bool kMatmul>
__global__ void __launch_bounds__(kSplitWarps * 32)
ball_split_kernel(const float* __restrict__ new_xyz, const float* __restrict__ xyz,
                  int* __restrict__ idx_out, int N, int S, int K, float radius_sq) {
  __shared__ int warp_hits[2][kSplitWarps];  // by round parity: one barrier a round
  __shared__ int first_hit;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t q = blockIdx.x;  // centroid b * S + s
  const int b = (int)(q / S);
  const float cx = new_xyz[3 * q], cy = new_xyz[3 * q + 1], cz = new_xyz[3 * q + 2];
  const float c2 = sq_norm(cx, cy, cz);
  const float* cloud = xyz + (size_t)b * N * 3;
  int* out = idx_out + q * K;

  int count = 0;  // hits so far, the same in every thread
  float nx[kSplitGroups], ny[kSplitGroups], nz[kSplitGroups];
  load_round(cloud, 0, N, warp, lane, nx, ny, nz);
  for (int base = 0, par = 0; base < N; base += kSplitRound, par ^= 1) {
    float px[kSplitGroups], py[kSplitGroups], pz[kSplitGroups];
#pragma unroll
    for (int g = 0; g < kSplitGroups; ++g) {
      px[g] = nx[g];
      py[g] = ny[g];
      pz[g] = nz[g];
    }
    if (base + kSplitRound < N) load_round(cloud, base + kSplitRound, N, warp, lane, nx, ny, nz);
    unsigned mask[kSplitGroups];
    int warp_count = 0;
#pragma unroll
    for (int g = 0; g < kSplitGroups; ++g) {
      const float x2 = kMatmul ? sq_norm(px[g], py[g], pz[g]) : 0.f;
      mask[g] = __ballot_sync(
          kFull, dist2<kMatmul>(cx, cy, cz, c2, px[g], py[g], pz[g], x2) <= radius_sq);
      warp_count += __popc(mask[g]);
    }
    if (lane == 0) warp_hits[par][warp] = warp_count;
    __syncthreads();
    const int w = lane < kSplitWarps ? warp_hits[par][lane] : 0;
    int slot = count + __reduce_add_sync(kFull, lane < warp ? w : 0);
    const int total = __reduce_add_sync(kFull, w);
#pragma unroll
    for (int g = 0; g < kSplitGroups; ++g) {
      const int mine = slot + __popc(mask[g] & below);
      if ((mask[g] >> lane & 1u) && mine < K) {
        const int j = base + (warp * kSplitGroups + g) * 32 + lane;
        out[mine] = j;
        if (mine == 0) first_hit = j;
      }
      slot += __popc(mask[g]);
    }
    count += total;
    if (count >= K) break;
  }
  __syncthreads();  // first_hit is written
  const int fill = count > 0 ? first_hit : N - 1;
  for (int k = count + (int)threadIdx.x; k < K; k += blockDim.x) out[k] = fill;
}

template <bool kMatmul>
int launch(const float* new_xyz, const float* xyz, int* idx, int B, int N, int S, int K,
           float radius_sq, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  // few centroids over a cloud above one tile: a block a centroid
  const long centroids = (long)B * S;
  if (N > kTileMax && centroids < (long)kSplitCentroidsPerSm * sms) {
    ball_split_kernel<kMatmul><<<(unsigned)centroids, kSplitWarps * 32, 0, stream>>>(
        new_xyz, xyz, idx, N, S, K, radius_sq);
    return (int)cudaGetLastError();
  }
  if (B > 65535) return (int)cudaErrorInvalidValue;
  static_assert(kTilePad % (32 * kWarpGroups) == 0 && kTileMax % kTilePad == 0, "tile");
  static_assert(32 * kWarpCentroids <= kStagedThreads, "block");
  const int tile = min((N + kTilePad - 1) / kTilePad * kTilePad, kTileMax);
  const size_t smem = 16 * (size_t)tile;
  static_assert(16L * kTileMax <= kMaxSmemBytes, "tile");
  auto kernel = ball_warp_kernel<kMatmul>;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)((S + kWarpCentroids - 1) / kWarpCentroids), (unsigned)B);
  kernel<<<grid, 32 * kWarpCentroids, smem, stream>>>(new_xyz, xyz, idx, N, S, K, radius_sq,
                                                      tile);
  return (int)cudaGetLastError();
}

}  // namespace

// new_xyz (B,S,3) f32, xyz (B,N,3) f32 -> idx (B,S,K) i32. radius_sq is the
// squared radius, rounded to f32 by the caller; matmul_form picks the
// matmul-form distance (1) or the difference form (0). Returns
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// launch's error.
extern "C" int pcot_ball_query_f32(const void* new_xyz, const void* xyz, void* idx, int B,
                                   int N, int S, int K, float radius_sq, int matmul_form,
                                   void* stream) {
  if (B < 1 || N < 1 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const float* c = (const float*)new_xyz;
  const float* x = (const float*)xyz;
  int* o = (int*)idx;
  cudaStream_t st = (cudaStream_t)stream;
  return matmul_form ? launch<true>(c, x, o, B, N, S, K, radius_sq, st)
                     : launch<false>(c, x, o, B, N, S, K, radius_sq, st);
}
