// The selection micro-benchmarks for Hopper (sm_90a): an elementwise rate
// probe and four formulations of a row's K-nearest selection.
//
// Replaces the TPU kernels of benchmarks/profile_vpu_select.py: _ew_kernel
// (:58, launched by ew :69) and _sel_argmin_kernel (:86),
// _sel_mintie_kernel (:97), _radix_count_kernel (:109) and
// _count_emit_kernel (:123), launched by sel (:174). On the TPU they chose
// sa_group's selection for the v5e's vector unit. The H100 has no such unit:
// its CUDA cores run the elementwise work and its warps' shuffles, ballots
// and block barriers the reductions, so each kernel here is designed for
// those, and the same question is asked again (chip_sweep.py times them
// beside topk_min on the grouping's distance tiles, PERF.md).
//
// ew: 32 (reps) rounds of x = max(x + x, x * x) on every element, f32, bf16
// (each operation rounded to bf16 to nearest even: the card's packed
// bf16x2 add, multiply and max) or int16 (wrapping modulo 2^16). One
// 16-byte vector a thread; bound by bytes (read once, written once), with
// 96 operations an element against the f32 rate close behind.
//
// The four selections take d (B, S, N) f32 without NaN, one block a row
// (b, s), the row in shared memory, and write (B, K, S) or (B, 1, S) int32
// as the TPU kernels lay their outputs out:
// - sel_argmin: K passes of argmin-and-mask (the winner set to +inf), the
//   design csrc/sa_group.cu used before its threshold select: each thread
//   keeps the minimum (value, lane) of its strided slice in registers, a
//   pass is a warp-shuffle argmin, a merge of the warp winners by warp 0
//   (two barriers), and a rescan of one slice by the winner's owner;
// - sel_mintie: K passes of a block minimum, then the lowest lane holding
//   it: two block reductions a pass, each a shuffle reduction and a merge
//   that every thread reads (one barrier each, alternating buffers);
// - radix_count: 31 passes over the f32 bit patterns as int32 (d >= 0
//   orders them), each a block count of the entries below the candidate
//   prefix (a warp's __reduce_add_sync, one barrier): the K-th smallest
//   pattern;
// - count_emit: radix_count's passes, one more count (the entries below
//   the threshold), then the lanes in lane order: every entry below the
//   threshold and the first ties, up to K, each written at its rank, which
//   warp ballots and __popc prefix counts give a block of lanes at a time.
// Both K-pass kernels give the stable sort's first K on rows without NaN
// (the masked +inf is the TPU kernels' choice: past the row's finite
// entries a pass picks the lowest +inf lane again, as jnp.argmin does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxN = 49152;  // a row in dynamic shared memory: 192 KB
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// ew
// ---------------------------------------------------------------------------

// max that propagates NaN, as jnp.maximum and torch.maximum: one instruction
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ unsigned ew_f32(unsigned w, int reps) {
  float x = __uint_as_float(w);
  for (int r = 0; r < reps; ++r) x = max_nan(__fadd_rn(x, x), __fmul_rn(x, x));
  return __float_as_uint(x);
}

// two bf16 in a word: add, multiply and (NaN-propagating) max of bf16x2,
// each rounded to nearest even (x + x and x * x of bf16 values are exact in
// f32, so this is f32 arithmetic rounded after every operation)
__device__ __forceinline__ unsigned ew_bf16x2(unsigned w, int reps) {
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w);
  for (int r = 0; r < reps; ++r) x = __hmax2_nan(__hadd2(x, x), __hmul2(x, x));
  return *reinterpret_cast<const unsigned*>(&x);
}

__device__ __forceinline__ short ew_i16(short v, int reps) {
  int x = v;
  for (int r = 0; r < reps; ++r) {
    const int a = (short)(x + x);  // wraps modulo 2^16
    const int b = (short)(x * x);
    x = a > b ? a : b;
  }
  return (short)x;
}

__device__ __forceinline__ unsigned ew_i16x2(unsigned w, int reps) {
  const unsigned lo = (unsigned short)ew_i16((short)(w & 0xffffu), reps);
  const unsigned hi = (unsigned short)ew_i16((short)(w >> 16), reps);
  return lo | (hi << 16);
}

// kind 0 f32, 1 bf16, 2 int16: a 32-bit word holds 1, 2, 2 elements
template <int kKind>
__device__ __forceinline__ unsigned ew_word(unsigned w, int reps) {
  if (kKind == 0) return ew_f32(w, reps);
  if (kKind == 1) return ew_bf16x2(w, reps);
  return ew_i16x2(w, reps);
}

// words16 16-byte vectors a thread each, then the tail elements past them
// one a thread
template <int kKind>
__global__ void __launch_bounds__(256)
ew_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long words16, int tail,
          int reps) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words16) {
    uint4 v = x[i];
    v.x = ew_word<kKind>(v.x, reps);
    v.y = ew_word<kKind>(v.y, reps);
    v.z = ew_word<kKind>(v.z, reps);
    v.w = ew_word<kKind>(v.w, reps);
    out[i] = v;
  } else if (i - words16 < tail) {  // the tail's elements, one a thread
    const long e = i - words16;
    if (kKind == 0) {
      const unsigned* xs = reinterpret_cast<const unsigned*>(x + words16);
      reinterpret_cast<unsigned*>(out + words16)[e] = ew_f32(xs[e], reps);
    } else {
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x + words16);
      unsigned short* os = reinterpret_cast<unsigned short*>(out + words16);
      if (kKind == 1) {
        // one bf16 as the low half of a word; the high half's result is dropped
        os[e] = (unsigned short)(ew_bf16x2(xs[e], reps) & 0xffffu);
      } else {
        os[e] = (unsigned short)ew_i16((short)xs[e], reps);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the selections
// ---------------------------------------------------------------------------

// (d, i) < (od, oi) lexicographically
__device__ __forceinline__ bool key_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

__device__ __forceinline__ void warp_argmin(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(kFull, d, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (key_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Stage row r of d in shared memory; each thread's (value, lane) minimum of
// its strided slice. Only the owner (lane % blockDim.x) reads a slice later.
__device__ __forceinline__ void stage_row(const float* __restrict__ src, float* row, int N,
                                          float& best_d, int& best_i) {
  best_d = INFINITY;
  best_i = INT_MAX;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float v = __ldg(src + n);
    row[n] = v;
    if (key_less(v, n, best_d, best_i)) {
      best_d = v;
      best_i = n;
    }
  }
}

// the owner of lane w masks it with +inf and takes its slice's minimum again
__device__ __forceinline__ void mask_and_rescan(float* row, int N, int w, float& best_d,
                                                int& best_i) {
  if (w % (int)blockDim.x != (int)threadIdx.x) return;
  row[w] = INFINITY;
  best_d = INFINITY;
  best_i = INT_MAX;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float v = row[n];
    if (key_less(v, n, best_d, best_i)) {
      best_d = v;
      best_i = n;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
sel_argmin_kernel(const float* __restrict__ d, int* __restrict__ out, int S, int N, int K) {
  extern __shared__ float row[];
  __shared__ float red_d[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  __shared__ int win;
  const int r = blockIdx.x;
  const int b = r / S, s = r - b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float best_d;
  int best_i;
  stage_row(d + (size_t)r * N, row, N, best_d, best_i);
  for (int k = 0; k < K; ++k) {
    float v = best_d;
    int i = best_i;
    warp_argmin(v, i);
    if (lane == 0) {
      red_d[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < warps ? red_d[lane] : INFINITY;
      i = lane < warps ? red_i[lane] : INT_MAX;
      warp_argmin(v, i);
      if (lane == 0) {
        win = i;
        out[((size_t)b * K + k) * S + s] = i;
      }
    }
    __syncthreads();
    mask_and_rescan(row, N, win, best_d, best_i);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
sel_mintie_kernel(const float* __restrict__ d, int* __restrict__ out, int S, int N, int K) {
  extern __shared__ float row[];
  __shared__ float red_m[2][kMaxWarps];
  __shared__ int red_l[2][kMaxWarps];
  const int r = blockIdx.x;
  const int b = r / S, s = r - b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float best_d;  // this slice's minimum and the lowest lane holding it
  int best_i;
  stage_row(d + (size_t)r * N, row, N, best_d, best_i);
  for (int k = 0; k < K; ++k) {
    const int p = k & 1;  // buffers alternate: a pass never writes what the last one reads
    float m = best_d;
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) red_m[p][warp] = m;
    __syncthreads();
    m = red_m[p][0];
    for (int w = 1; w < warps; ++w) m = fminf(m, red_m[p][w]);
    int c = best_d == m ? best_i : INT_MAX;  // the lowest tied lane
    for (int off = 16; off > 0; off >>= 1) c = min(c, __shfl_xor_sync(kFull, c, off));
    if (lane == 0) red_l[p][warp] = c;
    __syncthreads();
    c = red_l[p][0];
    for (int w = 1; w < warps; ++w) c = min(c, red_l[p][w]);
    if (threadIdx.x == 0) out[((size_t)b * K + k) * S + s] = c;
    mask_and_rescan(row, N, c, best_d, best_i);
  }
}

// The count of the row's entries whose bit pattern is below cand, summed
// over the block; buffer p alternates between calls.
__device__ __forceinline__ int block_count_below(const int* bits, int N, int cand,
                                                 int (&red)[2][kMaxWarps], int p) {
  int cnt = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) cnt += bits[n] < cand;
  cnt = __reduce_add_sync(kFull, cnt);
  if ((threadIdx.x & 31) == 0) red[p][threadIdx.x >> 5] = cnt;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[p][w];
  return total;
}

// Stage the row's bit patterns; the K-th smallest by 31 count passes (bit
// 30 down to 0; d >= 0 keeps bit 31 clear).
__device__ __forceinline__ int radix_kth(const float* __restrict__ src, int* bits, int N, int K,
                                         int (&red)[2][kMaxWarps], int& passes) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) bits[n] = __float_as_int(__ldg(src + n));
  __syncthreads();
  int prefix = 0;
  passes = 0;
  for (int bit = 30; bit >= 0; --bit, ++passes) {
    const int cand = prefix | (1 << bit);
    if (block_count_below(bits, N, cand, red, passes & 1) < K) prefix = cand;
  }
  return prefix;
}

__global__ void __launch_bounds__(kMaxThreads)
radix_count_kernel(const float* __restrict__ d, int* __restrict__ out, int S, int N, int K) {
  extern __shared__ int bits[];
  __shared__ int red[2][kMaxWarps];
  int passes;
  const int prefix = radix_kth(d + (size_t)blockIdx.x * N, bits, N, K, red, passes);
  if (threadIdx.x == 0) out[blockIdx.x] = prefix;
}

__global__ void __launch_bounds__(kMaxThreads)
count_emit_kernel(const float* __restrict__ d, int* __restrict__ out, int S, int N, int K) {
  extern __shared__ int bits[];
  __shared__ int red[2][kMaxWarps];
  __shared__ unsigned tot[2][kMaxWarps];  // a warp's (ties << 16 | below) in a block of lanes
  const int r = blockIdx.x;
  const int b = r / S, s = r - b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int passes;
  const int prefix = radix_kth(d + (size_t)r * N, bits, N, K, red, passes);
  const int n_below = block_count_below(bits, N, prefix, red, passes & 1);
  const int take = K - n_below;  // ties to take, the first in lane order
  const unsigned lt = (1u << lane) - 1u;
  int run_below = 0, run_ties = 0;  // over the blocks of lanes before this one
  int* dst = out + (size_t)b * K * S + s;
  for (int base = 0, p = 0; base < N; base += blockDim.x, p ^= 1) {
    const int n = base + threadIdx.x;
    const int v = n < N ? bits[n] : INT_MAX;
    const bool below = n < N && v < prefix;
    const bool tie = n < N && v == prefix;
    const unsigned bb = __ballot_sync(kFull, below);
    const unsigned bt = __ballot_sync(kFull, tie);
    if (lane == 0) tot[p][warp] = ((unsigned)__popc(bt) << 16) | (unsigned)__popc(bb);
    __syncthreads();
    int before_b = run_below + __popc(bb & lt), before_t = run_ties + __popc(bt & lt);
    for (int w = 0; w < warps; ++w) {
      const unsigned t = tot[p][w];
      if (w < warp) {
        before_b += (int)(t & 0xffffu);
        before_t += (int)(t >> 16);
      }
      run_below += (int)(t & 0xffffu);
      run_ties += (int)(t >> 16);
    }
    const int slot = before_b + min(before_t, max(take, 0));
    if ((below || (tie && before_t < take)) && slot < K) dst[(size_t)slot * S] = n;
  }
  // slots past the lanes selected stay 0, as the TPU kernel's one-hot sum
  // leaves them (only negative bit patterns leave any)
  for (int k = n_below + min(run_ties, max(take, 0)) + threadIdx.x; k < K; k += blockDim.x)
    dst[(size_t)k * S] = 0;
}

int row_threads(int N) {
  int t = (N / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
}

// one block a row, the row's N 4-byte entries in dynamic shared memory
template <typename Kernel>
int launch_rows(Kernel kernel, int rows, int N, void* stream, const float* d, int* out, int S,
                int K) {
  const int smem = N * 4;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, row_threads(N), smem, (cudaStream_t)stream>>>(d, out, S, N, K);
  return (int)cudaGetLastError();
}

bool bad_rows(int B, int S, int N, int K) {
  return B < 1 || S < 1 || N < 1 || K < 1 || K > N || N > kMaxN || (long)B * S > INT_MAX;
}

}  // namespace

// x (n elements of kind 0 f32, 1 bf16, 2 int16), 16-byte aligned -> out
// (the same), reps rounds of max(x + x, x * x). Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int pcot_vpu_ew(const void* x, void* out, long long n, int kind, int reps,
                           void* stream) {
  if (n < 1 || kind < 0 || kind > 2 || reps < 0 || ((uintptr_t)x & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int per16 = kind == 0 ? 4 : 8;  // elements in a 16-byte vector
  const long words16 = (long)(n / per16);
  const int tail = (int)(n - (long long)words16 * per16);
  const long threads = words16 + tail;
  const long blocks = (threads + 255) / 256;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint4* xi = (const uint4*)x;
  uint4* oi = (uint4*)out;
  if (kind == 0)
    ew_kernel<0><<<(unsigned)blocks, 256, 0, st>>>(xi, oi, words16, tail, reps);
  else if (kind == 1)
    ew_kernel<1><<<(unsigned)blocks, 256, 0, st>>>(xi, oi, words16, tail, reps);
  else
    ew_kernel<2><<<(unsigned)blocks, 256, 0, st>>>(xi, oi, words16, tail, reps);
  return (int)cudaGetLastError();
}

// d (B,S,N) f32 without NaN -> out (B,K,S) i32: the K nearest lanes of each
// row, nearest first, equal values to the lowest lane (K argmin passes).
extern "C" int pcot_vpu_sel_argmin(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_rows(sel_argmin_kernel, B * S, N, stream, (const float*)d, (int*)out, S, K);
}

// the same, by K passes of a minimum and its lowest tied lane
extern "C" int pcot_vpu_sel_mintie(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_rows(sel_mintie_kernel, B * S, N, stream, (const float*)d, (int*)out, S, K);
}

// d (B,S,N) f32 -> out (B,1,S) i32: the bit pattern of each row's K-th
// smallest value (d >= 0), by 31 count passes
extern "C" int pcot_vpu_radix_count(const void* d, void* out, int B, int S, int N, int K,
                                    void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_rows(radix_count_kernel, B * S, N, stream, (const float*)d, (int*)out, S, K);
}

// d (B,S,N) f32 -> out (B,K,S) i32: the lanes of the K smallest bit
// patterns (ties: the first in lane order), in ascending lane order
extern "C" int pcot_vpu_count_emit(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_rows(count_emit_kernel, B * S, N, stream, (const float*)d, (int*)out, S, K);
}
