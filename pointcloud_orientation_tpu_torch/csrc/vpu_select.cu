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
// The four selections take d (B, S, N) f32 without NaN and write (B, K, S)
// or (B, 1, S) int32 as the TPU kernels lay their outputs out. All four
// hold the row in registers: one warp a row up to N = 1,024, with no shared
// memory and no barrier; one block a row above (the row in shared memory
// only past 16,384 entries). Their first ports ran a block a row over the
// row in shared memory and spent their time on barriers and shared-memory
// reads (two barriers and a rescan a pass, 31 to 64 barriers a row,
// PERF.md), not on the bytes they must move.
// - sel_mintie and sel_argmin: K passes of the row's least entry, the
//   lowest position among equal ones: each thread keeps its few least order
//   keys in order (the first word first among equal keys); the owner masks
//   the winner with +inf and its next kept key moves up, and it scans its
//   registers again only when the finite keys kept run out. The two differ
//   only in a pass's reduction, as their TPU formulations do: sel_mintie
//   takes the minimum, then the lowest lane holding it (two
//   __reduce_min_sync in a warp); sel_argmin one argmin of (key, position)
//   packed in 64 bits (a __shfl_xor_sync butterfly). In the block design
//   the warps' winners are merged through one barrier a pass, the same way;
// - count_emit: the K-th smallest bit pattern as int32 (so -0.0 and
//   negative values lie below every other entry), R bits a pass by counting
//   the entries below 2^R - 1 candidates together (one barrier a pass in
//   the block design); once the bucket that holds the threshold is small,
//   its entries go to a list in shared memory and one warp makes the passes
//   left over it. Then the lanes in lane order: every entry below the
//   threshold and the first ties, up to K, each written at its slot, which
//   two ballots and __popc give a warp 32 lanes at a time after one scan of
//   the warps' counts;
// - radix_count: count_emit's threshold without the emission (the TPU
//   kernel's "counting half of a radix select"; there 31 one-bit passes
//   over the whole row).
// The counts kept, the bits a pass and the lists' caps are the fastest of
// chip_sweep.py's variants (PERF.md).
// The K-pass kernels give the stable sort's first K on rows without NaN
// (the masked +inf is the TPU kernels' choice: past the row's finite
// entries a pass picks the lowest +inf lane again, as jnp.argmin does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

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
// the selections: the row in registers
// ---------------------------------------------------------------------------
//
// A row of up to kWarpMaxN entries goes to one warp, kWarpRows rows a
// block, W = ceil(N / 32) words a lane: no shared memory and no barrier. A
// longer row goes to one block of kBlockThreads, W words a thread, up to
// kRegMaxN entries; past that the row lies in dynamic shared memory and a
// block of kSmemThreads reads each thread's words there (each thread stages
// and reads only its own words, so staging takes no barrier). W is the
// least count of a ladder of compile-time counts that holds the row, so
// every register index is a constant.

constexpr int kWarpMaxN = 1024;
constexpr int kWarpRows = 4;
constexpr int kBlockThreads = 512;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kRegMaxN = kBlockThreads * 32;
constexpr int kSmemThreads = 1024;
constexpr int kSmemWarps = kSmemThreads / 32;
// sel_mintie and sel_argmin: the least keys a thread keeps in order, in the
// warp and the block designs; it scans its words again only when the
// finite ones run out (1: after each of its wins)
constexpr int kMintieKeepWarp = 6;
constexpr int kMintieKeepBlock = 2;
// count_emit and radix_count: the bits of the threshold that one count
// pass decides, by counting the entries below 2^R - 1 candidates together
// (31 bits take ceil(31 / R) passes), over the row in the warp and the block designs and
// over the bucket's list; and the bucket size at which the passes left go
// to a list in shared memory, in each design
constexpr int kEmitBitsWarp = 1;
constexpr int kEmitBitsBlock = 2;
constexpr int kEmitBitsList = 2;
constexpr int kEmitCapWarp = 64;
constexpr int kEmitCapBlock = 512;

// count_emit's and radix_count's words of a thread: W in registers, or n in shared memory
// (word w at p[w * step]).
template <int W>
struct RegWords {
  int v[W];
  __device__ __forceinline__ int words() const { return W; }
  __device__ __forceinline__ int operator[](int w) const { return v[w]; }
};

struct SmemWords {
  const int* p;
  int step, n;
  __device__ __forceinline__ int words() const { return n; }
  __device__ __forceinline__ int operator[](int w) const { return p[w * step]; }
};

// the K-pass kernels' order key: unsigned order is float order and -0.0 is
// +0.0's key (float == decides the ties). A taken entry takes +inf's key,
// so it ties with every +inf of the row (rows hold no NaN).
constexpr unsigned kInfKey = 0xff800000u;
constexpr unsigned kPadKey = 0xffffffffu;  // past the row: above every entry

__device__ __forceinline__ unsigned mintie_key(float v) {
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the K-pass kernels' keys of a thread: W in registers with a mask of the
// words taken, or n in shared memory, a taken word overwritten.
template <int W>
struct RegKeys {
  static_assert(W <= 32, "one bit a word");
  unsigned v[W];
  unsigned taken = 0;
  __device__ __forceinline__ int words() const { return W; }
  __device__ __forceinline__ unsigned operator[](int w) const {
    return (taken >> w) & 1u ? kInfKey : v[w];
  }
  __device__ __forceinline__ void take(int w) { taken |= 1u << w; }
};

struct SmemKeys {
  unsigned* p;
  int step, n;
  __device__ __forceinline__ int words() const { return n; }
  __device__ __forceinline__ unsigned operator[](int w) const { return p[w * step]; }
  __device__ __forceinline__ void take(int w) { p[w * step] = kInfKey; }
};

// A thread's T least (key, word), ascending, equal keys by word.
template <int T>
struct Least {
  unsigned k[T];
  int w[T];
};

template <int T, class Keys>
__device__ __forceinline__ void least_keys(const Keys& keys, Least<T>& l) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    l.k[t] = kPadKey;
    l.w[t] = 0;
  }
#pragma unroll
  for (int w = 0; w < keys.words(); ++w) {
    const unsigned x = keys[w];  // words in order: x goes after the keys equal to it
#pragma unroll
    for (int t = T - 1; t > 0; --t) {
      const bool up = x < l.k[t - 1], here = x < l.k[t];
      l.w[t] = up ? l.w[t - 1] : here ? w : l.w[t];
      l.k[t] = up ? l.k[t - 1] : here ? x : l.k[t];
    }
    if (x < l.k[0]) {
      l.k[0] = x;
      l.w[0] = w;
    }
  }
}

// The owner of a pass's winner, its least: a finite key is taken (+inf from
// then on) and the next kept key moves up; once the finite keys kept run
// out the words are scanned again (+inf keys, given or taken, go by word).
// A winner at +inf stays the thread's least.
template <int T, class Keys>
__device__ __forceinline__ void take_least(Keys& keys, Least<T>& l) {
  if (l.k[0] >= kInfKey) return;
  keys.take(l.w[0]);
#pragma unroll
  for (int t = 0; t + 1 < T; ++t) {
    l.k[t] = l.k[t + 1];
    l.w[t] = l.w[t + 1];
  }
  l.k[T - 1] = kPadKey;
  if (l.k[0] >= kInfKey) least_keys(keys, l);
}

// A pass's winner among a warp's lanes, each offering its least key and
// that key's position: the least (key, position) pair, packed as key << 32
// | position, in every lane. sel_mintie takes it by two __reduce_min_sync
// (the least key, then the lowest position holding it); sel_argmin by one
// argmin of the packed words, a five-step __shfl_xor_sync butterfly (two
// 32-bit shuffles a step).
template <bool kArgmin>
__device__ __forceinline__ unsigned long long warp_least(unsigned key, unsigned pos) {
  if constexpr (kArgmin) {
    unsigned long long x = (unsigned long long)key << 32 | pos;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(kFull, x, off));
    return x;
  } else {
    const unsigned least = __reduce_min_sync(kFull, key);
    return (unsigned long long)least << 32 |
           __reduce_min_sync(kFull, key == least ? pos : UINT_MAX);
  }
}

// sel_mintie and sel_argmin, one warp a row, lane l holding positions l,
// l + 32, ...: a pass is warp_least of the lanes' least keys; the owner
// takes the winner.
template <int W, bool kArgmin>
__global__ void __launch_bounds__(kWarpRows * 32)
kpass_warp_kernel(const float* __restrict__ d, int* __restrict__ out, int rows, int S, int N,
                  int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const float* src = d + (size_t)r * N;
  RegKeys<W> keys;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int n = w * 32 + lane;
    keys.v[w] = n < N ? mintie_key(__ldg(src + n)) : kPadKey;
  }
  Least<kMintieKeepWarp> l;
  least_keys(keys, l);
  const int b = r / S;
  int* dst = out + ((size_t)b * K * S + (r - b * S));
  for (int k = 0; k < K; ++k) {
    const unsigned pos = (unsigned)warp_least<kArgmin>(l.k[0], (unsigned)(l.w[0] * 32 + lane));
    if (lane == 0) dst[(size_t)k * S] = (int)pos;
    if (lane == (int)(pos & 31u)) take_least(keys, l);
  }
}

// The same, one block of T threads a row, thread t holding positions t,
// t + T, ...: a pass takes each warp's least pair by warp_least, one
// barrier, then every warp reduces the warps' pairs the same way (two
// buffers, alternating); the owner takes the winner.
template <int T, bool kArgmin, class Keys>
__device__ __forceinline__ void kpass_block_passes(Keys& keys, int* __restrict__ dst, int S,
                                                   int K, unsigned long long (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Least<kMintieKeepBlock> l;
  least_keys(keys, l);
  for (int k = 0; k < K; ++k) {
    const unsigned long long wx =
        warp_least<kArgmin>(l.k[0], (unsigned)(l.w[0] * T) + threadIdx.x);
    if (lane == 0) red[k & 1][warp] = wx;
    __syncthreads();
    const unsigned long long x = lane < T / 32 ? red[k & 1][lane] : ~0ull;
    const unsigned pos = (unsigned)warp_least<kArgmin>((unsigned)(x >> 32), (unsigned)x);
    if (threadIdx.x == 0) dst[(size_t)k * S] = (int)pos;
    if (threadIdx.x == pos % T) take_least(keys, l);
  }
}

template <int W, bool kArgmin>  // W == 0: the row in shared memory
__global__ void __launch_bounds__(W ? kBlockThreads : kSmemThreads)
kpass_block_kernel(const float* __restrict__ d, int* __restrict__ out, int rows, int S, int N,
                   int K) {
  constexpr int T = W ? kBlockThreads : kSmemThreads;
  extern __shared__ unsigned kpass_row[];
  __shared__ unsigned long long red[2][32];
  const int r = blockIdx.x;
  const float* src = d + (size_t)r * N;
  const int b = r / S;
  int* dst = out + ((size_t)b * K * S + (r - b * S));
  if constexpr (W > 0) {
    RegKeys<W> keys;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int n = w * T + threadIdx.x;
      keys.v[w] = n < N ? mintie_key(__ldg(src + n)) : kPadKey;
    }
    kpass_block_passes<T, kArgmin>(keys, dst, S, K, red);
  } else {
    SmemKeys keys{kpass_row + threadIdx.x, T, (N + T - 1) / T};
    for (int w = 0; w < keys.n; ++w) {  // each thread stages only its own words
      const int n = w * T + threadIdx.x;
      keys.p[w * T] = n < N ? mintie_key(__ldg(src + n)) : kPadKey;
    }
    kpass_block_passes<T, kArgmin>(keys, dst, S, K, red);
  }
}

// count_emit's search for its threshold, radix_count's answer (the largest P
// in [0, 2^31) with fewer than K of the row's bit patterns below it): the
// bits of prefix above hi are decided, the bucket [prefix, prefix + 2^hi)
// holds the answer, `below` entries of the row lie below the bucket (-1:
// not counted yet) and `upper` below its end.
struct Search {
  int prefix, hi, below, upper;
};

// Count passes of R bits until the bits run out or, with cap >= 0, the
// bucket holds at most cap entries. A pass counts the entries of v below
// each candidate prefix | j << shift, j = 1 .. 2^R - 1, together, adds base
// (entries of the row below the bucket and not in v), and takes the largest
// j whose count stays under K (the counts grow with j). Lane j - 1 holds
// candidate j's count for the row: summed by __reduce_add_sync in a warp
// and, with several warps a row, through one shared array and one barrier
// (two buffers, alternating).
template <int R, int kRowWarps, class Words>
__device__ __forceinline__ void threshold_passes(const Words& v, int K, int base, int cap,
                                                 Search& s,
                                                 int (*red)[kRowWarps][(1 << R) - 1]) {
  constexpr int C = (1 << R) - 1;
  static_assert(C <= 32, "a lane a candidate");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int p = 0; s.hi > 0 && !(s.below >= 0 && s.upper - s.below <= cap); p ^= 1) {
    const int nb = min(s.hi, R);  // the last pass decides the bits left
    const int shift = s.hi - nb;
    int cand[C], c0[C], c1[C];  // two partial counts: half-length chains
#pragma unroll
    for (int j = 0; j < C; ++j) {
      cand[j] = (int)((unsigned)s.prefix + ((unsigned)(j + 1) << shift));
      c0[j] = c1[j] = 0;
    }
#pragma unroll
    for (int w = 0; w < v.words(); w += 2) {
      const int x0 = v[w], x1 = w + 1 < v.words() ? v[w + 1] : INT_MAX;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        c0[j] += x0 < cand[j];
        c1[j] += x1 < cand[j];
      }
    }
    int total = base;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int sum = __reduce_add_sync(kFull, c0[j] + c1[j]);
      if (kRowWarps == 1) {
        if (lane == j) total += sum;
      } else if (lane == 0) {
        red[p][warp][j] = sum;
      }
    }
    if (kRowWarps > 1) {
      __syncthreads();
      if (lane < C)
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w) total += red[p][w][lane];
    }
    const int last = (1 << nb) - 1;  // candidates past it leave the pass's bits
    const int j = __popc(__ballot_sync(kFull, lane < last && total < K));
    const int lo = __shfl_sync(kFull, total, max(j - 1, 0));
    const int up = __shfl_sync(kFull, total, min(j, C - 1));
    if (j > 0) s.below = lo;
    if (j < last) s.upper = up;
    s.prefix += j << shift;
    s.hi = shift;
  }
}

// The end of the search once the bucket holds at most the design's cap of
// entries: they go to a list in shared memory (the warp's own in the warp
// design, in lane order by ballots; the block's, in any order, a count needs
// none), and one warp makes the passes left over the list, adding the
// entries below the bucket; in the block design with no barrier, then one
// to hand P to the other warps through *count.
template <int kRowWarps, class Words>
__device__ __forceinline__ int finish_over_list(const Words& v, int base_pos, int N, int K,
                                                const Search& s, int* list, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned span = 1u << s.hi;
  if (kRowWarps == 1) {
    const unsigned lt = (1u << lane) - 1u;
    int n = 0;
#pragma unroll
    for (int w = 0; w < v.words(); ++w) {
      const int x = v[w];
      const bool in = base_pos + w * 32 + lane < N && (unsigned)x - (unsigned)s.prefix < span;
      const unsigned vote = __ballot_sync(kFull, in);
      if (in) list[n + __popc(vote & lt)] = x;
      n += __popc(vote);
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int w = 0; w < v.words(); ++w) {
      const int x = v[w];
      if (base_pos + w * 32 + lane < N && (unsigned)x - (unsigned)s.prefix < span)
        list[atomicAdd(count, 1)] = x;
    }
    __syncthreads();
  }
  Search one = s;
  if (kRowWarps == 1 || threadIdx.x < 32) {
    const int size = s.upper - s.below, words = (size + 31) / 32;
    for (int i = size + lane; i < words * 32; i += 32) list[i] = INT_MAX;
    __syncwarp();
    threshold_passes<kEmitBitsList, 1>(SmemWords{list + lane, 32, words}, K, s.below, -1, one,
                                       nullptr);
  }
  if (kRowWarps == 1) return one.prefix;
  if (threadIdx.x == 0) *count = one.prefix;
  __syncthreads();
  return *count;
}

// count_emit's emission. A warp's chunk holds positions base + w * 32 +
// lane. Each warp counts its entries below P and tied with it; with several
// warps a row, one scan over the warps' counts (one barrier) gives each
// warp the counts before its chunk. Then each word takes two ballots, and
// each selected entry goes to its slot: the entries below P before it and
// the ties taken before it (the first K - below of the row). Every row
// fills its K slots: fewer than K entries lie below P and, P being
// min(K-th smallest, 2^31 - 1) or 0 under K negative patterns, at least K
// at or below it.
template <int kRowWarps, class Words>
__device__ __forceinline__ void emit_lanes(const Words& v, int P, int base, int N, int K,
                                           int* __restrict__ dst, int S, int2* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int below = 0, ties = 0;
#pragma unroll
  for (int w = 0; w < v.words(); ++w) {
    const int x = v[w];
    below += x < P;
    ties += x == P && base + w * 32 + lane < N;
  }
  below = __reduce_add_sync(kFull, below);
  ties = __reduce_add_sync(kFull, ties);
  int before_b = 0, before_t = 0, all_b = below;
  if (kRowWarps > 1) {
    if (lane == 0) scan[warp] = make_int2(below, ties);
    __syncthreads();
    const int2 c = lane < kRowWarps ? scan[lane] : make_int2(0, 0);
    before_b = __reduce_add_sync(kFull, lane < warp ? c.x : 0);
    before_t = __reduce_add_sync(kFull, lane < warp ? c.y : 0);
    all_b = __reduce_add_sync(kFull, c.x);
  }
  const int take = max(K - all_b, 0);  // the ties to take, the first in lane order
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int w = 0; w < v.words(); ++w) {
    if (before_b + min(before_t, take) >= K) break;  // the slots are full (warp-uniform)
    const int n = base + w * 32 + lane;
    const int x = v[w];
    const bool lo = x < P, tie = x == P && n < N;
    const unsigned bb = __ballot_sync(kFull, lo), bt = __ballot_sync(kFull, tie);
    const int my_b = before_b + __popc(bb & lt), my_t = before_t + __popc(bt & lt);
    const int slot = my_b + min(my_t, take);
    if ((lo || (tie && my_t < take)) && slot < K) dst[(size_t)slot * S] = n;
    before_b += __popc(bb);
    before_t += __popc(bt);
  }
}

// count_emit over one row: one warp (kRowWarps == 1, a list a warp) or
// kRowWarps warps (one list), each warp a chunk of consecutive positions
// starting at base. Padding is INT_MAX, below no candidate. Without
// kEmit, radix_count: the threshold alone, written to *dst by one thread.
template <int kRowWarps, bool kEmit, class Words>
__device__ __forceinline__ void count_emit_row(const Words& v, int base, int N, int K,
                                               int* __restrict__ dst, int S) {
  constexpr int R = kRowWarps == 1 ? kEmitBitsWarp : kEmitBitsBlock;
  constexpr int kCap = kRowWarps == 1 ? kEmitCapWarp : kEmitCapBlock;
  constexpr int kLists = kRowWarps == 1 ? kWarpRows : 1;
  __shared__ int red[2][kRowWarps][(1 << R) - 1];
  __shared__ int list[kLists][kCap];
  __shared__ int count;
  if (kRowWarps > 1 && threadIdx.x == 0) count = 0;  // read after the first pass's barrier
  Search s{0, 31, -1, N};  // every entry lies below 2^31
  threshold_passes<R, kRowWarps>(v, K, 0, kCap, s, red);
  const int P = s.hi > 0 ? finish_over_list<kRowWarps>(v, base, N, K, s,
                                                       list[kLists > 1 ? threadIdx.x >> 5 : 0],
                                                       &count)
                         : s.prefix;
  if constexpr (kEmit) {
    __shared__ int2 scan[kRowWarps];
    emit_lanes<kRowWarps>(v, P, base, N, K, dst, S, scan);
  } else if ((kRowWarps == 1 ? threadIdx.x & 31 : threadIdx.x) == 0) {
    *dst = P;
  }
}

// count_emit (kEmit) or radix_count: each warp a chunk of 32 * W
// positions, W in registers, or the row in shared memory (W == 0)
template <int W, int kRowWarps, bool kEmit>
__global__ void __launch_bounds__(kRowWarps == 1 ? kWarpRows * 32 : kRowWarps * 32)
count_emit_kernel(const float* __restrict__ d, int* __restrict__ out, int rows, int S, int N,
                  int K) {
  extern __shared__ int emit_row[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = kRowWarps == 1 ? blockIdx.x * kWarpRows + warp : blockIdx.x;
  if (r >= rows) return;  // the whole warp (a block's rows never run out)
  const int* src = reinterpret_cast<const int*>(d) + (size_t)r * N;
  const int b = r / S;
  int* dst = out + (kEmit ? (size_t)b * K * S + (r - b * S) : (size_t)r);  // (B, K|1, S)
  if constexpr (W > 0) {
    const int base = kRowWarps == 1 ? 0 : warp * 32 * W;
    RegWords<W> v;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int n = base + w * 32 + lane;
      v.v[w] = n < N ? __ldg(src + n) : INT_MAX;
    }
    count_emit_row<kRowWarps, kEmit>(v, base, N, K, dst, S);
  } else {
    const int words = (N + 32 * kRowWarps - 1) / (32 * kRowWarps);
    const int base = warp * 32 * words;
    for (int w = 0; w < words; ++w) {  // each thread stages only its own words
      const int n = base + w * 32 + lane;
      emit_row[base + w * 32 + lane] = n < N ? __ldg(src + n) : INT_MAX;
    }
    count_emit_row<kRowWarps, kEmit>(SmemWords{emit_row + base + lane, 32, words}, base, N, K,
                                     dst, S);
  }
}

using SelectKernel = void (*)(const float*, int*, int, int, int, int);

struct Plan {
  SelectKernel kernel;
  int threads, rows_per_block, smem;
};

// The design a row of N entries takes, and its W from the ladders: 1, 2,
// 4, ..., 32 words a lane (a warp a row); 4, 8, 16, 20, 24, 32 words a
// thread (a block a row; 20 for N = 10,000); shared memory past 16,384.
template <class F>
Plan plan_for(int N) {
  if (N <= kWarpMaxN) {
    const int rpb = kWarpRows;
    const int t = kWarpRows * 32;
    if (N <= 32) return {F::template warp<1>(), t, rpb, 0};
    if (N <= 64) return {F::template warp<2>(), t, rpb, 0};
    if (N <= 128) return {F::template warp<4>(), t, rpb, 0};
    if (N <= 256) return {F::template warp<8>(), t, rpb, 0};
    if (N <= 512) return {F::template warp<16>(), t, rpb, 0};
    return {F::template warp<32>(), t, rpb, 0};
  }
  if (N <= kBlockThreads * 4) return {F::template block<4>(), kBlockThreads, 1, 0};
  if (N <= kBlockThreads * 8) return {F::template block<8>(), kBlockThreads, 1, 0};
  if (N <= kBlockThreads * 16) return {F::template block<16>(), kBlockThreads, 1, 0};
  if (N <= kBlockThreads * 20) return {F::template block<20>(), kBlockThreads, 1, 0};
  if (N <= kBlockThreads * 24) return {F::template block<24>(), kBlockThreads, 1, 0};
  if (N <= kRegMaxN) return {F::template block<32>(), kBlockThreads, 1, 0};
  const int words = (N + kSmemThreads - 1) / kSmemThreads;
  return {F::template block<0>(), kSmemThreads, 1, words * kSmemThreads * 4};
}

template <bool kArgmin>
struct KPassKernels {
  template <int W>
  static SelectKernel warp() { return kpass_warp_kernel<W, kArgmin>; }
  template <int W>
  static SelectKernel block() { return kpass_block_kernel<W, kArgmin>; }
};
using MintieKernels = KPassKernels<false>;
using ArgminKernels = KPassKernels<true>;

template <bool kEmit>
struct CountKernels {
  template <int W>
  static SelectKernel warp() { return count_emit_kernel<W, 1, kEmit>; }
  template <int W>
  static SelectKernel block() {
    if constexpr (W > 0) return count_emit_kernel<W, kBlockWarps, kEmit>;
    return count_emit_kernel<0, kSmemWarps, kEmit>;
  }
};
using EmitKernels = CountKernels<true>;
using RadixKernels = CountKernels<false>;

template <class F>
int launch_select(const void* d, void* out, int B, int S, int N, int K, void* stream) {
  const Plan p = plan_for<F>(N);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute((const void*)p.kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  int rows = B * S;
  const float* x = (const float*)d;
  int* o = (int*)out;
  void* args[] = {&x, &o, &rows, &S, &N, &K};
  const cudaError_t err = cudaLaunchKernel((const void*)p.kernel,
                                           (rows + p.rows_per_block - 1) / p.rows_per_block,
                                           p.threads, args, (size_t)p.smem, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
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
// row, nearest first, equal values to the lowest lane (K argmin passes of
// packed (key, position) pairs).
extern "C" int pcot_vpu_sel_argmin(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_select<ArgminKernels>(d, out, B, S, N, K, stream);
}

// the same, by K passes of a minimum and its lowest tied lane
extern "C" int pcot_vpu_sel_mintie(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_select<MintieKernels>(d, out, B, S, N, K, stream);
}

// d (B,S,N) f32 -> out (B,1,S) i32: the bit pattern of each row's K-th
// smallest value (d >= 0), by count_emit's count passes
extern "C" int pcot_vpu_radix_count(const void* d, void* out, int B, int S, int N, int K,
                                    void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_select<RadixKernels>(d, out, B, S, N, K, stream);
}

// d (B,S,N) f32 -> out (B,K,S) i32: the lanes of the K smallest bit
// patterns (ties: the first in lane order), in ascending lane order
extern "C" int pcot_vpu_count_emit(const void* d, void* out, int B, int S, int N, int K,
                                   void* stream) {
  if (bad_rows(B, S, N, K)) return (int)cudaErrorInvalidValue;
  return launch_select<EmitKernels>(d, out, B, S, N, K, stream);
}
