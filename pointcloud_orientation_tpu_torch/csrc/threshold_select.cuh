// The exact threshold select of csrc/topk_min.cu, csrc/sa_group.cu and
// csrc/knn.cu: the K smallest of a row, smallest first, equal values to the
// lowest position, by one block (block_select, over any visitor of the
// row's keys; select_sorted for a row staged in shared memory) or by one
// warp on a row of up to 1,024 entries in registers (warp_select_sorted).
//
// Every entry becomes a unique 64-bit key: its value's order key (the
// float's bits made order-preserving as an unsigned int, -0.0 as +0.0)
// shifted left over the bits of its position, or'ed with the position. The
// K-th smallest key is found 8 bits a pass from the top, each pass a
// 256-bin shared-memory histogram of the keys that share the digits found
// so far and one warp's scan of the bins; the search stops as soon as the
// bin holding the K-th key holds exactly the keys still to take (random
// distances: two or three passes; exact ties: the position's digits
// decide). The K keys at or below the prefix found are gathered in any
// order and each is put at its rank (the count of smaller keys among the
// K). A block takes three barriers a pass, a few passes, where the K argmin
// passes it replaced in the grouping (chip_sweep.py, PERF.md) took two
// barriers each of K passes; a warp takes none.
//
// Every NaN gets the largest key, above +inf, as a sort orders NaN last.
// The caller maps a selected key to its output: sa_group and knn give
// position 0 for a NaN (the K argmin passes never picked a NaN and gave 0
// once no candidate was left), topk_min gives 0 for +inf (an empty window
// slot, as its TPU kernel does). The matmul form of sa_group's distances
// can round below zero; negative values have order keys below every
// non-negative one, as a sort orders them.

#pragma once

#include <cuda_runtime.h>

namespace pcot_select {

constexpr int kBins = 256;
constexpr unsigned kInfKey = 0xff800000u;  // order_key(+inf)
constexpr unsigned kNanKey = 0xffffffffu;  // above kInfKey
constexpr unsigned kFull = 0xffffffffu;

// Unsigned order equals float order; -0.0 and +0.0 are one key; every NaN
// is kNanKey.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return kNanKey;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The bits of position a row of n entries needs, in whole 8-bit digits.
__host__ __device__ inline int position_bits(int n) {
  int bits = 1;
  while (bits < 24 && (1 << bits) < n) ++bits;
  return (bits + 7) / 8 * 8;
}

__device__ __forceinline__ unsigned long long composite(unsigned key, int pos, int pbits) {
  return ((unsigned long long)key << pbits) | (unsigned)pos;
}

// The position of a selected composite key, or 0 where its order key is
// `none` (kNanKey for the grouping and kNN, order_key(+inf) for topk_min).
__device__ __forceinline__ int position_or_zero(unsigned long long c, int pbits, unsigned none) {
  return (unsigned)(c >> pbits) == none ? 0 : (int)(c & ((1ull << pbits) - 1));
}

// One warp over the 256 bins: the bin where the running count reaches krem.
// True on the one lane that holds it, with the bin, the keys in the bins
// below it and the bin's own count.
__device__ __forceinline__ bool find_bin(const unsigned* hist, int krem, int lane, unsigned& bin,
                                         unsigned& before, unsigned& count) {
  unsigned h[kBins / 32];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
    h[j] = hist[lane * (kBins / 32) + j];
    sum += h[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  before = incl - sum;
  const bool mine = before < (unsigned)krem && (unsigned)krem <= incl;
  if (mine) {
#pragma unroll
    for (int j = 0; j < kBins / 32; ++j) {
      if ((unsigned)krem <= before + h[j]) {
        bin = lane * (kBins / 32) + j;
        count = h[j];
        break;
      }
      before += h[j];
    }
  }
  return mine;
}

// place(r, c) for the K unique keys cand[0..K) (any order), r the rank of c
// among them; by threads t, t + nt, ... of nt.
template <typename Place>
__device__ __forceinline__ void place_ranked(const unsigned long long* cand, int K, int t, int nt,
                                             Place&& place) {
  for (int i = t; i < K; i += nt) {  // keys are unique: the ranks are a permutation
    const unsigned long long c = cand[i];
    int r = 0;
    for (int j = 0; j < K; ++j) r += cand[j] < c;
    place(r, c);
  }
}

template <int kMaxK>
struct Shared {
  unsigned hist[kBins];
  unsigned long long cand[kMaxK];
  unsigned bin, below, count;  // the bin holding the K-th key, the keys before it, its size
  int n;                       // candidates gathered
};

// Every thread of the block calls this; 1 <= K <= min(n, kMaxK), pbits =
// position_bits(n) (or more). visit(f) calls f(c) once for each of the
// row's n composite keys, spread over the block's threads in any way, and
// may read what the caller wrote before the call: the first pass's barrier
// makes it visible. place(r, c) gets the r-th smallest key, once for each
// r < K, on some thread. No barrier follows the placing.
template <int kMaxK, typename Visit, typename Place>
__device__ void block_select(Visit&& visit, int n, int K, int pbits, Shared<kMaxK>& sh,
                             Place&& place) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) sh.n = 0;

  // The K selected keys are those whose bits above `shift` are <= prefix;
  // krem is the rank of the K-th key among those whose bits equal prefix.
  unsigned long long prefix = 0;
  int shift = 32 + pbits;
  int krem = K;
  bool done = K >= n;
  while (!done && shift > 0) {
    for (int i = tid; i < kBins; i += nt) sh.hist[i] = 0;
    __syncthreads();  // the bins are clear (and what visit reads is written)
    visit([&](unsigned long long c) {
      if ((c >> shift) == prefix) atomicAdd(&sh.hist[(unsigned)(c >> (shift - 8)) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid < 32) {
      unsigned bin, before, count;
      if (find_bin(sh.hist, krem, tid, bin, before, count)) {
        sh.bin = bin;
        sh.below = before;
        sh.count = count;
      }
    }
    __syncthreads();
    krem -= (int)sh.below;
    prefix = (prefix << 8) | sh.bin;
    shift -= 8;
    done = (int)sh.count == krem;
  }
  __syncthreads();  // sh.n is reset (and what visit reads is written, when no pass ran)
  visit([&](unsigned long long c) {
    if ((c >> shift) <= prefix) {
      const int slot = atomicAdd(&sh.n, 1);
      if (slot < kMaxK) sh.cand[slot] = c;
    }
  });
  __syncthreads();
  place_ranked(sh.cand, K, tid, nt, place);
}

// block_select on a row whose n order keys are in keys[] (shared memory):
// winners[r] gets the position of the r-th smallest key (0 where it is a
// NaN's); visible to the block on return.
template <int kMaxK>
__device__ void select_sorted(const unsigned* __restrict__ keys, int n, int K, int pbits,
                              Shared<kMaxK>& sh, int* __restrict__ winners) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  block_select<kMaxK>(
      [&](auto&& f) {
        for (int m = tid; m < n; m += nt) f(composite(keys[m], m, pbits));
      },
      n, K, pbits, sh,
      [&](int r, unsigned long long c) { winners[r] = position_or_zero(c, pbits, kNanKey); });
  __syncthreads();
}

// One warp's select, with no block barrier, for rows of up to 32 * kPer
// entries held in registers: lane l holds the order keys of positions
// l, l + 32, ... in key[] (positions at or past n are absent). hist (256
// bins), cand (kMaxK) and winners (kMaxK) are the warp's own shared memory.
// The same digit passes as block_select, each a warp histogram; the K keys
// at or below the prefix are gathered in position order by ballots and put
// at their ranks (0 for a NaN's). winners[] is visible to the warp on
// return.
template <int kPer, int kMaxK>
__device__ void warp_select_sorted(const unsigned (&key)[kPer], int n, int K, int pbits,
                                   unsigned* __restrict__ hist,
                                   unsigned long long* __restrict__ cand,
                                   int* __restrict__ winners) {
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0;
  int shift = 32 + pbits;
  int krem = K;
  bool done = K >= n;
  while (!done && shift > 0) {
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) hist[lane + 32 * i] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned long long c = composite(key[j], lane + 32 * j, pbits);
      if (lane + 32 * j < n && (c >> shift) == prefix)
        atomicAdd(&hist[(unsigned)(c >> (shift - 8)) & 0xffu], 1u);
    }
    __syncwarp();
    unsigned bin = 0, before = 0, count = 0;
    const int src = __ffs(__ballot_sync(kFull, find_bin(hist, krem, lane, bin, before, count))) - 1;
    bin = __shfl_sync(kFull, bin, src);
    count = __shfl_sync(kFull, count, src);
    before = __shfl_sync(kFull, before, src);
    __syncwarp();  // every lane has read the bins before the next pass clears them
    krem -= (int)before;
    prefix = (prefix << 8) | bin;
    shift -= 8;
    done = (int)count == krem;
  }
  const unsigned lt = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned long long c = composite(key[j], lane + 32 * j, pbits);
    const bool take = lane + 32 * j < n && (c >> shift) <= prefix;
    const unsigned vote = __ballot_sync(kFull, take);
    if (take) cand[base + __popc(vote & lt)] = c;
    base += __popc(vote);
  }
  __syncwarp();
  place_ranked(cand, K, lane, 32, [&](int r, unsigned long long c) {
    winners[r] = position_or_zero(c, pbits, kNanKey);
  });
  __syncwarp();
}

}  // namespace pcot_select
