// Recompute backward of the fused shared MLP + neighbour max-pool for
// Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel pointcloud_orientation_tpu/ops/pallas_kernels.py:
// _sa_mlp_max_bwd_impl / _sa_mlp_max_bwd_kernel (the VJP of
// sa_mlp_max_pallas), both its f32 (HIGHEST) variant and its bf16=True
// variant.
//
// Inputs: grouped (B,K,S,C0) neighbour-major, L <= 4 layers (W (Cin,Cout),
// scale, shift) with y = (x @ W) * scale + shift, a = relu(y), and the
// pooled cotangent dpooled (B,S,C_L). Outputs: dgrouped (B,K,S,C0), unless
// the caller passes NULL for it, and, per chunk of `chunk_rows` rows, the
// partial dW (P,Cin,Cout), dscale and dshift (P,Cout) of every layer, which
// the caller sums over the P chunks (as the JAX package sums its kernel's
// per-cloud partials outside the kernel).
//
// Semantics, as the TPU kernel: the forward is recomputed here, and the
// max-pool's cotangent is split evenly over the neighbours equal to the
// RECOMPUTED maximum (so a centroid always has at least one), then per layer
// from the last: dy = da * (y > 0); dscale = sum(dy * z) with z = x @ W;
// dshift = sum(dy); dz = dy * scale; dW = x^T dz; da_in = dz W^T.
//
// Bound on this card: operations, about 6 * rows * sum(Cin * Cout) f32
// (recompute, dW, da): 4.9 GFLOP at sa1 and 6.5 at sa2 for B=16, against
// tens of MB of traffic. The JAX side computes at HIGHEST f32, so this uses
// f32 FMAs on the CUDA cores (no TF32).
//
// Design (simple first): sa3's activations per cloud (32 rows x 1,792
// channels) do not fit one block's shared memory beside a W tile, and one
// block per cloud would use 16 of 132 SMs at B=16. So the recomputed
// activations live in a global scratch buffer that the wrapper allocates,
// and the work is a sequence of launches of a few kernels on the caller's
// stream: one tiled SGEMM (64x64 output tile per block, 16-deep shared
// stages, a 4x4 register tile per thread; strides given at launch so the
// same kernel computes x W, x^T dz per chunk of rows and dz W^T) with a forward
// epilogue that stores z and relu(z * s + t); a max/tie kernel; and a
// column-reduction kernel for dscale/dshift that also forms dz in place.
// The contractions over rows (dW, dscale, dshift) are split into chunks of
// rows, each chunk a partial of its own, so that they fill the card (per
// cloud, sa1 would give 16 blocks of 4,096-row loops); the caller sums the
// partials. The input gradient of the first layer is skipped when the
// caller does not need it (sa1: coordinates carry no parameters).
// No atomics: every sum runs in a fixed order, so results are bit-stable.
//
// bf16, as the TPU kernel's bf16 `mm`: in all three products (the
// recompute x W, dW = x^T dz and da = dz W^T) both operands are rounded to
// bf16 (round to nearest even) on their way into the shared stages and
// accumulated in f32; the rounded values are kept as f32 there, so the
// FMAs are the f32 kernel's. The forward epilogue, the max/tie split and
// the dscale/dshift column sums stay f32, as there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kMaxLayers = 4;

struct Gemm {  // C(m, n) = sum_k A(m, k) * B(k, n), batched over blockIdx.z
  const float* a;
  long sam, sak, sab;
  const float* b;
  long sbk, sbn, sbb;
  float* c;
  long scm, scb;  // C(m, n) at c[z * scb + m * scm + n]
  int M, N, K;
  long k_total;  // split-K: batch z contracts min(K, k_total - z * K) terms
};

enum { kStore = 0, kForward = 1 };

// The value an operand enters a product with: itself, or rounded to bf16.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// kForward: C = z, and c2 (same layout) = relu(z * s + t). kBf16: both
// operands rounded to bf16 as they are staged.
template <int MODE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const Gemm g, const float* __restrict__ s, const float* __restrict__ t,
            float* __restrict__ c2) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* A = g.a + (size_t)blockIdx.z * g.sab;
  const float* B = g.b + (size_t)blockIdx.z * g.sbb;
  const bool a_kfast = g.sak == 1;  // which index runs along memory: coalesce on it
  const bool b_nfast = g.sbn == 1;
  const int Kz = (int)min((long)g.K, g.k_total - (long)blockIdx.z * g.K);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kz; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * kThreads;
      int mm, kk;
      if (a_kfast) { mm = e / kBK; kk = e % kBK; } else { kk = e / kBM; mm = e % kBM; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] =
          (m < g.M && k < Kz) ? operand<kBf16>(A[(size_t)m * g.sam + (size_t)k * g.sak]) : 0.f;
      int nn;
      if (b_nfast) { kk = e / kBN; nn = e % kBN; } else { nn = e / kBK; kk = e % kBK; }
      const int n = n0 + nn, k2 = k0 + kk;
      Bs[kk][nn] =
          (n < g.N && k2 < Kz) ? operand<kBf16>(B[(size_t)k2 * g.sbk + (size_t)n * g.sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* C = g.c + (size_t)blockIdx.z * g.scb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      const size_t o = (size_t)m * g.scm + n;
      C[o] = acc[i][j];
      if (MODE == kForward) c2[o] = fmaxf(acc[i][j] * s[n] + t[n], 0.f);
    }
  }
}

// da[(b,k,s), c] = dpooled[b,s,c] / count if a[(b,k,s), c] equals the max
// over k of a[(b,:,s), c], else 0 (count: how many k reach the max).
__global__ void __launch_bounds__(kThreads)
max_ties_kernel(const float* __restrict__ a, const float* __restrict__ dpooled,
                float* __restrict__ da, int B, int K, int S, int C) {
  const size_t total = (size_t)B * S * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = (int)(e % C);
    const size_t bs = e / C;
    const int s = (int)(bs % S);
    const int b = (int)(bs / S);
    const size_t base = ((size_t)b * K * S + s) * C + c;  // row (b, 0, s)
    const size_t step = (size_t)S * C;                    // next neighbour
    float mx = a[base];
    for (int k = 1; k < K; ++k) mx = fmaxf(mx, a[base + k * step]);
    float cnt = 0.f;
    for (int k = 0; k < K; ++k) cnt += a[base + k * step] == mx ? 1.f : 0.f;
    const float share = dpooled[e] / cnt;
    for (int k = 0; k < K; ++k) da[base + k * step] = a[base + k * step] == mx ? share : 0.f;
  }
}

// Per chunk p of `chunk` rows (of `rows`) and channel c: dy = a > 0 ? da : 0;
// ds[p, c] = sum dy * z, dt[p, c] = sum dy; da is overwritten with dy * s.
// A block takes 32 channels of one chunk; its 8 warps stride over the rows
// and their partial sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(float* __restrict__ da, const float* __restrict__ a, const float* __restrict__ z,
              const float* __restrict__ s, float* __restrict__ ds, float* __restrict__ dt,
              long rows, int chunk, int C) {
  __shared__ float red_s[kThreads / 32][32];
  __shared__ float red_t[kThreads / 32][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const long r0 = (long)b * chunk;
  const int n_rows = (int)min((long)chunk, rows - r0);
  float acc_s = 0.f, acc_t = 0.f;
  if (c < C) {
    const float sc = s[c];
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      const size_t o = (size_t)(r0 + r) * C + c;
      const float dy = a[o] > 0.f ? da[o] : 0.f;
      acc_s = fmaf(dy, z[o], acc_s);
      acc_t += dy;
      da[o] = dy * sc;
    }
  }
  red_s[warp][lane] = acc_s;
  red_t[warp][lane] = acc_t;
  __syncthreads();
  if (warp == 0 && c < C) {
    float vs = 0.f, vt = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      vs += red_s[w][lane];
      vt += red_t[w][lane];
    }
    ds[(size_t)b * C + c] = vs;
    dt[(size_t)b * C + c] = vt;
  }
}

template <int MODE, bool kBf16>
cudaError_t launch_gemm(const Gemm& g, int batch, const float* s, const float* t, float* c2,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)((g.N + kBN - 1) / kBN), (unsigned)((g.M + kBM - 1) / kBM),
                  (unsigned)batch);
  if (grid.y > 65535u || batch > 65535) return cudaErrorInvalidValue;
  gemm_kernel<MODE, kBf16><<<grid, kThreads, 0, stream>>>(g, s, t, c2);
  return cudaGetLastError();
}

template <bool kBf16>
int run_bwd(const void* grouped, const void* dpooled, void* dgrouped, void* scratch,
            int scratch_floats, int chunk_rows, int B, int K, int S, int n_layers,
            const float* const* W, const float* const* Sc, const float* const* Sh,
            float* const* dW, float* const* dS, float* const* dT, const int* c, void* stream) {
  if (B < 1 || K < 1 || S < 1 || n_layers < 1 || n_layers > kMaxLayers || B > 65535)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    if (c[l] < 1 || c[l + 1] < 1) return (int)cudaErrorInvalidValue;
    if (!W[l] || !Sc[l] || !Sh[l] || !dW[l] || !dS[l] || !dT[l])
      return (int)cudaErrorInvalidValue;
  }
  if (!grouped || !dpooled || !scratch || chunk_rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)B * K * S;
  if (rows > 2147483647L) return (int)cudaErrorInvalidValue;
  const long chunks = (rows + chunk_rows - 1) / chunk_rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;

  // scratch layout: z_0, a_0, z_1, a_1, ..., then the two cotangent buffers
  float* z[kMaxLayers];
  float* act[kMaxLayers];
  float* p = (float*)scratch;
  long widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    z[l] = p;
    p += rows * c[l + 1];
    act[l] = p;
    p += rows * c[l + 1];
    widest = c[l + 1] > widest ? c[l + 1] : widest;
  }
  float* dbuf[2] = {p, p + rows * widest};
  if (dbuf[1] + rows * widest - (float*)scratch > (long)scratch_floats)
    return (int)cudaErrorInvalidValue;

  cudaError_t err;
  // 1. recompute the forward, keeping z and relu(y) of every layer
  for (int l = 0; l < n_layers; ++l) {
    const float* x = l == 0 ? (const float*)grouped : act[l - 1];
    Gemm g{x, c[l], 1, 0, W[l], c[l + 1], 1, 0, z[l], c[l + 1], 0,
           (int)rows, c[l + 1], c[l], c[l]};
    if ((err = launch_gemm<kForward, kBf16>(g, 1, Sc[l], Sh[l], act[l], st)) != cudaSuccess)
      return (int)err;
  }
  // 2. the max-pool's cotangent, ties split evenly
  {
    const int L = n_layers - 1;
    const long total = (long)B * S * c[n_layers];
    long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535L * 8) blocks = 65535L * 8;
    max_ties_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        act[L], (const float*)dpooled, dbuf[L & 1], B, K, S, c[n_layers]);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. layer by layer from the last
  for (int l = n_layers - 1; l >= 0; --l) {
    const int cin = c[l], cout = c[l + 1];
    float* dz = dbuf[l & 1];
    const dim3 grid_bn((unsigned)((cout + 31) / 32), (unsigned)chunks);
    bn_bwd_kernel<<<grid_bn, kThreads, 0, st>>>(dz, act[l], z[l], Sc[l], dS[l], dT[l], rows,
                                                chunk_rows, cout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const float* x = l == 0 ? (const float*)grouped : act[l - 1];
    // dW[p] = x[p]^T dz[p] over chunk p's rows (split-K): M = cin, N = cout
    Gemm gw{x, 1, cin, (long)chunk_rows * cin, dz, cout, 1, (long)chunk_rows * cout, dW[l],
            cout, (long)cin * cout, cin, cout, chunk_rows, rows};
    if ((err = launch_gemm<kStore, kBf16>(gw, (int)chunks, nullptr, nullptr, nullptr, st)) !=
        cudaSuccess)
      return (int)err;
    if (l == 0 && !dgrouped) break;  // the caller needs no input gradient
    // da_in = dz W^T: M = rows, N = cin, contraction over cout
    float* da_in = l == 0 ? (float*)dgrouped : dbuf[(l - 1) & 1];
    Gemm ga{dz, cout, 1, 0, W[l], 1, cout, 0, da_in, cin, 0, (int)rows, cin, cout, cout};
    if ((err = launch_gemm<kStore, kBf16>(ga, 1, nullptr, nullptr, nullptr, st)) != cudaSuccess)
      return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// grouped (B,K,S,c0), dpooled (B,S,c_L), dgrouped (B,K,S,c0) out or NULL; scratch
// of scratch_floats floats, at least rows * (2 * (c_1 + ... + c_L) + 2 *
// max(c_1..c_L)) with rows = B*K*S (z and relu(y) of every layer, and two
// cotangent buffers as wide as the widest layer output); layer l reads w_l
// (c_l, c_{l+1}) row-major, s_l, t_l (c_{l+1},) and writes dw_l
// (P, c_l, c_{l+1}), ds_l and dt_l (P, c_{l+1}), P = ceil(rows / chunk_rows)
// partial sums over consecutive row chunks; unused layers pass NULL and
// width 0. Returns cudaErrorInvalidValue for arguments the kernels do not
// take, else the first launch error.
// bf16 != 0 rounds both operands of every product to bf16 and accumulates
// in f32 (the TPU kernel's bf16=True); bf16 == 0 multiplies in f32.
extern "C" int pcot_sa_mlp_max_bwd_f32(
    const void* grouped, const void* dpooled, void* dgrouped, void* scratch, int scratch_floats,
    int chunk_rows, int B, int K, int S, int n_layers, const void* w0, const void* s0,
    const void* t0, const void* w1, const void* s1, const void* t1, const void* w2,
    const void* s2, const void* t2, const void* w3, const void* s3, const void* t3, void* dw0,
    void* ds0, void* dt0, void* dw1, void* ds1, void* dt1, void* dw2, void* ds2, void* dt2,
    void* dw3, void* ds3, void* dt3, int c0, int c1, int c2, int c3, int c4, int bf16,
    void* stream) {
  const float* W[kMaxLayers] = {(const float*)w0, (const float*)w1, (const float*)w2,
                                (const float*)w3};
  const float* Sc[kMaxLayers] = {(const float*)s0, (const float*)s1, (const float*)s2,
                                 (const float*)s3};
  const float* Sh[kMaxLayers] = {(const float*)t0, (const float*)t1, (const float*)t2,
                                 (const float*)t3};
  float* dW[kMaxLayers] = {(float*)dw0, (float*)dw1, (float*)dw2, (float*)dw3};
  float* dS[kMaxLayers] = {(float*)ds0, (float*)ds1, (float*)ds2, (float*)ds3};
  float* dT[kMaxLayers] = {(float*)dt0, (float*)dt1, (float*)dt2, (float*)dt3};
  const int c[kMaxLayers + 1] = {c0, c1, c2, c3, c4};
  auto run = bf16 ? run_bwd<true> : run_bwd<false>;
  return run(grouped, dpooled, dgrouped, scratch, scratch_floats, chunk_rows, B, K, S, n_layers,
             W, Sc, Sh, dW, dS, dT, c, stream);
}
