// Flash attention for Hopper (sm_90a): the forward, dK/dV and dQ kernels,
// f32 and bf16.
//
// Replaces the three Pallas TPU kernels behind the point transformer's
// attention_impl="flash" (pointcloud_orientation_tpu/models/
// point_transformer.py:24 _flash_attention_fn, which calls
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention):
//   forward  _flash_attention_impl            (flash_attention.py:589, pallas_call :758)
//   dK/dV    _flash_attention_bwd_dkv         (:941, pallas_call :1121, body :796)
//   dQ       _flash_attention_bwd_dq          (:1287, pallas_call :1456, body :1146)
// No mask, no bias, not causal; q, k, v (B, H, N, D) contiguous, N a
// multiple of 128.
//
// Arithmetic, as the library's: s = (q . k in f32) * sm_scale, the scale
// after the product. The forward keeps the library's online softmax over
// tiles of 128 keys: per tile m_next = max(m, max_j s_j), p_j = exp(s_j -
// m_next), l_next = sum_j p_j + exp(m - m_next) * l, and the accumulator
// kept normalised, acc = acc * (l_corr / l_next) + (sum_j p_j v_j) / l_next,
// with p rounded to v's type before p.v; it writes o (q's type) and the row
// statistics l and m (f32). The backward recomputes p = exp(s - m) * (1/l);
// dv += p.dO (p rounded to dO's type), dp = dO . v, ds = (dp - di) * p *
// sm_scale, dk += ds.q and dq += ds.k (ds rounded to the operands' type),
// with di = sum(o * dO) computed outside (ops/flash_attention.py), as the
// library computes it outside its kernels. bf16: bf16 operands widened to
// f32 (exact products), f32 sums, p and ds rounded to bf16 as the library
// rounds them. The plain PyTorch versions (ops/flash_attention.py) follow
// the same steps; the kernels differ from them only in the order of the
// f32 sums (and FMA contraction), so they are held by a tolerance.
//
// Bound on this card: at B=16, H=4, N=1,024, D=16 a forward is 6.7e7
// (query, key) pairs, each 2D multiply-adds for s and D for p.v and one
// exponential: ~6.4e9 f32 operations and 6.7e7 exponentials (at the SFU
// rate, 16 a clock an SM), ~0.1 ms at the f32 peak; the bytes are a few MB.
// The backward kernels are ~4D and ~3D multiply-adds a pair. So all three
// are bound by operations, not bytes, and a tensor-core design (wgmma) is
// the later step.
//
// Design (simple first): one thread per row (a query row in the forward and
// dQ kernels, a key row in dK/dV), a block of 128 rows per (batch, head,
// tile), so a block is one of the library's 128-row tiles. The row's
// operands (q, or k and v) and its accumulators (D floats each) live in
// registers; the other side's rows are staged 128 at a time in shared
// memory as f32 and read by every thread at the same address (a broadcast,
// no bank conflicts), 16 bytes a load. The forward reads each tile twice,
// once for the tile's row maximum and once for p, recomputing q . k rather
// than holding 128 scores a thread. No atomics: each output row is summed
// by one thread in a fixed order, so every run gives the same bits.
// Head dimensions 8, 16 and 32; the staged tiles take 2 * 128 * D * 4
// bytes, 32 KB at D=32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;  // rows a block owns = rows a staged tile holds

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as T holds it (f32: itself; bf16: rounded to nearest even)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return widen(narrow<T>(x)); }

template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = b4[i];
    s = fmaf(a[4 * i], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return s;
}

// acc += c * b
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float c, const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = b4[i];
    acc[4 * i] = fmaf(c, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(c, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(c, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(c, x.w, acc[4 * i + 3]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_row(float (&r)[D], const T* __restrict__ src) {
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = widen(src[d]);
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&r)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = narrow<T>(r[d]);
}

// rows [row0, row0 + kTile) of a (N, D) matrix into shared memory as f32
template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src) {
  for (int e = threadIdx.x; e < kTile * D; e += kTile) dst[e] = widen(src[e]);
}

// grid (N / kTile, H, B); thread = query row
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int N,
                 float scale) {
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const int row = blockIdx.x * kTile + threadIdx.x;
  float qr[D], acc[D];
  load_row<T, D>(qr, q + base + (size_t)row * D);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int t = 0; t < N; t += kTile) {
    __syncthreads();
    stage<T, D>(sk, k + base + (size_t)t * D);
    stage<T, D>(sv, v + base + (size_t)t * D);
    __syncthreads();
    float m_cur = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) m_cur = fmaxf(m_cur, dot_row<D>(qr, sk + j * D) * scale);
    const float m_next = fmaxf(m, m_cur);
    float psum = 0.f, pv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) pv[d] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(dot_row<D>(qr, sk + j * D) * scale - m_next);
      psum += p;
      axpy_row<D>(pv, round_to<T>(p), sv + j * D);
    }
    const float l_corr = expf(m - m_next) * l;
    const float l_next = psum + l_corr;
    const float inv = l_next == 0.f ? 1.f : 1.f / l_next;
    const float keep = l_corr * inv;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] * keep + pv[d] * inv;
    m = m_next;
    l = l_next;
  }
  store_row<T, D>(o + base + (size_t)row * D, acc);
  l_out[bh * N + row] = l;
  m_out[bh * N + row] = m;
}

// grid (N / kTile, H, B); thread = key row; loops over the query tiles
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ l, const float* __restrict__ m,
                     const T* __restrict__ dout, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int N, float scale) {
  __shared__ __align__(16) float sq[kTile * D];
  __shared__ __align__(16) float sdo[kTile * D];
  __shared__ float s_inv_l[kTile], s_m[kTile], s_di[kTile];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const int row = blockIdx.x * kTile + threadIdx.x;
  float kr[D], vr[D], dkr[D], dvr[D];
  load_row<T, D>(kr, k + base + (size_t)row * D);
  load_row<T, D>(vr, v + base + (size_t)row * D);
#pragma unroll
  for (int d = 0; d < D; ++d) dkr[d] = dvr[d] = 0.f;
  for (int t = 0; t < N; t += kTile) {
    __syncthreads();
    stage<T, D>(sq, q + base + (size_t)t * D);
    stage<T, D>(sdo, dout + base + (size_t)t * D);
    const size_t r = bh * N + t + threadIdx.x;
    s_inv_l[threadIdx.x] = 1.f / l[r];
    s_m[threadIdx.x] = m[r];
    s_di[threadIdx.x] = di[r];
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float p = expf(dot_row<D>(kr, sq + i * D) * scale - s_m[i]) * s_inv_l[i];
      const float dp = dot_row<D>(vr, sdo + i * D);
      const float ds = (dp - s_di[i]) * p * scale;
      axpy_row<D>(dvr, round_to<T>(p), sdo + i * D);
      axpy_row<D>(dkr, round_to<T>(ds), sq + i * D);
    }
  }
  store_row<T, D>(dk + base + (size_t)row * D, dkr);
  store_row<T, D>(dv + base + (size_t)row * D, dvr);
}

// grid (N / kTile, H, B); thread = query row; loops over the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ l, const float* __restrict__ m,
                    const T* __restrict__ dout, const float* __restrict__ di,
                    T* __restrict__ dq, int N, float scale) {
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * N * D;
  const int row = blockIdx.x * kTile + threadIdx.x;
  float qr[D], dor[D], dqr[D];
  load_row<T, D>(qr, q + base + (size_t)row * D);
  load_row<T, D>(dor, dout + base + (size_t)row * D);
#pragma unroll
  for (int d = 0; d < D; ++d) dqr[d] = 0.f;
  const float mi = m[bh * N + row];
  const float inv_l = 1.f / l[bh * N + row];
  const float dii = di[bh * N + row];
  for (int t = 0; t < N; t += kTile) {
    __syncthreads();
    stage<T, D>(sk, k + base + (size_t)t * D);
    stage<T, D>(sv, v + base + (size_t)t * D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(dot_row<D>(qr, sk + j * D) * scale - mi) * inv_l;
      const float dp = dot_row<D>(dor, sv + j * D);
      const float ds = (dp - dii) * p * scale;
      axpy_row<D>(dqr, round_to<T>(ds), sk + j * D);
    }
  }
  store_row<T, D>(dq + base + (size_t)row * D, dqr);
}

bool takes(int B, int H, int N, int D) {
  return B >= 1 && H >= 1 && B <= 65535 && H <= 65535 && N >= kTile && N % kTile == 0 &&
         (D == 8 || D == 16 || D == 32);
}

// LAUNCH(T, D) for the (type, head dimension) pair of the arguments
#define PCOT_FLASH_DISPATCH(D, BF16, LAUNCH)                   \
  do {                                                         \
    if (BF16) {                                                \
      if ((D) == 8) { LAUNCH(__nv_bfloat16, 8); }              \
      else if ((D) == 16) { LAUNCH(__nv_bfloat16, 16); }       \
      else { LAUNCH(__nv_bfloat16, 32); }                      \
    } else {                                                   \
      if ((D) == 8) { LAUNCH(float, 8); }                      \
      else if ((D) == 16) { LAUNCH(float, 16); }               \
      else { LAUNCH(float, 32); }                              \
    }                                                          \
  } while (0)

}  // namespace

// q, k, v (B,H,N,D) f32 or bf16 (bf16 != 0) -> o (B,H,N,D) of the same type,
// l, m (B,H,N) f32. Returns cudaErrorInvalidValue for arguments the kernels
// do not take (N not a positive multiple of 128, D not 8, 16 or 32), else
// cudaGetLastError() after the launch.
extern "C" int pcot_flash_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                              void* m, int B, int H, int N, int D, int bf16, float scale,
                              void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kTile, H, B);
#define PCOT_FLASH_FWD(T, DD)                                                      \
  flash_fwd_kernel<T, DD><<<grid, kTile, 0, (cudaStream_t)stream>>>(                \
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)l, (float*)m, N, scale)
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_FWD);
#undef PCOT_FLASH_FWD
  return (int)cudaGetLastError();
}

// the same q, k, v, the forward's l, m, dout (B,H,N,D) and di = sum(o * dout)
// (B,H,N) f32 -> dk, dv (B,H,N,D) of q's type
extern "C" int pcot_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* l,
                                  const void* m, const void* dout, const void* di, void* dk,
                                  void* dv, int B, int H, int N, int D, int bf16, float scale,
                                  void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kTile, H, B);
#define PCOT_FLASH_DKV(T, DD)                                                      \
  flash_bwd_dkv_kernel<T, DD><<<grid, kTile, 0, (cudaStream_t)stream>>>(            \
      (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,      \
      (const T*)dout, (const float*)di, (T*)dk, (T*)dv, N, scale)
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_DKV);
#undef PCOT_FLASH_DKV
  return (int)cudaGetLastError();
}

// the same inputs -> dq (B,H,N,D) of q's type
extern "C" int pcot_flash_bwd_dq(const void* q, const void* k, const void* v, const void* l,
                                 const void* m, const void* dout, const void* di, void* dq,
                                 int B, int H, int N, int D, int bf16, float scale,
                                 void* stream) {
  if (!takes(B, H, N, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kTile, H, B);
#define PCOT_FLASH_DQ(T, DD)                                                       \
  flash_bwd_dq_kernel<T, DD><<<grid, kTile, 0, (cudaStream_t)stream>>>(             \
      (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,      \
      (const T*)dout, (const float*)di, (T*)dq, N, scale)
  PCOT_FLASH_DISPATCH(D, bf16, PCOT_FLASH_DQ);
#undef PCOT_FLASH_DQ
  return (int)cudaGetLastError();
}
