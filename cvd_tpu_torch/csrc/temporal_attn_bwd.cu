// Per-pixel temporal attention, backward (kernel K7 of the port).
//
// Replaces cvd_tpu/ops/temporal_attn.py:_bwd_kernel (the Pallas TPU kernel
// behind the custom_vjp of temporal_flash_attention).
//
// What it computes: for every (batch row b, pixel n, head h), with
// logits[f, g] = q_f . k_g / sqrt(D) (+ mask[f, g]) and P = softmax_g:
//   dP = dO v^T,  delta_f = sum_g dP[f, g] P[f, g],  dS = P (dP - delta) / sqrt(D)
//   dq = dS k,  dk = dS^T q,  dv = P^T dO
// in f32, written in the input type. Pixels are independent, so there is
// no saved statistic and no accumulation across blocks: one pass.
//
// What bounds it on the H100: memory, as the forward. Per (pixel, head) it
// does ~10*F*G*D flops on 4 reads and 3 writes of [F, D] slices, ~6 flops per
// byte in bf16, far below the ~295 where the tensor cores would limit. So
// it reads q/k/v/dO once and writes dq/dk/dv once, through strides, with
// 16-byte loads from the pixel-major [B, N, F, C] layout, and keeps the
// logits and probabilities in shared memory.
//
// Design: the forward's layout. One block per (batch row, pixel); each warp
// takes heads h = warp, warp + warps, ...: it stages its head's q, k, v, dO
// slices in shared memory as f32, recomputes P (one row per lane), then
// dP, delta and dS, and the three products. Up to 4 warps per block, fewer
// when F, G and D make a warp's tiles large (F, G <= 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_WARPS = 4;
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// rows x D slab (row stride rs) -> f32 shared tile with leading dim LD
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int rows,
                                          int D, int LD, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = D / VEC;
  for (int idx = lane; idx < rows * chunks; idx += 32) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (long long)r * rs + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[r * LD + c + j] = to_f(e[j]);
  }
}

// f32 words of shared memory one warp uses
__host__ __device__ __forceinline__ int warp_words(int F, int G, int D) {
  return (2 * F + 2 * G) * (D + 1) + 2 * F * (G + 1);
}

struct Strides {
  long long bs, ns, fs;
};

template <typename T>
__global__ void temporal_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         Strides sq, Strides sk, Strides sv, Strides so,
                                         const float* __restrict__ mask, T* __restrict__ dq,
                                         T* __restrict__ dk, T* __restrict__ dv, Strides sdq,
                                         Strides sdk, int N, int F, int G, int H, int D,
                                         float scale) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / N;
  const int n = blockIdx.x % N;
  const int LD = D + 1;  // odd: the dot-product loops read without bank conflicts
  const int LP = G + 1;
  float* qs = smem + warp * warp_words(F, G, D);
  float* ks = qs + F * LD;
  float* vs = ks + G * LD;
  float* os = vs + G * LD;  // dO
  float* ps = os + F * LD;  // P [F][G]
  float* ds = ps + F * LP;  // dP, then dS [F][G]

  const T* qb = q + b * sq.bs + n * sq.ns;
  const T* kb = k + b * sk.bs + n * sk.ns;
  const T* vb = v + b * sv.bs + n * sv.ns;
  const T* ob = dout + b * so.bs + n * so.ns;
  T* dqb = dq + b * sdq.bs + n * sdq.ns;
  T* dkb = dk + b * sdk.bs + n * sdk.ns;
  T* dvb = dv + b * sdk.bs + n * sdk.ns;
  for (int h = warp; h < H; h += warps) {
    const long long col = (long long)h * D;
    load_rows<T>(qs, qb + col, sq.fs, F, D, LD, lane);
    load_rows<T>(ks, kb + col, sk.fs, G, D, LD, lane);
    load_rows<T>(vs, vb + col, sv.fs, G, D, LD, lane);
    load_rows<T>(os, ob + col, so.fs, F, D, LD, lane);
    __syncwarp();
    for (int idx = lane; idx < F * G; idx += 32) {
      const int f = idx / G, g = idx % G;
      float acc = 0.f, dacc = 0.f;
      for (int d = 0; d < D; ++d) {
        acc = fmaf(qs[f * LD + d], ks[g * LD + d], acc);
        dacc = fmaf(os[f * LD + d], vs[g * LD + d], dacc);
      }
      ps[f * LP + g] = acc * scale + (mask != nullptr ? mask[f * G + g] : 0.f);
      ds[f * LP + g] = dacc;
    }
    __syncwarp();
    for (int f = lane; f < F; f += 32) {
      float* prow = ps + f * LP;
      float* drow = ds + f * LP;
      float m = -CUDART_INF_F;
      for (int g = 0; g < G; ++g) m = fmaxf(m, prow[g]);
      float sum = 0.f;
      for (int g = 0; g < G; ++g) {
        prow[g] = expf(prow[g] - m);
        sum += prow[g];
      }
      const float inv = 1.f / sum;
      float delta = 0.f;
      for (int g = 0; g < G; ++g) {
        prow[g] *= inv;
        delta = fmaf(drow[g], prow[g], delta);
      }
      for (int g = 0; g < G; ++g) drow[g] = prow[g] * (drow[g] - delta) * scale;
    }
    __syncwarp();
    for (int idx = lane; idx < F * D; idx += 32) {  // dq = dS k
      const int f = idx / D, d = idx % D;
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc = fmaf(ds[f * LP + g], ks[g * LD + d], acc);
      dqb[(long long)f * sdq.fs + col + d] = from_f<T>(acc);
    }
    for (int idx = lane; idx < G * D; idx += 32) {  // dk = dS^T q, dv = P^T dO
      const int g = idx / D, d = idx % D;
      float acck = 0.f, accv = 0.f;
      for (int f = 0; f < F; ++f) {
        acck = fmaf(ds[f * LP + g], qs[f * LD + d], acck);
        accv = fmaf(ps[f * LP + g], os[f * LD + d], accv);
      }
      dkb[(long long)g * sdk.fs + col + d] = from_f<T>(acck);
      dvb[(long long)g * sdk.fs + col + d] = from_f<T>(accv);
    }
    __syncwarp();  // the next head overwrites this warp's tiles
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, Strides sq,
                   Strides sk, Strides sv, Strides so, const void* mask, void* dq, void* dk,
                   void* dv, Strides sdq, Strides sdk, int B, int N, int F, int G, int H, int D,
                   float scale, cudaStream_t stream) {
  const int per_warp = warp_words(F, G, D) * (int)sizeof(float);
  int warps = MAX_SMEM / per_warp;
  if (warps < 1) return cudaErrorInvalidValue;
  warps = warps < MAX_WARPS ? warps : MAX_WARPS;
  warps = warps < H ? warps : H;
  const int bytes = warps * per_warp;
  auto kernel = temporal_attn_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * N, warps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), sq, sk, sv, so, static_cast<const float*>(mask),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sdq, sdk, N, F, G, H, D,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask is an [F, G] f32 additive mask or
// null. Strides (batch, pixel, frame) in elements; channels are contiguous.
// dq is shaped like q, dk/dv like k (one set of strides for both).
extern "C" int temporal_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, long long q_bs, long long q_ns,
                                 long long q_fs, long long k_bs, long long k_ns, long long k_fs,
                                 long long v_bs, long long v_ns, long long v_fs,
                                 long long o_bs, long long o_ns, long long o_fs,
                                 const void* mask, void* dq, void* dk, void* dv,
                                 long long dq_bs, long long dq_ns, long long dq_fs,
                                 long long dk_bs, long long dk_ns, long long dk_fs, int B,
                                 int N, int F, int G, int H, int D, float scale, void* stream) {
  const Strides sq{q_bs, q_ns, q_fs}, sk{k_bs, k_ns, k_fs}, sv{v_bs, v_ns, v_fs},
      so{o_bs, o_ns, o_fs}, sdq{dq_bs, dq_ns, dq_fs}, sdk{dk_bs, dk_ns, dk_fs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, dout, sq, sk, sv, so, mask, dq, dk, dv, sdq, sdk, B, N, F, G,
                        H, D, scale, s);
  else if (dtype == 1)
    err = launch<bf16>(q, k, v, dout, sq, sk, sv, so, mask, dq, dk, dv, sdq, sdk, B, N, F, G,
                       H, D, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
