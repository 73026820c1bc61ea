// Per-pixel temporal attention, forward (kernel K3 of the port).
//
// Replaces cvd_tpu/ops/temporal_attn.py:_fwd_kernel (the Pallas TPU kernel
// behind temporal_flash_attention).
//
// What it computes: for every (batch row b, pixel n, head h), attention over
// the frame axis: logits[f, g] = q[b,n,f,hD:hD+D] . k[b,n,g,hD:hD+D] / sqrt(D)
// (+ mask[f, g]), softmax over g in f32, out[b,n,f] = P V. F = G = 16 on the
// main path.
//
// What bounds it on the H100: memory. Per (pixel, head) it does ~4*F*G*D
// flops on 3*F*D + F*D values, about 8 flops per byte in bf16, far below
// the ~295 flops per byte where the tensor cores would be the limit. So the
// design does one round trip of q/k/v/out through device memory and nothing
// more: no transposes (the pixel-major [B, N, F, C] layout is read in place
// through strides), no materialized logits, 16-byte vector loads.
//
// Design: one block per (batch row, pixel) with 4 warps; each warp takes
// heads h = warp, warp+4, ...: it stages its head's q/k/v [F, D] slices in
// shared memory as f32, computes the F x G logits, the softmax (one row
// per lane) and P V, and writes its output slice. P is rounded to the
// input type before P V, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

namespace {

constexpr int WARPS = 4;

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) temporal_attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    long long q_bs, long long q_ns, long long q_fs, long long k_bs, long long k_ns,
    long long k_fs, long long v_bs, long long v_ns, long long v_fs,
    const float* __restrict__ mask, T* __restrict__ out, long long o_bs, long long o_ns,
    long long o_fs, int N, int F, int G, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / N;
  const int n = blockIdx.x % N;
  const int LD = D + 1;  // odd: the q.k and P.V loops read without bank conflicts
  const int per_warp = (F + 2 * G) * LD + F * (G + 1);
  float* qs = smem + warp * per_warp;
  float* ks = qs + F * LD;
  float* vs = ks + G * LD;
  float* ps = vs + G * LD;

  const T* qb = q + b * q_bs + n * q_ns;
  const T* kb = k + b * k_bs + n * k_ns;
  const T* vb = v + b * v_bs + n * v_ns;
  T* ob = out + b * o_bs + n * o_ns;
  for (int h = warp; h < H; h += WARPS) {
    load_rows<T>(qs, qb + (long long)h * D, q_fs, F, D, LD, lane);
    load_rows<T>(ks, kb + (long long)h * D, k_fs, G, D, LD, lane);
    load_rows<T>(vs, vb + (long long)h * D, v_fs, G, D, LD, lane);
    __syncwarp();
    for (int idx = lane; idx < F * G; idx += 32) {
      const int f = idx / G, g = idx % G;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qs[f * LD + d], ks[g * LD + d], acc);
      ps[f * (G + 1) + g] = acc * scale + (mask != nullptr ? mask[f * G + g] : 0.f);
    }
    __syncwarp();
    for (int f = lane; f < F; f += 32) {
      float* row = ps + f * (G + 1);
      float m = -CUDART_INF_F;
      for (int g = 0; g < G; ++g) m = fmaxf(m, row[g]);
      float sum = 0.f;
      for (int g = 0; g < G; ++g) {
        row[g] = expf(row[g] - m);
        sum += row[g];
      }
      const float inv = 1.f / sum;
      for (int g = 0; g < G; ++g) row[g] = to_f(from_f<T>(row[g] * inv));
    }
    __syncwarp();
    for (int idx = lane; idx < F * D; idx += 32) {
      const int f = idx / D, d = idx % D;
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc = fmaf(ps[f * (G + 1) + g], vs[g * LD + d], acc);
      ob[(long long)f * o_fs + (long long)h * D + d] = from_f<T>(acc);
    }
    __syncwarp();  // the next head overwrites this warp's tiles
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_bs, long long q_ns,
                   long long q_fs, long long k_bs, long long k_ns, long long k_fs,
                   long long v_bs, long long v_ns, long long v_fs, const void* mask, void* out,
                   long long o_bs, long long o_ns, long long o_fs, int B, int N, int F, int G,
                   int H, int D, float scale, cudaStream_t stream) {
  const int LD = D + 1;
  const int bytes = WARPS * ((F + 2 * G) * LD + F * (G + 1)) * (int)sizeof(float);
  auto kernel = temporal_attn_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * N, WARPS * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_bs, q_ns,
      q_fs, k_bs, k_ns, k_fs, v_bs, v_ns, v_fs, static_cast<const float*>(mask),
      static_cast<T*>(out), o_bs, o_ns, o_fs, N, F, G, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask is an [F, G] f32 additive mask or
// null. Strides in elements; channels are contiguous.
extern "C" int temporal_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                 long long q_bs, long long q_ns, long long q_fs,
                                 long long k_bs, long long k_ns, long long k_fs,
                                 long long v_bs, long long v_ns, long long v_fs,
                                 const void* mask, void* out, long long o_bs, long long o_ns,
                                 long long o_fs, int B, int N, int F, int G, int H, int D,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, q_bs, q_ns, q_fs, k_bs, k_ns, k_fs, v_bs, v_ns, v_fs, mask,
                        out, o_bs, o_ns, o_fs, B, N, F, G, H, D, scale, s);
  else if (dtype == 1)
    err = launch<bf16>(q, k, v, q_bs, q_ns, q_fs, k_bs, k_ns, k_fs, v_bs, v_ns, v_fs, mask,
                       out, o_bs, o_ns, o_fs, B, N, F, G, H, D, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
