// Per-pixel temporal attention, forward (kernel K3 of the port).
//
// Replaces cvd_tpu/ops/temporal_attn.py:_fwd_kernel (the Pallas TPU kernel
// behind temporal_flash_attention).
//
// What it computes: for every (batch row b, pixel n, head h), attention over
// the frame axis: logits[f, g] = q[b,n,f,hD:hD+D] . k[b,n,g,hD:hD+D] / sqrt(D)
// (+ mask[f, g]), softmax over g in f32, out[b,n,f] = P V, with P rounded to
// the input type before P V as the TPU kernel does. F = G = 16 on the main
// path.
//
// What bounds it on the H100: memory. Per (pixel, head) it does ~4*F*G*D
// flops on 3*F*D + F*D values, about 8 flops per byte in bf16, far below
// the ~295 flops per byte where the tensor cores would be the limit. So a
// design does one round trip of q/k/v/out through device memory, in place in
// the pixel-major [B, N, F, C] layout (no transposes, no materialized
// logits), and must keep the work per byte small enough not to get in the
// way.
//
// Two kernels, chosen by the wrapper from (F, G, head_dim, type):
//
// temporal_attn_fwd_mma (bf16, F and G up to 16; the main path). The unit of
// work is one (pixel, group of heads whose channels are at most 640 bytes of
// a row); a block has one warp per head of the group and walks units
// blockIdx.x, + gridDim.x, ... with the next unit's rows in flight while it
// works on this one (two stages of cp.async, 16 bytes a thread, whole rows by
// all threads, so every sector that is read is used; the strided views of a
// fused q/k/v projection cost nothing extra). Rows stay bf16 in shared
// memory at a pitch of an odd count of 16-byte pieces (ldmatrix without bank
// conflicts). A warp computes S = Q K^T with mma.sync.m16n8k16 (F = 16 is
// its M; a head_dim that is 8 mod 16 ends with one m16n8k8), scales and
// masks on the fragment, takes the row maximum and sum with two shuffles
// across the four lanes of a row, packs P from the accumulators straight into
// the A fragment of P V (V through ldmatrix.trans), and writes the bf16
// result into its own, now dead, q columns of the tile, from where the block
// stores whole rows, 16 bytes a thread. Logits, probabilities and f32 copies
// of the inputs never touch shared memory. Frames beyond a ragged F or G are
// zero-filled rows, their keys masked out, their query rows not stored.
//
// temporal_attn_fwd (f32, and what the other does not take: F or G of 17 to
// 32, other head_dims). One block per (batch row, pixel) with 4 warps; each
// warp takes heads h = warp, warp+4, ...: it stages its head's q/k/v [F, D]
// slices in shared memory as f32, computes the F x G logits with full-f32
// FMAs, the softmax (one row per lane) and P V, and writes its output
// slice. It is bound by shared-memory loads (two per multiply-add), which is
// why the bf16 main path has the kernel above; it stays because comparing
// the card with the CPU needs full-f32 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "temporal_mma.cuh"

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


// ---- the bf16 tensor-core kernel ----

struct MmaParams {
  temporal::Slab q, k, v;
  bf16* out;
  long long o_bs, o_ns, o_fs;
  const float* mask;
  int N, NG, units;  // pixels a batch row, head groups a pixel, B * N * NG
  float scale_log2;  // log2(e) / sqrt(D)
};

template <int ND>
__global__ void __launch_bounds__(temporal::MAX_WARPS * 32, 3)
    temporal_attn_fwd_mma_kernel(const MmaParams p) {
  using namespace temporal;
  constexpr int D = ND * 8;
  extern __shared__ __align__(16) unsigned char tiles[];
  const Tile t(D * 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group_cols = (blockDim.x >> 5) * D;
  const int slab = ROWS * t.pitch;  // bytes of one tensor's rows; a stage is q, k, v
  const unsigned tiles_addr = static_cast<unsigned>(__cvta_generic_to_shared(tiles));
  const Lanes l(lane, t.pitch, warp * D * 2, D);
  const int F = p.q.rows, G = p.k.rows;
  float mk[2][4];
  load_mask(mk, p.mask, F, G, lane);

  auto load = [&](int u, int stage) {
    const Unit w(u, p.N, p.NG);
    const unsigned dst = tiles_addr + stage * 3 * slab;
    copy_in(dst, p.q.p + w.offset(p.q.bs, p.q.ns, group_cols), p.q.fs, F, t);
    copy_in(dst + slab, p.k.p + w.offset(p.k.bs, p.k.ns, group_cols), p.k.fs, G, t);
    copy_in(dst + 2 * slab, p.v.p + w.offset(p.v.bs, p.v.ns, group_cols), p.v.fs, G, t);
  };

  int u = blockIdx.x, stage = 0;
  if (u < p.units) load(u, 0);
  hopper::cp_async_commit();
  for (; u < p.units; u += gridDim.x, stage ^= 1) {
    if (u + (int)gridDim.x < p.units) load(u + gridDim.x, stage ^ 1);
    hopper::cp_async_commit();
    cp_async_wait_but_one();  // this unit's rows have landed; the next one's are in flight
    __syncthreads();
    const unsigned sq = tiles_addr + stage * 3 * slab;
    unsigned char* q_rows = tiles + stage * 3 * slab;

    float s[2][4] = {};
    product_xyt<ND>(s, sq, sq + slab, l);
    softmax_rows(s, mk, p.scale_log2);
    uint32_t pa[4];
    pack_a(pa, s);
    __syncwarp();  // every lane has read q: its columns now take the output
    product_ay<ND>(pa, sq + 2 * slab, q_rows, l, t.pitch);
    __syncthreads();
    const Unit w(u, p.N, p.NG);
    copy_out(p.out + w.offset(p.o_bs, p.o_ns, group_cols), p.o_fs, q_rows, F, t);
    __syncthreads();  // the stage is free for the unit after the next
  }
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

// The bf16 tensor-core kernel: F, G <= 16, D a head_dim of
// temporal::for_head_dim, HG (heads a block takes, one warp each) a divisor
// of H, at most 8.
extern "C" int temporal_attn_fwd_mma(const void* q, const void* k, const void* v, long long q_bs,
                                     long long q_ns, long long q_fs, long long k_bs,
                                     long long k_ns, long long k_fs, long long v_bs,
                                     long long v_ns, long long v_fs, const void* mask, void* out,
                                     long long o_bs, long long o_ns, long long o_fs, int B, int N,
                                     int F, int G, int H, int D, int HG, float scale,
                                     void* stream) {
  const long long units = temporal::unit_count(B, N, F, G, H, HG);
  if (units < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  MmaParams p;
  p.q = {static_cast<const bf16*>(q), q_bs, q_ns, q_fs, F};
  p.k = {static_cast<const bf16*>(k), k_bs, k_ns, k_fs, G};
  p.v = {static_cast<const bf16*>(v), v_bs, v_ns, v_fs, G};
  p.out = static_cast<bf16*>(out);
  p.o_bs = o_bs, p.o_ns = o_ns, p.o_fs = o_fs;
  p.mask = static_cast<const float*>(mask);
  p.N = N, p.NG = H / HG, p.units = static_cast<int>(units);
  p.scale_log2 = scale * hopper::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = temporal::for_head_dim(D, [&](auto nd) {
    constexpr int ND = decltype(nd)::value;
    static temporal::LaunchState state;  // one per instantiation
    return temporal::launch_units(temporal_attn_fwd_mma_kernel<ND>, p, p.units, HG, 3,
                                  HG * ND, state, s);
  });
  return static_cast<int>(err);
}
