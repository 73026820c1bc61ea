// Per-pixel temporal attention, backward (kernel K7 of the port).
//
// Replaces cvd_tpu/ops/temporal_attn.py:_bwd_kernel (the Pallas TPU kernel
// behind the custom_vjp of temporal_flash_attention).
//
// What it computes: for every (batch row b, pixel n, head h), with
// logits[f, g] = q_f . k_g / sqrt(D) (+ mask[f, g]) and P = softmax_g:
//   dP = dO v^T,  delta_f = sum_g dP[f, g] P[f, g],  dS = P (dP - delta) / sqrt(D)
//   dq = dS k,  dk = dS^T q,  dv = P^T dO
// written in the input type. Pixels are independent, so there is no saved
// statistic and no accumulation across blocks: one pass.
//
// What bounds it on the H100: memory, as the forward. Per (pixel, head) it
// does ~10*F*G*D flops on 4 reads and 3 writes of [F, D] slices, ~6 flops per
// byte in bf16, far below the ~295 where the tensor cores would limit. So
// it reads q/k/v/dO once and writes dq/dk/dv once, in place in the
// pixel-major [B, N, F, C] layout, and must keep the work per byte small.
//
// Two kernels, chosen by the wrapper from (F, G, head_dim, type):
//
// temporal_attn_bwd_mma (bf16, F and G up to 16; the main path). The
// forward's structure (temporal_attn_fwd.cu): a block of one warp per head
// walks units of one (pixel, group of heads), the rows of q, k, v and dO
// copied whole into shared memory as bf16 by two stages of 16-byte cp.async.
// A warp computes S = Q K^T and dP = dO V^T with mma.sync.m16n8k16, then P,
// delta (two shuffles across the four lanes of a row) and dS in f32 on the
// accumulator fragments; P and dS are rounded to bf16 and packed into A
// fragments, and their transposes are made in registers with movmatrix (four
// 8 x 8 blocks each). The three output products read their second operand
// through ldmatrix.trans and overwrite rows that are dead by then: dv = P^T
// dO into the v rows, dq = dS K into the dO rows, dk = dS^T Q into the k
// rows; the block then stores whole rows, 16 bytes a thread. Logits,
// probabilities and f32 copies never touch shared memory.
//
// temporal_attn_bwd (f32, and what the other does not take: F or G of 17 to
// 32, other head_dims). One block per (batch row, pixel); each warp takes
// heads h = warp, warp + warps, ...: it stages its head's q, k, v, dO slices
// in shared memory as f32, recomputes P (one row per lane), then dP, delta
// and dS, and the three products with full-f32 FMAs. Up to 4 warps per
// block, fewer when F, G and D make a warp's tiles large (F, G <= 32). Bound
// by shared-memory loads; kept because comparing the card with the CPU needs
// full-f32 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "temporal_mma.cuh"

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


// ---- the bf16 tensor-core kernel ----

struct MmaParams {
  temporal::Slab q, k, v, dout;
  bf16 *dq, *dk, *dv;
  Strides sdq, sdk;  // dq; dk and dv
  const float* mask;
  int N, NG, units;  // pixels a batch row, head groups a pixel, B * N * NG
  float scale, scale_log2;  // 1 / sqrt(D), and the same times log2(e)
};

template <int ND>
__global__ void __launch_bounds__(temporal::MAX_WARPS * 32, 2)
    temporal_attn_bwd_mma_kernel(const MmaParams p) {
  using namespace temporal;
  constexpr int D = ND * 8;
  extern __shared__ __align__(16) unsigned char tiles[];
  const Tile t(D * 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group_cols = (blockDim.x >> 5) * D;
  const int slab = ROWS * t.pitch;  // bytes of one tensor's rows; a stage is q, k, v, dO
  const unsigned tiles_addr = static_cast<unsigned>(__cvta_generic_to_shared(tiles));
  const Lanes l(lane, t.pitch, warp * D * 2, D);
  const int F = p.q.rows, G = p.k.rows;
  float mk[2][4];
  load_mask(mk, p.mask, F, G, lane);

  auto load = [&](int u, int stage) {
    const Unit w(u, p.N, p.NG);
    const unsigned dst = tiles_addr + stage * 4 * slab;
    copy_in(dst, p.q.p + w.offset(p.q.bs, p.q.ns, group_cols), p.q.fs, F, t);
    copy_in(dst + slab, p.k.p + w.offset(p.k.bs, p.k.ns, group_cols), p.k.fs, G, t);
    copy_in(dst + 2 * slab, p.v.p + w.offset(p.v.bs, p.v.ns, group_cols), p.v.fs, G, t);
    copy_in(dst + 3 * slab, p.dout.p + w.offset(p.dout.bs, p.dout.ns, group_cols), p.dout.fs,
            F, t);
  };

  int u = blockIdx.x, stage = 0;
  if (u < p.units) load(u, 0);
  hopper::cp_async_commit();
  for (; u < p.units; u += gridDim.x, stage ^= 1) {
    if (u + (int)gridDim.x < p.units) load(u + gridDim.x, stage ^ 1);
    hopper::cp_async_commit();
    cp_async_wait_but_one();  // this unit's rows have landed; the next one's are in flight
    __syncthreads();
    const unsigned sq = tiles_addr + stage * 4 * slab;
    const unsigned sk = sq + slab, sv = sq + 2 * slab, sdo = sq + 3 * slab;
    unsigned char* rows = tiles + stage * 4 * slab;

    float s[2][4] = {}, dp[2][4] = {};
    product_xyt<ND>(s, sq, sk, l);
    product_xyt<ND>(dp, sdo, sv, l);
    softmax_rows(s, mk, p.scale_log2);  // s is P now
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows lane / 4 and lane / 4 + 8
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) delta = fmaf(dp[j][e], s[j][e], delta);
      delta += __shfl_xor_sync(0xffffffffu, delta, 1);
      delta += __shfl_xor_sync(0xffffffffu, delta, 2);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) dp[j][e] = s[j][e] * (dp[j][e] - delta) * p.scale;
    }
    uint32_t pa[4], da[4], pt[4], dt[4];  // P, dS and their transposes, bf16
    pack_a(pa, s);
    pack_a(da, dp);
    transpose_a(pt, pa);
    transpose_a(dt, da);
    __syncwarp();  // every lane has read v: its columns take dv = P^T dO
    product_ay<ND>(pt, sdo, rows + 2 * slab, l, t.pitch);
    __syncwarp();  // dO is dead: its columns take dq = dS K
    product_ay<ND>(da, sk, rows + 3 * slab, l, t.pitch);
    __syncwarp();  // k is dead: its columns take dk = dS^T Q
    product_ay<ND>(dt, sq, rows + slab, l, t.pitch);
    __syncthreads();
    const Unit w(u, p.N, p.NG);
    copy_out(p.dq + w.offset(p.sdq.bs, p.sdq.ns, group_cols), p.sdq.fs, rows + 3 * slab, F, t);
    copy_out(p.dk + w.offset(p.sdk.bs, p.sdk.ns, group_cols), p.sdk.fs, rows + slab, G, t);
    copy_out(p.dv + w.offset(p.sdk.bs, p.sdk.ns, group_cols), p.sdk.fs, rows + 2 * slab, G, t);
    __syncthreads();  // the stage is free for the unit after the next
  }
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

// The bf16 tensor-core kernel: F, G <= 16, D a head_dim of
// temporal::for_head_dim, HG (heads a block takes, one warp each) a divisor
// of H, at most 8. Strides as above.
extern "C" int temporal_attn_bwd_mma(const void* q, const void* k, const void* v,
                                     const void* dout, long long q_bs, long long q_ns,
                                     long long q_fs, long long k_bs, long long k_ns,
                                     long long k_fs, long long v_bs, long long v_ns,
                                     long long v_fs, long long o_bs, long long o_ns,
                                     long long o_fs, const void* mask, void* dq, void* dk,
                                     void* dv, long long dq_bs, long long dq_ns,
                                     long long dq_fs, long long dk_bs, long long dk_ns,
                                     long long dk_fs, int B, int N, int F, int G, int H, int D,
                                     int HG, float scale, void* stream) {
  const long long units = temporal::unit_count(B, N, F, G, H, HG);
  if (units < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  MmaParams p;
  p.q = {static_cast<const bf16*>(q), q_bs, q_ns, q_fs, F};
  p.k = {static_cast<const bf16*>(k), k_bs, k_ns, k_fs, G};
  p.v = {static_cast<const bf16*>(v), v_bs, v_ns, v_fs, G};
  p.dout = {static_cast<const bf16*>(dout), o_bs, o_ns, o_fs, F};
  p.dq = static_cast<bf16*>(dq), p.dk = static_cast<bf16*>(dk), p.dv = static_cast<bf16*>(dv);
  p.sdq = {dq_bs, dq_ns, dq_fs}, p.sdk = {dk_bs, dk_ns, dk_fs};
  p.mask = static_cast<const float*>(mask);
  p.N = N, p.NG = H / HG, p.units = static_cast<int>(units);
  p.scale = scale, p.scale_log2 = scale * hopper::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = temporal::for_head_dim(D, [&](auto nd) {
    constexpr int ND = decltype(nd)::value;
    static temporal::LaunchState state;  // one per instantiation
    return temporal::launch_units(temporal_attn_bwd_mma_kernel<ND>, p, p.units, HG, 4,
                                  HG * ND, state, s);
  });
  return static_cast<int>(err);
}
