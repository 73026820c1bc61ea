// Epipolar flash attention, backward (kernel K6 of the port).
//
// Replaces cvd_tpu/ops/epi_flash.py:_bwd_kernel (the Pallas TPU kernel
// behind the custom_vjp of epi_flash_attention, has_bias=True, and of
// flash_attention, has_bias=False).
//
// What it computes: with the forward's row log-sum-exp lse[b,h,n] and
// delta[b,h,n] = rowsum(dO * O) (taken outside, as _bwd_call does), for
// query row b, head h, query n and key m of the routed kv row kb:
//   P    = exp(q.k / sqrt(D) + bias - lse)        (bias as in the forward)
//   dP   = dO . v
//   dS   = P (dP - delta)
//   dq   = dS k / sqrt(D),  dk = dS^T q / sqrt(D),  dv = P^T dO
// all three in f32. dk/dv come out aligned to the QUERY row b (the
// gathered layout); the wrapper scatter-adds them to the source rows.
//
// What bounds it on the H100: ~4 products of 2*N*N*D flops per (row, head)
// against ~8*N*D*2 bytes, compute-bound in principle; like the forward,
// this first version is bound by the scalar work per tile (bias, exp, the
// f32 accumulators kept in shared memory), not by the tensor cores.
//
// Design (FlashAttention-2's split; the TPU kernel instead holds a whole key
// row in VMEM and revisits the dk/dv block across a sequential q-tile grid
// axis, which one CUDA grid cannot do):
//  * kernel dkdv: one block owns (64 keys, head, batch row) and loops over
//    every q-tile, accumulating dk and dv for its keys in shared memory (f32)
//    — no atomics, each key's sums are owned by one warp;
//  * kernel dq: one block owns (64 queries, head, batch row) and loops over
//    every k-tile, accumulating dq;
//  * both recompute the logits and the in-tile epipolar bias exactly as the
//    forward does, with P = exp(logit - lse);
//  * q/k/v/dO are read in place from the [B, N, C] layout through row
//    strides, head h at column offset h*D, kv row kv_index[b] read in place;
//  * bf16: the four products on the tensor cores (WMMA 16x16x16, f32
//    accumulate). S = q k^T and dP = dO v^T take the bf16 inputs exactly;
//    P (for dv) and dS (for dk, dq) are rounded to bf16 before their
//    products. The TPU kernel casts its operands to f32 but multiplies at
//    the MXU's default (bf16) precision, so it rounds at the same places.
//    f32: every product as f32 FMAs, so f32 gradients stay full-f32;
//  * head_dim pads to a multiple of 16 (DP) with zeros. Shared memory:
//    dkdv holds four tiles, two f32 score tiles and two f32 accumulators;
//    that fits 227 KB up to DP = 160 in bf16 and DP = 96 in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BT = 64;     // rows per tile: keys (dkdv) or queries (dq)
constexpr int WARPS = 4;   // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <typename T, int DP>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LDT = F32 ? DP + 1 : DP + 8;      // q/k/v/dO tiles
  static constexpr int LDS = BT + 4;                     // f32 S and dP tiles
  // P and dS as product operands: bf16 copies, or in place in S / dP (f32)
  static constexpr int LDP = F32 ? LDS : BT + 8;
  static constexpr int LDO = DP + 4;                     // f32 accumulators
  static constexpr int TILE = align128(BT * LDT * (int)sizeof(T));
  static constexpr int SBUF = align128(BT * LDS * 4);
  static constexpr int PBUF = F32 ? 0 : align128(BT * LDP * (int)sizeof(T));
  static constexpr int ACC = align128(BT * LDO * 4);
  static constexpr int GEOM = align128((3 * BT + 2 * BT + 2 * BT) * 4);
  // dkdv: K, V, Q, dO tiles; S, dP; P, dS; dK, dV accumulators; geometry
  static constexpr int DKDV_BYTES = 4 * TILE + 2 * SBUF + 2 * PBUF + 2 * ACC + GEOM;
  // dq: Q, dO, K, V tiles; S, dP; dS; dQ accumulator; geometry
  static constexpr int DQ_BYTES = 4 * TILE + 2 * SBUF + PBUF + ACC + GEOM;
};

// rows [n0, n0+64) of a [L, *] slab (row stride rs, head columns at src),
// columns [0, DP) with zeros beyond D and beyond L
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int n0, int L,
                                          int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    const int n = n0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (n < L && c < D) raw = *reinterpret_cast<const uint4*>(src + (long long)n * rs + c);
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
    } else {
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LD + c + j] = e[j];
    }
  }
}

// C[r0:r0+16, 0:64] (f32, row stride ldc) = A[r0:r0+16, 0:DP] B[0:64, 0:DP]^T
template <typename T, int DP>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* C, int ldc, int r0,
                                         int lane) {
  using Lt = Layout<T, DP>;
  if constexpr (Lt::F32) {
    for (int rr = 0; rr < 16; ++rr) {
      const float* arow = A + (r0 + rr) * Lt::LDT;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float* brow = B + c * Lt::LDT;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) acc = fmaf(arow[d], brow[d], acc);
        C[(r0 + rr) * ldc + c] = acc;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + r0 * Lt::LDT + kk * 16, Lt::LDT);
        wmma::load_matrix_sync(b, B + n * 16 * Lt::LDT + kk * 16, Lt::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + r0 * ldc + n * 16, acc, ldc, wmma::mem_row_major);
    }
  }
}

// Acc[r0:r0+16, 0:DP] (f32, LDO) += A[r0:r0+16, 0:64] (row stride LDP) B[0:64, 0:DP]
template <typename T, int DP>
__device__ __forceinline__ void warp_ab_acc(const T* A, const T* B, float* Acc, int r0,
                                            int lane) {
  using Lt = Layout<T, DP>;
  if constexpr (Lt::F32) {
    for (int rr = 0; rr < 16; ++rr) {
      const float* arow = A + (r0 + rr) * Lt::LDP;
      for (int d = lane; d < DP; d += 32) {
        float acc = Acc[(r0 + rr) * Lt::LDO + d];
#pragma unroll 8
        for (int c = 0; c < BT; ++c) acc = fmaf(arow[c], B[c * Lt::LDT + d], acc);
        Acc[(r0 + rr) * Lt::LDO + d] = acc;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Acc + r0 * Lt::LDO + j * 16, Lt::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + r0 * Lt::LDP + kk * 16, Lt::LDP);
        wmma::load_matrix_sync(b, B + kk * 16 * Lt::LDT + j * 16, Lt::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Acc + r0 * Lt::LDO + j * 16, acc, Lt::LDO, wmma::mem_row_major);
    }
  }
}

__device__ __forceinline__ float epi_bias(const float* La, int r, const float* Kx, int c,
                                          float band_b, float alpha_b) {
  const float dist = fabsf(La[r] * Kx[c] + La[BT + r] * Kx[BT + c] + La[2 * BT + r]);
  return -fmaxf(dist - band_b, 0.f) * alpha_b;
}

// per-query rows of a q-tile: lines [3][BT], lse and delta [BT] (lse = +inf
// past Lq, so those queries get P = 0)
template <bool HAS_BIAS>
__device__ __forceinline__ void load_query_rows(float* La, float* Ls, float* Dl,
                                                const float* lines, const float* lse,
                                                const float* delta, int b, int bh, int q0,
                                                int Lq) {
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const int n = q0 + i;
    Ls[i] = n < Lq ? lse[(long long)bh * Lq + n] : CUDART_INF_F;
    Dl[i] = n < Lq ? delta[(long long)bh * Lq + n] : 0.f;
  }
  if constexpr (HAS_BIAS) {
    for (int i = threadIdx.x; i < 3 * BT; i += THREADS) {
      const int r = i % BT, j = i / BT;
      const int n = q0 + r;
      La[j * BT + r] = n < Lq ? lines[((long long)b * Lq + n) * 3 + j] : 0.f;
    }
  }
}

template <bool HAS_BIAS>
__device__ __forceinline__ void load_key_coords(float* Kx, const float* coords, int k0, int Lk) {
  if constexpr (HAS_BIAS) {
    for (int i = threadIdx.x; i < 2 * BT; i += THREADS) {
      const int c = i % BT, j = i / BT;
      Kx[j * BT + c] = k0 + c < Lk ? coords[(long long)j * Lk + k0 + c] : 0.f;
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  const int* kv_index;
  const float *lines, *coords, *band, *alpha, *lse, *delta;
  float *dq, *dk, *dv;  // [B, Lq, C] and gathered [B, Lk, C], contiguous f32
  int B, H, Lq, Lk, D;
  float scale;
};

template <typename T, bool HAS_BIAS, int DP>
__global__ void __launch_bounds__(THREADS) epi_flash_bwd_dkdv_kernel(Args a) {
  using Lt = Layout<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + Lt::TILE);
  T* Qs = reinterpret_cast<T*>(smem + 2 * Lt::TILE);
  T* Os = reinterpret_cast<T*>(smem + 3 * Lt::TILE);  // dO
  float* Ss = reinterpret_cast<float*>(smem + 4 * Lt::TILE);
  float* Dp = reinterpret_cast<float*>(smem + 4 * Lt::TILE + Lt::SBUF);
  unsigned char* pbase = smem + 4 * Lt::TILE + 2 * Lt::SBUF;
  T* Ps = Lt::F32 ? reinterpret_cast<T*>(Ss) : reinterpret_cast<T*>(pbase);
  T* dSs = Lt::F32 ? reinterpret_cast<T*>(Dp) : reinterpret_cast<T*>(pbase + Lt::PBUF);
  float* dKa = reinterpret_cast<float*>(pbase + 2 * Lt::PBUF);
  float* dVa = reinterpret_cast<float*>(pbase + 2 * Lt::PBUF + Lt::ACC);
  float* La = reinterpret_cast<float*>(pbase + 2 * Lt::PBUF + 2 * Lt::ACC);  // [3][BT]
  float* Kx = La + 3 * BT;                                                     // [2][BT]
  float* Ls = Kx + 2 * BT;                                                     // [BT]
  float* Dl = Ls + BT;                                                         // [BT]

  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kb = a.kv_index != nullptr ? a.kv_index[b] : b;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 keys
  const long long col = (long long)h * a.D;

  load_tile<T, DP, Lt::LDT>(Ks, static_cast<const T*>(a.k) + kb * a.k_bs + col, a.k_rs, k0,
                            a.Lk, a.D);
  load_tile<T, DP, Lt::LDT>(Vs, static_cast<const T*>(a.v) + kb * a.v_bs + col, a.v_rs, k0,
                            a.Lk, a.D);
  load_key_coords<HAS_BIAS>(Kx, a.coords, k0, a.Lk);
  for (int i = threadIdx.x; i < BT * Lt::LDO; i += THREADS) dKa[i] = dVa[i] = 0.f;
  const float band_b = HAS_BIAS ? a.band[b] : 0.f;
  const float alpha_b = HAS_BIAS ? a.alpha[b] : 0.f;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_bs + col;
  const T* ob = static_cast<const T*>(a.dout) + b * a.do_bs + col;

  for (int q0 = 0; q0 < a.Lq; q0 += BT) {
    __syncthreads();  // every warp is done with the previous q-tile
    load_tile<T, DP, Lt::LDT>(Qs, qb, a.q_rs, q0, a.Lq, a.D);
    load_tile<T, DP, Lt::LDT>(Os, ob, a.do_rs, q0, a.Lq, a.D);
    load_query_rows<HAS_BIAS>(La, Ls, Dl, a.lines, a.lse, a.delta, b, b * a.H + h, q0, a.Lq);
    __syncthreads();

    warp_abt<T, DP>(Ks, Qs, Ss, Lt::LDS, r0, lane);  // S^T [key][query]
    warp_abt<T, DP>(Vs, Os, Dp, Lt::LDS, r0, lane);  // dP^T [key][query]
    __syncwarp();
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;  // key
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;  // query
        float s = Ss[r * Lt::LDS + c] * a.scale;
        if constexpr (HAS_BIAS) s += epi_bias(La, c, Kx, r, band_b, alpha_b);
        const float p = k0 + r < a.Lk ? expf(s - Ls[c]) : 0.f;
        const float ds = p * (Dp[r * Lt::LDS + c] - Dl[c]);
        Ps[r * Lt::LDP + c] = from_f<T>(p);
        dSs[r * Lt::LDP + c] = from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_ab_acc<T, DP>(Ps, Os, dVa, r0, lane);   // dV += P^T dO
    warp_ab_acc<T, DP>(dSs, Qs, dKa, r0, lane);  // dK += dS^T Q
  }
  __syncwarp();

  const long long C = (long long)a.H * a.D;
  float* dkb = a.dk + (long long)b * a.Lk * C + col;
  float* dvb = a.dv + (long long)b * a.Lk * C + col;
  for (int rr = 0; rr < 16; ++rr) {
    const int m = k0 + r0 + rr;
    if (m >= a.Lk) break;
    for (int d = lane; d < a.D; d += 32) {
      dkb[m * C + d] = dKa[(r0 + rr) * Lt::LDO + d] * a.scale;
      dvb[m * C + d] = dVa[(r0 + rr) * Lt::LDO + d];
    }
  }
}

template <typename T, bool HAS_BIAS, int DP>
__global__ void __launch_bounds__(THREADS) epi_flash_bwd_dq_kernel(Args a) {
  using Lt = Layout<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = reinterpret_cast<T*>(smem + Lt::TILE);  // dO
  T* Ks = reinterpret_cast<T*>(smem + 2 * Lt::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 3 * Lt::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 4 * Lt::TILE);
  float* Dp = reinterpret_cast<float*>(smem + 4 * Lt::TILE + Lt::SBUF);
  unsigned char* pbase = smem + 4 * Lt::TILE + 2 * Lt::SBUF;
  T* dSs = Lt::F32 ? reinterpret_cast<T*>(Dp) : reinterpret_cast<T*>(pbase);
  float* dQa = reinterpret_cast<float*>(pbase + Lt::PBUF);
  float* La = reinterpret_cast<float*>(pbase + Lt::PBUF + Lt::ACC);  // [3][BT]
  float* Kx = La + 3 * BT;                                           // [2][BT]
  float* Ls = Kx + 2 * BT;
  float* Dl = Ls + BT;

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kb = a.kv_index != nullptr ? a.kv_index[b] : b;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 queries
  const long long col = (long long)h * a.D;

  load_tile<T, DP, Lt::LDT>(Qs, static_cast<const T*>(a.q) + b * a.q_bs + col, a.q_rs, q0,
                            a.Lq, a.D);
  load_tile<T, DP, Lt::LDT>(Os, static_cast<const T*>(a.dout) + b * a.do_bs + col, a.do_rs,
                            q0, a.Lq, a.D);
  load_query_rows<HAS_BIAS>(La, Ls, Dl, a.lines, a.lse, a.delta, b, b * a.H + h, q0, a.Lq);
  for (int i = threadIdx.x; i < BT * Lt::LDO; i += THREADS) dQa[i] = 0.f;
  const float band_b = HAS_BIAS ? a.band[b] : 0.f;
  const float alpha_b = HAS_BIAS ? a.alpha[b] : 0.f;
  const T* kbase = static_cast<const T*>(a.k) + kb * a.k_bs + col;
  const T* vbase = static_cast<const T*>(a.v) + kb * a.v_bs + col;

  for (int k0 = 0; k0 < a.Lk; k0 += BT) {
    __syncthreads();  // every warp is done with the previous k-tile
    load_tile<T, DP, Lt::LDT>(Ks, kbase, a.k_rs, k0, a.Lk, a.D);
    load_tile<T, DP, Lt::LDT>(Vs, vbase, a.v_rs, k0, a.Lk, a.D);
    load_key_coords<HAS_BIAS>(Kx, a.coords, k0, a.Lk);
    __syncthreads();

    warp_abt<T, DP>(Qs, Ks, Ss, Lt::LDS, r0, lane);  // S [query][key]
    warp_abt<T, DP>(Os, Vs, Dp, Lt::LDS, r0, lane);  // dP [query][key]
    __syncwarp();
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;  // query
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;  // key
        float s = Ss[r * Lt::LDS + c] * a.scale;
        if constexpr (HAS_BIAS) s += epi_bias(La, r, Kx, c, band_b, alpha_b);
        const float p = k0 + c < a.Lk ? expf(s - Ls[r]) : 0.f;
        dSs[r * Lt::LDP + c] = from_f<T>(p * (Dp[r * Lt::LDS + c] - Dl[r]));
      }
    }
    __syncwarp();
    warp_ab_acc<T, DP>(dSs, Ks, dQa, r0, lane);  // dQ += dS K
  }
  __syncwarp();

  const long long C = (long long)a.H * a.D;
  float* dqb = a.dq + (long long)b * a.Lq * C + col;
  for (int rr = 0; rr < 16; ++rr) {
    const int n = q0 + r0 + rr;
    if (n >= a.Lq) break;
    for (int d = lane; d < a.D; d += 32) dqb[n * C + d] = dQa[(r0 + rr) * Lt::LDO + d] * a.scale;
  }
}

template <typename T, bool HAS_BIAS, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Lt = Layout<T, DP>;
  if constexpr (Lt::DKDV_BYTES > 232448) {
    return cudaErrorInvalidValue;  // head_dim too wide for this dtype
  } else {
    auto dkdv = epi_flash_bwd_dkdv_kernel<T, HAS_BIAS, DP>;
    auto dq = epi_flash_bwd_dq_kernel<T, HAS_BIAS, DP>;
    cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Lt::DKDV_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::DQ_BYTES);
    if (err != cudaSuccess) return err;
    dkdv<<<dim3((a.Lk + BT - 1) / BT, a.H, a.B), THREADS, Lt::DKDV_BYTES, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3((a.Lq + BT - 1) / BT, a.H, a.B), THREADS, Lt::DQ_BYTES, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, bool HAS_BIAS>
cudaError_t dispatch(int DP, const Args& a, cudaStream_t stream) {
  switch (DP) {
    case 16: return launch<T, HAS_BIAS, 16>(a, stream);
    case 32: return launch<T, HAS_BIAS, 32>(a, stream);
    case 48: return launch<T, HAS_BIAS, 48>(a, stream);
    case 64: return launch<T, HAS_BIAS, 64>(a, stream);
    case 80: return launch<T, HAS_BIAS, 80>(a, stream);
    case 96: return launch<T, HAS_BIAS, 96>(a, stream);
    case 128: return launch<T, HAS_BIAS, 128>(a, stream);
    case 160: return launch<T, HAS_BIAS, 160>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_index may be null (identity routing);
// lines/coords/band/alpha are read only when has_bias. Strides in elements.
// lse and delta are [B, H, Lq] f32; dq [B, Lq, C], dk/dv [B, Lk, C] f32,
// contiguous. Returns the cudaError_t of the launches.
extern "C" int epi_flash_bwd(int dtype, int has_bias, const void* q, const void* k,
                             const void* v, const void* dout, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long do_bs, long long do_rs, const void* kv_index,
                             const void* lines, const void* coords, const void* band,
                             const void* alpha, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                             float scale, void* stream) {
  Args a{q, k, v, dout, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs,
         static_cast<const int*>(kv_index), static_cast<const float*>(lines),
         static_cast<const float*>(coords), static_cast<const float*>(band),
         static_cast<const float*>(alpha), static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
         static_cast<float*>(dv), B, H, Lq, Lk, D, scale};
  const int DP = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = has_bias ? dispatch<float, true>(DP, a, s) : dispatch<float, false>(DP, a, s);
  else if (dtype == 1)
    err = has_bias ? dispatch<bf16, true>(DP, a, s) : dispatch<bf16, false>(DP, a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
