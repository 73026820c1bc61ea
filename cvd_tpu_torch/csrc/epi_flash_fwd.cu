// Epipolar flash attention, forward (kernels K1 and K2 of the port).
//
// Replaces cvd_tpu/ops/epi_flash.py:_fwd_kernel (the Pallas TPU kernel
// behind epi_flash_attention, has_bias=True, and flash_attention,
// has_bias=False).
//
// What it computes: for query row b, head h, query n and key m of the
// routed kv row kb = kv_index[b] (or b),
//   logit = q[b,n,hD:hD+D] . k[kb,m,hD:hD+D] / sqrt(D)
//         + (HAS_BIAS ? -relu(|a_n x_m + b_n y_m + c_n| - band[b]) * alpha[b] : 0)
// softmax over m in f32, out = P V, plus the row log-sum-exp lse[b,h,n].
//
// What bounds it on the H100: at the main-path shapes (N = 1024 or 256
// tokens, head_dim 40 or 80) the two products are ~2*N*N*D flops against
// ~4*N*D*2 bytes per (row, head), i.e. compute-bound in principle; what
// limits this first version is the scalar work per tile (the bias, the
// online softmax, and the f32 accumulator kept in shared memory), not the
// tensor cores.
//
// Design:
//  * one block owns (q-tile of 64 queries, head, batch row) and loads its
//    kv row index itself (the TPU kernel's scalar prefetch);
//  * q, k, v are read in place from the [B, N, C] projection layout through
//    row strides, head h at column offset h*D: no transposes, no gather;
//  * k/v stream through shared memory in tiles of 64 keys with an online
//    softmax in f32 (the TPU kernel held a whole key row in VMEM and took an
//    exact softmax; 227 KB of shared memory does not hold one here);
//  * the bias is evaluated per (query, key) in-tile from the query line's
//    (a, b, c) and the key pixel's (x, y), as _bias_tile does;
//  * bf16: both products on the tensor cores (WMMA 16x16x16, f32
//    accumulate), P rounded to bf16 before P V as the TPU kernel does;
//    f32: both products as f32 FMAs, so f32 inputs keep full-f32 products;
//  * head_dim 40/80/160 is not a power of two: the tiles pad it to a
//    multiple of 16 (DP) with zeros;
//  * above 48 KB the shared-memory budget is raised with
//    cudaFuncAttributeMaxDynamicSharedMemorySize (DP = 160 in f32 needs
//    ~200 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;           // queries per block
constexpr int BKEY = 64;         // keys per tile
constexpr int WARPS = 4;         // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <typename T, int DP>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LDT = F32 ? DP + 1 : DP + 8;      // q/k/v tiles
  static constexpr int LDS = BKEY + 4;                   // f32 scores
  static constexpr int LDP = F32 ? BKEY + 1 : BKEY + 8;  // probabilities
  static constexpr int LDO = DP + 4;                     // f32 accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + align128(BQ * LDT * (int)sizeof(T));
  static constexpr int V_OFF = K_OFF + align128(BKEY * LDT * (int)sizeof(T));
  static constexpr int S_OFF = V_OFF + align128(BKEY * LDT * (int)sizeof(T));
  static constexpr int P_OFF = S_OFF + align128(BQ * LDS * 4);
  static constexpr int O_OFF = P_OFF + align128(BQ * LDP * (int)sizeof(T));
  static constexpr int G_OFF = O_OFF + align128(BQ * LDO * 4);
  static constexpr int BYTES = G_OFF + align128((3 * BQ + 2 * BKEY) * 4);
};

// rows [n0, n0+64) of a [L, *] slab (row stride rs, head columns at src),
// columns [0, DP) with zeros beyond D and beyond L
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int n0, int L, int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int idx = threadIdx.x; idx < BQ * CHUNKS; idx += THREADS) {
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

// S[r0:r0+16, 0:64] = Q[r0:r0+16] K^T for this warp's rows
template <typename T, int DP>
__device__ __forceinline__ void warp_scores(const T* Qs, const T* Ks, float* Ss,
                                            int r0, int lane) {
  using Lt = Layout<T, DP>;
  if constexpr (Lt::F32) {
    for (int rr = 0; rr < 16; ++rr) {
      const float* qrow = Qs + (r0 + rr) * Lt::LDT;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float* krow = Ks + c * Lt::LDT;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) acc = fmaf(qrow[d], krow[d], acc);
        Ss[(r0 + rr) * Lt::LDS + c] = acc;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < BKEY / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + r0 * Lt::LDT + kk * 16, Lt::LDT);
        wmma::load_matrix_sync(b, Ks + n * 16 * Lt::LDT + kk * 16, Lt::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * Lt::LDS + n * 16, acc, Lt::LDS, wmma::mem_row_major);
    }
  }
}

// O[r0:r0+16, 0:DP] += P[r0:r0+16, 0:64] V for this warp's rows
template <typename T, int DP>
__device__ __forceinline__ void warp_pv(const T* Ps, const T* Vs, float* Os,
                                        int r0, int lane) {
  using Lt = Layout<T, DP>;
  if constexpr (Lt::F32) {
    for (int rr = 0; rr < 16; ++rr) {
      const float* prow = Ps + (r0 + rr) * Lt::LDP;
      for (int d = lane; d < DP; d += 32) {
        float acc = Os[(r0 + rr) * Lt::LDO + d];
#pragma unroll 8
        for (int c = 0; c < BKEY; ++c) acc = fmaf(prow[c], Vs[c * Lt::LDT + d], acc);
        Os[(r0 + rr) * Lt::LDO + d] = acc;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * Lt::LDO + j * 16, Lt::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + r0 * Lt::LDP + kk * 16, Lt::LDP);
        wmma::load_matrix_sync(b, Vs + kk * 16 * Lt::LDT + j * 16, Lt::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + r0 * Lt::LDO + j * 16, acc, Lt::LDO, wmma::mem_row_major);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool HAS_BIAS, int DP>
__global__ void __launch_bounds__(THREADS) epi_flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, const int* __restrict__ kv_index,
    const float* __restrict__ lines, const float* __restrict__ coords,
    const float* __restrict__ band, const float* __restrict__ alpha,
    T* __restrict__ out, long long o_bs, long long o_rs, float* __restrict__ lse,
    int H, int Lq, int Lk, int D, float scale) {
  using Lt = Layout<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lt::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + Lt::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + Lt::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + Lt::S_OFF);
  T* Ps = reinterpret_cast<T*>(smem + Lt::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + Lt::O_OFF);
  float* La = reinterpret_cast<float*>(smem + Lt::G_OFF);  // [3][BQ] query lines
  float* Kx = La + 3 * BQ;                                 // [2][BKEY] key coords

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kb = kv_index != nullptr ? kv_index[b] : b;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<T, DP, Lt::LDT>(Qs, q + b * q_bs + (long long)h * D, q_rs, q0, Lq, D);
  for (int i = threadIdx.x; i < BQ * Lt::LDO; i += THREADS) Os[i] = 0.f;
  float band_b = 0.f, alpha_b = 0.f;
  if constexpr (HAS_BIAS) {
    for (int i = threadIdx.x; i < 3 * BQ; i += THREADS) {
      const int r = i % BQ, j = i / BQ;
      const int n = q0 + r;
      La[j * BQ + r] = n < Lq ? lines[((long long)b * Lq + n) * 3 + j] : 0.f;
    }
    band_b = band[b];
    alpha_b = alpha[b];
  }

  float m_run[16], l_run[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m_run[rr] = -CUDART_INF_F;
    l_run[rr] = 0.f;
  }

  const T* kbase = k + kb * k_bs + (long long)h * D;
  const T* vbase = v + kb * v_bs + (long long)h * D;
  for (int k0 = 0; k0 < Lk; k0 += BKEY) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, DP, Lt::LDT>(Ks, kbase, k_rs, k0, Lk, D);
    load_tile<T, DP, Lt::LDT>(Vs, vbase, v_rs, k0, Lk, D);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < 2 * BKEY; i += THREADS) {
        const int c = i % BKEY, j = i / BKEY;
        Kx[j * BKEY + c] = k0 + c < Lk ? coords[(long long)j * Lk + k0 + c] : 0.f;
      }
    }
    __syncthreads();

    warp_scores<T, DP>(Qs, Ks, Ss, r0, lane);
    __syncwarp();

    // online softmax over this tile, one row at a time (2 keys per lane)
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        float val = Ss[r * Lt::LDS + c] * scale;
        if constexpr (HAS_BIAS) {
          const float dist = fabsf(La[r] * Kx[c] + La[BQ + r] * Kx[BKEY + c] + La[2 * BQ + r]);
          val += -fmaxf(dist - band_b, 0.f) * alpha_b;
        }
        s[j] = k0 + c < Lk ? val : -CUDART_INF_F;
      }
      const float m_new = fmaxf(m_run[rr], warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m_run[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        Ps[r * Lt::LDP + lane + 32 * j] = from_f<T>(p);
      }
      l_run[rr] = l_run[rr] * corr + warp_sum(psum);
      m_run[rr] = m_new;
      for (int d = lane; d < DP; d += 32) Os[r * Lt::LDO + d] *= corr;
    }
    __syncwarp();
    warp_pv<T, DP>(Ps, Vs, Os, r0, lane);
  }
  __syncwarp();

  T* obase = out + b * o_bs + (long long)h * D;
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int n = q0 + r0 + rr;
    if (n >= Lq) continue;
    const float inv = 1.f / l_run[rr];
    for (int d = lane; d < D; d += 32)
      obase[(long long)n * o_rs + d] = from_f<T>(Os[(r0 + rr) * Lt::LDO + d] * inv);
    if (lane == 0) lse[((long long)b * H + h) * Lq + n] = m_run[rr] + logf(l_run[rr]);
  }
}

template <typename T, bool HAS_BIAS, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, long long q_bs,
                   long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                   long long v_rs, const void* kv_index, const void* lines,
                   const void* coords, const void* band, const void* alpha, void* out,
                   long long o_bs, long long o_rs, void* lse, int B, int H, int Lq,
                   int Lk, int D, float scale, cudaStream_t stream) {
  auto kernel = epi_flash_fwd_kernel<T, HAS_BIAS, DP>;
  constexpr int bytes = Layout<T, DP>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, static_cast<const int*>(kv_index),
      static_cast<const float*>(lines), static_cast<const float*>(coords),
      static_cast<const float*>(band), static_cast<const float*>(alpha), static_cast<T*>(out),
      o_bs, o_rs, static_cast<float*>(lse), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <typename T, bool HAS_BIAS>
cudaError_t dispatch(int DP, const void* q, const void* k, const void* v, long long q_bs,
                     long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                     long long v_rs, const void* kv_index, const void* lines,
                     const void* coords, const void* band, const void* alpha, void* out,
                     long long o_bs, long long o_rs, void* lse, int B, int H, int Lq, int Lk,
                     int D, float scale, cudaStream_t stream) {
#define EPI_CASE(dp)                                                                     \
  case dp:                                                                               \
    return launch<T, HAS_BIAS, dp>(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, kv_index, \
                                   lines, coords, band, alpha, out, o_bs, o_rs, lse, B, H, \
                                   Lq, Lk, D, scale, stream);
  switch (DP) {
    EPI_CASE(16)
    EPI_CASE(32)
    EPI_CASE(48)
    EPI_CASE(64)
    EPI_CASE(80)
    EPI_CASE(96)
    EPI_CASE(128)
    EPI_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
#undef EPI_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_index may be null (identity routing);
// lines/coords/band/alpha are read only when has_bias. Strides in elements.
extern "C" int epi_flash_fwd(int dtype, int has_bias, const void* q, const void* k,
                             const void* v, long long q_bs, long long q_rs, long long k_bs,
                             long long k_rs, long long v_bs, long long v_rs,
                             const void* kv_index, const void* lines, const void* coords,
                             const void* band, const void* alpha, void* out, long long o_bs,
                             long long o_rs, void* lse, int B, int H, int Lq, int Lk, int D,
                             float scale, void* stream) {
  const int DP = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EPI_ARGS                                                                          \
  DP, q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, kv_index, lines, coords, band, alpha, out, \
      o_bs, o_rs, lse, B, H, Lq, Lk, D, scale, s
  cudaError_t err;
  if (dtype == 0)
    err = has_bias ? dispatch<float, true>(EPI_ARGS) : dispatch<float, false>(EPI_ARGS);
  else if (dtype == 1)
    err = has_bias ? dispatch<bf16, true>(EPI_ARGS) : dispatch<bf16, false>(EPI_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef EPI_ARGS
  return static_cast<int>(err);
}
