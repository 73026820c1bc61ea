// LayerNorm -> matmul, forward (kernel K5 of the port).
//
// Replaces cvd_tpu/ops/ln_matmul.py:_ln_mm_kernel (the Pallas TPU kernel
// behind layer_norm_matmul).
//
// What it computes: out[t, :] = ((x[t] - mean_t) * rstd_t) @ W'^T + b', with
// mean/var over the C channels in f32 and the LayerNorm affine folded into
// W' = gamma * W and b' = beta @ W + b by the caller (ln_matmul.py:183-195).
// W' is [K, C] (one row per output, torch Linear layout), K the
// concatenated projections (q|k|v, or the GEGLU input).
//
// What bounds it on the H100: the product. At the main-path shapes
// (T = 65,536 tokens, C = 320, K = 960 or 2,560, and the narrower-T, wider-C
// levels) it is 2*T*C*K flops on (T*C + C*K + T*K)*2 bytes, well above the
// card's ~295 flops per byte, so it wants the tensor cores; the point of
// the fusion is that the normalized tokens never go back to device memory.
//
// Design: two kernels. ln_stats takes the per-token mean and 1/std (one
// warp per token, two passes over the row in f32, like _standardize).
// ln_matmul then runs a tiled product; each k-step standardizes its token
// chunk on the fly while staging it in shared memory (rounded to the input
// type before the product, as the TPU kernel casts x_hat to the weight
// type), so the normalized tokens exist only in shared memory. The folded
// bias is added in the epilogue.
//  * bf16: (128 tokens) x (128 outputs) blocks of 8 warps, each warp a
//    64 x 32 tile on the tensor cores (WMMA 16x16x16, f32 accumulate);
//    k-chunks of 32 are double-buffered: the next W' chunk streams in with
//    cp.async and the next token chunk is held in registers while the
//    current chunk multiplies, then standardized into the other buffer.
//  * f32: (64 tokens) x (64 outputs) blocks on an f32 FMA path, so f32
//    keeps full f32 products; single-buffered.
// No wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64, BKC = 32;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, long long rs, float* __restrict__ stats,
                                int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + row * rs;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    s2 += d * d;
  }
  const float var = warp_sum(s2) / C;
  if (lane == 0) {
    stats[2 * (long long)row] = mean;
    stats[2 * (long long)row + 1] = 1.f / sqrtf(var + eps);
  }
}

// stage a [64, 32] chunk of rows [r0, r0+64), columns [k0, k0+32) of a
// [rows, C] matrix (row stride rs) into dst[64][LD]; standardize when stats
template <typename T, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int r0, int rows,
                                      int k0, int C, const float* mean, const float* rstd) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BKC / VEC;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    const bool ok = r0 + r < rows && k0 + c < C;
    if (ok) raw = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + k0 + c);
    T* e = reinterpret_cast<T*>(&raw);
    if (mean != nullptr && ok) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f<T>((to_f(e[j]) - mean[r]) * rstd[r]);
    }
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LD + c + j] = e[j];
    }
  }
}

// bf16 tiles: TM tokens x TN outputs per block, k-chunks of TK channels
constexpr int TM = 128, TN = 128, TK = 32, T_THREADS = 256;
constexpr int LDK = TK + 8;  // 80-byte rows: 16-byte aligned, banks staggered
constexpr int LDE = 20;      // epilogue staging of one 16x16 f32 fragment

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// raw token chunk: rows [m0, m0+TM), channels [k0, k0+TK), two 16-byte
// vectors per thread, zeros outside the matrix
__device__ __forceinline__ void load_tokens(uint4 (&ra)[2], const bf16* x, long long rs,
                                            int m0, int rows, int k0, int C) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * T_THREADS;
    const int r = idx >> 2, c = k0 + (idx & 3) * 8;
    ra[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < rows && c < C)
      ra[i] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * rs + c);
  }
}

// standardize the held chunk into As (zeros stay zeros outside the matrix)
__device__ __forceinline__ void store_tokens(bf16* As, const uint4 (&ra)[2], const float* mean,
                                             const float* rstd, int m0, int rows, int k0,
                                             int C) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * T_THREADS;
    const int r = idx >> 2, c = (idx & 3) * 8;
    uint4 v = ra[i];
    if (m0 + r < rows && k0 + c < C) {
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16((__bfloat162float(e[j]) - mean[r]) * rstd[r]);
    }
    *reinterpret_cast<uint4*>(As + r * LDK + c) = v;
  }
}

// W' chunk: outputs [n0, n0+TN), channels [k0, k0+TK), with cp.async
__device__ __forceinline__ void load_weights(bf16* Bs, const bf16* w, int n0, int K, int k0,
                                             int C) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * T_THREADS;
    const int r = idx >> 2, c = (idx & 3) * 8;
    const bool ok = n0 + r < K && k0 + c < C;
    cp_async16(Bs + r * LDK + c, ok ? w + (long long)(n0 + r) * C + k0 + c : w, ok);
  }
}

__global__ void __launch_bounds__(T_THREADS, 2) ln_matmul_bf16_kernel(
    const bf16* __restrict__ x, long long x_rs, const float* __restrict__ stats,
    const bf16* __restrict__ w, const float* __restrict__ bias, bf16* __restrict__ out,
    long long o_rs, int rows, int C, int K) {
  __shared__ __align__(128) bf16 As[2][TM * LDK];
  __shared__ __align__(128) bf16 Bs[2][TN * LDK];
  __shared__ float mean[TM], rstd[TM];

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  for (int i = threadIdx.x; i < TM; i += T_THREADS) {
    const bool ok = m0 + i < rows;
    mean[i] = ok ? stats[2 * (long long)(m0 + i)] : 0.f;
    rstd[i] = ok ? stats[2 * (long long)(m0 + i) + 1] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (C + TK - 1) / TK;
  uint4 ra[2];
  load_tokens(ra, x, x_rs, m0, rows, 0, C);
  load_weights(Bs[0], w, n0, K, 0, C);
  cp_async_commit();
  __syncthreads();  // mean / rstd
  store_tokens(As[0], ra, mean, rstd, m0, rows, 0, C);
  cp_async_wait_all();
  __syncthreads();

  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    const bool more = kc + 1 < nk;
    if (more) {  // the other buffer was released by the barrier ending kc - 1
      load_tokens(ra, x, x_rs, m0, rows, (kc + 1) * TK, C);
      load_weights(Bs[cur ^ 1], w, n0, K, (kc + 1) * TK, C);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As[cur] + (wm + 16 * i) * LDK + kk * 16, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs[cur] + (wn + 16 * j) * LDK + kk * 16, LDK);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (more) store_tokens(As[cur ^ 1], ra, mean, rstd, m0, rows, (kc + 1) * TK, C);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: each 16x16 fragment goes through this warp's staging slice
  // (the token buffers are free after the last barrier), + bias, to bf16
  float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 16 * LDE;
  const bool vec = K % 8 == 0 && o_rs % 8 == 0;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm + 16 * i + r, col = n0 + wn + 16 * j + c;
      if (row < rows) {
        bf16* dst = out + (long long)row * o_rs + col;
        if (vec && col + 8 <= K) {
          uint4 v;
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int q = 0; q < 8; ++q) e[q] = __float2bfloat16(stage[r * LDE + c + q] + bias[col + q]);
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          for (int q = 0; q < 8 && col + q < K; ++q)
            dst[q] = __float2bfloat16(stage[r * LDE + c + q] + bias[col + q]);
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS) ln_matmul_f32_kernel(
    const float* __restrict__ x, long long x_rs, const float* __restrict__ stats,
    const float* __restrict__ w, const float* __restrict__ bias, float* __restrict__ out,
    long long o_rs, int rows, int C, int K) {
  constexpr int LDA = BKC + 1;
  __shared__ float As[BM * LDA];
  __shared__ float Bs[BN * LDA];
  __shared__ float mean[BM], rstd[BM];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tr = threadIdx.x / 16;  // rows tr*8 .. tr*8+7
  const int tc = threadIdx.x % 16;  // cols tc*4 .. tc*4+3
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const bool ok = m0 + i < rows;
    mean[i] = ok ? stats[2 * (long long)(m0 + i)] : 0.f;
    rstd[i] = ok ? stats[2 * (long long)(m0 + i) + 1] : 0.f;
  }
  __syncthreads();

  float acc[8][4] = {};
  for (int k0 = 0; k0 < C; k0 += BKC) {
    __syncthreads();
    stage<float, LDA>(As, x, x_rs, m0, rows, k0, C, mean, rstd);
    stage<float, LDA>(Bs, w, C, n0, K, k0, C, nullptr, nullptr);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BKC; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr * 8 + i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tc * 4 + j) * LDA + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tr * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tc * 4 + j;
      if (r < rows && c < K) out[(long long)r * o_rs + c] = acc[i][j] + bias[c];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [rows, C] (row stride x_rs), w [K, C]
// contiguous, bias [K] f32, stats [rows, 2] f32 scratch, out [rows, K]
// (row stride o_rs). C must be a multiple of 16 bytes' worth of elements.
extern "C" int ln_matmul_fwd(int dtype, const void* x, long long x_rs, const void* w,
                             const void* bias, void* stats, void* out, long long o_rs,
                             int rows, int C, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 stats_grid((rows + 7) / 8);
  if (dtype == 0) {
    const dim3 grid((K + BN - 1) / BN, (rows + BM - 1) / BM);
    ln_stats_kernel<float><<<stats_grid, 256, 0, s>>>(static_cast<const float*>(x), x_rs,
                                                      static_cast<float*>(stats), rows, C, eps);
    ln_matmul_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), x_rs, static_cast<const float*>(stats),
        static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out),
        o_rs, rows, C, K);
  } else if (dtype == 1) {
    ln_stats_kernel<bf16><<<stats_grid, 256, 0, s>>>(static_cast<const bf16*>(x), x_rs,
                                                     static_cast<float*>(stats), rows, C, eps);
    const dim3 grid16((K + TN - 1) / TN, (rows + TM - 1) / TM);
    ln_matmul_bf16_kernel<<<grid16, T_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), x_rs, static_cast<const float*>(stats),
        static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out),
        o_rs, rows, C, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
