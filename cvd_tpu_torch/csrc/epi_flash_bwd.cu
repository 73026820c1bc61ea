// Epipolar flash attention, backward (kernel K6 of the port).
//
// Replaces cvd_tpu/ops/epi_flash.py:_bwd_kernel (the Pallas TPU kernel
// behind the custom_vjp of epi_flash_attention, has_bias=True, and of
// flash_attention, has_bias=False).
//
// What it computes: with the forward's row log-sum-exp lse[b,h,n] and
// delta[b,h,n] = rowsum(dO * O) (a reduction outside the main kernels, as
// _bwd_call takes it; here the small kernel epi_flash_bwd_delta), for
// query row b, head h, query n and key m of the routed kv row kb:
//   P    = exp(q.k / sqrt(D) + bias - lse)        (bias as in the forward)
//   dP   = dO . v
//   dS   = P (dP - delta)
//   dq   = dS k / sqrt(D),  dk = dS^T q / sqrt(D),  dv = P^T dO
// q/k/v/dO are read in place from the [B, L, C] layout through row strides,
// head h at column offset h*D, the kv row kv_index[b] read in place.
//
// What bounds it on the H100 (bf16, B 32, N 1024, C 320, 8 heads of 40):
// five products, 10*B*h*N*N*D = 107 GFLOP, 0.109 ms on the tensor cores
// (989 TFLOP/s) against ~0.05 ms of memory traffic. As in the forward, at
// head_dim 40 the nearer limit is the work per logit: the split below
// evaluates 2*B*h*N*N = 5.4e8 exponentials (16 per clock per SM: ~0.14 ms)
// and the epipolar bias beside each. So every per-logit step stays in
// registers and the tensor cores are fed from registers and swizzled tiles.
//
// Design of the bf16 path (FlashAttention-2's split on wgmma; the TPU kernel
// instead holds a whole key row in VMEM and revisits the dk/dv block across
// a sequential q-tile grid axis, which one CUDA grid cannot do). Two kernels,
// each with the forward's shape; no atomics, so the result is deterministic.
// The split recomputes S and dP (7 products for 5).
//  * dq kernel: a block owns 128 queries of one (row, head), two warpgroups
//    of 64 (one where Lq < 128), and loops over the key tiles. S = Q K^T and
//    dP = dO V^T are wgmma m64n64k16 from swizzled shared-memory tiles into
//    register accumulators; bias, P = ex2(S log2e - lse log2e) and dS are
//    taken on the fragment (lse, delta and the query lines of a thread's two
//    rows live in registers); dS is rounded to bf16 in registers and is the A
//    operand of dQ += dS K (m64nWk16, K read with the transpose flag, W = the
//    width of a 64-channel atom of the head). dQ stays in registers over the
//    whole key loop and leaves once, scaled, in bf16.
//  * dkdv kernel, the same transposed: a warpgroup owns 64 keys of a SOURCE
//    row kb; S^T = K Q^T and dP^T = V dO^T into registers; P^T and dS^T from
//    registers are the A operands of dV += P^T dO and dK += dS^T Q, with the
//    dO and Q tiles read transposed. lse, delta and the lines of a q-tile's
//    queries lie along the fragment's columns and come from a small strip in
//    shared memory; the key coordinates of a thread's two rows live in
//    registers. A block walks every query row b routed to kb (kv_index[b] ==
//    kb; a row may be routed to more than once, or never) in ascending b and
//    keeps dK / dV in registers across them, so the routed gradients land in
//    their source rows with no scatter pass and in a fixed summation order.
//  * registers set the head_dims and the occupancy: S^T and dP^T of 64
//    queries are 32 + 32 f32 a thread, dK and dV W/2 each. Up to head_dim 48
//    the dkdv kernel takes a q-tile in two passes of 32 queries (m64n32k16),
//    which brings it to 128 registers: two blocks share an SM and drift out
//    of phase, so one's products run under the other's exponentials (one
//    block an SM, its two warpgroups in step at the tile barrier, took 0.55
//    ms a launch at the shape above, two take 0.44). Above head_dim 64 the
//    dkdv kernel is launched once per 64-channel atom (2 launches at head_dim
//    80, 3 at 160), each recomputing S^T / dP^T over the whole depth and
//    accumulating its atom: the logits are recomputed, the accumulators fit.
//    The dq kernel holds every atom of dQ (80 f32 a thread at head_dim 160).
//  * the streamed tiles (K/V in dq, Q/dO in dkdv) go through a two-stage
//    cp.async ring as in the forward: the next tile loads while this one
//    multiplies, one block barrier per tile.
//  * outputs go through the block's own finished operand rows in shared
//    memory, so that device memory sees whole 16-byte row pieces, in bf16.
// bf16 rounding: S and dP take the bf16 inputs exactly; P (for dV) and dS
// (for dK, dQ) are rounded to bf16 before their products. The TPU kernel
// casts its operands to f32 but multiplies at the MXU's default (bf16)
// precision, so it rounds at the same places.
//
// The f32 path (f32 inputs keep full-f32 products, as the card-vs-CPU checks
// need) is the simple tiled pair of kernels at the end: 64 rows a block, f32
// FMAs, S / dP and the accumulators in shared memory, which holds them up to
// a padded head_dim of 96. Its dkdv block owns a source row kb too and walks
// the query rows routed to it in ascending b, so both paths write dk/dv per
// source row and no scatter pass follows either.
#include <math_constants.h>

#include "hopper_mma.cuh"

using namespace hopper;

namespace {

constexpr int BT = 64;  // rows per streamed tile, both paths

struct Args {
  const void *q, *k, *v, *dout;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  const int* kv_index;
  const float *lines, *coords, *band, *alpha, *lse, *delta;
  // contiguous, in the input type: dq [B, Lq, C]; dk/dv [Bk, Lk, C], the
  // source rows
  void *dq, *dk, *dv;
  int B, Bk, H, Lq, Lk, D;
  float scale;
};

// ---------------------------------------------------------------------------
// delta[b, h, n] = sum_d dO[b, n, hD + d] * O[b, n, hD + d], one thread a
// (row, query, head), 16-byte loads, f32 sum in channel order
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(256) epi_flash_bwd_delta_kernel(
    const T* __restrict__ dout, const T* __restrict__ out, long long do_bs, long long do_rs,
    long long o_bs, long long o_rs, float* __restrict__ delta, int B, int H, int Lq, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Lq * H) return;
  const int h = idx % H;
  const int n = (idx / H) % Lq;
  const long long b = idx / H / Lq;
  const T* g = dout + b * do_bs + n * do_rs + (long long)h * D;
  const T* o = out + b * o_bs + n * o_rs + (long long)h * D;
  float acc = 0.f;
  for (int c = 0; c < D; c += VEC) {
    const uint4 graw = *reinterpret_cast<const uint4*>(g + c);
    const uint4 oraw = *reinterpret_cast<const uint4*>(o + c);
    const T* ge = reinterpret_cast<const T*>(&graw);
    const T* oe = reinterpret_cast<const T*>(&oraw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = fmaf(to_f(ge[j]), to_f(oe[j]), acc);
  }
  delta[(b * H + h) * Lq + n] = acc;
}

// ---------------------------------------------------------------------------
// bf16: register-resident backward on wgmma
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;
constexpr int STRIP = 5 * BT;  // per-query lse, delta and 3 line coefficients of a q-tile

// shared memory of the dq kernel: Q and dO tiles, K/V ring, key coordinates
template <int ND>
constexpr int dq_bytes(int bq) {
  return 1024 + Tile<ND>::AT * (2 * bq * 128 + 2 * STAGES * TILE) + STAGES * 2 * BT * 4;
}
// of the dkdv kernel: K and V tiles, Q/dO ring, the per-query strips
template <int ND>
constexpr int dkdv_bytes(int bk) {
  return 1024 + Tile<ND>::AT * (2 * bk * 128 + 2 * STAGES * TILE) + STAGES * STRIP * 4;
}

template <bool HAS_BIAS, int ND>
__global__ void __launch_bounds__(256) epi_flash_bwd_dq_bf16_kernel(Args a) {
  using Tl = Tile<ND>;
  constexpr int D = Tl::D, AT = Tl::AT, KS = Tl::KS;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const int BQ = blockDim.x / 2;  // 64 query rows per warpgroup, 16 per warp
  const unsigned Qs = (raw + 1023u) & ~1023u;   // [AT][BQ][64]
  const unsigned Os = Qs + AT * BQ * 128;       // dO, [AT][BQ][64]
  const unsigned Ks = Os + AT * BQ * 128;       // [STAGES][AT][64][64]
  const unsigned Vs = Ks + STAGES * AT * TILE;  // [STAGES][AT][64][64]
  unsigned char* q_ptr = smem_raw + (Qs - raw);
  float* Kx = reinterpret_cast<float*>(smem_raw + (Vs + STAGES * AT * TILE - raw));

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kb = a.kv_index != nullptr ? a.kv_index[b] : b;
  const int lane = threadIdx.x % 32;
  // the warp index as a value the compiler knows to be uniform in the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), wg = warp / 4;
  const int g = lane >> 2, c = lane & 3;  // fragment row and column pair
  const int r0 = warp * 16;               // this warp's rows of the block

  const bf16* kbase = static_cast<const bf16*>(a.k) + kb * a.k_bs + (long long)h * D;
  const bf16* vbase = static_cast<const bf16*>(a.v) + kb * a.v_bs + (long long)h * D;
  const int tiles = (a.Lk + BT - 1) / BT;

  auto copy_kv = [&](int t) {
    const int st = t % STAGES, k0 = t * BT;
    copy_rows<ND>(Ks + st * AT * TILE, kbase, a.k_rs, k0, BT, a.Lk);
    copy_rows<ND>(Vs + st * AT * TILE, vbase, a.v_rs, k0, BT, a.Lk);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < 2 * BT; i += blockDim.x) {
        const int col = k0 + i % BT, j = i / BT;
        const bool ok = col < a.Lk;
        cp_async(Kx + st * 2 * BT + i, ok ? a.coords + (long long)j * a.Lk + col : a.coords,
                 ok, 4);
      }
    }
    cp_async_commit();
  };

  copy_rows<ND>(Qs, static_cast<const bf16*>(a.q) + b * a.q_bs + (long long)h * D, a.q_rs, q0,
                BQ, a.Lq);
  copy_rows<ND>(Os, static_cast<const bf16*>(a.dout) + b * a.do_bs + (long long)h * D, a.do_rs,
                q0, BQ, a.Lq);
  copy_kv(0);

  // this thread's two query rows: r0 + g and r0 + g + 8; a row past Lq has
  // lse = +inf, so its P is 0
  float la[2][3] = {};
  float lse2[2], dl[2];
  const long long bh = (long long)b * a.H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + r0 + g + 8 * i;
    lse2[i] = n < a.Lq ? a.lse[bh * a.Lq + n] * LOG2E : CUDART_INF_F;
    dl[i] = n < a.Lq ? a.delta[bh * a.Lq + n] : 0.f;
    if constexpr (HAS_BIAS) {
      if (n < a.Lq) {
#pragma unroll
        for (int j = 0; j < 3; ++j) la[i][j] = a.lines[((long long)b * a.Lq + n) * 3 + j];
      }
    }
  }
  const float band_b = HAS_BIAS ? a.band[b] : 0.f;
  const float alpha2 = HAS_BIAS ? a.alpha[b] * LOG2E : 0.f;
  const float scale2 = a.scale * LOG2E;

  float dq[AT][32];  // atom at holds width(at) / 2 values a thread
#pragma unroll
  for (int at = 0; at < AT; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[at][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    fence_proxy_async();  // the copies are visible to wgmma
    __syncthreads();      // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < tiles) copy_kv(t + 1);
    const unsigned Kt = Ks + (t % STAGES) * AT * TILE;
    const unsigned Vt = Vs + (t % STAGES) * AT * TILE;
    const float* Kxt = Kx + (t % STAGES) * 2 * BT;
    const int k0 = t * BT;

    // S = Q K^T and dP = dO V^T: 64 rows of the warpgroup x 64 keys; [4 j + e]:
    // column block j of 8 keys, e = 0, 1 row g, e = 2, 3 row g + 8
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss64(s, smem_desc(Qs + (ks / 4) * BQ * 128 + wg * TILE + 32 * (ks % 4)),
                 smem_desc(Kt + (ks / 4) * TILE + 32 * (ks % 4)), ks != 0);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss64(dp, smem_desc(Os + (ks / 4) * BQ * 128 + wg * TILE + 32 * (ks % 4)),
                 smem_desc(Vt + (ks / 4) * TILE + 32 * (ks % 4)), ks != 0);
    wgmma_commit();
    wgmma_wait_all();

    // dS = P (dP - delta) on the fragment, P = 2^(S log2e + bias log2e - lse log2e)
    const bool ragged = k0 + BT > a.Lk;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int col = 8 * j + 2 * c;
      float kx[2] = {0.f, 0.f}, ky[2] = {0.f, 0.f};
      if constexpr (HAS_BIAS) {
        const float2 xx = *reinterpret_cast<const float2*>(Kxt + col);
        const float2 yy = *reinterpret_cast<const float2*>(Kxt + BT + col);
        kx[0] = xx.x, kx[1] = xx.y, ky[0] = yy.x, ky[1] = yy.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cc = e & 1;
        float val = fmaf(s[4 * j + e], scale2, -lse2[i]);
        if constexpr (HAS_BIAS) {
          const float dist = fabsf(la[i][0] * kx[cc] + la[i][1] * ky[cc] + la[i][2]);
          val -= fmaxf(dist - band_b, 0.f) * alpha2;
        }
        float p = fast_exp2(val);
        if (ragged && k0 + col + cc >= a.Lk) p = 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
      }
    }

    // dQ += dS K: dS from the registers (the accumulator layout of one product
    // is the A layout of the next), K read transposed from its tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t df[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                              pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                              pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                              pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs<Tl::width(0)>(dq[0], df, smem_desc(Kt + kk * 2048));
      if constexpr (AT > 1) wgmma_rs<Tl::width(1)>(dq[1], df, smem_desc(Kt + TILE + kk * 2048));
      if constexpr (AT > 2)
        wgmma_rs<Tl::width(2)>(dq[2], df, smem_desc(Kt + 2 * TILE + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait_all();
  }

  // dQ, scaled, goes through this warp's own rows of the Q tile (every warp of
  // the warpgroup is done with it), then out in 16-byte pieces
  bar_sync(1 + wg, 128);
#pragma unroll
  for (int at = 0; at < AT; ++at)
#pragma unroll
    for (int j = 0; j < Tl::width(at) / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i;
        *reinterpret_cast<uint32_t*>(q_ptr + at * BQ * 128 + swz(r, j) + 4 * c) =
            pack_bf16(dq[at][4 * j + 2 * i] * a.scale, dq[at][4 * j + 2 * i + 1] * a.scale);
      }
  __syncwarp();
  const long long C = (long long)a.H * D;
  bf16* obase = static_cast<bf16*>(a.dq) + (long long)b * a.Lq * C + (long long)h * D;
  for (int idx = lane; idx < 16 * ND; idx += 32) {
    const int r = r0 + idx / ND, ch = idx % ND;
    const int n = q0 + r;
    if (n < a.Lq)
      *reinterpret_cast<uint4*>(obase + n * C + ch * 8) =
          *reinterpret_cast<const uint4*>(q_ptr + (ch >> 3) * BQ * 128 + swz(r, ch & 7));
  }
}

// dK and dV of channels [64 ATOM, 64 ATOM + W) of head h for 64 keys a
// warpgroup of source row kb, summed over every query row routed to kb
template <bool HAS_BIAS, int ND, int ATOM>
__global__ void __launch_bounds__(256) epi_flash_bwd_dkdv_bf16_kernel(Args a) {
  using Tl = Tile<ND>;
  constexpr int D = Tl::D, AT = Tl::AT, KS = Tl::KS, W = Tl::width(ATOM);
  // queries per pass over a q-tile. Up to head_dim 48, two passes of 32 halve
  // the S^T and dP^T registers to fit 128 a thread, so that two blocks share
  // an SM and run out of phase; wider heads are over 128 either way
  constexpr int QH = D <= 48 ? 32 : BT;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const int BK = blockDim.x / 2;  // 64 keys per warpgroup, 16 per warp
  const unsigned Ks = (raw + 1023u) & ~1023u;   // [AT][BK][64]
  const unsigned Vs = Ks + AT * BK * 128;       // [AT][BK][64]
  const unsigned Qs = Vs + AT * BK * 128;       // [STAGES][AT][64][64]
  const unsigned Os = Qs + STAGES * AT * TILE;  // dO, [STAGES][AT][64][64]
  unsigned char* k_ptr = smem_raw + (Ks - raw);
  unsigned char* v_ptr = smem_raw + (Vs - raw);
  float* strip = reinterpret_cast<float*>(smem_raw + (Os + STAGES * AT * TILE - raw));

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int kb = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), wg = warp / 4;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16;  // this warp's keys of the block

  copy_rows<ND>(Ks, static_cast<const bf16*>(a.k) + kb * a.k_bs + (long long)h * D, a.k_rs, k0,
                BK, a.Lk);
  copy_rows<ND>(Vs, static_cast<const bf16*>(a.v) + kb * a.v_bs + (long long)h * D, a.v_rs, k0,
                BK, a.Lk);
  cp_async_commit();

  // the pixel coordinates of this thread's two keys: r0 + g and r0 + g + 8
  float kx[2] = {0.f, 0.f}, ky[2] = {0.f, 0.f};
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = k0 + r0 + g + 8 * i;
      if (m < a.Lk) kx[i] = a.coords[m], ky[i] = a.coords[(long long)a.Lk + m];
    }
  }
  const float scale2 = a.scale * LOG2E;
  const int tiles = (a.Lq + BT - 1) / BT;

  float dk[32], dv[32];  // W / 2 values a thread each
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;

  const bool routed = a.kv_index != nullptr;
  const int b_end = routed ? a.B : kb + 1;
  for (int b = routed ? 0 : kb; b < b_end; ++b) {
    if (routed) {
      // the same for every thread of the block, and known so to the compiler
      const int src = __shfl_sync(0xffffffffu, a.kv_index[b], 0);
      if (src != kb) continue;
    }
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_bs + (long long)h * D;
    const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.do_bs + (long long)h * D;
    const float* lse_b = a.lse + ((long long)b * a.H + h) * a.Lq;
    const float* delta_b = a.delta + ((long long)b * a.H + h) * a.Lq;
    const float band_b = HAS_BIAS ? a.band[b] : 0.f;
    const float alpha2 = HAS_BIAS ? a.alpha[b] * LOG2E : 0.f;

    auto copy_q = [&](int t) {
      const int st = t % STAGES, q0 = t * BT;
      copy_rows<ND>(Qs + st * AT * TILE, qb, a.q_rs, q0, BT, a.Lq);
      copy_rows<ND>(Os + st * AT * TILE, ob, a.do_rs, q0, BT, a.Lq);
      // strip rows: lse, delta, then the line coefficients a, b, c
      for (int i = threadIdx.x; i < (HAS_BIAS ? STRIP : 2 * BT); i += blockDim.x) {
        const int n = q0 + i % BT, j = i / BT;
        const bool ok = n < a.Lq;
        const float* src = j == 0 ? lse_b + n
                           : j == 1 ? delta_b + n
                                    : a.lines + ((long long)b * a.Lq + n) * 3 + (j - 2);
        cp_async(strip + st * STRIP + i, ok ? src : lse_b, ok, 4);
      }
      cp_async_commit();
    };

    __syncthreads();  // every warp is done with the ring of the previous row
    copy_q(0);
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait_all();
      fence_proxy_async();  // the copies are visible to wgmma
      __syncthreads();      // tile t has landed; every warp is done with tile t - 1
      if (t + 1 < tiles) copy_q(t + 1);
      const unsigned Qt = Qs + (t % STAGES) * AT * TILE;
      const unsigned Ot = Os + (t % STAGES) * AT * TILE;
      const float* sp = strip + (t % STAGES) * STRIP;
      const int q0 = t * BT;

      const bool ragged = q0 + BT > a.Lq;
#pragma unroll
      for (int half = 0; half < BT / QH; ++half) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys of the warpgroup x QH queries;
        // [4 j + e]: column block j of 8 queries, e = 0, 1 key g, e = 2, 3 key g + 8
        float st[QH / 2], dpt[QH / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss<QH>(st, smem_desc(Ks + (ks / 4) * BK * 128 + wg * TILE + 32 * (ks % 4)),
                     smem_desc(Qt + (ks / 4) * TILE + half * QH * 128 + 32 * (ks % 4)), ks != 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss<QH>(dpt, smem_desc(Vs + (ks / 4) * BK * 128 + wg * TILE + 32 * (ks % 4)),
                     smem_desc(Ot + (ks / 4) * TILE + half * QH * 128 + 32 * (ks % 4)), ks != 0);
        wgmma_commit();
        wgmma_wait_all();

        // P^T and dS^T on the fragment; the per-query values lie along its columns
#pragma unroll
        for (int j = 0; j < QH / 8; ++j) {
          const int col = half * QH + 8 * j + 2 * c;
          const float2 ls = *reinterpret_cast<const float2*>(sp + col);
          const float2 de = *reinterpret_cast<const float2*>(sp + BT + col);
          const float lse2[2] = {ls.x * LOG2E, ls.y * LOG2E};
          const float dl[2] = {de.x, de.y};
          float la[3][2] = {};
          if constexpr (HAS_BIAS) {
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const float2 l = *reinterpret_cast<const float2*>(sp + (2 + jj) * BT + col);
              la[jj][0] = l.x, la[jj][1] = l.y;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, cc = e & 1;
            float val = fmaf(st[4 * j + e], scale2, -lse2[cc]);
            if constexpr (HAS_BIAS) {
              const float dist = fabsf(la[0][cc] * kx[i] + la[1][cc] * ky[i] + la[2][cc]);
              val -= fmaxf(dist - band_b, 0.f) * alpha2;
            }
            float p = fast_exp2(val);
            if (ragged && q0 + col + cc >= a.Lq) p = 0.f;
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - dl[cc]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: A from the registers, the dO and Q tiles
        // read transposed (rows = the queries). Every fragment is packed before
        // the first product starts: with the conversions between the two
        // chains of products ptxas serializes them (remark C7520)
        uint32_t pf[QH / 16][4], df[QH / 16][4];
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pf[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
            df[kk][x] = pack_bf16(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk) {
          const unsigned rows = ATOM * TILE + (half * (QH / 16) + kk) * 2048;
          wgmma_rs<W>(dv, pf[kk], smem_desc(Ot + rows));
          wgmma_rs<W>(dk, df[kk], smem_desc(Qt + rows));
        }
        wgmma_commit();
        wgmma_wait_all();
      }
    }
  }

  // dK (scaled) and dV go through this warp's own rows of the K and V tiles,
  // then out in 16-byte pieces; a source row no query is routed to gets zeros
  cp_async_wait_all();
  __syncthreads();  // the K / V tiles have landed and every warp is done with them
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      const unsigned off = ATOM * BK * 128 + swz(r, j) + 4 * c;
      *reinterpret_cast<uint32_t*>(k_ptr + off) =
          pack_bf16(dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(v_ptr + off) = pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  __syncwarp();
  const long long C = (long long)a.H * D;
  const long long obase = (long long)kb * a.Lk * C + (long long)h * D + 64 * ATOM;
  bf16* dkb = static_cast<bf16*>(a.dk) + obase;
  bf16* dvb = static_cast<bf16*>(a.dv) + obase;
  for (int idx = lane; idx < 16 * (W / 8); idx += 32) {
    const int r = r0 + idx / (W / 8), ch = idx % (W / 8);
    const int m = k0 + r;
    if (m < a.Lk) {
      const unsigned off = ATOM * BK * 128 + swz(r, ch);
      *reinterpret_cast<uint4*>(dkb + m * C + ch * 8) = *reinterpret_cast<const uint4*>(k_ptr + off);
      *reinterpret_cast<uint4*>(dvb + m * C + ch * 8) = *reinterpret_cast<const uint4*>(v_ptr + off);
    }
  }
}

template <bool HAS_BIAS, int ND, int ATOM>
cudaError_t launch_dkdv_bf16(const Args& a, cudaStream_t stream) {
  auto kernel = epi_flash_bwd_dkdv_bf16_kernel<HAS_BIAS, ND, ATOM>;
  const int bk = a.Lk >= 128 ? 128 : 64;  // two warpgroups, or one
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkdv_bytes<ND>(128));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Lk + bk - 1) / bk, a.H, a.Bk), 2 * bk, dkdv_bytes<ND>(bk), stream>>>(a);
  return cudaGetLastError();
}

template <bool HAS_BIAS, int ND>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_dkdv_bf16<HAS_BIAS, ND, 0>(a, stream);
  if constexpr (Tile<ND>::AT > 1) {
    if (err == cudaSuccess) err = launch_dkdv_bf16<HAS_BIAS, ND, 1>(a, stream);
  }
  if constexpr (Tile<ND>::AT > 2) {
    if (err == cudaSuccess) err = launch_dkdv_bf16<HAS_BIAS, ND, 2>(a, stream);
  }
  if (err != cudaSuccess) return err;
  auto kernel = epi_flash_bwd_dq_bf16_kernel<HAS_BIAS, ND>;
  const int bq = a.Lq >= 128 ? 128 : 64;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes<ND>(128));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Lq + bq - 1) / bq, a.H, a.B), 2 * bq, dq_bytes<ND>(bq), stream>>>(a);
  return cudaGetLastError();
}

// head_dim in eighths: 8, 16, 32, 40, 48, 64, 80, 96, 128, 160
template <bool HAS_BIAS>
cudaError_t dispatch_bf16(const Args& a, cudaStream_t stream) {
#define EPI_CASE(nd) \
  case nd:           \
    return launch_bf16<HAS_BIAS, nd>(a, stream);
  if (a.D % 8) return cudaErrorInvalidValue;
  switch (a.D / 8) {
    EPI_CASE(1)
    EPI_CASE(2)
    EPI_CASE(4)
    EPI_CASE(5)
    EPI_CASE(6)
    EPI_CASE(8)
    EPI_CASE(10)
    EPI_CASE(12)
    EPI_CASE(16)
    EPI_CASE(20)
    default:
      return cudaErrorInvalidValue;
  }
#undef EPI_CASE
}

// ---------------------------------------------------------------------------
// f32: tiled kernels with f32 FMAs; S, dP and the accumulators in shared memory
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;  // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int DP>
struct Layout {
  static constexpr int LDT = DP + 1;  // q/k/v/dO tiles
  static constexpr int LDS = BT + 4;  // S and dP tiles; P and dS stay in place
  static constexpr int LDO = DP + 4;  // accumulators
  static constexpr int TILE_BYTES = align128(BT * LDT * 4);
  static constexpr int SBUF = align128(BT * LDS * 4);
  static constexpr int ACC = align128(BT * LDO * 4);
  static constexpr int GEOM = align128((3 * BT + 2 * BT + 2 * BT) * 4);
  // dkdv: K, V, Q, dO tiles; S, dP; dK, dV accumulators; geometry
  static constexpr int DKDV_BYTES = 4 * TILE_BYTES + 2 * SBUF + 2 * ACC + GEOM;
  // dq: Q, dO, K, V tiles; S, dP; dQ accumulator; geometry
  static constexpr int DQ_BYTES = 4 * TILE_BYTES + 2 * SBUF + ACC + GEOM;
};

// rows [n0, n0+64) of a [L, *] slab (row stride rs, head columns at src),
// columns [0, DP) with zeros beyond D and beyond L
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs, int n0,
                                          int L, int D) {
  constexpr int LD = Layout<DP>::LDT;
  constexpr int CHUNKS = DP / 4;
  for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    const int n = n0 + r;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < L && c < D) raw = *reinterpret_cast<const float4*>(src + (long long)n * rs + c);
    dst[r * LD + c] = raw.x, dst[r * LD + c + 1] = raw.y;
    dst[r * LD + c + 2] = raw.z, dst[r * LD + c + 3] = raw.w;
  }
}

// C[r0:r0+16, 0:64] (row stride LDS) = A[r0:r0+16, 0:DP] B[0:64, 0:DP]^T
template <int DP>
__device__ __forceinline__ void warp_abt(const float* A, const float* B, float* C, int r0,
                                         int lane) {
  using Lt = Layout<DP>;
  for (int rr = 0; rr < 16; ++rr) {
    const float* arow = A + (r0 + rr) * Lt::LDT;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      const float* brow = B + c * Lt::LDT;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(arow[d], brow[d], acc);
      C[(r0 + rr) * Lt::LDS + c] = acc;
    }
  }
}

// Acc[r0:r0+16, 0:DP] (LDO) += A[r0:r0+16, 0:64] (row stride LDS) B[0:64, 0:DP]
template <int DP>
__device__ __forceinline__ void warp_ab_acc(const float* A, const float* B, float* Acc, int r0,
                                            int lane) {
  using Lt = Layout<DP>;
  for (int rr = 0; rr < 16; ++rr) {
    const float* arow = A + (r0 + rr) * Lt::LDS;
    for (int d = lane; d < DP; d += 32) {
      float acc = Acc[(r0 + rr) * Lt::LDO + d];
#pragma unroll 8
      for (int c = 0; c < BT; ++c) acc = fmaf(arow[c], B[c * Lt::LDT + d], acc);
      Acc[(r0 + rr) * Lt::LDO + d] = acc;
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

template <bool HAS_BIAS, int DP>
__global__ void __launch_bounds__(THREADS) epi_flash_bwd_dkdv_f32_kernel(Args a) {
  using Lt = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + Lt::TILE_BYTES);
  float* Qs = reinterpret_cast<float*>(smem + 2 * Lt::TILE_BYTES);
  float* Os = reinterpret_cast<float*>(smem + 3 * Lt::TILE_BYTES);  // dO
  float* Ss = reinterpret_cast<float*>(smem + 4 * Lt::TILE_BYTES);  // S, then P
  float* Dp = reinterpret_cast<float*>(smem + 4 * Lt::TILE_BYTES + Lt::SBUF);  // dP, then dS
  unsigned char* abase = smem + 4 * Lt::TILE_BYTES + 2 * Lt::SBUF;
  float* dKa = reinterpret_cast<float*>(abase);
  float* dVa = reinterpret_cast<float*>(abase + Lt::ACC);
  float* La = reinterpret_cast<float*>(abase + 2 * Lt::ACC);  // [3][BT]
  float* Kx = La + 3 * BT;                                     // [2][BT]
  float* Ls = Kx + 2 * BT;                                     // [BT]
  float* Dl = Ls + BT;                                         // [BT]

  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int kb = blockIdx.z;  // a source row of k/v
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 keys
  const long long col = (long long)h * a.D;

  load_tile<DP>(Ks, static_cast<const float*>(a.k) + kb * a.k_bs + col, a.k_rs, k0, a.Lk, a.D);
  load_tile<DP>(Vs, static_cast<const float*>(a.v) + kb * a.v_bs + col, a.v_rs, k0, a.Lk, a.D);
  load_key_coords<HAS_BIAS>(Kx, a.coords, k0, a.Lk);
  for (int i = threadIdx.x; i < BT * Lt::LDO; i += THREADS) dKa[i] = dVa[i] = 0.f;

  // every query row b routed to kb, in order of b (none: dk = dv = 0)
  const bool routed = a.kv_index != nullptr;
  const int b_end = routed ? a.B : kb + 1;
  for (int b = routed ? 0 : kb; b < b_end; ++b) {
    if (routed && a.kv_index[b] != kb) continue;  // the same for the whole block
    const float band_b = HAS_BIAS ? a.band[b] : 0.f;
    const float alpha_b = HAS_BIAS ? a.alpha[b] : 0.f;
    const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + col;
    const float* ob = static_cast<const float*>(a.dout) + b * a.do_bs + col;

    for (int q0 = 0; q0 < a.Lq; q0 += BT) {
      __syncthreads();  // every warp is done with the previous q-tile
      load_tile<DP>(Qs, qb, a.q_rs, q0, a.Lq, a.D);
      load_tile<DP>(Os, ob, a.do_rs, q0, a.Lq, a.D);
      load_query_rows<HAS_BIAS>(La, Ls, Dl, a.lines, a.lse, a.delta, b, b * a.H + h, q0, a.Lq);
      __syncthreads();

      warp_abt<DP>(Ks, Qs, Ss, r0, lane);  // S^T [key][query]
      warp_abt<DP>(Vs, Os, Dp, r0, lane);  // dP^T [key][query]
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
          Ss[r * Lt::LDS + c] = p;
          Dp[r * Lt::LDS + c] = ds;
        }
      }
      __syncwarp();
      warp_ab_acc<DP>(Ss, Os, dVa, r0, lane);  // dV += P^T dO
      warp_ab_acc<DP>(Dp, Qs, dKa, r0, lane);  // dK += dS^T Q
    }
  }
  __syncthreads();  // the zeroed accumulators, where no row is routed to kb

  const long long C = (long long)a.H * a.D;
  float* dkb = static_cast<float*>(a.dk) + (long long)kb * a.Lk * C + col;
  float* dvb = static_cast<float*>(a.dv) + (long long)kb * a.Lk * C + col;
  for (int rr = 0; rr < 16; ++rr) {
    const int m = k0 + r0 + rr;
    if (m >= a.Lk) break;
    for (int d = lane; d < a.D; d += 32) {
      dkb[m * C + d] = dKa[(r0 + rr) * Lt::LDO + d] * a.scale;
      dvb[m * C + d] = dVa[(r0 + rr) * Lt::LDO + d];
    }
  }
}

template <bool HAS_BIAS, int DP>
__global__ void __launch_bounds__(THREADS) epi_flash_bwd_dq_f32_kernel(Args a) {
  using Lt = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = reinterpret_cast<float*>(smem + Lt::TILE_BYTES);  // dO
  float* Ks = reinterpret_cast<float*>(smem + 2 * Lt::TILE_BYTES);
  float* Vs = reinterpret_cast<float*>(smem + 3 * Lt::TILE_BYTES);
  float* Ss = reinterpret_cast<float*>(smem + 4 * Lt::TILE_BYTES);
  float* Dp = reinterpret_cast<float*>(smem + 4 * Lt::TILE_BYTES + Lt::SBUF);  // dP, then dS
  unsigned char* abase = smem + 4 * Lt::TILE_BYTES + 2 * Lt::SBUF;
  float* dQa = reinterpret_cast<float*>(abase);
  float* La = reinterpret_cast<float*>(abase + Lt::ACC);  // [3][BT]
  float* Kx = La + 3 * BT;                                // [2][BT]
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

  load_tile<DP>(Qs, static_cast<const float*>(a.q) + b * a.q_bs + col, a.q_rs, q0, a.Lq, a.D);
  load_tile<DP>(Os, static_cast<const float*>(a.dout) + b * a.do_bs + col, a.do_rs, q0, a.Lq,
                a.D);
  load_query_rows<HAS_BIAS>(La, Ls, Dl, a.lines, a.lse, a.delta, b, b * a.H + h, q0, a.Lq);
  for (int i = threadIdx.x; i < BT * Lt::LDO; i += THREADS) dQa[i] = 0.f;
  const float band_b = HAS_BIAS ? a.band[b] : 0.f;
  const float alpha_b = HAS_BIAS ? a.alpha[b] : 0.f;
  const float* kbase = static_cast<const float*>(a.k) + kb * a.k_bs + col;
  const float* vbase = static_cast<const float*>(a.v) + kb * a.v_bs + col;

  for (int k0 = 0; k0 < a.Lk; k0 += BT) {
    __syncthreads();  // every warp is done with the previous k-tile
    load_tile<DP>(Ks, kbase, a.k_rs, k0, a.Lk, a.D);
    load_tile<DP>(Vs, vbase, a.v_rs, k0, a.Lk, a.D);
    load_key_coords<HAS_BIAS>(Kx, a.coords, k0, a.Lk);
    __syncthreads();

    warp_abt<DP>(Qs, Ks, Ss, r0, lane);  // S [query][key]
    warp_abt<DP>(Os, Vs, Dp, r0, lane);  // dP [query][key]
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
        Dp[r * Lt::LDS + c] = p * (Dp[r * Lt::LDS + c] - Dl[r]);
      }
    }
    __syncwarp();
    warp_ab_acc<DP>(Dp, Ks, dQa, r0, lane);  // dQ += dS K
  }
  __syncwarp();

  const long long C = (long long)a.H * a.D;
  float* dqb = static_cast<float*>(a.dq) + (long long)b * a.Lq * C + col;
  for (int rr = 0; rr < 16; ++rr) {
    const int n = q0 + r0 + rr;
    if (n >= a.Lq) break;
    for (int d = lane; d < a.D; d += 32) dqb[n * C + d] = dQa[(r0 + rr) * Lt::LDO + d] * a.scale;
  }
}

template <bool HAS_BIAS, int DP>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  using Lt = Layout<DP>;
  if constexpr (Lt::DKDV_BYTES > 232448) {
    return cudaErrorInvalidValue;  // head_dim too wide for the f32 path
  } else {
    auto dkdv = epi_flash_bwd_dkdv_f32_kernel<HAS_BIAS, DP>;
    auto dq = epi_flash_bwd_dq_f32_kernel<HAS_BIAS, DP>;
    cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Lt::DKDV_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::DQ_BYTES);
    if (err != cudaSuccess) return err;
    dkdv<<<dim3((a.Lk + BT - 1) / BT, a.H, a.Bk), THREADS, Lt::DKDV_BYTES, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq<<<dim3((a.Lq + BT - 1) / BT, a.H, a.B), THREADS, Lt::DQ_BYTES, stream>>>(a);
    return cudaGetLastError();
  }
}

template <bool HAS_BIAS>
cudaError_t dispatch_f32(const Args& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16 * 16) {
    case 16: return launch_f32<HAS_BIAS, 16>(a, stream);
    case 32: return launch_f32<HAS_BIAS, 32>(a, stream);
    case 48: return launch_f32<HAS_BIAS, 48>(a, stream);
    case 64: return launch_f32<HAS_BIAS, 64>(a, stream);
    case 80: return launch_f32<HAS_BIAS, 80>(a, stream);
    case 96: return launch_f32<HAS_BIAS, 96>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. delta [B, H, Lq] f32 from dout and the
// forward's out, both [B, Lq, H * D] with strides in elements. Returns the
// cudaError_t of the launch.
extern "C" int epi_flash_bwd_delta(int dtype, const void* dout, const void* out,
                                   long long do_bs, long long do_rs, long long o_bs,
                                   long long o_rs, void* delta, int B, int H, int Lq, int D,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * Lq * H;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (dtype == 0)
    epi_flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(out), do_bs, do_rs, o_bs,
        o_rs, static_cast<float*>(delta), B, H, Lq, D);
  else if (dtype == 1)
    epi_flash_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(out), do_bs, do_rs, o_bs,
        o_rs, static_cast<float*>(delta), B, H, Lq, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. kv_index may be null (identity routing);
// lines/coords/band/alpha are read only when has_bias. Strides in elements.
// lse and delta are [B, H, Lq] f32. dq [B, Lq, C], dk and dv are contiguous,
// in the input type: dk/dv are [Bk, Lk, C], the gradients of the Bk source
// rows of k/v, every routed query row added in by the kernel in order of b
// (zeros for a row no query is routed to). Returns the cudaError_t of the
// launches.
extern "C" int epi_flash_bwd(int dtype, int has_bias, const void* q, const void* k,
                             const void* v, const void* dout, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long do_bs, long long do_rs, const void* kv_index,
                             const void* lines, const void* coords, const void* band,
                             const void* alpha, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, int B, int Bk, int H, int Lq, int Lk, int D,
                             float scale, void* stream) {
  Args a{q, k, v, dout, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs,
         static_cast<const int*>(kv_index), static_cast<const float*>(lines),
         static_cast<const float*>(coords), static_cast<const float*>(band),
         static_cast<const float*>(alpha), static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, Bk, H, Lq, Lk, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = has_bias ? dispatch_f32<true>(a, s) : dispatch_f32<false>(a, s);
  else if (dtype == 1)
    err = has_bias ? dispatch_bf16<true>(a, s) : dispatch_bf16<false>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
