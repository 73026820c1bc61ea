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
// What bounds it on the H100 (bf16, T 65,536 tokens, C 320, K 2,560): 2*T*C*K
// = 107.4 GFLOP is 0.109 ms on the tensor cores (989 TFLOP/s); reading x
// and W' once and writing out once is 379 MB, 0.113 ms at 3.35 TB/s. The
// two bounds meet: the reduction is short and the output is 88% of the
// bytes. So the panel design reads x exactly once, never writes the normalized
// tokens or their statistics to device memory, keeps the tensor cores on
// wgmma, and writes the output in whole 16-byte row pieces.
//
// Wider tokens (C 1280, T 16,384, K 10,240: 429 GFLOP, 0.434 ms on the tensor
// cores against 0.112 ms of device memory) are bound by the products, and
// then by the bytes each SM has to take in per product: a 64-row panel (all
// that fits at C 1280) takes in the whole W' for every 64 tokens. So C > 320
// takes the wide design below, whose tiles hold 128 tokens; it is also
// faster than the 128-row panel at C 640, where W' tiles were 64 wide.
//
// Design of the bf16 path up to C 320 (ln_matmul_bf16_kernel<PANEL, TNW>,
// instantiated as <128, 128>):
//  * a block owns a PANEL of tokens held whole in shared memory: 128 rows
//    (80 KB at C 320). The panel is copied in once with cp.async, mean and
//    1/std are taken from the shared copy
//    (eight lanes per token, f32, two passes over registers, as
//    _standardize does), and the panel is standardized in place once,
//    rounded to bf16 as the TPU kernel casts x_hat to the weight type. No
//    stats kernel, no stats scratch.
//  * the block then walks over the column tiles of W' (TNW 128 wide; the
//    template takes 64 for a wider panel). W' [K, C] is
//    already the K-major B operand; a tile streams in 64-channel pieces
//    through a ring of 4 stages filled by cp.async, two pieces ahead of the
//    products (W' is a few MB and stays in L2).
//  * instruction: wgmma.mma_async m64n128k16 / m64n64k16, bf16 in, f32
//    accumulators in registers, both operands read from shared memory
//    through descriptors. Panel and ring use the 128-byte swizzle (16-byte
//    piece index XOR row mod 8 inside each 128-byte row of 64 channels),
//    written by hand by the cp.async copies and by the in-place
//    standardization, so neither the copies, the statistics nor wgmma meet
//    bank conflicts. One product group stays in flight while the next piece
//    is awaited.
//  * two warpgroups, each on its own: they take the block's column tiles in
//    turns, each with its own ring and its own named barrier, over all rows
//    of the panel. Warpgroup 1 starts half a tile late, so that one's
//    epilogue and waits fall under the other's products.
//  * epilogue from registers: + b', round to bf16, a 4x4 exchange among
//    the four lanes that share a row so that each lane holds 8 neighbouring
//    outputs, one 16-byte store per lane: a row's four lanes write 64
//    contiguous bytes. The stores are fire-and-forget.
//  * few tokens (the deep UNet levels): the column tiles are split over
//    gridDim.y so that the card is filled; a block then standardizes its
//    panel again for its share of the tiles (x is small there). At the
//    main-path shape gridDim.y is 1 and x is read from device memory once.
//  * what the compiler needs: the warp and warpgroup index come from
//    __shfl_sync, so that the per-warpgroup loops are uniform to it, and the
//    tile and piece loops are nested; otherwise ptxas serializes the wgmma
//    instructions (remarks C7517 / C7518 under -Xptxas -v).
// In shared memory: the panel, the two W' rings. In registers: the
// accumulators, the folded bias of the lane's columns. Compiled with
// -DLNMM_PROF the kernel adds up clock cycles per phase (panel copy,
// standardization, product loop, epilogue, waits), read back through
// ln_matmul_prof; scripts/kernel_check.py prints them.
//
// Design of the bf16 path above C 320 (ln_matmul_bf16_kernel_wide_stats,
// then ln_matmul_bf16_kernel_wide):
//  * a first kernel takes mean and 1/std of every token (f32, a warp per
//    token, two passes over registers) into a [T, 2] f32 scratch.
//  * tiles of 128 tokens x 256 columns. A block owns one column tile and
//    walks a share of the 128-row blocks in order, so that the blocks of one
//    share read the same x rows at about the same time (from L2) and each
//    W' tile read feeds 128 tokens. The grid is the card's SMs, about.
//  * x and W' both stream in 64-channel pieces (16 + 32 KB, 128-byte
//    swizzle) through a ring of 4 stages filled by TMA: one thread of a
//    producer warpgroup issues the copies, an mbarrier per stage says that
//    the bytes have landed, another that both consumer warpgroups are done
//    with it. The producer warpgroup hands its registers to the consumers
//    (setmaxnreg 40 / 232).
//  * each consumer warpgroup takes 64 of the rows: it reads its lanes' x
//    values of a piece from shared memory in the layout of wgmma's
//    register A operand, standardizes them with the rows' statistics and
//    rounds them to bf16 (the arithmetic of the panel path), then runs
//    wgmma m64n256k16 with A from registers and the W' piece, shared by both
//    warpgroups, from shared memory. Epilogue as above, + b' read at the end.
//  What bounds it now: streaming the pieces in, 48 KB for 4.2 MFLOP (as
//  many bytes per product as cuBLAS's 256 x 128 tiles); with the products
//  taken out it runs as long, and neither more blocks nor x shared across a
//  cluster moved it. The statistics read x once more. The tensor maps are
//  built on the host at each launch and passed by value (__grid_constant__);
//  cuTensorMapEncodeTiled is looked up at run time (cudaGetDriverEntryPoint),
//  so the library links nothing new.
//
// The f32 path (full-f32 products, as the CPU tests and the card-vs-CPU
// checks need) stays the simple pair below: ln_stats (a warp per token)
// and a 64x64 tiled FMA product that standardizes while staging.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64, BN = 64, BKC = 32;
constexpr int THREADS = 128;


__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the eight lanes of an octet
__device__ __forceinline__ float oct_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: token panel in shared memory, wgmma over streamed W' tiles
// ---------------------------------------------------------------------------

constexpr int KC = 64;                  // channels per piece: one 128-byte swizzled row
constexpr int RING = 4;                 // W' stages of a warpgroup
constexpr int W_THREADS = 256;          // two warpgroups

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// writes of this thread to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// K-major operand with 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO), start address and offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 128)
    wgmma_m64n128k16(d, a, b, scale_d);
  else
    wgmma_m64n64k16(d, a, b, scale_d);
}

// byte offset of the 16-byte piece `piece` (0..7) of row r in a swizzled
// [rows][64] bf16 block
__device__ __forceinline__ unsigned swz(int r, int piece) {
  return r * 128 + ((piece ^ (r & 7)) << 4);
}

// lane c of a quad holds v[j] = its two outputs of column block j (j = 0..3);
// afterwards v[s] = lane s's two outputs of column block c: 8 neighbouring
// outputs of one block. Two butterfly steps: with lane c ^ 2 the halves
// {0, 1} / {2, 3} of the blocks, with lane c ^ 1 the block of the half.
__device__ __forceinline__ void quad_exchange(uint32_t (&v)[4], int c) {
  const bool hi2 = c & 2, hi1 = c & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 2);
  const uint32_t k0 = hi2 ? v[2] : v[0], k1 = hi2 ? v[3] : v[1];
  // blocks (b, b + 1) of this lane's half, from lane c & 1 (a) and (c & 1) + 2 (b)
  const uint32_t a0 = hi2 ? r0 : k0, a1 = hi2 ? r1 : k1;
  const uint32_t b0 = hi2 ? k0 : r0, b1 = hi2 ? k1 : r1;
  const uint32_t t0 = __shfl_xor_sync(0xffffffffu, hi1 ? a0 : a1, 1);
  const uint32_t t1 = __shfl_xor_sync(0xffffffffu, hi1 ? b0 : b1, 1);
  const uint32_t m0 = hi1 ? a1 : a0, m1 = hi1 ? b1 : b0;
  v[0] = hi1 ? t0 : m0;
  v[1] = hi1 ? m0 : t0;
  v[2] = hi1 ? t1 : m1;
  v[3] = hi1 ? m1 : t1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

#ifdef LNMM_PROF
__device__ unsigned long long g_prof[8];
#define PROF_MARK(i)                                                        \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      const long long now = clock64();                                      \
      atomicAdd(&g_prof[i], (unsigned long long)(now - prof_last));         \
      prof_last = now;                                                      \
    }                                                                       \
  } while (0)
#define PROF_T0() prof_t0 = clock64()
#define PROF_ADD(i) \
  if (threadIdx.x == 0) atomicAdd(&g_prof[i], (unsigned long long)(clock64() - prof_t0))
#else
#define PROF_MARK(i)
#define PROF_T0()
#define PROF_ADD(i)
#endif

template <int PANEL, int TNW>
__global__ void __launch_bounds__(W_THREADS, 1) ln_matmul_bf16_kernel(
    const bf16* __restrict__ x, long long x_rs, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, long long o_rs, int rows, int C,
    int K, float eps, int tiles_per_block) {
  constexpr int MH = PANEL / 64;           // 64-row halves of the panel
  constexpr int STAGE = TNW * KC * 2;      // bytes of one W' piece
  // 16-byte pieces of a token per lane of its octet: C <= 320, 640, 1280
  constexpr int MAX_PIECES = PANEL == 64 ? 20 : (TNW == 128 ? 5 : 10);
#ifdef LNMM_PROF
  long long prof_last = clock64(), prof_t0 = 0;
  if (threadIdx.x == 0) atomicAdd(&g_prof[0], 1ull);
#endif
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const int tid = threadIdx.x, lane = tid % 32;
  // warp and warpgroup as values the compiler knows to be uniform in a warp:
  // the per-warpgroup loops below must not look divergent to it, or it
  // serializes the wgmma instructions
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const int wtid = tid % 128;  // thread of the warpgroup
  const unsigned rings = (raw + 1023u) & ~1023u;     // [2][RING][TNW][64] swizzled
  const unsigned ring = rings + wg * RING * STAGE;   // this warpgroup's ring
  const unsigned panel = rings + 2 * RING * STAGE;   // [CB][PANEL][64] swizzled
  unsigned char* panel_ptr = smem_raw + (panel - raw);

  const int CB = (C + KC - 1) / KC;
  const int m0 = blockIdx.x * PANEL;
  const int ntiles = (K + TNW - 1) / TNW;
  const int tile_begin = blockIdx.y * tiles_per_block;
  const int tile_end = min(ntiles, tile_begin + tiles_per_block);
  if (tile_begin >= tile_end) return;
  // the warpgroups take the block's column tiles in turns
  const int my_tiles = (tile_end - tile_begin - wg + 1) / 2;
  const int iters = my_tiles * CB;

  // piece `it` of this warpgroup: 64 channels of one column tile of W'
  int w_tile = tile_begin + wg, w_kc = 0;  // the piece the next load_w brings
  auto load_w = [&](int it) {
    if (it < iters) {
      const int n0 = w_tile * TNW, k0 = w_kc * KC;
      const unsigned dst = ring + (it % RING) * STAGE;
#pragma unroll
      for (int i = 0; i < TNW * 8 / 128; ++i) {
        const int idx = wtid + i * 128;
        const int r = idx >> 3, piece = idx & 7;
        const int n = n0 + r, col = k0 + piece * 8;
        const bool ok = n < K && col < C;
        cp_async16(dst + swz(r, piece), ok ? w + (long long)n * C + col : w, ok);
      }
      if (++w_kc == CB) w_kc = 0, w_tile += 2;
    }
    cp_async_commit();
  };

  // the token panel, zeros outside the matrix
  for (int idx = tid; idx < PANEL * CB * 8; idx += W_THREADS) {
    const int r = idx / (CB * 8), ch = idx % (CB * 8);
    const bool ok = m0 + r < rows && ch * 8 < C;
    cp_async16(panel + (ch >> 3) * PANEL * 128 + swz(r, ch & 7),
               ok ? x + (long long)(m0 + r) * x_rs + ch * 8 : x, ok);
  }
  cp_async_commit();
  load_w(0);
  load_w(1);
  cp_async_wait<2>();
  __syncthreads();
  PROF_MARK(1);

  // standardize the panel in place: eight lanes per token (four tokens a
  // warp at a time), f32, two passes over the token's 16-byte pieces, which
  // the lanes hold in registers (C <= 1280: 20 a lane). Rows outside the
  // matrix are zeros and stay zeros.
  {
    const int l8 = lane & 7, pieces = C / 8;
    for (int r = warp * 4 + (lane >> 3); r < PANEL; r += W_THREADS / 32 * 4) {
      unsigned char* rowp = panel_ptr + r * 128 + ((l8 ^ (r & 7)) << 4);
      uint4 v[MAX_PIECES];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_PIECES; ++i) {
        if (l8 + 8 * i < pieces) {
          v[i] = *reinterpret_cast<const uint4*>(rowp + i * PANEL * 128);
          const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
        }
      }
      const float mean = oct_sum(s) / C;
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_PIECES; ++i) {
        if (l8 + 8 * i < pieces) {
          const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = __bfloat162float(e[j]) - mean;
            s2 += d * d;
          }
        }
      }
      const float rstd = 1.f / sqrtf(oct_sum(s2) / C + eps);
#pragma unroll
      for (int i = 0; i < MAX_PIECES; ++i) {
        if (l8 + 8 * i < pieces) {
          bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16((__bfloat162float(e[j]) - mean) * rstd);
          *reinterpret_cast<uint4*>(rowp + i * PANEL * 128) = v[i];
        }
      }
    }
  }
  fence_proxy_async();  // the standardized panel is visible to wgmma
  __syncthreads();
  PROF_MARK(2);

  // from here on the warpgroups run on their own: own tiles, own ring, own
  // barrier, so one's epilogue and waits hide behind the other's products
  const int g = lane >> 2, c = lane & 3;
  float acc[MH][TNW / 2];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int i = 0; i < TNW / 2; ++i) acc[h][i] = 0.f;
  float2 bj[TNW / 8];  // the folded bias of this lane's columns of the tile

  // Warpgroup 1 starts its first tile when warpgroup 0 has issued the
  // products of its first (barrier 3: 128 threads wait, 128 arrive). From
  // then on they run half a tile apart, so that one's epilogue falls under
  // the other's products and not under the other's epilogue.
  int it = 0;
  for (int tile = tile_begin + wg; tile < tile_end; tile += 2) {
    // read early, used in the tile's epilogue
#pragma unroll
    for (int j = 0; j < TNW / 8; ++j) {
      const int col = tile * TNW + 8 * j + 2 * c;
      bj[j] = col < K ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
    }
    if (wg == 1 && it == 0) bar_sync(3, W_THREADS);
    for (int kc = 0; kc < CB; ++kc, ++it) {
      PROF_T0();
      cp_async_wait<1>();   // piece `it` has landed (piece it + 1 may be in flight)
      fence_proxy_async();  // ... and is visible to wgmma
      // every warp of the warpgroup is past the products of piece it - 2
      bar_sync(1 + wg, 128);
      PROF_ADD(5);
      load_w(it + 2);
      const unsigned a = panel + kc * PANEL * 128;
      const unsigned b = ring + (it % RING) * STAGE;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < KC / 16; ++k16)
#pragma unroll
        for (int h = 0; h < MH; ++h)
          wgmma_k16<TNW>(acc[h], smem_desc(a + h * 64 * 128 + 32 * k16),
                         smem_desc(b + 32 * k16), (kc | k16) != 0);
      wgmma_commit();
      PROF_T0();
      wgmma_wait<1>();  // the products of piece it - 1 are done
      PROF_ADD(6);
    }
    if (wg == 0 && it == CB) bar_arrive(3, W_THREADS);
    PROF_T0();
    wgmma_wait<0>();
    PROF_ADD(6);

    // epilogue of this tile
    PROF_T0();
    const int n0 = tile * TNW;
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      const int row = m0 + h * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j0 = 0; j0 < TNW / 8; j0 += 4) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            v[jj] = pack_bf16(acc[h][4 * (j0 + jj) + 2 * half] + bj[j0 + jj].x,
                              acc[h][4 * (j0 + jj) + 2 * half + 1] + bj[j0 + jj].y);
          quad_exchange(v, c);
          const int r = row + 8 * half, col8 = n0 + 8 * (j0 + c);
          if (r < rows && col8 < K)
            *reinterpret_cast<uint4*>(out + (long long)r * o_rs + col8) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    PROF_ADD(4);
  }
  PROF_MARK(3);
}

template <int PANEL, int TNW>
cudaError_t launch_bf16(const void* x, long long x_rs, const void* w, const void* bias,
                        void* out, long long o_rs, int rows, int C, int K, float eps,
                        cudaStream_t stream) {
  auto kernel = ln_matmul_bf16_kernel<PANEL, TNW>;
  const int CB = (C + KC - 1) / KC;
  const int bytes = 1024 + 2 * RING * TNW * KC * 2 + CB * PANEL * 128;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  // few panels: split the column tiles over gridDim.y to fill the card, at
  // least two tiles a block (one for each warpgroup)
  const int panels = (rows + PANEL - 1) / PANEL, ntiles = (K + TNW - 1) / TNW;
  int split = 2 * sms / panels;
  split = split > ntiles / 2 ? ntiles / 2 : split;
  split = split < 1 ? 1 : split;
  int tiles_per_block = (ntiles + split - 1) / split;
  tiles_per_block += tiles_per_block & 1;  // even: both warpgroups get as many
  const dim3 grid(panels, (ntiles + tiles_per_block - 1) / tiles_per_block);
  kernel<<<grid, W_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), x_rs, static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), o_rs, rows, C, K, eps,
      tiles_per_block);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 above C 320: 128-row tiles, x and W' streamed by TMA, x standardized
// in registers as wgmma's A operand
// ---------------------------------------------------------------------------

constexpr int WM = 128;               // tokens of a tile: 64 for each consumer warpgroup
constexpr int WTN = 256;              // columns of a tile
constexpr int W_X = WM * KC * 2;      // bytes of an x piece: 128 tokens x 64 channels
constexpr int W_W = WTN * KC * 2;     // bytes of a W' piece: 256 columns x 64 channels
constexpr int WNS = 4;                // stages of the ring, an x piece and a W' piece each
constexpr int WIDE_THREADS = 384;     // two consumer warpgroups and a producer warpgroup

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LNMM_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LNMM_WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the box at (c0, c1) of a 2-D tensor map into shared memory at dst; the
// barrier at bar counts its bytes
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// D[64 x 256] (+)= A[64 x 16] (registers, the mma.sync A fragment of each
// warp's 16 rows) * B[256 x 16]^T (shared memory, K-major)
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// two neighbouring x values (one 32-bit word of a row) standardized with the
// row's (mean, 1/std) and rounded to bf16, as the panel kernel does
__device__ __forceinline__ uint32_t standardize2(uint32_t v, float2 st) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16((f.x - st.x) * st.y, (f.y - st.x) * st.y);
}

// mean and 1/std of each token in f32, two passes over the lane's 16-byte
// pieces held in registers (C <= 1280: 5 a lane); a warp per token
__global__ void __launch_bounds__(256) ln_matmul_bf16_kernel_wide_stats(
    const bf16* __restrict__ x, long long x_rs, float2* __restrict__ stats, int rows, int C,
    float eps) {
  constexpr int MAX_PIECES = 5;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (long long)row * x_rs;
  const int pieces = C / 8;
  uint4 v[MAX_PIECES];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PIECES; ++i) {
    if (lane + 32 * i < pieces) {
      v[i] = *reinterpret_cast<const uint4*>(xr + 8 * (lane + 32 * i));
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
    }
  }
  const float mean = warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PIECES; ++i) {
    if (lane + 32 * i < pieces) {
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __bfloat162float(e[j]) - mean;
        s2 += d * d;
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(s2) / C + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// A block owns one 256-column tile of W' and walks tiles_per_block 128-row
// blocks of tokens. One thread of the producer warpgroup keeps WNS pieces
// (64 channels of the x rows and of the W' tile) in flight, and the
// warpgroup gives its registers to the consumers; each consumer warpgroup takes 64
// rows: it reads its lanes' x values of a piece from shared memory,
// standardizes them in registers and multiplies the W' piece, shared by
// both warpgroups, with wgmma m64n256k16.
__global__ void __launch_bounds__(WIDE_THREADS, 1) ln_matmul_bf16_kernel_wide(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float2* __restrict__ stats, const float* __restrict__ bias, bf16* __restrict__ out,
    long long o_rs, int rows, int C, int K, int tiles_per_block) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned ring = (raw + 1023u) & ~1023u;  // [WNS][x piece | W' piece], 128-byte swizzle
  const unsigned full = ring + WNS * (W_X + W_W);  // WNS barriers: the stage has landed
  const unsigned empty = full + WNS * 8;           // WNS barriers: both warpgroups are done
  const int tid = threadIdx.x, lane = tid % 32;
  // warp and warpgroup as values the compiler knows to be uniform in a warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const int CB = (C + KC - 1) / KC;
  const int n0 = blockIdx.x * WTN;
  const int rb_begin = blockIdx.y * tiles_per_block;
  const int rb_end = min((rows + WM - 1) / WM, rb_begin + tiles_per_block);

  if (tid == 0) {
    for (int s = 0; s < WNS; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, and the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int rb = rb_begin; rb < rb_end; ++rb) {
        for (int kc = 0; kc < CB; ++kc, ++it) {
          const int s = it % WNS;
          if (it >= WNS) mbar_wait(empty + 8 * s, ((it / WNS) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, W_X + W_W);
          const unsigned dst = ring + s * (W_X + W_W);
          tma_load(dst, &x_map, full + 8 * s, kc * KC, rb * WM);
          tma_load(dst + W_X, &w_map, full + 8 * s, kc * KC, n0);
        }
      }
    }
    return;
  }

  // consumers: this lane's rows of a tile are row and row + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = lane >> 2, c = lane & 3;
  const int row = wg * 64 + (warp & 3) * 16 + g;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int rb = rb_begin; rb < rb_end; ++rb) {
    const int r0 = rb * WM + row;
    // rows outside the matrix: zeros from the copy, zeros standardized
    const float2 st0 = r0 < rows ? stats[r0] : make_float2(0.f, 0.f);
    const float2 st1 = r0 + 8 < rows ? stats[r0 + 8] : make_float2(0.f, 0.f);
    for (int kc = 0; kc < CB; ++kc, ++it) {
      const int s = it % WNS;
      mbar_wait(full + 8 * s, (it / WNS) & 1);
      const unsigned xs = ring + s * (W_X + W_W);
      // A fragments of the piece's four k16 steps: word h of a 16-channel
      // step holds channels 2c, 2c + 1 (+ 8 h) of row (a[.][2h]) and of
      // row + 8 (a[.][2h + 1]); rows row and row + 8 share the swizzle
      uint32_t a[KC / 16][4];
#pragma unroll
      for (int k16 = 0; k16 < KC / 16; ++k16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned p = xs + row * 128 + (((2 * k16 + h) ^ (row & 7)) << 4) + 4 * c;
          uint32_t v0, v1;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v0) : "r"(p) : "memory");
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v1) : "r"(p + 8 * 128) : "memory");
          a[k16][2 * h] = standardize2(v0, st0);
          a[k16][2 * h + 1] = standardize2(v1, st1);
        }
      }
      const unsigned ws = xs + W_X;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < KC / 16; ++k16)
        wgmma_rs_m64n256k16(acc, a[k16], smem_desc(ws + 32 * k16), (kc | k16) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (tid % 128 == 0) mbar_arrive(empty + 8 * s);  // the warpgroup is done with the stage
    }

    // epilogue: + b', round to bf16, 16-byte stores of 8 neighbouring outputs
#pragma unroll
    for (int j0 = 0; j0 < WTN / 8; j0 += 4) {
      float2 bj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * c;
        bj[jj] = col < K ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = pack_bf16(acc[4 * (j0 + jj) + 2 * hr] + bj[jj].x,
                            acc[4 * (j0 + jj) + 2 * hr + 1] + bj[jj].y);
        quad_exchange(v, c);
        const int r = r0 + 8 * hr, col8 = n0 + 8 * (j0 + c);
        if (r < rows && col8 < K)
          *reinterpret_cast<uint4*>(out + (long long)r * o_rs + col8) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows][cols] bf16 matrix (row stride rs elements) read in boxes of
// box_rows x 64 columns with the 128-byte swizzle, zeros outside
bool encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows,
                 long long cols, long long rs, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)rs * 2};
  const cuuint32_t box[2] = {KC, (cuuint32_t)box_rows}, step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wide(const void* x, long long x_rs, const void* w, const void* bias,
                        void* stats, void* out, long long o_rs, int rows, int C, int K,
                        float eps, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  if (!encode_bf16(encode, &x_map, x, rows, C, x_rs, WM) ||
      !encode_bf16(encode, &w_map, w, K, C, C, WTN))
    return cudaErrorInvalidValue;
  const int bytes = 1024 + WNS * (W_X + W_W) + 2 * WNS * 8;
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_bf16_kernel_wide,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  ln_matmul_bf16_kernel_wide_stats<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(x), x_rs, static_cast<float2*>(stats), rows, C, eps);
  // a block per column tile and share of the row blocks: as many blocks
  // as the card holds at once, each walking its row blocks in order
  const int ntiles = (K + WTN - 1) / WTN, nrb = (rows + WM - 1) / WM;
  int split = sms / ntiles;
  split = split > nrb ? nrb : split;
  split = split < 1 ? 1 : split;
  const int tiles_per_block = (nrb + split - 1) / split;
  const dim3 grid(ntiles, (nrb + tiles_per_block - 1) / tiles_per_block);
  ln_matmul_bf16_kernel_wide<<<grid, WIDE_THREADS, bytes, stream>>>(
      x_map, w_map, static_cast<const float2*>(stats), static_cast<const float*>(bias),
      static_cast<bf16*>(out), o_rs, rows, C, K, tiles_per_block);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: stats kernel + tiled FMA product
// ---------------------------------------------------------------------------

__global__ void ln_stats_kernel(const float* __restrict__ x, long long rs,
                                float* __restrict__ stats, int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + row * rs;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mean = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mean;
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
template <int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, long long rs, int r0,
                                      int rows, int k0, int C, const float* mean,
                                      const float* rstd) {
  constexpr int CHUNKS = BKC / 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool ok = r0 + r < rows && k0 + c < C;
    if (ok) raw = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rs + k0 + c);
    float e[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[r * LD + c + j] = mean != nullptr && ok ? (e[j] - mean[r]) * rstd[r] : e[j];
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
    stage<LDA>(As, x, x_rs, m0, rows, k0, C, mean, rstd);
    stage<LDA>(Bs, w, C, n0, K, k0, C, nullptr, nullptr);
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

#ifdef LNMM_PROF
extern "C" int ln_matmul_prof(unsigned long long* host8, int reset) {
  if (reset) {
    unsigned long long z[8] = {};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host8, g_prof, 8 * sizeof(unsigned long long));
}
#endif

// dtype: 0 = float32, 1 = bfloat16. x [rows, C] (row stride x_rs), w [K, C]
// contiguous, bias [K] f32, out [rows, K] (row stride o_rs). C must be a
// multiple of 16 bytes' worth of elements. stats [rows, 2] f32 is scratch of
// the f32 path and of the bf16 path above C 320 (null otherwise). bf16 takes
// C up to 1280 and K a multiple of 8; the rows of x start on 16 bytes.
// Returns the cudaError_t of the launch.
extern "C" int ln_matmul_fwd(int dtype, const void* x, long long x_rs, const void* w,
                             const void* bias, void* stats, void* out, long long o_rs,
                             int rows, int C, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 stats_grid((rows + 7) / 8);
    const dim3 grid((K + BN - 1) / BN, (rows + BM - 1) / BM);
    ln_stats_kernel<<<stats_grid, 256, 0, s>>>(static_cast<const float*>(x), x_rs,
                                               static_cast<float*>(stats), rows, C, eps);
    ln_matmul_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), x_rs, static_cast<const float*>(stats),
        static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out),
        o_rs, rows, C, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || C % 8 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  // the token panel up to C 320, the wide design above (ops/ln_matmul.py:
  // kernel_route says the same)
  const int CB = (C + KC - 1) / KC;
  if (CB <= 5)
    return static_cast<int>(launch_bf16<128, 128>(x, x_rs, w, bias, out, o_rs, rows, C, K, eps, s));
  if (CB <= 20)
    return static_cast<int>(launch_wide(x, x_rs, w, bias, stats, out, o_rs, rows, C, K, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
