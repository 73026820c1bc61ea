// Building blocks of the bf16 per-pixel temporal attention kernels
// (temporal_attn_fwd.cu, temporal_attn_bwd.cu): the tile of one unit of work
// in shared memory and its copies, ldmatrix / mma.sync / movmatrix wrappers
// and the small products on register fragments. Everything is inline device
// code.
//
// A unit is one (batch row, pixel, group of heads): up to 16 frame rows of
// q, k, v (and dO), each row the group's contiguous channels. A block has one
// warp per head of the group. The unit's rows are copied whole into shared
// memory as bf16 with 16-byte cp.async by all threads of the block; the row
// pitch is an odd count of 16-byte pieces, so the eight rows of an ldmatrix
// fall on distinct banks. Frames beyond a ragged F or G are zero-filled.
#pragma once

#include <math_constants.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace temporal {

using hopper::bf16;

constexpr int ROWS = 16;      // frame rows a tile holds: the M of mma.m16n8k16
constexpr int STAGES = 2;     // units in flight a block
static_assert(STAGES == 2, "the kernels flip between two stages (stage ^ 1, wait for all but one)");
constexpr int MAX_WARPS = 8;  // heads a unit holds at most

// [B, N, rows, C] tensor read through its strides (elements); channels contiguous
struct Slab {
  const bf16* p;
  long long bs, ns, fs;
  int rows;
};

// bytes between the rows of a tile whose rows hold `pieces` 16-byte pieces
__host__ __device__ __forceinline__ int tile_pitch(int pieces) { return (pieces | 1) * 16; }

// One unit's rows in shared memory, and this thread's walk over their 16-byte
// pieces (piece i of the tile is row i / PR, piece i % PR; the thread takes
// pieces threadIdx.x, threadIdx.x + blockDim.x, ... without dividing again).
struct Tile {
  int PR, pitch, r0, c0, dr, dc;
  __device__ __forceinline__ explicit Tile(int head_bytes) {
    PR = (blockDim.x >> 5) * head_bytes >> 4;
    pitch = tile_pitch(PR);
    r0 = threadIdx.x / PR;
    c0 = threadIdx.x % PR;
    dr = blockDim.x / PR;
    dc = blockDim.x % PR;
  }
  __device__ __forceinline__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= PR) {
      c -= PR;
      ++r;
    }
  }
};

// rows [0, ROWS) of the unit at src (row stride fs) -> the tile at dst; rows
// beyond `rows` are zero-filled
__device__ __forceinline__ void copy_in(unsigned dst, const bf16* src, long long fs, int rows,
                                        const Tile& t) {
  int r = t.r0, c = t.c0;
  while (r < ROWS) {
    const bool ok = r < rows;
    hopper::cp_async_to(dst + r * t.pitch + c * 16, ok ? src + r * fs + c * 8 : src, ok);
    t.next(r, c);
  }
}

// rows [0, rows) of the tile at src -> device memory at dst, 16 bytes a thread
__device__ __forceinline__ void copy_out(bf16* dst, long long fs, const unsigned char* src,
                                         int rows, const Tile& t) {
  int r = t.r0, c = t.c0;
  while (r < rows) {
    *reinterpret_cast<uint4*>(dst + r * fs + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * t.pitch + c * 16);
    t.next(r, c);
  }
}

__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D[16 x 8] += A[16 x 8] * B[8 x 8]
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// the transpose of an 8 x 8 bf16 matrix held across the warp as one fragment register
__device__ __forceinline__ uint32_t transpose8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// Where this lane points inside a tile (bytes from the tile's first row), for
// the head whose columns start `cb` bytes into a row:
//   a   its ldmatrix row of a [16 rows x 16 columns] piece read as the A
//       operand, or as a B operand through .trans (rows = the depth)
//   b   its ldmatrix row of a [16 rows x 16 columns] piece read as the B
//       operand of X Y^T (rows = the n index)
//   x8  the same for the last 8 columns of a head_dim that is 8 mod 16
//   c   its accumulator position: row lane / 4, column 2 * (lane % 4)
struct Lanes {
  int a, b, x8, c;
  __device__ __forceinline__ Lanes(int lane, int pitch, int cb, int D) {
    a = ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + cb + (lane >> 4) * 16;
    b = ((lane & 7) + (lane >> 4) * 8) * pitch + cb + ((lane >> 3) & 1) * 16;
    x8 = (lane & 15) * pitch + cb + (D - 8) * 2;
    c = (lane >> 2) * pitch + cb + (lane & 3) * 4;
  }
};

// acc[j] (+)= X Y^T over the head's D channels: X, Y are [16 x D] row-major
// pieces of the tiles at x and y; acc[0] holds columns 0-7, acc[1] 8-15
template <int ND>
__device__ __forceinline__ void product_xyt(float (&acc)[2][4], unsigned x, unsigned y,
                                            const Lanes& l) {
#pragma unroll
  for (int ks = 0; ks < ND / 2; ++ks) {
    uint32_t a[4], b[4];
    ldsm_x4(a, x + l.a + ks * 32);
    ldsm_x4(b, y + l.b + ks * 32);
    mma_k16(acc[0], a, b[0], b[1]);
    mma_k16(acc[1], a, b[2], b[3]);
  }
  if constexpr (ND % 2 == 1) {
    uint32_t a[2], b[2];
    ldsm_x2(a, x + l.x8);
    ldsm_x2(b, y + l.x8);
    mma_k8(acc[0], a[0], a[1], b[0]);
    mma_k8(acc[1], a[0], a[1], b[1]);
  }
}

// dst[16 x D] = A[16 x 16] Y, with A a register fragment and Y the [16 x D]
// piece of the tile at y (read through .trans); the result is rounded to bf16
// and written into the head's columns of the tile at dst
template <int ND>
__device__ __forceinline__ void product_ay(const uint32_t (&a)[4], unsigned y,
                                           unsigned char* dst, const Lanes& l, int pitch) {
  auto put = [&](const float (&o)[4], int col_bytes) {
    unsigned char* at = dst + l.c + col_bytes;
    *reinterpret_cast<uint32_t*>(at) = hopper::pack_bf16(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(at + 8 * pitch) = hopper::pack_bf16(o[2], o[3]);
  };
#pragma unroll
  for (int nt = 0; nt < ND / 2; ++nt) {
    uint32_t b[4];
    ldsm_x4_trans(b, y + l.a + nt * 32);
    float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
    mma_k16(o0, a, b[0], b[1]);
    mma_k16(o1, a, b[2], b[3]);
    put(o0, nt * 32);
    put(o1, nt * 32 + 16);
  }
  if constexpr (ND % 2 == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, y + l.x8);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma_k16(o, a, b[0], b[1]);
    put(o, (ND - 1) * 16);
  }
}

// The additive mask on this lane's accumulator positions, in base-2 units:
// -inf on the padded keys, the caller's [F, G] mask (or 0) elsewhere.
__device__ __forceinline__ void load_mask(float (&mk)[2][4], const float* mask, int F, int G,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (lane >> 2) + (e >> 1) * 8;
      const int c = 8 * j + 2 * (lane & 3) + (e & 1);
      mk[j][e] = c >= G ? -CUDART_INF_F
                        : (mask != nullptr && r < F ? mask[r * G + c] * hopper::LOG2E : 0.f);
    }
}

// s (logits, [16 x 16] accumulators) -> softmax over the 16 keys of each row,
// in place, f32: s * scale_log2 + mk, base-2 exponentials, the row maximum and
// sum across the four lanes that share a row
__device__ __forceinline__ void softmax_rows(float (&s)[2][4], const float (&mk)[2][4],
                                             float scale_log2) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = fmaf(s[j][e], scale_log2, mk[j][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows lane / 4 and lane / 4 + 8
    float m = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[j][e] = hopper::fast_exp2(s[j][e] - m);
        sum += s[j][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) s[j][e] *= inv;
  }
}

// [16 x 16] accumulators -> the bf16 A fragment of the same matrix
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[2][4]) {
  a[0] = hopper::pack_bf16(s[0][0], s[0][1]);
  a[1] = hopper::pack_bf16(s[0][2], s[0][3]);
  a[2] = hopper::pack_bf16(s[1][0], s[1][1]);
  a[3] = hopper::pack_bf16(s[1][2], s[1][3]);
}

// the A fragment of the transposed matrix: each 8 x 8 block transposed, the
// off-diagonal blocks exchanged
__device__ __forceinline__ void transpose_a(uint32_t (&t)[4], const uint32_t (&a)[4]) {
  t[0] = transpose8(a[0]);
  t[1] = transpose8(a[2]);
  t[2] = transpose8(a[1]);
  t[3] = transpose8(a[3]);
}

// unit u -> (batch row, pixel, head group), and its first element in a tensor
struct Unit {
  int b, n, hg;
  __device__ __forceinline__ Unit(int u, int N, int NG) {
    hg = u % NG;
    const int pix = u / NG;
    b = pix / N;
    n = pix - b * N;
  }
  __device__ __forceinline__ long long offset(long long bs, long long ns, int group_cols) const {
    return b * bs + n * ns + (long long)hg * group_cols;
  }
};

// ---- host side: the launch of a kernel that walks units ----

// fn(std::integral_constant<int, D / 8>) for a head_dim the kernels are
// instantiated for
template <typename Fn>
cudaError_t for_head_dim(int D, Fn fn) {
  switch (D) {
    case 8: return fn(std::integral_constant<int, 1>{});
    case 16: return fn(std::integral_constant<int, 2>{});
    case 32: return fn(std::integral_constant<int, 4>{});
    case 40: return fn(std::integral_constant<int, 5>{});
    case 64: return fn(std::integral_constant<int, 8>{});
    case 80: return fn(std::integral_constant<int, 10>{});
    case 128: return fn(std::integral_constant<int, 16>{});
    case 160: return fn(std::integral_constant<int, 20>{});
    default: return cudaErrorInvalidValue;
  }
}

// what a launcher remembers of one kernel instantiation: the SM count, the
// dynamic shared memory the kernel is allowed so far, and the resident blocks
// an SM for each count of warps
struct LaunchState {
  int sms = 0, allowed_bytes = 0, blocks_per_sm[MAX_WARPS + 1] = {};
};

// `kernel` on `warps` warps a block and `tensors` tiles a stage: as many
// blocks as the card holds at once (at most one per unit), each walking units
// blockIdx.x, + gridDim.x, ...
template <typename Params>
cudaError_t launch_units(void (*kernel)(Params), const Params& p, int units, int warps,
                         int tensors, int pieces, LaunchState& st, cudaStream_t stream) {
  const int bytes = STAGES * tensors * ROWS * tile_pitch(pieces);
  cudaError_t err = cudaSuccess;
  if (bytes > st.allowed_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    st.allowed_bytes = bytes;
  }
  if (st.blocks_per_sm[warps] == 0) {
    int device = 0, blocks = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32, bytes);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    st.blocks_per_sm[warps] = blocks;
  }
  const int resident = st.sms * st.blocks_per_sm[warps];
  kernel<<<units < resident ? units : resident, warps * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the checks both entry points make; -> units (B * N * head groups), or -1
inline long long unit_count(int B, int N, int F, int G, int H, int HG) {
  if (F < 1 || G < 1 || F > ROWS || G > ROWS || HG < 1 || HG > MAX_WARPS || H % HG) return -1;
  const long long units = (long long)B * N * (H / HG);
  return units > (1 << 30) ? -1 : units;
}

}  // namespace temporal
