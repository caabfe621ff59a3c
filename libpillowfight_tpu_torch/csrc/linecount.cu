// Per-row and per-column counts of the non-zero bytes of a bool or uint8
// plane, one read.
//
// Replaces libpillowfight_tpu/ops/pallas/linecount_kernel.py `_lc_kernel`
// (via `line_counts_pallas`). The TPU kernel carries the column sums in
// VMEM across an ordered grid; Hopper blocks run in no order, so every
// block adds its partial sums into the f32 outputs with atomicAdd. Each
// partial sum is an integer below 2^24 (H <= 65535 * 128, W < 2^24),
// so every f32 sum is exact and independent of order.
//
// Bound on the H100: bytes, 1 B/px read and ~0 written. Design against
// it (the first version moved one byte a thread, walked ~10 columns one
// after another, filled under a quarter of the card and needed a zeroed
// int32 accumulator and a conversion pass after it):
// - a block owns a band of BAND = 128 rows x CHUNK = 512 columns: a warp
//   row of 32 lanes x 16 bytes along W (one 16-byte load a lane and row,
//   a warp moves 512 B a row), 8 warps down the band, 16 rows a lane,
//   all 16 loads in flight at once; 280 blocks at A4 x 2, 64 KB each;
// - every byte is turned into 0/1 (`__vsetne4`), so a uint8 plane counts
//   its non-zero bytes like the plain version;
// - column counts live in four words a lane, a byte a column (`__vadd4`;
//   at most 16 rows a lane, 128 after the block's sum over its warps,
//   both under 256), and leave the block as one f32 atomic a column;
// - row counts: popcount of the 16 bytes, a warp sum (`__reduce_add_sync`)
//   and one f32 atomic a row and chunk;
// - the outputs are one buffer, rows then columns, zeroed by one
//   cudaMemsetAsync in `pft_line_counts`: two device operations a call.
// A plane whose pointer is not 16-byte aligned or whose width is no
// multiple of 16 takes the same kernel with byte loads (VEC = false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32, WARPS = 8, THREADS = LANES * WARPS;
constexpr int ROWS_PER_LANE = 16;
constexpr int BAND = WARPS * ROWS_PER_LANE;  // 128 rows
constexpr int CHUNK = LANES * 16;            // 512 columns

template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int x, int W) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + x));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = x + 4 * k + j;
      if (c < W) v |= (uint32_t)__ldg(row + c) << (8 * j);
    }
    w[k] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
line_counts_kernel(const uint8_t* __restrict__ plane,
                   float* __restrict__ rows, float* __restrict__ cols,
                   int H, int W) {
  __shared__ uint32_t part[WARPS][LANES * 4];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.z;
  const int x = blockIdx.x * CHUNK + lane * 16;
  const int y0 = blockIdx.y * BAND + warp * ROWS_PER_LANE;
  const uint8_t* page = plane + (size_t)b * H * W;
  const bool in_x = x < W;

  uint4 v[ROWS_PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const int y = y0 + i;
    v[i] = (in_x && y < H) ? load16<VEC>(page + (size_t)y * W, x, W)
                           : make_uint4(0, 0, 0, 0);
  }
  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const uint32_t a = __vsetne4(v[i].x, 0u), bb = __vsetne4(v[i].y, 0u);
    const uint32_t c = __vsetne4(v[i].z, 0u), d = __vsetne4(v[i].w, 0u);
    c0 = __vadd4(c0, a);
    c1 = __vadd4(c1, bb);
    c2 = __vadd4(c2, c);
    c3 = __vadd4(c3, d);
    // every byte is 0 or 1: shifted by 0..3 bits they stay in their byte
    const int n = __popc(a | (bb << 1) | (c << 2) | (d << 3));
    const int s = __reduce_add_sync(0xffffffffu, n);
    const int y = y0 + i;
    if (lane == 0 && s != 0 && y < H)
      atomicAdd(&rows[(size_t)b * H + y], (float)s);
  }
  part[warp][lane * 4 + 0] = c0;
  part[warp][lane * 4 + 1] = c1;
  part[warp][lane * 4 + 2] = c2;
  part[warp][lane * 4 + 3] = c3;
  __syncthreads();

  // 128 words, 4 columns each: one thread a word
  const int t = warp * LANES + lane;
  if (t < LANES * 4) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum = __vadd4(sum, part[w][t]);
    const int xc = blockIdx.x * CHUNK + t * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t n = (sum >> (8 * j)) & 0xFFu;
      if (n != 0 && xc + j < W)
        atomicAdd(&cols[(size_t)b * W + xc + j], (float)n);
    }
  }
}

}  // namespace

// plane: uint8/bool [B,H,W]; out: f32 [B*H + B*W], the row counts [B,H]
// then the column counts [B,W]; zeroed here. B <= 65535, H <= 65535 *
// BAND, W < 2^24.
extern "C" int pft_line_counts(const void* plane, void* out, int B, int H,
                               int W, void* stream) {
  if (B > 65535 || H > 65535 * BAND || W >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  float* rows = (float*)out;
  float* cols = rows + (size_t)B * H;
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * ((size_t)B * H + (size_t)B * W), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + CHUNK - 1) / CHUNK, (H + BAND - 1) / BAND, B);
  const dim3 block(LANES, WARPS);
  const bool vec = ((uintptr_t)plane % 16 == 0) && (W % 16 == 0);
  if (vec)
    line_counts_kernel<true><<<grid, block, 0, s>>>(
        (const uint8_t*)plane, rows, cols, H, W);
  else
    line_counts_kernel<false><<<grid, block, 0, s>>>(
        (const uint8_t*)plane, rows, cols, H, W);
  return (int)cudaGetLastError();
}
