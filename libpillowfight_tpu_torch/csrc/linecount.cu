// Per-row and per-column dark-pixel counts of a bool plane, one read.
//
// Replaces libpillowfight_tpu/ops/pallas/linecount_kernel.py `_lc_kernel`
// (via `line_counts_pallas`). The TPU kernel carries the column sums in
// VMEM across an ordered grid; Hopper blocks run in no order, so each
// block reduces a band of ROWS rows and adds its column partials into an
// int32 accumulator with atomicAdd (exact and order-free). Row sums are a
// warp-shuffle block reduction.
//
// Bound on the H100: bytes. 1 B/px of plane read, ~0 written (B*(H+W)
// counts), plus one int32 atomic per (band, column). Coalesced 1-byte
// loads along W; the band height amortises the atomics 32x.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;      // rows per block band
constexpr int THREADS = 256;  // 8 warps

__global__ void line_counts_kernel(const uint8_t* __restrict__ plane,
                                   float* __restrict__ rows,
                                   int* __restrict__ cols, int H, int W) {
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, H - y0);
  const uint8_t* page = plane + ((size_t)b * H + y0) * W;

  int racc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) racc[i] = 0;

  for (int x = threadIdx.x; x < W; x += THREADS) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < nrows) {
        const int v = page[(size_t)i * W + x] != 0;
        c += v;
        racc[i] += v;
      }
    }
    if (c) atomicAdd(&cols[(size_t)b * W + x], c);
  }

  __shared__ int part[ROWS][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    int v = racc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += part[threadIdx.x][w];
    rows[(size_t)b * H + y0 + threadIdx.x] = (float)s;
  }
}

}  // namespace

// plane: uint8/bool [B,H,W]; rows: f32 [B,H]; cols_acc: int32 [B,W],
// zeroed by the caller.
extern "C" int pft_line_counts(const void* plane, void* rows, void* cols_acc,
                               int B, int H, int W, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    dim3 grid((H + ROWS - 1) / ROWS, B);
    line_counts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)plane, (float*)rows, (int*)cols_acc, H, W);
  }
  return (int)cudaGetLastError();
}
