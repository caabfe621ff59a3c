// ACE random-spray accumulation with samples shared per page.
//
// Replaces libpillowfight_tpu/ops/pallas/ace_kernel.py `_ace_tile_kernel`
// (via `ace_spray_pallas`).
//
// For pixel p = (y, x) of page b, channel c, and the S samples (sy, sx) of
// the page with values v_c:
//   inv_d   = min(rsqrt(max(dy^2 + dx^2, 1e-12)), 1),  dy = y - sy, dx = x - sx
//   num_c   = sum_s clip(slope * (I_c(p) - v_c), -limit, limit) * inv_d
//   invd    = sum_s inv_d
// in sample order, from 0. The caller divides num by limit * invd and
// stretches each channel to [0,255].
//
// Bound on the H100: instruction issue, not bytes (S = 100 reads and
// writes 32 B a pixel, a fifth of the time the arithmetic takes). So the
// design counts issue slots a pixel and sample, and takes the form of the
// function that needs fewest:
//
// * The distance in 4 slots and one special-function rsqrt. Coordinates
//   are integers, so d2 = dy^2 + dx^2 is 0 or >= 1 and
//   min(rsqrt(max(d2, 1e-12)), 1) == rsqrt(max(d2, 1)): add (dy), FMA
//   (d2), max, rsqrt, add (invd). dy^2 is exact up to 4096 rows, so the
//   FMA rounds as multiply-then-add does and invd is bit-identical to
//   that form; on longer pages d2 may differ by one rounding.
//   `rsqrt.approx.ftz.f32` is one MUFU.RSQ; on d2 >= 1 it is `rsqrtf`
//   without its denormal fix-up.
// * The clip as a saturating FMA. With k = slope / (2 limit) and
//   u = sat(k (I - v) + 1/2) in [0,1] (one FFMA.SAT),
//   clip(slope (I - v), -limit, limit) = limit (2u - 1). The kernel sums
//   A_c = sum_s u_c * inv_d with one FMA a term and writes
//   num_c = limit (2 A_c - invd): sub, FFMA.SAT, FMA, 3 slots a channel
//   where clip-multiply-add took 6, two of them min/max.
//   PRESCALED forms a = k I + 1/2 once a pixel and k v once a sample, so
//   that u = sat(a - k v) is one FADD.SAT: 2 slots a channel. It gives up
//   the exact difference I - v; the wrapper takes it only while
//   |k| * 255 <= 2, see the error budget.
// * A thread keeps 8 pixels of one column (3 channels, their sums and
//   invd) in registers, a block 64 columns x 32 rows. A sample is staged
//   in shared memory as one 16-byte record (sx, sy, v0, v1) and one word
//   (v2), read as two broadcast loads for 8 pixels; dx^2 and y0 - sy are
//   formed once for the 8. That is 14 slots and one rsqrt a pixel and
//   sample (11 PRESCALED), and about 0.6 of a slot of loads and shared
//   terms, where the earlier form took 25 and 1.25.
// * The page is read once and written once: the samples run while the
//   pixels stay in registers, as the TPU kernel kept its tile in VMEM.
//
// Error budget against the clip form in f32 (`ace_spray_plain`), in units
// of the largest possible |num|, limit * invd. u carries one rounding of
// k, one of the FMA: <= 2^-23 each term. A_c <= invd is a sum of S
// non-negative terms, each FMA rounding to <= 2^-24 A_c: <= S 2^-24 invd
// at worst, ~sqrt(S) 2^-24 invd when the roundings are independent. invd
// itself carries the same. num = limit (2 A_c - invd) therefore differs
// by at most ~3 S 2^-24 (1.8e-5 at S = 100) and typically by ~3 sqrt(S)
// 2^-24 (2e-6 at S = 100, 6e-6 at S = 1000); the clip form's own sum of S
// signed terms wanders as far. PRESCALED adds 2^-24 (|k I| + 1/2 + |k v|
// + 1) <= 2^-24 * 5.5 a term while |k| * 255 <= 2: 3.3e-7.
//
// A block of 256 threads, two blocks an SM (`__launch_bounds__`): at most
// 128 registers a thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 64, BY = 4, PY = 8;  // block: 64 x (4 threads x 8 rows)
constexpr int THREADS = BX * BY;
constexpr int CHUNK = 512;              // samples staged at a time (10 KB)

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool PRESCALED>
__global__ void __launch_bounds__(THREADS, 2)
ace_spray_kernel(const float* __restrict__ planar, const int* __restrict__ sy,
                 const int* __restrict__ sx, const float* __restrict__ sval,
                 float* __restrict__ num, float* __restrict__ invd, int H,
                 int W, int S, float k, float limit) {
  __shared__ float4 s_a[CHUNK];  // sx, sy, v0, v1
  __shared__ float s_b[CHUNK];   // v2
  const int b = blockIdx.z;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int yb = (blockIdx.y * BY + threadIdx.y) * PY;
  const size_t hw = (size_t)H * W;
  const float* img = planar + (size_t)b * 3 * hw;

  // I: the pixel's value, or k I + 1/2 when PRESCALED; acc: A_c
  float I[3][PY], acc[3][PY], id[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    const int y = yb + j;
    const bool ok = x < W && y < H;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = ok ? img[c * hw + (size_t)y * W + x] : 0.0f;
      I[c][j] = PRESCALED ? fmaf(k, v, 0.5f) : v;
      acc[c][j] = 0.0f;
    }
    id[j] = 0.0f;
  }
  const float px = (float)x, py0 = (float)yb;

  for (int s0 = 0; s0 < S; s0 += CHUNK) {
    const int ns = min(CHUNK, S - s0);
    __syncthreads();
    for (int i = tid; i < ns; i += THREADS) {
      const size_t at = (size_t)b * S + s0 + i;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = sval[((size_t)b * 3 + c) * S + s0 + i];
        if (PRESCALED) v[c] = k * v[c];
      }
      s_a[i] = make_float4((float)sx[at], (float)sy[at], v[0], v[1]);
      s_b[i] = v[2];
    }
    __syncthreads();
    for (int i = 0; i < ns; ++i) {
      const float4 a = s_a[i];
      const float sv[3] = {a.z, a.w, s_b[i]};
      const float dx = px - a.x;
      const float dx2 = dx * dx;
      const float dy0 = py0 - a.y;
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        const float dy = dy0 + (float)j;
        const float inv = rsqrt_approx(fmaxf(fmaf(dy, dy, dx2), 1.0f));
        id[j] = __fadd_rn(id[j], inv);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float u = PRESCALED
                              ? __saturatef(I[c][j] - sv[c])
                              : __saturatef(fmaf(k, I[c][j] - sv[c], 0.5f));
          acc[c][j] = fmaf(u, inv, acc[c][j]);
        }
      }
    }
  }

  if (x >= W) return;
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    const int y = yb + j;
    if (y >= H) break;
    const size_t o = (size_t)y * W + x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      num[((size_t)b * 3 + c) * hw + o] =
          __fmul_rn(limit, __fmaf_rn(2.0f, acc[c][j], -id[j]));
    invd[(size_t)b * hw + o] = id[j];
  }
}

}  // namespace

// planar f32 [B,3,H,W]; sy, sx i32 [B,S]; sval f32 [B,3,S]
// -> num f32 [B,3,H,W], invd f32 [B,H,W]. limit > 0. prescaled != 0 takes
// the 2-slot form of a channel (see above).
extern "C" int pft_ace_spray(const void* planar, const void* sy,
                             const void* sx, const void* sval, void* num,
                             void* invd, int B, int H, int W, int S,
                             float slope, float limit, int prescaled,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || S < 0) return (int)cudaGetLastError();
  const float k = (float)((double)slope / (2.0 * (double)limit));
  dim3 block(BX, BY);
  dim3 grid((W + BX - 1) / BX, (H + BY * PY - 1) / (BY * PY), B);
  if (prescaled) {
    ace_spray_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)planar, (const int*)sy, (const int*)sx,
        (const float*)sval, (float*)num, (float*)invd, H, W, S, k, limit);
  } else {
    ace_spray_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)planar, (const int*)sy, (const int*)sx,
        (const float*)sval, (float*)num, (float*)invd, H, W, S, k, limit);
  }
  return (int)cudaGetLastError();
}
