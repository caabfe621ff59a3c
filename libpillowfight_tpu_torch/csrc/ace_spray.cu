// ACE random-spray accumulation with samples shared per page.
//
// Replaces libpillowfight_tpu/ops/pallas/ace_kernel.py `_ace_tile_kernel`
// (via `ace_spray_pallas`).
//
// For pixel p = (y, x) of page b, channel c, and the S samples (sy, sx) of
// the page with values v_c:
//   inv_d   = min(rsqrt(max(dy^2 + dx^2, 1e-12)), 1),  dy = y - sy, dx = x - sx
//   num_c  += clip(slope * (I_c(p) - v_c), -limit, limit) * inv_d
//   invd   += inv_d
// in sample order, from 0. The caller divides num by limit * invd and
// stretches each channel to [0,255].
//
// Design: a block covers 64 columns x 16 rows; each thread keeps 4 pixels
// of one column (all 3 channels) in registers, so one sample's coordinates
// and values, staged in shared memory (CHUNK samples at a time, broadcast
// reads), serve 4 pixels, and dx^2 is computed once for them: the separable
// distance of the TPU kernel. The distance term is shared by the three
// channels. The input page is read once and the outputs written once: the
// S samples run while the pixels stay in registers, as the TPU kernel kept
// its tile in VMEM.
//
// Arithmetic is __fmul_rn/__fadd_rn/__fsub_rn in the plain version's
// order; only rsqrtf (about 2 ulp) differs from the plain version's
// rsqrt, so the sums agree to f32 rounding.
//
// Bound on the H100: arithmetic. ~22 f32 operations per pixel and sample
// (one MUFU rsqrt): A4 x 16 at S = 100 is 1.4e10 pixel-samples, ~3e11
// operations, ~10 ms of CUDA-core issue; device memory moves 32 B/px
// (4.4 GB), ~1.3 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 64, BY = 4, PY = 4;  // block: 64 x (4 threads x 4 rows)
constexpr int THREADS = BX * BY;
constexpr int CHUNK = 512;              // samples staged at a time (10 KB)

__global__ void __launch_bounds__(THREADS)
ace_spray_kernel(const float* __restrict__ planar, const int* __restrict__ sy,
                 const int* __restrict__ sx, const float* __restrict__ sval,
                 float* __restrict__ num, float* __restrict__ invd, int H,
                 int W, int S, float slope, float limit) {
  __shared__ float s_y[CHUNK], s_x[CHUNK], s_v[3][CHUNK];
  const int b = blockIdx.z;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int yb = (blockIdx.y * BY + threadIdx.y) * PY;
  const size_t hw = (size_t)H * W;
  const float* img = planar + (size_t)b * 3 * hw;

  float I[3][PY], n[3][PY], id[PY], py[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    const int y = yb + j;
    const bool ok = x < W && y < H;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      I[c][j] = ok ? img[c * hw + (size_t)y * W + x] : 0.0f;
      n[c][j] = 0.0f;
    }
    id[j] = 0.0f;
    py[j] = (float)y;
  }
  const float px = (float)x;

  for (int s0 = 0; s0 < S; s0 += CHUNK) {
    const int ns = min(CHUNK, S - s0);
    __syncthreads();
    for (int i = tid; i < ns; i += THREADS) {
      const size_t k = (size_t)b * S + s0 + i;
      s_y[i] = (float)sy[k];
      s_x[i] = (float)sx[k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s_v[c][i] = sval[((size_t)b * 3 + c) * S + s0 + i];
    }
    __syncthreads();
    for (int i = 0; i < ns; ++i) {
      const float dx = __fsub_rn(px, s_x[i]);
      const float dx2 = __fmul_rn(dx, dx);
      const float sv0 = s_v[0][i], sv1 = s_v[1][i], sv2 = s_v[2][i];
      const float syi = s_y[i];
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        const float dy = __fsub_rn(py[j], syi);
        const float d2 = __fadd_rn(__fmul_rn(dy, dy), dx2);
        const float inv = fminf(rsqrtf(fmaxf(d2, 1e-12f)), 1.0f);
        const float sv[3] = {sv0, sv1, sv2};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t = fminf(
              fmaxf(__fmul_rn(slope, __fsub_rn(I[c][j], sv[c])), -limit),
              limit);
          n[c][j] = __fadd_rn(n[c][j], __fmul_rn(t, inv));
        }
        id[j] = __fadd_rn(id[j], inv);
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
    for (int c = 0; c < 3; ++c) num[((size_t)b * 3 + c) * hw + o] = n[c][j];
    invd[(size_t)b * hw + o] = id[j];
  }
}

}  // namespace

// planar f32 [B,3,H,W]; sy, sx i32 [B,S]; sval f32 [B,3,S]
// -> num f32 [B,3,H,W], invd f32 [B,H,W].
extern "C" int pft_ace_spray(const void* planar, const void* sy,
                             const void* sx, const void* sval, void* num,
                             void* invd, int B, int H, int W, int S,
                             float slope, float limit, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || S < 0) return (int)cudaGetLastError();
  dim3 block(BX, BY);
  dim3 grid((W + BX - 1) / BX, (H + BY * PY - 1) / (BY * PY), B);
  ace_spray_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)planar, (const int*)sy, (const int*)sx,
      (const float*)sval, (float*)num, (float*)invd, H, W, S, slope, limit);
  return (int)cudaGetLastError();
}
