// Fused separable blur: both 1-D passes in one sweep over the plane.
//
// Replaces libpillowfight_tpu/ops/pallas/gaussian_kernel.py `_blur_kernel`
// (via `gaussian_sep_pallas`).
//
// out[y][x] = sum_i t_i * h[y + i - hw][x],  h[y][x] = sum_i t_i *
// in[y][x + i - hw], zero outside the page: a correlation with the n = 2hw+1
// taps along W, then along H (the Gaussian taps are symmetric, so it is
// also the convolution).
//
// Design: one block per (plane, 32-row x 128-column tile). The block loads
// its tile and an hw-pixel halo on every side into shared memory (zeros
// outside the page), runs the W pass over all tile + halo rows into a
// second shared buffer, then the H pass, and writes each output pixel
// once. The TPU kernel carried neighbouring row bands in VMEM through
// three BlockSpecs; here the halo is simply re-read (from L2 mostly).
// Taps are a kernel parameter (a struct by value), so no device buffer
// or constant symbol has to be set before the launch.
//
// Order: the W pass first, then H, each sum a left fold from tap 0 with
// __fmul_rn/__fadd_rn (no FMA contraction): the order of the plain version
// (ops/conv.py sep_conv2d), so kernel and plain version agree bit for bit.
// (The TPU kernel ran the H pass first.)
//
// Bound on the H100: one f32 read and one write per pixel of device
// memory (~8 B/px; the halo adds ~(52*148)/(32*128) - 1 = 88% re-reads,
// served by L2), but the passes read shared memory n_taps times per output
// of each pass, ~(52/32 + 1) * n_taps = 55 loads/px at 21 taps: shared
// memory bandwidth, not device memory, bounds this simple form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 32, TW = 128;         // output tile
constexpr int THREADS = 256;             // TW columns x 2 rows per step
constexpr int RSTEP = THREADS / TW;
constexpr int MAX_TAPS = 97;             // hw <= 48: 176 KB of shared memory

struct Taps {
  float t[MAX_TAPS];
};

__global__ void __launch_bounds__(THREADS)
gaussian_sep_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int H, int W, Taps taps, int n_taps) {
  extern __shared__ float smem[];
  const int hw = (n_taps - 1) / 2;
  const int RH = TH + 2 * hw, RW = TW + 2 * hw;
  float* in_s = smem;              // [RH][RW]: tile + halo
  float* h_s = smem + RH * RW;     // [RH][TW]: after the W pass
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* src = in + plane;

  for (int r = ty; r < RH; r += RSTEP) {
    const int y = y0 - hw + r;
    const bool row_ok = y >= 0 && y < H;
    for (int c = tx; c < RW; c += TW) {
      const int x = x0 - hw + c;
      in_s[r * RW + c] =
          (row_ok && x >= 0 && x < W) ? src[(size_t)y * W + x] : 0.0f;
    }
  }
  __syncthreads();

  for (int r = ty; r < RH; r += RSTEP) {
    const float* row = in_s + r * RW + tx;
    float acc = __fmul_rn(row[0], taps.t[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(row[k], taps.t[k]));
    h_s[r * TW + tx] = acc;
  }
  __syncthreads();

  const int x = x0 + tx;
  if (x >= W) return;
  for (int r = ty; r < TH; r += RSTEP) {
    const int y = y0 + r;
    if (y >= H) break;
    const float* col = h_s + r * TW + tx;
    float acc = __fmul_rn(col[0], taps.t[0]);
    for (int k = 1; k < n_taps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(col[k * TW], taps.t[k]));
    out[plane + (size_t)y * W + x] = acc;
  }
}

}  // namespace

// planes, out: f32 [N,H,W]; taps: n_taps (odd, <= MAX_TAPS) host floats.
extern "C" int pft_gaussian_sep(const void* planes, void* out,
                                const float* taps, int n_taps, int N, int H,
                                int W, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  Taps t{};
  for (int i = 0; i < n_taps; ++i) t.t[i] = taps[i];
  const int hw = (n_taps - 1) / 2;
  const size_t smem =
      sizeof(float) * ((size_t)(TH + 2 * hw) * (TW + 2 * hw) +
                       (size_t)(TH + 2 * hw) * TW);
  cudaError_t err = cudaFuncSetAttribute(
      gaussian_sep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  gaussian_sep_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)planes, (float*)out, H, W, t, n_taps);
  return (int)cudaGetLastError();
}
