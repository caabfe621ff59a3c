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
// Order: the W pass first, then H, each sum a left fold from the first
// tap with __fmul_rn/__fadd_rn (no FMA contraction), every tap folded,
// also where it meets the zero padding: the order of the plain version
// (ops/conv.py sep_conv2d), so kernel and plain version agree bit for
// bit. The plain version skips a tap that is 0 and does not multiply by a
// tap that is 1; the generic instance does the same, the hw = 10 instance
// is taken only for taps that are neither. (The TPU kernel ran the H pass
// first.)
//
// Bound on the H100: operations. The folds without FMA are 2 x 21 FMUL
// and 2 x 20 FADD a pixel at 21 taps (the first tap of a fold has no add),
// 82 issue slots, against 8 B/px of device memory: 0.0426 ms of the FP32
// pipes against 0.0416 ms of bytes at A4 x 2.
//
// Design of the hw = 10 instance (`blur_strip_kernel<HW>`, every path's
// 21 taps), against that bound:
// - a block owns a strip of SW = 256 output columns and walks down a
//   segment of its rows, in groups of G = 2 HW + 1 rows; the host picks
//   the segment height so that the blocks fill whole waves of the card;
// - each group's input rows (the strip plus PAD = 12 columns each side)
//   arrive by 16-byte cp.async one group ahead, zero-filled outside the
//   page, so the copy of group g + 1 overlaps the folds of group g;
// - W pass: a lane computes 8 adjacent outputs from one register window
//   of 32 floats, 8 shared loads of 16 bytes for 8 outputs (the first
//   version took 21 shared loads an output);
// - H pass: a thread owns a column and keeps the G running folds of the
//   next G outputs of that column in registers: each new W-pass row adds
//   its term to all G of them, tap k to the output k rows above the last,
//   so every fold still runs from tap 0 in order, one shared load a row
//   and pixel, and the vertical halo costs 2 HW rows a segment, not 63% of
//   a 32-row tile;
// - taps are kernel parameters indexed at compile time: constant-bank
//   operands of FMUL, no register and no load;
// - the shared-memory attributes and the occupancy are set up once a
//   device.
// The generic instance (`blur_tile_kernel`, 1 to 97 taps) is the first
// version: a 32 x 128 tile with its halo in shared memory, W pass then H
// pass, one output a thread and pass.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // wait until at most N groups of copies are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the strip kernel, hw known at compile time

constexpr int SW = 256;    // output columns of a strip, one a thread in H
constexpr int OUTS = 8;    // W-pass outputs a lane
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;  // groups of input rows in shared memory

template <int HW>
struct Strip {
  static constexpr int G = 2 * HW + 1;            // taps, rows a group
  static constexpr int PAD = (HW + 3) / 4 * 4;    // halo columns, aligned
  static constexpr int IW = SW + 2 * PAD;         // input row of a strip
  static constexpr int WIN = (OUTS + HW + PAD + 3) / 4 * 4;  // lane window
  static constexpr size_t SMEM = sizeof(float) * (STAGES * G * IW + G * SW);
};

template <int HW>
struct StripTaps {
  float t[2 * HW + 1];
};

template <int HW, bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
blur_strip_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, int strips, int segs, int seg_rows,
                  StripTaps<HW> taps) {
  using S = Strip<HW>;
  constexpr int G = S::G, PAD = S::PAD, IW = S::IW, WIN = S::WIN;
  extern __shared__ __align__(16) float strip_smem[];
  float* in_s = strip_smem;                   // [STAGES][G][IW]: input
  float* h_s = strip_smem + STAGES * G * IW;  // [G][SW]: after the W pass

  const int tid = threadIdx.x;
  const int strip = blockIdx.x % strips;
  const int seg = (blockIdx.x / strips) % segs;
  const int n = blockIdx.x / strips / segs;
  const int x0 = strip * SW;
  const int y_begin = seg * seg_rows;
  const int y_end = min(y_begin + seg_rows, H);
  // W-pass rows y_begin - HW .. y_end - 1 + HW, in groups of G
  const int n_groups = (y_end - y_begin + 2 * HW + G - 1) / G;
  const float* src = in + (size_t)n * H * W;
  float* dst = out + (size_t)n * H * W;

  auto issue = [&](int g) {
    float* buf = in_s + (g % STAGES) * G * IW;
    const int r0 = y_begin - HW + g * G;
    if (VEC) {
      for (int q = tid; q < G * (IW / 4); q += THREADS) {
        const int s = q / (IW / 4), c = 4 * (q % (IW / 4));
        const int y = r0 + s, x = x0 - PAD + c;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        cp_async16(buf + s * IW + c, ok ? src + (size_t)y * W + x : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < G * IW; q += THREADS) {
        const int s = q / IW, c = q % IW;
        const int y = r0 + s, x = x0 - PAD + c;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        cp_async4(buf + s * IW + c, ok ? src + (size_t)y * W + x : src,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0.0f;

  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = lane * OUTS;
  const int x = x0 + tid;

  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < n_groups) issue(g);
    cp_async_commit();
  }
  for (int g = 0; g < n_groups; ++g) {
    if (g + STAGES - 1 < n_groups) issue(g + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // group g has arrived
    __syncthreads();

    // W pass: warp w takes rows w, w + WARPS, ... of the group
    const float* buf = in_s + (g % STAGES) * G * IW;
    for (int s = warp; s < G; s += WARPS) {
      const int y = y_begin - HW + g * G + s;
      float o[OUTS];
      if (y < 0 || y >= H) {  // the H pass pads with zero rows
#pragma unroll
        for (int j = 0; j < OUTS; ++j) o[j] = 0.0f;
      } else {
        float w[WIN];
        const float4* row = reinterpret_cast<const float4*>(buf + s * IW + c0);
#pragma unroll
        for (int q = 0; q < WIN / 4; ++q) {
          const float4 v = row[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < OUTS; ++j) {
          float a = __fmul_rn(w[j - HW + PAD], taps.t[0]);
#pragma unroll
          for (int k = 1; k < G; ++k)
            a = __fadd_rn(a, __fmul_rn(w[j + k - HW + PAD], taps.t[k]));
          o[j] = a;
        }
      }
      float4* hrow = reinterpret_cast<float4*>(h_s + s * SW + c0);
#pragma unroll
      for (int q = 0; q < OUTS / 4; ++q)
        hrow[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                              o[4 * q + 3]);
    }
    __syncthreads();

    // H pass: W-pass row i = g G + s is tap k of output i - k of the
    // segment, whose running fold lives in acc[(s - k) mod G]
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const float hv = h_s[s * SW + tid];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int slot = ((s - k) % G + G) % G;
        if (k == 0)
          acc[slot] = __fmul_rn(hv, taps.t[0]);
        else
          acc[slot] = __fadd_rn(acc[slot], __fmul_rn(hv, taps.t[k]));
      }
      // output i - 2 HW has its last tap
      const int y = y_begin + g * G + s - 2 * HW;
      if (y >= y_begin && y < y_end && x < W)
        dst[(size_t)y * W + x] = acc[(s + 1) % G];
    }
  }
}

// ---- the tile kernel, any odd tap count up to MAX_TAPS

constexpr int TH = 32, TW = 128;  // output tile
constexpr int RSTEP = THREADS / TW;
constexpr int MAX_TAPS = 97;      // hw <= 48: 176 KB of shared memory

struct TileTaps {
  float t[MAX_TAPS];   // the taps that are not 0, in order
  int off[MAX_TAPS];   // their offsets from the centre
  int n;               // how many
};

__device__ __forceinline__ float term(float v, float t) {
  return t == 1.0f ? v : __fmul_rn(v, t);  // as the plain version
}

__global__ void __launch_bounds__(THREADS)
blur_tile_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int H, int W, int hw, int tiles_x, int tiles_y,
                 TileTaps taps) {
  extern __shared__ float tile_smem[];
  const int RH = TH + 2 * hw, RW = TW + 2 * hw;
  float* in_s = tile_smem;             // [RH][RW]: tile + halo
  float* h_s = tile_smem + RH * RW;    // [RH][TW]: after the W pass
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int bx = blockIdx.x % tiles_x, by = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / tiles_x / tiles_y;
  const int y0 = by * TH, x0 = bx * TW;
  const size_t plane = (size_t)n * H * W;
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
    const int y = y0 - hw + r;
    float acc = 0.0f;  // no tap: zeros, as the plain version
    if (y >= 0 && y < H && taps.n > 0) {  // the H pass pads with zero rows
      const float* row = in_s + r * RW + tx + hw;
      acc = term(row[taps.off[0]], taps.t[0]);
      for (int u = 1; u < taps.n; ++u)
        acc = __fadd_rn(acc, term(row[taps.off[u]], taps.t[u]));
    }
    h_s[r * TW + tx] = acc;
  }
  __syncthreads();

  const int x = x0 + tx;
  if (x >= W) return;
  for (int r = ty; r < TH; r += RSTEP) {
    const int y = y0 + r;
    if (y >= H) break;
    const float* col = h_s + (r + hw) * TW + tx;
    float acc = 0.0f;
    if (taps.n > 0) {
      acc = term(col[taps.off[0] * TW], taps.t[0]);
      for (int u = 1; u < taps.n; ++u)
        acc = __fadd_rn(acc, term(col[taps.off[u] * TW], taps.t[u]));
    }
    out[plane + (size_t)y * W + x] = acc;
  }
}

size_t tile_smem_bytes(int hw) {
  return sizeof(float) * ((size_t)(TH + 2 * hw) * (TW + 2 * hw) +
                          (size_t)(TH + 2 * hw) * TW);
}

// Once a device: the shared-memory attributes, and the blocks of the strip
// kernel the card holds at once (SMs x blocks an SM), for the current
// device. A setup that failed is tried again at the next call.
constexpr int MAX_DEVICES = 64;
std::atomic<int> strip_slots_of[MAX_DEVICES];  // 0: not set up yet

cudaError_t setup(int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    *slots = strip_slots_of[dev].load(std::memory_order_acquire);
    if (*slots > 0) return cudaSuccess;
  }
  const int smem10 = (int)Strip<10>::SMEM;
  err = cudaFuncSetAttribute(blur_strip_kernel<10, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem10);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blur_strip_kernel<10, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem10);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blur_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tile_smem_bytes((MAX_TAPS - 1) / 2));
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blur_strip_kernel<10, true>, THREADS, smem10);
  if (err != cudaSuccess) return err;
  *slots = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < MAX_DEVICES)
    strip_slots_of[dev].store(*slots, std::memory_order_release);
  return cudaSuccess;
}

// The segment height (rows of output a block) that makes the fewest
// group steps a block times waves of blocks; segments beyond two waves
// only add halo rows.
int segment_rows(int N, int H, int strips, int hw, int slots) {
  const int G = 2 * hw + 1;
  const long most = 2L * slots / ((long)strips * N) + 1;
  long best_cost = -1;
  int best = H;
  for (int s = 1; s <= H && s <= most; ++s) {
    const int rows = (H + s - 1) / s;
    const long segs = (H + rows - 1) / rows;
    const long blocks = segs * strips * (long)N;
    const long waves = (blocks + slots - 1) / slots;
    const long cost = waves * ((rows + 2 * hw + G - 1) / G);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rows;
    }
  }
  return best;
}

// The strip kernel for 21 taps, none of them 0 or 1.
cudaError_t launch_strip(const float* planes, float* out, const float* taps,
                         int N, int H, int W, int slots, cudaStream_t stream) {
  constexpr int HW = 10;
  StripTaps<HW> t{};
  for (int i = 0; i < 2 * HW + 1; ++i) t.t[i] = taps[i];
  const int strips = (W + SW - 1) / SW;
  const int rows = segment_rows(N, H, strips, HW, slots);
  const int segs = (H + rows - 1) / rows;
  const long blocks = (long)strips * segs * N;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)planes % 16 == 0) && (W % 4 == 0);
  const size_t smem = Strip<HW>::SMEM;
  if (vec)
    blur_strip_kernel<HW, true><<<(unsigned)blocks, THREADS, smem, stream>>>(
        planes, out, H, W, strips, segs, rows, t);
  else
    blur_strip_kernel<HW, false><<<(unsigned)blocks, THREADS, smem, stream>>>(
        planes, out, H, W, strips, segs, rows, t);
  return cudaGetLastError();
}

// The tile kernel for any odd count up to MAX_TAPS: it skips a tap of 0
// and does not multiply by a tap of 1, as the plain version.
cudaError_t launch_tile(const float* planes, float* out, const float* taps,
                        int n_taps, int N, int H, int W, cudaStream_t stream) {
  const int hw = (n_taps - 1) / 2;
  TileTaps t{};
  for (int i = 0; i < n_taps; ++i) {
    if (taps[i] == 0.0f) continue;
    t.t[t.n] = taps[i];
    t.off[t.n] = i - hw;
    ++t.n;
  }
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long blocks = (long)tiles_x * tiles_y * N;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  blur_tile_kernel<<<(unsigned)blocks, THREADS, tile_smem_bytes(hw), stream>>>(
      planes, out, H, W, hw, tiles_x, tiles_y, t);
  return cudaGetLastError();
}

}  // namespace

// planes, out: f32 [N,H,W]; taps: n_taps (odd, <= MAX_TAPS) host floats.
// *instance: 1 when the strip kernel ran (21 taps, none 0 or 1), 0 when
// the tile kernel ran.
extern "C" int pft_gaussian_sep(const void* planes, void* out,
                                const float* taps, int n_taps, int N, int H,
                                int W, int* instance, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  bool strip = n_taps == 21;
  for (int i = 0; i < n_taps; ++i)
    strip = strip && taps[i] != 0.0f && taps[i] != 1.0f;
  *instance = strip ? 1 : 0;
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  int slots = 1;
  const cudaError_t err = setup(&slots);
  if (err != cudaSuccess) return (int)err;
  const float* in = (const float*)planes;
  if (strip)
    return (int)launch_strip(in, (float*)out, taps, N, H, W, slots,
                             (cudaStream_t)stream);
  return (int)launch_tile(in, (float*)out, taps, n_taps, N, H, W,
                          (cudaStream_t)stream);
}
