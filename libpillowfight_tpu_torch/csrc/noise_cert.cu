// Noisefilter ball sweeps: packed big-cluster certificates, and the
// direct small-cluster ball count.
//
// Replaces libpillowfight_tpu/ops/pallas/noise_kernel.py `_cert_band_kernel`
// (via `_cert_sweep`, orchestrated by `small_cluster_mask_pallas`) and
// `_noise_band_kernel` (via `_noise_sweep` and `_ball_sweep`, which the
// reference takes for k = 1). Both TPU kernels share `_board_consts` and
// `_shift_board`; here they share one template.
//
// For each mask pixel p, the radius-J graph ball of p inside the
// (2J+1)^2 window around p is grown on a bitboard (bit (dy+J)*(2J+1) +
// (dx+J) = offset (dy, dx)) by J king-move dilation steps gated by the
// window's mask bits.
// - Certificates (J = ceil(k/2), thresh = k+1): p is a certificate when
//   the ball has >= thresh members. The caller floods the mask from the
//   certificates: any cluster of > k pixels holds a pixel whose
//   radius-ceil(k/2) ball has >= k+1 members, and a cluster of <= k pixels
//   never does.
// - Ball count (J = k, thresh = k): p is kept when the ball has <= k
//   members, exactly when its cluster has <= k pixels (a cluster of <= k
//   pixels has diameter < k, so the ball is the cluster; a bigger one
//   keeps every BFS layer up to k non-empty).
//
// Design: one thread per packed word (q, x) handles the 32 rows
// 32q .. 32q+31 of column x. It keeps a ring of 2J+1 horizontal strips
// (bit dx+J = mask[y][x+dx]) in registers, so each row of the halo is read
// once per thread, straight from device memory: there is no band and no
// carry, and neighbours outside the page read as 0 (the TPU kernel's top
// pad and lane wrap tricks are not needed). Certificates come out as cert
// and mask words, one each for the 32 rows, aligned to the page rows,
// ready for the packed flood; the ball count writes one byte per pixel.
// The board is ceil((2J+1)^2/32) words (one at J <= 2, 31 at J = 15),
// unrolled per J by the template; popcount is __popc. At large J the
// boards do not fit in registers and spill to local memory (L1).
//
// Bound on the H100: integer ops. ~ (2J+1) byte loads per pixel (L1 hits:
// neighbouring threads read neighbouring bytes) and J dilation steps of a
// few dozen ops per board word; 1 B/px of device-memory read, 1/16 B/px
// (certificates) or 1 B/px (ball count) written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int NW>
__device__ __forceinline__ void shift_board(const uint32_t* in, int amt,
                                            uint32_t* out) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t v;
    if (amt > 0) {
      v = in[w] << amt;
      if (w > 0) v |= in[w - 1] >> (32 - amt);
    } else {
      const int a = -amt;
      v = in[w] >> a;
      if (w + 1 < NW) v |= in[w + 1] << (32 - a);
    }
    out[w] = v;
  }
}

// Word w of the board bits b (< nb) with b % s != skip (skip < 0: none).
__device__ __forceinline__ uint32_t board_word(int w, int s, int nb,
                                               int skip) {
  uint32_t v = 0;
  for (int bit = 0; bit < 32; ++bit) {
    const int b = w * 32 + bit;
    if (b < nb && (skip < 0 || b % s != skip)) v |= 1u << bit;
  }
  return v;
}

// BALL = false: cert/maskw are u32 words [B,Hq,W] (certificates: size >=
// thresh). BALL = true: out0 is a u8 plane [B,H,W] (size <= thresh), out1
// unused.
template <int J, bool BALL>
__global__ void noise_ball_kernel(const uint8_t* __restrict__ plane,
                                  void* __restrict__ out0,
                                  uint32_t* __restrict__ out1, int H, int W,
                                  int Hq, int thresh) {
  constexpr int S = 2 * J + 1, NB = S * S, NW = (NB + 31) / 32;
  constexpr int CB = J * S + J;  // the centre bit
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * W) return;
  const int q = (int)(i / W), x = (int)(i % W);
  const uint8_t* page = plane + (size_t)b * H * W;

  uint32_t board[NW], valp[NW], valm[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    board[w] = board_word(w, S, NB, -1);
    valp[w] = board_word(w, S, NB, 0);      // +1 shift: dx = -J aliased
    valm[w] = board_word(w, S, NB, S - 1);  // -1 shift: dx = +J aliased
  }

  auto strip_of = [&](int y) -> uint32_t {
    uint32_t s = 0;
    if (y < 0 || y >= H) return s;
    const uint8_t* row = page + (size_t)y * W;
#pragma unroll
    for (int dx = -J; dx <= J; ++dx) {
      const int xx = x + dx;
      if (xx >= 0 && xx < W && row[xx]) s |= 1u << (dx + J);
    }
    return s;
  };

  const int y0 = q * 32;
  uint32_t strips[S];  // strips[d] = row y - J + d
  strips[0] = 0;
#pragma unroll
  for (int d = 0; d < S - 1; ++d) strips[d + 1] = strip_of(y0 - J + d);

  uint8_t* small = BALL ? (uint8_t*)out0 + (size_t)b * H * W : nullptr;
  uint32_t cw = 0, mw = 0;
  const int n = min(32, H - y0);
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int d = 0; d < S - 1; ++d) strips[d] = strips[d + 1];
    strips[S - 1] = strip_of(y0 + k + J);

    uint32_t M[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) M[w] = 0;
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const int off = d * S, w = off >> 5, o = off & 31;
      M[w] |= strips[d] << o;
      if (o + S > 32 && w + 1 < NW) M[w + 1] |= strips[d] >> (32 - o);
    }
    if (!((strips[J] >> J) & 1u)) {  // not a mask pixel
      if (BALL) small[(size_t)(y0 + k) * W + x] = 0;
      continue;
    }

    uint32_t r[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) r[w] = (w == (CB >> 5)) ? 1u << (CB & 31) : 0u;
#pragma unroll
    for (int step = 0; step < J; ++step) {
      uint32_t sp[NW], sm[NW], t[NW], up[NW], dn[NW];
      shift_board<NW>(r, 1, sp);
      shift_board<NW>(r, -1, sm);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        t[w] = r[w] | (sp[w] & valp[w]) | (sm[w] & valm[w]);
      shift_board<NW>(t, S, up);
      shift_board<NW>(t, -S, dn);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        r[w] = (t[w] | up[w] | dn[w]) & board[w] & M[w];
    }
    int size = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) size += __popc(r[w]);
    if (BALL) {
      small[(size_t)(y0 + k) * W + x] = size <= thresh;
    } else {
      mw |= 1u << k;
      if (size >= thresh) cw |= 1u << k;
    }
  }
  if (!BALL) {
    const size_t o = (size_t)b * Hq * W + i;
    ((uint32_t*)out0)[o] = cw;
    out1[o] = mw;
  }
}

// Launch the instantiation for board radius j (1 <= j <= MAXJ).
template <bool BALL, int MAXJ, int J = 1>
int launch(int j, const void* plane, void* out0, void* out1, int B, int H,
           int W, int thresh, cudaStream_t s) {
  if constexpr (J > MAXJ) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (j != J)
      return launch<BALL, MAXJ, J + 1>(j, plane, out0, out1, B, H, W, thresh,
                                       s);
    const int Hq = (H + 31) / 32;
    dim3 grid((unsigned)(((size_t)Hq * W + THREADS - 1) / THREADS), B);
    noise_ball_kernel<J, BALL><<<grid, THREADS, 0, s>>>(
        (const uint8_t*)plane, out0, (uint32_t*)out1, H, W, Hq, thresh);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// plane: uint8/bool [B,H,W] -> cert, maskw: uint32 [B,ceil(H/32),W].
// j: board radius, 1..8 (k <= 15).
extern "C" int pft_noise_cert(const void* plane, void* cert, void* maskw,
                              int B, int H, int W, int j, int thresh,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  return launch<false, 8>(j, plane, cert, maskw, B, H, W, thresh,
                          (cudaStream_t)stream);
}

// plane: uint8/bool [B,H,W] -> small: uint8 [B,H,W], 1 where the pixel's
// cluster has <= k members. 1 <= k <= 15.
extern "C" int pft_noise_ball(const void* plane, void* small, int B, int H,
                              int W, int k, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  return launch<true, 15>(k, plane, small, nullptr, B, H, W, k,
                          (cudaStream_t)stream);
}
