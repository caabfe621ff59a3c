// Noisefilter certificate sweep: packed big-cluster certificates.
//
// Replaces libpillowfight_tpu/ops/pallas/noise_kernel.py `_cert_band_kernel`
// (via `_cert_sweep`, orchestrated by `small_cluster_mask_pallas`).
//
// For each mask pixel p, the radius-J graph ball of p inside the
// (2J+1)^2 window around p is grown on a bitboard (bit (dy+J)*(2J+1) +
// (dx+J) = offset (dy, dx)) by J king-move dilation steps gated by the
// window's mask bits; p is a certificate when the ball has >= thresh
// members. The caller floods the mask from the certificates: any cluster
// of > k pixels holds a pixel whose radius-ceil(k/2) ball has >= k+1
// members, and a cluster of <= k pixels never does.
//
// Design: one thread per packed word (q, x) handles the 32 rows
// 32q .. 32q+31 of column x. It keeps a ring of 2J+1 horizontal strips
// (bit dx+J = mask[y][x+dx]) in registers, so each row of the halo is read
// once per thread, straight from device memory: there is no band and no
// carry, and neighbours outside the page read as 0 (the TPU kernel's top
// pad and lane wrap tricks are not needed). The cert and mask bits of the
// 32 rows are written as one word each, aligned to the page rows, ready for
// the packed flood. The board is ceil((2J+1)^2/32) words (one at J <= 2),
// unrolled per J by the template; popcount is __popc.
//
// Bound on the H100: integer ops. ~ (2J+1) byte loads per pixel (L1 hits:
// neighbouring threads read neighbouring bytes) and J dilation steps of a
// few dozen ops per board word; 1 B/px of device-memory read, 1/16 B/px
// written.

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

template <int J>
__global__ void noise_cert_kernel(const uint8_t* __restrict__ plane,
                                  uint32_t* __restrict__ cert,
                                  uint32_t* __restrict__ maskw, int H, int W,
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
    if (!((strips[J] >> J) & 1u)) continue;  // not a mask pixel

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
    mw |= 1u << k;
    if (size >= thresh) cw |= 1u << k;
  }
  const size_t o = (size_t)b * Hq * W + i;
  cert[o] = cw;
  maskw[o] = mw;
}

template <int J>
void launch(const void* plane, void* cert, void* maskw, int B, int H, int W,
            int thresh, cudaStream_t s) {
  const int Hq = (H + 31) / 32;
  dim3 grid((unsigned)(((size_t)Hq * W + THREADS - 1) / THREADS), B);
  noise_cert_kernel<J><<<grid, THREADS, 0, s>>>(
      (const uint8_t*)plane, (uint32_t*)cert, (uint32_t*)maskw, H, W, Hq,
      thresh);
}

}  // namespace

// plane: uint8/bool [B,H,W] -> cert, maskw: uint32 [B,ceil(H/32),W].
// j: board radius, 1..8.
extern "C" int pft_noise_cert(const void* plane, void* cert, void* maskw,
                              int B, int H, int W, int j, int thresh,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (j) {
    case 1: launch<1>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 2: launch<2>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 3: launch<3>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 4: launch<4>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 5: launch<5>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 6: launch<6>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 7: launch<7>(plane, cert, maskw, B, H, W, thresh, s); break;
    case 8: launch<8>(plane, cert, maskw, B, H, W, thresh, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
