// Noisefilter ball sweeps: packed big-cluster certificates, and the
// direct small-cluster ball count.
//
// Replaces libpillowfight_tpu/ops/pallas/noise_kernel.py `_cert_band_kernel`
// (via `_cert_sweep`, orchestrated by `small_cluster_mask_pallas`) and
// `_noise_band_kernel` (via `_noise_sweep` and `_ball_sweep`, which the
// reference takes for k = 1). Both TPU kernels share `_board_consts` and
// `_shift_board`; here the two kernels share the staging and the board
// work.
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
// The board is ceil((2J+1)^2/32) words (one at J <= 2, 31 at J = 15),
// unrolled per J by the template; popcount is __popc. Neighbours outside
// the page read as 0 (the TPU kernels' top pad and lane wrap tricks are
// not needed).
//
// Both read 1 B/px; the certificates write 1/16 B/px (0.0065 ms at A4 300
// dpi x 2 and 3.35 TB/s), the ball count 1 B/px (0.0104 ms). Beyond the
// bytes the work is integer instructions, most of them on the few rows
// that hold a mask pixel. A block takes 32 rows x 256 columns, a warp a
// word column of 32 x 32:
// - The block stages its band (32 + 2J rows, its columns + 16 each side;
//   J <= 15) in shared memory as packed bits: a thread turns 16 bytes of
//   one 16-byte load into 16 bits (the not-zero test of four bytes at once
//   by a carry trick, gathered by one multiply). A strip (bits x-J .. x+J
//   of a row) is then one funnel shift of two shared words. Planes whose
//   rows are not 16-byte aligned stage byte by byte.
// - A warp transposes its 32 centre words (5 shuffle steps) into the mask
//   words, and ORs them across lanes: only rows with a mask pixel in the
//   warp's 32 columns take the board work, every lane in step.
// - The ball only grows, so a pixel is decided once its ball has more
//   members than the test asks about (a certificate at `thresh`, not
//   small past `thresh`), or once a step adds nothing (the ball is its
//   cluster's part in the window, and later steps add nothing either):
//   the warp stops dilating once every lane has decided, and a step builds
//   only the window rows it can reach (rows J-s .. J+s at step s).
// - Certificates and mask words come out one each for 32 page rows,
//   aligned to the page rows as the packed flood reads them.
// - The ball count at J = 1, the only J on a path, needs no board: the
//   ball after one step is the pixel and its mask neighbours, so "small"
//   is m & ~(OR of the 8 neighbours) on whole 32-pixel row words, one
//   lane a row. Its results come back as row words (J > 1: transposed
//   from the column words); a lane expands half a row word to 16 bytes
//   (x 0x00204081 spreads four bits to four bytes), so that one store
//   instruction writes 32 contiguous bytes of each of 16 rows. Planes
//   that do not allow 16-byte stores write bytes, a lane a column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // word columns of a block, one a warp
constexpr int THREADS = 32 * WARPS;
constexpr int BAND_WORDS = WARPS + 2;       // staged words a row
constexpr int BAND_CHUNKS = 2 * WARPS + 2;  // 16-column loads a row
constexpr int MAX_J = 15;  // a strip of 2J+1 bits within one funnel shift

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

// Bit i of the result set where byte i of the 16 is not 0: bit 7 of each
// byte by a carry, then bits 7, 15, 23, 31 gathered to bits 28..31 by a
// multiply whose partial products never overlap.
__device__ __forceinline__ uint32_t nonzero_bits16(uint4 v) {
  auto four = [](uint32_t u) {
    const uint32_t hi = (((u & 0x7f7f7f7fu) + 0x7f7f7f7fu) | u) & 0x80808080u;
    return (hi * 0x00204081u) >> 28;
  };
  return four(v.x) | four(v.y) << 4 | four(v.z) << 8 | four(v.w) << 12;
}

// Byte i of the result = bit i of n (i < 4): the partial products of the
// multiply never overlap, and bit i lands on bit 8i from n << 7i.
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

// 32 x 32 bit transpose across a warp: lane k holds row word k (bit x =
// pixel (k, x)); lane x gets column word x (bit k = pixel (k, x)). Its
// own inverse.
__device__ __forceinline__ uint32_t transpose32(uint32_t a, int lane) {
  const uint32_t keep[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = keep[i];
    const uint32_t o = __shfl_xor_sync(FULL, a, s);
    a = (lane & s) ? (a & ~m) | ((o >> s) & m) : (a & m) | ((o << s) & ~m);
  }
  return a;
}

// A block's band: band[r][w] bit i = pixel (y0 - J + r, xbase - 32 + 32w
// + i), 0 outside the page. vec: rows 16-byte aligned (W % 16 == 0 and an
// aligned plane).
template <int J>
__device__ __forceinline__ void stage_band(uint32_t (*band)[BAND_WORDS],
                                           const uint8_t* page, int H, int W,
                                           int y0, int xbase, bool vec) {
  constexpr int R = 32 + 2 * J;
  const int tid = threadIdx.x;
  // 16-column chunks, chunk c = columns xbase - 16 + 16c; the outer
  // halves of the first and last words stay 0
  constexpr int CHUNKS = R * BAND_CHUNKS;
  uint16_t* half = (uint16_t*)&band[0][0];
  auto at = [&](int i) {  // staged row r, chunk c -> u16 index, y, x
    const int r = i / BAND_CHUNKS, c = i - r * BAND_CHUNKS;
    return make_int3(r * 2 * BAND_WORDS + c + 1, y0 - J + r,
                     xbase - 16 + 16 * c);
  };
  if (vec) {  // every load first, so that they are in flight together
    constexpr int PASSES = (CHUNKS + THREADS - 1) / THREADS;
    uint4 v[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = tid + p * THREADS;
      const int3 u = at(i);
      v[p] = i < CHUNKS && u.y >= 0 && u.y < H && u.z >= 0 && u.z < W
                 ? *(const uint4*)(page + (size_t)u.y * W + u.z)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = tid + p * THREADS;
      if (i < CHUNKS) half[at(i).x] = (uint16_t)nonzero_bits16(v[p]);
    }
  } else {
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int3 u = at(i);
      uint32_t bits = 0;
      if (u.y >= 0 && u.y < H) {
        const uint8_t* row = page + (size_t)u.y * W;
        for (int k = 0; k < 16; ++k)
          if (u.z + k >= 0 && u.z + k < W && row[u.z + k]) bits |= 1u << k;
      }
      half[u.x] = (uint16_t)bits;
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    half[r * 2 * BAND_WORDS] = 0;
    half[r * 2 * BAND_WORDS + 2 * BAND_WORDS - 1] = 0;
  }
  __syncthreads();
}

// The board work of a warp on its staged band. mw: this lane's column
// word of mask pixels (lane = column 32 * warp + lane of the block, bit k
// = row k). Returns the column word of the mask pixels whose ball after J
// steps has >= thresh members (SMALL = false: certificates) or <= thresh
// members (SMALL = true: the ball count).
template <int J, bool SMALL>
__device__ __forceinline__ uint32_t ball_words(
    const uint32_t (*band)[BAND_WORDS], uint32_t mw, int warp, int lane,
    int thresh) {
  constexpr int S = 2 * J + 1, NB = S * S, NW = (NB + 31) / 32;
  constexpr int CB = J * S + J;  // the centre bit
  constexpr uint32_t SMASK = (1u << S) - 1u;
  // rows of the warp's columns with a mask pixel
  uint32_t rows = __reduce_or_sync(FULL, mw);
  // a strip: bits x-J .. x+J of a staged row, from words a and a + 1
  const int col = 32 * (warp + 1) + lane - J, a = col >> 5, off = col & 31;

  uint32_t board[NW], valp[NW], valm[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    board[w] = board_word(w, S, NB, -1);
    valp[w] = board_word(w, S, NB, 0);      // +1 shift: dx = -J aliased
    valm[w] = board_word(w, S, NB, S - 1);  // -1 shift: dx = +J aliased
  }
  uint32_t out = 0;
  while (rows) {
    const int k = __ffs(rows) - 1;  // page row y0 + k, staged row J + k
    rows &= rows - 1;
    const bool centre = (mw >> k) & 1u;
    uint32_t M[NW], r[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      M[w] = 0;
      r[w] = (centre && w == (CB >> 5)) ? 1u << (CB & 31) : 0u;
    }
    // window row d = staged row k + d
    auto add_row = [&](int d) {
      const uint32_t* p = &band[k + d][a];
      const uint32_t s = __funnelshift_r(p[0], p[1], off) & SMASK;
      const int o = (d * S) & 31, w = (d * S) >> 5;
      M[w] |= s << o;
      if (o + S > 32 && w + 1 < NW) M[w + 1] |= s >> (32 - o);
    };
    add_row(J);
    int size = centre;
    bool grew = true;
#pragma unroll
    for (int step = 1; step <= J; ++step) {
      const bool decided = SMALL ? size > thresh : size >= thresh;
      if (__all_sync(FULL, !centre || decided || !grew)) break;
      add_row(J - step);
      add_row(J + step);
      uint32_t sp[NW], sm[NW], t[NW], up[NW], dn[NW];
      shift_board<NW>(r, 1, sp);
      shift_board<NW>(r, -1, sm);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        t[w] = r[w] | (sp[w] & valp[w]) | (sm[w] & valm[w]);
      shift_board<NW>(t, S, up);
      shift_board<NW>(t, -S, dn);
      const int was = size;
      size = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        r[w] = (t[w] | up[w] | dn[w]) & board[w] & M[w];
        size += __popc(r[w]);
      }
      grew = size != was;
    }
    if (centre && (SMALL ? size <= thresh : size >= thresh)) out |= 1u << k;
  }
  return out;
}

// cert, maskw: u32 words [B,Hq,W].
template <int J>
__global__ void __launch_bounds__(THREADS)
    noise_cert_kernel(const uint8_t* __restrict__ plane,
                      uint32_t* __restrict__ cert,
                      uint32_t* __restrict__ maskw, int H, int W, int Hq,
                      int thresh, bool vec) {
  __shared__ uint32_t band[32 + 2 * J][BAND_WORDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, q = blockIdx.y, y0 = q * 32;
  const int xbase = blockIdx.x * 32 * WARPS;
  stage_band<J>(band, plane + (size_t)b * H * W, H, W, y0, xbase, vec);
  const uint32_t mw = transpose32(band[J + lane][warp + 1], lane);
  const uint32_t cw = ball_words<J, false>(band, mw, warp, lane, thresh);
  const int x = xbase + 32 * warp + lane;
  if (x < W) {
    const size_t o = ((size_t)b * Hq + q) * W + x;
    cert[o] = cw;
    maskw[o] = mw;
  }
}

// small: u8 plane [B,H,W], 1 where a mask pixel's ball after J steps has
// <= thresh members. vec: W % 16 == 0 and both planes 16-byte aligned.
template <int J>
__global__ void __launch_bounds__(THREADS)
    noise_ball_kernel(const uint8_t* __restrict__ plane,
                      uint8_t* __restrict__ small, int H, int W, int thresh,
                      bool vec) {
  __shared__ uint32_t band[32 + 2 * J][BAND_WORDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, y0 = blockIdx.y * 32;
  const int x0 = blockIdx.x * 32 * WARPS + 32 * warp;  // the warp's columns
  stage_band<J>(band, plane + (size_t)b * H * W, H, W, y0,
                blockIdx.x * 32 * WARPS, vec);
  // row word (lane = row y0 + lane, bit i = column x0 + i) or column word
  // (lane = column x0 + lane, bit k = row y0 + k) of the result
  uint32_t rw = 0, cw = 0;
  if constexpr (J == 1) {
    // the ball after one step: the pixel and its mask neighbours
    auto ring = [&](const uint32_t* r, bool mid) {
      const uint32_t left = __funnelshift_l(r[warp], r[warp + 1], 1);
      const uint32_t right = __funnelshift_r(r[warp + 1], r[warp + 2], 1);
      return left | right | (mid ? 0u : r[warp + 1]);
    };
    const uint32_t nb = ring(band[lane], false) | ring(band[lane + 1], true) |
                        ring(band[lane + 2], false);
    rw = band[lane + 1][warp + 1] & ~nb;
    if (!vec) cw = transpose32(rw, lane);
  } else {
    const uint32_t mw = transpose32(band[J + lane][warp + 1], lane);
    cw = ball_words<J, true>(band, mw, warp, lane, thresh);
    if (vec) rw = transpose32(cw, lane);
  }
  uint8_t* page = small + (size_t)b * H * W;
  if (vec) {
    // lane l: half l & 1 of row 16h + (l >> 1): a store instruction
    // writes 32 contiguous bytes of each of 16 rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * h + (lane >> 1);
      const uint32_t bits = __shfl_sync(FULL, rw, k) >> (16 * (lane & 1));
      const int x = x0 + 16 * (lane & 1);
      if (y0 + k < H && x < W)
        *(uint4*)(page + (size_t)(y0 + k) * W + x) =
            make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8),
                       spread4(bits >> 12));
    }
  } else {
    const int x = x0 + lane, n = min(32, H - y0);
    if (x < W)
      for (int k = 0; k < n; ++k)
        page[(size_t)(y0 + k) * W + x] = (cw >> k) & 1u;
  }
}

inline dim3 band_grid(int B, int H, int W) {
  return dim3((unsigned)((W + 32 * WARPS - 1) / (32 * WARPS)),
              (unsigned)((H + 31) / 32), (unsigned)B);
}

// Launch the certificate instance for board radius j (1 <= j <= MAXJ).
template <int MAXJ, int J = 1>
int launch_cert(int j, const void* plane, void* cert, void* maskw, int B,
                int H, int W, int thresh, cudaStream_t s) {
  if constexpr (J > MAXJ) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (j != J)
      return launch_cert<MAXJ, J + 1>(j, plane, cert, maskw, B, H, W, thresh,
                                      s);
    const bool vec = W % 16 == 0 && (uintptr_t)plane % 16 == 0;
    noise_cert_kernel<J><<<band_grid(B, H, W), THREADS, 0, s>>>(
        (const uint8_t*)plane, (uint32_t*)cert, (uint32_t*)maskw, H, W,
        (H + 31) / 32, thresh, vec);
    return (int)cudaGetLastError();
  }
}

// Launch the ball-count instance for board radius j (1 <= j <= MAXJ).
template <int MAXJ, int J = 1>
int launch_ball(int j, const void* plane, void* small, int B, int H, int W,
                cudaStream_t s) {
  if constexpr (J > MAXJ) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (j != J)
      return launch_ball<MAXJ, J + 1>(j, plane, small, B, H, W, s);
    const bool vec = W % 16 == 0 && (uintptr_t)plane % 16 == 0 &&
                     (uintptr_t)small % 16 == 0;
    noise_ball_kernel<J><<<band_grid(B, H, W), THREADS, 0, s>>>(
        (const uint8_t*)plane, (uint8_t*)small, H, W, J, vec);
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
  return launch_cert<8>(j, plane, cert, maskw, B, H, W, thresh,
                        (cudaStream_t)stream);
}

// plane: uint8/bool [B,H,W] -> small: uint8 [B,H,W], 1 where the pixel's
// cluster has <= k members. 1 <= k <= 15.
extern "C" int pft_noise_ball(const void* plane, void* small, int B, int H,
                              int W, int k, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  return launch_ball<MAX_J>(k, plane, small, B, H, W, (cudaStream_t)stream);
}
