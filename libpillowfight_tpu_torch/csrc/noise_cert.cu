// Noisefilter ball sweeps: packed big-cluster certificates, and the
// direct small-cluster ball count.
//
// Replaces libpillowfight_tpu/ops/pallas/noise_kernel.py `_cert_band_kernel`
// (via `_cert_sweep`, orchestrated by `small_cluster_mask_pallas`) and
// `_noise_band_kernel` (via `_noise_sweep` and `_ball_sweep`, which the
// reference takes for k = 1). Both TPU kernels share `_board_consts` and
// `_shift_board`; here they share the board helpers.
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
// Certificates, `noise_cert_kernel<J>`: 1 B/px read and 1/16 B/px written
// (0.0065 ms at A4 300 dpi x 2 and 3.35 TB/s), but the work is integer
// instructions, most of them on the few rows that hold a mask pixel. A
// block takes 32 rows x 256 columns, a warp a word column of 32 x 32:
// - The block stages its band (32 + 2J rows, its columns + 16 each side)
//   in shared memory as packed bits: a thread turns 16 bytes of one
//   16-byte load into 16 bits (the not-zero test of four bytes at once by
//   a carry trick, gathered by one multiply). A strip (bits x-J .. x+J of
//   a row) is then one funnel shift of two shared words. Planes whose
//   rows are not 16-byte aligned stage byte by byte.
// - A warp transposes its 32 centre words (5 shuffle steps) into the mask
//   words it writes, and ORs them across lanes: only rows with a mask pixel
//   in the warp's 32 columns take the board work, every lane in step.
// - The ball only grows, so a pixel whose ball has `thresh` members is a
//   certificate whatever the later steps add: the warp stops dilating
//   once every lane has decided, and a step builds only the window rows
//   it can reach (rows J-s .. J+s at step s).
// - Certificates and mask words come out one each for 32 page rows,
//   aligned to the page rows as the packed flood reads them.
//
// Ball count, `noise_ball_kernel<J, true>`: one thread per packed word
// (q, x) takes the 32 rows 32q .. 32q+31 of column x, with a ring of
// 2J+1 strips (bit dx+J = mask[y][x+dx]) in registers, each row of the
// halo read once per thread straight from device memory, and writes one
// byte per pixel. At large J the boards spill to local memory (L1). Its
// bound: ~(2J+1) byte loads per pixel (L1 hits) and J dilation steps of a
// few dozen ops per board word; 1 B/px read and 1 B/px written. (Its
// template still carries the certificates' former BALL = false form,
// which nothing instantiates now.)

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

constexpr unsigned FULL = 0xffffffffu;
constexpr int CERT_WARPS = 8;  // word columns of a block, one a warp
constexpr int CERT_THREADS = 32 * CERT_WARPS;
constexpr int CERT_WORDS = CERT_WARPS + 2;  // staged words a row
constexpr int CERT_CHUNKS = 2 * CERT_WARPS + 2;  // 16-column loads a row

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

// 32 x 32 bit transpose across a warp: lane k holds row word k (bit x =
// pixel (k, x)); lane x gets column word x (bit k = pixel (k, x)).
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

// cert, maskw: u32 words [B,Hq,W]. vec: rows 16-byte aligned (W % 16 == 0
// and an aligned plane).
template <int J>
__global__ void __launch_bounds__(CERT_THREADS)
    noise_cert_kernel(const uint8_t* __restrict__ plane,
                      uint32_t* __restrict__ cert,
                      uint32_t* __restrict__ maskw, int H, int W, int Hq,
                      int thresh, bool vec) {
  constexpr int S = 2 * J + 1, NB = S * S, NW = (NB + 31) / 32;
  constexpr int CB = J * S + J;  // the centre bit
  constexpr int R = 32 + 2 * J;  // staged rows
  constexpr uint32_t SMASK = (1u << S) - 1u;
  // band[r][w] bit i = pixel (y0 - J + r, xbase - 32 + 32w + i)
  __shared__ uint32_t band[R][CERT_WORDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, q = blockIdx.y, y0 = q * 32;
  const int xbase = blockIdx.x * 32 * CERT_WARPS;
  const uint8_t* page = plane + (size_t)b * H * W;

  // 16-column chunks, chunk c = columns xbase - 16 + 16c; the outer
  // halves of the first and last words stay 0
  constexpr int CHUNKS = R * CERT_CHUNKS;
  uint16_t* half = (uint16_t*)&band[0][0];
  auto at = [&](int i) {  // staged row r, chunk c -> u16 index, y, x
    const int r = i / CERT_CHUNKS, c = i - r * CERT_CHUNKS;
    return make_int3(r * 2 * CERT_WORDS + c + 1, y0 - J + r,
                     xbase - 16 + 16 * c);
  };
  if (vec) {  // every load first, so that they are in flight together
    constexpr int PASSES = (CHUNKS + CERT_THREADS - 1) / CERT_THREADS;
    uint4 v[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = tid + p * CERT_THREADS;
      const int3 u = at(i);
      v[p] = i < CHUNKS && u.y >= 0 && u.y < H && u.z >= 0 && u.z < W
                 ? *(const uint4*)(page + (size_t)u.y * W + u.z)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = tid + p * CERT_THREADS;
      if (i < CHUNKS) half[at(i).x] = (uint16_t)nonzero_bits16(v[p]);
    }
  } else {
    for (int i = tid; i < CHUNKS; i += CERT_THREADS) {
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
  for (int r = tid; r < R; r += CERT_THREADS) {
    half[r * 2 * CERT_WORDS] = 0;
    half[r * 2 * CERT_WORDS + 2 * CERT_WORDS - 1] = 0;
  }
  __syncthreads();

  // this lane's column x; rows of the warp's columns with a mask pixel
  const int x = xbase + 32 * warp + lane;
  const uint32_t mw = transpose32(band[J + lane][warp + 1], lane);
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
  uint32_t cw = 0;
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
#pragma unroll
    for (int step = 1; step <= J; ++step) {
      if (__all_sync(FULL, !centre || size >= thresh)) break;
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
      size = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        r[w] = (t[w] | up[w] | dn[w]) & board[w] & M[w];
        size += __popc(r[w]);
      }
    }
    if (centre && size >= thresh) cw |= 1u << k;
  }
  if (x < W) {
    const size_t o = ((size_t)b * Hq + q) * W + x;
    cert[o] = cw;
    maskw[o] = mw;
  }
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
    const int Hq = (H + 31) / 32;
    const bool vec = W % 16 == 0 && (uintptr_t)plane % 16 == 0;
    const dim3 grid((unsigned)((W + 32 * CERT_WARPS - 1) / (32 * CERT_WARPS)),
                    Hq, B);
    noise_cert_kernel<J><<<grid, CERT_THREADS, 0, s>>>(
        (const uint8_t*)plane, (uint32_t*)cert, (uint32_t*)maskw, H, W, Hq,
        thresh, vec);
    return (int)cudaGetLastError();
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
  return launch_cert<8>(j, plane, cert, maskw, B, H, W, thresh,
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
