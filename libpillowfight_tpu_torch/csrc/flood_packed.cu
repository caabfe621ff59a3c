// Bit-packed exact flood: pack/unpack and the whole flood in one launch.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_packed.py:
//   `_pack_kernel` / `pack_rows`, `_unpack_kernel` / `unpack_rows`, and
//   `_lanes_kernel`, `_rows_kernel`, `_dilate_kernel` (driven by
//   `_flood_packed`).
//
// Layout as in the reference: bit k of word (q, x) is pixel (32q + k, x),
// so a page is a [ceil(H/32), W] uint32 plane and one bitwise op moves 32
// rows. A round computes the reference's function: segmented OR along W,
// segmented OR along H across words, then a Chebyshev-ball dilation of
// radius `leap` gated by the mask, and whether the dilation added a word.
// Rounds repeat as the reference repeats them: two, then more while the
// last one added something and fewer than `max_iters` have run.
//
// What bounds it on the H100: by bytes almost nothing (a round passes a
// few times over packed planes of 0.125 B/px that sit in the 50 MB L2),
// so launches, host reads and chains of dependent loads are the cost. The
// design spends one launch a flood and reads nothing back:
// - One persistent cooperative kernel runs all rounds; the blocks meet at
//   `grid.sync()` between phases and read a changed flag on the device.
//   The phases stay global, two a round: a solid scan border spans the
//   whole width and height of a page, so tiles taken to their own fixed
//   points would need a round for every tile the flood crosses, while a
//   global scan along W and one along H cross the page in one round.
// - Row phase, a block per packed row, the row staged in shared memory:
//   it finishes the round before (OR over x - leap .. x + leap by
//   doubling, gate by the mask, note a change, store the state) and
//   starts the next (the segmented OR along W: each thread folds a chunk
//   of words into the map c -> a | (m & c), a block scan of the maps in
//   each direction gives every chunk its carries). The dilation is
//   separable, so taking its H half first (below) changes nothing.
// - Column phase, a block per strip of 32 columns, the strip's Hq words
//   of mask and state staged in shared memory by coalesced loads: the
//   segmented OR along H (a Kogge-Stone fill inside each word, a one-bit
//   carry scanned over eight segments of the column, one warp each), then
//   the H half of the dilation from the nearest set row above and below
//   each word, whatever the leap.
// The grid is what is co-resident (occupancy x SMs) or the work, if less;
// rows and strips are strided over it, so any batch runs.
//
// Pack moves 1 B/px in and 1/8 B/px out, so bytes bound it (0.0058 ms at
// A4 300 dpi x 2 and 3.35 TB/s; the plane it reads has just been written
// and may still sit in L2). A thread takes 16 adjacent columns of a word
// row: 32 coalesced 16-byte loads, every byte made 0/1 by a carry trick
// on four bytes at once, rows gathered into bytes with one shift and OR a
// load and lane, then a 4 x 4 byte transpose (`__byte_perm`) into the 16
// column words and four 16-byte stores: about 1.3 integer instructions a
// pixel. A plane whose rows are not 16-byte aligned takes 4-byte loads
// (W % 4 == 0) or byte loads, in the same kernel template.
//
// Unpack is the pack reversed: 1/8 B/px in and 1 B/px out (0.0058 ms at
// A4 300 dpi x 2), so its writes bound it. A thread takes 16 adjacent
// columns of a word row (four 16-byte loads), transposes each four
// columns' words by bytes (`__byte_perm`), so that byte c of t[g] holds
// rows 8g .. 8g+7 of column c, and stores each of its 32 rows as one
// 16-byte vector, (t[g] >> r) & 0x01010101 on four words: a warp stores
// 512 contiguous bytes of a row. Planes that do not allow it take 4-byte
// stores (W % 4 == 0, or a word view that is not 16-byte aligned) or
// byte stores, in the same kernel template. The 17.4 MB it writes at A4 x
// 2 fit in the 50 MB L2, so it can end before they reach device memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int PACK_THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;  // columns of a strip in the column phase
constexpr unsigned FULL = 0xffffffffu;

// Bytes of a load: bit 7 of each byte set where that byte is not 0.
__device__ __forceinline__ uint32_t nonzero_hi(uint32_t v) {
  return (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
}

// Pack: a thread takes V adjacent columns (V = 16 or 4) of one word row,
// 32 loads of V bytes. Byte c of acc[g][l] collects rows 8g .. 8g+7 of
// column 4l + c (bit r = row 8g + r); a 4 x 4 byte transpose of
// acc[0..3][l] gives the words of columns 4l .. 4l+3, stored as 16-byte
// vectors. V = 1: a thread takes one column, 32 byte loads (any W, any
// alignment). Rows past H read as 0.
template <int V>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_rows_kernel(const uint8_t* __restrict__ plane,
                     uint32_t* __restrict__ words, int H, int W, int Hq) {
  const int b = blockIdx.y;
  const int groups = W / V;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * groups) return;
  const int q = (int)(i / groups), x = (int)(i % groups) * V;
  const int y0 = q * 32, n = min(32, H - y0);
  const uint8_t* src = plane + ((size_t)b * H + y0) * W + x;
  uint32_t* dst = words + ((size_t)b * Hq + q) * W + x;
  if constexpr (V == 1) {
    uint32_t v = 0;
    for (int k = 0; k < n; ++k) v |= (uint32_t)(src[(size_t)k * W] != 0) << k;
    *dst = v;
  } else {
    constexpr int L = V / 4;  // 32-bit lanes of a load
    // all 32 loads first, so that they are in flight together
    uint32_t u[32][L];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint8_t* row = src + (size_t)k * W;
      if constexpr (V == 16) {
        const uint4 t = k < n ? *(const uint4*)row : make_uint4(0, 0, 0, 0);
        u[k][0] = t.x, u[k][1] = t.y, u[k][2] = t.z, u[k][3] = t.w;
      } else {
        u[k][0] = k < n ? *(const uint32_t*)row : 0u;
      }
    }
    uint32_t acc[4][L];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int l = 0; l < L; ++l) acc[g][l] = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k)
#pragma unroll
      for (int l = 0; l < L; ++l)
        acc[k >> 3][l] |= nonzero_hi(u[k][l]) >> (7 - (k & 7));
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t t0 = __byte_perm(acc[0][l], acc[1][l], 0x5140);
      const uint32_t t1 = __byte_perm(acc[2][l], acc[3][l], 0x5140);
      const uint32_t t2 = __byte_perm(acc[0][l], acc[1][l], 0x7362);
      const uint32_t t3 = __byte_perm(acc[2][l], acc[3][l], 0x7362);
      ((uint4*)dst)[l] =
          make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                     __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
    }
  }
}

// Unpack: a thread takes V adjacent columns (V = 16 or 4) of one word
// row: V word loads (four 16-byte loads at V = 16), a 4 x 4 byte
// transpose (`__byte_perm`) of each four columns into t[g], whose byte c
// holds rows 8g .. 8g+7 of column c, then row 8g + r of the four columns
// is (t[g] >> r) & 0x01010101: one 16-byte (V = 16) or 4-byte store a
// row, so that a warp stores V * 32 contiguous bytes of it. V = 1: a
// thread takes one column, 32 byte stores (any W, any alignment). Rows
// past H are not written.
template <int V>
__global__ void __launch_bounds__(PACK_THREADS)
    unpack_rows_kernel(const uint32_t* __restrict__ words,
                       uint8_t* __restrict__ plane, int H, int W, int Hq) {
  const int b = blockIdx.y;
  const int groups = W / V;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * groups) return;
  const int q = (int)(i / groups), x = (int)(i % groups) * V;
  const int y0 = q * 32, n = min(32, H - y0);
  const uint32_t* src = words + ((size_t)b * Hq + q) * W + x;
  uint8_t* dst = plane + ((size_t)b * H + y0) * W + x;
  if constexpr (V == 1) {
    const uint32_t v = *src;
    for (int k = 0; k < n; ++k) dst[(size_t)k * W] = (v >> k) & 1u;
  } else {
    constexpr int L = V / 4;  // 32-bit lanes of a store
    uint32_t w[V];
    if constexpr (V == 16) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint4 t = ((const uint4*)src)[l];
        w[4 * l] = t.x, w[4 * l + 1] = t.y, w[4 * l + 2] = t.z,
        w[4 * l + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) w[c] = src[c];
    }
    uint32_t t[4][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t* c = w + 4 * l;
      const uint32_t a0 = __byte_perm(c[0], c[1], 0x5140);
      const uint32_t a1 = __byte_perm(c[2], c[3], 0x5140);
      const uint32_t a2 = __byte_perm(c[0], c[1], 0x7362);
      const uint32_t a3 = __byte_perm(c[2], c[3], 0x7362);
      t[0][l] = __byte_perm(a0, a1, 0x5410);
      t[1][l] = __byte_perm(a0, a1, 0x7632);
      t[2][l] = __byte_perm(a2, a3, 0x5410);
      t[3][l] = __byte_perm(a2, a3, 0x7632);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k >= n) break;
      uint32_t o[L];
#pragma unroll
      for (int l = 0; l < L; ++l) o[l] = (t[k >> 3][l] >> (k & 7)) & 0x01010101u;
      uint8_t* row = dst + (size_t)k * W;
      if constexpr (V == 16)
        *(uint4*)row = make_uint4(o[0], o[1], o[2], o[3]);
      else
        *(uint32_t*)row = o[0];
    }
  }
}

// The map c -> a | (m & c) of one step of a segmented OR.
struct Op {
  uint32_t a, m;
};

__device__ __forceinline__ Op identity() { return Op{0u, FULL}; }

// `second` applied after `first`.
__device__ __forceinline__ Op then(Op first, Op second) {
  return Op{second.a | (second.m & first.a), second.m & first.m};
}

// Carry into this thread's chunk: the composition of every chunk before
// it in processing order (threads ascending, or descending if reverse),
// applied to 0. The caller's barrier follows the write of warp_tot.
__device__ __forceinline__ Op scan_exclusive(Op acc, bool reverse,
                                             Op* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Op inc = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Op other;
    other.a = reverse ? __shfl_down_sync(FULL, inc.a, off)
                      : __shfl_up_sync(FULL, inc.a, off);
    other.m = reverse ? __shfl_down_sync(FULL, inc.m, off)
                      : __shfl_up_sync(FULL, inc.m, off);
    if (reverse ? lane + off < 32 : lane >= off) inc = then(other, inc);
  }
  Op exc;
  exc.a = reverse ? __shfl_down_sync(FULL, inc.a, 1)
                  : __shfl_up_sync(FULL, inc.a, 1);
  exc.m = reverse ? __shfl_down_sync(FULL, inc.m, 1)
                  : __shfl_up_sync(FULL, inc.m, 1);
  if (lane == (reverse ? 31 : 0)) exc = identity();
  if (lane == (reverse ? 0 : 31)) warp_tot[warp] = inc;
  return exc;
}

__device__ __forceinline__ uint32_t carry_of(Op exc, bool reverse,
                                             const Op* warp_tot) {
  const int warp = threadIdx.x >> 5;
  Op pre = identity();
  if (reverse) {
    for (int w = WARPS - 1; w > warp; --w) pre = then(pre, warp_tot[w]);
  } else {
    for (int w = 0; w < warp; ++w) pre = then(pre, warp_tot[w]);
  }
  return then(pre, exc).a;
}

// Occluded fills inside one word (Kogge-Stone): spread f through runs of p.
__device__ __forceinline__ uint32_t fill_up(uint32_t f, uint32_t p) {
  f |= p & (f << 1);
  p &= p << 1;
  f |= p & (f << 2);
  p &= p << 2;
  f |= p & (f << 4);
  p &= p << 4;
  f |= p & (f << 8);
  p &= p << 8;
  return f | (p & (f << 16));
}

__device__ __forceinline__ uint32_t fill_down(uint32_t f, uint32_t p) {
  f |= p & (f >> 1);
  p &= p >> 1;
  f |= p & (f >> 2);
  p &= p >> 2;
  f |= p & (f >> 4);
  p &= p >> 4;
  f |= p & (f >> 8);
  p &= p >> 8;
  return f | (p & (f >> 16));
}

// Rows within `leap` of a set row, inside the word.
__device__ __forceinline__ uint32_t smear32(uint32_t x, int leap) {
  if (leap >= 31) return x ? FULL : 0u;
  for (int c = 0; c < leap;) {
    const int s = min(c + 1, leap - c);
    x |= (x << s) | (x >> s);
    c += s;
  }
  return x;
}

// Row phase of round `round`, a block per packed row. For round > 0 it
// ends the round before: r = (OR of v over x - leap .. x + leap & mask)
// | t, and a flag if any word of r differs from t. Then, on r, the
// segmented OR along W of this round, into t. smem: 3 * W words.
__device__ void row_phase(const uint32_t* __restrict__ mask, uint32_t* r,
                          uint32_t* t, const uint32_t* v, int* flag, int rows,
                          int W, int leap, int round, uint32_t* smem) {
  __shared__ Op warp_tot[2][WARPS];
  const int tid = threadIdx.x;
  uint32_t* a = smem;
  uint32_t* b = smem + W;
  uint32_t* m = smem + 2 * (size_t)W;
  // odd, so that the threads' chunks start in different banks
  const int chunk = ((W + THREADS - 1) / THREADS) | 1;
  const int lo = min(W, tid * chunk), hi = min(W, lo + chunk);
  int changed = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = (size_t)row * W;
    uint32_t* state = b;  // r of this row; `out` is the other buffer
    uint32_t* out = a;
    if (round > 0) {
      for (int x = tid; x < W; x += THREADS) a[x] = __ldcg(v + base + x);
      __syncthreads();
      uint32_t* src = a;
      uint32_t* dst = b;
      for (int c = 0; c < leap;) {
        const int s = min(c + 1, leap - c);
        for (int x = tid; x < W; x += THREADS)
          dst[x] = src[x] | (x >= s ? src[x - s] : 0u) |
                   (x + s < W ? src[x + s] : 0u);
        __syncthreads();
        uint32_t* swap = src;
        src = dst;
        dst = swap;
        c += s;
      }
      state = dst;
      out = src;
      for (int x = tid; x < W; x += THREADS) {
        const uint32_t mm = mask[base + x];
        const uint32_t tv = __ldcg(t + base + x);
        const uint32_t r2 = (src[x] & mm) | tv;
        changed |= r2 != tv;
        r[base + x] = r2;
        m[x] = mm;
        state[x] = r2;
      }
    } else {
      for (int x = tid; x < W; x += THREADS) {
        const uint32_t mm = mask[base + x];
        m[x] = mm;
        state[x] = r[base + x] & mm;
      }
    }
    __syncthreads();
    // out[x] = m[x] & (any state in the run of m): a scan from each side
    Op fwd = identity(), bwd = identity();
    for (int x = lo; x < hi; ++x) fwd = then(fwd, Op{m[x] & state[x], m[x]});
    for (int x = hi - 1; x >= lo; --x)
      bwd = then(bwd, Op{m[x] & state[x], m[x]});
    const Op ef = scan_exclusive(fwd, false, warp_tot[0]);
    const Op eb = scan_exclusive(bwd, true, warp_tot[1]);
    __syncthreads();
    uint32_t c = carry_of(ef, false, warp_tot[0]);
    for (int x = lo; x < hi; ++x) {
      c = m[x] & (state[x] | c);
      out[x] = c;
    }
    c = carry_of(eb, true, warp_tot[1]);
    for (int x = hi - 1; x >= lo; --x) {
      c = m[x] & (state[x] | c);
      out[x] |= c;
    }
    __syncthreads();
    for (int x = tid; x < W; x += THREADS) t[base + x] = out[x];
    __syncthreads();  // the buffers are free for the next row
  }
  if (__syncthreads_or(changed) && tid == 0) atomicOr(flag, 1);
}

// Column phase, a block per strip of COLS columns of one page: t = the
// segmented OR of t along H, v = t dilated by `leap` rows (both ways).
// smem: 3 * Hq * COLS words.
__device__ void column_phase(const uint32_t* __restrict__ mask, uint32_t* t,
                             uint32_t* v, int B, int Hq, int W, int leap,
                             uint32_t* smem) {
  __shared__ uint32_t seg[2][WARPS][COLS];  // [down, up][segment]: g | p << 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* m = smem;
  uint32_t* in = smem + (size_t)Hq * COLS;
  uint32_t* out = smem + 2 * (size_t)Hq * COLS;
  const int per_page = (W + COLS - 1) / COLS;
  const int len = (Hq + WARPS - 1) / WARPS;  // words of a segment
  const int q0 = min(Hq, warp * len), q1 = min(Hq, q0 + len);
  for (int strip = blockIdx.x; strip < B * per_page; strip += gridDim.x) {
    const int x = (strip % per_page) * COLS + lane;
    const bool live = x < W;
    const size_t base = (size_t)(strip / per_page) * Hq * W + (live ? x : 0);
    for (int q = warp; q < Hq; q += WARPS) {
      m[q * COLS + lane] = live ? mask[base + (size_t)q * W] : 0u;
      in[q * COLS + lane] = live ? __ldcg(t + base + (size_t)q * W) : 0u;
    }
    __syncthreads();
    // each segment alone: does it hand a carry on (g), does it pass one
    // through (p: every word all mask)
    uint32_t down = 0, up = 0, pass = 1;
    for (int q = q0; q < q1; ++q) {
      const uint32_t mm = m[q * COLS + lane];
      down = fill_up((in[q * COLS + lane] | down) & mm, mm) >> 31;
      pass &= mm == FULL;
    }
    for (int q = q1 - 1; q >= q0; --q) {
      const uint32_t mm = m[q * COLS + lane];
      up = fill_down((in[q * COLS + lane] | (up << 31)) & mm, mm) & 1u;
    }
    seg[0][warp][lane] = down | (pass << 1);
    seg[1][warp][lane] = up | (pass << 1);
    __syncthreads();
    down = up = 0;
    for (int w = 0; w < warp; ++w) {
      const uint32_t gp = seg[0][w][lane];
      down = (gp & 1u) | ((gp >> 1) & down);
    }
    for (int w = WARPS - 1; w > warp; --w) {
      const uint32_t gp = seg[1][w][lane];
      up = (gp & 1u) | ((gp >> 1) & up);
    }
    for (int q = q0; q < q1; ++q) {
      const uint32_t mm = m[q * COLS + lane];
      const uint32_t f = fill_up((in[q * COLS + lane] | down) & mm, mm);
      out[q * COLS + lane] = f;
      down = f >> 31;
    }
    for (int q = q1 - 1; q >= q0; --q) {
      const uint32_t mm = m[q * COLS + lane];
      const uint32_t f =
          fill_down((in[q * COLS + lane] | (up << 31)) & mm, mm);
      out[q * COLS + lane] |= f;
      up = f & 1u;
    }
    __syncthreads();
    // dilation along H: inside the word, and from the nearest set row in
    // the words above and below, as far as `leap` reaches
    for (int q = warp; q < Hq; q += WARPS) {
      const uint32_t tv = out[q * COLS + lane];
      uint32_t d = smear32(tv, leap);
      for (int j = 1; q - j >= 0 && 32 * (j - 1) < leap; ++j) {
        const uint32_t w = out[(q - j) * COLS + lane];
        if (w) {
          const int n = leap - (32 * (j - 1) + __clz(w) + 1) + 1;
          if (n > 0) d |= n >= 32 ? FULL : (1u << n) - 1u;
          break;
        }
      }
      for (int j = 1; q + j < Hq && 32 * (j - 1) < leap; ++j) {
        const uint32_t w = out[(q + j) * COLS + lane];
        if (w) {
          const int n = leap - (32 * (j - 1) + __ffs(w)) + 1;
          if (n > 0) d |= n >= 32 ? FULL : ~(FULL >> n);
          break;
        }
      }
      if (live) {
        t[base + (size_t)q * W] = tv;
        v[base + (size_t)q * W] = d;
      }
    }
    __syncthreads();  // the planes are free for the next strip
  }
}

// The whole flood. r: the seeds (within the mask) on entry, the reach on
// exit. t, v: scratch planes. info: int32 [4], zero on entry; [0..2] are
// the rounds' changed flags in turn, [3] gets the number of rounds run.
__global__ void __launch_bounds__(THREADS)
    flood_kernel(const uint32_t* __restrict__ mask, uint32_t* r, uint32_t* t,
                 uint32_t* v, int* info, int B, int Hq, int W, int leap,
                 int max_iters) {
  extern __shared__ uint32_t smem[];
  cg::grid_group grid = cg::this_grid();
  int round = 0;
  for (;; ++round) {
    row_phase(mask, r, t, v, info + round % 3, B * Hq, W, leap, round, smem);
    grid.sync();
    // round `round` is complete in r: two rounds always, then as long as
    // the last one changed a word and the cap allows
    if (round >= 2 && (round >= max_iters ||
                       *(volatile int*)(info + round % 3) == 0))
      break;
    if (blockIdx.x == 0 && threadIdx.x == 0) info[(round + 1) % 3] = 0;
    column_phase(mask, t, v, B, Hq, W, leap, smem);
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) info[3] = round;
}

template <int V>
void launch_pack(const void* plane, void* words, int B, int H, int W, int Hq,
                 cudaStream_t s) {
  const size_t n = (size_t)Hq * (W / V);
  const dim3 grid((unsigned)((n + PACK_THREADS - 1) / PACK_THREADS), B);
  pack_rows_kernel<V><<<grid, PACK_THREADS, 0, s>>>(
      (const uint8_t*)plane, (uint32_t*)words, H, W, Hq);
}

template <int V>
void launch_unpack(const void* words, void* plane, int B, int H, int W,
                   int Hq, cudaStream_t s) {
  const size_t n = (size_t)Hq * (W / V);
  const dim3 grid((unsigned)((n + PACK_THREADS - 1) / PACK_THREADS), B);
  unpack_rows_kernel<V><<<grid, PACK_THREADS, 0, s>>>(
      (const uint32_t*)words, (uint8_t*)plane, H, W, Hq);
}

}  // namespace

// plane: uint8/bool [B,H,W] -> words: uint32 [B,ceil(H/32),W], bit k of
// word (q, x) set where pixel (32q + k, x) is not 0. Rows start at
// multiples of W bytes, so 16-byte loads need W % 16 == 0 and a 16-byte
// aligned plane (A4 at 300 and 600 dpi: W = 2480, 4960), 4-byte loads
// W % 4 == 0; any other plane takes byte loads.
extern "C" int pft_pack_rows(const void* plane, void* words, int B, int H,
                             int W, void* stream) {
  const int Hq = (H + 31) / 32;
  const uintptr_t p = (uintptr_t)plane;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && Hq > 0 && W > 0) {
    if (W % 16 == 0 && p % 16 == 0)
      launch_pack<16>(plane, words, B, H, W, Hq, s);
    else if (W % 4 == 0 && p % 4 == 0)
      launch_pack<4>(plane, words, B, H, W, Hq, s);
    else
      launch_pack<1>(plane, words, B, H, W, Hq, s);
  }
  return (int)cudaGetLastError();
}

// words: uint32 [B,ceil(H/32),W] -> plane: uint8/bool [B,H,W]. 16-byte
// stores need W % 16 == 0 and a 16-byte aligned plane, and the 16-byte
// loads a 16-byte aligned word view; 4-byte stores W % 4 == 0; any
// other plane takes byte stores.
extern "C" int pft_unpack_rows(const void* words, void* plane, int B, int H,
                               int W, void* stream) {
  const int Hq = (H + 31) / 32;
  const uintptr_t p = (uintptr_t)plane, w = (uintptr_t)words;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && Hq > 0 && W > 0) {
    if (W % 16 == 0 && p % 16 == 0 && w % 16 == 0)
      launch_unpack<16>(words, plane, B, H, W, Hq, s);
    else if (W % 4 == 0 && p % 4 == 0)
      launch_unpack<4>(words, plane, B, H, W, Hq, s);
    else
      launch_unpack<1>(words, plane, B, H, W, Hq, s);
  }
  return (int)cudaGetLastError();
}

// Shared memory of a block of the flood: the larger of the two phases'.
extern "C" int pft_flood_packed_smem(int Hq, int W) {
  const long long words = 3LL * (W > Hq * COLS ? W : Hq * COLS);
  return words * 4 > (1LL << 30) ? 1 << 30 : (int)(words * 4);
}

// The whole flood on packed [B,Hq,W] planes in one cooperative launch.
// r: state, updated in place; t, v: scratch planes; info: int32 [4],
// zeroed by the caller. A launch the device refuses (no cooperative
// launch, too much shared memory) returns its error.
extern "C" int pft_flood_packed(const void* mask, void* r, void* t, void* v,
                                void* info, int B, int Hq, int W, int leap,
                                int max_iters, void* stream) {
  if (B <= 0 || Hq <= 0 || W <= 0) return (int)cudaGetLastError();
  const int smem = pft_flood_packed_smem(Hq, W);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorCooperativeLaunchTooLarge;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flood_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const long long rows = (long long)B * Hq;
  const long long strips = (long long)B * ((W + COLS - 1) / COLS);
  const long long work = rows > strips ? rows : strips;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(work < resident ? work : resident);
  const uint32_t* m = (const uint32_t*)mask;
  void* args[] = {&m, &r, &t, &v, &info, &B, &Hq, &W, &leap, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)flood_kernel, dim3(blocks),
                                    dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
