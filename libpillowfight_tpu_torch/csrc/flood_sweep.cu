// Exact flood on byte planes: one launch sweeps the page down and then up,
// in bands of 32 rows packed into words.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_kernel.py
// `_flood_sweep_kernel` (driven by `_flood_sweep` and
// `flood_reach_pallas`).
//
// What it computes: on 0/1 byte planes `mask` and `reach` [B,H,W], the
// rule "a mask pixel within Chebyshev distance `leap` of a reached pixel
// is reached", applied down the page and then up it. `reach` grows in
// place; the number of pixels added goes to `changed`. The flood is the
// closure of that rule, a unique fixed point; the host repeats launches
// until one adds nothing.
//
// What bounds it on the H100: bytes by count (mask and reach read twice a
// launch, 4 B/px, against 3.35 TB/s), but in fact the chain of dependent
// steps a block takes down its strip. The design keeps that chain short:
// - A block owns a strip of columns plus a halo of `leap` columns on each
//   side, one thread per column, and takes the page in bands of 32 rows.
//   A thread reads its column's 32 mask and 32 reach bytes of the band
//   (a warp reads 32 neighbouring bytes of a row at a time) and packs them
//   into two words, so every step below moves 32 rows at once and no warp
//   repeats another's work. The next band's bytes are asked for before
//   this band is worked on.
// - A band is taken to its own fixed point: the dilation of radius `leap`
//   (shifts inside the word along H; a doubling OR over neighbouring
//   columns through shared memory along W), gated by the mask, then the
//   segmented OR along H (a Kogge-Stone fill inside the word) and along W
//   (a scan of the maps c -> a | (m & c) over the threads), until
//   `__syncthreads_or` reports no new bit. A band with nothing left to
//   reach, or nothing reached in range, costs two barriers.
// - What the rows behind the band contribute is one number per column:
//   the distance from the band's edge to the column's nearest reached row
//   behind it. Rows of the band within `leap` of that row get a bit before
//   the dilation along W. So any leap costs one register, not leap rows.
// - Strips are narrow when the leap allows (128 threads up to leap 32,
//   then 256, 512, 1024): the more blocks, the more strips walk at once.
// - Only new bits are written back, as bytes.
//
// The stop rule, for blocks that run in no order. Strips exchange nothing
// within a launch: a neighbour's columns are read as they stand in
// memory, stale or not, which is harmless because reach only grows and
// every bit a block derives follows from the rule (sound). Suppose a
// launch adds nothing. Then no byte of `reach` changed during it, so every
// block read final values. Take a mask pixel p that is not reached and a
// reached pixel q within `leap` of it. q's column is within `leap` of
// p's, so it lies in the strip of the block that owns p. If q lies in p's
// band, the band's fixed point would have added p. If q lies above, the
// down sweep carried q's distance into p's band; if below, the up sweep
// did. Either would have added p. So no such pair exists: the plane is
// closed under the rule, and it is the fixed point. One idle launch
// proves both directions at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FAR = 1 << 29;  // no reached row behind the band

// The map c -> a | (m & c) of one step of a segmented OR.
struct Op {
  uint32_t a, m;
};

// `second` applied after `first`.
__device__ __forceinline__ Op then(Op first, Op second) {
  return Op{second.a | (second.m & first.a), second.m & first.m};
}

// Occluded fills inside one word (Kogge-Stone): spread f through runs of p.
__device__ __forceinline__ uint32_t fill_up32(uint32_t f, uint32_t p) {
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

__device__ __forceinline__ uint32_t fill_down32(uint32_t f, uint32_t p) {
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

// OR of v over the threads tid - leap .. tid + leap of the block, by
// doubling through two buffers in shared memory (one barrier a step).
__device__ __forceinline__ uint32_t widen(uint32_t v, int leap,
                                          uint32_t (*buf)[1024]) {
  const int tid = threadIdx.x, n = blockDim.x;
  int p = 0;
  for (int c = 0; c < leap; p ^= 1) {
    const int s = min(c + 1, leap - c);
    buf[p][tid] = v;
    __syncthreads();
    if (tid >= s) v |= buf[p][tid - s];
    if (tid + s < n) v |= buf[p][tid + s];
    c += s;
  }
  return v;
}

// Segmented OR along the threads of the block: m & (any r in the thread's
// run of m). A scan of the maps in each direction: shuffles inside a warp,
// the warps' totals through shared memory.
__device__ __forceinline__ uint32_t seg_or_threads(uint32_t r, uint32_t m,
                                                   Op (*tot)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  Op f{m & r, m}, g = f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Op o;
    o.a = __shfl_up_sync(FULL, f.a, off);
    o.m = __shfl_up_sync(FULL, f.m, off);
    if (lane >= off) f = then(o, f);
    o.a = __shfl_down_sync(FULL, g.a, off);
    o.m = __shfl_down_sync(FULL, g.m, off);
    if (lane + off < 32) g = then(o, g);
  }
  if (lane == 31) tot[0][warp] = f;
  if (lane == 0) tot[1][warp] = g;
  __syncthreads();
  uint32_t cf = 0, cb = 0;
  for (int w = 0; w < warp; ++w) cf = tot[0][w].a | (tot[0][w].m & cf);
  for (int w = nw - 1; w > warp; --w) cb = tot[1][w].a | (tot[1][w].m & cb);
  return f.a | (f.m & cf) | g.a | (g.m & cb);
}

// The bytes of one band of a column: rows y0 .. y0 + 31, 0 past the page.
__device__ __forceinline__ void fetch(const uint8_t* m_col,
                                      const uint8_t* r_col, bool in_page,
                                      int y0, int H, int W, uint8_t (&pm)[32],
                                      uint8_t (&pr)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const bool ok = in_page && y0 + k < H;
    const size_t at = (size_t)(y0 + k) * W;
    pm[k] = ok ? __ldg(m_col + at) : (uint8_t)0;
    pr[k] = ok ? __ldcg(r_col + at) : (uint8_t)0;  // past L1: other blocks write
  }
}

__device__ __forceinline__ void pack(const uint8_t (&pm)[32],
                                     const uint8_t (&pr)[32], uint32_t& M,
                                     uint32_t& R) {
  M = R = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    M |= (uint32_t)(pm[k] != 0) << k;
    R |= (uint32_t)(pr[k] != 0) << k;
  }
  R &= M;
}

// One launch: every block sweeps its strip down and then up. Block
// (strip, page); blockDim.x columns, of which the middle blockDim.x -
// 2 * leap are the block's own. AHEAD is how many bands' bytes a thread
// keeps on their way in registers while it works on a band: 1 (64
// registers), or 0 for the 1024-thread blocks, which have 64 registers
// in all. On an H100 one band ahead is several times faster than none,
// and two bands ahead are no faster than one.
template <int MAX_THREADS, int AHEAD>
__global__ void __launch_bounds__(MAX_THREADS)
    sweep_kernel(const uint8_t* __restrict__ mask, uint8_t* reach,
                 unsigned long long* __restrict__ changed, int H, int W,
                 int leap) {
  __shared__ uint32_t buf[2][1024];
  __shared__ Op tot[2][32];
  const int tid = threadIdx.x;
  const int own = blockDim.x - 2 * leap;
  const int col = blockIdx.x * own - leap + tid;
  const bool in_page = col >= 0 && col < W;
  const bool mine = in_page && tid >= leap && tid < leap + own;
  const size_t page = (size_t)blockIdx.y * H * W;
  const uint8_t* m_col = mask + page + (in_page ? col : 0);
  uint8_t* r_col = reach + page + (in_page ? col : 0);
  const int nb = (H + 31) >> 5;

  int added = 0;
  for (int up = 0; up < 2; ++up) {
    // rows from the band's edge to the column's nearest reached row behind
    int dist = FAR;
    // the i-th band of this sweep, taken to its fixed point
    auto work = [&](int y0, uint32_t M, uint32_t R) {
      const uint32_t loaded = R;
      // rows of this band within `leap` of the reached row behind it
      const int n = leap - dist + 1;
      const uint32_t behind = n <= 0    ? 0u
                              : n >= 32 ? FULL
                              : up      ? ~(FULL >> n)
                                        : (1u << n) - 1u;
      for (;;) {
        const uint32_t in_range = smear32(R, leap) | behind;
        if (!__syncthreads_or((M & ~R) != 0)) break;  // nothing left to reach
        if (!__syncthreads_or(in_range != 0)) break;  // nothing in range
        uint32_t r2 = R | (M & widen(in_range, leap, buf));
        r2 = fill_up32(r2, M) | fill_down32(r2, M);
        r2 = seg_or_threads(r2, M, tot);
        const bool grew = r2 != R;
        R = r2;
        if (!__syncthreads_or(grew)) break;
      }
      if (mine) {
        uint32_t fresh = R & ~loaded;
        added += __popc(fresh);
        while (fresh) {
          r_col[(size_t)(y0 + __ffs(fresh) - 1) * W] = 1;
          fresh &= fresh - 1;
        }
      }
      dist = R ? (up ? __ffs(R) : __clz(R) + 1) : min(dist + 32, FAR);
    };
    auto row_of = [&](int i) { return (up ? nb - 1 - i : i) << 5; };
    auto get = [&](int i, uint8_t (&pm)[32], uint8_t (&pr)[32]) {
      if (i < nb) fetch(m_col, r_col, in_page, row_of(i), H, W, pm, pr);
    };
    uint32_t M, R;
    uint8_t am[32], ar[32];
    if (AHEAD == 0) {
      for (int i = 0; i < nb; ++i) {
        get(i, am, ar);
        pack(am, ar, M, R);
        work(row_of(i), M, R);
      }
    } else {
      get(0, am, ar);
      for (int i = 0; i < nb; ++i) {
        pack(am, ar, M, R);
        get(i + 1, am, ar);
        work(row_of(i), M, R);
      }
    }
  }
  for (int off = 16; off; off >>= 1)
    added += __shfl_down_sync(FULL, added, off);
  if ((tid & 31) == 0 && added)
    atomicAdd(changed, (unsigned long long)added);
}

}  // namespace

// mask, reach: uint8/bool [B,H,W]; reach is updated in place. changed:
// one int64, the launch adds its count of new pixels to it. threads: 128,
// 256, 512 or 1024, with threads - 2 * leap >= 32.
extern "C" int pft_flood_sweep(const void* mask, void* reach, void* changed,
                               int B, int H, int W, int leap, int threads,
                               void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    const int own = threads - 2 * leap;
    const dim3 grid((W + own - 1) / own, B);
    cudaStream_t s = (cudaStream_t)stream;
    if (threads <= 256)
      sweep_kernel<256, 1><<<grid, threads, 0, s>>>(
          (const uint8_t*)mask, (uint8_t*)reach, (unsigned long long*)changed,
          H, W, leap);
    else
      sweep_kernel<1024, 0><<<grid, threads, 0, s>>>(
          (const uint8_t*)mask, (uint8_t*)reach, (unsigned long long*)changed,
          H, W, leap);
  }
  return (int)cudaGetLastError();
}
