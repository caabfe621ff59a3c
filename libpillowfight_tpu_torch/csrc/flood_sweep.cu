// Directional sweep of the exact flood on byte planes.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_kernel.py
// `_flood_sweep_kernel` (driven by `_flood_sweep` and
// `flood_reach_pallas`).
//
// What it computes: on 0/1 byte planes `mask` and `reach` [B,H,W], one
// sweep down (or up) the page that adds to `reach`, in place, every mask
// pixel that lies within Chebyshev distance `leap` of a reached pixel in
// the rows already swept or in its own row, transitively. It returns the
// number of pixels it added. The flood's fixed point is the closure of
// that rule in all directions; the host alternates down and up sweeps
// until one of each, back to back, adds nothing.
//
// What differs from the TPU kernel, and why: the TPU grid runs its bands
// in order and carries the last `leap` rows of the band before in VMEM.
// Blocks run in no order here, so the order comes from a loop: a block
// owns a strip of columns plus a halo of `leap` columns on each side, one
// thread per column, and walks all the rows itself. Per row
//   - each thread keeps, in a register, how many rows ago its column last
//     held a reached pixel; warp ballots turn "within `leap` rows", the
//     mask and the stored reach into bit rows in shared memory;
//   - every warp then works on the whole strip as one bit row, a word per
//     lane: it widens the rows-above bits by `leap` columns, closes the
//     mask over gaps shorter than `leap` (so a run of mask pixels no more
//     than `leap` apart is one segment), and fills the reach through the
//     segments both ways (a fill inside each word, a carry scan across
//     the lanes).
// Strips exchange nothing within a sweep: a neighbour's columns are read
// as they stand in memory, stale or not, which is harmless because reach
// only grows. Reach that must cross a strip sideways does so in the next
// sweep. A sweep that adds nothing has read only final values, so it
// proves the rule for its own direction; one of each direction proves
// the fixed point.
//
// Bound on the H100: bytes, 3 B/px a sweep (mask and reach read, reach
// written where it changes). A page has only W / (threads - 2 * leap)
// strips, so few blocks are in flight and each row costs a barrier and a
// thousand cycles of dependent warp work: the walk is latency bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// A bit row of up to 1024 columns: word `lane` holds columns 32*lane ..
// 32*lane+31, bit k the column 32*lane + k. Lanes past the row hold 0.

// Columns move up by s (column x takes x - s), zero fill. s is the same
// in every lane.
__device__ __forceinline__ uint32_t row_shl(uint32_t x, int s, int lane) {
  const int q = s >> 5, t = s & 31;
  uint32_t lo = q ? __shfl_up_sync(FULL, x, q) : x;
  if (lane < q) lo = 0;
  if (!t) return lo;
  uint32_t hi = __shfl_up_sync(FULL, x, q + 1);
  if (lane < q + 1) hi = 0;
  return (lo << t) | (hi >> (32 - t));
}

// Columns move down by s (column x takes x + s), zero fill.
__device__ __forceinline__ uint32_t row_shr(uint32_t x, int s, int lane) {
  const int q = s >> 5, t = s & 31;
  uint32_t lo = q ? __shfl_down_sync(FULL, x, q) : x;
  if (lane + q > 31) lo = 0;
  if (!t) return lo;
  uint32_t hi = __shfl_down_sync(FULL, x, q + 1);
  if (lane + q + 1 > 31) hi = 0;
  return (lo >> t) | (hi << (32 - t));
}

// OR of x over columns x - k .. x (up) or x .. x + k (down).
__device__ __forceinline__ uint32_t widen_up(uint32_t x, int k, int lane) {
  for (int c = 0; c < k;) {
    const int s = min(c + 1, k - c);
    x |= row_shl(x, s, lane);
    c += s;
  }
  return x;
}

__device__ __forceinline__ uint32_t widen_down(uint32_t x, int k, int lane) {
  for (int c = 0; c < k;) {
    const int s = min(c + 1, k - c);
    x |= row_shr(x, s, lane);
    c += s;
  }
  return x;
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

// f spread through the runs of e towards higher columns, over the whole
// row: a fill inside each word, a carry scan over the words (a word
// generates a carry if its top bit fills, and passes one on if it is all
// e), and the carry let into each word's lowest run of e.
__device__ __forceinline__ uint32_t row_fill_up(uint32_t f, uint32_t e,
                                                int lane, int nw) {
  const uint32_t filled = fill_up32(f, e);
  uint32_t g = filled >> 31, p = e == FULL;
  for (int off = 1; off < nw; off <<= 1) {
    const uint32_t gp = __shfl_up_sync(FULL, g | (p << 1), off);
    if (lane >= off) {
      g |= p & gp & 1u;
      p &= gp >> 1;
    }
  }
  uint32_t carry = __shfl_up_sync(FULL, g, 1);
  if (lane == 0) carry = 0;
  return carry ? filled | (e & ~(e + 1u)) : filled;
}

// The same towards lower columns.
__device__ __forceinline__ uint32_t row_fill_down(uint32_t f, uint32_t e,
                                                  int lane, int nw) {
  const uint32_t filled = fill_down32(f, e);
  uint32_t g = filled & 1u, p = e == FULL;
  for (int off = 1; off < nw; off <<= 1) {
    const uint32_t gp = __shfl_down_sync(FULL, g | (p << 1), off);
    if (lane + off < 32) {
      g |= p & gp & 1u;
      p &= gp >> 1;
    }
  }
  uint32_t carry = __shfl_down_sync(FULL, g, 1);
  if (lane == 31) carry = 0;
  const uint32_t rev = __brev(e);
  return carry ? filled | __brev(rev & ~(rev + 1u)) : filled;
}

// One sweep. Block (strip, page); blockDim.x = 32 * nw columns, of which
// the middle blockDim.x - 2 * leap are the block's own.
__global__ void sweep_kernel(const uint8_t* __restrict__ mask, uint8_t* reach,
                             int* __restrict__ changed, int H, int W,
                             int leap, int down) {
  __shared__ uint32_t rows[2][3][32];  // [row parity][m, r, above][word]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int own = blockDim.x - 2 * leap;
  const int col = blockIdx.x * own - leap + (int)threadIdx.x;
  const bool in_page = col >= 0 && col < W;
  const bool mine = in_page && (int)threadIdx.x >= leap &&
                    (int)threadIdx.x < leap + own;
  const size_t page = (size_t)blockIdx.y * H * W;
  const uint8_t* m_col = mask + page + (in_page ? col : 0);
  uint8_t* r_col = reach + page + (in_page ? col : 0);
  const uint32_t live = lane < nw ? FULL : 0u;  // lanes that hold a word

  int since = leap;  // rows between this row and the column's last reach
  int added = 0;
  int y = down ? 0 : H - 1;
  const int dy = down ? 1 : -1;
  bool m = false, r = false;
  if (in_page) {
    m = m_col[(size_t)y * W] != 0;
    r = *((volatile uint8_t*)(r_col + (size_t)y * W)) != 0;
  }
  for (int i = 0; i < H; ++i, y += dy) {
    // the next row's bytes, asked for before this row's work
    bool m_next = false, r_next = false;
    if (in_page && i + 1 < H) {
      m_next = m_col[(size_t)(y + dy) * W] != 0;
      r_next = *((volatile uint8_t*)(r_col + (size_t)(y + dy) * W)) != 0;
    }
    const uint32_t mw = __ballot_sync(FULL, m);
    const uint32_t rw = __ballot_sync(FULL, r && m);
    const uint32_t aw = __ballot_sync(FULL, since < leap);
    uint32_t (*buf)[32] = rows[i & 1];
    if (lane == 0) {
      buf[0][warp] = mw;
      buf[1][warp] = rw;
      buf[2][warp] = aw;
    }
    __syncthreads();
    // every warp: the whole strip as bit rows, one word per lane
    const uint32_t M = live & buf[0][lane & (nw - 1)];
    const uint32_t R = live & buf[1][lane & (nw - 1)];
    uint32_t f = R;
    if (__any_sync(FULL, (M & ~R) != 0)) {  // else nothing left to reach
      uint32_t A = live & buf[2][lane & (nw - 1)];
      A = widen_up(A, leap, lane) | widen_down(A, leap, lane);
      f = M & (R | A);
      if (__any_sync(FULL, f != 0)) {
        // segments: the mask closed over gaps of fewer than `leap` zeros
        // (dilate up by leap - 1, erode back; outside the row counts as
        // set for the erosion, so nothing is lost at the strip's end)
        const uint32_t D = widen_up(M, leap - 1, lane);
        const uint32_t e = live & ~widen_down(live & ~D, leap - 1, lane);
        f = row_fill_down(row_fill_up(f, e, lane, nw), e, lane, nw) & M;
      }
    }
    const uint32_t word = __shfl_sync(FULL, f, warp);
    const bool now = (word >> lane) & 1u;
    if (now && !r && mine) {
      r_col[(size_t)y * W] = 1;
      ++added;
    }
    since = now ? 0 : min(since + 1, leap);
    m = m_next;
    r = r_next;
  }
  for (int off = 16; off; off >>= 1)
    added += __shfl_down_sync(FULL, added, off);
  if (lane == 0 && added) atomicAdd(changed, added);
}

}  // namespace

// mask, reach: uint8/bool [B,H,W]; reach is updated in place. changed:
// one int32, the sweep adds its count to it. threads: 256 or 1024, with
// threads - 2 * leap >= 32.
extern "C" int pft_flood_sweep(const void* mask, void* reach, void* changed,
                               int B, int H, int W, int leap, int down,
                               int threads, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    const int own = threads - 2 * leap;
    const dim3 grid((W + own - 1) / own, B);
    sweep_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (uint8_t*)reach, (int*)changed, H, W, leap,
        down);
  }
  return (int)cudaGetLastError();
}
