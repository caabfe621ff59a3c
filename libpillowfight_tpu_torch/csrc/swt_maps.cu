// SWT's width maps by line scans: both passes of ops/swt.py (`_width_pass`,
// `_median_pass`) and the ray medians between them (`_ray_medians`).
//
// Replaces no TPU kernel. The JAX package computes the width maps with XLA
// plane passes (libpillowfight_tpu/ops/swt.py `_width_pass`,
// `_median_pass`), and the port first copied them as plain torch: pointer
// doubling over 16 first-edge chains, then ~35 dense elementwise passes for
// each of the 32 (class, sign) commits, in both passes, thousands of
// launches a batch. On the H100 that took ~129 ms an A4 300 dpi page, about
// 1% of what its memory allows; hence a kernel.
//
// What it computes, from the edges and the angles of the unit gradients
// (torch's atan2), bit for bit as the plain passes:
// - each edge pixel's direction class (`_quantize_angles`): the first of
//   the 16 at the least distance on the circle, in torch's f32 operations
//   and its remainder on the card (fmodf, then + 2 pi if negative);
// - per class k, from every pixel, the first edge cell along v_k within
//   t_units(k) steps; a knight step checks its near intermediate cell, then
//   its far one, then its lattice cell. (The doubling reaches further, to
//   the least power of two >= t_units, but every commit holds the steps to
//   t_units, so a farther first edge and none commit the same);
// - per class k and sign s the segment commits of `_class_commit`: the
//   ray from the nearest upstream anchor to the nearest downstream
//   opposing edge commits its width to the cells between, to the hit, to
//   the anchor and, for a knight move, to the near intermediate cell after
//   each of them but the hit; each anchor's state u | k << 11 | 1 << 16;
// - each anchor's median over its ray's first min(u + 1, 13) cells, and
//   the number of anchors of each page;
// - pass 2: the same commits of the medians, pulled from the anchors.
//
// What bounds it on the H100: by bytes, a pass reads the 1-byte class
// plane and a 4-byte chain plane once for each of the 8 class pairs and
// updates two f32 maps, ~1.4 ms an A4 300 dpi page at 3.35 TB/s (the
// classes read 5 bytes a pixel and write 1, once). In fact the walks'
// latency bounds it: a step of a walk waits on its own loads, so a launch
// lasts about as long as its longest walk (on an H100, ~3 ms a page at
// A4 x 16; the horizontal pair, whose lanes stand on 32 rows, slowest).
//
// Design:
// - The chain along v through a cell is a scan along the digital line p,
//   p + v, p + 2v, ...: one thread walks one line of a class pair (v, -v),
//   backward first, carrying the nearest edge ahead and writing each cell's
//   chain state along v to a scratch plane, then forward, carrying the
//   nearest edge behind (the chain along -v). At each cell of the forward
//   walk it has both chains and commits both classes of the pair and both
//   signs: O(1) a cell and direction, where the doubling built ceil(log2
//   t) dense int32 planes a class. The 16 chain planes never exist.
// - A thread walks a segment of SEG steps of its line, not the whole line:
//   the walks of a launch run side by side, so the longest walk sets its
//   time (a whole line of a column is 3,508 steps at A4 300 dpi). Each
//   walk first looks up to t_units steps past its ends for the nearest
//   edge there, which the neighbouring segment's walk also reads.
// - Lines are numbered by their row residue and intercept, so that at each
//   step the 32 lanes of a warp stand on neighbouring columns of one row
//   (every class pair but the horizontal one, whose lines are rows); a warp
//   walks the union of its lanes' steps, so its loads stay together.
// - Commits are atomicMin on the bits of positive floats: a knight's near
//   intermediate cell lies on another line. The maps are minima, which do
//   not depend on the order of the writes, so they come out as the plain
//   passes' minimum. Only finite values are written.
// - The medians: one thread a pixel, anchors only, the up to 13 samples
//   sorted by a network in registers. The anchor planes become the median
//   planes in place (each thread reads its own anchor words before writing
//   its medians), and n_anchors is counted there: a warp's ballot and one
//   atomic a warp. Nothing is read on the host between the passes.
// - Pass 2 writes into pass 1's maps in place: it reads only the medians,
//   and its anchor commit is the plain pass's min(width, median).
// - Arithmetic as the plain passes: u * |v| is an f32 product, the
//   knight's (u - 1) * |v| + |half| one fmaf, the width d_up + d_dn an f32
//   add; __fmul_rn and __fadd_rn keep nvcc from contracting them.
// - One C entry launches the whole: the classes, a fill, 8 pair launches,
//   the medians, 8 pair launches (19 launches and a memset a call).

#include <climits>
#include <cmath>
#include <cstdlib>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NDIR = 16;
constexpr int THREADS = 128;         // line segments a block
constexpr int SEG = 256;             // steps of a line segment
constexpr int MEDIAN_THREADS = 256;  // pixels a block
constexpr int MISS = (16 << 11) | 2047;
constexpr float INF = 1e9f;
constexpr int MED_SAMPLES = 13;
constexpr unsigned FULL = 0xffffffffu;

// One direction class as `ops/swt.py` `_direction_table` gives it.
struct Dir {
  int dy, dx;           // the step v
  int knight;           // non-zero for a knight move (two intermediate cells)
  int fy, fx;           // its far intermediate cell
  int ny, nx;           // its near one, the cell a knight ray also covers
  int t_units;          // the longest ray, in steps
  float norm;           // |v| in f32
  float hfar, hnear;    // |far|, |near| in f32
};

// The 16 steps for the medians, 4 bits a class (the step + 2), so that a
// class picks its step by a shift, not by indexing an array in local memory
// The f32 constants of `_quantize_angles`.
struct Angles {
  float cls[NDIR];  // the classes' angles
  float pi, two_pi;
};

struct Steps {
  unsigned long long dy, dx;
  __device__ __forceinline__ int y(int k) const {
    return (int)((dy >> (4 * k)) & 15) - 2;
  }
  __device__ __forceinline__ int x(int k) const {
    return (int)((dx >> (4 * k)) & 15) - 2;
  }
};

// A decoded chain state (`_decode_chain`).
struct Chain {
  float d;   // distance to the first edge, INF on a miss
  int u;     // steps to it (2047 on a miss)
  int c;     // its class, -1 on a miss
  bool lat;  // on the lattice, not at a knight's intermediate cell
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// Narrows [lo, hi] to the t with 0 <= b + a * t < m.
__device__ __forceinline__ void clip(int a, int b, int m, int& lo, int& hi) {
  if (a > 0) {
    lo = max(lo, -floordiv(b, a));
    hi = min(hi, floordiv(m - 1 - b, a));
  } else if (a < 0) {
    lo = max(lo, -floordiv(m - 1 - b, -a));
    hi = min(hi, floordiv(b, -a));
  } else if (b < 0 || b >= m) {
    hi = lo - 1;
  }
}

// Lines of a class pair in a page: rows for v = (0, 1); else dy residues
// of the rows times the intercepts on the first row that reach the page.
__host__ __device__ __forceinline__ int row_steps(const Dir& v, int H) {
  return (H - 1) / v.dy;
}

__host__ int lines_of(const Dir& v, int H, int W) {
  if (v.dy == 0) return H;
  return v.dy * (W + abs(v.dx) * row_steps(v, H));
}

// Segments of SEG steps that cover the steps t of every line of the pair.
__host__ int segments_of(const Dir& v, int H, int W) {
  return (v.dy == 0 ? W - 1 : row_steps(v, H)) / SEG + 1;
}

// Line `id` of the pair of v: cells (y0 + v.dy t, x0 + v.dx t), t in
// [lo, hi] (empty when lo > hi). Neighbouring ids of one residue have
// neighbouring intercepts, so at one t they stand on neighbouring columns.
__device__ __forceinline__ void line_of(const Dir& v, int id, int H, int W,
                                        int& y0, int& x0, int& lo, int& hi) {
  if (v.dy == 0) {
    y0 = id;
    x0 = 0;
  } else {
    const int T = row_steps(v, H), nx = W + abs(v.dx) * T;
    y0 = id / nx;
    x0 = id % nx - (v.dx > 0 ? v.dx * T : 0);
  }
  lo = -(1 << 30);
  hi = 1 << 30;
  clip(v.dy, y0, H, lo, hi);
  clip(v.dx, x0, W, lo, hi);
}

__device__ __forceinline__ int cls_at(const int8_t* page, int H, int W, int y,
                                      int x) {
  return (y >= 0 && y < H && x >= 0 && x < W)
             ? (int)__ldg(page + (size_t)y * W + x) : -1;
}

// The chain state of one step along d from (y, x), whose lattice cell holds
// class `lattice` (-1 off the edges or off the page): `_first_edge_along`'s
// base case, the near intermediate cell before the far one before the
// lattice cell.
__device__ __forceinline__ int first_step(const int8_t* page, int H, int W,
                                          int y, int x, const Dir& d,
                                          int lattice) {
  if (d.knight) {
    const int n = cls_at(page, H, W, y + d.ny, x + d.nx);
    if (n >= 0) return 1 | n << 11 | 1 << 17;
    const int f = cls_at(page, H, W, y + d.fy, x + d.fx);
    if (f >= 0) return 1 | f << 11;
  }
  return lattice >= 0 ? 1 | lattice << 11 | 1 << 16 : MISS;
}

__device__ __forceinline__ Chain decode(int enc, const Dir& d) {
  Chain ch;
  ch.u = enc & 2047;
  const int c5 = (enc >> 11) & 31;
  if (c5 >= 16) {
    ch.d = INF;
    ch.c = -1;
    ch.lat = false;
    return ch;
  }
  ch.c = c5;
  ch.lat = (enc >> 16) & 1;
  ch.d = ch.lat ? __fmul_rn((float)ch.u, d.norm)
                : fmaf((float)(ch.u - 1), d.norm,
                       (enc >> 17) & 1 ? d.hnear : d.hfar);
  return ch;
}

// The hit's class is within one class of the opposite of src (`_opposing`).
__device__ __forceinline__ bool opposing(int c, int src) {
  const int diff = (c - src - NDIR / 2) & (NDIR - 1);
  return c >= 0 && (diff <= 1 || diff == NDIR - 1);
}

// min into a map cell of a positive float (INF writes nothing)
__device__ __forceinline__ void relax(float* cell, float v) {
  if (v < INF) atomicMin(reinterpret_cast<int*>(cell), __float_as_int(v));
}

// Both classes of the pair (k along v, k + 8 along w = -v) and both signs
// committed at cell p = (y, x) of class c, from its chain states along v
// and w. maps and state hold [sign -1, sign +1] planes of `plane` cells.
template <bool MEDIANS>
__device__ __forceinline__ void commit(size_t p, size_t page0, int y, int x,
                                       int H, int W, int c, int enc_v,
                                       int enc_w, const Dir& v, const Dir& w,
                                       int k, float* maps, int* state,
                                       size_t plane) {
  const Chain along_v = decode(enc_v, v), along_w = decode(enc_w, w);
  const ptrdiff_t step_v = (ptrdiff_t)v.dy * W + v.dx;
  const int T = v.t_units;
  float lattice[2] = {INF, INF};
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int kk = k + side * NDIR / 2;
    const Dir& d = side ? w : v;            // the ray's direction
    const Chain& dn = side ? along_w : along_v;  // its nearest edge ahead
    const Chain& up = side ? along_v : along_w;  // and behind
    const ptrdiff_t up_step = side ? step_v : -step_v;
#pragma unroll
    for (int si = 0; si < 2; ++si) {  // si 0: sign -1, 1: sign +1
      // an edge of class c casts along c (sign +1) or c + 8 (sign -1)
      const int src = si ? kk : kk ^ (NDIR / 2);
      const bool anchor_up = up.c == src && up.lat;
      const bool hit_dn = opposing(dn.c, src);
      const bool mid = c < 0 && anchor_up && hit_dn && up.u + dn.u <= T;
      const bool on_hit = c >= 0 && anchor_up && opposing(c, src) &&
                          up.u <= T;
      const bool anchor = c == src && hit_dn && dn.u <= T;
      float wm, wh, wa;
      if (MEDIANS) {
        const float* med = reinterpret_cast<const float*>(state) + si * plane;
        const float pulled =
            mid || on_hit ? med[(ptrdiff_t)p + up_step * up.u] : INF;
        wm = mid ? pulled : INF;
        wh = on_hit ? pulled : INF;
        wa = anchor ? med[p] : INF;
      } else {
        wm = mid ? fmaxf(__fadd_rn(up.d, dn.d), 1.0f) : INF;
        wh = on_hit ? fmaxf(up.d, 1.0f) : INF;
        wa = anchor ? fmaxf(dn.d, 1.0f) : INF;
        // one class a pixel and sign can anchor: a plain store
        if (anchor) state[si * plane + p] = dn.u | kk << 11 | 1 << 16;
      }
      lattice[si] = fminf(lattice[si], fminf(fminf(wm, wh), wa));
      if (d.knight) {
        const int hy = y + d.ny, hx = x + d.nx;
        if (hy >= 0 && hy < H && hx >= 0 && hx < W)
          relax(maps + si * plane + page0 + (size_t)hy * W + hx,
                fminf(wm, wa));
      }
    }
  }
  relax(maps + p, lattice[0]);
  relax(maps + plane + p, lattice[1]);
}

// The class of the cell at step t of a line, -1 off [lo, hi].
__device__ __forceinline__ int cls_on(const int8_t* __restrict__ cls,
                                      size_t page0, int W, int y0, int x0,
                                      const Dir& v, int t, int lo, int hi) {
  return t >= lo && t <= hi
             ? (int)__ldg(cls + page0 + (size_t)(y0 + v.dy * t) * W + x0 +
                          v.dx * t)
             : -1;
}

// One class pair (v = the class k < 8, w = -v), one segment of SEG steps
// of one line a thread. The backward walk writes each cell's chain state
// along v to `chain`, starting from the nearest edge ahead of the segment
// (found by looking up to t_units steps past its end); the forward walk
// carries the chain along w, started the same way behind the segment, and
// commits. Pass 1 (MEDIANS false) commits widths and writes the anchor
// states; pass 2 commits the medians that `state` then holds.
template <bool MEDIANS>
__global__ void __launch_bounds__(THREADS)
pair_kernel(const int8_t* __restrict__ cls, int* __restrict__ chain,
            float* maps, int* state, int H, int W, int n_lines, int n_segs,
            int k, Dir v, Dir w) {
  const int b = blockIdx.y;
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  int y0 = 0, x0 = 0, lo = 1, hi = 0, first = 1, last = 0;
  if (id < (long long)n_lines * n_segs) {  // steps [first, last] of [lo, hi]
    const int seg = (int)(id / n_lines);
    line_of(v, (int)(id % n_lines), H, W, y0, x0, lo, hi);
    first = max(lo, seg * SEG);
    last = min(hi, seg * SEG + SEG - 1);
  }
  const bool any = first <= last;
  const int t_first = __reduce_min_sync(FULL, any ? first : INT_MAX);
  const int t_last = __reduce_max_sync(FULL, any ? last : INT_MIN);
  if (!any) return;
  const size_t page0 = (size_t)b * H * W;
  const size_t plane = (size_t)gridDim.y * H * W;
  const int8_t* page = cls + page0;
  const int reach = v.t_units;

  // backward: the nearest edge ahead along v, within t_units steps
  int hit_t = 0, hit = MISS;
  int ahead = cls_on(cls, page0, W, y0, x0, v, last + 1, lo, hi);
  for (int t = last + 1; t <= min(hi, last + reach - 1); ++t) {
    const int f = first_step(page, H, W, y0 + v.dy * t, x0 + v.dx * t, v,
                             cls_on(cls, page0, W, y0, x0, v, t + 1, lo, hi));
    if (f != MISS) {
      hit_t = t;
      hit = f;
      break;
    }
  }
  for (int t = t_last; t >= t_first; --t) {
    if (t < first || t > last) continue;
    const int y = y0 + v.dy * t, x = x0 + v.dx * t;
    const size_t p = page0 + (size_t)y * W + x;
    const int f = first_step(page, H, W, y, x, v, ahead);
    if (f != MISS) {
      hit_t = t;
      hit = f;
    }
    chain[p] = hit != MISS && hit_t - t < reach ? hit + (hit_t - t) : MISS;
    ahead = __ldg(cls + p);
  }

  // forward: the nearest edge behind (along w), and the commits
  hit = MISS;
  int behind = cls_on(cls, page0, W, y0, x0, v, first - 1, lo, hi);
  for (int t = first - 1; t >= max(lo, first - reach + 1); --t) {
    const int f = first_step(page, H, W, y0 + v.dy * t, x0 + v.dx * t, w,
                             cls_on(cls, page0, W, y0, x0, v, t - 1, lo, hi));
    if (f != MISS) {
      hit_t = t;
      hit = f;
      break;
    }
  }
  for (int t = t_first; t <= t_last; ++t) {
    if (t < first || t > last) continue;
    const int y = y0 + v.dy * t, x = x0 + v.dx * t;
    const size_t p = page0 + (size_t)y * W + x;
    const int f = first_step(page, H, W, y, x, w, behind);
    if (f != MISS) {
      hit_t = t;
      hit = f;
    }
    const int enc_w =
        hit != MISS && t - hit_t < reach ? hit + (t - hit_t) : MISS;
    const int c = __ldg(cls + p);
    commit<MEDIANS>(p, page0, y, x, H, W, c, chain[p], enc_w, v, w, k, maps,
                    state, plane);
    behind = c;
  }
}

// Each pixel's direction class, -1 off the edges (`_edge_classes` from the
// angles): torch's f32 operations in its order, each rounded once.
__global__ void classes_kernel(const float* __restrict__ ang,
                               const bool* __restrict__ edges,
                               int8_t* __restrict__ cls, size_t n,
                               Angles a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!edges[i]) {
    cls[i] = -1;
    return;
  }
  const float x = ang[i];
  float best = INFINITY;
  int c = 0;
#pragma unroll
  for (int k = 0; k < NDIR; ++k) {
    float r = fmodf(__fadd_rn(__fsub_rn(x, a.cls[k]), a.pi), a.two_pi);
    if (r < 0.0f) r = __fadd_rn(r, a.two_pi);
    const float d = fabsf(__fsub_rn(r, a.pi));
    if (d < best) {
      best = d;
      c = k;
    }
  }
  cls[i] = (int8_t)c;
}

__global__ void fill_kernel(float* maps, int* state, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    maps[i] = INF;
    state[i] = 0;
  }
}

// The upper median of the first min(u + 1, 13) cells of the ray an anchor
// state names (`_ray_medians`), INF for a pixel that anchors none.
__device__ __forceinline__ float ray_median(const float* map, int a, int y,
                                            int x, int H, int W,
                                            const Steps& steps) {
  if (!(a >> 16)) return INF;
  const int u = a & 2047, kk = (a >> 11) & 31;
  const int dy = steps.y(kk), dx = steps.x(kk);
  const int n = min(u + 1, MED_SAMPLES);
  float s[MED_SAMPLES];
#pragma unroll
  for (int j = 0; j < MED_SAMPLES; ++j) {
    const int yy = y + j * dy, xx = x + j * dx;
    s[j] = j < n && yy >= 0 && yy < H && xx >= 0 && xx < W
               ? map[(size_t)yy * W + xx] : INF;
  }
  // odd-even transposition: MED_SAMPLES rounds sort MED_SAMPLES values
#pragma unroll
  for (int r = 0; r < MED_SAMPLES; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < MED_SAMPLES; j += 2) {
      const float lo = fminf(s[j], s[j + 1]), hi = fmaxf(s[j], s[j + 1]);
      s[j] = lo;
      s[j + 1] = hi;
    }
  }
  float med = s[0];
#pragma unroll
  for (int j = 1; j < MED_SAMPLES; ++j)
    if (j == n / 2) med = s[j];
  return med;
}

// One thread a pixel: both signs' anchor words replaced by their medians,
// and the page's anchors counted.
__global__ void __launch_bounds__(MEDIAN_THREADS)
median_kernel(const float* __restrict__ maps, int* state, int* n_anchors,
              int H, int W, Steps steps) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * MEDIAN_THREADS + threadIdx.x;
  const bool in = i < H * W;
  const size_t page0 = (size_t)b * H * W;
  const size_t plane = (size_t)gridDim.y * H * W;
  const int a_m = in ? state[page0 + i] : 0;
  const int a_p = in ? state[plane + page0 + i] : 0;
  const unsigned ballot = __ballot_sync(FULL, ((a_m | a_p) >> 16) != 0);
  if (ballot && (int)(threadIdx.x & 31) == __ffs(ballot) - 1)
    atomicAdd(n_anchors + b, __popc(ballot));
  if (!in) return;
  const int y = i / W, x = i % W;
  state[page0 + i] = __float_as_int(
      ray_median(maps + page0, a_m, y, x, H, W, steps));
  state[plane + page0 + i] = __float_as_int(
      ray_median(maps + plane + page0, a_p, y, x, H, W, steps));
}

}  // namespace

// angles: f32 [B,H,W] of the unit gradients; edges: bool [B,H,W]; cls:
// int8 [B,H,W] and chain: int32 [B,H,W] scratch; maps: f32 [2,B,H,W] out
// (sign -1, sign +1); state: int32 [2,B,H,W] scratch; n_anchors: int32 [B]
// out. table: 16 x (dy, dx, knight, far y, far x, near y, near x,
// t_units); floats: 16 x (|v|, |far|, |near|, angle), then pi and 2 pi,
// f32. Classes 0..7 step down (or right, class 0) and class k + 8 is
// -v_k. B <= 65535, H * W < 2^31, 1 <= t_units <= 1024.
extern "C" int pft_swt_maps(const void* angles, const void* edges, void* cls,
                            void* chain, void* maps, void* state,
                            void* n_anchors, int B, int H, int W,
                            const int* table, const float* floats,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 ||
      (long long)H * W > INT_MAX - MEDIAN_THREADS)
    return (int)cudaErrorInvalidValue;
  Dir dir[NDIR];
  Steps steps{0, 0};
  Angles ang;
  ang.pi = floats[4 * NDIR];
  ang.two_pi = floats[4 * NDIR + 1];
  for (int c = 0; c < NDIR; ++c) {
    const int* t = table + 8 * c;
    const float* f = floats + 4 * c;
    ang.cls[c] = f[3];
    dir[c] = Dir{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7],
                 f[0], f[1], f[2]};
    if (t[7] < 1 || t[7] > 1024 || abs(t[0]) > 2 || abs(t[1]) > 2)
      return (int)cudaErrorInvalidValue;
    steps.dy |= (unsigned long long)(t[0] + 2) << (4 * c);
    steps.dx |= (unsigned long long)(t[1] + 2) << (4 * c);
  }
  for (int k = 0; k < NDIR / 2; ++k) {
    const Dir &v = dir[k], &w = dir[k + NDIR / 2];
    if (w.dy != -v.dy || w.dx != -v.dx || w.t_units != v.t_units ||
        v.dy < 0 || (v.dy == 0 && v.dx != 1))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t plane = (size_t)B * H * W;
  float* m = (float*)maps;
  int* st = (int*)state;
  classes_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, s>>>(
      (const float*)angles, (const bool*)edges, (int8_t*)cls, plane, ang);
  fill_kernel<<<(unsigned)((2 * plane + 255) / 256), 256, 0, s>>>(m, st,
                                                                2 * plane);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      const cudaError_t err =
          cudaMemsetAsync(n_anchors, 0, sizeof(int) * (size_t)B, s);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((H * W + MEDIAN_THREADS - 1) / MEDIAN_THREADS, B);
      median_kernel<<<grid, MEDIAN_THREADS, 0, s>>>(m, st, (int*)n_anchors,
                                                    H, W, steps);
    }
    for (int k = 0; k < NDIR / 2; ++k) {
      const int n = lines_of(dir[k], H, W), segs = segments_of(dir[k], H, W);
      const long long threads = (long long)n * segs;
      if (threads > (long long)INT_MAX * THREADS)
        return (int)cudaErrorInvalidValue;
      const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), B);
      if (pass == 0)
        pair_kernel<false><<<grid, THREADS, 0, s>>>(
            (const int8_t*)cls, (int*)chain, m, st, H, W, n, segs, k, dir[k],
            dir[k + NDIR / 2]);
      else
        pair_kernel<true><<<grid, THREADS, 0, s>>>(
            (const int8_t*)cls, (int*)chain, m, st, H, W, n, segs, k, dir[k],
            dir[k + NDIR / 2]);
    }
  }
  return (int)cudaGetLastError();
}
