// Connected components under pairwise links: min-flat-index labels.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_kernel.py
// `_label_sweep_kernel` (driven by `_label_sweep` and
// `label_components_pallas`), and serves `morph.label_components_links`,
// which the reference computes outside any kernel.
//
// What it computes: for a 0/1 byte plane `valid` [B,H,W] and four 0/1
// byte planes of links (plane d joins (y,x) to (y+dy,x+dx) for d over
// (0,1),(1,0),(1,1),(1,-1)), int32 labels [B,H,W]: the least flat index
// y*W + x of the pixel's component, H*W on invalid pixels. A link counts
// only when both ends are valid pixels of the page. With no link planes
// every pair of valid neighbours is linked (8-connectivity), which is what
// the TPU kernel computes.
//
// What differs from the TPU kernel: it propagates min labels with
// segmented doubling scans, band by band in grid order, down and up until
// a sweep changes nothing. Blocks run in no order here, so the labels come
// from a union-find instead.
//
// Bound on the H100: bytes (one valid byte, four link bytes, one int32
// label a pixel), but a union-find with one thread a pixel on device
// memory runs far from it: every pass streams the whole page in single
// bytes, and every union is a chain of dependent loads and atomics through
// L2, also for the many links that lie inside one small neighbourhood.
// What this design does about it, in three launches and no host round
// trip:
//
//   1. `tile_kernel`: a block owns a tile of 64 x 32 pixels and labels it
//      in shared memory. It reads the valid plane as 4-byte words (tile
//      plus a one-pixel rim), and the link planes only where the word
//      holds a valid pixel: SWT's planes and a page's non-white plane are
//      sparse. Four link bits a pixel are masked to links between valid
//      pixels of the page, by byte-parallel word operations. A tile without
//      a valid pixel writes H*W and is done. Otherwise: every pixel starts
//      under the head of its horizontal run (found with one ballot a row
//      half, so a run costs no union at all), the remaining links inside
//      the tile are united with shared-memory atomics, and links that
//      follow from three others (the diagonal beside a vertical and a
//      horizontal link, the vertical link beside its left neighbour's) are
//      skipped, which leaves a solid region one union a run. Row-major
//      order inside a tile agrees with flat-index order, so a local root
//      is the least flat index of its piece. Each pixel then writes the
//      flat index of its local root, once, as 16-byte stores. The links
//      that leave the tile (right column, bottom row, left column) go to
//      a scratch list of 128 bytes a tile, filtered the same way.
//   2. `border_kernel`: reads that list (1/16 byte a pixel) and unites
//      the two ends of each crossing link in device memory: find both
//      roots, hang the larger under the smaller with atomicMin, go on from
//      what the atomic displaced until it sticks.
//   3. `flatten_kernel`: every pixel of a tile that holds a valid pixel
//      takes its root; other tiles are not read again.
//
// Why it is right whatever the order of blocks and atomics: a parent is
// never larger than its child and only ever decreases, so there are no
// cycles and the root of a finished component is its least index; `find`
// halves its path with atomicMin while unions run (a plain store could
// undo a concurrent union). Plain stores appear only where no union runs
// any more: after the tile's barrier in step 1, and in step 3, where a
// pixel is overwritten by its final root and a reader sees either a
// former ancestor or the root.
//
// Planes whose width is no multiple of 4, or whose pointers are not
// aligned, take the same kernels with byte loads and 4-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 64, TH = 32;      // tile, in pixels
constexpr int THREADS = 256;         // 8 pixels a thread
constexpr int WORDS = TW / 4;        // 4-pixel words a tile row
constexpr int VS = TW + 8;           // s_valid row: column c at byte 4 + c
constexpr int BORDER = TW + 2 * TH;  // crossing-link bytes a tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int load_parent(int* parent, int x) {
  return *((volatile int*)(parent + x));
}

// shared and device memory alike
__device__ int find_root(int* parent, int x) {
  int p = load_parent(parent, x);
  while (p != x) {
    const int g = load_parent(parent, p);
    if (g != p) atomicMin(parent + x, g);
    x = p;
    p = g;
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b. If a was still a root this sticks;
    // else `old` is what a hung under, and old and b remain to unite.
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

// bytes x..x+3 of a row as one word, zero past the row's end
template <bool VEC>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int x, int W) {
  if (VEC) return x < W ? __ldg((const uint32_t*)(row + x)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < W) w |= (uint32_t)row[x + j] << (8 * j);
  return w;
}

// every non-zero byte becomes 1
__device__ __forceinline__ uint32_t bytes01(uint32_t w) {
  return ((w | ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu)) >> 7) & 0x01010101u;
}

template <bool VEC>
__device__ __forceinline__ void store4(int* row, int x, int W, int4 v) {
  if (VEC) {
    if (x < W) *(int4*)(row + x) = v;
    return;
  }
  const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x + j < W) row[x + j] = vals[j];
}

template <bool VEC>
__device__ __forceinline__ int4 load4i(const int* row, int x, int W, int n) {
  if (VEC) return x < W ? *(const int4*)(row + x) : make_int4(n, n, n, n);
  int vals[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) vals[j] = x + j < W ? row[x + j] : n;
  return make_int4(vals[0], vals[1], vals[2], vals[3]);
}

__device__ __forceinline__ size_t tile_index() {
  return ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

// links: four planes, or all null for 8-connectivity of `valid`
struct Links {
  const uint8_t* plane[4];
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const uint8_t* __restrict__ valid, Links links,
            int* __restrict__ labels, uint8_t* __restrict__ border,
            uint8_t* __restrict__ flags, int H, int W) {
  // valid: rows y0 .. y0+TH, columns x0-1 .. x0+TW (a rim right, below and
  // left); eff: the four link bits of each tile pixel, links between valid
  // pixels of the page only; h0: the raw (0,1) links of the row below the
  // tile, columns x0-1 .. x0+TW-1 at index c + 1
  __shared__ __align__(16) uint8_t s_valid[(TH + 1) * VS];
  __shared__ __align__(16) uint8_t s_eff[TH * TW];
  __shared__ uint8_t s_h0[TW + 4];
  __shared__ int s_par[TH * TW];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int n = H * W;
  const size_t base = (size_t)blockIdx.z * n;
  const size_t tile = tile_index();
  const uint8_t* v = valid + base;
  const bool has_links = links.plane[0] != nullptr;

  for (int i = tid; i < (TH + 1) * WORDS; i += THREADS) {
    const int r = i / WORDS, wd = i % WORDS, y = y0 + r;
    const uint32_t w = y < H ? load4<VEC>(v + (size_t)y * W, x0 + 4 * wd, W)
                             : 0u;
    *(uint32_t*)&s_valid[r * VS + 4 + 4 * wd] = bytes01(w);
  }
  if (tid < 2 * (TH + 1)) {  // the rim columns
    const int r = tid >> 1, y = y0 + r;
    const int x = (tid & 1) ? x0 + TW : x0 - 1;
    const bool in = y < H && x >= 0 && x < W;
    s_valid[r * VS + ((tid & 1) ? 4 + TW : 3)] =
        in && v[(size_t)y * W + x] ? 1 : 0;
  } else if (tid >= 128 && tid < 128 + TW + 1) {
    const int c = tid - 128 - 1, x = x0 + c, y = y0 + TH;
    const bool in = y < H && x >= 0 && x < W;
    s_h0[c + 1] = !has_links ? 1
                  : in && links.plane[0][base + (size_t)y * W + x] ? 1 : 0;
  }
  __syncthreads();

  // each thread: word wd of rows r and r + 16
  const int wd = tid % WORDS, r_lo = tid / WORDS;
  uint32_t own = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = r_lo + 16 * k, y = y0 + r;
    const uint32_t* vr = (const uint32_t*)&s_valid[r * VS];
    const uint32_t* vd = (const uint32_t*)&s_valid[(r + 1) * VS];
    const uint32_t w0 = vr[1 + wd];
    uint32_t e = 0;
    if (w0) {  // link bytes matter only beside a valid pixel
      uint32_t l[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
      if (has_links) {
#pragma unroll
        for (int d = 0; d < 4; ++d)
          l[d] = load4<VEC>(links.plane[d] + base + (size_t)y * W,
                            x0 + 4 * wd, W);
#pragma unroll
        for (int d = 0; d < 4; ++d) l[d] = bytes01(l[d]);
      }
      const uint32_t right = __funnelshift_r(w0, vr[2 + wd], 8);
      const uint32_t d0 = vd[1 + wd];
      const uint32_t dr = __funnelshift_r(d0, vd[2 + wd], 8);
      const uint32_t dl = __funnelshift_l(vd[wd], d0, 8);
      e = (l[0] & right) | ((l[1] & d0) << 1) | ((l[2] & dr) << 2) |
          ((l[3] & dl) << 3);
      e &= w0 * 15u;
    }
    *(uint32_t*)&s_eff[r * TW + 4 * wd] = e;
    own |= w0;
  }
  const int any = __syncthreads_or(own != 0);  // also publishes s_eff

  int* lab = labels + base;
  if (!any) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int y = y0 + r_lo + 16 * k;
      if (y < H)
        store4<VEC>(lab + (size_t)y * W, x0 + 4 * wd, W,
                    make_int4(n, n, n, n));
    }
    if (tid < BORDER / 4) ((uint32_t*)(border + tile * BORDER))[tid] = 0u;
    if (tid == 0) flags[tile] = 0;
    return;
  }

  // every pixel under the head of its run of (0,1) links, a row half
  // (32 pixels, one ballot) at a time
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int rr = 0; rr < TH / 8; ++rr) {
    const int r = warp + 8 * rr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r * TW + half * 32 + lane;
      const unsigned linked = __ballot_sync(FULL, s_eff[i] & 1);
      const unsigned gaps = ~linked & ((1u << lane) - 1u);
      s_par[i] = i - lane + (gaps ? 32 - __clz(gaps) : 0);
    }
  }
  __syncthreads();

  // the other links inside the tile; a link that follows from three
  // others is skipped
#pragma unroll
  for (int rr = 0; rr < TH / 8; ++rr) {
    const int r = warp + 8 * rr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 32 + lane, i = r * TW + c;
      const int e = s_eff[i];
      if (!e) continue;
      if ((e & 1) && c == 31) unite(s_par, i, i + 1);
      if (r == TH - 1) continue;
      const int el = c > 0 ? s_eff[i - 1] : 0;
      const int ed = s_eff[i + TW];
      const int edl = c > 0 ? s_eff[i + TW - 1] : 0;
      if ((e & 2) && !((el & 3) == 3 && (edl & 1))) unite(s_par, i, i + TW);
      if ((e & 4) && c < TW - 1 && !((e & 2) && (ed & 1)))
        unite(s_par, i, i + TW + 1);
      if ((e & 8) && c > 0 && !((e & 2) && (edl & 1)))
        unite(s_par, i, i + TW - 1);
    }
  }
  __syncthreads();

  // no union runs any more: each pixel writes the flat index of its root
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = r_lo + 16 * k, y = y0 + r;
    if (y >= H) continue;
    int out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * wd + j;
      int root = r * TW + c;
      while (s_par[root] != root) root = s_par[root];
      out[j] = s_valid[r * VS + 4 + c]
                   ? (y0 + root / TW) * W + x0 + root % TW
                   : n;
    }
    store4<VEC>(lab + (size_t)y * W, x0 + 4 * wd, W,
                make_int4(out[0], out[1], out[2], out[3]));
  }

  // the links that leave the tile: bottom row (bits 1, 2, 3), right
  // column (bit 0, and bit 2 above the bottom row), left column (bit 3
  // above the bottom row), each link in one list only
  if (tid < BORDER) {
    int out = 0;
    if (tid < TW) {
      const int c = tid, i = (TH - 1) * TW + c;
      const int e = s_eff[i];
      const int el = c > 0 ? s_eff[i - 1] : 0;
      const uint8_t* below = &s_valid[TH * VS + 4];
      // (0,1) links of the row below, from column c - 1 and from c
      const bool h_left = s_h0[c] && below[c - 1] && below[c];
      const bool h_here = s_h0[c + 1] && below[c] && below[c + 1];
      if ((e & 2) && !((el & 3) == 3 && h_left)) out |= 2;
      if ((e & 4) && !((e & 2) && h_here)) out |= 4;
      if ((e & 8) && !((e & 2) && h_left)) out |= 8;
    } else if (tid < TW + TH) {
      const int r = tid - TW, i = r * TW + TW - 1;
      const int e = s_eff[i];
      out = e & 1;
      if (r < TH - 1 && (e & 4) && !((e & 2) && (s_eff[i + TW] & 1)))
        out |= 4;
    } else {
      const int r = tid - TW - TH;
      if (r < TH - 1) out = s_eff[r * TW] & 8;
    }
    border[tile * BORDER + tid] = (uint8_t)out;
  }
  if (tid == 0) flags[tile] = 1;
}

// one thread a word of four crossing-link bytes
__global__ void border_kernel(const uint8_t* __restrict__ border, int* labels,
                              int H, int W, int tiles_x, int tiles_y,
                              size_t n_words) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_words) return;
  const uint32_t word = ((const uint32_t*)border)[idx];
  if (!word) return;
  const size_t tile = idx / (BORDER / 4);
  const int t0 = (int)(idx % (BORDER / 4)) * 4;
  const size_t per_page = (size_t)tiles_x * tiles_y;
  const int in_page = (int)(tile % per_page);
  const int x0 = (in_page % tiles_x) * TW, y0 = (in_page / tiles_x) * TH;
  int* par = labels + (tile / per_page) * (size_t)H * W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bits = (word >> (8 * j)) & 0xff;
    if (!bits) continue;
    const int t = t0 + j;
    const int r = t < TW ? TH - 1 : t < TW + TH ? t - TW : t - TW - TH;
    const int c = t < TW ? t : t < TW + TH ? TW - 1 : 0;
    const int p = (y0 + r) * W + x0 + c;
    if (bits & 1) unite(par, p, p + 1);
    if (bits & 2) unite(par, p, p + W);
    if (bits & 4) unite(par, p, p + W + 1);
    if (bits & 8) unite(par, p, p + W - 1);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
flatten_kernel(int* labels, const uint8_t* __restrict__ flags, int H, int W) {
  if (!flags[tile_index()]) return;  // the tile holds H*W only
  const int n = H * W;
  int* par = labels + (size_t)blockIdx.z * n;
  const int x = blockIdx.x * TW + 4 * (threadIdx.x % WORDS);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int y = blockIdx.y * TH + threadIdx.x / WORDS + 16 * k;
    if (y >= H) continue;
    int* row = par + (size_t)y * W;
    const int4 v = load4i<VEC>(row, x, W, n);
    int l[4] = {v.x, v.y, v.z, v.w};
    bool moved = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (l[j] == n) continue;
      int root = l[j], up = par[root];
      while (up != root) {
        root = up;
        up = par[root];
      }
      moved |= root != l[j];
      l[j] = root;
    }
    // a root keeps its own index, so it is rewritten with the same value
    if (moved) store4<VEC>(row, x, W, make_int4(l[0], l[1], l[2], l[3]));
  }
}

inline int tiles_of(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

}  // namespace

// Bytes of scratch one page needs: its tiles' crossing-link lists and a
// flag a tile.
extern "C" int pft_label_scratch_bytes(int H, int W) {
  return tiles_of(H, W) * (BORDER + 1);
}

// valid: uint8/bool [B,H,W]; l0..l3: uint8/bool [B,H,W] planes of the
// links (0,1), (1,0), (1,1), (1,-1), or all null for 8-connectivity of
// valid; labels: int32 [B,H,W], written in full; scratch: B times
// pft_label_scratch_bytes(H, W) bytes, 4-byte aligned.
extern "C" int pft_label_links(const void* valid, const void* l0,
                               const void* l1, const void* l2, const void* l3,
                               void* labels, void* scratch, int B, int H,
                               int W, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    const size_t tiles = (size_t)B * tiles_x * tiles_y;
    uint8_t* border = (uint8_t*)scratch;
    uint8_t* flags = border + tiles * BORDER;
    const Links links = {{(const uint8_t*)l0, (const uint8_t*)l1,
                          (const uint8_t*)l2, (const uint8_t*)l3}};
    const uintptr_t ptrs = (uintptr_t)valid | (uintptr_t)l0 | (uintptr_t)l1 |
                           (uintptr_t)l2 | (uintptr_t)l3;
    const bool vec = W % 4 == 0 && ptrs % 4 == 0 && (uintptr_t)labels % 16 == 0;
    const dim3 grid(tiles_x, tiles_y, B);
    const size_t n_words = tiles * (BORDER / 4);
    const int border_blocks = (int)((n_words + THREADS - 1) / THREADS);
    if (vec) {
      tile_kernel<true><<<grid, THREADS, 0, s>>>(
          (const uint8_t*)valid, links, (int*)labels, border, flags, H, W);
    } else {
      tile_kernel<false><<<grid, THREADS, 0, s>>>(
          (const uint8_t*)valid, links, (int*)labels, border, flags, H, W);
    }
    border_kernel<<<border_blocks, THREADS, 0, s>>>(
        border, (int*)labels, H, W, tiles_x, tiles_y, n_words);
    if (vec) {
      flatten_kernel<true><<<grid, THREADS, 0, s>>>((int*)labels, flags, H, W);
    } else {
      flatten_kernel<false><<<grid, THREADS, 0, s>>>((int*)labels, flags, H,
                                                     W);
    }
  }
  return (int)cudaGetLastError();
}
