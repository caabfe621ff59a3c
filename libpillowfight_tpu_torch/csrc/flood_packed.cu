// Bit-packed exact flood: pack/unpack and one flood round.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_packed.py:
//   `_pack_kernel` / `pack_rows`, `_unpack_kernel` / `unpack_rows`, and
//   `_lanes_kernel`, `_rows_kernel`, `_dilate_kernel` (driven by
//   `_flood_packed`).
//
// Layout as in the reference: bit k of word (q, x) is pixel (32q + k, x),
// so a page is a [ceil(H/32), W] uint32 plane and one bitwise op moves 32
// rows. A round keeps the reference's three phases: segmented OR along W,
// segmented OR along H across words, then a Chebyshev-ball dilation of
// radius `leap` gated by the mask, with a per-page count of changed words.
// The host repeats rounds until a round changes nothing.
//
// What differs from the TPU kernels, and why:
// - The TPU holds a whole page in VMEM and runs doubling chains over it
//   (log W lane rolls). Here nothing bounds the page size: each phase
//   streams through device memory. The W-axis seg-OR is one block per
//   packed row: each thread folds a chunk of words into the affine map
//   c -> a | (m & c), a block scan of those maps gives each chunk its
//   carry, and a forward then a backward pass write the result. The
//   H-axis seg-OR is one thread per column walking the words down then
//   up, with an in-word Kogge-Stone fill (5 steps) and a 1-bit carry.
// - The dilation is a horizontal pass (OR of 2*leap+1 words) into a
//   scratch plane, then a vertical pass of word shifts gated by the mask.
//
// Bound on the H100: a round reads and writes a few packed planes
// (0.125 B/px each); at A4 a plane is ~1 MB per page and sits in the
// 50 MB L2 for a batch of 16. The column walk of the H-axis pass is
// latency-bound (Hq dependent steps); the dilation is ~2*leap word ops
// per word. The host reads one int per round to test convergence.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void pack_rows_kernel(const uint8_t* __restrict__ plane,
                                 uint32_t* __restrict__ words, int H, int W,
                                 int Hq) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * W) return;
  const int q = (int)(i / W), x = (int)(i % W);
  const uint8_t* src = plane + (size_t)b * H * W + x;
  const int y0 = q * 32, n = min(32, H - y0);
  uint32_t v = 0;
  for (int k = 0; k < n; ++k)
    v |= (uint32_t)(src[(size_t)(y0 + k) * W] != 0) << k;
  words[(size_t)b * Hq * W + i] = v;
}

__global__ void unpack_rows_kernel(const uint32_t* __restrict__ words,
                                   uint8_t* __restrict__ plane, int H, int W,
                                   int Hq) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * W) return;
  const int q = (int)(i / W), x = (int)(i % W);
  uint8_t* dst = plane + (size_t)b * H * W + x;
  const int y0 = q * 32, n = min(32, H - y0);
  const uint32_t v = words[(size_t)b * Hq * W + i];
  for (int k = 0; k < n; ++k) dst[(size_t)(y0 + k) * W] = (v >> k) & 1u;
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
// applied to 0.
__device__ uint32_t carry_in(Op acc, bool reverse, Op* warp_tot) {
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
  __syncthreads();
  Op pre = identity();
  if (reverse) {
    for (int w = THREADS / 32 - 1; w > warp; --w) pre = then(pre, warp_tot[w]);
  } else {
    for (int w = 0; w < warp; ++w) pre = then(pre, warp_tot[w]);
  }
  return then(pre, exc).a;
}

// Segmented OR along W of one packed row: out = m & (any r in the run).
__global__ void lanes_kernel(const uint32_t* __restrict__ mask,
                             const uint32_t* __restrict__ r,
                             uint32_t* __restrict__ out, int W, int Hq) {
  const size_t row = ((size_t)blockIdx.y * Hq + blockIdx.x) * W;
  const uint32_t* m = mask + row;
  const uint32_t* rr = r + row;
  uint32_t* o = out + row;
  const int chunk = (W + THREADS - 1) / THREADS;
  const int lo = min(W, (int)threadIdx.x * chunk), hi = min(W, lo + chunk);
  __shared__ Op warp_tot[THREADS / 32];

  // forward: f[x] = m[x] & (r[x] | f[x-1])
  Op acc = identity();
  for (int x = lo; x < hi; ++x) {
    const uint32_t mm = m[x];
    acc = then(acc, Op{mm & rr[x], mm});
  }
  uint32_t c = carry_in(acc, false, warp_tot);
  for (int x = lo; x < hi; ++x) {
    c = m[x] & (rr[x] | c);
    o[x] = c;
  }
  __syncthreads();
  // backward over f: g[x] = m[x] & (f[x] | g[x+1])
  acc = identity();
  for (int x = hi - 1; x >= lo; --x) {
    const uint32_t mm = m[x];
    acc = then(acc, Op{mm & o[x], mm});
  }
  c = carry_in(acc, true, warp_tot);
  for (int x = hi - 1; x >= lo; --x) {
    c = m[x] & (o[x] | c);
    o[x] = c;
  }
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

// Segmented OR along H, in place: one thread per column, down then up.
__global__ void rows_kernel(const uint32_t* __restrict__ mask, uint32_t* r,
                            int W, int Hq) {
  const int b = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const size_t base = (size_t)b * Hq * W + x;
  uint32_t carry = 0;
  for (int q = 0; q < Hq; ++q) {
    const size_t i = base + (size_t)q * W;
    const uint32_t m = mask[i];
    const uint32_t f = fill_up((r[i] | carry) & m, m);
    r[i] = f;
    carry = f >> 31;
  }
  carry = 0;
  for (int q = Hq - 1; q >= 0; --q) {
    const size_t i = base + (size_t)q * W;
    const uint32_t m = mask[i];
    const uint32_t f = fill_down((r[i] | (carry << 31)) & m, m);
    r[i] = f;
    carry = f & 1u;
  }
}

// h = OR of t over words x-leap .. x+leap of the same packed row.
__global__ void hdilate_kernel(const uint32_t* __restrict__ t,
                               uint32_t* __restrict__ h, int W, int Hq,
                               int leap) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Hq * W) return;
  const int x = (int)(i % W);
  const uint32_t* src = t + (size_t)b * Hq * W + (i - x);
  uint32_t v = 0;
  const int x1 = min(W - 1, x + leap);
  for (int xx = max(0, x - leap); xx <= x1; ++xx) v |= src[xx];
  h[(size_t)b * Hq * W + i] = v;
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* col, int q, int Hq,
                                            int W) {
  return (q >= 0 && q < Hq) ? col[(size_t)q * W] : 0u;
}

// r = (vertical dilation of h by leap rows & mask) | t; changed[b] += the
// number of words where r != t.
__global__ void vdilate_gate_kernel(const uint32_t* __restrict__ mask,
                                    const uint32_t* __restrict__ t,
                                    const uint32_t* __restrict__ h,
                                    uint32_t* __restrict__ r,
                                    int* __restrict__ changed, int W, int Hq,
                                    int leap) {
  const int b = blockIdx.y;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int ch = 0;
  if (i < (size_t)Hq * W) {
    const int q = (int)(i / W), x = (int)(i % W);
    const uint32_t* col = h + (size_t)b * Hq * W + x;
    uint32_t v = col[(size_t)q * W];
    for (int d = 1; d <= leap; ++d) {
      const int qd = d >> 5, s = d & 31;
      uint32_t dn, up;  // bit-row y takes row y - d (dn) and y + d (up)
      if (s) {
        dn = (word_at(col, q - qd, Hq, W) << s) |
             (word_at(col, q - qd - 1, Hq, W) >> (32 - s));
        up = (word_at(col, q + qd, Hq, W) >> s) |
             (word_at(col, q + qd + 1, Hq, W) << (32 - s));
      } else {
        dn = word_at(col, q - qd, Hq, W);
        up = word_at(col, q + qd, Hq, W);
      }
      v |= dn | up;
    }
    const size_t idx = (size_t)b * Hq * W + i;
    const uint32_t tv = t[idx];
    const uint32_t r2 = (v & mask[idx]) | tv;
    r[idx] = r2;
    ch = r2 != tv;
  }
  const unsigned bal = __ballot_sync(FULL, ch);
  if ((threadIdx.x & 31) == 0 && bal) atomicAdd(&changed[b], __popc(bal));
}

inline dim3 word_grid(int Hq, int W, int B) {
  return dim3((unsigned)(((size_t)Hq * W + THREADS - 1) / THREADS), B);
}

}  // namespace

// plane: uint8/bool [B,H,W] -> words: uint32 [B,ceil(H/32),W].
extern "C" int pft_pack_rows(const void* plane, void* words, int B, int H,
                             int W, void* stream) {
  const int Hq = (H + 31) / 32;
  if (B > 0 && Hq > 0 && W > 0)
    pack_rows_kernel<<<word_grid(Hq, W, B), THREADS, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)plane,
                                               (uint32_t*)words, H, W, Hq);
  return (int)cudaGetLastError();
}

// words: uint32 [B,ceil(H/32),W] -> plane: uint8/bool [B,H,W].
extern "C" int pft_unpack_rows(const void* words, void* plane, int B, int H,
                               int W, void* stream) {
  const int Hq = (H + 31) / 32;
  if (B > 0 && Hq > 0 && W > 0)
    unpack_rows_kernel<<<word_grid(Hq, W, B), THREADS, 0,
                         (cudaStream_t)stream>>>((const uint32_t*)words,
                                                 (uint8_t*)plane, H, W, Hq);
  return (int)cudaGetLastError();
}

// One flood round on packed [B,Hq,W] planes. r: state, updated in place;
// t, h: scratch planes; changed: int32 [B], zeroed by the caller.
extern "C" int pft_flood_round(const void* mask, void* r, void* t, void* h,
                               void* changed, int B, int Hq, int W, int leap,
                               void* stream) {
  if (B > 0 && Hq > 0 && W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* m = (const uint32_t*)mask;
    lanes_kernel<<<dim3(Hq, B), THREADS, 0, s>>>(m, (const uint32_t*)r,
                                                 (uint32_t*)t, W, Hq);
    rows_kernel<<<dim3((W + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(
        m, (uint32_t*)t, W, Hq);
    hdilate_kernel<<<word_grid(Hq, W, B), THREADS, 0, s>>>(
        (const uint32_t*)t, (uint32_t*)h, W, Hq, leap);
    vdilate_gate_kernel<<<word_grid(Hq, W, B), THREADS, 0, s>>>(
        m, (const uint32_t*)t, (const uint32_t*)h, (uint32_t*)r,
        (int*)changed, W, Hq, leap);
  }
  return (int)cudaGetLastError();
}
