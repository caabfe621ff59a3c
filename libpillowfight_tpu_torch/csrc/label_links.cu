// Connected components under pairwise links: min-flat-index labels.
//
// Replaces libpillowfight_tpu/ops/pallas/flood_kernel.py
// `_label_sweep_kernel` (driven by `_label_sweep` and
// `label_components_pallas`), and serves `morph.label_components_links`,
// which the reference computes outside any kernel.
//
// What it computes: for a 0/1 byte plane `valid` [B,H,W] and four link
// bits per pixel (bit d joins (y,x) to (y+dy,x+dx) for d over
// (0,1),(1,0),(1,1),(1,-1)), int32 labels [B,H,W]: the least flat index
// y*W + x of the pixel's component, H*W on invalid pixels. A link counts
// only when both ends are valid pixels of the page. With no link plane
// every pair of valid neighbours is linked (8-connectivity), which is what
// the TPU kernel computes.
//
// What differs from the TPU kernel, and why: the TPU kernel propagates
// min labels with segmented doubling scans, band by band in grid order,
// down and up until a sweep changes nothing. Blocks run in no order here,
// so the labels come from a union-find over pixels instead, in three
// launches and no host round trip:
//   1. parent[p] = p on valid pixels, H*W elsewhere;
//   2. one thread per pixel unites the two ends of each of its links:
//      find both roots, hang the larger under the smaller with atomicMin,
//      go on from what the atomic displaced until it sticks;
//   3. every valid pixel takes its root.
// A parent is never larger than its child and only ever decreases, so
// there are no cycles, the root of a finished component is its least
// index, and the result does not depend on the order of the atomics.
// `find` halves its path with atomicMin (a plain store could undo a
// concurrent union).
//
// Bound on the H100: bytes. Compulsory traffic is one valid byte, one
// link byte and one int32 label written per pixel; the parent plane is
// read and rewritten a few more times (it is the label plane itself).
// The unions are dependent loads through L2, so the kernel is latency
// bound on long solid regions rather than bandwidth bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int load_parent(int* parent, int x) {
  return *((volatile int*)(parent + x));
}

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

__global__ void init_kernel(const uint8_t* __restrict__ valid,
                            int* __restrict__ parent, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t base = (size_t)blockIdx.y * n;
  parent[base + p] = valid[base + p] ? p : n;
}

__global__ void merge_kernel(const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ links, int* parent,
                             int H, int W) {
  const int n = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t base = (size_t)blockIdx.y * n;
  const uint8_t* v = valid + base;
  if (!v[p]) return;
  const int bits = links ? links[base + p] : 15;
  if (!bits) return;
  const int y = p / W, x = p - y * W;
  int* par = parent + base;
  if ((bits & 1) && x + 1 < W && v[p + 1]) unite(par, p, p + 1);
  if (y + 1 < H) {
    if ((bits & 2) && v[p + W]) unite(par, p, p + W);
    if ((bits & 4) && x + 1 < W && v[p + W + 1]) unite(par, p, p + W + 1);
    if ((bits & 8) && x > 0 && v[p + W - 1]) unite(par, p, p + W - 1);
  }
}

__global__ void flatten_kernel(int* parent, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int* par = parent + (size_t)blockIdx.y * n;
  if (load_parent(par, p) == n) return;  // invalid pixel
  const int root = find_root(par, p);
  // roots keep their own index; a non-root only ever moves closer to
  // its root, so concurrent finds through p stay right
  if (root != p) atomicMin(par + p, root);
}

}  // namespace

// valid: uint8/bool [B,H,W]; links: uint8 [B,H,W] of 4 link bits, or null
// for 8-connectivity of valid; labels: int32 [B,H,W], written in full.
extern "C" int pft_label_links(const void* valid, const void* links,
                               void* labels, int B, int H, int W,
                               void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int n = H * W;
    const dim3 grid((n + THREADS - 1) / THREADS, B);
    init_kernel<<<grid, THREADS, 0, s>>>((const uint8_t*)valid, (int*)labels,
                                         n);
    merge_kernel<<<grid, THREADS, 0, s>>>((const uint8_t*)valid,
                                          (const uint8_t*)links, (int*)labels,
                                          H, W);
    flatten_kernel<<<grid, THREADS, 0, s>>>((int*)labels, n);
  }
  return (int)cudaGetLastError();
}
