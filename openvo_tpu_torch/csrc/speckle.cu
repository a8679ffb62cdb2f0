// Speckle labelling kernel for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/speckle_cuda.py holds the wrapper; the plain
// version is ops/sgbm.speckle_keep_plain).
//
//   H7 speckle_keep <- the speckle filter's labelling and sizing, a
//   lax.while_loop of row/column min-scans in the JAX package
//   (openvo_tpu/ops/sgbm.py:476-488), left to XLA
//
// 4-connected components of valid pixels whose disparities differ by at
// most max_diff (invalid pixels are singletons), labelled by a block-based
// union-find in the manner of Allegretti, Bolelli and Grana, "Optimized
// Block-Based Algorithms to Label Connected Components on GPUs" (IEEE
// TPDS 2020), in four launches with no host read:
//   1. tile, one block a kTileH x 32 tile of a frame (a warp a tile row):
//      the tile's disparities and valid bits staged in shared memory;
//      each pixel's parent is the first pixel of its run inside the tile
//      row (a ballot of the run starts); the vertical edges inside the
//      tile unite their trees in shared memory (atomicMin); each pixel
//      then finds its tile-local root and the pixels of a root are counted
//      there (one shared atomicAdd a root a warp row). Written out: label
//      = the global flat index of the tile-local root, size = the count at
//      a tile-local root and 0 elsewhere;
//   2. border, a thread an edge that crosses tiles (a tile's top row
//      against the row above, its left column against the column on its
//      left; about 29k on a 1242x376 frame, of 467k pixels): union of the
//      two trees in the global labels, unless the edge is implied by
//      edges that other threads or the tiles unite (the skip rules in
//      border_kernel, each argued by induction along the tile edge);
//   3. roots, one block a tile: each tile-local root (size > 0) walks to
//      its component's root (one walk a tile part, not one a pixel: the
//      border unions leave chains of tile roots) and, unless it is that
//      root, adds its count there (one global atomicAdd a tile part);
//      then each pixel's label is the root of its tile-local root, from
//      shared memory (a pixel that a border union re-pointed walks its own
//      chain);
//   4. keep: valid & (size of the root > window).
// Every parent is a smaller flat index than its child (a run's start, or
// the smaller root of a union; inside a tile the local index order is the
// flat index order), so a component's root, and so every pixel's label,
// is the smallest flat index of the component: the plain version's label
// too. A batch is one flat index space (frame b's pixels at
// [b*H*W, (b+1)*H*W)); a tile never straddles frames, and no edge crosses
// a frame or wraps from a row's end to the next row's start.
//
// Concurrency. Tile phase: a root is linked only by atomicMin on itself,
// and when that fails (another thread linked that root first) the union
// goes on from the root the other thread linked it under; find halves the
// paths it walks with plain stores, only on nodes it saw with a parent
// (never a root) and only to an ancestor, so each store keeps every node
// in its tree. Every store (run start, atomicMin, halving) writes a value
// no larger than the one it replaces: parents only decrease, and find
// always ends. The barrier after the unions ends them; the compress step
// then writes only each thread's own entry, with its root. Border phase:
// the same union on the global labels (volatile loads: other blocks link
// roots meanwhile). Roots phase: after the border launch the forest no
// longer changes; each thread writes only its own label (its root, an
// ancestor of every node that reads it), and the count of a tile-local
// root i is read and added only where i is not a root, where no thread
// adds to it.
// Bound: each pixel's disparity and valid byte read, its label and keep
// written (about 8 bytes a pixel: 3.7 MB, 1.1 us at 3.35 TB/s, on a
// 1242x376 frame); the chains of dependent loads and the launches set the
// time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;        // the border and keep launches
constexpr int kTileW = 32;           // a warp a tile row
constexpr int kTileH = 32;           // rows a tile
constexpr int kTileWarps = 16;       // warps a tile block
constexpr int kRows = kTileH / kTileWarps;   // tile rows a warp
constexpr int kTilePixels = kTileH * kTileW;
static_assert(kTileH % kTileWarps == 0, "whole rows a warp");

__device__ __forceinline__ bool near(int a, int b, int max_diff) {
  return abs(a - b) <= max_diff;
}

template <typename T>
__device__ __forceinline__ bool joined(const T* d, const uint8_t* valid,
                                       int i, int j, int max_diff) {
  if (!valid[i] || !valid[j]) return false;
  return near((int)d[i], (int)d[j], max_diff);
}

__device__ __forceinline__ int parent(const int* L, int a) {
  return *(const volatile int*)(L + a);
}

// The root of a's tree. With `halve`, each node on the way is pointed at
// its grandparent (unions only: in a compress step a late store could
// overwrite the root another thread just wrote there).
template <bool halve>
__device__ __forceinline__ int find(int* L, int a) {
  int p = parent(L, a);
  while (p != a) {
    const int g = parent(L, p);
    if (halve && g != p) *(volatile int*)(L + a) = g;
    a = p;
    p = g;
  }
  return a;
}

// Links the trees of a and b, the larger root under the smaller. L is in
// global or shared memory (inlined, so that the compiler sees which).
__device__ __forceinline__ void unite(int* L, int a, int b) {
  bool done = false;
  while (!done) {
    a = find<true>(L, a);
    b = find<true>(L, b);
    if (a < b) {
      const int old = atomicMin(L + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(L + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  }
}

// Block b's tile: its first column and row, and its frame's first flat
// index (the grid covers frames x tiles_y x tiles_x, x fastest).
struct Tile {
  int x0, y0, base;
};

__device__ __forceinline__ Tile tile_of_block(int H, int W, int tiles_x,
                                              int tiles_y) {
  const int b = blockIdx.x, per = tiles_x * tiles_y;
  return {b % tiles_x * kTileW, b % per / tiles_x * kTileH, b / per * H * W};
}

// 1. One block a tile: local union-find in shared memory, then the labels
// (global index of the tile-local root) and the tile-local roots' counts.
template <typename T>
__global__ void __launch_bounds__(kTileWarps * 32) tile_kernel(
    const T* __restrict__ disp, const uint8_t* __restrict__ valid,
    int* __restrict__ labels, int* __restrict__ size, int H, int W,
    int tiles_x, int tiles_y, int max_diff) {
  __shared__ int L[kTilePixels];
  __shared__ int cnt[kTilePixels];
  __shared__ int ds[kTilePixels];
  __shared__ unsigned vmask[kTileH], smask[kTileH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile t = tile_of_block(H, W, tiles_x, tiles_y);
  const int x0 = t.x0, y0 = t.y0, base = t.base, x = x0 + lane;
  bool v[kRows], left[kRows];
  int d[kRows];

  // run starts: a pixel starts a run unless joined to its left neighbour
  // inside the tile; parent = the row's run start
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, y = y0 + ly, l = ly * kTileW + lane;
    const bool in = x < W && y < H;
    const int g = base + y * W + x;
    v[r] = in && valid[g];
    d[r] = in ? (int)disp[g] : 0;
    ds[l] = d[r];
    cnt[l] = 0;
    const int dl = __shfl_up_sync(kFull, d[r], 1);
    const unsigned vm = __ballot_sync(kFull, v[r]);
    left[r] = lane > 0 && v[r] && ((vm >> (lane - 1)) & 1) &&
              near(d[r], dl, max_diff);
    const unsigned sm = __ballot_sync(kFull, !left[r]);
    const unsigned le = sm & (kFull >> (31 - lane));   // lane 0 starts one
    L[l] = ly * kTileW + 31 - __clz(le);
    if (lane == 0) {
      vmask[ly] = vm;
      smask[ly] = sm;
    }
  }
  __syncthreads();

  // the vertical edges inside the tile; an edge is skipped where its left
  // neighbour's edge, the run to the left and the run above imply it
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, l = ly * kTileW + lane;
    const int above = ly > 0 ? ly - 1 : 0;   // row 0 has no edge up
    const bool up = ly > 0 && v[r] && ((vmask[above] >> lane) & 1) &&
                    near(d[r], ds[above * kTileW + lane], max_diff);
    const bool up_left = __shfl_up_sync(kFull, up, 1);
    const bool implied = lane > 0 && left[r] && up_left &&
                         !((smask[above] >> lane) & 1);
    if (up && !implied) unite(L, l, l - kTileW);
  }
  __syncthreads();

  // tile-local roots; the pixels of a root counted there
  int root[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, l = ly * kTileW + lane;
    root[r] = find<false>(L, l);
    L[l] = root[r];
    const bool in = x < W && y0 + ly < H;
    const int key = in ? root[r] : -1;
    const unsigned same = __match_any_sync(kFull, key);
    if (in && lane == __ffs(same) - 1) atomicAdd(cnt + key, __popc(same));
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, y = y0 + ly, l = ly * kTileW + lane;
    if (x < W && y < H) {
      const int g = base + y * W + x;
      const int rt = root[r];
      labels[g] = base + (y0 + rt / kTileW) * W + x0 + rt % kTileW;
      size[g] = rt == l ? cnt[l] : 0;
    }
  }
}

// 2. A thread an edge across tiles: the tiles' top rows (y a multiple of
// kTileH, y > 0) against the row above, then their left columns (x a
// multiple of kTileW, x > 0) against the column on the left.
//  - a top-row edge (i, i-W) at x not a tile's left column is implied
//    where i ~ i-1 and i-W ~ i-1-W (both inside a tile) and i-1 ~ i-1-W
//    (the edge at x-1, united or implied in turn: by induction from the
//    tile's left column, whose edges are never skipped);
//  - a left-column edge (i, i-1) at y not a tile's top row is implied
//    where i ~ i-W and i-1 ~ i-1-W (inside the tiles) and i-W ~ i-1-W
//    (the edge at y-1, by induction from the tile's top row).
// The corner pixel's two edges are never skipped, so no pair of skips
// leans on each other.
template <typename T>
__global__ void __launch_bounds__(kThreads) border_kernel(
    const T* __restrict__ d, const uint8_t* __restrict__ valid, int* L,
    int frames, int H, int W, int tiles_x, int tiles_y, int max_diff) {
  const int across = (tiles_y - 1) * W, per = across + (tiles_x - 1) * H;
  int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= frames * per) return;
  const int f = e / per;
  e -= f * per;
  const int base = f * H * W;
  int i, j;
  if (e < across) {
    const int y = (e / W + 1) * kTileH, x = e % W;
    i = base + y * W + x;
    j = i - W;
    if (!joined(d, valid, i, j, max_diff)) return;
    if (x % kTileW != 0 && joined(d, valid, i, i - 1, max_diff) &&
        joined(d, valid, i - 1, i - 1 - W, max_diff) &&
        joined(d, valid, j, j - 1, max_diff))
      return;
  } else {
    e -= across;
    const int x = (e / H + 1) * kTileW, y = e % H;
    i = base + y * W + x;
    j = i - 1;
    if (!joined(d, valid, i, j, max_diff)) return;
    if (y % kTileH != 0 && joined(d, valid, i, i - W, max_diff) &&
        joined(d, valid, j, j - W, max_diff) &&
        joined(d, valid, i - W, j - W, max_diff))
      return;
  }
  unite(L, i, j);
}

// 3. One block a tile: the tile-local roots find their components' roots
// and add their counts there; then every pixel's label = its root.
__global__ void __launch_bounds__(kTileWarps * 32) roots_kernel(
    int* L, int* size, int H, int W, int tiles_x, int tiles_y) {
  __shared__ int root[kTilePixels];   // a tile-local root's root, or -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile t = tile_of_block(H, W, tiles_x, tiles_y);
  const int x0 = t.x0, y0 = t.y0, base = t.base, x = x0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, y = y0 + ly, g = base + y * W + x;
    int rt = -1;
    if (x < W && y < H) {
      const int s = size[g];
      if (s > 0) {
        rt = find<false>(L, g);
        if (rt != g) atomicAdd(size + rt, s);
      }
    }
    root[ly * kTileW + lane] = rt;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = warp + r * kTileWarps, y = y0 + ly, g = base + y * W + x;
    if (x < W && y < H) {
      int rt = root[ly * kTileW + lane];
      if (rt < 0) {
        const int p = L[g] - base, py = p / W - y0, px = p % W - x0;
        if (py >= 0 && py < kTileH && px >= 0 && px < kTileW)
          rt = root[py * kTileW + px];
        if (rt < 0) rt = find<false>(L, g);
      }
      L[g] = rt;
    }
  }
}

__global__ void __launch_bounds__(kThreads) keep_kernel(
    const int* __restrict__ L, const int* __restrict__ size,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int total,
    int window) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < total) keep[i] = valid[i] && size[L[i]] > window;
}

template <typename T>
int launch(const T* d, const uint8_t* valid, int* labels, int* size,
           uint8_t* keep, int frames, int H, int W, int max_diff, int window,
           cudaStream_t st) {
  const int total = frames * H * W;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long edges =
      (long long)frames * ((tiles_y - 1) * W + (tiles_x - 1) * H);
  const int blocks = (total + kThreads - 1) / kThreads;
  tile_kernel<T><<<frames * tiles_x * tiles_y, kTileWarps * 32, 0, st>>>(
      d, valid, labels, size, H, W, tiles_x, tiles_y, max_diff);
  if (edges > 0)
    border_kernel<T><<<(int)((edges + kThreads - 1) / kThreads), kThreads, 0,
                       st>>>(d, valid, labels, frames, H, W, tiles_x, tiles_y,
                             max_diff);
  roots_kernel<<<frames * tiles_x * tiles_y, kTileWarps * 32, 0, st>>>(
      labels, size, H, W, tiles_x, tiles_y);
  keep_kernel<<<blocks, kThreads, 0, st>>>(labels, size, valid, keep, total,
                                           window);
  return (int)cudaGetLastError();
}

}  // namespace

// disp (frames, H, W) int16, or int32 where d_is_int32; valid and keep
// (frames, H, W) bytes 0/1; labels and size (frames, H, W) int32, size
// scratch (written here). frames * H * W plus a block must fit in an
// int32.
extern "C" int ovo_speckle_keep(const void* disp, int d_is_int32,
                                const uint8_t* valid, int* labels, int* size,
                                uint8_t* keep, int frames, int H, int W,
                                int max_diff, int window, void* stream) {
  if (frames < 0 || H <= 0 || W <= 0 ||
      (long long)frames * H * W > INT_MAX - kThreads)
    return (int)cudaErrorInvalidValue;
  if (frames == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d_is_int32)
    return launch((const int32_t*)disp, valid, labels, size, keep, frames, H,
                  W, max_diff, window, st);
  return launch((const int16_t*)disp, valid, labels, size, keep, frames, H,
                W, max_diff, window, st);
}
