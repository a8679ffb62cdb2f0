// Speckle labelling kernel for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/speckle_cuda.py holds the wrapper; the plain
// version is ops/sgbm.speckle_keep_plain).
//
//   H7 speckle_keep <- the speckle filter's labelling and sizing, a
//   lax.while_loop of row/column min-scans in the JAX package
//   (openvo_tpu/ops/sgbm.py:476-488), left to XLA
//
// 4-connected components of valid pixels whose disparities differ by at
// most max_diff (invalid pixels are singletons), labelled by union-find in
// the manner of Playne & Hawick, "A New Algorithm for Parallel
// Connected-Component Labelling on GPUs" (IEEE TPDS 2018), in five
// launches with no host read:
//   1. init, one warp a row: a pixel's parent is the first pixel of its
//      run (the horizontal segment of connected pixels it lies in), found
//      by a ballot of the run starts and a carry across the row's 32-pixel
//      chunks; size = 0. Every row is then a forest of depth 1;
//   2. merge, a thread a pixel: a pixel connected to its upper neighbour
//      unites their trees, unless its left neighbour's union already
//      implies it (left, upper-left and upper all connected);
//   3. compress: label = the root of the pixel's tree;
//   4. size: the warp's pixels of one label (__match_any_sync) add their
//      count at the root with one atomicAdd;
//   5. keep: valid & (size of the root > window).
// Every parent is a smaller flat index than its child (a run's start, or
// the smaller root of a union), so a component's root, and so every
// pixel's label, is the smallest flat index of the component: the plain
// version's label too. A batch is one flat index space (frame b's pixels
// at [b*H*W, (b+1)*H*W)) and no edge crosses a frame or wraps from a
// row's end to the next row's start.
//
// Concurrency: during the merge other threads link roots, so parents are
// read through volatile loads; a root is linked only by atomicMin on
// itself, and when that fails (another thread linked that root first) the
// union goes on from the root the other thread linked it under. The
// merge's find halves the paths it walks with plain stores: it writes only
// to nodes it saw with a parent (never a root) and only ancestors, so each
// store keeps every node in its tree. The compress step writes only each
// thread's own label. Parents only decrease, so find always ends.
// Bound: each pixel's disparity and valid byte read, its label and keep
// written (about 8 bytes a pixel: 3.7 MB, 1.1 us at 3.35 TB/s, on a
// 1242x376 frame); the atomics and pointer chases of the merge set the
// time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ bool joined(const T* d, const uint8_t* valid,
                                       int i, int j, int max_diff) {
  if (!valid[i] || !valid[j]) return false;
  const int a = (int)d[i], b = (int)d[j];
  return abs(a - b) <= max_diff;
}

__device__ __forceinline__ int parent(const int* L, int a) {
  return *(const volatile int*)(L + a);
}

// The root of a's tree. With `halve`, each node on the way is pointed at
// its grandparent (merge only: in the compress step a late store could
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

__device__ void unite(int* L, int a, int b) {
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

// One warp a row: parent = the row's index of the run's first pixel.
template <typename T>
__global__ void __launch_bounds__(kThreads) init_kernel(
    const T* __restrict__ d, const uint8_t* __restrict__ valid, int* L,
    int* size, int rows, int W, int max_diff) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int base = row * W;
  int start = 0;   // the run start carried from the chunks before
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane, i = base + x;
    const bool starts =
        x >= W || x == 0 || !joined(d, valid, i, i - 1, max_diff);
    const unsigned m = __ballot_sync(0xffffffffu, starts);
    const unsigned le = m & (0xffffffffu >> (31 - lane));
    if (x < W) {
      L[i] = base + (le ? x0 + 31 - __clz(le) : start);
      size[i] = 0;
    }
    if (m) start = x0 + 31 - __clz(m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const T* __restrict__ d, const uint8_t* __restrict__ valid, int* L,
    int total, int H, int W, int max_diff) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = i % W, y = (i / W) % H;
  if (y == 0 || !joined(d, valid, i, i - W, max_diff)) return;
  // i - 1 ~ i - 1 - W ~ i - W by its own union and the run above
  if (x > 0 && joined(d, valid, i, i - 1, max_diff) &&
      joined(d, valid, i - 1, i - 1 - W, max_diff) &&
      joined(d, valid, i - W, i - 1 - W, max_diff))
    return;
  unite(L, i, i - W);
}

__global__ void __launch_bounds__(kThreads) compress_kernel(int* L,
                                                            int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // only thread i writes L[i] here; the chains it reads are being
  // shortened to their roots by other threads, each value an ancestor
  L[i] = find<false>(L, i);
}

__global__ void __launch_bounds__(kThreads) size_kernel(
    const int* __restrict__ L, int* size, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int label = i < total ? L[i] : -1;   // every lane takes part
  const unsigned same = __match_any_sync(0xffffffffu, label);
  if (label >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(size + label, __popc(same));
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
  const int total = frames * H * W, rows = frames * H;
  const int blocks = (total + kThreads - 1) / kThreads;
  init_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                   st>>>(d, valid, labels, size, rows, W, max_diff);
  merge_kernel<T><<<blocks, kThreads, 0, st>>>(d, valid, labels, total, H, W,
                                               max_diff);
  compress_kernel<<<blocks, kThreads, 0, st>>>(labels, total);
  size_kernel<<<blocks, kThreads, 0, st>>>(labels, size, total);
  keep_kernel<<<blocks, kThreads, 0, st>>>(labels, size, valid, keep, total,
                                           window);
  return (int)cudaGetLastError();
}

}  // namespace

// disp (frames, H, W) int16, or int32 where d_is_int32; valid and keep
// (frames, H, W) bytes 0/1; labels and size (frames, H, W) int32, size
// scratch (zeroed here). frames * H * W plus a block must fit in an int32.
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
