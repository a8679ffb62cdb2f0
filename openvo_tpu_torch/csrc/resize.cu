// H6: ORB's pyramid stack in one launch: level 0 the image, levels 1.. the
// two contractions of each level's antialiased linear resize
// (jax.image.resize) in one fixed order, that of the plain version
// ops/image.resize_levels_plain, and zeros beyond each level:
//
//   mid(i, c) = the chain over the row taps t = 0 .. rn[i]-1 of
//               fma(rw[i][t], img[r0[i] + t][c], acc), from acc = 0;
//   out(i, j) = the chain over the column taps t = 0 .. cn[j]-1 of
//               fma(cw[j][t], mid(i, c0[j] + t), acc), from acc = 0.
//
// The rows' chain is XLA:CPU's order for its first product; both chains
// round once per step (fmaf), so the card gives the plain version's bits.
//
// Work: the wrapper (ops/orb_cuda.level_tables) lists, once per frame size
// and levels, the output tiles of every level after the first (16 rows x
// 64 columns, narrower, then shorter, where the image rows and columns a
// tile reads would not fit shared memory) and the spans of the stack that
// no tile writes: level 0, copied from the image, and the canvas beyond
// each level, zero (csrc/spans.cuh). The grid is one block a tile of a
// frame; after its tile a block writes its share of the spans (a warp a
// span, 16-byte stores), so that the launch writes every byte of the stack
// once, with no memset or copy beside it. A tile block:
//   1. copies the image rows and columns that its taps read into shared
//      memory (cp.async), and its rows' and columns' tap tables (where a
//      level's taps fit: 16 a side, scale factors to ~7.5; the columns'
//      tap by tap, so that a warp's lanes read neighbouring banks);
//   2. computes mid(i, c) once for each of its output rows and each of
//      those columns, into shared memory (a warp a row);
//   3. runs each output pixel's column chain from shared memory and writes
//      it (a warp a row).
// So a pixel costs rn + cn multiply-adds where it cost rn x cn, and the
// image is read from L2 once a tile, not once a tap.
//
// Bound: bytes. It must read the image once and write the stack once
// (1.87 + 14.94 MB on a KITTI frame of 8 levels); the multiply-adds (~9 M
// a frame) cost a small part of that at 67 TFLOP/s. What holds it above
// the bound is each tile's chain of waits (its table and image reads, two
// barriers) against 6 blocks an SM.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "spans.cuh"

namespace {

#ifdef OVO_SERIAL
constexpr int kThreads = 1;
#else
constexpr int kThreads = 256;
#endif
constexpr int kWarps = kThreads >= 32 ? kThreads / 32 : 1;
constexpr int kLanes = kThreads >= 32 ? 32 : kThreads;
// a tile's most rows and columns, the most image floats and mid values it
// holds, and the most taps its shared tables take (orb_cuda.RESIZE_TILE,
// RESIZE_IN, RESIZE_MID)
constexpr int kTileRows = 16, kTileCols = 64;
constexpr int kInFloats = 4096, kMidFloats = 2048;
constexpr int kMaxTaps = 16;
// blocks an SM holds: shared memory allows 7, registers (<= 40) 6
constexpr int kBlocksPerSM = 6;
// a tile: {level, i0, i1, j0, j1, c_lo, c_hi, r_lo, r_hi, row0, col0}:
// output rows [i0, i1) and columns [j0, j1) of the level, the level-0
// columns [c_lo, c_hi) and rows [r_lo, r_hi) that their taps read, and
// the level's first row and column in the concatenated tap tables
constexpr int kTileInts = 11;

struct TileSmem {
  float in[kInFloats];    // the image's rows [r_lo, r_hi), cols [c_lo, c_hi)
  float mid[kMidFloats];  // the tile's rows, cols [c_lo, c_hi)
  float rw[kTileRows * kMaxTaps];  // a row's taps together
  float cw[kMaxTaps * kTileCols];  // tap q of the tile's columns together
  int r0[kTileRows], rn[kTileRows], c0[kTileCols], cn[kTileCols];
};

__device__ void resize_tile(TileSmem& s, const float* __restrict__ img,
                            int W, const int* __restrict__ tile,
                            const int* __restrict__ r0,
                            const int* __restrict__ rn,
                            const float* __restrict__ rw,
                            const int* __restrict__ c0,
                            const int* __restrict__ cn,
                            const float* __restrict__ cw, int taps,
                            float* __restrict__ out) {
  const int t = threadIdx.x, warp = t / kLanes, lane = t % kLanes;
  const int i0 = tile[1], i1 = tile[2], j0 = tile[3], j1 = tile[4];
  const int c_lo = tile[5], span = tile[6] - c_lo;
  const int r_lo = tile[7], r_hi = tile[8];
  const int ri = tile[9] + i0, cj = tile[10] + j0;
  const int nr = i1 - i0, nc = j1 - j0;
  const bool local = taps <= kMaxTaps;

  // 1. the image's rows and columns that the tile reads (cp.async), and
  // the tap tables
  for (int y = r_lo + warp; y < r_hi; y += kWarps)
    for (int c = lane; c < span; c += kLanes)
      copy_async(&s.in[(y - r_lo) * span + c], img + (size_t)y * W + c_lo + c);
  for (int k = t; k < nr; k += kThreads) {
    s.r0[k] = r0[ri + k] - r_lo;
    s.rn[k] = rn[ri + k];
  }
  for (int k = t; k < nc; k += kThreads) {
    s.c0[k] = c0[cj + k] - c_lo;
    s.cn[k] = cn[cj + k];
  }
  if (local) {
    for (int k = t; k < nr * taps; k += kThreads)
      s.rw[k] = rw[(size_t)ri * taps + k];
    for (int k = t; k < nc * taps; k += kThreads)
      s.cw[(k % taps) * kTileCols + k / taps] = cw[(size_t)cj * taps + k];
  }
  wait_async();
  __syncthreads();
  // tap q of column j at wc[q * cstep + j * jstep]
  const float* wr = local ? s.rw : rw + (size_t)ri * taps;
  const float* wc = local ? s.cw : cw + (size_t)cj * taps;
  const int cstep = local ? kTileCols : 1, jstep = local ? 1 : taps;

  // 2. mid over the tile's rows and the columns its taps read
  for (int r = warp; r < nr; r += kWarps) {
    const float* w = wr + r * taps;
    const float* in = s.in + s.r0[r] * span;
    const int count = s.rn[r];
    for (int c = lane; c < span; c += kLanes) {
      float acc = 0.f;
      for (int u = 0; u < count; ++u)
        acc = __fmaf_rn(w[u], in[u * span + c], acc);
      s.mid[r * span + c] = acc;
    }
  }
  __syncthreads();

  // 3. the column chains
  for (int r = warp; r < nr; r += kWarps) {
    const float* m = s.mid + r * span;
    float* o = out + (size_t)(i0 + r) * W + j0;
    for (int j = lane; j < nc; j += kLanes) {
      const float* w = wc + j * jstep;
      const int first = s.c0[j], count = s.cn[j];
      float acc = 0.f;
      for (int q = 0; q < count; ++q)
        acc = __fmaf_rn(w[q * cstep], m[first + q], acc);
      o[j] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) resize_levels_kernel(
    const float* __restrict__ img, int H, int W, int nl,
    const int* __restrict__ tiles, int ntiles, const int* __restrict__ spans,
    int nspans, const int* __restrict__ r0,
    const int* __restrict__ rn, const float* __restrict__ rw,
    const int* __restrict__ c0, const int* __restrict__ cn,
    const float* __restrict__ cw, int taps, float* __restrict__ stack) {
  __shared__ TileSmem s;
  const size_t plane = (size_t)H * W, frame = plane * nl;
  const int blocks = frame_blocks(ntiles, nspans, kWarps);
  const int f = blockIdx.x / blocks, b = blockIdx.x % blocks;
  if (b < ntiles) {
    const int* tl = tiles + (size_t)b * kTileInts;
    resize_tile(s, img + f * plane, W, tl, r0, rn, rw, c0, cn, cw, taps,
                stack + f * frame + tl[0] * plane);
  }
  // then this block's spans: level 0 and the zeros beyond each level, a
  // warp each
  const int item = b + blocks * (threadIdx.x / kLanes);
  if (item < nspans)
    write_span(spans + (size_t)item * kSpanInts, stack + f * frame, nullptr,
               img + f * plane, W, 0.f, threadIdx.x % kLanes, kLanes);
}

}  // namespace

// img (frames, H, W); tiles (ntiles, 9) and spans (nspans, 4), a frame's
// (orb_cuda.level_tables); the tap tables of every level after the first,
// concatenated: rows (r0, rn, rw) and columns (c0, cn, cw), `taps` weights
// an output; stack (frames, nl, H, W), every element written.
extern "C" int ovo_resize_levels(const float* img, int H, int W, int nl,
                                 const int* tiles, int ntiles,
                                 const int* spans, int nspans, const int* r0,
                                 const int* rn, const float* rw,
                                 const int* c0, const int* cn,
                                 const float* cw, int taps, float* stack,
                                 int frames, void* stream) {
  if (nl < 1 || frames <= 0 || H <= 0 || W <= 0 || taps <= 0 ||
      ntiles < 0 || nspans < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)frames * frame_blocks(ntiles, nspans, kWarps);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  resize_levels_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      img, H, W, nl, tiles, ntiles, spans, nspans, r0, rn, rw, c0,
      cn, cw, taps, stack);
  return (int)cudaGetLastError();
}
