// H9: ORB's per-pixel detection stages over the pyramid stack in one
// launch, bound with ctypes (openvo_tpu_torch/ops/orb_cuda.py holds the
// wrapper and builds the tables; the plain version is
// ops/orb.corner_keys_plain).
//
//   H9 corner_keys <- the FAST score and corner test, the 3x3 NMS, the
//   border and mask tests and the Harris response, which the JAX package
//   leaves to XLA inside its jitted ORB (openvo_tpu/ops/orb.py:434-445;
//   fast_score :117, _nms3x3 :210, harris_response :154)
//
// Per canvas pixel of level l (its (h_l, w_l) in the top-left of the
// (H, W) canvas, zero beyond):
//   key  = the Harris response where the pixel is a corner, else -inf;
//   fkey = its FAST score there, else -inf (cv2.ORB's ranking only).
// A corner: FAST score > threshold, score >= its 3x3 maximum, edge <= x <
// w_l - edge and edge <= y < h_l - edge, and (with a mask) the level-0
// mask at (rows[l][y], cols[l][x]) nonzero, -1 meaning outside the level.
//
// Work: a corner lies in its level's border box (cut to the canvas), and
// only there does a key need more than -inf. The wrapper lists, once per
// frame size, levels and edge, the 32x64 tiles that cover each box from
// its top-left corner (ragged at its far edges) and the spans of the
// canvas outside the boxes (csrc/spans.cuh). The grid is one block a tile
// of a frame: no block is idle. A tile block:
//   1. loads the tile and a 4-pixel halo (40x72) of the canvas into shared
//      memory by cp.async (4 bytes a copy: a row of the stack is not
//      16-byte aligned in general, W = 1242 on KITTI);
//   2. runs FAST's pretest (below) on the tile and the 1-pixel ring the
//      NMS reads, holding -inf where it fails, and lists where it passes
//      (a ballot and one shared atomic a warp);
//   3. scores the listed pixels: the 16 differences and the arc folds of
//      the polarities that passed;
//   4. per tile pixel: the threshold and the NMS; -inf is written at once
//      where they fail, and the rest is listed;
//   5. tests the mask at the listed pixels, all at once (the tables', then
//      the mask's reads wait once a tile, not once a warp's pass);
//   6. per corner, 8 lanes: lane j < 7 adds the Sobel products of window
//      row j left to right from the first tap, lane 0 adds the 7 rows top
//      to bottom (shuffles), computes Harris and writes key (and fkey);
// then its warps write the block's share of the spans, -inf with 16-byte
// stores. A tile whose halo stays inside the canvas (every tile at ORB's
// edge of 31) reads shared memory at fixed offsets; one that reaches past
// it clamps, reflects and tests each read (corner_tile<true>).
//
// FAST's pretest is exact. An arc of 9 contiguous circle pixels (of 16)
// always holds two adjacent ones of the 4 cardinal pixels (circle indices
// 0, 4, 8, 12: 9 consecutive indices hold two consecutive multiples of 4).
// A bright arc scores > threshold only if each of its 9 pixels has
// __fsub_rn(n, v) > threshold, a dark one only if each has
// __fsub_rn(v, n) > threshold. So where no two adjacent cardinals are both
// bright (both dark) by that test, read with the same replicate clamping
// at the canvas's edge as the circle, the bright (dark) arc score is <=
// threshold. A pixel that fails for both polarities scores <= threshold:
// it is no corner, and since a corner's own score is > threshold it
// cannot change a corner's NMS test either; its score is held as -inf.
// Where one polarity fails, the other's arc score stands for the score:
// the two agree wherever either is > threshold, and elsewhere the value
// again decides nothing. fkey is written only at corners, where the
// score is exact. tests/test_torch_orb.py checks this on the plain
// functions.
//
// The paddings are those of the plain version, all at the canvas's edge,
// not the level's: replicate for FAST, reflect-101 for Sobel, zero for the
// box sums, -inf for the NMS.
//
// Bound: bytes. It must read each level's border box and its 4-pixel halo
// of the stack (4.27 MB on a KITTI frame) and the mask where a corner
// tests it, and write key (and fkey) once over the whole canvas (14.94 MB
// each); the pretest leaves 2-19% of a level's pixels to FAST's arcs on
// the bench's frames, and Harris runs at the ~1.6% that are corners. What
// holds it above the bound is the instructions a tile issues between its
// barriers (48 registers: 5 blocks an SM).
//
// Bit-exactness with the plain version (torch on the CPU, which rounds
// every product and sum on its own, and ops/image.fma where XLA fuses a
// multiply-add): every product and sum is an intrinsic, which nvcc never
// contracts into an FMA, and the sums run in the plain version's order.
// emu_fma(a, b, c) is the float64 product plus the float64 c, rounded
// once to float32, as ops/image.fma (not fmaf).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "spans.cuh"

namespace {

#ifdef OVO_SERIAL
constexpr int kThreads = 1;
#else
constexpr int kThreads = 256;
#endif
constexpr int kWarps = kThreads >= 32 ? kThreads / 32 : 1;
constexpr int kLanes = kThreads >= 32 ? 32 : kThreads;
constexpr int kTileH = 32, kTileW = 64;  // orb_cuda.CORNER_TILE
constexpr int kHalo = 4;                 // FAST's 3 + the NMS's 1
constexpr int kInH = kTileH + 2 * kHalo, kInW = kTileW + 2 * kHalo;
constexpr int kInStride = kInW + 1;
constexpr int kScH = kTileH + 2, kScW = kTileW + 2;  // scores, for the NMS
constexpr int kBox = 7;
constexpr int kGroup = 8;      // lanes a corner in Harris (7 rows)
constexpr int kTileInts = 5;   // a tile: {level, y0, y1, x0, x1}
constexpr int kBright = 1 << 14, kDark = 1 << 15;
constexpr uint16_t kStruck = 0xffff;   // a listed corner the mask refuses
constexpr unsigned kFull = 0xffffffffu;
static_assert(kScH * kScW < kBright, "a pretest entry: 14 bits of index");
static_assert(kTileH * kTileW < kStruck, "a corner entry: 16 bits");

// FAST's circle of radius 3, (dx, dy) in circular order (orb.FAST_CIRCLE):
// dx = 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1 and
// dy(q) = -dx(q + 4)
__host__ __device__ constexpr int circle_dx(int q) {
  return q <= 3 ? q : (q <= 5 ? 3 : (q <= 11 ? 8 - q : (q <= 13 ? -3
                                                                 : q - 16)));
}
__host__ __device__ constexpr int circle_dy(int q) {
  return -circle_dx((q + 4) & 15);
}

struct TileSmem {
  float img[kInH][kInStride];        // the canvas from (y0 - 4, x0 - 4)
  float score[kScH][kScW];           // from (y0 - 1, x0 - 1)
  uint16_t pass[kScH * kScW];        // pretest passes: index | polarities
  uint16_t corners[kTileH * kTileW]; // r * kTileW + c
  int npass, ncorners;
};

struct Prod {
  float xx, yy, xy;
};

__device__ __forceinline__ float emu_fma(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// reflect-101 of v into [0, n), n >= 2, |v - clamp(v)| <= 1
__device__ __forceinline__ int reflect101(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

// The arc score of orb.fast_score: the max over the 16 starts of the min
// over 9 contiguous circle pixels, folded as the plain version folds it.
__device__ __forceinline__ float arc_score(const float (&m)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(m[k], m[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = fminf(m4[k], m4[(k + 4) & 15]);
  float out = fminf(m8[0], m[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) out = fmaxf(out, fminf(m8[k], m[(k + 8) & 15]));
  return out;
}

// Sobel's two 3-tap sums in the plain version's order, (a + 2b) + c
__device__ __forceinline__ float tri(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, __fmul_rn(2.f, b)), c);
}

__device__ __forceinline__ void add_to(Prod& a, const Prod& b) {
  a.xx = __fadd_rn(a.xx, b.xx);
  a.yy = __fadd_rn(a.yy, b.yy);
  a.xy = __fadd_rn(a.xy, b.xy);
}

// Sobel at canvas pixel (y, x) with reflect-101 at the canvas's edge,
// dx = ((a + 2b) + c) - ((d + 2e) + f) over the right and left columns,
// dy the same over the lower and upper rows, and the three products
// rounded; 0 outside the canvas (the box sum's zero padding). img holds
// the canvas from (oy, ox).
__device__ __forceinline__ Prod sobel_products(const TileSmem& s, int H,
                                               int W, int oy, int ox, int y,
                                               int x) {
  Prod p{0.f, 0.f, 0.f};
  if (y < 0 || y >= H || x < 0 || x >= W) return p;
  const int ym = reflect101(y - 1, H) - oy, yc = y - oy,
            yp = reflect101(y + 1, H) - oy;
  const int xm = reflect101(x - 1, W) - ox, xc = x - ox,
            xp = reflect101(x + 1, W) - ox;
  const float dx = __fsub_rn(tri(s.img[ym][xp], s.img[yc][xp], s.img[yp][xp]),
                             tri(s.img[ym][xm], s.img[yc][xm], s.img[yp][xm]));
  const float dy = __fsub_rn(tri(s.img[yp][xm], s.img[yp][xc], s.img[yp][xp]),
                             tri(s.img[ym][xm], s.img[ym][xc], s.img[ym][xp]));
  p.xx = __fmul_rn(dx, dx);
  p.yy = __fmul_rn(dy, dy);
  p.xy = __fmul_rn(dx, dy);
  return p;
}

// A row of the 7x7 box at canvas row y around column x: the products at
// x - 3 .. x + 3 added left to right from the first. kEdge: the window
// may reach the canvas's edge (reflect-101, zeros beyond); else rows
// y - 1 .. y + 1 and columns x - 4 .. x + 4 lie inside it, and the nine
// columns are read once.
template <bool kEdge>
__device__ __forceinline__ Prod box_row(const TileSmem& s, int H, int W,
                                        int oy, int ox, int y, int x) {
  if (kEdge) {
    Prod a = sobel_products(s, H, W, oy, ox, y, x - 3);
#pragma unroll
    for (int k = 1; k < kBox; ++k)
      add_to(a, sobel_products(s, H, W, oy, ox, y, x - 3 + k));
    return a;
  }
  const float* up = &s.img[y - 1 - oy][x - 4 - ox];
  float u[9], m[9], d[9], v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    u[k] = up[k];
    m[k] = up[kInStride + k];
    d[k] = up[2 * kInStride + k];
    v[k] = tri(u[k], m[k], d[k]);   // a column's (a + 2b) + c
  }
  Prod a{0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kBox; ++k) {
    const float dx = __fsub_rn(v[k + 2], v[k]);
    const float dy = __fsub_rn(tri(d[k], d[k + 1], d[k + 2]),
                               tri(u[k], u[k + 1], u[k + 2]));
    const Prod p{__fmul_rn(dx, dx), __fmul_rn(dy, dy), __fmul_rn(dx, dy)};
    if (k == 0)
      a = p;
    else
      add_to(a, p);
  }
  return a;
}

// det = fma(sxx, syy, -(sxy * sxy)), tr = sxx + syy,
// resp = fma(-(0.04 * tr), tr, det)
__device__ __forceinline__ float harris(const Prod& b) {
  const float det = emu_fma(b.xx, b.yy, -__fmul_rn(b.xy, b.xy));
  const float tr = __fadd_rn(b.xx, b.yy);
  const float ktr = __fmul_rn(0.04f, tr);
  return emu_fma(-ktr, tr, det);
}

// The tile [y0, y1) x [x0, x1) of one level's plane: src the stack's
// plane, kout/fout the keys' (fout NULL without cv2's ranking), m0 the
// frame's level-0 mask and rows/cols the level's rows of the mask tables
// (all three NULL without a mask). kEdge: the tile's 4-pixel halo reaches
// past the canvas, so reads clamp, reflect and test; else (every tile of
// ORB's default edge of 31) they read the shared tile at fixed offsets.
template <bool kEdge>
__device__ void corner_tile(TileSmem& s, const float* __restrict__ src,
                            int H, int W, int y0, int y1, int x0, int x1,
                            const uint8_t* __restrict__ m0,
                            const int* __restrict__ rows,
                            const int* __restrict__ cols, float thr,
                            float* __restrict__ kout,
                            float* __restrict__ fout) {
  const int t = threadIdx.x, warp = t / kLanes, lane = t % kLanes;
  const float neg_inf = -INFINITY;
  const int oy = y0 - kHalo, ox = x0 - kHalo;

  // 1. the canvas around the tile (what lies outside it is never read)
  const int ly0 = max(oy, 0), ly1 = min(y1 + kHalo, H);
  const int lx0 = max(ox, 0), lx1 = min(x1 + kHalo, W);
  for (int y = ly0 + warp; y < ly1; y += kWarps)
    for (int x = lx0 + lane; x < lx1; x += kLanes)
      copy_async(&s.img[y - oy][x - ox], src + (size_t)y * W + x);
  if (t == 0) {
    s.npass = 0;
    s.ncorners = 0;
  }
  wait_async();
  __syncthreads();

  // 2. the pretest on rows y0 - 1 .. y1, columns x0 - 1 .. x1: adjacent
  // cardinals both bright or both dark; -inf outside the canvas (the
  // NMS's padding) and where neither polarity passes
  const int sh = y1 - y0 + 2, sw = x1 - x0 + 2;
  for (int i0 = 0; i0 < kScH * kScW; i0 += kThreads) {
    const int i = i0 + t, r = i / kScW, c = i - r * kScW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    int code = 0;
    if (r < sh && c < sw) {
      if (!kEdge || (y >= 0 && y < H && x >= 0 && x < W)) {
        const float* p = &s.img[r + 3][c + 3];   // (y, x)
        const float v = *p;
        const float n0 = kEdge ? s.img[clampi(y - 3, 0, H - 1) - oy][c + 3]
                               : p[-3 * kInStride];
        const float n4 = kEdge ? s.img[r + 3][clampi(x + 3, 0, W - 1) - ox]
                               : p[3];
        const float n8 = kEdge ? s.img[clampi(y + 3, 0, H - 1) - oy][c + 3]
                               : p[3 * kInStride];
        const float n12 = kEdge ? s.img[r + 3][clampi(x - 3, 0, W - 1) - ox]
                                : p[-3];
        const bool b0 = __fsub_rn(n0, v) > thr, b4 = __fsub_rn(n4, v) > thr,
                   b8 = __fsub_rn(n8, v) > thr, b12 = __fsub_rn(n12, v) > thr;
        const bool d0 = __fsub_rn(v, n0) > thr, d4 = __fsub_rn(v, n4) > thr,
                   d8 = __fsub_rn(v, n8) > thr, d12 = __fsub_rn(v, n12) > thr;
        if ((b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0))
          code |= kBright;
        if ((d0 && d4) || (d4 && d8) || (d8 && d12) || (d12 && d0))
          code |= kDark;
      }
      s.score[r][c] = neg_inf;
    }
    append(s.pass, &s.npass, code != 0, (uint16_t)(code | i));
  }
  __syncthreads();

  // 3. the arc scores of the polarities that passed
  const int npass = s.npass;
  for (int k = t; k < npass; k += kThreads) {
    const int code = s.pass[k], i = code & (kBright - 1);
    const int r = i / kScW, c = i - r * kScW;
    const float* p = &s.img[r + 3][c + 3];
    const float v = *p;
    float n[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      n[q] = kEdge
                 ? s.img[clampi(y0 - 1 + r + circle_dy(q), 0, H - 1) - oy]
                        [clampi(x0 - 1 + c + circle_dx(q), 0, W - 1) - ox]
                 : p[circle_dy(q) * kInStride + circle_dx(q)];
    float sb = neg_inf, sd = neg_inf;
    if (code & kBright) {
      float m[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) m[q] = __fsub_rn(n[q], v);
      sb = arc_score(m);
    }
    if (code & kDark) {
      float m[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) m[q] = __fsub_rn(v, n[q]);
      sd = arc_score(m);
    }
    s.score[r][c] = fmaxf(sb, sd);
  }
  __syncthreads();

  // 4. the NMS and the tests; -inf where they fail, the corners listed
  const int th = y1 - y0, tw = x1 - x0;
  for (int i0 = 0; i0 < kTileH * kTileW; i0 += kThreads) {
    const int i = i0 + t, r = i / kTileW, c = i % kTileW;
    bool corner = false;
    if (r < th && c < tw) {
      const int y = y0 + r, x = x0 + c;
      const float sc = s.score[r + 1][c + 1];
      corner = sc > thr;
      if (corner) {
        float mx = sc;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            mx = fmaxf(mx, s.score[r + dy][c + dx]);
        corner = sc >= mx;
      }
      if (!corner) {
        kout[(size_t)y * W + x] = neg_inf;
        if (fout != nullptr) fout[(size_t)y * W + x] = neg_inf;
      }
    }
    append(s.corners, &s.ncorners, corner, (uint16_t)i);
  }
  __syncthreads();

  // 5. the mask test of the listed corners, all at once (its two
  // dependent reads, the tables then the mask, wait once a tile); -inf
  // and struck from the list where it fails
  const int nc = s.ncorners;
  if (m0 != nullptr) {
    for (int k = t; k < nc; k += kThreads) {
      const int r = s.corners[k] / kTileW, c = s.corners[k] % kTileW;
      const int y = y0 + r, x = x0 + c;
      const int yi = rows[y], xi = cols[x];
      if (yi < 0 || xi < 0 || m0[(size_t)yi * W + xi] == 0) {
        kout[(size_t)y * W + x] = neg_inf;
        if (fout != nullptr) fout[(size_t)y * W + x] = neg_inf;
        s.corners[k] = kStruck;
      }
    }
    __syncthreads();
  }

  // 6. Harris at the corners
#ifdef OVO_SERIAL
  for (int k = 0; k < nc; ++k) {
    if (s.corners[k] == kStruck) continue;
    const int r = s.corners[k] / kTileW, c = s.corners[k] % kTileW;
    const int y = y0 + r, x = x0 + c;
    Prod b = box_row<kEdge>(s, H, W, oy, ox, y - 3, x);
    for (int j = 1; j < kBox; ++j)
      add_to(b, box_row<kEdge>(s, H, W, oy, ox, y - 3 + j, x));
    kout[(size_t)y * W + x] = harris(b);
    if (fout != nullptr) fout[(size_t)y * W + x] = s.score[r + 1][c + 1];
  }
#else
  constexpr int kGroups = kThreads / kGroup;
  const int g = t / kGroup, j = t % kGroup, lead = lane & ~(kGroup - 1);
  for (int base = 0; base < nc; base += kGroups) {
    const int k = base + g;
    const bool on = k < nc && s.corners[k] != kStruck;
    int r = 0, c = 0;
    Prod row{0.f, 0.f, 0.f};
    if (on) {
      r = s.corners[k] / kTileW;
      c = s.corners[k] % kTileW;
      if (j < kBox)
        row = box_row<kEdge>(s, H, W, oy, ox, y0 + r - 3 + j, x0 + c);
    }
    Prod b{__shfl_sync(kFull, row.xx, lead), __shfl_sync(kFull, row.yy, lead),
           __shfl_sync(kFull, row.xy, lead)};
#pragma unroll
    for (int q = 1; q < kBox; ++q)
      add_to(b, Prod{__shfl_sync(kFull, row.xx, lead + q),
                     __shfl_sync(kFull, row.yy, lead + q),
                     __shfl_sync(kFull, row.xy, lead + q)});
    if (on && j == 0) {
      const size_t at = (size_t)(y0 + r) * W + x0 + c;
      kout[at] = harris(b);
      if (fout != nullptr) fout[at] = s.score[r + 1][c + 1];
    }
  }
#endif
}

// Tile b of frame f: its level's plane and the tile's edge test.
__device__ __forceinline__ void corner_block(
    TileSmem& s, const float* __restrict__ stack, int H, int W, int nl,
    const int* __restrict__ tl, int f, const uint8_t* __restrict__ mask,
    const int* __restrict__ rows, const int* __restrict__ cols,
    float threshold, float* __restrict__ key, float* __restrict__ fkey) {
  const int l = tl[0], y0 = tl[1], y1 = tl[2], x0 = tl[3], x1 = tl[4];
  const size_t plane = (size_t)H * W, off = (f * (size_t)nl + l) * plane;
  const float* src = stack + off;
  const uint8_t* m0 = mask == nullptr ? nullptr : mask + f * plane;
  const int* rl = rows == nullptr ? nullptr : rows + (size_t)l * H;
  const int* cl = cols == nullptr ? nullptr : cols + (size_t)l * W;
  float* fout = fkey == nullptr ? nullptr : fkey + off;
  if (y0 < kHalo || x0 < kHalo || y1 + kHalo > H || x1 + kHalo > W)
    corner_tile<true>(s, src, H, W, y0, y1, x0, x1, m0, rl, cl, threshold,
                      key + off, fout);
  else
    corner_tile<false>(s, src, H, W, y0, y1, x0, x1, m0, rl, cl, threshold,
                       key + off, fout);
}

__global__ void __launch_bounds__(kThreads) corner_keys_kernel(
    const float* __restrict__ stack, int H, int W, int nl,
    const int* __restrict__ tiles, int ntiles, const int* __restrict__ spans,
    int nspans, const uint8_t* __restrict__ mask,
    const int* __restrict__ rows, const int* __restrict__ cols,
    float threshold, float* __restrict__ key, float* __restrict__ fkey) {
  __shared__ TileSmem s;
  const size_t frame = (size_t)H * W * nl;
  const int blocks = frame_blocks(ntiles, nspans, kWarps);
  const int f = blockIdx.x / blocks, b = blockIdx.x % blocks;
  if (b < ntiles)
    corner_block(s, stack, H, W, nl, tiles + (size_t)b * kTileInts, f, mask,
                 rows, cols, threshold, key, fkey);
  // then this block's spans outside every level's border box: -inf, a
  // warp each
  const int item = b + blocks * (threadIdx.x / kLanes);
  if (item < nspans) {
    const int* sp = spans + (size_t)item * kSpanInts;
    write_span(sp, key + f * frame,
               fkey == nullptr ? nullptr : fkey + f * frame, nullptr, W,
               -INFINITY, threadIdx.x % kLanes, kLanes);
  }
}

}  // namespace

// stack (frames, nl, H, W); tiles (ntiles, 5) and spans (nspans, 4), a
// frame's (orb_cuda.corner_tables); mask (frames, H, W) bytes, rows (nl,
// H) and cols (nl, W), all three NULL or none; key and fkey (frames, nl,
// H, W), fkey NULL unless wanted.
extern "C" int ovo_corner_keys(const float* stack, int H, int W, int nl,
                               const int* tiles, int ntiles,
                               const int* spans, int nspans,
                               const uint8_t* mask, const int* rows,
                               const int* cols, float threshold, float* key,
                               float* fkey, int frames, void* stream) {
  if (nl <= 0 || H < 2 || W < 2 || frames <= 0 || ntiles < 0 ||
      nspans < 0 || (mask == nullptr) != (rows == nullptr) ||
      (mask == nullptr) != (cols == nullptr) ||
      (fkey != nullptr &&
       ((reinterpret_cast<uintptr_t>(key) ^ reinterpret_cast<uintptr_t>(fkey)) &
        15) != 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)frames * frame_blocks(ntiles, nspans, kWarps);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  corner_keys_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      stack, H, W, nl, tiles, ntiles, spans, nspans, mask, rows, cols,
      threshold, key, fkey);
  return (int)cudaGetLastError();
}
