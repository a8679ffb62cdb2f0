// SGBM volume kernels for Hopper (sm_90a), bound to Python with ctypes
// (openvo_tpu_torch/ops/sgbm_cuda.py holds the wrappers and the plain
// PyTorch versions these must match bit for bit). H3 is in sgbm_wta.cu and
// the parts both sources share in sgbm_common.cuh, so that the two build
// in parallel.
//
// Layout: volumes are (H, W, D) row-major with the disparity axis innermost.
//
// Two arithmetic paths (the traits X2 and F32 in sgbm_common.cuh), as the
// JAX package's CPU path computes them:
//   - X2, where an int16 sentinel exists: int16 C and int32 L on the x2 grid
//     (costs x2, penalties 2*P1 and 2*P2), exact in any order, except the
//     deliberate fresh-start rounding (fresh_start) that reproduces the JAX
//     package's float32 carry of 1e9;
//   - F32, without an int16 sentinel: float32 C and L on the x1 grid, every
//     operation in the JAX package's order (the carry starts at 1e9, which
//     gives its fresh-start rounding by itself), with __fadd_rn, __fsub_rn
//     and __fmul_rn so that nvcc contracts nothing into an FMA.
//
//   H1 cost_hsweep    <- sgbm_pallas.cost_sweep_fused (K1), with its
//                        band_halo variant (sgbm_pallas.py:240-247): a row
//                        tile with halo rows, edge rows clamped in cost
//                        space. Two kernels on one stream: bt_box (cost and
//                        box sum) then hwalk (the left-to-right scan)
//   H2 vsweep         <- sgbm_pallas.sweep_v (K2): one or three vertical
//                        directions, top-down and/or bottom-up, with its
//                        init_carry / return_carry (sgbm_pallas.py:478-557)
//   H5 hsweep         <- sgbm_pallas.sweep_h (K6), float32
//   H3 hsweep_wta_lr  <- sgbm_pallas.sweep_hw_wta (K3), and over float32
//                        costs sweep_h_wta (K7); + lr_lookup (K4) and the
//                        post-pass of sgbm_fused_tpu
//
// Three designs, and what bounds each on the H100 (times in PERF.md):
//
//   - Warp walks (H1's hwalk, H3). One warp walks one row, four rows a
//     block; lane l holds the VPL disparities d = VPL*l + k (VPL = D/32
//     rounded up to a power of two) in registers, idle slots (d >= D) at
//     "infinity". A step takes the neighbours d +- 1 from the lane's own
//     registers or one shuffle up and one down, and min L' from one
//     redux.sync (__reduce_min_sync, the hardware's warp reduction), so no
//     block barrier is on the walk. The loads leave the chain: hwalk and H3
//     over float32 C take their columns from a TMA ring in the warp's
//     shared memory (lane 0 fetches a chunk of columns of each volume with
//     one bulk copy and an mbarrier, chunks ahead; hwalk sends s1 back the
//     same way), H3 over int16 C loads them 8 columns ahead into registers
//     (vector loads as volatile PTX, which the compiler keeps where they
//     are issued): each the faster on the card (sgbm_common.cuh, Feed). A
//     chunk or a loop body of 8 columns has no branch, so one column's work
//     interleaves with the next one's. What bounds them is the step's
//     dependency chain times the W columns, plus the issue slots the
//     column's loads, stores and reductions take beside it: the 376 rows of
//     a KITTI frame give one warp to each SM quarter it reaches, so nothing
//     else hides that latency. H3 keeps the argmin's redux, the uniqueness
//     vote and the right-view ring (a register shift of packed keys) off
//     the chain of L, and the row's per-column results in the warp's shared
//     memory.
//   - H1's cost leaves the walk: bt_box computes C for tiles of 16 rows x 32
//     columns x 32 disparities in parallel over the card, each BT cost once
//     per (input row, column, disparity) of a tile from per-pixel rounded
//     values and envelopes computed once per tile, with the vertical and
//     horizontal box sums as sliding integer sums in shared memory. It is
//     bound by its arithmetic and shared-memory traffic; the walk then
//     reads C back, so H1 moves 8 bytes per volume element (C written and
//     read, s1 written) where a fused kernel would move 6.
//   - Block walks (H2, H5): one thread per disparity, one block per line,
//     one block barrier and a two-stage min per step. Bound by that walk
//     (latency), several times their byte floors; not redesigned yet.
//
// The band and the carry add no pass: a band reads its halo rows where the
// whole image reads its neighbours, and a carry is one (W, D) row read
// before the walk and one written at its end.

#include "sgbm_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// H1 bt_box: the Birchfield-Tomasi cost and its box sum
// ---------------------------------------------------------------------------

// Round to bfloat16 (nearest, ties to even) when kBf16, on the bits (every
// value here is finite). For two bfloat16 operands the float32 sum or
// difference rounds to bfloat16 exactly as a bfloat16 operation would (24
// >= 2 * 8 + 2 bits), which is what XLA and PyTorch compute.
template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if (!kBf16) return v;
  const unsigned u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// A sample (rounded) and its half-sample envelope [lo, hi] from its
// neighbours' values.
template <bool kBf16>
__device__ __forceinline__ void envelope(float v0, float vm, float vp,
                                         float& v, float& lo, float& hi) {
  v = rnd<kBf16>(v0);
  const float am = 0.5f * rnd<kBf16>(v + rnd<kBf16>(vm));
  const float ap = 0.5f * rnd<kBf16>(v + rnd<kBf16>(vp));
  lo = fminf(fminf(am, ap), v);
  hi = fmaxf(fmaxf(am, ap), v);
}

// The envelope of pixel x of an image row; the neighbours wrap around the
// row, as the JAX package's jnp.roll.
template <bool kBf16>
__device__ __forceinline__ void row_envelope(const float* __restrict__ row,
                                             int x, int W, float& v,
                                             float& lo, float& hi) {
  envelope<kBf16>(row[x], row[x == 0 ? W - 1 : x - 1],
                  row[x == W - 1 ? 0 : x + 1], v, lo, hi);
}

// BT cost x2, truncated, from the rounded samples and envelopes. The JAX
// package rounds each of the four differences to bfloat16; rounding is
// monotone and rounds 0 to 0, so rounding the min of the two maxima once
// gives the same value.
template <bool kBf16>
__device__ __forceinline__ int bt_from(float l, float llo, float lhi, float r,
                                       float rlo, float rhi) {
  const float cl = fmaxf(fmaxf(l - rhi, rlo - l), 0.0f);
  const float cr = fmaxf(fmaxf(r - lhi, llo - r), 0.0f);
  const float c2 = 2.0f * rnd<kBf16>(fminf(cl, cr));
  // trunc(c2) for 0 <= c2 < 2^23: the sum with 2^23, rounded toward zero
  return __float_as_int(__fadd_rz(c2, 8388608.0f)) - 0x4B000000;
}

// BT cost x2 at (x, d) of one image row, straight from the images: the
// half-sample neighbours at x +/- 1 wrap around the row, and a right-image
// column outside the image (for the pixel or a neighbour) gives the
// sentinel. bt_box takes it at the edge columns x = 0 and W - 1, where the
// wrap moves the right image's neighbours away from s +/- 1.
template <bool kBf16>
__device__ __forceinline__ int bt_cost2(const float* __restrict__ lrow,
                                        const float* __restrict__ rrow,
                                        int x, int d, int W, int m,
                                        int sentinel) {
  const int xm = x == 0 ? W - 1 : x - 1;
  const int xp = x == W - 1 ? 0 : x + 1;
  const int s0 = x - m - d, sm = xm - m - d, sp = xp - m - d;
  if (s0 < 0 || sm < 0 || sp < 0 || x - m > W - 1 || xm - m > W - 1 ||
      xp - m > W - 1)
    return sentinel;
  float l, llo, lhi, r, rlo, rhi;
  envelope<kBf16>(lrow[x], lrow[xm], lrow[xp], l, llo, lhi);
  envelope<kBf16>(rrow[s0], rrow[sm], rrow[sp], r, rlo, rhi);
  return bt_from<kBf16>(l, llo, lhi, r, rlo, rhi);
}

constexpr int kBoxRows = 16;      // output rows of a bt_box tile
constexpr int kBoxThreads = 256;  // 8 warps

// Shared memory of a bt_box tile of tx columns with box radius r: the left
// and right rows' samples and envelopes, and the int16 cost stage.
size_t box_smem(int r, int tx) {
  const size_t ny = kBoxRows + 2 * r, nx = tx + 2 * r, nr = nx + 31;
  return sizeof(float) * 3 * ny * (nx + nr) + sizeof(int16_t) * ny * nx * 32;
}

// H1, first kernel: C for output rows [i0, i0 + 16) x columns [x0, x0 + tx)
// x disparities [dc, dc + 32) of a block. Input row j of the tile is row
// row0 + i0 - r + j clamped to [clamp_lo, clamp_hi] (the image's edge rows
// for a whole image, the band's own rows, or the core's first / last row at
// a tile on the image's top / bottom edge: K1's band_halo); tile column xi
// is image column x0 - r + xi clamped to the image.
//   1. Each input row's rounded samples and envelopes, once per pixel: the
//      left image at the tile's columns, the right image at the columns s =
//      x - m - d the tile's (x, d) read.
//   2. A warp per tile column, a lane per disparity: the BT cost of every
//      input row, once each, into the int16 stage, with the vertical (2r+1)
//      box sums of the 16 output rows sliding along in place (exact).
//   3. A warp per output row: the horizontal (2r+1) box sums (sliding) to C.
template <bool kBf16>
__global__ void __launch_bounds__(kBoxThreads)
    bt_box_kernel(const float* __restrict__ lp, const float* __restrict__ rp,
                  int16_t* __restrict__ C, int W, int D, int m, int r,
                  int sentinel, int row0, int rows, int clamp_lo,
                  int clamp_hi, int tx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ny = kBoxRows + 2 * r, nx = tx + 2 * r, nr = nx + 31;
  const int x0 = blockIdx.x * tx, i0 = blockIdx.y * kBoxRows;
  const int dc = blockIdx.z * 32;
  float* lenv = reinterpret_cast<float*>(smem);  // [3][ny][nx]
  float* renv = lenv + 3 * ny * nx;              // [3][ny][nr]
  int16_t* st = reinterpret_cast<int16_t*>(renv + 3 * ny * nr);  // [ny][nx][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = dc + lane;
  auto in_row = [&](int j) {
    return min(max(row0 + i0 - r + j, clamp_lo), clamp_hi);
  };
  auto col = [&](int xi) { return min(max(x0 - r + xi, 0), W - 1); };
  // right window slot si is column s_base + si: column x0 - r + xi at
  // disparity dc + lane reads slot xi + 31 - lane
  const int s_base = x0 - r - m - dc - 31;
#pragma unroll 4
  for (int i = threadIdx.x; i < ny * nx; i += kBoxThreads) {
    const int j = i / nx;
    row_envelope<kBf16>(lp + (size_t)in_row(j) * W, col(i - j * nx), W,
                        lenv[i], lenv[ny * nx + i], lenv[2 * ny * nx + i]);
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < ny * nr; i += kBoxThreads) {
    const int j = i / nr, s = s_base + i - j * nr;
    float v = 0.0f, lo = 0.0f, hi = 0.0f;
    if (s >= 0 && s < W)
      row_envelope<kBf16>(rp + (size_t)in_row(j) * W, s, W, v, lo, hi);
    renv[i] = v;
    renv[ny * nr + i] = lo;
    renv[2 * ny * nr + i] = hi;
  }
  __syncthreads();
  const int jstride = nx * 32;
  for (int xi = warp; xi < nx; xi += kBoxThreads / 32) {
    const int x = col(xi);
    // an interior column's three right samples s - 1, s, s + 1 lie in the
    // image iff s >= 1 and x - m + 1 <= W - 1
    const bool inside = x - m - d >= 1 && x - m <= W - 2;
    const int si = xi + 31 - lane;
    // the cost of input row j, then the vertical box sum sliding with it:
    // after row j, row j - 2r (each thread reads and writes only its own
    // column and disparity) holds the sum of rows j - 2r .. j
    int16_t* cp = st + xi * 32 + lane;
    int s = 0;
    auto push = [&](int j, int c) {
      cp[j * jstride] = (int16_t)c;
      s += c;
      if (j >= 2 * r) {
        int16_t* out = cp + (j - 2 * r) * jstride;
        const int old = *out;
        *out = (int16_t)s;
        s -= old;
      }
    };
    if (x == 0 || x == W - 1) {  // the row's wrap moves the neighbours
      for (int j = 0; j < ny; ++j) {
        const size_t o = (size_t)in_row(j) * W;
        push(j, d < D ? bt_cost2<kBf16>(lp + o, rp + o, x, d, W, m, sentinel)
                      : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < ny; ++j) {
        const int li = j * nx + xi, ri = j * nr + si;
        const int c = bt_from<kBf16>(lenv[li], lenv[ny * nx + li],
                                     lenv[2 * ny * nx + li], renv[ri],
                                     renv[ny * nr + ri],
                                     renv[2 * ny * nr + ri]);
        push(j, d < D ? (inside ? c : sentinel) : 0);
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < kBoxRows; i += kBoxThreads / 32) {
    if (i0 + i >= rows || d >= D) continue;
    const int16_t* vp = st + i * jstride + lane;
    int s = 0;
    for (int xi = 0; xi <= 2 * r; ++xi) s += vp[xi * 32];
    int16_t* out = C + ((size_t)(i0 + i) * W + x0) * D + d;
    const int n_out = min(tx, W - x0);
#pragma unroll 4
    for (int t = 0; t < n_out; ++t) {
      out[(size_t)t * D] = (int16_t)s;
      if (t + 2 * r + 1 < nx) s += vp[(t + 2 * r + 1) * 32] - vp[t * 32];
    }
  }
}

// hwalk's ring: 2 stages of 16 columns (8 at 8 slots a lane): its columns
// are small and take few instructions, so long chunks keep the chunk's
// fence and lane 0's copies off most columns (openvo_tpu_torch/tools/
// probe_warp_walk.cu).
__host__ __device__ constexpr int hwalk_chunk(int vpl) {
  return vpl <= 4 ? 16 : 64 / vpl;
}
constexpr int kHwalkStages = 2;

// H1, second kernel: one warp per row of int16 C; the left-to-right scan
// from a fresh start, s1 = L. Fed by the warp's TMA ring (F = kRing, in
// ring_bytes of shared memory a warp) or through registers.
template <int VPL, int F>
__global__ void __launch_bounds__(32 * kWalkWarps)
    hwalk_kernel(const int16_t* __restrict__ C, int32_t* __restrict__ s1,
                 int rows, int W, int D, int P1, int P2, int ring_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.x * (blockDim.x >> 5) + warp;
  if (y >= rows) return;
  const int d0 = VPL * lane, n = min(max(D - d0, 0), VPL);
  const size_t base = (size_t)y * W * D;
  struct Col {
    int16_t c[VPL];
  };
  int Lr[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) Lr[k] = kBig;
  int minprev = 0;
  auto step = [&](const Col& col, auto fresh) {
    int c[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = col.c[k];
    warp_step<X2, VPL>(Lr, c, minprev, P1, P2, decltype(fresh)::value, lane,
                       n);
  };
  if constexpr (F == kRing) {
    constexpr int CH = hwalk_chunk(VPL);
    const Ring<CH, kHwalkStages, 1, true> ring{
        smem + (size_t)warp * ring_bytes,
        {(unsigned char*)(C + base), (unsigned char*)(s1 + base)},
        {2 * D, 4 * D}};
    ring_walk<CH, true>(
        W, lane, ring,
        [&](int s, int slot) {
          Col col;
          if (n == VPL)
            load_full<false>(col.c, reinterpret_cast<const int16_t*>(
                                        ring.part(s, 0)) +
                                        (size_t)slot * D + d0);
          return col;
        },
        [&](const Col& col, int, auto fresh, int s, int slot) {
          step(col, fresh);
          store_slots<true>(reinterpret_cast<int*>(ring.part(s, 1)) +
                                (size_t)slot * D + d0,
                            Lr, n);
        });
  } else {
    constexpr bool kVec = F == kVector;
    walk<kPrefetch<VPL>, true, Col>(
        W,
        [&](Col& col, int x) {
          load_slots<kVec>(col.c, C + base + (size_t)x * D + d0, n);
        },
        [&](const Col& col, int x, auto fresh) {
          step(col, fresh);
          store_slots<kVec>(s1 + base + (size_t)x * D + d0, Lr, n);
        });
  }
}

// ---------------------------------------------------------------------------
// Block walks (H2, H5)
// ---------------------------------------------------------------------------

// threads per block of a block walk: D rounded up to whole warps
int padded(int D) { return (D + 31) & ~31; }

template <typename V>
__device__ __forceinline__ V warp_min(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = vmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block-wide min of v (blockDim.x a multiple of 32): warp shuffles, then
// one slot per warp in red[0..nwarps). The caller synchronises.
template <typename V>
__device__ __forceinline__ void warp_min_to(V* red, V v) {
  const V m = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
}

template <typename V>
__device__ __forceinline__ V read_min(const V* red, int nwarps) {
  V m = red[0];
  for (int w = 1; w < nwarps; ++w) m = vmin(m, red[w]);
  return m;
}

// Fill both (Dp + 2)-slot L buffers of a block walk with big(). The caller
// synchronises before writing a slot.
template <typename P>
__device__ __forceinline__ void fill_carry(typename P::L* lbuf, int Dp) {
  for (int i = threadIdx.x; i < 2 * (Dp + 2); i += blockDim.x)
    lbuf[i] = P::big();
}

// H2: one block per scan line, for each direction of travel asked for
// (top-down first, then bottom-up) and each direction j in [dir0, dir0 +
// ndirs) of (straight, previous L at x - 1, previous L at x + 1). Per
// direction, W lines start on the first row walked; a diagonal has W + H - 1
// more that start on the edge column it shifts in (x = 0 for j = 1, W - 1
// for j = 2: the same for both directions of travel, as in the JAX
// package's _scan_dirs). A line starts afresh unless it starts on the first
// row walked and init holds its previous L at x - dx; the line at the last
// row walked writes its L to cout. Each line adds its L into sv. prev[d + 1]
// holds the previous L, with big() at prev[0] and at every slot past
// prev[D] (the idle threads').
template <typename P>
__global__ void vsweep_kernel(const typename P::C* __restrict__ C,
                              typename P::L* sv, int H, int W, int D, int P1,
                              int P2, int dir0, int ndirs, int down,
                              const typename P::L* __restrict__ init,
                              typename P::L* __restrict__ cout) {
  using L = typename P::L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = blockDim.x;
  L* lbuf = (L*)smem;                // 2 x (Dp + 2)
  L* red = lbuf + 2 * (Dp + 2);      // 2 x 32
  const int d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  const L p1 = (L)P1, p2 = (L)P2;
  const int nl = W + H - 1;
  int per_way = 0;
  for (int j = dir0; j < dir0 + ndirs; ++j) per_way += j == 0 ? W : nl;
  int b = blockIdx.x;
  // the first per_way blocks walk top-down if that was asked for
  const bool reverse = !(down && b < per_way);
  if (b >= per_way) b -= per_way;
  int j = dir0;
  for (int lines = j == 0 ? W : nl; b >= lines; lines = nl) {  // j > 0: nl
    b -= lines;
    ++j;
  }
  const int dx = j == 0 ? 0 : (j == 1 ? 1 : -1);
  const int ys = reverse ? -1 : 1, y_first = reverse ? H - 1 : 0;
  const int y_last = reverse ? 0 : H - 1;
  int y = y_first, x = b;
  if (b >= W) {
    y = y_first + ys * (b - W + 1);
    x = dx == 1 ? 0 : W - 1;
  }
  const size_t cbase = (size_t)(j - dir0) * W * D;
  const bool carried = init && y == y_first && x - dx >= 0 && x - dx < W;
  fill_carry<P>(lbuf, Dp);
  __syncthreads();
  L minprev = P::big();
  if (carried) {  // the same for the whole block
    const L v = active ? init[cbase + (size_t)(x - dx) * D + d] : P::big();
    lbuf[d + 1] = v;
    warp_min_to(red, v);
    __syncthreads();
    minprev = read_min(red, nwarps);
  }
  int buf = 0;
  for (bool fresh = !carried; y >= 0 && y < H && x >= 0 && x < W;
       y += ys, x += dx, fresh = false) {
    const L* prev = lbuf + buf * (Dp + 2);
    L* next = lbuf + (buf ^ 1) * (Dp + 2);
    L Lv = P::big();
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      Lv = P::step(prev[d + 1], prev[d], prev[d + 2], (L)C[o], minprev, p1,
                   p2, fresh);
      P::add_to(sv + o, Lv);
      if (cout && y == y_last) cout[cbase + (size_t)x * D + d] = Lv;
    }
    next[d + 1] = Lv;
    warp_min_to(red + (buf ^ 1) * 32, Lv);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

// H5: one block per row y. Walks x left to right with the float32 SGM step
// from a previous L of 1e9; out = L.
__global__ void hsweep_kernel(const float* __restrict__ C,
                              float* __restrict__ out, int W, int D, int P1,
                              int P2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = blockDim.x;
  float* lbuf = (float*)smem;          // 2 x (Dp + 2)
  float* red = lbuf + 2 * (Dp + 2);    // 2 x 32
  const int y = blockIdx.x, d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  fill_carry<F32>(lbuf, Dp);
  __syncthreads();
  float minprev = kBigF;
  int buf = 0;
  for (int x = 0; x < W; ++x) {
    const float* prev = lbuf + buf * (Dp + 2);
    float* next = lbuf + (buf ^ 1) * (Dp + 2);
    float L = kBigF;
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      L = F32::step(prev[d + 1], prev[d], prev[d + 2], C[o], minprev,
                    (float)P1, (float)P2, false);
      out[o] = L;
    }
    next[d + 1] = L;
    warp_min_to(red + (buf ^ 1) * 32, L);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

template <typename P>
int launch_vsweep(const void* C, void* sv, int H, int W, int D, int P1,
                  int P2, int dir0, int ndirs, int down, int up,
                  const void* init, void* cout, cudaStream_t stream) {
  using L = typename P::L;
  const int Dp = padded(D);
  const size_t smem = sizeof(L) * (2 * (Dp + 2) + 64);
  int per_way = 0;
  for (int j = dir0; j < dir0 + ndirs; ++j) per_way += j == 0 ? W : W + H - 1;
  const int blocks = per_way * ((down ? 1 : 0) + (up ? 1 : 0));
  vsweep_kernel<P><<<blocks, Dp, smem, stream>>>(
      (const typename P::C*)C, (L*)sv, H, W, D, P1, P2, dir0, ndirs, down,
      (const L*)init, (L*)cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lp, rp: H input rows; C, s1: `rows` output rows, input rows row0.. of it
int ovo_cost_hsweep(const float* lp, const float* rp, int16_t* C,
                    int32_t* s1, int H, int W, int D, int min_disp,
                    int radius, int sentinel, int P1, int P2, int bf16,
                    int row0, int rows, int clamp_lo, int clamp_hi,
                    void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || radius < 0 || rows <= 0 ||
      row0 < 0 || row0 + rows > H || clamp_lo < 0 || clamp_lo > clamp_hi ||
      clamp_hi >= H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the widest tile (of 32, 16, 8 columns) within 100 KB, so that two
  // blocks share an SM; else the widest that fits at all
  int tx = 32;
  while (tx > 8 && box_smem(radius, tx) > 100 * 1024) tx /= 2;
  const size_t smem = box_smem(radius, tx);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* box = bf16 ? (const void*)bt_box_kernel<true>
                         : (const void*)bt_box_kernel<false>;
  int err = set_smem(box, smem);
  if (err) return err;
  const dim3 grid((W + tx - 1) / tx, (rows + kBoxRows - 1) / kBoxRows,
                  (D + 31) / 32);
  if (bf16)
    bt_box_kernel<true><<<grid, kBoxThreads, smem, st>>>(
        lp, rp, C, W, D, min_disp, radius, sentinel, row0, rows, clamp_lo,
        clamp_hi, tx);
  else
    bt_box_kernel<false><<<grid, kBoxThreads, smem, st>>>(
        lp, rp, C, W, D, min_disp, radius, sentinel, row0, rows, clamp_lo,
        clamp_hi, tx);
  err = (int)cudaGetLastError();
  if (err) return err;
  const bool ring = feed_fits(kRing, D, {C, s1});
  const size_t warp_bytes =
      ring ? ring_bytes(hwalk_chunk(slots_per_lane(D)), kHwalkStages, D, 6)
           : 0;
  return with_lanes<kRing>(D, ring, [&](auto vpl, auto feed) {
    auto kernel = hwalk_kernel<decltype(vpl)::value, decltype(feed)::value>;
    const int e = set_smem((const void*)kernel, kWalkWarps * warp_bytes);
    if (e) return e;
    kernel<<<(rows + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps,
             kWalkWarps * warp_bytes, st>>>(C, s1, rows, W, D, P1, P2,
                                             (int)warp_bytes);
    return (int)cudaGetLastError();
  });
}

// C int16 with int32 sv/init/cout (f32 = 0) or all float32 (f32 = 1, one
// direction and one direction of travel); directions [dir0, dir0 + ndirs)
// of (straight, +1, -1); init/cout (ndirs, W, D) or NULL
int ovo_vsweep(const void* C, int f32, void* sv, int H, int W, int D, int P1,
               int P2, int dir0, int ndirs, int down, int up,
               const void* init, void* cout, void* stream) {
  const bool one_way = !(down && up);
  if (bad_d(D) || H <= 0 || W <= 0 || !(down || up) || dir0 < 0 ||
      ndirs < 1 || dir0 + ndirs > 3 || ((init || cout) && !one_way) ||
      (f32 && (ndirs != 1 || !one_way)))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_vsweep<F32>(C, sv, H, W, D, P1, P2, dir0, ndirs, down, up,
                              init, cout, (cudaStream_t)stream);
  return launch_vsweep<X2>(C, sv, H, W, D, P1, P2, dir0, ndirs, down, up,
                           init, cout, (cudaStream_t)stream);
}

int ovo_hsweep(const float* C, float* out, int H, int W, int D, int P1,
               int P2, void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const size_t smem = sizeof(float) * (2 * (Dp + 2) + 64);
  hsweep_kernel<<<H, Dp, smem, (cudaStream_t)stream>>>(C, out, W, D, P1, P2);
  return (int)cudaGetLastError();
}

}  // extern "C"
