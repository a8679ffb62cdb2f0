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
//                        init_carry / return_carry (sgbm_pallas.py:478-557);
//                        the trio over int16 C of a batch of frames is
//                        csrc/sgbm_trio.cu's row-synchronous walk instead
//   H5 hsweep         <- sgbm_pallas.sweep_h (K6), float32: hwalk over F32
//   H3 hsweep_wta_lr  <- sgbm_pallas.sweep_hw_wta (K3), and over float32
//                        costs sweep_h_wta (K7); + lr_lookup (K4) and the
//                        post-pass of sgbm_fused_tpu
//
// Two designs, and what bounds each on the H100 (times in PERF.md):
//
//   - Warp walks (H1's hwalk, H5, H2, H3). One warp walks one scan line (a
//     row, or a vertical or diagonal line for H2), four lines a block; lane
//     l holds the VPL disparities d = VPL*l + k (VPL = D/32 rounded up to a
//     power of two) in registers, idle slots (d >= D) at "infinity". A step
//     takes the neighbours d +- 1 from the lane's own registers or one
//     shuffle up and one down, and min L' from one redux.sync
//     (__reduce_min_sync, the hardware's warp reduction), so no block
//     barrier is on the walk and nothing on its chain passes through shared
//     memory. The loads leave the chain: hwalk (over int16 and float32 C)
//     and H3 over float32 C take their columns from a TMA ring in the
//     warp's shared memory (lane 0 fetches a chunk of columns of each
//     volume with one bulk copy and an mbarrier, chunks ahead; hwalk sends
//     its L back the same way), H3 over int16 C loads each column 8 steps
//     ahead and H2 each pixel 4 steps ahead into registers (vector loads
//     as volatile PTX, which the compiler keeps where they are issued):
//     each the faster on the card (sgbm_common.cuh, Feed; for H2, whose
//     pixels lie W*D +- D elements apart, a ring of one bulk copy a pixel
//     lost: tools/probe_warp_walk.cu). A chunk or a loop body of a few steps
//     has no branch, so one step's work interleaves with the next one's.
//     What bounds the row walks is the step's dependency chain times the W
//     columns, plus the issue slots the column's loads, stores and
//     reductions take beside it: the 376 rows of a KITTI frame give one
//     warp to each SM quarter it reaches, so nothing else hides that
//     latency. H2's lines are short (at most H pixels) and many (4,476 for
//     the top-down trio at KITTI size), so its launch keeps to 64 registers
//     and 32 lines an SM walk at once, the directions' lines interleaved so
//     that their adds into a row of the int32 sum meet in L2. Each line
//     adds its L into the sum every other line of the launch adds into: a
//     warp stages 4 pixels' L in shared memory and sends each with one bulk
//     reduce-add (cp.reduce.async.bulk .add.s32, applied in L2 per element
//     atomically, so exact in any order). Those adds, not the walk, bound
//     it: the same walk with plain stores takes about half the time. So the
//     trio of a batch, the paths' H2, is a walk of its own that sums the
//     three directions on the SM and writes s1 once (csrc/sgbm_trio.cu,
//     bound by those bytes); this kernel keeps the straight line alone, the
//     carries, float32 C, a single frame and the scalar fallback. Over
//     int16 C the sum is H1's s1 itself, so no zeroed volume is written and
//     H3 reads one volume fewer. H3 keeps the argmin's redux, the
//     uniqueness vote and the right-view ring (a register shift of packed
//     keys) off the chain of L, and the row's per-column results in the
//     warp's shared memory.
//   - H1's cost leaves the walk: bt_box computes C for tiles of 16 rows x 32
//     columns x 32 disparities in parallel over the card, each BT cost once
//     per (input row, column, disparity) of a tile from per-pixel rounded
//     values and envelopes computed once per tile, with the vertical and
//     horizontal box sums as sliding integer sums in shared memory. It is
//     bound by its arithmetic and shared-memory traffic; the walk then
//     reads C back, so H1 moves 8 bytes per volume element (C written and
//     read, s1 written) where a fused kernel would move 6.
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
// x disparities [dc, dc + 32) of a block, of frame blockIdx.z / ceil(D/32)
// of a batch (frames of H input rows and `rows` output rows each, one
// after another: a frame changes only the base offsets, and no box sum
// crosses a frame's edge). Input row j of the tile is row
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
                  int clamp_hi, int tx, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ny = kBoxRows + 2 * r, nx = tx + 2 * r, nr = nx + 31;
  const int x0 = blockIdx.x * tx, i0 = blockIdx.y * kBoxRows;
  const int nzd = (D + 31) / 32, frame = blockIdx.z / nzd;
  const int dc = (blockIdx.z - frame * nzd) * 32;
  lp += (size_t)frame * H * W;
  rp += (size_t)frame * H * W;
  C += (size_t)frame * rows * W * D;
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

// hwalk's ring: stages of 16 columns (8 at 8 slots a lane), 2 over int16 C
// and 3 over float32 C: its columns are small and take few instructions,
// so long chunks keep the chunk's fence and lane 0's copies off most
// columns (openvo_tpu_torch/tools/probe_warp_walk.cu).
__host__ __device__ constexpr int hwalk_chunk(int vpl) {
  return vpl <= 4 ? 16 : 64 / vpl;
}
template <typename P>
constexpr int kHwalkStages = P::kSumsExact ? 2 : 3;

// H1's second kernel (P = X2: int16 C, out = s1 int32, from a fresh start)
// and H5 (P = F32: float32 C and L, from a previous L of 1e9 everywhere and
// min L' = 1e9, as the JAX package's carry): one warp per row of C, the
// left-to-right scan, out = L. Fed by the warp's TMA ring (F = kRing: NS
// stages of CH columns in ring_bytes of shared memory a warp) or through
// registers.
template <typename P, int VPL, int F, int CH = hwalk_chunk(VPL),
          int NS = kHwalkStages<P>>
__global__ void __launch_bounds__(32 * kWalkWarps)
    hwalk_kernel(const typename P::C* __restrict__ C,
                 typename P::L* __restrict__ out, int rows, int W, int D,
                 int P1, int P2, int ring_bytes) {
  using CT = typename P::C;
  using L = typename P::L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.x * (blockDim.x >> 5) + warp;
  if (y >= rows) return;
  const int d0 = VPL * lane, n = min(max(D - d0, 0), VPL);
  const size_t base = (size_t)y * W * D;
  const L p1 = (L)P1, p2 = (L)P2;
  struct Col {
    CT c[VPL];
  };
  L Lr[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) Lr[k] = P::big();
  L minprev = P::start_minprev();
  auto step = [&](const Col& col, auto fresh) {
    L c[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = (L)col.c[k];
    warp_step<P, VPL>(Lr, c, minprev, p1, p2, decltype(fresh)::value, lane,
                      n);
  };
  if constexpr (F == kRing) {
    const Ring<CH, NS, 1, true> ring{
        smem + (size_t)warp * ring_bytes,
        {(unsigned char*)(C + base), (unsigned char*)(out + base)},
        {(int)sizeof(CT) * D, (int)sizeof(L) * D}};
    ring_walk<CH, true>(
        W, lane, ring,
        [&](int s, int slot) {
          Col col;
          if (n == VPL)
            load_full<false>(col.c, reinterpret_cast<const CT*>(
                                        ring.part(s, 0)) +
                                        (size_t)slot * D + d0);
          return col;
        },
        [&](const Col& col, int, auto fresh, int s, int slot) {
          step(col, fresh);
          store_slots<true>(reinterpret_cast<L*>(ring.part(s, 1)) +
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
          store_slots<kVec>(out + base + (size_t)x * D + d0, Lr, n);
        });
  }
}

// hwalk over P's C (H1's walk over int16 C, H5 over float32 C): the TMA
// ring where feed_fits, else scalar loads at 32 slots a lane.
template <typename P>
int launch_hwalk(const void* C, void* out, int rows, int W, int D, int P1,
                 int P2, cudaStream_t stream) {
  using CT = typename P::C;
  using L = typename P::L;
  const bool ring = feed_fits(kRing, D, {C, out});
  const size_t warp_bytes =
      ring ? ring_bytes(hwalk_chunk(slots_per_lane(D)), kHwalkStages<P>, D,
                        (int)(sizeof(CT) + sizeof(L)))
           : 0;
  return with_lanes<kRing>(D, ring, [&](auto vpl, auto feed) {
    auto kernel =
        hwalk_kernel<P, decltype(vpl)::value, decltype(feed)::value>;
    const int e = set_smem((const void*)kernel, kWalkWarps * warp_bytes);
    if (e) return e;
    kernel<<<(rows + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps,
             kWalkWarps * warp_bytes, stream>>>((const CT*)C, (L*)out, rows,
                                                W, D, P1, P2,
                                                (int)warp_bytes);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// H2 vsweep: one warp per scan line
// ---------------------------------------------------------------------------

// A vertical scan line: direction j (0 straight; 1 and 2 the diagonals,
// whose previous L lies at x - dx, dx = +1 and -1), walked top-down (ys =
// 1) or bottom-up (ys = -1) for len pixels from (y, x).
struct VLine {
  int j, dx, ys, y, x, len;
};

// Line b of a launch. For each direction of travel asked for (top-down
// first, then bottom-up; per_way lines each) and each direction j in
// [dir0, dir0 + ndirs), W lines start on the first row walked; a diagonal
// has H - 1 more that start on the edge column it shifts in (x = 0 for +1,
// W - 1 for -1: the same for both directions of travel, as in the JAX
// package's _scan_dirs). A line runs until it leaves the image. The
// directions' lines alternate (the lines from column x of the first row,
// then those from row k of the edge columns), so that warps that run at the
// same time add into the same rows of the sum.
__device__ __forceinline__ VLine vline(int b, int H, int W, int dir0,
                                       int ndirs, int down, int per_way) {
  VLine v;
  const bool up = !(down && b < per_way);
  if (b >= per_way) b -= per_way;
  const int diags = ndirs - (dir0 == 0 ? 1 : 0);
  if (b < ndirs * W) {
    v.j = dir0 + b % ndirs;
    b /= ndirs;
  } else {  // an edge line of one of the diagonals
    b -= ndirs * W;
    v.j = dir0 + (ndirs - diags) + b % diags;
    b = W + b / diags;
  }
  v.dx = v.j == 0 ? 0 : (v.j == 1 ? 1 : -1);
  v.ys = up ? -1 : 1;
  v.y = up ? H - 1 : 0;
  v.x = b;
  if (b >= W) {
    v.y += v.ys * (b - W + 1);
    v.x = v.dx == 1 ? 0 : W - 1;
  }
  v.len = up ? v.y + 1 : H - v.y;
  if (v.dx == 1) v.len = min(v.len, W - v.x);
  if (v.dx == -1) v.len = min(v.len, v.x + 1);
  return v;
}

// One bulk reduce-add of `bytes` of int32 elements from shared memory at
// src into dst: the L2 applies it per element atomically.
template <typename L>
__device__ __forceinline__ void bulk_reduce_add(L* dst, unsigned src,
                                                int bytes) {
  static_assert(std::is_same_v<L, int>, "an add of int32 elements");
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.s32 [%0], "
      "[%1], %2;" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// H2's tuning, the fastest on the H100 of those timed by
// openvo_tpu_torch/tools/probe_warp_walk.cu (other feeds, adds and
// tunings live there): the vector feed loads a line's pixels 4 ahead, and
// the kernel keeps to the registers that let 8 blocks of 4 warps share an
// SM over int16 C (4 over float32 C, 1 beyond 4 slots a lane), so that 32
// lines an SM (4,224 of a KITTI trio's 4,476) walk at once and their adds
// meet in L2. Over int16 C a warp stages its L for the bulk adds in
// kAddStages stages of kAddRows pixels.
template <int VPL>
constexpr int kVsweepAhead = VPL <= 4 ? 4 : kPrefetch<VPL>;
template <typename P, int VPL>
constexpr int kVsweepBlocks = VPL > 4 ? 1 : (P::kSumsExact ? 8 : 4);
constexpr int kAddRows = 4, kAddStages = 2;

// Shared memory of an H2 warp: the bulk adds' stages (int16 C, vector
// feed), else none.
size_t vsweep_warp_bytes(bool staged, int D) {
  return staged ? (size_t)kAddStages * kAddRows * D * sizeof(int) : 0;
}

// H2: one warp per scan line (vline), lane l holding d = VPL*l + k as in
// hwalk: the step takes d +- 1 from the lane's registers or one shuffle
// each way and min L' from one redux, with no block barrier. A line starts
// afresh unless it starts on the first row walked and init holds its
// previous L at x - dx; a line that ends on the last row walked writes its
// L to cout. Each pixel's inputs come through registers, kVsweepAhead
// pixels ahead (F = kVector or kScalar). Over X2 every line of every
// direction adds its L into sv: from the vector feed a warp stages kAddRows
// pixels' L in its shared memory and lane i sends the stage's pixel i with
// one bulk reduce-add (cp.reduce.async.bulk .add.s32); from the scalar
// feed each lane adds its slots with atomicAdd. Over F32 a launch walks one
// direction, whose lines cover each pixel once, and each pixel's sum
// becomes sv + L (L where `assign`: the first direction), as the JAX
// package's sum order.
template <typename P, int VPL, int F>
__global__ void __launch_bounds__(32 * kWalkWarps, kVsweepBlocks<P, VPL>)
    vsweep_kernel(const typename P::C* __restrict__ C, typename P::L* sv,
                  int H, int W, int D, int P1, int P2, int dir0, int ndirs,
                  int down, int per_way, int nlines, int assign,
                  const typename P::L* __restrict__ init,
                  typename P::L* __restrict__ cout, int frames,
                  long long carry_stride) {
  using CT = typename P::C;
  using L = typename P::L;
  constexpr bool kExact = P::kSumsExact;
  constexpr bool kVec = F == kVector;
  constexpr bool kStaged = kExact && kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= nlines * frames) return;
  // line b of frame f: a frame moves C, sv and the carries by its own
  // volume (carry_stride elements for the carries)
  const int f = b / nlines;
  b -= f * nlines;
  C += (size_t)f * H * W * D;
  sv += (size_t)f * H * W * D;
  if (init) init += f * carry_stride;
  if (cout) cout += f * carry_stride;
  const VLine v = vline(b, H, W, dir0, ndirs, down, per_way);
  const int d0 = VPL * lane, n = min(max(D - d0, 0), VPL);
  const L p1 = (L)P1, p2 = (L)P2;
  // the lane's first element at the line's first pixel, and the elements
  // from one pixel of the line to the next
  const long long first = ((long long)v.y * W + v.x) * D + d0;
  const long long next = ((long long)v.ys * W + v.dx) * D;
  const size_t cbase = (size_t)(v.j - dir0) * W * D;
  const bool carried = init && v.y == (v.ys > 0 ? 0 : H - 1) &&
                       v.x - v.dx >= 0 && v.x - v.dx < W;
  L Lr[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) Lr[k] = P::big();
  L minprev = P::start_minprev();
  if (carried) {
    const L* ip = init + cbase + (size_t)(v.x - v.dx) * D + d0;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (k < n) Lr[k] = ip[k];
    minprev = P::warp_all_min(lane_min(Lr));
  }
  // kStaged: the warp's stages of the adds
  L* staged = reinterpret_cast<L*>(smem) +
              (size_t)warp * kAddStages * kAddRows * D;
  // a pixel's C and, over F32 where it adds, the sum it adds to
  struct Col {
    CT c[VPL];
    L a[kExact ? 1 : VPL];
  };
  // after pixel t, which ends a stage of the adds (generic, so that only
  // kStaged instantiates it)
  auto send = [&](auto t) {
    const int k = t / kAddRows, rows = t - k * kAddRows + 1;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane < rows)
      bulk_reduce_add(
          sv + (first - d0) + (k * kAddRows + lane) * next,
          smem_addr(staged + ((k % kAddStages) * kAddRows + lane) * (size_t)D),
          D * (int)sizeof(L));
    // pixel t + 1 writes the stage of chunk k + 1 - kAddStages
    bulk_stores_read<kAddStages - 1>();
    __syncwarp();
  };
  auto step = [&](const Col& col, int t, auto fresh) {
    L c[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = (L)col.c[k];
    warp_step<P, VPL>(Lr, c, minprev, p1, p2,
                      decltype(fresh)::value && !carried, lane, n);
    if constexpr (kStaged) {
      const int row = (t / kAddRows) % kAddStages * kAddRows + t % kAddRows;
      store_slots<true>(staged + (size_t)row * D + d0, Lr, n);
      if (t % kAddRows == kAddRows - 1 || t == v.len - 1) send(t);
      return;
    }
    L* o = sv + first + t * next;
    if constexpr (kExact) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        if (k < n) atomicAdd(o + k, Lr[k]);
    } else if (assign) {
      store_slots<kVec>(o, Lr, n);
    } else {
      L s[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) s[k] = P::add(col.a[k], Lr[k]);
      store_slots<kVec>(o, s, n);
    }
  };
  walk<kVsweepAhead<VPL>, true, Col>(
      v.len,
      [&](Col& col, int t) {
        const long long o = first + t * next;
        load_slots<kVec>(col.c, C + o, n);
        if constexpr (!kExact) {
          if (!assign) load_slots<kVec>(col.a, sv + o, n);
        }
      },
      step);
  if constexpr (kStaged) bulk_stores_done();
  // a line that ends on the last row walked: its L continues the sweep
  if (cout && v.y + v.ys * (v.len - 1) == (v.ys > 0 ? H - 1 : 0)) {
    L* cp = cout + cbase + (size_t)(v.x + v.dx * (v.len - 1)) * D + d0;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (k < n) cp[k] = Lr[k];
  }
}

// H2 over P's C: every line of [dir0, dir0 + ndirs) and of each direction
// of travel asked for in one launch, with vector loads where feed_fits and
// a bulk add's rows are whole 16-byte units, else scalar loads at 32 slots
// a lane.
template <typename P>
int launch_vsweep(const void* C, void* sv, int H, int W, int D, int P1,
                  int P2, int dir0, int ndirs, int down, int up, int assign,
                  const void* init, void* cout, cudaStream_t stream,
                  int frames = 1, long long carry_stride = 0) {
  using CT = typename P::C;
  using L = typename P::L;
  int per_way = 0;
  for (int j = dir0; j < dir0 + ndirs; ++j) per_way += j == 0 ? W : W + H - 1;
  const int nlines = per_way * ((down ? 1 : 0) + (up ? 1 : 0));
  const bool fast = feed_fits(kVector, D, {C, sv}) && D % 4 == 0;
  return with_lanes<kVector>(D, fast, [&](auto vpl, auto feed) {
    constexpr int F = decltype(feed)::value;
    const size_t warp_bytes =
        vsweep_warp_bytes(P::kSumsExact && F == kVector, D);
    auto kernel = vsweep_kernel<P, decltype(vpl)::value, F>;
    const int e = set_smem((const void*)kernel, kWalkWarps * warp_bytes);
    if (e) return e;
    const long long blocks =
        ((long long)nlines * frames + kWalkWarps - 1) / kWalkWarps;
    kernel<<<(unsigned)blocks, 32 * kWalkWarps, kWalkWarps * warp_bytes,
             stream>>>((const CT*)C, (L*)sv, H, W, D, P1, P2, dir0, ndirs,
                       down, per_way, nlines, assign, (const L*)init,
                       (L*)cout, frames, carry_stride);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// lp, rp: `frames` frames of H input rows; C, s1: `rows` output rows a
// frame, input rows row0.. of it. The frames of a batch share one launch
// of each kernel: bt_box takes the frame from its grid's z, hwalk walks
// frames * rows rows
int ovo_cost_hsweep(const float* lp, const float* rp, int16_t* C,
                    int32_t* s1, int H, int W, int D, int min_disp,
                    int radius, int sentinel, int P1, int P2, int bf16,
                    int row0, int rows, int clamp_lo, int clamp_hi,
                    int frames, void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || radius < 0 || rows <= 0 ||
      row0 < 0 || row0 + rows > H || clamp_lo < 0 || clamp_lo > clamp_hi ||
      clamp_hi >= H || frames <= 0 || frames * ((D + 31) / 32) > 65535 ||
      (long long)frames * rows > INT_MAX)
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
                  frames * ((D + 31) / 32));
  if (bf16)
    bt_box_kernel<true><<<grid, kBoxThreads, smem, st>>>(
        lp, rp, C, W, D, min_disp, radius, sentinel, row0, rows, clamp_lo,
        clamp_hi, tx, H);
  else
    bt_box_kernel<false><<<grid, kBoxThreads, smem, st>>>(
        lp, rp, C, W, D, min_disp, radius, sentinel, row0, rows, clamp_lo,
        clamp_hi, tx, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_hwalk<X2>(C, s1, frames * rows, W, D, P1, P2, st);
}

// C int16 with int32 sv/init/cout (f32 = 0: sv holds the sum so far, zeros
// or a partial sum) or all float32 (f32 = 1: one direction and one
// direction of travel; sv = sv + L, or sv = L where `assign`); directions
// [dir0, dir0 + ndirs) of (straight, +1, -1); init/cout (ndirs, W, D) or
// NULL. `frames` volumes of (H, W, D) one after another in C and sv, each
// with its carries carry_stride elements after the previous frame's: the
// lines of every frame in one launch
int ovo_vsweep(const void* C, int f32, void* sv, int H, int W, int D, int P1,
               int P2, int dir0, int ndirs, int down, int up, int assign,
               const void* init, void* cout, int frames,
               long long carry_stride, void* stream) {
  const bool one_way = !(down && up);
  if (bad_d(D) || H <= 0 || W <= 0 || !(down || up) || dir0 < 0 ||
      ndirs < 1 || dir0 + ndirs > 3 || ((init || cout) && !one_way) ||
      (f32 && (ndirs != 1 || !one_way)) || (assign && !f32) || frames <= 0 ||
      carry_stride < 0)
    return (int)cudaErrorInvalidValue;
  int per_frame = 0;  // a frame's lines, at most: every direction both ways
  for (int j = dir0; j < dir0 + ndirs; ++j) per_frame += 2 * (W + H - 1);
  if ((long long)per_frame * frames > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_vsweep<F32>(C, sv, H, W, D, P1, P2, dir0, ndirs, down, up,
                              assign, init, cout, (cudaStream_t)stream,
                              frames, carry_stride);
  return launch_vsweep<X2>(C, sv, H, W, D, P1, P2, dir0, ndirs, down, up, 0,
                           init, cout, (cudaStream_t)stream, frames,
                           carry_stride);
}

// H5: the left-to-right scan of float32 C, out = L (a batch of frames is
// H = frames * rows rows: each row is a line of its own)
int ovo_hsweep(const float* C, float* out, int H, int W, int D, int P1,
               int P2, void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return launch_hwalk<F32>(C, out, H, W, D, P1, P2, (cudaStream_t)stream);
}

}  // extern "C"
