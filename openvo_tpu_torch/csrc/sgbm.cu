// SGBM volume kernels for Hopper (sm_90a), bound to Python with ctypes
// (openvo_tpu_torch/ops/sgbm_cuda.py holds the wrappers and the plain
// PyTorch versions these must match bit for bit).
//
// Layout: volumes are (H, W, D) row-major with the disparity axis innermost;
// every kernel runs one thread per disparity, so a warp touches 32
// neighbouring values of one pixel. A block has D threads rounded up to
// whole warps: the idle lanes (d >= D) take part in every barrier and
// shuffle with L = "infinity" and store nothing.
//
// Two arithmetic paths (the traits X2 and F32 below), as the JAX package's
// CPU path computes them:
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
//                        tile with halo rows, edge rows clamped in cost space
//   H2 vsweep         <- sgbm_pallas.sweep_v (K2): one or three vertical
//                        directions, top-down and/or bottom-up, with its
//                        init_carry / return_carry (sgbm_pallas.py:478-557)
//   H5 hsweep         <- sgbm_pallas.sweep_h (K6), float32
//   H3 hsweep_wta_lr  <- sgbm_pallas.sweep_hw_wta (K3), and over float32
//                        costs sweep_h_wta (K7); + lr_lookup (K4) and the
//                        post-pass of sgbm_fused_tpu
//
// What bounds them on the H100: each block walks its row or line serially,
// one block barrier per step, so all are bound by that walk (latency), not
// by bytes: at KITTI size (1242x376, D=128) the byte floors at 3.35 TB/s
// are 0.11 ms (H1, H2's int16 trio), 0.14 ms (H5, H2's float32 trio) and
// 0.18-0.21 ms (H3), a sixth to a twentieth of the measured times
// (PERF.md). The band and the carry add no pass: a band reads its halo rows
// where the whole image reads its neighbours, and a carry is one (W, D) row
// read before the walk and one written at its end. A band of 94 rows still
// takes most of the whole image's H1 time: the walk over W sets it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 28;   // x2 grid: L outside the disparity range
constexpr float kBigF = 1e9f;   // x1 grid: the JAX package's carry and fill
constexpr unsigned kFull = 0xffffffffu;

// First L of a scan: float32 (c + 1e9) - 1e9 on the x1 grid rounds c
// half-to-even to a multiple of 64, i.e. c2 to a multiple of 128 here.
__device__ __forceinline__ int fresh_start(int c2) {
  return (int)rintf((float)c2 * (1.0f / 128.0f)) * 128;
}

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ unsigned long long vmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

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

// The int16 path on the x2 grid. prev[d + 1] holds the previous L, with
// big() at prev[0] and at every slot past prev[D] (the idle lanes').
struct X2 {
  using C = int16_t;
  using L = int;
  using Key = int;  // S * D + d: its min is min S with the lowest d
  static constexpr Key kKeyMax = INT_MAX;
  __device__ static L big() { return kBig; }
  __device__ static L step(const L* prev, int d, L c, L minprev, L P1, L P2,
                           bool fresh) {
    if (fresh) return fresh_start(c);
    int cand = min(prev[d + 1], min(prev[d], prev[d + 2]) + P1);
    cand = min(cand, minprev + P2);
    return c + cand - minprev;
  }
  __device__ static L add(L a, L b) { return a + b; }
  // many lines of many directions add into one element: any order is exact
  __device__ static void add_to(L* acc, L v) { atomicAdd(acc, v); }
  __device__ static Key key(L S, int d, int D) { return S * D + d; }
  __device__ static int key_d(Key k, int D) { return k % D; }
  __device__ static L key_s(Key k, int D) { return k / D; }
  __device__ static float x1(L S) { return 0.5f * (float)S; }
  // (s_m - s_p) / (2 denom) on the x2 grid is the x1 ratio, and both
  // operands are exact integers
  __device__ static float frac(L sm, L sp, L ms, int b, int D) {
    const int denom = sm + sp - 2 * ms;
    if (b > 0 && b < D - 1 && denom > 0)
      return __fdiv_rn((float)(sm - sp), fmaxf(2.0f * (float)denom, 1e-9f));
    return 0.0f;
  }
};

// The float32 path on the x1 grid: each operation rounds as the JAX
// package's _scan_dirs and _wta. A scan's first step reads a previous L of
// 1e9 everywhere (the buffers start filled with it), so `fresh` is unused.
struct F32 {
  using C = float;
  using L = float;
  // (bits of S) << 32 | d: S >= 0, and a non-negative float's bits keep its
  // order as an unsigned integer, so the min is min S with the lowest d
  using Key = unsigned long long;
  static constexpr Key kKeyMax = ~0ull;
  __device__ static L big() { return kBigF; }
  __device__ static L step(const L* prev, int d, L c, L minprev, L P1, L P2,
                           bool) {
    float cand = fminf(prev[d + 1], __fadd_rn(fminf(prev[d], prev[d + 2]), P1));
    cand = fminf(cand, __fadd_rn(minprev, P2));
    return __fsub_rn(__fadd_rn(c, cand), minprev);
  }
  __device__ static L add(L a, L b) { return __fadd_rn(a, b); }
  // one line per element in a launch, launches in the JAX sum order
  __device__ static void add_to(L* acc, L v) { *acc = __fadd_rn(*acc, v); }
  __device__ static Key key(L S, int d, int) {
    return ((Key)__float_as_uint(S) << 32) | (unsigned)d;
  }
  __device__ static int key_d(Key k, int) { return (int)(k & 0xffffffffu); }
  __device__ static L key_s(Key k, int) {
    return __uint_as_float((unsigned)(k >> 32));
  }
  __device__ static float x1(L S) { return S; }
  __device__ static float frac(L sm, L sp, L ms, int b, int D) {
    const float denom = __fsub_rn(__fadd_rn(sm, sp), __fmul_rn(2.0f, ms));
    if (b > 0 && b < D - 1 && denom > 0.0f)
      return __fdiv_rn(__fsub_rn(sm, sp),
                       fmaxf(__fmul_rn(2.0f, denom), 1e-9f));
    return 0.0f;
  }
};

// Fill both (Dp + 2)-slot L buffers of a scan with big(). The caller
// synchronises before writing a slot.
template <typename P>
__device__ __forceinline__ void fill_carry(typename P::L* lbuf, int Dp) {
  for (int i = threadIdx.x; i < 2 * (Dp + 2); i += blockDim.x)
    lbuf[i] = P::big();
}

// Round to bfloat16 (nearest, ties to even) when kBf16. For two bfloat16
// operands the float32 sum or difference rounds to bfloat16 exactly as a
// bfloat16 operation would (24 >= 2 * 8 + 2 bits), which is what XLA and
// PyTorch compute.
template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Birchfield-Tomasi cost x2 at (x, d) of one image row. As in the JAX
// package, the half-sample neighbours at x +/- 1 wrap around the row, and a
// right-image column outside the image (for the pixel or a neighbour) gives
// the sentinel. With kBf16 the images and every add and subtract are
// rounded to bfloat16 (the JAX package's work type for 2*cap <= 127); min,
// max and the halving are exact either way. The doubled cost is truncated.
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
  const float l = rnd<kBf16>(lrow[x]), lm = rnd<kBf16>(lrow[xm]),
              lq = rnd<kBf16>(lrow[xp]);
  const float am = 0.5f * rnd<kBf16>(l + lm), ap = 0.5f * rnd<kBf16>(l + lq);
  const float llo = fminf(fminf(am, ap), l), lhi = fmaxf(fmaxf(am, ap), l);
  const float r = rnd<kBf16>(rrow[s0]), rm = rnd<kBf16>(rrow[sm]),
              rq = rnd<kBf16>(rrow[sp]);
  const float bm = 0.5f * rnd<kBf16>(r + rm), bp = 0.5f * rnd<kBf16>(r + rq);
  const float rlo = fminf(fminf(bm, bp), r), rhi = fmaxf(fmaxf(bm, bp), r);
  const float cl =
      fmaxf(0.0f, fmaxf(rnd<kBf16>(l - rhi), rnd<kBf16>(rlo - l)));
  const float cr =
      fmaxf(0.0f, fmaxf(rnd<kBf16>(r - lhi), rnd<kBf16>(llo - r)));
  return (int)(fminf(cl, cr) * 2.0f);
}

// H1: one block per output row y = row0 + blockIdx.x of the H input rows.
// The vertical box reads rows clamped to [clamp_lo, clamp_hi]: the image's
// edge rows for a whole image, the band's own rows, or the core's first /
// last row at a tile on the image's top / bottom edge (K1's band_halo).
// Walks x left to right keeping a ring of the last 2r+1 column sums (per
// thread, in shared memory) for the sliding horizontal box sum, then takes
// the forward SGM step.
template <bool kBf16>
__global__ void cost_hsweep_kernel(const float* __restrict__ lp,
                                   const float* __restrict__ rp,
                                   int16_t* __restrict__ C,
                                   int32_t* __restrict__ s1, int W, int D,
                                   int m, int r, int sentinel, int P1, int P2,
                                   int row0, int clamp_lo, int clamp_hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 2 * r + 1, Dp = blockDim.x;
  int* ring = (int*)smem;            // n * Dp column sums
  int* lbuf = ring + n * Dp;         // 2 x (Dp + 2) previous L
  int* red = lbuf + 2 * (Dp + 2);    // 2 x 32 warp minima
  const int y = row0 + blockIdx.x, d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  fill_carry<X2>(lbuf, Dp);
  auto colsum = [&](int xc) {
    int s = 0;
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = min(max(y + dy, clamp_lo), clamp_hi);
      s += bt_cost2<kBf16>(lp + (size_t)yy * W, rp + (size_t)yy * W, xc, d,
                           W, m, sentinel);
    }
    return s;
  };
  int box = 0;
  for (int p = -r; p <= r; ++p) {
    const int v = active ? colsum(min(max(p, 0), W - 1)) : 0;
    ring[(p + r) * Dp + d] = v;
    box += v;
  }
  __syncthreads();
  int minprev = 0, buf = 0;
  for (int x = 0; x < W; ++x) {
    if (x > 0) {
      // column x + r enters the window; it shares its ring slot with
      // column x - r - 1, which leaves it
      const int p = x + r;
      int* slot = ring + ((p + r) % n) * Dp + d;
      const int v = active ? colsum(min(p, W - 1)) : 0;
      box += v - *slot;
      *slot = v;
    }
    const int* prev = lbuf + buf * (Dp + 2);
    int* next = lbuf + (buf ^ 1) * (Dp + 2);
    int L = kBig;
    if (active) {
      L = X2::step(prev, d, box, minprev, P1, P2, x == 0);
      const size_t o = ((size_t)blockIdx.x * W + x) * D + d;
      C[o] = (int16_t)box;
      s1[o] = L;
    }
    next[d + 1] = L;
    warp_min_to(red + (buf ^ 1) * 32, L);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

// H2: one block per scan line, for each direction of travel asked for
// (top-down first, then bottom-up) and each direction j in [dir0, dir0 +
// ndirs) of (straight, previous L at x - 1, previous L at x + 1). Per
// direction, W lines start on the first row walked; a diagonal has W + H - 1
// more that start on the edge column it shifts in (x = 0 for j = 1, W - 1
// for j = 2: the same for both directions of travel, as in the JAX
// package's _scan_dirs). A line starts afresh unless it starts on the first
// row walked and init holds its previous L at x - dx; the line at the last
// row walked writes its L to cout. Each line adds its L into sv.
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
      Lv = P::step(prev, d, (L)C[o], minprev, p1, p2, fresh);
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
      L = F32::step(prev, d, C[o], minprev, (float)P1, (float)P2, false);
      out[o] = L;
    }
    next[d + 1] = L;
    warp_min_to(red + (buf ^ 1) * 32, L);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

// H3: one block per row y. Walks x right to left: reverse SGM step,
// S = L + s1 + sv (+ svu) (over F32, ((s1 + L) + sv) + svu), packed key (its
// min is min S with the lowest d), uniqueness vote, and the right-view
// argmin bestR(xr) = argmin_d S(xr + d, d) in a D-slot ring of packed keys
// (thread d folds S(x, d) into slot (x - d) mod D; slot x mod D is complete
// after column x and is then read and reset by thread D - 1, the next to
// write it). The row's per-column results stay in shared memory for the
// epilogue, which writes the final disparity. The uniqueness test is the
// JAX package's float32 one on the x1 grid: S * (100 - u) < min S * 100,
// each product rounded.
template <typename P>
__global__ void hsweep_wta_lr_kernel(
    const typename P::C* __restrict__ C, const typename P::L* __restrict__ s1,
    const typename P::L* __restrict__ sv,
    const typename P::L* __restrict__ svu, int16_t* __restrict__ disp16,
    int W, int D, int P1, int P2, int min_disp, int uniq, int disp12) {
  using L = typename P::L;
  using Key = typename P::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = blockDim.x;
  Key* red_k = (Key*)smem;                 // 2 x 32
  Key* ring = red_k + 64;                  // D
  L* lbuf = (L*)(ring + D);                // 2 x (Dp + 2)
  L* red_l = lbuf + 2 * (Dp + 2);          // 2 x 32
  L* min_s = red_l + 64;                   // W
  L* s_m = min_s + W;                      // W
  L* s_p = s_m + W;                        // W
  int16_t* best_row = (int16_t*)(s_p + W); // W
  int16_t* bestr_row = best_row + W;       // W
  uint8_t* bad_row = (uint8_t*)(bestr_row + W);  // W
  const int y = blockIdx.x, d = threadIdx.x, lane = d & 31,
            nwarps = Dp >> 5;
  const bool active = d < D;
  const L p1 = (L)P1, p2 = (L)P2;
  fill_carry<P>(lbuf, Dp);
  if (active) ring[d] = P::kKeyMax;
  for (int i = d; i < W; i += Dp) bad_row[i] = 0;
  __syncthreads();
  L minprev = P::big();
  int buf = 0;
  for (int x = W - 1; x >= 0; --x) {
    const L* prev = lbuf + buf * (Dp + 2);
    L* next = lbuf + (buf ^ 1) * (Dp + 2);
    L Lv = P::big(), S = 0;
    Key key = P::kKeyMax;
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      Lv = P::step(prev, d, (L)C[o], minprev, p1, p2, x == W - 1);
      S = P::add(P::add(s1[o], Lv), sv[o]);
      if (svu) S = P::add(S, svu[o]);
      key = P::key(S, d, D);
      if (x - d >= 0) {
        Key* slot = ring + (x - d) % D;
        *slot = vmin(*slot, key);
      }
    }
    next[d + 1] = Lv;
    warp_min_to(red_l + (buf ^ 1) * 32, Lv);
    warp_min_to(red_k + (buf ^ 1) * 32, key);
    __syncthreads();
    minprev = read_min(red_l + (buf ^ 1) * 32, nwarps);
    const Key kmin = read_min(red_k + (buf ^ 1) * 32, nwarps);
    const int best = P::key_d(kmin, D);
    const L ms = P::key_s(kmin, D);
    if (d == max(best - 1, 0)) s_m[x] = S;
    if (d == min(best + 1, D - 1)) s_p[x] = S;
    if (d == 0) {
      best_row[x] = (int16_t)best;
      min_s[x] = ms;
    }
    if (uniq > 0) {
      const bool bad =
          active && abs(d - best) > 1 &&
          __fmul_rn(P::x1(S), (float)(100 - uniq)) <
              __fmul_rn(P::x1(ms), 100.0f);
      if (__any_sync(kFull, bad) && lane == 0) bad_row[x] = 1;
    }
    if (d == D - 1) {
      Key* slot = ring + x % D;
      bestr_row[x] = (int16_t)P::key_d(*slot, D);
      *slot = P::kKeyMax;
    }
    buf ^= 1;
  }
  __syncthreads();
  for (int x = d; x < W; x += Dp) {
    const int b = best_row[x];
    float frac = P::frac(s_m[x], s_p[x], min_s[x], b, D);
    frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    const float df = __fadd_rn(__fadd_rn((float)b, frac), (float)min_disp);
    const int disp = (int)rintf(__fmul_rn(df, 16.0f));
    bool valid = !(uniq > 0 && bad_row[x]);
    if (disp12 >= 0) {
      const int xr = x - b;  // K4: the LR lookup is a shared-memory read
      valid = valid && (xr < 0 || abs(b - (int)bestr_row[xr]) <= disp12);
    }
    valid = valid && x - (b + min_disp) >= 0;
    disp16[(size_t)y * W + x] = (int16_t)(valid ? disp : (min_disp - 1) * 16);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_d(int D) { return D < 1 || D > 1024; }

// threads per block: D rounded up to whole warps
int padded(int D) { return (D + 31) & ~31; }

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

template <typename P>
int launch_hsweep_wta_lr(const void* C, const void* s1, const void* sv,
                         const void* svu, int16_t* disp16, int H, int W,
                         int D, int P1, int P2, int min_disp, int uniq,
                         int disp12, cudaStream_t stream) {
  using L = typename P::L;
  const int Dp = padded(D);
  const size_t smem = sizeof(typename P::Key) * (64 + (size_t)D) +
                      sizeof(L) * (2 * (Dp + 2) + 64 + 3 * (size_t)W) +
                      sizeof(int16_t) * 2 * (size_t)W + (size_t)W;
  int err = set_smem((const void*)hsweep_wta_lr_kernel<P>, smem);
  if (err) return err;
  hsweep_wta_lr_kernel<P><<<H, Dp, smem, stream>>>(
      (const typename P::C*)C, (const L*)s1, (const L*)sv, (const L*)svu,
      disp16, W, D, P1, P2, min_disp, uniq, disp12);
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
  const int Dp = padded(D);
  const size_t smem =
      sizeof(int) * ((2 * radius + 1) * Dp + 2 * (Dp + 2) + 64);
  const void* kernel = bf16 ? (const void*)cost_hsweep_kernel<true>
                            : (const void*)cost_hsweep_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  if (bf16)
    cost_hsweep_kernel<true><<<rows, Dp, smem, (cudaStream_t)stream>>>(
        lp, rp, C, s1, W, D, min_disp, radius, sentinel, P1, P2, row0,
        clamp_lo, clamp_hi);
  else
    cost_hsweep_kernel<false><<<rows, Dp, smem, (cudaStream_t)stream>>>(
        lp, rp, C, s1, W, D, min_disp, radius, sentinel, P1, P2, row0,
        clamp_lo, clamp_hi);
  return (int)cudaGetLastError();
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

// C int16 with int32 s1/sv/svu (f32 = 0) or all float32 (f32 = 1); svu may
// be NULL
int ovo_hsweep_wta_lr(const void* C, int f32, const void* s1, const void* sv,
                      const void* svu, int16_t* disp16, int H, int W, int D,
                      int P1, int P2, int min_disp, int uniq, int disp12,
                      void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_hsweep_wta_lr<F32>(C, s1, sv, svu, disp16, H, W, D, P1, P2,
                                     min_disp, uniq, disp12,
                                     (cudaStream_t)stream);
  return launch_hsweep_wta_lr<X2>(C, s1, sv, svu, disp16, H, W, D, P1, P2,
                                  min_disp, uniq, disp12,
                                  (cudaStream_t)stream);
}

}  // extern "C"
