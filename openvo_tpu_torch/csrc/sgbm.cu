// SGBM volume kernels for Hopper (sm_90a), bound to Python with ctypes
// (openvo_tpu_torch/ops/sgbm_cuda.py holds the wrappers and the plain
// PyTorch versions these must match bit for bit).
//
// Layout: volumes are (H, W, D) row-major with the disparity axis innermost;
// every kernel runs one thread per disparity, so a warp touches 32
// neighbouring values of one pixel. A block has D threads rounded up to
// whole warps: the idle lanes (d >= D) take part in every barrier and
// shuffle with L = kBig and store nothing. All SGM arithmetic is int32 on
// the x2 grid (costs x2, penalties 2*P1 and 2*P2), exact in any order,
// except the deliberate fresh-start rounding (fresh_start below) that
// reproduces the JAX package's float32 carry of 1e9.
//
//   H1 cost_hsweep    <- sgbm_pallas.cost_sweep_fused (K1)
//   H2 vsweep         <- sgbm_pallas.sweep_v (K2): one or three vertical
//                        directions, top-down and/or bottom-up
//   H5 hsweep         <- sgbm_pallas.sweep_h (K6)
//   H3 hsweep_wta_lr  <- sgbm_pallas.sweep_hw_wta (K3), and over int32
//                        costs sweep_h_wta (K7); + lr_lookup (K4) and the
//                        post-pass of sgbm_fused_tpu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 28;   // L outside the disparity range
constexpr unsigned kFull = 0xffffffffu;

// First L of a scan: float32 (c + 1e9) - 1e9 on the x1 grid rounds c
// half-to-even to a multiple of 64, i.e. c2 to a multiple of 128 here.
__device__ __forceinline__ int fresh_start(int c2) {
  return (int)rintf((float)c2 * (1.0f / 128.0f)) * 128;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One SGM step for disparity d. prev[d + 1] holds the previous L, with
// kBig at prev[0] and at every slot past prev[D] (the idle lanes').
__device__ __forceinline__ int sgm_step(const int* prev, int d, int c2,
                                        int minprev, int P1, int P2) {
  int cand = min(prev[d + 1], min(prev[d], prev[d + 2]) + P1);
  cand = min(cand, minprev + P2);
  return c2 + cand - minprev;
}

// Block-wide min of v (blockDim.x a multiple of 32): warp shuffles, then
// one slot per warp in red[0..nwarps). The caller synchronises.
__device__ __forceinline__ void warp_min_to(int* red, int v) {
  int m = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
}

__device__ __forceinline__ int read_min(const int* red, int nwarps) {
  int m = red[0];
  for (int w = 1; w < nwarps; ++w) m = min(m, red[w]);
  return m;
}

// The carry of one scan: two (Dp + 2)-slot buffers of the previous L with
// kBig at both ends. Call before the first barrier.
__device__ __forceinline__ void init_carry(int* lbuf, int Dp) {
  if (threadIdx.x < 2) {
    lbuf[threadIdx.x * (Dp + 2)] = kBig;
    lbuf[threadIdx.x * (Dp + 2) + Dp + 1] = kBig;
  }
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

// H1: one block per row y. Walks x left to right keeping a ring of the
// last 2r+1 column sums (per thread, in shared memory) for the sliding
// horizontal box sum, then takes the forward SGM step.
template <bool kBf16>
__global__ void cost_hsweep_kernel(const float* __restrict__ lp,
                                   const float* __restrict__ rp,
                                   int16_t* __restrict__ C,
                                   int32_t* __restrict__ s1, int H, int W,
                                   int D, int m, int r, int sentinel, int P1,
                                   int P2) {
  extern __shared__ int smem[];
  const int n = 2 * r + 1, Dp = blockDim.x;
  int* ring = smem;                  // n * Dp column sums
  int* lbuf = ring + n * Dp;         // 2 x (Dp + 2) previous L
  int* red = lbuf + 2 * (Dp + 2);    // 2 x 32 warp minima
  const int y = blockIdx.x, d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  init_carry(lbuf, Dp);
  auto colsum = [&](int xc) {
    int s = 0;
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = min(max(y + dy, 0), H - 1);
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
      L = x == 0 ? fresh_start(box) : sgm_step(prev, d, box, minprev, P1, P2);
      const size_t o = ((size_t)y * W + x) * D + d;
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
// (top-down first, then bottom-up). Per direction, blocks [0, W) are the
// vertical lines; with diagonals, then W + H - 1 lines whose previous L
// lies at x - 1 and W + H - 1 at x + 1, each starting on the first row
// walked or on the edge column the diagonal shifts in (x = 0 for the
// first, W - 1 for the second: the same for both directions of travel, as
// in the JAX package's _scan_dirs). Each line starts afresh and adds its L
// into sv with integer atomics.
template <typename T>
__global__ void vsweep_kernel(const T* __restrict__ C,
                              int32_t* __restrict__ sv, int H, int W, int D,
                              int P1, int P2, int diagonals, int down) {
  extern __shared__ int smem[];
  const int Dp = blockDim.x;
  int* lbuf = smem;                  // 2 x (Dp + 2)
  int* red = lbuf + 2 * (Dp + 2);    // 2 x 32
  const int d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  const int nl = W + H - 1;
  const int per_way = W + (diagonals ? 2 * nl : 0);
  int b = blockIdx.x;
  // the first per_way blocks walk top-down if that was asked for
  const bool reverse = !(down && b < per_way);
  if (b >= per_way) b -= per_way;
  const int ys = reverse ? -1 : 1, y_first = reverse ? H - 1 : 0;
  int y = y_first, x = 0, dx = 0;
  if (b < W) {
    x = b;
  } else {
    b -= W;
    dx = b < nl ? 1 : -1;
    if (b >= nl) b -= nl;
    if (b < W) {
      x = b;
    } else {
      y = y_first + ys * (b - W + 1);
      x = dx == 1 ? 0 : W - 1;
    }
  }
  init_carry(lbuf, Dp);
  __syncthreads();
  int minprev = 0, buf = 0;
  for (bool first = true; y >= 0 && y < H && x >= 0 && x < W;
       y += ys, x += dx, first = false) {
    const int* prev = lbuf + buf * (Dp + 2);
    int* next = lbuf + (buf ^ 1) * (Dp + 2);
    int L = kBig;
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      const int c2 = C[o];
      L = first ? fresh_start(c2) : sgm_step(prev, d, c2, minprev, P1, P2);
      atomicAdd(sv + o, L);
    }
    next[d + 1] = L;
    warp_min_to(red + (buf ^ 1) * 32, L);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

// H5: one block per row y. Walks x left to right (or right to left) with
// the forward SGM step; out = L (+ acc when acc is given; acc may be out).
__global__ void hsweep_kernel(const int32_t* __restrict__ C,
                              const int32_t* acc, int32_t* out, int H, int W,
                              int D, int P1, int P2, int reverse) {
  extern __shared__ int smem[];
  const int Dp = blockDim.x;
  int* lbuf = smem;                  // 2 x (Dp + 2)
  int* red = lbuf + 2 * (Dp + 2);    // 2 x 32
  const int y = blockIdx.x, d = threadIdx.x, nwarps = Dp >> 5;
  const bool active = d < D;
  init_carry(lbuf, Dp);
  __syncthreads();
  int minprev = 0, buf = 0;
  for (int i = 0; i < W; ++i) {
    const int x = reverse ? W - 1 - i : i;
    const int* prev = lbuf + buf * (Dp + 2);
    int* next = lbuf + (buf ^ 1) * (Dp + 2);
    int L = kBig;
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      const int c2 = C[o];
      L = i == 0 ? fresh_start(c2) : sgm_step(prev, d, c2, minprev, P1, P2);
      out[o] = acc ? acc[o] + L : L;
    }
    next[d + 1] = L;
    warp_min_to(red + (buf ^ 1) * 32, L);
    __syncthreads();
    minprev = read_min(red + (buf ^ 1) * 32, nwarps);
    buf ^= 1;
  }
}

// H3: one block per row y. Walks x right to left: reverse SGM step,
// S = L + s1 + sv, packed key S * D + d (its min is min S with the lowest
// d), uniqueness vote, and the right-view argmin bestR(xr) = argmin_d
// S(xr + d, d) in a D-slot ring of packed keys (thread d folds S(x, d) into
// slot (x - d) mod D; slot x mod D is complete after column x and is then
// read and reset by thread D - 1, the next to write it). The row's
// per-column results stay in shared memory for the epilogue, which writes
// the final disparity. The uniqueness test is the JAX package's float32
// one on the x1 grid: S * (100 - u) < min S * 100, each product rounded.
template <typename T>
__global__ void hsweep_wta_lr_kernel(
    const T* __restrict__ C, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ sv, int16_t* __restrict__ disp16, int H,
    int W, int D, int P1, int P2, int min_disp, int uniq, int disp12) {
  extern __shared__ int smem[];
  const int Dp = blockDim.x;
  int* lbuf = smem;                        // 2 x (Dp + 2)
  int* red_l = lbuf + 2 * (Dp + 2);        // 2 x 32
  int* red_k = red_l + 64;                 // 2 x 32
  int* ring = red_k + 64;                  // D
  int* min_s = ring + D;                   // W
  int* s_m = min_s + W;                    // W
  int* s_p = s_m + W;                      // W
  int16_t* best_row = (int16_t*)(s_p + W); // W
  int16_t* bestr_row = best_row + W;       // W
  uint8_t* bad_row = (uint8_t*)(bestr_row + W);  // W
  const int y = blockIdx.x, d = threadIdx.x, lane = d & 31,
            nwarps = Dp >> 5;
  const bool active = d < D;
  init_carry(lbuf, Dp);
  if (active) ring[d] = INT_MAX;
  for (int i = d; i < W; i += Dp) bad_row[i] = 0;
  __syncthreads();
  int minprev = 0, buf = 0;
  for (int x = W - 1; x >= 0; --x) {
    const int* prev = lbuf + buf * (Dp + 2);
    int* next = lbuf + (buf ^ 1) * (Dp + 2);
    int L = kBig, S = 0, key = INT_MAX;
    if (active) {
      const size_t o = ((size_t)y * W + x) * D + d;
      const int c2 = C[o];
      L = x == W - 1 ? fresh_start(c2)
                     : sgm_step(prev, d, c2, minprev, P1, P2);
      S = L + s1[o] + sv[o];
      key = S * D + d;
      if (x - d >= 0) {
        int* slot = ring + (x - d) % D;
        *slot = min(*slot, key);
      }
    }
    next[d + 1] = L;
    warp_min_to(red_l + (buf ^ 1) * 32, L);
    warp_min_to(red_k + (buf ^ 1) * 32, key);
    __syncthreads();
    minprev = read_min(red_l + (buf ^ 1) * 32, nwarps);
    const int kmin = read_min(red_k + (buf ^ 1) * 32, nwarps);
    const int best = kmin % D, ms = kmin / D;
    if (d == max(best - 1, 0)) s_m[x] = S;
    if (d == min(best + 1, D - 1)) s_p[x] = S;
    if (d == 0) {
      best_row[x] = (int16_t)best;
      min_s[x] = ms;
    }
    if (uniq > 0) {
      const bool bad =
          active && abs(d - best) > 1 &&
          __fmul_rn(0.5f * (float)S, (float)(100 - uniq)) <
              __fmul_rn(0.5f * (float)ms, 100.0f);
      if (__any_sync(kFull, bad) && lane == 0) bad_row[x] = 1;
    }
    if (d == D - 1) {
      int* slot = ring + x % D;
      bestr_row[x] = (int16_t)(*slot % D);
      *slot = INT_MAX;
    }
    buf ^= 1;
  }
  __syncthreads();
  for (int x = d; x < W; x += Dp) {
    const int b = best_row[x], ms = min_s[x], sm = s_m[x], sp = s_p[x];
    const int denom = sm + sp - 2 * ms;
    float frac = 0.0f;
    if (b > 0 && b < D - 1 && denom > 0)
      frac = (float)(sm - sp) / fmaxf(2.0f * (float)denom, 1e-9f);
    frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    const float df = ((float)b + frac) + (float)min_disp;
    const int disp = (int)rintf(df * 16.0f);
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

}  // namespace

extern "C" {

int ovo_cost_hsweep(const float* lp, const float* rp, int16_t* C,
                    int32_t* s1, int H, int W, int D, int min_disp,
                    int radius, int sentinel, int P1, int P2, int bf16,
                    void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || radius < 0)
    return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const size_t smem =
      sizeof(int) * ((2 * radius + 1) * Dp + 2 * (Dp + 2) + 64);
  const void* kernel = bf16 ? (const void*)cost_hsweep_kernel<true>
                            : (const void*)cost_hsweep_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  if (bf16)
    cost_hsweep_kernel<true><<<H, Dp, smem, (cudaStream_t)stream>>>(
        lp, rp, C, s1, H, W, D, min_disp, radius, sentinel, P1, P2);
  else
    cost_hsweep_kernel<false><<<H, Dp, smem, (cudaStream_t)stream>>>(
        lp, rp, C, s1, H, W, D, min_disp, radius, sentinel, P1, P2);
  return (int)cudaGetLastError();
}

int ovo_vsweep(const void* C, int c_bytes, int32_t* sv, int H, int W, int D,
               int P1, int P2, int diagonals, int down, int up,
               void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || !(down || up) ||
      (c_bytes != 2 && c_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const size_t smem = sizeof(int) * (2 * (Dp + 2) + 64);
  const int per_way = W + (diagonals ? 2 * (W + H - 1) : 0);
  const int blocks = per_way * ((down ? 1 : 0) + (up ? 1 : 0));
  if (c_bytes == 2)
    vsweep_kernel<int16_t><<<blocks, Dp, smem, (cudaStream_t)stream>>>(
        (const int16_t*)C, sv, H, W, D, P1, P2, diagonals, down);
  else
    vsweep_kernel<int32_t><<<blocks, Dp, smem, (cudaStream_t)stream>>>(
        (const int32_t*)C, sv, H, W, D, P1, P2, diagonals, down);
  return (int)cudaGetLastError();
}

int ovo_hsweep(const int32_t* C, const int32_t* acc, int32_t* out, int H,
               int W, int D, int P1, int P2, int reverse, void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const size_t smem = sizeof(int) * (2 * (Dp + 2) + 64);
  hsweep_kernel<<<H, Dp, smem, (cudaStream_t)stream>>>(C, acc, out, H, W, D,
                                                       P1, P2, reverse);
  return (int)cudaGetLastError();
}

int ovo_hsweep_wta_lr(const void* C, int c_bytes, const int32_t* s1,
                      const int32_t* sv, int16_t* disp16, int H, int W,
                      int D, int P1, int P2, int min_disp, int uniq,
                      int disp12, void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || (c_bytes != 2 && c_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const size_t smem = sizeof(int) * (2 * (Dp + 2) + 128 + D + 3 * (size_t)W) +
                      sizeof(int16_t) * 2 * (size_t)W + (size_t)W;
  const void* kernel = c_bytes == 2
                           ? (const void*)hsweep_wta_lr_kernel<int16_t>
                           : (const void*)hsweep_wta_lr_kernel<int32_t>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  if (c_bytes == 2)
    hsweep_wta_lr_kernel<int16_t><<<H, Dp, smem, (cudaStream_t)stream>>>(
        (const int16_t*)C, s1, sv, disp16, H, W, D, P1, P2, min_disp, uniq,
        disp12);
  else
    hsweep_wta_lr_kernel<int32_t><<<H, Dp, smem, (cudaStream_t)stream>>>(
        (const int32_t*)C, s1, sv, disp16, H, W, D, P1, P2, min_disp, uniq,
        disp12);
  return (int)cudaGetLastError();
}

}  // extern "C"
