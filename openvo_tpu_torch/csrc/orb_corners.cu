// H9: ORB's per-pixel detection stages over the pyramid stack in one
// launch, bound with ctypes (openvo_tpu_torch/ops/orb_cuda.py holds the
// wrapper; the plain version is ops/orb.corner_keys_plain).
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
// One block of 256 threads per (32x32 output tile, level, frame):
//   1. the tile and a 4-pixel halo (40x40) of the canvas go to shared
//      memory;
//   2. FAST scores on the 34x34 around the tile (the NMS reads one more
//      pixel each way), -inf outside the canvas;
//   3. Sobel dx, dy on the 38x38 around it and their three products, 0
//      outside the canvas (the box sum's zero padding);
//   4. the 7 horizontal taps of each product, 38 rows x 32 columns;
//   5. per output pixel: the 7 vertical taps, Harris, the tests, the keys.
// A tile wholly outside its level's border box writes -inf and reads
// nothing. The paddings are those of the plain version, all at the
// canvas's edge, not the level's: replicate for FAST, reflect-101 for
// Sobel, zero for the box sums, -inf for the NMS.
//
// Bound: bytes. It reads the stack once (14.9 MB a KITTI frame) and
// writes key (and fkey) once; about 270 float operations a pixel inside
// the levels' border boxes cost less than the bytes at 67 TFLOP/s. The
// halo re-reads 1.56x the tile's pixels, from L2.
//
// Bit-exactness with the plain version (torch on the CPU, which rounds
// every product and sum on its own, and ops/image.fma where XLA fuses a
// multiply-add): every product and sum is an intrinsic, which nvcc never
// contracts into an FMA, and the sums run in the plain version's order.
// emu_fma(a, b, c) is the float64 product plus the float64 c, rounded
// once to float32, as ops/image.fma (not fmaf).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 4;                // FAST's 3 + the NMS's 1
constexpr int kIn = kTile + 2 * kHalo;  // 40: the image tile
constexpr int kScore = kTile + 2;       // 34: scores, for the NMS
constexpr int kProd = kTile + 6;        // 38: Sobel products, for the box
constexpr int kBox = 7;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels];
};

// FAST's circle of radius 3, (dx, dy) in circular order (orb.FAST_CIRCLE)
__constant__ int kCircleX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                 3, 3, 2, 1, 0, -1, -2, -3};

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

__global__ void __launch_bounds__(kThreads) corner_keys_kernel(
    const float* __restrict__ stack, int H, int W, int nl, Levels lv,
    const uint8_t* __restrict__ mask, const int* __restrict__ rows,
    const int* __restrict__ cols, int edge, float threshold,
    float* __restrict__ key, float* __restrict__ fkey, int tiles_x) {
  __shared__ float img[kIn][kIn + 1];
  __shared__ float score[kScore][kScore + 1];
  __shared__ float pxx[kProd][kProd + 1], pyy[kProd][kProd + 1],
      pxy[kProd][kProd + 1];
  __shared__ float hxx[kProd][kTile + 1], hyy[kProd][kTile + 1],
      hxy[kProd][kTile + 1];
  const int l = blockIdx.y, f = blockIdx.z, t = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const size_t plane = ((size_t)f * nl + l) * H * W;
  const float* src = stack + plane;
  float* kout = key + plane;
  float* fout = fkey == nullptr ? nullptr : fkey + plane;
  const float neg_inf = -INFINITY;

  // the level's border box, cut to the canvas
  const int y_lo = edge, y_hi = min(lv.h[l] - edge, H);
  const int x_lo = edge, x_hi = min(lv.w[l] - edge, W);
  if (y_lo >= y_hi || x_lo >= x_hi || ty0 >= y_hi || ty0 + kTile <= y_lo ||
      tx0 >= x_hi || tx0 + kTile <= x_lo) {
    for (int i = t; i < kTile * kTile; i += kThreads) {
      const int y = ty0 + i / kTile, x = tx0 + i % kTile;
      if (y < H && x < W) {
        kout[(size_t)y * W + x] = neg_inf;
        if (fout != nullptr) fout[(size_t)y * W + x] = neg_inf;
      }
    }
    return;
  }

  // 1. the canvas at rows oy.., columns ox.. (0 outside it, never read)
  const int oy = ty0 - kHalo, ox = tx0 - kHalo;
  for (int i = t; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, c = i % kIn, y = oy + r, x = ox + c;
    img[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? __ldg(src + (size_t)y * W + x)
                    : 0.f;
  }
  __syncthreads();

  // 2. FAST: bright = n - img, dark = img - n over the 16 neighbours,
  // replicated at the canvas's edge; -inf outside the canvas (the NMS's
  // padding)
  for (int i = t; i < kScore * kScore; i += kThreads) {
    const int r = i / kScore, c = i % kScore;
    const int y = ty0 - 1 + r, x = tx0 - 1 + c;
    float s = neg_inf;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float v = img[y - oy][x - ox];
      float bright[16], dark[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float n = img[clampi(y + kCircleY[k], 0, H - 1) - oy]
                           [clampi(x + kCircleX[k], 0, W - 1) - ox];
        bright[k] = __fsub_rn(n, v);
        dark[k] = __fsub_rn(v, n);
      }
      s = fmaxf(arc_score(bright), arc_score(dark));
    }
    score[r][c] = s;
  }

  // 3. Sobel with reflect-101 at the canvas's edge:
  // dx = ((a + 2b) + c) - ((d + 2e) + f) over the right and left columns,
  // dy the same over the lower and upper rows; the products rounded; 0
  // outside the canvas
  for (int i = t; i < kProd * kProd; i += kThreads) {
    const int r = i / kProd, c = i % kProd;
    const int y = ty0 - 3 + r, x = tx0 - 3 + c;
    float vxx = 0.f, vyy = 0.f, vxy = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int ym = reflect101(y - 1, H) - oy, yc = y - oy,
                yp = reflect101(y + 1, H) - oy;
      const int xm = reflect101(x - 1, W) - ox, xc = x - ox,
                xp = reflect101(x + 1, W) - ox;
      const float dx = __fsub_rn(
          __fadd_rn(__fadd_rn(img[ym][xp], __fmul_rn(2.f, img[yc][xp])),
                    img[yp][xp]),
          __fadd_rn(__fadd_rn(img[ym][xm], __fmul_rn(2.f, img[yc][xm])),
                    img[yp][xm]));
      const float dy = __fsub_rn(
          __fadd_rn(__fadd_rn(img[yp][xm], __fmul_rn(2.f, img[yp][xc])),
                    img[yp][xp]),
          __fadd_rn(__fadd_rn(img[ym][xm], __fmul_rn(2.f, img[ym][xc])),
                    img[ym][xp]));
      vxx = __fmul_rn(dx, dx);
      vyy = __fmul_rn(dy, dy);
      vxy = __fmul_rn(dx, dy);
    }
    pxx[r][c] = vxx;
    pyy[r][c] = vyy;
    pxy[r][c] = vxy;
  }
  __syncthreads();

  // 4. the box's horizontal taps, left to right from the first tap
  for (int i = t; i < kProd * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    float a = pxx[r][c], b = pyy[r][c], d = pxy[r][c];
#pragma unroll
    for (int k = 1; k < kBox; ++k) {
      a = __fadd_rn(a, pxx[r][c + k]);
      b = __fadd_rn(b, pyy[r][c + k]);
      d = __fadd_rn(d, pxy[r][c + k]);
    }
    hxx[r][c] = a;
    hyy[r][c] = b;
    hxy[r][c] = d;
  }
  __syncthreads();

  // 5. each output pixel: the tests, then (at a corner) the vertical taps
  // and Harris: det = fma(sxx, syy, -(sxy * sxy)), tr = sxx + syy,
  // resp = fma(-(0.04 * tr), tr, det)
  const uint8_t* m0 = mask == nullptr ? nullptr : mask + (size_t)f * H * W;
  for (int i = t; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = ty0 + r, x = tx0 + c;
    if (y >= H || x >= W) continue;
    const float s = score[r + 1][c + 1];
    float mx = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[r + dy][c + dx]);
    bool corner = s > threshold && s >= mx && y >= y_lo && y < y_hi &&
                  x >= x_lo && x < x_hi;
    if (corner && m0 != nullptr) {
      const int yi = rows[l * H + y], xi = cols[l * W + x];
      corner = yi >= 0 && xi >= 0 && m0[(size_t)yi * W + xi] != 0;
    }
    float k = neg_inf;
    if (corner) {
      float sxx = hxx[r][c], syy = hyy[r][c], sxy = hxy[r][c];
#pragma unroll
      for (int j = 1; j < kBox; ++j) {
        sxx = __fadd_rn(sxx, hxx[r + j][c]);
        syy = __fadd_rn(syy, hyy[r + j][c]);
        sxy = __fadd_rn(sxy, hxy[r + j][c]);
      }
      const float det = emu_fma(sxx, syy, -__fmul_rn(sxy, sxy));
      const float tr = __fadd_rn(sxx, syy);
      const float ktr = __fmul_rn(0.04f, tr);
      k = emu_fma(-ktr, tr, det);
    }
    kout[(size_t)y * W + x] = k;
    if (fout != nullptr) fout[(size_t)y * W + x] = corner ? s : neg_inf;
  }
}

}  // namespace

// stack (frames, nl, H, W); sizes (h, w) a level (host); mask (frames, H,
// W) bytes, rows (nl, H) and cols (nl, W), all three NULL or none; key and
// fkey (frames, nl, H, W), fkey NULL unless wanted.
extern "C" int ovo_corner_keys(const float* stack, int H, int W, int nl,
                               const int* sizes, const uint8_t* mask,
                               const int* rows, const int* cols, int edge,
                               float threshold, float* key, float* fkey,
                               int frames, void* stream) {
  if (nl <= 0 || nl > kMaxLevels || H < 2 || W < 2 || frames <= 0 ||
      frames > 65535 || (mask == nullptr) != (rows == nullptr) ||
      (mask == nullptr) != (cols == nullptr))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < nl; ++l) {
    lv.h[l] = sizes[2 * l];
    lv.w[l] = sizes[2 * l + 1];
  }
  const int tiles_x = (W + kTile - 1) / kTile;
  const long long tiles = (long long)tiles_x * ((H + kTile - 1) / kTile);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, nl, frames);
  corner_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      stack, H, W, nl, lv, mask, rows, cols, edge, threshold, key, fkey,
      tiles_x);
  return (int)cudaGetLastError();
}
