// H6: ORB's pyramid levels 1.. from level 0 in one launch, the two
// contractions of each level's antialiased linear resize
// (jax.image.resize) in one fixed order, that of the plain version
// ops/image.resize_levels_plain:
//
//   mid(i, c) = the chain over the row taps t = 0 .. rn[i]-1 of
//               fma(rw[i][t], img[r0[i] + t][c], acc), from acc = 0;
//   out(i, j) = the chain over the column taps t = 0 .. cn[j]-1 of
//               fma(cw[j][t], mid(i, c0[j] + t), acc), from acc = 0.
//
// The rows' chain is XLA:CPU's order for its first product; both chains
// round once per step (fmaf), so the card gives the plain version's bits.
// A thread computes one output pixel, recomputing the mid values of its
// column taps: the taps are few (2-10), and the level-0 rows it reads are
// shared through L1 by the warp's neighbouring pixels.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

struct Level {
  int oh, ow;        // the level's size
  int row0, col0;    // its first output row / column in the tap tables
};

struct Levels {
  Level l[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads) resize_levels_kernel(
    const float* __restrict__ img, int H, int W, const int* __restrict__ r0,
    const int* __restrict__ rn, const float* __restrict__ rw,
    const int* __restrict__ c0, const int* __restrict__ cn,
    const float* __restrict__ cw, int taps, Levels lv, int nl,
    float* __restrict__ stack) {
  const Level L = lv.l[blockIdx.y];
  const int hh = min(L.oh, H), ww = min(L.ow, W);
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)hh * ww) return;
  const int i = (int)(p / ww), j = (int)(p % ww);
  const float* x = img + (size_t)blockIdx.z * H * W;
  const int ri = L.row0 + i, cj = L.col0 + j;
  const int rs = r0[ri], rcount = rn[ri], cs = c0[cj], ccount = cn[cj];
  const float* wr = rw + (size_t)ri * taps;
  const float* wc = cw + (size_t)cj * taps;
  float acc = 0.f;
  for (int t = 0; t < ccount; ++t) {
    const float* col = x + cs + t;
    float mid = 0.f;
    for (int u = 0; u < rcount; ++u)
      mid = __fmaf_rn(wr[u], col[(size_t)(rs + u) * W], mid);
    acc = __fmaf_rn(wc[t], mid, acc);
  }
  stack[(((size_t)blockIdx.z * nl + blockIdx.y + 1) * H + i) * W + j] = acc;
}

}  // namespace

// img (frames, H, W); the tap tables of every level after the first,
// concatenated: rows (r0, rn, rw) and columns (c0, cn, cw), `taps` weights
// an output; sizes (oh, ow) a level; stack (frames, nl, H, W), written at
// [:, 1:, :min(oh, H), :min(ow, W)].
extern "C" int ovo_resize_levels(const float* img, int H, int W,
                                 const int* r0, const int* rn,
                                 const float* rw, const int* c0,
                                 const int* cn, const float* cw, int taps,
                                 const int* sizes, int nl, float* stack,
                                 int frames, void* stream) {
  if (nl < 2 || nl - 1 > kMaxLevels || frames <= 0 || frames > 65535 ||
      H <= 0 || W <= 0 || taps <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  long long most = 0;
  int row0 = 0, col0 = 0;
  for (int l = 0; l < nl - 1; ++l) {
    const int oh = sizes[2 * l], ow = sizes[2 * l + 1];
    lv.l[l] = Level{oh, ow, row0, col0};
    row0 += oh;
    col0 += ow;
    const long long n = (long long)(oh < H ? oh : H) * (ow < W ? ow : W);
    most = n > most ? n : most;
  }
  const long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, nl - 1, frames);
  resize_levels_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, H, W, r0, rn, rw, c0, cn, cw, taps, lv, nl, stack);
  return (int)cudaGetLastError();
}
