// Steered-BRIEF descriptor kernel for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/orb_cuda.py holds the wrapper and the plain
// version).
//
//   H4 brief_describe <- orb_pallas.brief_sample_t (K5), with the window
//   gather, the 7-tap blur and the GET_VALUE rotation that the JAX package
//   ran around it in XLA (openvo_tpu/ops/orb.py:529-555, :320-353)
//
// From the pyramid level to the packed descriptor in one launch. One block
// of 256 threads per keypoint:
//   1. the 45x45 raw window at (x - 22, y - 22) of its level goes to shared
//      memory (starts clamped into the stack as lax.dynamic_slice clamps);
//   2. the separable 7-tap sigma-2 blur, rows first (45x39), then columns
//      (39x39, over the raw window's space), rounded half to even;
//   3. thread j rotates pair j of the rBRIEF pattern with GET_VALUE
//      rounding, compares its two samples, and each warp packs its 32 bits
//      with one ballot into a 32-bit word: four bytes LSB first in
//      little-endian memory, the layout of hamming.pack_bits and of cv2.
// An invalid keypoint writes a zero row and reads nothing. A batch of
// frames is one launch: keypoint k of the batch reads frame k / kpf's
// stack (kpf keypoints a frame), and nothing else changes.
//
// Bound: the raw windows' bytes (8.1 KB a keypoint, 4.1 MB at K = 512,
// about 1.2 us at 3.35 TB/s); at this size the launch dominates. The loads
// are 4-byte and read-only: a window row starts at any 4-byte offset, and
// a level's pitch (W * 4 bytes) need not be a multiple of 16, so neither
// 16-byte vector loads, cp.async.bulk nor a TMA tensor map fits the stack.
//
// Bit-exactness with the plain version (XLA:CPU's fused multiply-adds as
// ops/image.fma emulates them): every product and sum is an intrinsic,
// which nvcc never contracts into an FMA. emu_fma(a, b, c) is the float64
// product plus the float64 c, rounded once to float32 (not fmaf, which
// differs where the float64 sum lies on a float32 tie). cos and sin come in
// as inputs computed by torch, so no device math library is involved.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaw = 45;      // raw window side: 2 * (19 + 3) + 1
constexpr int kWin = 39;      // blurred BRIEF window side: 2 * 19 + 1
constexpr int kRad = 22;      // raw window radius
constexpr int kPairs = 256;   // rBRIEF tests, one thread each
constexpr int kTaps = 7;

__device__ __forceinline__ float emu_fma(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// fma(k0, t0, k1 * t1), then fma(k_i, t_i, acc) for i = 2..6: the order of
// the plain version's blur (XLA's fusion of the JAX package's sum).
__device__ __forceinline__ float blur7(const float* t, int step,
                                       const float* k) {
  float acc = emu_fma(k[0], t[0], __fmul_rn(k[1], t[step]));
#pragma unroll
  for (int i = 2; i < kTaps; ++i) acc = emu_fma(k[i], t[i * step], acc);
  return acc;
}

__device__ __forceinline__ int clampi(long long v, long long lo,
                                      long long hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

struct Taps {
  float k[kTaps];
};

__global__ void __launch_bounds__(kPairs)
    brief_describe_kernel(const float* __restrict__ stack, int nl, int H,
                          int W, const int64_t* __restrict__ octave,
                          const int64_t* __restrict__ xy,
                          const float* __restrict__ cos_a,
                          const float* __restrict__ sin_a,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ pattern, Taps taps,
                          uint32_t* __restrict__ out, int kpf) {
  __shared__ float raw[kRaw * kRaw];   // raw window, then the blurred one
  __shared__ float hp[kRaw * kWin];    // rows blurred
  const int k = blockIdx.x, t = threadIdx.x;
  uint32_t* row_out = out + (size_t)k * (kPairs / 32);
  if (!valid[k]) {
    if (t < kPairs / 32) row_out[t] = 0u;
    return;
  }
  const int lv = clampi(octave[k], 0, nl - 1);
  const int y0 = clampi(xy[2 * k + 1] - kRad, 0, H - kRaw);
  const int x0 = clampi(xy[2 * k] - kRad, 0, W - kRaw);
  const float* src =
      stack + (((size_t)(k / kpf) * nl + lv) * H + y0) * W + x0;
  for (int i = t; i < kRaw * kRaw; i += kPairs) {
    const int r = i / kRaw, c = i - r * kRaw;
    raw[i] = __ldg(src + (size_t)r * W + c);
  }
  // this thread's pair, fetched while the window lands
  const float4 pq = __ldg(reinterpret_cast<const float4*>(pattern) + t);
  const float ca = cos_a[k], sa = sin_a[k];
  __syncthreads();
  for (int i = t; i < kRaw * kWin; i += kPairs) {
    const int r = i / kWin, c = i - r * kWin;
    hp[i] = blur7(raw + r * kRaw + c, 1, taps.k);
  }
  __syncthreads();
  for (int i = t; i < kWin * kWin; i += kPairs) {
    const int r = i / kWin, c = i - r * kWin;
    raw[i] = rintf(blur7(hp + r * kWin + c, kWin, taps.k));
  }
  __syncthreads();
  // GET_VALUE: col = 19 + rint(x cos - y sin), row = 19 + rint(x sin +
  // y cos), each an fma over a float32 product. The clamp only guards
  // shared memory: cos and sin of one angle keep every pattern point
  // inside the window.
  const auto sample = [&](float x, float y) {
    const int col = kWin / 2 + (int)rintf(emu_fma(x, ca, -__fmul_rn(y, sa)));
    const int row = kWin / 2 + (int)rintf(emu_fma(x, sa, __fmul_rn(y, ca)));
    return raw[clampi(row, 0, kWin - 1) * kWin + clampi(col, 0, kWin - 1)];
  };
  const bool bit = sample(pq.x, pq.y) < sample(pq.z, pq.w);
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((t & 31) == 0) row_out[t >> 5] = word;
}

}  // namespace

extern "C" int ovo_brief_describe(const float* stack, int nl, int H, int W,
                                  const int64_t* octave, const int64_t* xy,
                                  const float* cos_a, const float* sin_a,
                                  const uint8_t* valid, const float* pattern,
                                  const float* taps, uint32_t* out, int K,
                                  int frames, void* stream) {
  // K keypoints a frame, `frames` stacks of (nl, H, W) one after another
  if (K < 0 || frames <= 0 || nl <= 0 || H < kRaw || W < kRaw ||
      (long long)K * frames > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  Taps tp;
  for (int i = 0; i < kTaps; ++i) tp.k[i] = taps[i];
  brief_describe_kernel<<<K * frames, kPairs, 0, (cudaStream_t)stream>>>(
      stack, nl, H, W, octave, xy, cos_a, sin_a, valid, pattern, tp, out, K);
  return (int)cudaGetLastError();
}
