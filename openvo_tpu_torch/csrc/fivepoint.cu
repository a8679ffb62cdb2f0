// The five-point solver's root stage for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/fivepoint_cuda.py holds the wrapper; the plain
// version is pose/fivepoint.five_point_roots_plain).
//
//   H12 five_point_roots <- Nister's solver after the elimination:
//   _real_roots' fori_loop (openvo_tpu/pose/fivepoint.py:112-195) and the
//   back-substitution (:217-240), left to XLA
//
// From the eliminated system M (S, 10, 10) and the null-space basis X, Y,
// Z, W (S, 4, 3, 3) to the candidates E (S, 10, 3, 3) at unit Frobenius
// norm and their validity (S, 10). A block of 256 threads a sample (S is
// 64 in the mono step, at least 16 for any sample count), every stage in
// registers and shared memory:
//
// 1. B(z) (3, 3, 5), entry by entry a difference of two entries of M (or
//    of a zero), as pose/fivepoint._z_index lays them out;
// 2. the three 2x2 minors of rows 1, 2 and the cofactor expansion along
//    row 0, each coefficient a convolution's chain of products over the
//    zero-padded factors (_conv), a thread a coefficient; n(z), degree 12,
//    scaled by its largest |coefficient| + 1e-30;
// 3. the scan: thread i evaluates q(theta) = sum_i c_i sin^i cos^(12-i) at
//    grid points i and i + 256 of the 512-point theta grid (built as numpy
//    builds _theta_grid); a cell is a sign change where the product of its
//    ends is negative; 16 ballots hold the 511 cells, and popc and bit
//    scans give the first ten sign-change cells in ascending order, the
//    slots beyond them the lowest other cells, marked invalid (the plain
//    version's stable sort);
// 4. 48 bisection steps of the ten slots at once: threads 0-9 hold a
//    slot's (lo, hi, q(lo)) and put its midpoint's sine and cosine in
//    shared memory; threads 0-129 each compute one of the ten q(mid)'s 130
//    terms; thread j adds slot j's 13 terms as ATen's sum does;
// 5. thread j: z = tan of the last midpoint, B(z) by its 5 powers, the
//    three cross products of its rows, the one with the largest |v_3| (the
//    first on ties, NaN first, as argmax), x and y, E, its norm and
//    validity.
//
// Bound by latency, not by bytes (0.9 KB a sample) or operations: the 48
// bisection steps run in turn, each a sine and cosine, then two powf (about
// a hundred instructions each) and a 13-term sum, behind two block
// barriers. So a thread computes one term a step, and the scan two grid
// points.
//
// Bit-equal to the plain version on the card, and so to the benchmark's
// frozen reference of it: every operation is a correctly rounded intrinsic
// in the order of the ATen or cuBLAS kernel that the plain version runs
// there (found by matching their bits on the card): the elementwise steps
// one rounding each; q's 13-term sum and the Frobenius norm's 9 squares as
// ATen's reduction adds them (aten_sum8); B(z) at a root as einsum's batched
// product, fused multiply-adds over the powers from 0 (cuBLAS's kernel for
// 16 samples and more; for one sample it takes another order); the cross
// products as torch.linalg.cross's kernel contracts them; argmax's ties and
// NaN; and sinf, cosf, powf, tanf and sqrtf, the precise functions ATen's
// kernels call. powf's exponents pass through an opaque move, so the
// compiler cannot rewrite a constant power (x * x for 2) where ATen's
// kernel reads its exponent at run time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // a block a sample
constexpr int kWarps = kThreads / 32;
constexpr int kGrid = 512;           // theta grid points
constexpr int kCells = kGrid - 1;
constexpr int kWords = kGrid / 32;   // ballot words over the cells
constexpr int kBisect = 48;
constexpr int kRoots = 10;
constexpr int kDeg = 12;             // n(z)'s padded degree
constexpr int kTerms = kDeg + 1;
constexpr int kZero = 100;           // the zero after M's 100 entries
constexpr unsigned kFull = 0xffffffffu;
// the grid's ends, as numpy rounds them: float32(-pi/2 + 1e-4), float32(pi/2
// - 1e-4)
constexpr float kThetaLo = (float)(-3.141592653589793 / 2 + 1e-4);
constexpr float kThetaHi = (float)(3.141592653589793 / 2 - 1e-4);

struct Smem {
  float m[kZero + 1];           // M's entries, then 0
  float basis[36];              // X, Y, Z, W, row-major
  float b[45];                  // B(z): [row][col][z power]
  float minors[27];             // [col pair][z power 0..8]
  float t[39];                  // row 0's cofactor terms [col][0..12]
  float c[kTerms];              // n(z) / (max |n_i| + 1e-30)
  float qs[kGrid];              // q at the grid
  unsigned words[kWords];       // the sign-change cells' ballots
  float sin_mid[kRoots], cos_mid[kRoots];   // a bisection step's midpoints
  float terms[kRoots * kTerms];  // a bisection step's terms [slot][i]
};

__device__ __forceinline__ float opaque(float x) {
  asm("mov.f32 %0, %0;" : "+f"(x));
  return x;
}

// B[r][c][p] = m[za] - m[zb]: rows <e> - z<f>, <g> - z<h>, <i> - z<j>
// from M's rows (4, 5), (6, 7), (8, 9); column groups (2, 1, 0),
// (5, 4, 3), (9, 8, 7, 6) of M's columns (pose/fivepoint._z_index)
__device__ __forceinline__ void z_pair(int e, int& za, int& zb) {
  const int r = e / 15, c = (e / 5) % 3, p = e % 5;
  const int len = c == 2 ? 4 : 3;
  const int k0 = c == 0 ? 2 : c == 1 ? 5 : 9;   // column k_p = k0 - p
  za = p < len ? 10 * (4 + 2 * r) + (k0 - p) : kZero;
  zb = p > 0 && p <= len ? 10 * (5 + 2 * r) + (k0 - (p - 1)) : kZero;
}

// a[i - (m - 1)] inside a, 0 in the padding on either side
__device__ __forceinline__ float padded(const float* a, int n, int m, int i) {
  const int k = i - (m - 1);
  return k >= 0 && k < n ? a[k] : 0.0f;
}

// coefficient j of _conv(a, v), len(a) = n >= len(v) = m: the padded a's
// taps against v reversed, added tap by tap
__device__ __forceinline__ float conv_at(const float* a, int n,
                                         const float* v, int m, int j) {
  float acc = __fmul_rn(padded(a, n, m, j), v[m - 1]);
  for (int k = 1; k < m; ++k)
    acc = __fadd_rn(acc, __fmul_rn(padded(a, n, m, j + k), v[m - 1 - k]));
  return acc;
}

// theta at grid point g: lo (1 - h) + hi h, h = g / 511, the last point hi
__device__ __forceinline__ float theta_at(int g) {
  if (g >= kGrid - 1) return kThetaHi;
  const float h = __fdiv_rn((float)g, (float)(kGrid - 1));
  return __fadd_rn(__fmul_rn(kThetaLo, __fsub_rn(1.0f, h)),
                   __fmul_rn(kThetaHi, h));
}

// term i of q: (c_i sin^i) cos^(12 - i)
__device__ __forceinline__ float q_term(float ci, float s, float co, int i) {
  return __fmul_rn(__fmul_rn(ci, powf(s, opaque((float)i))),
                   powf(co, opaque((float)(kDeg - i))));
}

// ATen's sum over the last axis of 8 to 15 contiguous floats on the card
// (ATen/native/cuda/Reduce.cuh): 8 lanes, lane l adding elements l and l + 8
// to zeros, then the lanes' shuffle tree with offsets 4, 2, 1
template <int N>
__device__ __forceinline__ float aten_sum8(const float* x) {
  static_assert(N >= 8 && N < 16, "ATen reduces 8 to 15 elements on 8 lanes");
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    v[l] = l + 8 < N ? __fadd_rn(__fadd_rn(0.0f, x[l]), __fadd_rn(0.0f, x[l + 8]))
                     : __fadd_rn(0.0f, x[l]);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int l = 0; l < off; ++l) v[l] = __fadd_rn(v[l], v[l + off]);
  return v[0];
}

__device__ __forceinline__ float q_at(const float* c, float theta) {
  const float s = sinf(theta), co = cosf(theta);
  float terms[kTerms];
#pragma unroll
  for (int i = 0; i < kTerms; ++i) terms[i] = q_term(c[i], s, co, i);
  return aten_sum8<kTerms>(terms);
}

// a x b as torch.linalg.cross's kernel computes it on the card: each entry
// a fused multiply-add of the first product less the second, rounded
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

__global__ void __launch_bounds__(kThreads)
    five_point_roots_kernel(const float* __restrict__ M,
                            const float* __restrict__ basis,
                            float* __restrict__ Es, uint8_t* __restrict__ valid) {
  __shared__ Smem w;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long s = blockIdx.x;

  // 1. M and the basis in, then B(z)
  if (t < 100) w.m[t] = M[s * 100 + t];
  if (t == 100) w.m[kZero] = 0.0f;
  if (t < 36) w.basis[t] = basis[s * 36 + t];
  __syncthreads();
  if (t < 45) {
    int za, zb;
    z_pair(t, za, zb);
    w.b[t] = __fsub_rn(w.m[za], w.m[zb]);
  }
  __syncthreads();

  // 2. det B(z): the minors of rows 1, 2 against the column pairs (1, 2),
  // (0, 2), (0, 1), then row 0's cofactors, n = t0 - t1 + t2
  if (t < 27) {
    const int k = t / 9, j = t % 9;
    const int c0 = k == 0 ? 1 : 0, c1 = k == 2 ? 1 : 2;
    const float* r1 = w.b + 15;
    const float* r2 = w.b + 30;
    w.minors[t] = __fsub_rn(conv_at(r1 + 5 * c0, 5, r2 + 5 * c1, 5, j),
                            conv_at(r1 + 5 * c1, 5, r2 + 5 * c0, 5, j));
  }
  __syncthreads();
  if (t < 39) w.t[t] = conv_at(w.minors + 9 * (t / 13), 9,
                               w.b + 5 * (t / 13), 5, t % 13);
  __syncthreads();
  float c[kTerms];
  {
    float n[kTerms];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kTerms; ++i) {
      n[i] = __fadd_rn(__fsub_rn(w.t[i], w.t[13 + i]), w.t[26 + i]);
      const float a = fabsf(n[i]);
      amax = (isnan(a) || a > amax) ? a : amax;   // amax: NaN wins
    }
    const float scale = __fadd_rn(amax, 1e-30f);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) {
      c[i] = __fdiv_rn(n[i], scale);
      if (t == 0) w.c[i] = c[i];
    }
  }

  // 3. the scan and its ballots: warp v's 64 cells in two words
  for (int g = t; g < kGrid; g += kThreads) w.qs[g] = q_at(c, theta_at(g));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWords / kWarps; ++k) {
    const int word = warp * (kWords / kWarps) + k;
    const int cell = 32 * word + lane;
    const unsigned bits = __ballot_sync(
        kFull, cell < kCells && __fmul_rn(w.qs[cell], w.qs[cell + 1]) < 0.0f);
    if (lane == 0) w.words[word] = bits;
  }
  __syncthreads();

  // slot t (threads 0-9): the t-th sign-change cell, else the (t - n_sc)-th
  // other cell
  int n_sc = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) n_sc += __popc(w.words[k]);
  const bool slot_sc = t < n_sc;
  int cell = 0;
  if (t < kRoots) {
    int want = slot_sc ? t : t - n_sc;
    for (int k = 0; k < kWords; ++k) {
      unsigned m = slot_sc ? w.words[k] : ~w.words[k];
      if (k == kWords - 1) m &= 0x7fffffffu;   // cell 511 does not exist
      const int cnt = __popc(m);
      if (want < cnt) {
        for (int i = 0; i < want; ++i) m &= m - 1;
        cell = 32 * k + __ffs(m) - 1;
        break;
      }
      want -= cnt;
    }
  }

  // 4. bisection: threads 0-9 hold the slots, thread t < 130 term t % 13 of
  // slot t / 13
  float lo = theta_at(cell), hi = theta_at(cell + 1), qlo = w.qs[cell];
  float mid = 0.0f;
  const int slot = t / kTerms, term = t % kTerms;
  for (int step = 0; step < kBisect; ++step) {
    if (t < kRoots) {
      mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      w.sin_mid[t] = sinf(mid);
      w.cos_mid[t] = cosf(mid);
    }
    __syncthreads();
    if (t < kRoots * kTerms)
      w.terms[t] = q_term(w.c[term], w.sin_mid[slot], w.cos_mid[slot], term);
    __syncthreads();
    if (t < kRoots) {
      const float qm = aten_sum8<kTerms>(w.terms + kTerms * t);
      const bool same = __fmul_rn(qm, qlo) > 0.0f;
      lo = same ? mid : lo;
      hi = same ? hi : mid;
      qlo = same ? qm : qlo;
    }
  }
  if (t >= kRoots) return;

  // 5. back-substitution
  const float z = tanf(__fmul_rn(0.5f, __fadd_rn(lo, hi)));
  float zp[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) zp[p] = powf(z, opaque((float)p));
  float bz[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      // einsum's batched product (cuBLAS): fused multiply-adds over the
      // powers in order, from 0
      const float* bp = w.b + 15 * r + 5 * col;
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < 5; ++p) acc = __fmaf_rn(bp[p], zp[p], acc);
      bz[r][col] = acc;
    }
  float cands[3][3];
  cross3(bz[0], bz[1], cands[0]);
  cross3(bz[0], bz[2], cands[1]);
  cross3(bz[1], bz[2], cands[2]);
  int pick = 0;
  float best = fabsf(cands[0][2]);
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const float a = fabsf(cands[i][2]);
    if (!isnan(best) && (isnan(a) || a > best)) {
      pick = i;
      best = a;
    }
  }
  const float v0 = cands[pick][0], v1 = cands[pick][1], v2 = cands[pick][2];
  const bool ok_w = fabsf(v2) > 1e-12f;
  const float w_safe = ok_w ? v2 : 1.0f;
  const float x = __fdiv_rn(v0, w_safe), y = __fdiv_rn(v1, w_safe);
  float e[9], sq[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    e[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, w.basis[k]),
                                         __fmul_rn(y, w.basis[9 + k])),
                               __fmul_rn(z, w.basis[18 + k])),
                     w.basis[27 + k]);
    sq[k] = __fmul_rn(e[k], e[k]);
  }
  // vector_norm: the squares summed as ATen's sum, then the square root
  const float fro = __fsqrt_rn(aten_sum8<9>(sq));
  const float div = isnan(fro) ? fro : fmaxf(fro, 1e-12f);
  bool finite = true;
  float* out = Es + (s * kRoots + t) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float v = __fdiv_rn(e[k], div);
    finite = finite && isfinite(v);
    out[k] = v;
  }
  valid[s * kRoots + t] = slot_sc && ok_w && finite;
}

}  // namespace

// M (S, 10, 10), basis (S, 4, 3, 3) float32 -> Es (S, 10, 3, 3) float32,
// valid (S, 10) bool
extern "C" int ovo_five_point_roots(const float* M, const float* basis,
                                    float* Es, uint8_t* valid, int S,
                                    void* stream) {
  if (S < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  five_point_roots_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
      M, basis, Es, valid);
  return (int)cudaGetLastError();
}
