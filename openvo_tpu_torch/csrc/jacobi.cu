// The pose fits' small SVDs for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/jacobi_cuda.py holds the wrappers; the plain
// versions are pose/kabsch.kabsch_fit_plain and
// pose/kabsch.jacobi_svd_plain).
//
//   H10 kabsch_fit <- the whole Kabsch fit, openvo_tpu/pose/kabsch.py:22-60
//   (its SVD jnp.linalg.svd, :49), left to XLA
//   H11 jacobi_svd <- the five-point null space, the refit and the
//   essential projection and recoverPose, jnp.linalg.svd
//   (openvo_tpu/pose/fivepoint.py:210; ransac.py:140, :142, :273), left to
//   XLA
//
// Both rest on one-sided (Hestenes) Jacobi: the columns of A over V (V
// starting as I) are rotated in pairs (p, q), p < q, by the rotation that
// zeroes their dot product g_pq,
//   d = g_qq - g_pp, t = 2 g_pq / (d + copysign(sqrt(d^2 + 4 g_pq^2), d))
//   (0 for 0/0), c = 1 / sqrt(1 + t^2), s = c t,
//   a_p <- c a_p - s a_q, a_q <- s a_p + c a_q.
// Every operation is a correctly rounded intrinsic in the plain version's
// order (no contraction into FMAs; every sum a left-to-right chain, or
// H10's fixed tree), so each matrix gets the plain version's bits, whatever
// the batch and however the work is spread over threads.
//
// H10, a block of kFitThreads threads a fit: the threads over the points
// take the valid count, the masked sums of src and dst in float64, then the
// 9 sums of the centred products X_k Y_l, each sum a fixed pairwise tree
// over the points padded to a power of two with -0.0 (element i plus
// element i + h, h halving; x + -0.0 = x, so a wider padding gives the same
// bits): a thread folds its own points t + k kFitThreads (the levels h >=
// kFitThreads) depth first, then shared memory and a warp's shuffles take
// the levels below. Then thread 0: the finite test, JACOBI_SWEEPS = 5
// cyclic sweeps over (0, 1), (0, 2), (1, 2) of H, no test, in registers;
// the least column shifted last cyclically (ties to the first index, as
// argmin), u_1 and u_2 the first two columns over their norms
// (V's column where a norm is 0), u_3 = u_1 x u_2; R = V U^T and t = mu_d -
// R mu_s as chains; T in float32, NaN where H is not finite (R, t) or fewer
// than 3 rows are valid (all of T). One launch replaces the fit's ~30.
//
// H11, a group of n lanes a matrix (several matrices a warp: ten 3x3, three
// 9x9 or 5x9), lane j holding column j of A over V in registers (loops
// unrolled for the shapes the port runs: 5x9 float32 rows, their 5x5 L,
// the 9x9 Gram, 3x3; one generic instance up to kMaxDim). A sweep is the
// round-robin order of pose/kabsch.jacobi_rounds: n rounded up to even n',
// n' - 1 rounds of n'/2 disjoint pairs rotated at once (9x9: 9 rounds of 4
// pairs; 3x3: (0, 1), (0, 2), (1, 2), the cyclic order). In a round the two
// lanes of a pair swap columns by shuffles and each computes g_pp, g_qq,
// g_pq, the skip test |g_pq| <= tol sqrt(g_pp g_qq) and (c, s) from the
// same bits, then updates its own column. A matrix whose sweep rotated
// nothing (a vote of its lanes) stops; the others after max_sweeps. Then
// each lane's column norm and its rank among the group's (greater, or NaN,
// or equal with a lower index: torch.sort's stable descending order) give
// S and V's column order, and, where m = n = 3, U as H10 makes it.
// A wide matrix (m < n, float32, the five-point solver's 5x9 rows) takes
// JAX's path on the CPU, LAPACK's sgesdd for n >= 11m/6: its LQ a = L
// Q[:m] by sgelq2 and sorgl2 in float32 with OpenBLAS's arithmetic (snrm2 in
// float64, sgemv a chain of fused multiply-adds, sger fused multiply-adds
// of -tau v_j, each emulated as ops/image.fma), lane r holding row r of R
// and then of Q: reflector i's norm and scaling on lane i, its row
// broadcast, every later row updated by its own lane. Then the sweeps on
// the m x m L, a lane a column, V = [Q[:m]^T V_L, Q[m:]^T]. So the null
// space comes in JAX's own float32 basis, bit for bit: the float32
// five-point solver's candidates depend on the basis (PERF.md section 6).
//
// Bound: neither moves bytes to speak of (H10 reads 28 B a point and writes
// 64 B a fit; H11 at most 648 B in, 1,384 B out a matrix) nor fills the
// card: a batch is 1 to 64 matrices or 1 to 16 fits, so the time is a chain
// of dependent operations: H11's a round (the three 9-term dot products,
// the test's and the rotation's square roots and divisions, the column's
// update) times rounds a sweep times sweeps; H10's the tree's log2 N levels
// and thread 0's ~1,000 operations of the 3x3 sweeps.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kSweeps3 = 5;      // pose/kabsch.JACOBI_SWEEPS
constexpr int kMaxDim = 9;       // ops/jacobi_cuda.MAX_DIM
constexpr int kFitThreads = 256;
constexpr int kFitMaxLogK = 6;   // 64 points a thread (MAX_FIT_POINTS)
constexpr int kSvdThreads = 32;  // a warp a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// torch.nan_to_num(x, nan=0.0): NaN -> 0, +-inf -> +-DBL_MAX
__device__ __forceinline__ double nan_to_num(double x) {
  if (isnan(x)) return 0.0;
  if (isinf(x)) return x > 0.0 ? DBL_MAX : -DBL_MAX;
  return x;
}

// (c, s) of the rotation that zeroes g_pq (pose/kabsch._rotate)
__device__ __forceinline__ void rotation(double gpp, double gqq, double gpq,
                                         double& c, double& s) {
  const double d = sub(gqq, gpp);
  const double two_g = add(gpq, gpq);
  const double r = __dsqrt_rn(add(mul(d, d), mul(two_g, two_g)));
  const double t = nan_to_num(__ddiv_rn(two_g, add(d, copysign(r, d))));
  c = __ddiv_rn(1.0, __dsqrt_rn(add(1.0, mul(t, t))));
  s = mul(c, t);
}

__device__ __forceinline__ void rotate(double& x, double& y, double c,
                                       double s) {
  const double nx = sub(mul(c, x), mul(s, y));
  y = add(mul(s, x), mul(c, y));
  x = nx;
}

// argmin's order: the smaller, a NaN before a number
__device__ __forceinline__ bool less_or_nan(double a, double b) {
  return a < b || (isnan(a) && !isnan(b));
}

// a descending sort's order: the larger, a NaN before a number
__device__ __forceinline__ bool greater_or_nan(double a, double b) {
  return a > b || (isnan(a) && !isnan(b));
}

// u_1, u_2 = the first two columns of A over their norms (V's column where
// a norm is not > 0), u_3 = u_1 x u_2 (pose/kabsch._left_3x3)
__device__ __forceinline__ void left_3x3(const double a0[3],
                                         const double a1[3],
                                         const double v0[3],
                                         const double v1[3], double n0,
                                         double n1, double u[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[0][i] = n0 > 0.0 ? __ddiv_rn(a0[i], n0) : v0[i];
    u[1][i] = n1 > 0.0 ? __ddiv_rn(a1[i], n1) : v1[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u[2][i] = sub(mul(u[0][(i + 1) % 3], u[1][(i + 2) % 3]),
                  mul(u[0][(i + 2) % 3], u[1][(i + 1) % 3]));
}

// ---------------------------------------------------------------------------
// H10
// ---------------------------------------------------------------------------

// The Kabsch factors of a finite row-major 3x3 H (pose/kabsch.
// rotation_3x3_plain): v[j] column j of V, u[i] row i of U^T.
__device__ __forceinline__ void rotation_3x3(const double h[9],
                                             double v[3][3],
                                             double u[3][3]) {
  double col[3][6];   // column j: A's entries 0-2 over V's 3-5
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      col[j][i] = h[3 * i + j];
      col[j][3 + i] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps3; ++sweep) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = k < 2 ? 0 : 1, q = k == 0 ? 1 : 2;
      double* x = col[p];
      double* y = col[q];
      const double gpp = add(add(mul(x[0], x[0]), mul(x[1], x[1])),
                             mul(x[2], x[2]));
      const double gqq = add(add(mul(y[0], y[0]), mul(y[1], y[1])),
                             mul(y[2], y[2]));
      const double gpq = add(add(mul(x[0], y[0]), mul(x[1], y[1])),
                             mul(x[2], y[2]));
      double c, s;
      rotation(gpp, gqq, gpq, c, s);
#pragma unroll
      for (int i = 0; i < 6; ++i) rotate(x[i], y[i], c, s);
    }
  }
  double norm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    norm[j] = __dsqrt_rn(add(add(mul(col[j][0], col[j][0]),
                                 mul(col[j][1], col[j][1])),
                             mul(col[j][2], col[j][2])));
  int least = 0;
  if (less_or_nan(norm[1], norm[least])) least = 1;
  if (less_or_nan(norm[2], norm[least])) least = 2;
  // column j of the result is column (least + 1 + j) % 3: the least last
  double a[3][3], n[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int src = 0; src < 3; ++src) {
      if ((least + 1 + j) % 3 == src) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a[j][i] = col[src][i];
          v[j][i] = col[src][3 + i];
        }
        n[j] = norm[src];
      }
    }
  }
  left_3x3(a[0], a[1], v[0], v[1], n[0], n[1], u);
}

__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((x >> b) & 1) << (bits - 1 - b);
  return r;
}

// The fold of a thread's 2^LOGK points t + k kFitThreads, the tree's levels
// h >= kFitThreads (which pair a thread's own points): its leaves taken in
// the bit-reversed order of k make a balanced tree added left to right.
// The subtree of leaves [J0, J0 + 2^L), depth first (L + 1 partial sums
// live at a time).
template <int LOGK, int L, int J0, int Q, typename Load>
__device__ __forceinline__ void fold_points(const Load& load,
                                            double (&out)[Q]) {
  if constexpr (L == 0) {
    load(bit_reverse(J0, LOGK), out);
  } else {
    double left[Q];
    fold_points<LOGK, L - 1, J0, Q>(load, left);
    fold_points<LOGK, L - 1, J0 + (1 << (L - 1)), Q>(load, out);
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q] = add(left[q], out[q]);
  }
}

// The tree's levels h < kFitThreads over the threads' folds v: shared
// memory down to h = 32, then warp 0's shuffles; thread 0 ends with the Q
// sums.
template <int Q>
__device__ __forceinline__ void block_tree(double (&v)[Q],
                                           double (*sh)[kFitThreads]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < Q; ++q) sh[q][t] = v[q];
  __syncthreads();
#pragma unroll
  for (int h = kFitThreads / 2; h >= 32; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int q = 0; q < Q; ++q) sh[q][t] = add(sh[q][t], sh[q][t + h]);
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      double x = sh[q][t];
#pragma unroll
      for (int h = 16; h >= 1; h >>= 1)
        x = add(x, __shfl_down_sync(kFull, x, h));
      v[q] = x;
    }
  }
}

template <int LOGK>
__global__ void __launch_bounds__(kFitThreads)
    kabsch_fit_kernel(const float* __restrict__ src,
                      const float* __restrict__ dst,
                      const uint8_t* __restrict__ mask, float* __restrict__ T,
                      int N) {
  __shared__ double sh[9][kFitThreads];
  __shared__ double mu[6];
  __shared__ int count;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* s = src + (size_t)b * N * 3;
  const float* d = dst + (size_t)b * N * 3;
  const uint8_t* w = mask + (size_t)b * N;
  if (t == 0) count = 0;
  __syncthreads();
  // the valid count and the masked sums of src and dst (invalid rows 0)
  int c = 0;
  double sums[6];
  fold_points<LOGK, LOGK, 0, 6>(
      [&](int k, double (&v)[6]) {
        const int i = t + k * kFitThreads;
        if (i < N) {
          const bool valid = w[i] != 0;
          c += valid;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            v[q] = valid ? (double)s[3 * i + q] : 0.0;
            v[3 + q] = valid ? (double)d[3 * i + q] : 0.0;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 6; ++q) v[q] = -0.0;
        }
      },
      sums);
  atomicAdd(&count, c);
  block_tree<6>(sums, sh);
  if (t == 0) {
    const double n = (double)max(count, 1);
#pragma unroll
    for (int q = 0; q < 6; ++q) mu[q] = __ddiv_rn(sums[q], n);
  }
  __syncthreads();
  // the sums of X_k Y_l over the centred valid rows (invalid rows 0)
  double ms[3], md[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    ms[q] = mu[q];
    md[q] = mu[3 + q];
  }
  double hs[9];
  fold_points<LOGK, LOGK, 0, 9>(
      [&](int k, double (&v)[9]) {
        const int i = t + k * kFitThreads;
        if (i < N) {
          const bool valid = w[i] != 0;
          double x[3], y[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            x[q] = valid ? sub((double)s[3 * i + q], ms[q]) : 0.0;
            y[q] = valid ? sub((double)d[3 * i + q], md[q]) : 0.0;
          }
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
            for (int l = 0; l < 3; ++l) v[3 * kk + l] = mul(x[kk], y[l]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 9; ++q) v[q] = -0.0;
        }
      },
      hs);
  block_tree<9>(hs, sh);
  if (t != 0) return;
  float* out = T + 16 * (size_t)b;
  const float nan = __int_as_float(0x7fc00000);
  if (count < 3) {
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = nan;
    return;
  }
  bool finite = true;
#pragma unroll
  for (int q = 0; q < 9; ++q) finite = finite && isfinite(hs[q]);
  float o[12];
  if (finite) {
    double v[3][3], u[3][3];
    rotation_3x3(hs, v, u);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      double r[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {   // R[i][j] = sum_k V[i][k] U^T[k][j]
        r[j] = add(add(mul(v[0][i], u[0][j]), mul(v[1][i], u[1][j])),
                   mul(v[2][i], u[2][j]));
        o[4 * i + j] = __double2float_rn(r[j]);
      }
      const double rm = add(add(mul(r[0], ms[0]), mul(r[1], ms[1])),
                            mul(r[2], ms[2]));
      o[4 * i + 3] = __double2float_rn(sub(md[i], rm));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 12; ++e) o[e] = nan;
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) out[e] = o[e];
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

// ---------------------------------------------------------------------------
// H11
// ---------------------------------------------------------------------------

// Column j's partner in round r of the round-robin order over n columns
// (pose/kabsch.jacobi_rounds), -1 where it is the pad column or none.
__device__ __forceinline__ int rr_partner(int j, int r, int n) {
  const int n2 = n + (n & 1), m1 = n2 - 1;
  const int x = m1 - 1 - r;
  int q;
  if (j == n2 - 1) {
    q = x;
  } else if (j == x) {
    q = n2 - 1;
  } else {
    q = (2 * x - j) % m1;
    if (q < 0) q += m1;
  }
  return j < n && q < n ? q : -1;
}

// One-sided Jacobi on the m x n matrix of a lane group, lane j < n holding
// column j of A (a[0..m-1]) over V (v[0..n-1]): rounds of disjoint pairs,
// the partner's column by shuffles. Returns the sweeps the plain version
// counts for this matrix. Every lane of the warp calls it with the same m,
// n and max_sweeps.
template <int M, int N, int RM, int RN>
__device__ int jacobi_sweeps(double (&a)[RM], double (&v)[RN], int m_rt,
                             int n_rt, int j, int base, unsigned gmask,
                             bool live, double tol, int max_sweeps) {
  const int m = M ? M : m_rt, n = N ? N : n_rt;
  const int rounds = n + (n & 1) - 1;
  bool done = !live;
  int sweeps = 0;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    if (__all_sync(kFull, done)) break;
    bool rot = false;
    for (int r = 0; r < rounds; ++r) {
      const int q = rr_partner(j, r, n);
      const int from = base + (q >= 0 ? q : j);
      double pa[RM], pv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (i < m) pa[i] = __shfl_sync(kFull, a[i], from);
#pragma unroll
      for (int i = 0; i < RN; ++i)
        if (i < n) pv[i] = __shfl_sync(kFull, v[i], from);
      if (q < 0 || done) continue;
      const bool lo = j < q;   // this lane holds column p
      double gpp = 0.0, gqq = 0.0, gpq = 0.0;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (i >= m) break;
        const double x = lo ? a[i] : pa[i], y = lo ? pa[i] : a[i];
        gpp = i ? add(gpp, mul(x, x)) : mul(x, x);
        gqq = i ? add(gqq, mul(y, y)) : mul(y, y);
        gpq = i ? add(gpq, mul(x, y)) : mul(x, y);
      }
      if (fabs(gpq) <= mul(tol, __dsqrt_rn(mul(gpp, gqq)))) continue;
      double c, s;
      rotation(gpp, gqq, gpq, c, s);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (i >= m) break;
        a[i] = lo ? sub(mul(c, a[i]), mul(s, pa[i]))
                  : add(mul(s, pa[i]), mul(c, a[i]));
      }
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        if (i >= n) break;
        v[i] = lo ? sub(mul(c, v[i]), mul(s, pv[i]))
                  : add(mul(s, pv[i]), mul(c, v[i]));
      }
      rot = true;
    }
    const bool any = (__ballot_sync(kFull, rot) & gmask) != 0u;
    if (!done) {
      ++sweeps;
      done = !any;
    }
  }
  return sweeps;
}

// sqrt of the chain a_0^2 + ... + a_{m-1}^2
template <int RM>
__device__ __forceinline__ double column_norm(const double (&a)[RM], int m) {
  double acc = mul(a[0], a[0]);
#pragma unroll
  for (int i = 1; i < RM; ++i)
    if (i < m) acc = add(acc, mul(a[i], a[i]));
  return __dsqrt_rn(acc);
}

// Lane j's place among the group's first n columns by norm: the count of
// columns before it in a stable descending sort (NaN first).
__device__ __forceinline__ int norm_rank(double nrm, int j, int n,
                                         int base) {
  int rank = 0;
  for (int k = 0; k < n; ++k) {
    const double nk = __shfl_sync(kFull, nrm, base + k);
    rank += greater_or_nan(nk, nrm) || (k < j && !greater_or_nan(nrm, nk));
  }
  return rank;
}

// ops/image.fma, as OpenBLAS's fused multiply-adds are reproduced: the
// float64 product plus the float64 c, rounded once to float32
__device__ __forceinline__ float emu_fma(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// LAPACK's slapy2: w sqrt(1 + (z/w)^2), w where z is 0
__device__ __forceinline__ float slapy2(float x, float y) {
  const float w = fmaxf(fabsf(x), fabsf(y)), z = fminf(fabsf(x), fabsf(y));
  if (z == 0.0f) return w;
  const float q = __fdiv_rn(z, w);
  return __fmul_rn(w, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(q, q))));
}

// LAPACK's slarf('Right') on this lane's row, columns c..n-1, with v = (1,
// vk[c+1..]): w = row . v (sgemv, a chain of fused multiply-adds), then
// row[k] += (-tau v_k) w (sger); nothing where tau is 0
template <int RN>
__device__ __forceinline__ void slarf_row(float (&row)[RN],
                                          const float (&vk)[RN], int c,
                                          int n, float tau) {
  if (tau == 0.0f) return;
  float w = emu_fma(row[c], 1.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < RN; ++k)
    if (k > c && k < n) w = emu_fma(row[k], vk[k], w);
#pragma unroll
  for (int k = 0; k < RN; ++k) {
    if (k >= c && k < n) {
      const float t = __fmul_rn(-tau, k == c ? 1.0f : vk[k]);
      row[k] = emu_fma(t, w, row[k]);
    }
  }
}

// row i of the group's rows (lane base + i), entries i+1..n-1, to every lane
template <int RN>
__device__ __forceinline__ void broadcast_row(const float (&row)[RN],
                                              float (&vk)[RN], int i, int n,
                                              int base) {
#pragma unroll
  for (int k = 0; k < RN; ++k)
    if (k < n) vk[k] = __shfl_sync(kFull, row[k], base + i);
}

template <int M, int N>
__global__ void __launch_bounds__(kSvdThreads)
    jacobi_svd_kernel(const void* __restrict__ in, double* __restrict__ S,
                      double* __restrict__ V, double* __restrict__ U,
                      int* __restrict__ sweeps, int B, int m_rt, int n_rt,
                      double tol, int max_sweeps) {
  constexpr int RM = M ? M : kMaxDim, RN = N ? N : kMaxDim;
  const int m = M ? M : m_rt, n = N ? N : n_rt;
  const int per_warp = 32 / n;   // a group of n lanes a matrix
  const int lane = threadIdx.x & 31;
  const int g = lane / n, j = lane - g * n, base = g * n;
  const int b =
      (blockIdx.x * (kSvdThreads / 32) + threadIdx.x / 32) * per_warp + g;
  const bool live = g < per_warp && b < B;
  const unsigned gmask =
      (unsigned)((((1ull << n) - 1ull) << base) & 0xffffffffull);
  double* so = S + (size_t)b * n;
  double* vo = V + (size_t)b * n * n;

  if (m < n) {
    // the LQ of the float32 rows, lane r holding row r of R, then of Q
    float row[RN], tau[RM], vk[RN];
    const float* src = static_cast<const float*>(in) + (size_t)b * m * n;
#pragma unroll
    for (int k = 0; k < RN; ++k)
      row[k] = live && j < m && k < n ? src[j * n + k] : 0.0f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {   // sgelq2: reflector i zeroes row i
      if (i >= m) break;
      float my_tau = 0.0f;
      if (j == i) {
        const float alpha = row[i];
        const float x1 = row[i + 1 < RN ? i + 1 : i];
        double ss = __dmul_rn(x1, x1);
#pragma unroll
        for (int k = 0; k < RN; ++k)
          if (k > i + 1 && k < n)
            ss = __dadd_rn(ss, __dmul_rn(row[k], row[k]));
        const float xnorm = __double2float_rn(__dsqrt_rn(ss));
        if (xnorm != 0.0f) {
          const float beta = -copysignf(slapy2(alpha, xnorm), alpha);
          my_tau = __fdiv_rn(__fsub_rn(beta, alpha), beta);
          const float scale = __fdiv_rn(1.0f, __fsub_rn(alpha, beta));
#pragma unroll
          for (int k = 0; k < RN; ++k)
            if (k > i && k < n) row[k] = __fmul_rn(row[k], scale);
          row[i] = beta;
        }
      }
      tau[i] = __shfl_sync(kFull, my_tau, base + i);
      broadcast_row(row, vk, i, n, base);
      if (j > i && j < m) slarf_row(row, vk, i, n, tau[i]);
    }
    // L's columns, lane k < m holding column k (L[i][k] = R[i][k], k <= i)
    double a[RM], vl[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = 0.0;
      vl[i] = i == j ? 1.0 : 0.0;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (i >= m) break;
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        if (k >= m) break;
        const float x = __shfl_sync(kFull, row[k], base + i);
        if (k == j && k <= i) a[i] = (double)x;
      }
    }
    // sorgl2: Q = H(m-1) ... H(0), its rows m..n-1 from the identity
    if (j >= m) {
#pragma unroll
      for (int k = 0; k < RN; ++k) row[k] = k == j ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int i = RM - 1; i >= 0; --i) {
      if (i >= m) continue;
      if (j == i) row[i] = 1.0f;
      broadcast_row(row, vk, i, n, base);
      if (j > i && j < n) slarf_row(row, vk, i, n, tau[i]);
      if (j == i) {
#pragma unroll
        for (int k = 0; k < RN; ++k) {
          if (k > i && k < n) row[k] = __fmul_rn(row[k], -tau[i]);
          if (k < i) row[k] = 0.0f;
        }
        row[i] = __fsub_rn(1.0f, tau[i]);
      }
    }
    const int sw = jacobi_sweeps<M, M, RM, RM>(a, vl, m, m, j, base, gmask,
                                               live, tol, max_sweeps);
    const double nrm = column_norm(a, m);
    const int rank = norm_rank(nrm, j, m, base);
    // V's first m columns: (Q[:m]^T V_L)[jj][rank], lane k < m its column
    double acc[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (i >= m) break;
#pragma unroll
      for (int jj = 0; jj < RN; ++jj) {
        if (jj >= n) break;
        const double p =
            mul((double)__shfl_sync(kFull, row[jj], base + i), vl[i]);
        acc[jj] = i ? add(acc[jj], p) : p;
      }
    }
    if (!live) return;
    if (j < m) {
      so[rank] = nrm;
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
        if (jj < n) vo[jj * n + rank] = acc[jj];
    } else if (j < n) {   // V's last n - m columns: Q[m:]^T
      so[j] = 0.0;
#pragma unroll
      for (int jj = 0; jj < RN; ++jj)
        if (jj < n) vo[jj * n + j] = (double)row[jj];
    }
    if (j == 0) sweeps[b] = sw;
    return;
  }

  // m >= n: the sweeps on the float64 columns themselves
  double a[RM], v[RN];
  const double* src = static_cast<const double*>(in) + (size_t)b * m * n;
#pragma unroll
  for (int i = 0; i < RM; ++i)
    if (i < m) a[i] = live ? src[i * n + j] : 0.0;
#pragma unroll
  for (int i = 0; i < RN; ++i) v[i] = i == j ? 1.0 : 0.0;
  const int sw = jacobi_sweeps<M, N, RM, RN>(a, v, m, n, j, base, gmask, live,
                                             tol, max_sweeps);
  const double nrm = column_norm(a, m);
  const int rank = norm_rank(nrm, j, n, base);
  if (live) {
    so[rank] = nrm;
#pragma unroll
    for (int i = 0; i < RN; ++i)
      if (i < n) vo[i * n + rank] = v[i];
    if (j == 0) sweeps[b] = sw;
  }
  if (U == nullptr || m != 3 || n != 3) return;
  // U's columns u_1, u_2 from the columns ranked 0 and 1, u_3 = u_1 x u_2
  const unsigned r0 = __ballot_sync(kFull, live && rank == 0) & gmask;
  const unsigned r1 = __ballot_sync(kFull, live && rank == 1) & gmask;
  const int l0 = r0 ? __ffs(r0) - 1 : lane, l1 = r1 ? __ffs(r1) - 1 : lane;
  double a0[3], a1[3], v0[3], v1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a0[i] = __shfl_sync(kFull, a[i], l0);
    a1[i] = __shfl_sync(kFull, a[i], l1);
    v0[i] = __shfl_sync(kFull, v[i], l0);
    v1[i] = __shfl_sync(kFull, v[i], l1);
  }
  const double n0 = __shfl_sync(kFull, nrm, l0);
  const double n1 = __shfl_sync(kFull, nrm, l1);
  double u[3][3];
  left_3x3(a0, a1, v0, v1, n0, n1, u);
  if (!live) return;
  double* uo = U + 9 * (size_t)b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {   // lane i writes U's row i
    if (i == j) {
#pragma unroll
      for (int r = 0; r < 3; ++r) uo[3 * i + r] = u[r][i];
    }
  }
}

template <int M, int N>
int launch_svd(const void* a, double* S, double* V, double* U, int* sweeps,
               int B, int m, int n, double tol, int max_sweeps,
               cudaStream_t stream) {
  const int per_block = (kSvdThreads / 32) * (32 / n);
  jacobi_svd_kernel<M, N><<<(B + per_block - 1) / per_block, kSvdThreads, 0,
                            stream>>>(a, S, V, U, sweeps, B, m, n, tol,
                                      max_sweeps);
  return (int)cudaGetLastError();
}

template <int LOGK>
int launch_fit(const float* src, const float* dst, const uint8_t* mask,
               float* T, int B, int N, cudaStream_t stream) {
  kabsch_fit_kernel<LOGK><<<B, kFitThreads, 0, stream>>>(src, dst, mask, T,
                                                          N);
  return (int)cudaGetLastError();
}

}  // namespace

// src, dst (B, N, 3) float32, mask (B, N) bool -> T (B, 4, 4) float32
extern "C" int ovo_kabsch_fit(const float* src, const float* dst,
                              const uint8_t* mask, float* T, int B, int N,
                              void* stream) {
  if (B < 0 || N < 0 || N > (kFitThreads << kFitMaxLogK))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int logk = 0;
  while ((kFitThreads << logk) < N) ++logk;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (logk) {
    case 0: return launch_fit<0>(src, dst, mask, T, B, N, st);
    case 1: return launch_fit<1>(src, dst, mask, T, B, N, st);
    case 2: return launch_fit<2>(src, dst, mask, T, B, N, st);
    case 3: return launch_fit<3>(src, dst, mask, T, B, N, st);
    case 4: return launch_fit<4>(src, dst, mask, T, B, N, st);
    case 5: return launch_fit<5>(src, dst, mask, T, B, N, st);
    default: return launch_fit<6>(src, dst, mask, T, B, N, st);
  }
}

// a: float32 where m < n, else float64
extern "C" int ovo_jacobi_svd(const void* a, double* S, double* V,
                              double* U, int* sweeps, int B, int m, int n,
                              double tol, int max_sweeps, void* stream) {
  if (B < 0 || m < 1 || n < 1 || m > kMaxDim || n > kMaxDim ||
      max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (m == 5 && n == 9)
    return launch_svd<5, 9>(a, S, V, U, sweeps, B, m, n, tol, max_sweeps, st);
  if (m == 9 && n == 9)
    return launch_svd<9, 9>(a, S, V, U, sweeps, B, m, n, tol, max_sweeps, st);
  if (m == 3 && n == 3)
    return launch_svd<3, 3>(a, S, V, U, sweeps, B, m, n, tol, max_sweeps, st);
  return launch_svd<0, 0>(a, S, V, U, sweeps, B, m, n, tol, max_sweeps, st);
}
