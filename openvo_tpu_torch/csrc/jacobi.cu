// The small SVDs of the pose fits for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/jacobi_cuda.py holds the wrappers; the plain
// versions are pose/kabsch.rotation_3x3_plain and
// pose/kabsch.jacobi_svd_plain).
//
//   H10 rotation_3x3 <- Kabsch's 3x3 SVD, jnp.linalg.svd in the JAX package
//   (openvo_tpu/pose/kabsch.py:49), left to XLA
//   H11 jacobi_svd   <- the five-point null space, the refit and the
//   essential projection and recoverPose, jnp.linalg.svd
//   (openvo_tpu/pose/fivepoint.py:210; ransac.py:140, :142, :273), left to
//   XLA
//
// Both are one-sided (Hestenes) Jacobi, one thread a matrix: the columns of
// A over V (V starting as I) are rotated in pairs (p, q), p < q, in cyclic
// order, by the rotation that zeroes their dot product g_pq,
//   d = g_qq - g_pp, t = 2 g_pq / (d + copysign(sqrt(d^2 + 4 g_pq^2), d))
//   (0 for 0/0), c = 1 / sqrt(1 + t^2), s = c t,
//   a_p <- c a_p - s a_q, a_q <- s a_p + c a_q.
// Every operation is a correctly rounded float64 intrinsic in the plain
// version's order (no contraction into FMAs, every sum a left-to-right
// chain), so each matrix gets the plain version's bits, whatever the
// batch.
//
// H10: JACOBI_SWEEPS = 5 sweeps over (0, 1), (0, 2), (1, 2) of the 3x3
// cross-covariance, no test, all in registers; then the column norms, the
// least column shifted last cyclically (ties to the first index, as
// argmin), u_1 and u_2 the first two columns over their norms (V's column
// where a norm is 0) and u_3 = u_1 x u_2. It writes V and the rows of U^T;
// the wrapper's torch.matmul forms R = V U^T, as the plain version does.
//
// H11: m x n matrices, m, n <= 9, held in the thread's local memory. A
// rotation is skipped where |g_pq| <= tol sqrt(g_pp g_qq); a matrix whose
// sweep rotated nothing stops (the plain version runs every sweep, and a
// sweep after such a one skips every pair again), the others after
// max_sweeps. Then the column norms sorted descending (ties to the lower
// index, as a stable sort; NaN first, as torch.sort) give S and V's column
// order, and, where m = n = 3, U as H10 makes it. A wide matrix (m < n,
// the five-point solver's 5x9 rows, float32) takes JAX's path on the CPU,
// LAPACK's sgesdd for n >= 11m/6: its LQ factorisation a = L Q[:m] by
// sgelq2 and sorgl2 in float32 with OpenBLAS's arithmetic (snrm2 in
// float64, sgemv a chain of fused multiply-adds, sger fused multiply-adds
// of -tau v_j, each emulated as ops/image.fma), then the sweeps on the
// m x m L, V = [Q[:m]^T V_L, Q[m:]^T]. So its null space comes in JAX's
// own float32 basis, bit for bit: the float32 five-point solver's
// candidates depend on the basis, and with a Jacobi basis of the 9
// columns, or LAPACK's in float64, the bench corridor's mono run parts
// from JAX's beyond its bars (PERF.md section 6).
//
// Bound: neither moves bytes to speak of (H10 reads 72 B and writes 144 B a
// matrix; H11 at most 648 B in, 1,384 B out) nor fills the card: a batch
// is 1 to 64 matrices, so the time is one thread's chain of dependent
// operations (H10 about 1,000; H11 about 130 a rotation of a 9x9 matrix,
// 36 rotations a sweep, up to 12 sweeps; a 5x9 matrix's float32 LQ about
// 1,500 and its 5x5 L's sweeps about 60 a rotation, 10 a sweep). Spreading
// a matrix over a warp, with parallel orderings, is the way to a faster
// kernel.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kSweeps3 = 5;     // pose/kabsch.JACOBI_SWEEPS
constexpr int kMaxDim = 9;      // ops/jacobi_cuda.MAX_DIM
constexpr int kThreads3 = 128;
constexpr int kThreadsSvd = 32;

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

__global__ void __launch_bounds__(kThreads3)
    rotation_3x3_kernel(const double* __restrict__ H, double* __restrict__ V,
                        double* __restrict__ Ut, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double* h = H + 9 * (size_t)b;
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
  double a[3][3], v[3][3], n[3];
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
  double u[3][3];
  left_3x3(a[0], a[1], v[0], v[1], n[0], n[1], u);
  double* vo = V + 9 * (size_t)b;
  double* uo = Ut + 9 * (size_t)b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      vo[3 * i + j] = v[j][i];
      uo[3 * i + j] = u[i][j];
    }
  }
}

// One-sided Jacobi on the m x n matrix A (A[column][row]) with V (W,
// starting as I): the sweeps, then the column norms and their stable
// descending order. Returns the sweeps run.
__device__ int hestenes(double (*A)[kMaxDim], double (*W)[kMaxDim], int m,
                        int n, double tol, int max_sweeps, double* norm,
                        int* order) {
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) W[j][i] = i == j ? 1.0 : 0.0;
  int sweep = 0;
  while (sweep < max_sweeps) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double gpp = mul(A[p][0], A[p][0]);
        double gqq = mul(A[q][0], A[q][0]);
        double gpq = mul(A[p][0], A[q][0]);
        for (int i = 1; i < m; ++i) {
          gpp = add(gpp, mul(A[p][i], A[p][i]));
          gqq = add(gqq, mul(A[q][i], A[q][i]));
          gpq = add(gpq, mul(A[p][i], A[q][i]));
        }
        if (fabs(gpq) <= mul(tol, __dsqrt_rn(mul(gpp, gqq)))) continue;
        double c, s;
        rotation(gpp, gqq, gpq, c, s);
        for (int i = 0; i < m; ++i) rotate(A[p][i], A[q][i], c, s);
        for (int i = 0; i < n; ++i) rotate(W[p][i], W[q][i], c, s);
        rotated = true;
      }
    }
    ++sweep;
    if (!rotated) break;
  }
  for (int j = 0; j < n; ++j) {
    double acc = mul(A[j][0], A[j][0]);
    for (int i = 1; i < m; ++i) acc = add(acc, mul(A[j][i], A[j][i]));
    norm[j] = __dsqrt_rn(acc);
  }
  // a stable descending sort: each rank takes the first largest left
  bool taken[kMaxDim];
  for (int j = 0; j < n; ++j) taken[j] = false;
  for (int r = 0; r < n; ++r) {
    int best = -1;
    for (int j = 0; j < n; ++j)
      if (!taken[j] && (best < 0 || greater_or_nan(norm[j], norm[best])))
        best = j;
    taken[best] = true;
    order[r] = best;
  }
  return sweep;
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

// LAPACK's slarf('Right') on rows r0..r1-1, columns c..n-1 of C with v =
// (1, C[vrow][c+1..]): w = C v (sgemv, a chain of fused multiply-adds),
// then C[r][j] += (-tau v_j) w_r (sger); nothing where tau is 0
__device__ void slarf_right(float (*C)[kMaxDim], int vrow, int c, int r0,
                            int r1, int n, float tau) {
  if (tau == 0.0f) return;
  float w[kMaxDim];
  for (int r = r0; r < r1; ++r) {
    float acc = emu_fma(C[r][c], 1.0f, 0.0f);
    for (int j = c + 1; j < n; ++j) acc = emu_fma(C[r][j], C[vrow][j], acc);
    w[r] = acc;
  }
  for (int j = c; j < n; ++j) {
    const float t = __fmul_rn(-tau, j == c ? 1.0f : C[vrow][j]);
    for (int r = r0; r < r1; ++r) C[r][j] = emu_fma(t, w[r], C[r][j]);
  }
}

// The LQ factorisation a = L Q[:m] of the float32 m x n rows R (m < n) as
// JAX's SVD computes it on the CPU (pose/kabsch._lapack_lq): LAPACK's
// sgelq2, then sorgl2 for Q = H(m-1) ... H(0), with OpenBLAS's arithmetic
// (snrm2 in float64). R ends holding L below its diagonal and the
// reflectors right of it; Q's rows m..n-1 are LAPACK's null-space basis.
__device__ void lapack_lq(float (*R)[kMaxDim], float (*Q)[kMaxDim],
                          float* tau, int m, int n) {
  for (int i = 0; i < m; ++i) {
    const float alpha = R[i][i];
    double ss = __dmul_rn(R[i][i + 1], R[i][i + 1]);
    for (int j = i + 2; j < n; ++j)
      ss = __dadd_rn(ss, __dmul_rn(R[i][j], R[i][j]));
    const float xnorm = __double2float_rn(__dsqrt_rn(ss));
    tau[i] = 0.0f;
    if (xnorm != 0.0f) {
      const float beta = -copysignf(slapy2(alpha, xnorm), alpha);
      tau[i] = __fdiv_rn(__fsub_rn(beta, alpha), beta);
      const float scale = __fdiv_rn(1.0f, __fsub_rn(alpha, beta));
      for (int j = i + 1; j < n; ++j) R[i][j] = __fmul_rn(R[i][j], scale);
      R[i][i] = beta;
    }
    // rows below see v = (1, R[i][i+1..])
    const float diag = R[i][i];
    R[i][i] = 1.0f;
    slarf_right(R, i, i, i + 1, m, n, tau[i]);
    R[i][i] = diag;
  }
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      Q[r][c] = r < m ? R[r][c] : (r == c ? 1.0f : 0.0f);
  for (int i = m - 1; i >= 0; --i) {
    Q[i][i] = 1.0f;
    slarf_right(Q, i, i, i + 1, n, n, tau[i]);
    for (int j = i + 1; j < n; ++j) Q[i][j] = __fmul_rn(Q[i][j], -tau[i]);
    Q[i][i] = __fsub_rn(1.0f, tau[i]);
    for (int j = 0; j < i; ++j) Q[i][j] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreadsSvd)
    jacobi_svd_kernel(const void* __restrict__ a, double* __restrict__ S,
                      double* __restrict__ V, double* __restrict__ U,
                      int* __restrict__ sweeps, int B, int m, int n,
                      double tol, int max_sweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double A[kMaxDim][kMaxDim];   // the Jacobi's A[column][row]
  double W[kMaxDim][kMaxDim];   // its V[column][row]
  double norm[kMaxDim];
  int order[kMaxDim];
  double* so = S + (size_t)b * n;
  double* vo = V + (size_t)b * n * n;
  if (m < n) {
    float R[kMaxDim][kMaxDim];   // a's rows, then L and the reflectors
    float Q[kMaxDim][kMaxDim];
    float tau[kMaxDim];
    const float* src = static_cast<const float*>(a) + (size_t)b * m * n;
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j) R[i][j] = src[i * n + j];
    lapack_lq(R, Q, tau, m, n);
    for (int j = 0; j < m; ++j)   // L, lower triangular
      for (int i = 0; i < m; ++i) A[j][i] = j <= i ? (double)R[i][j] : 0.0;
    sweeps[b] = hestenes(A, W, m, m, tol, max_sweeps, norm, order);
    for (int r = 0; r < n; ++r) so[r] = r < m ? norm[order[r]] : 0.0;
    for (int j = 0; j < n; ++j) {
      for (int k = 0; k < m; ++k) {   // (Q[:m]^T V_L)[j][k]
        const double* vl = W[order[k]];
        double acc = mul(Q[0][j], vl[0]);
        for (int i = 1; i < m; ++i) acc = add(acc, mul(Q[i][j], vl[i]));
        vo[j * n + k] = acc;
      }
      for (int k = m; k < n; ++k) vo[j * n + k] = Q[k][j];
    }
    return;
  }
  const double* src = static_cast<const double*>(a) + (size_t)b * m * n;
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < m; ++i) A[j][i] = src[i * n + j];
  sweeps[b] = hestenes(A, W, m, n, tol, max_sweeps, norm, order);
  for (int r = 0; r < n; ++r) {
    so[r] = norm[order[r]];
    for (int i = 0; i < n; ++i) vo[i * n + r] = W[order[r]][i];
  }
  if (U != nullptr && m == 3 && n == 3) {
    double u[3][3];
    left_3x3(A[order[0]], A[order[1]], W[order[0]], W[order[1]],
             norm[order[0]], norm[order[1]], u);
    double* uo = U + 9 * (size_t)b;
    for (int i = 0; i < 3; ++i)
      for (int r = 0; r < 3; ++r) uo[3 * i + r] = u[r][i];
  }
}

}  // namespace

extern "C" int ovo_rotation_3x3(const double* H, double* V, double* Ut, int B,
                                void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  rotation_3x3_kernel<<<(B + kThreads3 - 1) / kThreads3, kThreads3, 0,
                        (cudaStream_t)stream>>>(H, V, Ut, B);
  return (int)cudaGetLastError();
}

// a: float32 where m < n, else float64
extern "C" int ovo_jacobi_svd(const void* a, double* S, double* V,
                              double* U, int* sweeps, int B, int m, int n,
                              double tol, int max_sweeps, void* stream) {
  if (B < 0 || m < 1 || n < 1 || m > kMaxDim || n > kMaxDim ||
      max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  jacobi_svd_kernel<<<(B + kThreadsSvd - 1) / kThreadsSvd, kThreadsSvd, 0,
                      (cudaStream_t)stream>>>(a, S, V, U, sweeps, B, m, n,
                                              tol, max_sweeps);
  return (int)cudaGetLastError();
}
