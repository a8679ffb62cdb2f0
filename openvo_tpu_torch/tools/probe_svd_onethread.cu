// A variant of H11 for timing only (openvo_tpu_torch/tools/
// probe_svd_kernels.py builds it; the port never does): one thread a
// matrix, as H11's first design, but with the shapes fixed at compile time
// (loops unrolled, the matrix in registers where the compiler can keep it)
// and the pairs in the cyclic order (0, 1), (0, 2), ..., (n-2, n-1). Set
// beside H11's first design (one thread, local memory, cyclic) and its
// present one (a lane a column, round-robin order), it splits the gain
// between the layout and the order. The cyclic order gives other bits than
// the round-robin one except on 3x3 matrices (the same order) and the wide
// path's null-space columns (the LQ's, which no order touches).

#include "../csrc/jacobi.cu"

namespace {

template <int M, int N>
__global__ void __launch_bounds__(32)
    onethread_kernel(const void* __restrict__ in, double* __restrict__ S,
                     double* __restrict__ V, double* __restrict__ U,
                     int* __restrict__ sweeps, int B, double tol,
                     int max_sweeps) {
  constexpr bool kWide = M < N;
  constexpr int K = kWide ? M : N;   // the Jacobi's columns
  constexpr int RW = kWide ? M : 1, QN = kWide ? N : 1;
  const int b = blockIdx.x * 32 + threadIdx.x;
  if (b >= B) return;
  double A[K][M];   // A[column][row]
  double W[K][K];   // V[column][row]
  float R[RW][N], Q[QN][N], tau[M];
  if constexpr (kWide) {
    const float* src = static_cast<const float*>(in) + (size_t)b * M * N;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) R[i][k] = src[i * N + k];
#pragma unroll
    for (int i = 0; i < M; ++i) {   // sgelq2
      const float alpha = R[i][i];
      double ss = __dmul_rn(R[i][i + 1], R[i][i + 1]);
#pragma unroll
      for (int k = i + 2; k < N; ++k)
        ss = __dadd_rn(ss, __dmul_rn(R[i][k], R[i][k]));
      const float xnorm = __double2float_rn(__dsqrt_rn(ss));
      tau[i] = 0.0f;
      if (xnorm != 0.0f) {
        const float beta = -copysignf(slapy2(alpha, xnorm), alpha);
        tau[i] = __fdiv_rn(__fsub_rn(beta, alpha), beta);
        const float scale = __fdiv_rn(1.0f, __fsub_rn(alpha, beta));
#pragma unroll
        for (int k = i + 1; k < N; ++k) R[i][k] = __fmul_rn(R[i][k], scale);
        R[i][i] = beta;
      }
#pragma unroll
      for (int r = i + 1; r < M; ++r) {
        float vk[N];
#pragma unroll
        for (int k = 0; k < N; ++k) vk[k] = R[i][k];
        slarf_row(R[r], vk, i, N, tau[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c)
        Q[r][c] = r < M ? R[r][c] : (r == c ? 1.0f : 0.0f);
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {   // sorgl2
      Q[i][i] = 1.0f;
#pragma unroll
      for (int r = i + 1; r < N; ++r) {
        float vk[N];
#pragma unroll
        for (int k = 0; k < N; ++k) vk[k] = Q[i][k];
        slarf_row(Q[r], vk, i, N, tau[i]);
      }
#pragma unroll
      for (int k = i + 1; k < N; ++k) Q[i][k] = __fmul_rn(Q[i][k], -tau[i]);
      Q[i][i] = __fsub_rn(1.0f, tau[i]);
#pragma unroll
      for (int k = 0; k < i; ++k) Q[i][k] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < M; ++i) A[j][i] = j <= i ? (double)R[i][j] : 0.0;
  } else {
    const double* src = static_cast<const double*>(in) + (size_t)b * M * N;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < M; ++i) A[j][i] = src[i * N + j];
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) W[j][i] = i == j ? 1.0 : 0.0;
  int sweep = 0;
  while (sweep < max_sweeps) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < K - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < K; ++q) {
        double gpp = mul(A[p][0], A[p][0]);
        double gqq = mul(A[q][0], A[q][0]);
        double gpq = mul(A[p][0], A[q][0]);
#pragma unroll
        for (int i = 1; i < M; ++i) {
          gpp = add(gpp, mul(A[p][i], A[p][i]));
          gqq = add(gqq, mul(A[q][i], A[q][i]));
          gpq = add(gpq, mul(A[p][i], A[q][i]));
        }
        if (fabs(gpq) <= mul(tol, __dsqrt_rn(mul(gpp, gqq)))) continue;
        double c, s;
        rotation(gpp, gqq, gpq, c, s);
#pragma unroll
        for (int i = 0; i < M; ++i) rotate(A[p][i], A[q][i], c, s);
#pragma unroll
        for (int i = 0; i < K; ++i) rotate(W[p][i], W[q][i], c, s);
        rotated = true;
      }
    }
    ++sweep;
    if (!rotated) break;
  }
  double norm[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    double acc = mul(A[j][0], A[j][0]);
#pragma unroll
    for (int i = 1; i < M; ++i) acc = add(acc, mul(A[j][i], A[j][i]));
    norm[j] = __dsqrt_rn(acc);
  }
  int rank[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    rank[j] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      rank[j] += greater_or_nan(norm[k], norm[j]) ||
                 (k < j && !greater_or_nan(norm[j], norm[k]));
  }
  double* so = S + (size_t)b * N;
  double* vo = V + (size_t)b * N * N;
#pragma unroll
  for (int j = 0; j < K; ++j) so[rank[j]] = norm[j];
  if constexpr (kWide) {
#pragma unroll
    for (int r = M; r < N; ++r) so[r] = 0.0;
#pragma unroll
    for (int jj = 0; jj < N; ++jj) {
#pragma unroll
      for (int k = 0; k < K; ++k) {   // (Q[:m]^T V_L)[jj][rank k]
        double acc = mul(Q[0][jj], W[k][0]);
#pragma unroll
        for (int i = 1; i < M; ++i) acc = add(acc, mul(Q[i][jj], W[k][i]));
        vo[jj * N + rank[k]] = acc;
      }
#pragma unroll
      for (int k = M; k < N; ++k) vo[jj * N + k] = Q[k][jj];
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < K; ++i) vo[i * N + rank[j]] = W[j][i];
    if constexpr (M == 3 && N == 3) {
      if (U != nullptr) {
        double a0[3], a1[3], v0[3], v1[3], n0 = 0.0, n1 = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (rank[j] == 0) {
              a0[i] = A[j][i];
              v0[i] = W[j][i];
              n0 = norm[j];
            }
            if (rank[j] == 1) {
              a1[i] = A[j][i];
              v1[i] = W[j][i];
              n1 = norm[j];
            }
          }
        }
        double u[3][3];
        left_3x3(a0, a1, v0, v1, n0, n1, u);
        double* uo = U + 9 * (size_t)b;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int r = 0; r < 3; ++r) uo[3 * i + r] = u[r][i];
      }
    }
  }
  sweeps[b] = sweep;
}

template <int M, int N>
int launch_onethread(const void* a, double* S, double* V, double* U,
                     int* sweeps, int B, double tol, int max_sweeps,
                     cudaStream_t st) {
  onethread_kernel<M, N><<<(B + 31) / 32, 32, 0, st>>>(a, S, V, U, sweeps,
                                                        B, tol, max_sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// ovo_jacobi_svd's arguments, for the shapes the mono path runs (5x9,
// 9x9, 3x3); others are refused
extern "C" int ovo_jacobi_svd_onethread(const void* a, double* S, double* V,
                                        double* U, int* sweeps, int B, int m,
                                        int n, double tol, int max_sweeps,
                                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return B == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  if (m == 5 && n == 9)
    return launch_onethread<5, 9>(a, S, V, U, sweeps, B, tol, max_sweeps, st);
  if (m == 9 && n == 9)
    return launch_onethread<9, 9>(a, S, V, U, sweeps, B, tol, max_sweeps, st);
  if (m == 3 && n == 3)
    return launch_onethread<3, 3>(a, S, V, U, sweeps, B, tol, max_sweeps, st);
  return (int)cudaErrorInvalidValue;
}
