// Rigid clique kernel for Hopper (sm_90a), bound with ctypes
// (openvo_tpu_torch/ops/clique_cuda.py holds the wrapper; the plain
// version is pose/rigid_clique.greedy_clique_plain).
//
//   H8 greedy_clique <- the rigid clique's greedy growth, a lax.while_loop
//   in the JAX package (openvo_tpu/pose/rigid_clique.py:53-69), left to XLA
//
// One block a cloud runs JAX's loop over the (N, N) consistency matrix
// `cons` and the counts `num` (num[j] = sum_i cons[i, j]) literally:
//   seed = argmax(num); clique = {seed}; compatible = cons[seed, :];
//   while sum(compatible - clique) > 0 and it < N:
//     sel = argmax(num * (compatible - clique)); clique[sel] = 1;
//     compatible[j] = (sum_{i in clique} cons[j, i] >= |clique|); ++it.
// argmax takes the first maximum (jnp.argmax) over values that can be
// negative, and the condition is a sum, not an any: a seed consistent with
// nothing (a NaN row) leaves sum -1 and stops at once.
//
// Thread t owns indices j = t, t + T, ... (at most kItems of them) and
// keeps their num, their count of consistent members (raised by
// cons[j, sel] at each pick) and their membership in registers. A step is
// one block reduction of (sum of candidates, argmax key): each warp
// reduces by shuffles into a slot of shared memory, and after one barrier
// every thread reads the warps' slots; the slots alternate between steps,
// so one barrier a step suffices. The argmax key packs the value above
// (MAX - j) and j's membership bit, so the larger value, then the smaller
// index, wins, and every thread learns whether sel was a member already
// (then the clique and the counts stay as they are). cons is read as bits:
// for N up to kBitsMaxN each block first packs its matrix into shared
// memory by ballots, rows of N bits padded to an odd count of words (no
// bank conflict when the warp reads one column); above that it reads the
// bytes from global memory.
//
// Bound: the matrix read once (N * N bytes a cloud: 262 KB at N = 512, 78
// ns at 3.35 TB/s); the time is the chain of picks, each a block
// reduction and a barrier, at most N of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kItems = 4;        // indices a thread: N <= 4 * 1024
constexpr int kMaxThreads = 1024;
constexpr int kBitsMaxN = 1024;  // cons as bits in shared memory up to here

__device__ __forceinline__ long long pack_key(int v, int j, bool member) {
  return (long long)v * 4294967296LL +
         (long long)((((unsigned)(INT_MAX - j)) << 1) | (unsigned)member);
}

struct Reduced {
  long long key;
  int sum;
};

// The block's max key and sum, every thread's; `slot` alternates between
// consecutive calls so that one barrier a call suffices.
__device__ __forceinline__ Reduced block_reduce(long long key, int sum,
                                                long long (*keys)[32],
                                                int (*sums)[32], int slot) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other > key ? other : key;
  }
  sum = __reduce_add_sync(0xffffffffu, sum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    keys[slot][warp] = key;
    sums[slot][warp] = sum;
  }
  __syncthreads();
  Reduced r{LLONG_MIN, 0};
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const long long k = keys[slot][w];
    r.key = k > r.key ? k : r.key;
    r.sum += sums[slot][w];
  }
  return r;
}

__device__ __forceinline__ int key_index(long long key) {
  return INT_MAX - (int)(((unsigned)(key & 0xffffffffLL)) >> 1);
}

template <bool kBits>
__global__ void __launch_bounds__(kMaxThreads) greedy_clique_kernel(
    const uint8_t* __restrict__ cons, const int* __restrict__ num,
    int* __restrict__ out, int N, int stride) {
  extern __shared__ uint32_t bits[];
  __shared__ long long keys[2][32];
  __shared__ int sums[2][32];
  const int t = threadIdx.x, T = blockDim.x;
  const uint8_t* C = cons + (size_t)blockIdx.x * N * N;
  if (kBits) {
    const int lane = t & 31, warps = T >> 5, words = (N + 31) >> 5;
    for (int r = t >> 5; r < N; r += warps)
      for (int w = 0; w < words; ++w) {
        const int i = (w << 5) + lane;
        const unsigned m =
            __ballot_sync(0xffffffffu, i < N && C[(size_t)r * N + i]);
        if (lane == 0) bits[r * stride + w] = m;
      }
    __syncthreads();
  }
  const auto con = [&](int j, int i) -> int {
    if (kBits) return (bits[j * stride + (i >> 5)] >> (i & 31)) & 1;
    return C[(size_t)j * N + i] != 0;
  };
  int nm[kItems], cnt[kItems];
  bool member[kItems], compat[kItems];
  long long key = LLONG_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * T;
    nm[k] = j < N ? num[(size_t)blockIdx.x * N + j] : 0;
    if (j < N) {
      const long long kj = pack_key(nm[k], j, false);
      key = kj > key ? kj : key;
    }
  }
  const int seed = key_index(block_reduce(key, 0, keys, sums, 1).key);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * T;
    member[k] = j == seed;
    cnt[k] = j < N ? con(j, seed) : 0;
    compat[k] = j < N && con(seed, j);
  }
  int size = 1;
  for (int it = 0;; ++it) {
    key = LLONG_MIN;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = t + k * T;
      if (j < N) {
        const int c = (int)compat[k] - (int)member[k];
        sum += c;
        const long long kj = pack_key(nm[k] * c, j, member[k]);
        key = kj > key ? kj : key;
      }
    }
    const Reduced r = block_reduce(key, sum, keys, sums, it & 1);
    if (!(r.sum > 0 && it < N)) break;
    const int sel = key_index(r.key);
    const bool grows = !(r.key & 1);
    size += grows;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = t + k * T;
      if (j < N) {
        member[k] = member[k] || j == sel;
        if (grows) cnt[k] += con(j, sel);
        compat[k] = cnt[k] >= size;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * T;
    if (j < N) out[(size_t)blockIdx.x * N + j] = member[k];
  }
}

}  // namespace

// cons (clouds, N, N) bytes 0/1, num (clouds, N) int32 -> out (clouds, N)
// int32 0/1 membership; one block a cloud.
extern "C" int ovo_greedy_clique(const uint8_t* cons, const int* num,
                                 int* out, int clouds, int N, void* stream) {
  if (clouds < 0 || clouds > INT_MAX || N <= 0 ||
      N > kItems * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (clouds == 0) return (int)cudaSuccess;
  const int threads = N < kMaxThreads ? ((N + 31) / 32) * 32 : kMaxThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= kBitsMaxN) {
    const int stride = ((N + 31) / 32) | 1;
    const size_t smem = (size_t)N * stride * sizeof(uint32_t);
    static bool raised = false;   // the attribute, once a process
    if (smem > 48 * 1024 && !raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          greedy_clique_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)((size_t)kBitsMaxN * (((kBitsMaxN + 31) / 32) | 1) *
                sizeof(uint32_t)));
      if (e != cudaSuccess) return (int)e;
      raised = true;
    }
    greedy_clique_kernel<true><<<clouds, threads, smem, st>>>(cons, num, out,
                                                              N, stride);
  } else {
    greedy_clique_kernel<false><<<clouds, threads, 0, st>>>(cons, num, out,
                                                            N, 0);
  }
  return (int)cudaGetLastError();
}
