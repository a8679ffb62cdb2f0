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
// nothing (a NaN row) leaves sum -1 and stops at once. A pick of a member
// changes the clique and the counts not at all; where it leaves
// `compatible` as it was too, every later step repeats it, and the loop
// stops there with the state it would end with.
//
// N <= kWarpMaxN (512, the odometer's slots): the picks are a chain, so
// one warp runs it, with no block barrier a pick. First every warp of the
// block packs the columns of cons into shared-memory bits (bit b of word
// w of column s: cons[32w + b, s]): a lane reads 32 bytes of a row (two
// 16-byte loads where N is a multiple of 32), a warp four 32x32 blocks at
// once (the pack is the loads' latency: one SM reads a cloud's 262 KB),
// and 32 ballots transpose a block; columns padded to an odd count of
// words, so the lanes' stores, a column each, meet no bank conflict. After one barrier, warp 0
// alone: lane l holds items j = 16l .. 16l + 15 (their num, their count of
// consistent members, and their membership and compatibility as bit
// masks) in registers. A pick is the lane's first maximum over its items,
// one __reduce_max_sync, a ballot for the first lane at the maximum and a
// shuffle of its item; the sum is two popcounts and one __reduce_add_sync.
// The counts rise by column sel of cons: one shared load a lane (its 16
// items are 16 bits of one word). Concurrency: the pack's stores and the
// chain's loads are parted by the one barrier; the chain is one warp's,
// every collective over all its lanes.
//
// N > kWarpMaxN (up to 4096): one block reduction and barrier a pick, as
// the first design ran every N. Thread t owns indices j = t, t + T, ...
// (at most kItems of them); each warp reduces (sum, argmax key) by
// shuffles into a slot of shared memory, and after one barrier every
// thread reads the warps' slots (the slots alternate between steps, so one
// barrier a step suffices). The key packs the value above (MAX - j) and
// j's membership bit, so the larger value, then the smaller index, wins.
// cons is read as row bits in shared memory up to kBitsMaxN (ballots,
// rows padded to an odd count of words) and as bytes above.
//
// Bound: the matrix read once (N * N bytes a cloud: 262 KB at N = 512, 78
// ns at 3.35 TB/s); the time is the chain of picks, at most N of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpItems = 16;               // items a lane in the chain
constexpr int kWarpMaxN = 32 * kWarpItems;   // the warp chain's largest N
constexpr int kPackWarps = 16;               // warps that pack the bits
constexpr int kInFlight = 4;                 // blocks a warp loads at once
constexpr int kItems = 4;        // indices a thread: N <= 4 * 1024
constexpr int kMaxThreads = 1024;
constexpr int kBitsMaxN = 1024;  // cons as bits in shared memory up to here

// The first maximum of v over the warp's items (lane l's item k is
// 16l + k; `live` marks the lane's items below N, a prefix).
__device__ __forceinline__ int warp_argmax(const int (&v)[kWarpItems],
                                           unsigned live) {
  int best = v[0], at = 0;
#pragma unroll
  for (int k = 1; k < kWarpItems; ++k)
    if (((live >> k) & 1) && v[k] > best) {
      best = v[k];
      at = k;
    }
  const int top = __reduce_max_sync(kFull, live ? best : INT_MIN);
  const int src = __ffs(__ballot_sync(kFull, live && best == top)) - 1;
  return src * kWarpItems + __shfl_sync(kFull, at, src);
}

__global__ void __launch_bounds__(kPackWarps * 32) warp_clique_kernel(
    const uint8_t* __restrict__ cons, const int* __restrict__ num,
    int* __restrict__ out, int N, int stride) {
  extern __shared__ uint32_t col[];   // col[s * stride + w]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = (N + 31) >> 5;
  const uint8_t* C = cons + (size_t)blockIdx.x * N * N;
  // rows of whole 16-byte pieces
  const bool wide = (N & 31) == 0 && ((uintptr_t)C & 15) == 0;

  // 1. pack: block (rb, cb) of 32x32, lane = row 32rb + lane; a warp
  // loads kInFlight blocks before it transposes them
  const int blocks = words * words, step = (blockDim.x >> 5) * kInFlight;
  for (int blk0 = warp * kInFlight; blk0 < blocks; blk0 += step) {
    uint32_t b[kInFlight][8];   // 32 bytes a block, 4 a word
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int blk = blk0 + q, rb = blk / words, cb = blk % words;
      const int row = (rb << 5) + lane, c0 = cb << 5;
#pragma unroll
      for (int w = 0; w < 8; ++w) b[q][w] = 0;
      if (blk < blocks && row < N) {
        const uint8_t* p = C + (size_t)row * N + c0;
        if (wide) {
          const uint4 q0 = *(const uint4*)p, q1 = *(const uint4*)(p + 16);
          b[q][0] = q0.x; b[q][1] = q0.y; b[q][2] = q0.z; b[q][3] = q0.w;
          b[q][4] = q1.x; b[q][5] = q1.y; b[q][6] = q1.z; b[q][7] = q1.w;
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c)
            if (c0 + c < N)
              b[q][c >> 2] |= (uint32_t)(p[c] != 0) << ((c & 3) << 3);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int blk = blk0 + q;
      if (blk >= blocks) break;   // alike on every lane
      const int rb = blk / words, c0 = (blk % words) << 5;
      uint32_t mine = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const uint32_t m =
            __ballot_sync(kFull, (b[q][c >> 2] >> ((c & 3) << 3)) & 0xff);
        if (lane == c) mine = m;
      }
      if (c0 + lane < N) col[(c0 + lane) * stride + rb] = mine;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 2. the chain, on warp 0
  const int j0 = lane * kWarpItems;
  const int shift = (lane & 1) * kWarpItems;   // the lane's half of a word
  int nm[kWarpItems], cnt[kWarpItems];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kWarpItems; ++k) {
    const bool in = j0 + k < N;
    nm[k] = in ? num[(size_t)blockIdx.x * N + j0 + k] : 0;
    live |= (unsigned)in << k;
  }
  const int seed = warp_argmax(nm, live);
  unsigned member = seed / kWarpItems == lane ? 1u << (seed % kWarpItems) : 0;
  unsigned compat = 0;
  // (a lane past N reads no word: its items' counts stay unused)
  const uint32_t first =
      live ? col[seed * stride + (lane >> 1)] >> shift : 0;
#pragma unroll
  for (int k = 0; k < kWarpItems; ++k) {
    cnt[k] = (first >> k) & 1;   // cons[j, seed]
    if ((live >> k) & 1)
      compat |= (unsigned)(C[(size_t)seed * N + j0 + k] != 0) << k;
  }
  int size = 1;
  for (int it = 0;; ++it) {
    const unsigned cand = compat & ~member, lose = member & ~compat;
    const int sum = __reduce_add_sync(kFull, __popc(cand) - __popc(lose));
    if (!(sum > 0 && it < N)) break;
    int v[kWarpItems];   // num * (compatible - clique)
#pragma unroll
    for (int k = 0; k < kWarpItems; ++k)
      v[k] = ((cand >> k) & 1) ? nm[k]
             : ((lose >> k) & 1) ? (int)(0u - (unsigned)nm[k]) : 0;
    const int sel = warp_argmax(v, live);
    const int owner = sel / kWarpItems, bit = sel % kWarpItems;
    const bool grows = !((__shfl_sync(kFull, member, owner) >> bit) & 1);
    if (grows) {
      if (lane == owner) member |= 1u << bit;
      ++size;
      const uint32_t c = live ? col[sel * stride + (lane >> 1)] >> shift : 0;
#pragma unroll
      for (int k = 0; k < kWarpItems; ++k) cnt[k] += (c >> k) & 1;
    }
    unsigned next = 0;
#pragma unroll
    for (int k = 0; k < kWarpItems; ++k)
      next |= (unsigned)(cnt[k] >= size) << k;
    next &= live;
    if (!grows && !__any_sync(kFull, next != compat)) break;
    compat = next;
  }
#pragma unroll
  for (int k = 0; k < kWarpItems; ++k)
    if ((live >> k) & 1)
      out[(size_t)blockIdx.x * N + j0 + k] = (member >> k) & 1;
}

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
    const long long other = __shfl_xor_sync(kFull, key, off);
    key = other > key ? other : key;
  }
  sum = __reduce_add_sync(kFull, sum);
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
__global__ void __launch_bounds__(kMaxThreads) block_clique_kernel(
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
            __ballot_sync(kFull, i < N && C[(size_t)r * N + i]);
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int words = (N + 31) / 32, stride = words | 1;
  if (N <= kWarpMaxN) {
    const int warps = words * words < kPackWarps ? words * words : kPackWarps;
    warp_clique_kernel<<<clouds, warps * 32,
                         (size_t)N * stride * sizeof(uint32_t), st>>>(
        cons, num, out, N, stride);
  } else if (N <= kBitsMaxN) {
    const int threads = N < kMaxThreads ? words * 32 : kMaxThreads;
    const size_t smem = (size_t)N * stride * sizeof(uint32_t);
    static bool raised = false;   // the attribute, once a process
    if (smem > 48 * 1024 && !raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          block_clique_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)((size_t)kBitsMaxN * (((kBitsMaxN + 31) / 32) | 1) *
                sizeof(uint32_t)));
      if (e != cudaSuccess) return (int)e;
      raised = true;
    }
    block_clique_kernel<true><<<clouds, threads, smem, st>>>(cons, num, out,
                                                             N, stride);
  } else {
    block_clique_kernel<false><<<clouds, kMaxThreads, 0, st>>>(cons, num,
                                                               out, N, 0);
  }
  return (int)cudaGetLastError();
}
