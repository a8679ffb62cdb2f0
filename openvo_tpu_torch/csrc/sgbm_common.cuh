// Shared by the SGBM kernels of csrc/sgbm.cu and csrc/sgbm_wta.cu (the
// kernels, their designs and what bounds them are described at the top of
// csrc/sgbm.cu): the arithmetic traits X2 and F32, the parts of the warp
// walks, and launch helpers. Each source compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kBig = 1 << 28;   // x2 grid: L outside the disparity range
constexpr float kBigF = 1e9f;   // x1 grid: the JAX package's carry and fill
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory of a block
constexpr int kWalkWarps = 4;   // rows (one warp each) in a warp-walk block

// First L of a scan: float32 (c + 1e9) - 1e9 on the x1 grid rounds c
// half-to-even to a multiple of 64, i.e. c2 to a multiple of 128 here.
__device__ __forceinline__ int fresh_start(int c2) {
  return (int)rintf((float)c2 * (1.0f / 128.0f)) * 128;
}

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ unsigned vmin(unsigned a, unsigned b) {
  return min(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ unsigned long long vmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// Min of a lane's N slots, as a tree.
template <typename V, int N>
__device__ __forceinline__ V lane_min(const V (&v)[N]) {
  V t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = v[k];
#pragma unroll
  for (int s = N / 2; s > 0; s /= 2) {
#pragma unroll
    for (int k = 0; k < s; ++k) t[k] = vmin(t[k], t[k + s]);
  }
  return t[0];
}

// n / D for 0 <= n < 2^31 by a multiply and a shift, exact (Granlund and
// Montgomery): m = ceil(2^(31 + l) / D), l the least with 2^l >= D.
struct DivD {
  unsigned m;
  int s, D;
  __device__ explicit DivD(int d) : D(d) {
    int l = 0;
    while ((1 << l) < d) ++l;
    s = 31 + l;
    m = (unsigned)(((1ull << s) + d - 1) / d);
  }
  __device__ int quot(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> s);
  }
};

// The int16 path on the x2 grid.
struct X2 {
  using C = int16_t;
  using L = int;
  static constexpr bool kSumsExact = true;
  using Key = int;  // S * D + d: its min is min S with the lowest d
  static constexpr Key kKeyMax = INT_MAX;
  __device__ static L big() { return kBig; }
  // min L' before a scan's fresh first step (which does not read it)
  __device__ static L start_minprev() { return 0; }
  // L at d from the previous L at d (mid), d - 1 (lo) and d + 1 (hi)
  __device__ static L step(L mid, L lo, L hi, L c, L minprev, L P1, L P2,
                           bool fresh) {
    if (fresh) return fresh_start(c);
    int cand = min(mid, min(lo, hi) + P1);
    cand = min(cand, minprev + P2);
    return c + cand - minprev;
  }
  __device__ static L warp_all_min(L v) { return __reduce_min_sync(kFull, v); }
  // (lowest d of min S, min S) over a warp's slots: one redux of the key
  template <int VPL>
  __device__ static void warp_argmin(const L (&S)[VPL], int n, int d0,
                                     const DivD& dv, int& best, L& ms) {
    Key k[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      k[j] = j < n ? key(S[j], d0 + j, dv.D) : kKeyMax;
    const Key m = __reduce_min_sync(kFull, lane_min(k));
    ms = dv.quot(m);
    best = m - ms * dv.D;
  }
  __device__ static L add(L a, L b) { return a + b; }
  // many lines of many directions add into one element: any order is exact
  __device__ static void add_to(L* acc, L v) { atomicAdd(acc, v); }
  __device__ static Key key(L S, int d, int D) { return S * D + d; }
  __device__ static int key_d(Key k, const DivD& dv) {
    return k - dv.quot(k) * dv.D;
  }
  __device__ static float x1(L S) { return 0.5f * (float)S; }
  // (s_m - s_p) / (2 denom) on the x2 grid is the x1 ratio, and both
  // operands are exact integers
  __device__ static float frac(L sm, L sp, L ms, int b, int D) {
    const int denom = sm + sp - 2 * ms;
    if (b > 0 && b < D - 1 && denom > 0)
      return __fdiv_rn((float)(sm - sp), fmaxf(2.0f * (float)denom, 1e-9f));
    return 0.0f;
  }
};

// The float32 path on the x1 grid: each operation rounds as the JAX
// package's _scan_dirs and _wta. A scan's first step reads a previous L of
// 1e9 everywhere and min L' = 1e9 (start_minprev), which gives the JAX
// carry's fresh-start rounding by itself, so `fresh` is unused. Every L
// and S is >= +0 (costs are,
// and L = (c + cand) - minprev with cand >= minprev), and the bits of a
// non-negative float order as an unsigned integer: the warp minima are
// integer reduxes of the bits.
struct F32 {
  using C = float;
  using L = float;
  static constexpr bool kSumsExact = false;
  // (bits of S) << 32 | d: its min is min S with the lowest d
  using Key = unsigned long long;
  static constexpr Key kKeyMax = ~0ull;
  __device__ static L big() { return kBigF; }
  __device__ static L start_minprev() { return kBigF; }
  __device__ static L step(L mid, L lo, L hi, L c, L minprev, L P1, L P2,
                           bool) {
    float cand = fminf(mid, __fadd_rn(fminf(lo, hi), P1));
    cand = fminf(cand, __fadd_rn(minprev, P2));
    return __fsub_rn(__fadd_rn(c, cand), minprev);
  }
  __device__ static L warp_all_min(L v) {
    return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(v)));
  }
  template <int VPL>
  __device__ static void warp_argmin(const L (&S)[VPL], int n, int d0,
                                     const DivD&, int& best, L& ms) {
    unsigned b[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) b[j] = j < n ? __float_as_uint(S[j]) : ~0u;
    const unsigned mb = __reduce_min_sync(kFull, lane_min(b));
    int dl = INT_MAX;
#pragma unroll
    for (int j = VPL - 1; j >= 0; --j)
      if (j < n && b[j] == mb) dl = d0 + j;
    best = __reduce_min_sync(kFull, dl);
    ms = __uint_as_float(mb);
  }
  __device__ static L add(L a, L b) { return __fadd_rn(a, b); }
  // one line per element in a launch, launches in the JAX sum order
  __device__ static void add_to(L* acc, L v) { *acc = __fadd_rn(*acc, v); }
  __device__ static Key key(L S, int d, int) {
    return ((Key)__float_as_uint(S) << 32) | (unsigned)d;
  }
  __device__ static int key_d(Key k, const DivD&) {
    return (int)(k & 0xffffffffu);
  }
  __device__ static float x1(L S) { return S; }
  __device__ static float frac(L sm, L sp, L ms, int b, int D) {
    const float denom = __fsub_rn(__fadd_rn(sm, sp), __fmul_rn(2.0f, ms));
    if (b > 0 && b < D - 1 && denom > 0.0f)
      return __fdiv_rn(__fsub_rn(sm, sp),
                       fmaxf(__fmul_rn(2.0f, denom), 1e-9f));
    return 0.0f;
  }
};

// ---------------------------------------------------------------------------
// Warp walks (H1's hwalk, H5, H2, H3)
// ---------------------------------------------------------------------------

// How a warp walk brings each column's inputs in (and H1's s1 out):
//   kRing:   a TMA ring in the warp's shared memory (Ring, ring_walk): the
//            volumes' rows are contiguous, so lane 0 fetches a chunk of
//            columns of each input with one bulk copy (cp.async.bulk) that
//            signals the stage's mbarrier, a few chunks ahead, and sends
//            H1's s1 back with one bulk copy a chunk; the lanes read and
//            write shared memory only. Needs D a multiple of 8 (16-byte
//            columns), every volume 16-byte aligned and at most 8 slots a
//            lane.
//   kScalar: each lane loads its slots one by one into registers, kPrefetch
//            columns ahead (walk), and stores them one by one: any D (the
//            port launches it at 32 slots a lane only).
//   kVector: as kScalar with vector loads and stores: D a multiple of the
//            slots a lane, aligned volumes, at most 8 slots a lane.
// Each kernel takes the faster of kRing and kVector where its shapes allow
// (openvo_tpu_torch/tools/probe_warp_walk.cu times both): hwalk (H1's walk
// and H5) and H3 over float32 C the ring, H3 over int16 C and H2 vector
// loads; else kScalar.
enum Feed : int { kScalar, kVector, kRing };

// Columns loaded ahead of a register-fed walk: enough to cover a
// device-memory load under the walk's access pattern (8 at 4 slots a lane),
// fewer for wide lanes (registers).
template <int VPL>
constexpr int kPrefetch = VPL <= 4 ? 8 : 32 / VPL;


__device__ __forceinline__ void from_bits(int& v, unsigned w) { v = (int)w; }
__device__ __forceinline__ void from_bits(float& v, unsigned w) {
  v = __uint_as_float(w);
}
__device__ __forceinline__ void from_bits(int16_t& v, unsigned w) {
  v = (int16_t)(w & 0xffffu);
}

// Read-only loads as volatile inline PTX: the compiler keeps each where the
// walk issues it, PF columns ahead of its use. (It folds plain loads into a
// loop-carried register buffer back to the point of use, which puts a
// device-memory latency on every column.)
__device__ __forceinline__ unsigned ldg_b16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ldg_b32(const void* p) {
  unsigned v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ldg_v2(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 ldg_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// NW 32-bit words at p (16-byte aligned when NW >= 4), in vector loads:
// volatile read-only loads from device memory (kGlobal) or plain loads
// from shared memory.
template <bool kGlobal, int NW>
__device__ __forceinline__ void load_words(unsigned (&w)[NW], const void* p) {
  if constexpr (NW >= 4) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4* q4 = static_cast<const uint4*>(p) + i;
      const uint4 q = kGlobal ? ldg_v4(q4) : *q4;
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 q = kGlobal ? ldg_v2(p) : *static_cast<const uint2*>(p);
    w[0] = q.x;
    w[1] = q.y;
  } else {
    w[0] = kGlobal ? ldg_b32(p) : *static_cast<const unsigned*>(p);
  }
}

// A full lane's N slots at p in vector loads (p aligned to their size).
template <bool kGlobal, typename T, int N>
__device__ __forceinline__ void load_full(T (&v)[N], const T* p) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes < 4) {  // one int16
    v[0] = kGlobal ? (T)ldg_b16(p) : *p;
  } else {
    unsigned w[kBytes / 4];
    load_words<kGlobal>(w, p);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (sizeof(T) == 2)
        from_bits(v[k], w[k / 2] >> (16 * (k & 1)));
      else
        from_bits(v[k], w[k]);
    }
  }
}

// A lane's slots of one pixel from device memory: the first n <= N of them
// from p (the rest keep their value). With kVec (D a multiple of VPL and
// the volume 16-byte aligned, so a lane holds all its slots or none) a full
// lane loads them in vector loads, else one by one.
template <bool kVec, typename T, int N>
__device__ __forceinline__ void load_slots(T (&v)[N], const T* p, int n) {
  if constexpr (kVec) {
    if (n == N) load_full<true>(v, p);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < n) {
        if constexpr (sizeof(T) == 2)
          from_bits(v[k], ldg_b16(p + k));
        else
          from_bits(v[k], ldg_b32(p + k));
      }
    }
  }
}

__device__ __forceinline__ int to_bits(int v) { return v; }
__device__ __forceinline__ int to_bits(float v) { return __float_as_int(v); }

// A lane's first n <= N slots to p (int32 or float32), as load_slots.
template <bool kVec, typename T, int N>
__device__ __forceinline__ void store_slots(T* p, const T (&v)[N], int n) {
  static_assert(sizeof(T) == 4, "int32 or float32 slots");
  if constexpr (kVec) {
    if (n == N) {
      int* q = reinterpret_cast<int*>(p);
      if constexpr (N >= 4) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
          reinterpret_cast<int4*>(q)[i] =
              make_int4(to_bits(v[4 * i]), to_bits(v[4 * i + 1]),
                        to_bits(v[4 * i + 2]), to_bits(v[4 * i + 3]));
      } else if constexpr (N == 2) {
        *reinterpret_cast<int2*>(q) = make_int2(to_bits(v[0]), to_bits(v[1]));
      } else {
        q[0] = to_bits(v[0]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) p[k] = v[k];
  }
}

// Walk W columns (left to right if kForward, else right to left): step(col,
// x, fresh) for each column x in turn, fresh std::true_type at the walk's
// first column (a scan's fresh start) and std::false_type after it, with
// each column's inputs loaded PF columns ahead by load(col, x) into a
// rotating set of registers. The main loop's PF columns
// carry no branch (a load past the last column reads the last column
// again), so the compiler can interleave one column's work with the next
// one's; the first PF columns and the last W % PF go on their own.
template <int PF, bool kForward, typename Col, typename Load, typename Step>
__device__ __forceinline__ void walk(int W, Load&& load, Step&& step) {
  auto xof = [&](int t) { return kForward ? t : W - 1 - t; };
  auto one = [&](int t, Col& slot, auto fresh) {
    const Col cur = slot;
    load(slot, xof(min(t + PF, W - 1)));
    step(cur, xof(t), fresh);
  };
  Col buf[PF] = {};
#pragma unroll
  for (int j = 0; j < PF; ++j) load(buf[j], xof(min(j, W - 1)));
  one(0, buf[0], std::true_type());
#pragma unroll
  for (int j = 1; j < PF; ++j)
    if (j < W) one(j, buf[j], std::false_type());
  int t0 = PF;
  for (; t0 + PF <= W; t0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) one(t0 + j, buf[j], std::false_type());
  }
#pragma unroll
  for (int j = 0; j < PF; ++j)
    if (t0 + j < W) one(t0 + j, buf[j], std::false_type());
}

// The TMA (bulk copy) and mbarrier instructions of the ring.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(unsigned bar, int parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until at most N of this thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A warp's TMA ring: NS stages in shared memory at mem, each holding CH
// columns (a chunk) of the NIN input volumes and (kOut) of the output volume,
// then one mbarrier a stage. row[i] is the warp's row of volume i (inputs
// first), col[i] its bytes per column (a multiple of 16). Lane 0 issues every
// copy.
template <int CH, int NS, int NIN, bool kOut>
struct Ring {
  static constexpr int kVols = NIN + (kOut ? 1 : 0);
  unsigned char* mem;
  unsigned char* row[kVols];
  int col[kVols];

  __device__ int stage_bytes() const {
    int b = 0;
#pragma unroll
    for (int i = 0; i < kVols; ++i) b += col[i];
    return CH * b;
  }
  // volume i's part of stage s
  __device__ unsigned char* part(int s, int i) const {
    int off = 0;
#pragma unroll
    for (int j = 0; j < i; ++j) off += col[j];
    return mem + s * stage_bytes() + CH * off;
  }
  __device__ unsigned bar(int s) const {
    return smem_addr(mem + NS * stage_bytes() + 8 * s);
  }
  __device__ void init() const {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(bar(s));
    mbar_init_fence();
  }
  // the inputs' columns [x0, x0 + n) into stage s
  __device__ void fetch(int s, int x0, int n) const {
    int total = 0;
#pragma unroll
    for (int i = 0; i < NIN; ++i) total += n * col[i];
    mbar_expect(bar(s), total);
#pragma unroll
    for (int i = 0; i < NIN; ++i)
      bulk_load(smem_addr(part(s, i)), row[i] + (size_t)x0 * col[i],
                n * col[i], bar(s));
  }
  __device__ void wait(int s, int parity) const {
    while (!mbar_done(bar(s), parity)) {
    }
  }
};

// Walk W columns through a ring (as walk: left to right if kForward, fresh a
// type, true at the first column) in chunks of CH: step(col, x, fresh, s,
// slot), with col = read(s, slot) the lane's inputs of the column in slot
// `slot` of stage s, and the output, if any, written into the same slot of
// stage s's output part. A full chunk's columns are read from shared memory
// at its start, so their latency overlaps the steps; the full chunks carry
// no branch, and the last W % CH columns go one at a time. After a chunk,
// the warp's lanes meet (__syncwarp), and lane 0 sends the chunk's output
// and fetches the chunk NS ahead into the stage.
template <int CH, bool kForward, int NS, int NIN, bool kOut, typename Read,
          typename Step>
__device__ __forceinline__ void ring_walk(int W, int lane,
                                          const Ring<CH, NS, NIN, kOut>& ring,
                                          Read&& read, Step&& step) {
  const int nch = (W + CH - 1) / CH;
  // chunk k's first column in memory order, and its columns
  auto x0_of = [&](int k) {
    return kForward ? k * CH : max(W - (k + 1) * CH, 0);
  };
  auto n_of = [&](int k) { return min(CH, W - k * CH); };
  if (lane == 0) {
    ring.init();
    for (int k = 0; k < NS && k < nch; ++k)
      ring.fetch(k, x0_of(k), n_of(k));
  }
  __syncwarp();
  // cols: the chunk's columns, std::integral_constant<int, CH> or an int
  auto chunk = [&](int k, auto cols, auto fresh) {
    int n;
    if constexpr (std::is_integral_v<decltype(cols)>)
      n = cols;
    else
      n = decltype(cols)::value;
    const int s = k % NS, x0 = x0_of(k);
    auto slot = [&](int j) { return kForward ? j : n - 1 - j; };
    ring.wait(s, (k / NS) & 1);
    if constexpr (std::is_integral_v<decltype(cols)>) {
      step(read(s, slot(0)), x0 + slot(0), fresh, s, slot(0));
      for (int j = 1; j < n; ++j)
        step(read(s, slot(j)), x0 + slot(j), std::false_type(), s, slot(j));
    } else {
      decltype(read(0, 0)) c[CH];  // a full chunk's columns, read up front
#pragma unroll
      for (int j = 0; j < CH; ++j) c[j] = read(s, slot(j));
      step(c[0], x0 + slot(0), fresh, s, slot(0));
#pragma unroll
      for (int j = 1; j < CH; ++j)
        step(c[j], x0 + slot(j), std::false_type(), s, slot(j));
    }
    // the lanes' shared-memory writes, seen by the bulk copy
    if constexpr (kOut)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      if constexpr (kOut) {
        bulk_store(ring.row[NIN] + (size_t)x0 * ring.col[NIN],
                   smem_addr(ring.part(s, NIN)), n * ring.col[NIN]);
        // chunk k + 1 writes the stage of chunk k + 1 - NS: that chunk's
        // store has read it once at most NS - 1 stores are still reading
        bulk_stores_read<NS - 1>();
      }
      if (k + NS < nch) ring.fetch(s, x0_of(k + NS), n_of(k + NS));
    }
    if constexpr (kOut) __syncwarp();
  };
  const int full = W / CH;
  int k = 0;
  if (full > 0) {
    chunk(0, std::integral_constant<int, CH>(), std::true_type());
    for (k = 1; k < full; ++k)
      chunk(k, std::integral_constant<int, CH>(), std::false_type());
  }
  if (k == 0)
    chunk(k, W, std::true_type());
  else if (k < nch)
    chunk(k, W - k * CH, std::false_type());
  if constexpr (kOut) {
    if (lane == 0) bulk_stores_done();
  }
}

// One SGM step of a warp's row: Lr (the previous L, lane l's slots d = VPL*l
// + k, n of them in the range) becomes the new L; minprev becomes its min.
template <typename P, int VPL>
__device__ __forceinline__ void warp_step(typename P::L (&Lr)[VPL],
                                          const typename P::L (&c)[VPL],
                                          typename P::L& minprev,
                                          typename P::L p1, typename P::L p2,
                                          bool fresh, int lane, int n) {
  using L = typename P::L;
  L lo0 = __shfl_up_sync(kFull, Lr[VPL - 1], 1);
  L hin = __shfl_down_sync(kFull, Lr[0], 1);
  if (lane == 0) lo0 = P::big();
  if (lane == 31) hin = P::big();
  L nl[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const L lo = k == 0 ? lo0 : Lr[k - 1];
    const L hi = k == VPL - 1 ? hin : Lr[k + 1];
    nl[k] = k < n ? P::step(Lr[k], lo, hi, c[k], minprev, p1, p2, fresh)
                  : P::big();
  }
  minprev = P::warp_all_min(lane_min(nl));
#pragma unroll
  for (int k = 0; k < VPL; ++k) Lr[k] = nl[k];
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_d(int D) { return D < 1 || D > 1024; }

// disparities per lane of a warp walk: D / 32 rounded up to a power of two
int slots_per_lane(int D) {
  int v = 1;
  while (32 * v < D) v *= 2;
  return v;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether a warp walk over these volumes can take the TMA ring (16-byte
// columns: D a multiple of 8) or vector loads (D a multiple of the slots a
// lane): aligned volumes and at most 8 slots a lane either way.
bool feed_fits(int feed, int D, std::initializer_list<const void*> vols) {
  const int vpl = slots_per_lane(D);
  bool ok = vpl <= 8 && D % (feed == kRing ? 8 : vpl) == 0;
  for (const void* p : vols) ok = ok && aligned16(p);
  return ok;
}

// Shared memory of a warp's ring of ns stages of ch columns at D, per_elem
// bytes a volume element (inputs and output), rounded to 16 bytes.
size_t ring_bytes(int ch, int ns, int D, int per_elem) {
  return (ns * ((size_t)ch * D * per_elem + 8) + 15) & ~(size_t)15;
}

// f(std::integral_constant<int, VPL>, std::integral_constant<int, feed>):
// D's slots per lane fed by kFast where `fast` (feed_fits), else one
// instantiation of 32 slots a lane and scalar loads, which takes any D.
// Every D of SGBMParams (a multiple of 16) up to 256 takes kFast.
template <int kFast, typename F>
int with_lanes(int D, bool fast, F&& f) {
  using Fast = std::integral_constant<int, kFast>;
  if (fast) {
    switch (slots_per_lane(D)) {
      case 1: return f(std::integral_constant<int, 1>(), Fast());
      case 2: return f(std::integral_constant<int, 2>(), Fast());
      case 4: return f(std::integral_constant<int, 4>(), Fast());
      case 8: return f(std::integral_constant<int, 8>(), Fast());
    }
  }
  return f(std::integral_constant<int, 32>(),
           std::integral_constant<int, kScalar>());
}

}  // namespace
