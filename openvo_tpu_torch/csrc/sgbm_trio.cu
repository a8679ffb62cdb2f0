// H2's trio over int16 C (the straight line and both diagonals, walked
// top-down or bottom-up, added into H1's s1) as one row-synchronous walk,
// for Hopper (sm_90a), bound with ctypes. ops/sgbm_cuda.vsweep takes it
// where the call allows (vsweep_design); csrc/sgbm.cu's vsweep_kernel keeps
// every other variant of H2 (the straight line alone, the carries, float32
// C, the scalar fallback, one or two frames).
//
// What bounds H2 on the H100. The trio reads C (2 bytes an element) and
// adds its three L into s1 (4 bytes read, 4 written): 598 MB a KITTI frame,
// 0.178 ms at 3.35 TB/s. vsweep_kernel walks each of the 4,476 lines with a
// warp and adds every pixel's L into s1 with a bulk reduce-add applied in
// L2, which bound it at 2.6-3.3x that floor. Here every pixel's three L are
// computed on the SM that owns the pixel, summed there, and added to s1
// read once and written once: C is read once, s1 once each way, and no
// atomic is left (0.209 ms a frame at 8 and 16 frames on the H100,
// tools/probe_warp_walk.cu).
//
// Design. A frame's width is cut into strips of nw * kTrioCols columns, a
// block a strip; warp w of a block owns kTrioCols neighbouring columns, its
// lanes holding d = VPL*l + k as in hwalk. The block walks every row in the
// order of travel (OpenCV's MODE_SGBM pass, calib3d/src/stereosgbm.cpp:
// rows in turn, each direction's previous-row L kept), the warp keeping its
// columns' previous-row L of all three directions in registers. A step of
// one line is warp_step as in the line walks (a shuffle each way, one
// redux.sync for min L'), and the warp's 3 * kTrioCols lines of a row are
// independent chains that interleave. The +1 diagonal at column x takes
// its previous L from column x - 1, the -1 diagonal from x + 1: inside the
// warp those are its own registers (the +1 lines updated right to left, the
// -1 lines left to right, so in place); across warps the edge columns' L
// pass through shared memory, double-buffered by row parity; across blocks
// through device memory (L2) as (value, tag) pairs in 4 rows of slots, the
// tag naming the step, so a reader needs no flag and a writer no fence. The
// slots lie in a scratch of the call's own, zeroed on its stream before the
// launch (tag 0 names no step), so launches on other streams share none.
// Each warp computes and publishes its edge columns' outgoing L first in a
// row, reads its neighbours' at the row's start and takes them last, so
// the hand-off has about a row's work to arrive. Blocks wait on one
// another, so the launch is cooperative (every block resident), and a grid
// too large for the card walks several frames a block in turn.
// Loads and stores: thread 0 brings each row of the strip's C and s1 into a
// ring of 3 stages in shared memory with two bulk copies (TMA) and an
// mbarrier, 2 rows ahead of the walk; the lanes write the row's sums back
// into its stage, and thread 0 sends them to s1 with one bulk copy. One
// block barrier a row frees the stage and publishes the warps' edges.
//
// Why not a thread-block cluster: a block of 16 warps holds 80 columns'
// state in registers (128 a thread), so a KITTI frame needs 16 SMs; the
// H100 keeps only 7 clusters of 16 (one block an SM) resident at once,
// cudaOccupancyMaxActiveClusters on the card, and 8 frames then take two
// waves; clusters of 8 keep 15 resident but leave 156 columns an SM, more
// state than the register file holds.
//
// Exact: int32 sums in any order, each line's fresh start (fresh_start) on
// the first row walked, on column 0 for the +1 diagonal and on column W - 1
// for the -1 diagonal (where vline starts those lines), P::big() beyond
// the disparity range.

#include "sgbm_common.cuh"

#include <algorithm>

namespace {

constexpr int kTrioCols = 5;        // columns a warp
constexpr int kTrioMaxWarps = 16;   // warps a block (512 threads)
constexpr int kTrioSlots = 4;       // rows of a block's edges in L2
constexpr int kTrioStages = 3;      // rows of C and s1 in shared memory
constexpr long long kTrioPolls = 1ll << 26;  // a missing edge is a fault

// A column's L in shared memory: D values, then their min, in rows of 16
// bytes.
__host__ __device__ inline int trio_edge(int D) { return D + 4; }

// A block's part of the scratch: kTrioSlots rows of its two edges (its last
// column's +1 L, for the block on its right; its first column's -1 L, for
// the one on its left), each value a (value, tag) pair of 32-bit words.
__host__ __device__ inline size_t trio_block_bytes(int D) {
  return (size_t)kTrioSlots * 2 * D * 2 * sizeof(unsigned);
}

// A lane's VPL slots of an edge in device memory as (value, tag) pairs,
// stored 16 (or 8) bytes at a time and read the same way, so a reader that
// finds a pair's tag finds its value (NCCL's LL protocol): the edge needs
// no fence and no flag.
template <int VPL>
struct Tagged {
  unsigned w[2 * VPL];
};
template <int VPL>
__device__ __forceinline__ void tagged_store(unsigned* p, const int (&v)[VPL],
                                             unsigned tag) {
  if constexpr (VPL == 1) {
    asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(p),
                 "r"(v[0]), "r"(tag)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < VPL; k += 2)
      asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(
                       p + 2 * k),
                   "r"(v[k]), "r"(tag), "r"(v[k + 1]), "r"(tag)
                   : "memory");
  }
}
template <int VPL>
__device__ __forceinline__ void tagged_load(Tagged<VPL>& e,
                                            const unsigned* p) {
  if constexpr (VPL == 1) {
    asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
                 : "=r"(e.w[0]), "=r"(e.w[1])
                 : "l"(p)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < 2 * VPL; k += 4)
      asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(e.w[k]), "=r"(e.w[k + 1]), "=r"(e.w[k + 2]),
                     "=r"(e.w[k + 3])
                   : "l"(p + k)
                   : "memory");
  }
}
template <int VPL>
__device__ __forceinline__ bool tagged_ok(const Tagged<VPL>& e,
                                          unsigned tag) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < VPL; ++k) ok = ok && e.w[2 * k + 1] == tag;
  return ok;
}

// The walk. Block b is strip b % nstrips of frames b / nstrips, b /
// nstrips + nslots, ... (one after another); ys = 1 walks top-down, -1
// bottom-up. kAllSlots: every lane holds VPL disparities (D = 32 * VPL), so
// no slot needs a test (it must not be named kFull: that would hide the full
// warp mask of sgbm_common.cuh from the warp intrinsics below). Shared memory: kTrioStages stages of a strip row (C,
// then s1), the warps' edges [row parity][+1, -1][warp][trio_edge(D)],
// kTrioStages mbarriers. The sums go back into the stage and out with one
// bulk copy a row, so a stage is fetched kTrioStages - 1 rows ahead, once
// the copy out of the row before has read it.
// Scratch: each block's edges, zeroed before the launch; the tag of step t's
// edges is t + 1.
template <int VPL, int K, bool kAllSlots>
__global__ void __launch_bounds__(32 * kTrioMaxWarps, 1)
    vsweep_trio_kernel(const int16_t* __restrict__ C, int* s1, int H, int W,
                       int D, int P1, int P2, int ys, int frames,
                       int nstrips, int nslots, unsigned char* scratch) {
  constexpr int ns = kTrioStages;
  static_assert(K >= 2, "a warp's edge columns are two columns");
  static_assert(std::is_same_v<decltype(kFull), const unsigned> &&
                    kFull == 0xffffffffu,
                "the warp intrinsics take the full warp's mask");
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int S = nw * K;
  const int slot = blockIdx.x / nstrips, s = blockIdx.x - slot * nstrips;
  const int x0 = s * S, ncols = min(S, W - x0), xw = x0 + warp * K;
  const int d0 = VPL * lane, E = trio_edge(D);
  const int n = kAllSlots ? VPL : min(max(D - d0, 0), VPL);
  const size_t cbytes = (size_t)S * D * sizeof(int16_t);
  const size_t stage = cbytes + (size_t)S * D * sizeof(int);
  int* xch = reinterpret_cast<int*>(smem + ns * stage);
  auto xslot = [&](int par, int dir, int w) {
    return xch + ((size_t)(par * 2 + dir) * nw + w) * E;
  };
  auto bar = [&](int st) {
    return smem_addr(xch + (size_t)4 * nw * E) + 8 * st;
  };
  // block b's edge dir of step t: this lane's pairs
  auto edge = [&](int b, int t, int dir) {
    return reinterpret_cast<unsigned*>(scratch +
                                       (size_t)b * trio_block_bytes(D)) +
           ((size_t)(t & (kTrioSlots - 1)) * 2 + dir) * 2 * D + 2 * d0;
  };
  const int rounds = (frames - slot + nslots - 1) / nslots;
  const int T = rounds * H;
  auto row_of = [&](int t, int& f, int& y) {
    const int round = t / H, r = t - round * H;
    f = slot + round * nslots;
    y = ys > 0 ? r : H - 1 - r;
  };
  // thread 0: strip row t's C and s1 into stage t % ns
  auto fetch = [&](int t) {
    int f, y;
    row_of(t, f, y);
    const size_t px = ((size_t)f * H + y) * W + x0;
    unsigned char* at = smem + (t % ns) * stage;
    mbar_expect(bar(t % ns), ncols * D * (int)(sizeof(int16_t) + sizeof(int)));
    bulk_load(smem_addr(at), C + px * D, ncols * D * (int)sizeof(int16_t),
              bar(t % ns));
    bulk_load(smem_addr(at + cbytes), s1 + px * D,
              ncols * D * (int)sizeof(int), bar(t % ns));
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < ns; ++st) mbar_init(bar(st));
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < ns - 1 && t < T; ++t) fetch(t);

  const int p1 = P1, p2 = P2;
  int L0[K][VPL], L1[K][VPL], L2[K][VPL], m0[K], m1[K], m2[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) L0[i][k] = L1[i][k] = L2[i][k] = 0;
    m0[i] = m1[i] = m2[i] = 0;
  }
  // a block-edge warp's neighbour: the block on its left (warp 0) or right
  // (warp nw - 1), whose edge of the previous row it takes
  const bool from_left = warp == 0 && s > 0;
  const bool from_right = warp == nw - 1 && s + 1 < nstrips;

  for (int t = 0; t < T; ++t) {
    int f, y;
    row_of(t, f, y);
    const bool first = t % H == 0;
    const int st = t % ns, par = t & 1;
    const unsigned tag = (unsigned)t + 1;
    // the neighbours' edges of step t - 1, read now, used last
    Tagged<VPL> eL, eR;
    if (from_left && t > 0 && n == VPL)
      tagged_load(eL, edge(blockIdx.x - 1, t - 1, 0));
    if (from_right && t > 0 && n == VPL)
      tagged_load(eR, edge(blockIdx.x + 1, t - 1, 1));
    while (!mbar_done(bar(st), (t / ns) & 1)) {
    }
    const int16_t* Cs = reinterpret_cast<const int16_t*>(smem + st * stage);
    int* As = reinterpret_cast<int*>(smem + st * stage + cbytes);
    // column i's line of a direction: out (L, min) from the previous L of
    // its line (prev, mprev) and the column's C
    auto step = [&](int (&out)[VPL], int& mout, const int (&prev)[VPL],
                    int mprev, int i, bool fresh) {
      int16_t cv[VPL] = {};
      if (n == VPL) load_full<false>(cv, Cs + (size_t)(warp * K + i) * D + d0);
      int c[VPL], Lr[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) c[k] = cv[k], Lr[k] = prev[k];
      int mp = mprev;
      warp_step<X2, VPL>(Lr, c, mp, p1, p2, fresh, lane, n);
#pragma unroll
      for (int k = 0; k < VPL; ++k) out[k] = Lr[k];
      mout = mp;
    };
    auto put = [&](int* p, const int (&v)[VPL], int mv) {
      store_slots<true>(p + d0, v, n);
      if (lane == 0) p[D] = mv;
    };
    // a neighbour's edge (pairs e, read from p) as a previous L and its
    // min; re-read until every pair holds the tag of its step. Every step
    // waits so, also where the line starts afresh: that keeps the blocks
    // within kTrioSlots rows of one another.
    auto take = [&](Tagged<VPL>& e, const unsigned* p, int (&prev)[VPL],
                    int& mp) {
      long long polls = 0;
      while (!__all_sync(kFull, n != VPL || tagged_ok(e, tag - 1))) {
        if (++polls == kTrioPolls) __trap();
        if (n == VPL) tagged_load(e, p);
      }
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        prev[k] = n == VPL ? (int)e.w[2 * k] : kBig;
      mp = __reduce_min_sync(kFull, lane_min(prev));
    };

    // The row's work. Fresh starts: the first row walked; column 0 for +1,
    // W - 1 for -1; columns beyond the image keep fresh (bounded) values.
    // Only the first row and the warps at the image's edges start lines
    // (maybe: std::true_type), so every other warp's row is compiled
    // without a fresh start's arithmetic.
    auto row = [&](auto maybe) {
      constexpr bool kMaybe = decltype(maybe)::value;
      auto fresh0 = [&](int i) { return kMaybe && (first || xw + i >= W); };
      auto fresh1 = [&](int i) {
        return kMaybe && (first || xw + i == 0 || xw + i >= W);
      };
      auto fresh2 = [&](int i) {
        return kMaybe && (first || xw + i >= W - 1);
      };

      // the edges this warp sends: column K - 1's +1 line, column 0's -1 line
      step(L1[K - 1], m1[K - 1], L1[K - 2], m1[K - 2], K - 1, fresh1(K - 1));
      put(xslot(par, 0, warp), L1[K - 1], m1[K - 1]);
      if (from_right && n == VPL)
        tagged_store(edge(blockIdx.x, t, 0), L1[K - 1], tag);
      step(L2[0], m2[0], L2[1], m2[1], 0, fresh2(0));
      put(xslot(par, 1, warp), L2[0], m2[0]);
      if (from_left && n == VPL)
        tagged_store(edge(blockIdx.x, t, 1), L2[0], tag);

      // the lines whose previous L the warp holds
#pragma unroll
      for (int i = K - 2; i >= 1; --i)
        step(L1[i], m1[i], L1[i - 1], m1[i - 1], i, fresh1(i));
#pragma unroll
      for (int i = 1; i <= K - 2; ++i)
        step(L2[i], m2[i], L2[i + 1], m2[i + 1], i, fresh2(i));
#pragma unroll
      for (int i = 0; i < K; ++i)
        step(L0[i], m0[i], L0[i], m0[i], i, fresh0(i));

      // the edges this warp receives, from the previous row: column -1's +1
      // line (the warp on the left, or the block's), column K's -1 line
      {
        int prev[VPL], mp = 0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) prev[k] = kBig;
        const bool fr = fresh1(0);
        if (warp > 0) {
          const int* p = xslot(par ^ 1, 0, warp - 1);
          if (!fr && n == VPL) load_full<false>(prev, p + d0);
          if (!fr) mp = p[D];
        } else if (s > 0 && t > 0) {
          take(eL, edge(blockIdx.x - 1, t - 1, 0), prev, mp);
        }
        step(L1[0], m1[0], prev, mp, 0, fr);
      }
      {
        int prev[VPL], mp = 0;
#pragma unroll
        for (int k = 0; k < VPL; ++k) prev[k] = kBig;
        const bool fr = fresh2(K - 1);
        if (warp < nw - 1) {
          const int* p = xslot(par ^ 1, 1, warp + 1);
          if (!fr && n == VPL) load_full<false>(prev, p + d0);
          if (!fr) mp = p[D];
        } else if (s + 1 < nstrips && t > 0) {
          take(eR, edge(blockIdx.x + 1, t - 1, 1), prev, mp);
        }
        step(L2[K - 1], m2[K - 1], prev, mp, K - 1, fr);
      }

      // s1 += L(0) + L(+1) + L(-1) at the warp's columns in the image,
      // into the stage
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (xw + i >= W) continue;
        int a[VPL] = {};
        if (n == VPL)
          load_full<false>(a, As + (size_t)(warp * K + i) * D + d0);
#pragma unroll
        for (int k = 0; k < VPL; ++k) a[k] += L0[i][k] + L1[i][k] + L2[i][k];
        store_slots<true>(As + (size_t)(warp * K + i) * D + d0, a, n);
      }
      // the lanes' writes to the stage, seen by the bulk copy out
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    };
    if (first || xw == 0 || xw + K - 1 >= W - 1)
      row(std::true_type());
    else
      row(std::false_type());
    // every warp is done with the stage and has put its edges
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(s1 + (((size_t)f * H + y) * W + x0) * D, smem_addr(As),
                 ncols * D * (int)sizeof(int));
      // the stage of row t + ns - 1 held row t - 1: its copy out has read
      // it once at most one copy (this row's) still reads
      bulk_stores_read<1>();
      if (t + ns - 1 < T) fetch(t + ns - 1);
    }
  }
  if (threadIdx.x == 0) bulk_stores_done();
}

// Shared memory of a block of nw warps.
size_t trio_smem(int nw, int D) {
  const size_t S = (size_t)nw * kTrioCols;
  return kTrioStages * S * D * (sizeof(int16_t) + sizeof(int)) +
         (size_t)4 * nw * trio_edge(D) * sizeof(int) + 8 * kTrioStages;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The walk over `frames` frames of (H, W, D) in one cooperative launch of
// blocks of nw warps: as many frames at once as the card keeps resident
// (and the scratch has room for), the rest in turn. The part of the scratch
// the blocks use is zeroed on the stream first.
template <int VPL, bool kAllSlots>
int launch_trio(const int16_t* C, int* s1, int H, int W, int D, int P1,
                int P2, int up, int frames, unsigned char* scratch,
                long long scratch_bytes, cudaStream_t stream, int nw) {
  auto kernel = vsweep_trio_kernel<VPL, kTrioCols, kAllSlots>;
  const size_t smem = trio_smem(nw, D);
  int per_sm = 0;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int e = set_smem((const void*)kernel, smem);
  if (e) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         32 * nw, smem);
  if (e) return e;
  const int S = nw * kTrioCols, nstrips = (W + S - 1) / S;
  const long long room = scratch_bytes / (long long)trio_block_bytes(D);
  const long long blocks_max =
      std::min<long long>((long long)per_sm * sm_count(), room);
  const int nslots = (int)std::min<long long>(frames, blocks_max / nstrips);
  if (nslots < 1) return (int)cudaErrorInvalidValue;
  e = (int)cudaMemsetAsync(scratch, 0,
                           (size_t)nslots * nstrips * trio_block_bytes(D),
                           stream);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nslots * nstrips);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, C, s1, H, W, D, P1, P2,
                              up ? -1 : 1, frames, nstrips, nslots, scratch);
  return e ? e : (int)cudaGetLastError();
}

// Warps a block: 16 (80 columns a block, one an SM) where the frames' strips
// reach 90% of the SMs, else 8 (40 columns, two an SM): of 4, 8 and 16 the
// fastest at 3-16 KITTI frames (tools/probe_warp_walk.cu).
int trio_warps(int W, int frames) {
  const int S = kTrioMaxWarps * kTrioCols;
  return (long long)frames * ((W + S - 1) / S) * 10 >= 9LL * sm_count()
             ? kTrioMaxWarps
             : kTrioMaxWarps / 2;
}

}  // namespace

extern "C" {

// Bytes of scratch that any launch of H2's trio walk on the current device
// has room in (a block's edges for 4 blocks an SM at D = 128). The launch
// zeroes the part it uses on its stream, so a call's scratch needs no
// zeroing and is the call's own.
int ovo_vsweep_trio_scratch() {
  return (int)((size_t)sm_count() * 4 * trio_block_bytes(128));
}

// The trio of int16 C (frames volumes of (H, W, D)) walked top-down, or
// bottom-up where `up`, added into s1: D a multiple of 8 up to 128, C and
// s1 16-byte aligned, on a scratch that no launch in flight shares.
int ovo_vsweep_trio(const void* C, void* s1, int H, int W, int D, int P1,
                    int P2, int up, int frames, void* scratch,
                    long long scratch_bytes, void* stream) {
  if (D < 8 || D > 128 || D % 8 || H <= 0 || W <= 0 || frames <= 0 ||
      !aligned16(C) || !aligned16(s1) || !aligned16(scratch) ||
      (long long)frames * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int nw = trio_warps(W, frames);
  auto go = [&](auto vpl) {
    constexpr int kVpl = decltype(vpl)::value;
    auto launch = kVpl * 32 == D ? launch_trio<kVpl, true>
                                 : launch_trio<kVpl, false>;
    return launch((const int16_t*)C, (int*)s1, H, W, D, P1, P2, up, frames,
                  (unsigned char*)scratch, scratch_bytes,
                  (cudaStream_t)stream, nw);
  };
  switch (slots_per_lane(D)) {
    case 1: return go(std::integral_constant<int, 1>());
    case 2: return go(std::integral_constant<int, 2>());
    default: return go(std::integral_constant<int, 4>());
  }
}

}  // extern "C"
