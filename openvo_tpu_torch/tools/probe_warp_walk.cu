// How the SGBM warp walks' feeds and block sizes compare: times H1's two
// kernels (bt_box, hwalk), H2, H5 and H3 at KITTI shapes (376 x 1242, D =
// 128) on random inputs, each by CUDA events over 20 launches (the lower of
// two rounds), and checks that every variant gives the first one's output
// bit for bit:
//   - hwalk and H3 in each of their feeds (the TMA ring, the vector
//     register prefetch, the scalar one) at 1 to 4 warps (rows) a block;
//   - H2 over int16 C (the top-down trio, both trios, the straight line
//     down and both ways, each in one launch) and over float32 C (the trio
//     in three launches, one a direction): first as the port launches it
//     (launch_vsweep), then the variants this file keeps (vsweep_variant_
//     kernel: the port's walk in other feeds, a ring of one bulk copy a
//     pixel among them; other ways of adding into the sum, reductions from
//     the lanes among them; other tunings), plus the walk with plain stores
//     in place of the adds (its output is wrong: timing only), and the
//     port's scalar fallback;
//   - H2's top-down trio over 1-4, 8 and 16 frames (the cells run 1, 8 and
//     16; 2-4 show where the trio walk starts to win): the port's line
//     walk, the same walk with plain stores, and the trio walk
//     (csrc/sgbm_trio.cu) at 16, 8 and 4 warps a block, with and without
//     its slot tests (`probe trio` times these alone);
//   - H5 (hwalk over float32 C) in the vector feed and in rings of several
//     geometries.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o probe openvo_tpu_torch/tools/probe_warp_walk.cu && ./probe
//
// It includes csrc/sgbm.cu, csrc/sgbm_trio.cu and csrc/sgbm_wta.cu, so it
// times the kernels the port builds; H2's line-walk variants live here
// only.

#include "../csrc/sgbm.cu"
#include "../csrc/sgbm_trio.cu"
#include "../csrc/sgbm_wta.cu"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int H = 376, W = 1242, D = 128, VPL = 4, R = 2;

// ---------------------------------------------------------------------------
// H2's variants that the port does not build: other feeds, adds and
// tunings, each timed against the port's kernel (csrc/sgbm.cu)
// ---------------------------------------------------------------------------

// How a variant over int16 C adds a line's L into the int32 sum (any order
// is exact):
//   kRed:    each lane's own reductions to device memory (red.global.add),
//            its slots two at a time as one 64-bit add where it holds an
//            aligned pair: every L and every partial sum is >= 0 and below
//            2^31, so the low word's sum never carries into the high one;
//   kTmaAdd: as the port: the warp stages a few pixels' L in its shared
//            memory (VTune's out_rows a stage), and lane i sends the stage's
//            pixel i with one bulk reduce-add;
//   kStore:  plain stores, which lose the sum: only to time the walk
//            without its adds.
enum VOut : int { kRed, kTmaAdd, kStore };

__device__ __forceinline__ void red_add_pair(int* p, int lo, int hi) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            ((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

// How a variant is tuned: a register feed loads its pixels `ahead` steps
// ahead; the kernel keeps to the registers (launch bounds) that let
// `blocks` blocks of 4 warps share an SM; the directions' lines interleave
// (the port's vline) or come direction by direction; kTmaAdd's stages hold
// out_rows pixels each, out_stages of them. The port's tuning is
// VTune<4, 8, true, 4, 2> over int16 C at 4 slots a lane.
template <int ahead, int blocks, bool interleave, int out_rows,
          int out_stages>
struct VTune {
  static constexpr int kAhead = ahead, kBlocks = blocks;
  static constexpr bool kInterleave = interleave;
  static constexpr int kOutRows = out_rows, kOutStages = out_stages;
};

// The ring's geometry: stages of 8 pixels, 3 of them.
constexpr int kLineChunk = 8, kLineStages = 3;

// Line b of a launch: the port's interleaved order, or each direction's
// lines in turn.
template <bool kInterleave>
__device__ __forceinline__ VLine vline_in(int b, int H, int W, int dir0,
                                          int ndirs, int down, int per_way) {
  if (kInterleave) return vline(b, H, W, dir0, ndirs, down, per_way);
  VLine v;
  const bool up = !(down && b < per_way);
  if (b >= per_way) b -= per_way;
  v.j = dir0;
  for (int lines = v.j == 0 ? W : W + H - 1; b >= lines;
       lines = W + H - 1) {
    b -= lines;
    ++v.j;
  }
  v.dx = v.j == 0 ? 0 : (v.j == 1 ? 1 : -1);
  v.ys = up ? -1 : 1;
  v.y = up ? H - 1 : 0;
  v.x = b;
  if (b >= W) {
    v.y += v.ys * (b - W + 1);
    v.x = v.dx == 1 ? 0 : W - 1;
  }
  v.len = up ? v.y + 1 : H - v.y;
  if (v.dx == 1) v.len = min(v.len, W - v.x);
  if (v.dx == -1) v.len = min(v.len, v.x + 1);
  return v;
}

// A warp's TMA ring over one scan line: NS stages in shared memory at mem,
// each holding CH pixels of the line (their D values of each of NIN
// volumes), then one mbarrier a stage. A line's pixels lie (ys*W + dx)*D
// elements apart, so each pixel comes in a bulk copy of its own: lane 0
// arms the stage's mbarrier with the chunk's bytes, then lane i < CH
// copies the chunk's pixel i. A volume of 0 bytes a pixel is not fetched.
template <int CH, int NS, int NIN>
struct LineRing {
  static_assert(CH <= 32, "a lane per pixel of a chunk");
  unsigned char* mem;
  const unsigned char* px0[NIN];  // volume i at the line's first pixel
  long long next[NIN];            // bytes from one pixel to the next
  int bytes[NIN];                 // of a pixel's D values: a multiple of 16

  __device__ int stage_bytes() const {
    int b = 0;
#pragma unroll
    for (int i = 0; i < NIN; ++i) b += bytes[i];
    return CH * b;
  }
  __device__ unsigned char* part(int s, int i) const {
    int off = 0;
#pragma unroll
    for (int j = 0; j < i; ++j) off += bytes[j];
    return mem + s * stage_bytes() + CH * off;
  }
  __device__ unsigned bar(int s) const {
    return smem_addr(mem + NS * stage_bytes() + 8 * s);
  }
  // pixels [t0, t0 + n) into stage s: every lane of the warp calls it
  __device__ void fetch(int s, int t0, int n, int lane) const {
    if (lane == 0) mbar_expect(bar(s), n * stage_bytes() / CH);
    __syncwarp();
    if (lane < n) {
#pragma unroll
      for (int i = 0; i < NIN; ++i)
        if (bytes[i])
          bulk_load(smem_addr(part(s, i) + lane * bytes[i]),
                    px0[i] + (t0 + lane) * next[i], bytes[i], bar(s));
    }
  }
  __device__ void wait(int s, int parity) const {
    while (!mbar_done(bar(s), parity)) {
    }
  }
};

// Walk a line's len pixels through a LineRing in chunks of CH: step(col, t,
// fresh) for pixel t, with col = read(s, slot) its inputs in slot `slot` of
// stage s, fresh a type (true at t = 0). As ring_walk: a full chunk's
// pixels are read from shared memory at its start and carry no branch, and
// once the warp's lanes have met after a chunk its stage takes the chunk NS
// ahead.
template <int CH, int NS, int NIN, typename Read, typename Step>
__device__ __forceinline__ void line_ring_walk(
    int len, int lane, const LineRing<CH, NS, NIN>& ring, Read&& read,
    Step&& step) {
  const int nch = (len + CH - 1) / CH;
  auto n_of = [&](int k) { return min(CH, len - k * CH); };
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(ring.bar(s));
    mbar_init_fence();
  }
  __syncwarp();
  for (int k = 0; k < NS && k < nch; ++k) ring.fetch(k, k * CH, n_of(k), lane);
  auto chunk = [&](int k, auto cols, auto fresh) {
    const int s = k % NS, t0 = k * CH;
    ring.wait(s, (k / NS) & 1);
    if constexpr (std::is_integral_v<decltype(cols)>) {
      step(read(s, 0), t0, fresh);
      for (int j = 1; j < cols; ++j)
        step(read(s, j), t0 + j, std::false_type());
    } else {
      decltype(read(0, 0)) c[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) c[j] = read(s, j);
      step(c[0], t0, fresh);
#pragma unroll
      for (int j = 1; j < CH; ++j) step(c[j], t0 + j, std::false_type());
    }
    __syncwarp();
    if (k + NS < nch) ring.fetch(s, (k + NS) * CH, n_of(k + NS), lane);
  };
  const int full = len / CH;
  int k = 0;
  if (full > 0) {
    chunk(0, std::integral_constant<int, CH>(), std::true_type());
    for (k = 1; k < full; ++k)
      chunk(k, std::integral_constant<int, CH>(), std::false_type());
  }
  if (k == 0)
    chunk(k, len, std::true_type());
  else if (k < nch)
    chunk(k, len - k * CH, std::false_type());
}

// Shared memory of a variant's warp tuned by T: the adds' stages (kTmaAdd)
// then the ring (kRing), for c_bytes of C and a_bytes of the sum read a
// pixel's element.
template <typename T>
size_t variant_warp_bytes(int feed, int out, int D, int c_bytes,
                          int a_bytes) {
  size_t b = out == kTmaAdd ? (size_t)T::kOutStages * T::kOutRows * D * 4 : 0;
  if (feed == kRing)
    b += ring_bytes(kLineChunk, kLineStages, D, c_bytes + a_bytes);
  return b;
}

// The port's vsweep_kernel (without the carry) in feed F, adding by kOut,
// tuned by T. ring_bytes: shared memory a warp (variant_warp_bytes).
template <typename P, int VPL, int F, int kOut, typename T>
__global__ void __launch_bounds__(32 * kWalkWarps, T::kBlocks)
    vsweep_variant_kernel(const typename P::C* __restrict__ C,
                          typename P::L* sv, int H, int W, int D, int P1,
                          int P2, int dir0, int ndirs, int down, int per_way,
                          int nlines, int assign, int ring_bytes,
                          int frames) {
  using CT = typename P::C;
  using L = typename P::L;
  constexpr bool kExact = P::kSumsExact;
  constexpr bool kVec = F != kScalar;
  constexpr bool kStaged = kExact && kOut == kTmaAdd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= nlines * frames) return;
  // line b of frame f, as the port's launch: a frame moves C and sv
  const int f = b / nlines;
  b -= f * nlines;
  C += (size_t)f * H * W * D;
  sv += (size_t)f * H * W * D;
  const VLine v =
      vline_in<T::kInterleave>(b, H, W, dir0, ndirs, down, per_way);
  const int d0 = VPL * lane, n = min(max(D - d0, 0), VPL);
  const L p1 = (L)P1, p2 = (L)P2;
  const long long first = ((long long)v.y * W + v.x) * D + d0;
  const long long next = ((long long)v.ys * W + v.dx) * D;
  L Lr[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) Lr[k] = P::big();
  L minprev = P::start_minprev();
  unsigned char* mine = smem + (size_t)warp * ring_bytes;
  L* staged = reinterpret_cast<L*>(mine);  // kStaged: the adds' stages
  struct Col {
    CT c[VPL];
    L a[kExact ? 1 : VPL];
  };
  constexpr int kRows = T::kOutRows, kStages = T::kOutStages;
  auto send = [&](auto t) {
    const int k = t / kRows, rows = t - k * kRows + 1;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane < rows)
      bulk_reduce_add(sv + (first - d0) + (k * kRows + lane) * next,
                      smem_addr(staged + ((k % kStages) * kRows + lane) *
                                             (size_t)D),
                      D * (int)sizeof(L));
    bulk_stores_read<kStages - 1>();
    __syncwarp();
  };
  auto step = [&](const Col& col, int t, auto fresh) {
    L c[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = (L)col.c[k];
    warp_step<P, VPL>(Lr, c, minprev, p1, p2, decltype(fresh)::value, lane,
                      n);
    if constexpr (kStaged) {
      const int row = (t / kRows) % kStages * kRows + t % kRows;
      store_slots<true>(staged + (size_t)row * D + d0, Lr, n);
      if (t % kRows == kRows - 1 || t == v.len - 1) send(t);
      return;
    }
    L* o = sv + first + t * next;
    if constexpr (kExact && kOut == kStore) {
      store_slots<kVec>(o, Lr, n);
    } else if constexpr (kExact && kVec && VPL >= 2) {
      if (n == VPL) {
#pragma unroll
        for (int k = 0; k < VPL / 2; ++k)
          red_add_pair(o + 2 * k, Lr[2 * k], Lr[2 * k + 1]);
      }
    } else if constexpr (kExact) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        if (k < n) atomicAdd(o + k, Lr[k]);
    } else if (assign) {
      store_slots<kVec>(o, Lr, n);
    } else {
      L s[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) s[k] = P::add(col.a[k], Lr[k]);
      store_slots<kVec>(o, s, n);
    }
  };
  if constexpr (F == kRing) {
    LineRing<kLineChunk, kLineStages, kExact ? 1 : 2> ring;
    ring.mem = mine + (kStaged ? (size_t)kStages * kRows * D * 4 : 0);
    ring.px0[0] = reinterpret_cast<const unsigned char*>(C + (first - d0));
    ring.next[0] = next * (long long)sizeof(CT);
    ring.bytes[0] = D * (int)sizeof(CT);
    if constexpr (!kExact) {
      ring.px0[1] = reinterpret_cast<const unsigned char*>(sv + (first - d0));
      ring.next[1] = next * (long long)sizeof(L);
      ring.bytes[1] = assign ? 0 : D * (int)sizeof(L);
    }
    line_ring_walk(
        v.len, lane, ring,
        [&](int s, int slot) {
          Col col;
          if (n == VPL) {
            const size_t o = (size_t)slot * D + d0;
            load_full<false>(col.c,
                             reinterpret_cast<const CT*>(ring.part(s, 0)) + o);
            if constexpr (!kExact)
              load_full<false>(
                  col.a, reinterpret_cast<const L*>(ring.part(s, 1)) + o);
          }
          return col;
        },
        step);
  } else {
    walk<T::kAhead, true, Col>(
        v.len,
        [&](Col& col, int t) {
          const long long o = first + t * next;
          load_slots<kVec>(col.c, C + o, n);
          if constexpr (!kExact) {
            if (!assign) load_slots<kVec>(col.a, sv + o, n);
          }
        },
        step);
  }
  if constexpr (kStaged) bulk_stores_done();
}

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    std::printf("CUDA error %s: %s\n", what, cudaGetErrorString(e));
    std::exit(1);
  }
}

template <typename F>
float time_ms(F&& launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f;
  launch();
  for (int round = 0; round < 2; ++round) {
    cudaEventRecord(a);
    for (int i = 0; i < 20; ++i) launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    best = fminf(best, ms / 20);
  }
  check(cudaGetLastError(), "launch");
  return best;
}

const char* kFeedName[] = {"scalar loads", "vector loads", "TMA ring"};

template <typename T>
std::vector<T> fetch(const T* p, size_t n) {
  std::vector<T> v(n);
  check(cudaMemcpy(v.data(), p, n * sizeof(T), cudaMemcpyDeviceToHost),
        "copy");
  return v;
}

// hwalk in feed F: its time, and whether s1 equals `ref` (empty: none yet)
template <int F>
void time_hwalk(const int16_t* C, int32_t* s1, std::vector<int32_t>& ref,
                int warps, int rows = H) {
  const size_t wb =
      F == kRing ? ring_bytes(hwalk_chunk(VPL), kHwalkStages<X2>, D, 6) : 0;
  auto kernel = hwalk_kernel<X2, VPL, F>;
  check((cudaError_t)set_smem((const void*)kernel, warps * wb), "smem");
  const float ms = time_ms([&] {
    kernel<<<(rows + warps - 1) / warps, 32 * warps, warps * wb>>>(
        C, s1, rows, W, D, 400, 1600, (int)wb);
  });
  const auto out = fetch(s1, (size_t)rows * W * D);
  if (ref.empty()) ref = out;
  std::printf("hwalk, %-14s %d warps a block, %d rows: %.4f ms, s1 %s\n",
              kFeedName[F], warps, rows, ms,
              out == ref ? "equal" : "DIFFERS");
}

// H3 over P's C in feed F (over int16 C, s1 holding H2's sums too and sv
// null), with the bottom-up partial apart if svu
template <typename P, int F>
void time_h3(const char* what, const void* C, const void* s1, const void* sv,
             const void* svu, int16_t* disp, std::vector<int16_t>& ref,
             int most_warps) {
  using L = typename P::L;
  const size_t rb =
      ((3 * sizeof(L) + 2 * sizeof(int16_t) + 1) * W + 15) & ~(size_t)15;
  const int per_elem = (int)(sizeof(typename P::C) +
                             (1 + (sv ? 1 : 0) + (svu ? 1 : 0)) * sizeof(L));
  const size_t wb =
      rb + (F == kRing ? ring_bytes(h3_chunk(VPL), kH3Stages, D, per_elem)
                       : 0);
  int warps = most_warps;
  while (warps > 1 && warps * wb > kMaxSmem) --warps;
  auto go = [&](auto kernel) {
    check((cudaError_t)set_smem((const void*)kernel, warps * wb), "smem");
    return time_ms([&] {
      kernel<<<(H + warps - 1) / warps, 32 * warps, warps * wb>>>(
          (const typename P::C*)C, (const L*)s1, (const L*)sv, (const L*)svu,
          disp, H, W, D, 400, 1600, 0, 10, 1, (int)rb, (int)wb);
    });
  };
  const float ms = svu ? go(hsweep_wta_lr_kernel<P, VPL, F, true>)
                       : go(hsweep_wta_lr_kernel<P, VPL, F, false>);
  const auto out = fetch(disp, (size_t)H * W);
  if (ref.empty()) ref = out;
  std::printf("H3 %-27s %-14s %d warps a block: %.4f ms, disparity %s\n",
              what, kFeedName[F], warps, ms,
              out == ref ? "equal" : "DIFFERS");
}

const char* kOutName[] = {"reductions", "bulk reduce-adds", "plain stores"};

// The lines of an H2 launch over int16 C: the top-down trio (5 paths),
// both trios (8 paths), the straight line top-down, or both ways (4 paths);
// over float32 C the top-down trio in three launches, one a direction
enum Lines : int { kTrio, kBothTrios, kStraight, kStraightBoth };
const char* kLinesName[] = {"int16 C, top-down trio", "int16 C, both trios",
                            "int16 C, straight down",
                            "int16 C, straight both ways"};
const char* kF32Name = "float32 C, trio in 3 launches";

// launch(dir0, ndirs, down, up, assign, p1, p2) for each launch of the
// lines: one over int16 C, three over float32 C (the first setting the sum)
template <typename P, typename Go>
void for_launches(int lines, Go&& go) {
  if constexpr (P::kSumsExact) {
    const bool trio = lines == kTrio || lines == kBothTrios;
    const bool both = lines == kBothTrios || lines == kStraightBoth;
    go(0, trio ? 3 : 1, 1, both ? 1 : 0, 0, 400, 1600);
  } else {
    for (int j = 0; j < 3; ++j) go(j, 1, 1, 0, j == 0, 8 * 169, 32 * 169);
  }
}

// One H2 case: its time, and whether the sum it leaves in sv from zeros
// (over int16 C) equals ref (the first case's; not compared where `wrong`:
// plain stores)
template <typename L, typename Launch>
void time_h2_case(const std::string& what, Launch&& launch, L* sv,
                  std::vector<L>& ref, bool exact, bool wrong = false) {
  const float ms = time_ms(launch);
  const size_t n = (size_t)H * W * D;
  if (exact) check(cudaMemset(sv, 0, n * sizeof(L)), "memset");
  launch();
  check(cudaDeviceSynchronize(), "H2");
  const auto out = fetch((const L*)sv, n);
  const char* same = "not compared";
  if (!wrong) {
    if (ref.empty()) ref = out;
    same = out == ref ? "equal" : "DIFFERS";
  }
  std::printf("H2 %s: %.4f ms, sum %s\n", what.c_str(), ms, same);
}

// H2 as the port launches it (launch_vsweep: vector loads 4 ahead, over
// int16 C bulk reduce-adds in 2 stages of 4 pixels), then, with scalar,
// its fallback for other D (scalar loads at 32 slots a lane, atomicAdd)
template <typename P>
void time_h2_port(int lines, const void* C, void* sv,
                  std::vector<typename P::L>& ref, bool scalar = false) {
  using L = typename P::L;
  auto launch = [&] {
    for_launches<P>(lines, [&](int dir0, int ndirs, int down, int up,
                               int assign, int p1, int p2) {
      if (!scalar) {
        check((cudaError_t)launch_vsweep<P>(C, sv, H, W, D, p1, p2, dir0,
                                            ndirs, down, up, assign,
                                            nullptr, nullptr, 0),
              "H2 launch");
        return;
      }
      int per_way = 0;
      for (int j = dir0; j < dir0 + ndirs; ++j)
        per_way += j == 0 ? W : W + H - 1;
      const int nlines = per_way * (down + up);
      auto kernel = vsweep_kernel<P, 32, kScalar>;
      kernel<<<(nlines + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps>>>(
          (const typename P::C*)C, (L*)sv, H, W, D, p1, p2, dir0, ndirs, down,
          per_way, nlines, assign, nullptr, nullptr, 1, 0);
    });
  };
  const std::string name =
      std::string(P::kSumsExact ? kLinesName[lines] : kF32Name) +
      (scalar ? ", the port's fallback (scalar loads, 32 slots a lane)"
              : ", the port's launch");
  time_h2_case(name, launch, (L*)sv, ref, P::kSumsExact);
}

// A variant of H2 over P's C in feed F adding by kOut, tuned by T (adds
// over int16 C only)
template <typename P, int F, int kOut, typename T>
void time_h2(int lines, const void* C, void* sv,
             std::vector<typename P::L>& ref) {
  using CT = typename P::C;
  using L = typename P::L;
  constexpr int kO = P::kSumsExact ? kOut : kRed;
  const size_t wb = variant_warp_bytes<T>(
      F, kO, D, (int)sizeof(CT), P::kSumsExact ? 0 : (int)sizeof(L));
  auto kernel = vsweep_variant_kernel<P, VPL, F, kO, T>;
  check((cudaError_t)set_smem((const void*)kernel, kWalkWarps * wb), "smem");
  auto launch = [&] {
    for_launches<P>(lines, [&](int dir0, int ndirs, int down, int up,
                               int assign, int p1, int p2) {
      int per_way = 0;
      for (int j = dir0; j < dir0 + ndirs; ++j)
        per_way += j == 0 ? W : W + H - 1;
      const int nlines = per_way * (down + up);
      kernel<<<(nlines + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps,
               kWalkWarps * wb>>>((const CT*)C, (L*)sv, H, W, D, p1, p2,
                                  dir0, ndirs, down, per_way, nlines, assign,
                                  (int)wb, 1);
    });
  };
  char tune[96] = "";
  if (kO == kTmaAdd)
    std::snprintf(tune, sizeof tune, ", adds in %d stages of %d pixels",
                  T::kOutStages, T::kOutRows);
  char name[320];
  std::snprintf(name, sizeof name, "%s, %d ahead, >= %d blocks/SM, %s%s, %s, %s",
                P::kSumsExact ? kLinesName[lines] : kF32Name, T::kAhead,
                T::kBlocks, T::kInterleave ? "interleaved" : "in turn", tune,
                kFeedName[F], kOutName[kO]);
  time_h2_case(std::string(name), launch, (L*)sv, ref, P::kSumsExact,
               kO == kStore);
}

// H5, hwalk over float32 C in feed F (a ring of NS stages of CH columns)
template <int F, int CH = hwalk_chunk(VPL), int NS = kHwalkStages<F32>>
void time_h5(const float* C, float* out, std::vector<float>& ref) {
  const size_t wb = F == kRing ? ring_bytes(CH, NS, D, 8) : 0;
  int warps = kWalkWarps;
  while (warps > 1 && warps * wb > kMaxSmem) --warps;
  auto kernel = hwalk_kernel<F32, VPL, F, CH, NS>;
  check((cudaError_t)set_smem((const void*)kernel, warps * wb), "smem");
  const float ms = time_ms([&] {
    kernel<<<(H + warps - 1) / warps, 32 * warps, warps * wb>>>(
        C, out, H, W, D, 8 * 169, 32 * 169, (int)wb);
  });
  const auto got = fetch(out, (size_t)H * W * D);
  if (ref.empty()) ref = got;
  if (F == kRing)
    std::printf("H5 %-14s %2d columns x %d stages, %d warps a block: %.4f "
                "ms, L %s\n", kFeedName[F], CH, NS, warps, ms,
                got == ref ? "equal" : "DIFFERS");
  else
    std::printf("H5 %-14s %d warps a block: %.4f ms, L %s\n", kFeedName[F],
                warps, ms, got == ref ? "equal" : "DIFFERS");
}

// H2's top-down trio over B frames (the cells run 1, 8 and 16; 2-4 show
// where the trio walk starts to win) into a random partial sum: the port's
// line walk in one launch (launch_vsweep, bulk reduce-adds), the same walk
// with plain stores (timing only: its sum is wrong), and the trio walk
// (csrc/sgbm_trio.cu) at 16, 8 and 4 warps a block, with and without the
// slot tests, each checked against the line walk's sum.
void time_trio(int B, unsigned char* scratch, long long scratch_bytes) {
  const size_t n = (size_t)B * H * W * D;
  int16_t* C;
  int32_t *sv, *init;
  check(cudaMalloc(&C, sizeof(int16_t) * n), "malloc");
  check(cudaMalloc(&sv, sizeof(int32_t) * n), "malloc");
  check(cudaMalloc(&init, sizeof(int32_t) * n), "malloc");
  {
    std::vector<int16_t> c((size_t)H * W * D);
    std::vector<int32_t> s((size_t)H * W * D);
    for (int f = 0; f < B; ++f) {
      srand(100 + f);
      for (auto& v : c) v = (int16_t)(rand() % 2000);
      for (auto& v : s) v = rand() % 20000;
      cudaMemcpy(C + (size_t)f * H * W * D, c.data(), c.size() * 2,
                 cudaMemcpyHostToDevice);
      cudaMemcpy(init + (size_t)f * H * W * D, s.data(), s.size() * 4,
                 cudaMemcpyHostToDevice);
    }
  }
  std::vector<int32_t> ref;
  auto report = [&](const char* what, auto&& launch, bool compare) {
    const float ms = time_ms(launch);
    check(cudaMemcpy(sv, init, n * 4, cudaMemcpyDeviceToDevice), "copy");
    launch();
    check(cudaDeviceSynchronize(), what);
    const char* same = "not compared";
    if (compare) {
      const auto out = fetch((const int32_t*)sv, n);
      if (ref.empty()) ref = out;
      same = out == ref ? "equal" : "DIFFERS";
    }
    std::printf("H2 top-down trio, B=%d, %s: %.4f ms, %.4f ms a frame, sum "
                "%s\n", B, what, ms, ms / B, same);
  };
  report("the port's line walk (bulk reduce-adds)", [&] {
    check((cudaError_t)launch_vsweep<X2>(C, sv, H, W, D, 400, 1600, 0, 3, 1,
                                         0, 0, nullptr, nullptr, 0, B),
          "H2 launch");
  }, true);
  {
    using T = VTune<4, 8, true, 4, 2>;
    auto kernel = vsweep_variant_kernel<X2, VPL, kVector, kStore, T>;
    const int per_way = W + 2 * (W + H - 1);
    report("the line walk with plain stores", [&] {
      kernel<<<(per_way * B + kWalkWarps - 1) / kWalkWarps,
               32 * kWalkWarps>>>(C, sv, H, W, D, 400, 1600, 0, 3, 1,
                                  per_way, per_way, 0, 0, B);
    }, false);
  }
  // all slots: no slot tests (D = 32 * VPL), as the port launches D = 128
  auto trio = [&](auto full, int nw) {
    constexpr bool kF = decltype(full)::value;
    char what[128];
    std::snprintf(what, sizeof what, "trio walk, %d warps a block, %s%s", nw,
                  kF ? "full lanes" : "lanes tested",
                  nw == trio_warps(W, B) && kF ? " (the port's)" : "");
    report(what, [&] {
      check((cudaError_t)launch_trio<VPL, kF>(C, sv, H, W, D, 400, 1600, 0,
                                             B, scratch, scratch_bytes, 0,
                                             nw),
            "trio launch");
    }, true);
  };
  for (int nw : {16, 8, 4}) {
    trio(std::true_type(), nw);
    trio(std::false_type(), nw);
  }
  cudaFree(C);
  cudaFree(sv);
  cudaFree(init);
}

}  // namespace

int main(int argc, char** argv) {
  // `probe trio` times H2's trio walk against the line walk only;
  // `probe h2h5` times H2 and H5 only
  {
    const long long sb = ovo_vsweep_trio_scratch();
    unsigned char* scratch;
    check(cudaMalloc(&scratch, sb), "malloc");  // each launch zeroes it
    for (int B : {1, 2, 3, 4, 8, 16}) time_trio(B, scratch, sb);
    cudaFree(scratch);
    if (argc >= 2 && std::strcmp(argv[1], "trio") == 0) return 0;
  }
  const bool all = argc < 2 || std::strcmp(argv[1], "h2h5") != 0;
  const size_t n = (size_t)H * W * D;
  std::vector<float> img((size_t)H * W);
  std::vector<int16_t> c(n);
  std::vector<int32_t> s(n);
  srand(1);
  for (auto& v : img) v = (float)(rand() % 127);
  for (auto& v : c) v = (int16_t)(rand() % 2000);
  for (auto& v : s) v = rand() % 20000;
  std::vector<float> f(s.begin(), s.end());
  float *lp, *rp, *Cf, *s1f, *svf, *svuf;
  int16_t *C, *disp;
  int32_t *s1, *sv;
  check(cudaMalloc(&lp, sizeof(float) * H * W), "malloc");
  check(cudaMalloc(&rp, sizeof(float) * H * W), "malloc");
  check(cudaMalloc(&C, sizeof(int16_t) * n), "malloc");
  check(cudaMalloc(&s1, sizeof(int32_t) * n), "malloc");
  check(cudaMalloc(&sv, sizeof(int32_t) * n), "malloc");
  check(cudaMalloc(&Cf, sizeof(float) * n), "malloc");
  check(cudaMalloc(&s1f, sizeof(float) * n), "malloc");
  check(cudaMalloc(&svf, sizeof(float) * n), "malloc");
  check(cudaMalloc(&svuf, sizeof(float) * n), "malloc");
  check(cudaMalloc(&disp, sizeof(int16_t) * H * W), "malloc");
  cudaMemcpy(lp, img.data(), sizeof(float) * H * W, cudaMemcpyHostToDevice);
  cudaMemcpy(rp, img.data(), sizeof(float) * H * W, cudaMemcpyHostToDevice);
  cudaMemcpy(C, c.data(), sizeof(int16_t) * n, cudaMemcpyHostToDevice);
  cudaMemcpy(sv, s.data(), sizeof(int32_t) * n, cudaMemcpyHostToDevice);
  for (float* p : {Cf, s1f, svf, svuf})
    cudaMemcpy(p, f.data(), sizeof(float) * n, cudaMemcpyHostToDevice);

  if (all) {  // H1 and H3
    const int tx = 32;
    const size_t bsm = box_smem(R, tx);
    check((cudaError_t)set_smem((const void*)bt_box_kernel<true>, bsm),
          "smem");
    const dim3 grid((W + tx - 1) / tx, (H + kBoxRows - 1) / kBoxRows,
                    (D + 31) / 32);
    std::printf("bt_box (bf16), tile 16x%d:   %.4f ms\n", tx, time_ms([&] {
                  bt_box_kernel<true><<<grid, kBoxThreads, bsm>>>(
                      lp, rp, C, W, D, 0, R, 504, 0, H, 0, H - 1, tx, H);
                }));
    cudaMemcpy(C, c.data(), sizeof(int16_t) * n, cudaMemcpyHostToDevice);

    std::vector<int32_t> s1_ref;
    std::vector<int16_t> x2, f32, f32u;
    std::vector<int32_t> band_ref;  // a tiled rank's 94-row band
    time_hwalk<kRing>(C, s1, band_ref, 4, H / 4);
    time_hwalk<kVector>(C, s1, band_ref, 4, H / 4);
    for (int warps = 4; warps >= 1; --warps) {
      time_hwalk<kRing>(C, s1, s1_ref, warps);
      time_hwalk<kVector>(C, s1, s1_ref, warps);
      time_hwalk<kScalar>(C, s1, s1_ref, warps);
    }
    // H3 over int16 C reads s1 holding H2's sum too (here s1 + sv)
    std::vector<int32_t> folded = fetch(s1, n);
    for (size_t i = 0; i < n; ++i) folded[i] += s[i];
    int32_t* s1v;
    check(cudaMalloc(&s1v, sizeof(int32_t) * n), "malloc");
    cudaMemcpy(s1v, folded.data(), sizeof(int32_t) * n,
               cudaMemcpyHostToDevice);
    for (int warps = 4; warps >= 1; --warps) {
      time_h3<X2, kRing>("int16 C", C, s1v, nullptr, nullptr, disp, x2,
                         warps);
      time_h3<X2, kVector>("int16 C", C, s1v, nullptr, nullptr, disp, x2,
                           warps);
      time_h3<X2, kScalar>("int16 C", C, s1v, nullptr, nullptr, disp, x2,
                           warps);
      time_h3<F32, kRing>("float32 C", Cf, s1f, svf, nullptr, disp, f32,
                          warps);
      time_h3<F32, kVector>("float32 C", Cf, s1f, svf, nullptr, disp, f32,
                            warps);
      time_h3<F32, kRing>("float32 C, bottom-up apart", Cf, s1f, svf, svuf,
                          disp, f32u, warps);
      time_h3<F32, kVector>("float32 C, bottom-up apart", Cf, s1f, svf,
                            svuf, disp, f32u, warps);
    }
  }

  // H2: the port's launch first in each group, then the variants' tunings,
  // feeds and adds (VTune<ahead, blocks an SM, interleaved, rows a stage,
  // stages>)
  using T4x2 = VTune<4, 8, true, 4, 2>;  // the port's, over int16 C
  for (int lines : {kTrio, kBothTrios, kStraight, kStraightBoth}) {
    std::vector<int32_t> ref;
    time_h2_port<X2>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<4, 8, true, 4, 4>>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<4, 8, true, 8, 2>>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<4, 8, true, 8, 3>>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<4, 8, true, 16, 2>>(lines, C, sv,
                                                             ref);
    time_h2<X2, kVector, kTmaAdd, VTune<8, 1, true, 16, 2>>(lines, C, sv,
                                                             ref);
    time_h2<X2, kVector, kRed, T4x2>(lines, C, sv, ref);
    time_h2<X2, kVector, kRed, VTune<8, 1, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kVector, kStore, T4x2>(lines, C, sv, ref);
    if (lines != kTrio) continue;
    time_h2<X2, kVector, kTmaAdd, T4x2>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<4, 8, false, 4, 2>>(lines, C, sv,
                                                             ref);
    time_h2<X2, kVector, kTmaAdd, VTune<8, 1, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kVector, kTmaAdd, VTune<2, 9, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kVector, kRed, VTune<8, 1, false, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kVector, kStore, VTune<8, 1, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kRing, kTmaAdd, VTune<8, 5, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kRing, kRed, VTune<8, 8, true, 4, 2>>(lines, C, sv, ref);
    time_h2<X2, kRing, kStore, VTune<8, 8, true, 4, 2>>(lines, C, sv, ref);
    time_h2_port<X2>(lines, C, sv, ref, true);
  }
  std::printf("H2's zero fill of the int32 sum (cudaMemsetAsync): %.4f ms\n",
              time_ms([&] { cudaMemsetAsync(sv, 0, n * sizeof(int32_t)); }));
  std::vector<float> h2f;
  time_h2_port<F32>(kTrio, Cf, svf, h2f);
  time_h2<F32, kVector, kRed, VTune<8, 1, true, 4, 2>>(kTrio, Cf, svf, h2f);
  time_h2<F32, kRing, kRed, VTune<8, 1, true, 4, 2>>(kTrio, Cf, svf, h2f);
  time_h2<F32, kRing, kRed, VTune<8, 4, true, 4, 2>>(kTrio, Cf, svf, h2f);
  time_h2_port<F32>(kTrio, Cf, svf, h2f, true);

  std::vector<float> h5;
  time_h5<kRing>(Cf, s1f, h5);
  time_h5<kRing, 16, 2>(Cf, s1f, h5);
  time_h5<kRing, 8, 3>(Cf, s1f, h5);
  time_h5<kRing, 32, 2>(Cf, s1f, h5);
  time_h5<kVector>(Cf, s1f, h5);
  time_h5<kScalar>(Cf, s1f, h5);
  return 0;
}
