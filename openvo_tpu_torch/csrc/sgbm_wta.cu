// H3 hsweep_wta_lr for Hopper (sm_90a), bound with ctypes: the kernel that
// replaces sgbm_pallas.sweep_hw_wta (K3) and, over float32 costs,
// sweep_h_wta (K7), with lr_lookup (K4) in its epilogue. Its design and what
// bounds it are described with the other SGBM kernels at the top of
// csrc/sgbm.cu; it is a source of its own so that the two build in
// parallel.

#include "sgbm_common.cuh"

namespace {

// H3's ring: 3 stages of about 10 KB of inputs (16 columns at up to 2 slots
// a lane, 32 / VPL above): a chunk's columns are read from shared memory at
// its start, so longer chunks cost registers (openvo_tpu_torch/tools/
// probe_warp_walk.cu).
__host__ __device__ constexpr int h3_chunk(int vpl) {
  return vpl <= 2 ? 16 : 32 / vpl;
}
constexpr int kH3Stages = 3;

// H3: one warp per row y, walking x right to left: the reverse SGM step, S
// = L + s1 over X2 (s1 holds H2's sums too: H2 adds into it) and ((s1 + L)
// + sv) + svu over F32 (svu if kU), the argmin over
// d with the lowest d on ties, the uniqueness vote, and the right-view
// argmin bestR(xr) = argmin_d S(xr + d, d) as a register shift: slot d of R
// holds the running min of the diagonal xr = x - d, which at the next
// column moves to slot d - 1 (one shuffle across lanes), so after column x
// slot 0 holds diagonal x complete. The row's per-column results stay in
// the warp's shared memory for the epilogue, which writes the final
// disparity. The uniqueness test is the JAX package's float32 one on the x1
// grid: S * (100 - u) < min S * 100, each product rounded. A warp's part of
// shared memory (warp_bytes) holds its results (row_bytes), then its TMA
// ring (F = kRing).
template <typename P, int VPL, int F, bool kU>
__global__ void __launch_bounds__(32 * kWalkWarps) hsweep_wta_lr_kernel(
    const typename P::C* __restrict__ C, const typename P::L* __restrict__ s1,
    const typename P::L* __restrict__ sv,
    const typename P::L* __restrict__ svu, int16_t* __restrict__ disp16,
    int H, int W, int D, int P1, int P2, int min_disp, int uniq, int disp12,
    int row_bytes, int warp_bytes) {
  using L = typename P::L;
  using Key = typename P::Key;
  using CT = typename P::C;
  constexpr bool kV = !P::kSumsExact;  // sv apart from s1: over F32 only
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.x * (blockDim.x >> 5) + warp;
  if (y >= H) return;
  unsigned char* mine = smem + (size_t)warp * warp_bytes;
  L* min_s = reinterpret_cast<L*>(mine);                            // W
  L* s_m = min_s + W;                                               // W
  L* s_p = s_m + W;                                                 // W
  int16_t* best_row = reinterpret_cast<int16_t*>(s_p + W);          // W
  int16_t* bestr_row = best_row + W;                                // W
  uint8_t* bad_row = reinterpret_cast<uint8_t*>(bestr_row + W);     // W
  const int d0 = VPL * lane, n = min(max(D - d0, 0), VPL);
  const size_t base = (size_t)y * W * D;
  const L p1 = (L)P1, p2 = (L)P2;
  const DivD dv(D);
  // the column step has no branch: the vote and the right-view ring run
  // whether or not the epilogue reads them
  const float scale = (float)(100 - uniq);
  struct Col {
    CT c[VPL];
    L a[VPL], v[kV ? VPL : 1], u[kU ? VPL : 1];
  };
  L Lr[VPL];
  Key R[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    Lr[k] = P::big();
    R[k] = P::kKeyMax;
  }
  L minprev = P::big();
  auto step = [&](const Col& col, int x, auto fresh) {
    L c[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) c[k] = (L)col.c[k];
    warp_step<P, VPL>(Lr, c, minprev, p1, p2, decltype(fresh)::value, lane,
                      n);
    L S[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      S[k] = P::add(col.a[k], Lr[k]);
      if constexpr (kV) S[k] = P::add(S[k], col.v[k]);
      if constexpr (kU) S[k] = P::add(S[k], col.u[k]);
    }
    int best;
    L ms;
    P::template warp_argmin<VPL>(S, n, d0, dv, best, ms);
    const int dm = max(best - 1, 0), dp = min(best + 1, D - 1);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (d0 + k == dm) s_m[x] = S[k];
      if (d0 + k == dp) s_p[x] = S[k];
    }
    const float thr = __fmul_rn(P::x1(ms), 100.0f);
    bool bad = false;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      bad |= (k < n) & (abs(d0 + k - best) > 1) &
             (__fmul_rn(P::x1(S[k]), scale) < thr);
    bad = __any_sync(kFull, bad);
    Key from = __shfl_down_sync(kFull, R[0], 1);
    if (lane == 31) from = P::kKeyMax;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const Key next = k == VPL - 1 ? from : R[k + 1];
      R[k] = vmin(next, k < n ? P::key(S[k], d0 + k, D) : P::kKeyMax);
    }
    if (lane == 0) {
      best_row[x] = (int16_t)best;
      min_s[x] = ms;
      bad_row[x] = bad;
      bestr_row[x] = (int16_t)P::key_d(R[0], dv);
    }
  };
  if constexpr (F == kRing) {
    constexpr int CH = h3_chunk(VPL);
    auto u8 = [](const void* p) {
      return const_cast<unsigned char*>(static_cast<const unsigned char*>(p));
    };
    constexpr int kV_ = kV ? 1 : 0;  // volume index of svu: 2 + kV_
    Ring<CH, kH3Stages, 2 + kV_ + (kU ? 1 : 0), false> ring;
    ring.mem = mine + row_bytes;
    ring.row[0] = u8(C + base);
    ring.col[0] = D * (int)sizeof(CT);
    ring.row[1] = u8(s1 + base);
    ring.col[1] = D * (int)sizeof(L);
    if constexpr (kV) {
      ring.row[2] = u8(sv + base);
      ring.col[2] = D * (int)sizeof(L);
    }
    if constexpr (kU) {
      ring.row[2 + kV_] = u8(svu + base);
      ring.col[2 + kV_] = D * (int)sizeof(L);
    }
    ring_walk<CH, false>(
        W, lane, ring,
        [&](int s, int slot) {
          Col col;
          if (n == VPL) {
            const size_t o = (size_t)slot * D + d0;
            load_full<false>(col.c,
                             reinterpret_cast<const CT*>(ring.part(s, 0)) + o);
            load_full<false>(col.a,
                             reinterpret_cast<const L*>(ring.part(s, 1)) + o);
            if constexpr (kV)
              load_full<false>(
                  col.v, reinterpret_cast<const L*>(ring.part(s, 2)) + o);
            if constexpr (kU)
              load_full<false>(
                  col.u, reinterpret_cast<const L*>(ring.part(s, 2 + kV_)) +
                             o);
          }
          return col;
        },
        [&](const Col& col, int x, auto fresh, int, int) {
          step(col, x, fresh);
        });
  } else {
    constexpr bool kVec = F == kVector;
    walk<kPrefetch<VPL>, false, Col>(
        W,
        [&](Col& col, int x) {
          const size_t o = base + (size_t)x * D + d0;
          load_slots<kVec>(col.c, C + o, n);
          load_slots<kVec>(col.a, s1 + o, n);
          if constexpr (kV) load_slots<kVec>(col.v, sv + o, n);
          if constexpr (kU) load_slots<kVec>(col.u, svu + o, n);
        },
        step);
  }
  __syncwarp();
  for (int x = lane; x < W; x += 32) {
    const int b = best_row[x];
    float frac = P::frac(s_m[x], s_p[x], min_s[x], b, D);
    frac = fminf(fmaxf(frac, -0.5f), 0.5f);
    const float df = __fadd_rn(__fadd_rn((float)b, frac), (float)min_disp);
    const int disp = (int)rintf(__fmul_rn(df, 16.0f));
    bool valid = !(uniq > 0 && bad_row[x]);
    if (disp12 >= 0) {
      const int xr = x - b;  // K4: the LR lookup is a shared-memory read
      valid = valid && (xr < 0 || abs(b - (int)bestr_row[xr]) <= disp12);
    }
    valid = valid && x - (b + min_disp) >= 0;
    disp16[(size_t)y * W + x] = (int16_t)(valid ? disp : (min_disp - 1) * 16);
  }
}

template <typename P>
int launch_hsweep_wta_lr(const void* C, const void* s1, const void* sv,
                         const void* svu, int16_t* disp16, int H, int W,
                         int D, int P1, int P2, int min_disp, int uniq,
                         int disp12, cudaStream_t stream) {
  using L = typename P::L;
  // per warp: min S, S(best - 1), S(best + 1), best, bestR, the vote
  const size_t row_bytes =
      ((3 * sizeof(L) + 2 * sizeof(int16_t) + 1) * W + 15) & ~(size_t)15;
  // the faster feed (openvo_tpu_torch/tools/probe_warp_walk.cu): vector
  // loads over int16 C, the ring over float32 C
  constexpr int kFast = P::kSumsExact ? kVector : kRing;
  const int per_elem = (int)(sizeof(typename P::C) +
                             (1 + (sv ? 1 : 0) + (svu ? 1 : 0)) * sizeof(L));
  const size_t ring =
      kFast == kRing
          ? ring_bytes(h3_chunk(slots_per_lane(D)), kH3Stages, D, per_elem)
          : 0;
  const bool fast = feed_fits(kFast, D, {C, s1, sv, svu}) &&
                    row_bytes + ring <= kMaxSmem;
  const size_t warp_bytes = row_bytes + (fast ? ring : 0);
  if (warp_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  int warps = kWalkWarps;
  while (warps > 1 && warps * warp_bytes > kMaxSmem) --warps;
  const size_t smem = warps * warp_bytes;
  return with_lanes<kFast>(D, fast, [&](auto vpl, auto feed) {
    constexpr int VPL = decltype(vpl)::value, F = decltype(feed)::value;
    auto go = [&](auto kernel) {
      const int err = set_smem((const void*)kernel, smem);
      if (err) return err;
      kernel<<<(H + warps - 1) / warps, 32 * warps, smem, stream>>>(
          (const typename P::C*)C, (const L*)s1, (const L*)sv, (const L*)svu,
          disp16, H, W, D, P1, P2, min_disp, uniq, disp12, (int)row_bytes,
          (int)warp_bytes);
      return (int)cudaGetLastError();
    };
    if constexpr (P::kSumsExact) {  // H2 adds sv and svu into s1
      return go(hsweep_wta_lr_kernel<P, VPL, F, false>);
    } else {
      if (svu) return go(hsweep_wta_lr_kernel<P, VPL, F, true>);
      return go(hsweep_wta_lr_kernel<P, VPL, F, false>);
    }
  });
}

}  // namespace

extern "C" {

// C int16 with int32 s1 (f32 = 0; exact in any order, so H2 adds the
// vertical sums into s1 and sv and svu are NULL) or all float32 (f32 = 1;
// sv the top-down vertical sum; svu, the bottom-up partial kept apart for
// the sum order, may be NULL)
int ovo_hsweep_wta_lr(const void* C, int f32, const void* s1, const void* sv,
                      const void* svu, int16_t* disp16, int H, int W, int D,
                      int P1, int P2, int min_disp, int uniq, int disp12,
                      void* stream) {
  if (bad_d(D) || H <= 0 || W <= 0 || (!f32 && (sv || svu)) ||
      (f32 && !sv))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return launch_hsweep_wta_lr<F32>(C, s1, sv, svu, disp16, H, W, D, P1, P2,
                                     min_disp, uniq, disp12,
                                     (cudaStream_t)stream);
  return launch_hsweep_wta_lr<X2>(C, s1, sv, svu, disp16, H, W, D, P1, P2,
                                  min_disp, uniq, disp12,
                                  (cudaStream_t)stream);
}

}  // extern "C"
