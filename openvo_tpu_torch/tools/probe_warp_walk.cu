// How the SGBM warp walks' feeds and block sizes compare: times H1's two
// kernels (bt_box, hwalk) and H3 at KITTI shapes (376 x 1242, D = 128) on
// random inputs, hwalk and H3 in each of their feeds (the TMA ring, the
// vector register prefetch, the scalar one) at 1 to 4 warps (rows) a block,
// each by CUDA events over 20 launches (the lower of two rounds), and
// checks that every variant gives the first one's output bit for bit.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o probe openvo_tpu_torch/tools/probe_warp_walk.cu && ./probe
//
// It includes csrc/sgbm.cu and csrc/sgbm_wta.cu, so it times the kernels
// the port builds.

#include "../csrc/sgbm.cu"
#include "../csrc/sgbm_wta.cu"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int H = 376, W = 1242, D = 128, VPL = 4, R = 2;

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
      F == kRing ? ring_bytes(hwalk_chunk(VPL), kHwalkStages, D, 6) : 0;
  auto kernel = hwalk_kernel<VPL, F>;
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

// H3 over P's C in feed F, with the bottom-up partial apart if svu
template <typename P, int F>
void time_h3(const char* what, const void* C, const void* s1, const void* sv,
             const void* svu, int16_t* disp, std::vector<int16_t>& ref,
             int most_warps) {
  using L = typename P::L;
  const size_t rb =
      ((3 * sizeof(L) + 2 * sizeof(int16_t) + 1) * W + 15) & ~(size_t)15;
  const int per_elem = (int)(sizeof(typename P::C) + (svu ? 3 : 2) * sizeof(L));
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

}  // namespace

int main() {
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

  const int tx = 32;
  const size_t bsm = box_smem(R, tx);
  check((cudaError_t)set_smem((const void*)bt_box_kernel<true>, bsm), "smem");
  const dim3 grid((W + tx - 1) / tx, (H + kBoxRows - 1) / kBoxRows,
                  (D + 31) / 32);
  std::printf("bt_box (bf16), tile 16x%d:   %.4f ms\n", tx, time_ms([&] {
                bt_box_kernel<true><<<grid, kBoxThreads, bsm>>>(
                    lp, rp, C, W, D, 0, R, 504, 0, H, 0, H - 1, tx);
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
  for (int warps = 4; warps >= 1; --warps) {
    time_h3<X2, kRing>("int16 C", C, s1, sv, nullptr, disp, x2, warps);
    time_h3<X2, kVector>("int16 C", C, s1, sv, nullptr, disp, x2, warps);
    time_h3<X2, kScalar>("int16 C", C, s1, sv, nullptr, disp, x2, warps);
    time_h3<F32, kRing>("float32 C", Cf, s1f, svf, nullptr, disp, f32, warps);
    time_h3<F32, kVector>("float32 C", Cf, s1f, svf, nullptr, disp, f32,
                          warps);
    time_h3<F32, kRing>("float32 C, bottom-up apart", Cf, s1f, svf, svuf,
                        disp, f32u, warps);
    time_h3<F32, kVector>("float32 C, bottom-up apart", Cf, s1f, svf, svuf,
                          disp, f32u, warps);
  }
  return 0;
}
