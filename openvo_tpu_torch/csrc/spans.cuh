// Shared by H6 (csrc/resize.cu) and H9 (csrc/orb_corners.cu): the spans
// of a stack's canvas that none of their tiles writes, and the helpers
// their tile blocks use on the card. Each helper has a plain serial form
// (OVO_SERIAL) for a one-thread-a-block build of the kernels by a host
// compiler, which checks their arithmetic before a card runs them; the
// card's build never defines it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A span: four int32 {dst, n, rows, src}: `rows` runs of n floats, the
// first at offset dst of a frame's output and each W floats after the
// previous one; every float gets `value` or, where src >= 0, the float at
// the same place of the runs from offset src of the frame's input.
// ops/orb_cuda.canvas_spans builds them.
constexpr int kSpanInts = 4;

// One warp's run: scalar stores up to a 16-byte boundary, 16-byte stores,
// a scalar tail (scalar throughout where a copy's source and destination
// are not aligned alike). dst2, where not NULL, gets the same floats in
// the same loop (aligned as dst).
__device__ __forceinline__ void write_run(float* __restrict__ dst,
                                          float* __restrict__ dst2,
                                          const float* __restrict__ src,
                                          int n, float value, int lane,
                                          int lanes) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (src != nullptr && ((reinterpret_cast<uintptr_t>(src) ^ d) & 15) != 0) {
    for (int k = lane; k < n; k += lanes) dst[k] = __ldg(src + k);
    return;
  }
  const int head = min(n, (int)(((16 - (d & 15)) & 15) / 4));
  const int n4 = (n - head) / 4;
  for (int k = lane; k < head; k += lanes) {
    const float v = src == nullptr ? value : __ldg(src + k);
    dst[k] = v;
    if (dst2 != nullptr) dst2[k] = v;
  }
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  if (src == nullptr) {
    const float4 v = make_float4(value, value, value, value);
    float4* e4 =
        dst2 == nullptr ? nullptr : reinterpret_cast<float4*>(dst2 + head);
    for (int k = lane; k < n4; k += lanes) {
      d4[k] = v;
      if (dst2 != nullptr) e4[k] = v;
    }
  } else {
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    for (int k = lane; k < n4; k += lanes) d4[k] = __ldg(s4 + k);
  }
  for (int k = head + 4 * n4 + lane; k < n; k += lanes) {
    const float v = src == nullptr ? value : __ldg(src + k);
    dst[k] = v;
    if (dst2 != nullptr) dst2[k] = v;
  }
}

// One warp's span of one frame: out and in are the frame's output and
// input (in may be NULL where no span copies); out2, where not NULL, a
// second output filled alike (spans that copy take no second output),
// whose address is out's modulo 16 bytes.
__device__ __forceinline__ void write_span(const int* __restrict__ span,
                                           float* out, float* out2,
                                           const float* in, int W,
                                           float value, int lane,
                                           int lanes) {
  const int dst = span[0], n = span[1], rows = span[2], src = span[3];
  for (int r = 0; r < rows; ++r)
    write_run(out + dst + (size_t)r * W,
              out2 == nullptr ? nullptr : out2 + dst + (size_t)r * W,
              src < 0 ? nullptr : in + src + (size_t)r * W, n, value, lane,
              lanes);
}

// The blocks a frame of a tiled kernel with `tiles` tiles and `spans`
// spans a frame, `warps` warps a block: block b of a frame runs tile b
// (where b < tiles) and the spans b, b + blocks, ... (a warp each).
__host__ __device__ __forceinline__ int frame_blocks(int tiles, int spans,
                                                     int warps) {
  const int for_spans = (spans + warps - 1) / warps;
  return tiles > for_spans ? tiles : for_spans;
}

// One float from global into shared memory without a register: cp.async
// (4 bytes, through L1); wait_async() waits for all of the thread's.
__device__ __forceinline__ void copy_async(float* smem, const float* g) {
#ifdef OVO_SERIAL
  *smem = *g;
#else
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(g)
               : "memory");
#endif
}

__device__ __forceinline__ void wait_async() {
#ifndef OVO_SERIAL
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Appends `value` to a shared list where `keep`, in no set order: one
// shared atomic a warp (a ballot, then each lane's place among the kept).
// Every thread of a warp calls it alike.
__device__ __forceinline__ void append(uint16_t* list, int* count, bool keep,
                                       uint16_t value) {
#ifdef OVO_SERIAL
  if (keep) list[(*count)++] = value;
#else
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m != 0) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (keep) list[base + __popc(m & ((1u << lane) - 1u))] = value;
#endif
}

}  // namespace
