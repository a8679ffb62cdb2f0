// Timing-event reads for the port's trace (openvo_tpu_torch/trace.py),
// bound with ctypes. No kernel: a captured step's graph records its stage
// marks as timing events, and the trace reads each replay's marks
// against an anchor event in one call here, in place of one Python call
// (and its device guard) an event.

#include <cuda_runtime.h>

// events[0] is the anchor, events[1..n-1] a replay's marks in order: ms
// from the anchor to each mark into ms[0..n-2]. Returns
// cudaErrorNotReady, writing nothing, where the last mark is not done yet;
// any error is cleared from this runtime's last error, which the kernel
// entries return after their launches.
extern "C" int ovo_event_times(void* const* events, int n, float* ms) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaEventQuery((cudaEvent_t)events[n - 1]);
  for (int i = 1; err == cudaSuccess && i < n; ++i)
    err = cudaEventElapsedTime(ms + i - 1, (cudaEvent_t)events[0],
                               (cudaEvent_t)events[i]);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
