// Greedy non-maximum suppression for Hopper (sm_90a), CUDA C++: the
// suppression loops of the detection operators as one launch.
//
// This kernel belongs to the port alone: the JAX package runs each loop as
// a device fori_loop (mxnet_tpu/contrib/ops.py:246-247 in
// MultiBoxDetection, :379 in Proposal), which has no pallas_call. Run
// eagerly in PyTorch, one step of such a loop is several launches, and a
// loop is thousands of steps (the 8732 anchors of SSD-300, Proposal's 6000
// boxes), so the loop is one kernel here.
//
// The kernel decides nothing about boxes. The caller hands it, for each of
// B samples, S steps of the loop:
//   order[b, s]   the box the step visits (int64, in [0, n)),
//   mask[b, s, j] whether that box suppresses box j (uint8, [B, S, n]: the
//                 IoU-over-threshold test and each loop's own conditions,
//                 computed by the same PyTorch expression the plain version
//                 reads, so no IoU is recomputed here where FMA contraction
//                 could move a value across the threshold),
//   active[b, i]  whether box i may suppress at all (uint8, [B, n]),
// and the kernel runs, for s = 0 .. S-1 in order,
//   i = order[b, s];
//   if (active[b, i] && !suppressed[i]) suppressed[j] |= mask[b, s, j] for all j
// and writes suppressed[b, :] (uint8, [B, n]). The plain version is
// ops/kernels.py nms_suppress_reference; the two agree bit for bit.
//
// Design (right first, not fast): one CTA a sample, the suppressed flags in
// shared memory (n bytes), the CTA's threads sweeping one mask row a step
// with 4-byte loads where the row allows. Each step is two barriers: one
// after every thread has read the visited box's flag, one after the row's
// writes. A step whose box is inactive or suppressed reads no row, so the
// bytes read are those of the rows of the boxes that survive.
//
// Entry point: mxtt_nms (plain C, loaded with ctypes). It returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
nms_kernel(const uint8_t* __restrict__ mask, const long long* __restrict__ order,
           const uint8_t* __restrict__ active, uint8_t* __restrict__ out, int steps, int n) {
  extern __shared__ uint8_t sup[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* act = active + (long long)b * n;
  const long long* ord = order + (long long)b * steps;
  for (int j = tid; j < n; j += kThreads) sup[j] = 0;
  __syncthreads();
  // rows of a 4-aligned mask are 4-aligned when n is a multiple of 4
  const bool words = (n % 4) == 0 && (reinterpret_cast<uintptr_t>(mask) % 4) == 0;
  for (int s = 0; s < steps; ++s) {
    const long long i = ord[s];
    const bool go = act[i] != 0 && sup[i] == 0;
    __syncthreads();  // every thread has read sup[i] before any write
    if (go) {
      const uint8_t* row = mask + ((long long)b * steps + s) * n;
      if (words) {
        const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
        uint32_t* sup4 = reinterpret_cast<uint32_t*>(sup);
        for (int w = tid; w < n / 4; w += kThreads) {
          const uint32_t m = row4[w];
          if (m) sup4[w] |= m;  // mask bytes are 0 or 1, as the flags
        }
      } else {
        for (int j = tid; j < n; j += kThreads) {
          if (row[j]) sup[j] = 1;
        }
      }
    }
    __syncthreads();
  }
  uint8_t* o = out + (long long)b * n;
  for (int j = tid; j < n; j += kThreads) o[j] = sup[j];
}

}  // namespace

extern "C" int mxtt_nms(const void* mask, const void* order, const void* active, void* out,
                        int batch, int steps, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = (size_t)((n + 3) / 4) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const long long*>(order),
      static_cast<const uint8_t*>(active), static_cast<uint8_t*>(out), steps, n);
  return (int)cudaGetLastError();
}
