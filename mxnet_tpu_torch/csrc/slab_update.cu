// Fused optimizer-slab update for Hopper (sm_90a), CUDA C++: one AMP
// optimizer step over a flat 1-D slab of parameters in one pass.
//
// Replaces the TPU kernel `_slab_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (launched by `fused_slab_update`, pallas_call at :582), whose math is
// `_slab_update_math` (:455). Per element i, in this order:
//   g  = f32(grad[i]) * inv_scale
//   g  = g * rescale_grad                  (when rescale_grad != 1)
//   g  = clip(g, -clip_gradient, clip)     (when clip_gradient > 0)
//   g  = g + wd * w                        (when wd != 0)
//   sgd:     w' = w - lr * g
//   sgd_mom: m' = momentum * m - lr * g;  w' = w + m'
//   adam:    mean' = beta1 * mean + (1 - beta1) * g
//            var'  = beta2 * var + (1 - beta2) * g * g
//            w'    = w - lr * mean' / (sqrt(var') + epsilon)
//   then, unless finite > 0.5, w' and every state keep their old bits, and
//   w16 = bf16(w') (round to nearest even).
// Adam's bias correction is folded into lr by the caller.
//
// Every product, sum, difference, square root and quotient is written with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __fsqrt_rn, __fdiv_rn), which the compiler never contracts into an FMA:
// each rounds once, as each separate PyTorch op of the plain version does,
// so the kernel equals the plain version bit for bit.
//
// lr, inv_scale and finite are read from a 3-float device buffer (the
// counterpart of the Pallas kernel's SMEM scalars), so a step that computes
// them on the device never waits for the host. The static hyperparameters
// are kernel arguments. The kernel is templated on the update kind and on
// the gradient's type (bf16 under AMP, f32 allowed).
//
// What bounds it on the H100: bytes. Each element reads w (4), g (2 or 4)
// and its states (4 each) and writes w' (4), its states (4 each) and w16
// (2): 20 bytes for sgd_mom with a bf16 gradient, 28 for adam, against a
// few dozen flops. One grid-stride loop with a bound check covers any
// length, so the wrapper pads nothing (the TPU kernel pads to 128 lanes).
// Outputs may alias their inputs (each thread reads element i before it
// writes it), which lets the caller update master and states in place.
//
// Entry point: mxtt_slab_update (plain C, loaded with ctypes). It returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Kind { kSgd = 0, kSgdMom = 1, kAdam = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Hyper {
  float wd, rescale, clip, momentum, beta1, beta2, one_minus_beta1, one_minus_beta2, eps;
  int has_rescale, has_clip, has_wd;
};

template <int KIND, typename G>
__global__ void __launch_bounds__(kThreads)
slab_update_kernel(const float* w, const G* __restrict__ g, const float* s0, const float* s1,
                   float* out_w, float* out_s0, float* out_s1, __nv_bfloat16* __restrict__ w16,
                   const float* __restrict__ scalars, long long n, Hyper h) {
  const float lr = scalars[0];
  const float inv_scale = scalars[1];
  const bool keep = scalars[2] > 0.5f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float wv = w[i];
    float gv = __fmul_rn(to_f32(g[i]), inv_scale);
    if (h.has_rescale) gv = __fmul_rn(gv, h.rescale);
    if (h.has_clip) gv = gv < -h.clip ? -h.clip : (gv > h.clip ? h.clip : gv);  // NaN stays
    if (h.has_wd) gv = __fadd_rn(gv, __fmul_rn(h.wd, wv));
    float nw;
    if (KIND == kSgd) {
      nw = __fsub_rn(wv, __fmul_rn(lr, gv));
    } else if (KIND == kSgdMom) {
      const float m = s0[i];
      const float nm = __fsub_rn(__fmul_rn(h.momentum, m), __fmul_rn(lr, gv));
      nw = __fadd_rn(wv, nm);
      out_s0[i] = keep ? nm : m;
    } else {
      const float mean = s0[i];
      const float var = s1[i];
      const float nmean = __fadd_rn(__fmul_rn(h.beta1, mean), __fmul_rn(h.one_minus_beta1, gv));
      const float nvar =
          __fadd_rn(__fmul_rn(h.beta2, var), __fmul_rn(h.one_minus_beta2, __fmul_rn(gv, gv)));
      const float step =
          __fdiv_rn(__fmul_rn(lr, nmean), __fadd_rn(__fsqrt_rn(nvar), h.eps));
      nw = __fsub_rn(wv, step);
      out_s0[i] = keep ? nmean : mean;
      out_s1[i] = keep ? nvar : var;
    }
    nw = keep ? nw : wv;
    out_w[i] = nw;
    w16[i] = __float2bfloat16_rn(nw);
  }
}

template <int KIND>
cudaError_t launch(int g_bf16, const void* w, const void* g, const void* s0, const void* s1,
                   void* out_w, void* out_s0, void* out_s1, void* w16, const void* scalars,
                   long long n, const Hyper& h, int blocks, cudaStream_t stream) {
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  const float* s1f = static_cast<const float*>(s1);
  float* ow = static_cast<float*>(out_w);
  float* os0 = static_cast<float*>(out_s0);
  float* os1 = static_cast<float*>(out_s1);
  __nv_bfloat16* o16 = static_cast<__nv_bfloat16*>(w16);
  const float* sc = static_cast<const float*>(scalars);
  if (g_bf16) {
    slab_update_kernel<KIND, __nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        wf, static_cast<const __nv_bfloat16*>(g), s0f, s1f, ow, os0, os1, o16, sc, n, h);
  } else {
    slab_update_kernel<KIND, float><<<blocks, kThreads, 0, stream>>>(
        wf, static_cast<const float*>(g), s0f, s1f, ow, os0, os1, o16, sc, n, h);
  }
  return cudaGetLastError();
}

}  // namespace

// One step over n elements. kind: 0 sgd, 1 sgd_mom (s0 = momentum), 2 adam
// (s0 = mean, s1 = var); unused state pointers may be null. w, states and
// their outputs f32, g bf16 (g_bf16 = 1) or f32, w16 bf16, scalars three
// floats (lr, inv_scale, finite); all contiguous on one device. The has_*
// flags switch the rescale, clip and weight-decay terms on, as the Python
// conditions of `_slab_update_math` do.
extern "C" int mxtt_slab_update(int kind, int g_bf16, const void* w, const void* g,
                                const void* s0, const void* s1, void* out_w, void* out_s0,
                                void* out_s1, void* w16, const void* scalars, long long n,
                                float wd, float rescale, float clip, float momentum, float beta1,
                                float beta2, float one_minus_beta1, float one_minus_beta2,
                                float eps, int has_rescale, int has_clip, int has_wd,
                                int blocks, void* stream) {
  if (n <= 0) return 0;
  const Hyper h{wd, rescale, clip, momentum, beta1, beta2, one_minus_beta1, one_minus_beta2,
                eps, has_rescale, has_clip, has_wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kSgd:
      err = launch<kSgd>(g_bf16, w, g, s0, s1, out_w, out_s0, out_s1, w16, scalars, n, h, blocks, s);
      break;
    case kSgdMom:
      err = launch<kSgdMom>(g_bf16, w, g, s0, s1, out_w, out_s0, out_s1, w16, scalars, n, h,
                            blocks, s);
      break;
    case kAdam:
      err = launch<kAdam>(g_bf16, w, g, s0, s1, out_w, out_s0, out_s1, w16, scalars, n, h,
                          blocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
