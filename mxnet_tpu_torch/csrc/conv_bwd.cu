// Conv-backward pair for Hopper (sm_90a), CUDA C++: the gradients of a 2-D
// convolution with stride 1, dilation 1 and one group, NCHW / OIHW.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py:
//   * K2 conv_wgrad_kernel (+ conv_wgrad_reduce_kernel) <- `_conv_wgrad_kernel`
//     (launched by `conv_bwd_filter`):
//       gw[o, c, i, j] = sum_{n, y, x} g[n, o, y, x] * xpad[n, c, y + i, x + j]
//   * K3 conv_dgrad_kernel <- `_conv_dgrad_kernel` (launched by
//     `conv_bwd_input`): the stride-1 correlation of the (k-1-p)-padded grad
//     with the 180-degree-rotated, O<->C-swapped filter, i.e.
//       dx[n, c, h, w] = sum_{o, i, j} g[n, o, h + p - i, w + p - j] * w[o, c, i, j]
// Loads are f32 or bf16 (x, g and w of one type), every product and sum is
// f32, and both outputs are f32, as `preferred_element_type` makes them in
// the Pallas kernels; the caller casts.
//
// What bounds them on the H100. Each is an implicit GEMM: per tap, K2 is an
// O x C product reduced over M = N*OH*OW, and K3 an (N*H*W) x C product
// reduced over O * taps. At ResNet-50's shapes that is 2*M*O*C*taps flops
// against a few bytes per input element, hundreds of operations per byte:
// the bound is the tensor cores' rate. This first version multiplies with
// f32 FMAs on the CUDA cores from 64 x 64 tiles staged in shared memory
// (256 threads, a 4 x 4 micro-tile each, a reduction chunk of 16), so it
// stays well above that bound; wgmma, TMA and cp.async pipelines are the
// next step. What the design does:
//   * No im2col. The tap's shifted window of x (K2) or of g (K3) is read in
//     place from NCHW through its index arithmetic; the halo of the padding
//     comes from masked loads that read zero, so the wrapper pads nothing
//     and makes no channels-last copy.
//   * K2 fills the card by splitting M. At ResNet-50's stage-1 shapes
//     M = 32*56*56 = 100,352 while O x C is 64 x 64: one block per output
//     tile would leave most of the 132 SMs idle. The grid is therefore
//     (C tiles, O tiles, taps * splits); block s sums its fixed range of M
//     chunks and writes an f32 partial to a workspace the wrapper
//     allocates, and conv_wgrad_reduce_kernel sums the partials over s in
//     a fixed order while laying the result out as (O, C, kh, kw). No
//     atomics: a repeated launch gives the same bits.
//   * K3 has one owner per output tile of (N*H*W) x C; the reduction over
//     the taps and O runs inside the block in a fixed order, so it is
//     bitwise-repeatable too.
//   * Loads walk the reduction's contiguous axis (the spatial index) across
//     neighbouring threads, so global reads coalesce along W.
//
// Entry points: mxtt_conv_bwd_filter and mxtt_conv_bwd_input (plain C, loaded
// with ctypes). Each returns the cudaError_t of its launches (0 on success)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // rows and cols of an output tile
constexpr int kK = 16;              // reduction chunk
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = kTile + 4;   // shared row pitch: keeps float4 alignment

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Geo {
  int n, c, h, w, o, kh, kw, ph, pw, oh, ow;
};

// acc[i][j] += sum_k As[k][ty*4 + i] * Bs[k][tx*4 + j]
__device__ __forceinline__ void mma_tile(float (*As)[kPitch], float (*Bs)[kPitch],
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// K2, first pass. Block (c tile, o tile, tap * splits + split) sums the
// products of reduction chunks [split * per_split, (split + 1) * per_split)
// for one tap and writes ws[split][tap][o][c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
                  Geo q, int m_total, int splits, int per_split) {
  __shared__ __align__(16) float As[kK][kPitch];  // [m][o]: g
  __shared__ __align__(16) float Bs[kK][kPitch];  // [m][c]: the tap's window of x
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kTile, o0 = blockIdx.y * kTile;
  const int taps = q.kh * q.kw;
  const int tap = blockIdx.z / splits, split = blockIdx.z % splits;
  const int ki = tap / q.kw, kj = tap % q.kw;
  const int ohw = q.oh * q.ow;
  const long long hw = static_cast<long long>(q.h) * q.w;
  const int n_chunks = (m_total + kK - 1) / kK;
  const int first = split * per_split;
  const int last = first + per_split < n_chunks ? first + per_split : n_chunks;
  const int lm = tid % kK;  // the m this thread loads within a chunk
  const int lr = tid / kK;  // the first tile row it loads (then +16, +32, +48)
  float acc[4][4] = {};
  for (int chunk = first; chunk < last; ++chunk) {
    const int m = chunk * kK + lm;
    const bool m_ok = m < m_total;
    int img = 0, y = 0, xx = 0;
    if (m_ok) {
      img = m / ohw;
      const int r = m - img * ohw;
      y = r / q.ow;
      xx = r - y * q.ow;
    }
    const int iy = y + ki - q.ph, ix = xx + kj - q.pw;
    const bool x_ok = m_ok && iy >= 0 && iy < q.h && ix >= 0 && ix < q.w;
    const long long g_off = static_cast<long long>(img) * q.o * ohw +
                            static_cast<long long>(y) * q.ow + xx;
    const long long x_off = x_ok ? static_cast<long long>(img) * q.c * hw +
                                       static_cast<long long>(iy) * q.w + ix
                                 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 16 * i;
      const int oo = o0 + r, cc = c0 + r;
      As[lm][r] = (m_ok && oo < q.o) ? to_f32(g[g_off + static_cast<long long>(oo) * ohw]) : 0.f;
      Bs[lm][r] = (x_ok && cc < q.c) ? to_f32(x[x_off + cc * hw]) : 0.f;
    }
    __syncthreads();
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* out = ws + static_cast<long long>(split * taps + tap) * q.o * q.c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oo = o0 + ty * 4 + i;
    if (oo >= q.o) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + tx * 4 + j;
      if (cc < q.c) out[static_cast<long long>(oo) * q.c + cc] = acc[i][j];
    }
  }
}

// K2, second pass: gw[o][c][tap] = sum over split, in order, of
// ws[split][tap][o][c].
__global__ void conv_wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ gw,
                                         int splits, int taps, long long oc) {
  const long long total = oc * taps;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int tap = static_cast<int>(idx % taps);
    const long long pos = idx / taps;  // o * C + c
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[(static_cast<long long>(sp) * taps + tap) * oc + pos];
    gw[idx] = s;
  }
}

// K3. Block (m tile, c tile) owns dx for 64 positions (n, h, w) and 64
// channels; the taps and the O chunks are loops inside it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ wt, float* __restrict__ dx,
                  Geo q, int m_total) {
  __shared__ __align__(16) float As[kK][kPitch];  // [o][m]: the tap's window of g
  __shared__ __align__(16) float Bs[kK][kPitch];  // [o][c]: the tap of w
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int hw = q.h * q.w;
  const long long ohw = static_cast<long long>(q.oh) * q.ow;
  const int lm = tid % kTile;  // the m (and the c) this thread loads
  const int lo = tid / kTile;  // the first o row it loads (then +4, +8, +12)
  const int m = m0 + lm;
  const bool m_ok = m < m_total;
  int img = 0, y = 0, xx = 0;
  if (m_ok) {
    img = m / hw;
    const int r = m - img * hw;
    y = r / q.w;
    xx = r - y * q.w;
  }
  const long long g_img = static_cast<long long>(img) * q.o * ohw;
  const int cc = c0 + lm;
  const int taps = q.kh * q.kw;
  float acc[4][4] = {};
  for (int tap = 0; tap < taps; ++tap) {
    const int ki = tap / q.kw, kj = tap % q.kw;
    const int gy = y + q.ph - ki, gx = xx + q.pw - kj;
    const bool g_ok = m_ok && gy >= 0 && gy < q.oh && gx >= 0 && gx < q.ow;
    const long long g_off = g_ok ? g_img + static_cast<long long>(gy) * q.ow + gx : 0;
    for (int o0 = 0; o0 < q.o; o0 += kK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lo + 4 * i;
        const int oo = o0 + r;
        As[r][lm] = (g_ok && oo < q.o) ? to_f32(g[g_off + oo * ohw]) : 0.f;
        Bs[r][lm] = (oo < q.o && cc < q.c)
                        ? to_f32(wt[((static_cast<long long>(oo) * q.c + cc) * q.kh + ki) * q.kw + kj])
                        : 0.f;
      }
      __syncthreads();
      mma_tile(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
    if (mm >= m_total) continue;
    const int im = mm / hw;
    const int rem = mm - im * hw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < q.c) dx[(static_cast<long long>(im) * q.c + c) * hw + rem] = acc[i][j];
    }
  }
}

Geo make_geo(int n, int c, int h, int w, int o, int kh, int kw, int ph, int pw, int oh, int ow) {
  Geo q;
  q.n = n; q.c = c; q.h = h; q.w = w; q.o = o; q.kh = kh; q.kw = kw;
  q.ph = ph; q.pw = pw; q.oh = oh; q.ow = ow;
  return q;
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* g, void* ws, void* gw, const Geo& q,
                         int splits, int per_split, cudaStream_t stream) {
  const int taps = q.kh * q.kw;
  const int m_total = q.n * q.oh * q.ow;
  const long long z = static_cast<long long>(taps) * splits;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((q.c + kTile - 1) / kTile, (q.o + kTile - 1) / kTile, static_cast<unsigned>(z));
  conv_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws), q, m_total,
      splits, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long oc = static_cast<long long>(q.o) * q.c;
  const long long total = oc * taps;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  conv_wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<float*>(gw), splits, taps, oc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dgrad(const void* g, const void* wt, void* dx, const Geo& q,
                         cudaStream_t stream) {
  const int m_total = q.n * q.h * q.w;
  const dim3 grid((m_total + kTile - 1) / kTile, (q.c + kTile - 1) / kTile);
  conv_dgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wt), static_cast<float*>(dx), q, m_total);
  return cudaGetLastError();
}

}  // namespace

// gw (O, C, kh, kw) f32 from x (N, C, H, W) and g (N, O, OH, OW), both f32 or
// both bf16, contiguous; ws holds splits * kh * kw * O * C floats.
extern "C" int mxtt_conv_bwd_filter(const void* x, const void* g, void* ws, void* gw, int n,
                                    int c, int h, int w, int o, int kh, int kw, int ph, int pw,
                                    int oh, int ow, int splits, int per_split, int is_bf16,
                                    void* stream) {
  if (n <= 0 || c <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
      ? launch_wgrad<__nv_bfloat16>(x, g, ws, gw, q, splits, per_split, s)
      : launch_wgrad<float>(x, g, ws, gw, q, splits, per_split, s);
  return static_cast<int>(err);
}

// dx (N, C, H, W) f32 from g (N, O, OH, OW) and w (O, C, kh, kw), both f32 or
// both bf16, contiguous.
extern "C" int mxtt_conv_bwd_input(const void* g, const void* wt, void* dx, int n, int c, int h,
                                   int w, int o, int kh, int kw, int ph, int pw, int oh, int ow,
                                   int is_bf16, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dgrad<__nv_bfloat16>(g, wt, dx, q, s)
                                  : launch_dgrad<float>(g, wt, dx, q, s);
  return static_cast<int>(err);
}
