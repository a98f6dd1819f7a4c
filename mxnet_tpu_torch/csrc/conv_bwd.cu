// Conv-backward pair for Hopper (sm_90a), CUDA C++: the gradients of a 2-D
// convolution with stride 1, dilation 1 and one group, NCHW / OIHW.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py:
//   * K2 <- `_conv_wgrad_kernel` (launched by `conv_bwd_filter`):
//       gw[o, c, i, j] = sum_{n, y, x} g[n, o, y, x] * xpad[n, c, y + i, x + j]
//     (bf16: conv_wgrad_sm90, TMA and wgmma; f32: conv_wgrad_kernel; both
//     then conv_wgrad_reduce_kernel)
//   * K3 <- `_conv_dgrad_kernel` (launched by `conv_bwd_input`): the
//     stride-1 correlation of the (k-1-p)-padded grad with the
//     180-degree-rotated, O<->C-swapped filter, i.e.
//       dx[n, c, h, w] = sum_{o, i, j} g[n, o, h + p - i, w + p - j] * w[o, c, i, j]
//     (bf16: conv_dgrad_sm90, TMA and wgmma; f32: conv_dgrad_kernel)
// Loads are f32 or bf16 (x, g and w of one type), every product and sum is
// f32, and both outputs are f32, as `preferred_element_type` makes them in
// the Pallas kernels; the caller casts.
//
// What bounds them on the H100. Each is an implicit GEMM: per tap, K2 is an
// O x C product reduced over M = N*OH*OW, and K3 an (N*H*W) x C product
// reduced over O * taps. The 3 x 3 convolutions of ResNet-50 do hundreds
// of operations per byte of input: the tensor cores' rate bounds them. Its
// 1 x 1 ones do 2 * O * C / (2 * (O + C)) = O * C / (O + C), 32 to 410,
// against the card's 295 a byte, so most are bound by bytes (32x64x56x56
// -> 256 reads 64 MB for 3.3 GFLOP: 19 us of HBM against 3 us of math),
// and there a layout copy of an operand costs as much as the product. What the designs do:
//   * K2, bf16 (conv_wgrad_sm90, flash_sm90.cuh's TMA, mbarrier and wgmma
//     pieces): per tap D[O x C] += A[O x K] * B[K x C] with K running over
//     positions, 64 a step. Both operands come channels-last, so along K
//     both are MN-major: a step's A is a box (o 64, x 8, y 8, n 1) of
//     channels-last g and its B one or two boxes (c 64, x 8, y 8, n 1) of
//     channels-last x at the tap's shift (x0 + j - pw, y0 + i - ph), each
//     64 rows of 128 B with the 128 B swizzle (Tile<64>'s layout, a
//     128-channel B two boxes 8 KB apart, LBO), read by SS wgmma
//     m64nNk16 with both transpose bits; TMA fills coordinates outside
//     H x W (negative ones too), positions past OH x OW and channels past
//     O or C with zeros, so the halo and the ragged edges need no padded
//     copy. The layout copies are transpose_bf16's (below): x_cl by this
//     entry point, g_cl by it too or, in a backward that wants both
//     gradients, once for K2 and K3 together (mxtt_conv_channels_last).
//     The 1 x 1 convolutions with no padding (33 of ResNet-50's 46) skip
//     the patches, which waste 23% of the positions at 28, 14 and 7: a
//     step is 64 consecutive positions. Where an NCHW row (H * W * 2
//     bytes) is a multiple of 16 (56 x 56, 28 x 28) and g and x start on a
//     16-byte boundary, TMA reads them in place as boxes (position 64, o or
//     c 64, n 1), K-major, and no copy is made, which is what bounds those
//     shapes; else the N*OH*OW rows of the channels-last copies. A CTA is
//     two warpgroups of 64 o each where O > 64, sharing each stage's x
//     tile (half the shared-memory bytes a product of one), else one; a
//     4-stage ring, one wgmma group left in flight. M is split so the CTAs
//     fill one wave of the CTAs that fit the card by their shared memory
//     and no more (kernels.wgrad_splits_sm90): a second, short wave doubled
//     the time of the 3 x 3 shapes. Block s
//     writes an f32 partial to a workspace and conv_wgrad_reduce_kernel
//     sums the partials over s in a fixed order while laying the result
//     out as (O, C, kh, kw). No atomics: a repeat gives the same bits.
//   * K3, bf16 (conv_dgrad_sm90, the same pieces): M = an 8 x 8 patch of
//     one image's positions, N = 64 (C <= 64) or 128 channels, K = taps *
//     O in steps of 64 o. TMA wants byte strides that are multiples of 16,
//     which a row of NCHW g (OW * 2 B: 14, 28, 56 B at OW 7, 14, 28) is
//     not, so it reads g channels-last (N, OH, OW, O) and w as
//     (C, kh, kw, O) (O % 8 == 0 in the envelope; the JAX wrapper
//     transposes outside its kernel too). A step's A tile is one 4-D box
//     (o 64, x 8, y 8, n 1) of g at the tap's shift, read K-major; its B
//     tile one 3-D box (o 64, tap 1, c N) of the permuted weight, K-major.
//     The steps stream through a 4-stage ring in one fixed order (tap
//     major, o chunk minor) into SS wgmma m64nNk16, one group left in
//     flight while the stage before is refilled. Stores are f32 NCHW, x
//     fastest across the lanes of a quad group. One owner per output tile:
//     bitwise-repeatable.
//   * The layout copies (transpose_bf16, transpose_bf16_pairs): batched
//     2-D transposes through shared memory, coalesced both ways; where rows
//     and columns are even and both arrays start on a 4-byte boundary,
//     64 x 64 tiles moved two values a thread per 4-byte access.
//   * f32 K2 and K3 multiply with f32 FMAs on the CUDA cores from 64 x 64
//     tiles staged in shared memory (256 threads, a 4 x 4 micro-tile each,
//     a reduction chunk of 16); the f32 limit (1e-4) rules out TF32 tensor
//     cores. No im2col: the tap's shifted window of x (K2) or of g (K3) is
//     read in place from NCHW through its index arithmetic; the halo of
//     the padding comes from masked loads that read zero. f32 K2 splits M
//     as above (kernels.wgrad_splits: about four blocks an SM).
//
// Entry points: mxtt_conv_bwd_filter, mxtt_conv_bwd_input and
// mxtt_conv_channels_last (plain C, loaded with ctypes). Each returns the
// cudaError_t of its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace {

constexpr int kTile = 64;           // rows and cols of an output tile
constexpr int kK = 16;              // reduction chunk
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = kTile + 4;   // shared row pitch: keeps float4 alignment

__device__ __forceinline__ float to_f32(float x) { return x; }

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

// K2's second pass over the partials of either first pass
cudaError_t launch_wgrad_reduce(const void* ws, void* gw, const Geo& q, int splits,
                                cudaStream_t stream) {
  const int taps = q.kh * q.kw;
  const long long oc = static_cast<long long>(q.o) * q.c;
  const long long total = oc * taps;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  conv_wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<float*>(gw), splits, taps, oc);
  return cudaGetLastError();
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_wgrad_reduce(ws, gw, q, splits, stream);
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

// ------------------------------------------------------------------ bf16 K3
// In namespace sm90, so the header's names (kRows, kThreads = one
// warpgroup) are found before the SIMT kernels'.
namespace sm90 {
namespace {

constexpr int kConvStages = 4;  // ring depth over (tap, o chunk) steps
constexpr int kPatch = 8;       // an M tile is an 8 x 8 patch of one image's positions
constexpr int kChunk = 64;      // o of one k step: 128 B rows, the 128 B swizzle

constexpr int kBox = kRows * 2 * kChunk;  // one 64 x 64 bf16 box: 64 rows of 128 B

// Shared-memory map of one CTA: kConvStages stages of (A: kA boxes, B:
// kN / 64 boxes), each box 64 rows of 128 B with the 128 B swizzle, i.e.
// Tile<64>'s layout; then kConvStages "full" and kConvStages "empty"
// barriers. K3: A is 64 positions x 64 o, B kN channels x 64 o, both read
// K-major. K2: A is kA boxes of 64 positions x 64 o (one a warpgroup), B
// kN / 64 boxes of 64 positions x 64 channels, both read MN-major.
// kernels.wgrad_ctas_per_sm90 counts K2's CTAs an SM from kSmemBytes.
template <int kN, int kA = 1>
struct ConvRing {
  static constexpr int kABytes = kA * kBox;
  static constexpr int kBBytes = kN / kChunk * kBox;
  static constexpr int kStage = kABytes + kBBytes;  // a multiple of 1024
  static constexpr int kBarOffset = kConvStages * kStage;
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * 2 * kConvStages;

  uint32_t base;
  __device__ __forceinline__ uint32_t a_tile(int s) const { return base + s * kStage; }
  __device__ __forceinline__ uint32_t b_tile(int s) const { return a_tile(s) + kABytes; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOffset + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + kBarOffset + 8 * (kConvStages + s);
  }
};

// thread 0: k step kt (tap kt / chunks, o chunk kt % chunks) into its stage:
// the tap's window of g, a box (o 64, x 8, y 8, n 1) at (o0, x0 + pw - j,
// y0 + ph - i, n), whose coordinates outside OH x OW (negative ones too)
// and past O read as zeros; and the box (o 64, tap 1, c kN) of the weight
template <int kN>
__device__ __forceinline__ void conv_load(const ConvRing<kN>& ring, const CUtensorMap* gmap,
                                          const CUtensorMap* wmap, Geo q, int kt,
                                          int chunks, int n, int y0, int x0, int c0) {
  const int s = kt % kConvStages;
  const int tap = kt / chunks;
  const int o0 = (kt - tap * chunks) * kChunk;
  const int i = tap / q.kw, j = tap - i * q.kw;
  mbar_expect_tx(ring.full(s), ConvRing<kN>::kStage);
  tma_load_4d(ring.a_tile(s), gmap, ring.full(s), o0, x0 + q.pw - j, y0 + q.ph - i, n);
  tma_load_3d(ring.b_tile(s), wmap, ring.full(s), o0, tap, c0);
}

// K3, bf16: an implicit GEMM, dx (positions x channels) = sum over (tap,
// o) of g's shifted window (positions x o) times the tap of w (o x
// channels). One CTA (one warpgroup) per (8 x 8 patch of one image, kN
// channels); the (tap, o chunk) steps stream through a ring of TMA stages
// in one fixed order, each 4 SS wgmma m64nkNk16, with one group left in
// flight while the previous step's stage is refilled. One owner per output
// tile, so a repeat gives the same bits.
template <int kN>
__global__ void __launch_bounds__(kThreads)
    conv_dgrad_sm90(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap wmap, float* __restrict__ dx, Geo q,
                    int tiles_y, int tiles_x) {
  extern __shared__ uint8_t smem_raw[];
  const ConvRing<kN> ring{aligned_smem_base(smem_raw)};
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  int m = blockIdx.x;
  const int x0 = (m % tiles_x) * kPatch;
  m /= tiles_x;
  const int y0 = (m % tiles_y) * kPatch;
  const int n = m / tiles_y;
  const int c0 = blockIdx.y * kN;
  const int chunks = (q.o + kChunk - 1) / kChunk;
  const int n_k = q.kh * q.kw * chunks;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < kConvStages && kt < n_k; ++kt)
      conv_load(ring, &gmap, &wmap, q, kt, chunks, n, y0, x0, c0);
  __syncwarp();

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kConvStages;
    mbar_wait(ring.full(s), (kt / kConvStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_ss_acc(acc, desc_kmajor<64>(ring.a_tile(s), kk), desc_kmajor<64>(ring.b_tile(s), kk));
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1 is done: release its stage for step kt - 1 + kConvStages
    fence_regs(acc);
    if (kt > 0) {
      const int done = kt - 1, sd = done % kConvStages;
      mbar_arrive(ring.empty(sd));
      if (tid == 0 && done + kConvStages < n_k) {
        mbar_wait(ring.empty(sd), (done / kConvStages) & 1);
        conv_load(ring, &gmap, &wmap, q, done + kConvStages, chunks, n, y0, x0, c0);
      }
      __syncwarp();
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // row 16w + lane/4 + 8·half of the tile is position (y0 + 2w + half,
  // x0 + lane/4); store only y < H, x < W and c < C, as f32 NCHW
  const long long hw = static_cast<long long>(q.h) * q.w;
  const int x = x0 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int y = y0 + 2 * warp + half;
    if (y >= q.h || x >= q.w) continue;
    float* out = dx + static_cast<long long>(n) * q.c * hw + static_cast<long long>(y) * q.w + x;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * (lane % 4) + e;
        if (c < q.c) out[c * hw] = acc[4 * j + 2 * half + e];
      }
  }
}

constexpr int kT = 32;  // the layout transposes' tile

// out[b][c][r] = in[b][r][c] of 16-bit [batch][rows][cols] (bf16 moved as
// raw bits), through a shared 32 x 32 tile (padded so the column-wise
// reads do not conflict on banks)
__global__ void __launch_bounds__(kT * 8)
    transpose_bf16(const uint16_t* __restrict__ in, uint16_t* __restrict__ out, int rows,
                   int cols) {
  __shared__ uint16_t tile[kT][kT + 2];
  const long long base = static_cast<long long>(blockIdx.z) * rows * cols;
  const int c0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  for (int j = threadIdx.y; j < kT; j += 8) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[j][threadIdx.x] = in[base + static_cast<long long>(r) * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kT; j += 8) {
    const int c = c0 + j, r = r0 + threadIdx.x;
    if (r < rows && c < cols) out[base + static_cast<long long>(c) * rows + r] = tile[threadIdx.x][j];
  }
}

constexpr int kTP = 64;  // the paired transposes' tile

// transpose_bf16 where rows and cols are even: a 64 x 64 tile, each
// thread moving two values in each 4-byte load and store, so a warp reads
// and writes 128 B runs and keeps four times the bytes in flight
__global__ void __launch_bounds__(kT * 8)
    transpose_bf16_pairs(const uint16_t* __restrict__ in, uint16_t* __restrict__ out, int rows,
                         int cols) {
  __shared__ __align__(4) uint16_t tile[kTP][kTP + 2];
  const long long base = static_cast<long long>(blockIdx.z) * rows * cols;
  const int c0 = blockIdx.x * kTP, r0 = blockIdx.y * kTP;
  const int two = 2 * threadIdx.x;
  for (int j = threadIdx.y; j < kTP; j += 8) {
    const int r = r0 + j, c = c0 + two;
    if (r < rows && c < cols)
      *reinterpret_cast<uint32_t*>(&tile[j][two]) =
          *reinterpret_cast<const uint32_t*>(in + base + static_cast<long long>(r) * cols + c);
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTP; j += 8) {
    const int c = c0 + j, r = r0 + two;
    if (r < rows && c < cols)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<long long>(c) * rows + r) =
          tile[two][j] | static_cast<uint32_t>(tile[two + 1][j]) << 16;
  }
}

cudaError_t transpose(const void* in, void* out, int batch, int rows, int cols,
                      cudaStream_t stream) {
  const auto src = static_cast<const uint16_t*>(in);
  const auto dst = static_cast<uint16_t*>(out);
  const bool words = reinterpret_cast<uintptr_t>(in) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (words && rows % 2 == 0 && cols % 2 == 0) {
    const dim3 grid((cols + kTP - 1) / kTP, (rows + kTP - 1) / kTP, batch);
    transpose_bf16_pairs<<<grid, dim3(kT, 8), 0, stream>>>(src, dst, rows, cols);
  } else {
    const dim3 grid((cols + kT - 1) / kT, (rows + kT - 1) / kT, batch);
    transpose_bf16<<<grid, dim3(kT, 8), 0, stream>>>(src, dst, rows, cols);
  }
  return cudaGetLastError();
}

// g (N, O, OH, OW) and w (O, C, kh, kw), contiguous bf16, are first
// transposed into the layouts TMA reads (byte strides multiples of 16, as
// O % 8 == 0): g_cl channels-last (N, OH, OW, O), unless the caller made
// it already (g_ready), and w_t (C, kh, kw, O)
template <int kN>
cudaError_t launch_dgrad_bf16(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                              const Geo& q, bool g_ready, cudaStream_t stream) {
  const int taps = q.kh * q.kw;
  cudaError_t err = g_ready ? cudaSuccess : transpose(g, g_cl, q.n, q.o, q.oh * q.ow, stream);
  if (err != cudaSuccess) return err;
  err = transpose(wt, w_t, 1, q.o, q.c * taps, stream);
  if (err != cudaSuccess) return err;
  const cuuint64_t o = q.o, c = q.c;
  const cuuint64_t gdims[4] = {o, static_cast<cuuint64_t>(q.ow), static_cast<cuuint64_t>(q.oh),
                               static_cast<cuuint64_t>(q.n)};
  const cuuint64_t gstrides[3] = {2 * o, 2 * o * q.ow, 2 * o * q.ow * q.oh};
  const cuuint32_t gbox[4] = {kChunk, kPatch, kPatch, 1};
  const cuuint64_t wdims[3] = {o, static_cast<cuuint64_t>(taps), c};
  const cuuint64_t wstrides[2] = {2 * o, 2 * o * taps};
  const cuuint32_t wbox[3] = {kChunk, 1, kN};
  CUtensorMap gmap, wmap;
  err = encode_bf16(&gmap, g_cl, 4, gdims, gstrides, gbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = encode_bf16(&wmap, w_t, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kern = conv_dgrad_sm90<kN>;
  const size_t smem = ConvRing<kN>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles_y = (q.h + kPatch - 1) / kPatch, tiles_x = (q.w + kPatch - 1) / kPatch;
  const dim3 grid(q.n * tiles_y * tiles_x, (q.c + kN - 1) / kN);
  kern<<<grid, kThreads, smem, stream>>>(gmap, wmap, static_cast<float*>(dx), q, tiles_y,
                                         tiles_x);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 K2

// K2's k steps. Step s is 64 positions: the box (x box_x, y box_y) at
// (x0, y0) of image n, with x0 = (s % tiles_x) * box_x, y0 = (s / tiles_x %
// tiles_y) * box_y and n = s / (tiles_x * tiles_y). That is an 8 x 8 patch
// of one image (patch); or, for a 1 x 1 kernel with no padding, 64
// consecutive positions of one image's H * W row of NCHW g and x, read in
// place where its byte stride H * W * 2 is a multiple of 16 and both start on
// a 16-byte boundary (nchw), else of
// the N * OH * OW rows of g_cl and x_cl, read as one image 64 x 1 wide
// (flat).
struct WgradSteps {
  int images, tiles_y, tiles_x, box_y, box_x;
  int splits, per_split;  // split s takes steps [s * per_split, (s + 1) * per_split)
};

// thread 0: k step kt of the CTA (step `step` of the tap's GEMM) into its
// stage: kA boxes (o 64, x, y, n) of g_cl at (o0 + 64 b, x0, y0, n) and
// kN / 64 boxes (c 64, x, y, n) of x_cl at the tap's shift (c0 + 64 b,
// x0 + j - pw, y0 + i - ph, n); coordinates outside H x W (negative ones
// too), positions past OH x OW or M, and o or c past O or C read as zeros.
// kNchw: the boxes (position 64, o 64, n 1) of g and (position 64, c 64,
// n 1) of x at (x0, o0 + 64 b, n) and (x0, c0 + 64 b, n) instead, zero past
// H * W, O and C.
template <int kN, int kA, bool kNchw>
__device__ __forceinline__ void wgrad_load(const ConvRing<kN, kA>& ring, const CUtensorMap* gmap,
                                           const CUtensorMap* xmap, const WgradSteps& p, int kt,
                                           int step, int o0, int c0, int dy, int dx) {
  const int s = kt % kConvStages;
  const int rest = step / p.tiles_x;
  const int x0 = (step - rest * p.tiles_x) * p.box_x;
  const int y0 = (rest % p.tiles_y) * p.box_y, n = rest / p.tiles_y;
  mbar_expect_tx(ring.full(s), ConvRing<kN, kA>::kStage);
#pragma unroll
  for (int b = 0; b < kA; ++b) {
    if constexpr (kNchw)
      tma_load_3d(ring.a_tile(s) + b * kBox, gmap, ring.full(s), x0, o0 + b * kChunk, n);
    else
      tma_load_4d(ring.a_tile(s) + b * kBox, gmap, ring.full(s), o0 + b * kChunk, x0, y0, n);
  }
#pragma unroll
  for (int b = 0; b < kN / kChunk; ++b) {
    if constexpr (kNchw)
      tma_load_3d(ring.b_tile(s) + b * kBox, xmap, ring.full(s), x0, c0 + b * kChunk, n);
    else
      tma_load_4d(ring.b_tile(s) + b * kBox, xmap, ring.full(s), c0 + b * kChunk, x0 + dx,
                  y0 + dy, n);
  }
}

// K2, bf16, first pass: an implicit GEMM per tap, gw_tap (o x c) = sum over
// positions of g_cl's box (positions x o) transposed times x_cl's shifted
// box (positions x c). CTA (c tile, o tile, tap * splits + split), kW
// warpgroups of 64 o each (A box wg) sharing the stage's x tile, sums the
// steps of its split in one fixed order
// through a ring of TMA stages, four SS wgmma m64nkNk16 a step with both
// operands MN-major (kNchw: the NCHW boxes, o x positions and c x
// positions, both K-major), one group left in flight while the previous
// step's stage is refilled, and writes its f32 partial to
// ws[split][tap][o][c].
template <int kN, int kW, bool kNchw>
__global__ void __launch_bounds__(kThreads * kW)
    conv_wgrad_sm90(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap xmap, float* __restrict__ ws, Geo q,
                    WgradSteps p) {
  extern __shared__ uint8_t smem_raw[];
  const ConvRing<kN, kW> ring{aligned_smem_base(smem_raw)};
  const int tid = threadIdx.x;
  const int wg = tid / kThreads, warp = tid % kThreads / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kN, o0 = blockIdx.y * kRows * kW;
  const int tap = blockIdx.z / p.splits, split = blockIdx.z - tap * p.splits;
  const int i = tap / q.kw, j = tap - i * q.kw;
  const int first = split * p.per_split;
  const int left = p.images * p.tiles_y * p.tiles_x - first;
  const int n_k = left < p.per_split ? (left > 0 ? left : 0) : p.per_split;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kThreads * kW);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < kConvStages && kt < n_k; ++kt)
      wgrad_load<kN, kW, kNchw>(ring, &gmap, &xmap, p, kt, first + kt, o0, c0, i - q.ph,
                                j - q.pw);
  __syncwarp();

  float acc[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kConvStages;
    mbar_wait(ring.full(s), (kt / kConvStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      if constexpr (kNchw)
        wgmma_ss_acc(acc, desc_kmajor<64>(ring.a_tile(s) + wg * kBox, kk),
                     desc_kmajor<64>(ring.b_tile(s), kk));
      else
        wgmma_ss_mn(acc, desc_mnmajor<64>(ring.a_tile(s) + wg * kBox, kk),
                    desc_mnmajor<kN>(ring.b_tile(s), kk));
    }
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1 is done: release its stage for step kt - 1 + kConvStages
    fence_regs(acc);
    if (kt > 0) {
      const int done = kt - 1, sd = done % kConvStages;
      mbar_arrive(ring.empty(sd));
      if (tid == 0 && done + kConvStages < n_k) {
        mbar_wait(ring.empty(sd), (done / kConvStages) & 1);
        wgrad_load<kN, kW, kNchw>(ring, &gmap, &xmap, p, done + kConvStages,
                                  first + done + kConvStages, o0, c0, i - q.ph, j - q.pw);
      }
      __syncwarp();
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // row 16w + lane/4 + 8·half of the warpgroup's tile is o, column
  // 8j + 2·(lane % 4) + e is c: float2 stores of o < O, c < C (C % 8 == 0)
  float* out = ws + static_cast<long long>(split * q.kh * q.kw + tap) * q.o * q.c;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int o = o0 + kRows * wg + 16 * warp + lane / 4 + 8 * half;
    if (o >= q.o) continue;
    float* row = out + static_cast<long long>(o) * q.c;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int c = c0 + 8 * jj + 2 * (lane % 4);
      if (c < q.c)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[4 * jj + 2 * half], acc[4 * jj + 2 * half + 1]);
    }
  }
}

template <int kN, int kW, bool kNchw>
cudaError_t launch_wgrad_tiles(const CUtensorMap& gmap, const CUtensorMap& xmap, void* ws,
                               const Geo& q, const WgradSteps& p, cudaStream_t stream) {
  const long long z = static_cast<long long>(q.kh) * q.kw * p.splits;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  auto kern = conv_wgrad_sm90<kN, kW, kNchw>;
  const size_t smem = ConvRing<kN, kW>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((q.c + kN - 1) / kN, (q.o + kRows * kW - 1) / (kRows * kW),
                  static_cast<unsigned>(z));
  kern<<<grid, kThreads * kW, smem, stream>>>(gmap, xmap, static_cast<float*>(ws), q, p);
  return cudaGetLastError();
}

// CTAs of two warpgroups (128 o) where O > 64, else of one
template <int kN, bool kNchw>
cudaError_t launch_wgrad_warpgroups(const CUtensorMap& gmap, const CUtensorMap& xmap, void* ws,
                                    const Geo& q, const WgradSteps& p, cudaStream_t stream) {
  return q.o > kRows ? launch_wgrad_tiles<kN, 2, kNchw>(gmap, xmap, ws, q, p, stream)
                     : launch_wgrad_tiles<kN, 1, kNchw>(gmap, xmap, ws, q, p, stream);
}

// in_place: a 1 x 1 kernel with no padding whose NCHW rows of H * W * 2
// bytes are multiples of 16, and whose g and x start on a 16-byte
// boundary, reads g and x in place (nchw). Otherwise x (N, C, H, W)
// and g (N, O, OH, OW), contiguous bf16, are first transposed into the
// channels-last copies TMA reads (byte strides C * 2 and O * 2, multiples
// of 16): x_cl (N, H, W, C) and, unless the caller made it already
// (g_ready), g_cl (N, OH, OW, O). Then the first pass into ws and the
// ordered reduce into gw.
template <int kN>
cudaError_t launch_wgrad_bf16(const void* x, const void* g, void* x_cl, void* g_cl, void* ws,
                              void* gw, const Geo& q, int splits, int per_split, bool g_ready,
                              bool in_place, cudaStream_t stream) {
  const bool flat = q.kh == 1 && q.kw == 1 && q.ph == 0 && q.pw == 0;
  const cuuint64_t o = q.o, c = q.c, n = q.n;
  const cuuint64_t hw = static_cast<cuuint64_t>(q.oh) * q.ow;  // = H * W when flat
  WgradSteps p;
  p.splits = splits;
  p.per_split = per_split;
  cudaError_t err;
  if (in_place) {
    if (!flat || hw % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0)
      return cudaErrorInvalidValue;
    p.images = q.n; p.tiles_y = 1; p.box_y = 1; p.box_x = kRows;
    p.tiles_x = static_cast<int>((hw + kRows - 1) / kRows);
    const cuuint64_t gdims[3] = {hw, o, n}, xdims[3] = {hw, c, n};
    const cuuint64_t gstrides[2] = {2 * hw, 2 * hw * o}, xstrides[2] = {2 * hw, 2 * hw * c};
    const cuuint32_t box[3] = {kRows, kChunk, 1};
    CUtensorMap gmap, xmap;
    err = encode_bf16(&gmap, g, 3, gdims, gstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = encode_bf16(&xmap, x, 3, xdims, xstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = launch_wgrad_warpgroups<kN, true>(gmap, xmap, ws, q, p, stream);
    if (err != cudaSuccess) return err;
    return launch_wgrad_reduce(ws, gw, q, splits, stream);
  }
  err = g_ready ? cudaSuccess : transpose(g, g_cl, q.n, q.o, q.oh * q.ow, stream);
  if (err != cudaSuccess) return err;
  err = transpose(x, x_cl, q.n, q.c, q.h * q.w, stream);
  if (err != cudaSuccess) return err;
  const cuuint64_t m = n * hw;
  cuuint64_t gdims[4], xdims[4];
  if (flat) {
    p.images = 1; p.tiles_y = 1; p.box_y = 1; p.box_x = kRows;
    p.tiles_x = static_cast<int>((m + kRows - 1) / kRows);
    const cuuint64_t gd[4] = {o, m, 1, 1}, xd[4] = {c, m, 1, 1};
    for (int d = 0; d < 4; ++d) { gdims[d] = gd[d]; xdims[d] = xd[d]; }
  } else {
    p.images = q.n; p.box_y = kPatch; p.box_x = kPatch;
    p.tiles_y = (q.oh + kPatch - 1) / kPatch;
    p.tiles_x = (q.ow + kPatch - 1) / kPatch;
    const cuuint64_t gd[4] = {o, static_cast<cuuint64_t>(q.ow), static_cast<cuuint64_t>(q.oh), n};
    const cuuint64_t xd[4] = {c, static_cast<cuuint64_t>(q.w), static_cast<cuuint64_t>(q.h), n};
    for (int d = 0; d < 4; ++d) { gdims[d] = gd[d]; xdims[d] = xd[d]; }
  }
  const cuuint64_t gstrides[3] = {2 * o, 2 * o * gdims[1], 2 * o * gdims[1] * gdims[2]};
  const cuuint64_t xstrides[3] = {2 * c, 2 * c * xdims[1], 2 * c * xdims[1] * xdims[2]};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(p.box_x),
                             static_cast<cuuint32_t>(p.box_y), 1};
  CUtensorMap gmap, xmap;
  err = encode_bf16(&gmap, g_cl, 4, gdims, gstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = encode_bf16(&xmap, x_cl, 4, xdims, xstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = launch_wgrad_warpgroups<kN, false>(gmap, xmap, ws, q, p, stream);
  if (err != cudaSuccess) return err;
  return launch_wgrad_reduce(ws, gw, q, splits, stream);
}

}  // namespace
}  // namespace sm90

// gw (O, C, kh, kw) f32 from x (N, C, H, W) and g (N, O, OH, OW), both f32 or
// both bf16, contiguous; ws holds splits * kh * kw * O * C floats. bf16 also
// takes x_cl and g_cl, room for N*C*H*W and N*O*OH*OW bf16 values (the
// channels-last copies TMA reads); with g_ready, g_cl already holds g's
// (mxtt_conv_channels_last); with in_place, g and x are read in place
// (kernels.wgrad_mode_sm90's "nchw") and x_cl and g_cl are unused. f32
// ignores all four.
extern "C" int mxtt_conv_bwd_filter(const void* x, const void* g, void* x_cl, void* g_cl,
                                    void* ws, void* gw, int n, int c, int h, int w, int o, int kh,
                                    int kw, int ph, int pw, int oh, int ow, int splits,
                                    int per_split, int is_bf16, int g_ready, int in_place,
                                    void* stream) {
  if (n <= 0 || c <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_wgrad<float>(x, g, ws, gw, q, splits, per_split, s);
  else if (c <= 64)
    err = sm90::launch_wgrad_bf16<64>(x, g, x_cl, g_cl, ws, gw, q, splits, per_split, g_ready,
                                      in_place, s);
  else
    err = sm90::launch_wgrad_bf16<128>(x, g, x_cl, g_cl, ws, gw, q, splits, per_split, g_ready,
                                       in_place, s);
  return static_cast<int>(err);
}

// dx (N, C, H, W) f32 from g (N, O, OH, OW) and w (O, C, kh, kw), both f32 or
// both bf16, contiguous. bf16 also takes g_cl and w_t, room for N*O*OH*OW
// and O*C*kh*kw bf16 values (the transposed copies TMA reads; O % 8 == 0);
// with g_ready, g_cl already holds g's. f32 ignores them.
extern "C" int mxtt_conv_bwd_input(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                                   int n, int c, int h, int w, int o, int kh, int kw, int ph,
                                   int pw, int oh, int ow, int is_bf16, int g_ready,
                                   void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_dgrad<float>(g, wt, dx, q, s);
  else if (c <= 64)
    err = sm90::launch_dgrad_bf16<64>(g, wt, g_cl, w_t, dx, q, g_ready, s);
  else
    err = sm90::launch_dgrad_bf16<128>(g, wt, g_cl, w_t, dx, q, g_ready, s);
  return static_cast<int>(err);
}

// out (batch, cols, rows) from in (batch, rows, cols), 16-bit values: the
// channels-last copy of a bf16 conv gradient, (N, O, OH * OW) ->
// (N, OH * OW, O), made once and handed to both K2 and K3 (g_ready)
extern "C" int mxtt_conv_channels_last(const void* in, void* out, int batch, int rows, int cols,
                                       void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0) return 0;
  return static_cast<int>(
      sm90::transpose(in, out, batch, rows, cols, static_cast<cudaStream_t>(stream)));
}
