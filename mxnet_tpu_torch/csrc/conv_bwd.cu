// Conv-backward pair for Hopper (sm_90a), CUDA C++: the gradients of a 2-D
// convolution with stride 1, dilation 1 and one group, NCHW / OIHW.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py:
//   * K2 conv_wgrad_kernel (+ conv_wgrad_reduce_kernel) <- `_conv_wgrad_kernel`
//     (launched by `conv_bwd_filter`):
//       gw[o, c, i, j] = sum_{n, y, x} g[n, o, y, x] * xpad[n, c, y + i, x + j]
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
// reduced over O * taps. At ResNet-50's shapes that is 2*M*O*C*taps flops
// against a few bytes per input element, hundreds of operations per byte:
// the bound is the tensor cores' rate. What the designs do:
//   * K3, bf16 (conv_dgrad_sm90, flash_sm90.cuh's TMA, mbarrier and wgmma
//     pieces): M = an 8 x 8 patch of one image's positions, N = 64 (C <=
//     64) or 128 channels, K = taps * O in steps of 64 o. TMA wants byte
//     strides that are multiples of 16, which a row of NCHW g (OW * 2 B: 14,
//     28, 56 B at OW 7, 14, 28) is not, so transpose_bf16 first writes g
//     channels-last (N, OH, OW, O) and w as (C, kh, kw, O) into workspaces
//     the wrapper allocates (O % 8 == 0 in the envelope; the JAX wrapper
//     transposes outside its kernel too): two batched 2-D transposes
//     through shared memory, coalesced both ways, ~1/3 of K3's bytes. A
//     step's A tile is one 4-D box (o 64, x 8, y 8, n 1) of g at the tap's
//     shift: 64 rows of 128 B with the 128 B swizzle, Tile<64>'s layout,
//     read K-major; TMA fills coordinates outside OH x OW (negative ones
//     too) and past O with zeros, which covers the halo and the ragged
//     edges without a padded copy. Its B tile is one 3-D box (o 64, tap 1,
//     c N) of the permuted weight, K-major. The steps stream through a
//     4-stage ring in one fixed order (tap major, o chunk minor) into SS
//     wgmma m64nNk16, one group left in flight while the stage before is
//     refilled. An 8 x 8 patch tiles 56 x 56 exactly; at 28, 14 and 7
//     about 23% of the tiled positions fall outside the image and are
//     computed but not stored. Stores are f32 NCHW, x fastest across the
//     lanes of a quad group.
//   * K2, and K3 in f32, multiply with f32 FMAs on the CUDA cores from
//     64 x 64 tiles staged in shared memory (256 threads, a 4 x 4
//     micro-tile each, a reduction chunk of 16); the f32 limit (1e-4)
//     rules out TF32 tensor cores for K3 in f32, and K2 waits for its own
//     redesign. No im2col: the tap's shifted window of x (K2) or of g (K3)
//     is read in place from NCHW through its index arithmetic; the halo of
//     the padding comes from masked loads that read zero. Loads walk the
//     reduction's contiguous axis (the spatial index) across neighbouring
//     threads, so global reads coalesce along W.
//   * K2 fills the card by splitting M. At ResNet-50's stage-1 shapes
//     M = 32*56*56 = 100,352 while O x C is 64 x 64: one block per output
//     tile would leave most of the 132 SMs idle. The grid is therefore
//     (C tiles, O tiles, taps * splits); block s sums its fixed range of M
//     chunks and writes an f32 partial to a workspace the wrapper
//     allocates, and conv_wgrad_reduce_kernel sums the partials over s in
//     a fixed order while laying the result out as (O, C, kh, kw). No
//     atomics: a repeated launch gives the same bits.
//   * K3 has one owner per output tile of (N*H*W) x C in both kernels; the
//     reduction over the taps and O runs inside the block in a fixed
//     order, so it is bitwise-repeatable too.
//
// Entry points: mxtt_conv_bwd_filter and mxtt_conv_bwd_input (plain C, loaded
// with ctypes). Each returns the cudaError_t of its launches (0 on success)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

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

// ------------------------------------------------------------------ bf16 K3
// In namespace sm90, so the header's names (kRows, kThreads = one
// warpgroup) are found before the SIMT kernels'.
namespace sm90 {
namespace {

constexpr int kConvStages = 4;  // ring depth over (tap, o chunk) steps
constexpr int kPatch = 8;       // an M tile is an 8 x 8 patch of one image's positions
constexpr int kChunk = 64;      // o of one k step: 128 B rows, the 128 B swizzle

// Shared-memory map of one CTA: kConvStages stages of (A: 64 positions x
// 64 o, B: kN channels x 64 o), both 128 B rows with the 128 B swizzle,
// i.e. Tile<64>'s layout, read K-major; then kConvStages "full" and
// kConvStages "empty" barriers.
template <int kN>
struct ConvRing {
  static constexpr int kABytes = kRows * 2 * kChunk;
  static constexpr int kBBytes = kN * 2 * kChunk;
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

cudaError_t transpose(const void* in, void* out, int batch, int rows, int cols,
                      cudaStream_t stream) {
  const dim3 grid((cols + kT - 1) / kT, (rows + kT - 1) / kT, batch);
  transpose_bf16<<<grid, dim3(kT, 8), 0, stream>>>(static_cast<const uint16_t*>(in),
                                                   static_cast<uint16_t*>(out), rows, cols);
  return cudaGetLastError();
}

// g (N, O, OH, OW) and w (O, C, kh, kw), contiguous bf16, are first
// transposed into the layouts TMA reads (byte strides multiples of 16, as
// O % 8 == 0): g_cl channels-last (N, OH, OW, O) and w_t (C, kh, kw, O)
template <int kN>
cudaError_t launch_dgrad_bf16(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                              const Geo& q, cudaStream_t stream) {
  const int taps = q.kh * q.kw;
  cudaError_t err = transpose(g, g_cl, q.n, q.o, q.oh * q.ow, stream);
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

}  // namespace
}  // namespace sm90

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
// both bf16, contiguous. bf16 also takes g_cl and w_t, room for N*O*OH*OW
// and O*C*kh*kw bf16 values (the transposed copies TMA reads; O % 8 == 0);
// f32 ignores them.
extern "C" int mxtt_conv_bwd_input(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                                   int n, int c, int h, int w, int o, int kh, int kw, int ph,
                                   int pw, int oh, int ow, int is_bf16, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_dgrad<float>(g, wt, dx, q, s);
  else if (c <= 64)
    err = sm90::launch_dgrad_bf16<64>(g, wt, g_cl, w_t, dx, q, s);
  else
    err = sm90::launch_dgrad_bf16<128>(g, wt, g_cl, w_t, dx, q, s);
  return static_cast<int>(err);
}
