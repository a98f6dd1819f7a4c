// Conv-backward pair for Hopper (sm_90a), CUDA C++: the gradients of a 2-D
// convolution with stride 1, dilation 1 and one group, NCHW / OIHW.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py:
//   * K2 <- `_conv_wgrad_kernel` (launched by `conv_bwd_filter`):
//       gw[o, c, i, j] = sum_{n, y, x} g[n, o, y, x] * xpad[n, c, y + i, x + j]
//     (conv_wgrad_sm90, TMA and wgmma, then conv_wgrad_reduce_kernel)
//   * K3 <- `_conv_dgrad_kernel` (launched by `conv_bwd_input`): the
//     stride-1 correlation of the (k-1-p)-padded grad with the
//     180-degree-rotated, O<->C-swapped filter, i.e.
//       dx[n, c, h, w] = sum_{o, i, j} g[n, o, h + p - i, w + p - j] * w[o, c, i, j]
//     (conv_dgrad_sm90, TMA and wgmma)
// Loads are f32 or bf16 (x, g and w of one type), every sum is f32, and
// both outputs are f32, as `preferred_element_type` makes them in the
// Pallas kernels; the caller casts.
//
// What bounds them on the H100. Each is an implicit GEMM: per tap, K2 is an
// O x C product reduced over M = N*OH*OW, and K3 an (N*H*W) x C product
// reduced over O * taps. The 3 x 3 convolutions of ResNet-50 do hundreds
// of operations per byte of input: the tensor cores' rate bounds them. Its
// 1 x 1 ones do 2 * O * C / (2 * (O + C)) = O * C / (O + C), 32 to 410,
// against the card's 295 a byte, so most are bound by bytes (32x64x56x56
// -> 256 reads 64 MB for 3.3 GFLOP: 19 us of HBM against 3 us of math),
// and there a layout copy of an operand costs as much as the product. What the designs do:
//   * K2 (conv_wgrad_sm90, flash_sm90.cuh's TMA, mbarrier and wgmma
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
//     copy. The layout copies are the transposes below: x_cl by this
//     entry point, g_cl by it too or, in a backward that wants both
//     gradients, once for K2 and K3 together (mxtt_conv_channels_last).
//     The 1 x 1 convolutions with no padding (33 of ResNet-50's 46) skip
//     the patches, which waste 23% of the positions at 28, 14 and 7: a
//     step is 64 consecutive positions. Where an NCHW row (H * W * 2
//     bytes) is a multiple of 16 (56 x 56, 28 x 28) and bf16 g and x start
//     on a 16-byte boundary, TMA reads them in place as boxes (position
//     64, o or c 64, n 1), K-major, and no copy is made, which is what
//     bounds those shapes; else the N*OH*OW rows of the channels-last
//     copies. A CTA is two warpgroups of 64 o each where O > 64, sharing
//     each stage's x tile (half the shared-memory bytes a product of one),
//     else one; a ring of up to 4 stages, one wgmma group left in flight.
//     M is split so the CTAs fill one wave of the CTAs that fit the card
//     by their shared memory and no more (kernels.wgrad_splits_sm90): a
//     second, short wave doubled the time of the 3 x 3 shapes. Block s
//     writes an f32 partial to a workspace and conv_wgrad_reduce_kernel
//     sums the partials over s in a fixed order while laying the result
//     out as (O, C, kh, kw). No atomics: a repeat gives the same bits.
//   * K3 (conv_dgrad_sm90, the same pieces): M = an 8 x 8 patch of
//     one image's positions, N = 64 (C <= 64) or 128 channels, K = taps *
//     O in steps of 64 o. TMA wants byte strides that are multiples of 16,
//     which a row of NCHW g (OW * 2 B: 14, 28, 56 B at OW 7, 14, 28) is
//     not, so it reads g channels-last (N, OH, OW, O) and w as
//     (C, kh, kw, O) (O % 8 == 0 in the envelope; the JAX wrapper
//     transposes outside its kernel too). A step's A tile is one 4-D box
//     (o 64, x 8, y 8, n 1) of g at the tap's shift, read K-major; its B
//     tile one 3-D box (o 64, tap 1, c N) of the permuted weight, K-major.
//     The steps stream through a ring of up to 4 stages in one fixed order
//     (tap major, o chunk minor) into SS wgmma m64nNk16, one group left in
//     flight while the stage before is refilled. Stores are f32 NCHW, x
//     fastest across the lanes of a quad group. One owner per output tile:
//     bitwise-repeatable.
//   * f32 (both kernels, kP = 2 planes): the f32 limit (1e-4 of max|plain|)
//     rules out one TF32 or bf16 product (2.5e-4 and 2e-3 of max), and f32
//     FMAs on the CUDA cores reach at most 67 TFLOP/s. So every f32 value
//     v is split into two bf16 planes, hi = bf16_rn(v) and lo = bf16_rn(v
//     - hi) (v - hi is exact in f32), and each k16 step runs three SS
//     wgmma into one f32 accumulator, always in the order a_hi * b_lo,
//     a_lo * b_hi, a_hi * b_hi (a_lo * b_lo, about 2^-16 of a product, is
//     left out): 4-7e-6 of max|exact| at ResNet-50's reductions with IEEE
//     f32 sums, on the bf16 tensor cores at a third of their rate. The
//     tensor cores' f32 accumulation loses low bits on every wgmma with a
//     bias: on an H100 the error grew with the k16 steps one accumulator
//     sums, to 2.1e-4 of max (over the limit) at the 896 k steps a split
//     of K2 at 256 x 64 x 56 x 56 3 x 3, and to a third of that with
//     hi * hi alone in it. So the products of kPromoteSteps k steps go into
//     that accumulator, which is then added into a second on the CUDA
//     cores (an f32 add, rounded to nearest) and zeroed: 4-8e-6 of max at
//     every depth measured, for under 1% of the time. The layout pass
//     (transpose_bf16_split) reads each f32 value once and writes its two
//     2-byte planes, as many bytes as an f32 channels-last copy. A stage
//     of the ring holds A_hi, A_lo, B_hi and B_lo, twice a bf16 stage's
//     bytes, so the ring takes as many stages, up to 4, as fit a CTA's
//     227 KB (3 for K2's 128 o x 128 c). NCHW is never read in place:
//     the values must be split first.
//   * The layout copies (transpose_bf16, transpose_bf16_pairs,
//     transpose_bf16_split): batched 2-D transposes through shared memory,
//     coalesced both ways; where rows and columns are even and both arrays
//     start on a 4-byte boundary, 64 x 64 tiles moved two values a thread
//     per 4-byte store.
//
// Entry points: mxtt_conv_bwd_filter, mxtt_conv_bwd_input and
// mxtt_conv_channels_last (plain C, loaded with ctypes). Each returns the
// cudaError_t of its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace {

struct Geo {
  int n, c, h, w, o, kh, kw, ph, pw, oh, ow;
};

Geo make_geo(int n, int c, int h, int w, int o, int kh, int kw, int ph, int pw, int oh, int ow) {
  Geo q;
  q.n = n; q.c = c; q.h = h; q.w = w; q.o = o; q.kh = kh; q.kw = kw;
  q.ph = ph; q.pw = pw; q.oh = oh; q.ow = ow;
  return q;
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

}  // namespace

namespace sm90 {
namespace {

constexpr int kConvStages = 4;  // ring depth over k steps, where it fits
constexpr int kPatch = 8;       // an M tile is an 8 x 8 patch of one image's positions
constexpr int kChunk = 64;      // o of one k step: 128 B rows, the 128 B swizzle
constexpr int kCtaSmem = 232448;  // shared memory a CTA can use on an H100 (227 KB)

constexpr int kBox = kRows * 2 * kChunk;  // one 64 x 64 bf16 box: 64 rows of 128 B

// Shared-memory map of one CTA: kStages stages, each kP planes of A (kA
// boxes) then kP planes of B (kN / 64 boxes), each box 64 rows of 128 B
// with the 128 B swizzle, i.e. Tile<64>'s layout; then kStages "full" and
// kStages "empty" barriers. kP = 1: bf16; kP = 2: the hi and lo planes of
// split f32. K3: A is 64 positions x 64 o, B kN channels x 64 o, both read
// K-major. K2: A is kA boxes of 64 positions x 64 o (one a warpgroup), B
// kN / 64 boxes of 64 positions x 64 channels, both read MN-major. The
// ring takes kConvStages stages, or as many as fit kCtaSmem.
// kernels.wgrad_ctas_per_sm90 counts K2's CTAs an SM from kSmemBytes.
template <int kN, int kA = 1, int kP = 1>
struct ConvRing {
  static constexpr int kABytes = kA * kBox;  // one plane
  static constexpr int kBBytes = kN / kChunk * kBox;
  static constexpr int kStage = kP * (kABytes + kBBytes);  // a multiple of 1024
  static constexpr int kFit = (kCtaSmem - 1024 - 16 * kConvStages) / kStage;
  static constexpr int kStages = kFit < kConvStages ? kFit : kConvStages;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static constexpr int kBarOffset = kStages * kStage;
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * 2 * kStages;

  uint32_t base;
  __device__ __forceinline__ uint32_t a_tile(int s, int p = 0) const {
    return base + s * kStage + p * kABytes;
  }
  __device__ __forceinline__ uint32_t b_tile(int s, int p = 0) const {
    return base + s * kStage + kP * kABytes + p * kBBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOffset + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + kBarOffset + 8 * (kStages + s);
  }
};

// The tensor maps of a kernel's A and B operands, one a plane
template <int kP>
struct ConvMaps {
  CUtensorMap a[kP], b[kP];
};

// split f32 (kP = 2): the k steps whose products part sums before it is
// added into acc
constexpr int kPromoteSteps = 8;

// After k step kt's wgmma group is committed: for split f32, every
// kPromoteSteps steps and after the last, wait for every group, add part
// into acc in f32 (rounded to nearest) and zero it; else wait until only
// step kt's group is in flight (step kt - 1 is done). Every CTA takes the
// same steps, so a repeat gives the same bits.
template <int kP, int N>
__device__ __forceinline__ void retire_step(float (&acc)[N], float (&part)[N], int kt, int n_k) {
  if (kP == 2 && ((kt + 1) % kPromoteSteps == 0 || kt + 1 == n_k)) {
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc[e] += part[e];
      part[e] = 0.f;
    }
  } else {
    wgmma_wait<1>();
  }
}

// thread 0: k step kt (tap kt / chunks, o chunk kt % chunks) into its stage,
// each plane: the tap's window of g, a box (o 64, x 8, y 8, n 1) at (o0,
// x0 + pw - j, y0 + ph - i, n), whose coordinates outside OH x OW
// (negative ones too) and past O read as zeros; and the box (o 64, tap 1,
// c kN) of the weight
template <int kN, int kP>
__device__ __forceinline__ void conv_load(const ConvRing<kN, 1, kP>& ring, const ConvMaps<kP>& maps,
                                          Geo q, int kt, int chunks, int n, int y0, int x0,
                                          int c0) {
  using Ring = ConvRing<kN, 1, kP>;
  const int s = kt % Ring::kStages;
  const int tap = kt / chunks;
  const int o0 = (kt - tap * chunks) * kChunk;
  const int i = tap / q.kw, j = tap - i * q.kw;
  mbar_expect_tx(ring.full(s), Ring::kStage);
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    tma_load_4d(ring.a_tile(s, p), &maps.a[p], ring.full(s), o0, x0 + q.pw - j, y0 + q.ph - i, n);
    tma_load_3d(ring.b_tile(s, p), &maps.b[p], ring.full(s), o0, tap, c0);
  }
}

// K3: an implicit GEMM, dx (positions x channels) = sum over (tap, o) of
// g's shifted window (positions x o) times the tap of w (o x channels).
// One CTA (one warpgroup) per (8 x 8 patch of one image, kN channels); the
// (tap, o chunk) steps stream through a ring of TMA stages in one fixed
// order, each 4 k16 steps of kP == 1 ? 1 : 3 SS wgmma m64nkNk16, with one
// group left in flight while the previous step's stage is refilled. One
// owner per output tile, so a repeat gives the same bits.
template <int kN, int kP>
__global__ void __launch_bounds__(kThreads)
    conv_dgrad_sm90(const __grid_constant__ ConvMaps<kP> maps, float* __restrict__ dx, Geo q,
                    int tiles_y, int tiles_x) {
  using Ring = ConvRing<kN, 1, kP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring{aligned_smem_base(smem_raw)};
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
    for (int s = 0; s < Ring::kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < Ring::kStages && kt < n_k; ++kt)
      conv_load(ring, maps, q, kt, chunks, n, y0, x0, c0);
  __syncwarp();

  // the wgmma accumulate into sum: acc (bf16) or part (split f32)
  float acc[kN / 2], part[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = part[i] = 0.f;
  float (&sum)[kN / 2] = kP == 2 ? part : acc;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % Ring::kStages;
    mbar_wait(ring.full(s), (kt / Ring::kStages) & 1);
    fence_regs(sum);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_acc(sum, desc_kmajor<64>(ring.a_tile(s, pa), kk),
                     desc_kmajor<64>(ring.b_tile(s, pb), kk));
      });
    wgmma_commit();
    retire_step<kP>(acc, part, kt, n_k);  // step kt - 1 is done: release its stage
    fence_regs(sum);
    if (kt > 0) {
      const int done = kt - 1, sd = done % Ring::kStages;
      mbar_arrive(ring.empty(sd));
      if (tid == 0 && done + Ring::kStages < n_k) {
        mbar_wait(ring.empty(sd), (done / Ring::kStages) & 1);
        conv_load(ring, maps, q, done + Ring::kStages, chunks, n, y0, x0, c0);
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

constexpr int kTP = 64;  // the paired and split transposes' tile

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

// the bits of bf16_rn(v) and of bf16_rn(v - hi); v - hi is exact in f32
// and is not contracted into anything
__device__ __forceinline__ void split_bf16(float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h))));
}

// hi[b][c][r] and lo[b][c][r], the two bf16 planes of v = in[b][r][c] of
// f32 [batch][rows][cols], through a shared 64 x 64 f32 tile: 4-byte
// loads, 128 B runs a warp; where rows is even and hi starts on a 4-byte
// boundary (kPairs), each thread stores two values of each plane in one
// 4-byte store, else one
template <bool kPairs>
__global__ void __launch_bounds__(kT * 8)
    transpose_bf16_split(const float* __restrict__ in, uint16_t* __restrict__ hi,
                         uint16_t* __restrict__ lo, int rows, int cols) {
  __shared__ float tile[kTP][kTP + 1];
  const long long base = static_cast<long long>(blockIdx.z) * rows * cols;
  const int c0 = blockIdx.x * kTP, r0 = blockIdx.y * kTP;
  for (int j = threadIdx.y; j < kTP; j += 8) {
    const int r = r0 + j;
#pragma unroll
    for (int h = 0; h < kTP; h += kT) {
      const int c = c0 + h + threadIdx.x;
      if (r < rows && c < cols)
        tile[j][h + threadIdx.x] = in[base + static_cast<long long>(r) * cols + c];
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTP; j += 8) {
    const int c = c0 + j;
    if (c >= cols) continue;
    const long long row = base + static_cast<long long>(c) * rows;
    if constexpr (kPairs) {
      const int r = r0 + 2 * threadIdx.x;
      if (r >= rows) continue;
      uint32_t h2, l2;
      split_pair(tile[2 * threadIdx.x][j], tile[2 * threadIdx.x + 1][j], h2, l2);
      *reinterpret_cast<uint32_t*>(hi + row + r) = h2;
      *reinterpret_cast<uint32_t*>(lo + row + r) = l2;
    } else {
#pragma unroll
      for (int h = 0; h < kTP; h += kT) {
        const int r = r0 + h + threadIdx.x;
        if (r >= rows) continue;
        uint32_t vh, vl;
        split_bf16(tile[h + threadIdx.x][j], vh, vl);
        hi[row + r] = static_cast<uint16_t>(vh);
        lo[row + r] = static_cast<uint16_t>(vl);
      }
    }
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

// f32 in [batch][rows][cols] -> its hi plane [batch][cols][rows] at out
// and its lo plane right after it
cudaError_t transpose_split(const void* in, void* out, int batch, int rows, int cols,
                            cudaStream_t stream) {
  const auto src = static_cast<const float*>(in);
  const auto hi = static_cast<uint16_t*>(out);
  const auto lo = hi + static_cast<long long>(batch) * rows * cols;
  const dim3 grid((cols + kTP - 1) / kTP, (rows + kTP - 1) / kTP, batch);
  if (rows % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0)
    transpose_bf16_split<true><<<grid, dim3(kT, 8), 0, stream>>>(src, hi, lo, rows, cols);
  else
    transpose_bf16_split<false><<<grid, dim3(kT, 8), 0, stream>>>(src, hi, lo, rows, cols);
  return cudaGetLastError();
}

// the layout pass of kP planes: bf16 in -> its transpose; f32 in -> the
// transposes of its hi and lo planes, one after the other
template <int kP>
cudaError_t layout(const void* in, void* out, int batch, int rows, int cols,
                   cudaStream_t stream) {
  if constexpr (kP == 1)
    return transpose(in, out, batch, rows, cols, stream);
  else
    return transpose_split(in, out, batch, rows, cols, stream);
}

// plane p of a layout-pass output of `elems` bf16 values a plane
inline const void* plane(const void* base, int p, long long elems) {
  return static_cast<const uint8_t*>(base) + 2 * elems * p;
}

// g (N, O, OH, OW) and w (O, C, kh, kw), contiguous bf16 (kP = 1) or f32
// (kP = 2), are first transposed into the layouts TMA reads (byte strides
// multiples of 16, as O % 8 == 0), as kP bf16 planes each: g_cl
// channels-last (N, OH, OW, O), unless the caller made it already
// (g_ready), and w_t (C, kh, kw, O)
template <int kN, int kP>
cudaError_t launch_dgrad_sm90(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                              const Geo& q, bool g_ready, cudaStream_t stream) {
  const int taps = q.kh * q.kw;
  cudaError_t err = g_ready ? cudaSuccess : layout<kP>(g, g_cl, q.n, q.o, q.oh * q.ow, stream);
  if (err != cudaSuccess) return err;
  err = layout<kP>(wt, w_t, 1, q.o, q.c * taps, stream);
  if (err != cudaSuccess) return err;
  const cuuint64_t o = q.o, c = q.c;
  const cuuint64_t gdims[4] = {o, static_cast<cuuint64_t>(q.ow), static_cast<cuuint64_t>(q.oh),
                               static_cast<cuuint64_t>(q.n)};
  const cuuint64_t gstrides[3] = {2 * o, 2 * o * q.ow, 2 * o * q.ow * q.oh};
  const cuuint32_t gbox[4] = {kChunk, kPatch, kPatch, 1};
  const cuuint64_t wdims[3] = {o, static_cast<cuuint64_t>(taps), c};
  const cuuint64_t wstrides[2] = {2 * o, 2 * o * taps};
  const cuuint32_t wbox[3] = {kChunk, 1, kN};
  const long long g_elems = static_cast<long long>(q.n) * q.o * q.oh * q.ow;
  const long long w_elems = static_cast<long long>(q.o) * q.c * taps;
  ConvMaps<kP> maps;
  for (int p = 0; p < kP; ++p) {
    err = encode_bf16(&maps.a[p], plane(g_cl, p, g_elems), 4, gdims, gstrides, gbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = encode_bf16(&maps.b[p], plane(w_t, p, w_elems), 3, wdims, wstrides, wbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  auto kern = conv_dgrad_sm90<kN, kP>;
  const size_t smem = ConvRing<kN, 1, kP>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles_y = (q.h + kPatch - 1) / kPatch, tiles_x = (q.w + kPatch - 1) / kPatch;
  const dim3 grid(q.n * tiles_y * tiles_x, (q.c + kN - 1) / kN);
  kern<<<grid, kThreads, smem, stream>>>(maps, static_cast<float*>(dx), q, tiles_y, tiles_x);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K2

// K2's k steps. Step s is 64 positions: the box (x box_x, y box_y) at
// (x0, y0) of image n, with x0 = (s % tiles_x) * box_x, y0 = (s / tiles_x %
// tiles_y) * box_y and n = s / (tiles_x * tiles_y). That is an 8 x 8 patch
// of one image (patch); or, for a 1 x 1 kernel with no padding, 64
// consecutive positions of one image's H * W row of NCHW g and x, read in
// place where its byte stride H * W * 2 is a multiple of 16 and both start on
// a 16-byte boundary (nchw, bf16 only), else of
// the N * OH * OW rows of g_cl and x_cl, read as one image 64 x 1 wide
// (flat).
struct WgradSteps {
  int images, tiles_y, tiles_x, box_y, box_x;
  int splits, per_split;  // split s takes steps [s * per_split, (s + 1) * per_split)
};

// thread 0: k step kt of the CTA (step `step` of the tap's GEMM) into its
// stage, each plane: kA boxes (o 64, x, y, n) of g_cl at (o0 + 64 b, x0,
// y0, n) and kN / 64 boxes (c 64, x, y, n) of x_cl at the tap's shift
// (c0 + 64 b, x0 + j - pw, y0 + i - ph, n); coordinates outside H x W
// (negative ones too), positions past OH x OW or M, and o or c past O or C
// read as zeros. kNchw: the boxes (position 64, o 64, n 1) of g and
// (position 64, c 64, n 1) of x at (x0, o0 + 64 b, n) and (x0, c0 + 64 b,
// n) instead, zero past H * W, O and C.
template <int kN, int kA, bool kNchw, int kP>
__device__ __forceinline__ void wgrad_load(const ConvRing<kN, kA, kP>& ring,
                                           const ConvMaps<kP>& maps, const WgradSteps& p, int kt,
                                           int step, int o0, int c0, int dy, int dx) {
  using Ring = ConvRing<kN, kA, kP>;
  const int s = kt % Ring::kStages;
  const int rest = step / p.tiles_x;
  const int x0 = (step - rest * p.tiles_x) * p.box_x;
  const int y0 = (rest % p.tiles_y) * p.box_y, n = rest / p.tiles_y;
  mbar_expect_tx(ring.full(s), Ring::kStage);
#pragma unroll
  for (int pl = 0; pl < kP; ++pl) {
#pragma unroll
    for (int b = 0; b < kA; ++b) {
      if constexpr (kNchw)
        tma_load_3d(ring.a_tile(s, pl) + b * kBox, &maps.a[pl], ring.full(s), x0,
                    o0 + b * kChunk, n);
      else
        tma_load_4d(ring.a_tile(s, pl) + b * kBox, &maps.a[pl], ring.full(s), o0 + b * kChunk,
                    x0, y0, n);
    }
#pragma unroll
    for (int b = 0; b < kN / kChunk; ++b) {
      if constexpr (kNchw)
        tma_load_3d(ring.b_tile(s, pl) + b * kBox, &maps.b[pl], ring.full(s), x0,
                    c0 + b * kChunk, n);
      else
        tma_load_4d(ring.b_tile(s, pl) + b * kBox, &maps.b[pl], ring.full(s), c0 + b * kChunk,
                    x0 + dx, y0 + dy, n);
    }
  }
}

// K2, first pass: an implicit GEMM per tap, gw_tap (o x c) = sum over
// positions of g_cl's box (positions x o) transposed times x_cl's shifted
// box (positions x c). CTA (c tile, o tile, tap * splits + split), kW
// warpgroups of 64 o each (A box wg) sharing the stage's x tile, sums the
// steps of its split in one fixed order through a ring of TMA stages, four
// k16 steps of kP == 1 ? 1 : 3 SS wgmma m64nkNk16 a step with both
// operands MN-major (kNchw: the NCHW boxes, o x positions and c x
// positions, both K-major), one group left in flight while the previous
// step's stage is refilled, and writes its f32 partial to
// ws[split][tap][o][c].
template <int kN, int kW, bool kNchw, int kP>
__global__ void __launch_bounds__(kThreads * kW)
    conv_wgrad_sm90(const __grid_constant__ ConvMaps<kP> maps, float* __restrict__ ws, Geo q,
                    WgradSteps p) {
  using Ring = ConvRing<kN, kW, kP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring{aligned_smem_base(smem_raw)};
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
    for (int s = 0; s < Ring::kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kThreads * kW);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < Ring::kStages && kt < n_k; ++kt)
      wgrad_load<kN, kW, kNchw, kP>(ring, maps, p, kt, first + kt, o0, c0, i - q.ph, j - q.pw);
  __syncwarp();

  // the wgmma accumulate into sum: acc (bf16) or part (split f32)
  float acc[kN / 2], part[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = part[e] = 0.f;
  float (&sum)[kN / 2] = kP == 2 ? part : acc;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % Ring::kStages;
    mbar_wait(ring.full(s), (kt / Ring::kStages) & 1);
    fence_regs(sum);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        if constexpr (kNchw)
          wgmma_ss_acc(sum, desc_kmajor<64>(ring.a_tile(s, pa) + wg * kBox, kk),
                       desc_kmajor<64>(ring.b_tile(s, pb), kk));
        else
          wgmma_ss_mn(sum, desc_mnmajor<64>(ring.a_tile(s, pa) + wg * kBox, kk),
                      desc_mnmajor<kN>(ring.b_tile(s, pb), kk));
      });
    wgmma_commit();
    retire_step<kP>(acc, part, kt, n_k);  // step kt - 1 is done: release its stage
    fence_regs(sum);
    if (kt > 0) {
      const int done = kt - 1, sd = done % Ring::kStages;
      mbar_arrive(ring.empty(sd));
      if (tid == 0 && done + Ring::kStages < n_k) {
        mbar_wait(ring.empty(sd), (done / Ring::kStages) & 1);
        wgrad_load<kN, kW, kNchw, kP>(ring, maps, p, done + Ring::kStages,
                                      first + done + Ring::kStages, o0, c0, i - q.ph, j - q.pw);
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

template <int kN, int kW, bool kNchw, int kP>
cudaError_t launch_wgrad_tiles(const ConvMaps<kP>& maps, void* ws, const Geo& q,
                               const WgradSteps& p, cudaStream_t stream) {
  const long long z = static_cast<long long>(q.kh) * q.kw * p.splits;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  auto kern = conv_wgrad_sm90<kN, kW, kNchw, kP>;
  const size_t smem = ConvRing<kN, kW, kP>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((q.c + kN - 1) / kN, (q.o + kRows * kW - 1) / (kRows * kW),
                  static_cast<unsigned>(z));
  kern<<<grid, kThreads * kW, smem, stream>>>(maps, static_cast<float*>(ws), q, p);
  return cudaGetLastError();
}

// CTAs of two warpgroups (128 o) where O > 64, else of one
template <int kN, bool kNchw, int kP>
cudaError_t launch_wgrad_warpgroups(const ConvMaps<kP>& maps, void* ws, const Geo& q,
                                    const WgradSteps& p, cudaStream_t stream) {
  return q.o > kRows ? launch_wgrad_tiles<kN, 2, kNchw, kP>(maps, ws, q, p, stream)
                     : launch_wgrad_tiles<kN, 1, kNchw, kP>(maps, ws, q, p, stream);
}

// in_place (bf16 only): a 1 x 1 kernel with no padding whose NCHW rows of
// H * W * 2 bytes are multiples of 16, and whose g and x start on a
// 16-byte boundary, reads g and x in place (nchw). Otherwise x (N, C, H,
// W) and g (N, O, OH, OW), contiguous bf16 (kP = 1) or f32 (kP = 2), are
// first transposed into the channels-last copies TMA reads (byte strides
// C * 2 and O * 2, multiples of 16), kP bf16 planes each: x_cl (N, H, W,
// C) and, unless the caller made it already (g_ready), g_cl (N, OH, OW,
// O). Then the first pass into ws and the ordered reduce into gw.
template <int kN, int kP>
cudaError_t launch_wgrad_sm90(const void* x, const void* g, void* x_cl, void* g_cl, void* ws,
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
    if constexpr (kP == 1) {
      if (!flat || hw % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(g) % 16 != 0)
        return cudaErrorInvalidValue;
      p.images = q.n; p.tiles_y = 1; p.box_y = 1; p.box_x = kRows;
      p.tiles_x = static_cast<int>((hw + kRows - 1) / kRows);
      const cuuint64_t gdims[3] = {hw, o, n}, xdims[3] = {hw, c, n};
      const cuuint64_t gstrides[2] = {2 * hw, 2 * hw * o}, xstrides[2] = {2 * hw, 2 * hw * c};
      const cuuint32_t box[3] = {kRows, kChunk, 1};
      ConvMaps<1> maps;
      err = encode_bf16(&maps.a[0], g, 3, gdims, gstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
      err = encode_bf16(&maps.b[0], x, 3, xdims, xstrides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
      err = launch_wgrad_warpgroups<kN, true, 1>(maps, ws, q, p, stream);
      if (err != cudaSuccess) return err;
      return launch_wgrad_reduce(ws, gw, q, splits, stream);
    } else {
      return cudaErrorInvalidValue;  // f32 is split before any product
    }
  }
  err = g_ready ? cudaSuccess : layout<kP>(g, g_cl, q.n, q.o, q.oh * q.ow, stream);
  if (err != cudaSuccess) return err;
  err = layout<kP>(x, x_cl, q.n, q.c, q.h * q.w, stream);
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
  const long long g_elems = static_cast<long long>(m * o);
  const long long x_elems = static_cast<long long>(n) * q.h * q.w * q.c;
  ConvMaps<kP> maps;
  for (int pl = 0; pl < kP; ++pl) {
    err = encode_bf16(&maps.a[pl], plane(g_cl, pl, g_elems), 4, gdims, gstrides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = encode_bf16(&maps.b[pl], plane(x_cl, pl, x_elems), 4, xdims, xstrides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  err = launch_wgrad_warpgroups<kN, false, kP>(maps, ws, q, p, stream);
  if (err != cudaSuccess) return err;
  return launch_wgrad_reduce(ws, gw, q, splits, stream);
}

}  // namespace
}  // namespace sm90

// gw (O, C, kh, kw) f32 from x (N, C, H, W) and g (N, O, OH, OW), both f32 or
// both bf16, contiguous; ws holds splits * kh * kw * O * C floats; x_cl and
// g_cl room for N*C*H*W and N*O*OH*OW bf16 values a plane (one plane for
// bf16, hi and lo for f32: the channels-last copies TMA reads); with
// g_ready, g_cl already holds g's (mxtt_conv_channels_last); with in_place
// (bf16 only), g and x are read in place (kernels.wgrad_mode_sm90's
// "nchw") and x_cl and g_cl are unused.
extern "C" int mxtt_conv_bwd_filter(const void* x, const void* g, void* x_cl, void* g_cl,
                                    void* ws, void* gw, int n, int c, int h, int w, int o, int kh,
                                    int kw, int ph, int pw, int oh, int ow, int splits,
                                    int per_split, int is_bf16, int g_ready, int in_place,
                                    void* stream) {
  if (n <= 0 || c <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c <= 64)
    err = is_bf16 ? sm90::launch_wgrad_sm90<64, 1>(x, g, x_cl, g_cl, ws, gw, q, splits, per_split,
                                                   g_ready, in_place, s)
                  : sm90::launch_wgrad_sm90<64, 2>(x, g, x_cl, g_cl, ws, gw, q, splits, per_split,
                                                   g_ready, in_place, s);
  else
    err = is_bf16 ? sm90::launch_wgrad_sm90<128, 1>(x, g, x_cl, g_cl, ws, gw, q, splits,
                                                    per_split, g_ready, in_place, s)
                  : sm90::launch_wgrad_sm90<128, 2>(x, g, x_cl, g_cl, ws, gw, q, splits,
                                                    per_split, g_ready, in_place, s);
  return static_cast<int>(err);
}

// dx (N, C, H, W) f32 from g (N, O, OH, OW) and w (O, C, kh, kw), both f32 or
// both bf16, contiguous; g_cl and w_t room for N*O*OH*OW and O*C*kh*kw
// bf16 values a plane (one plane for bf16, hi and lo for f32: the
// transposed copies TMA reads; O % 8 == 0); with g_ready, g_cl already
// holds g's.
extern "C" int mxtt_conv_bwd_input(const void* g, const void* wt, void* g_cl, void* w_t, void* dx,
                                   int n, int c, int h, int w, int o, int kh, int kw, int ph,
                                   int pw, int oh, int ow, int is_bf16, int g_ready,
                                   void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const Geo q = make_geo(n, c, h, w, o, kh, kw, ph, pw, oh, ow);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c <= 64)
    err = is_bf16 ? sm90::launch_dgrad_sm90<64, 1>(g, wt, g_cl, w_t, dx, q, g_ready, s)
                  : sm90::launch_dgrad_sm90<64, 2>(g, wt, g_cl, w_t, dx, q, g_ready, s);
  else
    err = is_bf16 ? sm90::launch_dgrad_sm90<128, 1>(g, wt, g_cl, w_t, dx, q, g_ready, s)
                  : sm90::launch_dgrad_sm90<128, 2>(g, wt, g_cl, w_t, dx, q, g_ready, s);
  return static_cast<int>(err);
}

// out (batch, cols, rows) from in (batch, rows, cols): the channels-last
// copy of a conv gradient, (N, O, OH * OW) -> (N, OH * OW, O), made once
// and handed to both K2 and K3 (g_ready); bf16 in: one bf16 plane; f32
// in: its hi plane, then its lo plane
extern "C" int mxtt_conv_channels_last(const void* in, void* out, int batch, int rows, int cols,
                                       int is_bf16, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? sm90::layout<1>(in, out, batch, rows, cols, s)
                                  : sm90::layout<2>(in, out, batch, rows, cols, s));
}
