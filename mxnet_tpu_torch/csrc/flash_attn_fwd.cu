// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (launched by `_fwd_call`, reached from `flash_attention` / `attention`):
// blockwise online-softmax attention that never materialises the [T, T]
// score matrix and saves the f32 logsumexp for a backward pass.
//
// What it computes, as the Pallas kernel does: s = scale * q.k^T in f32 from
// bf16 or f32 loads; the keep-mask (k < T, and q >= k when causal); masked
// scores set to -1e30; a running max m, sum l and f32 accumulator; at the
// end o = acc / safe_l cast to q's dtype and lse = m + log(safe_l), where
// safe_l = l if l > 0 else 1, so a row whose sum is 0 writes 0.
//
// What bounds it on the H100. Causal attention at the serving shapes does
// about 4*D flops per (q, k) pair against 8*D bytes per row of q, k, v, o,
// so at T >= 128 it needs far more operations per byte than the card's
// balance point: the bound is the tensor cores' bf16 rate (989 TFLOP/s).
// One design, TMA and wgmma (flash_sm90.cuh), on kP bf16 planes of each
// operand: bf16 operands as they are (kP = 1, flash_fwd_sm90), f32 ones as
// the hi and lo planes of flash_split_kernel below (kP = 2,
// flash_fwd_split_sm90; both kernels run fwd_cta<D, kP>).
//   * One CTA of one warpgroup (128 threads) per (batch*head, 64-row q
//     tile); the heaviest causal q tiles are scheduled first so the causal
//     triangle balances across SMs. The TPU's sequential k grid axis with
//     VMEM scratch becomes the loop over k tiles inside the CTA, up to the
//     causal diagonal.
//   * The Q tile arrives by TMA once; K and V tiles (64 x D bf16, each
//     plane) come by TMA through a ring of kStages shared-memory stages
//     guarded by mbarriers, so the next tiles are in flight while one is
//     multiplied. Rows past T arrive as zeros; the mask, not the fill,
//     decides what counts. Operands are read as [B, T, H, D] through their
//     strides.
//   * S = Q K^T by wgmma with both operands in shared memory (K-major), f32
//     in registers; scale, mask and the online softmax run on the
//     accumulator fragment (one ex2 instruction a score, log2(e) folded
//     into the scale; l sums the f32 p, as JAX does); P is rounded to bf16
//     in registers and O += P V runs by wgmma with P as the register A
//     operand and the V tile read MN-major (transpose bit), so nothing is
//     staged twice.
//   * What bounds this design on the card is latency: each CTA runs its
//     two products and the softmax in turn, so the SM's tensor cores are
//     kept busy only by several resident CTAs. The mask is evaluated only
//     on the tiles that straddle the causal diagonal or T, each score
//     takes one ex2 instruction, and registers are capped so that five
//     bf16 CTAs fit an SM at D <= 64 (96 registers, 42 KB at D = 64, no
//     spills); measured, each of the three counts. Two warpgroups sharing
//     each K/V tile over a 128-row q tile ran the forward 1-4% faster but
//     dq 19% slower, with fewer CTAs an SM, so one warpgroup was kept
//     (PERF.md).
//   * Numerics, bf16: P is rounded to bf16 before the second product, as
//     FlashAttention-2/3 do; the JAX kernel multiplies it in f32. The
//     difference stays inside the bf16 limit (2e-2 absolute against
//     reference_attention). One owner per output, no atomics: a repeated
//     launch gives the same bits.
//   * f32 (kP = 2). The f32 limit (1e-4) rules out one bf16 or TF32
//     product, and f32 FMAs on the CUDA cores reach 67 TFLOP/s at most
//     (the CUDA-core kernel this design replaced ran 2.2x f32 SDPA). So, as
//     the f32 conv kernels do, each f32 value v is two bf16 planes, hi =
//     bf16(v) and lo = bf16(v - hi), and each f32 product is three bf16
//     ones, hi*lo + lo*hi + hi*hi (plane_products): the bound becomes three
//     times the bf16 operations. S takes the three products of each of its
//     D/16 k16 steps (24 at most) into one accumulator. P is split in
//     registers into hi and lo A operands (to_a_operand<2>); the products
//     of a K/V tile (3 x 4 k16 steps) go into a partial that starts at zero
//     and is then added into O on the CUDA cores (add_split_product), after
//     the online rescale of O: the tensor cores' f32 sums round with a
//     bias, so a whole sequence summed in one accumulator would lose bits
//     with its length (conv_bwd.cu's kPromoteSteps; here the period is one
//     K/V tile). O and lse are f32. A stage holds the hi and lo tiles of K
//     and V, twice a bf16 stage: 80 KB of ring at D = 64 (two CTAs an SM),
//     160 KB at D = 128 (one). Registers: S 32, O D/2, the partial D/2 (64
//     columns at a time at D = 128), P's planes 32, so the f32 kernel has
//     its own bounds, two CTAs an SM below D = 128 and one at 128.
//     Q's planes come from the same pass as K's and V's, not from an f32
//     tile split in the CTA: the pass costs 4 bytes read and 4 written a
//     value of q (a third of the pass, which is small beside the kernel),
//     and keeps one TMA path and one set of bits for every operand.
//   * The split pass (flash_split_kernel): a grid-stride loop over runs of
//     8 values along D of up to four strided f32 [B, T, H, D] operands,
//     writing each run's hi and lo planes with one 16-byte store each into
//     a contiguous bf16 (ops, 2, B, T, H, D) workspace; 16-byte loads where
//     the operands' base and strides allow. It reads 4 bytes and writes 4
//     a value, bound by the card's memory rate, and rounds as
//     kernels.split_bf16 does, bit for bit.
//
// Entry points: mxtt_flash_attn_fwd and mxtt_flash_split (plain C, loaded
// with ctypes). Each returns the cudaError_t of its launch (0 on success)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_sm90.cuh"

namespace sm90 {
namespace {

constexpr int kStages = 2;  // K/V ring depth

template <int D, int kP>
using FwdRing = Ring<D, 1, kStages, kP>;  // lead tile: Q

// Scale, keep-mask (k < T, and q >= k when causal; only when kMask) and
// online softmax of one 64 x 64 score tile on the accumulator fragment, in
// log2 units: updates the running max m and sum l of this thread's two
// rows (l sums the f32 p), rescales acc, and leaves p in sc.
template <bool kMask, int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 2], int row0, int col0, int k0,
                                             int seq, int causal, float scale_log2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + col0 + e;
        const bool keep = !kMask || (col < seq && (!causal || row >= col));
        float& x = sc[4 * j + 2 * half + e];
        x = keep ? x * scale_log2 : kNegInf;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[half], quad_max(mx));
    const float alpha = ex2(m[half] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + col0 + e;
        const bool keep = !kMask || (col < seq && (!causal || row >= col));
        float& x = sc[4 * j + 2 * half + e];
        x = keep ? ex2(x - m_new) : 0.f;
        rs += x;
      }
    l[half] = l[half] * alpha + quad_sum(rs);
    m[half] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 2 * half] *= alpha;
      acc[4 * j + 2 * half + 1] *= alpha;
    }
  }
}

// One CTA of the forward on kP planes of each operand; maps holds q's,
// k's and v's maps, kP each.
template <int D, int kP>
__device__ __forceinline__ void fwd_cta(const Maps<3 * kP>& maps,
                                        typename PlaneOut<kP>::T* __restrict__ o,
                                        float* __restrict__ lse, int heads, int seq,
                                        float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const FwdRing<D, kP> ring{aligned_smem_base(smem_raw)};
  const CUtensorMap* qmap = &maps.m[0];
  const CUtensorMap* kmap = &maps.m[kP];
  const CUtensorMap* vmap = &maps.m[2 * kP];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (kv_end + kRows - 1) / kRows;

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0) {
    const CUtensorMap* lead[1] = {qmap};
    ring.load_lead(lead, q0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s) ring.load_kv(s, kmap, vmap, s * kRows, h, b);
  }
  __syncwarp();

  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);             // and columns 8j + col0 + {0, 1}
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(ring.lead_bar(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(ring.full(s), (i / kStages) & 1);

    // S = Q K^T, both K-major in shared memory, plane by plane
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0, pa), kk),
                           desc_kmajor<D>(ring.k_tile(s, pb), kk), 1);
      });
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, keep-mask and online softmax on the fragment; only the tiles
    // that straddle the causal diagonal or T evaluate the mask
    const int k0 = i * kRows;
    if (k0 + kRows > seq || (causal && k0 + kRows - 1 > q0))
      softmax_tile<true, D>(sc, m, l, acc, row0, col0, k0, seq, causal, scale_log2);
    else
      softmax_tile<false, D>(sc, m, l, acc, row0, col0, k0, seq, causal, scale_log2);

    // O += P V: P as the register A operand (bf16: rounded; f32: its hi and
    // lo planes), V MN-major
    uint32_t pa[kP][4][4];
    to_a_operand<kP>(sc, pa);
    if constexpr (kP == 1) {
      fence_regs(pa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, pa[0][kk], desc_mnmajor<D>(ring.v_tile(s), kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
    } else {
      add_split_product<D>(acc, pa, ring.v_tile(s, 0), ring.v_tile(s, 1));
    }

    ring.release(i, n_tiles, kmap, vmap, h, b);
  }

  // o = acc / safe_l in o's type, lse = m + log(safe_l); rows past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const float safe_l = l[half] > 0.f ? l[half] : 1.f;
    auto* orow = o + ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j + col0, acc[4 * j + 2 * half] / safe_l,
             acc[4 * j + 2 * half + 1] / safe_l);
    if (lane % 4 == 0)
      lse[static_cast<long long>(bh) * seq + row] = m[half] * kLn2 + logf(safe_l);
  }
}

// bf16: at least five CTAs an SM at D <= 64 (registers capped at 102 a
// thread; 42 KB of shared memory a CTA at D = 64), three at D = 128.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 3 : 5)
    flash_fwd_sm90(const __grid_constant__ Maps<3> maps, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int heads, int seq, float scale_log2, int causal) {
  fwd_cta<D, 1>(maps, o, lse, heads, seq, scale_log2, causal);
}

// split f32: two CTAs an SM below D = 128 (81 KB of shared memory at
// D = 64), one at 128 (161 KB); registers up to 255 a thread.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
    flash_fwd_split_sm90(const __grid_constant__ Maps<6> maps, float* __restrict__ o,
                         float* __restrict__ lse, int heads, int seq, float scale_log2,
                         int causal) {
  fwd_cta<D, 2>(maps, o, lse, heads, seq, scale_log2, causal);
}

template <int D, int kP, typename Kern>
cudaError_t launch_planes(Kern kern, const void* const (&ptrs)[3], void* o, void* lse,
                          int batch, int seq, int heads, const long long* st, float scale,
                          int causal, cudaStream_t stream) {
  // an operand's lo plane follows its hi plane, one [B, T, H, D] apart
  const long long plane = static_cast<long long>(batch) * seq * heads * D;
  Maps<3 * kP> maps;
  for (int i = 0; i < 3; ++i)
    for (int p = 0; p < kP; ++p) {
      const cudaError_t err =
          encode_operand(&maps.m[i * kP + p], static_cast<const __nv_bfloat16*>(ptrs[i]) + p * plane,
                         batch, seq, heads, D, st[3 * i], st[3 * i + 1], st[3 * i + 2]);
      if (err != cudaSuccess) return err;
    }
  const size_t smem = FwdRing<D, kP>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(maps, static_cast<typename PlaneOut<kP>::T*>(o),
                                         static_cast<float*>(lse), heads, seq, scale * kLog2e,
                                         causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int planes, const void* q, const void* k, const void* v, void* o, void* lse,
                   int batch, int seq, int heads, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const void* const ptrs[3] = {q, k, v};
  if (planes == 1)
    return launch_planes<D, 1>(flash_fwd_sm90<D>, ptrs, o, lse, batch, seq, heads, st, scale,
                               causal, stream);
  if (planes == 2)
    return launch_planes<D, 2>(flash_fwd_split_sm90<D>, ptrs, o, lse, batch, seq, heads, st,
                               scale, causal, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- split pass

constexpr int kSplitThreads = 256;

// up to four strided f32 [B, T, H, D] operands: base and element strides
struct SplitSrc {
  const float* ptr[4];
  long long sb[4], st[4], sh[4];
};

// out (uint4 units, 8 bf16): plane p of operand op at [(2 op + p) groups +
// r] for the r-th run of 8 values, [B, T, H, D] order; kVec: 16-byte loads
template <bool kVec>
__global__ void __launch_bounds__(kSplitThreads)
    flash_split_kernel(SplitSrc src, uint4* __restrict__ out, int n_ops, int seq, int heads,
                       int d, long long groups) {
  const long long total = groups * n_ops;
  for (long long g = blockIdx.x * static_cast<long long>(kSplitThreads) + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * kSplitThreads) {
    const int op = static_cast<int>(g / groups);
    const long long r = g - op * groups;
    const long long e = r * 8;
    const int c = static_cast<int>(e % d);
    long long row = e / d;
    const int h = static_cast<int>(row % heads);
    row /= heads;
    const int t = static_cast<int>(row % seq);
    const long long b = row / seq;
    const float* x = nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i)  // constant indices: the parameter is not copied to the stack
      if (i == op) x = src.ptr[i] + b * src.sb[i] + t * src.st[i] + h * src.sh[i] + c;
    float v[8];
    if constexpr (kVec) {
      const float4 u = reinterpret_cast<const float4*>(x)[0];
      const float4 w = reinterpret_cast<const float4*>(x)[1];
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = x[i];
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair(v[2 * i], v[2 * i + 1], hi[i], lo[i]);
    out[2 * op * groups + r] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    out[(2 * op + 1) * groups + r] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

cudaError_t split_planes(int n_ops, const void* const (&ptrs)[4], const long long* st, void* out,
                         int batch, int seq, int heads, int d, cudaStream_t stream) {
  SplitSrc src = {};
  bool vec = true;
  for (int i = 0; i < n_ops; ++i) {
    src.ptr[i] = static_cast<const float*>(ptrs[i]);
    src.sb[i] = st[3 * i];
    src.st[i] = st[3 * i + 1];
    src.sh[i] = st[3 * i + 2];
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 && src.sb[i] % 4 == 0 &&
          src.st[i] % 4 == 0 && src.sh[i] % 4 == 0;
  }
  const long long groups = static_cast<long long>(batch) * seq * heads * d / 8;
  const long long blocks = (groups * n_ops + kSplitThreads - 1) / kSplitThreads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  uint4* dst = static_cast<uint4*>(out);
  if (vec)
    flash_split_kernel<true><<<grid, kSplitThreads, 0, stream>>>(src, dst, n_ops, seq, heads, d,
                                                                  groups);
  else
    flash_split_kernel<false><<<grid, kSplitThreads, 0, stream>>>(src, dst, n_ops, seq, heads, d,
                                                                   groups);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90

// q, k, v: [batch, seq, heads, d] with unit stride along d and the given
// element strides for (batch, seq, heads), read by TMA (16 B aligned bases,
// strides that are multiples of 8 elements); o: contiguous [batch, seq,
// heads, d]; lse: contiguous f32 [batch, heads, seq]. planes 1: bf16
// operands and o (flash_fwd_sm90); planes 2: each of q, k, v points at the
// hi plane of a split f32 operand whose lo plane follows it, batch * seq *
// heads * d values on, and o is f32 (flash_fwd_split_sm90). d is 16, 32,
// 64 or 128.
extern "C" int mxtt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int seq, int heads, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, int planes, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = sm90::launch<16>(planes, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 32: err = sm90::launch<32>(planes, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 64: err = sm90::launch<64>(planes, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 128: err = sm90::launch<128>(planes, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The hi and lo bf16 planes of n_ops (1 to 4) f32 [batch, seq, heads, d]
// operands x0.. (unit stride along d, the given element strides for
// (batch, seq, heads)) into out, contiguous bf16 (n_ops, 2, batch, seq,
// heads, d), 16 B aligned; d a multiple of 8.
extern "C" int mxtt_flash_split(
    int n_ops, const void* x0, const void* x1, const void* x2, const void* x3,
    long long sb0, long long st0, long long sh0, long long sb1, long long st1, long long sh1,
    long long sb2, long long st2, long long sh2, long long sb3, long long st3, long long sh3,
    void* out, int batch, int seq, int heads, int d, void* stream) {
  if (n_ops < 1 || n_ops > 4 || d % 8 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const void* const ptrs[4] = {x0, x1, x2, x3};
  const long long st[12] = {sb0, st0, sh0, sb1, st1, sh1, sb2, st2, sh2, sb3, st3, sh3};
  return static_cast<int>(sm90::split_planes(n_ops, ptrs, st, out, batch, seq, heads, d,
                                             static_cast<cudaStream_t>(stream)));
}
