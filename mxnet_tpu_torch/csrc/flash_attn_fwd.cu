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
// Two kernels, chosen by dtype:
//
// bf16: flash_fwd_sm90, TMA and wgmma (flash_sm90.cuh).
//   * One CTA of one warpgroup (128 threads) per (batch*head, 64-row q
//     tile); the heaviest causal q tiles are scheduled first so the causal
//     triangle balances across SMs. The TPU's sequential k grid axis with
//     VMEM scratch becomes the loop over k tiles inside the CTA, up to the
//     causal diagonal.
//   * The Q tile arrives by TMA once; K and V tiles (64 x D bf16) come by
//     TMA through a ring of kStages shared-memory stages guarded by
//     mbarriers, so the next tiles are in flight while one is multiplied.
//     Rows past T arrive as zeros; the mask, not the fill, decides what
//     counts. q, k, v are read as [B, T, H, D] through their strides.
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
//     CTAs fit an SM at D <= 64 (96 registers, 42 KB at D = 64, no
//     spills); measured, each of the three counts. Two warpgroups sharing
//     each K/V tile over a 128-row q tile ran the forward 1-4% faster but
//     dq 19% slower, with fewer CTAs an SM, so one warpgroup was kept
//     (PERF.md).
//   * Numerics: P is rounded to bf16 before the second product, as
//     FlashAttention-2/3 do; the JAX kernel multiplies it in f32. The
//     difference stays inside the bf16 limit (2e-2 absolute against
//     reference_attention). One owner per output, no atomics: a repeated
//     launch gives the same bits.
//
// f32: flash_fwd_kernel, f32 FMAs on the CUDA cores from shared-memory
// tiles. The f32 limit (1e-4) rules out TF32 tensor cores. Each block owns
// one (batch*head, 64-row q tile); Q, K and V tiles are staged through
// shared memory as f32 and reused by all 128 threads; each thread owns a
// 4 x 8 micro-tile of the scores and a 4 x D/8 micro-tile of the
// accumulator; row max and sum go through warp shuffles among the 8 lanes
// that share a row group; the ragged edge is masked in the kernel.
//
// Entry point: mxtt_flash_attn_fwd (plain C, loaded with ctypes). It returns
// the cudaError_t of the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kBlockQ = 64;    // q rows per block
constexpr int kBlockK = 64;    // k rows per shared-memory tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kLanes = 8;      // lanes sharing one row group
constexpr int kRows = kBlockQ / (kThreads / kLanes);  // q rows per thread: 4
constexpr int kCols = kBlockK / kLanes;               // score cols per thread: 8
constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF

// max / sum over the 8 lanes of a row group; the xor butterfly leaves the
// same bits in every lane, so all 8 keep identical running statistics
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int seq,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     float scale, int causal) {
  constexpr int DP = D + 1;        // padded rows: no bank conflicts
  constexpr int PP = kBlockK + 1;
  constexpr int kAcc = D / kLanes;  // accumulator cols per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlockQ][DP]
  float* ks = qs + kBlockQ * DP;    // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;    // [kBlockK][D]
  float* ps = vs + kBlockK * D;     // [kBlockQ][PP]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;   // column lane inside the row group
  const int group = tid / kLanes;  // row group: rows group*kRows + i
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    qs[r * DP + c] = t < seq ? qb[t * q_st + c] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool in = t < seq;  // zero rows past T: 0 * p never makes NaN
      ks[r * DP + c] = in ? kb[t * k_st + c] : 0.f;
      vs[r * D + c] = in ? vb[t * v_st + c] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(group * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = ks[(lane + kLanes * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = group * kRows + i;
      const int qpos = q0 + row;
      bool keep[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + lane + kLanes * j;
        keep[j] = kpos < seq && (!causal || qpos >= kpos);
        s[i][j] = keep[j] ? scale * s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[row * PP + lane + kLanes * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[kRows], vv[kAcc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(group * kRows + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) vv[j] = vs[kk * D + lane + kLanes * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + group * kRows + i;
    if (t >= seq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* orow = o + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      orow[lane + kLanes * j] = acc[i][j] / safe_l;
    if (lane == 0)
      lse[static_cast<long long>(bh) * seq + t] = m[i] + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int batch, int seq, int heads, const long long* st, float scale,
                       int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      heads, seq, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ bf16
// In namespace sm90, so the header's names (kRows = 64 rows a tile) are
// found before the SIMT kernel's.
namespace sm90 {
namespace {

constexpr int kStages = 2;  // K/V ring depth

template <int D>
using FwdRing = Ring<D, 1, kStages>;  // lead tile: Q

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

// At least five CTAs an SM at D <= 64 (registers capped at 102 a thread;
// 42 KB of shared memory a CTA at D = 64), three at D = 128.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 3 : 5)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int heads, int seq, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const FwdRing<D> ring{aligned_smem_base(smem_raw)};

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
    const CUtensorMap* lead[1] = {&qmap};
    ring.load_lead(lead, q0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      ring.load_kv(s, &kmap, &vmap, s * kRows, h, b);
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

    // S = Q K^T, both K-major in shared memory
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0), kk),
                         desc_kmajor<D>(ring.k_tile(s), kk), kk > 0);
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

    // O += P V: P rounded to bf16 as the register A operand, V MN-major
    uint32_t pa[4][4];
    to_a_operand(sc, pa);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(ring.v_tile(s), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);

    ring.release(i, n_tiles, &kmap, &vmap, h, b);
  }

  // o = acc / safe_l in bf16, lse = m + log(safe_l); rows past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const float safe_l = l[half] > 0.f ? l[half] : 1.f;
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[4 * j + 2 * half] / safe_l,
                                                      acc[4 * j + 2 * half + 1] / safe_l);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) = v2;
    }
    if (lane % 4 == 0)
      lse[static_cast<long long>(bh) * seq + row] = m[half] * kLn2 + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch, int seq, int heads, const long long* st, float scale,
                        int causal, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = encode_operand(&maps[i], ptrs[i], batch, seq, heads, D,
                                           st[3 * i], st[3 * i + 1], st[3 * i + 2]);
    if (err != cudaSuccess) return err;
  }
  auto kern = flash_fwd_sm90<D>;
  const size_t smem = FwdRing<D>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      heads, seq, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90

namespace {

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  return is_bf16 ? sm90::launch_bf16<D>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream)
                 : launch_f32<D>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream);
}

}  // namespace

// q, k, v: [batch, seq, heads, d] with unit stride along d and the given
// element strides for (batch, seq, heads); o: contiguous [batch, seq, heads,
// d] of the same dtype; lse: contiguous f32 [batch, heads, seq].
// is_bf16 selects __nv_bfloat16 (1: the TMA/wgmma kernel, which also wants
// 16 B aligned bases and strides that are multiples of 8 elements) or float
// (0: the SIMT kernel); d is 16, 32, 64 or 128.
extern "C" int mxtt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int seq, int heads, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(is_bf16, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 32: err = launch<32>(is_bf16, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 64: err = launch<64>(is_bf16, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    case 128: err = launch<128>(is_bf16, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
