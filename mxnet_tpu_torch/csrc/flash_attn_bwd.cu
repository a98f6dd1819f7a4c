// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py launched by
// `_bwd_call` (the jax.custom_vjp backward of `_flash`):
//   * dq  <- `_bwd_dq_kernel`:  dq = scale * sum_k dS K
//            (flash_dq_sm90<D, kP>)
//   * dkv <- `_bwd_dkv_kernel`: dv = sum_q P^T dO, dk = scale * sum_q dS^T Q
//            (flash_dkv_sm90<D, kP>)
// both TMA and wgmma (bf16 kP = 1; f32 kP = 2, on the split planes of
// flash_attn_fwd.cu's split pass, which the wrapper runs once for both),
// with, as the Pallas kernels compute it, from bf16 or f32 loads: s =
// scale * q.k^T in f32; the keep-mask of `_masked_scores` (k < T, and
// q >= k when causal; here also q < T, since T is not padded); P =
// exp(s - lse) where kept, else 0; dP = dO V^T; dS = P * (dP - delta).
// lse is the forward's f32 logsumexp and delta = sum_D dO * O, both
// [B, H, T] f32, computed by the caller. Outputs are cast to q's dtype
// after the scale, as `:198` and `:245-246` do.
//
// What bounds them on the H100. Per live (q, k) pair dq does 6*D flops
// (s, dP, dS K) and dk/dv 8*D (s, dP, P^T dO, dS^T Q) against ~10-12*D
// bytes per row, so at T >= 128 both need far more operations per byte
// than the card's balance point: the bound is the tensor cores' bf16 rate.
// What the designs do:
//   * One owner per output, no atomics. The TPU design splits the backward
//     into a dq pass and a dk/dv pass so each output tile has one writer;
//     the split is kept, so a repeated launch gives the same bits.
//   * dq, bf16 (flash_dq_sm90, flash_sm90.cuh): one CTA of one warpgroup
//     per (batch*head, 64-row q tile), the heaviest causal q tiles first.
//     Q and dO arrive by TMA once; lse and delta sit in registers in the
//     accumulator fragment's row layout; K and V tiles come by TMA through
//     a ring of shared-memory stages guarded by mbarriers, up to the causal
//     diagonal. Per k tile: S = Q K^T and dP = dO V^T by two wgmmas with
//     all operands K-major in shared memory; P (one ex2 instruction a
//     score, the mask evaluated only on tiles that straddle the causal
//     diagonal or T) and dS = P (dP - delta) in f32 registers; dS rounded
//     to bf16 in registers is the A operand of dq += dS K, whose B is the
//     same K tile read MN-major (transpose bit), so no transposed copy is
//     made. Four CTAs fit an SM at D = 64 (128 registers, 49 KB), and
//     they hide each other's latency: each runs its products and the
//     elementwise work in turn. Numerics: dS is rounded to bf16 before the
//     product, as FlashAttention-2/3 do (the JAX kernel multiplies it in
//     f32); the result stays inside the bf16 limit, 2e-2 of max|plain|
//     against reference_attention_bwd.
//   * dk/dv, bf16 (flash_dkv_sm90): the same design with the roles of
//     queries and keys turned round. One warpgroup CTA per (batch*head,
//     64-row k tile), low k tiles (the most q tiles under the causal mask)
//     first; K and V arrive by TMA once; Q and dO tiles stream through the
//     same ring from the q tile that holds key k0 (causal) or 0 to the
//     end. Per q tile: S^T = K Q^T and dP^T = V dO^T by SS wgmma (all
//     K-major); P^T and dS^T = P^T (dP^T - delta) on the fragment, where
//     lse and delta belong to the columns: the 128 threads bring the next
//     q tile's 64 + 64 values into one of two shared buffers while this
//     tile's products run. P^T rounded to bf16 is the A operand of
//     dv += P^T dO, issued before dS^T is computed so the tensor cores and
//     the elementwise work overlap; dS^T rounded to bf16 is the A operand
//     of dk += dS^T Q; dO and Q are read MN-major, so again no copy.
//     Registers bound residency: dk and dv take D/2 floats each, S^T and
//     dP^T 32 each. Numerics: P^T and dS^T are rounded to bf16 before the
//     products (FlashAttention-2/3 do the same), inside the same 2e-2
//     limit.
//   * f32 (flash_dq_sm90<D, 2>, flash_dkv_sm90<D, 2>): the same kernels on
//     two bf16 planes of each operand, hi = bf16(v) and lo = bf16(v - hi),
//     made by the wrapper's split pass (mxtt_flash_split; one pass over q,
//     k, v and dO serves both kernels of a backward); each f32 product is
//     three bf16 ones, hi*lo + lo*hi + hi*hi, so the bound is three times
//     the bf16 operations (the f32 limit, 1e-4 of max|plain|, rules out one
//     bf16 or TF32 product, and the CUDA cores' f32 FMAs reach 67 TFLOP/s
//     at most: the CUDA-core kernels these replaced ran dq in 5.1 ms and
//     dk/dv in 6.4 ms at n=8 T=2047, 2.1x f32 SDPA's dq+dk+dv). The
//     resident tiles (Q and dO for dq, K and V for dk/dv) and the streamed
//     ones are hi and lo tiles (96 KB of shared memory at D = 64, 193 KB at
//     D = 128: two CTAs an SM or one); S (S^T) and dP (dP^T) take three
//     products a k16 step. dS (and P^T, dS^T) are split in registers into
//     hi and lo A operands (to_a_operand<2>). Each output sums 4 k16 steps
//     a streamed tile over all the tiles (128 at T = 2047, 512 at 8192),
//     and the tensor cores' f32 accumulation rounds every wgmma's sum with
//     a bias, so one accumulator's error would grow with T (conv_bwd.cu's
//     kPromoteSteps): each tile's products go into a partial that starts
//     at zero and is added into dq, dk or dv on the CUDA cores
//     (add_split_product), a promotion every 4 k16 steps. Where the sums
//     live: dq (dk and dv) in registers, D/2 each, and one partial (reused
//     for dk/dv's two products), 32 columns of it a thread at most (64
//     columns at a time at D = 128). In dq, dS is made in S's registers and
//     dP's are free once it is, so S 32 + dP 32 + dq D/2 are live during
//     the first products and dS's planes 32 + partial 32 + dq D/2 during
//     the last. In dk/dv, dS^T is made before the products, so S^T's
//     registers are free by then (no overlap of the dv product with it, as
//     in bf16): about S^T 32 + dS^T 32 + the A planes 32 + partial 32 + dk
//     and dv D live at once. Keeping the promoted sums in shared memory
//     instead would not fit beside the D = 128 ring (32 KB each). dq, dk =
//     scale * acc and dv are written in f32.
//   * The ragged edge of T is masked in the kernels and loads past T are
//     zero-filled (no padding of T). The kernels read q, k, v, dO through
//     tensor maps of their [B, T, H, D] strides (the wrapper copies a bf16
//     operand TMA cannot read; f32 operands are split into contiguous
//     planes first).
//
// Entry points: mxtt_flash_attn_bwd_dq and mxtt_flash_attn_bwd_dkv (plain C,
// loaded with ctypes). Each returns the cudaError_t of its launch (0 on
// success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace sm90 {
namespace {

constexpr int kStages = 2;  // ring depth of the streamed tiles

// element strides of one [B, T, H, D] operand (unit stride along D)
struct Strides {
  long long b, t, h;
};

// arguments shared by both entry points
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, seq, heads;
  Strides sq, sk, sv, sdo;
  float scale;
  int causal;
  cudaStream_t stream;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int batch, int seq,
               int heads, const long long* st, float scale, int causal,
               void* stream) {
  return Args{q, k, v, dout, lse, delta, batch, seq, heads,
              Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
              Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
              scale, causal, static_cast<cudaStream_t>(stream)};
}

// The tensor maps of q, k, v and dout, kP each: kP = 1 the bf16 operands;
// kP = 2 each pointer is the hi plane of a split f32 operand whose lo plane
// follows it, one [B, T, H, D] on
template <int D, int kP>
cudaError_t encode_planes(const Args& a, Maps<4 * kP>& maps) {
  const long long plane = static_cast<long long>(a.batch) * a.seq * a.heads * D;
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Strides st[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int i = 0; i < 4; ++i)
    for (int p = 0; p < kP; ++p) {
      const cudaError_t err = encode_operand(
          &maps.m[i * kP + p], static_cast<const __nv_bfloat16*>(ptrs[i]) + p * plane, a.batch,
          a.seq, a.heads, D, st[i].b, st[i].t, st[i].h);
      if (err != cudaSuccess) return err;
    }
  return cudaSuccess;
}

// ---------------------------------------------------------------------- dq

template <int D, int kP>
using DqRing = Ring<D, 2, kStages, kP>;  // lead tiles: Q, dO; the stages stream K and V

// dS = P (dP - delta) of one 64 x 64 tile on the accumulator fragment, into
// sc: P = 2^(scale_log2 s - lse2) where kept (k < T, and q >= k when
// causal; only when kMask), else 0.
template <bool kMask>
__device__ __forceinline__ void ds_tile(float (&sc)[32], const float (&dp)[32],
                                        const float (&lse2)[2], const float (&dlt)[2],
                                        int row0, int col0, int k0, int seq, int causal,
                                        float scale_log2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + col0 + e;
        const bool keep = !kMask || (col < seq && (!causal || row >= col));
        const int x = 4 * j + 2 * half + e;
        const float p = keep ? ex2(sc[x] * scale_log2 - lse2[half]) : 0.f;
        sc[x] = p * (dp[x] - dlt[half]);
      }
  }
}

// One CTA (one warpgroup) per (batch*head, 64-row q tile), the heaviest
// causal q tiles first, on kP planes of each operand (bf16: one; split
// f32: hi and lo). Q and dO are resident; K and V tiles stream through the
// ring up to the causal diagonal. Per K/V tile: S = Q K^T and dP = dO V^T
// by SS wgmma (all K-major, plane by plane); dS = P (dP - delta) in f32
// registers; dq += dS K with dS as the register A operand (bf16: rounded;
// split f32: its hi and lo planes, the tile's twelve products summed in a
// zeroed partial that is then added into dq, add_split_product) and K
// read MN-major. maps holds q's, k's, v's and dO's maps, kP each.
template <int D, int kP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_sm90(const __grid_constant__ Maps<4 * kP> maps, const float* __restrict__ lse,
                  const float* __restrict__ delta, typename PlaneOut<kP>::T* __restrict__ dq,
                  int heads, int seq, float scale, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const DqRing<D, kP> ring{aligned_smem_base(smem_raw)};
  const CUtensorMap* qmap = &maps.m[0];
  const CUtensorMap* kmap = &maps.m[kP];
  const CUtensorMap* vmap = &maps.m[2 * kP];
  const CUtensorMap* domap = &maps.m[3 * kP];

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
    const CUtensorMap* lead[2] = {qmap, domap};
    ring.load_lead(lead, q0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      ring.load_kv(s, kmap, vmap, s * kRows, h, b);
  }
  __syncwarp();

  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);             // and columns 8j + col0 + {0, 1}
  // lse in log2 units and delta of the two rows; rows past T take 0 (their
  // q and dO rows are zeros, so their dS is 0, and they are not stored)
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const long long at = static_cast<long long>(bh) * seq + row;
    lse2[half] = row < seq ? lse[at] * kLog2e : 0.f;
    dlt[half] = row < seq ? delta[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(ring.lead_bar(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(ring.full(s), (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T, all four operands K-major in shared
    // memory, plane by plane
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0, pa), kk),
                           desc_kmajor<D>(ring.k_tile(s, pb), kk), 1);
      });
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_m64n64k16(dp, desc_kmajor<D>(ring.lead(1, pa), kk),
                           desc_kmajor<D>(ring.v_tile(s, pb), kk), 1);
      });
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(scale s - lse) where kept, else 0; dS = P (dP - delta); only
    // the tiles that straddle the causal diagonal or T evaluate the mask
    const int k0 = i * kRows;
    if (k0 + kRows > seq || (causal && k0 + kRows - 1 > q0))
      ds_tile<true>(sc, dp, lse2, dlt, row0, col0, k0, seq, causal, scale_log2);
    else
      ds_tile<false>(sc, dp, lse2, dlt, row0, col0, k0, seq, causal, scale_log2);

    // dq += dS K: dS as the register A operand (bf16: rounded; split f32:
    // its hi and lo planes), K MN-major
    uint32_t da[kP][4][4];
    to_a_operand<kP>(sc, da);
    if constexpr (kP == 1) {
      fence_regs(da);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, da[0][kk], desc_mnmajor<D>(ring.k_tile(s), kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(da);
    } else {
      add_split_product<D>(acc, da, ring.k_tile(s, 0), ring.k_tile(s, 1));
    }

    ring.release(i, n_tiles, kmap, vmap, h, b);
  }

  // dq = scale * acc in dq's type; rows past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    auto* out = dq + ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j + col0, scale * acc[4 * j + 2 * half],
             scale * acc[4 * j + 2 * half + 1]);
  }
}

// kP = 1: bf16 q, k, v, dout and dq; kP = 2: each of q, k, v, dout is the
// hi plane of a split f32 operand whose lo plane follows it, one
// [B, T, H, D] on, and dq is f32
template <int D, int kP>
cudaError_t launch_dq(const Args& a, void* dq) {
  Maps<4 * kP> maps;
  cudaError_t err = encode_planes<D, kP>(a, maps);
  if (err != cudaSuccess) return err;
  auto kern = flash_dq_sm90<D, kP>;
  const size_t smem = DqRing<D, kP>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  using Out = typename PlaneOut<kP>::T;
  const dim3 grid(a.batch * a.heads, (a.seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      maps, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Out*>(dq), a.heads, a.seq, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int planes, const Args& a, void* dq) {
  if (planes == 1) return launch_dq<D, 1>(a, dq);
  if (planes == 2) return launch_dq<D, 2>(a, dq);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- dk/dv

template <int D, int kP>
using DkvRing = Ring<D, 2, kStages, kP>;  // lead tiles: K, V; the stages stream Q and dO

// P^T of one 64 x 64 tile on the accumulator fragment, in place: rows are
// the CTA's keys, columns the q tile; P^T = 2^(scale_log2 s - lse2[col])
// where kept (k < T, q < T, and q >= k when causal; only when kMask), else
// 0. lse2 holds the tile's 64 columns in log2 units.
template <bool kMask>
__device__ __forceinline__ void pt_tile(float (&sc)[32], const float* lse2, int row0, int col0,
                                        int q0, int seq, int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + 8 * j + col0 + e;
        const bool keep = !kMask || (row < seq && col < seq && (!causal || col >= row));
        const int x = 4 * j + 2 * half + e;
        sc[x] = keep ? ex2(sc[x] * scale_log2 - (e ? l.y : l.x)) : 0.f;
      }
    }
  }
}

// dS^T = P^T (dP^T - delta[col]) of one tile, into dp
__device__ __forceinline__ void dst_tile(float (&dp)[32], const float (&pt)[32],
                                         const float* dlt, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(dlt + 8 * j + col0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = 4 * j + 2 * half;
      dp[x] = pt[x] * (dp[x] - d.x);
      dp[x + 1] = pt[x + 1] * (dp[x + 1] - d.y);
    }
  }
}

// One CTA (one warpgroup) per (batch*head, 64-row k tile), low k tiles
// (the most q tiles under the causal mask) first, on kP planes of each
// operand (bf16: one; split f32: hi and lo). K and V are resident; Q and
// dO tiles stream through the ring from the q tile holding key k0
// (causal; earlier q tiles see only masked keys) or 0 to the end. Per q
// tile: S^T = K Q^T and dP^T = V dO^T by SS wgmma (all K-major, plane by
// plane); P^T in f32 registers. bf16: P^T rounded to bf16 is the A
// operand of dv += P^T dO (dO MN-major), which runs while dS^T = P^T (dP^T
// - delta) is computed; dS^T rounded to bf16 is the A operand of dk +=
// dS^T Q (Q MN-major). Split f32: dS^T is computed first, then P^T's and
// dS^T's hi and lo planes are the A operands of the two products, each
// summed for the q tile in a partial accumulator and then added into dv or
// dk on the CUDA cores (add_split_product). lse and delta are per column:
// the threads bring the next tile's 64 + 64 values into one of two shared
// buffers while this tile's products run. maps holds q's, k's, v's and
// dO's maps, kP each.
template <int D, int kP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_sm90(const __grid_constant__ Maps<4 * kP> maps, const float* __restrict__ lse,
                   const float* __restrict__ delta, typename PlaneOut<kP>::T* __restrict__ dk,
                   typename PlaneOut<kP>::T* __restrict__ dv, int heads, int seq, float scale,
                   float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  // [buffer][lse in log2 units, delta][column of the q tile]
  __shared__ __align__(16) float stats[2][2][kRows];
  const DkvRing<D, kP> ring{aligned_smem_base(smem_raw)};
  const CUtensorMap* qmap = &maps.m[0];
  const CUtensorMap* kmap = &maps.m[kP];
  const CUtensorMap* vmap = &maps.m[2 * kP];
  const CUtensorMap* domap = &maps.m[3 * kP];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kRows;
  const int q_first = causal ? k0 : 0;  // q tiles are 64-aligned like k tiles
  const int n_tiles = (seq - q_first + kRows - 1) / kRows;

  // thread tid brings column tid % 64 of lse (tid < 64, times log2 e) or
  // of delta (tid >= 64); columns past T take 0 (they are masked)
  const int stat_col = tid % kRows, stat_kind = tid / kRows;
  const float* stat_row = (stat_kind ? delta : lse) + static_cast<long long>(bh) * seq;
  const float stat_mul = stat_kind ? 1.f : kLog2e;
  stats[0][stat_kind][stat_col] =
      q_first + stat_col < seq ? stat_row[q_first + stat_col] * stat_mul : 0.f;

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0) {
    const CUtensorMap* lead[2] = {kmap, vmap};
    ring.load_lead(lead, k0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      ring.load_kv(s, qmap, domap, q_first + s * kRows, h, b);
  }
  __syncwarp();

  const int row0 = k0 + 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int col0 = 2 * (lane % 4);             // and q columns 8j + col0 + {0, 1}
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(ring.lead_bar(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int q0 = q_first + i * kRows;
    const int next = q0 + kRows + stat_col;  // the next tile's statistic, stored below
    const float next_stat = i + 1 < n_tiles && next < seq ? stat_row[next] * stat_mul : 0.f;
    mbar_wait(ring.full(s), (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, all operands K-major, plane by plane
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0, pa), kk),
                           desc_kmajor<D>(ring.k_tile(s, pb), kk), 1);
      });
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      plane_products<kP>([&](int pa, int pb) {
        wgmma_ss_m64n64k16(dp, desc_kmajor<D>(ring.lead(1, pa), kk),
                           desc_kmajor<D>(ring.v_tile(s, pb), kk), 1);
      });
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done; dP^T may still run
    fence_regs(sc);

    // P^T; only the tiles that straddle the causal diagonal or T evaluate
    // the mask (q tiles start at k0 under the causal mask, so the diagonal
    // is in tile 0 alone)
    const float* lse2 = stats[i & 1][0];
    const float* dlt = stats[i & 1][1];
    if (k0 + kRows > seq || q0 + kRows > seq || (causal && q0 == k0))
      pt_tile<true>(sc, lse2, row0, col0, q0, seq, causal, scale_log2);
    else
      pt_tile<false>(sc, lse2, row0, col0, q0, seq, causal, scale_log2);

    if constexpr (kP == 1) {
      // dv += P^T dO: P^T rounded to bf16 as the register A operand, dO MN-major
      uint32_t pa[4][4];
      to_a_operand(sc, pa);
      fence_regs(pa);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor<D>(ring.v_tile(s), kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; P^T dO may still run
      fence_regs(dp);

      // dk += dS^T Q: dS^T rounded to bf16 as the register A operand, Q MN-major
      dst_tile(dp, sc, dlt, col0);
      uint32_t da[4][4];
      to_a_operand(dp, da);
      fence_regs(da);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dk_acc, da[kk], desc_mnmajor<D>(ring.k_tile(s), kk));
      wgmma_commit();
      // the other buffer was last read in tile i - 1, before the barrier below
      stats[(i + 1) & 1][stat_kind][stat_col] = next_stat;
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    } else {
      // dS^T = P^T (dP^T - delta) first, so S^T's registers are free
      // before the products; then dv += P^T dO and dk += dS^T Q, each with
      // its A operand's hi and lo planes in registers and B's MN-major
      wgmma_wait_all();
      fence_regs(dp);
      dst_tile(dp, sc, dlt, col0);
      uint32_t pa[2][4][4];
      to_a_operand<2>(sc, pa);
      add_split_product<D>(dv_acc, pa, ring.v_tile(s, 0), ring.v_tile(s, 1));
      uint32_t da[2][4][4];
      to_a_operand<2>(dp, da);
      add_split_product<D>(dk_acc, da, ring.k_tile(s, 0), ring.k_tile(s, 1));
      // the other buffer was last read in tile i - 1, before the barrier below
      stats[(i + 1) & 1][stat_kind][stat_col] = next_stat;
    }
    __syncthreads();  // the next tile's statistics are in place

    ring.release(i, n_tiles, qmap, domap, h, b, q_first);
  }

  // dk = scale * acc and dv in the outputs' type; keys past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const long long off = ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int x = 4 * j + 2 * half;
      store2(dk + off + 8 * j + col0, scale * dk_acc[x], scale * dk_acc[x + 1]);
      store2(dv + off + 8 * j + col0, dv_acc[x], dv_acc[x + 1]);
    }
  }
}

// kP = 1: bf16 q, k, v, dout, dk and dv; kP = 2: each of q, k, v, dout is
// the hi plane of a split f32 operand whose lo plane follows it, one
// [B, T, H, D] on, and dk, dv are f32
template <int D, int kP>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  Maps<4 * kP> maps;
  cudaError_t err = encode_planes<D, kP>(a, maps);
  if (err != cudaSuccess) return err;
  auto kern = flash_dkv_sm90<D, kP>;
  const size_t smem = DkvRing<D, kP>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  using Out = typename PlaneOut<kP>::T;
  const dim3 grid(a.batch * a.heads, (a.seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      maps, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Out*>(dk), static_cast<Out*>(dv), a.heads, a.seq, a.scale, a.scale * kLog2e,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int planes, const Args& a, void* dk, void* dv) {
  if (planes == 1) return launch_dkv<D, 1>(a, dk, dv);
  if (planes == 2) return launch_dkv<D, 2>(a, dk, dv);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sm90

// q, k, v, dout: [batch, seq, heads, d] with unit stride along d and the
// given element strides for (batch, seq, heads), read by TMA (16 B aligned
// bases, strides that are multiples of 8 elements); lse, delta: contiguous
// f32 [batch, heads, seq]; dq: contiguous [batch, seq, heads, d]. planes 1:
// bf16 operands and dq; planes 2: each of q, k, v, dout points at the hi
// plane of a split f32 operand whose lo plane follows it, batch * seq *
// heads * d values on, and dq is f32. d is 16, 32, 64 or 128.
extern "C" int mxtt_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq,
    int heads, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, int causal, int planes, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const sm90::Args a = sm90::make_args(q, k, v, dout, lse, delta, batch, seq, heads, st,
                                       scale, causal, stream);
  cudaError_t err;
  switch (d) {
    case 16: err = sm90::launch_dq<16>(planes, a, dq); break;
    case 32: err = sm90::launch_dq<32>(planes, a, dq); break;
    case 64: err = sm90::launch_dq<64>(planes, a, dq); break;
    case 128: err = sm90::launch_dq<128>(planes, a, dq); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q, k, v, dout as for dq, read by TMA; dk, dv: contiguous [batch, seq,
// heads, d]. planes 1: bf16 operands and outputs; planes 2: each of q, k,
// v, dout points at the hi plane of a split f32 operand whose lo plane
// follows it, batch * seq * heads * d values on, and dk, dv are f32.
extern "C" int mxtt_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq, int heads, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, int causal, int planes, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const sm90::Args a = sm90::make_args(q, k, v, dout, lse, delta, batch, seq, heads, st,
                                       scale, causal, stream);
  cudaError_t err;
  switch (d) {
    case 16: err = sm90::launch_dkv<16>(planes, a, dk, dv); break;
    case 32: err = sm90::launch_dkv<32>(planes, a, dk, dv); break;
    case 64: err = sm90::launch_dkv<64>(planes, a, dk, dv); break;
    case 128: err = sm90::launch_dkv<128>(planes, a, dk, dv); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
