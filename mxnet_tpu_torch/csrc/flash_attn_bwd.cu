// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py launched by
// `_bwd_call` (the jax.custom_vjp backward of `_flash`):
//   * dq  <- `_bwd_dq_kernel`:  dq = scale * sum_k dS K
//            (bf16: flash_dq_sm90, TMA and wgmma; f32: flash_dq_kernel)
//   * dkv <- `_bwd_dkv_kernel`: dv = sum_q P^T dO, dk = scale * sum_q dS^T Q
//            (bf16: flash_dkv_sm90, TMA and wgmma; f32: flash_dkv_kernel)
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
//   * dq and dk/dv, f32 (flash_dq_kernel, flash_dkv_kernel): f32 FMAs on
//     the CUDA cores; the f32 limit (1e-4) rules out TF32 tensor cores.
//     One block per (batch*head, 64-row q or k tile); the other tiles are
//     a loop inside the block (dq: up to the causal diagonal; dk/dv: from
//     the tile holding the block's first key to the end); the accumulators
//     stay in registers. Each 64 x 64 score tile is recomputed (s and dP)
//     from tiles staged in shared memory as f32, padded by one column so
//     neither the row-wise nor the column-wise reads conflict on banks. 128
//     threads; each owns a 4 x 8 micro-tile of the scores and a 4 x D/8
//     micro-tile of the accumulators, as in flash_attn_fwd.cu. Dynamic
//     shared memory is 83-100 KB at D=64 and 149-166 KB at D=128, above
//     the 48 KB default, so the launch sets the opt-in attribute.
//   * The ragged edge of T is masked in the kernels and loads past T are
//     zero-filled (no padding of T). The f32 kernels read q, k, v, dO as
//     [B, T, H, D] through their strides; the bf16 ones through tensor maps
//     of the same strides (the wrapper copies an operand TMA cannot read).
//
// Entry points: mxtt_flash_attn_bwd_dq and mxtt_flash_attn_bwd_dkv (plain C,
// loaded with ctypes). Each returns the cudaError_t of its launch (0 on
// success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kBlock = 64;     // rows of a q tile and of a k tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kLanes = 8;      // lanes sharing one row group
constexpr int kRows = kBlock / (kThreads / kLanes);  // tile rows per thread: 4
constexpr int kCols = kBlock / kLanes;               // score cols per thread: 8
constexpr int kPP = kBlock + 1;                      // padded score-tile row

// element strides of one [B, T, H, D] operand (unit stride along D)
struct Strides {
  long long b, t, h;
};

// rows t0 .. t0+kBlock of one (batch, head) slice into dst [kBlock][D+1];
// rows past seq are zero, so 0 * p can never make a NaN
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int t0, int seq) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < seq ? src[t * st + c] : 0.f;
  }
}

// acc[i][j] = a[row_i] . b[col_j] over D, rows group*kRows + i of a and
// rows lane + kLanes*j of b, both [kBlock][D+1] in shared memory
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         float (&acc)[kRows][kCols], int group,
                                         int lane) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[kRows], y[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = a[(group * kRows + i) * DP + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) y[j] = b[(lane + kLanes * j) * DP + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_kk w[row_i][kk] * m[kk][lane + kLanes*j]: w is a
// [kBlock][kPP] score tile, m a [kBlock][D+1] operand tile
template <int D>
__device__ __forceinline__ void tile_accumulate(
    const float* w, const float* m, float (&acc)[kRows][D / kLanes], int group,
    int lane) {
  constexpr int DP = D + 1;
  constexpr int kAcc = D / kLanes;
#pragma unroll 4
  for (int kk = 0; kk < kBlock; ++kk) {
    float x[kRows], y[kAcc];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = w[(group * kRows + i) * kPP + kk];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) y[j] = m[kk * DP + lane + kLanes * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kPP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * kPP + 2 * kBlock);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int seq, Strides sq, Strides sk, Strides sv,
                    Strides sdo, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int kAcc = D / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBlock][DP]
  float* dos = qs + kBlock * DP;  // [kBlock][DP]
  float* ks = dos + kBlock * DP;  // [kBlock][DP]
  float* vs = ks + kBlock * DP;   // [kBlock][DP]
  float* dss = vs + kBlock * DP;  // [kBlock][kPP] dS of the current k tile

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // heavy tiles first
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<D>(qs, q + b * sq.b + h * sq.h, sq.t, q0, seq);
  load_tile<D>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, seq);
  const float* lse_row = lse + static_cast<long long>(bh) * seq;
  const float* delta_row = delta + static_cast<long long>(bh) * seq;
  float lse_r[kRows], delta_r[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + group * kRows + i;
    lse_r[i] = t < seq ? lse_row[t] : 0.f;
    delta_r[i] = t < seq ? delta_row[t] : 0.f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(seq, q0 + kBlock) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, kb, sk.t, k0, seq);
    load_tile<D>(vs, vb, sv.t, k0, seq);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<D>(qs, ks, s, group, lane);
    tile_dot<D>(dos, vs, dp, group, lane);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = group * kRows + i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + kLanes * j;
        const int kpos = k0 + col;
        const bool keep = qpos < seq && kpos < seq && (!causal || qpos >= kpos);
        const float p = keep ? expf(scale * s[i][j] - lse_r[i]) : 0.f;
        dss[row * kPP + col] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(dss, ks, acc, group, lane);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + group * kRows + i;
    if (t >= seq) continue;
    float* row = dq + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) row[lane + kLanes * j] = scale * acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int seq, Strides sq,
                     Strides sk, Strides sv, Strides sdo, float scale,
                     int causal) {
  constexpr int DP = D + 1;
  constexpr int kAcc = D / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                // [kBlock][DP]
  float* vs = ks + kBlock * DP;    // [kBlock][DP]
  float* qs = vs + kBlock * DP;    // [kBlock][DP]
  float* dos = qs + kBlock * DP;   // [kBlock][DP]
  float* ps = dos + kBlock * DP;   // [kBlock][kPP] P^T of the current q tile
  float* dss = ps + kBlock * kPP;  // [kBlock][kPP] dS^T
  float* lse_s = dss + kBlock * kPP;  // [kBlock]
  float* delta_s = lse_s + kBlock;    // [kBlock]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kBlock;  // low k tiles carry the most q tiles
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_row = lse + static_cast<long long>(bh) * seq;
  const float* delta_row = delta + static_cast<long long>(bh) * seq;

  load_tile<D>(ks, k + b * sk.b + h * sk.h, sk.t, k0, seq);
  load_tile<D>(vs, v + b * sv.b + h * sv.h, sv.t, k0, seq);
  float dk_acc[kRows][kAcc], dv_acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // q tiles are kBlock-aligned like k tiles: under the causal mask the
  // tile holding key k0 is the one that starts at k0
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(qs, qb, sq.t, q0, seq);
    load_tile<D>(dos, dob, sdo.t, q0, seq);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const int t = q0 + i;
      lse_s[i] = t < seq ? lse_row[t] : 0.f;
      delta_s[i] = t < seq ? delta_row[t] : 0.f;
    }
    __syncthreads();

    // scores transposed: rows are this block's keys, columns the q tile
    float st[kRows][kCols];
    tile_dot<D>(ks, qs, st, group, lane);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = group * kRows + i;
      const int kpos = k0 + row;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + kLanes * j;
        const int qpos = q0 + col;
        const bool keep = kpos < seq && qpos < seq && (!causal || qpos >= kpos);
        ps[row * kPP + col] = keep ? expf(scale * st[i][j] - lse_s[col]) : 0.f;
      }
    }
    tile_dot<D>(vs, dos, st, group, lane);  // dP^T, reusing the registers
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = group * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + kLanes * j;
        // each thread reads back only the P^T entries it wrote itself
        dss[row * kPP + col] = ps[row * kPP + col] * (st[i][j] - delta_s[col]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(ps, dos, dv_acc, group, lane);
    tile_accumulate<D>(dss, qs, dk_acc, group, lane);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = k0 + group * kRows + i;
    if (t >= seq) continue;
    const long long off = ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      dk[off + lane + kLanes * j] = scale * dk_acc[i][j];
      dv[off + lane + kLanes * j] = dv_acc[i][j];
    }
  }
}

// arguments shared by both entry points
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int batch, seq, heads;
  Strides sq, sk, sv, sdo;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  auto kern = flash_dq_kernel<D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.heads, a.seq, a.sq, a.sk, a.sv, a.sdo, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  auto kern = flash_dkv_kernel<D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.heads, a.seq, a.sq, a.sk,
      a.sv, a.sdo, a.scale, a.causal);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int batch, int seq,
               int heads, const long long* st, float scale, int causal,
               void* stream) {
  return Args{q, k, v, dout, lse, delta, batch, seq, heads,
              Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
              Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
              scale, causal, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// ------------------------------------------------------------------ bf16 dq
// In namespace sm90, so the header's names (kRows = 64 rows a tile,
// load_tile by TMA) are found before the SIMT kernels'.
namespace sm90 {
namespace {

constexpr int kStages = 2;  // K/V ring depth

template <int D>
using DqRing = Ring<D, 2, kStages>;  // lead tiles: Q, dO

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int heads,
                  int seq, float scale, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const DqRing<D> ring{aligned_smem_base(smem_raw)};

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
    const CUtensorMap* lead[2] = {&qmap, &domap};
    ring.load_lead(lead, q0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      ring.load_kv(s, &kmap, &vmap, s * kRows, h, b);
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

    // S = Q K^T and dP = dO V^T, all four operands K-major in shared memory
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0), kk),
                         desc_kmajor<D>(ring.k_tile(s), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, desc_kmajor<D>(ring.lead(1), kk),
                         desc_kmajor<D>(ring.v_tile(s), kk), kk > 0);
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

    // dq += dS K: dS rounded to bf16 as the register A operand, K MN-major
    uint32_t da[4][4];
    to_a_operand(sc, da);
    fence_regs(da);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, da[kk], desc_mnmajor<D>(ring.k_tile(s), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(da);

    ring.release(i, n_tiles, &kmap, &vmap, h, b);
  }

  // dq = scale * acc in bf16; rows past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    __nv_bfloat16* out = dq + ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) = __floats2bfloat162_rn(
          scale * acc[4 * j + 2 * half], scale * acc[4 * j + 2 * half + 1]);
  }
}

// the tensor maps of q, k, v and dout
inline cudaError_t encode_operands(const Args& a, int d, CUtensorMap (&maps)[4]) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Strides st[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_operand(&maps[i], ptrs[i], a.batch, a.seq, a.heads, d,
                                           st[i].b, st[i].t, st[i].h);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  CUtensorMap maps[4];
  cudaError_t err = encode_operands(a, D, maps);
  if (err != cudaSuccess) return err;
  auto kern = flash_dq_sm90<D>;
  const size_t smem = DqRing<D>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dq), a.heads, a.seq,
      a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 dk/dv

template <int D>
using DkvRing = Ring<D, 2, kStages>;  // lead tiles: K, V; the stages stream Q and dO

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
// (the most q tiles under the causal mask) first. K and V are resident;
// Q and dO tiles stream through the ring from the q tile holding key k0
// (causal; earlier q tiles see only masked keys) or 0 to the end. Per q
// tile: S^T = K Q^T and dP^T = V dO^T by SS wgmma (all K-major); P^T in
// f32 registers, rounded to bf16 as the A operand of dv += P^T dO (dO
// MN-major), which runs while dS^T = P^T (dP^T - delta) is computed; dS^T
// rounded to bf16 is the A operand of dk += dS^T Q (Q MN-major). lse and
// delta are per column: the threads bring the next tile's 64 + 64 values
// into one of two shared buffers while this tile's products run.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int heads, int seq, float scale,
                   float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  // [buffer][lse in log2 units, delta][column of the q tile]
  __shared__ __align__(16) float stats[2][2][kRows];
  const DkvRing<D> ring{aligned_smem_base(smem_raw)};

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
    const CUtensorMap* lead[2] = {&kmap, &vmap};
    ring.load_lead(lead, k0, h, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      ring.load_kv(s, &qmap, &domap, q_first + s * kRows, h, b);
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

    // S^T = K Q^T and dP^T = V dO^T, all four operands K-major
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(sc, desc_kmajor<D>(ring.lead(0), kk),
                         desc_kmajor<D>(ring.k_tile(s), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, desc_kmajor<D>(ring.lead(1), kk),
                         desc_kmajor<D>(ring.v_tile(s), kk), kk > 0);
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
    __syncthreads();  // the next tile's statistics are in place

    ring.release(i, n_tiles, &qmap, &domap, h, b, q_first);
  }

  // dk = scale * acc and dv in bf16; keys past T not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const long long off = ((static_cast<long long>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int x = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + col0) =
          __floats2bfloat162_rn(scale * dk_acc[x], scale * dk_acc[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + col0) =
          __floats2bfloat162_rn(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  CUtensorMap maps[4];
  cudaError_t err = encode_operands(a, D, maps);
  if (err != cudaSuccess) return err;
  auto kern = flash_dkv_sm90<D>;
  const size_t smem = DkvRing<D>::kSmemBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.heads, a.seq, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90

// q, k, v, dout: [batch, seq, heads, d] of one dtype with unit stride along
// d and the given element strides for (batch, seq, heads); lse, delta:
// contiguous f32 [batch, heads, seq]; dq (and dk, dv): contiguous [batch,
// seq, heads, d] of q's dtype. is_bf16 selects __nv_bfloat16 (1) or float
// (0); d is 16, 32, 64 or 128. The bf16 dq kernel reads q, k, v, dout by
// TMA, which also wants 16 B aligned bases and strides that are multiples
// of 8 elements.
extern "C" int mxtt_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq,
    int heads, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, batch, seq, heads, st,
                           scale, causal, stream);
  cudaError_t err;
  switch (d) {
    case 16: err = is_bf16 ? sm90::launch_dq_bf16<16>(a, dq) : launch_dq_f32<16>(a, dq); break;
    case 32: err = is_bf16 ? sm90::launch_dq_bf16<32>(a, dq) : launch_dq_f32<32>(a, dq); break;
    case 64: err = is_bf16 ? sm90::launch_dq_bf16<64>(a, dq) : launch_dq_f32<64>(a, dq); break;
    case 128: err = is_bf16 ? sm90::launch_dq_bf16<128>(a, dq) : launch_dq_f32<128>(a, dq); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int mxtt_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq, int heads, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, batch, seq, heads, st,
                           scale, causal, stream);
  cudaError_t err;
  switch (d) {
    case 16: err = is_bf16 ? sm90::launch_dkv_bf16<16>(a, dk, dv) : launch_dkv_f32<16>(a, dk, dv); break;
    case 32: err = is_bf16 ? sm90::launch_dkv_bf16<32>(a, dk, dv) : launch_dkv_f32<32>(a, dk, dv); break;
    case 64: err = is_bf16 ? sm90::launch_dkv_bf16<64>(a, dk, dv) : launch_dkv_f32<64>(a, dk, dv); break;
    case 128: err = is_bf16 ? sm90::launch_dkv_bf16<128>(a, dk, dv) : launch_dkv_f32<128>(a, dk, dv); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
