// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replace the TPU kernels of mxnet_tpu/ops/pallas_kernels.py launched by
// `_bwd_call` (the jax.custom_vjp backward of `_flash`):
//   * flash_dq_kernel  <- `_bwd_dq_kernel`:  dq = scale * sum_k dS K
//   * flash_dkv_kernel <- `_bwd_dkv_kernel`: dv = sum_q P^T dO,
//                                            dk = scale * sum_q dS^T Q
// with, exactly as the Pallas kernels compute it, from bf16 or f32 loads
// upcast to f32: s = scale * q.k^T; the keep-mask of `_masked_scores`
// (k < T, and q >= k when causal; here also q < T, since T is not padded);
// P = exp(s - lse) where kept, else 0; dP = dO V^T; dS = P * (dP - delta).
// lse is the forward's f32 logsumexp and delta = sum_D dO * O, both
// [B, H, T] f32, computed by the caller. Outputs are cast to q's dtype
// after the scale, as `:198` and `:245-246` do.
//
// What bounds them on the H100. Per live (q, k) pair dq does 6*D flops
// (s, dP, dS K) and dk/dv 8*D (s, dP, P^T dO, dS^T Q) against ~10-12*D
// bytes per row, so at T >= 128 both need far more operations per byte
// than the card's balance point: the bound is the tensor cores' bf16 rate.
// This first version multiplies with f32 FMAs on the CUDA cores, like the
// forward kernel, so it stays an order of magnitude or more above that
// bound; wgmma and TMA are the next step. What the design does:
//   * One owner per output, no atomics. The TPU design splits the backward
//     into a dq pass and a dk/dv pass so each output tile has one writer;
//     the split is kept, so a repeated launch gives the same bits.
//   * dq: one block per (batch*head, 64-row q tile); the k tiles are a loop
//     inside the block up to the causal diagonal (the forward's bound), the
//     f32 dq accumulator stays in registers. The heaviest q tiles start
//     first so the causal triangle balances across SMs.
//   * dk/dv: one block per (batch*head, 64-row k tile); the q tiles are a
//     loop from the tile holding the block's first key (earlier q tiles see
//     only masked keys) to the end; dk and dv stay in registers.
//   * Each 64 x 64 score tile is recomputed (s and dP) from tiles staged in
//     shared memory as f32, padded by one column so neither the row-wise
//     nor the column-wise reads conflict on banks. 128 threads; each owns a
//     4 x 8 micro-tile of the scores and a 4 x D/8 micro-tile of the
//     accumulators, as in flash_attn_fwd.cu.
//   * The ragged edge of T is masked in the kernel and loads past T are
//     zero-filled (no padding of T); q, k, v, dO are read as [B, T, H, D]
//     through their strides, so the wrapper makes no transposed copies.
//   * Dynamic shared memory is 83-100 KB at D=64 and 149-166 KB at D=128,
//     above the 48 KB default, so the launch sets the opt-in attribute.
//
// Entry points: mxtt_flash_attn_bwd_dq and mxtt_flash_attn_bwd_dkv (plain C,
// loaded with ctypes). Each returns the cudaError_t of its launch (0 on
// success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;     // rows of a q tile and of a k tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kLanes = 8;      // lanes sharing one row group
constexpr int kRows = kBlock / (kThreads / kLanes);  // tile rows per thread: 4
constexpr int kCols = kBlock / kLanes;               // score cols per thread: 8
constexpr int kPP = kBlock + 1;                      // padded score-tile row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element strides of one [B, T, H, D] operand (unit stride along D)
struct Strides {
  long long b, t, h;
};

// rows t0 .. t0+kBlock of one (batch, head) slice into dst [kBlock][D+1] as
// f32; rows past seq are zero, so 0 * p can never make a NaN
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int t0, int seq) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < seq ? to_f32(src[t * st + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T, D>(qs, q + b * sq.b + h * sq.h, sq.t, q0, seq);
  load_tile<T, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, seq);
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
    load_tile<T, D>(ks, kb, sk.t, k0, seq);
    load_tile<T, D>(vs, vb, sv.t, k0, seq);
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
    T* row = dq + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) store_as(row + lane + kLanes * j, scale * acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int seq, Strides sq,
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
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_row = lse + static_cast<long long>(bh) * seq;
  const float* delta_row = delta + static_cast<long long>(bh) * seq;

  load_tile<T, D>(ks, k + b * sk.b + h * sk.h, sk.t, k0, seq);
  load_tile<T, D>(vs, v + b * sv.b + h * sv.h, sv.t, k0, seq);
  float dk_acc[kRows][kAcc], dv_acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // q tiles are kBlock-aligned like k tiles: under the causal mask the
  // tile holding key k0 is the one that starts at k0
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(qs, qb, sq.t, q0, seq);
    load_tile<T, D>(dos, dob, sdo.t, q0, seq);
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
      store_as(dk + off + lane + kLanes * j, scale * dk_acc[i][j]);
      store_as(dv + off + lane + kLanes * j, dv_acc[i][j]);
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

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  auto kern = flash_dq_kernel<T, D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.heads, a.seq, a.sq, a.sk, a.sv, a.sdo, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  auto kern = flash_dkv_kernel<T, D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.heads, a.seq, a.sq, a.sk,
      a.sv, a.sdo, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(int d, const Args& a, void* dq) {
  switch (d) {
    case 16: return launch_dq<T, 16>(a, dq);
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: return launch_dq<T, 64>(a, dq);
    case 128: return launch_dq<T, 128>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(int d, const Args& a, void* dk, void* dv) {
  switch (d) {
    case 16: return launch_dkv<T, 16>(a, dk, dv);
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: return launch_dkv<T, 64>(a, dk, dv);
    case 128: return launch_dkv<T, 128>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
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

// q, k, v, dout: [batch, seq, heads, d] of one dtype with unit stride along
// d and the given element strides for (batch, seq, heads); lse, delta:
// contiguous f32 [batch, heads, seq]; dq (and dk, dv): contiguous [batch,
// seq, heads, d] of q's dtype. is_bf16 selects __nv_bfloat16 (1) or float
// (0); d is 16, 32, 64 or 128.
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
  const cudaError_t err = is_bf16 ? dispatch_dq<__nv_bfloat16>(d, a, dq)
                                  : dispatch_dq<float>(d, a, dq);
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
  const cudaError_t err = is_bf16 ? dispatch_dkv<__nv_bfloat16>(d, a, dk, dv)
                                  : dispatch_dkv<float>(d, a, dk, dv);
  return static_cast<int>(err);
}
