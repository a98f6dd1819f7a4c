// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (launched by `_fwd_call`, reached from `flash_attention` / `attention`):
// blockwise online-softmax attention that never materialises the [T, T]
// score matrix and saves the f32 logsumexp for a backward pass.
//
// What it computes, exactly as the Pallas kernel does: s = scale * q.k^T in
// f32 from bf16 or f32 loads; the keep-mask (k < T, and q >= k when causal);
// masked scores set to -1e30; a running max m, sum l and f32 accumulator; at
// the end o = acc / safe_l cast to q's dtype and lse = m + log(safe_l), where
// safe_l = l if l > 0 else 1, so a row whose sum is 0 writes 0.
//
// What bounds it on the H100. Causal attention at the serving shapes does
// about 4*D flops per (q, k) pair against 8*D bytes per row of q, k, v, o,
// so at T >= 128 it needs far more operations per byte than the card's
// balance point: the bound is the tensor cores' bf16 rate (989 TFLOP/s).
// This first version multiplies with f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), so it cannot get within an order of magnitude of that bound;
// wgmma and TMA are the next step. What the design does about the rest:
//   * The TPU's sequential k grid axis with VMEM scratch becomes a loop
//     inside one block; each block owns one (batch*head, 64-row q tile), so
//     the running max, sum and accumulator stay in registers across k tiles.
//   * Q, K and V tiles are staged through shared memory once per tile and
//     reused by all 128 threads; each thread owns a 4 x 8 micro-tile of the
//     scores and a 4 x D/8 micro-tile of the accumulator, so every shared
//     load feeds several FMAs. Row max and sum go through warp shuffles
//     among the 8 lanes that share a row group.
//   * The k loop stops at the causal diagonal, and the heaviest q tiles are
//     scheduled first so the causal triangle balances across SMs.
//   * The ragged edge is masked in the kernel (no padding of T, no shrinking
//     of blocks for small T), and q/k/v are read as [B, T, H, D] through
//     their strides, so the wrapper makes no transposed copies.
//
// Entry point: mxtt_flash_attn_fwd (plain C, loaded with ctypes). It returns
// the cudaError_t of the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per block
constexpr int kBlockK = 64;    // k rows per shared-memory tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kLanes = 8;      // lanes sharing one row group
constexpr int kRows = kBlockQ / (kThreads / kLanes);  // q rows per thread: 4
constexpr int kCols = kBlockK / kLanes;               // score cols per thread: 8
constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    qs[r * DP + c] = t < seq ? to_f32(qb[t * q_st + c]) : 0.f;
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
      ks[r * DP + c] = in ? to_f32(kb[t * k_st + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[t * v_st + c]) : 0.f;
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
    T* orow = o + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      store_as(orow + lane + kLanes * j, acc[i][j] / safe_l);
    if (lane == 0)
      lse[static_cast<long long>(bh) * seq + t] = m[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      heads, seq, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, void* lse, int batch, int seq, int heads,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, seq, heads, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [batch, seq, heads, d] with unit stride along d and the given
// element strides for (batch, seq, heads); o: contiguous [batch, seq, heads,
// d] of the same dtype; lse: contiguous f32 [batch, heads, seq].
// is_bf16 selects __nv_bfloat16 (1) or float (0); d is 16, 32, 64 or 128.
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
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s)
              : dispatch_d<float>(d, q, k, v, o, lse, batch, seq, heads, st, scale, causal, s);
  return static_cast<int>(err);
}
