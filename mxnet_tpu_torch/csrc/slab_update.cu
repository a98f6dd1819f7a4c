// Fused optimizer-slab update for Hopper (sm_90a), CUDA C++: one AMP
// optimizer step over every slab of a table in one launch.
//
// Replaces the TPU kernel `_slab_kernel` of mxnet_tpu/ops/pallas_kernels.py
// (:495, launched by `fused_slab_update`, pallas_call at :582), whose math is
// `_slab_update_math` (:455). Per element i, in this order:
//   g  = f32(grad[i]) * inv_scale
//   g  = g * rescale_grad                  (when rescale_grad != 1)
//   g  = clip(g, -clip_gradient, clip)     (when clip_gradient > 0)
//   g  = g + wd * w                        (when wd != 0)
//   sgd:     w' = w - lr * g
//   sgd_mom: m' = momentum * m - lr * g;  w' = w + m'
//   adam:    mean' = beta1 * mean + (1 - beta1) * g
//            var'  = beta2 * var + (1 - beta2) * g * g
//            w'    = w - lr * mean' / (sqrt(var') + epsilon)
//   then, unless finite > 0.5, w' and every state keep their old bits, and
//   w16 = bf16(w') (round to nearest even).
// Adam's bias correction is folded into lr by the caller.
//
// Every product, sum, difference, square root and quotient is written with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __fsqrt_rn, __fdiv_rn), which the compiler never contracts into an FMA:
// each rounds once, as each separate PyTorch op of the plain version does,
// so the kernel equals the plain version bit for bit.
//
// What bounds it on the H100: bytes at 3.35 TB/s. Each element reads w (4),
// g (2 or 4) and its states (4 each) and writes w' (4), its states (4 each)
// and w16 (2): 20 bytes for sgd_mom with a bf16 gradient, 28 for adam,
// against a few dozen flops, far below the ridge. So the design spends
// nothing on arithmetic and everything on moving the bytes once, with few
// instructions and no fixed cost per slab:
// - One launch a step for every slab of the step (a training step has one
//   per (bucket, chunk) of the flat plan: 16 for ResNet-50). The table of
//   slabs rides in the launch's parameter block as a __grid_constant__
//   struct (at most kMaxEntries entries, 3.4 KB, inside the classic 4 KB);
//   a longer table takes more launches. The tiles of all slabs form one
//   flat space (each entry holds the prefix count of tiles before it), and
//   a grid of a few CTAs an SM walks it with a grid stride, so no slab pays
//   its own ramp and tail.
// - 16-byte accesses for the f32 operands, which carry 16 of sgd_mom's 20
//   bytes an element: thread t of a 2048-element tile takes elements 4t..4t+3
//   and 1024+4t..1024+4t+3 as float4s, so a warp's access is 512 contiguous
//   bytes; the bf16 gradient and copy take the same four elements as 8-byte
//   accesses, also contiguous across the warp (whole 32-byte sectors). All
//   loads of a thread are issued before its first store. Measured on the
//   card (slab_ab.py, one step over ResNet-50's 16 buckets), this layout
//   beats a thread's eight elements side by side (a 16-byte bf16 gradient
//   load, but f32 accesses 32 bytes apart across the warp) by 11-14%, and
//   plain loads and stores beat the streaming hints (__ldcs / __stcs) by
//   1-2%; one or four vectors a thread land within 1% of two. Every
//   contiguous layout stops near 82% of the bound.
// - A slab may start at any element (a chunk of a bucket, a view at an odd
//   offset): an entry takes a scalar head up to the first 16-byte boundary,
//   a vector body and a scalar tail. An entry whose operands are misaligned
//   against each other (head -1) runs scalar throughout.
// - The per-step scalars come from device memory: each entry's lr through
//   its own pointer (the caller copies the step's lrs to the device once a
//   call), inv_scale and finite through pointers, so a step that computes
//   them on the device never waits for the host and a captured graph reads
//   new values at each replay. A null pointer takes the value beside it in
//   the table instead (a host number in a standalone call).
// Outputs may alias their inputs (each thread reads its elements before it
// writes them), which lets the caller update master and states in place.
//
// Entry point: mxtt_slab_update (plain C, loaded with ctypes). It returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                        // f32 elements in 16 bytes
constexpr int kVecs = 2;                       // vectors a thread takes of a tile
constexpr int kStride = kThreads * kVec;       // 1024: a thread's next vector is this far on
constexpr int kTile = kVecs * kStride;         // 2048 elements a tile (ops/kernels.py _SLAB_TILE)
constexpr int kMaxEntries = 32;
enum Kind { kSgd = 0, kSgdMom = 1, kAdam = 2 };

// One slab. Layout shared with the wrapper (ops/kernels.py `_SLAB_ENTRY`).
struct SlabEntry {
  const float* w;
  const void* g;
  const float* s0;
  const float* s1;
  float* out_w;
  float* out_s0;
  float* out_s1;
  __nv_bfloat16* w16;
  const float* lr_ptr;  // the step's lr in device memory; null: lr_value
  long long n;
  int tile0;            // the entry's first tile in the launch's tile space
  int head;             // elements before the 16-byte-aligned body; -1: scalar throughout
  float lr_value;
  float wd;
  int has_wd;
  int pad;
};
static_assert(sizeof(SlabEntry) == 104, "SlabEntry layout");

// What every slab of a launch shares (ops/kernels.py `_SLAB_SHARED`).
struct SlabShared {
  const float* inv_scale_ptr;  // null: inv_scale_value
  const float* finite_ptr;     // null: finite_value
  float inv_scale_value, finite_value;
  float rescale, clip, momentum, beta1, beta2, one_minus_beta1, one_minus_beta2, eps;
  int has_rescale, has_clip, n_entries, n_tiles;
};
static_assert(sizeof(SlabShared) == 72, "SlabShared layout");

struct SlabTable {
  SlabShared s;
  SlabEntry e[kMaxEntries];
};
static_assert(sizeof(SlabTable) <= 4096, "the table must fit the classic parameter block");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 ld_grad4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ld_grad4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The step's scalars for one entry.
struct Step {
  float lr, inv_scale, wd;
  bool keep, has_wd;
};

// One element: `_slab_update_math` in its order of operations. s0 / s1 are
// read and written through references (unused for the kinds without them).
template <int KIND>
__device__ __forceinline__ float update1(const SlabShared& h, const Step& st, float wv,
                                         float graw, float& s0, float& s1) {
  float gv = __fmul_rn(graw, st.inv_scale);
  if (h.has_rescale) gv = __fmul_rn(gv, h.rescale);
  if (h.has_clip) gv = gv < -h.clip ? -h.clip : (gv > h.clip ? h.clip : gv);  // NaN stays
  if (st.has_wd) gv = __fadd_rn(gv, __fmul_rn(st.wd, wv));
  float nw;
  if (KIND == kSgd) {
    nw = __fsub_rn(wv, __fmul_rn(st.lr, gv));
  } else if (KIND == kSgdMom) {
    const float nm = __fsub_rn(__fmul_rn(h.momentum, s0), __fmul_rn(st.lr, gv));
    nw = __fadd_rn(wv, nm);
    s0 = st.keep ? nm : s0;
  } else {
    const float nmean = __fadd_rn(__fmul_rn(h.beta1, s0), __fmul_rn(h.one_minus_beta1, gv));
    const float nvar =
        __fadd_rn(__fmul_rn(h.beta2, s1), __fmul_rn(h.one_minus_beta2, __fmul_rn(gv, gv)));
    const float step = __fdiv_rn(__fmul_rn(st.lr, nmean), __fadd_rn(__fsqrt_rn(nvar), h.eps));
    nw = __fsub_rn(wv, step);
    s0 = st.keep ? nmean : s0;
    s1 = st.keep ? nvar : s1;
  }
  return st.keep ? nw : wv;
}

template <int KIND, typename G>
__device__ __forceinline__ void scalar_element(const SlabShared& h, const SlabEntry& e,
                                               const Step& st, long long i) {
  const float wv = e.w[i];
  float s0 = KIND != kSgd ? e.s0[i] : 0.f;
  float s1 = KIND == kAdam ? e.s1[i] : 0.f;
  const float nw = update1<KIND>(h, st, wv, to_f32(static_cast<const G*>(e.g)[i]), s0, s1);
  e.out_w[i] = nw;
  if (KIND != kSgd) e.out_s0[i] = s0;
  if (KIND == kAdam) e.out_s1[i] = s1;
  e.w16[i] = __float2bfloat16_rn(nw);
}

template <int KIND>
__device__ __forceinline__ float4 update4(const SlabShared& h, const Step& st, float4 w, float4 g,
                                          float4& s0, float4& s1) {
  float4 nw;
  nw.x = update1<KIND>(h, st, w.x, g.x, s0.x, s1.x);
  nw.y = update1<KIND>(h, st, w.y, g.y, s0.y, s1.y);
  nw.z = update1<KIND>(h, st, w.z, g.z, s0.z, s1.z);
  nw.w = update1<KIND>(h, st, w.w, g.w, s0.w, s1.w);
  return nw;
}

// NV aligned 4-element vectors at idx[0..NV): every load first,
// then the math, then every store.
template <int KIND, typename G, int NV>
__device__ __forceinline__ void vectors(const SlabShared& h, const SlabEntry& e, const Step& st,
                                        const long long* idx) {
  const G* g = static_cast<const G*>(e.g);
  float4 w[NV], gv[NV], s0[NV], s1[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    w[v] = ld4(e.w + idx[v]);
    gv[v] = ld_grad4(g + idx[v]);
    s0[v] = KIND != kSgd ? ld4(e.s0 + idx[v]) : make_float4(0.f, 0.f, 0.f, 0.f);
    s1[v] = KIND == kAdam ? ld4(e.s1 + idx[v]) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) w[v] = update4<KIND>(h, st, w[v], gv[v], s0[v], s1[v]);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    st4(e.out_w + idx[v], w[v]);
    if (KIND != kSgd) st4(e.out_s0 + idx[v], s0[v]);
    if (KIND == kAdam) st4(e.out_s1 + idx[v], s1[v]);
    st_bf16x4(e.w16 + idx[v], w[v]);
  }
}

template <int KIND, typename G>
__global__ void __launch_bounds__(kThreads)
slab_update_kernel(const __grid_constant__ SlabTable t) {
  const SlabShared& h = t.s;
  const float inv_scale = h.inv_scale_ptr ? __ldg(h.inv_scale_ptr) : h.inv_scale_value;
  const bool keep = (h.finite_ptr ? __ldg(h.finite_ptr) : h.finite_value) > 0.5f;
  const int tid = threadIdx.x;
  int k = 0;  // this CTA's entry: its tiles only grow, so the entry only moves on
  for (int tile = blockIdx.x; tile < h.n_tiles; tile += gridDim.x) {
    while (k + 1 < h.n_entries && tile >= t.e[k + 1].tile0) ++k;
    const SlabEntry& e = t.e[k];
    const Step st{e.lr_ptr ? __ldg(e.lr_ptr) : e.lr_value, inv_scale, e.wd, keep,
                  e.has_wd != 0};
    const long long local = tile - e.tile0;
    if (e.head < 0) {  // operands misaligned against each other: scalar
      const long long base = local * kTile + tid;
#pragma unroll 1
      for (int j = 0; j < kTile / kThreads; ++j) {
        const long long i = base + j * kThreads;
        if (i < e.n) scalar_element<KIND, G>(h, e, st, i);
      }
      continue;
    }
    if (local == 0 && tid < e.head) scalar_element<KIND, G>(h, e, st, tid);
    const long long first = e.head + local * kTile + tid * kVec;
    long long idx[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) idx[v] = first + v * kStride;
    if (idx[kVecs - 1] + kVec <= e.n) {
      vectors<KIND, G, kVecs>(h, e, st, idx);
      continue;
    }
#pragma unroll 1
    for (int v = 0; v < kVecs; ++v) {  // the entry's last tile
      const long long i0 = first + v * kStride;
      if (i0 + kVec <= e.n) {
        vectors<KIND, G, 1>(h, e, st, &i0);
      } else {
        for (long long i = i0; i < e.n; ++i) scalar_element<KIND, G>(h, e, st, i);
      }
    }
  }
}

template <int KIND>
cudaError_t launch(int g_bf16, const SlabTable& t, int blocks, cudaStream_t stream) {
  if (g_bf16) {
    slab_update_kernel<KIND, __nv_bfloat16><<<blocks, kThreads, 0, stream>>>(t);
  } else {
    slab_update_kernel<KIND, float><<<blocks, kThreads, 0, stream>>>(t);
  }
  return cudaGetLastError();
}

}  // namespace

// One step over the n_entries slabs of `entries` (at most 32), sharing
// `shared`. kind: 0 sgd, 1 sgd_mom (s0 = momentum), 2 adam (s0 = mean, s1 =
// var); unused state pointers may be null. Every slab's w, states and their
// outputs f32, g bf16 (g_bf16 = 1) or f32, w16 bf16, all on the current
// device. The has_* flags switch the rescale, clip and weight-decay terms on,
// as the Python conditions of `_slab_update_math` do. Both tables are host
// memory, copied into the launch.
extern "C" int mxtt_slab_update(int kind, int g_bf16, const void* shared, const void* entries,
                                int n_entries, int blocks, void* stream) {
  if (n_entries <= 0 || n_entries > kMaxEntries || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabTable t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(&t.s, shared, sizeof(SlabShared));
  std::memcpy(t.e, entries, sizeof(SlabEntry) * n_entries);
  if (t.s.n_entries != n_entries || t.s.n_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd:
      return static_cast<int>(launch<kSgd>(g_bf16, t, blocks, s));
    case kSgdMom:
      return static_cast<int>(launch<kSgdMom>(g_bf16, t, blocks, s));
    case kAdam:
      return static_cast<int>(launch<kAdam>(g_bf16, t, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
