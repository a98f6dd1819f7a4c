// Hopper (sm_90a) building blocks of the kernels in flash_attn_fwd.cu
// (K4f), flash_attn_bwd.cu (K4dq, K4dkv) and conv_bwd.cu (K2, K3): a TMA tensor
// map over one [B, T, H, D] bf16 operand (and over any bf16 array whose
// byte strides are multiples of 16), an mbarrier ring, the shared-memory
// descriptors of wgmma, and thin inline-PTX wrappers of
// wgmma.mma_async m64nNk16 (f32 += bf16 x bf16). The f32 flash kernels run
// on two bf16 planes of each operand (hi and lo, three products for each
// f32 one: plane_products, to_a_operand<2>, add_split_product), and the
// ring holds both planes of every tile.
//
// Tiles. A tile is 64 rows (positions t) of one (batch, head) slice, all D
// columns, bf16, in shared memory. TMA writes it with the swizzle that
// matches one row: a row of D bf16 is 2·D bytes, so D=16 takes the 32 B
// swizzle, D=32 the 64 B one and D=64 the 128 B one; D=128 is two boxes of
// 64 columns, each a [64][64] block with the 128 B swizzle, the second
// 8 KB after the first. Every tile starts on a 1024 B boundary, the period
// of the largest swizzle, so the pattern TMA writes is the one wgmma reads.
// Any other box whose rows are 128 B (64 bf16) with the 128 B swizzle, and
// whose row count is a multiple of 8, has Tile<64>'s layout row for row
// (conv_bwd.cu's tiles: 64 positions by 64 o, 64 or 128 channels, or 64 o).
//
// The same tile is read by wgmma two ways:
//   * K-major (the reduction runs along D, e.g. Q and K in S = Q·Kᵀ): one
//     k16 step is 32 bytes of every row; step kk starts 32·kk bytes into
//     its box, the next 8-row group is 8 rows further (SBO).
//   * MN-major (the reduction runs along the 64 rows, e.g. V in O += P·V,
//     K in dq += dS·K, Q in dk += dSᵀ·Q, and both operands of K2's
//     gw += gᵀ·x): one k16 step is 16 rows; the operand's transpose bit
//     is set; SBO steps 8 rows, LBO steps from one 64-column box to the
//     next.
// So no transposed copy of any tile is made.
//
// The accumulator of m64nN.f32 (and the register A operand made from it):
// thread `lane` of warp `w` holds rows 16w + lane/4 and 16w + lane/4 + 8;
// d[4j + 2·half + e] sits at row (16w + lane/4 + 8·half), column
// 8j + 2·(lane % 4) + e. A row's max and sum reduce over the 4 threads of
// a quad with two __shfl_xor_sync. The bf16 A operand of k step kk is
// d[8kk .. 8kk + 7] packed in pairs, so the score tile never leaves the
// registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRows = 64;        // rows of a tile, and M of every wgmma
constexpr int kThreads = 128;    // one warpgroup
constexpr float kNegInf = -1e30f;  // the Pallas kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Geometry of one [64, D] bf16 tile.
template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kBoxCols = D < 64 ? D : 64;   // columns of one TMA box
  static constexpr int kBoxes = D / kBoxCols;        // 2 at D = 128, else 1
  static constexpr int kRowBytes = 2 * kBoxCols;     // = the swizzle span
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;  // the whole tile
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kSbo = 8 * kRowBytes / 16;  // next 8 rows, 16 B units
  static constexpr uint32_t kLbo = kBoxBytes / 16;      // next 64-col box (MN-major)
};

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled tensor map over a bf16 array of `rank` dimensions, innermost
// first: dims, byte strides of dims 1.. (multiples of 16), box and swizzle.
// Coordinates out of range, negative ones too, read as zeros.
inline cudaError_t encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                               const cuuint64_t* dims, const cuuint64_t* strides,
                               const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of one [batch, seq, heads, d] bf16 operand with unit stride
// along d and element strides (sb, st, sh): dims (d, heads, seq, batch),
// byte strides (h, t, b), box (min(d, 64), 1, 64, 1) with the swizzle of
// Tile<d>. Rows past seq read as zeros. The base must be 16 B aligned and
// each byte stride a multiple of 16 (the wrapper's tma_compatible).
inline cudaError_t encode_operand(CUtensorMap* map, const void* ptr, int batch, int seq,
                                  int heads, int d, long long sb, long long st, long long sh) {
  const int box_cols = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, kRows, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_bf16(map, ptr, 4, dims, strides, box, swizzle);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024 B boundary at or after the dynamic shared memory's start
// (the launch asks for 1024 B more than the tiles need)
__device__ __forceinline__ uint32_t aligned_smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// --- mbarrier ring

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA writes to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a
// stage's k-th use waits with parity k & 1, which flips at each wrap
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows t0 .. t0+63 of head h, batch b into the tile at `dst` (one or two
// boxes); completes on `bar` with Tile<D>::kBytes bytes
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int t0, int h, int b) {
#pragma unroll
  for (int box = 0; box < Tile<D>::kBoxes; ++box)
    tma_load_4d(dst + box * Tile<D>::kBoxBytes, map, bar, box * Tile<D>::kBoxCols, h, t0, b);
}

// --- wgmma descriptors

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFFu) << 32) | (layout << 62);
}

// k16 step kk of a tile read K-major (reduction along D)
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using G = Tile<D>;
  constexpr int kSteps = G::kBoxCols / 16;  // k16 steps in one box
  return make_desc(tile + (kk / kSteps) * G::kBoxBytes + (kk % kSteps) * 32, 1, G::kSbo,
                   G::kLayout);
}

// k16 step kk of a tile read MN-major (reduction along the 64 rows)
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using G = Tile<D>;
  return make_desc(tile + kk * 16 * G::kRowBytes, G::kLbo, G::kSbo, G::kLayout);
}

// --- wgmma synchronisation

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still running (they complete
// in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int P, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[P][N][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(r[p]);
}

// --- the accumulator fragment

// 2^x in one MUFU instruction (ex2.approx.ftz: 2 ulp, denormals flushed;
// exp2f wraps range fix-ups around the same instruction)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a 64 x 64 f32 accumulator rounded to bf16 as the register A operand of
// four k16 steps
__device__ __forceinline__ void to_a_operand(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// the bits of two bf16 hi values, bf16_rn(x) and bf16_rn(y) (x in the low
// half), and of their lo values, bf16_rn(x - hi) and bf16_rn(y - hi); the
// differences are exact in f32 and are not contracted into anything
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
}

// the same operand as kP bf16 planes: kP = 1 one rounding, a[0] as above;
// kP = 2 the split of each f32 value, a[0] = hi = bf16(d) and a[1] = lo =
// bf16(d - hi) (d - hi is exact in f32), as kernels.split_bf16 rounds
template <int kP>
__device__ __forceinline__ void to_a_operand(const float (&d)[32], uint32_t (&a)[kP][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (kP == 2)
        split_pair(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], a[0][kk][r], a[1][kk][r]);
      else
        a[0][kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
    }
}

// two neighbouring values of an output row, as bf16 or f32
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// the output type of a kernel on kP planes: bf16 for bf16 operands, f32
// for split f32 ones
template <int kP>
struct PlaneOut {
  using T = __nv_bfloat16;
};
template <>
struct PlaneOut<2> {
  using T = float;
};

// The products of one k16 step into one accumulator, mma(plane of A, plane
// of B): bf16 (kP = 1) a * b; split f32 (kP = 2) a_hi * b_lo, a_lo * b_hi,
// then a_hi * b_hi (a_lo * b_lo, about 2^-16 of a product, is left out),
// always in this order, so a repeat gives the same bits
template <int kP, typename Mma>
__device__ __forceinline__ void plane_products(Mma&& mma) {
  if constexpr (kP == 2) {
    mma(0, 1);
    mma(1, 0);
  }
  mma(0, 0);
}

// --- wgmma.mma_async (inline PTX)

// d (+)= A B over one k16 step, A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B over one k16 step, A (64 x 16) and B (16 x 128) both K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b));
}

// d += A B over one k16 step, both K-major in shared memory, N = 64 or 128
// by the accumulator's size
__device__ __forceinline__ void wgmma_ss_acc(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  wgmma_ss_m64n64k16(d, desc_a, desc_b, 1);
}
__device__ __forceinline__ void wgmma_ss_acc(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  wgmma_ss_m64n128k16(d, desc_a, desc_b);
}

// d += A B over one k16 step, A (64 x 16) and B (16 x N) both MN-major in
// shared memory (both transpose bits set): the reduction runs along the
// tiles' rows for both operands, as in conv_bwd.cu's filter gradient;
// N = 64 or 128 by the accumulator's size
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1, 1, 1, 1, "
      "1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b));
}

// d += A B over one k16 step, A (64 x 16 bf16) in registers, B (16 x N)
// MN-major in shared memory (transpose bit set); N = 16, 32, 64 or 128
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// acc += A B over one 64-row tile of the reduction (four k16 steps), split
// f32: A's hi and lo planes in registers (to_a_operand<2>), B's at b_hi
// and b_lo ([64, D] tiles read MN-major). The twelve products go into a
// partial accumulator that starts at zero, which is then added into acc
// on the CUDA cores (an f32 add, rounded to nearest): the tensor cores'
// f32 accumulation rounds every wgmma's sum with a bias, so an
// accumulator that summed a whole sequence would lose bits in proportion
// to its length (conv_bwd.cu's kPromoteSteps). The partial covers 64
// columns at a time (two rounds at D = 128), to spare registers.
template <int D>
__device__ __forceinline__ void add_split_product(float (&acc)[D / 2], uint32_t (&a)[2][4][4],
                                                  uint32_t b_hi, uint32_t b_lo) {
  constexpr int kC = D < 64 ? D : 64;  // columns of one partial
#pragma unroll
  for (int c = 0; c < D / kC; ++c) {
    float part[kC / 2];
#pragma unroll
    for (int e = 0; e < kC / 2; ++e) part[e] = 0.f;
    fence_regs(part);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      plane_products<2>([&](int pa, int pb) {
        wgmma_rs<kC>(part, a[pa][kk],
                     desc_mnmajor<kC>((pb ? b_lo : b_hi) + c * Tile<D>::kBoxBytes, kk));
      });
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(a);
#pragma unroll
    for (int e = 0; e < kC / 2; ++e) acc[c * kC / 2 + e] += part[e];
  }
}

// the tensor maps of a kernel's operands, kP after each other for each
// operand (its planes), passed as one __grid_constant__ parameter
template <int N>
struct Maps {
  CUtensorMap m[N];
};

// --- the K/V ring

// Shared-memory map of one CTA: `lead` resident tiles (Q, or Q and dO; K
// and V in the dk/dv kernel), then kStages stages of two streamed tiles
// (K and V; Q and dO in the dk/dv kernel, which calls them k_tile and
// v_tile too), then the barriers: one for the
// resident tiles, kStages "full" (TMA landed) and kStages "empty" (all 128
// threads are done with the stage). Each tile is kP planes, one after the
// other: one bf16 plane, or the hi and lo planes of split f32 (plane p of
// an operand comes through the tensor map after its first, map + p).
template <int D, int kLead, int kStages, int kP = 1>
struct Ring {
  static constexpr int kTile = Tile<D>::kBytes;
  static constexpr int kBarOffset = (kLead + 2 * kStages) * kP * kTile;
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);

  uint32_t base;
  __device__ __forceinline__ uint32_t lead(int i, int p = 0) const {
    return base + (i * kP + p) * kTile;
  }
  __device__ __forceinline__ uint32_t k_tile(int s, int p = 0) const {
    return base + ((kLead + 2 * s) * kP + p) * kTile;
  }
  __device__ __forceinline__ uint32_t v_tile(int s, int p = 0) const {
    return k_tile(s, kP + p);
  }
  __device__ __forceinline__ uint32_t lead_bar() const { return base + kBarOffset; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOffset + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + kBarOffset + 8 * (1 + kStages + s);
  }

  // thread 0: every barrier; the caller syncs the CTA after
  __device__ __forceinline__ void init() const {
    mbar_init(lead_bar(), 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kThreads);
    }
    fence_barrier_init();
  }

  // thread 0: the resident tiles, one tensor map each (kP maps, one a
  // plane), at rows t0..
  __device__ __forceinline__ void load_lead(const CUtensorMap* const (&maps)[kLead], int t0,
                                            int h, int b) const {
    mbar_expect_tx(lead_bar(), kLead * kP * kTile);
#pragma unroll
    for (int i = 0; i < kLead; ++i)
#pragma unroll
      for (int p = 0; p < kP; ++p) load_tile<D>(lead(i, p), maps[i] + p, lead_bar(), t0, h, b);
  }

  // thread 0: the K and V tiles at rows t0.. into stage s
  __device__ __forceinline__ void load_kv(int s, const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          int t0, int h, int b) const {
    mbar_expect_tx(full(s), 2 * kP * kTile);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      load_tile<D>(k_tile(s, p), kmap + p, full(s), t0, h, b);
      load_tile<D>(v_tile(s, p), vmap + p, full(s), t0, h, b);
    }
  }

  // every thread, after its last wgmma on stage s (tile i) has completed:
  // release the stage; thread 0 then refills it with tile i + kStages, the
  // one at rows t_first + (i + kStages)·64 (the ring's tile 0 starts at
  // row t_first)
  __device__ __forceinline__ void release(int i, int n_tiles, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap, int h, int b,
                                          int t_first = 0) const {
    const int s = i % kStages;
    mbar_arrive(empty(s));
    if (threadIdx.x == 0 && i + kStages < n_tiles) {
      mbar_wait(empty(s), (i / kStages) & 1);
      load_kv(s, kmap, vmap, t_first + (i + kStages) * kRows, h, b);
    }
    __syncwarp();
  }
};

}  // namespace sm90
