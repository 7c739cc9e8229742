// Weight-only int8 matrix product for the Whisper decoder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_int8_matmul_kernel`
// (modular_audio_pipeline_tpu/ops/quant.py:39, launched by
// `_int8_matmul_pallas` at :54 through `int8_matmul` at :69), together with
// the bias add and the cast that the JAX `_proj`
// (modular_audio_pipeline_tpu/models/whisper/model.py:77-88) applies to its
// result.
//
// Computes out[M, N] = round_to(out_type, (sum_k bf16(x)[m, k] * wq[k, n])
// * ws[n] + f32(bias[n])): x is rounded to bf16 on load whatever its type
// (the TPU wrapper casts it), the int8 codes are exact in bf16, every product
// is exact in f32 and summed in f32; then the per-column scale multiplies the
// finished sum, the bias is added in f32 (two roundings, never one fused
// multiply-add) and the value is rounded once to the output type.
//
// Bounds on an H100. The decode step (M = 80 rows: 16 windows x 5 beams)
// reads every weight once and reuses it for 80 rows only: bytes bound it
// (the logits head, K 1280, N 51968: 66.5 MB of codes + 16.6 MB of f32
// output, 25 us at 3.35 TB/s). The cross K/V product (M = 24000) and the
// teacher-forced alignment pass (M = windows x tokens) are bound by their
// operations. Stored as int8 the weights are half the bytes of bf16: that
// halving is the point of the kernel, so the codes reach the multiplier
// without a dequantised copy ever landing in device memory.
//
// Three kernels, picked by `make_plan` from the shape:
//
// `int8_matmul_decode` (bf16 x, M <= 128, N % 16 == 0, K % 8 == 0). The
// product runs as out^T = wq^T x^T on `wgmma` with the roles swapped: 64
// weight columns are its M, the x rows (padded to 16, 32, 80 or 128) its N,
// the codes, converted to bf16 in registers (the 2^23 exponent trick: one
// byte permute and one add per code), are the register A operand, and the
// x tile is B from shared memory (K-major, 128-byte swizzle). A thread's A
// fragment needs two neighbouring codes of four K rows, so logical row
// g + 8h of each warp's 16 is real column 2g + h: four 16-bit loads per
// k16 step, and the accumulator holds pairs of neighbouring output columns.
// x rows and code rows come by 16-byte `cp.async` into a ring of stages of
// 64 K rows. Two configurations:
//   - 64-column CTAs of one warpgroup: few rows and narrow outputs leave
//     too few column tiles for 132 SMs, so K is split across the CTAs of a
//     thread-block cluster (a power of two up to 8). After the main loop
//     each rank writes its partial tile into its own (now idle) ring and,
//     after one cluster barrier, sends each rank the rows it owns with one
//     bulk copy into that rank's ring, completing on its `mbarrier`; the
//     owner adds the partial sums in rank order and applies the epilogue.
//     No workspace, no second launch, no atomics: the same bits every run.
//   - wide outputs (the logits head): four warpgroups of two 64-column
//     tiles, one CTA per SM over an even share of the columns (51968 = 130
//     CTAs of 400), no split.
// In both, each warpgroup converts one k16 step while the previous one
// multiplies.
//
// `int8_matmul_wide` (bf16 x, M > 128, same alignment): the cross K/V
// (M = 24000) and the alignment pass (M = windows x tokens). `wgmma`
// m64n64k16 with a CTA of two warpgroups over 128 rows x 128 columns; x
// tiles come by TMA (128-byte swizzle) as the K-major A operand, the codes
// by TMA into a staging tile that all 256 threads convert into a swizzled
// bf16 tile, the MN-major B operand (as the flash kernel uses V); the
// products of stage s run while stage s + 1 is converted. Five-stage ring.
//
// `int8_matmul_generic` (f32 x, ragged N or K, unaligned pointers): the first
// `mma.sync` design, with one stage in flight and byte loads for ragged N,
// without its split along K. Off the main path (large-v3-turbo runs bf16 at
// N and K multiples of 16); it has the same epilogue.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the 80-row
// projections take 0.009-0.018 ms against 0.005-0.010 ms for bf16
// `torch.matmul`, the head 0.052 ms (bound 0.025), the cross K/V 0.29 ms
// (bound 0.080). What holds each back is in PERF.md section 6.

#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encode function is fetched at run time

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

constexpr int kNoBias = -1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// int8 code (as its unsigned byte) -> float, exactly: 0x4B000000 is 2^23,
// whose float has an ulp of 1, so the byte (code + 128) lands in the mantissa.
__device__ __forceinline__ float code_to_float(uint32_t byte) {
  return __uint_as_float(0x4B000080u ^ byte) - 8388736.0f;  // 2^23 + 128
}

// Byte J of a word of four codes already xor-ed with 0x80808080, as a float.
template <int J>
__device__ __forceinline__ float code_of(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | J)) - 8388736.0f;
}

// Two floats that are exact in bf16 (small integers) as one bf16x2 word: the
// high halves, low half = lo.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The epilogue of every kernel: the finished f32 sum times the scale, plus
// the bias, each rounded in f32 (explicit intrinsics: the compiler must not
// contract them into one fused multiply-add, which rounds once).
__device__ __forceinline__ float finish(float acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(acc, scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

__device__ __forceinline__ float bias_at(const void* bias, int type, int n) {
  if (type == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
  if (type == kF32) return static_cast<const float*>(bias)[n];
  return 0.f;
}

__device__ __forceinline__ void store_value(void* out, int type, size_t i, float v) {
  if (type == kBF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else static_cast<float*>(out)[i] = v;
}

// Eight consecutive columns of one row: scales sc[0..7] and bias words
// bi[c..c+7] (of bias_type), rounding, and one 16-byte (bf16) or two
// 16-byte (f32) stores at out + off. off % 8 == 0, every pointer 16-byte aligned.
__device__ __forceinline__ void finish8(const float (&acc)[8], const float* sc, const void* bi,
                                        int bias_type, int c, void* __restrict__ out, int out_type,
                                        size_t off) {
  const bool has_bias = bias_type != kNoBias;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = finish(acc[i], sc[i], bias_at(bi, bias_type, c + i), has_bias);
  if (out_type == kBF16) {
    uint4 w;
    w.x = pack_bf16(v[0], v[1]);
    w.y = pack_bf16(v[2], v[3]);
    w.z = pack_bf16(v[4], v[5]);
    w.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) = w;
  } else {
    float* o = static_cast<float*>(out) + off;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !ok (src-size 0: nothing is read, `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

// ---------------------------------------------------------------------------
// wgmma, mbarrier and TMA helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier has left the phase of parity `parity`. A barrier
// that never flips (a lost TMA load) traps after about 2^20 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls > (1u << 20)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The shared::cluster address of the same location in cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows with the
// 128-byte swizzle, groups of 8 rows 1024 bytes apart (the stride field);
// the leading offset is unused at one swizzle row of width.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t desc = 0;
  desc |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>(1) << 16;
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;
  desc |= static_cast<uint64_t>(1) << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64x64] (+)= A (shared, K-major) * B (shared, MN-major), per warpgroup
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x N] (+)= a[64 x 16] (registers) * B[16 x N] (shared memory, K-major), per warpgroup
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d);

template <> __device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7" 
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15" 
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39" 
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63" 
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Decode regime: M <= 128, wgmma with the roles swapped, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kDecBK = 64;          // K rows per ring stage: one 128-byte swizzle row of x
constexpr int kDecMaxRows = 128;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kDecMaxCols = 512;    // columns of one CTA of the wide-output configuration

// NR: x rows, padded (the wgmma N); TPW: 64-column tiles per warpgroup; NWG:
// warpgroups. A CTA owns up to 64 * TPW * NWG columns; warpgroup w takes its
// tiles w, w + NWG, ... NWG == 1 is the split-K configuration (64 columns,
// a cluster along K); NWG > 1 the wide-output one (no split).
template <int NR, int TPW, int NWG>
struct Dec {
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kCols = 64 * TPW * NWG;
  static constexpr int CS = kCols + 16;         // code row stride, bytes: 2 * CS % 128 == 32
  static constexpr int kXBytes = NR * 128;      // x tile, 128-byte swizzle
  static constexpr int kStage = kXBytes + kDecBK * CS;
  static_assert(kStage % 1024 == 0, "x tiles must stay 1024-byte aligned");
  // split K: as deep a ring as leaves two CTAs on an SM; wide outputs: one CTA
  static constexpr int kFit = 108 * 1024 / kStage;
  static constexpr int kStages = NWG == 1 ? (kFit > 8 ? 8 : kFit) : 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kScales = kRing;              // kCols f32 scales, then kCols bias words
  static constexpr int kSmem = kScales + 8 * kCols + 1024;
  // After the main loop the ring holds this rank's partial tile [NR][kCols]
  // f32 and, behind it, the rows it owns as received from every rank.
  static constexpr int kRecv = NR * kCols * 4;
  static_assert(NWG > 1 || kRecv + (NR + kMaxCluster) * kCols * 4 <= kRing, "ring too small");
};

// grid.x = column ranges of `cols` x cluster size; the cluster (cs x 1 x 1)
// splits K: rank r takes [r * k_slice, min(K, (r + 1) * k_slice)).
//
// The product is out^T = wq^T x^T: wgmma m64nNRk16 with 64 weight columns as
// its M, the converted codes as the register A operand, and the x tile
// (rows as N, K-major, 128-byte swizzle) as B from shared memory. Logical
// row g + 8h of warp wi's 16 is real column 16wi + 2g + h of the tile, so a
// thread's A fragment is two neighbouring codes of four K rows (four 16-bit
// loads), and its accumulator holds pairs of neighbouring output columns.
template <int NR, int TPW, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
int8_matmul_decode(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ ws, const void* __restrict__ bias,
                   void* __restrict__ out, int M, int K, int N, int cols, int k_slice,
                   int bias_type, int out_type) {
  using D = Dec<NR, TPW, NWG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t red_bar;  // split K: this rank's rows have arrived
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / cs) * cols;
  const int n_end = min(N, n0 + cols);
  const int kb = rank * k_slice;
  const int ke = min(K, kb + k_slice);
  const int nst = ke > kb ? (ke - kb + kDecBK - 1) / kDecBK : 0;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  const float* sc = reinterpret_cast<const float*>(gbase + D::kScales);  // scale of column n0 + i
  const uint8_t* bi = gbase + D::kScales + 4 * D::kCols;                // bias, bias_type words

  // Stage s of this CTA's K slice into ring slot s % kStages: x rows in the
  // 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), code rows
  // padded. K % 8 == 0 and k_slice % 64 == 0, so an 8-wide x chunk is inside or outside [kb, ke) as
  // a whole; n_end % 16 == 0 does the same for a 16-wide code chunk.
  // Everything outside arrives as zeros.
  auto load_stage = [&](int s) {
    const int k0 = kb + s * kDecBK;
    const uint32_t xs = base + (s % D::kStages) * D::kStage;
    const uint32_t cb = xs + D::kXBytes;
    for (int i = tid; i < NR * 8; i += D::kThreads) {
      const int r = i >> 3;
      const int c = i & 7;
      const int k = k0 + 8 * c;
      const bool ok = r < M && k < ke;
      cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4), ok ? x + static_cast<size_t>(r) * K + k : x,
                 ok);
    }
    for (int i = tid; i < kDecBK * (D::kCols / 16); i += D::kThreads) {
      const int r = i / (D::kCols / 16);
      const int c = i % (D::kCols / 16);
      const int k = k0 + r;
      const int n = n0 + 16 * c;
      const bool ok = k < ke && n < n_end;
      cp_async16(cb + r * D::CS + 16 * c, ok ? wq + static_cast<size_t>(k) * N + n : wq, ok);
    }
  };

  // Prologue: this CTA's scales and bias, and the ring's first stages (the
  // scales ride in the first group: they are in before any product).
  constexpr int kAhead = D::kStages - 1;  // stages in flight
  if (NWG == 1 && cs > 1 && tid == 0) {
    // the partial rows this rank owns arrive from every rank (itself included)
    const int rows = min(M, NR);
    const int R = (rows + cs - 1) / cs;
    const int mine = max(0, min(rows, (rank + 1) * R) - rank * R);
    mbar_init(smem_u32(&red_bar), 1);
    mbar_arrive_expect_tx(smem_u32(&red_bar), static_cast<uint32_t>(cs * mine * D::kCols * 4));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const int bias_bytes = bias_type == kBF16 ? 2 : 4;
    for (int i = tid; i < D::kCols / 4; i += D::kThreads) {  // 16-byte chunks of scales
      const bool ok = n0 + 4 * i < n_end;
      cp_async16(base + D::kScales + 16 * i, ok ? ws + n0 + 4 * i : ws, ok);
    }
    if (bias_type != kNoBias) {
      const int per = 16 / bias_bytes;
      for (int i = tid; i < D::kCols / per; i += D::kThreads) {
        const bool ok = n0 + per * i < n_end;
        cp_async16(base + D::kScales + 4 * D::kCols + 16 * i,
                   ok ? static_cast<const uint8_t*>(bias) + static_cast<size_t>(n0 + per * i) *
                                                             bias_bytes
                      : bias,
                   ok);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();  // empty groups keep the count of groups in step
  }

  float acc[TPW][NR / 2];  // the first product of the slice writes it (scale_d = 0)

  // The A fragments of k16 step kk of stage s for tile u, from the codes in
  // shared memory: rows 2t, 2t+1 (registers 0, 1) and 2t+8, 2t+9 (2, 3) of
  // the step; the low byte of each 16-bit load is logical row g, the high
  // byte row g + 8.
  auto make_a = [&](uint32_t (&r)[4], int slot, int kk, int u) {
    const uint8_t* c = gbase + slot * D::kStage + D::kXBytes + (16 * kk + 2 * t) * D::CS +
                       64 * (wg + NWG * u) + 16 * wi + 2 * g;
    const uint32_t r0 = *reinterpret_cast<const uint16_t*>(c) ^ 0x8080u;
    const uint32_t r1 = *reinterpret_cast<const uint16_t*>(c + D::CS) ^ 0x8080u;
    const uint32_t r8 = *reinterpret_cast<const uint16_t*>(c + 8 * D::CS) ^ 0x8080u;
    const uint32_t r9 = *reinterpret_cast<const uint16_t*>(c + 9 * D::CS) ^ 0x8080u;
    r[0] = pack_exact(code_of<0>(r0), code_of<0>(r1));
    r[1] = pack_exact(code_of<1>(r0), code_of<1>(r1));
    r[2] = pack_exact(code_of<0>(r8), code_of<0>(r9));
    r[3] = pack_exact(code_of<1>(r8), code_of<1>(r9));
  };

  // Each warpgroup converts one k16 step while the previous one multiplies
  // (two A register sets); a stage ends with its products done, so stage s
  // refills the slot of stage s - 1.
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kAhead - 1>();                                   // stage s: this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma
    __syncthreads();  // everyone's; and every warpgroup is done with slot s - 1
    if (s + kAhead < nst) load_stage(s + kAhead);
    cp_async_commit();
    const int slot = s % D::kStages;
    const uint64_t db = smem_desc(base + slot * D::kStage);
    uint32_t a[2][TPW][4];
#pragma unroll
    for (int kk = 0; kk < kDecBK / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < TPW; ++u) make_a(a[kk & 1][u], slot, kk, u);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < TPW; ++u)
        wgmma_rs<NR>(acc[u], a[kk & 1][u], db + 2 * kk, s > 0 || kk > 0);  // +32 bytes per k16
      wgmma_commit();
      wgmma_wait<1>();  // step kk - 1 is done: its A registers may be written again
    }
    wgmma_wait<0>();
  }
  cp_async_wait<0>();  // the scales, even when the slice was empty
  __syncthreads();
#pragma unroll
  for (int u = 0; u < TPW; ++u) fence_regs(acc[u]);  // read below, after the last wait
  if (nst == 0) {  // an empty slice adds zeros
#pragma unroll
    for (int u = 0; u < TPW; ++u)
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) acc[u][i] = 0.f;
  }

  // acc[u][4j + e] and acc[u][4j + 2 + e]: output row 8j + 2t + e, columns
  // n and n + 1 of tile wg + NWG * u
  const bool has_bias = bias_type != kNoBias;
  if (cs == 1) {
#pragma unroll
    for (int u = 0; u < TPW; ++u) {
      const int nl = 64 * (wg + NWG * u) + 16 * wi + 2 * g;
      const int n = n0 + nl;
      if (n >= n_end) continue;
      const float s0 = sc[nl], s1 = sc[nl + 1];
      const float b0 = bias_at(bi, bias_type, nl), b1 = bias_at(bi, bias_type, nl + 1);
#pragma unroll
      for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + 2 * t + e;
          if (m >= M) continue;
          const float v0 = finish(acc[u][4 * j + e], s0, b0, has_bias);
          const float v1 = finish(acc[u][4 * j + 2 + e], s1, b1, has_bias);
          const size_t i = static_cast<size_t>(m) * N + n;
          if (out_type == kBF16)
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + i) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(v0, v1);
        }
      }
    }
    return;
  }

  // Split K (one warpgroup): rank r owns output rows [r * R, (r + 1) * R).
  // Each rank writes its partial tile into its own ring, and after a cluster
  // barrier (every rank is past its main loop, so every ring is free) sends
  // each owner its rows with one bulk copy into the owner's ring
  // (recv[source rank][row][column]), completing on the owner's barrier.
  // The owner adds the ranks' partial sums in rank order, then scale, bias,
  // rounding, one store. No atomics, the same bits on every run.
  if constexpr (NWG == 1) {
    const int rows = min(M, NR);
    const int R = (rows + cs - 1) / cs;
    float* tile = reinterpret_cast<float*>(gbase);
#pragma unroll
    for (int u = 0; u < TPW; ++u)
#pragma unroll
      for (int j = 0; j < NR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(tile + (8 * j + 2 * t + e) * D::kCols + 64 * u + 16 * wi +
                                     2 * g) = make_float2(acc[u][4 * j + e], acc[u][4 * j + 2 + e]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the copies
    cluster.sync();
    if (tid == 0) {
      for (int o = 0; o < cs; ++o) {
        const int rows_o = min(rows, (o + 1) * R) - o * R;
        if (rows_o <= 0) continue;
        const uint32_t src = base + static_cast<uint32_t>(o * R * D::kCols * 4);
        const uint32_t dst = map_rank(base + D::kRecv + rank * R * D::kCols * 4, o);
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(dst),
            "r"(src), "r"(rows_o * D::kCols * 4), "r"(map_rank(smem_u32(&red_bar), o))
            : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    mbar_wait(smem_u32(&red_bar), 0);
    const float* recv = reinterpret_cast<const float*>(gbase + D::kRecv);
    const int my_rows = min(rows, (rank + 1) * R) - rank * R;
    for (int q = tid; q < my_rows * (D::kCols / 8); q += D::kThreads) {
      const int lr = q / (D::kCols / 8);
      const int c8 = 8 * (q % (D::kCols / 8));
      if (n0 + c8 >= n_end) continue;
      const float* p = recv + lr * D::kCols + c8;
      float4 lo = *reinterpret_cast<const float4*>(p);
      float4 hi = *reinterpret_cast<const float4*>(p + 4);
      for (int r = 1; r < cs; ++r) {
        const float* pr = p + r * R * D::kCols;
        const float4 va = *reinterpret_cast<const float4*>(pr);
        const float4 vb = *reinterpret_cast<const float4*>(pr + 4);
        lo.x += va.x; lo.y += va.y; lo.z += va.z; lo.w += va.w;
        hi.x += vb.x; hi.y += vb.y; hi.z += vb.z; hi.w += vb.w;
      }
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      finish8(v, sc + c8, bi, bias_type, c8, out, out_type,
              static_cast<size_t>(rank * R + lr) * N + n0 + c8);
    }
    // the copies out of this CTA's memory have read it before it is released
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Wide-M regime: wgmma, TMA
// ---------------------------------------------------------------------------

constexpr int kWBM = 128;  // rows per CTA: two warpgroups of 64
constexpr int kWBN = 128;  // columns per CTA: two wgmma n64 halves
constexpr int kWBK = 64;   // K per stage: one 128-byte swizzle row of bf16
constexpr int kWStages = 5;
constexpr int kWThreads = 256;
constexpr int kWXBytes = kWBM * kWBK * 2;  // 16 KB
constexpr int kWCBytes = kWBK * kWBN;      // 8 KB of codes
constexpr int kWBBytes = kWBK * kWBN * 2;  // 16 KB of converted codes, two [64 k][64 n] halves
constexpr int kWSmem = kWStages * (kWXBytes + kWCBytes) + 2 * kWBBytes + 1024;

// map_x: x [M, K] bf16, boxes of [128 rows, 64 k], 128-byte swizzle;
// map_w: wq [K, N] int8, boxes of [64 k, 128 n]. grid (ceil(N/128), ceil(M/128)).
__global__ void __launch_bounds__(kWThreads, 1)
int8_matmul_wide(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ ws, const void* __restrict__ bias,
                 void* __restrict__ out, int M, int K, int N, int bias_type, int out_type) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t codes0 = base + kWStages * kWXBytes;
  const uint32_t b0 = codes0 + kWStages * kWCBytes;
  const int n0 = blockIdx.x * kWBN;
  const int m0 = blockIdx.y * kWBM;
  const int nst = (K + kWBK - 1) / kWBK;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // x and code tiles of stage s; K past its end arrives as zeros (and still
  // counts towards the barrier's bytes), so the tail adds nothing.
  auto issue = [&](int s) {
    const int slot = s % kWStages;
    const uint32_t bar = smem_u32(&full[slot]);
    mbar_arrive_expect_tx(bar, kWXBytes + kWCBytes);
    tma_load_2d(base + slot * kWXBytes, &map_x, bar, s * kWBK, m0);
    tma_load_2d(codes0 + slot * kWCBytes, &map_w, bar, n0, s * kWBK);
  };
  if (tid == 0) {
    for (int s = 0; s < kWStages - 2 && s < nst; ++s) issue(s);
  }

  // The first product writes the accumulator (scale_d = 0): no other
  // instruction may define it while products on it are in flight, or the
  // compiler serialises them.
  float acc[2][32];
  for (int s = 0; s < nst; ++s) {
    // The products of stage s - 2 are done (both warpgroups, after the
    // barrier): its x slot and its converted-code buffer may be refilled.
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && s + kWStages - 2 < nst) issue(s + kWStages - 2);
    const int slot = s % kWStages;
    mbar_wait(smem_u32(&full[slot]), (s / kWStages) & 1);

    // codes -> bf16, into the swizzled MN-major tile: row k of half h holds
    // columns 64h .. 64h + 63, 16-byte chunk c at (c ^ (k % 8)).
    const uint8_t* stage_codes = gbase + kWStages * kWXBytes + slot * kWCBytes;
    uint8_t* bbuf = gbase + kWStages * (kWXBytes + kWCBytes) + (s & 1) * kWBBytes;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = e * kWThreads + tid;  // 512 chunks of 16 codes
      const int k = q >> 3;
      const int c16 = q & 7;
      const uint4 w = *reinterpret_cast<const uint4*>(stage_codes + k * kWBN + 16 * c16);
      const uint32_t u0 = w.x ^ 0x80808080u, u1 = w.y ^ 0x80808080u;
      const uint32_t u2 = w.z ^ 0x80808080u, u3 = w.w ^ 0x80808080u;
      uint4 lo, hi;
      lo.x = pack_exact(code_of<0>(u0), code_of<1>(u0));
      lo.y = pack_exact(code_of<2>(u0), code_of<3>(u0));
      lo.z = pack_exact(code_of<0>(u1), code_of<1>(u1));
      lo.w = pack_exact(code_of<2>(u1), code_of<3>(u1));
      hi.x = pack_exact(code_of<0>(u2), code_of<1>(u2));
      hi.y = pack_exact(code_of<2>(u2), code_of<3>(u2));
      hi.z = pack_exact(code_of<0>(u3), code_of<1>(u3));
      hi.w = pack_exact(code_of<2>(u3), code_of<3>(u3));
      uint8_t* row = bbuf + (c16 >> 2) * (kWBBytes / 2) + k * 128;
      const int c8 = 2 * (c16 & 3);
      *reinterpret_cast<uint4*>(row + ((c8 ^ (k & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (k & 7)) << 4)) = hi;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();

    const uint64_t da = smem_desc(base + slot * kWXBytes + wg * 64 * 128);
    const uint64_t db = smem_desc(b0 + (s & 1) * kWBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      // A: 32 bytes along the swizzle row per k16; B: 16 rows of 128 bytes
      const int acc_in = s > 0 || kk > 0;
      wgmma_m64n64k16_ss(acc[0], da + 2 * kk, db + 128 * kk, acc_in);
      wgmma_m64n64k16_ss(acc[1], da + 2 * kk, db + ((kWBBytes / 2) >> 4) + 128 * kk, acc_in);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // accumulator: rows 16 * warp + g (+8), columns 8j + 2t, 8j + 2t + 1
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool has_bias = bias_type != kNoBias;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 64 * h + 8 * j + 2 * (lane & 3);
      if (n >= N) continue;
      const float2 s = *reinterpret_cast<const float2*>(ws + n);
      const float bb0 = bias_at(bias, bias_type, n), bb1 = bias_at(bias, bias_type, n + 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        if (r >= M) continue;
        const float v0 = finish(acc[h][4 * j + 2 * e], s.x, bb0, has_bias);
        const float v1 = finish(acc[h][4 * j + 2 * e + 1], s.y, bb1, has_bias);
        const size_t i = static_cast<size_t>(r) * N + n;
        if (out_type == kBF16) {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + i) = pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(v0, v1);
        }
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, fetched through the CUDA runtime, so the
// library links against nothing but the runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A row-major [rows, cols] matrix as a 2-D map; elements past either edge
// are read as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
              int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Generic kernel: f32 x, ragged N or K, unaligned pointers
// ---------------------------------------------------------------------------

constexpr int kGenThreads = 128;  // four warps
constexpr int kGenBK = 64;        // depth of one shared-memory stage
constexpr int kXPad = 8;          // bf16 elements: rows 144 bytes apart, conflict-free fragments
constexpr int kCPad = 16;         // bytes: keeps code rows 16-byte aligned and the banks apart

// Two neighbouring x values along K as one bf16x2 word (low half = lower k),
// zero beyond K and beyond row M.
template <typename T>
__device__ __forceinline__ uint32_t load_x_pair(const T* __restrict__ x, int m, int k, int M,
                                                int K, bool pairs) {
  if (m >= M || k >= K) return 0u;
  const T* p = x + static_cast<size_t>(m) * K + k;
  if (pairs && k + 1 < K) {
    if constexpr (sizeof(T) == 2) {
      return *reinterpret_cast<const uint32_t*>(p);  // already bf16x2
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      return pack_bf16(v.x, v.y);
    }
  }
  const float lo = to_float(p[0]);
  const float hi = (k + 1 < K) ? to_float(p[1]) : 0.f;
  return pack_bf16(lo, hi);
}

// One block of four warps owns 16*MT rows by 32*NW columns and walks all of
// K in stages of 64; the next stage's global loads are in flight during this
// stage's products.
template <typename T, int MT, int NW, bool VEC>
__global__ void __launch_bounds__(kGenThreads)
int8_matmul_generic(const T* __restrict__ x, const uint8_t* __restrict__ wq,
                    const float* __restrict__ ws, const void* __restrict__ bias,
                    void* __restrict__ out, int M, int K, int N, bool x_pairs, int bias_type,
                    int out_type) {
  constexpr int BM = 16 * MT;
  constexpr int BN = 32 * NW;
  constexpr int XS = kGenBK + kXPad;
  constexpr int CS = BN + kCPad;
  constexpr int XPT = BM * kGenBK / 2 / kGenThreads;
  constexpr int CVT = kGenBK * BN / 16 / kGenThreads;
  static_assert(BM * kGenBK / 2 % kGenThreads == 0 && kGenBK * BN / 16 % kGenThreads == 0,
                "tile/threads");

  __shared__ __align__(16) __nv_bfloat16 xs[BM][XS];
  __shared__ __align__(16) uint8_t cs[kGenBK][CS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[MT][NW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint32_t xr[XPT];
  int4 cv[CVT];

  auto load_global = [&](int k0) {
#pragma unroll
    for (int e = 0; e < XPT; ++e) {
      const int idx = e * kGenThreads + tid;
      xr[e] = load_x_pair(x, m0 + idx / (kGenBK / 2), k0 + 2 * (idx % (kGenBK / 2)), M, K,
                          x_pairs);
    }
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < CVT; ++e) {
        const int idx = e * kGenThreads + tid;
        const int k = k0 + idx / (BN / 16);
        const int n = n0 + (idx % (BN / 16)) * 16;
        cv[e] = (k < K && n < N)  // N % 16 == 0: a vector is inside or outside as a whole
                    ? *reinterpret_cast<const int4*>(wq + static_cast<size_t>(k) * N + n)
                    : make_int4(0, 0, 0, 0);
      }
    }
  };

  auto store_shared = [&](int k0) {
#pragma unroll
    for (int e = 0; e < XPT; ++e) {
      const int idx = e * kGenThreads + tid;
      *reinterpret_cast<uint32_t*>(&xs[idx / (kGenBK / 2)][2 * (idx % (kGenBK / 2))]) = xr[e];
    }
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < CVT; ++e) {
        const int idx = e * kGenThreads + tid;
        *reinterpret_cast<int4*>(&cs[idx / (BN / 16)][(idx % (BN / 16)) * 16]) = cv[e];
      }
    } else {
      for (int idx = tid; idx < kGenBK * BN; idx += kGenThreads) {
        const int k = k0 + idx / BN;
        const int n = n0 + idx % BN;
        cs[idx / BN][idx % BN] =
            (k < K && n < N) ? wq[static_cast<size_t>(k) * N + n] : static_cast<uint8_t>(0);
      }
    }
  };

  load_global(0);
  for (int k0 = 0; k0 < K; k0 += kGenBK) {
    store_shared(k0);
    __syncthreads();
    if (k0 + kGenBK < K) load_global(k0 + kGenBK);

#pragma unroll
    for (int kk = 0; kk < kGenBK; kk += 16) {
      uint32_t b[NW][2];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint8_t* c = &cs[kk + 2 * t][(warp * NW + j) * 8 + g];
        b[j][0] = pack_bf16(code_to_float(c[0]), code_to_float(c[CS]));
        b[j][1] = pack_bf16(code_to_float(c[8 * CS]), code_to_float(c[9 * CS]));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* a = &xs[i * 16 + g][kk + 2 * t];
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + 8 * XS);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + 8 * XS + 8);
#pragma unroll
        for (int j = 0; j < NW; ++j) mma_bf16(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

  // C fragment: rows g and g+8, columns 2t and 2t+1 of each 16 x 8 tile
  const bool has_bias = bias_type != kNoBias;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int n = n0 + (warp * NW + j) * 8 + 2 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (n + c >= N) continue;
      const float s = ws[n + c];
      const float b = bias_at(bias, bias_type, n + c);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + i * 16 + g + 8 * h;
          if (m < M)
            store_value(out, out_type, static_cast<size_t>(m) * N + n + c,
                        finish(acc[i][j][2 * h + c], s, b, has_bias));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Plans and launchers
// ---------------------------------------------------------------------------

enum : int { kRouteGeneric = 0, kRouteDecode = 1, kRouteWide = 2 };

struct Plan {
  int route;
  int rows;     // decode: x rows padded to the wgmma N (16, 32, 80, 128); generic: row tiles of 16
  int cols;     // decode: columns per CTA; generic: warps' columns / 8
  int cs;       // decode: cluster size, CTAs along K
  int k_slice;  // decode: K per cluster rank, a multiple of kDecBK
};

// K per rank when K is split `cs` ways: ceil(K / cs) rounded up to a stage.
int k_slice_of(int k, int cs) { return ((k + cs - 1) / cs + kDecBK - 1) / kDecBK * kDecBK; }

// The kernel and tiling for a shape.
Plan make_plan(int m, int k, int n, int dtype) {
  Plan p{kRouteGeneric, 1, 1, 1, k};
  const int sms = sm_count();
  if (dtype == kBF16 && n % 16 == 0 && k % 8 == 0) {
    if (m > kDecMaxRows) {
      p.route = kRouteWide;
      return p;
    }
    p.route = kRouteDecode;
    p.rows = m <= 16 ? 16 : m <= 32 ? 32 : m <= 80 ? 80 : 128;
    const int tiles = (n + 63) / 64;
    if (p.rows <= 80 && tiles >= 2 * sms) {
      // wide output (the logits head): one CTA per SM over an even share of
      // the columns, in 16-column units, and no split
      const int units = (n / 16 + sms - 1) / sms;
      p.cols = units * 16 > kDecMaxCols ? kDecMaxCols : units * 16;
      return p;
    }
    // 64-column tiles; too few to fill the card: split K until they do, in
    // clusters of a power of two (they pack into the GPCs; measured faster)
    p.cols = 64;
    int cs = 1;
    while (cs * tiles < sms && cs < kMaxCluster) cs *= 2;
    const int stages = (k + kDecBK - 1) / kDecBK;
    if (cs > stages) cs = stages;
    p.k_slice = k_slice_of(k, cs);
    p.cs = (k + p.k_slice - 1) / p.k_slice;
    return p;
  }
  p.rows = m <= 16 ? 1 : 5;
  const int row_blocks = (m + 16 * p.rows - 1) / (16 * p.rows);
  // wide tiles when they still fill the card: x is re-read from L2 once per column tile
  p.cols = static_cast<long long>(row_blocks) * ((n + 127) / 128) >= 2LL * sms ? 4 : 1;
  return p;
}

template <int NR, int TPW, int NWG>
int launch_decode(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                  int m, int k, int n, const Plan& p, int bias_type, int out_type,
                  cudaStream_t stream) {
  using D = Dec<NR, TPW, NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_matmul_decode<NR, TPW, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, D::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (p.cols > D::kCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(((n + p.cols - 1) / p.cols) * p.cs));
  cfg.blockDim = dim3(D::kThreads);
  cfg.dynamicSmemBytes = D::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_matmul_decode<NR, TPW, NWG>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws), bias, out, m, k, n, p.cols,
      p.k_slice, bias_type, out_type);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// 64-column tiles: one warpgroup; wide outputs: four warpgroups of two tiles
int dispatch_decode(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                    int m, int k, int n, const Plan& p, int bias_type, int out_type,
                    cudaStream_t stream) {
  if (p.cols > 64) {
    if (p.rows == 16)
      return launch_decode<16, 2, 4>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
    if (p.rows == 32)
      return launch_decode<32, 2, 4>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
    if (p.rows == 80)
      return launch_decode<80, 2, 4>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.rows == 16)
    return launch_decode<16, 1, 1>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
  if (p.rows == 32)
    return launch_decode<32, 1, 1>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
  if (p.rows == 80)
    return launch_decode<80, 1, 1>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
  return launch_decode<128, 1, 1>(x, wq, ws, bias, out, m, k, n, p, bias_type, out_type, stream);
}

int launch_wide(const void* x, const void* wq, const void* ws, const void* bias, void* out, int m,
                int k, int n, int bias_type, int out_type, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, kWBM, kWBK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, k, n, kWBK, kWBN,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_matmul_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + kWBN - 1) / kWBN, (m + kWBM - 1) / kWBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int8_matmul_wide<<<grid, kWThreads, kWSmem, stream>>>(map_x, map_w, static_cast<const float*>(ws),
                                                       bias, out, m, k, n, bias_type, out_type);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT, int NW>
int launch_generic(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                   int m, int k, int n, int bias_type, int out_type, cudaStream_t stream) {
  const dim3 grid((m + 16 * MT - 1) / (16 * MT), (n + 32 * NW - 1) / (32 * NW));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const bool x_pairs = k % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(wq);
  const float* sp = static_cast<const float*>(ws);
  if (vec)
    int8_matmul_generic<T, MT, NW, true><<<grid, kGenThreads, 0, stream>>>(
        xp, wp, sp, bias, out, m, k, n, x_pairs, bias_type, out_type);
  else
    int8_matmul_generic<T, MT, NW, false><<<grid, kGenThreads, 0, stream>>>(
        xp, wp, sp, bias, out, m, k, n, x_pairs, bias_type, out_type);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_generic(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                     int m, int k, int n, const Plan& p, int bias_type, int out_type,
                     cudaStream_t stream) {
  if (p.rows == 1 && p.cols == 1)
    return launch_generic<T, 1, 1>(x, wq, ws, bias, out, m, k, n, bias_type, out_type, stream);
  if (p.rows == 1)
    return launch_generic<T, 1, 4>(x, wq, ws, bias, out, m, k, n, bias_type, out_type, stream);
  if (p.cols == 1)
    return launch_generic<T, 5, 1>(x, wq, ws, bias, out, m, k, n, bias_type, out_type, stream);
  return launch_generic<T, 5, 4>(x, wq, ws, bias, out, m, k, n, bias_type, out_type, stream);
}

}  // namespace

// The plan for a shape: writes {route (0 generic, 1 decode, 2 wide), rows,
// columns per CTA, cluster size, K per rank} into plan[0..4] (see Plan).
// Returns 0, or cudaErrorInvalidValue for an empty shape.
extern "C" int int8_matmul_plan(int m, int k, int n, int dtype, int* plan) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(m, k, n, dtype);
  plan[0] = p.route;
  plan[1] = p.rows;
  plan[2] = p.cols;
  plan[3] = p.cs;
  plan[4] = p.k_slice;
  return 0;
}

// x: contiguous [m, k] of `dtype` (kF32 or kBF16); wq: contiguous [k, n] int8;
// ws: [n] f32; bias: [n] of `bias_dtype` (kF32 or kBF16), or null with
// bias_dtype -1; out: contiguous [m, n] of `out_dtype` (kF32 or kBF16).
// Any m, k, n >= 1; bf16 x with n % 16 == 0, k % 8 == 0 and 16-byte aligned
// pointers takes the decode (m <= 128) or the wide kernel, anything else the
// generic one. One launch on `stream`; returns its cudaError_t.
extern "C" int int8_matmul_fwd(const void* x, const void* wq, const void* ws, const void* bias,
                               void* out, int m, int k, int n, int dtype, int bias_dtype,
                               int out_dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != kBF16 && dtype != kF32) || (out_dtype != kBF16 && out_dtype != kF32) ||
      (bias_dtype != kNoBias && bias_dtype != kBF16 && bias_dtype != kF32) ||
      ((bias == nullptr) != (bias_dtype == kNoBias)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p = make_plan(m, k, n, dtype);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                          reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(bias) |
                          reinterpret_cast<uintptr_t>(out);
  if (p.route != kRouteGeneric && (align & 15)) p = make_plan(m, k, n, kF32);
  if (p.route == kRouteDecode)
    return dispatch_decode(x, wq, ws, bias, out, m, k, n, p, bias_dtype, out_dtype, st);
  if (p.route == kRouteWide)
    return launch_wide(x, wq, ws, bias, out, m, k, n, bias_dtype, out_dtype, st);
  if (dtype == kBF16)
    return dispatch_generic<__nv_bfloat16>(x, wq, ws, bias, out, m, k, n, p, bias_dtype,
                                           out_dtype, st);
  return dispatch_generic<float>(x, wq, ws, bias, out, m, k, n, p, bias_dtype, out_dtype, st);
}
