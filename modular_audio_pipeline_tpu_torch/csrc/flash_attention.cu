// Flash attention forward for the Whisper encoder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (modular_audio_pipeline_tpu/ops/attention.py:60, launched by `_flash_call`
// at :103 through `flash_attention` at :132).
//
// Computes o = softmax((q*s) (k*s)^T) v over [B*H, S, D] rows, s = D^-0.25
// (Whisper's split scaling). q*s and k*s are rounded to the input type, as
// the JAX path rounds them to bf16 before its f32-accumulated product; the
// softmax runs online in f32 (running max and sum), the accumulator is f32
// and the output is rounded to the input type.
//
// Three bounds on an H100 at the encoder shape [16, 20, 1500, 64] bf16:
//   operations  4*B*H*S*S*D = 1.84e11 on the tensor cores, 0.186 ms at 989
//               TFLOP/s;
//   exponentials B*H*S*S = 7.2e8 through the special-function unit, 16 per
//               clock per SM: 0.172 ms on 132 SMs at 1.98 GHz, as much as the
//               products need at this head dim;
//   bytes       246 MB of q, k, v and o, 0.073 ms at 3.35 TB/s.
// So the products must run on the tensor cores, and the exponentials must
// overlap them or the kernel takes the sum of the two.
//
// Design (bf16, D = 64: `flash_fwd_tc`). One block per (batch*head, tile of
// 128 queries): two warpgroups of 64 query rows each. K and V tiles of 64
// keys come by TMA into a ring of kStages shared-memory stages (128-byte
// swizzle), signalled by `mbarrier`s: thread 0 keeps the ring kStages - 1
// tiles ahead, a stage is refilled once all eight warps have left it.
// S = Q K^T is `wgmma` m64n64k16 with Q held in registers as the A operand
// (scaled and rounded there, once) and K read from shared memory; the online
// softmax runs on the f32 accumulator in registers; the unnormalised
// probabilities are rounded to bf16 and fed from registers to O += P V
// (`wgmma` m64n64k16 again, V read from shared memory as the MN-major
// operand, so V is never transposed); the row sum is taken from the f32
// probabilities and divides O at the end. The exponential is `ex2.approx`
// with log2(e) folded into the score by one FFMA with the running max.
// The block fits 128 registers a thread and 65 KB of shared memory, so two
// blocks (four warpgroups) share an SM and run out of step: one's
// exponentials and loads overlap another's products. A producer warpgroup
// with `setmaxnreg`, 128-key tiles and one block per SM, with or without
// warpgroups taking turns at the tensor cores, measured 6-15% slower here:
// at D = 64 the products, the exponentials and the L2-to-shared-memory
// stream of K and V each need about the same time, and what decides is how
// many independent warpgroups an SM holds.
//
// The scale D^-0.25 = 2^-1.5 is no power of two, so k*s must be rounded before
// the product. Each K tile is loaded by the 12 query-tile blocks of its head;
// scaling it in shared memory would be paid 12 times and would need a pass
// of generic-proxy stores plus a fence between TMA and `wgmma`. Instead a
// small elementwise pre-pass (`scale_rows`, same stream) writes k*s once into
// scratch that the wrapper allocates (123 MB of traffic, 0.04 ms, counted
// inside the kernel's reported time), and the TMA map reads the scratch.
//
// S = 1500 is no tile multiple and heads are contiguous, so K and V use 3-D
// tensor maps [B*H, S, D]: rows past S are zero-filled on load instead of
// read from the next head; tail keys are set to -inf before the row max; Q
// is loaded and O stored by plain predicated accesses, so a tail tile never
// touches the next head's rows.
//
// f32 inputs, and bf16 at D = 32, take `flash_fwd_fma` on the CUDA cores.
// It is on the serving path (SegmentationNet, f32 at D = 32, [512, 4, 1000,
// 32] per 512-window chunk) and on the training path (the Whisper encoder in
// f32, [8, 20, 1500, 64] at batch 8, 32 launches a step). Its products stay
// f32 FMAs: TF32 would change the JAX package's f32 arithmetic. At the
// segmentation shape 2.62e11 operations take 3.91 ms at the 67 TFLOP/s of
// the f32 CUDA cores, the exponentials 0.49 ms and the bytes 0.31 ms, so it
// is bound by operations, and what keeps the FMA pipes from their rate is
// the shared-memory loads that feed them: with one thread per query, each
// K or V value read from shared memory feeds one FMA, and a thread holds
// q, the accumulator and the scores at once (241 registers at D = 64).
//
// Design (`flash_fwd_fma`, FmaTile below). One block per (batch*head, tile of
// BQ = 128 queries). Each thread owns a register tile: TQ = 8 queries x TK
// keys of a 64-key score tile (TK = 8 at D = 32, 4 at D = 64) and the same 8
// queries x D/(64/TK) columns of the output, so each 16-byte load from shared
// memory feeds 11-16 FMAs (4 with one thread per query). The 64/TK threads
// that share a query row sit in one warp; the row max and the running sum's
// rescale factor come from __shfl_xor_sync among them, and the rounded
// unnormalised probabilities go through a [128][64 + pad] f32 tile in shared
// memory to the threads that own the output columns (the same threads, so the
// factors stay in registers). Q, K and V tiles are copied by `cp.async` (16
// bytes, rows past S zero-filled and never read); the next K/V tile is issued
// as soon as the current one is whole, into the other of two buffers, so its
// load overlaps this tile's arithmetic. Q and each K tile are scaled and
// rounded once in shared memory by the thread that copied them (bf16 lands in
// a staging area and is widened there). Rows of Q, K and V are padded to an
// odd number of 16-byte units, so float4 loads of neighbouring rows fall on
// distinct banks. Keys past S are set to -inf before the row max, and queries
// past S are not stored. Two syncs a tile: one when the tile is whole, one
// when P is.
//
// The tile shape was measured, not derived (`kernel_times.py --fma-shapes`
// times the candidates side by side): 128 x 8 x 8 (128 threads, 254
// registers, no spills, two blocks an SM) at D = 32 and 128 x 8 x 4 (256
// threads, 200 registers, one block an SM) at D = 64 beat 64 queries in
// 4 x 4 register tiles (256 threads, 122-128 registers, two blocks an SM)
// at both shapes: fewer shared-memory loads per FMA outweigh fewer warps.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, [16, 20, 1500, 64] bf16, by
// chip_smoke.py: 0.537 ms a launch with the pre-pass (10.63 ms before this
// design), `scaled_dot_product_attention` 0.497 ms; PERF.md section 6 has
// what separates the two. The CUDA-core route, by kernel_times.py beside a
// checkout with one thread per query: [512, 4, 1000, 32] f32 7.22-7.27 ms
// (10.37-10.44 ms), [8, 20, 1500, 64] f32 2.65-2.66 ms (4.31 ms).

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; the encode function is fetched at run time

namespace {

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, head dim 64
// ---------------------------------------------------------------------------

constexpr int kHD = 64;        // head dim: one 128-byte swizzle row of bf16
constexpr int kWarpgroups = 2; // 64 query rows each
constexpr int kTileM = 64 * kWarpgroups;     // queries per block
constexpr int kTileN = 64;                   // keys per K/V tile
constexpr int kTcThreads = 128 * kWarpgroups;
constexpr int kStages = 4;                   // K/V ring depth
constexpr int kTileBytes = kTileN * kHD * 2; // one K or V tile: 8 KB
constexpr int kTcSmem = kStages * 2 * kTileBytes + 1024;  // + room to align to 1024
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// One [1, kTileN, kHD] box of a [B*H, S, D] map into shared memory; rows past
// S arrive as zeros and still count towards the barrier's bytes.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(head)
      : "memory");
}

// Shared-memory matrix descriptor of a tile stored as 128-byte rows with the
// 128-byte swizzle, groups of 8 rows 1024 bytes apart. For K ([keys][d],
// the K-major B operand) the 8-row groups run along N; for V ([keys][d], the
// MN-major B operand) they run along the product's K: both are the stride
// field. The leading offset is unused at these shapes (one swizzle row wide).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t desc = 0;
  desc |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  desc |= static_cast<uint64_t>(1) << 16;          // leading byte offset (unused)
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  desc |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to an accumulator across the
// asynchronous products that write it.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64x64] (+)= a[64x16] (registers) * B (shared memory; TRANS_B: MN-major), per warpgroup
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring q values of row `row` (zero past S), times `scale`,
// rounded to bf16: one register of the A fragment.
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* __restrict__ q, int row,
                                                int col, int S, float scale) {
  if (row >= S) return 0u;
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(q + static_cast<size_t>(row) * kHD + col);
  return pack_bf16(__bfloat162float(v.x) * scale, __bfloat162float(v.y) * scale);
}

// out[i] = bf16(in[i] * scale), 8 values a thread
__global__ void scale_rows(const int4* __restrict__ in, int4* __restrict__ out, size_t n8,
                           float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  int4 w = __ldg(in + i);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = __floats2bfloat162_rn(__bfloat162float(h[j].x) * scale,
                                 __bfloat162float(h[j].y) * scale);
  }
  out[i] = w;
}

// Row max of one score tile folded into the running max, then the tile's
// unnormalised probabilities in place (exp2 of the score times log2(e), less
// the max), their sums into l0/l1, and the factors c0/c1 that the earlier
// sums and the accumulator owe to the new max. s[4j + c]: key column
// 8j + 2t + (c & 1), first row for c < 2, second row (eight below) otherwise.
__device__ __forceinline__ void softmax_tile(float (&s)[kTileN / 2], float& m0, float& m1,
                                             float& l0, float& l1, float& c0, float& c1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < kTileN / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // Every tile holds a valid key, so the new max is finite; the first
  // tile's factor is exp2(-inf) = 0 on an empty state.
  c0 = fast_exp2((m0 - mx0) * kLog2e);
  c1 = fast_exp2((m1 - mx1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < kTileN / 2; i += 4) {
    s[i] = fast_exp2(fmaf(s[i], kLog2e, -ms0));
    s[i + 1] = fast_exp2(fmaf(s[i + 1], kLog2e, -ms0));
    s[i + 2] = fast_exp2(fmaf(s[i + 2], kLog2e, -ms1));
    s[i + 3] = fast_exp2(fmaf(s[i + 3], kLog2e, -ms1));
    sum0 += s[i] + s[i + 1];
    sum1 += s[i + 2] + s[i + 3];
  }
  l0 = fmaf(l0, c0, sum0);
  l1 = fmaf(l1, c1, sum1);
}

// map_k: the pre-scaled k; map_v: v; both [B*H, S, 64] bf16 with boxes of
// [1, kTileN, 64]. q, o: [B*H, S, 64] bf16. grid (ceil(S / kTileM), B*H).
// 128 registers a thread and 65 KB of shared memory: two blocks on an SM.
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
             const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int S,
             float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[kStages], empty[kStages]

  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle needs 1024
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const int head = blockIdx.y;
  const int n_tiles = (S + kTileN - 1) / kTileN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);                 // the loader's arrive + the TMA bytes
      mbar_init(empty0 + 8 * st, 4 * kWarpgroups);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile n into its stage of the ring, once every warp has left the tile
  // that was there before. Thread 0 is the loader.
  auto load_tile = [&](int n) {
    const int stage = n % kStages;
    const int round = n / kStages;
    if (round > 0) mbar_wait(empty0 + 8 * stage, (round - 1) & 1);
    const uint32_t bar = full0 + 8 * stage;
    const uint32_t dst = tiles + stage * 2 * kTileBytes;
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
    tma_load_tile(dst, &map_k, bar, n * kTileN, head);
    tma_load_tile(dst + kTileBytes, &map_v, bar, n * kTileN, head);
  };
  if (threadIdx.x == 0) {
    for (int n = 0; n < kStages - 1 && n < n_tiles; ++n) load_tile(n);
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row
  const int t = lane & 3;   // fragment column pair
  const size_t base = static_cast<size_t>(head) * S * kHD;
  const int row0 = blockIdx.x * kTileM + wg * 64 + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ragged = (S % kTileN) != 0;
  const int tail = S - (n_tiles - 1) * kTileN;  // keys of the last tile

  // Q as the A fragments of four k16 steps, scaled and rounded once.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = load_q_pair(q + base, row0, 16 * kk + 2 * t, S, scale);
    qf[kk][1] = load_q_pair(q + base, row1, 16 * kk + 2 * t, S, scale);
    qf[kk][2] = load_q_pair(q + base, row0, 16 * kk + 8 + 2 * t, S, scale);
    qf[kk][3] = load_q_pair(q + base, row1, 16 * kk + 8 + 2 * t, S, scale);
  }

  float acc[32];  // O: rows row0 (acc[4j], acc[4j+1]) and row1 (acc[4j+2], acc[4j+3])
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float c0, c1;
  float s[kTileN / 2];          // one score tile, then its probabilities
  uint32_t pf[kTileN / 16][4];  // the probabilities as bf16 A fragments of four k16 steps

  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n % kStages;
    const uint32_t k_tile = tiles + stage * 2 * kTileBytes;
    const uint64_t k_desc = smem_desc(k_tile);
    const uint64_t v_desc = smem_desc(k_tile + kTileBytes);
    if (threadIdx.x == 0 && n + kStages - 1 < n_tiles) load_tile(n + kStages - 1);
    __syncwarp();  // warp 0 is whole again before the warpgroup-wide products
    mbar_wait(full0 + 8 * stage, (n / kStages) & 1);

    // S = Q K^T: four k16 steps along d, 32 bytes apart inside the swizzle row
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(s, qf[kk], k_desc + 2 * kk, kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (ragged && n == n_tiles - 1) {  // s[4j + c]: key column 8j + 2t + (c & 1)
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) {
        if (8 * (i >> 2) + 2 * t + (i & 1) >= tail) s[i] = -INFINITY;
      }
    }
    softmax_tile(s, m0, m1, l0, l1, c0, c1);
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      acc[i] *= c0;
      acc[i + 1] *= c0;
      acc[i + 2] *= c1;
      acc[i + 3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: 16 keys a step, 2048 bytes apart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk)
      wgmma_m64n64k16_rs<1>(acc, pf[kk], v_desc + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* out = o + base;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0) * kHD + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (row1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row1) * kHD + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
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

// A [bh, s, 64] bf16 tensor as a 3-D map with boxes of [1, kTileN, 64] and the
// 128-byte swizzle; out-of-range rows are filled with zeros.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s) {
  const cuuint64_t dims[3] = {kHD, static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {kHD * 2, static_cast<cuuint64_t>(s) * kHD * 2};  // bytes
  const cuuint32_t box[3] = {kHD, kTileN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS;
}

int launch_tc(const void* q, const void* k, const void* v, void* o, void* k_scaled, int bh, int s,
              float scale, cudaStream_t stream) {
  if (k_scaled == nullptr || encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(k_scaled) | reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(o);
  if (align & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap map_k, map_v;
  if (!make_map(&map_k, k_scaled, bh, s) || !make_map(&map_v, v, bh, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n8 = static_cast<size_t>(bh) * s * kHD / 8;
  scale_rows<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, stream>>>(
      static_cast<const int4*>(k), static_cast<int4*>(k_scaled), n8, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTileM - 1) / kTileM, bh);
  flash_fwd_tc<<<grid, kTcThreads, kTcSmem, stream>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), s,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// CUDA-core kernel: f32 inputs, and bf16 at head dim 32
// ---------------------------------------------------------------------------

constexpr int kFmaKeys = 64;  // keys per K/V tile

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's shape: BQ queries against 64-key tiles; each thread holds a
// register tile of TQ queries x TK keys of the scores and TQ queries x kCols
// columns of the output, and the kLanes threads that share a query row sit
// in one warp. Shared memory, in floats: Q [BQ][kRow], K and V [2][64][kRow]
// (two tiles), P [BQ][kProw]; bf16 adds a staging area where its copies
// land before they are widened.
template <typename T, int HD, int BQ, int TQ, int TK>
struct FmaTile {
  static constexpr int kLanes = kFmaKeys / TK;
  static constexpr int kGroups = BQ / TQ;  // a thread's query rows: group + i * kGroups
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kCols = HD / kLanes;
  static constexpr int kRow = HD + 4;  // odd in 16-byte units: neighbouring rows on other banks
  static constexpr int kProw = kFmaKeys + kLanes;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements of one copy
  static constexpr bool kWiden = sizeof(T) != 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BQ * kRow;
  static constexpr int kV = kK + 2 * kFmaKeys * kRow;
  static constexpr int kP = kV + 2 * kFmaKeys * kRow;
  static constexpr int kStage = kP + BQ * kProw;
  static constexpr int kStageFloats =
      kWiden ? (BQ + 4 * kFmaKeys) * HD * static_cast<int>(sizeof(T)) / 4 : 0;
  static constexpr int kSmem = (kStage + kStageFloats) * 4;
  static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "a row's threads share one warp");
  static_assert(kCols == 2 || kCols % 4 == 0, "output columns in float2 or float4");
  static_assert((BQ * HD / kVec) % kThreads == 0 && (kFmaKeys * HD / kVec) % kThreads == 0,
                "whole copies per thread");
};

// `rows` rows of a [S, HD] head from row r0 into shared memory at `dst`
// (rows `row_bytes` apart), 16 bytes a copy; rows past S are zero-filled
// and read nothing.
template <class C, typename T, int HD>
__device__ __forceinline__ void fma_copy(uint32_t dst, int row_bytes, const T* __restrict__ src,
                                         int r0, int rows, int S) {
  constexpr int kPerRow = HD / C::kVec;
#pragma unroll
  for (int e = threadIdx.x; e < rows * kPerRow; e += C::kThreads) {
    const int r = e / kPerRow, c = e - r * kPerRow;
    const bool in = r0 + r < S;
    const T* g = src + static_cast<size_t>(in ? r0 + r : 0) * HD + c * C::kVec;
    cp_async16(dst + r * row_bytes + c * 16, g, in ? 16u : 0u);
  }
}

// The thread's own copies made ready: times `scale` and rounded to T when
// `scaled` (q and k), widened from the staging area for bf16. A thread
// touches only what it copied itself, so its own wait is enough.
template <class C, typename T, int HD>
__device__ __forceinline__ void fma_ready(float* dst, const T* raw, int rows, bool scaled,
                                          float scale) {
  constexpr int kPerRow = HD / C::kVec;
#pragma unroll
  for (int e = threadIdx.x; e < rows * kPerRow; e += C::kThreads) {
    const int r = e / kPerRow, c = e - r * kPerRow;
    float4* out = reinterpret_cast<float4*>(dst + r * C::kRow + c * C::kVec);
    if constexpr (!C::kWiden) {
      if (scaled) {
        float4 x = *out;
        x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
        *out = x;
      }
    } else {
      const uint4 w = *reinterpret_cast<const uint4*>(raw + r * HD + c * C::kVec);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
      float f[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __bfloat162float(h[j].x);
        f[2 * j + 1] = __bfloat162float(h[j].y);
      }
      if (scaled) {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = round_as<T>(f[j] * scale);
      }
      out[0] = make_float4(f[0], f[1], f[2], f[3]);
      out[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_cols(float (&x)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + c);
      x[c] = a.x, x[c + 1] = a.y, x[c + 2] = a.z, x[c + 3] = a.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_cols(float* out, const float (&x)[N], float inv) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(x[0] * inv, x[1] * inv);
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      *reinterpret_cast<float4*>(out + c) =
          make_float4(x[c] * inv, x[c + 1] * inv, x[c + 2] * inv, x[c + 3] * inv);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_cols(__nv_bfloat16* out, const float (&x)[N], float inv) {
#pragma unroll
  for (int c = 0; c < N; c += 2) {
    *reinterpret_cast<__nv_bfloat162*>(out + c) =
        __floats2bfloat162_rn(x[c] * inv, x[c + 1] * inv);
  }
}

__device__ __forceinline__ float part(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// q, k, v, o: [B*H, S, HD] of T, 16-byte aligned. grid (ceil(S / BQ), B*H).
// MIN_BLOCKS: the blocks an SM must hold, which caps the registers a thread.
template <typename T, int HD, int BQ, int TQ, int TK, int MIN_BLOCKS>
__global__ void __launch_bounds__(FmaTile<T, HD, BQ, TQ, TK>::kThreads, MIN_BLOCKS)
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int S, float scale) {
  using C = FmaTile<T, HD, BQ, TQ, TK>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + C::kQ;
  float* ps = smem + C::kP;
  T* stage = reinterpret_cast<T*>(smem + C::kStage);  // bf16: Q, then K and V of two tiles
  const auto k_buf = [&](int b) { return smem + C::kK + b * kFmaKeys * C::kRow; };
  const auto v_buf = [&](int b) { return smem + C::kV + b * kFmaKeys * C::kRow; };
  const auto k_raw = [&](int b) { return stage + (BQ + 2 * b * kFmaKeys) * HD; };
  const auto v_raw = [&](int b) { return k_raw(b) + kFmaKeys * HD; };

  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (S + kFmaKeys - 1) / kFmaKeys;
  const int tail = S - (n_tiles - 1) * kFmaKeys;  // keys of the last tile
  const int lane = threadIdx.x % C::kLanes;  // keys lane + j * kLanes, columns from lane * kCols
  const int group = threadIdx.x / C::kLanes;

  // Tile n of K and V into buffer n & 1 (bf16: into its staging area).
  const auto load_tile = [&](int n) {
    const int b = n & 1;
    if constexpr (C::kWiden) {
      fma_copy<C, T, HD>(smem_u32(k_raw(b)), HD * sizeof(T), k + base, n * kFmaKeys, kFmaKeys, S);
      fma_copy<C, T, HD>(smem_u32(v_raw(b)), HD * sizeof(T), v + base, n * kFmaKeys, kFmaKeys, S);
    } else {
      fma_copy<C, T, HD>(smem_u32(k_buf(b)), C::kRow * 4, k + base, n * kFmaKeys, kFmaKeys, S);
      fma_copy<C, T, HD>(smem_u32(v_buf(b)), C::kRow * 4, v + base, n * kFmaKeys, kFmaKeys, S);
    }
    cp_async_commit();
  };
  if constexpr (C::kWiden) {
    fma_copy<C, T, HD>(smem_u32(stage), HD * sizeof(T), q + base, q0, BQ, S);
  } else {
    fma_copy<C, T, HD>(smem_u32(qs), C::kRow * 4, q + base, q0, BQ, S);
  }
  load_tile(0);

  float acc[TQ][C::kCols];
  float m[TQ], l[TQ];  // each row's running max; this thread's share of its running sum
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int n = 0; n < n_tiles; ++n) {
    const int b = n & 1;
    const float* kb = k_buf(b);
    const float* vb = v_buf(b);
    cp_async_wait_all();
    if (n == 0) fma_ready<C, T, HD>(qs, stage, BQ, true, scale);
    fma_ready<C, T, HD>(k_buf(b), k_raw(b), kFmaKeys, true, scale);
    if constexpr (C::kWiden) fma_ready<C, T, HD>(v_buf(b), v_raw(b), kFmaKeys, false, 1.f);
    __syncthreads();  // tile n is whole, and every thread has left tile n - 1
    if (n + 1 < n_tiles) load_tile(n + 1);  // lands while this tile is computed

    // s[i][j] = q row (group + i * kGroups) . k row (lane + j * kLanes)
    float s[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (group + i * C::kGroups) * C::kRow + d);
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kb + (lane + j * C::kLanes) * C::kRow + d);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    if (n == n_tiles - 1 && tail < kFmaKeys) {  // keys past S
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        if (lane + j * C::kLanes >= tail) {
#pragma unroll
          for (int i = 0; i < TQ; ++i) s[i][j] = -INFINITY;
        }
      }
    }

    // Online softmax. The row max is taken over the row's kLanes threads;
    // every tile holds a valid key, so it is finite, and the first tile's
    // factor is exp2(-inf) = 0 on the empty state.
    float corr[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < TK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = C::kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      corr[i] = fast_exp2((m[i] - mx) * kLog2e);
      m[i] = mx;
      const float ms = mx * kLog2e;
      float sum = 0.f;
      float* prow = ps + (group + i * C::kGroups) * C::kProw + lane;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], kLog2e, -ms));
        sum += p;
        prow[j * C::kLanes] = round_as<T>(p);  // unnormalised, rounded to T before P V
      }
      l[i] = fmaf(l[i], corr[i], sum);
    }
    __syncthreads();  // P is whole

    // O = O * corr + P V, four keys at a time
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[i][c] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kFmaKeys; j += 4) {
      float4 pv[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (group + i * C::kGroups) * C::kProw + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[C::kCols];
        load_cols(vv, vb + (j + u) * C::kRow + lane * C::kCols);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float p = part(pv[i], u);
#pragma unroll
          for (int c = 0; c < C::kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int off = C::kLanes / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + group + i * C::kGroups;
    if (row < S)
      store_cols(o + base + static_cast<size_t>(row) * HD + lane * C::kCols, acc[i], 1.f / l[i]);
  }
}

template <typename T, int HD, int BQ, int TQ, int TK, int MIN_BLOCKS>
int launch_fma(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
               cudaStream_t stream) {
  using C = FmaTile<T, HD, BQ, TQ, TK>;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (align & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto kernel = flash_fwd_fma<T, HD, BQ, TQ, TK, MIN_BLOCKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(static_cast<const T*>(q),
                                                  static_cast<const T*>(k),
                                                  static_cast<const T*>(v), static_cast<T*>(o), s,
                                                  scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [bh, s, hd] of `dtype` (kF32 or kBF16), 16-byte
// aligned; hd 32 or 64. bf16 at hd 64 runs on the tensor cores and needs
// `k_scaled`, scratch of k's size and type (16-byte aligned too); every other
// case takes the CUDA-core kernel and ignores it. Launches on `stream` and
// returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* k_scaled, int bh, int s, int hd, int dtype, float scale,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && hd == 64) return launch_tc(q, k, v, o, k_scaled, bh, s, scale, st);
  if (dtype == kBF16 && hd == 32)
    return launch_fma<__nv_bfloat16, 32, 128, 8, 8, 2>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 64)
    return launch_fma<float, 64, 128, 8, 4, 1>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 32)
    return launch_fma<float, 32, 128, 8, 8, 2>(q, k, v, o, bh, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
