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
// f32 inputs and D = 32 take `flash_fwd_simt`, the earlier kernel: one thread
// per query row, f32 FMAs, K/V tiles of 32 keys through shared memory. It is
// off the main path (large-v3-turbo runs bf16 at D = 64).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, [16, 20, 1500, 64] bf16, by
// chip_smoke.py: 0.537 ms a launch with the pre-pass (10.63 ms before this
// design), `scaled_dot_product_attention` 0.497 ms; PERF.md section 6 has
// what separates the two.

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; the encode function is fetched at run time

namespace {

// ---------------------------------------------------------------------------
// SIMT kernel: f32 inputs, and bf16 at head dim 32
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 128;  // queries per block, one per thread
constexpr int kTileK = 32;    // keys per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int S, float scale) {
  __shared__ __align__(16) float ks[kTileK][HD];
  __shared__ __align__(16) float vs[kTileK][HD];

  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int qi = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = qi < S;

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? round_as<T>(to_float(q[base + static_cast<size_t>(qi) * HD + d]) * scale)
                   : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max
  float l = 0.f;        // running sum of exp(s - m)

  for (int k0 = 0; k0 < S; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * HD; e += kBlockQ) {
      const int j = e / HD;
      const int d = e - j * HD;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < S) {
        const size_t off = base + static_cast<size_t>(k0 + j) * HD + d;
        kv = round_as<T>(to_float(k[off]) * scale);
        vv = to_float(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[kTileK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[j] = (k0 + j < S) ? dot : -INFINITY;  // ragged key edge
      m_new = fmaxf(m_new, s[j]);
    }
    // The first tile always holds a valid key, so m_new is finite and
    // exp(-inf - m_new) = 0 clears the empty initial state.
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float p = __expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (active) {
    T* out = o + base + static_cast<size_t>(qi) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) out[d] = from_float<T>(acc[d] / l);
  }
}

template <typename T, int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
                cudaStream_t stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_simt<T, HD><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale);
  return static_cast<int>(cudaGetLastError());
}

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

}  // namespace

// q, k, v, o: contiguous [bh, s, hd] of `dtype` (kF32 or kBF16); hd 32 or 64.
// bf16 at hd 64 runs on the tensor cores and needs `k_scaled`, scratch of k's
// size and type (16-byte aligned, as q, k, v and o must be); every other case
// takes the SIMT kernel and ignores it. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* k_scaled, int bh, int s, int hd, int dtype, float scale,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && hd == 64) return launch_tc(q, k, v, o, k_scaled, bh, s, scale, st);
  if (dtype == kBF16 && hd == 32)
    return launch_simt<__nv_bfloat16, 32>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 64) return launch_simt<float, 64>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 32) return launch_simt<float, 32>(q, k, v, o, bh, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
