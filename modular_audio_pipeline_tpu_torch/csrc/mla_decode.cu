// Absorbed multi-head latent attention (MLA) for one decode step of
// DeepSeek-V2 (`decode_step` in models/lm/deepseek_v2.py), for Hopper
// (sm_90a). It replaces no TPU kernel: the JAX package has no DeepSeek-V2.
// Its plain version is `_absorbed_attention` (same file), which the CPU runs
// and which this kernel is held to on the card; `mla_decode_emulation`
// there states this kernel's arithmetic step by step.
//
// Per layer, one query a sequence over the latent cache. Every operand is
// read once in its own type (bf16 on the card, or f32), and every product
// and sum is exact or an f32 operation (below):
//   q_lat[b,h,:] = q_nope[b,h,:] W_uk[:,h,:]                       (absorb)
//   s[b,h,t]     = (q_lat[b,h,:] c_kv[b,t,:] + q_pe[b,h,:] k_pe[b,t,:]) scale,
//                  t <= pos (the positions past it are not read)
//   o_lat[b,h,:] = softmax_t(s) c_kv[b,t,:]
//   o[b,h,:]     = o_lat[b,h,:] W_uv[:,h,:]                      (un-absorb)
// and o is rounded once to the input type. W_uk and W_uv are the nope and v
// halves of each head's columns of w_kvb [R, H (nope + v)], read in place.
// All H heads read the same latent row: a position's key and value are one
// row of R + rope values.
//
// Bounds on an H100 at DeepSeek-V2-Lite (H 16, R 512, rope 64, nope 128,
// v 128) over a context of 16,512 positions at batch 1:
//   operations  2 T H (2 R + rope) + 2 H R (nope + v) = 0.579 GFLOP, 8.6 us
//               as f32 FMAs at 67 TFLOP/s (the CUDA cores; TF32 would be a
//               lower precision than the configuration states);
//   bytes       the bf16 cache (19.0 MB) and w_kvb (4.2 MB), 6.9 us at
//               3.35 TB/s.
// On the tensor-core route below the products of three parts each come to
// 1.7 GFLOP, 1.8 us at 989 TFLOP/s, so there the bytes bound a layer.
//
// Three launches on the caller's stream:
//   mla_absorb   one warp a head and four latent rows: q_lat into scratch qf
//                [B, H, R + rope] f32, with q_pe widened beside it.
//   mla_attend_tc  (bf16 cache, 16 heads: DeepSeek-V2-Lite on the card)
//                split-KV (flash decoding): grid (split, batch), one block
//                of 256 threads an SM; a split is `chunk` positions, taken
//                in tiles of 32 rows of c_kv | k_pe that come by cp.async
//                into one staging tile while the other is used. The
//                products run on the tensor cores (`mma` m16n8k16, the 16
//                heads as the rows) and stay exact: the cache's bf16 values
//                enter as they are, and q_lat and p are each split into
//                three bf16 parts that sum to the f32 value exactly, so each
//                product of parts is exact and `mma` sums them in f32. Each
//                warp holds its quarter of q's parts in registers for the
//                whole split (loading them from shared memory for every tile
//                made the scores wait on shared memory). Scores: warp w
//                takes 16 positions and a quarter of the 576 dims, the
//                quarters summed in a fixed order; online softmax in f32, a
//                warp two heads, a lane a position (exp2f, the accurate
//                exp2); then o_lat += p c_kv, a warp 64 latent columns.
//   mla_attend   (an f32 cache, or test-small's 4 heads) the same split on
//                the CUDA cores in f32 FMAs: each warp an eighth of the
//                dims for the scores, each lane a register tile of 4 heads x
//                4 positions with the cache widened in registers; o_lat by
//                4 heads x 16 bytes of the latent a lane. (At V2-Lite's
//                shape it took 28 us, the tensor-core route 15.)
//   mla_combine  a cluster of 8 blocks a (head, batch), one eighth of the
//                latent rows a block: cp.async brings that eighth of W_uv,
//                then the live splits' partial rows and their (max, sum)
//                into shared memory; the splits are merged by their maxima
//                in a fixed order (no atomics), and each block's share of
//                o_lat W_uv is summed by rank 0 over the cluster's shared
//                memory, ranks in order.
// Positions past `pos` are zero-filled, not read, and masked; splits wholly
// past it exit at once. A split writes its unnormalised o_lat and its
// running max and sum. `pos` is read on the device (a 0-d int64 tensor),
// and the grids depend on the cache's size alone, so the step is captured
// once in a CUDA graph and replayed as the context grows. Measured on an
// H100 at the shape above (kernel_times.py): about 25.5 us a layer for the
// three, the plain f32 chain it replaced 133 us. Tried and dropped, for no
// gain at this shape: launching the attention and the combine as
// programmatic dependents, three or four staging tiles, clusters of 16 for
// the combine, 512 threads for the CUDA-core route.

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // positions a tile: one a lane in the softmax
constexpr int kRanks = 8;   // blocks of a combine cluster: eighths of the latent rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The query's position, clamped into [0, ctx) so that no read leaves the
// cache. A kernel cannot raise cheaply: the callers check the position on
// the host before the step (`forward`, `DecodeGraph` in deepseek_v2.py).
__device__ __forceinline__ int live_pos(const long long* pos, int ctx) {
  const long long p = *pos;
  return static_cast<int>(p < 0 ? 0 : (p >= ctx ? ctx - 1 : p));
}

// ---------------------------------------------------------------------------
// absorb
// ---------------------------------------------------------------------------

constexpr int kMaxNope = 256;
constexpr int kAbsorbRows = 4;  // latent rows a warp

// qf[b, h, r] = q_nope[b, h, :] . w_kvb[r, h (nope + dv) : h (nope + dv) + nope]
// for r < R, and qf[b, h, R + i] = q_pe[b, h, i]. A warp takes kAbsorbRows
// rows of one head (R is a multiple of it), lane n the dims n + 32 i: its
// loads of all its rows are in flight at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_absorb(const T* __restrict__ q_nope, long long qn_b, long long qn_h,
           const T* __restrict__ q_pe, long long qp_b, long long qp_h,
           const T* __restrict__ w, float* __restrict__ qf, int batch, int heads, int r_dim,
           int rope, int nope, int dv) {
  constexpr int kPer = kMaxNope / 32;
  const int kd = r_dim + rope;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < batch * heads * rope) {
    const int i = g % rope, bh = g / rope, h = bh % heads, b = bh / heads;
    qf[static_cast<size_t>(bh) * kd + r_dim + i] = to_float(q_pe[b * qp_b + h * qp_h + i]);
  }
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kAbsorbRows;
  if (row0 >= heads * r_dim) return;
  const int h = row0 / r_dim, r0 = row0 - h * r_dim;
  const size_t ld = static_cast<size_t>(heads) * (nope + dv);
  const T* const wr = w + static_cast<size_t>(r0) * ld + static_cast<size_t>(h) * (nope + dv);
  float wv[kAbsorbRows][kPer];
#pragma unroll
  for (int k = 0; k < kAbsorbRows; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = lane + 32 * i;
      wv[k][i] = n < nope ? to_float(wr[k * ld + n]) : 0.f;
    }
  for (int b = 0; b < batch; ++b) {
    const T* const q = q_nope + b * qn_b + h * qn_h;
    float qv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = lane + 32 * i;
      qv[i] = n < nope ? to_float(q[n]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAbsorbRows; ++k) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) a = fmaf(qv[i], wv[k][i], a);
      a = warp_sum(a);
      if (lane == 0) qf[(static_cast<size_t>(b) * heads + h) * kd + r0 + k] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// split-KV attention over the latent cache
// ---------------------------------------------------------------------------

// 16 bytes of cache (kVec values) widened to f32 in registers
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  // element 0 of a 32-bit word is its low half
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16);
  f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16);
  f[7] = __uint_as_float(u.w & 0xffff0000u);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// The block's layout. Shared memory: q [H][kQRow] f32 (neighbouring rows
// four banks apart), the eight score slices [kWarps][H][kRedRow] f32, the
// probabilities [kTile][H] f32 (a lane's heads side by side), each head's
// correction [H]; then two staging tiles [kTile][kRowS] of T, the cache
// rows as they are stored (c_kv, then k_pe, one 16-byte unit of padding:
// neighbouring rows four banks apart).
template <typename T, int H, int R, int ROPE>
struct Attend {
  static constexpr int kKd = R + ROPE;     // a cache row: the latent, then the rope key
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
  static constexpr int kRowS = kKd + kVec;  // a staged row, in T
  static constexpr int kQRow = kKd + 4;     // a row of q, in floats
  static constexpr int kHt = H / 4;         // a lane's heads: hg + 4 j
  static constexpr int kTt = kTile / 8;     // a lane's positions in the scores: tg + 8 i
  static constexpr int kRedRow = kTile + 8;  // (hg, tg) -> bank 8 hg + tg
  static constexpr int kUnits = kKd / kVec;  // 16-byte units of a row
  static constexpr int kLatUnits = R / kVec;
  static constexpr int kColGroups = (kLatUnits + 63) / 64;  // a lane's units: w 8 + tg + 64 m
  static constexpr int kHw = (H + kWarps - 1) / kWarps;     // heads a warp in the softmax
  static constexpr int kQ = 0;
  static constexpr int kRed = kQ + H * kQRow;
  static constexpr int kP = kRed + kWarps * H * kRedRow;
  static constexpr int kCorr = kP + kTile * H;
  static constexpr int kStage = kCorr + H;
  static constexpr int kStageBytes = kTile * kRowS * static_cast<int>(sizeof(T));
  static constexpr int kSmem = kStage * 4 + 2 * kStageBytes;
  static_assert(H % 4 == 0 && H <= 4 * 32, "heads in four lane groups");
  static_assert(R % kVec == 0 && ROPE % kVec == 0, "whole 16-byte units a row");
  static_assert(kStage % 4 == 0, "the staging tiles on 16-byte boundaries");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

template <typename T, int H, int R, int ROPE>
__global__ void __launch_bounds__(kThreads, 1)
mla_attend(const float* __restrict__ qf, const T* __restrict__ ckv, const T* __restrict__ kpe,
           const long long* __restrict__ pos_p, float* __restrict__ part_o,
           float* __restrict__ part_ml, int ctx, int chunk, float scale) {
  using C = Attend<T, H, R, ROPE>;
  constexpr int V = C::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sq = reinterpret_cast<float*>(smem) + C::kQ;
  float* const sred = reinterpret_cast<float*>(smem) + C::kRed;
  float* const sp = reinterpret_cast<float*>(smem) + C::kP;
  float* const scorr = reinterpret_cast<float*>(smem) + C::kCorr;
  T* const sstage = reinterpret_cast<T*>(smem + C::kStage * 4);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y, n_split = gridDim.x;
  const int pos = live_pos(pos_p, ctx);
  const int c0 = split * chunk;
  if (c0 > pos) return;  // wholly past the query: the combine does not read this split
  const int last = min(c0 + chunk - 1, pos);
  const int n_tiles = (last - c0) / kTile + 1;
  const T* const ckv_b = ckv + static_cast<size_t>(b) * ctx * R;
  const T* const kpe_b = kpe + static_cast<size_t>(b) * ctx * ROPE;

  // rows t0 .. t0 + kTile - 1 into staging tile `buf`; rows past `last` are
  // zero-filled and read nothing
  auto stage = [&](int t0, int buf) {
    T* const dst = sstage + buf * (C::kStageBytes / static_cast<int>(sizeof(T)));
    for (int e = tid; e < kTile * C::kUnits; e += kThreads) {
      const int r = e / C::kUnits, c = e - r * C::kUnits;
      const bool in = t0 + r <= last;
      const size_t t = in ? t0 + r : c0;
      const T* src = c < C::kLatUnits ? ckv_b + t * R + c * V
                                      : kpe_b + t * ROPE + (c - C::kLatUnits) * V;
      cp_async16(smem_u32(dst + r * C::kRowS + c * V), src, in ? 16u : 0u);
    }
    cp_async_commit();
  };
  const float* const qb = qf + static_cast<size_t>(b) * H * C::kKd;
  for (int e = tid; e < H * (C::kKd / 4); e += kThreads) {  // q, in the first tile's group
    const int h = e / (C::kKd / 4), c = e - h * (C::kKd / 4);
    cp_async16(smem_u32(sq + h * C::kQRow + 4 * c), qb + h * C::kKd + 4 * c, 16u);
  }
  stage(c0, 0);

  const int hg = lane >> 3, tg = lane & 7;
  float m_run[C::kHw], l_run[C::kHw];
#pragma unroll
  for (int k = 0; k < C::kHw; ++k) {
    m_run[k] = -INFINITY;
    l_run[k] = 0.f;
  }
  float acc[C::kHt][C::kColGroups][V];
#pragma unroll
  for (int j = 0; j < C::kHt; ++j)
#pragma unroll
    for (int m = 0; m < C::kColGroups; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][m][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = c0 + it * kTile;
    const int live = min(kTile, last - t0 + 1);
    const T* const tile = sstage + (it & 1) * (C::kStageBytes / static_cast<int>(sizeof(T)));
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; every lane has left the other tile
    if (it + 1 < n_tiles) stage(t0 + kTile, (it + 1) & 1);

    // scores: this warp's 16-byte units of the dims (every eighth), a lane's
    // 4 heads x 4 positions, the cache widened in registers
    float s[C::kHt][C::kTt];
#pragma unroll
    for (int j = 0; j < C::kHt; ++j)
#pragma unroll
      for (int i = 0; i < C::kTt; ++i) s[j][i] = 0.f;
#pragma unroll 3
    for (int c = w; c < C::kUnits; c += kWarps) {
      float kv[C::kTt][V];
#pragma unroll
      for (int i = 0; i < C::kTt; ++i)
        widen(*reinterpret_cast<const uint4*>(tile + (tg + 8 * i) * C::kRowS + c * V), kv[i]);
#pragma unroll
      for (int j = 0; j < C::kHt; ++j) {
        float qv[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(sq + (hg + 4 * j) * C::kQRow + c * V + e);
          qv[e] = q4.x;
          qv[e + 1] = q4.y;
          qv[e + 2] = q4.z;
          qv[e + 3] = q4.w;
        }
#pragma unroll
        for (int i = 0; i < C::kTt; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) s[j][i] = fmaf(qv[e], kv[i][e], s[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < C::kHt; ++j)
#pragma unroll
      for (int i = 0; i < C::kTt; ++i)
        sred[(w * H + hg + 4 * j) * C::kRedRow + tg + 8 * i] = s[j][i];
    __syncthreads();

    // online softmax: warp w takes heads w, w + 8, ...; lane = position
#pragma unroll
    for (int k = 0; k < C::kHw; ++k) {
      const int h = w + kWarps * k;
      if (h < H) {
        float x = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) x += sred[(q * H + h) * C::kRedRow + lane];
        x = lane < live ? x * scale : -INFINITY;
        const float mn = fmaxf(m_run[k], warp_max(x));  // finite: position t0 is live
        const float cr = exp2f((m_run[k] - mn) * kLog2e);  // 0 on the first tile
        const float p = exp2f((x - mn) * kLog2e);
        l_run[k] = l_run[k] * cr + warp_sum(p);
        m_run[k] = mn;
        sp[lane * H + (h & 3) * C::kHt + (h >> 2)] = p;
        if (lane == 0) scorr[h] = cr;
      }
    }
    __syncthreads();

    // o_lat += p c_kv: a lane's 4 heads x its 16-byte units of the latent
#pragma unroll
    for (int j = 0; j < C::kHt; ++j) {
      const float cr = scorr[hg + 4 * j];
#pragma unroll
      for (int m = 0; m < C::kColGroups; ++m)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][m][e] *= cr;
    }
#pragma unroll 2
    for (int t = 0; t < live; ++t) {
      float p[C::kHt];
      if constexpr (C::kHt == 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(sp + t * H + hg * 4);
        p[0] = p4.x;
        p[1] = p4.y;
        p[2] = p4.z;
        p[3] = p4.w;
      } else {
#pragma unroll
        for (int j = 0; j < C::kHt; ++j) p[j] = sp[t * H + hg * C::kHt + j];
      }
#pragma unroll
      for (int m = 0; m < C::kColGroups; ++m) {
        const int c = w * 8 + tg + 64 * m;
        if (C::kLatUnits % 64 == 0 || c < C::kLatUnits) {
          float kv[V];
          widen(*reinterpret_cast<const uint4*>(tile + t * C::kRowS + c * V), kv);
#pragma unroll
          for (int j = 0; j < C::kHt; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[j][m][e] = fmaf(p[j], kv[e], acc[j][m][e]);
        }
      }
    }
  }

  // the split's partial: o_lat unnormalised, each head's max and sum
  float* const po = part_o + static_cast<size_t>(b * n_split + split) * H * R;
#pragma unroll
  for (int j = 0; j < C::kHt; ++j)
#pragma unroll
    for (int m = 0; m < C::kColGroups; ++m) {
      const int c = w * 8 + tg + 64 * m;
      if (C::kLatUnits % 64 == 0 || c < C::kLatUnits)
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(po + (hg + 4 * j) * R + c * V + e) =
              make_float4(acc[j][m][e], acc[j][m][e + 1], acc[j][m][e + 2], acc[j][m][e + 3]);
    }
#pragma unroll
  for (int k = 0; k < C::kHw; ++k) {
    const int h = w + kWarps * k;
    if (h < H && lane == 0) {
      float* const ml = part_ml + (static_cast<size_t>(b * n_split + split) * H + h) * 2;
      ml[0] = m_run[k];
      ml[1] = l_run[k];
    }
  }
}

// The same split on the tensor cores, for a bf16 cache at 16 heads. Both
// products are exact: the cache's bf16 values enter as they are, and q_lat
// and p are each split into three bf16 parts whose sum is the f32 value
// exactly (hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid, which has
// at most 8 significant bits), so each product of parts is exact in f32 and
// `mma` sums them in f32: no value is rounded below f32. Shared memory: the
// three parts of q [3][H][kRowS] bf16, two staging tiles [kTile][kRowS]
// (rows 1,168 bytes apart: the eight rows of an `ldmatrix` fall on
// distinct banks), the four slices of the scores [4][H][kRedRow] f32, the
// three parts of p [3][H][kPRow] bf16 and the corrections [H].
template <int H, int R, int ROPE>
struct AttendTc {
  static constexpr int kKd = R + ROPE;
  static constexpr int kRowS = kKd + 8;      // bf16
  static constexpr int kRedRow = kTile + 8;  // f32
  static constexpr int kPRow = kTile + 8;    // bf16, 80 bytes: eight rows on distinct banks
  static constexpr int kKSteps = kKd / 16 / 4;  // k16 steps a warp in the scores (four slices)
  static constexpr int kStageBytes = kTile * kRowS * 2;
  static constexpr int kQ = 0;                                  // bytes
  static constexpr int kStage = kQ + 3 * H * kRowS * 2;
  static constexpr int kRed = kStage + 2 * kStageBytes;
  static constexpr int kP = kRed + 4 * H * kRedRow * 4;
  static constexpr int kCorr = kP + 3 * H * kPRow * 2;
  static constexpr int kSmem = kCorr + H * 4;
  static_assert(H == 16, "the heads are the rows of one m16 tile");
  static_assert(kKd % 64 == 0 && R == 64 * kWarps, "k16 steps in four slices; 64 columns a warp");
  static_assert(kStage % 16 == 0 && kRed % 16 == 0 && kP % 16 == 0, "16-byte boundaries");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);  // exact
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));  // exact: at most 8 bits remain
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a b: m16n8k16, bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int H, int R, int ROPE>
__global__ void __launch_bounds__(kThreads, 1)
mla_attend_tc(const float* __restrict__ qf, const __nv_bfloat16* __restrict__ ckv,
              const __nv_bfloat16* __restrict__ kpe, const long long* __restrict__ pos_p,
              float* __restrict__ part_o, float* __restrict__ part_ml, int ctx, int chunk,
              float scale) {
  using C = AttendTc<H, R, ROPE>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const sq = reinterpret_cast<bf16*>(smem + C::kQ);
  bf16* const sstage = reinterpret_cast<bf16*>(smem + C::kStage);
  float* const sred = reinterpret_cast<float*>(smem + C::kRed);
  bf16* const sp = reinterpret_cast<bf16*>(smem + C::kP);
  float* const scorr = reinterpret_cast<float*>(smem + C::kCorr);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row group and column pair
  const int split = blockIdx.x, b = blockIdx.y, n_split = gridDim.x;
  const int pos = live_pos(pos_p, ctx);
  const int c0 = split * chunk;
  if (c0 > pos) return;  // wholly past the query: the combine does not read this split
  const int last = min(c0 + chunk - 1, pos);
  const int n_tiles = (last - c0) / kTile + 1;
  const bf16* const ckv_b = ckv + static_cast<size_t>(b) * ctx * R;
  const bf16* const kpe_b = kpe + static_cast<size_t>(b) * ctx * ROPE;

  auto stage = [&](int t0, int buf) {
    bf16* const dst = sstage + buf * (kTile * C::kRowS);
    constexpr int kUnits = C::kKd / 8, kLat = R / 8;
    for (int e = tid; e < kTile * kUnits; e += kThreads) {
      const int r = e / kUnits, c = e - r * kUnits;
      const bool in = t0 + r <= last;
      const size_t t = in ? t0 + r : c0;
      const bf16* src = c < kLat ? ckv_b + t * R + c * 8 : kpe_b + t * ROPE + (c - kLat) * 8;
      cp_async16(smem_u32(dst + r * C::kRowS + c * 8), src, in ? 16u : 0u);
    }
    cp_async_commit();
  };
  stage(c0, 0);
  {  // q_lat | q_pe, split into its three bf16 parts
    const float4* const qb = reinterpret_cast<const float4*>(qf + static_cast<size_t>(b) * H * C::kKd);
    constexpr int kN = H * C::kKd / 4 / kThreads;
    static_assert(H * C::kKd / 4 % kThreads == 0, "whole float4s a thread");
    float4 v[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = qb[tid + i * kThreads];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = 4 * (tid + i * kThreads), h = e / C::kKd, k = e - h * C::kKd;
      const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bf16 hi, mid, lo;
        split3(x[u], hi, mid, lo);
        sq[(0 * H + h) * C::kRowS + k + u] = hi;
        sq[(1 * H + h) * C::kRowS + k + u] = mid;
        sq[(2 * H + h) * C::kRowS + k + u] = lo;
      }
    }
  }

  // scores: warp w takes 16 positions (two n-tiles, w % 2) and a quarter
  // of the dims (w / 2), its q fragments held in registers for the whole
  // split; softmax: heads 2w, 2w + 1; o_lat: latent columns 64 w ..
  const int nh = w & 1, kq = w >> 1;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t sq_lane =
      smem_u32(sq) + ((lane & 15) * C::kRowS + 8 * (lane >> 4)) * 2;  // A: rows, column halves
  const uint32_t sp_lane = smem_u32(sp) + ((lane & 15) * C::kPRow + 8 * (lane >> 4)) * 2;
  uint32_t qa[C::kKSteps][3][4];
  __syncthreads();  // q's parts are in shared memory
#pragma unroll
  for (int j = 0; j < C::kKSteps; ++j)
#pragma unroll
    for (int part = 0; part < 3; ++part)
      ldsm_x4(sq_lane + (part * H * C::kRowS + kq * (C::kKd / 4) + 16 * j) * 2, qa[j][part]);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = c0 + it * kTile;
    const int live = min(kTile, last - t0 + 1);
    const bf16* const tile = sstage + (it & 1) * (kTile * C::kRowS);
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; every lane has left the other tile
    if (it + 1 < n_tiles) stage(t0 + kTile, (it + 1) & 1);

    float sc[2][3][4];  // a running sum for each n-tile and part of q
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][part][e] = 0.f;
    {
      // B (k x n = dims x positions) from the tile's rows, k contiguous: four
      // 8x8 matrices = one k16 step of two n-tiles
      const uint32_t kb = smem_u32(tile) + ((16 * nh + (lane & 7) + 8 * (lane >> 4)) * C::kRowS +
                                            kq * (C::kKd / 4) + 8 * ((lane >> 3) & 1)) * 2;
#pragma unroll
      for (int j = 0; j < C::kKSteps; ++j) {
        uint32_t kf[4];
        ldsm_x4(kb + 32 * j, kf);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(sc[0][part], qa[j][part], kf[0], kf[1]);
          mma_bf16(sc[1][part], qa[j][part], kf[2], kf[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) t[e] = (sc[n][0][e] + sc[n][1][e]) + sc[n][2][e];
      float* const r = sred + (kq * H + g) * C::kRedRow + 16 * nh + 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(r) = make_float2(t[0], t[1]);
      *reinterpret_cast<float2*>(r + 8 * C::kRedRow) = make_float2(t[2], t[3]);
    }
    __syncthreads();

    // online softmax, one lane a position; p split into its three parts
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = 2 * w + k;
      float x = ((sred[h * C::kRedRow + lane] + sred[(H + h) * C::kRedRow + lane]) +
                 sred[(2 * H + h) * C::kRedRow + lane]) +
                sred[(3 * H + h) * C::kRedRow + lane];
      x = lane < live ? x * scale : -INFINITY;
      const float mn = fmaxf(m_run[k], warp_max(x));  // finite: position t0 is live
      const float cr = exp2f((m_run[k] - mn) * kLog2e);  // 0 on the first tile
      const float p = exp2f((x - mn) * kLog2e);
      l_run[k] = l_run[k] * cr + warp_sum(p);
      m_run[k] = mn;
      bf16 hi, mid, lo;
      split3(p, hi, mid, lo);
      sp[(0 * H + h) * C::kPRow + lane] = hi;
      sp[(1 * H + h) * C::kPRow + lane] = mid;
      sp[(2 * H + h) * C::kPRow + lane] = lo;
      if (lane == 0) scorr[h] = cr;
    }
    __syncthreads();

    // o_lat += p c_kv over this warp's 64 columns: 8 n-tiles, two k16 steps
    // of positions, three parts of p
    const float cr0 = scorr[g], cr1 = scorr[g + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= cr0;
      acc[j][1] *= cr0;
      acc[j][2] *= cr1;
      acc[j][3] *= cr1;
    }
    // B (k x n = positions x columns) from the tile's rows, n contiguous:
    // transposed 8x8 matrices, two n-tiles a load
    const uint32_t vb = smem_u32(tile) +
                        (((lane & 7) + 8 * ((lane >> 3) & 1)) * C::kRowS + 64 * w +
                         8 * (lane >> 4)) * 2;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      if (16 * ks >= live) break;
      uint32_t a[3][4];
#pragma unroll
      for (int part = 0; part < 3; ++part)
        ldsm_x4(sp_lane + (part * H * C::kPRow + 16 * ks) * 2, a[part]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vb + (16 * ks * C::kRowS + 16 * np) * 2, vf);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(acc[2 * np], a[part], vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], a[part], vf[2], vf[3]);
        }
      }
    }
  }

  // the split's partial: o_lat unnormalised, each head's max and sum
  float* const po = part_o + static_cast<size_t>(b * n_split + split) * H * R;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * w + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(po + g * R + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(po + (g + 8) * R + col) = make_float2(acc[j][2], acc[j][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float* const ml = part_ml + (static_cast<size_t>(b * n_split + split) * H + 2 * w + k) * 2;
      ml[0] = m_run[k];
      ml[1] = l_run[k];
    }
  }
}

// ---------------------------------------------------------------------------
// combine the splits, un-absorb
// ---------------------------------------------------------------------------

// Shared memory of a combine block, in bytes: this rank's rows of W_uv
// [rs][dv] of T, the live splits' partial rows [n_split][rs] and their
// (max, sum) pairs [n_split][2], the splits' weights [n_split], o_lat's rows
// [rs], a reduction area [kThreads], this rank's share of the output [dv]
// and the softmax's sum.
__host__ __device__ inline int combine_w_bytes(int rs, int dv, int elt) {
  return (rs * dv * elt + 15) / 16 * 16;
}
__host__ __device__ inline int combine_smem(int rs, int dv, int elt, int n_split) {
  return combine_w_bytes(rs, dv, elt) +
         4 * (n_split * rs + 2 * n_split + (n_split + 3) / 4 * 4 + rs + kThreads + dv + 4);
}

template <typename T>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
mla_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
            const T* __restrict__ w, const long long* __restrict__ pos_p, T* __restrict__ out,
            int ctx, int chunk, int n_split, int heads, int r_dim, int nope, int dv) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / kRanks, b = blockIdx.y;
  const int rs = r_dim / kRanks, r0 = rank * rs;
  const int live = min(n_split, live_pos(pos_p, ctx) / chunk + 1);
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));

  T* const sw = reinterpret_cast<T*>(smem);
  float* const spart =
      reinterpret_cast<float*>(smem + combine_w_bytes(rs, dv, static_cast<int>(sizeof(T))));
  float2* const sml = reinterpret_cast<float2*>(spart + n_split * rs);
  float* const swts = spart + n_split * rs + 2 * n_split;
  float* const solat = swts + (n_split + 3) / 4 * 4;
  float* const sred = solat + rs;
  float* const sout = sred + kThreads;
  float* const ssum = sout + dv;

  // copies in flight together: this rank's rows of W_uv, the live splits'
  // partial rows and their (max, sum) pairs
  const int wcopies = dv / kVec;
  for (int e = tid; e < rs * wcopies; e += kThreads) {
    const int r = e / wcopies, c = e - r * wcopies;
    const T* src = w + static_cast<size_t>(r0 + r) * heads * (nope + dv) +
                   static_cast<size_t>(h) * (nope + dv) + nope + c * kVec;
    cp_async16(smem_u32(sw + r * dv + c * kVec), src, 16u);
  }
  const int pcopies = rs / 4;
  for (int e = tid; e < live * pcopies; e += kThreads) {
    const int s = e / pcopies, c = e - s * pcopies;
    const float* src =
        part_o + (static_cast<size_t>(b * n_split + s) * heads + h) * r_dim + r0 + 4 * c;
    cp_async16(smem_u32(spart + s * rs + 4 * c), src, 16u);
  }
  for (int s = tid; s < live; s += kThreads)
    cp_async8(smem_u32(sml + s), part_ml + (static_cast<size_t>(b * n_split + s) * heads + h) * 2);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (tid < 32) {  // each split's weight exp(m_s - M) and the sum L of l_s exp(m_s - M)
    float mx = -INFINITY;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, sml[s].x);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float wt = exp2f((sml[s].x - mx) * kLog2e);
      swts[s] = wt;
      l = fmaf(wt, sml[s].y, l);
    }
    l = warp_sum(l);
    if (lane == 0) *ssum = l;
  }
  __syncthreads();

  // o_lat over the splits: kp threads a row, each every kp-th split in four
  // running sums, then the sums in order
  const int kp = kThreads / rs;
  {
    const int r = tid % rs, k = tid / rs;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int s = k;
    for (; s + 3 * kp < live; s += 4 * kp)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(swts[s + u * kp], spart[(s + u * kp) * rs + r], a[u]);
    for (; s < live; s += kp) a[0] = fmaf(swts[s], spart[s * rs + r], a[0]);
    sred[k * rs + r] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (tid < rs) {
    float a = 0.f;
    for (int k = 0; k < kp; ++k) a += sred[k * rs + tid];
    solat[tid] = a / *ssum;
  }
  __syncthreads();

  // this rank's share of o_lat W_uv: ns threads an output, then in order
  const int ns = kThreads / dv;
  {
    const int v = tid % dv, q = tid / dv;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int r = q;
    for (; r + 3 * ns < rs; r += 4 * ns)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = fmaf(solat[r + u * ns], to_float(sw[(r + u * ns) * dv + v]), a[u]);
    for (; r < rs; r += ns) a[0] = fmaf(solat[r], to_float(sw[r * dv + v]), a[0]);
    sred[q * dv + v] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (tid < dv) {
    float a = 0.f;
    for (int q = 0; q < ns; ++q) a += sred[q * dv + tid];
    sout[tid] = a;
  }
  cluster.sync();
  if (rank == 0 && tid < dv) {
    float a = 0.f;
    for (int q = 0; q < kRanks; ++q) a += cluster.map_shared_rank(sout, q)[tid];
    out[(static_cast<size_t>(b) * heads + h) * dv + tid] = from_float<T>(a);
  }
  cluster.sync();  // the other ranks' shares stay until rank 0 has read them
}

struct Args {
  const void *q_nope, *q_pe, *c_kv, *k_pe, *w_kvb;
  long long qn_b, qn_h, qp_b, qp_h;
  const long long* pos;
  float *qf, *part_o, *part_ml;
  void* out;
  int batch, ctx, heads, r_dim, rope, nope, dv, chunk, n_split;
  float scale;
};

template <typename T, int H, int R, int ROPE>
int launch(const Args& a, cudaStream_t st) {
  // the attention on the tensor cores for a bf16 cache at 16 heads, else on
  // the CUDA cores
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value && H == 16;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kTc)
    err = cudaFuncSetAttribute(mla_attend_tc<H, R, ROPE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               AttendTc<H, R, ROPE>::kSmem);
  else
    err = cudaFuncSetAttribute(mla_attend<T, H, R, ROPE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Attend<T, H, R, ROPE>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int csmem = combine_smem(R / kRanks, a.dv, static_cast<int>(sizeof(T)), a.n_split);
  err = cudaFuncSetAttribute(mla_combine<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, csmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = (H * R / kAbsorbRows + kWarps - 1) / kWarps;
  const int ropes = (a.batch * H * ROPE + kThreads - 1) / kThreads;
  mla_absorb<T><<<rows > ropes ? rows : ropes, kThreads, 0, st>>>(
      static_cast<const T*>(a.q_nope), a.qn_b, a.qn_h, static_cast<const T*>(a.q_pe), a.qp_b,
      a.qp_h, static_cast<const T*>(a.w_kvb), a.qf, a.batch, H, R, ROPE, a.nope, a.dv);
  const dim3 splits(a.n_split, a.batch);
  if constexpr (kTc)
    mla_attend_tc<H, R, ROPE><<<splits, kThreads, AttendTc<H, R, ROPE>::kSmem, st>>>(
        a.qf, static_cast<const T*>(a.c_kv), static_cast<const T*>(a.k_pe), a.pos, a.part_o,
        a.part_ml, a.ctx, a.chunk, a.scale);
  else
    mla_attend<T, H, R, ROPE><<<splits, kThreads, Attend<T, H, R, ROPE>::kSmem, st>>>(
        a.qf, static_cast<const T*>(a.c_kv), static_cast<const T*>(a.k_pe), a.pos, a.part_o,
        a.part_ml, a.ctx, a.chunk, a.scale);
  mla_combine<T><<<dim3(H * kRanks, a.batch), kThreads, csmem, st>>>(
      a.part_o, a.part_ml, static_cast<const T*>(a.w_kvb), a.pos, static_cast<T*>(a.out), a.ctx,
      a.chunk, a.n_split, H, R, a.nope, a.dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One layer's absorbed decode attention (see the top of this file), three
// launches on `stream`. q_nope [B, H, nope] and q_pe [B, H, rope] at the
// strides given (in elements; the last dim contiguous); c_kv [B, ctx, R] and
// k_pe [B, ctx, rope] contiguous; w_kvb [R, H (nope + dv)] contiguous; all of
// `dtype` (kF32 or kBF16), the cache and w_kvb 16-byte aligned. pos: a 0-d
// int64 on the device, the query's position (positions up to it are
// attended). Scratch: qf [B, H, R + rope], part_o [B, n_split, H, R] and
// part_ml [B, n_split, H, 2], f32, 16-byte aligned. out [B, H, dv] of
// `dtype`. The context is cut into n_split splits of `chunk` positions (a
// multiple of 32). Built for (H, R, rope) = (16, 512, 64) and (4, 32, 16).
// Returns the cudaError_t of the launches.
extern "C" int mla_decode(const void* q_nope, long long qn_b, long long qn_h, const void* q_pe,
                          long long qp_b, long long qp_h, const void* c_kv, const void* k_pe,
                          const void* w_kvb, const long long* pos, float* qf, float* part_o,
                          float* part_ml, void* out, int batch, int ctx, int heads, int r_dim,
                          int rope, int nope, int dv, int chunk, int n_split, int dtype,
                          float scale, void* stream) {
  const int elt = dtype == kBF16 ? 2 : 4;
  if (batch <= 0 || batch > 65535 || ctx <= 0 || chunk <= 0 || chunk % kTile != 0 ||
      n_split <= 0 || n_split > 4096 || static_cast<long long>(n_split) * chunk < ctx ||
      nope <= 0 || nope > kMaxNope || dv <= 0 || dv > kThreads || kThreads % dv != 0 ||
      (dv * elt) % 16 != 0 || (nope * elt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(c_kv) | reinterpret_cast<uintptr_t>(k_pe) |
                          reinterpret_cast<uintptr_t>(w_kvb) | reinterpret_cast<uintptr_t>(qf) |
                          reinterpret_cast<uintptr_t>(part_o);
  if (align & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q_nope, q_pe, c_kv, k_pe, w_kvb, qn_b, qn_h, qp_b, qp_h, pos, qf, part_o,
               part_ml, out, batch, ctx, heads, r_dim, rope, nope, dv, chunk, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool lite = heads == 16 && r_dim == 512 && rope == 64;
  const bool small = heads == 4 && r_dim == 32 && rope == 16;
  if (dtype == kBF16 && lite) return launch<__nv_bfloat16, 16, 512, 64>(a, st);
  if (dtype == kF32 && lite) return launch<float, 16, 512, 64>(a, st);
  if (dtype == kBF16 && small) return launch<__nv_bfloat16, 4, 32, 16>(a, st);
  if (dtype == kF32 && small) return launch<float, 4, 32, 16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
