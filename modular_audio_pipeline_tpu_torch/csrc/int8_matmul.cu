// Weight-only int8 matrix product for the Whisper decoder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_int8_matmul_kernel`
// (modular_audio_pipeline_tpu/ops/quant.py:39, launched by
// `_int8_matmul_pallas` at :54 through `int8_matmul` at :69).
//
// Computes out[M, N] f32 = (bf16(x)[M, K] @ wq[K, N] int8) * ws[N] f32:
// x is rounded to bf16 on load whatever its type (the TPU wrapper casts it),
// the int8 codes are exact in bf16, every product x*code is exact in f32, the
// sum is accumulated in f32, and the per-column scale multiplies the finished
// sum once. No bias: the caller adds it in f32.
//
// Bound on an H100: the decode step (M = 80 rows: 16 windows x 5 beams) reads
// every weight once and reuses it for 80 rows only, so the bytes bound it.
// The logits head (K 1280, N 51968) moves 66.5 MB of codes + 16.6 MB of f32
// output, 25 us at 3.35 TB/s, against 10.6 GFLOP = 11 us at the bf16 tensor-
// core rate. The cross K/V product (M = 24000) is bound by its operations.
// Stored as int8 the weights are half the bytes of bf16: that halving is the
// whole point of the kernel, so the codes must reach the multiplier without a
// dequantised copy ever landing in device memory.
//
// Design: the product runs on the tensor cores (mma.sync m16n8k16, bf16 x
// bf16 -> f32). One block of four warps owns a tile of 16*MT rows by 32*NW
// columns and walks its share of K in stages of 64: the x tile (rounded to
// bf16) and the raw int8 code tile go through shared memory; each warp owns
// 8*NW columns, reads its four codes per fragment as bytes, converts them to
// bf16 in registers (an exponent trick: two integer/float ops per code, no
// int-to-float unit) and reuses the fragment for all MT row tiles. The next
// stage's global loads are issued before this stage's products. Codes are
// loaded as 16-byte vectors when N is a multiple of 16 and aligned; any other
// M, K, N takes scalar loads, and every edge is masked.
//
// The few rows of a decode step leave a 1280-column projection with 40 tiles
// for 132 SMs, each a long dependent chain along K. So K is split across
// blocks (grid z) until about four blocks per SM exist; the partial sums go
// to a workspace and a second small kernel adds them in a fixed order and
// applies the scale, which keeps "the scale multiplies the finished sum" and
// makes the result the same on every run (no atomics). Wide outputs (the
// logits head, the cross K/V) take 128-column tiles instead, so that x is
// re-read from L2 a quarter as often, and need no split.
//
// Unlike the TPU kernel it takes every shape (the TPU wrapper admits only
// N % 512 == 0 and K % 128 == 0 and pads M to 8). wgmma, TMA and a deeper
// pipeline are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBK = 64;        // depth of one shared-memory stage
constexpr int kXPad = 8;       // bf16 elements: rows 144 bytes apart, conflict-free fragments
constexpr int kCPad = 16;      // bytes: keeps code rows 16-byte aligned and the banks apart
constexpr int kMinSlice = 128; // a split along K keeps at least two stages per block
constexpr int kMaxSplits = 32;

// int8 code (as its unsigned byte) -> float, exactly: 0x4B000000 is 2^23, whose
// float has an ulp of 1, so the byte (code + 128) lands in the mantissa.
__device__ __forceinline__ float code_to_float(uint32_t byte) {
  return __uint_as_float(0x4B000080u ^ byte) - 8388736.0f;  // 2^23 + 128
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

// Two neighbouring x values along K as one bf16x2 word (low half = lower k),
// zero outside [.., k_end) and beyond row M.
template <typename T>
__device__ __forceinline__ uint32_t load_x_pair(const T* __restrict__ x, int m, int k, int M,
                                                int K, int k_end, bool pairs) {
  if (m >= M || k >= k_end) return 0u;
  const T* p = x + static_cast<size_t>(m) * K + k;
  if (pairs && k + 1 < k_end) {
    if constexpr (sizeof(T) == 2) {
      return *reinterpret_cast<const uint32_t*>(p);  // already bf16x2
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      return pack_bf16(v.x, v.y);
    }
  }
  const float lo = to_float(p[0]);
  const float hi = (k + 1 < k_end) ? to_float(p[1]) : 0.f;
  return pack_bf16(lo, hi);
}

// out: [M, N] when gridDim.z == 1 (scaled here), else the workspace
// [gridDim.z, M, N] of unscaled partial sums.
template <typename T, int MT, int NW, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wq,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int M, int K, int N, int k_slice, bool x_pairs) {
  constexpr int BM = 16 * MT;
  constexpr int BN = 32 * NW;
  constexpr int XS = kBK + kXPad;              // xs row stride, bf16 elements
  constexpr int CS = BN + kCPad;               // cs row stride, bytes
  constexpr int XPT = BM * kBK / 2 / kThreads; // bf16x2 words of x a thread stages
  constexpr int CVT = kBK * BN / 16 / kThreads;  // 16-byte code vectors a thread stages
  static_assert(BM * kBK / 2 % kThreads == 0 && kBK * BN / 16 % kThreads == 0, "tile/threads");

  __shared__ __align__(16) __nv_bfloat16 xs[BM][XS];
  __shared__ __align__(16) uint8_t cs[kBK][CS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row / column group
  const int t = tid & 3;          // position in the group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_slice;
  const int k_end = min(K, k_begin + k_slice);

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
      const int idx = e * kThreads + tid;  // consecutive threads walk along K
      xr[e] = load_x_pair(x, m0 + idx / (kBK / 2), k0 + 2 * (idx % (kBK / 2)), M, K, k_end,
                          x_pairs);
    }
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < CVT; ++e) {
        const int idx = e * kThreads + tid;
        const int k = k0 + idx / (BN / 16);
        const int n = n0 + (idx % (BN / 16)) * 16;
        cv[e] = (k < k_end && n < N)  // N % 16 == 0: a vector is inside or outside as a whole
                    ? *reinterpret_cast<const int4*>(wq + static_cast<size_t>(k) * N + n)
                    : make_int4(0, 0, 0, 0);
      }
    }
  };

  auto store_shared = [&](int k0) {
#pragma unroll
    for (int e = 0; e < XPT; ++e) {
      const int idx = e * kThreads + tid;
      *reinterpret_cast<uint32_t*>(&xs[idx / (kBK / 2)][2 * (idx % (kBK / 2))]) = xr[e];
    }
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < CVT; ++e) {
        const int idx = e * kThreads + tid;
        *reinterpret_cast<int4*>(&cs[idx / (BN / 16)][(idx % (BN / 16)) * 16]) = cv[e];
      }
    } else {
      // ragged N: byte loads straight into shared memory, no staging registers
      for (int idx = tid; idx < kBK * BN; idx += kThreads) {
        const int k = k0 + idx / BN;
        const int n = n0 + idx % BN;
        cs[idx / BN][idx % BN] =
            (k < k_end && n < N) ? wq[static_cast<size_t>(k) * N + n] : static_cast<uint8_t>(0);
      }
    }
  };

  load_global(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    store_shared(k0);
    __syncthreads();
    if (k0 + kBK < k_end) load_global(k0 + kBK);  // in flight during the products below

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[NW][2];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        // B fragment: column g of the warp's j-th group of 8, rows 2t, 2t+1 and 2t+8, 2t+9
        const uint8_t* c = &cs[kk + 2 * t][(warp * NW + j) * 8 + g];
        b[j][0] = pack_bf16(code_to_float(c[0]), code_to_float(c[CS]));
        b[j][1] = pack_bf16(code_to_float(c[8 * CS]), code_to_float(c[9 * CS]));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // A fragment: rows g and g+8 of row tile i, columns 2t, 2t+1 and 2t+8, 2t+9
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
  const bool scale_now = gridDim.z == 1;  // else the reduction applies the scale
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int n = n0 + (warp * NW + j) * 8 + 2 * t;
    const float s0 = (scale_now && n < N) ? ws[n] : 1.f;
    const float s1 = (scale_now && n + 1 < N) ? ws[n + 1] : 1.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float* row = dst + static_cast<size_t>(m) * N;
        if (n < N) row[n] = acc[i][j][2 * h] * s0;
        if (n + 1 < N) row[n + 1] = acc[i][j][2 * h + 1] * s1;
      }
    }
  }
}

// out[m, n] = (sum over splits, in order, of part[s, m, n]) * ws[n]
__global__ void __launch_bounds__(256)
int8_matmul_reduce(const float* __restrict__ part, const float* __restrict__ ws,
                   float* __restrict__ out, size_t mn, int N, int splits) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[static_cast<size_t>(s) * mn + i];
    out[i] = sum * ws[i % N];
  }
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

struct Plan {
  int mt;       // row tiles of 16 per block
  int nw;       // column groups of 8 per warp
  int splits;   // blocks along K
  int k_slice;  // K per split, a multiple of kBK
};

Plan make_plan(int m, int k, int n) {
  Plan p;
  p.mt = m <= 16 ? 1 : 5;  // 80 rows: one decode step of 16 windows x 5 beams
  const int row_blocks = (m + 16 * p.mt - 1) / (16 * p.mt);
  const int sms = sm_count();
  // wide tiles when they still fill the card: x is re-read from L2 once per column tile
  p.nw = static_cast<long long>(row_blocks) * ((n + 127) / 128) >= 2LL * sms ? 4 : 1;
  const long long blocks = static_cast<long long>(row_blocks) * ((n + 32 * p.nw - 1) / (32 * p.nw));
  // too few tiles to fill the card: split K until about four blocks per SM exist
  const long long want = blocks >= 2LL * sms ? 1 : (4LL * sms + blocks - 1) / blocks;
  const int cap = k / kMinSlice < 1 ? 1 : (k / kMinSlice > kMaxSplits ? kMaxSplits : k / kMinSlice);
  const int s = want > cap ? cap : static_cast<int>(want);
  p.k_slice = ((k + s - 1) / s + kBK - 1) / kBK * kBK;
  p.splits = (k + p.k_slice - 1) / p.k_slice;
  return p;
}

template <typename T, int MT, int NW>
int launch_tile(const void* x, const void* wq, const void* ws, float* dst, int m, int k, int n,
                const Plan& p, cudaStream_t stream) {
  const dim3 grid((m + 16 * MT - 1) / (16 * MT), (n + 32 * NW - 1) / (32 * NW), p.splits);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const bool x_pairs = k % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(wq);
  const float* sp = static_cast<const float*>(ws);
  if (vec)
    int8_matmul_kernel<T, MT, NW, true><<<grid, kThreads, 0, stream>>>(
        xp, wp, sp, dst, m, k, n, p.k_slice, x_pairs);
  else
    int8_matmul_kernel<T, MT, NW, false><<<grid, kThreads, 0, stream>>>(
        xp, wp, sp, dst, m, k, n, p.k_slice, x_pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* wq, const void* ws, void* out, void* workspace, int m,
           int k, int n, cudaStream_t stream) {
  const Plan p = make_plan(m, k, n);
  if (p.splits > 1 && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* dst = static_cast<float*>(p.splits > 1 ? workspace : out);
  int rc;
  if (p.mt == 1 && p.nw == 1) rc = launch_tile<T, 1, 1>(x, wq, ws, dst, m, k, n, p, stream);
  else if (p.mt == 1) rc = launch_tile<T, 1, 4>(x, wq, ws, dst, m, k, n, p, stream);
  else if (p.nw == 1) rc = launch_tile<T, 5, 1>(x, wq, ws, dst, m, k, n, p, stream);
  else rc = launch_tile<T, 5, 4>(x, wq, ws, dst, m, k, n, p, stream);
  if (rc != 0 || p.splits == 1) return rc;
  const size_t mn = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  int8_matmul_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(workspace), static_cast<const float*>(ws),
      static_cast<float*>(out), mn, n, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of splits along K that int8_matmul_fwd takes at this shape: the
// caller allocates a workspace of splits * m * n floats when it is above 1.
extern "C" int int8_matmul_splits(int m, int k, int n) {
  if (m <= 0 || k <= 0 || n <= 0) return 1;
  return make_plan(m, k, n).splits;
}

// x: contiguous [m, k] of `dtype` (kF32 or kBF16); wq: contiguous [k, n] int8;
// ws: [n] f32; out: contiguous [m, n] f32; workspace: int8_matmul_splits(m, k, n)
// * m * n floats, or null when that is 1. Any m, k, n >= 1. Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int int8_matmul_fwd(const void* x, const void* wq, const void* ws, void* out,
                               void* workspace, int m, int k, int n, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, wq, ws, out, workspace, m, k, n, st);
  if (dtype == kF32) return launch<float>(x, wq, ws, out, workspace, m, k, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
