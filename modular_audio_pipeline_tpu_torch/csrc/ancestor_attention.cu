// Ancestry-indexed beam self-attention for one decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel`
// (modular_audio_pipeline_tpu/ops/ancestor_attention.py:132, launched by
// `_pallas_ancestor_attention` at :326 through `ancestor_attention` at :462).
//
// Beam search never permutes the KV cache: hypothesis k of window b finds its
// token at cache position p in beam row anc[b, k, p]. For one query per
// hypothesis this kernel computes, over one layer of the un-permuted cache,
//   s[k, p] = (q[k] . K[b*K + anc[b,k,p], p]) * ks[...] + mask[p]   (f32)
//   w[k, p] = round(softmax_p(s[k, :]) * vs[...])                    (to q's type)
//   y[k]    = round(sum_p w[k, p] * V[b*K + anc[b,k,p], p])          (f32 sum)
// with the int8 codes' scales ks/vs only for an int8 cache. This is the
// order of rounding of ancestor_attention.py:258-307: bf16 products summed in
// f32, scales after QK and before PV, probabilities rounded before PV.
//
// Bound on an H100 at BW=16 windows, K=5 beams, H=20 heads, ctx=448, hd=64
// with the int8 cache: it must read layer l's K and V codes once (91.75 MB)
// and their scales (5.7 MB), about 29 us at 3.35 TB/s; its arithmetic is
// about 0.2 GFLOP. Bytes bound it.
//
// Design: one block per (window, head). Its K hypotheses' queries sit in
// shared memory; one thread per (hypothesis, position) reads the selected K
// row with 16-byte loads and writes the score to shared memory; one warp per
// hypothesis takes the softmax; one thread per (hypothesis, head-dim lane)
// sums the selected V rows, neighbouring lanes on neighbouring bytes.
// Positions whose mask is -inf (past the decode position) are neither read
// nor summed, so a step reads only the live context.
//
// The cache is written in place outside this kernel: the wrapper stores this
// step's K/V rows (and scales) at `pos` of layer l with one row store
// immediately before the launch, so the kernel reads them like any other
// position and needs no patching. The TPU kernel patched the new rows in and
// wrote them itself only to keep XLA's cache update in place; here the cache
// is a torch tensor and layer l is a pointer into it, so neither a layer
// slice nor the cache is ever copied.

#include "common.cuh"

namespace {

template <typename TC, int HD>
__device__ __forceinline__ void load_row(const TC* __restrict__ src, float* dst) {
  if constexpr (sizeof(TC) == 1) {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(src) + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[c * 16 + i] = static_cast<float>(b[i]);
    }
  } else if constexpr (sizeof(TC) == 2) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(src) + c);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[c * 8 + i] = __bfloat162float(b[i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(src) + c);
      dst[c * 4] = w.x;
      dst[c * 4 + 1] = w.y;
      dst[c * 4 + 2] = w.z;
      dst[c * 4 + 3] = w.w;
    }
  }
}

// q, y: [BW*K, H, HD]; ck, cv: layer l, [BW*K, H, ctx, HD]; ks, vs: layer l,
// [BW*K, H, ctx] (SCALES only); anc: [BW, K, ctx]; mask: [ctx].
template <typename TQ, typename TC, int HD, bool SCALES>
__global__ void ancestor_attention_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ ck, const TC* __restrict__ cv,
    const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ anc,
    const float* __restrict__ mask, TQ* __restrict__ y, int K, int H, int ctx) {
  extern __shared__ float smem[];
  float* qsh = smem;         // [K][HD]
  float* w = smem + K * HD;  // [K][ctx]: scores, then PV weights

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row0 = b * K;
  const int* anc_b = anc + static_cast<size_t>(b) * K * ctx;

  for (int e = tid; e < K * HD; e += blockDim.x) {
    const int k = e / HD;
    const int d = e - k * HD;
    qsh[e] = to_float(q[(static_cast<size_t>(row0 + k) * H + h) * HD + d]);
  }
  __syncthreads();

  // 1. scores, one thread per (hypothesis, position)
  for (int e = tid; e < K * ctx; e += blockDim.x) {
    const int k = e / ctx;
    const int p = e - k * ctx;
    const float mk = mask[p];
    float sc = -INFINITY;
    if (mk != -INFINITY) {
      const size_t rp = (static_cast<size_t>(row0 + anc_b[e]) * H + h) * ctx + p;
      float kr[HD];
      load_row<TC, HD>(ck + rp * HD, kr);
      const float* qk = qsh + k * HD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qk[d], kr[d], dot);
      if constexpr (SCALES) dot *= ks[rp];
      sc = dot + mk;
    }
    w[e] = sc;
  }
  __syncthreads();

  // 2. softmax over positions, one warp per hypothesis
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  for (int k = tid >> 5; k < K; k += nwarps) {
    float* wk = w + k * ctx;
    float mx = -INFINITY;
    for (int p = lane; p < ctx; p += 32) mx = fmaxf(mx, wk[p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < ctx; p += 32) {
      const float ex = expf(wk[p] - mx);
      wk[p] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int p = lane; p < ctx; p += 32) {
      float pr = wk[p] / sum;
      if constexpr (SCALES) {
        if (pr != 0.f) {
          pr *= vs[(static_cast<size_t>(row0 + anc_b[k * ctx + p]) * H + h) * ctx + p];
        }
      }
      wk[p] = round_as<TQ>(pr);
    }
  }
  __syncthreads();

  // 3. weighted sum of the selected V rows, one thread per (hypothesis, lane)
  for (int e = tid; e < K * HD; e += blockDim.x) {
    const int k = e / HD;
    const int d = e - k * HD;
    const float* wk = w + k * ctx;
    const int* ak = anc_b + k * ctx;
    float acc = 0.f;
#pragma unroll 4
    for (int p = 0; p < ctx; ++p) {
      const float pw = wk[p];
      if (pw != 0.f) {
        const size_t rp = (static_cast<size_t>(row0 + ak[p]) * H + h) * ctx + p;
        acc = fmaf(pw, to_float(cv[rp * HD + d]), acc);
      }
    }
    y[(static_cast<size_t>(row0 + k) * H + h) * HD + d] = from_float<TQ>(acc);
  }
}

template <typename TQ, typename TC, int HD>
int launch(const void* q, const void* ck, const void* cv, const void* ks, const void* vs,
           const void* anc, const void* mask, void* y, int bw, int k, int h, int ctx,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * (HD + ctx) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((k * HD + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const dim3 grid(bw, h);
  constexpr bool kScales = sizeof(TC) == 1;
  ancestor_attention_kernel<TQ, TC, HD, kScales><<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(ck), static_cast<const TC*>(cv),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(anc), static_cast<const float*>(mask), static_cast<TQ*>(y),
      k, h, ctx);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(int q_dtype, int cache_dtype, const void* q, const void* ck, const void* cv,
             const void* ks, const void* vs, const void* anc, const void* mask, void* y,
             int bw, int k, int h, int ctx, cudaStream_t st) {
  if (q_dtype == kBF16 && cache_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, HD>(q, ck, cv, ks, vs, anc, mask, y, bw, k, h, ctx, st);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, HD>(q, ck, cv, ks, vs, anc, mask, y, bw, k, h,
                                                    ctx, st);
  if (q_dtype == kF32 && cache_dtype == kI8)
    return launch<float, int8_t, HD>(q, ck, cv, ks, vs, anc, mask, y, bw, k, h, ctx, st);
  if (q_dtype == kF32 && cache_dtype == kF32)
    return launch<float, float, HD>(q, ck, cv, ks, vs, anc, mask, y, bw, k, h, ctx, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// See the kernel for layouts. ks/vs are read only for an int8 cache
// (cache_dtype kI8) and may be null otherwise. Launches on `stream` and
// returns the cudaError_t of the launch.
extern "C" int ancestor_attention_fwd(const void* q, const void* ck, const void* cv,
                                      const void* ks, const void* vs, const void* anc,
                                      const void* mask, void* y, int bw, int k, int h,
                                      int ctx, int hd, int q_dtype, int cache_dtype,
                                      void* stream) {
  if (bw <= 0 || k <= 0 || h <= 0 || h > 65535 || ctx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cache_dtype == kI8 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch<64>(q_dtype, cache_dtype, q, ck, cv, ks, vs, anc, mask, y, bw, k, h, ctx, st);
  if (hd == 32)
    return dispatch<32>(q_dtype, cache_dtype, q, ck, cv, ks, vs, anc, mask, y, bw, k, h, ctx, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
