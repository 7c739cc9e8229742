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
// Bound on an H100 at the encoder shape [16, 20, 1500, 64] bf16: 4*B*H*S*S*D
// = 1.84e11 operations against 246 MB of q, k, v and o, so the operations
// bound it (0.19 ms at 989 TFLOP/s bf16 on the tensor cores; the bytes take
// 0.07 ms at 3.35 TB/s).
//
// Design: one block per (batch*head, tile of 128 queries), one thread per
// query row with its scaled q and its accumulator in registers; key and
// value tiles of 32 rows are staged through shared memory as f32 and read as
// broadcasts. Like the TPU kernel, the S x S scores never reach device
// memory. This first version runs in plain f32 FMAs, not on the tensor
// cores (wgmma), so it is far from the bound: that is later work.
//
// Unlike the TPU kernel it keeps head dim 64 native (no pad to 128 lanes)
// and does not pad S to a tile multiple: the ragged key edge is masked here.

#include "common.cuh"

namespace {

constexpr int kBlockQ = 128;  // queries per block, one per thread
constexpr int kTileK = 32;    // keys per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, float scale,
           cudaStream_t stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd<T, HD><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [bh, s, hd] of `dtype` (kF32 or kBF16); hd 32 or 64.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int hd, int dtype, float scale,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && hd == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, bh, s, scale, st);
  if (dtype == kBF16 && hd == 32) return launch<__nv_bfloat16, 32>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 64) return launch<float, 64>(q, k, v, o, bh, s, scale, st);
  if (dtype == kF32 && hd == 32) return launch<float, 32>(q, k, v, o, bh, s, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
