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
// order of rounding of ancestor_attention.py:258-307, kept here: operands in
// q's type summed in f32, the K scale after QK, probabilities normalised over
// the whole live context, times the V scale, rounded to q's type, then PV
// summed in f32. No float atomics: every sum has a fixed order, so two runs
// give the same bits.
//
// Bound on an H100 at BW=16 windows, K=5 beams, H=20 heads, ctx=448, hd=64
// with the int8 cache: it must read the selected K and V codes of layer l once
// (at most 91.75 MB, 57 MB when the hypotheses pick rows at random, 18 MB when
// they share their ancestry as in real decoding) and their scales, 6-29 us at
// 3.35 TB/s; its arithmetic is about 0.2 GFLOP. Bytes bound it, so the design
// is built around wide loads in flight; the products are too small for the
// tensor cores and run as f32 FMAs.
//
// Design. Every lane does useful work and every cache load is 16 bytes wide
// (one-byte loads behind a serial walk of the context left the memory system
// idle; eight lanes a row summed by shuffles, with a row read once for all
// the hypotheses that select it, was bound by its instructions: a warp-wide
// loop over the hypotheses with most lanes idle):
//   1. scores: one thread per (hypothesis, position) loads the selected K row
//      (64 bytes of int8 as four 16-byte loads, all issued before the first
//      is used, two rows in flight a thread), turns the codes into floats by
//      an exponent trick (two full-rate operations a code, not the
//      quarter-rate converter) and takes the dot product with q from shared
//      memory, times the K scale, plus the mask;
//   2. softmax: one warp per hypothesis takes the max and the sum of exp; one
//      thread per (hypothesis, position) then normalises, multiplies by the
//      V scale and rounds to q's type: every weight is rounded once, before
//      any product with V;
//   3. PV: one thread per (hypothesis, 16-byte chunk of the row) walks a
//      share of the positions, eight loads in flight, with its chunk's sums
//      in registers; the shares are added through shared memory in a fixed
//      order.
// Threads that select the same row (the beams of a window share almost all
// of their ancestry in real decoding) read the same addresses at the same
// time, so the row comes from device memory once and from L1 after that.
// One (window, head) is one cluster of `split` blocks, each taking a
// contiguous chunk of the positions: the chunk maxima and sums are exchanged
// through distributed shared memory (the global max and sum are known before
// any weight is rounded), and rank 0 adds the chunks' PV sums in rank order.
// With split = 1 the launch is a plain one of one block per (window, head),
// which is what a full batch takes: there the split only adds cluster
// barriers (0.049 ms at 1, 0.059 ms at 2 blocks); one window alone (20 blocks
// for 132 SMs) gains from it (0.022 ms at 1, 0.015 ms at 4 blocks). Positions
// whose mask is -inf are neither read nor summed, so the short context
// buckets stay cheap.
//
// The cache is written in place: this step's K/V rows (and scales) arrive
// beside the cache, position `pos` is read from them, and the block that owns
// `pos` stores them into layer l. Nothing in the launch reads the cache at
// `pos`, so the store needs no ordering against the loads, and the wrapper
// needs no separate copy launches before the kernel. The TPU kernel patched
// the new rows in and wrote them itself to keep XLA's cache update in place;
// here the cache is a torch tensor and layer l is a pointer into it, so
// neither a layer slice nor the cache is ever copied.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py, int8 cache,
// 16 windows x 5 beams x 20 heads, on the device: 0.052 ms at ctx 448 with
// random ancestry (0.223 ms before this design), 0.043 ms with shared
// ancestry, 0.014 ms at ctx 64 (0.022 ms before); bound 0.020 ms. 80
// registers, three blocks of 256 threads on an SM. PERF.md section 6.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScoreRows = 2;  // K rows a thread keeps in flight in the score pass
constexpr int kValueRows = 8;  // V chunks a thread keeps in flight in the PV pass
constexpr int kMaxBeams = 32;
constexpr int kMaxSplit = 8;   // portable cluster size

// One 16-byte chunk of a cache row as floats.
template <typename TC>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16 / sizeof(TC)]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(TC) == 1) {
    // int8 code -> float, exactly: the byte of (code + 128) lands in the
    // mantissa of 2^23 (0x4B000000, ulp 1), then 2^23 + 128 is taken off.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
      f[4 * i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.0f;
      f[4 * i + 1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.0f;
      f[4 * i + 2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.0f;
      f[4 * i + 3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.0f;
    }
  } else if constexpr (sizeof(TC) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
}

// q, y: [BW*K, H, HD]; ck, cv: layer l, [BW*K, H, ctx, HD]; ks, vs: layer l,
// [BW*K, H, ctx] (SCALES only); anc: [BW, K, ctx]; mask: [ctx]. With pos >= 0,
// nk, nv: [BW*K, H, HD] and nks, nvs: [BW*K, H] are this step's rows: position
// pos is read from them, and the block that owns pos stores them into the
// cache (nothing in this launch reads the cache at pos, so the store needs
// no ordering against the loads).
// grid (BW * split, H) in clusters of (split, 1, 1); block r of a cluster
// takes positions [r * chunk, min(ctx, (r + 1) * chunk)).
template <typename TQ, typename TC, int HD, bool SCALES, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 3)
ancestor_attention_kernel(
    const TQ* __restrict__ q, TC* ck, TC* cv, float* ks, float* vs,
    const int* __restrict__ anc, const float* __restrict__ mask, TQ* __restrict__ y,
    const TC* __restrict__ nk, const TC* __restrict__ nv, const float* __restrict__ nks,
    const float* __restrict__ nvs, int pos, int K, int H, int ctx, int chunk) {
  constexpr int EC = 16 / sizeof(TC);      // elements of a 16-byte chunk
  constexpr int C = HD / EC;               // chunks of a row
  constexpr int PC = C < 4 ? C : 4;        // chunks the score pass loads at once
  constexpr int NP = C / PC;               // such pieces of a row

  // Without CLUSTER the launch is a plain one of one block per (window, head).
  cg::cluster_group cluster = cg::this_cluster();
  const int split = CLUSTER ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = CLUSTER ? static_cast<int>(cluster.block_rank()) : 0;
  auto sync_ranks = [&] {
    if constexpr (CLUSTER) cluster.sync(); else __syncthreads();
  };
  auto of_rank = [&](float* mine, int r) {
    if constexpr (CLUSTER) return cluster.map_shared_rank(mine, r); else return mine;
  };

  extern __shared__ float smem[];
  float* qs = smem;                        // [K][HD]
  float* w = qs + K * HD;                  // [K][chunk] scores, then exp, then PV weights
  float* red = w + K * chunk;              // [kThreads][EC] PV sums of the position shares
  float* part = red + kThreads * EC;       // [K][HD] this block's PV sums, read by rank 0
  float* lstat = part + K * HD;            // [2][K] chunk max, chunk sum, read by every rank
  float* gstat = lstat + 2 * K;            // [2][K] global max, global sum
  float* vsc = gstat + 2 * K;              // [K][chunk] V scales of the selected rows (SCALES)
  float* msk = vsc + (SCALES ? K * chunk : 0);                // [chunk] the mask
  uint8_t* ancs = reinterpret_cast<uint8_t*>(msk + chunk);    // [K][chunk] beam rows

  const int b = blockIdx.x / split;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = b * K;
  const int p0 = rank * chunk;
  const int len = max(0, min(chunk, ctx - p0));
  const int n_items = K * len;
  const int* anc_b = anc + static_cast<size_t>(b) * K * ctx;
  const uint4* ck4 = reinterpret_cast<const uint4*>(ck);
  const uint4* cv4 = reinterpret_cast<const uint4*>(cv);
  const uint4* nk4 = reinterpret_cast<const uint4*>(nk);
  const uint4* nv4 = reinterpret_cast<const uint4*>(nv);
  const int fresh = pos - p0;  // local index of this step's position, if it is in this chunk

  for (int e = tid; e < K * HD; e += kThreads) {
    const int k = e / HD;
    const int d = e - k * HD;
    qs[e] = to_float(q[(static_cast<size_t>(row0 + k) * H + h) * HD + d]);
  }
  if (fresh >= 0 && fresh < len) {
    for (int e = tid; e < K * C; e += kThreads) {
      const size_t row = static_cast<size_t>(row0 + e / C) * H + h;
      const size_t dst = (row * ctx + pos) * C + e % C;
      reinterpret_cast<uint4*>(ck)[dst] = nk4[row * C + e % C];
      reinterpret_cast<uint4*>(cv)[dst] = nv4[row * C + e % C];
    }
    if constexpr (SCALES) {
      for (int k = tid; k < K; k += kThreads) {
        const size_t row = static_cast<size_t>(row0 + k) * H + h;
        ks[row * ctx + pos] = nks[row];
        vs[row * ctx + pos] = nvs[row];
      }
    }
  }
  for (int pl = tid; pl < len; pl += kThreads) {
    msk[pl] = mask[p0 + pl];
    for (int k = 0; k < K; ++k)
      ancs[k * chunk + pl] = static_cast<uint8_t>(anc_b[k * ctx + p0 + pl]);
  }
  __syncthreads();

  // 1. scores, one thread per (hypothesis, position)
  for (int it = tid; it < n_items; it += kThreads * kScoreRows) {
    int k[kScoreRows], pl[kScoreRows];
    const uint4* src[kScoreRows];
    float mk[kScoreRows], sc[kScoreRows], dot[kScoreRows];
#pragma unroll
    for (int u = 0; u < kScoreRows; ++u) {
      const int item = it + u * kThreads;
      mk[u] = -INFINITY;
      sc[u] = 1.f;
      dot[u] = 0.f;
      k[u] = pl[u] = 0;
      src[u] = ck4;
      if (item < n_items) {
        k[u] = item / len;
        pl[u] = item - k[u] * len;
        mk[u] = msk[pl[u]];
        if (mk[u] != -INFINITY) {
          const size_t row = static_cast<size_t>(row0 + ancs[k[u] * chunk + pl[u]]) * H + h;
          const size_t rp = row * ctx + p0 + pl[u];
          const bool is_new = pl[u] == fresh;
          src[u] = is_new ? nk4 + row * C : ck4 + rp * C;
          if constexpr (SCALES) {
            sc[u] = is_new ? __ldg(nks + row) : ks[rp];
            vsc[k[u] * chunk + pl[u]] = is_new ? __ldg(nvs + row) : vs[rp];  // for pass 2
          }
        }
      }
    }
#pragma unroll
    for (int piece = 0; piece < NP; ++piece) {
      uint4 raw[kScoreRows][PC];
#pragma unroll
      for (int u = 0; u < kScoreRows; ++u) {
        if (mk[u] != -INFINITY) {
#pragma unroll
          for (int c = 0; c < PC; ++c) raw[u][c] = __ldg(src[u] + piece * PC + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kScoreRows; ++u) {
        if (mk[u] != -INFINITY) {
          const float* qk = qs + k[u] * HD + piece * PC * EC;
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            float f[EC];
            unpack<TC>(raw[u][c], f);
#pragma unroll
            for (int e = 0; e < EC; ++e) dot[u] = fmaf(qk[c * EC + e], f[e], dot[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kScoreRows; ++u) {
      if (it + u * kThreads < n_items)
        w[k[u] * chunk + pl[u]] = mk[u] != -INFINITY ? dot[u] * sc[u] + mk[u] : -INFINITY;
    }
  }
  __syncthreads();

  // 2. softmax over the whole context: chunk max, global max, exp, chunk sum,
  // global sum (ranks added in order), then every weight normalised, scaled
  // and rounded once
  for (int k = warp; k < K; k += kWarps) {
    float mx = -INFINITY;
    for (int p = lane; p < len; p += 32) mx = fmaxf(mx, w[k * chunk + p]);
    mx = warp_max(mx);
    if (lane == 0) lstat[k] = mx;
  }
  sync_ranks();
  for (int k = tid; k < K; k += kThreads) {
    float mx = -INFINITY;
    for (int r = 0; r < split; ++r) mx = fmaxf(mx, of_rank(lstat, r)[k]);
    gstat[k] = mx;
  }
  __syncthreads();
  for (int k = warp; k < K; k += kWarps) {
    const float mx = gstat[k];
    float sum = 0.f;
    for (int p = lane; p < len; p += 32) {
      const float ex = expf(w[k * chunk + p] - mx);
      w[k * chunk + p] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    if (lane == 0) lstat[K + k] = sum;
  }
  sync_ranks();
  for (int k = tid; k < K; k += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < split; ++r) sum += of_rank(lstat, r)[K + k];
    gstat[K + k] = sum;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const float sum = gstat[K + k];
    for (int pl = tid; pl < len; pl += kThreads) {
      float pr = w[k * chunk + pl] / sum;
      if constexpr (SCALES) {
        if (pr != 0.f) pr *= vsc[k * chunk + pl];
      }
      w[k * chunk + pl] = round_as<TQ>(pr);
    }
  }
  __syncthreads();

  // 3. weighted sums of the selected V rows: a thread owns one (hypothesis,
  // 16-byte chunk) column and one share of the positions
  const int cols = K * C;
  const int cpp = min(cols, kThreads);  // columns per pass
  const int ng = kThreads / cpp;        // position shares
  const int pg = tid / cpp;
  const int ci = tid - pg * cpp;
  for (int col0 = 0; col0 < cols; col0 += cpp) {
    const int col = col0 + ci;
    const bool active = pg < ng && col < cols;
    const int k = col / C;
    const int c = col - k * C;
    float acc[EC];
#pragma unroll
    for (int e = 0; e < EC; ++e) acc[e] = 0.f;
    if (active) {
      const float* wk = w + k * chunk;
      const uint8_t* ak = ancs + k * chunk;
      for (int pb = pg; pb < len; pb += ng * kValueRows) {
        float pw[kValueRows];
        uint4 raw[kValueRows];
#pragma unroll
        for (int u = 0; u < kValueRows; ++u) {
          const int pl = pb + u * ng;
          pw[u] = pl < len ? wk[pl] : 0.f;
          if (pw[u] != 0.f) {
            const size_t row = static_cast<size_t>(row0 + ak[pl]) * H + h;
            raw[u] = __ldg(pl == fresh ? nv4 + row * C + c : cv4 + (row * ctx + p0 + pl) * C + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kValueRows; ++u) {
          if (pw[u] != 0.f) {
            float f[EC];
            unpack<TC>(raw[u], f);
#pragma unroll
            for (int e = 0; e < EC; ++e) acc[e] = fmaf(pw[u], f[e], acc[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < EC; ++e) red[(pg * cpp + ci) * EC + e] = acc[e];
    }
    __syncthreads();
    for (int o = tid; o < cpp * EC; o += kThreads) {
      const int oc = o / EC;
      const int e = o - oc * EC;
      if (col0 + oc < cols) {
        float sum = 0.f;
        for (int gi = 0; gi < ng; ++gi) sum += red[(gi * cpp + oc) * EC + e];  // share order
        const int ok = (col0 + oc) / C;
        const int ocn = (col0 + oc) - ok * C;
        part[ok * HD + ocn * EC + e] = sum;
      }
    }
    __syncthreads();
  }

  // 4. the chunks' sums in rank order
  sync_ranks();
  if (rank == 0) {
    for (int e = tid; e < K * HD; e += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < split; ++r) sum += of_rank(part, r)[e];
      const int k = e / HD;
      const int d = e - k * HD;
      y[(static_cast<size_t>(row0 + k) * H + h) * HD + d] = from_float<TQ>(sum);
    }
  }
  if constexpr (CLUSTER) cluster.sync();  // rank 0 has read every block's shared memory
}

// Blocks per (window, head) when the caller leaves the choice open. With a
// block for every SM already (16 windows x 20 heads) a split only adds cluster
// barriers and loses (chip_smoke.py prints the sweep); with few (window, head)
// pairs, one short file or a narrow model, it is the only way to fill the
// card: double while the grid stays within two blocks per SM and a block
// keeps at least 64 positions.
int auto_split(int bw, int h, int ctx) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
    return n;
  }();
  int split = 1;
  while (2 * split <= kMaxSplit && bw * h * 2 * split <= 2 * sms && ctx / (2 * split) >= 64)
    split *= 2;
  return split;
}

// The pointers and sizes of one call, as the C interface receives them.
struct Args {
  const void* q;
  void *ck, *cv, *ks, *vs;
  const void *anc, *mask;
  void* y;
  const void *nk, *nv, *nks, *nvs;
  int pos, bw, k, h, ctx, split;
};

template <typename TQ, typename TC, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int bw = a.bw, k = a.k, h = a.h, ctx = a.ctx;
  int split = a.split;
  constexpr bool kScales = sizeof(TC) == 1;
  if (split <= 0) split = auto_split(bw, h, ctx);
  auto kernel = split > 1 ? ancestor_attention_kernel<TQ, TC, HD, kScales, true>
                          : ancestor_attention_kernel<TQ, TC, HD, kScales, false>;
  if (split > kMaxSplit || split > ctx) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (ctx + split - 1) / split;
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * k * HD +
                                       (kScales ? 2 : 1) * k * chunk + chunk +
                                       kThreads * (16 / sizeof(TC)) + 4 * k) +
                      static_cast<size_t>(k) * chunk;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bw * split, h);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q), static_cast<TC*>(a.ck), static_cast<TC*>(a.cv),
      static_cast<float*>(a.ks), static_cast<float*>(a.vs), static_cast<const int*>(a.anc),
      static_cast<const float*>(a.mask), static_cast<TQ*>(a.y), static_cast<const TC*>(a.nk),
      static_cast<const TC*>(a.nv), static_cast<const float*>(a.nks),
      static_cast<const float*>(a.nvs), a.pos, k, h, ctx, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(int q_dtype, int cache_dtype, const Args& a, cudaStream_t st) {
  if (q_dtype == kBF16 && cache_dtype == kI8) return launch<__nv_bfloat16, int8_t, HD>(a, st);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, HD>(a, st);
  if (q_dtype == kF32 && cache_dtype == kI8) return launch<float, int8_t, HD>(a, st);
  if (q_dtype == kF32 && cache_dtype == kF32) return launch<float, float, HD>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// See the kernel for layouts. ks/vs are read only for an int8 cache
// (cache_dtype kI8) and may be null otherwise. With pos >= 0, nk/nv (and
// nks/nvs for an int8 cache) are this step's rows: they are read at position
// pos and stored into the cache there, in place; pos < 0 reads the cache as
// it is. A pos at or past ctx takes the last position, ctx - 1: the write is
// clamped as the JAX package's dynamic_update_slice clamps its start, so a
// row never lands outside the cache. `split` is the number of blocks (one cluster) per (window, head), 1
// to 8, or 0 to let the launcher choose from the shape; the result does not
// depend on it beyond the order of the f32 sums. At most 32 beams. Launches
// on `stream` and returns the cudaError_t of the launch.
extern "C" int ancestor_attention_fwd(const void* q, void* ck, void* cv, void* ks, void* vs,
                                      const void* anc, const void* mask, void* y,
                                      const void* nk, const void* nv, const void* nks,
                                      const void* nvs, int pos, int bw, int k, int h, int ctx,
                                      int hd, int q_dtype, int cache_dtype, int split,
                                      void* stream) {
  if (bw <= 0 || k <= 0 || k > kMaxBeams || h <= 0 || h > 65535 || ctx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos >= ctx) pos = ctx - 1;
  if (cache_dtype == kI8 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos >= 0 && (nk == nullptr || nv == nullptr ||
                   (cache_dtype == kI8 && (nks == nullptr || nvs == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q, ck, cv, ks, vs, anc, mask, y, nk, nv, nks, nvs, pos < 0 ? -1 : pos,
                  bw, k, h, ctx, split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch<64>(q_dtype, cache_dtype, a, st);
  if (hd == 32) return dispatch<32>(q_dtype, cache_dtype, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
