// Native host runtime of the audio pipeline (a copy of the JAX package's).
//
// The device does all heavy DSP/model compute; what remains on the host is
// sequential bookkeeping that Python runs 100-1000x slower than C++:
//
//  - dtw_path:       monotonic DTW backtrace for word-timestamp alignment
//                    (S x T dynamic program, ~340k cells per 30 s window)
//  - pcm16_to_f32 /  sample-format conversion for WAV ingest/egress
//    f32_to_pcm16    (NumPy is fine here; the C path avoids temp copies)
//  - crossfade_concat: linear crossfade joins used by silence removal
//
// Built with: g++ -O3 -march=native -shared -fPIC map_audio.cc -o libmap_audio.so
// Loaded via ctypes (runtime/native_lib.py); every entry point has a pure
// NumPy fallback, so the extension is an accelerator, never a dependency.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Monotonic DTW through cost[s][t]; writes the column (audio frame) where
// each token row starts into cols[s]. Moves: diagonal, up, left.
void dtw_path(const double* cost, int32_t s_len, int32_t t_len, int64_t* cols) {
  const double inf = std::numeric_limits<double>::infinity();
  const int32_t w = t_len + 1;

  std::vector<double> prev(w, inf), cur(w, inf);
  std::vector<int8_t> trace(static_cast<size_t>(s_len + 1) * w, 0);
  prev[0] = 0.0;

  for (int32_t i = 1; i <= s_len; ++i) {
    const double* row_cost = cost + static_cast<size_t>(i - 1) * t_len;
    int8_t* trace_row = trace.data() + static_cast<size_t>(i) * w;
    cur[0] = inf;
    for (int32_t j = 1; j <= t_len; ++j) {
      double best = prev[j - 1];  // diagonal
      int8_t move = 0;
      if (prev[j] < best) { best = prev[j]; move = 1; }      // up
      if (cur[j - 1] < best) { best = cur[j - 1]; move = 2; }  // left
      cur[j] = row_cost[j - 1] + best;
      trace_row[j] = move;
    }
    std::swap(prev, cur);
  }

  int32_t i = s_len, j = t_len;
  while (i > 0 && j > 0) {
    cols[i - 1] = j - 1;
    const int8_t move = trace[static_cast<size_t>(i) * w + j];
    if (move == 0) { --i; --j; }
    else if (move == 1) { --i; }
    else { --j; }
  }
  // unreached leading rows (possible if j hit 0 first) start at frame 0
  while (i > 0) { cols[--i] = 0; }
}

void pcm16_to_f32(const int16_t* in, float* out, int64_t n) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kScale;
}

void f32_to_pcm16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(v);
  }
}

// Concatenate n_chunks float buffers with linear crossfades.
// chunk_lens[i] samples per chunk, xf_lens[i] = crossfade into chunk i
// (xf_lens[0] ignored). Returns the output length written to `out`.
int64_t crossfade_concat(const float** chunks, const int64_t* chunk_lens,
                         const int32_t* xf_lens, int32_t n_chunks, float* out) {
  if (n_chunks <= 0) return 0;
  int64_t pos = chunk_lens[0];
  std::memcpy(out, chunks[0], sizeof(float) * chunk_lens[0]);
  for (int32_t c = 1; c < n_chunks; ++c) {
    const float* chunk = chunks[c];
    const int64_t len = chunk_lens[c];
    int64_t xf = xf_lens[c];
    if (xf > pos) xf = pos;
    if (xf > len) xf = len;
    if (xf > 0) {
      float* tail = out + pos - xf;
      // endpoint-inclusive ramp: matches np.linspace(0, 1, xf)
      const float step = xf > 1 ? 1.0f / static_cast<float>(xf - 1) : 1.0f;
      for (int64_t k = 0; k < xf; ++k) {
        const float r = step * static_cast<float>(k);
        tail[k] = tail[k] * (1.0f - r) + chunk[k] * r;
      }
      pos -= xf;
    }
    std::memcpy(out + pos + (xf > 0 ? xf : 0),
                chunk + (xf > 0 ? xf : 0),
                sizeof(float) * (len - (xf > 0 ? xf : 0)));
    pos += len;
  }
  return pos;
}

}  // extern "C"
