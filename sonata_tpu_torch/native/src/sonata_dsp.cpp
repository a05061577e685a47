// sonata_dsp: prosody post-processing (rate / pitch / volume) for synthesized
// speech, as a small C ABI library.
//
// This is the TPU-era equivalent of the reference's use of the Sonic C
// library (vendored submodule, driven through FFI from
// crates/sonata/synth/src/lib.rs:55-105): time-stretch for rate, linear
// resampling for pitch, scalar gain for volume.  It is an original
// implementation (WSOLA — waveform-similarity overlap-add — rather than
// Sonic's PICOLA variant): same observable contract, no copied code.
//
// Contract:
//   out_len = sonata_dsp_output_len(n, speed, pitch)    // upper bound
//   written = sonata_dsp_process(in, n, sr, speed, pitch, volume, out, cap)
//     speed  > 0: output duration = input / speed (1.0 = unchanged)
//     pitch  > 0: pitch multiplier (1.0 = unchanged), duration preserved
//     volume >= 0: linear gain
//   returns number of samples written, or -1 on bad args / short buffer.
//
// Thread-safe: no global state.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Linear resampler: ratio q -> output length ~= n * q, pitch scaled by 1/q.
static void resample_linear(const float* in, int64_t n, double q,
                            std::vector<float>& out) {
  if (n <= 0 || q <= 0) { out.clear(); return; }
  int64_t out_n = (int64_t)std::llround((double)n * q);
  if (out_n < 1) out_n = 1;
  out.resize((size_t)out_n);
  const double step = (double)(n - 1) / (double)(out_n > 1 ? out_n - 1 : 1);
  for (int64_t i = 0; i < out_n; ++i) {
    double pos = i * step;
    int64_t i0 = (int64_t)pos;
    if (i0 >= n - 1) { out[(size_t)i] = in[n - 1]; continue; }
    double frac = pos - (double)i0;
    out[(size_t)i] = (float)((1.0 - frac) * in[i0] + frac * in[i0 + 1]);
  }
}

// WSOLA time stretch: ratio r -> output length ~= n * r, pitch preserved.
// Window ~25 ms, 50% overlap-add with a Hann window, +-win/4 search for the
// best-correlated splice point.
static void wsola_stretch(const float* in, int64_t n, int sample_rate,
                          double r, std::vector<float>& out) {
  if (n <= 0) { out.clear(); return; }
  if (std::fabs(r - 1.0) < 1e-6) {
    out.assign(in, in + n);
    return;
  }
  int win = sample_rate / 40;            // ~25 ms
  if (win < 64) win = 64;
  if (win > n) win = (int)n;
  if (win % 2) ++win;
  const int hop_out = win / 2;
  const double hop_in = (double)hop_out / r;
  const int search = win / 4;

  const int64_t out_n = (int64_t)std::llround((double)n * r) + win;
  out.assign((size_t)out_n, 0.0f);
  std::vector<float> norm((size_t)out_n, 0.0f);
  std::vector<float> window((size_t)win);
  for (int i = 0; i < win; ++i)
    window[(size_t)i] =
        0.5f - 0.5f * (float)std::cos(2.0 * M_PI * i / (win - 1));

  double in_pos = 0.0;
  int64_t out_pos = 0;
  int64_t prev_start = -1;
  while (out_pos + win <= out_n) {
    int64_t target = (int64_t)std::llround(in_pos);
    int64_t start = target;
    if (prev_start >= 0) {
      // natural continuation of the previous frame in input space
      int64_t natural = prev_start + hop_out;
      int64_t lo = target - search, hi = target + search;
      if (lo < 0) lo = 0;
      if (hi > n - win) hi = n - win;
      if (lo > hi) { lo = hi = (target < 0 ? 0 : (target > n - win ? n - win : target)); }
      // pick the candidate best correlated with in[natural ...]
      double best = -1e30;
      int64_t best_s = lo;
      if (natural >= 0 && natural + win <= n) {
        for (int64_t s = lo; s <= hi; ++s) {
          double corr = 0.0;
          // stride 2: halves the cost, negligible accuracy loss at 22 kHz
          for (int i = 0; i < win; i += 2)
            corr += (double)in[natural + i] * (double)in[s + i];
          if (corr > best) { best = corr; best_s = s; }
        }
        start = best_s;
      }
    }
    if (start < 0) start = 0;
    if (start > n - win) start = n - win;
    for (int i = 0; i < win; ++i) {
      out[(size_t)(out_pos + i)] += in[start + i] * window[(size_t)i];
      norm[(size_t)(out_pos + i)] += window[(size_t)i];
    }
    prev_start = start;
    out_pos += hop_out;
    in_pos += hop_in;
    if ((int64_t)std::llround(in_pos) > n - win && out_pos + win <= out_n) {
      in_pos = (double)(n - win);
    }
    if ((int64_t)std::llround(in_pos) >= n) break;
  }
  for (int64_t i = 0; i < out_n; ++i)
    if (norm[(size_t)i] > 1e-4f) out[(size_t)i] /= norm[(size_t)i];
  out.resize((size_t)std::min<int64_t>(out_n, (int64_t)std::llround((double)n * r)));
}

}  // namespace

extern "C" {

int64_t sonata_dsp_output_len(int64_t n, float speed, float pitch) {
  if (n <= 0 || speed <= 0.0f || pitch <= 0.0f) return -1;
  double len = (double)n / (double)speed;
  return (int64_t)std::llround(len) + 8192;  // slack for window rounding
}

int64_t sonata_dsp_process(const float* in, int64_t n, int sample_rate,
                           float speed, float pitch, float volume,
                           float* out, int64_t out_cap) {
  if (!in || !out || n < 0 || sample_rate <= 0 || speed <= 0.0f ||
      pitch <= 0.0f || volume < 0.0f)
    return -1;
  if (n == 0) return 0;

  std::vector<float> stage1;
  const float* cur = in;
  int64_t cur_n = n;

  // pitch shift: resample by 1/pitch (pitch x p, length n/p) ...
  if (std::fabs(pitch - 1.0f) > 1e-6f) {
    resample_linear(cur, cur_n, 1.0 / (double)pitch, stage1);
    cur = stage1.data();
    cur_n = (int64_t)stage1.size();
  }
  // ... then WSOLA back: ratio pitch/speed -> final length n/speed.
  std::vector<float> stage2;
  double ratio = (double)pitch / (double)speed;
  if (std::fabs(ratio - 1.0) > 1e-6) {
    wsola_stretch(cur, cur_n, sample_rate, ratio, stage2);
    cur = stage2.data();
    cur_n = (int64_t)stage2.size();
  }

  if (cur_n > out_cap) return -1;
  if (std::fabs(volume - 1.0f) > 1e-6f) {
    for (int64_t i = 0; i < cur_n; ++i) out[i] = cur[i] * volume;
  } else if (cur != out) {
    std::memcpy(out, cur, (size_t)cur_n * sizeof(float));
  }
  return cur_n;
}

const char* sonata_dsp_version(void) { return "sonata_dsp 1.0"; }

}  // extern "C"
