// Native F0 estimator: YIN (cumulative-mean-normalized difference function
// with parabolic interpolation) for the offline feature pipeline.
//
// Same algorithm and constants as the batched tensor implementation
// (tts_king_torch/ops/f0.py) so the two backends are interchangeable (the
// port's copy of tts_king_tpu/native/f0.cpp); this is the CPU-native
// replacement for the reference's pyworld dio+stonemask C++ calls
// (fs_two/preprocessor/preprocessor.py:206-215). One call per utterance,
// O(frames * W * tau_max) direct difference evaluation, OpenMP-free (the
// batch loader parallelizes across utterances instead).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline int reflect_index(int i, int n) {
  // numpy 'reflect' (no edge repeat): ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = ((i % period) + period) % period;
  return i < n ? i : period - i;
}

}  // namespace

extern "C" int yin_f0_native(const float* wav, int n, int sr, int hop,
                             int frame_len, float f0_floor, float f0_ceil,
                             float threshold, float* out_f0, int max_frames) {
  if (n <= 0 || hop <= 0 || frame_len <= 0) return 0;
  const int W = frame_len;
  int tau_min = (int)(sr / f0_ceil);
  if (tau_min < 2) tau_min = 2;
  int tau_max = (int)(sr / f0_floor) + 1;
  if (tau_max > W / 2) tau_max = W / 2;
  const int N = W - tau_max;  // correlation support
  const int n_frames_total = n / hop + 1;
  const int n_frames = n_frames_total < max_frames ? n_frames_total : max_frames;

  const int pad = W / 2;
  const int left_extra = pad;
  // Padded signal x[i] for i in [-pad, n + pad)
  std::vector<float> x(n + 2 * pad);
  for (int i = 0; i < n + 2 * pad; ++i)
    x[i] = wav[reflect_index(i - left_extra, n)];

  std::vector<double> d(tau_max + 1), cmndf(tau_max + 1);

  for (int f = 0; f < n_frames; ++f) {
    const float* frame = x.data() + f * hop;

    // difference function d[tau] = sum_{j<N} (x[j] - x[j+tau])^2
    d[0] = 0.0;
    for (int tau = 1; tau <= tau_max; ++tau) {
      double acc = 0.0;
      for (int j = 0; j < N; ++j) {
        const double diff = (double)frame[j] - (double)frame[j + tau];
        acc += diff * diff;
      }
      d[tau] = acc;
    }

    // cumulative mean normalization
    cmndf[0] = 1.0;
    double running = 0.0;
    for (int tau = 1; tau <= tau_max; ++tau) {
      running += d[tau];
      cmndf[tau] = running > 1e-12 ? d[tau] * tau / running : 1.0;
    }

    // first dip below threshold in [tau_min, tau_max], else global min
    int tau = -1;
    for (int t = tau_min; t <= tau_max; ++t) {
      if (cmndf[t] < threshold) {
        tau = t;
        break;
      }
    }
    bool any_below = tau >= 0;
    if (any_below) {
      // walk to the local minimum within a 32-sample window (matches the
      // tensor implementation's bounded dip search)
      int best = tau;
      const int hi = tau + 31 <= tau_max ? tau + 31 : tau_max;
      for (int t = tau; t <= hi; ++t)
        if (cmndf[t] < cmndf[best]) best = t;
      tau = best;
    } else {
      int best = tau_min;
      for (int t = tau_min; t <= tau_max; ++t)
        if (cmndf[t] < cmndf[best]) best = t;
      tau = best;
    }

    // parabolic interpolation on the CMNDF around tau
    const int tm = tau - 1 >= 0 ? tau - 1 : 0;
    const int tp = tau + 1 <= tau_max ? tau + 1 : tau_max;
    const double y0 = cmndf[tm], y1 = cmndf[tau], y2 = cmndf[tp];
    const double denom = y0 - 2.0 * y1 + y2;
    double delta = std::fabs(denom) > 1e-12 ? 0.5 * (y0 - y2) / denom : 0.0;
    if (delta > 0.5) delta = 0.5;
    if (delta < -0.5) delta = -0.5;
    const double period = (double)tau + delta;

    double f0 = period >= 1.0 ? (double)sr / period : 0.0;
    const bool voiced = cmndf[tau] < 0.3 && f0 >= f0_floor && f0 <= f0_ceil;
    out_f0[f] = voiced ? (float)f0 : 0.0f;
  }
  return n_frames;
}
