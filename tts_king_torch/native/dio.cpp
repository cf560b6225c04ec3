// DIO-style multiband F0 estimator with StoneMask-style refinement.
//
// The reference extracts pitch with pyworld's dio+stonemask
// (fs_two/preprocessor/preprocessor.py:207-213). pyworld is a binding to
// M. Morise's WORLD; this file re-implements the published algorithmic
// ideas from scratch (Morise 2009/2016): band-limit the signal so each
// candidate band isolates one fundamental, estimate the period from four
// event sequences (rising/falling zero crossings, peaks, dips), score each
// band by the spread of the four estimates, pick the most stable band per
// frame, clean the contour (jump removal, short-run removal, candidate-
// guided extension), then refine each voiced frame to cents accuracy with
// a normalized-autocorrelation peak around the predicted lag.
//
// It is an algorithmic re-implementation, not a port of the WORLD sources;
// bit-parity with pyworld is not claimed. Accuracy is validated against
// ground-truth synthetic signals (tests/test_torch_features.py). This is
// the port's copy of tts_king_tpu/native/dio.cpp, the same code, so both
// packages give bit-equal F0.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <complex>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- FFT ----
void fft_inplace(std::vector<std::complex<double>>& a, bool inverse) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = 2.0 * kPi / (double)len * (inverse ? 1.0 : -1.0);
    const std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (size_t j = 0; j < len / 2; ++j) {
        const std::complex<double> u = a[i + j];
        const std::complex<double> v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wl;
      }
    }
  }
  if (inverse)
    for (auto& x : a) x /= (double)n;
}

size_t next_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Nuttall window value at position k of length m (0..m-1).
double nuttall(int k, int m) {
  const double t = 2.0 * kPi * k / (m - 1);
  return 0.355768 - 0.487396 * std::cos(t) + 0.144232 * std::cos(2 * t) -
         0.012604 * std::cos(3 * t);
}

// Low-pass "same"-size FFT convolution with a Nuttall-windowed sinc whose
// cutoff is fc Hz. Each DIO band keeps only content below its boundary
// frequency so the surviving waveform is near-sinusoidal at the
// fundamental.
void lowpass_same(const std::vector<double>& x, double fs, double fc,
                  std::vector<double>& out) {
  const int n = (int)x.size();
  int half = (int)std::lround(2.0 * fs / fc);
  if (half < 4) half = 4;
  const int L = 2 * half + 1;
  std::vector<double> h(L);
  double s = 0.0;
  for (int k = 0; k < L; ++k) {
    const double t = (double)(k - half);
    const double arg = 2.0 * fc / fs * t;
    const double sinc = (t == 0.0) ? 1.0 : std::sin(kPi * arg) / (kPi * arg);
    h[k] = sinc * nuttall(k, L);
    s += h[k];
  }
  for (int k = 0; k < L; ++k) h[k] /= s;

  const size_t m = next_pow2((size_t)n + (size_t)L);
  std::vector<std::complex<double>> fa(m), fb(m);
  for (int i = 0; i < n; ++i) fa[i] = x[i];
  for (int k = 0; k < L; ++k) fb[k] = h[k];
  fft_inplace(fa, false);
  fft_inplace(fb, false);
  for (size_t i = 0; i < m; ++i) fa[i] *= fb[i];
  fft_inplace(fa, true);
  out.resize(n);
  for (int i = 0; i < n; ++i) out[i] = fa[i + half].real();
}

// ------------------------------------------------------------- events ----
// Interval-based F0 samples from one event sequence: for consecutive event
// times t_j, one sample f=fs/(t_{j+1}-t_j) located at the interval midpoint.
struct IntervalTrack {
  std::vector<double> loc;  // sample positions (midpoints)
  std::vector<double> f0;   // Hz
};

void intervals_from_events(const std::vector<double>& t, double fs,
                           IntervalTrack& out) {
  out.loc.clear();
  out.f0.clear();
  for (size_t j = 0; j + 1 < t.size(); ++j) {
    const double dt = t[j + 1] - t[j];
    if (dt <= 0.0) continue;
    out.loc.push_back(0.5 * (t[j] + t[j + 1]));
    out.f0.push_back(fs / dt);
  }
}

// Linear interpolation of an IntervalTrack at sample position p; valid only
// inside the track's support with at least two intervals.
bool track_at(const IntervalTrack& tr, double p, double* val) {
  const size_t m = tr.loc.size();
  if (m < 2 || p < tr.loc.front() || p > tr.loc.back()) return false;
  const size_t hi =
      std::upper_bound(tr.loc.begin(), tr.loc.end(), p) - tr.loc.begin();
  const size_t i1 = std::min(std::max(hi, (size_t)1), m - 1);
  const size_t i0 = i1 - 1;
  const double w = (tr.loc[i1] > tr.loc[i0])
                       ? (p - tr.loc[i0]) / (tr.loc[i1] - tr.loc[i0])
                       : 0.0;
  *val = tr.f0[i0] * (1.0 - w) + tr.f0[i1] * w;
  return true;
}

void detect_events(const std::vector<double>& x, std::vector<double>& rise,
                   std::vector<double>& fall, std::vector<double>& peak,
                   std::vector<double>& dip) {
  const int n = (int)x.size();
  rise.clear(); fall.clear(); peak.clear(); dip.clear();
  for (int i = 0; i + 1 < n; ++i) {
    if (x[i] < 0.0 && x[i + 1] >= 0.0)
      rise.push_back(i + (-x[i]) / (x[i + 1] - x[i]));
    if (x[i] > 0.0 && x[i + 1] <= 0.0)
      fall.push_back(i + x[i] / (x[i] - x[i + 1]));
  }
  // peaks/dips: zero crossings of the first difference (located at i+0.5)
  for (int i = 0; i + 2 < n; ++i) {
    const double d0 = x[i + 1] - x[i];
    const double d1 = x[i + 2] - x[i + 1];
    if (d0 > 0.0 && d1 <= 0.0)
      peak.push_back(i + 0.5 + d0 / (d0 - d1));
    if (d0 < 0.0 && d1 >= 0.0)
      dip.push_back(i + 0.5 + (-d0) / (d1 - d0));
  }
}

// -------------------------------------------------------- refinement ----
// StoneMask-style: sharpen f0 with the normalized autocorrelation peak
// around the predicted lag on a ~3-period window centered at the frame.
double refine_frame(const float* wav, int n, double fs, double center,
                    double f0, double f0_floor, double f0_ceil,
                    double* peak_ncc) {
  const int lag0 = (int)std::lround(fs / f0);
  const int seg = std::min(n, (int)std::lround(3.0 * fs / f0));
  const int lag_hi = std::min(lag0 + 3, seg - 2);
  const int lag_lo = std::max(2, lag0 - 3);
  if (lag_hi <= lag_lo + 1 || seg < 3 * lag_lo / 2) {
    *peak_ncc = 0.0;
    return f0;
  }
  int start = (int)std::lround(center) - seg / 2;
  start = std::max(0, std::min(start, n - seg));
  const int M = seg - lag_hi;
  if (M < 8) {
    *peak_ncc = 0.0;
    return f0;
  }

  auto ncc = [&](int lag) {
    double se = 0.0, st = 0.0, sc = 0.0;
    const float* a = wav + start;
    const float* b = wav + start + lag;
    for (int i = 0; i < M; ++i) {
      se += (double)a[i] * a[i];
      st += (double)b[i] * b[i];
      sc += (double)a[i] * b[i];
    }
    const double d = std::sqrt(se * st);
    return d > 1e-12 ? sc / d : 0.0;
  };

  int best = lag_lo;
  double best_v = -2.0;
  std::vector<double> vals(lag_hi - lag_lo + 1);
  for (int l = lag_lo; l <= lag_hi; ++l) {
    vals[l - lag_lo] = ncc(l);
    if (vals[l - lag_lo] > best_v) {
      best_v = vals[l - lag_lo];
      best = l;
    }
  }
  *peak_ncc = best_v;

  // Octave-down guard: if half the period correlates almost as well, the
  // candidate band latched onto a sub-harmonic — prefer the octave up.
  const int half = best / 2;
  if (half >= 2 && fs / half <= f0_ceil) {
    int hb = half;
    double hv = -2.0;
    for (int l = std::max(2, half - 1); l <= half + 1 && l < seg - 2; ++l) {
      const double v = ncc(l);
      if (v > hv) { hv = v; hb = l; }
    }
    if (hv > 0.90 * best_v && hv > 0.3) {
      best = hb;
      best_v = hv;
      *peak_ncc = hv;
      // re-center the +-1 parabola around the new best
      vals.assign(3, 0.0);
      vals[0] = (best - 1 >= 2) ? ncc(best - 1) : hv;
      vals[1] = hv;
      vals[2] = (best + 1 < seg - 2) ? ncc(best + 1) : hv;
      double delta = 0.0;
      const double den = vals[0] - 2.0 * vals[1] + vals[2];
      if (std::fabs(den) > 1e-12) delta = 0.5 * (vals[0] - vals[2]) / den;
      delta = std::max(-0.5, std::min(0.5, delta));
      const double refined = fs / ((double)best + delta);
      return (refined < f0_floor || refined > f0_ceil) ? f0 : refined;
    }
  }

  double delta = 0.0;
  if (best > lag_lo && best < lag_hi) {
    const double y0 = vals[best - 1 - lag_lo], y1 = vals[best - lag_lo],
                 y2 = vals[best + 1 - lag_lo];
    const double den = y0 - 2.0 * y1 + y2;
    if (std::fabs(den) > 1e-12) delta = 0.5 * (y0 - y2) / den;
    delta = std::max(-0.5, std::min(0.5, delta));
  }
  const double refined = fs / ((double)best + delta);
  if (refined < f0_floor || refined > f0_ceil) return f0;
  return refined;
}

}  // namespace

// dio_f0_native: F0 contour for one utterance, one value per hop, n/hop+1
// frames (the same count as the mel extractor / yin_f0_native).
extern "C" int dio_f0_native(const float* wav, int n, int sr, int hop,
                             float f0_floor, float f0_ceil,
                             float channels_in_octave, float allowed_range,
                             float* out_f0, int max_frames) {
  if (n <= 0 || hop <= 0) return 0;
  const int n_frames_total = n / hop + 1;
  const int F = std::min(n_frames_total, max_frames);
  const double fs = (double)sr;

  // DC removal.
  std::vector<double> x(n);
  double mean = 0.0;
  for (int i = 0; i < n; ++i) mean += wav[i];
  mean /= n;
  for (int i = 0; i < n; ++i) x[i] = (double)wav[i] - mean;

  // Candidate bands: boundary[i] = floor * 2^((i+1)/cio); band i isolates
  // fundamentals in [boundary/2, boundary].
  const int n_bands =
      1 + (int)std::floor(std::log2((double)f0_ceil / f0_floor) *
                          channels_in_octave);
  std::vector<double> cand(n_bands * F, 0.0);   // per-band f0 per frame
  std::vector<double> score(n_bands * F, 1e9);  // deviation / f0

  std::vector<double> filtered;
  std::vector<double> ev[4];
  IntervalTrack tracks[4];
  for (int b = 0; b < n_bands; ++b) {
    const double boundary =
        f0_floor * std::pow(2.0, (double)(b + 1) / channels_in_octave);
    if (boundary / 2.0 > f0_ceil) break;
    lowpass_same(x, fs, boundary, filtered);
    detect_events(filtered, ev[0], ev[1], ev[2], ev[3]);
    for (int k = 0; k < 4; ++k) intervals_from_events(ev[k], fs, tracks[k]);

    for (int f = 0; f < F; ++f) {
      const double p = (double)f * hop;
      double est[4];
      bool ok = true;
      for (int k = 0; k < 4 && ok; ++k) ok = track_at(tracks[k], p, &est[k]);
      if (!ok) continue;
      const double m = 0.25 * (est[0] + est[1] + est[2] + est[3]);
      // The band is only trustworthy when the fundamental it isolated
      // actually lies in its half-octave, inside the global search range.
      if (m < f0_floor || m > f0_ceil * 1.1) continue;
      if (m < boundary * 0.45 || m > boundary * 1.1) continue;
      double var = 0.0;
      for (int k = 0; k < 4; ++k) var += (est[k] - m) * (est[k] - m);
      const double sd = std::sqrt(var / 4.0);
      cand[b * F + f] = m;
      score[b * F + f] = sd / (m + 1e-12);
    }
  }

  // Best band per frame; reliability cut.
  const double kMaxScore = 0.20;
  std::vector<double> f0(F, 0.0);
  for (int f = 0; f < F; ++f) {
    double bs = 1e9, bv = 0.0;
    for (int b = 0; b < n_bands; ++b) {
      if (score[b * F + f] < bs) {
        bs = score[b * F + f];
        bv = cand[b * F + f];
      }
    }
    if (bs <= kMaxScore) f0[f] = bv;
  }

  // Fix step 1: kill octave/step jumps beyond allowed_range per frame.
  std::vector<double> f1(f0);
  for (int f = 1; f < F; ++f) {
    if (f1[f] == 0.0 || f0[f - 1] == 0.0) continue;
    if (std::fabs(f0[f] - f0[f - 1]) / f0[f] > allowed_range) f1[f] = 0.0;
  }
  // Fix step 2: drop voiced runs too short to be speech (~35 ms).
  const int min_run = std::max(3, (int)std::lround(0.03 * fs / hop));
  for (int f = 0; f < F;) {
    if (f1[f] == 0.0) { ++f; continue; }
    int e = f;
    while (e < F && f1[e] != 0.0) ++e;
    if (e - f < min_run)
      for (int i = f; i < e; ++i) f1[i] = 0.0;
    f = e;
  }
  // Fix steps 3/4: extend voiced edges using per-band candidates that agree
  // with the edge value within allowed_range.
  auto extend = [&](int start, int dir) {
    double ref = f1[start];
    for (int f = start + dir; f >= 0 && f < F; f += dir) {
      if (f1[f] != 0.0) break;
      double best = 0.0, bd = 1e9;
      for (int b = 0; b < n_bands; ++b) {
        const double c = cand[b * F + f];
        if (c == 0.0) continue;
        const double d = std::fabs(c - ref) / ref;
        if (d < bd) { bd = d; best = c; }
      }
      if (bd > allowed_range) break;
      f1[f] = best;
      ref = best;
    }
  };
  for (int f = 0; f < F; ++f) {
    const bool v = f1[f] != 0.0;
    if (v && (f == 0 || f1[f - 1] == 0.0) && f > 0) extend(f, -1);
    if (v && (f + 1 >= F || f1[f + 1] == 0.0) && f + 1 < F) extend(f, +1);
  }

  // StoneMask-style refinement on the raw waveform.
  const double kMinNcc = 0.15;
  for (int f = 0; f < F; ++f) {
    if (f1[f] == 0.0) {
      out_f0[f] = 0.0f;
      continue;
    }
    double ncc = 0.0;
    const double refined =
        refine_frame(wav, n, fs, (double)f * hop, f1[f], f0_floor, f0_ceil,
                     &ncc);
    out_f0[f] = (ncc >= kMinNcc) ? (float)refined : 0.0f;
  }
  return F;
}

extern "C" void dio_f0_batch(const float** wavs, const int* lens, int n_utts,
                             int sr, int hop, float f0_floor, float f0_ceil,
                             float channels_in_octave, float allowed_range,
                             float* out_f0, int max_frames,
                             int* out_n_frames, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_utts) return;
      out_n_frames[i] = dio_f0_native(
          wavs[i], lens[i], sr, hop, f0_floor, f0_ceil, channels_in_octave,
          allowed_range, out_f0 + (size_t)i * max_frames, max_frames);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}
