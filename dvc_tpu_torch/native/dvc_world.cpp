// dvc_world — WORLD-style F0 / aperiodicity analysis, native host engine.
//
// The reference calls the native pyworld package for harvest F0 and D4C
// band aperiodicity (preprocessing/WORLD_processing.py:33-35).  pyworld is
// not a dependency here; this translation unit implements both estimators
// from their published algorithms:
//
//   Harvest: M. Morise, "Harvest: A high-performance fundamental frequency
//            estimator from speech signals," INTERSPEECH 2017.
//   D4C:     M. Morise, "D4C, a band-aperiodicity estimator for high-quality
//            speech synthesis," Speech Communication 84, 2016.
//
// Pipeline (Harvest): decimate to ~8 kHz -> 24-channels/octave bandpass
// filter bank (Nuttall-windowed cosine) -> four event-interval F0 candidate
// trains per channel (rising/falling zero crossings, peaks, dips) ->
// candidates where the four agree -> instantaneous-frequency refinement over
// up to 6 harmonics -> neighbor-consistency pruning -> best-score base
// contour -> jump removal, short-segment removal, candidate-pool extension
// -> zero-phase 2nd-order Butterworth smoothing (30 Hz at the 1 kHz internal
// frame rate) -> resample to the requested frame period.
//
// Pipeline (D4C): per voiced frame, static centroid from two Blackman-
// windowed segments offset +-T0/4 -> smoothed power spectrum (Hanning 4*T0,
// rectangular smoothing of width F0) -> static group delay (centroid/power,
// high-passed across frequency by subtracting its F0/2-smoothed version) ->
// per 3 kHz band: Nuttall-windowed group-delay slice, quefrency power
// sorted, aperiodicity = power outside the top coefficients -> dB
// interpolation over the coarse axis to the full spectral grid.
//
// D4C additionally applies the LoveTrain voicing override (Morise 2016
// §2.2 / pyworld's `threshold` option, default 0.85): per voiced frame the
// ratio of windowed signal power in [0.1, 4] kHz to that in [0.1, 7.9] kHz
// is computed, and frames below the threshold are forced fully aperiodic
// (treated as unvoiced by the synthesizer).
//
// Like pyworld's optional multithreading, the channel filtering, candidate
// refinement, and D4C frame loops run on a thread pool (DVC_WORLD_THREADS
// overrides the hardware count; results are bit-identical at any thread
// count — parallel sections write disjoint slots and merge in a fixed
// order).
//
// Exact WORLD bit-parity requires golden vectors recorded where pyworld
// exists — see tools/gen_world_golden.py.
//
// A copy of dvc_tpu/native/dvc_world.cpp for the PyTorch port.
//
// Build: g++ -O3 -shared -fPIC (no dependencies), by
// dvc_tpu_torch/native/_build.py into build/native/; bound via ctypes in
// dvc_tpu_torch/native/world.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#include "dvc_common.h"  // FFT, windows, thread pool (shared with dvc_dsp)

namespace {

using dvc::kPi;
using dvc::blackman;
using dvc::fft_inplace;
using dvc::next_pow2;
using dvc::nuttall;

constexpr double kEps = 1e-12;

template <typename Fn>
void parallel_for(long n, const Fn& fn) {
  dvc::parallel_for(n, fn);
}

// ------------------------------------------------------- decimation --------
// windowed-sinc anti-alias low-pass + integer pick (role of WORLD's
// decimation to the ~8 kHz analysis rate).
std::vector<double> decimate(const float* x, long n, int ratio) {
  if (ratio <= 1) return std::vector<double>(x, x + n);
  const int half = 32 * ratio;
  const double cutoff = 0.45 / ratio;
  std::vector<double> h(2 * half + 1);
  double sum = 0.0;
  for (int i = 0; i < 2 * half + 1; ++i) {
    double t = i - half;
    double sinc = (t == 0.0) ? 2.0 * cutoff
                             : std::sin(2.0 * kPi * cutoff * t) / (kPi * t);
    h[i] = sinc * blackman(static_cast<double>(i) / (2 * half));
    sum += h[i];
  }
  for (double& v : h) v /= sum;
  long m = n / ratio;
  std::vector<double> y(m, 0.0);
  for (long o = 0; o < m; ++o) {
    long c = o * ratio;
    double acc = 0.0;
    long lo = std::max<long>(0, c - half), hi = std::min<long>(n - 1, c + half);
    for (long i = lo; i <= hi; ++i) acc += x[i] * h[i - (c - half)];
    y[o] = acc;
  }
  return y;
}

// --------------------------------------------- event-interval F0 trains ----
struct EventTrack {
  std::vector<double> t;   // event midpoints (seconds)
  std::vector<double> f0;  // interval F0 at each midpoint
};

// interval track from the sign-change positions of `s` (negative-going).
EventTrack zero_crossings(const std::vector<double>& s, double fs) {
  EventTrack out;
  std::vector<double> locs;
  for (size_t i = 0; i + 1 < s.size(); ++i)
    if (s[i] > 0.0 && s[i + 1] <= 0.0)
      locs.push_back((i + s[i] / (s[i] - s[i + 1])) / fs);
  for (size_t k = 0; k + 1 < locs.size(); ++k) {
    double iv = locs[k + 1] - locs[k];
    if (iv <= 0) continue;
    out.t.push_back(0.5 * (locs[k] + locs[k + 1]));
    out.f0.push_back(1.0 / iv);
  }
  return out;
}

double interp_track(const EventTrack& tr, double t) {
  // linear interpolation; 0 outside the covered range or with <2 events
  if (tr.t.size() < 2 || t < tr.t.front() || t > tr.t.back()) return 0.0;
  auto it = std::lower_bound(tr.t.begin(), tr.t.end(), t);
  size_t j = std::max<size_t>(1, it - tr.t.begin());
  double t0 = tr.t[j - 1], t1 = tr.t[j];
  double a = (t1 > t0) ? (t - t0) / (t1 - t0) : 0.0;
  return tr.f0[j - 1] * (1.0 - a) + tr.f0[j] * a;
}

struct Candidates {
  int n_frames = 0;
  int max_c = 0;
  std::vector<double> f0;     // (n_frames, max_c)
  std::vector<double> score;  // (n_frames, max_c)
  double& F(int i, int j) { return f0[static_cast<size_t>(i) * max_c + j]; }
  double& S(int i, int j) { return score[static_cast<size_t>(i) * max_c + j]; }
};

// Per-frame cache of refinement FFT pairs.  The windowed/derivative-window
// spectra depend only on (frame center, window length) — candidates of the
// SAME frame whose f0 rounds to the same window length share them exactly,
// and reusing the buffers across frames removes per-candidate allocation.
// Values are identical to a fresh computation, so refinement stays
// bit-identical.
struct RefineFrameCache {
  std::vector<int> wlens;  // active entries for the current frame
  std::vector<std::vector<double>> rm, im, rd, id;
  void reset() { wlens.clear(); }
};

// refine one candidate by harmonic-weighted instantaneous frequency
// (Flanagan's equation on a Blackman-windowed FFT pair).
void refine_candidate(const std::vector<double>& y, double fs, double tpos,
                      double f0_floor, double f0_ceil, double* f0c,
                      double* score, RefineFrameCache* cache) {
  double f0 = *f0c;
  if (f0 < f0_floor || f0 > f0_ceil) {
    *score = 0.0;
    return;
  }
  int half = static_cast<int>(1.5 * fs / f0 + 0.5);
  int wlen = 2 * half + 1;
  int fft_size = next_pow2(wlen) * 2;
  long c = static_cast<long>(tpos * fs + 0.5);

  int idx = -1;
  for (size_t q = 0; q < cache->wlens.size(); ++q)
    if (cache->wlens[q] == wlen) {
      idx = static_cast<int>(q);
      break;
    }
  if (idx < 0) {
    idx = static_cast<int>(cache->wlens.size());
    cache->wlens.push_back(wlen);
    if (static_cast<int>(cache->rm.size()) <= idx) {
      cache->rm.emplace_back();
      cache->im.emplace_back();
      cache->rd.emplace_back();
      cache->id.emplace_back();
    }
    cache->rm[idx].assign(fft_size, 0.0);
    cache->im[idx].assign(fft_size, 0.0);
    cache->rd[idx].assign(fft_size, 0.0);
    cache->id[idx].assign(fft_size, 0.0);

    // Blackman windows cached by length (values identical per computation)
    static std::mutex win_mu;
    static std::map<int, std::vector<double>>* win_cache =
        new std::map<int, std::vector<double>>;
    const double* w;
    {
      std::lock_guard<std::mutex> lock(win_mu);
      auto it = win_cache->find(wlen);
      if (it == win_cache->end()) {
        std::vector<double> fresh(wlen);
        for (int i = 0; i < wlen; ++i)
          fresh[i] = blackman(static_cast<double>(i) / (wlen - 1));
        it = win_cache->emplace(wlen, std::move(fresh)).first;
      }
      w = it->second.data();
    }
    auto sample = [&](long i) -> double {
      return (i >= 0 && i < static_cast<long>(y.size())) ? y[i] : 0.0;
    };
    double* rm = cache->rm[idx].data();
    double* rd = cache->rd[idx].data();
    for (int i = 0; i < wlen; ++i) {
      double v = sample(c - half + i);
      rm[i] = v * w[i];
      // derivative window (central difference of the window)
      double wm = (i > 0) ? w[i - 1] : 0.0;
      double wp = (i < wlen - 1) ? w[i + 1] : 0.0;
      rd[i] = v * (wp - wm) * 0.5 * fs;  // d/dt in seconds
    }
    fft_inplace(cache->rm[idx].data(), cache->im[idx].data(), fft_size);
    fft_inplace(cache->rd[idx].data(), cache->id[idx].data(), fft_size);
  }
  const double* re_m = cache->rm[idx].data();
  const double* im_m = cache->im[idx].data();
  const double* re_d = cache->rd[idx].data();
  const double* im_d = cache->id[idx].data();

  double freq_res = fs / fft_size;
  int n_harm = std::min(6, static_cast<int>(fs / 2.0 / f0));
  if (n_harm < 1) {
    *score = 0.0;
    return;
  }
  double num = 0.0, den = 0.0, dev = 0.0, wsum = 0.0;
  double inst[6], amp[6];  // n_harm <= 6 by construction
  for (int h = 1; h <= n_harm; ++h) {
    int k = static_cast<int>(f0 * h / freq_res + 0.5);
    if (k <= 0 || k >= fft_size / 2) {
      n_harm = h - 1;
      break;
    }
    double power = re_m[k] * re_m[k] + im_m[k] * im_m[k];
    double a = std::sqrt(power);
    // instantaneous frequency (Flanagan / reassignment):
    //   f_inst = f_k + Im{conj(S_dw) S_w} / (2 pi |S_w|^2)
    double instf = k * freq_res +
                   (re_d[k] * im_m[k] - im_d[k] * re_m[k]) /
                       (2.0 * kPi * std::max(power, kEps));
    inst[h - 1] = instf;
    amp[h - 1] = a;
    num += a * instf;
    den += a * h;
  }
  if (n_harm < 1 || den <= kEps) {
    *score = 0.0;
    return;
  }
  double refined = num / den;
  if (refined < f0_floor || refined > f0_ceil) {
    *score = 0.0;
    return;
  }
  double odd = 0.0;
  for (int h = 1; h <= n_harm; ++h) {
    dev += amp[h - 1] * std::fabs(inst[h - 1] / h - refined);
    wsum += amp[h - 1];
    if (h % 2 == 1) odd += amp[h - 1];
  }
  dev /= std::max(wsum, kEps) * std::max(refined, kEps);  // relative deviation
  *f0c = refined;
  *score = 1.0 / (dev + 1e-6);
  // Subharmonic suppression (robustness addition beyond the paper): a
  // candidate at f0/2 of the true pitch has all its EVEN harmonics on real
  // partials and scores as well as the true candidate, but its odd
  // harmonics sit on noise.  Starved odd-harmonic energy marks it.
  if (n_harm >= 2) {
    double odd_frac = odd / std::max(wsum, kEps);
    *score *= std::min(1.0, odd_frac / 0.2);
  }
}

// zero-phase 2nd-order Butterworth low-pass, cutoff fc (normalized to the
// frame rate), applied forward then backward within one segment.
void zero_phase_lpf(std::vector<double>& seg, double fc) {
  if (seg.size() < 5) return;
  double K = std::tan(kPi * fc);
  double norm = 1.0 + std::sqrt(2.0) * K + K * K;
  double b0 = K * K / norm, b1 = 2.0 * b0, b2 = b0;
  double a1 = 2.0 * (K * K - 1.0) / norm;
  double a2 = (1.0 - std::sqrt(2.0) * K + K * K) / norm;
  auto run = [&](std::vector<double>& v) {
    double x1 = v[0], x2 = v[0];        // edge-pad state
    double y1 = v[0], y2 = v[0];
    for (double& x0 : v) {
      double y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
      x2 = x1;
      x1 = x0;
      y2 = y1;
      y1 = y0;
      x0 = y0;
    }
  };
  run(seg);
  std::reverse(seg.begin(), seg.end());
  run(seg);
  std::reverse(seg.begin(), seg.end());
}

// --------------------------------------------- harvest filter-bank cache --
// The per-channel band-pass filter spectra depend only on (analysis rate,
// FFT bucket, f0 band) — not on the audio — so across a corpus the same
// bank is recomputed for every utterance in the same length bucket.  Cache
// the spectra (values identical to the per-call computation, so harvest
// output stays bit-identical).  A handful of buckets covers a corpus;
// the cache clears itself past 4 to bound memory (~32 MB per bucket).
struct FilterBank {
  std::vector<int> half;                    // per-channel filter half-width
  std::vector<std::vector<double>> fre, fim;  // per-channel spectra
};

const FilterBank& harvest_filter_bank(double afs, int fft_size,
                                      double f0_floor, double f0_ceil,
                                      int n_ch) {
  struct Key {
    double afs, f0_floor, f0_ceil;
    int fft_size, n_ch;
    bool operator<(const Key& o) const {
      if (afs != o.afs) return afs < o.afs;
      if (f0_floor != o.f0_floor) return f0_floor < o.f0_floor;
      if (f0_ceil != o.f0_ceil) return f0_ceil < o.f0_ceil;
      if (fft_size != o.fft_size) return fft_size < o.fft_size;
      return n_ch < o.n_ch;
    }
  };
  static std::mutex mu;
  static std::map<Key, FilterBank>* cache = new std::map<Key, FilterBank>;
  Key key{afs, f0_floor, f0_ceil, fft_size, n_ch};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache->find(key);
  if (it != cache->end()) return it->second;
  if (cache->size() >= 4) cache->clear();
  FilterBank fb;
  fb.half.assign(n_ch, 0);
  fb.fre.resize(n_ch);
  fb.fim.resize(n_ch);
  for (int ch = 0; ch < n_ch; ++ch) {
    double bf0 = f0_floor * std::pow(2.0, (ch + 1) / 24.0);
    if (bf0 > f0_ceil * 1.1) continue;
    int half = static_cast<int>(afs / bf0 * 2.0 + 0.5);
    int flen = 2 * half + 1;
    if (flen >= fft_size) continue;
    std::vector<double> fre(fft_size, 0.0), fim(fft_size, 0.0);
    for (int i = 0; i < flen; ++i)
      fre[i] = nuttall(static_cast<double>(i) / (flen - 1)) *
               std::cos(2.0 * kPi * bf0 * (i - half) / afs);
    fft_inplace(fre.data(), fim.data(), fft_size);
    fb.half[ch] = half;
    fb.fre[ch] = std::move(fre);
    fb.fim[ch] = std::move(fim);
  }
  return cache->emplace(key, std::move(fb)).first->second;
}

// ------------------------------------------------- D4C LoveTrain ----------
// Low-band power-ratio voicing check (Morise 2016 §2.2; pyworld `threshold`
// option).  Windowed power ratio [0.1,4] kHz / [0.1,7.9] kHz around one
// frame; frames scoring at or below the threshold are forced fully
// aperiodic by the caller.
double love_train_frame(const float* x, long n, int fs, double f0v,
                        double tpos, int fft_lt, int b0, int b1, int b2) {
  int half = static_cast<int>(1.5 * fs / f0v + 0.5);
  int wlen = 2 * half + 1;
  if (wlen > fft_lt) return 0.0;  // f0 below the analysis floor: no verdict
  long c = static_cast<long>(tpos * fs + 0.5);
  std::vector<double> re(fft_lt, 0.0), im(fft_lt, 0.0), w(wlen);
  double wsum = 0.0, dsum = 0.0;
  for (int i = 0; i < wlen; ++i) {
    w[i] = blackman(static_cast<double>(i) / (wlen - 1));
    long j = c - half + i;
    double v = (j >= 0 && j < n) ? x[j] : 0.0;
    re[i] = v * w[i];
    dsum += re[i];
    wsum += w[i];
  }
  // window-weighted DC removal so the excluded <100 Hz region does not leak
  double dc = dsum / std::max(wsum, kEps);
  for (int i = 0; i < wlen; ++i) re[i] -= dc * w[i];
  fft_inplace(re.data(), im.data(), fft_lt);
  int n_half = fft_lt / 2;
  double low = 0.0, full = 0.0;
  for (int k = b0 + 1; k <= std::min(b2, n_half); ++k) {
    double p = re[k] * re[k] + im[k] * im[k];
    if (k <= b1) low += p;
    full += p;
  }
  return low / std::max(full, kEps);
}

// ------------------------------------------------- synthesis helpers ------
// Deterministic per-pulse RNG (splitmix64 + Box-Muller): each excitation
// pulse owns an independent stream keyed by (seed, pulse index), so the
// synthesized waveform is bit-identical at any thread count.
struct PulseRng {
  uint64_t s;
  PulseRng(uint64_t seed, uint64_t stream)
      : s(seed * 0x9E3779B97F4A7C15ULL + stream + 1) {}
  uint64_t next() {
    s += 0x9E3779B97F4A7C15ULL;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() {  // (0, 1]
    return (next() >> 11) * (1.0 / 9007199254740992.0) + 5.6e-17;
  }
  double normal() {
    double u1 = uniform(), u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * kPi * u2);
  }
};

// Log-magnitude (fft_size/2+1 bins) -> minimum-phase complex spectrum
// (fft_size, conjugate-symmetric) via the cepstral method: mirror the log
// spectrum, IFFT to the (even, real) cepstrum, fold onto the causal side,
// FFT back, exponentiate.  re/im are fft_size scratch that receive the
// result.
void minimum_phase_spectrum(const double* logmag, int fft_size, double* re,
                            double* im) {
  const int n_freq = fft_size / 2 + 1;
  for (int k = 0; k < n_freq; ++k) {
    re[k] = logmag[k];
    im[k] = 0.0;
  }
  for (int k = n_freq; k < fft_size; ++k) {
    re[k] = logmag[fft_size - k];
    im[k] = 0.0;
  }
  fft_inplace(re, im, fft_size, /*inverse=*/true);  // real even cepstrum
  for (int k = 1; k < fft_size / 2; ++k) {
    re[k] *= 2.0;
    im[k] *= 2.0;
  }
  for (int k = fft_size / 2 + 1; k < fft_size; ++k) {
    re[k] = 0.0;
    im[k] = 0.0;
  }
  fft_inplace(re, im, fft_size, /*inverse=*/false);  // log min-phase spectrum
  for (int k = 0; k < fft_size; ++k) {
    double mag = std::exp(re[k]);
    re[k] = mag * std::cos(im[k]);
    im[k] = mag * std::sin(im[k]);
  }
}

double safe_aperiodicity(double x) {
  return std::min(0.999999999999, std::max(0.001, x));
}

}  // namespace

extern "C" {

// Number of 1 ms internal frames for a signal of n samples at fs.
int dvc_harvest_frames(long n, int fs, double frame_period_ms) {
  return static_cast<int>(1000.0 * n / fs / frame_period_ms) + 1;
}

// Harvest F0 estimation.  f0_out must hold dvc_harvest_frames(...) doubles
// for the requested frame_period.  `stage` selects the pipeline output
// (0 = base contour, 1 = jump removal, 2 = short-run removal, 3 = extension,
// 4 = smoothed final — the production value); intermediate stages exist for
// tests/debugging.  Returns the number of frames, -1 on error.
int dvc_harvest_stage(const float* x, long n, int fs, double frame_period_ms,
                      double f0_floor, double f0_ceil, double* f0_out,
                      int stage) {
  if (!x || !f0_out || n < 64 || fs <= 0) return -1;
  // parameter sanity: an inverted/degenerate search band would drive the
  // channel count negative (std::vector length_error -> process abort)
  if (!(f0_floor > 0.0) || !(f0_ceil > f0_floor) ||
      !(frame_period_ms > 0.0))
    return -1;

  // --- downsample to the ~8 kHz analysis rate ------------------------------
  int ratio = std::max(1, fs / 8000);
  std::vector<double> y = decimate(x, n, ratio);
  double afs = static_cast<double>(fs) / ratio;
  double mean = 0.0;
  for (double v : y) mean += v;
  mean /= std::max<size_t>(1, y.size());
  for (double& v : y) v -= mean;

  // --- internal 1 ms candidate grid ----------------------------------------
  const double cand_period = 0.001;  // seconds
  int n1 = static_cast<int>(n / static_cast<double>(fs) / cand_period) + 1;

  // --- spectrum of the analysis signal (filtering done in freq domain) -----
  int margin = static_cast<int>(4.0 * afs / f0_floor) + 1;
  int fft_size = next_pow2(static_cast<long>(y.size()) + 2L * margin);
  std::vector<double> yre(fft_size, 0.0), yim(fft_size, 0.0);
  for (size_t i = 0; i < y.size(); ++i) yre[i] = y[i];
  fft_inplace(yre.data(), yim.data(), fft_size);

  // --- channels: 24 per octave ---------------------------------------------
  int n_ch =
      1 + static_cast<int>(std::log2(f0_ceil / f0_floor) * 24.0);
  Candidates cand;
  cand.n_frames = n1;
  cand.max_c = n_ch;  // worst case one candidate per channel per frame
  cand.f0.assign(static_cast<size_t>(n1) * n_ch, 0.0);
  cand.score.assign(static_cast<size_t>(n1) * n_ch, 0.0);
  std::vector<int> n_cand(n1, 0);

  // Channel filtering + event trains run on the thread pool: each channel
  // writes its own (n1,) candidate column, and the dedup/insertion merge
  // below walks channels in index order, so the result is bit-identical to
  // the serial loop at any thread count.
  std::vector<std::vector<double>> chan_cand(n_ch);
  // Nuttall-windowed cosine band-pass spectra, cached across utterances of
  // the same FFT bucket (values identical to an in-loop computation)
  const FilterBank& fb = harvest_filter_bank(afs, fft_size, f0_floor,
                                             f0_ceil, n_ch);
  parallel_for(n_ch, [&](long ch) {
    if (fb.fre[ch].empty()) return;  // out-of-band or degenerate channel
    double bf0 = f0_floor * std::pow(2.0, (ch + 1) / 24.0);
    int half = fb.half[ch];
    // multiply spectra, inverse transform, compensate the filter delay.
    // Scratch is thread-local: ~1 MB of fresh pages per channel otherwise
    // dominates the stage on warm caches (values are fully overwritten
    // before use — bit-identical)
    static thread_local std::vector<double> fre_s, fim_s, filtered_s;
    fre_s.resize(fft_size);
    fim_s.resize(fft_size);
    std::vector<double>& fre = fre_s;
    std::vector<double>& fim = fim_s;
    const double* bre = fb.fre[ch].data();
    const double* bim = fb.fim[ch].data();
    for (int k = 0; k < fft_size; ++k) {
      fre[k] = yre[k] * bre[k] - yim[k] * bim[k];
      fim[k] = yre[k] * bim[k] + yim[k] * bre[k];
    }
    fft_inplace(fre.data(), fim.data(), fft_size, /*inverse=*/true);
    filtered_s.resize(y.size());
    std::vector<double>& filtered = filtered_s;
    for (size_t i = 0; i < y.size(); ++i) {
      size_t j = i + half;
      filtered[i] = (j < static_cast<size_t>(fft_size)) ? fre[j] : 0.0;
    }

    // four event trains (falling/rising zero crossings, peaks, dips) fused
    // into one pass.  Bit-identical to running zero_crossings on the
    // materialized neg/diff/ndiff copies: IEEE negation is exact and
    // fl(b-a) == -fl(a-b), so (-a)/((-a)-(-b)) == a/(a-b) bit-for-bit, and
    // the sign tests on negated values reduce to the mirrored comparisons.
    EventTrack tr[4];
    {
      const size_t m = filtered.size();
      std::vector<double> locs[4];
      auto dif_at = [&](size_t i) -> double {
        // zero_crossings(diff) read diff[m-1] == 0.0 (never written)
        return (i + 1 < m) ? filtered[i + 1] - filtered[i] : 0.0;
      };
      double da = dif_at(0);
      for (size_t i = 0; i + 1 < m; ++i) {
        double a = filtered[i], b = filtered[i + 1];
        if (a > 0.0 && b <= 0.0)
          locs[0].push_back((i + a / (a - b)) / afs);   // falling
        if (a < 0.0 && -b <= 0.0)
          locs[1].push_back((i + a / (a - b)) / afs);   // rising (== neg)
        double db = dif_at(i + 1);
        if (da > 0.0 && db <= 0.0)
          locs[2].push_back((i + da / (da - db)) / afs);  // peaks
        if (da < 0.0 && -db <= 0.0)
          locs[3].push_back((i + da / (da - db)) / afs);  // dips (== ndiff)
        da = db;
      }
      for (int e = 0; e < 4; ++e) {
        for (size_t k = 0; k + 1 < locs[e].size(); ++k) {
          double iv = locs[e][k + 1] - locs[e][k];
          if (iv <= 0) continue;
          tr[e].t.push_back(0.5 * (locs[e][k] + locs[e][k + 1]));
          tr[e].f0.push_back(1.0 / iv);
        }
      }
    }

    std::vector<double>& col = chan_cand[ch];
    col.assign(n1, 0.0);
    // marching interpolation cursors: frame times are monotone, so the
    // lower_bound of interp_track is reached by advancing a per-train
    // index (same segment, same arithmetic — bit-identical)
    size_t cur[4] = {1, 1, 1, 1};
    auto interp_march = [&](int e, double t) -> double {
      const EventTrack& trk = tr[e];
      if (trk.t.size() < 2 || t < trk.t.front() || t > trk.t.back())
        return 0.0;
      size_t& j = cur[e];
      if (j >= trk.t.size()) j = trk.t.size() - 1;
      // lower_bound semantics: first j with trk.t[j] >= t, clamped to >= 1
      while (j > 1 && trk.t[j - 1] >= t) --j;
      while (j < trk.t.size() - 1 && trk.t[j] < t) ++j;
      double t0 = trk.t[j - 1], t1 = trk.t[j];
      double a = (t1 > t0) ? (t - t0) / (t1 - t0) : 0.0;
      return trk.f0[j - 1] * (1.0 - a) + trk.f0[j] * a;
    };
    for (int i = 0; i < n1; ++i) {
      double t = i * cand_period;
      double v[4], s = 0.0;
      bool ok = true;
      for (int e = 0; e < 4; ++e) {
        v[e] = interp_march(e, t);
        if (v[e] <= 0.0) {
          ok = false;
          break;
        }
        s += v[e];
      }
      if (!ok) continue;
      double m = s / 4.0;
      double dev = 0.0;
      for (int e = 0; e < 4; ++e) dev += (v[e] - m) * (v[e] - m);
      dev = std::sqrt(dev / 3.0) / m;
      if (dev > 0.2) continue;                        // four must agree
      if (m < bf0 * 0.5 || m > bf0 * 2.0) continue;   // in-channel band
      if (m < f0_floor || m > f0_ceil) continue;
      col[i] = m;
    }
  });

  // serial merge in channel order with pre-refinement dedup: ~24 channels/
  // octave means the true pitch is found by several adjacent channels —
  // refining each copy would multiply the FFT cost for no information
  for (int ch = 0; ch < n_ch; ++ch) {
    const std::vector<double>& col = chan_cand[ch];
    if (col.empty()) continue;
    for (int i = 0; i < n1; ++i) {
      double m = col[i];
      if (m <= 0.0) continue;
      bool dup = false;
      for (int j = 0; j < n_cand[i] && !dup; ++j)
        dup = std::fabs(cand.F(i, j) - m) < 0.03 * m;
      if (dup) continue;
      if (n_cand[i] < cand.max_c) {
        cand.F(i, n_cand[i]) = m;
        cand.S(i, n_cand[i]) = 1.0;  // refined below
        n_cand[i]++;
      }
    }
  }

  // --- refinement + dedup (frames are independent -> thread pool) ----------
  parallel_for(n1, [&](long i) {
    // FFT-pair cache: shared between same-wlen candidates of this frame,
    // buffers reused across frames handled by this worker thread
    static thread_local RefineFrameCache rcache;
    rcache.reset();
    double t = i * cand_period;
    for (int j = 0; j < n_cand[i]; ++j) {
      double f0c = cand.F(i, j), sc = 0.0;
      refine_candidate(y, afs, t, f0_floor, f0_ceil, &f0c, &sc, &rcache);
      cand.F(i, j) = (sc > 0.0) ? f0c : 0.0;
      cand.S(i, j) = sc;
    }
    // merge near-duplicates (refined to the same pitch): keep best score
    for (int j = 0; j < n_cand[i]; ++j) {
      if (cand.F(i, j) <= 0.0) continue;
      for (int k = j + 1; k < n_cand[i]; ++k) {
        if (cand.F(i, k) <= 0.0) continue;
        if (std::fabs(cand.F(i, j) - cand.F(i, k)) <
            0.03 * cand.F(i, j)) {
          if (cand.S(i, k) > cand.S(i, j)) {
            cand.F(i, j) = cand.F(i, k);
            cand.S(i, j) = cand.S(i, k);
          }
          cand.F(i, k) = 0.0;
          cand.S(i, k) = 0.0;
        }
      }
    }
  });

  // --- neighbor-consistency pruning ----------------------------------------
  std::vector<double> pruned_score(cand.score);
  auto closest_ratio = [&](int frame, double f) -> double {
    // a missing neighbor (clip edge) is no evidence of inconsistency:
    // treat it as a perfect match so boundary frames are never pruned for
    // being first/last (audio trimmed mid-phonation keeps its edge f0)
    if (frame < 0 || frame >= n1) return 0.0;
    double best = 1e30;
    for (int j = 0; j < n_cand[frame]; ++j) {
      double c = cand.F(frame, j);
      if (c <= 0.0) continue;
      best = std::min(best, std::fabs(c - f) / f);
    }
    return best;
  };
  for (int i = 0; i < n1; ++i)
    for (int j = 0; j < n_cand[i]; ++j) {
      double f = cand.F(i, j);
      if (f <= 0.0) continue;
      if (closest_ratio(i - 1, f) > 0.05 || closest_ratio(i + 1, f) > 0.05)
        pruned_score[static_cast<size_t>(i) * cand.max_c + j] = 0.0;
    }
  cand.score.swap(pruned_score);

  // --- base contour: best score per frame ----------------------------------
  std::vector<double> f0(n1, 0.0);
  for (int i = 0; i < n1; ++i) {
    double best = 0.0, bf = 0.0;
    for (int j = 0; j < n_cand[i]; ++j)
      if (cand.S(i, j) > best) {
        best = cand.S(i, j);
        bf = cand.F(i, j);
      }
    f0[i] = bf;
  }

  // --- Step 1: remove impossible jumps (>0.8% per ms) ----------------------
  const double allowed = 0.008;
  std::vector<double> step1(f0);
  for (int i = 1; i < n1; ++i)
    if (f0[i] > 0.0 && f0[i - 1] > 0.0 &&
        std::fabs(f0[i] - f0[i - 1]) / f0[i] > allowed)
      step1[i] = 0.0;

  // --- Step 2: drop voiced runs shorter than 9 ms ---------------------------
  const int min_run = 9;
  std::vector<double> step2(step1);
  {
    int run_start = -1;
    for (int i = 0; i <= n1; ++i) {
      bool v = (i < n1) && step1[i] > 0.0;
      if (v && run_start < 0) run_start = i;
      if (!v && run_start >= 0) {
        if (i - run_start < min_run)
          for (int k = run_start; k < i; ++k) step2[k] = 0.0;
        run_start = -1;
      }
    }
  }

  // --- Steps 3/4: extend voiced sections through the candidate pool --------
  auto best_match = [&](int frame, double ref) -> double {
    if (frame < 0 || frame >= n1) return 0.0;
    double best_sc = 0.0, best_f = 0.0;
    for (int j = 0; j < n_cand[frame]; ++j) {
      double c = cand.F(frame, j);
      if (c <= 0.0) continue;
      if (std::fabs(c - ref) / ref > 0.09) continue;
      // prefer the closest candidate among acceptable ones
      double sc = 1.0 / (kEps + std::fabs(c - ref));
      if (sc > best_sc) {
        best_sc = sc;
        best_f = c;
      }
    }
    return best_f;
  };
  std::vector<double> fixed(step2);
  // forward extension from every voiced->unvoiced boundary
  for (int i = 1; i < n1; ++i) {
    if (!(fixed[i - 1] > 0.0 && fixed[i] == 0.0)) continue;
    double ref = fixed[i - 1];
    for (int k = i; k < std::min(n1, i + 100); ++k) {
      if (fixed[k] > 0.0) break;  // met the next section
      double m = best_match(k, ref);
      if (m <= 0.0) break;
      fixed[k] = m;
      ref = m;
    }
  }
  // backward extension
  for (int i = n1 - 2; i >= 0; --i) {
    if (!(fixed[i + 1] > 0.0 && fixed[i] == 0.0)) continue;
    double ref = fixed[i + 1];
    for (int k = i; k > std::max(-1, i - 100); --k) {
      if (fixed[k] > 0.0) break;
      double m = best_match(k, ref);
      if (m <= 0.0) break;
      fixed[k] = m;
      ref = m;
    }
  }

  // --- smoothing: zero-phase Butterworth (30 Hz) per voiced segment --------
  std::vector<double> extended(fixed);
  {
    int run_start = -1;
    for (int i = 0; i <= n1; ++i) {
      bool v = (i < n1) && fixed[i] > 0.0;
      if (v && run_start < 0) run_start = i;
      if (!v && run_start >= 0) {
        std::vector<double> seg(fixed.begin() + run_start, fixed.begin() + i);
        zero_phase_lpf(seg, 0.03);
        for (int k = run_start; k < i; ++k) fixed[k] = seg[k - run_start];
        run_start = -1;
      }
    }
  }

  // --- resample the 1 ms track to the requested frame period ---------------
  const std::vector<double>* stages[5] = {&f0, &step1, &step2, &extended,
                                          &fixed};
  const std::vector<double>& track =
      *stages[std::min(std::max(stage, 0), 4)];
  int n_out = dvc_harvest_frames(n, fs, frame_period_ms);
  for (int i = 0; i < n_out; ++i) {
    double t = i * frame_period_ms / 1000.0;
    int k = std::min(n1 - 1, static_cast<int>(t / cand_period + 0.5));
    double v = track[k];
    f0_out[i] = (v >= f0_floor && v <= f0_ceil) ? v : 0.0;
  }
  return n_out;
}

int dvc_harvest(const float* x, long n, int fs, double frame_period_ms,
                double f0_floor, double f0_ceil, double* f0_out) {
  return dvc_harvest_stage(x, n, fs, frame_period_ms, f0_floor, f0_ceil,
                           f0_out, 4);
}

// ------------------------------------------------------------- DIO --------
// DIO F0 estimation (Morise et al. 2009/2010 — the method behind
// pyworld.dio, the reference's pitch extractor at
// reference preprocessing/utils.py:183-192).  Pipeline: decimate to
// ~8 kHz -> per-band Nuttall low-pass at log-spaced boundary f0s
// (channels_in_octave, pyworld default 2.0) -> four interval-based period
// detectors (falling/rising zero crossings, peaks, dips) evaluated
// directly at the OUTPUT frame grid (unlike Harvest's 1 ms internal grid)
// -> per-band candidate = mean of the four intervals, scored by their
// relative deviation (the band whose low-pass leaves a near-sinusoid at
// the true f0 wins) -> jump removal at `allowed_range` per frame (pyworld
// default 0.1), short-run removal (voice_range_minimum frames, the
// 2/f0_floor-seconds rule), candidate-pool extension.  DIO ships no
// contour smoothing (StoneMask refines afterwards), so none is applied.
// Numeric agreement with pyworld.dio is gated by the golden scaffold
// (tools/gen_dio_golden.py, once pyworld fixtures are recorded); behavioral
// agreement by tests/test_dio.py truth/noise/Harvest-consistency gates.
int dvc_dio(const float* x, long n, int fs, double frame_period_ms,
            double f0_floor, double f0_ceil, double channels_in_octave,
            double allowed_range, double* f0_out) {
  if (!x || !f0_out || n < 64 || fs <= 0) return -1;
  if (!(f0_floor > 0.0) || !(f0_ceil > f0_floor) ||
      !(frame_period_ms > 0.0) || !(channels_in_octave > 0.0) ||
      !(allowed_range > 0.0))
    return -1;

  int ratio = std::max(1, fs / 8000);
  std::vector<double> y = decimate(x, n, ratio);
  double afs = static_cast<double>(fs) / ratio;
  double mean = 0.0;
  for (double v : y) mean += v;
  mean /= std::max<size_t>(1, y.size());
  for (double& v : y) v -= mean;

  int n_out = dvc_harvest_frames(n, fs, frame_period_ms);
  int n_bands =
      1 + static_cast<int>(std::log2(f0_ceil / f0_floor) *
                           channels_in_octave);

  // spectrum once; per-band low-pass is a spectral multiply (the longest
  // impulse is ~2 periods of the lowest boundary f0)
  int margin = static_cast<int>(2.0 * afs / f0_floor) + 2;
  int fft_size = next_pow2(static_cast<long>(y.size()) + 2L * margin);
  std::vector<double> yre(fft_size, 0.0), yim(fft_size, 0.0);
  for (size_t i = 0; i < y.size(); ++i) yre[i] = y[i];
  fft_inplace(yre.data(), yim.data(), fft_size);

  // candidate grid: (n_out, n_bands) f0 + deviation score (lower better)
  std::vector<double> cf0(static_cast<size_t>(n_out) * n_bands, 0.0);
  std::vector<double> cdev(static_cast<size_t>(n_out) * n_bands, 1e30);

  parallel_for(n_bands, [&](long b) {
    double boundary = f0_floor * std::pow(2.0, (b + 1) / channels_in_octave);
    int half = static_cast<int>(afs / boundary + 0.5);
    int flen = 2 * half + 1;
    if (flen >= fft_size) return;
    // Nuttall-window low-pass (main-lobe cutoff ~ the boundary f0) with
    // the filter delay compensated by reading at i + half
    std::vector<double> fre(fft_size, 0.0), fim(fft_size, 0.0);
    for (int i = 0; i < flen; ++i)
      fre[i] = nuttall(static_cast<double>(i) / (flen - 1));
    fft_inplace(fre.data(), fim.data(), fft_size);
    for (int k = 0; k < fft_size; ++k) {
      double re = yre[k] * fre[k] - yim[k] * fim[k];
      double im = yre[k] * fim[k] + yim[k] * fre[k];
      fre[k] = re;
      fim[k] = im;
    }
    fft_inplace(fre.data(), fim.data(), fft_size, /*inverse=*/true);
    std::vector<double> filtered(y.size());
    for (size_t i = 0; i < y.size(); ++i) {
      size_t j = i + half;
      filtered[i] = (j < static_cast<size_t>(fft_size)) ? fre[j] : 0.0;
    }

    // four event trains (shared helpers with Harvest: falling/rising
    // zero crossings of the signal; peaks/dips via its first difference)
    EventTrack tr[4];
    {
      const size_t m = filtered.size();
      std::vector<double> locs[4];
      auto dif_at = [&](size_t i) -> double {
        return (i + 1 < m) ? filtered[i + 1] - filtered[i] : 0.0;
      };
      double da = dif_at(0);
      for (size_t i = 0; i + 1 < m; ++i) {
        double a = filtered[i], bb = filtered[i + 1];
        if (a > 0.0 && bb <= 0.0)
          locs[0].push_back((i + a / (a - bb)) / afs);
        if (a < 0.0 && -bb <= 0.0)
          locs[1].push_back((i + a / (a - bb)) / afs);
        double db = dif_at(i + 1);
        if (da > 0.0 && db <= 0.0)
          locs[2].push_back((i + da / (da - db)) / afs);
        if (da < 0.0 && -db <= 0.0)
          locs[3].push_back((i + da / (da - db)) / afs);
        da = db;
      }
      for (int e = 0; e < 4; ++e)
        for (size_t k = 0; k + 1 < locs[e].size(); ++k) {
          double iv = locs[e][k + 1] - locs[e][k];
          if (iv <= 0) continue;
          tr[e].t.push_back(0.5 * (locs[e][k] + locs[e][k + 1]));
          tr[e].f0.push_back(1.0 / iv);
        }
    }

    size_t cur[4] = {1, 1, 1, 1};
    auto interp_march = [&](int e, double t) -> double {
      const EventTrack& trk = tr[e];
      if (trk.t.size() < 2 || t < trk.t.front() || t > trk.t.back())
        return 0.0;
      size_t& j = cur[e];
      if (j >= trk.t.size()) j = trk.t.size() - 1;
      while (j > 1 && trk.t[j - 1] >= t) --j;
      while (j < trk.t.size() - 1 && trk.t[j] < t) ++j;
      double t0 = trk.t[j - 1], t1 = trk.t[j];
      double a = (t1 > t0) ? (t - t0) / (t1 - t0) : 0.0;
      return trk.f0[j - 1] * (1.0 - a) + trk.f0[j] * a;
    };
    for (int i = 0; i < n_out; ++i) {
      double t = i * frame_period_ms / 1000.0;
      double v[4], s = 0.0;
      bool ok = true;
      for (int e = 0; e < 4; ++e) {
        v[e] = interp_march(e, t);
        if (v[e] <= 0.0) {
          ok = false;
          break;
        }
        s += v[e];
      }
      if (!ok) continue;
      double m4 = s / 4.0;
      double dev = 0.0;
      for (int e = 0; e < 4; ++e) dev += (v[e] - m4) * (v[e] - m4);
      dev = std::sqrt(dev / 3.0) / m4;
      // a band can only detect pitches below its own low-pass cutoff
      if (m4 < f0_floor || m4 > f0_ceil || m4 > boundary * 1.2) continue;
      cf0[static_cast<size_t>(i) * n_bands + b] = m4;
      cdev[static_cast<size_t>(i) * n_bands + b] = dev;
    }
  });

  // best (most stable) candidate per frame; unstable frames are unvoiced
  std::vector<double> f0(n_out, 0.0);
  for (int i = 0; i < n_out; ++i) {
    double best_dev = 0.2, best_f = 0.0;  // stability cutoff as Harvest's
    for (int b = 0; b < n_bands; ++b) {
      double d = cdev[static_cast<size_t>(i) * n_bands + b];
      if (d < best_dev) {
        best_dev = d;
        best_f = cf0[static_cast<size_t>(i) * n_bands + b];
      }
    }
    f0[i] = best_f;
  }

  // Step 1: jump removal at allowed_range per FRAME (pyworld default 0.1)
  std::vector<double> step1(f0);
  for (int i = 1; i < n_out; ++i)
    if (f0[i] > 0.0 && f0[i - 1] > 0.0 &&
        std::fabs(f0[i] - f0[i - 1]) / f0[i] > allowed_range)
      step1[i] = 0.0;

  // Step 2: drop voiced runs shorter than voice_range_minimum
  int min_run =
      static_cast<int>(0.5 + 2000.0 / frame_period_ms / f0_floor) + 1;
  std::vector<double> step2(step1);
  {
    int run_start = -1;
    for (int i = 0; i <= n_out; ++i) {
      bool v = (i < n_out) && step1[i] > 0.0;
      if (v && run_start < 0) run_start = i;
      if (!v && run_start >= 0) {
        if (i - run_start < min_run)
          for (int k = run_start; k < i; ++k) step2[k] = 0.0;
        run_start = -1;
      }
    }
  }

  // Steps 3/4: extend voiced sections through the candidate pool
  auto best_match = [&](int frame, double ref) -> double {
    if (frame < 0 || frame >= n_out) return 0.0;
    double best_sc = 0.0, best_f = 0.0;
    for (int b = 0; b < n_bands; ++b) {
      double c = cf0[static_cast<size_t>(frame) * n_bands + b];
      if (c <= 0.0) continue;
      if (std::fabs(c - ref) / ref > allowed_range) continue;
      double sc = 1.0 / (kEps + std::fabs(c - ref));
      if (sc > best_sc) {
        best_sc = sc;
        best_f = c;
      }
    }
    return best_f;
  };
  for (int i = 1; i < n_out; ++i) {
    if (!(step2[i - 1] > 0.0 && step2[i] == 0.0)) continue;
    double ref = step2[i - 1];
    for (int k = i; k < std::min(n_out, i + 20); ++k) {
      if (step2[k] > 0.0) break;
      double m = best_match(k, ref);
      if (m <= 0.0) break;
      step2[k] = m;
      ref = m;
    }
  }
  for (int i = n_out - 2; i >= 0; --i) {
    if (!(step2[i + 1] > 0.0 && step2[i] == 0.0)) continue;
    double ref = step2[i + 1];
    for (int k = i; k > std::max(-1, i - 20); --k) {
      if (step2[k] > 0.0) break;
      double m = best_match(k, ref);
      if (m <= 0.0) break;
      step2[k] = m;
      ref = m;
    }
  }

  for (int i = 0; i < n_out; ++i)
    f0_out[i] = (step2[i] >= f0_floor && step2[i] <= f0_ceil) ? step2[i]
                                                              : 0.0;
  return n_out;
}

// D4C band aperiodicity.  ap_out must hold n_frames * (fft_size_out/2 + 1)
// doubles ((frame, bin) row-major, like pyworld.d4c's output grid).
// `threshold` is the LoveTrain voicing cutoff (pyworld default 0.85; pass
// <= 0 to disable the override).  Returns 0, -1 on error.
int dvc_d4c(const float* x, long n, int fs, const double* f0, int n_frames,
            double frame_period_ms, int fft_size_out, double threshold,
            double* ap_out) {
  if (!x || !f0 || !ap_out || n <= 0 || n_frames <= 0) return -1;
  const double floor_f0 = 47.0;
  const double freq_interval = 3000.0;
  const int fft_d4c =
      1 << (1 + static_cast<int>(
                    std::ceil(std::log2(4.0 * fs / floor_f0 + 1.0))));
  const int n_freq_d4c = fft_d4c / 2 + 1;
  int n_bands = static_cast<int>(
      std::min(15000.0, fs / 2.0 - freq_interval) / freq_interval);
  n_bands = std::max(1, n_bands);
  const int n_out = fft_size_out / 2 + 1;

  // frequency-domain Nuttall window for the per-band group-delay slice
  const int seg_half = static_cast<int>(freq_interval * fft_d4c / fs);
  const int seg_len = 2 * seg_half + 1;
  std::vector<double> seg_win(seg_len);
  for (int i = 0; i < seg_len; ++i)
    seg_win[i] = nuttall(static_cast<double>(i) / (seg_len - 1));
  const int boundary =
      static_cast<int>(fft_d4c * 8.0 / seg_len + 0.5);  // main-lobe width

  auto sample = [&](long i) -> double {
    return (i >= 0 && i < n) ? x[i] : 0.0;
  };

  // rectangular smoothing across frequency (width w_hz), cumsum-based
  auto linear_smooth = [&](const std::vector<double>& in,
                           std::vector<double>& out, double w_hz) {
    int nf = static_cast<int>(in.size());
    double res = static_cast<double>(fs) / fft_d4c;
    double w_bins = std::max(1.0, w_hz / res);
    std::vector<double> cs(nf + 1, 0.0);
    for (int i = 0; i < nf; ++i) cs[i + 1] = cs[i] + in[i];
    auto at = [&](double p) {
      p = std::min(std::max(p, 0.0), static_cast<double>(nf));
      int i0 = static_cast<int>(p);
      double fr = p - i0;
      double c0 = cs[i0];
      double c1 = cs[std::min(i0 + 1, nf)];
      return c0 * (1.0 - fr) + c1 * fr;
    };
    for (int i = 0; i < nf; ++i) {
      double lo = i - w_bins / 2.0, hi = i + w_bins / 2.0;
      out[i] = (at(hi) - at(lo)) / std::max(hi - lo, 1e-9);
    }
  };

  // LoveTrain analysis geometry (lowest analyzable pitch 40 Hz)
  const double lowest_f0 = 40.0;
  const int fft_lt = next_pow2(static_cast<long>(3.0 * fs / lowest_f0 + 1.0));
  const int lt_b0 = static_cast<int>(std::ceil(100.0 * fft_lt / fs));
  const int lt_b1 = static_cast<int>(std::ceil(4000.0 * fft_lt / fs));
  const int lt_b2 = static_cast<int>(std::ceil(7900.0 * fft_lt / fs));

  // Frames are independent; each writes only its own output row and uses
  // only local scratch, so the pool is deterministic.
  std::atomic<bool> failed(false);
  parallel_for(n_frames, [&](long fr) {
    double* row = ap_out + static_cast<size_t>(fr) * n_out;
    double cf0 = f0[fr];
    double tpos = fr * frame_period_ms / 1000.0;
    if (cf0 > 0.0 && threshold > 0.0) {
      double ap0 = love_train_frame(x, n, fs, std::max(cf0, lowest_f0), tpos,
                                    fft_lt, lt_b0, lt_b1, lt_b2);
      if (ap0 <= threshold) cf0 = 0.0;  // override: treat as unvoiced
    }
    if (cf0 <= 0.0 || cf0 < floor_f0) {
      for (int k = 0; k < n_out; ++k) row[k] = 1.0 - 1e-12;
      return;
    }
    std::vector<double> re(fft_d4c), im(fft_d4c);
    std::vector<double> centroid(n_freq_d4c), power(n_freq_d4c),
        gd(n_freq_d4c), gd_smooth(n_freq_d4c);
    std::vector<double> coarse_db(n_bands);
    double t0s = fs / cf0;  // period in samples

    // ---- static centroid: Blackman 4*T0 windows at +-T0/4 -----------------
    std::fill(centroid.begin(), centroid.end(), 0.0);
    for (int off = -1; off <= 1; off += 2) {
      long c = static_cast<long>(tpos * fs + off * t0s / 4.0 + 0.5);
      int half = static_cast<int>(2.0 * t0s + 0.5);
      int wlen = 2 * half + 1;
      if (wlen >= fft_d4c) {
        failed.store(true);
        return;
      }
      std::vector<double> wave(wlen);
      double pw = 0.0;
      for (int i = 0; i < wlen; ++i) {
        double w = blackman(static_cast<double>(i) / (wlen - 1));
        wave[i] = sample(c - half + i) * w;
        pw += wave[i] * wave[i];
      }
      double norm = 1.0 / std::sqrt(std::max(pw, kEps));
      std::fill(re.begin(), re.end(), 0.0);
      std::fill(im.begin(), im.end(), 0.0);
      for (int i = 0; i < wlen; ++i) re[i] = wave[i] * norm;
      std::vector<double> re_t(fft_d4c, 0.0), im_t(fft_d4c, 0.0);
      for (int i = 0; i < wlen; ++i)
        re_t[i] = re[i] * (i + 1.0) / fs;  // time-weighted (seconds)
      fft_inplace(re.data(), im.data(), fft_d4c);
      fft_inplace(re_t.data(), im_t.data(), fft_d4c);
      for (int k = 0; k < n_freq_d4c; ++k)
        centroid[k] += re[k] * re_t[k] + im[k] * im_t[k];  // Re{S* St}
    }

    // ---- smoothed power spectrum: Hanning 4*T0, width-F0 smoothing --------
    {
      long c = static_cast<long>(tpos * fs + 0.5);
      int half = static_cast<int>(2.0 * t0s + 0.5);
      int wlen = 2 * half + 1;
      std::fill(re.begin(), re.end(), 0.0);
      std::fill(im.begin(), im.end(), 0.0);
      for (int i = 0; i < wlen; ++i) {
        double w = 0.5 - 0.5 * std::cos(2.0 * kPi * i / (wlen - 1.0));
        re[i] = sample(c - half + i) * w;
      }
      fft_inplace(re.data(), im.data(), fft_d4c);
      for (int k = 0; k < n_freq_d4c; ++k)
        power[k] = re[k] * re[k] + im[k] * im[k];
      std::vector<double> sm(n_freq_d4c);
      linear_smooth(power, sm, cf0);
      power.swap(sm);
    }

    // ---- static group delay, high-passed across frequency -----------------
    for (int k = 0; k < n_freq_d4c; ++k)
      gd[k] = centroid[k] / std::max(power[k], kEps);
    linear_smooth(gd, gd_smooth, cf0 / 2.0);
    for (int k = 0; k < n_freq_d4c; ++k) gd[k] -= gd_smooth[k];

    // ---- coarse aperiodicity per 3 kHz band --------------------------------
    for (int b = 0; b < n_bands; ++b) {
      int center =
          static_cast<int>(freq_interval * (b + 1) * fft_d4c / fs + 0.5);
      std::fill(re.begin(), re.end(), 0.0);
      std::fill(im.begin(), im.end(), 0.0);
      for (int i = 0; i < seg_len; ++i) {
        int k = center - seg_half + i;
        double v = (k >= 0 && k < n_freq_d4c) ? gd[k] : 0.0;
        re[i] = v * seg_win[i];
      }
      fft_inplace(re.data(), im.data(), fft_d4c);
      std::vector<double> p(n_freq_d4c);
      for (int k = 0; k < n_freq_d4c; ++k)
        p[k] = re[k] * re[k] + im[k] * im[k];
      std::sort(p.begin(), p.end());
      for (int k = 1; k < n_freq_d4c; ++k) p[k] += p[k - 1];
      double total = std::max(p[n_freq_d4c - 1], kEps);
      int cut = std::max(0, n_freq_d4c - 1 - boundary);
      double apw = p[cut] / total;  // power outside the coherent main lobe
      coarse_db[b] =
          std::min(0.0, std::max(-60.0, 10.0 * std::log10(std::max(apw, 1e-12))));
    }

    // ---- interpolate the coarse dB axis onto the output grid --------------
    // anchors: (0 Hz, -60 dB), (3k..3k*n_bands, measured), (fs/2, ~0 dB)
    std::vector<double> ax(n_bands + 2), av(n_bands + 2);
    ax[0] = 0.0;
    av[0] = -60.0;
    for (int b = 0; b < n_bands; ++b) {
      ax[b + 1] = freq_interval * (b + 1);
      av[b + 1] = coarse_db[b];
    }
    ax[n_bands + 1] = fs / 2.0;
    av[n_bands + 1] = -1e-12;
    int seg = 0;
    for (int k = 0; k < n_out; ++k) {
      double f = static_cast<double>(k) * fs / fft_size_out;
      while (seg + 2 < static_cast<int>(ax.size()) && f > ax[seg + 1]) ++seg;
      double a = (f - ax[seg]) / std::max(ax[seg + 1] - ax[seg], kEps);
      a = std::min(std::max(a, 0.0), 1.0);
      double db = av[seg] * (1.0 - a) + av[seg + 1] * a;
      row[k] = std::min(1.0 - 1e-12,
                        std::max(0.001, std::pow(10.0, db / 20.0)));
    }
  });
  return failed.load() ? -1 : 0;
}

// WORLD-faithful synthesis (role of pyworld.synthesize, reference
// preprocessing/WORLD_processing.py:99-106).  Per the WORLD vocoder
// (Morise 2016): the F0 contour is interpolated to sample rate, glottal
// pulse instants are the 2*pi wrap points of the accumulated phase (with a
// fractional-sample offset from the linear zero crossing), and each pulse
// contributes one fft_size-long response that is the sum of
//   * a periodic part: minimum-phase response of the envelope with the
//     aperiodic power removed, sp*(1-ap^2), fractionally time-shifted by a
//     linear phase and scaled by sqrt(pulse interval) for flat power;
//   * an aperiodic part: a white-noise segment spanning the pulse interval
//     shaped by the minimum-phase response of sp*ap^2 (full sp when
//     unvoiced — unvoiced regions tick at a 500 Hz default rate and carry
//     noise only).
// Envelopes are linearly interpolated to the pulse time; aperiodicity is
// geometrically interpolated and squared (amplitude ratio -> power ratio).
// Responses are overlap-added causally at the pulse instant.
//
// f0: (n_frames,), sp/ap: (n_frames, fft_size/2+1) row-major (CheapTrick
// power envelope, D4C amplitude-ratio aperiodicity).  y_out must hold
// y_length doubles (zeroed here).  Returns 0, -1 on bad args.
int dvc_synthesis(const double* f0, int n_frames, const double* sp,
                  const double* ap, int fft_size, int fs,
                  double frame_period_ms, long y_length,
                  unsigned long long seed, double* y_out) {
  if (!f0 || !sp || !ap || !y_out || n_frames <= 0 || y_length <= 0 ||
      fft_size < 8 || (fft_size & (fft_size - 1)) != 0 || fs <= 0 ||
      frame_period_ms <= 0.0)
    return -1;
  const int n_freq = fft_size / 2 + 1;
  const double fp = frame_period_ms / 1000.0;
  const double lowest_f0 = static_cast<double>(fs) / fft_size + 1.0;
  const double default_f0 = 500.0;  // unvoiced time-base rate (WORLD value)
  const double safe_guard = 1e-12;

  // ---- per-sample time base --------------------------------------------
  // coarse f0/vuv with one linearly extrapolated trailing frame so the
  // interpolation covers the full y_length
  std::vector<double> cf0(n_frames + 1), cvuv(n_frames + 1);
  for (int i = 0; i < n_frames; ++i) {
    cf0[i] = (f0[i] < lowest_f0) ? 0.0 : f0[i];
    cvuv[i] = cf0[i] > 0.0 ? 1.0 : 0.0;
  }
  cf0[n_frames] = n_frames >= 2
                      ? std::max(0.0, 2.0 * cf0[n_frames - 1] - cf0[n_frames - 2])
                      : cf0[n_frames - 1];
  cvuv[n_frames] = cvuv[n_frames - 1];

  std::vector<double> if0(y_length), ivuv(y_length);
  for (long i = 0; i < y_length; ++i) {
    double pos = (static_cast<double>(i) / fs) / fp;
    int j = std::min(n_frames - 1, static_cast<int>(pos));
    double a = std::min(1.0, std::max(0.0, pos - j));
    double v = cvuv[j] * (1.0 - a) + cvuv[j + 1] * a;
    double f = cf0[j] * (1.0 - a) + cf0[j + 1] * a;
    ivuv[i] = v;
    if0[i] = (v > 0.5) ? std::max(f, lowest_f0) : default_f0;
  }

  // ---- pulse instants from the accumulated phase ------------------------
  std::vector<long> pidx;
  std::vector<double> pshift;
  {
    double total = 0.0, wrap_prev = 0.0;
    for (long i = 0; i < y_length; ++i) {
      total += 2.0 * kPi * if0[i] / fs;
      double wrap = std::fmod(total, 2.0 * kPi);
      if (i > 0 && std::fabs(wrap - wrap_prev) > kPi) {
        // phase crossed 2*pi between samples i-1 and i
        double y1 = wrap_prev - 2.0 * kPi;
        double y2 = wrap;
        double x = (y2 > y1) ? -y1 / (y2 - y1) : 0.0;  // zero crossing in [0,1]
        pidx.push_back(i - 1);
        pshift.push_back(x / fs);
      }
      wrap_prev = wrap;
    }
  }
  std::memset(y_out, 0, sizeof(double) * y_length);
  const long n_pulses = static_cast<long>(pidx.size());
  if (n_pulses == 0) return 0;

  // hann-shaped DC remover (unit sum): the periodic min-phase response has
  // a small DC bias that would accumulate across overlap-added pulses
  std::vector<double> dc_remover(fft_size);
  {
    double s = 0.0;
    for (int i = 0; i < fft_size; ++i) {
      dc_remover[i] =
          0.5 - 0.5 * std::cos(2.0 * kPi * (i + 1.0) / (1.0 + fft_size));
      s += dc_remover[i];
    }
    for (int i = 0; i < fft_size; ++i) dc_remover[i] /= s;
  }

  // ---- per-pulse responses (parallel; deterministic per-pulse RNG) ------
  std::vector<double> resp(static_cast<size_t>(n_pulses) * fft_size, 0.0);
  parallel_for(n_pulses, [&](long p) {
    const long idx = pidx[p];
    const long next_idx = (p + 1 < n_pulses) ? pidx[p + 1] : y_length;
    const int noise_size = static_cast<int>(
        std::max<long>(1, std::min<long>(fft_size, next_idx - idx)));
    const double vuv = ivuv[idx];
    const double pos = (static_cast<double>(idx) / fs) / fp;
    const int j0 = std::min(n_frames - 1, static_cast<int>(pos));
    const int j1 = std::min(n_frames - 1, j0 + 1);
    const double a = std::min(1.0, std::max(0.0, pos - j0));
    const double* sp0 = sp + static_cast<size_t>(j0) * n_freq;
    const double* sp1 = sp + static_cast<size_t>(j1) * n_freq;
    const double* ap0 = ap + static_cast<size_t>(j0) * n_freq;
    const double* ap1 = ap + static_cast<size_t>(j1) * n_freq;

    std::vector<double> env(n_freq), ap2(n_freq), logmag(n_freq);
    for (int k = 0; k < n_freq; ++k) {
      env[k] = sp0[k] * (1.0 - a) + sp1[k] * a;
      double g = std::pow(safe_aperiodicity(ap0[k]), 1.0 - a) *
                 std::pow(safe_aperiodicity(ap1[k]), a);
      ap2[k] = g * g;
    }

    double* out = resp.data() + static_cast<size_t>(p) * fft_size;
    std::vector<double> re(fft_size), im(fft_size);

    // periodic part
    if (vuv > 0.5 && ap2[0] <= 0.999) {
      for (int k = 0; k < n_freq; ++k)
        logmag[k] =
            0.5 * std::log(std::max(env[k] * (1.0 - ap2[k]), 0.0) + safe_guard);
      minimum_phase_spectrum(logmag.data(), fft_size, re.data(), im.data());
      // fractional time shift as linear phase (conjugate-symmetric)
      const double coef = 2.0 * kPi * pshift[p] * fs / fft_size;
      for (int k = 0; k < fft_size; ++k) {
        double kf = (k <= fft_size / 2) ? k : k - fft_size;
        double cr = std::cos(-coef * kf), ci = std::sin(-coef * kf);
        double nr = re[k] * cr - im[k] * ci;
        im[k] = re[k] * ci + im[k] * cr;
        re[k] = nr;
      }
      fft_inplace(re.data(), im.data(), fft_size, /*inverse=*/true);
      double dc = 0.0;
      for (int k = 0; k < fft_size; ++k) dc += re[k];
      const double scale = std::sqrt(static_cast<double>(noise_size));
      for (int k = 0; k < fft_size; ++k)
        out[k] = (re[k] - dc_remover[k] * dc) * scale;
    }

    // aperiodic part: white-noise segment spanning the pulse interval,
    // shaped by the minimum-phase response of the aperiodic envelope
    std::vector<double> nre(fft_size, 0.0), nim(fft_size, 0.0);
    PulseRng rng(seed, static_cast<uint64_t>(p));
    double avg = 0.0;
    for (int i = 0; i < noise_size; ++i) {
      nre[i] = rng.normal();
      avg += nre[i];
    }
    avg /= noise_size;
    for (int i = 0; i < noise_size; ++i) nre[i] -= avg;
    fft_inplace(nre.data(), nim.data(), fft_size, /*inverse=*/false);
    for (int k = 0; k < n_freq; ++k)
      logmag[k] = 0.5 * std::log(env[k] * (vuv > 0.5 ? ap2[k] : 1.0) +
                                 safe_guard);
    minimum_phase_spectrum(logmag.data(), fft_size, re.data(), im.data());
    for (int k = 0; k < fft_size; ++k) {
      double cr = re[k] * nre[k] - im[k] * nim[k];
      im[k] = re[k] * nim[k] + im[k] * nre[k];
      re[k] = cr;
    }
    fft_inplace(re.data(), im.data(), fft_size, /*inverse=*/true);
    for (int k = 0; k < fft_size; ++k) out[k] += re[k];
  });

  // ---- serial overlap-add (fixed order; causal at the pulse instant) ----
  for (long p = 0; p < n_pulses; ++p) {
    const double* r = resp.data() + static_cast<size_t>(p) * fft_size;
    const long base = pidx[p];
    const long hi = std::min<long>(fft_size, y_length - base);
    for (long j = 0; j < hi; ++j) y_out[base + j] += r[j];
  }
  return 0;
}

}  // extern "C"
