// dvc_dsp — native host-side DSP / data-loading engine.
//
// The reference's native code lives in external pip packages (lws C++ STFT,
// librosa/numba resampling, webrtcvad — SURVEY.md §2.3).  This library is the
// in-repo C++ equivalent: WAV decode, polyphase resampling, lws-compatible
// framing + real FFT, mel projection, dB + [0,1] normalization, energy VAD,
// and a pthread-pooled batch front end, exported through a plain C ABI and
// bound via ctypes (dvc_tpu_torch/native/__init__.py).  It feeds the offline
// preprocessing path when host CPUs are the bottleneck (the device path in
// ops/ is the PyTorch pipeline; both produce the same mels, see
// tests/test_torch_port_preprocess.py).  A copy of dvc_tpu/native/dvc_dsp.cpp,
// so that the PyTorch port builds its own engine.
//
// Math parity targets (checked against the port's ops):
//   mel basis    == ops/mel.py mel_filterbank (slaney scale + area norm)
//   framing      == ops/stft.py num_frames/pad_lr (ref preprocessing/utils.py:89-107)
//   window       == sqrt(periodic hann)
//   dB/normalize == ref preprocessing/utils.py:129-143
//
// Build: dvc_tpu_torch/native/_build.py at first use (g++ -O3 -shared -fPIC,
// no dependencies) into build/native/.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "dvc_common.h"  // FFT, thread pool (shared with dvc_world)

namespace {

using dvc::kPi;
using dvc::fft_inplace;

// --------------------------------------------------------------- mel -------
// slaney mel scale (librosa default), matching ops/mel.py bit-for-bit in
// double precision.
double hz_to_mel(double f) {
  const double f_sp = 200.0 / 3.0, min_log_hz = 1000.0;
  const double min_log_mel = min_log_hz / f_sp;
  const double logstep = std::log(6.4) / 27.0;
  if (f >= min_log_hz) return min_log_mel + std::log(f / min_log_hz) / logstep;
  return f / f_sp;
}

double mel_to_hz(double m) {
  const double f_sp = 200.0 / 3.0, min_log_hz = 1000.0;
  const double min_log_mel = min_log_hz / f_sp;
  const double logstep = std::log(6.4) / 27.0;
  if (m >= min_log_mel) return min_log_hz * std::exp(logstep * (m - min_log_mel));
  return m * f_sp;
}

struct MelParams {
  int sample_rate = 16000;
  int fft_size = 1024;
  int hop_size = 256;
  int num_mels = 80;
  double fmin = 90.0;
  double fmax = 7600.0;
  double min_level_db = -100.0;
  double ref_level_db = 16.0;
};

std::vector<float> build_mel_basis(const MelParams& p) {
  int n_freq = p.fft_size / 2 + 1;
  std::vector<double> fftfreqs(n_freq);
  for (int i = 0; i < n_freq; ++i)
    fftfreqs[i] = 0.5 * p.sample_rate * i / (n_freq - 1);
  std::vector<double> hz(p.num_mels + 2);
  double m_lo = hz_to_mel(p.fmin), m_hi = hz_to_mel(p.fmax);
  for (int i = 0; i < p.num_mels + 2; ++i)
    hz[i] = mel_to_hz(m_lo + (m_hi - m_lo) * i / (p.num_mels + 1));
  std::vector<float> w(p.num_mels * n_freq, 0.f);
  for (int m = 0; m < p.num_mels; ++m) {
    double enorm = 2.0 / (hz[m + 2] - hz[m]);
    for (int k = 0; k < n_freq; ++k) {
      double lower = (fftfreqs[k] - hz[m]) / (hz[m + 1] - hz[m]);
      double upper = (hz[m + 2] - fftfreqs[k]) / (hz[m + 2] - hz[m + 1]);
      double v = std::fmin(lower, upper);
      if (v > 0) w[m * n_freq + k] = static_cast<float>(v * enorm);
    }
  }
  return w;
}

// lws framing (reference preprocessing/utils.py:89-107)
int num_frames(long length, int fsize, int fshift) {
  long pad = fsize - fshift;
  if (length % fshift == 0) return static_cast<int>((length + pad * 2 - fsize) / fshift + 1);
  return static_cast<int>((length + pad * 2 - fsize) / fshift + 2);
}

// one frame's mel extraction against a prebuilt basis (shared by the
// single-call entry, which caches a basis per thread, and the batch entry,
// which builds one basis for all workers)
int mel_one(const float* wav, long n, float* out, const MelParams& p,
            const std::vector<float>& basis) {
  int m = num_frames(n, p.fft_size, p.hop_size);
  int n_freq = p.fft_size / 2 + 1;
  long pad_l = p.fft_size - p.hop_size;

  std::vector<double> win(p.fft_size);
  for (int i = 0; i < p.fft_size; ++i)
    win[i] = std::sqrt(0.5 - 0.5 * std::cos(2.0 * kPi * i / p.fft_size));

  std::vector<double> re(p.fft_size), im(p.fft_size), mag(n_freq);
  const double min_level = std::exp(p.min_level_db / 20.0 * std::log(10.0));

  for (int f = 0; f < m; ++f) {
    long start = static_cast<long>(f) * p.hop_size - pad_l;
    for (int i = 0; i < p.fft_size; ++i) {
      long idx = start + i;
      double v = (idx >= 0 && idx < n) ? wav[idx] : 0.0;
      re[i] = v * win[i];
      im[i] = 0.0;
    }
    fft_inplace(re.data(), im.data(), p.fft_size);
    for (int k = 0; k < n_freq; ++k)
      mag[k] = std::sqrt(re[k] * re[k] + im[k] * im[k]);
    for (int mm = 0; mm < p.num_mels; ++mm) {
      double acc = 0.0;
      const float* row = &basis[static_cast<size_t>(mm) * n_freq];
      for (int k = 0; k < n_freq; ++k) acc += row[k] * mag[k];
      double db = 20.0 * std::log10(std::fmax(min_level, acc)) - p.ref_level_db;
      double norm = (db - p.min_level_db) / -p.min_level_db;
      out[static_cast<size_t>(mm) * m + f] =
          static_cast<float>(std::fmin(1.0, std::fmax(0.0, norm)));
    }
  }
  return m;
}

}  // namespace

extern "C" {

// Compute the mel spectrogram of a mono float waveform.
// out must hold num_mels * dvc_num_frames(n, 1024, 256) floats (row-major
// (num_mels, T) like the reference's (80, T)).
// Returns the number of frames, or -1 on error.
int dvc_melspectrogram(const float* wav, long n, float* out,
                       int sample_rate, int fft_size, int hop_size,
                       int num_mels, double fmin, double fmax,
                       double min_level_db, double ref_level_db) {
  if (!wav || !out || n <= 0) return -1;
  MelParams p;
  p.sample_rate = sample_rate;
  p.fft_size = fft_size;
  p.hop_size = hop_size;
  p.num_mels = num_mels;
  p.fmin = fmin;
  p.fmax = fmax;
  p.min_level_db = min_level_db;
  p.ref_level_db = ref_level_db;

  static thread_local std::vector<float> basis;
  static thread_local MelParams cached;
  if (basis.empty() || std::memcmp(&cached, &p, sizeof(p)) != 0) {
    basis = build_mel_basis(p);
    cached = p;
  }
  return mel_one(wav, n, out, p, basis);
}

int dvc_num_frames(long length, int fsize, int fshift) {
  return num_frames(length, fsize, fshift);
}

// Polyphase rational resampling with a windowed-sinc filter (parity with
// ops/audio.py resample_poly).  out must hold ceil(n * up / down) floats.
// Returns output length or -1.
long dvc_resample(const float* wav, long n, float* out, int orig_sr,
                  int target_sr) {
  if (orig_sr == target_sr) {
    std::memcpy(out, wav, sizeof(float) * n);
    return n;
  }
  long g = 1;
  {
    long a = orig_sr, b = target_sr;
    while (b) { long t = a % b; a = b; b = t; }
    g = a;
  }
  int up = static_cast<int>(target_sr / g), down = static_cast<int>(orig_sr / g);
  const int num_zeros = 16;
  const double rolloff = 0.945;
  double cutoff = rolloff * 0.5 / std::max(up, down);
  int half = static_cast<int>(std::ceil(num_zeros / (2 * cutoff)));
  int klen = 2 * half + 1;
  std::vector<double> kernel(klen);
  for (int i = 0; i < klen; ++i) {
    double x = 2 * cutoff * (i - half);
    double sinc = (x == 0.0) ? 1.0 : std::sin(kPi * x) / (kPi * x);
    double w = 0.5 - 0.5 * std::cos(2.0 * kPi * (i + 1) / (klen + 1));
    kernel[i] = 2 * cutoff * sinc * w * up;
  }
  long out_len = (n * up + down - 1) / down;
  int pad = klen / 2;
  for (long o = 0; o < out_len; ++o) {
    // output o corresponds to dilated-input position o*down; conv with pad
    long center = o * down - pad;
    double acc = 0.0;
    for (int k = 0; k < klen; ++k) {
      long dil_pos = center + k;  // position in the up-dilated signal
      if (dil_pos < 0) continue;
      if (dil_pos % up) continue;
      long src = dil_pos / up;
      if (src >= n) break;
      acc += kernel[klen - 1 - k] * wav[src];
    }
    out[o] = static_cast<float>(acc);
  }
  return out_len;
}

// Energy VAD per-window mask (parity with ops/audio.py energy_vad_mask
// detector; smoothing/dilation stay host-side in Python).  Returns number of
// windows; mask entries are 0/1.
long dvc_energy_vad(const float* wav, long n, uint8_t* mask, int sample_rate,
                    int window_ms, double threshold_db) {
  int spw = window_ms * sample_rate / 1000;
  long windows = n / spw;
  for (long w = 0; w < windows; ++w) {
    double acc = 0.0;
    for (int i = 0; i < spw; ++i) {
      double v = wav[w * spw + i];
      acc += v * v;
    }
    double db = 10.0 * std::log10(acc / spw + 1e-12);
    mask[w] = db > threshold_db ? 1 : 0;
  }
  return windows;
}

// Exact DTW over a dense (n, m) distance matrix: accumulate and backtrack
// the optimal path (role of the Python loop in eval/mcd.py:dtw_path, which
// holds the GIL for O(N*M) interpreter steps).  px/py must hold n + m
// entries; returns the path length (start-to-end order), or -1 on error.
// Tie-breaking matches the Python implementation: diagonal, then up, then
// left.
long dvc_dtw_path(const double* dist, long n, long m, int* px, int* py) {
  if (!dist || !px || !py || n <= 0 || m <= 0) return -1;
  const long w = m + 1;
  std::vector<double> acc(static_cast<size_t>(n + 1) * w, HUGE_VAL);
  acc[0] = 0.0;
  for (long i = 1; i <= n; ++i) {
    const double* drow = dist + (i - 1) * m;
    double* row = acc.data() + i * w;
    const double* prev = acc.data() + (i - 1) * w;
    for (long j = 1; j <= m; ++j) {
      double best = prev[j];
      if (row[j - 1] < best) best = row[j - 1];
      if (prev[j - 1] < best) best = prev[j - 1];
      row[j] = drow[j - 1] + best;
    }
  }
  std::vector<int> rx, ry;
  rx.reserve(n + m);
  ry.reserve(n + m);
  long i = n, j = m;
  while (i > 0 || j > 0) {
    rx.push_back(static_cast<int>(i - 1));
    ry.push_back(static_cast<int>(j - 1));
    double best = HUGE_VAL;
    long bi = i, bj = j;
    if (i > 0 && j > 0) {
      best = acc[(i - 1) * w + (j - 1)];
      bi = i - 1;
      bj = j - 1;
    }
    if (i > 0 && acc[(i - 1) * w + j] < best) {
      best = acc[(i - 1) * w + j];
      bi = i - 1;
      bj = j;
    }
    if (j > 0 && acc[i * w + (j - 1)] < best) {
      bi = i;
      bj = j - 1;
    }
    i = bi;
    j = bj;
    if (i == 0 && j == 0) break;
  }
  long len = static_cast<long>(rx.size());
  for (long k = 0; k < len; ++k) {
    px[k] = rx[len - 1 - k];
    py[k] = ry[len - 1 - k];
  }
  return len;
}

// Batched mel extraction with a thread pool: n_files wavs (concatenated in
// `wavs`, lengths in `lengths`), outputs written at out_offsets into `out`.
// frames_out[i] receives the frame count of file i.
int dvc_melspectrogram_batch(const float* wavs, const long* offsets,
                             const long* lengths, int n_files, float* out,
                             const long* out_offsets, int* frames_out,
                             int n_threads, int sample_rate, int fft_size,
                             int hop_size, int num_mels, double fmin,
                             double fmax, double min_level_db,
                             double ref_level_db) {
  MelParams p;
  p.sample_rate = sample_rate;
  p.fft_size = fft_size;
  p.hop_size = hop_size;
  p.num_mels = num_mels;
  p.fmin = fmin;
  p.fmax = fmax;
  p.min_level_db = min_level_db;
  p.ref_level_db = ref_level_db;
  // one basis for every worker (read-only), built once per call
  const std::vector<float> basis = build_mel_basis(p);
  std::atomic_int err{0};
  dvc::parallel_for(n_files, n_threads, [&](long i) {
    if (!wavs || !out || lengths[i] <= 0) {
      err.store(1);
      frames_out[i] = -1;
      return;
    }
    frames_out[i] = mel_one(wavs + offsets[i], lengths[i],
                            out + out_offsets[i], p, basis);
  });
  return err.load() ? -1 : 0;
}

}  // extern "C"
