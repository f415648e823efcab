// dvc_common — helpers shared by the native engine translation units
// (dvc_dsp.cpp, dvc_world.cpp): radix-2 FFT, window functions, and a
// fork-join thread pool.  Header-only so each .so still builds from a
// single source file with no link-time coupling.
#ifndef DVC_COMMON_H_
#define DVC_COMMON_H_

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

namespace dvc {

constexpr double kPi = 3.14159265358979323846;

// Cached twiddle factors for one butterfly stage.  The values are computed
// by the SAME complex recurrence the original in-loop code used (not by
// per-index cos/sin), so FFT results are bit-identical to the uncached
// implementation; hoisting them out of the butterfly removes the
// loop-carried dependency and lets the compiler vectorize the stage.
struct TwiddleStage {
  std::vector<double> cr, ci;
};

inline const TwiddleStage& twiddle_stage(int len, bool inverse) {
  // index by log2(len); power-of-two lengths only (as the FFT requires)
  static std::atomic<const TwiddleStage*> cache[2][32] = {};
  static std::mutex build_mu;
  int lg = 0;
  while ((1 << lg) < len) ++lg;
  std::atomic<const TwiddleStage*>& slot = cache[inverse ? 1 : 0][lg];
  const TwiddleStage* hit = slot.load(std::memory_order_acquire);
  if (hit) return *hit;
  std::lock_guard<std::mutex> lock(build_mu);
  hit = slot.load(std::memory_order_acquire);
  if (hit) return *hit;
  auto* st = new TwiddleStage;
  st->cr.resize(len / 2);
  st->ci.resize(len / 2);
  double sign = inverse ? 2.0 : -2.0;
  double ang = sign * kPi / len;
  double wr = std::cos(ang), wi = std::sin(ang);
  double cr = 1.0, ci = 0.0;
  for (int k = 0; k < len / 2; ++k) {
    st->cr[k] = cr;
    st->ci[k] = ci;
    double ncr = cr * wr - ci * wi;
    ci = cr * wi + ci * wr;
    cr = ncr;
  }
  slot.store(st, std::memory_order_release);  // leaked by design: process-
  return *st;                                 // lifetime cache, ~n entries
}

// iterative radix-2 Cooley-Tukey, complex in-place; n must be a power of two.
inline void fft_inplace(double* re, double* im, int n, bool inverse = false) {
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    const TwiddleStage& tw = twiddle_stage(len, inverse);
    const double* twr = tw.cr.data();
    const double* twi = tw.ci.data();
    for (int i = 0; i < n; i += len) {
      double* r0 = re + i;
      double* i0 = im + i;
      double* r1 = re + i + len / 2;
      double* i1 = im + i + len / 2;
      for (int k = 0; k < len / 2; ++k) {
        double cr = twr[k], ci = twi[k];
        double ur = r0[k], ui = i0[k];
        double vr = r1[k] * cr - i1[k] * ci;
        double vi = r1[k] * ci + i1[k] * cr;
        r0[k] = ur + vr;
        i0[k] = ui + vi;
        r1[k] = ur - vr;
        i1[k] = ui - vi;
      }
    }
  }
  if (inverse)
    for (int i = 0; i < n; ++i) {
      re[i] /= n;
      im[i] /= n;
    }
}

inline int next_pow2(long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// window functions over x in [0, 1]
inline double nuttall(double x) {
  return 0.355768 - 0.487396 * std::cos(2.0 * kPi * x) +
         0.144232 * std::cos(4.0 * kPi * x) -
         0.012604 * std::cos(6.0 * kPi * x);
}

inline double blackman(double x) {
  return 0.42 - 0.5 * std::cos(2.0 * kPi * x) + 0.08 * std::cos(4.0 * kPi * x);
}

// Worker count: DVC_WORLD_THREADS overrides the hardware count.
inline int num_threads() {
  if (const char* env = std::getenv("DVC_WORLD_THREADS")) {
    int n = std::atoi(env);
    if (n > 0) return n;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 1;
}

// Fork-join over [0, n): each index is claimed by an atomic counter, so
// callers guaranteeing disjoint writes per index get identical results at
// any worker count.  Never spawns more workers than items.
template <typename Fn>
inline void parallel_for(long n, int workers, const Fn& fn) {
  workers = static_cast<int>(std::min<long>(workers, n));
  if (workers <= 1) {
    for (long i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<long> next(0);
  auto run = [&]() {
    for (long i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  pool.reserve(workers - 1);
  for (int w = 1; w < workers; ++w) pool.emplace_back(run);
  run();
  for (auto& t : pool) t.join();
}

template <typename Fn>
inline void parallel_for(long n, const Fn& fn) {
  parallel_for(n, num_threads(), fn);
}

}  // namespace dvc

#endif  // DVC_COMMON_H_
