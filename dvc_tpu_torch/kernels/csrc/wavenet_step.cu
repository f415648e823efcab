// WaveNet vocoder: autoregressive mixture-of-logistics generation on Hopper.
//
// Replaces the TPU kernels of dvc_tpu/kernels/wavenet_step.py:
//   * K1+K2, the resident pl.pallas_call built by `_resident_call`
//     (:387-429, call at :415), whose body is `_make_kernel_resident`
//     (:286-384), with the in-kernel sampler `_mol_sample` /
//     `_uniform_from_bits` (:241-283);
//   * K3, the streamed pl.pallas_call built by `_streamed_call` (:705-787,
//     call at :771), whose body is `_make_kernel` (:464-592).  Its fused
//     w_cat/w_so layout and `layers_per_block` are TPU grid shapes of K1's
//     function (this kernel's output-major pack already is the fused
//     layout); its int8 weight streaming (quantized=True) is a function of
//     its own and is the <int8_t, bf16, F> instantiation below.
// Same function, same dtype behaviour:
//   * float32 / bf16 weights: activations are cast to the weight dtype
//     before every tap, cond, skip, out and final1 product; the ring stores
//     each layer input h in the weight dtype;
//   * int8 weights (per-(layer, segment, output column) float32 scales):
//     activations are cast to bf16 before every layer product and the ring
//     holds bf16 (`cd` :512, ring :765); each segment's product (tap
//     x_{t-2d}, tap x_{t-d}, tap h, cond; skip; out) is scaled after the dot
//     (`mm` :514-519); final1 keeps the weight dtype the caller asked for
//     (:231) and its input is cast to it;
//   * products accumulate in float32; w_first, the biases and final2 stay
//     float32; the residual and skip chains are float32, legacy skip
//     scaling (x sqrt(1/2)) from the second layer on.
//
// What bounds it on an H100.  Every sample step reads every weight:
// 24 x (786,432 + 40,960 + 65,536 + 131,072) = 24.58 M parameters, 49.2 MB
// in bf16 (+0.16 MB for the head).  Streamed from device memory at 3.35 TB/s
// that is 14.7 us per sample step for the whole batch (29.3 us with float32
// weights), about 4.2x realtime at 16 kHz for one stream.  int8 halves it:
// 24.6 MB of codes + 0.27 MB of scales + the head, about 7.5 us per step,
// and 24.6 MB would fit the 50 MB L2.  The arithmetic is 49.2 MFLOP per
// batch row per step, so the loop stays memory-bound up to a batch of about
// 295.  The TPU kept all 49 MB resident in its on-chip VMEM; an H100 has
// 132 x 227 KB = 30 MB of shared memory and a 50 MB L2, so that design does
// not carry over one to one.
//
// This first design is simple and right, not fast.  The host function loops
// over samples in C and enqueues, per sample, two kernels per layer and two
// for the head (T x (2L + 2) launches, no Python in the loop):
//   layer_in   one block per gate-column pair (j, j + G/2), so one block owns
//              both halves of tanh(a) * sigmoid(g); it stages the inputs
//              [x_{t-2d} | x_{t-d} | h | c_t] of up to kRowTile batch rows in
//              shared memory, cast to the activation dtype, and its warps
//              split the two weight rows between them;
//   layer_out  one warp per skip/out column: skip accumulation, the residual
//              h_next = (res + h) * sqrt(1/2) into the other half of a
//              ping-pong h buffer, and h (the layer input) written into the
//              ring slot that held x_{t-2d};
//   final1     one warp per final1 column: relu -> final1 -> relu;
//   head       one block per batch row: final2 -> MoL sample (Philox4x32-10
//              keyed by the seed, counter (draw, t, row)), and the next
//              sample's first_conv.
// One template over (layer weight W, activation and ring A, final1 weight F)
// covers every pack: <float, float, float>, <bf16, bf16, bf16>, and for int8
// <int8, bf16, float> or <int8, bf16, bf16>.
// Weights are packed output-major ((L, G, KI) and (L, S + R, G2p)), so the
// threads reading one output column read one contiguous row, 16 bytes a
// thread per load, all of a row's loads issued before the first is used; the
// TPU's (in, out) layout would make every column read strided.  Every weight
// row is whole 16-byte vectors: float32 / bf16 packs zero-pad KI = 3R + C to
// a multiple of 8 and need G/2 and S to be multiples of 8.  An int8 pack
// zero-pads each w_in segment to Rs (taps) or a multiple of 16 (cond) and
// each w_so row to G2p, multiples of 16 codes, so that no 16-code vector
// straddles two segments: each vector's products are summed, then multiplied
// by its segment's scale (exact int8 -> float, exact bf16 x int8 products;
// only the float32 sum order differs from the plain version).
//
// Races the split avoids: layer_in reads ring slot off + (t mod 2d) as
// x_{t-2d} before layer_out overwrites it with h (separate launches on one
// stream), and h is never updated in place while other warps copy it into
// the ring (ping-pong buffer).  Ring taps follow the TPU kernel (:340-342):
// tap_2d = off + (t mod 2d), tap_d = off + ((t mod 2d) + d) mod 2d.
//
// The whole batch runs in one call: there is no VMEM budget to split on, so
// the TPU path's seed + i sub-batch split (wavenet_step.py:651-663) does not
// apply.  Every launch is followed by cudaGetLastError(); the C entry points
// return the first error code and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kRowTile = 8;      // batch rows per pass through the weights
constexpr int kWarpsIn = 4;      // warps sharing one gate-column pair's dots
constexpr int kWarpsOut = 4;     // warps (output columns) per layer_out/final1 block
constexpr int kHeadThreads = 1024;
constexpr int kUnroll = 8;       // 16-byte weight loads in flight per lane per row
constexpr int kMaxSmem = 232448; // H100: 227 KB of dynamic shared memory a block
constexpr int kSegs = 4;         // int8 w_in row segments: x_{t-2d}, x_{t-d}, h, cond
constexpr float kSqrtHalf = 0.70710678118654752440f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& r, float* w) {
    w[0] = __uint_as_float(r.x);
    w[1] = __uint_as_float(r.y);
    w[2] = __uint_as_float(r.z);
    w[3] = __uint_as_float(r.w);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  // round to nearest even, as jnp .astype(bfloat16) and torch .to(bfloat16)
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
  static __device__ __forceinline__ void unpack(const uint4& r, float* w) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// int8 codes: weights only (activations never take this type), each
// vector's products scaled after their sum
template <>
struct Cvt<int8_t> {
  static constexpr int kVec = 16;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void unpack(const uint4& r, float* w) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k)  // byte k of word i is code 4i + k
        w[4 * i + k] = (float)(int)(int8_t)(uint8_t)(u[i] >> (8 * k));
    }
  }
};

// float -> activation dtype -> float: the cast an activation takes before a product
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Cvt<T>::to(Cvt<T>::from(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scales of NR int8 weight rows: vector v of row r lies in segment
// min(v / seg_vecs, kSegs - 1) and is scaled by s[r][segment].
template <int NR>
struct RowScales {
  float s[NR][kSegs];
  int seg_vecs;
  __device__ __forceinline__ float of(int r, int v) const {
    const int seg = v / seg_vecs;
    return seg == 0 ? s[r][0] : seg == 1 ? s[r][1] : seg == 2 ? s[r][2] : s[r][3];
  }
};

// Per-thread partial dot products of NR weight rows w[r] (n elements each,
// whole 16-byte vectors) with nb <= kRowTile activation rows xs (n floats
// apart in shared memory): acc[r][bb] += this thread's share, the vectors
// first, first + stride, ...  Each thread issues the loads of kUnroll
// vectors per row before it uses any, so one round trip to memory covers a
// row of up to stride * kUnroll vectors.  int8 rows (sc given) sum each
// vector's products and add them times the vector's segment scale.  The
// caller sums the shares.
template <typename W, int NR>
__device__ __forceinline__ void lane_dots(const W* const (&w)[NR], const float* xs, int n,
                                          int nb, int first, int stride,
                                          float (&acc)[NR][kRowTile],
                                          const RowScales<NR>* sc = nullptr) {
  constexpr int V = Cvt<W>::kVec;
  const int nv = n / V;
  for (int v0 = first; v0 < nv; v0 += stride * kUnroll) {
    uint4 raw[NR][kUnroll];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + stride * u;
        raw[r][u] = v < nv ? __ldg(reinterpret_cast<const uint4*>(w[r]) + v)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + stride * u;
      if (v < nv) {
        float wv[NR][V];
#pragma unroll
        for (int r = 0; r < NR; ++r) Cvt<W>::unpack(raw[r][u], wv[r]);
        float scale[NR];
        if constexpr (Cvt<W>::kScaled) {
#pragma unroll
          for (int r = 0; r < NR; ++r) scale[r] = sc->of(r, v);
        }
#pragma unroll
        for (int bb = 0; bb < kRowTile; ++bb) {
          if (bb < nb) {
            const float* x = xs + bb * n + v * V;
            if constexpr (Cvt<W>::kScaled) {
              float p[NR] = {};
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float xe = x[e];
#pragma unroll
                for (int r = 0; r < NR; ++r) p[r] = fmaf(wv[r][e], xe, p[r]);
              }
#pragma unroll
              for (int r = 0; r < NR; ++r) acc[r][bb] = fmaf(scale[r], p[r], acc[r][bb]);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float xe = x[e];
#pragma unroll
                for (int r = 0; r < NR; ++r) acc[r][bb] = fmaf(wv[r][e], xe, acc[r][bb]);
              }
            }
          }
        }
      }
    }
  }
}

// ---- counter-based random numbers ---------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 24 random bits -> (0, 1), clipped to [1e-5, 1 - 1e-5] as the TPU kernel's
// _uniform_from_bits does
__device__ __forceinline__ float uniform01(uint32_t bits) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-8f + 2.98023223876953125e-8f;
  return fminf(fmaxf(u, 1e-5f), 1.0f - 1e-5f);
}

__device__ __forceinline__ uint32_t word_of(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// One MoL draw from y = [logits | means | log_scales] (3 * nr_mix floats):
// Gumbel-max mixture choice, logistic inverse CDF with the log scale clamped
// at log_scale_min, clipped to [-1, 1].  Deterministic mode takes the argmax
// mixture's mean (no noise) and still clips.
__device__ float mol_sample(const float* y, int nr_mix, float log_scale_min, int deterministic,
                            uint2 key, uint32_t t, uint32_t row) {
  int sel = 0;
  float best = -INFINITY;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < nr_mix; ++i) {
    float g = 0.f;
    if (!deterministic) {
      if ((i & 3) == 0) r = philox4x32_10(make_uint4((uint32_t)(i >> 2), t, row, 0u), key);
      g = -logf(-logf(uniform01(word_of(r, i & 3))));
    }
    const float v = y[i] + g;
    if (v > best) {  // first maximum wins, as argmax
      best = v;
      sel = i;
    }
  }
  const float mean = y[nr_mix + sel];
  float x = mean;
  if (!deterministic) {
    const float log_s = fmaxf(y[2 * nr_mix + sel], log_scale_min);
    const float u = uniform01(philox4x32_10(make_uint4(0u, t, row, 1u), key).x);
    x = mean + expf(log_s) * (logf(u) - log1pf(-u));
  }
  return fminf(fmaxf(x, -1.f), 1.f);
}

// ---- per-sample kernels ---------------------------------------------------

template <typename W, typename A>
__global__ void __launch_bounds__(kWarpsIn * 32)
layer_in_kernel(const W* __restrict__ w_in,      // (G, KIp) this layer
                const float* __restrict__ s_in,  // (kSegs, G) this layer; int8 only
                const float* __restrict__ b_in,  // (G,)
                const A* __restrict__ ring,      // (slots, B, R)
                int slot_2d, int slot_d,
                const float* __restrict__ h,     // (B, R) layer input
                const float* __restrict__ cond,  // row 0 of c_t; rows cond_stride apart
                long long cond_stride,
                float* __restrict__ gated,       // (B, G2)
                int B, int R, int Rs, int C, int KIp, int G2) {
  extern __shared__ float xs[];  // (kRowTile, KIp): [x_{t-2d} | x_{t-d} | h | c_t | 0]
  __shared__ float part[kWarpsIn][2][kRowTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x;      // gate-column pair (j, j + G2)
  const W* const rows[2] = {w_in + (size_t)j * KIp, w_in + (size_t)(j + G2) * KIp};
  RowScales<2> sc;
  if constexpr (Cvt<W>::kScaled) {
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      sc.s[0][s] = s_in[(size_t)s * 2 * G2 + j];
      sc.s[1][s] = s_in[(size_t)s * 2 * G2 + j + G2];
    }
    sc.seg_vecs = Rs / Cvt<W>::kVec;
  }
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();  // the previous tile's readers are done
    for (int bb = 0; bb < nb; ++bb) {
      const int b = b0 + bb;
      const A* x2 = ring + ((size_t)slot_2d * B + b) * R;
      const A* x1 = ring + ((size_t)slot_d * B + b) * R;
      const float* hb = h + (size_t)b * R;
      const float* cb = cond + (size_t)b * cond_stride;
      float* row = xs + bb * KIp;
      for (int k = threadIdx.x; k < Rs; k += blockDim.x) {  // Rs > R: int8 padding
        const bool in = k < R;
        row[k] = in ? Cvt<A>::to(x2[k]) : 0.f;
        row[Rs + k] = in ? Cvt<A>::to(x1[k]) : 0.f;
        row[2 * Rs + k] = in ? round_to<A>(hb[k]) : 0.f;
      }
      for (int k = 3 * Rs + threadIdx.x; k < KIp; k += blockDim.x)
        row[k] = k < 3 * Rs + C ? round_to<A>(cb[k - 3 * Rs]) : 0.f;
    }
    __syncthreads();
    float acc[2][kRowTile] = {};
    lane_dots<W, 2>(rows, xs, KIp, nb, threadIdx.x, blockDim.x, acc, &sc);
#pragma unroll
    for (int bb = 0; bb < kRowTile; ++bb) {
      const float sa = warp_sum(acc[0][bb]);
      const float sg = warp_sum(acc[1][bb]);
      if (lane == 0) {
        part[warp][0][bb] = sa;
        part[warp][1][bb] = sg;
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      const int bb = threadIdx.x;
      float pa = b_in[j], pg = b_in[j + G2];
#pragma unroll
      for (int w = 0; w < kWarpsIn; ++w) {
        pa += part[w][0][bb];
        pg += part[w][1][bb];
      }
      gated[(size_t)(b0 + bb) * G2 + j] = tanhf(pa) * (1.f / (1.f + expf(-pg)));
    }
  }
}

template <typename W, typename A>
__global__ void __launch_bounds__(kWarpsOut * 32)
layer_out_kernel(const W* __restrict__ w_so,       // (S + R, G2p) this layer
                 const float* __restrict__ s_so,   // (S + R,) this layer; int8 only
                 const float* __restrict__ b_so,   // (S + R,)
                 const float* __restrict__ gated,  // (B, G2)
                 const float* __restrict__ h_in,   // (B, R) layer input
                 float* __restrict__ h_out,        // (B, R) next layer's input
                 float* __restrict__ skip,         // (B, S)
                 A* __restrict__ ring, int slot_w,
                 int B, int R, int S, int G2, int G2p, int first_layer, float skip_scale) {
  extern __shared__ float gs[];  // (kRowTile, G2p)
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsOut + (threadIdx.x >> 5);
  RowScales<1> sc;
  if constexpr (Cvt<W>::kScaled) {
    sc.s[0][0] = o < S + R ? s_so[o] : 0.f;
    sc.seg_vecs = INT_MAX;  // one segment: the whole row
  }
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * G2p; idx += blockDim.x) {  // G2 -> G2p: zeros
      const int bb = idx / G2p, i = idx - bb * G2p;
      gs[idx] = i < G2 ? round_to<A>(gated[(size_t)(b0 + bb) * G2 + i]) : 0.f;
    }
    __syncthreads();
    if (o < S + R) {
      const W* const rows[1] = {w_so + (size_t)o * G2p};
      float acc[1][kRowTile] = {};
      lane_dots<W, 1>(rows, gs, G2p, nb, threadIdx.x & 31, 32, acc, &sc);
#pragma unroll
      for (int bb = 0; bb < kRowTile; ++bb) {
        const float v = warp_sum(acc[0][bb]) + b_so[o];
        if (lane == 0 && bb < nb) {
          const int b = b0 + bb;
          if (o < S) {
            float* sp = skip + (size_t)b * S + o;
            *sp = first_layer ? v : (*sp + v) * skip_scale;
          } else {
            const int r = o - S;
            const float hi = h_in[(size_t)b * R + r];
            h_out[(size_t)b * R + r] = (v + hi) * kSqrtHalf;
            ring[((size_t)slot_w * B + b) * R + r] = Cvt<A>::from(hi);
          }
        }
      }
    }
  }
}

template <typename F>
__global__ void __launch_bounds__(kWarpsOut * 32)
final1_kernel(const float* __restrict__ skip,                           // (B, S)
              const F* __restrict__ w_f1, const float* __restrict__ b_f1,  // (S, S), (S,)
              float* __restrict__ fin,                                  // (B, S)
              int B, int S) {
  extern __shared__ float os[];  // (kRowTile, S)
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsOut + (threadIdx.x >> 5);
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * S; idx += blockDim.x)
      os[idx] = round_to<F>(fmaxf(skip[(size_t)b0 * S + idx], 0.f));
    __syncthreads();
    if (o < S) {
      const F* const rows[1] = {w_f1 + (size_t)o * S};
      float acc[1][kRowTile] = {};
      lane_dots<F, 1>(rows, os, S, nb, threadIdx.x & 31, 32, acc);
#pragma unroll
      for (int bb = 0; bb < kRowTile; ++bb) {
        const float v = warp_sum(acc[0][bb]) + b_f1[o];
        if (lane == 0 && bb < nb) fin[(size_t)(b0 + bb) * S + o] = fmaxf(v, 0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(kHeadThreads)
head_kernel(const float* __restrict__ fin,                              // (B, S)
            const float* __restrict__ w_f2, const float* __restrict__ b_f2,  // (K, S), (K,)
            const float* __restrict__ w_first, const float* __restrict__ b_first,  // (R,)
            float* __restrict__ h_next,  // (B, R): first_conv of the new sample
            float* __restrict__ out,     // (B, T_total)
            int S, int K, int R, int T_total, int t, uint2 key, int deterministic,
            float log_scale_min) {
  extern __shared__ float sm[];  // o (S) | y (K) | x (1)
  float* o = sm;
  float* y = o + S;
  float* xs = y + K;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int k = threadIdx.x; k < S; k += blockDim.x) o[k] = fin[(size_t)b * S + k];
  __syncthreads();
  for (int c = warp; c < K; c += nw) {
    const float* const rows[1] = {w_f2 + (size_t)c * S};
    float acc[1][kRowTile] = {};
    lane_dots<float, 1>(rows, o, S, 1, lane, 32, acc);
    const float v = warp_sum(acc[0][0]);
    if (lane == 0) y[c] = v + b_f2[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float x = mol_sample(y, K / 3, log_scale_min, deterministic, key, (uint32_t)t,
                               (uint32_t)b);
    out[(size_t)b * T_total + t] = x;
    xs[0] = x;
  }
  __syncthreads();
  const float x = xs[0];
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    h_next[(size_t)b * R + r] = x * w_first[r] + b_first[r];
}

// h for sample 0: first_conv of x_{-1} = 0
__global__ void init_h_kernel(const float* __restrict__ w_first,
                              const float* __restrict__ b_first, float* __restrict__ h,
                              int n, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) h[i] = 0.f * w_first[i % R] + b_first[i % R];
}

__global__ void mol_sample_kernel(const float* __restrict__ y, long long row_stride, int N,
                                  int K, uint2 key, int deterministic, float log_scale_min,
                                  float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N)
    out[n] = mol_sample(y + (size_t)n * row_stride, K / 3, log_scale_min, deterministic, key,
                        0u, (uint32_t)n);
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Shapes: KIp is w_in's padded row length, Rs its tap segment length, G2p
// w_so's padded row length (Rs = R, G2p = G/2 for float32 / bf16 packs).
struct Dims {
  int B, T, L, R, Rs, G, G2p, S, C, KIp, K;
};

// Device pointers of the packed WaveNet and the caller's scratch; s_in and
// s_so are the int8 scales (null for float32 / bf16 packs).
struct Bufs {
  const void *w_in, *s_in, *b_in, *w_so, *s_so, *b_so, *w_first, *b_first, *w_f1, *b_f1,
      *w_f2, *b_f2, *cond;
  void *ring, *h, *skip, *gated, *fin, *out;
};

template <typename W, typename A, typename F>
int generate(const Dims& d, const int* dil, int legacy, float log_scale_min, uint2 key,
             int deterministic, const Bufs& p, cudaStream_t stream) {
  const int B = d.B, L = d.L, R = d.R, Rs = d.Rs, G = d.G, G2 = d.G / 2, G2p = d.G2p;
  const int S = d.S, C = d.C, KIp = d.KIp, K = d.K, T_total = d.T;
  const W* w_in = static_cast<const W*>(p.w_in);
  const W* w_so = static_cast<const W*>(p.w_so);
  const float* s_in = static_cast<const float*>(p.s_in);
  const float* s_so = static_cast<const float*>(p.s_so);
  const float* b_in = static_cast<const float*>(p.b_in);
  const float* b_so = static_cast<const float*>(p.b_so);
  const float* w_first = static_cast<const float*>(p.w_first);
  const float* b_first = static_cast<const float*>(p.b_first);
  const F* w_f1 = static_cast<const F*>(p.w_f1);
  const float* b_f1 = static_cast<const float*>(p.b_f1);
  const float* w_f2 = static_cast<const float*>(p.w_f2);
  const float* b_f2 = static_cast<const float*>(p.b_f2);
  const float* cond = static_cast<const float*>(p.cond);
  A* ring = static_cast<A*>(p.ring);
  float* h = static_cast<float*>(p.h);
  float* skip = static_cast<float*>(p.skip);
  float* gated = static_cast<float*>(p.gated);
  float* fin = static_cast<float*>(p.fin);
  float* out = static_cast<float*>(p.out);

  std::vector<int> offs(L);
  int slots = 0;
  for (int l = 0; l < L; ++l) {
    offs[l] = slots;
    slots += 2 * dil[l];
  }
  const int rows = B < kRowTile ? B : kRowTile;
  const int smem_in = rows * KIp * (int)sizeof(float);
  const int smem_out = rows * G2p * (int)sizeof(float);
  const int smem_f1 = rows * S * (int)sizeof(float);
  const int smem_head = (S + K + 1) * (int)sizeof(float);
  if (smem_in > kMaxSmem || smem_out > kMaxSmem || smem_f1 > kMaxSmem || smem_head > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  DVC_CHECK(cudaFuncSetAttribute(layer_in_kernel<W, A>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_in));
  DVC_CHECK(cudaFuncSetAttribute(layer_out_kernel<W, A>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_out));
  DVC_CHECK(cudaFuncSetAttribute(final1_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_f1));

  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * B * R * sizeof(A), stream));
  init_h_kernel<<<(B * R + 255) / 256, 256, 0, stream>>>(w_first, b_first, h, B * R, R);
  DVC_CHECK(cudaGetLastError());

  const float skip_scale = legacy ? kSqrtHalf : 1.f;
  const size_t hsz = (size_t)B * R;
  const int grid_in = G2;
  const int grid_out = (S + R + kWarpsOut - 1) / kWarpsOut;
  const int grid_f1 = (S + kWarpsOut - 1) / kWarpsOut;
  const long long cond_stride = (long long)T_total * C;  // cond is (B, T, C)
  for (int t = 0; t < T_total; ++t) {
    for (int l = 0; l < L; ++l) {
      const int dl = dil[l], two_d = 2 * dl;
      const int wp = t % two_d;
      const int slot_2d = offs[l] + wp;
      const int slot_d = offs[l] + (wp + dl) % two_d;
      const float* h_in = h + (size_t)(l & 1) * hsz;  // layer 0 reads buffer 0
      float* h_out = h + (size_t)((l + 1) & 1) * hsz;
      layer_in_kernel<W, A><<<grid_in, kWarpsIn * 32, smem_in, stream>>>(
          w_in + (size_t)l * G * KIp, s_in ? s_in + (size_t)l * kSegs * G : nullptr,
          b_in + (size_t)l * G, ring, slot_2d, slot_d, h_in, cond + (size_t)t * C, cond_stride,
          gated, B, R, Rs, C, KIp, G2);
      DVC_CHECK(cudaGetLastError());
      layer_out_kernel<W, A><<<grid_out, kWarpsOut * 32, smem_out, stream>>>(
          w_so + (size_t)l * (S + R) * G2p, s_so ? s_so + (size_t)l * (S + R) : nullptr,
          b_so + (size_t)l * (S + R), gated, h_in, h_out, skip, ring, slot_2d, B, R, S, G2, G2p,
          l == 0, skip_scale);
      DVC_CHECK(cudaGetLastError());
    }
    final1_kernel<F><<<grid_f1, kWarpsOut * 32, smem_f1, stream>>>(skip, w_f1, b_f1, fin, B, S);
    DVC_CHECK(cudaGetLastError());
    // the last layer's residual output is unused, so the head may write the
    // next sample's first_conv into buffer 0 whichever buffer that was
    head_kernel<<<B, kHeadThreads, smem_head, stream>>>(fin, w_f2, b_f2, w_first, b_first, h,
                                                        out, S, K, R, T_total, t, key,
                                                        deterministic, log_scale_min);
    DVC_CHECK(cudaGetLastError());
  }
  return 0;
}

uint2 key_of(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
}

}  // namespace

extern "C" {

// Weight type codes: 0 = float32, 1 = bfloat16, 2 = int8 (layer weights
// only, with float32 scales s_in (L, 4, G) and s_so (L, S + R); activations
// and ring in bf16).  w_dtype / f1_dtype pairs: (0, 0), (1, 1), (2, 0), (2, 1).
// Pointers are 16-byte aligned device pointers except dil (host, L ints).
// Returns 0 or the first cudaError_t.
int dvc_wavenet_generate(int w_dtype, int f1_dtype, int B, int T, int L, int R, int Rs, int G,
                         int G2p, int S, int C, int KIp, int K, const int* dil, int legacy,
                         float log_scale_min, unsigned long long seed, int deterministic,
                         const void* w_in, const void* s_in, const void* b_in, const void* w_so,
                         const void* s_so, const void* b_so, const void* w_first,
                         const void* b_first, const void* w_f1, const void* b_f1,
                         const void* w_f2, const void* b_f2, const void* cond, void* ring,
                         void* h, void* skip, void* gated, void* fin, void* out, void* stream) {
  const int vec = w_dtype == 0 ? 4 : w_dtype == 1 ? 8 : 16;  // weights per 16 bytes
  const bool int8 = w_dtype == 2;
  if (f1_dtype < 0 || f1_dtype > 1 || B <= 0 || T < 0 || L <= 0 || K <= 0 || K % 3 != 0 ||
      G % 2 != 0 || S % 8 != 0 ||
      KIp % vec != 0 || G2p % vec != 0 || G2p < G / 2 || Rs < R || KIp < 3 * Rs + C ||
      (int8 && (Rs % vec != 0 || !s_in || !s_so)))
    return (int)cudaErrorInvalidValue;
  const Dims d{B, T, L, R, Rs, G, G2p, S, C, KIp, K};
  const Bufs p{w_in, s_in, b_in, w_so, s_so, b_so, w_first, b_first, w_f1, b_f1, w_f2, b_f2,
               cond, ring, h, skip, gated, fin, out};
  const uint2 key = key_of(seed);
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  switch (w_dtype * 2 + f1_dtype) {  // f1_dtype is 0 or 1
    case 0:  // (0, 0)
      return generate<float, float, float>(d, dil, legacy, log_scale_min, key, deterministic,
                                           p, st);
    case 3:  // (1, 1)
      return generate<bf16, bf16, bf16>(d, dil, legacy, log_scale_min, key, deterministic, p,
                                        st);
    case 4:  // (2, 0)
      return generate<int8_t, bf16, float>(d, dil, legacy, log_scale_min, key, deterministic,
                                           p, st);
    case 5:  // (2, 1)
      return generate<int8_t, bf16, bf16>(d, dil, legacy, log_scale_min, key, deterministic, p,
                                          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One MoL draw per row of y (N rows of K floats, row_stride floats apart;
// 0 repeats one row).  Row n uses the Philox counter of sample 0, batch row n.
int dvc_mol_sample(const void* y, long long row_stride, int N, int K, unsigned long long seed,
                   int deterministic, float log_scale_min, void* out, void* stream) {
  if (N < 0 || K <= 0 || K % 3 != 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  mol_sample_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)y, row_stride, N, K, key_of(seed), deterministic, log_scale_min,
      (float*)out);
  return (int)cudaGetLastError();
}

const char* dvc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
