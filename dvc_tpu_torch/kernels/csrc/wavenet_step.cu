// WaveNet vocoder: autoregressive mixture-of-logistics generation on Hopper.
//
// Replaces the TPU kernel of dvc_tpu/kernels/wavenet_step.py: the resident
// pl.pallas_call built by `_resident_call` (:387-429, call at :415), whose
// body is `_make_kernel_resident` (:286-384), with the in-kernel sampler
// `_mol_sample` / `_uniform_from_bits` (:241-283).  Same function, same
// dtype behaviour:
//   * activations are cast to the weight dtype before every tap, cond, skip,
//     out and final1 product, and products accumulate in float32;
//   * w_first, the biases and final2 stay float32;
//   * the ring stores each layer input h in the weight dtype;
//   * the residual and skip chains are float32, legacy skip scaling (x
//     sqrt(1/2)) from the second layer on.
//
// What bounds it on an H100.  Every sample step reads every weight:
// 24 x (786,432 + 40,960 + 65,536 + 131,072) = 24.58 M parameters, 49.2 MB
// in bf16 (+0.16 MB for the head).  Streamed from device memory at 3.35 TB/s
// that is 14.7 us per sample step for the whole batch (29.3 us with float32
// weights), about 4.2x realtime at 16 kHz for one stream.  The arithmetic is
// 49.2 MFLOP per batch row per step, so the loop stays memory-bound up to a
// batch of about 295.  The TPU kept all 49 MB resident in its on-chip VMEM;
// an H100 has 132 x 227 KB = 30 MB of shared memory and a 50 MB L2, so that
// design does not carry over one to one.
//
// This first design is simple and right, not fast.  The host function loops
// over samples in C and enqueues, per sample, two kernels per layer and two
// for the head (T x (2L + 2) launches, no Python in the loop):
//   layer_in   one block per gate-column pair (j, j + G/2), so one block owns
//              both halves of tanh(a) * sigmoid(g); it stages the inputs
//              [x_{t-2d} | x_{t-d} | h | c_t] of up to kRowTile batch rows in
//              shared memory, cast to the weight dtype, and its warps split
//              the two weight rows between them;
//   layer_out  one warp per skip/out column: skip accumulation, the residual
//              h_next = (res + h) * sqrt(1/2) into the other half of a
//              ping-pong h buffer, and h (the layer input) written into the
//              ring slot that held x_{t-2d};
//   final1     one warp per final1 column: relu -> final1 -> relu;
//   head       one block per batch row: final2 -> MoL sample (Philox4x32-10
//              keyed by the seed, counter (draw, t, row)), and the next
//              sample's first_conv.
// Weights are packed output-major ((L, G, KI) and (L, S + R, G/2)), so the
// threads reading one output column read one contiguous row, 16 bytes a thread per
// load, all of a row's loads issued before the first is used; the TPU's
// (in, out) layout would make every column read strided.
// KI = 3R + C is zero-padded to a multiple of 8 by the packer, and G/2 and S
// must be multiples of 8, so every weight row is whole 16-byte vectors.
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
constexpr float kSqrtHalf = 0.70710678118654752440f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
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

// float -> weight dtype -> float: the cast an activation takes before a product
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Cvt<T>::to(Cvt<T>::from(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-thread partial dot products of NR weight rows w[r] (n elements each,
// whole 16-byte vectors) with nb <= kRowTile activation rows xs (n floats
// apart in shared memory): acc[r][bb] += this thread's share, the vectors
// first, first + stride, ...  Each thread issues the loads of kUnroll
// vectors per row before it uses any, so one round trip to memory covers a
// row of up to stride * kUnroll vectors.  The caller sums the shares.
template <typename T, int NR>
__device__ __forceinline__ void lane_dots(const T* const (&w)[NR], const float* xs, int n,
                                          int nb, int first, int stride,
                                          float (&acc)[NR][kRowTile]) {
  constexpr int V = Cvt<T>::kVec;
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
        for (int r = 0; r < NR; ++r) Cvt<T>::unpack(raw[r][u], wv[r]);
#pragma unroll
        for (int bb = 0; bb < kRowTile; ++bb) {
          if (bb < nb) {
            const float* x = xs + bb * n + v * V;
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

template <typename T>
__global__ void __launch_bounds__(kWarpsIn * 32)
layer_in_kernel(const T* __restrict__ w_in,      // (G, KIp) this layer
                const float* __restrict__ b_in,  // (G,)
                const T* __restrict__ ring,      // (slots, B, R)
                int slot_2d, int slot_d,
                const float* __restrict__ h,     // (B, R) layer input
                const float* __restrict__ cond,  // row 0 of c_t; rows cond_stride apart
                long long cond_stride,
                float* __restrict__ gated,       // (B, G2)
                int B, int R, int C, int KIp, int G2) {
  extern __shared__ float xs[];  // (kRowTile, KIp)
  __shared__ float part[kWarpsIn][2][kRowTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x;      // gate-column pair (j, j + G2)
  const T* const rows[2] = {w_in + (size_t)j * KIp, w_in + (size_t)(j + G2) * KIp};
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();  // the previous tile's readers are done
    for (int bb = 0; bb < nb; ++bb) {
      const int b = b0 + bb;
      const T* x2 = ring + ((size_t)slot_2d * B + b) * R;
      const T* x1 = ring + ((size_t)slot_d * B + b) * R;
      const float* hb = h + (size_t)b * R;
      const float* cb = cond + (size_t)b * cond_stride;
      float* row = xs + bb * KIp;
      for (int k = threadIdx.x; k < R; k += blockDim.x) {
        row[k] = Cvt<T>::to(x2[k]);
        row[R + k] = Cvt<T>::to(x1[k]);
        row[2 * R + k] = round_to<T>(hb[k]);
      }
      for (int k = 3 * R + threadIdx.x; k < KIp; k += blockDim.x)
        row[k] = k < 3 * R + C ? round_to<T>(cb[k - 3 * R]) : 0.f;
    }
    __syncthreads();
    float acc[2][kRowTile] = {};
    lane_dots<T, 2>(rows, xs, KIp, nb, threadIdx.x, blockDim.x, acc);
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

template <typename T>
__global__ void __launch_bounds__(kWarpsOut * 32)
layer_out_kernel(const T* __restrict__ w_so,       // (S + R, G2) this layer
                 const float* __restrict__ b_so,   // (S + R,)
                 const float* __restrict__ gated,  // (B, G2)
                 const float* __restrict__ h_in,   // (B, R) layer input
                 float* __restrict__ h_out,        // (B, R) next layer's input
                 float* __restrict__ skip,         // (B, S)
                 T* __restrict__ ring, int slot_w,
                 int B, int R, int S, int G2, int first_layer, float skip_scale) {
  extern __shared__ float gs[];  // (kRowTile, G2)
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsOut + (threadIdx.x >> 5);
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * G2; idx += blockDim.x)
      gs[idx] = round_to<T>(gated[(size_t)b0 * G2 + idx]);
    __syncthreads();
    if (o < S + R) {
      const T* const rows[1] = {w_so + (size_t)o * G2};
      float acc[1][kRowTile] = {};
      lane_dots<T, 1>(rows, gs, G2, nb, threadIdx.x & 31, 32, acc);
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
            ring[((size_t)slot_w * B + b) * R + r] = Cvt<T>::from(hi);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsOut * 32)
final1_kernel(const float* __restrict__ skip,                           // (B, S)
              const T* __restrict__ w_f1, const float* __restrict__ b_f1,  // (S, S), (S,)
              float* __restrict__ fin,                                  // (B, S)
              int B, int S) {
  extern __shared__ float os[];  // (kRowTile, S)
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsOut + (threadIdx.x >> 5);
  for (int b0 = 0; b0 < B; b0 += kRowTile) {
    const int nb = min(kRowTile, B - b0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * S; idx += blockDim.x)
      os[idx] = round_to<T>(fmaxf(skip[(size_t)b0 * S + idx], 0.f));
    __syncthreads();
    if (o < S) {
      const T* const rows[1] = {w_f1 + (size_t)o * S};
      float acc[1][kRowTile] = {};
      lane_dots<T, 1>(rows, os, S, nb, threadIdx.x & 31, 32, acc);
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

template <typename T>
int generate(int B, int T_total, int L, int R, int G, int S, int C, int KIp, int K,
             const int* dil, int legacy, float log_scale_min, uint2 key, int deterministic,
             const T* w_in, const float* b_in, const T* w_so, const float* b_so,
             const float* w_first, const float* b_first, const T* w_f1, const float* b_f1,
             const float* w_f2, const float* b_f2, const float* cond, T* ring, float* h,
             float* skip, float* gated, float* fin, float* out, cudaStream_t stream) {
  const int G2 = G / 2;
  std::vector<int> offs(L);
  int slots = 0;
  for (int l = 0; l < L; ++l) {
    offs[l] = slots;
    slots += 2 * dil[l];
  }
  const int rows = B < kRowTile ? B : kRowTile;
  const int smem_in = rows * KIp * (int)sizeof(float);
  const int smem_out = rows * G2 * (int)sizeof(float);
  const int smem_f1 = rows * S * (int)sizeof(float);
  const int smem_head = (S + K + 1) * (int)sizeof(float);
  if (smem_in > kMaxSmem || smem_out > kMaxSmem || smem_f1 > kMaxSmem || smem_head > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  DVC_CHECK(cudaFuncSetAttribute(layer_in_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_in));
  DVC_CHECK(cudaFuncSetAttribute(layer_out_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_out));
  DVC_CHECK(cudaFuncSetAttribute(final1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_f1));

  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * B * R * sizeof(T), stream));
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
      const int d = dil[l], two_d = 2 * d;
      const int wp = t % two_d;
      const int slot_2d = offs[l] + wp;
      const int slot_d = offs[l] + (wp + d) % two_d;
      const float* h_in = h + (size_t)(l & 1) * hsz;  // layer 0 reads buffer 0
      float* h_out = h + (size_t)((l + 1) & 1) * hsz;
      layer_in_kernel<T><<<grid_in, kWarpsIn * 32, smem_in, stream>>>(
          w_in + (size_t)l * G * KIp, b_in + (size_t)l * G, ring, slot_2d, slot_d, h_in,
          cond + (size_t)t * C, cond_stride, gated, B, R, C, KIp, G2);
      DVC_CHECK(cudaGetLastError());
      layer_out_kernel<T><<<grid_out, kWarpsOut * 32, smem_out, stream>>>(
          w_so + (size_t)l * (S + R) * G2, b_so + (size_t)l * (S + R), gated, h_in, h_out, skip,
          ring, slot_2d, B, R, S, G2, l == 0, skip_scale);
      DVC_CHECK(cudaGetLastError());
    }
    final1_kernel<T><<<grid_f1, kWarpsOut * 32, smem_f1, stream>>>(skip, w_f1, b_f1, fin, B, S);
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

// dtype: 0 = float32 weights, 1 = bfloat16 weights.  KIp: w_in's padded row
// length (>= 3R + C, a multiple of 8).  Pointers are 16-byte aligned device
// pointers except dil (host, L ints).  Returns 0 or the first cudaError_t.
int dvc_wavenet_generate(int dtype, int B, int T, int L, int R, int G, int S, int C, int KIp,
                         int K, const int* dil, int legacy, float log_scale_min,
                         unsigned long long seed, int deterministic, const void* w_in,
                         const void* b_in, const void* w_so, const void* b_so,
                         const void* w_first, const void* b_first, const void* w_f1,
                         const void* b_f1, const void* w_f2, const void* b_f2, const void* cond,
                         void* ring, void* h, void* skip, void* gated, void* fin, void* out,
                         void* stream) {
  if (B <= 0 || T < 0 || L <= 0 || K <= 0 || K % 3 != 0 || G % 16 != 0 || S % 8 != 0 ||
      KIp % 8 != 0 || KIp < 3 * R + C)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return generate<float>(B, T, L, R, G, S, C, KIp, K, dil, legacy, log_scale_min,
                             key_of(seed), deterministic, (const float*)w_in,
                             (const float*)b_in, (const float*)w_so, (const float*)b_so,
                             (const float*)w_first, (const float*)b_first, (const float*)w_f1,
                             (const float*)b_f1, (const float*)w_f2, (const float*)b_f2,
                             (const float*)cond, (float*)ring, (float*)h, (float*)skip,
                             (float*)gated, (float*)fin, (float*)out, st);
    case 1:
      return generate<__nv_bfloat16>(
          B, T, L, R, G, S, C, KIp, K, dil, legacy, log_scale_min, key_of(seed), deterministic,
          (const __nv_bfloat16*)w_in, (const float*)b_in, (const __nv_bfloat16*)w_so,
          (const float*)b_so, (const float*)w_first, (const float*)b_first,
          (const __nv_bfloat16*)w_f1, (const float*)b_f1, (const float*)w_f2,
          (const float*)b_f2, (const float*)cond, (__nv_bfloat16*)ring, (float*)h,
          (float*)skip, (float*)gated, (float*)fin, (float*)out, st);
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
