// WaveNet vocoder: autoregressive mixture-of-logistics generation on Hopper,
// one persistent cooperative launch per call with the weights resident in
// shared memory.
//
// Replaces the TPU kernels of dvc_tpu/kernels/wavenet_step.py:
//   * K1+K2, the resident pl.pallas_call built by `_resident_call`
//     (:388-429, call at :415), whose body is `_make_kernel_resident`
//     (:286-384), with the in-kernel sampler `_mol_sample` /
//     `_uniform_from_bits` (:241-283);
//   * K3, the streamed pl.pallas_call built by `_streamed_call` (:706-787,
//     call at :771), whose body is `_make_kernel` (:464-592).  Its fused
//     w_cat/w_so layout and `layers_per_block` are TPU grid shapes of K1's
//     function; its int8 weight streaming (quantized=True) is the
//     <int8_t, bf16, F> instantiation below.
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
// What bounds it on an H100.  A sample step is 24 x (786,432 + 40,960 +
// 65,536 + 131,072) = 24.58 M multiply-adds per batch row: 2.45 ms of
// tensor-core work (989 TFLOP/s) for cond (3, 16384, 80), the operation
// bound.  The step is a chain of 2L + 1 = 49 dependent phases, each ending
// in a grid barrier of about 1.14 us on this card (tools/ablate_body), so
// the barriers alone cost about 56 us a step: the floor of this design.
// The weights are 49.2 MB in bf16, 98.3 MB in float32 and 24.6 MB of int8
// codes (+0.27 MB of scales); the TPU kept them in VMEM.  Here each block
// keeps its own rows in shared memory (227 KB a block, 29.7 MB over 128
// SMs): the int8 pack entirely, so an int8 step reads no weight from L2 or
// device memory; bf16 and float32 keep their leading layers and stream the
// rest, one layer ahead, from L2 (at full width and B = 3, 11 of 24 bf16
// layers resident: 26.6 MB a step streamed; 4 of 24 float32 layers: 81.9 MB).
// At B <= 8 a layer is about 24 K multiply-adds a block, too few for the
// tensor cores to pay for their tile shapes: the dots are float32 FMAs on
// the CUDA cores (mma / wgmma for large batches is future work).
//
// Design.  One cooperative launch (cudaLaunchCooperativeKernel refuses a
// grid that cannot be co-resident instead of hanging) of `blocks` blocks,
// one an SM, loops over (t, l) inside the kernel.  The caller's block plan
// (kernels/wavenet_step.py `block_plan`) gives each block `pairs`
// consecutive gate-column pairs (j, j + G/2), `rows` consecutive skip/out
// rows and `cols` consecutive final1 columns (full width on 128 blocks:
// 2, 6 and 2), the row tile and the number of resident layers; the kernel
// recomputes the shared-memory layout and refuses a plan whose byte count
// differs from its own.  A block's rows of a layer are three contiguous runs
// of the output-major pack (its a-rows, its g-rows, its skip/out rows), so
// no reordered pack is needed: they are copied into shared memory with
// 16-byte cp.async, resident layers once per call, streamed layers into a
// double buffer, layer l + 1's copy issued at the start of layer l.  Per
// sample step:
//   in     stage [x_{t-2d} | x_{t-d} | h | c_t] of a row tile once, in the
//          activation dtype (all of a thread's 16-byte loads in flight
//          before the first store), then the dots: the threads of a gate
//          pair split its 4-element chunks and each dots both of the pair's
//          rows, so a staged chunk is read once for both; the gate
//          tanh(a) * sigmoid(g) into `gated`;               grid barrier (a)
//   out    stage `gated` once; one warp per skip/out row.  The skip sums and
//          the layer inputs h of the block's own rows live in shared memory
//          for the whole step; h is published for the next layer's `in`,
//          the skip only after the last layer; the ring slot of x_{t-2d}
//          takes h after barrier (a), when every block has staged it;
//                                                           grid barrier (b)
//   final1 relu -> final1 -> relu for the block's columns;  grid barrier
//   head   every block computes final2 and the MoL draw of every batch row
//          itself and forms the next sample's h = x * w_first + b_first for
//          its own rows; block 0 writes the output.  No barrier: the next
//          layer 0 reads only block-local data and the ring.
// The blocks agree bit for bit on every draw: each reads the same fin from
// L2 after the barrier, sums final2 in the same order (lane-strided FMAs,
// then a butterfly warp sum) and draws Philox4x32-10 numbers keyed by
// (seed, t, row), counter (draw, t, row, which), that depend on nothing
// else.  A check run passes `draws` and every block writes its draws there,
// and `stamps`, where block 0 writes its SM clock at every phase's end.
// Data written inside the kernel is read through L2 (ld.global.cg); the
// weights through cp.async; the ring is zeroed by the kernel before the
// first barrier, so a call is exactly one launch.
// Ring taps follow the TPU kernel (:340-342): tap_2d = off + (t mod 2d),
// tap_d = off + ((t mod 2d) + d) mod 2d.
//
// One template over (layer weight W, activation and ring A, final1 weight F)
// covers every pack: <float, float, float>, <bf16, bf16, bf16>, and for int8
// <int8, bf16, float> or <int8, bf16, bf16>.  Every weight row is whole
// 16-byte vectors: float32 / bf16 packs zero-pad KI = 3R + C to a multiple of
// 8; an int8 pack zero-pads each w_in segment to Rs (taps) or a multiple of
// 16 (cond) and each w_so row to G2p, so that no 16-code vector straddles two
// segments: each 4-code chunk's products are summed, then multiplied by its
// segment's scale.  The staging needs R % 8 == 0, C % 4 == 0 and
// (G/2) % 8 == 0.  h and gated are published in the activation dtype and the
// skip sum as F(relu(skip)): the casts their readers apply anyway, at half
// the bytes that every block stages.  The C entry point returns the first
// CUDA error code and the Python wrapper raises on it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 8;           // batch rows per pass through the weights
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;      // H100: 227 KB of shared memory a block
constexpr int kStaticReserve = 1024;  // static shared memory the plan sets aside
constexpr int kSegs = 4;              // int8 w_in row segments: x_{t-2d}, x_{t-d}, h, cond
constexpr float kSqrtHalf = 0.70710678118654752440f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float from(float v) { return v; }
  // elements 4c .. 4c + 3 of row w, as floats
  static __device__ __forceinline__ void unpack4(const float* w, int c, float* o) {
    const float4 f = reinterpret_cast<const float4*>(w)[c];
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr bool kScaled = false;
  // round to nearest even, as jnp .astype(bfloat16) and torch .to(bfloat16)
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
  static __device__ __forceinline__ void unpack4(const __nv_bfloat16* w, int c, float* o) {
    const uint2 u = reinterpret_cast<const uint2*>(w)[c];  // element 2i is the low half
    o[0] = __uint_as_float(u.x << 16);
    o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16);
    o[3] = __uint_as_float(u.y & 0xffff0000u);
  }
};

// int8 codes: weights only (activations never take this type), each
// chunk's products scaled after their sum
template <>
struct Cvt<int8_t> {
  static constexpr int kVec = 16;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void unpack4(const int8_t* w, int c, float* o) {
    const uint32_t u = reinterpret_cast<const uint32_t*>(w)[c];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = (float)(int)(int8_t)(uint8_t)(u >> (8 * k));  // byte k
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums over a warp's 32 lanes of V values a lane holds (V a power of two
// from 2 to 16), by a reduce-scatter butterfly: at the level of offset O a
// lane keeps N of its 2N values (the upper half when lane & O) and adds its
// partner's copy of that half, so V values cost V - 1 shuffles, plus one for
// each level left.  Levels are template arguments so that `a` stays in
// registers.  Returns the sum of value reduce_index<V>(lane).
template <int N, int O, int V>
__device__ __forceinline__ void fold(float (&a)[V], int lane) {
  if constexpr (N >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float send = up ? a[i] : a[i + N];
      const float keep = up ? a[i + N] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    fold<N / 2, O / 2, V>(a, lane);
  } else if constexpr (O >= 1) {
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
    fold<0, O / 2, V>(a, lane);
  }
}

template <int V>
__device__ __forceinline__ float warp_sum_many(float (&a)[V]) {
  fold<V / 2, 16, V>(a, threadIdx.x & 31);
  return a[0];
}

// which value's sum warp_sum_many<V> leaves in `lane`, and a lane that holds
// value `idx`
template <int V>
__device__ __forceinline__ int reduce_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int n = V / 2, o = 16; n >= 1; n /= 2, o /= 2)
    if (lane & o) idx += n;
  return idx;
}

template <int V>
__device__ __forceinline__ int reduce_lane(int idx) {
  int lane = 0;
#pragma unroll
  for (int n = V / 2, o = 16; n >= 1; n /= 2, o /= 2)
    if (idx & n) lane |= o;
  return lane;
}

// lane bb < V gets the warp's sum of a[bb]
template <int V>
__device__ __forceinline__ float warp_sums_to_lanes(float (&a)[V]) {
  const float s = warp_sum_many<V>(a);
  return __shfl_sync(0xffffffffu, s, reduce_lane<V>((threadIdx.x & 31) & (V - 1)));
}

// ---- the launch's parameters and its shared-memory layout -----------------

struct Params {
  int B, T, L, R, Rs, G2, G2p, S, C, KIp, K;
  int blocks, pairs, rows, cols, tile, nres;  // the caller's block plan
  int legacy, deterministic;
  float log_scale_min;
  uint2 key;
  int slots;
  int dil[kMaxLayers], offs[kMaxLayers];
  const void* w_in;      // (L, G, KIp) W
  const float* s_in;     // (L, kSegs, G), int8 only
  const float* b_in;     // (L, G)
  const void* w_so;      // (L, S + R, G2p) W
  const float* s_so;     // (L, S + R), int8 only
  const float* b_so;     // (L, S + R)
  const float* w_first;  // (R,)
  const float* b_first;  // (R,)
  const void* w_f1;      // (S, S) F, output-major
  const float* b_f1;     // (S,)
  const float* w_f2;     // (K, S)
  const float* b_f2;     // (K,)
  const float* cond;     // (B, T, C)
  void* ring;            // (slots, B, R) A
  void* h;               // (B, R) A: the next layer's input, published by its owners
  void* skip;            // (B, S) F: F(relu(skip sum)), published after the last layer
  void* gated;           // (B, G/2) A
  float* fin;            // (B, S): relu(final1)
  float* out;            // (B, T)
  float* draws;          // (blocks, B, T) or null: every block's draws (check runs)
  long long* stamps;     // (stamp_steps, 4 L + 4) or null: block 0's clock at each phase end
  int stamp_steps;
};

__host__ __device__ inline size_t r16(size_t n) { return (n + 15) & ~(size_t)15; }

// Per-layer constants of a block, floats: [int8 only: w_in row scales
// (2 pairs x kSegs) | w_so row scales (rows)] [b_in of its 2 pairs rows |
// b_so of its rows]
__host__ __device__ inline int scale_floats(const Params& p, bool scaled) {
  return scaled ? 2 * p.pairs * kSegs + p.rows : 0;
}

// Byte offsets into a block's dynamic shared memory, in this order; the
// Python block plan sums the same regions.
struct Layout {
  size_t slice;  // one layer's weights of one block: [a-rows | g-rows | skip/out rows]
  size_t wres, wbuf, consts, wf1, own, xsamp, stage, total;
};

template <typename W, typename A, typename F>
__host__ __device__ inline Layout layout_of(const Params& p) {
  Layout o;
  // bytes of a staging tile's row: the widest of the phases' inputs, each
  // in the type its dots read (the head's fin | y in float32)
  size_t width = (size_t)p.KIp * sizeof(A);
  width = width > (size_t)p.G2p * sizeof(A) ? width : (size_t)p.G2p * sizeof(A);
  width = width > (size_t)p.S * sizeof(F) ? width : (size_t)p.S * sizeof(F);
  width = width > (size_t)(p.S + p.K) * 4 ? width : (size_t)(p.S + p.K) * 4;
  o.slice = r16((size_t)(2 * p.pairs * p.KIp + p.rows * p.G2p) * sizeof(W));
  const int per = scale_floats(p, Cvt<W>::kScaled) + 2 * p.pairs + p.rows;
  size_t at = 0;
  o.wres = at;
  at += (size_t)p.nres * o.slice;
  o.wbuf = at;
  at += p.nres < p.L ? 2 * o.slice : 0;
  o.consts = at;
  at += r16((size_t)p.L * per * sizeof(float));
  o.wf1 = at;
  at += r16((size_t)p.cols * p.S * sizeof(F));
  o.own = at;
  at += r16((size_t)p.rows * p.B * sizeof(float));
  o.xsamp = at;
  at += r16((size_t)p.B * sizeof(float));
  o.stage = at;
  at += r16((size_t)p.tile * width);
  o.total = at;
  return o;
}

// ---- copies and loads -------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, by the whole block
__device__ __forceinline__ void copy_async(void* dst, const void* src, size_t bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) cp_async16(d + i, s + i);
}

// ---- dots --------------------------------------------------------------------

// Segment scale of chunk c of an int8 row: s4[0] below seg.x, s4[1] below
// seg.y, s4[2] below seg.z, else s4[3] (a row of one segment: all INT_MAX)
__device__ __forceinline__ float seg_scale(const float (&s4)[kSegs], int3 seg, int c) {
  return c < seg.x ? s4[0] : c < seg.y ? s4[1] : c < seg.z ? s4[2] : s4[3];
}

// Per-thread partial dot products of NR weight rows w[r] (n elements in
// shared memory, n % 4 == 0) with NB staged activation rows xs (n elements
// of type X apart): acc[r][bb] += this thread's share over the 4-element
// chunks first, first + stride, ...  A chunk of xs is read once for all NR
// rows, and a warp's reads are consecutive words (no bank conflicts)
// whatever the types.  int8 rows sum each chunk's products and add
// them times the chunk's segment scale.  The caller sums the shares.
template <typename W, typename X, int NR, int NB>
__device__ __forceinline__ void dots_nb(const W* const (&w)[NR], const X* xs, int n, int first,
                                        int stride, float (&acc)[NR][kMaxTile],
                                        const float (&s4)[NR][kSegs], int3 seg) {
  const int nc = n / 4;
#pragma unroll 2
  for (int c = first; c < nc; c += stride) {
    float wv[NR][4];
    float scale[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      Cvt<W>::unpack4(w[r], c, wv[r]);
      if constexpr (Cvt<W>::kScaled) scale[r] = seg_scale(s4[r], seg, c);
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      float x[4];
      Cvt<X>::unpack4(xs + (size_t)bb * n, c, x);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if constexpr (Cvt<W>::kScaled) {
          float s = wv[r][0] * x[0];
          s = fmaf(wv[r][1], x[1], s);
          s = fmaf(wv[r][2], x[2], s);
          s = fmaf(wv[r][3], x[3], s);
          acc[r][bb] = fmaf(scale[r], s, acc[r][bb]);
        } else {
          acc[r][bb] = fmaf(wv[r][0], x[0], acc[r][bb]);
          acc[r][bb] = fmaf(wv[r][1], x[1], acc[r][bb]);
          acc[r][bb] = fmaf(wv[r][2], x[2], acc[r][bb]);
          acc[r][bb] = fmaf(wv[r][3], x[3], acc[r][bb]);
        }
      }
    }
  }
}

// dots_nb for a run-time row count nb (1 .. kMaxTile)
template <typename W, typename X, int NR>
__device__ __forceinline__ void dots(const W* const (&w)[NR], const X* xs, int n, int nb,
                                     int first, int stride, float (&acc)[NR][kMaxTile],
                                     const float (&s4)[NR][kSegs], int3 seg) {
  switch (nb) {
    case 1: dots_nb<W, X, NR, 1>(w, xs, n, first, stride, acc, s4, seg); break;
    case 2: dots_nb<W, X, NR, 2>(w, xs, n, first, stride, acc, s4, seg); break;
    case 3: dots_nb<W, X, NR, 3>(w, xs, n, first, stride, acc, s4, seg); break;
    case 4: dots_nb<W, X, NR, 4>(w, xs, n, first, stride, acc, s4, seg); break;
    case 5: dots_nb<W, X, NR, 5>(w, xs, n, first, stride, acc, s4, seg); break;
    case 6: dots_nb<W, X, NR, 6>(w, xs, n, first, stride, acc, s4, seg); break;
    case 7: dots_nb<W, X, NR, 7>(w, xs, n, first, stride, acc, s4, seg); break;
    default: dots_nb<W, X, NR, 8>(w, xs, n, first, stride, acc, s4, seg); break;
  }
}

// 4 floats -> 4 elements of T, rounded as T's `from` does, as raw bits
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&f)[4]);

template <>
__device__ __forceinline__ void store4<float>(float* dst, const float (&f)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, const float (&f)[4]) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(f[0])) |
                      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[1])) << 16);
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(f[2])) |
                      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[3])) << 16);
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
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

// ---- the phases ---------------------------------------------------------------

// The block's share of the plan: gate pairs [j0, j0 + nj), skip/out rows
// [o0, o0 + no), final1 columns [f0, f0 + nf).
struct Owned {
  int j0, nj, o0, no, f0, nf;
};

__device__ __forceinline__ void slots_of(const Params& p, int t, int l, int* s2, int* s1) {
  const int d = p.dil[l], wp = t % (2 * d);
  *s2 = p.offs[l] + wp;
  *s1 = p.offs[l] + (wp + d) % (2 * d);
}

// Chunk q (16 bytes) of staged row b0 of phase `in`: its source, the
// stride in chunks between batch rows, its element offset in the staged row,
// and its kind: 0 ring tap x_{t-2d}, 1 ring tap x_{t-d}, 2 h, 3 cond.
template <typename A>
__device__ __forceinline__ const uint4* in_chunk(const Params& p, const A* x2, const A* x1, int t,
                                                 int b0, int q, size_t* stride, int* dst,
                                                 int* kind) {
  constexpr int VA = Cvt<A>::kVec;
  const int R = p.R, ca = R / VA;
  if (q < 3 * ca) {
    const int seg = q / ca, k = q - seg * ca;
    const A* base = seg == 0 ? x2 : seg == 1 ? x1 : static_cast<const A*>(p.h);
    *stride = R / VA;
    *dst = seg * p.Rs + k * VA;
    *kind = seg;
    return reinterpret_cast<const uint4*>(base + (size_t)b0 * R) + k;
  }
  const int k = q - 3 * ca;
  *stride = (size_t)p.T * p.C / 4;
  *dst = 3 * p.Rs + k * 4;
  *kind = 3;
  return reinterpret_cast<const uint4*>(p.cond + ((size_t)b0 * p.T + t) * p.C) + k;
}

// xs (nb rows of KIp elements of A) = [x_{t-2d} | x_{t-d} | h | c_t] of
// batch rows b0.., each segment at its offset of the pack (taps Rs apart,
// cond at 3 Rs) and zeros in the padding.  The ring and h arrive in A and
// are copied as they are; cond is rounded to A; layer 0's h is the
// block-local first_conv of the last draws.  A thread takes the same 16-byte
// chunk q of every row (one row's source, then a stride), all its loads
// issued before its first store.
template <typename A>
__device__ __forceinline__ void stage_in(const Params& p, const A* x2, const A* x1, int l, int t,
                                         int b0, int nb, const float* xsamp, A* xs) {
  constexpr int VA = Cvt<A>::kVec;  // activation elements in 16 bytes
  const int R = p.R, Rs = p.Rs, C = p.C, KIp = p.KIp;
  const int nq = 3 * (R / VA) + C / 4;  // chunks of a batch row
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    size_t stride;
    int dst, kind;
    const uint4* src = in_chunk<A>(p, x2, x1, t, b0, q, &stride, &dst, &kind);
    const bool act = kind < 3;
    const bool first_conv = l == 0 && kind == 2;  // layer 0's h: computed here
    uint4 v[kMaxTile];
#pragma unroll
    for (int bb = 0; bb < kMaxTile; ++bb)
      if (bb < nb && !first_conv) v[bb] = __ldcg(src + bb * stride);
#pragma unroll
    for (int bb = 0; bb < kMaxTile; ++bb) {
      if (bb < nb) {
        A* d = xs + (size_t)bb * KIp + dst;
        if (first_conv) {
          const int r = dst - 2 * Rs;
          const float x = xsamp[b0 + bb];
#pragma unroll
          for (int e = 0; e < VA / 4; ++e) {
            float f[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = r + 4 * e + i;
              f[i] = fmaf(x, __ldg(p.w_first + k), __ldg(p.b_first + k));
            }
            store4<A>(d + 4 * e, f);
          }
        } else if (act) {
          *reinterpret_cast<uint4*>(d) = v[bb];
        } else {
          const float f[4] = {__uint_as_float(v[bb].x), __uint_as_float(v[bb].y),
                              __uint_as_float(v[bb].z), __uint_as_float(v[bb].w)};
          store4<A>(d, f);
        }
      }
    }
  }
  // zeros in the padding: [R, Rs) after each tap, [3 Rs + C, KIp) at the end
  const int pad_tap = Rs - R, npad = 3 * pad_tap + (KIp - 3 * Rs - C);
  for (int i = threadIdx.x; i < nb * npad; i += kThreads) {
    const int bb = i / npad, k = i - bb * npad;
    const int at = k < 3 * pad_tap ? (k / pad_tap) * Rs + R + k % pad_tap
                                   : 3 * Rs + C + (k - 3 * pad_tap);
    xs[(size_t)bb * KIp + at] = Cvt<A>::from(0.f);
  }
}

// dst (nb rows, n_dst elements apart) = the T rows src (n elements, whole
// 16-byte chunks, src_stride apart) as they are, zeros in [n, n_dst)
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int n_dst, const T* src, int src_stride,
                                           int nb, int n) {
  constexpr int V = Cvt<T>::kVec;
  const int nq = n_dst / V;  // n_dst is a multiple of V
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const bool in = q * V < n;
    uint4 v[kMaxTile];
#pragma unroll
    for (int bb = 0; bb < kMaxTile; ++bb) {
      v[bb] = make_uint4(0u, 0u, 0u, 0u);
      if (bb < nb && in)
        v[bb] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)bb * src_stride) + q);
    }
#pragma unroll
    for (int bb = 0; bb < kMaxTile; ++bb)
      if (bb < nb) reinterpret_cast<uint4*>(dst + (size_t)bb * n_dst)[q] = v[bb];
  }
}

// phase `in`: gated[b][j] for the block's gate pairs.  Rows 0..pairs-1 of
// the slice are the a-rows, pairs..2 pairs-1 the g-rows; pair q has
// kWarps / pairs warps, each thread dotting both of its rows.
template <typename W, typename A>
__device__ __forceinline__ void phase_in(const Params& p, int t, int l, const W* wl,
                                         const float* cl, const Owned& me, const float* xsamp,
                                         A* xs, float (&part)[kWarps][2][kMaxTile]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpp = kWarps / p.pairs, q = warp / wpp;
  const int tpp = wpp * 32, sub = tid - q * tpp;
  const bool live = q < me.nj;
  const W* const rows[2] = {wl + (size_t)q * p.KIp, wl + (size_t)(p.pairs + q) * p.KIp};
  float s4[2][kSegs] = {{1.f, 1.f, 1.f, 1.f}, {1.f, 1.f, 1.f, 1.f}};
  if constexpr (Cvt<W>::kScaled) {
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      s4[0][s] = cl[q * kSegs + s];
      s4[1][s] = cl[(p.pairs + q) * kSegs + s];
    }
  }
  const int rc = p.Rs / 4;  // chunks of a tap segment
  const int3 seg = Cvt<W>::kScaled ? make_int3(rc, 2 * rc, 3 * rc)
                                   : make_int3(INT_MAX, INT_MAX, INT_MAX);
  const float* bias = cl + scale_floats(p, Cvt<W>::kScaled);  // a-rows, then g-rows
  const int cq = tid / kMaxTile, cb = tid % kMaxTile;  // the combining thread of (pair, row)
  const bool combines = tid < p.pairs * kMaxTile && cq < me.nj;
  int s2, s1;
  slots_of(p, t, l, &s2, &s1);
  const A* ring = static_cast<const A*>(p.ring);
  A* gated = static_cast<A*>(p.gated);
  const size_t hsz = (size_t)p.B * p.R;
  for (int b0 = 0; b0 < p.B; b0 += p.tile) {
    const int nb = min(p.tile, p.B - b0);
    if (b0 > 0) __syncthreads();  // the previous tile's readers are done
    stage_in<A>(p, ring + (size_t)s2 * hsz, ring + (size_t)s1 * hsz, l, t, b0, nb, xsamp, xs);
    __syncthreads();
    float acc[2][kMaxTile] = {};
    if (live) dots<W, A, 2>(rows, xs, p.KIp, nb, sub, tpp, acc, s4, seg);
    float red[2 * kMaxTile];  // [a-row | g-row] x kMaxTile, summed over the warp at once
#pragma unroll
    for (int bb = 0; bb < kMaxTile; ++bb) {
      red[bb] = acc[0][bb];
      red[kMaxTile + bb] = acc[1][bb];
    }
    const float sum = warp_sum_many<2 * kMaxTile>(red);
    if ((lane & 1) == 0) {
      const int v = reduce_index<2 * kMaxTile>(lane);
      part[warp][v / kMaxTile][v % kMaxTile] = sum;
    }
    __syncthreads();
    if (combines && cb < nb) {
      float pa = bias[cq], pg = bias[p.pairs + cq];
      for (int w = cq * wpp; w < (cq + 1) * wpp; ++w) {
        pa += part[w][0][cb];
        pg += part[w][1][cb];
      }
      gated[(size_t)(b0 + cb) * p.G2 + me.j0 + cq] =
          Cvt<A>::from(tanhf(pa) * (1.f / (1.f + expf(-pg))));
    }
  }
}

// phase `out`: one warp per skip/out row of the block.  own[i][b] holds row
// o0 + i's skip sum (o < S) or layer input h (o >= S) for the whole step.
template <typename W, typename A, typename F>
__device__ __forceinline__ void phase_out(const Params& p, int t, int l, const W* wl,
                                          const float* cl, const Owned& me, float* own,
                                          A* gs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = p.B, R = p.R, S = p.S, G2p = p.G2p;
  const W* wso = wl + (size_t)2 * p.pairs * p.KIp;
  const float* sso = cl + 2 * p.pairs * kSegs;                             // int8 only
  const float* bso = cl + scale_floats(p, Cvt<W>::kScaled) + 2 * p.pairs;  // b_so of the rows
  const bool last = l == p.L - 1;
  const float skip_scale = p.legacy ? kSqrtHalf : 1.f;
  const int3 one_seg = make_int3(INT_MAX, INT_MAX, INT_MAX);
  int s2, s1;
  slots_of(p, t, l, &s2, &s1);
  A* ring_w = static_cast<A*>(p.ring) + (size_t)s2 * B * R;
  A* h = static_cast<A*>(p.h);
  F* skip = static_cast<F*>(p.skip);
  for (int b0 = 0; b0 < B; b0 += p.tile) {
    const int nb = min(p.tile, B - b0);
    if (b0 > 0) __syncthreads();
    stage_rows<A>(gs, G2p, static_cast<const A*>(p.gated) + (size_t)b0 * p.G2, p.G2, nb, p.G2);
    __syncthreads();
    for (int i = warp; i < me.no; i += kWarps) {
      const int o = me.o0 + i;
      float s4[1][kSegs] = {{1.f, 1.f, 1.f, 1.f}};
      if constexpr (Cvt<W>::kScaled) s4[0][0] = sso[i];  // one segment: the whole row
      const W* const rows[1] = {wso + (size_t)i * G2p};
      float acc[1][kMaxTile] = {};
      dots<W, A, 1>(rows, gs, G2p, nb, lane, 32, acc, s4, one_seg);
      float v = warp_sums_to_lanes<kMaxTile>(acc[0]);  // lane bb: batch row bb's dot
      if (lane < nb) {
        const int b = b0 + lane;
        v += bso[i];
        float* ow = own + (size_t)i * B + b;
        if (o < S) {
          const float sk = l == 0 ? v : (*ow + v) * skip_scale;
          *ow = sk;
          if (last) skip[(size_t)b * S + o] = Cvt<F>::from(fmaxf(sk, 0.f));
        } else {
          const int r = o - S;
          const float hi = *ow;
          ring_w[(size_t)b * R + r] = Cvt<A>::from(hi);
          const float hn = (v + hi) * kSqrtHalf;
          *ow = hn;
          if (!last) h[(size_t)b * R + r] = Cvt<A>::from(hn);
        }
      }
    }
  }
}

// final1: fin = relu(F(relu(skip)) @ w_f1 + b_f1) for the block's columns
template <typename F>
__device__ __forceinline__ void phase_final1(const Params& p, const F* wf1, const Owned& me,
                                             F* os) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, S = p.S;
  const float ones[1][kSegs] = {{1.f, 1.f, 1.f, 1.f}};
  const int3 one_seg = make_int3(INT_MAX, INT_MAX, INT_MAX);
  const float bias0 = warp < me.nf ? __ldg(p.b_f1 + me.f0 + warp) : 0.f;  // before the staging
  for (int b0 = 0; b0 < p.B; b0 += p.tile) {
    const int nb = min(p.tile, p.B - b0);
    if (b0 > 0) __syncthreads();
    stage_rows<F>(os, S, static_cast<const F*>(p.skip) + (size_t)b0 * S, S, nb, S);
    __syncthreads();
    for (int i = warp; i < me.nf; i += kWarps) {
      const int o = me.f0 + i;
      const F* const rows[1] = {wf1 + (size_t)i * S};
      float acc[1][kMaxTile] = {};
      dots<F, F, 1>(rows, os, S, nb, lane, 32, acc, ones, one_seg);
      const float v = warp_sums_to_lanes<kMaxTile>(acc[0]);
      if (lane < nb)
        p.fin[(size_t)(b0 + lane) * S + o] = fmaxf(v + (i == warp ? bias0 : __ldg(p.b_f1 + o)), 0.f);
    }
  }
}

// head, in every block alike: final2 and the MoL draw of every batch row,
// then the next sample's layer input h = x * w_first + b_first of the
// block's own out rows.  fin's tile is staged once; a warp takes final2 rows
// c = warp, warp + kWarps, ... kHeadRows at a time and issues all their
// w_f2 loads (256 columns) before it uses any.
constexpr int kHeadRows = 4;

__device__ __forceinline__ void phase_head(const Params& p, int t, const Owned& me, float* fs, float* xsamp,
                           float* own) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = p.B, S = p.S, K = p.K;
  float* ys = fs + (size_t)p.tile * S;  // after the fin tile: tile x K draws' parameters
  for (int b0 = 0; b0 < B; b0 += p.tile) {
    const int nb = min(p.tile, B - b0);
    if (b0 > 0) __syncthreads();
    stage_rows<float>(fs, S, p.fin + (size_t)b0 * S, S, nb, S);
    __syncthreads();
    for (int c0 = warp; c0 < K; c0 += kHeadRows * kWarps) {
      float acc[kHeadRows][kMaxTile] = {};
      for (int k0 = 0; k0 < S; k0 += 8 * 32) {
        float wv[kHeadRows][8];
#pragma unroll
        for (int u = 0; u < kHeadRows; ++u) {
          const int c = c0 + u * kWarps;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int k = k0 + lane + 32 * e;
            wv[u][e] = c < K && k < S ? __ldg(p.w_f2 + (size_t)c * S + k) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + lane + 32 * e;
          if (k < S) {
#pragma unroll
            for (int bb = 0; bb < kMaxTile; ++bb) {
              if (bb < nb) {
                const float f = fs[(size_t)bb * S + k];
#pragma unroll
                for (int u = 0; u < kHeadRows; ++u) acc[u][bb] = fmaf(wv[u][e], f, acc[u][bb]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kHeadRows; ++u) {
        const int c = c0 + u * kWarps;
        if (c < K) {
          const float bias = __ldg(p.b_f2 + c);
#pragma unroll
          for (int bb = 0; bb < kMaxTile; ++bb) {
            if (bb < nb) {
              const float v = warp_sum(acc[u][bb]);
              if (lane == 0) ys[bb * K + c] = v + bias;
            }
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      const int b = b0 + threadIdx.x;
      const float x = mol_sample(ys + threadIdx.x * K, K / 3, p.log_scale_min, p.deterministic,
                                 p.key, (uint32_t)t, (uint32_t)b);
      xsamp[b] = x;
      if (blockIdx.x == 0) p.out[(size_t)b * p.T + t] = x;
      if (p.draws) p.draws[((size_t)blockIdx.x * B + b) * p.T + t] = x;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < me.no * B; i += kThreads) {
    const int ii = i / B, b = i - ii * B, o = me.o0 + ii;
    if (o >= S) own[i] = fmaf(xsamp[b], __ldg(p.w_first + o - S), __ldg(p.b_first + o - S));
  }
  __syncthreads();
}

template <typename W, typename A, typename F>
__global__ void __launch_bounds__(kThreads, 1) wavenet_persistent(const Params p) {
  __shared__ float part[kWarps][2][kMaxTile];
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Layout lo = layout_of<W, A, F>(p);
  W* wres = reinterpret_cast<W*>(smem + lo.wres);
  W* wbuf = reinterpret_cast<W*>(smem + lo.wbuf);
  float* consts = reinterpret_cast<float*>(smem + lo.consts);
  F* wf1 = reinterpret_cast<F*>(smem + lo.wf1);
  float* own = reinterpret_cast<float*>(smem + lo.own);
  float* xsamp = reinterpret_cast<float*>(smem + lo.xsamp);
  unsigned char* stage = smem + lo.stage;
  const size_t slice = lo.slice / sizeof(W);
  const int blk = blockIdx.x, SR = p.S + p.R;
  Owned me;
  me.j0 = blk * p.pairs;
  me.nj = max(0, min(p.pairs, p.G2 - me.j0));
  me.o0 = blk * p.rows;
  me.no = max(0, min(p.rows, SR - me.o0));
  me.f0 = blk * p.cols;
  me.nf = max(0, min(p.cols, p.S - me.f0));

  // the block's rows of layer l: three contiguous runs of the output-major pack
  auto load_layer = [&](int l, W* dst) {
    const W* wi = static_cast<const W*>(p.w_in) + (size_t)l * 2 * p.G2 * p.KIp;
    const W* wo = static_cast<const W*>(p.w_so) + (size_t)l * SR * p.G2p;
    const size_t run = (size_t)me.nj * p.KIp * sizeof(W);
    copy_async(dst, wi + (size_t)me.j0 * p.KIp, run);
    copy_async(dst + (size_t)p.pairs * p.KIp, wi + (size_t)(p.G2 + me.j0) * p.KIp, run);
    copy_async(dst + (size_t)2 * p.pairs * p.KIp, wo + (size_t)me.o0 * p.G2p,
               (size_t)me.no * p.G2p * sizeof(W));
  };

  // prologue: resident weights, constants and final1 columns in; the ring zeroed
  for (int l = 0; l < p.nres; ++l) load_layer(l, wres + (size_t)l * slice);
  copy_async(wf1, static_cast<const F*>(p.w_f1) + (size_t)me.f0 * p.S,
             (size_t)me.nf * p.S * sizeof(F));
  cp_async_commit();
  const int nsc = scale_floats(p, Cvt<W>::kScaled), per = nsc + 2 * p.pairs + p.rows;
  for (int i = threadIdx.x; i < p.L * per; i += kThreads) {
    const int l = i / per, k = i - l * per;
    const int k2 = k < nsc ? k : k - nsc;  // index among the scales, else among the biases
    float v = 0.f;
    if (k < nsc && k2 < 2 * p.pairs * kSegs) {  // w_in row scales
      const int row = k2 / kSegs, seg = k2 - row * kSegs, q = row % p.pairs;
      const int col = (row < p.pairs ? 0 : p.G2) + me.j0 + q;
      if (q < me.nj) v = p.s_in[((size_t)l * kSegs + seg) * 2 * p.G2 + col];
    } else if (k < nsc) {  // w_so row scales
      const int i2 = k2 - 2 * p.pairs * kSegs;
      if (i2 < me.no) v = p.s_so[(size_t)l * SR + me.o0 + i2];
    } else if (k2 < 2 * p.pairs) {  // b_in of the a-rows, then the g-rows
      const int q = k2 % p.pairs;
      const int col = (k2 < p.pairs ? 0 : p.G2) + me.j0 + q;
      if (q < me.nj) v = p.b_in[(size_t)l * 2 * p.G2 + col];
    } else if (k2 - 2 * p.pairs < me.no) {  // b_so of the rows
      v = p.b_so[(size_t)l * SR + me.o0 + k2 - 2 * p.pairs];
    }
    consts[i] = v;
  }
  for (int b = threadIdx.x; b < p.B; b += kThreads) xsamp[b] = 0.f;  // x_{-1} = 0
  for (int i = threadIdx.x; i < me.no * p.B; i += kThreads) {
    const int o = me.o0 + i / p.B;
    if (o >= p.S) own[i] = fmaf(0.f, p.w_first[o - p.S], p.b_first[o - p.S]);
  }
  {
    uint4* ring = static_cast<uint4*>(p.ring);
    const size_t n16 = (size_t)p.slots * p.B * p.R * sizeof(A) / 16;
    for (size_t i = (size_t)blk * kThreads + threadIdx.x; i < n16; i += (size_t)p.blocks * kThreads)
      ring[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<0>();
  long long streamed = 0;  // streamed layers so far: buffer streamed & 1
  if (p.nres < p.L) {
    load_layer(p.nres, wbuf);
    cp_async_commit();
  }
  __syncthreads();
  grid.sync();  // the ring is zero everywhere

  // check runs: block 0's thread 0 reads the SM clock at the step's start
  // and at the end of every phase and barrier (index 4 L + 4 a step)
  const int nst = 4 * p.L + 4;
  auto stamp = [&](int t, int k) {
    if (p.stamps && blk == 0 && threadIdx.x == 0 && t < p.stamp_steps)
      p.stamps[(size_t)t * nst + k] = clock64();
  };
  for (int t = 0; t < p.T; ++t) {
    stamp(t, 0);
    for (int l = 0; l < p.L; ++l) {
      const W* wl;
      if (l < p.nres) {
        wl = wres + (size_t)l * slice;
      } else {
        // the next streamed layer's copy goes out now, into the buffer that
        // the previous streamed layer read before its barriers
        const int next = l + 1 < p.L ? l + 1 : p.nres;
        load_layer(next, wbuf + (size_t)((streamed + 1) & 1) * slice);
        cp_async_commit();
        cp_async_wait<1>();  // this layer's copy has landed, the next may be in flight
        __syncthreads();
        wl = wbuf + (size_t)(streamed & 1) * slice;
        ++streamed;
      }
      const float* cl = consts + (size_t)l * per;
      phase_in<W, A>(p, t, l, wl, cl, me, xsamp, reinterpret_cast<A*>(stage), part);
      stamp(t, 4 * l + 1);
      grid.sync();  // (a) gated is whole; every block has staged slot x_{t-2d}
      stamp(t, 4 * l + 2);
      phase_out<W, A, F>(p, t, l, wl, cl, me, own, reinterpret_cast<A*>(stage));
      stamp(t, 4 * l + 3);
      grid.sync();  // (b) h (or, after the last layer, the skip sum) is whole
      stamp(t, 4 * l + 4);
    }
    phase_final1<F>(p, wf1, me, reinterpret_cast<F*>(stage));
    stamp(t, 4 * p.L + 1);
    grid.sync();  // fin is whole
    stamp(t, 4 * p.L + 2);
    phase_head(p, t, me, reinterpret_cast<float*>(stage), xsamp, own);
    stamp(t, 4 * p.L + 3);
  }
  cp_async_wait<0>();
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

template <typename W, typename A, typename F>
int launch(const Params& p, long long smem, cudaStream_t stream) {
  const Layout lo = layout_of<W, A, F>(p);
  if ((long long)lo.total != smem || smem + kStaticReserve > kMaxSmem)
    return (int)cudaErrorInvalidValue;  // the caller's plan is not this kernel's
  const void* kern = (const void*)wavenet_persistent<W, A, F>;
  cudaFuncAttributes fa;
  DVC_CHECK(cudaFuncGetAttributes(&fa, kern));
  if (fa.sharedSizeBytes > (size_t)kStaticReserve) return (int)cudaErrorInvalidValue;
  DVC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  int dev = 0, sms = 0, per_sm = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, (size_t)smem));
  if ((long long)per_sm * sms < p.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params arg = p;
  void* args[] = {&arg};
  DVC_CHECK(cudaLaunchCooperativeKernel(kern, dim3(p.blocks), dim3(kThreads), args, (size_t)smem,
                                        stream));
  return (int)cudaGetLastError();
}

uint2 key_of(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
}

}  // namespace

extern "C" {

// Weight type codes: 0 = float32, 1 = bfloat16, 2 = int8 (layer weights
// only, with float32 scales s_in (L, 4, G) and s_so (L, S + R); activations
// and ring in bf16).  w_dtype / f1_dtype pairs: (0, 0), (1, 1), (2, 0), (2, 1).
// The block plan (blocks, pairs, rows, cols, tile, nres, smem) comes from the
// Python wrapper's block_plan; smem must equal the kernel's own layout.
// Pointers are 16-byte aligned device pointers except dil (host, L ints);
// draws and stamps (check runs) may be null.  Returns 0 or the first cudaError_t.
int dvc_wavenet_generate(int w_dtype, int f1_dtype, int B, int T, int L, int R, int Rs, int G,
                         int G2p, int S, int C, int KIp, int K, const int* dil, int legacy,
                         float log_scale_min, unsigned long long seed, int deterministic,
                         int blocks, int pairs, int rows, int cols, int tile, int nres,
                         long long smem, const void* w_in, const void* s_in, const void* b_in,
                         const void* w_so, const void* s_so, const void* b_so,
                         const void* w_first, const void* b_first, const void* w_f1,
                         const void* b_f1, const void* w_f2, const void* b_f2, const void* cond,
                         void* ring, void* h, void* skip, void* gated, void* fin, void* out,
                         void* draws, void* stamps, int stamp_steps, void* stream) {
  const int vec = w_dtype == 0 ? 4 : w_dtype == 1 ? 8 : 16;  // weights per 16 bytes
  const bool int8 = w_dtype == 2;
  const int G2 = G / 2;
  if (f1_dtype < 0 || f1_dtype > 1 || B <= 0 || T < 0 || L <= 0 || L > kMaxLayers || K <= 0 ||
      K % 3 != 0 || G % 2 != 0 || G2 % 8 != 0 || S % 8 != 0 || R % 8 != 0 || C % 4 != 0 ||
      KIp % vec != 0 || G2p % vec != 0 || G2p < G2 || Rs < R || KIp < 3 * Rs + C ||
      (int8 && (Rs % vec != 0 || !s_in || !s_so)) || blocks <= 0 ||
      (pairs != 1 && pairs != 2 && pairs != 4) || rows <= 0 || cols <= 0 ||
      (long long)blocks * pairs < G2 || (long long)blocks * rows < S + R ||
      (long long)blocks * cols < S || tile <= 0 || tile > kMaxTile || nres < 0 || nres > L)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B;
  p.T = T;
  p.L = L;
  p.R = R;
  p.Rs = Rs;
  p.G2 = G2;
  p.G2p = G2p;
  p.S = S;
  p.C = C;
  p.KIp = KIp;
  p.K = K;
  p.blocks = blocks;
  p.pairs = pairs;
  p.rows = rows;
  p.cols = cols;
  p.tile = tile;
  p.nres = nres;
  p.legacy = legacy;
  p.deterministic = deterministic;
  p.log_scale_min = log_scale_min;
  p.key = key_of(seed);
  int slots = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] <= 0) return (int)cudaErrorInvalidValue;
    p.dil[l] = dil[l];
    p.offs[l] = slots;
    slots += 2 * dil[l];
  }
  p.slots = slots;
  p.w_in = w_in;
  p.s_in = static_cast<const float*>(s_in);
  p.b_in = static_cast<const float*>(b_in);
  p.w_so = w_so;
  p.s_so = static_cast<const float*>(s_so);
  p.b_so = static_cast<const float*>(b_so);
  p.w_first = static_cast<const float*>(w_first);
  p.b_first = static_cast<const float*>(b_first);
  p.w_f1 = w_f1;
  p.b_f1 = static_cast<const float*>(b_f1);
  p.w_f2 = static_cast<const float*>(w_f2);
  p.b_f2 = static_cast<const float*>(b_f2);
  p.cond = static_cast<const float*>(cond);
  p.ring = ring;
  p.h = h;
  p.skip = skip;
  p.gated = gated;
  p.fin = static_cast<float*>(fin);
  p.out = static_cast<float*>(out);
  p.draws = static_cast<float*>(draws);
  p.stamps = static_cast<long long*>(stamps);
  p.stamp_steps = stamps ? stamp_steps : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  switch (w_dtype * 2 + f1_dtype) {  // f1_dtype is 0 or 1
    case 0:  // (0, 0)
      return launch<float, float, float>(p, smem, st);
    case 3:  // (1, 1)
      return launch<bf16, bf16, bf16>(p, smem, st);
    case 4:  // (2, 0)
      return launch<int8_t, bf16, float>(p, smem, st);
    case 5:  // (2, 1)
      return launch<int8_t, bf16, bf16>(p, smem, st);
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
