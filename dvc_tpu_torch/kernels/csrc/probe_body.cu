// WaveNet layer-body probes (P2, P3, P4) on Hopper: the 6-matmul layer body
// of the AR WaveNet kernel run over T samples of L layers, with bf16 weights
// and ring, float32 accumulation and a float32 h.
//
// Replaces the TPU kernels of tools/bench_body.py and tools/bench_body2.py:
//   P2 `make_resident` (bench_body.py:52-102, pl.pallas_call at :95): grid
//      (T,), all weights resident; cond = bf16(h[:, :C]) taken ONCE per step,
//      from the h the step starts with (:67);
//   P3 `make_streamed` (bench_body.py:105-172, call at :165): grid (T, L),
//      one layer's weights per grid step; cond = bf16(h[:, :C]) taken at
//      EVERY layer from the current h (:124), so a different function;
//   P4 `make(stage)` (bench_body2.py:29-129, call at :123): the resident body
//      with production features added by stage: 1 streams cond from
//      cond_in (T, B, C); 2 writes (T, B), batch row 0's first B channels of
//      h after each step (:96-97); 3 rebuilds h every step from the fed-back
//      sample, h = x * w_first, after the head relu -> final1 (bf16) -> relu
//      -> final2 column 0 (float32) -> clip (:57-58, :87-93); 4 adds the
//      per-layer bias (:77-78), which stages 0-3 do not have.  P4 sums the
//      skips as skip = s, then (skip + s) * 0.7071 (:85); P2 and P3 as
//      skip = s, then skip + s.
// The body (bench_body.py:38-49): conv = x_{t-2d} @ W0 + x_{t-d} @ W1 +
// bf16(h) @ W2 + cond @ Wc (+ b); gated = bf16(tanh(conv[:G/2]) *
// sigmoid(conv[G/2:])); s = gated @ w_skip; h = (gated @ w_out + h) * 0.7071,
// the layer input h going into the ring slot of x_{t-2d} as bf16.  The TPU
// kernels compute the skip sum and never output it; here it is an output, so
// that the skip product can be checked.
//
// What bounds it on an H100.  Per sample step 24 x B x (3 x 512 x 512 +
// 80 x 512 + 256 x 256 + 256 x 512) = 196.6 M multiply-adds at B = 8: 0.40 ms
// at the bf16 tensor-core peak over the probes' 1000 steps.  A kernel that
// keeps no weight on chip also streams all 24 layers' weights, 49.15 MB of
// bf16, every step: 14.7 us a step at 3.35 TB/s.  The TPU kept them resident
// in VMEM; the 132 SMs have about 30 MB of shared memory between them, so
// here "resident" reads them from device memory (and the 50 MB L2) each step.
//
// Design.  Weights are packed output-major by the wrapper: w_in (L, G, KIp)
// rows [W0[:, j] | W1[:, j] | W2[:, j] | Wc[:, j] | 0], w_so (L, S + R, G/2)
// rows [w_skip[:, s] ; w_out[:, r]], w_f1 (S, S) row o = w_f1[:, o], so a
// thread reads 16-byte vectors of one contiguous row.  The grid is one block
// an SM (132 on an H100, 256 threads).  A layer is two phases:
//   in   per gate-column pair (j, j + G/2), one block: the block stages the
//        inputs [x_{t-2d} | x_{t-d} | bf16(h) | bf16(cond)] of all B rows in
//        shared memory and its threads split the two rows' dots; it writes
//        the bf16-rounded gate value gated[b][j];
//   out  per skip/out column, one warp: the dot with the staged gated, the
//        skip update, and for an out column r the ring write of the layer
//        input h[b][r] and h[b][r] = (res + h) * 0.7071 in place.
// Each phase is a chain of dependent memory round trips, so each phase first
// issues the loads that need nothing staged (its weight vectors and biases,
// the old h and skip of its outputs), then stages its inputs with all of a
// lane's 16-byte loads in flight, then computes; each batch row's epilogue
// runs on its own lane.
// P2 and P4 are ONE cooperative launch that loops over (t, l) inside the
// kernel; a grid barrier follows each phase: (a) after `in`, because the out
// columns need all of gated, and so that every block has staged slot x_{t-2d}
// before `out` overwrites it; (b) after `out`, because the next layer reads
// all of h.  The head of P4 stage 3 adds two phases per step (final1 by
// columns; then every block computes the B samples and writes its share of
// the next h), each with its barrier.  cudaLaunchCooperativeKernel refuses a
// grid that cannot be co-resident instead of hanging.  P3 runs the same two
// phases on the same grid as two kernel launches per layer, from a host loop
// in C: the gap between P2 and P3 is the price of a launch against a grid
// barrier.  The step-start
// cond of P2 and P4 stage 0 is a snapshot of h[:, :C] that block 0 writes
// while the first layer reads h itself.  Data written inside the kernel is
// read with ld.global.cg (L2, coherent across SMs); the weights through the
// read-only path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;       // batch rows per pass through a weight row
constexpr int kStage = 9;         // 16-byte loads in flight per lane while staging: a batch
                                  // row of 276 chunks (R = 512, C = 80) in one round trip
constexpr int kBlocksPerSm = 1;   // grid: one block an SM (132 on an H100)
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory a block
constexpr float kHalf = 0.7071f;  // the probes' literal, not sqrt(1/2)

enum CondRule { kCondStep = 0, kCondLayer = 1, kCondInput = 2 };

struct Body {
  int B, T, L, R, G, S, C, KIp;
  int cond_rule, bias, scaled_skip, row_out, head;
  int dil[kMaxLayers], offs[kMaxLayers];
  const __nv_bfloat16* w_in;  // (L, G, KIp)
  const __nv_bfloat16* w_so;  // (L, S + R, G/2)
  const float* b;             // (L, G)
  const float* cond_in;       // (T, B, C), cond rule kCondInput
  const float* w_first;       // (R,), head
  const __nv_bfloat16* w_f1;  // (S, S) output-major, head
  const float* w_f2;          // (S,): column 0 of final2, head
  uint16_t* ring;             // (slots, B, R) bf16 bits, zeroed by the host
  float* h;                   // (B, R)
  float* skip;                // (B, S)
  float* gated;               // (B, G/2), bf16-rounded
  float* cond;                // (B, C): h[:, :C] at the step's start
  float* o1;                  // (B, S): relu(final1), head
  float* out;                 // (T, B) with row_out
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// round to nearest even, as jnp .astype(bfloat16) and torch .to(bfloat16)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack_bf16(const uint4& r, float* w) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The 16-byte weight vector `first` of each of NR rows, loaded ahead (before
// a phase stages its inputs) so that its latency overlaps the staging; zeros
// past the row's end
template <int NR>
__device__ __forceinline__ void prefetch(const __nv_bfloat16* const (&w)[NR], int n, int first,
                                         uint4 (&pre)[NR]) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
    pre[r] = first < n / 8 ? __ldg(reinterpret_cast<const uint4*>(w[r]) + first)
                           : make_uint4(0u, 0u, 0u, 0u);
}

// acc[r][bb] += this thread's share of dot(w[r], xs[bb]) over the 8-element
// vectors first, first + stride, ... of rows of n (a multiple of 8) bf16
// weights; xs holds nb <= kRowTile rows of n floats.  The caller sums shares.
// With use_pre, pre holds vector `first` of each row (see prefetch).
template <int NR>
__device__ __forceinline__ void dots(const __nv_bfloat16* const (&w)[NR], const float* xs, int n,
                                     int nb, int first, int stride,
                                     float (&acc)[NR][kRowTile], const uint4 (&pre)[NR],
                                     bool use_pre) {
  const int nv = n / 8;
  for (int v = first; v < nv; v += stride) {
    float wv[NR][8];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      unpack_bf16(use_pre && v == first ? pre[r]
                                        : __ldg(reinterpret_cast<const uint4*>(w[r]) + v),
                  wv[r]);
#pragma unroll
    for (int bb = 0; bb < kRowTile; ++bb) {
      if (bb < nb) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + bb * n + v * 8);
        const float4 lo = x4[0], hi = x4[1];  // 16-byte shared loads: fewer bank conflicts
        const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[r][bb] = fmaf(wv[r][e], x[e], acc[r][bb]);
        }
      }
    }
  }
}

__device__ __forceinline__ float4 round4(uint4 v) {
  return make_float4(round_bf16(__uint_as_float(v.x)), round_bf16(__uint_as_float(v.y)),
                     round_bf16(__uint_as_float(v.z)), round_bf16(__uint_as_float(v.w)));
}

// xs (B, KIp) = [x_{t-2d} | x_{t-d} | bf16(h) | bf16(cond) | 0] as floats.
// Warp w copies batch rows w, w + kWarps, ... in 16-byte chunks (8 bf16 of
// the ring, 4 floats of h or cond), a lane's kStage loads all issued before
// the first is stored: one round trip to L2 per kStage chunks instead of
// one per element.
__device__ void stage_in(const Body& p, const uint16_t* x2, const uint16_t* x1, const float* csrc,
                         int cstride, float* xs) {
  const int R = p.R, C = p.C, KIp = p.KIp;
  const int r8 = R / 8, r4 = R / 4, nrow = 2 * r8 + r4 + C / 4;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < p.B; b += kWarps) {
    float* row = xs + (size_t)b * KIp;
    const uint4* s2 = reinterpret_cast<const uint4*>(x2 + (size_t)b * R);
    const uint4* s1 = reinterpret_cast<const uint4*>(x1 + (size_t)b * R);
    const uint4* sh = reinterpret_cast<const uint4*>(p.h + (size_t)b * R);
    const uint4* sc = reinterpret_cast<const uint4*>(csrc + (size_t)b * cstride);
    for (int q0 = lane; q0 < nrow; q0 += 32 * kStage) {
      uint4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + 32 * u;
        if (q < nrow)
          v[u] = __ldcg(q < r8               ? s2 + q
                        : q < 2 * r8         ? s1 + (q - r8)
                        : q < 2 * r8 + r4    ? sh + (q - 2 * r8)
                                             : sc + (q - 2 * r8 - r4));
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int q = q0 + 32 * u;
        if (q < 2 * r8) {  // x_{t-2d} at [0, R), x_{t-d} at [R, 2R)
          float f[8];
          unpack_bf16(v[u], f);
          float4* d = reinterpret_cast<float4*>(row + q * 8);
          d[0] = make_float4(f[0], f[1], f[2], f[3]);
          d[1] = make_float4(f[4], f[5], f[6], f[7]);
        } else if (q < nrow) {  // h at [2R, 3R), cond at [3R, 3R + C)
          const int k = q < 2 * r8 + r4 ? 2 * R + (q - 2 * r8) * 4 : 3 * R + (q - 2 * r8 - r4) * 4;
          *reinterpret_cast<float4*>(row + k) = round4(v[u]);
        }
      }
    }
    for (int k = 3 * R + C + lane; k < KIp; k += 32) row[k] = 0.f;
  }
}

// dst[i] = f(src[i]) for n floats (n % 4 == 0) in 16-byte chunks, kStage
// loads in flight per thread; f is the identity or relu and a bf16 rounding
__device__ void stage_f32(float* dst, const float* src, int n, bool relu_round) {
  const int n4 = n / 4;
  for (int c0 = threadIdx.x; c0 < n4; c0 += kStage * blockDim.x) {
    uint4 v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < n4) v[u] = __ldcg(reinterpret_cast<const uint4*>(src) + c);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < n4) {
        if (relu_round) {
          const uint4 r = v[u];
          v[u] = make_uint4(__float_as_uint(fmaxf(__uint_as_float(r.x), 0.f)),
                            __float_as_uint(fmaxf(__uint_as_float(r.y), 0.f)),
                            __float_as_uint(fmaxf(__uint_as_float(r.z), 0.f)),
                            __float_as_uint(fmaxf(__uint_as_float(r.w), 0.f)));
          reinterpret_cast<float4*>(dst)[c] = round4(v[u]);
        } else {
          reinterpret_cast<uint4*>(dst)[c] = v[u];
        }
      }
    }
  }
}

__device__ __forceinline__ void slots_of(const Body& p, int t, int l, int* s2, int* s1) {
  const int d = p.dil[l], wp = t % (2 * d);
  *s2 = p.offs[l] + wp;
  *s1 = p.offs[l] + (wp + d) % (2 * d);
}

// phase `in`: gated[b][j] for the gate pairs j = blockIdx.x, + gridDim.x, ...
__device__ void phase_in(const Body& p, int t, int l, float* xs) {
  __shared__ float part[kWarps][2][kRowTile];
  const int B = p.B, R = p.R, C = p.C, KIp = p.KIp, G2 = p.G / 2;
  const size_t hsz = (size_t)B * R;
  int s2, s1;
  slots_of(p, t, l, &s2, &s1);
  const float* csrc = p.cond;  // the step-start snapshot
  int cstride = C;
  if (p.cond_rule == kCondInput) {
    csrc = p.cond_in + (size_t)t * B * C;
  } else if (p.cond_rule == kCondLayer || l == 0) {
    csrc = p.h;
    cstride = R;
  }
  if (p.cond_rule == kCondStep && l == 0 && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < B * C; i += blockDim.x) {
      const int b = i / C, c = i - b * C;
      p.cond[i] = __ldcg(p.h + (size_t)b * R + c);
    }
  }
  const __nv_bfloat16* base = p.w_in + (size_t)l * p.G * KIp;
  // the weights and biases of this block's first two gate pairs (256 pairs
  // on 132 blocks), loaded before the staging so that their latency overlaps it
  uint4 pre0[2] = {}, pre1[2] = {};
  float bias0[2] = {}, bias1[2] = {};
  auto load_pair = [&](int j, uint4 (&pre)[2], float (&bias)[2]) {
    if (j < G2) {
      const __nv_bfloat16* const rows[2] = {base + (size_t)j * KIp, base + (size_t)(j + G2) * KIp};
      prefetch<2>(rows, KIp, threadIdx.x, pre);
      if (p.bias && threadIdx.x < kRowTile) {
        bias[0] = p.b[(size_t)l * p.G + j];
        bias[1] = p.b[(size_t)l * p.G + j + G2];
      }
    }
  };
  load_pair(blockIdx.x, pre0, bias0);
  load_pair(blockIdx.x + gridDim.x, pre1, bias1);
  stage_in(p, p.ring + (size_t)s2 * hsz, p.ring + (size_t)s1 * hsz, csrc, cstride, xs);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = blockIdx.x, k = 0; j < G2; j += gridDim.x, ++k) {
    const __nv_bfloat16* const rows[2] = {base + (size_t)j * KIp, base + (size_t)(j + G2) * KIp};
    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = min(kRowTile, B - b0);
      float acc[2][kRowTile] = {};
      if (k == 1)
        dots<2>(rows, xs + (size_t)b0 * KIp, KIp, nb, threadIdx.x, blockDim.x, acc, pre1, true);
      else
        dots<2>(rows, xs + (size_t)b0 * KIp, KIp, nb, threadIdx.x, blockDim.x, acc, pre0, k == 0);
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
        float pa = 0.f, pg = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          pa += part[w][0][bb];
          pg += part[w][1][bb];
        }
        if (p.bias) {
          pa += k == 0 ? bias0[0] : k == 1 ? bias1[0] : p.b[(size_t)l * p.G + j];
          pg += k == 0 ? bias0[1] : k == 1 ? bias1[1] : p.b[(size_t)l * p.G + j + G2];
        }
        p.gated[(size_t)(b0 + bb) * G2 + j] = round_bf16(tanhf(pa) * (1.f / (1.f + expf(-pg))));
      }
      __syncthreads();  // part is reused
    }
  }
}

// phase `out`: skip and out columns o, one warp each, over the grid's warps
__device__ void phase_out(const Body& p, int t, int l, float* gs) {
  const int B = p.B, R = p.R, S = p.S, G2 = p.G / 2;
  const size_t hsz = (size_t)B * R;
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kWarps;
  const int o0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const __nv_bfloat16* base = p.w_so + (size_t)l * (S + R) * G2;
  uint4 pre[1] = {};
  float pre_old = 0.f;  // the first column's skip or h of batch row `lane`
  if (o0 < S + R) {
    const __nv_bfloat16* const rows[1] = {base + (size_t)o0 * G2};
    prefetch<1>(rows, G2, lane, pre);
    if (lane < min(kRowTile, B))
      pre_old = o0 < S ? (l == 0 ? 0.f : __ldcg(p.skip + (size_t)lane * S + o0))
                       : __ldcg(p.h + (size_t)lane * R + o0 - S);
  }
  stage_f32(gs, p.gated, B * G2, false);
  __syncthreads();
  int s2, s1;
  slots_of(p, t, l, &s2, &s1);
  uint16_t* ring_w = p.ring + (size_t)s2 * hsz;
  for (int o = o0; o < S + R; o += nwarps) {
    const __nv_bfloat16* const rows[1] = {base + (size_t)o * G2};
    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = min(kRowTile, B - b0);
      float acc[1][kRowTile] = {};
      dots<1>(rows, gs + (size_t)b0 * G2, G2, nb, lane, 32, acc, pre, o == o0);
      float v = 0.f;  // lane bb keeps batch row bb's dot, so the rows' epilogues run in parallel
#pragma unroll
      for (int bb = 0; bb < kRowTile; ++bb) {
        const float sum = warp_sum(acc[0][bb]);
        if (lane == bb) v = sum;
      }
      if (lane < nb) {
        const int b = b0 + lane;
        const bool first = o == o0 && b0 == 0;
        if (o < S) {
          float* sp = p.skip + (size_t)b * S + o;
          const float old = first ? pre_old : l == 0 ? 0.f : __ldcg(sp);
          *sp = l == 0 ? v : p.scaled_skip ? (old + v) * kHalf : old + v;
        } else {
          const int r = o - S;
          const size_t e = (size_t)b * R + r;
          const float hv = first ? pre_old : __ldcg(p.h + e);
          ring_w[e] = __bfloat16_as_ushort(__float2bfloat16_rn(hv));
          const float nh = (v + hv) * kHalf;
          p.h[e] = nh;
          if (p.row_out && l == p.L - 1 && b == 0 && r < B) p.out[(size_t)t * B + r] = nh;
        }
      }
    }
  }
}

// head, part 1: o1 = relu(bf16(relu(skip)) @ w_f1), one warp per column
__device__ void phase_final1(const Body& p, float* os) {
  const int B = p.B, S = p.S;
  stage_f32(os, p.skip, B * S, true);
  __syncthreads();
  const uint4 none[1] = {};
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kWarps;
  for (int o = blockIdx.x * kWarps + (threadIdx.x >> 5); o < S; o += nwarps) {
    const __nv_bfloat16* const rows[1] = {p.w_f1 + (size_t)o * S};
    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = min(kRowTile, B - b0);
      float acc[1][kRowTile] = {};
      dots<1>(rows, os + (size_t)b0 * S, S, nb, lane, 32, acc, none, false);
      float v = 0.f;
#pragma unroll
      for (int bb = 0; bb < kRowTile; ++bb) {
        const float sum = warp_sum(acc[0][bb]);
        if (lane == bb) v = sum;
      }
      if (lane < nb) p.o1[(size_t)(b0 + lane) * S + o] = fmaxf(v, 0.f);
    }
  }
}

// head, part 2, in every block alike: x[b] = clip(o1[b] @ w_f2[:, 0], -1, 1),
// then this block's share of the next step's h = x * w_first
__device__ void phase_sample(const Body& p, float* xs) {
  const int B = p.B, S = p.S, R = p.R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float acc = 0.f;
    for (int k = lane; k < S; k += 32) acc = fmaf(__ldcg(p.o1 + (size_t)b * S + k), p.w_f2[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) xs[b] = fminf(fmaxf(acc, -1.f), 1.f);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)B * R;
       i += (size_t)gridDim.x * blockDim.x)
    p.h[i] = xs[i / R] * p.w_first[i % R];
}

__global__ void __launch_bounds__(kThreads) body_persistent(Body p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  for (int t = 0; t < p.T; ++t) {
    for (int l = 0; l < p.L; ++l) {
      phase_in(p, t, l, sm);
      grid.sync();  // (a) gated is whole; slot x_{t-2d} has been staged by all
      phase_out(p, t, l, sm);
      grid.sync();  // (b) h is whole
    }
    if (p.head) {
      phase_final1(p, sm);
      grid.sync();
      phase_sample(p, sm);
      grid.sync();
    }
  }
}

__global__ void __launch_bounds__(kThreads) body_in(Body p, int t, int l) {
  extern __shared__ float sm[];
  phase_in(p, t, l, sm);
}

__global__ void __launch_bounds__(kThreads) body_out(Body p, int t, int l) {
  extern __shared__ float sm[];
  phase_out(p, t, l, sm);
}

__global__ void fill_kernel(float* x, size_t n, float v) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = v;
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" {

// persistent = 1: one cooperative launch (P2, P4); 0: two launches per layer
// from a host loop (P3; no head).  cond_rule 0: bf16(h[:, :C]) at the step's
// start; 1: at every layer; 2: cond_in[t].  dil: host array of L dilations
// (offsets are the running sum of 2d); slots >= sum 2d is the ring's length.
// Buffers are device pointers: w_in (L, G, KIp), w_so (L, S + R, G/2) and
// w_f1 (S, S) bf16; b (L, G), cond_in (T, B, C), w_first (R,) and w_f2 (S,)
// float32 (those a flag does not use may be null); ring (slots, B, R) bf16;
// h (B, R) (the output when row_out is 0), skip (B, S), gated (B, G/2),
// cond (B, C), o1 (B, S) and out (T, B) float32.  Returns 0 or the first
// cudaError_t.
int dvc_probe_body(int persistent, int cond_rule, int bias, int scaled_skip, int row_out,
                   int head, int B, int T, int L, int R, int G, int S, int C, int KIp,
                   const int* dil, int slots, const void* w_in, const void* w_so,
                   const void* b, const void* cond_in, const void* w_first, const void* w_f1,
                   const void* w_f2, void* ring, void* h, void* skip, void* gated, void* cond,
                   void* o1, void* out, void* stream) {
  const int G2 = G / 2;
  if (B <= 0 || T < 0 || L <= 0 || L > kMaxLayers || R <= 0 || G <= 0 || G % 2 || S <= 0 ||
      C < 0 || C > R || R % 8 || C % 4 || KIp % 8 || KIp < 3 * R + C || G2 % 8 || S % 8 ||
      cond_rule < 0 || cond_rule > 2 || (row_out && B > R) || (head && !persistent) ||
      (cond_rule == kCondInput && !cond_in) || (bias && !b) ||
      (head && (!w_first || !w_f1 || !w_f2)) || (row_out && !out))
    return (int)cudaErrorInvalidValue;
  Body p{};
  p.B = B;
  p.T = T;
  p.L = L;
  p.R = R;
  p.G = G;
  p.S = S;
  p.C = C;
  p.KIp = KIp;
  p.cond_rule = cond_rule;
  p.bias = bias;
  p.scaled_skip = scaled_skip;
  p.row_out = row_out;
  p.head = head;
  int need = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] <= 0) return (int)cudaErrorInvalidValue;
    p.dil[l] = dil[l];
    p.offs[l] = need;
    need += 2 * dil[l];
  }
  if (slots < need) return (int)cudaErrorInvalidValue;
  p.w_in = static_cast<const __nv_bfloat16*>(w_in);
  p.w_so = static_cast<const __nv_bfloat16*>(w_so);
  p.b = static_cast<const float*>(b);
  p.cond_in = static_cast<const float*>(cond_in);
  p.w_first = static_cast<const float*>(w_first);
  p.w_f1 = static_cast<const __nv_bfloat16*>(w_f1);
  p.w_f2 = static_cast<const float*>(w_f2);
  p.ring = static_cast<uint16_t*>(ring);
  p.h = static_cast<float*>(h);
  p.skip = static_cast<float*>(skip);
  p.gated = static_cast<float*>(gated);
  p.cond = static_cast<float*>(cond);
  p.o1 = static_cast<float*>(o1);
  p.out = static_cast<float*>(out);

  const size_t smem_in = (size_t)B * KIp * sizeof(float);
  const size_t smem_out = (size_t)B * G2 * sizeof(float);
  const size_t smem_head = ((size_t)B * S + B) * sizeof(float);
  size_t smem = smem_in > smem_out ? smem_in : smem_out;
  smem = smem > smem_head ? smem : smem_head;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;

  const cudaStream_t st = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * R;
  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * hsz * sizeof(uint16_t), st));
  // the probes' h at t = 0: ones, or first_conv of the sample 0 when the head
  // feeds the sample back (x * w_first with x = 0)
  fill_kernel<<<(unsigned)((hsz + 255) / 256), 256, 0, st>>>(p.h, hsz, head ? 0.f : 1.f);
  DVC_CHECK(cudaGetLastError());

  // one grid for both schedules: at most one block a gate pair
  int dev = 0, sms = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int nblk = sms * kBlocksPerSm < G2 ? sms * kBlocksPerSm : G2;
  if (persistent) {
    int per_sm = 0;
    DVC_CHECK(cudaFuncSetAttribute(body_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
    DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, body_persistent, kThreads,
                                                            smem));
    if (per_sm < kBlocksPerSm) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&p};
    DVC_CHECK(cudaLaunchCooperativeKernel((const void*)body_persistent, dim3(nblk),
                                          dim3(kThreads), args, smem, st));
    return (int)cudaGetLastError();
  }
  DVC_CHECK(cudaFuncSetAttribute(body_in, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_in));
  DVC_CHECK(cudaFuncSetAttribute(body_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_out));
  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      body_in<<<nblk, kThreads, smem_in, st>>>(p, t, l);
      DVC_CHECK(cudaGetLastError());
      body_out<<<nblk, kThreads, smem_out, st>>>(p, t, l);
      DVC_CHECK(cudaGetLastError());
    }
  }
  return 0;
}

const char* dvc_probe_body_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
