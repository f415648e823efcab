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
// at the bf16 tensor-core peak over the probes' 1000 steps.  The weights are
// 49.15 MB of bf16; the 132 SMs have about 30 MB of shared memory between
// them, so not all of them can stay on chip.  In practice a step is a chain
// of 2L dependent phases, each ended by an exchange across the whole grid.
//
// P2 and P4: body_mma.  What held the first design (body_persistent:
// cooperative_groups grid syncs, float32 FMAs) back, by tools/ablate_body at
// T = 200, B = 8 on an NVIDIA H100 80GB HBM3 at 700 W: 237.54 us a step;
// its 48 grid barriers alone 54.73 (1.14 us each); phase `in` 5.9 us a
// layer and `out` 2.6, both chains of dependent L2 round trips: each of 132
// blocks staged all 26 KB of [x_{t-2d} | x_{t-d} | bf16(h) | cond] of all
// rows as floats every layer (51 us a step by "staging nothing"), read its
// weights from L2 or device memory every step, none resident (42 us by "no
// weight loads"), and summed its dots as float32 FMAs with cross-warp sums.
// What this design does about each:
//   * the dots on the tensor cores: mma.sync.m16n8k16 bf16 -> float32, the
//     weight rows as the A operand, the batch as the n = 8 side (B > 8 loops
//     over n-tiles; rows past B are zero), each warp's k-steps in two
//     independent chains.  A block's tile has fewer than 16 rows (4, 6 and
//     2 below), so the A fragments' rows 8-15 are zero registers and never
//     stored.  The pack (bench_body.frag_pack) is laid out in mma's A
//     fragment order: a lane reads its 8 bytes of a k-step with one
//     conflict-free shared load, no ldmatrix and no shuffles;
//   * weights resident as far as they fit: each block's rows of a layer are
//     one contiguous 16,000-byte run of the pack, brought by one TMA bulk
//     copy (cp.async.bulk + mbarrier complete_tx): the leading `nres`
//     layers once a call (10 of 24 at B <= 8, 8 at B <= 16), the rest
//     streamed into two slots, each refilled as soon as its layer's dots
//     are done, a layer ahead of its use;
//   * staging: a layer's ring taps do not depend on the layer before, so
//     their copy (cp.async) is issued in the wait of barrier (a) of the
//     layer before and their dots (64 of phase `in`'s 101 k-steps) run in
//     the wait of its barrier (b); after (b) a block stages only bf16(h)
//     and cond (9.5 KB at B = 8; h is published as bf16 by its owners, so
//     no consumer converts), and the gate's biases are loaded before it;
//   * the barriers: a release/acquire arrival count in device memory in
//     place of cooperative_groups' grid sync (0.99 us against 1.13 in a
//     loop of barriers alone on 128 blocks, tools/bench_sync), handled by a
//     ninth warp: the compute warps signal their arrival through a named
//     barrier and go on (to the taps), the sync warp does the release's
//     fence, the atomic and the polling, and lets them through a second
//     named barrier.  Still two exchanges a layer, the same count as before.
// Departure from the plan of clusters with TMA multicast staging: on the
// H100 cudaOccupancyMaxActiveClusters reads 15 clusters of 8 (30 of 4) at
// one block an SM, fewer than the 16 x 8 = 128 blocks of a layer split
// across clusters, and a cluster barrier costs 0.44-0.61 us at 2-8 CTAs,
// half a grid barrier, which a split of a phase's dots across a cluster
// would add to each phase (tools/bench_sync).  A second departure was tried
// and dropped: publishing h and gated as 32-bit words tagged with their
// layer, so that a consumer's staging load is its wait and no grid barrier
// is left, ran slower than this design, its exchange alone slower than two
// counted barriers: every thread of every block polled its own words.  The
// grid is 128 blocks of 288
// threads, one an SM (cudaLaunchCooperativeKernel refuses a grid that
// cannot be co-resident instead of hanging), and block i owns:
//   in   gate pairs (j, j + G/2) for j in [2i, 2i + 2): a 4-row tile over
//        K = [x_{t-2d} | x_{t-d}] (64 k-steps, the taps) and [h | cond]
//        (37 k-steps); the gate into bf16 `gb`;            grid barrier (a)
//   out  skip rows [2i, 2i + 2) and channels [4i, 4i + 4) of h, over K =
//        gated (16 k-steps): the skip sums and the layer inputs h of its
//        rows live in its shared memory for the whole call; it writes the
//        ring slot x_{t-2d} of its channels (every block staged it before
//        (a)), publishes bf16(h) and, after a step's last layer, the cond
//        snapshot (P2's rule) or bf16(relu(skip)) (the head);
//                                                          grid barrier (b)
//   head final1 rows [2i, 2i + 2) (16 k-steps) into o1;    grid barrier
//        then every block computes x = clip(o1 @ w_f2[:, 0]) for every row
//        itself and stages h = x * w_first of the next step's first layer
//        from it, so the head adds one barrier a step, not two.
// Every wait traps after kSpinLimit polls instead of hanging.  Data written
// inside the kernel is read with ld.global.cg or cp.async.cg (L2, coherent
// across SMs); the weights arrive by the TMA, read-only.  Where the time
// went at the end (tools/ablate_body, same card): 146 us a step; us a
// layer: phase `in` 2.0, `out` 1.1, a grid barrier 1.5, staging 1.8,
// weights 0.5.
//
// P3 keeps the first design: body_in and body_out, two launches per layer
// from a host loop in C, on the output-major pack (bench_body.pack): w_in
// (L, G, KIp) rows [W0[:, j] | W1[:, j] | W2[:, j] | Wc[:, j] | 0], w_so
// (L, S + R, G/2) rows [w_skip[:, s] ; w_out[:, r]].  A layer is two phases:
//   in   per gate-column pair (j, j + G/2), one block: the block stages the
//        inputs [x_{t-2d} | x_{t-d} | bf16(h) | bf16(cond)] of all B rows in
//        shared memory and its threads split the two rows' dots; it writes
//        the bf16-rounded gate value gated[b][j];
//   out  per skip/out column, one warp: the dot with the staged gated, the
//        skip update, and for an out column r the ring write of the layer
//        input h[b][r] and h[b][r] = (res + h) * 0.7071 in place.
// Each phase first issues the loads that need nothing staged (its weight
// vectors and biases, the old h and skip of its outputs), then stages its
// inputs with all of a lane's 16-byte loads in flight, then computes; each
// batch row's epilogue runs on its own lane.  Against the first design's P2
// (the same phases between grid barriers) it priced a launch against a grid
// barrier.  The step-start cond of the "step" rule is a snapshot of h[:, :C]
// that block 0 writes while the first layer reads h itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// P3: the per-layer kernels body_in and body_out
struct Body {
  int B, T, L, R, G, S, C, KIp;
  int cond_rule;  // kCondStep or kCondLayer
  int dil[kMaxLayers], offs[kMaxLayers];
  const __nv_bfloat16* w_in;  // (L, G, KIp)
  const __nv_bfloat16* w_so;  // (L, S + R, G/2)
  const float* b;             // (L, G)
  uint16_t* ring;             // (slots, B, R) bf16 bits, zeroed by the host
  float* h;                   // (B, R)
  float* skip;                // (B, S)
  float* gated;               // (B, G/2), bf16-rounded
  float* cond;                // (B, C): h[:, :C] at the step's start
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

// dst[i] = src[i] for n floats (n % 4 == 0) in 16-byte chunks, kStage
// loads in flight per thread
__device__ void stage_f32(float* dst, const float* src, int n) {
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
      if (c < n4) reinterpret_cast<uint4*>(dst)[c] = v[u];
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
  if (p.cond_rule == kCondLayer || l == 0) {
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
      if (threadIdx.x < kRowTile) {
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
        pa += k == 0 ? bias0[0] : k == 1 ? bias1[0] : p.b[(size_t)l * p.G + j];
        pg += k == 0 ? bias0[1] : k == 1 ? bias1[1] : p.b[(size_t)l * p.G + j + G2];
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
  stage_f32(gs, p.gated, B * G2);
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
          *sp = l == 0 ? v : old + v;
        } else {
          const int r = o - S;
          const size_t e = (size_t)b * R + r;
          const float hv = first ? pre_old : __ldcg(p.h + e);
          ring_w[e] = __bfloat16_as_ushort(__float2bfloat16_rn(hv));
          p.h[e] = (v + hv) * kHalf;
        }
      }
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


// ---------------------------------------------------------------------------
// P2 and P4: body_mma, one persistent cooperative launch on the tensor cores

constexpr int kCtas = 128;          // blocks of body_mma, one an SM
constexpr int kMmaBlock = kThreads + 32;  // kWarps compute warps and the sync warp
constexpr int kMaxNt = 2;           // n-tiles of 8 batch rows: B <= 16
constexpr int kMaxRows = 8;         // rows of a block's tile: the first half of mma's m16
constexpr int kPad = 8;             // bf16 pad of a staged row: conflict-free B fragments
constexpr int kOwnB = 16;           // batch stride of the owned state
constexpr long long kSpinLimit = 1ll << 24;  // polls before a wait traps instead of hanging

// tools/ablate_body edits these switches; the kernel is right only as they are
constexpr bool kDoIn = true;         // phase in: the dots, the gate
constexpr bool kDoOut = true;        // phase out: the dots, the epilogue
constexpr bool kStageInputs = true;  // stage the taps, h and cond of phase in
constexpr bool kLoadWeights = true;  // bulk-copy the weights and read their fragments
constexpr bool kGridBarrier = true;  // false: block barriers in place of the grid's

struct Persist {
  int B, T, L, R, G2, S, C, KT, KH, KO, KF, nt;
  int pairs, rin, rs, rh, rout, rf1, LB, F1B, nres;
  int cond_rule, bias, scaled_skip, row_out, head;
  int dil[kMaxLayers], offs[kMaxLayers];
  // shared memory, byte offsets
  int o_red, o_xt, o_xh, o_xg, o_own, o_x, o_mbar, o_wf1, o_wres, o_wstr, smem;
  const uint8_t* wfrag;  // (L, kCtas, LB): each block's fragments of a layer
  const uint8_t* wf1;    // (kCtas, F1B), head
  const float* b;        // (L, 2 G2)
  const float* cond_in;  // (T, B, C), cond rule kCondInput
  const float* w_first;  // (R,), head
  const float* w_f2;     // (S,): column 0 of final2, head
  uint16_t* ring;        // (slots, B, R) bf16, zeroed by the host
  uint16_t* hb;          // (B, R) bf16(h), published by the owners of h's columns
  uint16_t* condb;       // (B, C) bf16(h[:, :C]) at the step's start, cond rule kCondStep
  uint16_t* gb;          // (B, G2) gated, bf16
  uint16_t* sb;          // (B, S) bf16(relu(skip)) after the last layer, head
  float* o1;             // (B, S) relu(final1), head
  unsigned int* bar;     // the grid barrier's arrival count, zeroed by the host
  float* h;              // (B, R): the final h
  float* skip;           // (B, S): the last step's skip sum
  float* out;            // (T, B) with row_out
};

int align16(int n) { return (n + 15) & ~15; }

// Fills p's tile shapes and shared-memory layout from B, L, R, G2, S, C and
// head; 0, or cudaErrorInvalidValue for shapes the kernel does not take or a
// plan that does not fit
int persist_layout(Persist& p) {
  if (p.B < 1 || p.B > 8 * kMaxNt || p.L < 2 || p.L > kMaxLayers || p.G2 % kCtas ||
      p.R % kCtas || p.S % kCtas || p.R % 16 || p.C % 8 || p.C > p.R || p.G2 % 16 || p.S % 16)
    return (int)cudaErrorInvalidValue;
  p.pairs = p.G2 / kCtas;
  p.rin = 2 * p.pairs;
  p.rs = p.S / kCtas;
  p.rh = p.R / kCtas;
  p.rout = p.rs + p.rh;
  p.rf1 = p.S / kCtas;
  if (p.rin > kMaxRows || p.rout > kMaxRows) return (int)cudaErrorInvalidValue;
  p.KT = 2 * p.R / 16;
  p.KH = (p.R + p.C + 15) / 16;
  p.KO = p.G2 / 16;
  p.KF = p.S / 16;
  p.nt = (p.B + 7) / 8;
  p.LB = ((p.KT + p.KH) * p.rin + p.KO * p.rout) * 32;
  p.F1B = p.head ? p.KF * p.rf1 * 32 : 0;
  const int rows = 8 * p.nt, xg_w = p.G2 > p.S ? p.G2 : p.S;
  int off = 0;
  p.o_red = off;
  off += align16(kWarps * kMaxNt * 64 * 4);
  p.o_xt = off;
  off += align16(rows * (2 * p.R + kPad) * 2);
  p.o_xh = off;
  off += align16(rows * (16 * p.KH + kPad) * 2);
  p.o_xg = off;
  off += align16(rows * (xg_w + kPad) * 2);
  p.o_own = off;
  off += 2 * kMaxRows * kOwnB * 4;
  p.o_x = off;
  off += kOwnB * 4;
  p.o_mbar = off;
  off += 32;
  p.o_wf1 = off;
  off += p.F1B;
  p.o_wres = off;
  if (off + p.L * p.LB <= kMaxSmem) {
    p.nres = p.L;
    p.o_wstr = off + p.L * p.LB;
    p.smem = p.o_wstr;
  } else {
    p.nres = (kMaxSmem - off - 2 * p.LB) / p.LB;
    if (p.nres < 0) return (int)cudaErrorInvalidValue;
    p.o_wstr = off + p.nres * p.LB;
    p.smem = p.o_wstr + 2 * p.LB;
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(m)) : "memory");
}

// expect `bytes` more on m and bulk-copy them (TMA, one contiguous run)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* m) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(m))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* m, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(m)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* m, uint32_t parity) {
  const uint32_t a = smem_u32(m);
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The compute warps' block barrier (named barrier 1), without the sync warp
__device__ __forceinline__ void sync_compute() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// The grid barrier, split between the compute warps and the sync warp.  The
// compute warps arrive after a phase's stores (named barrier 2, without
// waiting) and wait before the next phase's loads (named barrier 3); the
// sync warp, per grid barrier, waits for their arrival, adds to an arrival
// count in device memory with release and reads it with acquire at gpu
// scope (lane 0), and the n-th barrier of the call is passed when the count
// reaches n x blocks; then it lets the compute warps go.  So the release's
// fence and the polling never hold up the compute warps' own work between
// the arrival and the wait.
__device__ __forceinline__ void grid_arrive() {
  asm volatile("bar.arrive 2, %0;" ::"n"(kMmaBlock) : "memory");
}

__device__ __forceinline__ void grid_wait() {
  asm volatile("bar.sync 3, %0;" ::"n"(kMmaBlock) : "memory");
}

__device__ void sync_warp_loop(const Persist& p, unsigned int barriers) {
  for (unsigned int n = 1; n <= barriers; ++n) {
    asm volatile("bar.sync 2, %0;" ::"n"(kMmaBlock) : "memory");
    if (kGridBarrier && (threadIdx.x & 31) == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p.bar) : "memory");
      const unsigned int target = n * gridDim.x;
      for (long long spins = 0;; ++spins) {
        unsigned int v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p.bar) : "memory");
        if ((int)(v - target) >= 0) break;
        if (spins > kSpinLimit) __trap();
      }
    }
    __syncwarp();
    asm volatile("bar.arrive 3, %0;" ::"n"(kMmaBlock) : "memory");
  }
}

// d += A (16 x 16, rows g and g + 8 of which only g are used) x B (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// acc[n] += this warp's k-steps k = warp, warp + kWarps, ... < nk of a tile
// of nr rows (fragments at w: k-step k, row g, lane quarter t at byte
// (k nr + g) 32 + 8 t) against the staged batch rows xs (stride xstride
// bf16; k-step k at element 16 k)
__device__ __forceinline__ uint2 a_frag(const uint8_t* w, int nr, int k, int g, int t) {
  if (g >= nr) return make_uint2(0u, 0u);
  return kLoadWeights ? *reinterpret_cast<const uint2*>(w + ((size_t)k * nr + g) * 32 + t * 8)
                      : make_uint2(0x3f803f80u, 0x3f803f80u);
}

__device__ __forceinline__ void mma_step(float (&d)[4], uint2 a, const uint16_t* x) {
  mma_bf16(d, a.x, a.y, *reinterpret_cast<const uint32_t*>(x),
           *reinterpret_cast<const uint32_t*>(x + 8));
}

// two k-steps at a time into two accumulators, their loads issued together,
// so that two mma chains are in flight
__device__ __forceinline__ void tile_dots(float (&acc)[kMaxNt][4], const uint8_t* w, int nr,
                                          int nk, const uint16_t* xs, int xstride, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float odd[kMaxNt][4] = {};
  int k = warp;
  for (; k + kWarps < nk; k += 2 * kWarps) {
    const uint2 a0 = a_frag(w, nr, k, g, t), a1 = a_frag(w, nr, k + kWarps, g, t);
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) {
      if (n < nt) {
        const uint16_t* x = xs + (size_t)(n * 8 + g) * xstride + 16 * k + 2 * t;
        mma_step(acc[n], a0, x);
        mma_step(odd[n], a1, x + 16 * kWarps);
      }
    }
  }
  if (k < nk) {
    const uint2 a0 = a_frag(w, nr, k, g, t);
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n)
      if (n < nt) mma_step(acc[n], a0, xs + (size_t)(n * 8 + g) * xstride + 16 * k + 2 * t);
  }
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += odd[n][i];
}

// every warp's partial sums of its rows into red (then a block barrier)
__device__ __forceinline__ void to_red(float* red, const float (&acc)[kMaxNt][4], int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n) {
    if (n < nt) {
      float* r = red + ((warp * kMaxNt + n) * 8 + g) * 8 + 2 * t;
      r[0] = acc[n][0];
      r[1] = acc[n][1];
    }
  }
}

// row r of the tile for batch row b: the warps' partial sums in warp order
__device__ __forceinline__ float red_sum(const float* red, int r, int b) {
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[((w * kMaxNt + b / 8) * 8 + r) * 8 + b % 8];
  return v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 bf16x8(const float4& a, const float4& b) {
  return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y), bf16x2(b.z, b.w));
}

// 8 channels [e, e + 8) of h = x * w_first, as bf16
__device__ __forceinline__ uint4 h_from_x(const Persist& p, float x, int e) {
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(p.w_first + e));
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(p.w_first + e + 4));
  return bf16x8(make_float4(x * w0.x, x * w0.y, x * w0.z, x * w0.w),
                make_float4(x * w1.x, x * w1.y, x * w1.z, x * w1.w));
}

__device__ __forceinline__ void slots_at(const Persist& p, int t, int l, int* s2, int* s1) {
  const int d = p.dil[l], wp = t % (2 * d);
  *s2 = p.offs[l] + wp;
  *s1 = p.offs[l] + (wp + d) % (2 * d);
}

// xt row b = [x_{t-2d} | x_{t-d}] of layer (t, l), by cp.async (the ring is
// not written in the layers between this call and the dots that read it)
__device__ void stage_taps(const Persist& p, uint16_t* xt, int t, int l) {
  if (!kStageInputs) return;
  int s2, s1;
  slots_at(p, t, l, &s2, &s1);
  const int R = p.R, half = R / 8, cpr = 2 * half, xstride = 2 * R + kPad;
  for (int i = threadIdx.x; i < p.B * cpr; i += kThreads) {
    const int b = i / cpr, q = i - b * cpr;
    const int slot = q < half ? s2 : s1, e = (q < half ? q : q - half) * 8;
    cp16(xt + (size_t)b * xstride + q * 8, p.ring + ((size_t)slot * p.B + b) * R + e);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// xh row b = [bf16(h) | cond | 0] of layer (t, l); h is x * w_first at a
// step's first layer with the head, else the published hb
__device__ void stage_h(const Persist& p, uint16_t* xh, const float* xs, int t, int l) {
  if (!kStageInputs) return;
  constexpr int kU = 4;
  const int R = p.R, C = p.C, cpr = (R + C) / 8, xstride = 16 * p.KH + kPad, n = p.B * cpr;
  const bool from_x = p.head && l == 0;
  for (int i0 = threadIdx.x; i0 < n; i0 += kU * kThreads) {
    uint4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int b = i / cpr, e = (i - b * cpr) * 8;
        if (e < R || p.cond_rule == kCondLayer) {
          const int c = e < R ? e : e - R;
          v[u] = from_x ? h_from_x(p, xs[b], c)
                        : __ldcg(reinterpret_cast<const uint4*>(p.hb + (size_t)b * R + c));
        } else if (p.cond_rule == kCondInput) {
          const float4* src =
              reinterpret_cast<const float4*>(p.cond_in + ((size_t)t * p.B + b) * C + e - R);
          v[u] = bf16x8(__ldg(src), __ldg(src + 1));
        } else {
          v[u] = __ldcg(reinterpret_cast<const uint4*>(p.condb + (size_t)b * C + e - R));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int b = i / cpr, e = (i - b * cpr) * 8;
        *reinterpret_cast<uint4*>(xh + (size_t)b * xstride + e) = v[u];
      }
    }
  }
}

// xg row b = src[b][0, width) (gated, or bf16(relu(skip)) for final1)
__device__ void stage_rows(const Persist& p, uint16_t* xg, const uint16_t* src, int width) {
  constexpr int kU = 2;
  const int cpr = width / 8, xstride = (p.G2 > p.S ? p.G2 : p.S) + kPad, n = p.B * cpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += kU * kThreads) {
    uint4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int b = i / cpr, e = (i - b * cpr) * 8;
        v[u] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)b * width + e));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int b = i / cpr, e = (i - b * cpr) * 8;
        *reinterpret_cast<uint4*>(xg + (size_t)b * xstride + e) = v[u];
      }
    }
  }
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kMmaBlock, 1) body_mma(Persist p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + p.o_red);
  uint16_t* xt = reinterpret_cast<uint16_t*>(smem + p.o_xt);
  uint16_t* xh = reinterpret_cast<uint16_t*>(smem + p.o_xh);
  uint16_t* xg = reinterpret_cast<uint16_t*>(smem + p.o_xg);
  float* own_h = reinterpret_cast<float*>(smem + p.o_own);  // (kMaxRows, kOwnB)
  float* own_skip = own_h + kMaxRows * kOwnB;
  float* xs = reinterpret_cast<float*>(smem + p.o_x);  // the head's samples x
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + p.o_mbar);  // resident, stream 0, 1
  uint8_t* wf1 = smem + p.o_wf1;
  uint8_t* wres = smem + p.o_wres;
  uint8_t* wstr = smem + p.o_wstr;
  const int B = p.B, R = p.R, S = p.S, C = p.C, G2 = p.G2, blk = blockIdx.x, tid = threadIdx.x;
  const int xt_s = 2 * R + kPad, xh_s = 16 * p.KH + kPad, xg_s = (G2 > S ? G2 : S) + kPad;
  const int ns = p.L - p.nres;                         // streamed layers a step
  const long long uses = (long long)p.T * ns;          // streamed layer uses a call
  const size_t lstride = (size_t)kCtas * p.LB;         // bytes of a layer's pack

  // the prologue: zero the staging (rows past B and the pad stay zero), the
  // owned state at t = 0, the weights' copies in flight, layer (0, 0)'s taps
  for (int i = tid; i < (p.o_own - p.o_xt) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem + p.o_xt)[i] = 0u;
  const float h0 = p.head ? 0.f : 1.f;  // the probes' h at t = 0
  for (int i = tid; i < kMaxRows * kOwnB; i += blockDim.x) {
    own_h[i] = h0;
    own_skip[i] = 0.f;
  }
  if (tid < kOwnB) xs[tid] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(mbar + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue_stream = [&](long long k) {  // streamed use k into slot k & 1
    const int layer = p.nres + (int)(k % ns);
    mbar_expect(mbar + 1 + (k & 1), p.LB);
    bulk_load(wstr + (k & 1) * p.LB, p.wfrag + layer * lstride + (size_t)blk * p.LB, p.LB,
              mbar + 1 + (k & 1));
  };
  if (kLoadWeights && tid == 0) {
    mbar_expect(mbar, p.nres * p.LB + p.F1B);
    for (int l = 0; l < p.nres; ++l)
      bulk_load(wres + l * p.LB, p.wfrag + l * lstride + (size_t)blk * p.LB, p.LB, mbar);
    if (p.head) bulk_load(wf1, p.wf1 + (size_t)blk * p.F1B, p.F1B, mbar);
    for (long long k = 0; k < 2 && k < uses; ++k) issue_stream(k);
  }
  if (kLoadWeights) mbar_wait(mbar, 0);
  // layer (t, l)'s weights, once they are in (a streamed layer waits for
  // its slot; the wait returns at once if the copy is already in)
  auto weights_of = [&](int t, int l) -> const uint8_t* {
    if (l < p.nres) return wres + l * p.LB;
    const long long k = (long long)t * ns + (l - p.nres);
    if (kLoadWeights) mbar_wait(mbar + 1 + (k & 1), (uint32_t)((k >> 1) & 1));
    return wstr + (k & 1) * p.LB;
  };
  // The taps' dots of layer (t, l) into tacc, its taps' copy landed.  A
  // layer's taps need no other block: the copy is issued in the wait of
  // barrier (a) of the layer before (no slot it reads is written until the
  // layer after that, L >= 2), the dots run in the wait of its barrier (b).
  float tacc[kMaxNt][4];
  auto taps_dots = [&](int t, int l) {
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) tacc[n][i] = 0.f;
    if (t >= p.T) return;
    const uint8_t* w = weights_of(t, l);
    if (kStageInputs) cp_wait_all();
    sync_compute();
    if (kDoIn) tile_dots(tacc, w, p.rin, p.KT, xt, xt_s, p.nt);
  };
  if (tid >= kThreads) {  // the sync warp
    sync_warp_loop(p, (unsigned int)p.T * (2 * p.L + (p.head ? 1 : 0)));
    return;
  }
  if (p.T > 0) stage_taps(p, xt, 0, 0);
  taps_dots(0, 0);

  for (int t = 0; t < p.T; ++t) {
    for (int l = 0; l < p.L; ++l) {
      const long long k = (long long)t * ns + (l - p.nres);  // streamed use, if l >= nres
      const uint8_t* w = weights_of(t, l);
      int s2, s1;
      slots_at(p, t, l, &s2, &s1);

      // phase in: the taps' dots were done in the last barrier's wait; the
      // gate's biases are loaded before this one's
      float acc[kMaxNt][4];
#pragma unroll
      for (int n = 0; n < kMaxNt; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = tacc[n][i];
      const bool gate_thread = tid < p.pairs * B;
      const int gp = gate_thread ? tid / B : 0, gb_row = gate_thread ? tid - gp * B : 0;
      const int gj = blk * p.pairs + gp;
      const float bias_a = p.bias && gate_thread ? __ldg(p.b + (size_t)l * 2 * G2 + gj) : 0.f;
      const float bias_g = p.bias && gate_thread ? __ldg(p.b + (size_t)l * 2 * G2 + G2 + gj) : 0.f;
      if (t > 0 || l > 0) grid_wait();  // (b) of the previous layer, or the head's
      if (p.head && l == 0 && t > 0) {
        // x = clip(final2[:, 0] of o1) for every batch row, in every block
        // alike; the owned h of the step's first layer is x * w_first
        for (int b = tid >> 5; b < B; b += kWarps) {
          float a = 0.f;
          for (int c = tid & 31; c < S; c += 32)
            a = fmaf(__ldcg(p.o1 + (size_t)b * S + c), __ldg(p.w_f2 + c), a);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          if ((tid & 31) == 0) xs[b] = fminf(fmaxf(a, -1.f), 1.f);
        }
        sync_compute();
        if (tid < p.rh * B) {
          const int rr = tid / B, b = tid - rr * B;
          own_h[(p.rs + rr) * kOwnB + b] = xs[b] * __ldg(p.w_first + blk * p.rh + rr);
        }
      }
      if (kDoIn) {
        stage_h(p, xh, xs, t, l);
        sync_compute();
        tile_dots(acc, w + p.KT * p.rin * 32, p.rin, p.KH, xh, xh_s, p.nt);
        to_red(red, acc, p.nt);
        sync_compute();
        if (gate_thread) {
          const float a = red_sum(red, gp, gb_row) + bias_a;
          const float g = red_sum(red, p.pairs + gp, gb_row) + bias_g;
          p.gb[(size_t)gb_row * G2 + gj] = bf16_bits(tanhf(a) * (1.f / (1.f + expf(-g))));
        }
      }
      grid_arrive();
      const int tn = l + 1 < p.L ? t : t + 1, ln = l + 1 < p.L ? l + 1 : 0;  // the next layer
      if (tn < p.T) stage_taps(p, xt, tn, ln);  // this layer's were read before the wait
      grid_wait();  // (a): gated is whole

      // phase out: skip and out rows; the owned rows' ring write, h and skip
      if (kDoOut) {
        stage_rows(p, xg, p.gb, G2);
        sync_compute();
        float acc2[kMaxNt][4] = {};
        tile_dots(acc2, w + (p.KT + p.KH) * p.rin * 32, p.rout, p.KO, xg, xg_s, p.nt);
        to_red(red, acc2, p.nt);
      }
      sync_compute();  // every warp is done with w and red is whole
      if (kLoadWeights && l >= p.nres && tid == 0 && k + 2 < uses) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_stream(k + 2);
      }
      if (kDoOut && tid < p.rout * B) {
        const int rr = tid / B, b = tid - rr * B;
        const float v = red_sum(red, rr, b);
        const bool last = l == p.L - 1;
        if (rr < p.rs) {
          const int o = blk * p.rs + rr;
          const float old = own_skip[rr * kOwnB + b];
          const float sk = l == 0 ? v : p.scaled_skip ? (old + v) * kHalf : old + v;
          own_skip[rr * kOwnB + b] = sk;
          if (p.head && last) p.sb[(size_t)b * S + o] = bf16_bits(fmaxf(sk, 0.f));
        } else {
          const int r = blk * p.rh + rr - p.rs;
          const float hv = own_h[rr * kOwnB + b];
          p.ring[((size_t)s2 * B + b) * R + r] = bf16_bits(hv);
          const float nh = (v + hv) * kHalf;
          own_h[rr * kOwnB + b] = nh;
          p.hb[(size_t)b * R + r] = bf16_bits(nh);
          if (last && p.cond_rule == kCondStep && r < C) p.condb[(size_t)b * C + r] = bf16_bits(nh);
          if (last && p.row_out && b == 0 && r < B) p.out[(size_t)t * B + r] = nh;
        }
      }
      grid_arrive();
      taps_dots(tn, ln);
    }
    if (p.head) {  // final1 of the step's skip sum: o1 = relu(bf16(relu(skip)) @ w_f1)
      grid_wait();
      stage_rows(p, xg, p.sb, S);
      sync_compute();
      float acc[kMaxNt][4] = {};
      tile_dots(acc, wf1, p.rf1, p.KF, xg, xg_s, p.nt);
      to_red(red, acc, p.nt);
      sync_compute();
      if (tid < p.rf1 * B) {
        const int rr = tid / B, b = tid - rr * B;
        p.o1[(size_t)b * S + blk * p.rf1 + rr] = fmaxf(red_sum(red, rr, b), 0.f);
      }
      grid_arrive();
    }
  }
  if (p.T > 0) grid_wait();  // the last barrier: every arrival is taken
  cp_wait_all();
  if (tid < p.rout * B) {
    const int rr = tid / B, b = tid - rr * B;
    if (rr < p.rs)
      p.skip[(size_t)b * S + blk * p.rs + rr] = own_skip[rr * kOwnB + b];
    else
      p.h[(size_t)b * R + blk * p.rh + rr - p.rs] = own_h[rr * kOwnB + b];
  }
}

__global__ void fill_u16(uint16_t* x, size_t n, uint16_t v) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = v;
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

int set_dil(const int* dil, int L, int slots, int* dst, int* offs) {
  int need = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] <= 0) return (int)cudaErrorInvalidValue;
    dst[l] = dil[l];
    offs[l] = need;
    need += 2 * dil[l];
  }
  return slots < need ? (int)cudaErrorInvalidValue : 0;
}

int persist_shape(Persist& p, int B, int L, int R, int G, int S, int C, int head, int cond_rule) {
  if (G % 2 || cond_rule < 0 || cond_rule > 2 || (head && cond_rule == kCondStep))
    return (int)cudaErrorInvalidValue;
  p.B = B;
  p.L = L;
  p.R = R;
  p.G2 = G / 2;
  p.S = S;
  p.C = C;
  p.head = head;
  p.cond_rule = cond_rule;
  return persist_layout(p);
}

}  // namespace

extern "C" {

// The plan of body_mma (P2, P4) at these shapes: plan[0..8] = blocks,
// threads a block, rows of a block's in, out and final1 tiles, bytes of a
// block's weights a layer, resident layers, shared-memory bytes a block, and
// the card's blocks an SM for it.  Returns 0, cudaErrorInvalidValue for
// shapes the kernel does not take or a plan that does not fit, or the first
// cudaError_t.
int dvc_probe_body_plan(int B, int L, int R, int G, int S, int C, int head, int cond_rule,
                        int* plan) {
  Persist p{};
  const int err = persist_shape(p, B, L, R, G, S, C, head, cond_rule);
  if (err) return err;
  int per_sm = 0;
  DVC_CHECK(cudaFuncSetAttribute(body_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, body_mma, kMmaBlock, p.smem));
  const int vals[9] = {kCtas, kMmaBlock, p.rin, p.rout, p.rf1, p.LB, p.nres, p.smem, per_sm};
  for (int i = 0; i < 9; ++i) plan[i] = vals[i];
  return 0;
}

// P2 and P4: one cooperative launch of body_mma.  cond_rule 0: bf16(h[:, :C])
// at the step's start; 1: at every layer; 2: cond_in[t].  dil: host array
// of L dilations (offsets are the running sum of 2d); slots >= sum 2d is the
// ring's length.  Device pointers: wfrag (L, blocks, layer bytes) and wf1
// (blocks, final1 bytes) bf16 fragments (bench_body.frag_pack); b (L, G),
// cond_in (T, B, C), w_first (R,) and w_f2 (S,) float32 (those a flag does
// not use may be null); scratch ring (slots, B, R), hb (B, R), condb (B, C),
// gb (B, G/2) and sb (B, S) bf16, o1 (B, S) float32, bar one uint32;
// outputs h (B, R), skip (B, S) and, with row_out, out (T, B) float32.
// Returns 0 or the first cudaError_t.
int dvc_probe_body_persistent(int cond_rule, int bias, int scaled_skip, int row_out, int head,
                              int B, int T, int L, int R, int G, int S, int C, const int* dil,
                              int slots, const void* wfrag, const void* wf1, const void* b,
                              const void* cond_in, const void* w_first, const void* w_f2,
                              void* ring, void* hb, void* condb, void* gb, void* sb, void* o1,
                              void* bar, void* h, void* skip, void* out, void* stream) {
  Persist p{};
  int err = persist_shape(p, B, L, R, G, S, C, head, cond_rule);
  if (err) return err;
  if (T < 0 || (row_out && B > R) || (cond_rule == kCondInput && !cond_in) || (bias && !b) ||
      (head && (!w_first || !wf1 || !w_f2)) || (row_out && !out))
    return (int)cudaErrorInvalidValue;
  err = set_dil(dil, L, slots, p.dil, p.offs);
  if (err) return err;
  p.T = T;
  p.bias = bias;
  p.scaled_skip = scaled_skip;
  p.row_out = row_out;
  p.wfrag = static_cast<const uint8_t*>(wfrag);
  p.wf1 = static_cast<const uint8_t*>(wf1);
  p.b = static_cast<const float*>(b);
  p.cond_in = static_cast<const float*>(cond_in);
  p.w_first = static_cast<const float*>(w_first);
  p.w_f2 = static_cast<const float*>(w_f2);
  p.ring = static_cast<uint16_t*>(ring);
  p.hb = static_cast<uint16_t*>(hb);
  p.condb = static_cast<uint16_t*>(condb);
  p.gb = static_cast<uint16_t*>(gb);
  p.sb = static_cast<uint16_t*>(sb);
  p.o1 = static_cast<float*>(o1);
  p.bar = static_cast<unsigned int*>(bar);
  p.h = static_cast<float*>(h);
  p.skip = static_cast<float*>(skip);
  p.out = static_cast<float*>(out);

  int dev = 0, sms = 0, per_sm = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  DVC_CHECK(cudaFuncSetAttribute(body_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, body_mma, kMmaBlock, p.smem));
  if (per_sm * sms < kCtas) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t st = (cudaStream_t)stream;
  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * B * R * 2, st));
  DVC_CHECK(cudaMemsetAsync(bar, 0, sizeof(unsigned int), st));
  // the probes' h at t = 0: ones, or x * w_first of the sample x = 0 with the head
  const uint16_t h0 = head ? 0 : 0x3f80;
  const size_t hsz = (size_t)B * R, csz = (size_t)B * C;
  fill_u16<<<(unsigned)((hsz + 255) / 256), 256, 0, st>>>(p.hb, hsz, h0);
  DVC_CHECK(cudaGetLastError());
  if (csz) {
    fill_u16<<<(unsigned)((csz + 255) / 256), 256, 0, st>>>(p.condb, csz, h0);
    DVC_CHECK(cudaGetLastError());
  }
  void* args[] = {&p};
  DVC_CHECK(cudaLaunchCooperativeKernel((const void*)body_mma, dim3(kCtas), dim3(kMmaBlock), args,
                                        p.smem, st));
  return (int)cudaGetLastError();
}

// P3: two launches per layer (body_in, body_out) from a host loop.
// cond_rule 0: bf16(h[:, :C]) at the step's start; 1: at every layer.  dil:
// host array of L dilations; slots >= sum 2d.  Device pointers: w_in (L, G,
// KIp) and w_so (L, S + R, G/2) bf16 (bench_body.pack), b (L, G) float32;
// ring (slots, B, R) bf16; h (B, R) (the output), skip (B, S), gated (B,
// G/2) and cond (B, C) float32.  Returns 0 or the first cudaError_t.
int dvc_probe_body_streamed(int cond_rule, int B, int T, int L, int R, int G, int S, int C,
                            int KIp, const int* dil, int slots, const void* w_in,
                            const void* w_so, const void* b, void* ring, void* h, void* skip,
                            void* gated, void* cond, void* stream) {
  const int G2 = G / 2;
  if (B <= 0 || T < 0 || L <= 0 || L > kMaxLayers || R <= 0 || G <= 0 || G % 2 || S <= 0 ||
      C < 0 || C > R || R % 8 || C % 4 || KIp % 8 || KIp < 3 * R + C || G2 % 8 || S % 8 ||
      cond_rule < 0 || cond_rule > 1 || !b)
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
  const int err = set_dil(dil, L, slots, p.dil, p.offs);
  if (err) return err;
  p.w_in = static_cast<const __nv_bfloat16*>(w_in);
  p.w_so = static_cast<const __nv_bfloat16*>(w_so);
  p.b = static_cast<const float*>(b);
  p.ring = static_cast<uint16_t*>(ring);
  p.h = static_cast<float*>(h);
  p.skip = static_cast<float*>(skip);
  p.gated = static_cast<float*>(gated);
  p.cond = static_cast<float*>(cond);

  const size_t smem_in = (size_t)B * KIp * sizeof(float);
  const size_t smem_out = (size_t)B * G2 * sizeof(float);
  if (smem_in > (size_t)kMaxSmem || smem_out > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * R;
  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * hsz * sizeof(uint16_t), st));
  fill_kernel<<<(unsigned)((hsz + 255) / 256), 256, 0, st>>>(p.h, hsz, 1.f);  // h at t = 0
  DVC_CHECK(cudaGetLastError());

  int dev = 0, sms = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int nblk = sms * kBlocksPerSm < G2 ? sms * kBlocksPerSm : G2;
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
