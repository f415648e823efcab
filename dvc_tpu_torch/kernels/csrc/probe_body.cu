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
// P3: streamed_in and streamed_out, a launch a phase, 2L launches a step.
// Pricing a launch against P2's grid barrier is what P3 is for, so the
// launches stay.  What held the first design (body_in/body_out from a host
// loop in C, float32 FMAs on an output-major pack) back, same card: 292 us a
// step at B = 8, T = 1000, of which its empty launches alone took 226 us
// (4.7 us each, tools/ablate_body): the host's loop of 48,000 launches and
// each kernel's drain before the next one could start.  What this design
// does about it:
//   * a CUDA graph in place of the host loop: a step's 2L launches and a
//     one-thread node that advances the step counter are captured and
//     instantiated once a call and replayed T times; a kernel reads its
//     step from the counter after its wait, and the counter moves only in
//     the node after the step's last kernel is done.  Graphs of 8 and 32
//     steps were tried and ran slower, their empty launches too;
//   * programmatic dependent launch (PDL) between consecutive kernels: each
//     launch but a graph's first carries cudaLaunchAttributeProgrammatic-
//     StreamSerialization, and each kernel lets its successor start at once
//     (griddepcontrol.launch_dependents).  Before its griddepcontrol.wait a
//     kernel touches only what nothing in the call writes: its mbarrier, the
//     TMA bulk copy of its rows of the layer's weights into shared memory,
//     the gate's biases, zeros in its staging; after the wait it reads h,
//     hb, the ring, gated, skip, the cond snapshot and the step counter, all
//     through L2.  Every kernel waits before it ends, so a kernel's end
//     implies the end of every kernel before it;
//   * the dots on the tensor cores (mma.sync) from a fragment-order pack
//     (bench_body.streamed_pack): streamed_out on body_mma's 128 blocks and
//     out-tiles (3,072 bytes of weights a block a layer), streamed_in on 32
//     blocks of mma's whole m16 tile, 8 gate pairs a block (51,712 bytes),
//     since every block of phase in stages all its inputs from L2 and that
//     broadcast, more than the dots, sets the phase's time; h and skip live
//     in device memory between launches;
//   * co-residency: a block of each kernel fits on an SM beside the other
//     (shared memory, 256 threads, at most 128 registers a thread by
//     __launch_bounds__, both kernels asking for the largest shared-memory
//     carveout so that an SM need not drain to change it), so that a
//     kernel's prologue runs while the one before still works;
//     dvc_probe_streamed_plan reads it on the card.
// The weights cannot stay in shared memory across launches (2.05 MB a layer,
// 49.15 MB a step): each step reads them again, 14.7 ms a call of 1000 steps
// at the HBM rate if they come from device memory, less where the 50 MB L2
// keeps them.  Where the time went at the end (tools/ablate_body, same
// card, T = 200): 157 us a step; us a layer: its two launches alone 1.4,
// phase `in` 1.5, `out` 1.3, staging 1.6, weights 0.8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory a block
constexpr float kHalf = 0.7071f;  // the probes' literal, not sqrt(1/2)

enum CondRule { kCondStep = 0, kCondLayer = 1, kCondInput = 2 };


// ---------------------------------------------------------------------------
// P2 and P4: body_mma, one persistent cooperative launch on the tensor cores

constexpr int kCtas = 128;          // blocks of body_mma, one an SM
constexpr int kMmaBlock = kThreads + 32;  // kWarps compute warps and the sync warp
constexpr int kMaxNt = 2;           // n-tiles of 8 batch rows: B <= 16
constexpr int kMaxRows = 8;         // rows of a block's tile: the first half of mma's m16
constexpr int kPad = 8;             // bf16 pad of a staged row: conflict-free B fragments
constexpr int kOwnB = 16;           // batch stride of the owned state
constexpr int kInRows = 16;         // rows of a tile of P3's streamed_in: mma's whole m16
constexpr long long kSpinLimit = 1ll << 24;  // polls before a wait traps instead of hanging

// tools/ablate_body edits these switches; the kernels are right only as they are
// (P3's kernels read kDoIn, kDoOut, kStageInputs, kLoadWeights and kLayerWork)
constexpr bool kDoIn = true;         // phase in: the dots, the gate
constexpr bool kDoOut = true;        // phase out: the dots, the epilogue
constexpr bool kStageInputs = true;  // stage the taps, h and cond of phase in
constexpr bool kLoadWeights = true;  // bulk-copy the weights and read their fragments
constexpr bool kGridBarrier = true;  // false: block barriers in place of the grid's
constexpr bool kLayerWork = true;    // false: P3's kernels only trigger their successor and wait

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
  // P3 (streamed_shape): streamed_in's blocks, mbarrier, bytes of a block's
  // weights a layer and shared memory; the same of streamed_out (kCtas
  // blocks); their weights (bench_body.streamed_pack): win (L, in blocks,
  // i_wb) and wout (L, kCtas, u_wb) fragments; the step of the graph's replay
  int i_ctas, i_mbar, i_wb, i_smem, u_mbar, u_wb, u_smem;
  const uint8_t* win;
  const uint8_t* wout;
  int* tbase;
};

int align16(int n) { return (n + 15) & ~15; }

// Fills p's tile shapes from B, L, R, G2, S, C and head; 0, or
// cudaErrorInvalidValue for shapes the tiles do not take
int tile_shape(Persist& p) {
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
  return 0;
}

// Fills p's tile shapes and body_mma's shared-memory layout; 0, or
// cudaErrorInvalidValue for shapes the kernel does not take or a plan that
// does not fit
int persist_layout(Persist& p) {
  const int err = tile_shape(p);
  if (err) return err;
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

__global__ void fill_f32(float* x, size_t n, float v) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = v;
}


// ---------------------------------------------------------------------------
// P3: streamed_in and streamed_out, a launch a phase, chained by programmatic
// dependent launch and replayed from a CUDA graph

// Let the next kernel in the stream start its blocks now (they run up to
// their own pdl_wait); wait until the kernel before has ended and its writes
// are visible.  Both are no-ops for a launch without the PDL attribute.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// thread 0: arm this launch's mbarrier and bulk-copy the block's `bytes` of
// a layer's fragments from src into w
__device__ __forceinline__ void streamed_weights(const uint8_t* src, int bytes, uint8_t* w,
                                                 uint64_t* mbar) {
  if (!kLoadWeights || threadIdx.x != 0) return;
  mbar_init(mbar);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  mbar_expect(mbar, bytes);
  bulk_load(w, src, bytes, mbar);
}

// streamed_in's tiles use all 16 rows of mma's m16: 8 gate pairs' a-rows in
// rows 0-7 and their g-rows in rows 8-15, so that a quarter of body_mma's
// blocks (32 at G/2 = 256) compute phase in with the same k-steps a warp.
// Every block stages all of phase in's inputs from L2, and that broadcast,
// not the dots, set the phase's time: the same kernel launched on fewer
// blocks (its outputs wrong, for timing only) ran faster at every halving
// from 128 blocks of 4 rows to 16.

// the A fragment of k-step k of a 16-row tile for lane (g, t): a0 and a2
// from row g's 8 bytes, a1 and a3 from row g + 8's (layout as a_frag's)
__device__ __forceinline__ uint4 a_frag16(const uint8_t* w, int k, int g, int t) {
  if (!kLoadWeights) return make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
  const uint2 lo = *reinterpret_cast<const uint2*>(w + ((size_t)k * kInRows + g) * 32 + t * 8);
  const uint2 hi =
      *reinterpret_cast<const uint2*>(w + ((size_t)k * kInRows + g + 8) * 32 + t * 8);
  return make_uint4(lo.x, hi.x, lo.y, hi.y);
}

// d += A (16 x 16) x B (16 x 8), B's column g at x
__device__ __forceinline__ void mma16_step(float (&d)[4], uint4 a, const uint16_t* x) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(*reinterpret_cast<const uint32_t*>(x)),
        "r"(*reinterpret_cast<const uint32_t*>(x + 8)));
}

// tile_dots of a 16-row tile: acc[n] += this warp's k-steps k = warp, warp +
// kWarps, ... < nk, two at a time into two accumulators
__device__ __forceinline__ void tile_dots16(float (&acc)[kMaxNt][4], const uint8_t* w, int nk,
                                            const uint16_t* xs, int xstride, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float odd[kMaxNt][4] = {};
  int k = warp;
  for (; k + kWarps < nk; k += 2 * kWarps) {
    const uint4 a0 = a_frag16(w, k, g, t), a1 = a_frag16(w, k + kWarps, g, t);
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) {
      if (n < nt) {
        const uint16_t* x = xs + (size_t)(n * 8 + g) * xstride + 16 * k + 2 * t;
        mma16_step(acc[n], a0, x);
        mma16_step(odd[n], a1, x + 16 * kWarps);
      }
    }
  }
  if (k < nk) {
    const uint4 a0 = a_frag16(w, k, g, t);
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n)
      if (n < nt) mma16_step(acc[n], a0, xs + (size_t)(n * 8 + g) * xstride + 16 * k + 2 * t);
  }
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += odd[n][i];
}

// every warp's partial sums of its 16 rows into red (then a block barrier)
__device__ __forceinline__ void to_red16(float* red, const float (&acc)[kMaxNt][4], int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kMaxNt; ++n) {
    if (n < nt) {
      float* r = red + ((warp * kMaxNt + n) * kInRows + g) * 8 + 2 * t;
      r[0] = acc[n][0];
      r[1] = acc[n][1];
      r[64] = acc[n][2];  // row g + 8
      r[65] = acc[n][3];
    }
  }
}

// row r of a 16-row tile for batch row b: the warps' partial sums in warp order
__device__ __forceinline__ float red_sum16(const float* red, int r, int b) {
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[((w * kMaxNt + b / 8) * kInRows + r) * 8 + b % 8];
  return v;
}

// P3's phase in of layer l at step *tbase: the gate of this block's 8 pairs
// into gb
__global__ void __launch_bounds__(kThreads, 2) streamed_in(Persist p, int l) {
  extern __shared__ __align__(16) uint8_t smem[];
  pdl_trigger();
  if (!kLayerWork) {
    pdl_wait();
    return;
  }
  float* red = reinterpret_cast<float*>(smem + p.o_red);
  uint16_t* xt = reinterpret_cast<uint16_t*>(smem + p.o_xt);
  uint16_t* xh = reinterpret_cast<uint16_t*>(smem + p.o_xh);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + p.i_mbar);
  uint8_t* w = smem + p.i_mbar + 16;
  const int B = p.B, G2 = p.G2, tid = threadIdx.x;
  const int xt_s = 2 * p.R + kPad, xh_s = 16 * p.KH + kPad;
  // before the wait, only what nothing in the call writes: the weights'
  // copy, the gate's biases, and zeros in xh (its columns past R + C meet
  // zero weights, and must not hold a NaN)
  streamed_weights(p.win + ((size_t)l * gridDim.x + blockIdx.x) * p.i_wb, p.i_wb, w, mbar);
  for (int i = tid; i < p.nt * xh_s; i += kThreads)  // 8 nt rows of xh_s bf16
    reinterpret_cast<uint4*>(xh)[i] = make_uint4(0u, 0u, 0u, 0u);
  const bool gate_thread = tid < kInRows / 2 * B;
  const int gp = gate_thread ? tid / B : 0, gb_row = gate_thread ? tid - gp * B : 0;
  const int gj = blockIdx.x * (kInRows / 2) + gp;
  const float bias_a = gate_thread ? __ldg(p.b + (size_t)l * 2 * G2 + gj) : 0.f;
  const float bias_g = gate_thread ? __ldg(p.b + (size_t)l * 2 * G2 + G2 + gj) : 0.f;
  __syncthreads();  // xh's zeros and the mbarrier's init before any use
  pdl_wait();
  const int t = __ldcg(p.tbase);
  stage_taps(p, xt, t, l);  // cp.async: in flight while h and cond are staged
  stage_h(p, xh, nullptr, t, l);
  cp_wait_all();
  __syncthreads();
  if (kLoadWeights) mbar_wait(mbar, 0);  // also without the dots: no copy outlives the block
  if (!kDoIn) return;
  float acc[kMaxNt][4] = {};
  tile_dots16(acc, w, p.KT, xt, xt_s, p.nt);
  tile_dots16(acc, w + p.KT * kInRows * 32, p.KH, xh, xh_s, p.nt);
  to_red16(red, acc, p.nt);
  __syncthreads();
  if (gate_thread) {
    const float a = red_sum16(red, gp, gb_row) + bias_a;
    const float g = red_sum16(red, kInRows / 2 + gp, gb_row) + bias_g;
    p.gb[(size_t)gb_row * G2 + gj] = bf16_bits(tanhf(a) * (1.f / (1.f + expf(-g))));
  }
}

// P3's phase out of layer l at step *tbase: this block's skip rows and
// channels of h, as body_mma's phase out, with h and skip in device memory;
// the ring slot x_{t-2d} of its channels takes the layer input h, and after
// a step's last layer the cond snapshot (cond rule kCondStep) the new h
__global__ void __launch_bounds__(kThreads, 2) streamed_out(Persist p, int l) {
  extern __shared__ __align__(16) uint8_t smem[];
  pdl_trigger();
  if (!kLayerWork) {
    pdl_wait();
    return;
  }
  float* red = reinterpret_cast<float*>(smem + p.o_red);
  uint16_t* xg = reinterpret_cast<uint16_t*>(smem + p.o_xg);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + p.u_mbar);
  uint8_t* w = smem + p.u_mbar + 16;
  const int B = p.B, R = p.R, S = p.S, blk = blockIdx.x, tid = threadIdx.x;
  const int xg_s = (p.G2 > S ? p.G2 : S) + kPad;
  streamed_weights(p.wout + ((size_t)l * kCtas + blockIdx.x) * p.u_wb, p.u_wb, w, mbar);
  __syncthreads();  // the mbarrier's init before any wait on it
  pdl_wait();
  // an owner's old skip or h, loaded ahead of the staging
  const bool owner = tid < p.rout * B;
  const int rr = owner ? tid / B : 0, b = owner ? tid - rr * B : 0;
  const bool is_skip = rr < p.rs;
  const int r = blk * p.rh + rr - p.rs;
  const size_t e = is_skip ? (size_t)b * S + blk * p.rs + rr : (size_t)b * R + r;
  const float old = owner && (!is_skip || l > 0) ? __ldcg((is_skip ? p.skip : p.h) + e) : 0.f;
  const int t = __ldcg(p.tbase);
  stage_rows(p, xg, p.gb, p.G2);
  __syncthreads();
  if (kLoadWeights) mbar_wait(mbar, 0);
  if (!kDoOut) return;
  float acc[kMaxNt][4] = {};
  tile_dots(acc, w, p.rout, p.KO, xg, xg_s, p.nt);
  to_red(red, acc, p.nt);
  __syncthreads();
  if (!owner) return;
  const float v = red_sum(red, rr, b);
  if (is_skip) {
    p.skip[e] = l == 0 ? v : old + v;
    return;
  }
  int s2, s1;
  slots_at(p, t, l, &s2, &s1);
  p.ring[((size_t)s2 * B + b) * R + r] = bf16_bits(old);
  const float nh = (v + old) * kHalf;
  p.h[e] = nh;
  p.hb[e] = bf16_bits(nh);
  if (l == p.L - 1 && p.cond_rule == kCondStep && r < p.C)
    p.condb[(size_t)b * p.C + r] = bf16_bits(nh);
}

// a graph's last node: its next replay is the next step
__global__ void advance_step(int* tbase) { *tbase += 1; }

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

// P3's shapes and layouts: streamed_in on G/2 / 8 blocks of 16-row tiles
// (partial sums, taps, [h | cond], its mbarrier, its rows' weights),
// streamed_out on body_mma's kCtas blocks and out-tiles (partial sums,
// gated, its mbarrier, its rows' weights).  0, or cudaErrorInvalidValue.
int streamed_shape(Persist& p, int B, int L, int R, int G, int S, int C, int cond_rule) {
  if (G % 2 || cond_rule < 0 || cond_rule > 1) return (int)cudaErrorInvalidValue;
  p.B = B;
  p.L = L;
  p.R = R;
  p.G2 = G / 2;
  p.S = S;
  p.C = C;
  p.head = 0;
  p.cond_rule = cond_rule;
  const int err = tile_shape(p);
  if (err) return err;
  const int rows = 8 * p.nt, xg_w = p.G2 > p.S ? p.G2 : p.S;
  p.i_ctas = p.G2 / (kInRows / 2);
  p.o_red = 0;
  p.o_xt = align16(kWarps * kMaxNt * kInRows * 8 * 4);
  p.o_xh = p.o_xt + align16(rows * (2 * p.R + kPad) * 2);
  p.i_mbar = p.o_xh + align16(rows * (16 * p.KH + kPad) * 2);
  p.i_wb = (p.KT + p.KH) * kInRows * 32;
  p.i_smem = p.i_mbar + 16 + p.i_wb;
  p.o_xg = align16(kWarps * kMaxNt * 64 * 4);
  p.u_mbar = p.o_xg + align16(rows * (xg_w + kPad) * 2);
  p.u_wb = p.KO * p.rout * 32;
  p.u_smem = p.u_mbar + 16 + p.u_wb;
  return p.i_smem > kMaxSmem || p.u_smem > kMaxSmem ? (int)cudaErrorInvalidValue : 0;
}

int streamed_attrs(const Persist& p) {
  DVC_CHECK(cudaFuncSetAttribute(streamed_in, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 p.i_smem));
  DVC_CHECK(cudaFuncSetAttribute(streamed_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 p.u_smem));
  DVC_CHECK(cudaFuncSetAttribute(streamed_in, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared));
  DVC_CHECK(cudaFuncSetAttribute(streamed_out, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared));
  return 0;
}

// one launch of a P3 kernel into st; with pdl its blocks may start while the
// kernel before it in st still runs
int launch_phase(void (*kernel)(Persist, int), const Persist& p, int blocks, int smem, int l,
                 bool pdl, cudaStream_t st) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p, l);
}

// a step of P3 (each launch after the graph's first with a programmatic
// edge to the one before) and the counter's advance, captured on cs into a
// graph and instantiated into *exec
int capture_step(const Persist& p, cudaStream_t cs, cudaGraphExec_t* exec) {
  int err = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err) return err;
  for (int l = 0; l < p.L && !err; ++l) {
    err = launch_phase(streamed_in, p, p.i_ctas, p.i_smem, l, l > 0, cs);
    if (!err) err = launch_phase(streamed_out, p, kCtas, p.u_smem, l, true, cs);
  }
  if (!err) {
    advance_step<<<1, 1, 0, cs>>>(p.tbase);
    err = (int)cudaGetLastError();
  }
  cudaGraph_t graph = nullptr;
  const int end = (int)cudaStreamEndCapture(cs, &graph);  // ends the capture on any error
  if (!err) err = end;
  if (!err) err = (int)cudaGraphInstantiate(exec, graph, 0);
  if (graph) cudaGraphDestroy(graph);
  return err;
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

// The plan of P3's kernels at these shapes: plan[0..17] = blocks of
// streamed_out and of streamed_in, threads a block, rows of a block's in and
// out tiles, bytes of a block's in- and out-weights a layer, shared memory of streamed_in and streamed_out, their
// registers a thread, the card's blocks an SM for each, whether a block of
// each fits on an SM beside the other (1 or 0: shared memory with the
// per-block reservation, threads, registers), the SM's shared memory, the
// per-block reservation, the L2's bytes and the largest persisting L2 size.
// Returns 0, cudaErrorInvalidValue for shapes the kernels do not take, or
// the first cudaError_t.
int dvc_probe_streamed_plan(int B, int L, int R, int G, int S, int C, int cond_rule, int* plan) {
  Persist p{};
  int err = streamed_shape(p, B, L, R, G, S, C, cond_rule);
  if (!err) err = streamed_attrs(p);
  if (err) return err;
  cudaFuncAttributes fin, fout;
  DVC_CHECK(cudaFuncGetAttributes(&fin, streamed_in));
  DVC_CHECK(cudaFuncGetAttributes(&fout, streamed_out));
  int dev = 0, per_in = 0, per_out = 0, sm_smem = 0, reserved = 0, sm_threads = 0, sm_regs = 0,
      l2 = 0, persisting = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_in, streamed_in, kThreads,
                                                          p.i_smem));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_out, streamed_out, kThreads,
                                                          p.u_smem));
  DVC_CHECK(cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev));
  DVC_CHECK(cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sm_regs, cudaDevAttrMaxRegistersPerMultiprocessor, dev));
  DVC_CHECK(cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev));
  DVC_CHECK(cudaDeviceGetAttribute(&persisting, cudaDevAttrMaxPersistingL2CacheSize, dev));
  // a warp's registers are given in units of 256
  auto block_regs = [](int regs) { return kWarps * ((regs * 32 + 255) / 256 * 256); };
  const int fits = p.i_smem + p.u_smem + 2 * reserved <= sm_smem && 2 * kThreads <= sm_threads &&
                   block_regs(fin.numRegs) + block_regs(fout.numRegs) <= sm_regs;
  const int vals[18] = {kCtas,       p.i_ctas,     kThreads, kInRows, p.rout,
                        p.i_wb,      p.u_wb,       p.i_smem, p.u_smem,
                        fin.numRegs, fout.numRegs, per_in,   per_out, fits,
                        sm_smem,     reserved,     l2,       persisting};
  for (int i = 0; i < 18; ++i) plan[i] = vals[i];
  return 0;
}

// P3: T steps of 2L launches (streamed_in, streamed_out a layer), chained by
// programmatic dependent launch, as a CUDA graph of a step replayed T times
// on `stream`.  cond_rule 0: bf16(h[:, :C]) at the step's start; 1: at every
// layer.  dil: host array of L dilations; slots >= sum 2d.  Device
// pointers: win (L, G/2 / 8, in bytes) and wout (L, blocks, out bytes) bf16
// fragments (bench_body.streamed_pack) and b (L, G) float32; scratch ring (slots, B, R),
// hb (B, R), condb (B, C) and gb (B, G/2) bf16 and tbase one int32; outputs
// h (B, R) and skip (B, S) float32.  *graph_us: host microseconds spent
// capturing and instantiating the graph, a part of the call.  Returns 0 or
// the first cudaError_t.
int dvc_probe_body_streamed(int cond_rule, int B, int T, int L, int R, int G, int S, int C,
                            const int* dil, int slots, const void* win, const void* wout,
                            const void* b, void* ring, void* hb, void* condb, void* gb,
                            void* tbase, void* h, void* skip, void* stream, double* graph_us) {
  Persist p{};
  int err = streamed_shape(p, B, L, R, G, S, C, cond_rule);
  if (err) return err;
  if (T < 0 || !win || !wout || !b || !graph_us) return (int)cudaErrorInvalidValue;
  err = set_dil(dil, L, slots, p.dil, p.offs);
  if (!err) err = streamed_attrs(p);
  if (err) return err;
  p.T = T;
  p.win = static_cast<const uint8_t*>(win);
  p.wout = static_cast<const uint8_t*>(wout);
  p.b = static_cast<const float*>(b);
  p.ring = static_cast<uint16_t*>(ring);
  p.hb = static_cast<uint16_t*>(hb);
  p.condb = static_cast<uint16_t*>(condb);
  p.gb = static_cast<uint16_t*>(gb);
  p.tbase = static_cast<int*>(tbase);
  p.h = static_cast<float*>(h);
  p.skip = static_cast<float*>(skip);

  const cudaStream_t st = (cudaStream_t)stream;
  const size_t hsz = (size_t)B * R, csz = (size_t)B * C;
  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * hsz * 2, st));
  DVC_CHECK(cudaMemsetAsync(skip, 0, (size_t)B * S * 4, st));
  DVC_CHECK(cudaMemsetAsync(tbase, 0, sizeof(int), st));
  // the probes' h at t = 0: ones, in float32 and as bf16 (h and the snapshot)
  fill_f32<<<(unsigned)((hsz + 255) / 256), 256, 0, st>>>(p.h, hsz, 1.f);
  DVC_CHECK(cudaGetLastError());
  fill_u16<<<(unsigned)((hsz + 255) / 256), 256, 0, st>>>(p.hb, hsz, 0x3f80);
  DVC_CHECK(cudaGetLastError());
  if (csz) {
    fill_u16<<<(unsigned)((csz + 255) / 256), 256, 0, st>>>(p.condb, csz, 0x3f80);
    DVC_CHECK(cudaGetLastError());
  }
  *graph_us = 0.0;
  if (T == 0) return 0;

  cudaStream_t cs = nullptr;  // capture only: nothing runs on it
  cudaGraphExec_t step = nullptr;
  const auto t0 = std::chrono::steady_clock::now();
  err = (int)cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (!err) err = capture_step(p, cs, &step);
  *graph_us = std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0)
                  .count();
  for (int t = 0; t < T && !err; ++t) err = (int)cudaGraphLaunch(step, st);
  if (step) cudaGraphExecDestroy(step);  // in flight, it is freed when its launches are done
  if (cs) cudaStreamDestroy(cs);
  return err ? err : (int)cudaGetLastError();
}
const char* dvc_probe_body_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
