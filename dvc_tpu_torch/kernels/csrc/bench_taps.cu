// Ring-tap probe (P1) on Hopper: a serial recurrence over T samples of L
// layers, each h = tanh((x_{t-d} + x_{t-2d} + h) @ w), with the layer input
// written into a ring of past inputs.
//
// Replaces the TPU kernel of tools/bench_taps.py: `make(mode)` (:20-72,
// pl.pallas_call at :66), a sequential grid (T,) whose body reads two ring
// taps per layer from VMEM.  Modes, as there:
//   0 dynamic  taps at slots off + (t mod 2d) (x_{t-2d}, overwritten with
//              the layer input) and off + ((t mod 2d) + d) mod 2d (x_{t-d});
//   1 static   taps at fixed slots 2l (overwritten) and 2l + 1 (never
//              written, so always zero);
//   2 compute  no ring: y = (h + h + h) @ w.
// float32 throughout, as the probe: h (B, R) and w (R, R) in (in, out)
// layout.  The output is the final h.
//
// What bounds it on an H100.  24 x B x R^2 multiply-adds per sample step in
// float32 outside the tensor cores: 50.3 MFLOP a step at B = 8, R = 512,
// 0.75 us at 67 TFLOP/s, 3.00 ms for the probe's 2000 steps; w is 1 MB and
// is read once.  Every layer depends on the whole previous h of its row, so
// in practice the serial chain of L x T dependent layers bounds it, and
// each link of the chain costs one exchange of h between the SMs that hold
// the row's channels.
//
// What held the first design back (on one NVIDIA H100 80GB HBM3 at 700 W):
// one cooperative launch over 128 blocks with a grid barrier after every
// layer, 48,000 a call at T = 2000, each block staging the whole 16 KB u =
// x_{t-d} + x_{t-2d} + h of all B rows from L2 every layer: 4.0-4.4 us a
// layer, 192.2-209.7 ms a call.  Yet the body mixes no batch rows (u @ w
// and tanh are row-wise), so the grid-wide chain was needless.
//
// Design.  One thread-block cluster of kCluster CTAs per batch row, and no
// grid barrier: clusters never wait on each other, so B above the number of
// co-resident clusters runs in waves, and a call is still one launch.  CTA
// j of a cluster owns channels [j R/n, (j+1) R/n) of h, u and the ring and
// the same output columns of w.  The cluster size: 8.  On the H100
// cudaOccupancyMaxActiveClusters reads 15 clusters of 8 and 7 of 16 at one
// CTA an SM (tools/bench_sync), so 16 would run the probe's B = 8 rows in
// two waves.  At 8 a CTA
// owns 64 columns: its 512 x 64 slice of w (128 KB) stays in registers for
// the whole call (512 threads, 64 values each: thread (s, c) holds rows
// [64 s, 64 s + 64) of column c), which leaves shared memory to its slice
// of the ring, 504 slots x 64 channels (129 KB), local and never read by
// another CTA (so it needs no copy from device memory).  Per layer n:
//   1. wait on this CTA's mbarrier of u buffer n & 1 until the layer's
//      whole input has landed (2 KB: 256 bytes from each of the 8 CTAs);
//   2. each thread's 64-term dot of its rows of u with its w column, u read
//      from shared memory as broadcast 16-byte loads, 4 chains in flight;
//   3. the 8 slices' sums in shared memory (double-buffered), one block
//      barrier, and tanh, by 64 threads;
//   4. those threads form their channels of the NEXT layer's input u' =
//      x'_{t-d} + x'_{t-2d} + h from the local ring, write the layer input
//      h into its slot x'_{t-2d}, and send u' to every CTA of the cluster
//      (itself included) with st.async into distributed shared memory, a
//      lane quad's 4 channels as one 16-byte store that completes its bytes
//      on the receiver's mbarrier of u buffer (n + 1) & 1.
// No cluster barrier a layer: a CTA waits only for its own input, and the
// sender never waits.  Two u buffers make that safe: a CTA writes a peer's
// buffer n + 1 only after the peer's input n has come from it, i.e. after
// the peer finished layer n - 1 with that buffer; a receiver arms buffer
// n & 1's mbarrier for layer n + 2 right after its wait for layer n, before
// any peer can send layer n + 2.  A cluster barrier a layer would cost
// 0.50-0.61 us of it by itself at 8 CTAs (tools/bench_sync).  The dots are float32
// FMAs, not TF32: the check is 1e-4 of the max.  A plan that does not fit
// (R other than kCluster x kCols, or a ring over the shared memory) is
// refused, as is a launch with no co-resident cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                // CTAs a batch row
constexpr int kThreads = 512;
constexpr int kCols = 64;                  // channels a CTA
constexpr int kR = kCluster * kCols;       // the only R a plan takes (the probe's 512)
constexpr int kSlices = kThreads / kCols;  // row slices of w a column is split into
constexpr int kKPT = kR / kSlices;         // w values a thread keeps in registers
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;           // H100: 227 KB of dynamic shared memory a block

static_assert(kThreads % kCols == 0 && kR % kSlices == 0 && kKPT % 4 == 0, "plan");
static_assert(kCluster % 4 == 0 && kCols % 32 == 0, "a lane quad sends to kCluster / 4 peers");

struct Taps {
  int mode, B, T, L, slots;
  int dil[kMaxLayers], offs[kMaxLayers];
  const float* w;  // (R, R), (in, out)
  float* out;      // (B, R)
};

// shared memory of a CTA: ring (slots, kCols) | u (2, kR) | part (2, kSlices,
// kCols), float32 | two mbarriers
size_t smem_bytes(int slots) {
  return ((size_t)slots * kCols + 2 * kR + 2 * kSlices * kCols) * sizeof(float) + 16;
}

constexpr long long kSpinLimit = 1ll << 24;  // polls before a wait traps instead of hanging

__device__ __forceinline__ void slots_of(const Taps& p, int t, int l, int* s2, int* s1) {
  if (p.mode == 0) {
    const int d = p.dil[l], wp = t % (2 * d);
    *s2 = p.offs[l] + wp;
    *s1 = p.offs[l] + (wp + d) % (2 * d);
  } else {
    *s2 = 2 * l;
    *s1 = 2 * l + 1;
  }
}

// channel c's layer input sum of layer (t, l) from the layer input h, the
// ring write of h into slot x_{t-2d} after the taps are read
__device__ __forceinline__ float layer_input(const Taps& p, float* ring, int t, int l, int c,
                                             float h) {
  if (p.mode == 2) return (h + h) + h;
  int s2, s1;
  slots_of(p, t, l, &s2, &s1);
  const float v = (ring[s1 * kCols + c] + ring[s2 * kCols + c]) + h;
  ring[s2 * kCols + c] = h;
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// this CTA's address `a` in the shared memory of CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// the bytes of the next input of u buffer `m`'s layer, expected on its mbarrier
__device__ __forceinline__ void expect_input(uint32_t mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
               "r"((uint32_t)(kR * sizeof(float)))
               : "memory");
}

__device__ __forceinline__ void wait_input(uint32_t mbar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// channel c's input value v into u buffer `buf` of every CTA of the
// cluster, completing on that CTA's mbarrier of the buffer: the 4 channels
// of a lane quad go as one 16-byte st.async, lane q of the quad sending to
// peers q and q + 4
__device__ __forceinline__ void send_input(float v, int c, int j, float* u, int buf,
                                           uint64_t* mbar) {
  const int lane = threadIdx.x & 31, base = lane & ~3, q = lane & 3;
  const float v0 = __shfl_sync(0xffffffffu, v, base), v1 = __shfl_sync(0xffffffffu, v, base + 1);
  const float v2 = __shfl_sync(0xffffffffu, v, base + 2), v3 = __shfl_sync(0xffffffffu, v, base + 3);
  const uint32_t dst = smem_u32(u + buf * kR + j * kCols + (c & ~3)), mb = smem_u32(mbar + buf);
#pragma unroll
  for (int k = 0; k < kCluster / 4; ++k) {
    const int peer = q + 4 * k;
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(peer_addr(dst, peer)),
        "f"(v0), "f"(v1), "f"(v2), "f"(v3), "r"(peer_addr(mb, peer))
        : "memory");
  }
}

__global__ void __launch_bounds__(kThreads, 1) taps_cluster(Taps p) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float4 sm4[];
  float* ring = reinterpret_cast<float*>(sm4);    // (slots, kCols)
  float* u = ring + (size_t)p.slots * kCols;      // (2, kR): layer n's input in buffer n & 1
  float* part = u + 2 * kR;                       // (2, kSlices, kCols)
  uint64_t* mbar = reinterpret_cast<uint64_t*>(part + 2 * kSlices * kCols);  // one a buffer
  const int j = (int)cl.block_rank();
  const int b = blockIdx.x / kCluster;
  const int c = threadIdx.x % kCols, s = threadIdx.x / kCols;
  float* out = p.out + (size_t)b * kR + j * kCols;

  float w[kKPT];  // rows [s kKPT, (s + 1) kKPT) of output column j kCols + c
#pragma unroll
  for (int i = 0; i < kKPT; ++i) w[i] = __ldg(p.w + (size_t)(s * kKPT + i) * kR + j * kCols + c);
  if (p.mode != 2)
    for (int i = threadIdx.x; i < p.slots * kCols; i += kThreads) ring[i] = 0.f;
  const int total = p.T * p.L;
  if (total == 0) {  // the probe's h at t = 0
    if (s == 0) out[c] = 1.f;
    return;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(mbar + i)) : "memory");
      if (i < total) expect_input(smem_u32(mbar + i));  // layers 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();  // every CTA of the cluster runs, its mbarriers armed, before any send
  if (s == 0) send_input(layer_input(p, ring, 0, 0, c, 1.f), c, j, u, 0, mbar);

  int t = 0, l = 0;  // the layer (t, l) = n
  for (int n = 0; n < total; ++n) {
    wait_input(smem_u32(mbar + (n & 1)), (uint32_t)((n >> 1) & 1));
    // buffer n & 1 is whole and every peer has read it as layer n - 2's
    // input; arm its mbarrier for layer n + 2
    if (threadIdx.x == 0 && n + 2 < total) expect_input(smem_u32(mbar + (n & 1)));
    const float4* ub = reinterpret_cast<const float4*>(u + (n & 1) * kR + s * kKPT);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKPT / 4; ++i) {
      const float4 x = ub[i];
      acc[0] = fmaf(x.x, w[4 * i], acc[0]);
      acc[1] = fmaf(x.y, w[4 * i + 1], acc[1]);
      acc[2] = fmaf(x.z, w[4 * i + 2], acc[2]);
      acc[3] = fmaf(x.w, w[4 * i + 3], acc[3]);
    }
    float* pn = part + (n & 1) * kSlices * kCols;
    pn[s * kCols + c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();
    if (++l == p.L) {
      l = 0;
      ++t;
    }
    if (s == 0) {
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) a += pn[q * kCols + c];
      const float h = tanhf(a);
      if (n + 1 < total)
        send_input(layer_input(p, ring, t, l, c, h), c, j, u, (n + 1) & 1, mbar);
      else
        out[c] = h;
    }
  }
  cl.sync();  // no CTA leaves while a peer's sends to it may be in flight
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

int configure(int slots, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid,
              cudaStream_t st) {
  if (slots < 0 || smem_bytes(slots) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(slots);
  DVC_CHECK(cudaFuncSetAttribute(taps_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

// The plan of a call: plan[0..4] = cluster size, channels a CTA, threads a
// CTA, shared-memory bytes a CTA, and the card's cudaOccupancyMaxActive-
// Clusters for it.  Returns 0, cudaErrorInvalidValue for a plan that does
// not fit (R != kCluster x kCols, or the ring over the shared memory), or
// the first cudaError_t.
int dvc_probe_taps_plan(int R, int slots, int* plan) {
  if (R != kR) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = configure(slots, &cfg, &attr, kCluster, 0);
  if (err) return err;
  int active = 0;
  DVC_CHECK(cudaOccupancyMaxActiveClusters(&active, (const void*)taps_cluster, &cfg));
  plan[0] = kCluster;
  plan[1] = kCols;
  plan[2] = kThreads;
  plan[3] = (int)smem_bytes(slots);
  plan[4] = active;
  return 0;
}

// mode 0 dynamic, 1 static, 2 compute.  dil: host array of L dilations (the
// ring offsets are their running sum of 2d); slots: the ring's length, at
// least max(sum 2d, 2L).  w (R, R) and out (B, R) are float32 device
// pointers.  One cluster launch of B x kCluster CTAs.  Returns 0 or the
// first cudaError_t (cudaErrorInvalidValue for a plan that does not fit).
int dvc_probe_taps(int mode, int B, int R, int T, int L, const int* dil, int slots,
                   const void* w, void* out, void* stream) {
  if (mode < 0 || mode > 2 || B <= 0 || R != kR || T < 0 || L <= 0 || L > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Taps p{};
  p.mode = mode;
  p.B = B;
  p.T = T;
  p.L = L;
  p.slots = mode == 2 ? 0 : slots;
  int need = 2 * L;
  for (int l = 0, off = 0; l < L; ++l) {
    if (dil[l] <= 0) return (int)cudaErrorInvalidValue;
    p.dil[l] = dil[l];
    p.offs[l] = off;
    off += 2 * dil[l];
    need = off > need ? off : need;
  }
  if (slots < need) return (int)cudaErrorInvalidValue;
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = configure(p.slots, &cfg, &attr, B * kCluster, (cudaStream_t)stream);
  if (err) return err;
  int active = 0;
  DVC_CHECK(cudaOccupancyMaxActiveClusters(&active, (const void*)taps_cluster, &cfg));
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  DVC_CHECK(cudaLaunchKernelEx(&cfg, taps_cluster, p));
  return (int)cudaGetLastError();
}

const char* dvc_probe_taps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
