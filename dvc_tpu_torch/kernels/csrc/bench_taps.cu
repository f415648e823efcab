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
// float32 throughout, as the probe: the ring (slots, B, R), h (B, R) and w
// (R, R) in (in, out) layout.  The output is the final h.
//
// What bounds it on an H100.  24 x B x R^2 multiply-adds per sample step in
// float32 outside the tensor cores: 50.3 MFLOP a step at B = 8, R = 512,
// 0.75 us at 67 TFLOP/s, 3.00 ms for the probe's 2000 steps; w is 1 MB and
// is read once.  Every layer depends on the whole previous h, so in practice
// the serial chain of L x T dependent layers bounds it.
//
// Design.  One cooperative launch for the whole run: the probe's sequential
// grid becomes a loop over (t, l) inside the kernel.  The blocks split the
// R output columns (4 a block at R = 512 on 132 SMs) and keep their columns
// of w in shared memory for the whole run (8 KB each; the 1 MB of w never
// leaves the chip after the first read).  Per layer each block stages the
// layer input u = x_{t-d} + x_{t-2d} + h for all B rows (16 KB) from L2, all
// of a thread's 16-byte loads in flight at once, computes its columns with
// one warp per (column, row) output, and writes
// tanh into the other half of a ping-pong h.  One grid barrier per layer
// (cooperative_groups grid sync; cudaLaunchCooperativeKernel refuses a grid
// that cannot be co-resident instead of hanging) makes the new h whole
// before the next layer reads it.  The ring write of the layer input into
// slot x_{t-2d} comes after that barrier, when every block has staged the
// slot: each block writes its own columns, which only it writes in h.
// Data written inside the kernel is read with ld.global.cg (L2, coherent
// across SMs), never through the non-coherent L1 / read-only paths.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4;  // float4 chunks in flight per thread while staging
constexpr int kMaxLayers = 64;
constexpr int kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory a block

struct Taps {
  int mode, B, R, T, L, ncols;
  int dil[kMaxLayers], offs[kMaxLayers];
  const float* w;  // (R, R), (in, out)
  float* ring;     // (slots, B, R), zeroed by the host
  float* h;        // (2, B, R): layer n reads half n & 1, writes the other
  float* out;      // (B, R)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 sum3(float4 a, float4 b, float4 c) {  // (a + b) + c
  return make_float4(a.x + b.x + c.x, a.y + b.y + c.y, a.z + b.z + c.z, a.w + b.w + c.w);
}

// u = x_{t-d} + x_{t-2d} + h (compute: h + h + h) over n4 float4 chunks, a
// thread's kStage chunks loaded before the first is used: one round trip
// to L2 per kStage chunks instead of one per element
__device__ void stage(float* u, const float* h, const float* x1, const float* x2, int n4,
                      bool compute) {
  for (int c0 = threadIdx.x; c0 < n4; c0 += kStage * blockDim.x) {
    float4 hv[kStage], a[kStage], b[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < n4) {
        hv[k] = __ldcg(reinterpret_cast<const float4*>(h) + c);
        if (!compute) {
          a[k] = __ldcg(reinterpret_cast<const float4*>(x1) + c);
          b[k] = __ldcg(reinterpret_cast<const float4*>(x2) + c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < n4)
        reinterpret_cast<float4*>(u)[c] =
            compute ? sum3(hv[k], hv[k], hv[k]) : sum3(a[k], b[k], hv[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) taps_kernel(Taps p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int B = p.B, R = p.R;
  const int c0 = blockIdx.x * p.ncols;
  const int nc = min(p.ncols, R - c0);  // this block's output columns
  float* wt = sm;                       // (ncols, R): row c is w[:, c0 + c]
  float* u = sm + (size_t)p.ncols * R;  // (B, R): the layer input
  const size_t hsz = (size_t)B * R;
  for (int i = threadIdx.x; i < nc * R; i += blockDim.x) {
    const int c = i / R, k = i - c * R;
    wt[i] = p.w[(size_t)k * R + c0 + c];
  }
  for (int i = threadIdx.x; i < B * nc; i += blockDim.x) {
    const int b = i / nc, c = i - b * nc;
    p.h[(size_t)b * R + c0 + c] = 1.f;  // the probe's h at t = 0
  }
  grid.sync();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int t = 0; t < p.T; ++t) {
    for (int l = 0; l < p.L; ++l) {
      const int n = t * p.L + l;
      const float* hin = p.h + (size_t)(n & 1) * hsz;
      float* hout = p.h + (size_t)((n + 1) & 1) * hsz;
      int s2 = 0, s1 = 0;  // slots of x_{t-2d} (written below) and x_{t-d}
      if (p.mode == 0) {
        const int d = p.dil[l], wp = t % (2 * d);
        s2 = p.offs[l] + wp;
        s1 = p.offs[l] + (wp + d) % (2 * d);
      } else if (p.mode == 1) {
        s2 = 2 * l;
        s1 = 2 * l + 1;
      }
      const float* x2 = p.ring + (size_t)s2 * hsz;
      const float* x1 = p.ring + (size_t)s1 * hsz;
      stage(u, hin, x1, x2, B * R / 4, p.mode == 2);
      __syncthreads();
      for (int q = warp; q < nc * B; q += nw) {
        const int c = q / B, b = q - c * B;
        const float* ub = u + (size_t)b * R;
        const float* wc = wt + (size_t)c * R;
        float acc = 0.f;
        for (int k = lane; k < R; k += 32) acc = fmaf(ub[k], wc[k], acc);
        acc = warp_sum(acc);
        if (lane == 0) hout[(size_t)b * R + c0 + c] = tanhf(acc);
      }
      grid.sync();  // the new h is whole; every block has staged slot s2
      if (p.mode != 2) {
        float* ring_w = p.ring + (size_t)s2 * hsz;
        for (int i = threadIdx.x; i < B * nc; i += blockDim.x) {
          const int b = i / nc, c = i - b * nc;
          const size_t e = (size_t)b * R + c0 + c;
          ring_w[e] = __ldcg(hin + e);
        }
        // with one layer no other barrier comes before the next step reads
        // the slot (at d = 1, x_{t+1-d} is the slot just written)
        if (p.L == 1) grid.sync();
      }
    }
  }
  const float* hf = p.h + (size_t)((p.T * p.L) & 1) * hsz;  // written by this block
  for (int i = threadIdx.x; i < B * nc; i += blockDim.x) {
    const int b = i / nc, c = i - b * nc;
    const size_t e = (size_t)b * R + c0 + c;
    p.out[e] = __ldcg(hf + e);
  }
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" {

// mode 0 dynamic, 1 static, 2 compute.  dil: host array of L dilations (the
// ring offsets are their running sum of 2d); slots: the ring's length, at
// least max(sum 2d, 2L).  w (R, R), ring (slots, B, R), h (2, B, R) and out
// (B, R) are float32 device pointers.  Returns 0 or the first cudaError_t.
int dvc_probe_taps(int mode, int B, int R, int T, int L, const int* dil, int slots,
                   const void* w, void* ring, void* h, void* out, void* stream) {
  if (mode < 0 || mode > 2 || B <= 0 || R <= 0 || R % 4 || T < 0 || L <= 0 || L > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Taps p{};
  p.mode = mode;
  p.B = B;
  p.R = R;
  p.T = T;
  p.L = L;
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
  p.ring = static_cast<float*>(ring);
  p.h = static_cast<float*>(h);
  p.out = static_cast<float*>(out);
  int dev = 0, sms = 0, per_sm = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  p.ncols = (R + sms - 1) / sms;
  const int nblk = (R + p.ncols - 1) / p.ncols;
  const size_t smem = ((size_t)p.ncols * R + (size_t)B * R) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  DVC_CHECK(cudaFuncSetAttribute(taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, taps_kernel, kThreads, smem));
  if (per_sm * sms < nblk) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t st = (cudaStream_t)stream;
  DVC_CHECK(cudaMemsetAsync(ring, 0, (size_t)slots * B * R * sizeof(float), st));
  void* args[] = {&p};
  DVC_CHECK(cudaLaunchCooperativeKernel((const void*)taps_kernel, dim3(nblk), dim3(kThreads),
                                        args, smem, st));
  return (int)cudaGetLastError();
}

const char* dvc_probe_taps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
