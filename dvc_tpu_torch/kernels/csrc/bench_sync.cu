// Hopper's exchange primitives, timed alone: the price of the barriers that
// the probe kernels' designs choose between (bench_taps.cu, probe_body.cu).
//
//   cluster  cooperative_groups' cluster.sync() (barrier.cluster arrive.release
//            / wait.acquire) in a loop, clusters of 2-16 CTAs;
//   counter  the grid barrier of probe_body.cu's body_mma: a release add to an
//            arrival count in device memory and acquire polls until it
//            reaches n x blocks, by one thread a block, in a loop;
//   grid     cooperative_groups' grid sync (cudaLaunchCooperativeKernel), in
//            a loop;
//   launch   a chain of empty dependent kernels (the price of a launch, which
//            probe_body.cu's P3 pays 2L times a step against P2's grid
//            barriers): launched one by one into a stream, with and without
//            programmatic dependent launch, or replayed from a CUDA graph,
//            with plain or programmatic edges.
// One launch of `iters` barriers; the caller times it (the launch chain is
// timed here, between two events, without the graph's instantiation).  Each block asks for
// `smem` bytes of shared memory, so that a large value holds one block an SM
// as the probe kernels do.  No TPU kernel is replaced: this is a measurement
// of the card, not a port.  It is bound by latency, not by bytes or
// operations.  Every poll traps after kSpinLimit tries instead of hanging.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr long long kSpinLimit = 1ll << 24;

__global__ void __launch_bounds__(kThreads) cluster_loop(int iters) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cl.sync();
}

__global__ void __launch_bounds__(kThreads) counter_loop(int iters, unsigned int* count) {
  for (int i = 1; i <= iters; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
      const unsigned int target = (unsigned int)i * gridDim.x;
      for (long long spins = 0;; ++spins) {
        unsigned int v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
        if ((int)(v - target) >= 0) break;
        if (spins > kSpinLimit) __trap();
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) grid_loop(int iters) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < iters; ++i) g.sync();
}

// a link of a launch chain: lets the next kernel start and waits for the one
// before (both no-ops without the programmatic launch attribute)
__global__ void __launch_bounds__(kThreads) chain_link() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

int chain_launch(int blocks, bool pdl, cudaStream_t st) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, chain_link);
}

#define DVC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks, int cluster,
                    int smem, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

int cluster_attrs(int cluster, int smem) {
  DVC_CHECK(cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (cluster > 8)
    DVC_CHECK(cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return 0;
}

}  // namespace

extern "C" {

// cudaOccupancyMaxActiveClusters for clusters of `cluster` CTAs of
// kThreads threads and `smem` bytes each, into *out.
int dvc_sync_cluster_occupancy(int cluster, int smem, int* out) {
  if (cluster < 1 || cluster > 16 || smem < 0) return (int)cudaErrorInvalidValue;
  int err = cluster_attrs(cluster, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, cluster, smem, 0);
  DVC_CHECK(cudaOccupancyMaxActiveClusters(out, (const void*)cluster_loop, &cfg));
  return 0;
}

// kind 0: cluster barriers (blocks a multiple of cluster); 1: the counter
// grid barrier (count: one zeroed uint32 in device memory); 2: the
// cooperative_groups grid barrier.  One launch of `iters` barriers on
// `stream`.  Returns 0 or the first cudaError_t; a grid that cannot be
// co-resident is refused.
int dvc_sync_loop(int kind, int blocks, int cluster, int smem, int iters, void* count,
                  void* stream) {
  if (kind < 0 || kind > 2 || blocks < 1 || iters < 0 || smem < 0 ||
      (kind == 0 && (cluster < 1 || cluster > 16 || blocks % cluster)) || (kind == 1 && !count))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) {
    int err = cluster_attrs(cluster, smem);
    if (err) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, blocks, cluster, smem, st);
    DVC_CHECK(cudaLaunchKernelEx(&cfg, cluster_loop, iters));
    return (int)cudaGetLastError();
  }
  const void* fn = kind == 1 ? (const void*)counter_loop : (const void*)grid_loop;
  int dev = 0, sms = 0, per_sm = 0;
  DVC_CHECK(cudaGetDevice(&dev));
  DVC_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  DVC_CHECK(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  DVC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem));
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (kind == 1) {
    DVC_CHECK(cudaMemsetAsync(count, 0, sizeof(unsigned int), st));
    void* args[] = {&iters, &count};
    DVC_CHECK(cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, smem, st));
  } else {
    void* args[] = {&iters};
    DVC_CHECK(cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, smem, st));
  }
  return (int)cudaGetLastError();
}

// A chain of n launches of chain_link, `blocks` blocks each.  mode 0: into
// `stream` one by one; 1: the same with programmatic dependent launch; 2: a
// CUDA graph of the n launches (captured and instantiated first); 3: the
// graph with programmatic edges.  One warm round, then `reps` rounds between
// two events: *us is microseconds a launch.  Returns 0 or the first
// cudaError_t.
int dvc_sync_launch_chain(int mode, int blocks, int n, int reps, void* stream, double* us) {
  if (mode < 0 || mode > 3 || blocks < 1 || n < 1 || reps < 1 || !us)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool pdl = mode & 1, graph = mode >= 2;
  cudaStream_t cs = nullptr;
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaEvent_t e0 = nullptr, e1 = nullptr;
  int err = (int)cudaEventCreate(&e0);
  if (!err) err = (int)cudaEventCreate(&e1);
  if (!err && graph) {
    err = (int)cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
    if (!err) err = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
    if (!err) {
      for (int i = 0; i < n && !err; ++i) err = chain_launch(blocks, pdl && i > 0, cs);
      const int end = (int)cudaStreamEndCapture(cs, &g);  // ends the capture on any error
      if (!err) err = end;
    }
    if (!err) err = (int)cudaGraphInstantiate(&exec, g, 0);
  }
  auto one_round = [&]() -> int {
    if (graph) return (int)cudaGraphLaunch(exec, st);
    for (int i = 0; i < n; ++i) {
      const int e = chain_launch(blocks, pdl && i > 0, st);
      if (e) return e;
    }
    return 0;
  };
  if (!err) err = one_round();
  if (!err) err = (int)cudaEventRecord(e0, st);
  for (int r = 0; r < reps && !err; ++r) err = one_round();
  if (!err) err = (int)cudaEventRecord(e1, st);
  if (!err) err = (int)cudaEventSynchronize(e1);
  float ms = 0.f;
  if (!err) err = (int)cudaEventElapsedTime(&ms, e0, e1);
  if (!err) *us = ms * 1e3 / ((double)n * reps);
  if (exec) cudaGraphExecDestroy(exec);
  if (g) cudaGraphDestroy(g);
  if (cs) cudaStreamDestroy(cs);
  if (e0) cudaEventDestroy(e0);
  if (e1) cudaEventDestroy(e1);
  return err ? err : (int)cudaGetLastError();
}

const char* dvc_sync_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
