// One launch of a kernel whose blocks form thread-block clusters along x,
// for the kernels that split work over a cluster and merge it through
// distributed shared memory (nn.cu, splat.cu).

#pragma once

#include <cuda_runtime.h>

// Launches `kernel` on `grid` blocks of `threads` threads in clusters of
// `cluster_x` blocks along x; returns the launch's error.
template <typename Kernel, typename... Args>
inline cudaError_t launch_clusters(Kernel kernel, dim3 grid, int threads, int cluster_x,
                                   void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
