// The device switch of the lean launch path (frontistr_tpu_torch/launch.py),
// shared by every C entry of the port's kernels.
#pragma once

#include <cuda_runtime.h>

// Runs `launch` with `device` current, then restores the caller's device;
// returns the first CUDA error (the launch's included) or 0.  The device is
// switched only when it is not already current.
template <class Launch>
inline int on_device(int device, Launch launch) {
  int caller = -1;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  launch();
  err = cudaGetLastError();
  if (caller != device) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
