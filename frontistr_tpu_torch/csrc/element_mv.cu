// SoA element matvec for Hopper (sm_90a).
//
// Replaces the TPU kernel frontistr_tpu/ops/pallas_mv.py (`_kernel`,
// launched from `element_matvec_soa`).  For every element e and row i
// of the hex8 element matrices (m = 24) it computes
//
//     fe[i, e] = sum_j keT[i, j, e] * xeT[j, e]
//
// with keT (m, m, E), xeT (m, E) and fe (m, E) row-major: the element
// axis is the contiguous one.  It is the matvec of the structured hex8
// operator (assembly/structured.py), run every CG iteration in float32
// and every refinement residual in float64.
//
// What bounds it on an H100: device-memory bytes.  Each call reads the
// m*m*E element matrices once (576 values per element), m*E inputs and
// writes m*E outputs, for 2*m*m*E flops: 2 flops per 4 or 8 bytes, far
// below the card's ratio of operations to bytes.
//
// What the design does about it:
//   - one thread per element, neighbouring threads on neighbouring
//     elements: each of the 576 keT loads of a warp is one coalesced
//     128-byte (f32) or 256-byte (f64) transaction, and keT is read
//     exactly once;
//   - the element's 24 inputs stay in registers and each row's sum is
//     accumulated in a register, so nothing is read or written twice;
//   - rows are unrolled in groups so that many independent loads are in
//     flight per thread, which is what keeps the memory system busy;
//   - no atomics: every output has one writer, so two launches give
//     bit-equal results;
//   - any E: the last block masks its ragged edge, so keT needs no
//     padding.
// The TPU design (the element axis padded to a 2048 multiple once at
// assembly, `block_e` sized to VMEM, an unrolled j-loop of rank-2 tiles
// because Mosaic would not lower a rank-3 reduce) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 24;          // hex8: 8 nodes x 3 dofs
constexpr int kThreads = 128;

template <typename T>
__global__ void element_mv_kernel(const T* __restrict__ keT,
                                  const T* __restrict__ xeT, long long E,
                                  T* __restrict__ fe) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  T x[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) x[j] = xeT[j * E + e];
#pragma unroll 4
  for (int i = 0; i < kM; ++i) {
    const T* row = keT + (long long)i * kM * E + e;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kM; ++j) acc += row[j * E] * x[j];
    fe[i * E + e] = acc;
  }
}

template <typename T>
int launch(const void* keT, const void* xeT, long long E, void* fe,
           cudaStream_t stream) {
  if (E == 0) return 0;
  const long long grid = (E + kThreads - 1) / kThreads;
  element_mv_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(keT), static_cast<const T*>(xeT), E,
      static_cast<T*>(fe));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers to device memory:
// keT (m*m*E), xeT (m*E), fe (m*E), all of the element type and
// contiguous.  is_double selects float64 over float32.  Returns 0, a
// cudaError_t from the launch, or -2 for an m other than 24.
extern "C" int fstr_element_mv(int is_double, int m, const void* keT,
                               const void* xeT, long long E, void* fe,
                               void* stream) {
  if (m != kM) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(keT, xeT, E, fe, st);
  return launch<float>(keT, xeT, E, fe, st);
}
