// Sorted segment-sum assembly for Hopper (sm_90a).
//
// Replaces the TPU kernel frontistr_tpu/assembly/segsum_pallas.py
// (`_kernel`, launched from `make_segsum.run` and wrapped by
// `make_planes_segsum`).  For every destination slot s and each of the
// nd*nd value planes v = i*nd + j it computes
//
//     out[v, s] = sum_{k in [slot_ptr[s], slot_ptr[s+1])} ke(perm[k])[i, j]
//
// where perm lists the raw element pair entries in slot order and a raw
// entry p decodes, inside its element block, in pair order (a, b, e)
// with e fastest, to the (i, j) entry of the nd x nd sub-block (a, b) of
// that block's element matrix: ke_b[e, a*nd + i, b*nd + j].  Empty slots
// come out 0.
//
// What bounds it on an H100: device-memory bytes.  Per call it reads
// P*(4+4) bytes of index (perm, plus slot_ptr once per slot), P*nd*nd
// element-matrix values that are scattered at the granularity of one
// nd-wide row (perm order is slot order, not element order), and writes
// nd*nd*n_slots values.  There is no arithmetic worth counting.
//
// What the design does about it:
//   - one thread per slot walks its own sorted segment, so the sums need
//     no atomics and no second pass: the result is deterministic and
//     bit-equal from run to run, like the reference's sorted assembly;
//   - the perm gather and the plane relayout are fused: entries are read
//     straight from the (E, m, m) element matrices, so the (nd*nd, P)
//     entry planes the TPU path materializes never exist in memory;
//   - outputs are plane-major (nd*nd, n_slots), so neighbouring threads
//     (neighbouring slots) store to neighbouring addresses.
// The TPU design (one-hot MXU matmuls over slot-aligned chunks, window
// rows gathered back to slots) answers the TPU's lack of fast scatter and
// is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlocks = 8;
constexpr int kThreads = 256;

template <typename T>
struct BlockTable {
  const T* ke[kMaxBlocks];           // (E_b, m_b, m_b) row-major
  long long off[kMaxBlocks + 1];     // raw pair prefix offsets
  long long E[kMaxBlocks];
  int nn[kMaxBlocks];
  int nblk;
};

template <typename T, int ND>
__global__ void segsum_kernel(const int* __restrict__ slot_ptr,
                              const int* __restrict__ perm,
                              long long n_slots, BlockTable<T> bt,
                              T* __restrict__ out) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  T acc[ND * ND];
#pragma unroll
  for (int v = 0; v < ND * ND; ++v) acc[v] = T(0);
  const int k1 = slot_ptr[s + 1];
  for (int k = slot_ptr[s]; k < k1; ++k) {
    const long long p = perm[k];
    int b = 0;
    while (b + 1 < bt.nblk && p >= bt.off[b + 1]) ++b;
    const long long E = bt.E[b];
    const long long nnE = (long long)bt.nn[b] * E;
    const long long q = p - bt.off[b];
    const long long a = q / nnE;
    const long long r = q - a * nnE;
    const long long c = r / E;
    const long long e = r - c * E;
    const long long m = (long long)bt.nn[b] * ND;
    const T* row = bt.ke[b] + e * m * m + (a * ND) * m + c * ND;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i * ND + j] += row[i * m + j];
    }
  }
#pragma unroll
  for (int v = 0; v < ND * ND; ++v) out[v * n_slots + s] = acc[v];
}

template <typename T, int ND>
int launch(const int* slot_ptr, const int* perm, long long n_slots,
           const BlockTable<T>& bt, void* out, cudaStream_t stream) {
  if (n_slots == 0) return 0;
  const long long grid = (n_slots + kThreads - 1) / kThreads;
  segsum_kernel<T, ND><<<(unsigned)grid, kThreads, 0, stream>>>(
      slot_ptr, perm, n_slots, bt, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int nd, const int* slot_ptr, const int* perm,
             long long n_slots, const void* const* ke_ptrs,
             const long long* pair_off, const long long* E, const int* nn,
             int nblk, void* out, cudaStream_t stream) {
  BlockTable<T> bt;
  bt.nblk = nblk;
  for (int b = 0; b < nblk; ++b) {
    bt.ke[b] = static_cast<const T*>(ke_ptrs[b]);
    bt.off[b] = pair_off[b];
    bt.E[b] = E[b];
    bt.nn[b] = nn[b];
  }
  bt.off[nblk] = pair_off[nblk];
  // 3-D solids only (nd = 3); the 2-D and scalar cases come with the
  // element types that need them
  if (nd != 3) return -2;
  return launch<T, 3>(slot_ptr, perm, n_slots, bt, out, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers to device memory:
// slot_ptr (n_slots+1 int32), perm (P int32), each ke_ptrs[b], out
// (nd*nd*n_slots of the element type).  Host arrays: ke_ptrs, pair_off
// (nblk+1), E (nblk), nn (nblk).  is_double selects float64 over float32.
// Returns 0, a cudaError_t from the launch, -1 for too many blocks or -2
// for an unsupported nd.
extern "C" int fstr_segsum(int is_double, int nd, const int* slot_ptr,
                           const int* perm, long long n_slots,
                           const void* const* ke_ptrs,
                           const long long* pair_off, const long long* E,
                           const int* nn, int nblk, void* out,
                           void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return dispatch<double>(nd, slot_ptr, perm, n_slots, ke_ptrs, pair_off,
                            E, nn, nblk, out, st);
  return dispatch<float>(nd, slot_ptr, perm, n_slots, ke_ptrs, pair_off, E,
                         nn, nblk, out, st);
}
