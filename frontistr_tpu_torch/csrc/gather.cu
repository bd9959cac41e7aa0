// Gathers for Hopper (sm_90a): K3-K6.
//
// Replace the four TPU kernels of scripts/microbench_pallas_gather.py, a
// probe of Mosaic's in-VMEM `dynamic_gather` written for a future ELL
// SpMV.  On the TPU each kernel gathers inside VMEM.  Here K3 and K4 give
// every output element its own thread, which reads its source value
// straight from global memory; K5 and K6 stage their window in shared
// memory with coalesced loads and every thread writes one output element
// read from shared memory.  All four are float32 with int32 indices.
//
// Index rule (that of jnp.take_along_axis, which the TPU kernels call): an
// index k into an axis of n entries is used as k + n when -n <= k < 0;
// outside [-n, n) the gathered value is NaN.
//
//   K3 gather_rows   (`k1`, :44):  out[s,l] = x[i[s,l], l]
//      x (R, L), i (S, L) -> (S, L).
//   K4 gather_cols   (`k2`, :65):  out[s,l] = x[s, i[s,l]]
//      x (R, W), i (R, L) -> (R, L).
//   K5 window_gather (`k4`, :84) and K6 window_gather_tiled (`k5`, :114),
//      on 128 lanes, a window w of WINV*8 rows:
//          v = floor(iq[s,l] / 8)
//          out[s,l] = 0                                if v not in [0, WINV)
//                   = w[8v + (iq[s, p] mod 8), p]      p = ip[s,l]
//      with mod the floor modulo (always in [0, 8)).  This is what the TPU
//      bodies compute: the first take_along_axis gathers sublanes by
//      iq % 8, the second gathers those rows' lanes by ip, so the row
//      offset comes from iq at column p = ip[s,l] of the same row, not
//      from iq[s,l] as the script's comment (flat // 128, flat % 128)
//      says.  K5 is one window and one tile; K6 cuts the rows into tiles
//      of tile_rows (256 in the script), and tile t reads window block
//      t mod nwin of w (nwin*WINV*8 rows; `lambda t: (t % 4, 0)` with
//      nwin = 4 in the script).  The TPU's cascade over the WINV source
//      vregs exists because dynamic_gather reaches one vreg (8 sublanes)
//      at a time; one composed index reads shared memory directly, so it
//      is not carried over.
//
// What bounds them on an H100: device-memory bytes, with no arithmetic to
// count: each input read once and the output written once, at the
// script's shapes K3 98,304 B, K4 12,288 / 49,152 B, K5 45,056 B and K6
// 25,296,896 B, i.e. 0.029, 0.004 / 0.015, 0.013 and 7.55 us at
// 3.35 TB/s.  Every shape but K6's is far below one launch (1.4-2.1 us
// from a CUDA graph), so K3-K5 are bound by launch latency: on the
// device, the time from the launch to the last block's last store.
//
// What the design does about it:
//   - K3 and K4: one thread per output over the flattened (S, L) or
//     (R, L), 256 threads a block (32 blocks at K3's (8,1024), 16 at
//     K4's (8,512)): only the last block has idle threads, whatever L is.
//     A thread reads its index (coalesced), then its source value
//     through the read-only path (__ldg): a K4 row is at most 48 KB and
//     K3's source at the script's shape 32 KB, so it stays in L1/L2.  No
//     shared memory and no barrier, so a thread's latency is two dependent
//     loads and a store.  The staged design before it (8 blocks; K3
//     staged a column tile and walked the S rows in series, K4 staged a
//     row) waited at a barrier for the whole stage before its first
//     output: from a CUDA graph on an H100 it took 1.84 us at (8,1024)
//     and (8,512) where this one takes 1.50-1.54 us (both 1.45 us at
//     (8,128)).  An eager call also pays the host's cost of issuing the
//     launch; ops/gather.py keeps that short (see its docstring).
//   - K5/K6 keep a thread's second read, iq[s, p], inside its own row:
//     the block stages the rows it is writing, so one staged row serves
//     every lane of that row; their random lane reads of shared memory
//     conflict (not measured, not tuned);
//   - global loads and stores are coalesced (neighbouring threads on
//     neighbouring outputs); only the source reads are indexed;
//   - every output has one writer: relaunches are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;       // K3/K4 block: one thread an output
constexpr int kMaxRowsK3 = 64;      // K3 source rows taken
constexpr int kMaxWidthK4 = 12288;  // K4 source width taken (a 48 KB row)
constexpr int kLanes = 128;         // K5/K6 lanes
constexpr int kMaxWinRows = 64;     // K5/K6 window rows staged: 32 KB
constexpr int kWinThreads = 1024;   // 8 rows of 128 lanes per pass
constexpr int kRowsPerPass = kWinThreads / kLanes;

// The quiet NaN torch.full(..., nan) writes, so NaN outputs are bit-equal.
__device__ __forceinline__ float nan_f() {
  return __uint_as_float(0x7fc00000u);
}

__device__ __forceinline__ int wrap(int k, int n) {
  return k < 0 ? k + n : k;         // valid iff the result is in [0, n)
}

// Output t of n = S*L is (s, l) = (t / L, t % L).
__global__ void gather_rows_kernel(const float* __restrict__ x, int R,
                                   int L, const int* __restrict__ idx,
                                   long long n, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int l = (int)(t % L);
  const int k = wrap(__ldg(idx + t), R);
  out[t] = (k >= 0 && k < R) ? __ldg(x + (long long)k * L + l) : nan_f();
}

// Output t of n = R*L is (s, l) = (t / L, t % L).
__global__ void gather_cols_kernel(const float* __restrict__ x, int W,
                                   const int* __restrict__ idx, int L,
                                   long long n, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int k = wrap(__ldg(idx + t), W);
  out[t] = (k >= 0 && k < W) ? __ldg(x + (t / L) * W + k) : nan_f();
}

// One block writes rows [row0, row1) from window `w` (win_rows x 128).
__device__ void window_rows(const float* __restrict__ w, int win_rows,
                            const int* __restrict__ iq,
                            const int* __restrict__ ip, long long row0,
                            long long row1, float* __restrict__ out) {
  __shared__ float ws[kMaxWinRows * kLanes];
  __shared__ int iqs[kRowsPerPass * kLanes];
  const int t = threadIdx.x;
  const int lane = t % kLanes;
  const int r_in_pass = t / kLanes;
  for (int j = t; j < win_rows * kLanes; j += kWinThreads) ws[j] = w[j];
  const int winv = win_rows / 8;
  for (long long s0 = row0; s0 < row1; s0 += kRowsPerPass) {
    const long long s = s0 + r_in_pass;
    const bool live = s < row1;
    int q = 0, p = 0;
    if (live) {
      q = iq[s * kLanes + lane];
      p = ip[s * kLanes + lane];
      iqs[t] = q;
    }
    __syncthreads();                // window (first pass) and iq rows in
    if (live) {
      const int v = q >> 3;         // floor(q / 8)
      float val = 0.0f;
      if (v >= 0 && v < winv) {
        const int pl = wrap(p, kLanes);
        if (pl >= 0 && pl < kLanes) {
          const int row = 8 * v + (iqs[r_in_pass * kLanes + pl] & 7);
          val = ws[row * kLanes + pl];
        } else {
          val = nan_f();
        }
      }
      out[s * kLanes + lane] = val;
    }
    __syncthreads();                // iqs is rewritten by the next pass
  }
}

__global__ void window_gather_kernel(const float* __restrict__ w,
                                     int win_rows,
                                     const int* __restrict__ iq,
                                     const int* __restrict__ ip,
                                     long long S, float* __restrict__ out) {
  window_rows(w, win_rows, iq, ip, 0, S, out);
}

__global__ void window_gather_tiled_kernel(const float* __restrict__ w,
                                           int win_rows, int nwin,
                                           const int* __restrict__ iq,
                                           const int* __restrict__ ip,
                                           long long S, int tile_rows,
                                           float* __restrict__ out) {
  const long long t = blockIdx.x;
  const long long row0 = t * tile_rows;
  const long long row1 = row0 + tile_rows < S ? row0 + tile_rows : S;
  const float* wt = w + (t % nwin) * (long long)win_rows * kLanes;
  window_rows(wt, win_rows, iq, ip, row0, row1, out);
}

// The blocks of kThreads threads that cover n outputs, or -1 if they are
// more than a grid takes.
long long blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return b > 0x7fffffffLL ? -1 : b;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is to device
// memory, contiguous row-major: float32 values, int32 indices.  Each
// launches on `stream` of device `device` and returns 0, the cudaError_t
// of its launch, or -2 for sizes it does not take.

// K3: x (R, L), idx (S, L) -> out (S, L); R <= 64.
extern "C" int fstr_gather_rows(const void* x, int R, int L, const void* idx,
                                int S, void* out, void* stream, int device) {
  if (R < 1 || R > kMaxRowsK3 || L < 0 || S < 0) return -2;
  const long long n = (long long)S * L;
  const long long blocks = blocks_for(n);
  if (blocks < 0) return -2;
  if (n == 0) return 0;
  return on_device(device, [&] {
    gather_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), R, L, static_cast<const int*>(idx), n,
        static_cast<float*>(out));
  });
}

// K4: x (R, W), idx (R, L) -> out (R, L); W <= 12288.
extern "C" int fstr_gather_cols(const void* x, int R, int W, const void* idx,
                                int L, void* out, void* stream, int device) {
  if (R < 0 || W < 1 || W > kMaxWidthK4 || L < 0) return -2;
  const long long n = (long long)R * L;
  const long long blocks = blocks_for(n);
  if (blocks < 0) return -2;
  if (n == 0) return 0;
  return on_device(device, [&] {
    gather_cols_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), W, static_cast<const int*>(idx), L, n,
        static_cast<float*>(out));
  });
}

// K5: w (win_rows, 128), iq/ip (S, 128) -> out (S, 128); one block.
extern "C" int fstr_window_gather(const void* w, int win_rows,
                                  const void* iq, const void* ip,
                                  long long S, void* out, void* stream,
                                  int device) {
  if (win_rows < 8 || win_rows > kMaxWinRows || win_rows % 8 || S < 0)
    return -2;
  if (S == 0) return 0;
  return on_device(device, [&] {
    window_gather_kernel<<<1, kWinThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), win_rows, static_cast<const int*>(iq),
        static_cast<const int*>(ip), S, static_cast<float*>(out));
  });
}

// K6: w (nwin * win_rows, 128), iq/ip (S, 128) -> out (S, 128); one block
// per tile of tile_rows rows (the last one ragged), tile t on window
// block t % nwin.
extern "C" int fstr_window_gather_tiled(const void* w, int win_rows,
                                        int nwin, const void* iq,
                                        const void* ip, long long S,
                                        int tile_rows, void* out,
                                        void* stream, int device) {
  if (win_rows < 8 || win_rows > kMaxWinRows || win_rows % 8 || nwin < 1 ||
      tile_rows < 1 || S < 0)
    return -2;
  if (S == 0) return 0;
  const long long tiles = (S + tile_rows - 1) / tile_rows;
  if (tiles > 0x7fffffffLL) return -2;
  return on_device(device, [&] {
    window_gather_tiled_kernel<<<(unsigned)tiles, kWinThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), win_rows, nwin,
        static_cast<const int*>(iq), static_cast<const int*>(ip), S,
        tile_rows, static_cast<float*>(out));
  });
}
