// Gathers for Hopper (sm_90a): K3-K6.
//
// Replace the four TPU kernels of scripts/microbench_pallas_gather.py, a
// probe of Mosaic's in-VMEM `dynamic_gather` written for a future ELL
// SpMV.  On the TPU each kernel gathers inside VMEM.  Here every kernel
// reads its indices straight from global memory and its source values
// through the read-only path, with no shared memory and no barrier: K3
// and K4 give every output element its own thread, K5 and K6 every row
// of output its own warp.  All four are float32 with int32 indices.
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
//      says.  K6 cuts the rows into tiles of tile_rows (256 in the
//      script), and row s reads window block (s / tile_rows) mod nwin of
//      w (nwin*WINV*8 rows; `lambda t: (t % 4, 0)` with nwin = 4 in the
//      script); K5 is K6 with nwin = 1 and one tile, so one kernel body
//      serves both.  The TPU's cascade over the WINV source vregs exists
//      because dynamic_gather reaches one vreg (8 sublanes) at a time;
//      one composed index reads the window directly, so it is not
//      carried over.
//
// What bounds them on an H100: device-memory bytes, with no arithmetic to
// count: each input read once and the output written once, at the
// script's shapes K3 98,304 B, K4 12,288 / 49,152 B, K5 45,056 B and K6
// 25,296,896 B, i.e. 0.029, 0.004 / 0.015, 0.013 and 7.55 us at
// 3.35 TB/s.  Every shape but K6's is far below one launch (1.4-2.1 us
// from a CUDA graph), so K3-K5 are bound by launch latency: on the
// device, the time from the launch to the last block's last store.  K6
// is bound by its 25 MB: iq and ip (8 MB each) are read once, the output
// (8 MB) written once, and only the 128 KB of window blocks is read
// again, from L1/L2.
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
//   - K5 and K6, what the staged design before it missed (on an H100,
//     from a CUDA graph: K6 16.2 us, 47% of its bound; K5 2.07 us, 0.7 us
//     above K3).  It took the TPU's grid as the CUDA grid: one block of
//     1,024 threads per tile, 64 blocks on 132 SMs at K6's shape, and K5
//     one block.  Each block first copied its 32 KB window block into
//     shared memory and waited at a barrier, then walked its 256 rows in
//     32 passes of 8 rows, each pass a 4-byte load of iq and of ip a
//     thread, a barrier, a shared-memory read, a store and a second
//     barrier.  So at most 64 x 1,024 x 8 B = 512 KB were in flight,
//     where 3.35 TB/s at 0.6-0.8 us of latency needs 2-2.7 MB, and 32
//     serial passes of about 0.5 us came to the 16 us measured.
//   - K5 and K6 now: a warp owns whole rows of output, lane j lanes
//     4j..4j+3.  It loads its 4 iq and 4 ip as one 16-byte vector each,
//     with the streaming hint (__ldcs: read once), and issues the next
//     row's two loads before it uses the current row's.  iq[s, p] comes
//     from lane p/4 by warp shuffle: each lane packs its four iq mod 8
//     into the bytes of one word, so an output costs one shuffle.  The
//     four window values come through __ldg, all four reads issued
//     before any is used (a window block is at most 32 KB and the
//     script's four 128 KB, so they stay in L1/L2), and the 4 outputs
//     go out as one 16-byte streaming store (__stcs).  No shared memory,
//     no barrier.  The grid is chosen for the card, not the TPU's tiles:
//     a row a warp, in blocks of kWinWarps warps but no more blocks than
//     fit on the card at once (the occupancy API's count times the SM
//     count, once per device, with the L1 at its largest), and a
//     grid-stride loop past that; when there are no more rows than SMs,
//     blocks of one warp, so each row's window reads fill an L1 of their
//     own.  A row count that is no multiple of the rows a block takes
//     leaves whole warps idle, never part of a row.  Row indices are
//     32-bit (S < 2^31 - 8: a 2^31-row input would be 1 TB).
//   - Those choices, each held against the others in one call on an
//     H100 (microbench/gather.py; PERF.md has the runs): blocks of 8
//     warps and not 2 or 1 (K6 from a CUDA graph 10.2 us against 12.5
//     and 17.1 us); blocks of one warp for no more rows than SMs (K5
//     1.58 us against 1.81 us); the streaming hint on the index loads
//     (K6 with a cold L2 16.0 us, against 16.4-16.5 us with __ldg and
//     16.1-16.2 us with no L1 allocation, though __ldg is 2 us faster
//     from a warm L2); the four window reads issued before any is used
//     (K5 1.82 us against 2.00 us, where the compiler had put a select
//     between them).
//   - every output has one writer: relaunches are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;       // K3/K4 block: one thread an output
constexpr int kMaxRowsK3 = 64;      // K3 source rows taken
constexpr int kMaxWidthK4 = 12288;  // K4 source width taken (a 48 KB row)
constexpr int kLanes = 128;         // K5/K6 lanes: 4 a thread of a warp
constexpr int kMaxWinRows = 64;     // K5/K6 window rows: 32 KB
constexpr int kWinWarps = 8;        // K5/K6 block: a row a warp at a time
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kMaxDevices = 64;

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

// The window gather: warp r of the grid writes rows r, r + R, r + 2R, ...
// (R the grid's warps), lane j output lanes 4j..4j+3 of each.  Row s reads
// window block (s / tile_rows) % nwin of w.
__device__ __forceinline__ int4 load_stream(const int* p) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}

// Output lanes 4j..4j+3 of one row at lane j of its warp, from the row's
// iq (q) and ip (p) words of this lane.  Each lane packs its four iq mod 8
// (iq & 7, the floor modulo) into the bytes of `subs`; output c takes the
// byte of lane p/4 by one shuffle.  Then the four window reads go out
// together, and only then is any of them used (written so, the compiler
// predicates them and issues all four at once); an output out of the
// window (0) or of [-128, 128) (NaN) needs no read.
__device__ __forceinline__ float4 window_row(const float* __restrict__ wt,
                                             int winv, int4 q, int4 p) {
  const unsigned subs = (q.x & 7) | (q.y & 7) << 8 | (q.z & 7) << 16 |
                        (unsigned)(q.w & 7) << 24;
  const int qs[4] = {q.x, q.y, q.z, q.w};
  const int ps[4] = {p.x, p.y, p.z, p.w};
  int off[4];                           // into wt, or -1: take fill[c]
  float fill[4], got[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int pl = wrap(ps[c], kLanes);
    const bool p_ok = pl >= 0 && pl < kLanes;
    const int pc = p_ok ? pl : 0;
    const int sub =
        (__shfl_sync(0xffffffffu, subs, pc >> 2) >> (8 * (pc & 3))) & 7;
    const int v = qs[c] >> 3;           // floor(q / 8)
    const bool in_win = v >= 0 && v < winv;
    off[c] = in_win && p_ok ? (8 * v + sub) * kLanes + pc : -1;
    fill[c] = in_win ? nan_f() : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) got[c] = __ldg(wt + (off[c] < 0 ? 0 : off[c]));
#pragma unroll
  for (int c = 0; c < 4; ++c) got[c] = off[c] < 0 ? fill[c] : got[c];
  return make_float4(got[0], got[1], got[2], got[3]);
}

__global__ void __launch_bounds__(kWinThreads)
window_gather_kernel(const float* __restrict__ w, int win_rows, int nwin,
                     const int* __restrict__ iq, const int* __restrict__ ip,
                     int S, int tile_rows, float* __restrict__ out) {
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  int s = blockIdx.x * warps + (threadIdx.x >> 5);
  if (s >= S) return;                   // the whole warp
  const int lane4 = (threadIdx.x & 31) * 4;
  const int winv = win_rows >> 3;
  int4 q = load_stream(iq + (long long)s * kLanes + lane4);
  int4 p = load_stream(ip + (long long)s * kLanes + lane4);
  for (;;) {
    const int next = s < S - stride ? s + stride : S;  // no int overflow
    int4 qn, pn;
    if (next < S) {                     // its loads go out before s's use
      qn = load_stream(iq + (long long)next * kLanes + lane4);
      pn = load_stream(ip + (long long)next * kLanes + lane4);
    }
    const float* wt =
        w + (long long)((unsigned)s / tile_rows % nwin) * win_rows * kLanes;
    __stcs(reinterpret_cast<float4*>(out + (long long)s * kLanes + lane4),
           window_row(wt, winv, q, p));
    if (next >= S) break;
    s = next;
    q = qn;
    p = pn;
  }
}

// The card's SMs and the blocks of kWinThreads that fit on it at once
// (every SM full), with the kernel's L1 at its largest (it uses no shared
// memory), by device; zeros until first asked.  Call with `device`
// current.
struct WindowGrid {
  int sms, resident;
};

WindowGrid window_grid(int device) {
  static WindowGrid cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return WindowGrid{0, 0};
  if (cache[device].resident == 0) {
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(window_gather_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxL1) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_gather_kernel, kWinThreads, 0) != cudaSuccess)
      return WindowGrid{0, 0};
    cache[device] = WindowGrid{sms, sms * per_sm};
  }
  return cache[device];
}

// Both window entries: checks, then one launch of a warp a row: blocks of
// one warp, each on an SM of its own, when there are no more rows than
// SMs; else blocks of kWinWarps, no more than the card holds at once.
int window_launch(const void* w, int win_rows, int nwin, const void* iq,
                  const void* ip, long long S, int tile_rows, void* out,
                  void* stream, int device) {
  if (win_rows < 8 || win_rows > kMaxWinRows || win_rows % 8 || nwin < 1 ||
      tile_rows < 1 || S < 0 || S > 0x7fffffffLL - kWinWarps ||
      (((uintptr_t)iq | (uintptr_t)ip | (uintptr_t)out) & 15))
    return -2;
  if (S == 0) return 0;
  return on_device(device, [&] {
    const WindowGrid grid = window_grid(device);
    const int warps = S <= grid.sms ? 1 : kWinWarps;
    const long long want = (S + warps - 1) / warps;
    const long long blocks =
        grid.resident > 0 && grid.resident < want ? grid.resident : want;
    window_gather_kernel<<<(unsigned)blocks, 32 * warps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), win_rows, nwin,
        static_cast<const int*>(iq), static_cast<const int*>(ip), (int)S,
        tile_rows, static_cast<float*>(out));
  });
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

// K5: w (win_rows, 128), iq/ip (S, 128) -> out (S, 128): K6 with one
// window block (so every tile reads it).  iq, ip and out 16-byte aligned.
extern "C" int fstr_window_gather(const void* w, int win_rows,
                                  const void* iq, const void* ip,
                                  long long S, void* out, void* stream,
                                  int device) {
  return window_launch(w, win_rows, 1, iq, ip, S, 1, out, stream, device);
}

// K6: w (nwin * win_rows, 128), iq/ip (S, 128) -> out (S, 128); row s on
// window block (s / tile_rows) % nwin.  iq, ip and out 16-byte aligned.
extern "C" int fstr_window_gather_tiled(const void* w, int win_rows,
                                        int nwin, const void* iq,
                                        const void* ip, long long S,
                                        int tile_rows, void* out,
                                        void* stream, int device) {
  return window_launch(w, win_rows, nwin, iq, ip, S, tile_rows, out, stream,
                       device);
}
