// Sorted segment-sum assembly for Hopper (sm_90a): kernel K1, two entries.
//
// Replaces the TPU kernel frontistr_tpu/assembly/segsum_pallas.py
// (`_kernel`, launched from `make_segsum.run` and wrapped by
// `make_planes_segsum`).  The TPU design (one-hot MXU matmuls over
// slot-aligned chunks, window rows gathered back to slots) answers the
// TPU's lack of fast scatter and is not carried over.  Both entries sum
// each slot's sorted segment in ascending k in one thread, with no
// atomics, so a relaunch is bit-equal, like the reference's sorted
// assembly.
//
// 1. The element assembly (`make_planes_segsum`).  For every destination
//    slot s and each of the nd*nd value planes v = i*nd + j (nd = 3 for
//    the 3-D solids, 9 planes; nd = 2 for the 2-D solids, 4 planes):
//
//      out[v, s] = sum_{k in [slot_ptr[s], slot_ptr[s+1])} ke(perm[k])[i, j]
//
//    where perm lists the raw element pair entries in slot order and raw
//    entry p is, inside its element block, pair (a, b) of element e in
//    pair order (a, b, e) with e fastest: ke_b[e, a*nd + i, b*nd + j].
//    Empty slots come out 0.  Both entries are one template on ND, so the
//    nd = 2 record is four values, not nine with five left empty.
//
// 2. The planes entry (`make_segsum`): out[v, s] = sum over the segment
//    of values[v, perm[k]] for V value planes of R entries.
//
// What bounds the element assembly on an H100: device-memory bytes, and
// no arithmetic worth counting.  It must read every element-matrix value
// once (P*9 values), the index of the P entries and the slot pointer,
// and write 9*n_slots values, most of them zeros: on the Newton path's
// box_tet4(69) cluster profile 88% of the 41,160,000 slots are empty,
// and a non-empty segment holds 6.1 entries on average, 24 at most.
//
// What the design does about it.  The first design (one thread per slot
// over all slots, a decode of perm[k] per entry, each entry's three 3-value
// rows read from device memory) reached 31-39% of the bytes bound: most of
// its lanes idled on empty slots, and rows of 24 or 12 bytes cost whole
// 32-byte sectors.  Now two passes over a schedule that assembly/segsum.py
// builds on the card once per plan (microbench/segsum.py times the
// choices; PERF.md has the numbers):
//   - Pass 1 sums the non-empty slots only, in tiles that follow the slot
//     layout.  A plan may give its slot space as (A, B, W, C), slot
//     ((a*B + b)*W + w)*C + c; a tile is one a, all (b, w) and CT
//     consecutive c.  For the cluster profile, slot (aoff, boff, wc,
//     cluster), a tile then holds every pair entry (a, *) of each element
//     whose node a sits at offset aoff in one of its clusters, so it reads
//     whole row blocks: rows a*3..a*3+2 of an element matrix, 3 x m
//     contiguous values.  The block copies its row blocks to shared
//     memory (cp.async, 16 bytes a copy, all in flight at once), each
//     element-matrix value once and in whole sectors; then one thread per
//     non-empty slot walks its segment in ascending k and sums the nine
//     values of each entry from shared memory.  Each entry carries its
//     coordinates in the stage (no decode, no 64-bit division), and a
//     thread's first eight are loaded before the stage arrives.  The
//     slots of a tile are listed longest segment first, so the threads of
//     a warp walk segments of about one length.  A tile whose row blocks
//     do not fit is read from device memory at the same coordinates.
//   - Pass 2 writes the planes: one block per 4,096 consecutive slots,
//     one thread per slot, each non-empty slot's nine sums read as one
//     72- or 36-byte record and stored to the nine planes, empty slots as
//     zeros; a warp's stores to a plane are consecutive.  Storing from
//     pass 1's tiles instead (runs of CT slots at a stride of C in 9 x 120
//     rows) cost two to four times a memset of the planes at the Newton
//     shapes.
// The 2 x 9 x n_items values of the sums buffer are the traffic the
// bytes bound does not count.
//
// The 2-D solids (nd = 2) take the same two passes, instantiated on ND:
// a row block is 2 x m values (m = 16 for quad8), an item's record four
// sums (32 or 16 bytes), so a 48 KB stage holds 9/4 as many row blocks of
// the same m; the schedule (assembly/segsum.py) derives every size from
// nd.  The sums still run in ascending k, so the 2-D AMG setup repeats
// bit for bit as the 3-D one does.
//
// Shells and 611 beams (nd = 6) are the third instance: a row block is
// 6 x m values (m = 12, 18, 24 or 54), an item's record 36 sums (288 or
// 144 bytes), so a thread of pass 1 keeps 36 accumulators (72 registers
// in float64) and a 48 KB stage holds 41 row blocks at m = 24 and 18 at
// m = 54 (float64).  Pass 2 reads each record whole and writes it to the
// 36 planes, as for the solids.
//
// The u-p flow tet 3414 (nd = 4: v_x, v_y, v_z, p at each node) is the
// fourth instance: a row block is 4 x 16 values, an item's record 16 sums
// (128 or 64 bytes).  Its element matrices are not symmetric (advection,
// SUPG and the velocity-pressure coupling), so the (i, j) order of a
// sub-block and the (a, b) order of a pair matter: entry (a, b) is row
// block a, column sub-block b, value (i, j) at row i, column j.
//
// The planes entry is a simple one-thread-per-(slot, plane) kernel: its
// callers (the AMG's Galerkin sums, nodal smoothing) run it once or
// twice per Newton iteration on a few million entries.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kMaxBlocks = 8;
constexpr int kThreads = 256;       // planes kernel, element pass 2
constexpr int kSumThreads = 128;    // element pass 1
constexpr int kWriteSlots = 4096;   // WRITE_SLOTS in assembly/segsum.py
constexpr int kBatch = 8;           // entries a thread loads at once

template <typename T>
struct Blocks {
  const T* ke[kMaxBlocks];           // (E_b, m_b, m_b) row-major
  long long start[kMaxBlocks + 1];   // flat offset of block b's first value
  int m[kMaxBlocks];                 // m_b = nn_b * nd
  int nblk;
};

// The block holding flat offset g (one block: 0, no search).
template <typename T, bool kMulti>
__device__ __forceinline__ int block_of(const Blocks<T>& bk, long long g) {
  int b = 0;
  if (kMulti)
    while (b + 1 < bk.nblk && g >= bk.start[b + 1]) ++b;
  return b;
}

// Pass 1, the sums: one block per tile.  The tile's non-empty slots are
// items [tile_ptr[tile], tile_ptr[tile+1]) with entries [item_k0, item_k1);
// item `it` leaves its ND*ND sums at sums[it*ND*ND ..].
//
// The tile's row blocks (rows a*ND..a*ND+ND-1 of one element matrix,
// ND x m_b values from flat offset rb_src[r]) are [rb_ptr[tile],
// rb_ptr[tile+1]); entry k reads value (i, j) of its sub-block at loc[k] +
// i*m_max + j of the staged row blocks (row block r at r*ND*m_max, rows
// m_max apart).  A tile with more than stage_rb row blocks is read from
// device memory at the same coordinates.  Shared memory: the stage, then
// the row blocks' offsets.
template <int ND, typename T, typename I, bool kMulti>
__global__ void __launch_bounds__(kSumThreads)
sums_kernel(const int* __restrict__ loc, const I* __restrict__ rb_src,
            const int* __restrict__ rb_ptr, const int* __restrict__ item_k0,
            const int* __restrict__ item_k1,
            const int* __restrict__ tile_ptr, int m_max, int stage_rb,
            int vec16, const Blocks<T> bk, T* __restrict__ sums) {
  constexpr int kNV = ND * ND;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rbs = ND * m_max;
  T* stage = reinterpret_cast<T*>(smem);
  I* rb_at = reinterpret_cast<I*>(
      smem + ((sizeof(T) * (size_t)stage_rb * rbs + 7) & ~(size_t)7));
  const int tile = blockIdx.x;
  const int r0 = rb_ptr[tile];
  const int n_rb = rb_ptr[tile + 1] - r0;
  const bool staged = n_rb <= stage_rb;
  const int i0 = tile_ptr[tile];
  const int n_items = tile_ptr[tile + 1] - i0;

  // 1. Each thread's first item and its first batch of coordinates are
  //    requested before the stage, so their latencies overlap.
  int it = threadIdx.x, k = 0, k1 = 0;
  int l[kBatch];
  if (it < n_items) {
    k = __ldg(item_k0 + i0 + it);
    k1 = __ldg(item_k1 + i0 + it);
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    l[b] = k + b < k1 ? __ldg(loc + k + b) : -1;
  if (staged)
    for (int r = threadIdx.x; r < n_rb; r += kSumThreads)
      rb_at[r] = __ldg(rb_src + r0 + r);
  __syncthreads();

  // 2. The stage: the tile's row blocks, whole sectors, copied straight to
  //    shared memory (cp.async), every copy in flight at once: 16 bytes a
  //    copy where the row blocks are laid out alike and 16-byte aligned.
  if (staged && vec16) {
    const int u = rbs * (int)sizeof(T) / 16;     // 16-byte units a block
    const int n = n_rb * u;
    for (int x = threadIdx.x; x < n; x += kSumThreads) {
      const int r = x / u;
      const long long g = rb_at[r];
      const int b = block_of<T, kMulti>(bk, g);
      const char* from = reinterpret_cast<const char*>(
          bk.ke[b] + (g - bk.start[b]));
      __pipeline_memcpy_async(reinterpret_cast<char*>(stage) + 16 * x,
                              from + 16 * (x - r * u), 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else if (staged) {
    const int n = n_rb * rbs;
    for (int x = threadIdx.x; x < n; x += kSumThreads) {
      const int r = x / rbs;
      const int y = x - r * rbs;
      const long long g = rb_at[r];
      const int b = block_of<T, kMulti>(bk, g);
      const T* from = bk.ke[b] + (g - bk.start[b]);
      if (!kMulti || bk.m[b] == m_max) {
        __pipeline_memcpy_async(stage + x, from + y, sizeof(T));
      } else {                          // rows of m_b, staged m_max apart
        const int i = y / m_max;
        const int col = y - i * m_max;
        if (col < bk.m[b])
          __pipeline_memcpy_async(stage + x, from + i * bk.m[b] + col,
                                  sizeof(T));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  // 3. One thread an item: its ND*ND sums, each in ascending k.
  for (; it < n_items; it += kSumThreads) {
    if (it != (int)threadIdx.x) {
      k = __ldg(item_k0 + i0 + it);
      k1 = __ldg(item_k1 + i0 + it);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        l[b] = k + b < k1 ? __ldg(loc + k + b) : -1;
    }
    T acc[kNV];
#pragma unroll
    for (int v = 0; v < kNV; ++v) acc[v] = T(0);
    while (true) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (l[b] < 0) continue;
        if (staged) {
          const T* x = stage + l[b];
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              acc[i * ND + j] += x[i * m_max + j];
        } else {
          const int r = l[b] / rbs;
          const long long g = __ldg(rb_src + r0 + r);
          const int blk = block_of<T, kMulti>(bk, g);
          const int m = kMulti ? bk.m[blk] : m_max;
          const T* x = bk.ke[blk] + (g - bk.start[blk]) + (l[b] - r * rbs);
#pragma unroll
          for (int i = 0; i < ND; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              acc[i * ND + j] += __ldg(x + i * m + j);
        }
      }
      k += kBatch;
      if (k >= k1) break;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        l[b] = k + b < k1 ? __ldg(loc + k + b) : -1;
    }
    T* to = sums + (long long)(i0 + it) * kNV;
#pragma unroll
    for (int v = 0; v < kNV; ++v) to[v] = acc[v];
  }
}

// Pass 2, the planes: one block per kWriteSlots consecutive slots.  The
// block's non-empty slots, ascending, are nz_slot[nz_ptr[tile] ..
// nz_ptr[tile+1]) with their sums at sums[nz_item*kNV ..]; every slot of
// the block is written, zeros included.
template <int kNV, typename T>
__global__ void __launch_bounds__(kThreads)
planes_out_kernel(const int* __restrict__ nz_slot,
                  const int* __restrict__ nz_item,
                  const int* __restrict__ nz_ptr, long long n_slots,
                  const T* __restrict__ sums, T* __restrict__ out) {
  __shared__ int item_of[kWriteSlots];
  const long long s0 = (long long)blockIdx.x * kWriteSlots;
  for (int t = threadIdx.x; t < kWriteSlots; t += kThreads) item_of[t] = -1;
  __syncthreads();
  const int p0 = nz_ptr[blockIdx.x], p1 = nz_ptr[blockIdx.x + 1];
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads)
    item_of[__ldg(nz_slot + p) - s0] = __ldg(nz_item + p);
  __syncthreads();
  const int n = n_slots - s0 < kWriteSlots ? (int)(n_slots - s0)
                                           : kWriteSlots;
  // a thread a slot: its item's kNV sums (one record) to the kNV planes,
  // the warp's stores to each plane consecutive
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int item = item_of[t];
    T v[kNV];
#pragma unroll
    for (int p = 0; p < kNV; ++p)
      v[p] = item >= 0 ? __ldg(sums + (long long)item * kNV + p) : T(0);
#pragma unroll
    for (int p = 0; p < kNV; ++p) out[p * n_slots + s0 + t] = v[p];
  }
}

struct Schedule {
  const int* loc;
  const void* rb_src;
  const int* rb_ptr;
  const int* item_k0;
  const int* item_k1;
  const int* tile_ptr;
  const int* nz_slot;
  const int* nz_item;
  const int* nz_ptr;
  int n_tiles, m_max, stage_rb, vec16;
  long long n_slots;
};

template <int ND, typename T, typename I, bool kMulti>
int launch_passes(const Schedule& sc, const Blocks<T>& bk, void* sums,
                  void* out, cudaStream_t stream, int device) {
  const size_t smem =
      ((sizeof(T) * (size_t)sc.stage_rb * ND * sc.m_max + 7) & ~(size_t)7) +
      sizeof(I) * (size_t)sc.stage_rb;
  const long long n_write = (sc.n_slots + kWriteSlots - 1) / kWriteSlots;
  cudaError_t attr = cudaSuccess;
  const int rc = on_device(device, [&] {
    auto pass1 = sums_kernel<ND, T, I, kMulti>;
    attr = cudaFuncSetAttribute(
        pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr == cudaSuccess)     // shared memory over L1: more tiles an SM
      attr = cudaFuncSetAttribute(
          pass1, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (attr != cudaSuccess) return;
    if (sc.n_tiles > 0)
      pass1<<<sc.n_tiles, kSumThreads, smem, stream>>>(
          sc.loc, static_cast<const I*>(sc.rb_src), sc.rb_ptr, sc.item_k0,
          sc.item_k1, sc.tile_ptr, sc.m_max, sc.stage_rb, sc.vec16, bk,
          static_cast<T*>(sums));
    attr = cudaGetLastError();
    if (attr != cudaSuccess) return;
    planes_out_kernel<ND * ND, T><<<(unsigned)n_write, kThreads, 0,
                                    stream>>>(
        sc.nz_slot, sc.nz_item, sc.nz_ptr, sc.n_slots,
        static_cast<const T*>(sums), static_cast<T*>(out));
  });
  return attr != cudaSuccess ? (int)attr : rc;
}

template <int ND, typename T>
int dispatch_elements(int idx64, const Schedule& sc,
                      const void* const* ke_ptrs, const long long* starts,
                      const int* ms, int nblk, void* sums, void* out,
                      cudaStream_t stream, int device) {
  Blocks<T> bk;
  bk.nblk = nblk;
  for (int b = 0; b < nblk; ++b) {
    bk.ke[b] = static_cast<const T*>(ke_ptrs[b]);
    bk.start[b] = starts[b];
    bk.m[b] = ms[b];
  }
  bk.start[nblk] = starts[nblk];
  if (nblk == 1)
    return idx64 ? launch_passes<ND, T, long long, false>(sc, bk, sums, out,
                                                          stream, device)
                 : launch_passes<ND, T, int, false>(sc, bk, sums, out,
                                                    stream, device);
  return idx64 ? launch_passes<ND, T, long long, true>(sc, bk, sums, out,
                                                       stream, device)
               : launch_passes<ND, T, int, true>(sc, bk, sums, out, stream,
                                                 device);
}

// The planes entry: one thread per (slot, plane).  Threads of a block
// take neighbouring slots of one plane, so the plane-major stores
// coalesce; the plane runs along the grid's y axis.  The perm loads of a
// batch of four entries are issued before their value loads, which keeps
// four loads of a thread in flight.
template <typename T>
__global__ void planes_kernel(const T* __restrict__ values, long long R,
                              const int* __restrict__ slot_ptr,
                              const int* __restrict__ perm,
                              long long n_slots, int V,
                              T* __restrict__ out) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int k0 = __ldg(slot_ptr + s);
  const int k1 = __ldg(slot_ptr + s + 1);
  for (int v = blockIdx.y; v < V; v += gridDim.y) {
    const T* __restrict__ x = values + (long long)v * R;
    T sum = T(0);
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      const int p0 = __ldg(perm + k), p1 = __ldg(perm + k + 1);
      const int p2 = __ldg(perm + k + 2), p3 = __ldg(perm + k + 3);
      const T x0 = __ldg(x + p0), x1 = __ldg(x + p1);
      const T x2 = __ldg(x + p2), x3 = __ldg(x + p3);
      sum += x0;
      sum += x1;
      sum += x2;
      sum += x3;
    }
    for (; k < k1; ++k) sum += __ldg(x + __ldg(perm + k));
    out[(long long)v * n_slots + s] = sum;
  }
}

template <typename T>
int launch_planes(const void* values, int V, long long R, const int* slot_ptr,
                  const int* perm, long long n_slots, void* out,
                  cudaStream_t stream, int device) {
  const long long gx = (n_slots + kThreads - 1) / kThreads;
  if (gx > 0x7fffffffLL) return -2;
  const dim3 grid((unsigned)gx, (unsigned)(V < 65535 ? V : 65535));
  return on_device(device, [&] {
    planes_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(values), R, slot_ptr, perm, n_slots, V,
        static_cast<T*>(out));
  });
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer but the host
// arrays named below is to device memory on device `device`; each entry
// launches on `stream` and returns 0, the launch's cudaError_t, -1 for
// too many element blocks or -2 for sizes it does not take.

// The element assembly, over the schedule assembly/segsum.py builds (all
// int32 but rb_src, int64 when idx64): pass 1 over n_tiles tiles, from
// loc (P), rb_src, rb_ptr and tile_ptr (n_tiles+1), item_k0 and item_k1,
// into sums (n_items, nd*nd) of the element type; tiles of at most
// stage_rb row blocks (nd rows of m_max values) are staged, by 16-byte
// copies when
// vec16 (every row block laid out alike and 16-byte aligned in memory and
// in the stage).  Pass 2 over blocks of
// kWriteSlots slots, from nz_slot and nz_item (the non-empty slots,
// ascending, and their items) and nz_ptr, into out (nd*nd, n_slots).
// Host arrays: ke_ptrs (nblk) to the element matrices, starts (nblk+1)
// their flat offsets, ms (nblk) their widths m_b <= m_max.  nd is 2 (the
// 2-D solids), 3, 4 (the u-p flow element 3414) or 6 (shells and 611
// beams); is_double selects float64 over float32.
extern "C" int fstr_segsum(int nd, int is_double, int idx64, const void* loc,
                           const void* rb_src, const void* rb_ptr,
                           const void* item_k0, const void* item_k1,
                           const void* tile_ptr, int n_tiles,
                           const void* nz_slot, const void* nz_item,
                           const void* nz_ptr, long long n_slots, int m_max,
                           int stage_rb, int vec16,
                           const void* const* ke_ptrs,
                           const long long* starts, const int* ms, int nblk,
                           void* sums, void* out, void* stream, int device) {
  if (nblk < 1 || nblk > kMaxBlocks) return -1;
  if ((nd != 2 && nd != 3 && nd != 4 && nd != 6) || n_tiles < 0 ||
      stage_rb < 0 || m_max < 1 || n_slots < 0 || n_slots >= 0x7fffffffLL)
    return -2;
  for (int b = 0; b < nblk; ++b)
    if (ms[b] < 1 || ms[b] > m_max) return -2;
  if (n_slots == 0) return 0;
  const Schedule sc{static_cast<const int*>(loc), rb_src,
                    static_cast<const int*>(rb_ptr),
                    static_cast<const int*>(item_k0),
                    static_cast<const int*>(item_k1),
                    static_cast<const int*>(tile_ptr),
                    static_cast<const int*>(nz_slot),
                    static_cast<const int*>(nz_item),
                    static_cast<const int*>(nz_ptr), n_tiles, m_max,
                    stage_rb, vec16, n_slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nd == 2)
    return is_double ? dispatch_elements<2, double>(idx64, sc, ke_ptrs,
                                                    starts, ms, nblk, sums,
                                                    out, st, device)
                     : dispatch_elements<2, float>(idx64, sc, ke_ptrs, starts,
                                                   ms, nblk, sums, out, st,
                                                   device);
  if (nd == 6)
    return is_double ? dispatch_elements<6, double>(idx64, sc, ke_ptrs,
                                                    starts, ms, nblk, sums,
                                                    out, st, device)
                     : dispatch_elements<6, float>(idx64, sc, ke_ptrs, starts,
                                                   ms, nblk, sums, out, st,
                                                   device);
  if (nd == 4)
    return is_double ? dispatch_elements<4, double>(idx64, sc, ke_ptrs,
                                                    starts, ms, nblk, sums,
                                                    out, st, device)
                     : dispatch_elements<4, float>(idx64, sc, ke_ptrs, starts,
                                                   ms, nblk, sums, out, st,
                                                   device);
  return is_double ? dispatch_elements<3, double>(idx64, sc, ke_ptrs, starts,
                                                  ms, nblk, sums, out, st,
                                                  device)
                   : dispatch_elements<3, float>(idx64, sc, ke_ptrs, starts,
                                                 ms, nblk, sums, out, st,
                                                 device);
}

// The planes entry: values (V, R) and out (V, n_slots) of the element
// type, slot_ptr (n_slots+1) and perm (P) int32.
extern "C" int fstr_segsum_planes(int is_double, const void* values, int V,
                                  long long R, const int* slot_ptr,
                                  const int* perm, long long n_slots,
                                  void* out, void* stream, int device) {
  if (V < 1 || R < 0 || n_slots < 0) return -2;
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_planes<double>(values, V, R, slot_ptr, perm, n_slots, out,
                                 st, device);
  return launch_planes<float>(values, V, R, slot_ptr, perm, n_slots, out, st,
                              device);
}
