// Event-driven k x k convolution for Hopper (sm_90a): the sequential and
// interlaced conv units of the paper's accelerator, batched and
// single-queue.
//
// Replaces (src/repro/kernels/event_conv/kernel.py):
//   event_conv_seq_batched        <- event_conv_pallas_batched
//                                    (_event_conv_batched_kernel,
//                                     _apply_event_block, prefix=(0,))
//   event_conv_seq_single         <- event_conv_pallas
//                                    (_event_conv_kernel)
//     each composed over the c_in fori_loop of apply_all_cins
//     (src/repro/core/scheduler.py:615-635): one launch takes every input
//     channel's queues of one (channel block, time step);
//   event_conv_interlaced_batched <- event_conv_pallas_interlaced_batched
//                                    (_apply_event_block_interlaced)
//   event_conv_interlaced_single  <- event_conv_pallas_interlaced
//                                    (_event_conv_interlaced_kernel)
//
// Contract (all four): queues are applied in order to their halo-padded
// tiles (Hp, Wp, C).  A valid event (i, j) adds the 180-degree-rotated
// (kh, kw, C) kernel into the window starting at the clamped (i, j);
// int8/int16 widen to int32 and clip after every add; invalid slots add
// nothing.  The sequential entries take C_in queues per tile and apply
// input channel 0's queue first, then channel 1's, and so on, each with
// its own kernel[ci]: per membrane cell the order of adds is (input
// channel, queue slot), the order of the JAX package's per-channel Pallas
// calls, so float32 stays bit-exact and saturation exact.  vm_in and
// vm_out may alias (in-place update): a cell is read before it is written,
// by the one thread that owns it.
//
// Sequential entries: an output-stationary gather.  What bounds them on
// the card is bytes: a conv1 launch at B=8 reads and writes eight
// 30x30x8 float32 tiles (460 KB) and reads 32 x 8 queues of 256 slots
// (590 KB) and 9 KB of weights, for ~10^6 adds; the old walk (one CTA per
// queue, one barrier per event, the tile staged through shared memory once
// per input channel) ran 700-1,600x above that bound.  Here every
// membrane cell has one owning thread: it loads the cell once (neighbouring
// threads on neighbouring (pixel, channel) addresses), keeps it in a
// register through every add of every input channel and stores it once:
// no barrier per event, no atomics, no tile in shared memory.  A CTA owns
// a PH x PW pixel patch of one queue's tile (by up to 256 channels), and
// the host sizes the patch so the grid covers the card's SMs at one sample
// as at B=8 (conv1: 256 CTAs of 8x4 pixels at B=8, 120 of 4x2 for one
// sample).  The CTA, at least 256 threads however few cells it owns,
// reads each input channel's queue once, all of a round's loads issued
// before any is used, and keeps the slots whose window meets its patch,
// compacted in (channel, slot) order with a warp ballot and a prefix sum
// over the warps, into shared memory (packed: channel, row, column); one
// barrier separates the compaction from the walk.  Each warp then keeps,
// again by ballot, the kept slots whose window meets its own lanes' pixels
// and walks them in order, kWalkBatch at a time (their weight loads issue
// together, the adds follow in order); a lane adds kernel[ci] at its
// offset when its cell lies in the window.  The kernel is read through the
// read-only cache (L1, the same SRAM as shared memory).  What is left is
// latency: a cell's adds are one ordered chain (~94 at conv1's density)
// that only its owner can run, and a single tile has under two
// cell-owning warps per SM to hide it.
//
// Interlaced entries: a staged-tile walk.  Consecutive windows of a
// queue may overlap, so each step has to see the previous one's writes;
// a CTA holds its tile (or channel slice), the rotated kernel and the
// queue in shared memory (Pallas kept the tile VMEM-resident the same
// way), threads cover the (event, tap, channel) cells of one step, and one
// barrier separates steps.  A group of event_par same-column events has
// disjoint windows, so the whole group is one step.  The walk stops at
// the queue's last valid slot.  Batched: one CTA per queue over all C
// channels.  Single: output channels are independent, so the grid runs
// over channel slices of the one tile: a slice is as many channels as one
// warp covers with one step's cells, walked by warp 0 with a __syncwarp()
// between steps while the CTA's other warps only stage the slice and
// write it back; where one channel's step needs more than a warp, a slice
// is one channel and the whole CTA walks with a block barrier.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sat_add(float a, float b) { return a + b; }
__device__ __forceinline__ int16_t sat_add(int16_t a, int16_t b) {
  int w = (int)a + (int)b;
  return (int16_t)max(-32768, min(32767, w));
}
__device__ __forceinline__ int8_t sat_add(int8_t a, int8_t b) {
  int w = (int)a + (int)b;
  return (int8_t)max(-128, min(127, w));
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Dynamic shared memory of one CTA holding cs channels of a tile: queue
// coords, tile slice, rotated kernel slice, valid bits, and for the
// interlaced unit a per-slot apply bit and a per-group kind.
struct Layout {
  size_t coords, tile, krot, valid, keep, kind, total;
  __host__ __device__ Layout(int e, int hp, int wp, int cs, int kh, int kw,
                             int event_par, size_t item) {
    coords = 0;
    tile = align16(coords + (size_t)e * 2 * sizeof(int));
    krot = align16(tile + (size_t)hp * wp * cs * item);
    valid = align16(krot + (size_t)kh * kw * cs * item);
    keep = align16(valid + (size_t)e);
    size_t n_keep = event_par > 1 ? (size_t)e : 0;
    kind = align16(keep + n_keep);
    size_t n_groups = event_par > 1 ? (size_t)(e / event_par) : 0;
    total = align16(kind + n_groups);
  }
};

// What one CTA owns: queue q, channels [c0, c0 + cs) of the tile's c.
struct Slice {
  int q, c0, cs;
};

// Channels per CTA of the interlaced single-queue entry: as many as one
// warp covers with one step's (event, tap) cells, at least one.
__host__ __device__ __forceinline__ int single_slice(int kh, int kw,
                                                     int event_par, int c) {
  const int cells = event_par * kh * kw;
  const int s = cells >= 32 ? 1 : 32 / cells;
  return s < c ? s : c;
}

// Who walks the queue and how its steps are separated: every thread of
// the CTA with a block barrier, or warp 0 alone with a warp barrier (the
// other warps only help stage the tile and write it back).
struct BlockSync {
  __device__ __forceinline__ int walkers() const { return blockDim.x; }
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ __forceinline__ int walkers() const { return 32; }
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

// Stage a CTA's slice of one queue's tile, its slice of the rotated
// kernel, and the queue into shared memory; returns the last valid slot
// (-1 when the queue is empty).  Block-uniform.
template <typename T>
__device__ int stage(const T* vm_in, const int* __restrict__ coords,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ kernel, unsigned char* smem,
                     const Layout& L, const Slice& s, int e, int hp, int wp,
                     int c, int kh, int kw, int* s_last) {
  int* s_coords = reinterpret_cast<int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  T* krot = reinterpret_cast<T*>(smem + L.krot);
  uint8_t* s_valid = smem + L.valid;
  const int cs = s.cs;
  const int n_pix = hp * wp;  // a tile fits shared memory: int indices
  const T* src = vm_in + (size_t)s.q * n_pix * c;
  if (cs == c) {
#pragma unroll 4
    for (int x = threadIdx.x; x < n_pix * c; x += blockDim.x)
      tile[x] = src[x];
  } else {
#pragma unroll 4
    for (int x = threadIdx.x; x < n_pix * cs; x += blockDim.x) {
      const int pix = x / cs;
      tile[x] = src[pix * c + s.c0 + (x - pix * cs)];
    }
  }
  const int kwc = kw * cs;
  const int n_k = kh * kwc;
  for (int x = threadIdx.x; x < n_k; x += blockDim.x) {
    const int a = x / kwc, r = x - a * kwc, b = r / cs, ch = r - b * cs;
    krot[x] = kernel[((kh - 1 - a) * kw + (kw - 1 - b)) * c + s.c0 + ch];
  }
  if (threadIdx.x == 0) *s_last = -1;
  __syncthreads();
  const int* qc = coords + (size_t)s.q * e * 2;
  const uint8_t* qv = valid + (size_t)s.q * e;
  int my_last = -1;
  for (int x = threadIdx.x; x < e; x += blockDim.x) {
    const uint8_t v = qv[x] != 0;
    s_valid[x] = v;
    s_coords[2 * x] = qc[2 * x];
    s_coords[2 * x + 1] = qc[2 * x + 1];
    if (v) my_last = x;
  }
  if (my_last >= 0) atomicMax(s_last, my_last);
  __syncthreads();
  return *s_last;
}

// Add the rotated kernel at event (i, j) for cells x = x0, x0+stride,
// ... of the window (cs channels per pixel in shared memory).  The start
// is clamped into the tile, as lax.dynamic_slice clamps it in the
// reference.
template <typename T>
__device__ __forceinline__ void apply_event(T* tile, const T* krot, int i,
                                            int j, int hp, int wp, int cs,
                                            int kh, int kw, int x0,
                                            int stride) {
  i = min(max(i, 0), hp - kh);
  j = min(max(j, 0), wp - kw);
  T* base = tile + ((size_t)i * wp + j) * cs;
  const int kwc = kw * cs;
  const int n_k = kh * kwc;
  for (int x = x0; x < n_k; x += stride) {
    const int a = x / kwc, r = x - a * kwc;
    T* cell = base + (size_t)a * wp * cs + r;
    *cell = sat_add(*cell, krot[x]);
  }
}

// Write the CTA's slice back; starts with a block barrier, so every
// walker's last adds are visible.
template <typename T>
__device__ void unstage(T* vm_out, const T* tile, const Slice& s, int hp,
                        int wp, int c) {
  __syncthreads();
  const int n_pix = hp * wp;
  T* dst = vm_out + (size_t)s.q * n_pix * c;
  if (s.cs == c) {
    for (int x = threadIdx.x; x < n_pix * c; x += blockDim.x)
      dst[x] = tile[x];
  } else {
    for (int x = threadIdx.x; x < n_pix * s.cs; x += blockDim.x) {
      const int pix = x / s.cs;
      dst[pix * c + s.c0 + (x - pix * s.cs)] = tile[x];
    }
  }
}

enum GroupKind : uint8_t { kEmpty = 0, kHomogeneous = 1, kMixed = 2 };

// Classify each group: the first valid slot is the anchor; the group is
// homogeneous when every valid slot shares the anchor's interlace column.
// In a homogeneous group a slot repeating an earlier valid slot's
// coordinates is dropped: the gather->add->scatter of the Pallas kernel
// writes that window once.  Ends with a block barrier.
__device__ void classify_groups(const int* s_coords, const uint8_t* s_valid,
                                uint8_t* s_keep, uint8_t* s_kind,
                                int n_groups, int event_par, int kh, int kw) {
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    const int base = g * event_par;
    int acol = -1;
    bool homog = true;
    for (int p = 0; p < event_par; ++p) {
      if (!s_valid[base + p]) continue;
      const int i = s_coords[2 * (base + p)], j = s_coords[2 * (base + p) + 1];
      const int col = (i % kh) * kw + (j % kw);
      if (acol < 0) acol = col;
      else if (col != acol) homog = false;
    }
    for (int p = 0; p < event_par; ++p) {
      const int s = base + p;
      bool keep = s_valid[s];
      if (keep && homog) {
        for (int r = 0; r < p; ++r) {
          const int t = base + r;
          if (s_valid[t] && s_coords[2 * t] == s_coords[2 * s] &&
              s_coords[2 * t + 1] == s_coords[2 * s + 1]) {
            keep = false;
          }
        }
      }
      s_keep[s] = keep;
    }
    s_kind[g] = acol < 0 ? kEmpty : (homog ? kHomogeneous : kMixed);
  }
  __syncthreads();
}

// The interlaced unit: stage, classify, one barrier per homogeneous group
// (and per valid event of a mixed group), write back.
template <typename T, typename Sync>
__device__ void run_interlaced(const T* vm_in, T* vm_out, const int* coords,
                               const uint8_t* valid, const T* kernel,
                               unsigned char* smem, int* s_last,
                               const Slice& s, int e, int hp, int wp, int c,
                               int kh, int kw, int event_par, Sync sync) {
  const Layout L(e, hp, wp, s.cs, kh, kw, event_par, sizeof(T));
  const int last = stage(vm_in, coords, valid, kernel, smem, L, s, e, hp, wp,
                         c, kh, kw, s_last);
  const int* s_coords = reinterpret_cast<const int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  const T* krot = reinterpret_cast<const T*>(smem + L.krot);
  const uint8_t* s_valid = smem + L.valid;
  uint8_t* s_keep = smem + L.keep;
  uint8_t* s_kind = smem + L.kind;
  const int n_groups = (last + event_par) / event_par;  // 0 when empty
  classify_groups(s_coords, s_valid, s_keep, s_kind, n_groups, event_par, kh,
                  kw);

  const int n_k = kh * kw * s.cs;
  const int walkers = sync.walkers();
  if ((int)threadIdx.x < walkers) {
    for (int g = 0; g < n_groups; ++g) {
      const int base = g * event_par;
      const uint8_t kind = s_kind[g];  // uniform over the walkers
      if (kind == kEmpty) continue;
      if (kind == kHomogeneous) {
        // disjoint windows: thread x covers cell x % n_k of slot x / n_k
        for (int x = threadIdx.x; x < event_par * n_k; x += walkers) {
          const int p = x / n_k;
          const int sl = base + p;
          if (!s_keep[sl]) continue;
          apply_event(tile, krot, s_coords[2 * sl], s_coords[2 * sl + 1],
                      hp, wp, s.cs, kh, kw, x - p * n_k, n_k);
        }
        sync();
      } else {
        for (int p = 0; p < event_par; ++p) {
          const int sl = base + p;
          if (!s_valid[sl]) continue;
          apply_event(tile, krot, s_coords[2 * sl], s_coords[2 * sl + 1],
                      hp, wp, s.cs, kh, kw, threadIdx.x, walkers);
          sync();
        }
      }
    }
  }
  unstage(vm_out, tile, s, hp, wp, c);
}

// ---- interlaced, batched: one CTA per queue, all channels ----------------

template <typename T>
__global__ void event_conv_interlaced_kernel(
    const T* vm_in, T* vm_out, const int* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel, int e,
    int hp, int wp, int c, int kh, int kw, int event_par) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  run_interlaced(vm_in, vm_out, coords, valid, kernel, smem, &s_last,
                 Slice{(int)blockIdx.x, 0, c}, e, hp, wp, c, kh, kw,
                 event_par, BlockSync());
}

// ---- interlaced, single queue: one CTA per channel slice -----------------

template <typename T, typename Sync>
__global__ void event_conv_interlaced_single_kernel(
    const T* vm_in, T* vm_out, const int* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel, int e,
    int hp, int wp, int c, int kh, int kw, int event_par, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int c0 = blockIdx.x * slice;
  run_interlaced(vm_in, vm_out, coords, valid, kernel, smem, &s_last,
                 Slice{0, c0, min(slice, c - c0)}, e, hp, wp, c, kh, kw,
                 event_par, Sync());
}

// Threads of an interlaced CTA: one per cell of a step, at least 128 (so
// staging a single-queue slice is not one warp's latency chain: its
// walkers are then warp 0 alone, WarpSync), at most 1024.
int threads_for(int cells) {
  int t = (cells + 31) / 32 * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB default.
template <typename K, typename... Args>
cudaError_t launch(K kernel, int grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_interlaced(const void* vm_in, void* vm_out,
                              const void* coords, const void* valid,
                              const void* kernel, int q, int e, int hp,
                              int wp, int c, int kh, int kw, int event_par,
                              cudaStream_t stream) {
  const Layout L(e, hp, wp, c, kh, kw, event_par, sizeof(T));
  return launch(event_conv_interlaced_kernel<T>, q,
                threads_for(event_par * kh * kw * c), L.total, stream,
                static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
                static_cast<const int*>(coords),
                static_cast<const uint8_t*>(valid),
                static_cast<const T*>(kernel), e, hp, wp, c, kh, kw,
                event_par);
}

template <typename T>
cudaError_t launch_interlaced_single(const void* vm_in, void* vm_out,
                                     const void* coords, const void* valid,
                                     const void* kernel, int e, int hp,
                                     int wp, int c, int kh, int kw,
                                     int event_par, cudaStream_t stream) {
  const int slice = single_slice(kh, kw, event_par, c);
  const int grid = (c + slice - 1) / slice;
  const int threads = threads_for(event_par * kh * kw * slice);
  const Layout L(e, hp, wp, slice, kh, kw, event_par, sizeof(T));
  auto args = [&](auto k) {
    return launch(k, grid, threads, L.total, stream,
                  static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
                  static_cast<const int*>(coords),
                  static_cast<const uint8_t*>(valid),
                  static_cast<const T*>(kernel), e, hp, wp, c, kh, kw,
                  event_par, slice);
  };
  return event_par * kh * kw * slice <= 32
             ? args(event_conv_interlaced_single_kernel<T, WarpSync>)
             : args(event_conv_interlaced_single_kernel<T, BlockSync>);
}

// ---- the sequential unit: output-stationary gather ----------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherThreads = 512;  // most threads of one CTA
// fewest threads of one CTA: a CTA that owns fewer cells still compacts
// its queues with this many
constexpr int kGatherMinThreads = 256;
constexpr int kGatherChannels = 256; // most channels of one CTA's cells
constexpr int kPerLane = 8;          // slots a lane tests per round
constexpr int kWalkBatch = 4;        // matches a warp applies per step
// kept slots one CTA holds at once (32 KB); a round is at most
// (kGatherThreads / 32) * 32 * kPerLane = 4096 slots, so a chunk of
// kListCap slots never overflows the list
constexpr int kListCap = 8192;
// a kept slot packs (input channel, window row, window column)
constexpr int kRowBits = 11, kColBits = 11;
constexpr uint32_t kColMask = (1u << kColBits) - 1;
constexpr uint32_t kRowMask = (1u << kRowBits) - 1;

__device__ __forceinline__ uint32_t pack_slot(int ci, int i, int j) {
  return ((uint32_t)ci << (kRowBits + kColBits)) | ((uint32_t)i << kColBits) |
         (uint32_t)j;
}

// Does a kh x kw window starting at (i, j) meet rows [y0, y1] x cols
// [x0, x1] (inclusive)?  An empty box (y0 > y1) meets nothing.
__device__ __forceinline__ bool meets(int i, int j, int kh, int kw, int y0,
                                      int y1, int x0, int x1) {
  return i <= y1 && i + kh > y0 && j <= x1 && j + kw > x0;
}

// Grid: x = pixel patch (row-major over the tile), y = queue, z = channel
// slice.  coords (C_in, Q, E, 2), valid (C_in, Q, E), kernel (C_in, kh,
// kw, C) unrotated; tiles (Q, Hp, Wp, C).
template <typename T>
__global__ void __launch_bounds__(kGatherThreads) event_conv_gather_kernel(
    const T* vm_in, T* vm_out, const int2* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel,
    int c_in, int q_count, int e, int hp, int wp, int c, int kh, int kw,
    int ph, int pw, int cs) {
  __shared__ uint32_t s_list[kListCap];
  __shared__ int s_count[2][kGatherThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_px = (wp + pw - 1) / pw;
  const int y0 = (blockIdx.x / n_px) * ph, x0 = (blockIdx.x % n_px) * pw;
  const int y1 = min(y0 + ph, hp) - 1, x1 = min(x0 + pw, wp) - 1;
  const int q = blockIdx.y;
  const int c0 = blockIdx.z * cs, cw = min(cs, c - c0);

  // this thread's cell: channel fastest, then pixels of the patch
  const int p = threadIdx.x / cw, ch = c0 + threadIdx.x % cw;
  const int y = y0 + p / pw, x = x0 + p % pw;
  const bool mine = p < ph * pw && y < hp && x < wp;
  const int cell = ((q * hp + y) * wp + x) * c + ch;
  T acc = mine ? vm_in[cell] : T(0);
  // the warp's box: the pixels its lanes own
  const int wy0 = __reduce_min_sync(kFull, mine ? y : INT_MAX);
  const int wy1 = __reduce_max_sync(kFull, mine ? y : -1);
  const int wx0 = __reduce_min_sync(kFull, mine ? x : INT_MAX);
  const int wx1 = __reduce_max_sync(kFull, mine ? x : -1);
  // kernel[ci][kh-1-(y-i)][kw-1-(x-j)][ch] of a window at (i, j) is
  // kernel[ci * khkwc + i * kwc + j * c + lane_off]
  const int kwc = kw * c, khkwc = kh * kwc;
  const int lane_off = (kh - 1 - y) * kwc + (kw - 1 - x) * c + ch;

  const int n_slots = c_in * e;  // flat (channel, slot) order
  const int round = n_warps * 32 * kPerLane;
  const int chunk = kListCap / round * round;
  const unsigned below = (1u << lane) - 1;
  int parity = 0;
  for (int base = 0; base < n_slots; base += chunk) {
    const int end = min(base + chunk, n_slots);
    // compaction: keep the slots whose window meets the patch, in order
    int kept = 0;
    for (int r = base; r < end; r += round) {
      const int first = r + warp * 32 * kPerLane;
      int ci[kPerLane];
      int2 ij[kPerLane];
      uint8_t ok[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {  // all loads first, unpredicated,
        // so a round waits for one memory latency, not 2 * kPerLane
        const int s = min(first + k * 32 + lane, n_slots - 1);
        ci[k] = s / e;
        const int at = (ci[k] * q_count + q) * e + (s - ci[k] * e);
        ok[k] = valid[at];
        ij[k] = coords[at];
      }
      uint32_t slot[kPerLane];
      unsigned hit[kPerLane];
      int n = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int i = min(max(ij[k].x, 0), hp - kh);
        const int j = min(max(ij[k].y, 0), wp - kw);
        const bool keep = first + k * 32 + lane < end && ok[k] &&
                          meets(i, j, kh, kw, y0, y1, x0, x1);
        slot[k] = pack_slot(ci[k], i, j);
        hit[k] = __ballot_sync(kFull, keep);
        n += __popc(hit[k]);
      }
      if (lane == 0) s_count[parity][warp] = n;
      __syncthreads();
      int at = kept;
      for (int w = 0; w < n_warps; ++w) {
        const int cnt = s_count[parity][w];
        at += w < warp ? cnt : 0;
        kept += cnt;
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if ((hit[k] >> lane) & 1u)
          s_list[at + __popc(hit[k] & below)] = slot[k];
        at += __popc(hit[k]);
      }
      parity ^= 1;  // the next round's counts go to the other buffer
    }
    __syncthreads();
    // walk: the kept slots whose window meets this warp's pixels, in order
    // (a warp that owns no cell has an empty box and skips it)
    for (int j0 = 0; j0 < kept && wy0 <= wy1; j0 += 32) {
      const int jj = j0 + lane;
      const uint32_t u = jj < kept ? s_list[jj] : 0u;
      const int ui = (u >> kColBits) & kRowMask, uj = u & kColMask;
      unsigned hit = __ballot_sync(
          kFull, jj < kept && meets(ui, uj, kh, kw, wy0, wy1, wx0, wx1));
      while (hit) {
        // up to kWalkBatch matches at a time: their weight loads are
        // independent and issue together; the adds then run in order
        int off[kWalkBatch];
        bool add[kWalkBatch];
#pragma unroll
        for (int r = 0; r < kWalkBatch; ++r) {
          const uint32_t v = __shfl_sync(kFull, u, (__ffs(hit) - 1) & 31);
          const int vi = (v >> kColBits) & kRowMask, vj = v & kColMask;
          add[r] = hit != 0 && mine && (unsigned)(y - vi) < (unsigned)kh &&
                   (unsigned)(x - vj) < (unsigned)kw;
          off[r] = add[r] ? (int)(v >> (kRowBits + kColBits)) * khkwc +
                                vi * kwc + vj * c + lane_off
                          : 0;
          hit &= hit - 1;
        }
        T w[kWalkBatch];
#pragma unroll
        for (int r = 0; r < kWalkBatch; ++r) w[r] = kernel[off[r]];
#pragma unroll
        for (int r = 0; r < kWalkBatch; ++r)
          if (add[r]) acc = sat_add(acc, w[r]);
      }
    }
    __syncthreads();  // the next chunk overwrites the list
  }
  if (mine) vm_out[cell] = acc;
}

// The patch of one CTA: from 8 x 8 pixels, halved (columns first) until
// its cells fit kGatherThreads, then until the grid covers the card's SMs
// or a CTA would own fewer than 64 cells.
void gather_patch(int q, int hp, int wp, int cs, int slices, int* ph,
                  int* pw) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  int h = 8, w = 8;
  auto halve = [&] {
    if (w >= h) w /= 2;
    else h /= 2;
  };
  while (h * w * cs > kGatherThreads) halve();
  auto ctas = [&] {
    return (long)q * slices * ((hp + h - 1) / h) * ((wp + w - 1) / w);
  };
  while (ctas() < n_sm && h * w * cs >= 128 && h * w > 1) halve();
  *ph = h;
  *pw = w;
}

template <typename T>
cudaError_t launch_gather(const void* vm_in, void* vm_out, const void* coords,
                          const void* valid, const void* kernel, int c_in,
                          int q, int e, int hp, int wp, int c, int kh, int kw,
                          cudaStream_t stream) {
  const int cs = c < kGatherChannels ? c : kGatherChannels;
  const int slices = (c + cs - 1) / cs;
  int ph, pw;
  gather_patch(q, hp, wp, cs, slices, &ph, &pw);
  const int cells = (ph * pw * cs + 31) / 32 * 32;
  const int threads = cells > kGatherMinThreads ? cells : kGatherMinThreads;
  const dim3 grid(((hp + ph - 1) / ph) * ((wp + pw - 1) / pw), q, slices);
  event_conv_gather_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
      static_cast<const int2*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<const T*>(kernel), c_in, q, e, hp, wp, c, kh, kw, ph, pw,
      cs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the interlaced batched entry
// needs (the wrapper checks it against the 227 KB per-block limit first).
size_t event_conv_smem_bytes(int e, int hp, int wp, int c, int kh, int kw,
                             int event_par, int itemsize) {
  return Layout(e, hp, wp, c, kh, kw, event_par, (size_t)itemsize).total;
}

// The same for one CTA (one channel slice) of the interlaced single-queue
// entry.
size_t event_conv_single_smem_bytes(int e, int hp, int wp, int c, int kh,
                                    int kw, int event_par, int itemsize) {
  const int slice = single_slice(kh, kw, event_par, c);
  return Layout(e, hp, wp, slice, kh, kw, event_par, (size_t)itemsize).total;
}

#define DISPATCH(call)                                 \
  switch (dtype) {                                     \
    case 0: return call(float);                        \
    case 1: return call(int16_t);                      \
    case 2: return call(int8_t);                       \
    default: return (int)cudaErrorInvalidValue;        \
  }

// dtype: 0 float32, 1 int16, 2 int8.  Each returns cudaGetLastError().
// The sequential entries take C_in queues per tile: coords (C_in, Q, E, 2),
// valid (C_in, Q, E), kernel (C_in, kh, kw, C); Q = 1 for the single entry.
int event_conv_seq_batched(const void* vm_in, void* vm_out,
                           const void* coords, const void* valid,
                           const void* kernel, int c_in, int q, int e, int hp,
                           int wp, int c, int kh, int kw, int dtype,
                           void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_gather<T>(vm_in, vm_out, coords, valid, kernel, c_in, \
                                 q, e, hp, wp, c, kh, kw, s)
  DISPATCH(CALL)
#undef CALL
}

int event_conv_interlaced_batched(const void* vm_in, void* vm_out,
                                  const void* coords, const void* valid,
                                  const void* kernel, int q, int e, int hp,
                                  int wp, int c, int kh, int kw,
                                  int event_par, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_interlaced<T>(vm_in, vm_out, coords, valid, kernel, \
                                     q, e, hp, wp, c, kh, kw, event_par, s)
  DISPATCH(CALL)
#undef CALL
}

int event_conv_seq_single(const void* vm_in, void* vm_out, const void* coords,
                          const void* valid, const void* kernel, int c_in,
                          int e, int hp, int wp, int c, int kh, int kw,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_gather<T>(vm_in, vm_out, coords, valid, kernel, c_in, \
                                 1, e, hp, wp, c, kh, kw, s)
  DISPATCH(CALL)
#undef CALL
}

int event_conv_interlaced_single(const void* vm_in, void* vm_out,
                                 const void* coords, const void* valid,
                                 const void* kernel, int e, int hp, int wp,
                                 int c, int kh, int kw, int event_par,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_interlaced_single<T>(vm_in, vm_out, coords, valid,  \
                                            kernel, e, hp, wp, c, kh, kw,  \
                                            event_par, s)
  DISPATCH(CALL)
#undef CALL
}

#undef DISPATCH

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
