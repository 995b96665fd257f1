// Event-driven k x k convolution for Hopper (sm_90a): the sequential and
// interlaced conv units of the paper's accelerator, batched and
// single-queue.
//
// Replaces (src/repro/kernels/event_conv/kernel.py):
//   event_conv_seq_batched        <- event_conv_pallas_batched
//                                    (_event_conv_batched_kernel,
//                                     _apply_event_block, prefix=(0,))
//   event_conv_interlaced_batched <- event_conv_pallas_interlaced_batched
//                                    (_apply_event_block_interlaced)
//   event_conv_seq_single         <- event_conv_pallas
//                                    (_event_conv_kernel)
//   event_conv_interlaced_single  <- event_conv_pallas_interlaced
//                                    (_event_conv_interlaced_kernel)
//
// Contract (all four): a queue is applied in queue order to its
// halo-padded tile (Hp, Wp, C).  A valid event (i, j) adds the
// 180-degree-rotated (kh, kw, C) kernel into the window at (i, j);
// int8/int16 widen to int32 and clip after every event.  vm_in and
// vm_out may alias (in-place update): a CTA reads its whole share of the
// tile before it writes any of it, and no two CTAs share a cell.
//
// What bounds it on the card: not bytes and not adds.  A FULL-path launch
// moves ~0.5 MB (batched) or ~60 KB (single) and does at most ~10^5
// adds; the time is the serial chain of events in a queue, because
// consecutive windows may overlap and each event has to see the previous
// one's writes.  The design keeps that chain on chip: a CTA holds its
// tile, the rotated kernel and the queue in shared memory (Pallas kept
// the tile VMEM-resident the same way), threads cover the (tap, channel)
// cells of one event, and one barrier separates events.  The interlaced
// unit shortens the chain by event_par: a group of same-column events has
// disjoint windows, so the whole group is one step with one barrier.  The
// walk stops at the queue's last valid slot.
//
// Batched entries: one CTA per queue over all C channels (Q CTAs).
// Single entries: the card has one queue to spread, but output channels
// are independent, so the grid runs over channel slices: each CTA stages
// its slice of the tile and of the rotated kernel, walks the whole queue
// and writes its slice back.  A slice is as many channels as one warp
// covers with one step's cells (3 for a 3x3 sequential step, 1 for 5x5),
// so warp 0 walks the queue with a __syncwarp() between steps while the
// CTA's other warps only stage the slice and write it back; where one
// channel's step already needs more than a warp (interlaced groups of 8
// 3x3 events), a slice is one channel and the whole CTA walks with a
// block barrier.

#include <cuda_runtime.h>
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

// Channels per CTA of the single-queue entries: as many as one warp
// covers with one step's (event, tap) cells, at least one.
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

// The sequential unit: stage, one barrier per valid event, write back.
template <typename T, typename Sync>
__device__ void run_seq(const T* vm_in, T* vm_out, const int* coords,
                        const uint8_t* valid, const T* kernel,
                        unsigned char* smem, int* s_last, const Slice& s,
                        int e, int hp, int wp, int c, int kh, int kw,
                        Sync sync) {
  const Layout L(e, hp, wp, s.cs, kh, kw, 1, sizeof(T));
  const int last = stage(vm_in, coords, valid, kernel, smem, L, s, e, hp, wp,
                         c, kh, kw, s_last);
  const int* s_coords = reinterpret_cast<const int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  const T* krot = reinterpret_cast<const T*>(smem + L.krot);
  const uint8_t* s_valid = smem + L.valid;
  const int walkers = sync.walkers();
  if ((int)threadIdx.x < walkers) {
    for (int ev = 0; ev <= last; ++ev) {
      if (!s_valid[ev]) continue;  // uniform: invalid slots add nothing
      apply_event(tile, krot, s_coords[2 * ev], s_coords[2 * ev + 1], hp,
                  wp, s.cs, kh, kw, threadIdx.x, walkers);
      sync();  // the next window may overlap this one
    }
  }
  unstage(vm_out, tile, s, hp, wp, c);
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

// ---- batched entries: one CTA per queue, all channels --------------------

template <typename T>
__global__ void event_conv_seq_kernel(const T* vm_in, T* vm_out,
                                      const int* __restrict__ coords,
                                      const uint8_t* __restrict__ valid,
                                      const T* __restrict__ kernel, int e,
                                      int hp, int wp, int c, int kh, int kw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  run_seq(vm_in, vm_out, coords, valid, kernel, smem, &s_last,
          Slice{(int)blockIdx.x, 0, c}, e, hp, wp, c, kh, kw, BlockSync());
}

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

// ---- single-queue entries: one CTA per channel slice ---------------------

template <typename T, typename Sync>
__global__ void event_conv_seq_single_kernel(
    const T* vm_in, T* vm_out, const int* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel, int e,
    int hp, int wp, int c, int kh, int kw, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int c0 = blockIdx.x * slice;
  run_seq(vm_in, vm_out, coords, valid, kernel, smem, &s_last,
          Slice{0, c0, min(slice, c - c0)}, e, hp, wp, c, kh, kw, Sync());
}

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

int threads_for(int cells) {
  int t = (cells + 31) / 32 * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

// Threads of a single-queue CTA: at least 128, so staging the slice is
// not one warp's latency chain; the walkers are the whole CTA, or warp 0
// alone (WarpSync) when one warp covers a step's cells.
int single_threads(int cells) {
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
cudaError_t launch_seq(const void* vm_in, void* vm_out, const void* coords,
                       const void* valid, const void* kernel, int q, int e,
                       int hp, int wp, int c, int kh, int kw,
                       cudaStream_t stream) {
  const Layout L(e, hp, wp, c, kh, kw, 1, sizeof(T));
  return launch(event_conv_seq_kernel<T>, q, threads_for(kh * kw * c),
                L.total, stream, static_cast<const T*>(vm_in),
                static_cast<T*>(vm_out), static_cast<const int*>(coords),
                static_cast<const uint8_t*>(valid),
                static_cast<const T*>(kernel), e, hp, wp, c, kh, kw);
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
cudaError_t launch_seq_single(const void* vm_in, void* vm_out,
                              const void* coords, const void* valid,
                              const void* kernel, int e, int hp, int wp,
                              int c, int kh, int kw, cudaStream_t stream) {
  const int slice = single_slice(kh, kw, 1, c);
  const int grid = (c + slice - 1) / slice;
  const int threads = single_threads(kh * kw * slice);
  const Layout L(e, hp, wp, slice, kh, kw, 1, sizeof(T));
  auto args = [&](auto k) {
    return launch(k, grid, threads, L.total, stream,
                  static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
                  static_cast<const int*>(coords),
                  static_cast<const uint8_t*>(valid),
                  static_cast<const T*>(kernel), e, hp, wp, c, kh, kw, slice);
  };
  return kh * kw * slice <= 32
             ? args(event_conv_seq_single_kernel<T, WarpSync>)
             : args(event_conv_seq_single_kernel<T, BlockSync>);
}

template <typename T>
cudaError_t launch_interlaced_single(const void* vm_in, void* vm_out,
                                     const void* coords, const void* valid,
                                     const void* kernel, int e, int hp,
                                     int wp, int c, int kh, int kw,
                                     int event_par, cudaStream_t stream) {
  const int slice = single_slice(kh, kw, event_par, c);
  const int grid = (c + slice - 1) / slice;
  const int threads = single_threads(event_par * kh * kw * slice);
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the batched entries needs
// (the wrapper checks it against the 227 KB per-block limit first).
size_t event_conv_smem_bytes(int e, int hp, int wp, int c, int kh, int kw,
                             int event_par, int itemsize) {
  return Layout(e, hp, wp, c, kh, kw, event_par, (size_t)itemsize).total;
}

// The same for one CTA (one channel slice) of the single-queue entries.
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
int event_conv_seq_batched(const void* vm_in, void* vm_out,
                           const void* coords, const void* valid,
                           const void* kernel, int q, int e, int hp, int wp,
                           int c, int kh, int kw, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_seq<T>(vm_in, vm_out, coords, valid, kernel, q, e, \
                              hp, wp, c, kh, kw, s)
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
                          const void* valid, const void* kernel, int e,
                          int hp, int wp, int c, int kh, int kw, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_seq_single<T>(vm_in, vm_out, coords, valid, kernel, \
                                     e, hp, wp, c, kh, kw, s)
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
