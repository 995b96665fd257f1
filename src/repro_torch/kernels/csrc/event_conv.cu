// Event-driven k x k convolution for Hopper (sm_90a): the batched
// sequential and interlaced conv units of the paper's accelerator.
//
// Replaces (src/repro/kernels/event_conv/kernel.py):
//   event_conv_seq_batched        <- event_conv_pallas_batched
//                                    (_event_conv_batched_kernel,
//                                     _apply_event_block, prefix=(0,))
//   event_conv_interlaced_batched <- event_conv_pallas_interlaced_batched
//                                    (_apply_event_block_interlaced)
//
// Contract (both): Q queues, each applied in queue order to its own
// halo-padded tile vm (Q, Hp, Wp, C).  A valid event (i, j) adds the
// 180-degree-rotated (kh, kw, C) kernel into the window at (i, j);
// int8/int16 widen to int32 and clip after every event.  vm_in and
// vm_out may alias (in-place update): a CTA reads its whole tile before
// it writes any of it.
//
// What bounds it on the card: not bytes and not adds.  A FULL-path launch
// moves ~0.5 MB (a few tenths of a microsecond at 3.35 TB/s) and does
// ~10^5 adds; the time is the serial chain of events in a queue, because
// consecutive windows may overlap and each event has to see the previous
// one's writes.  The design keeps that chain on chip: one CTA per queue
// holds the tile, the rotated kernel and the queue in shared memory
// (Pallas kept the tile VMEM-resident the same way), threads cover the
// (tap, channel) cells of one event, and one __syncthreads() separates
// events.  The interlaced unit shortens the chain by event_par: a group
// of same-column events has disjoint windows, so the whole group is one
// step with one barrier.  The walk stops at the queue's last valid slot.
// Only Q CTAs run per launch; filling the card (several channel blocks
// or time steps per launch) is later work.

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

// Dynamic shared memory of one CTA: queue coords, tile, rotated kernel,
// valid bits, and for the interlaced unit a per-slot apply bit and a
// per-group kind.
struct Layout {
  size_t coords, tile, krot, valid, keep, kind, total;
  __host__ __device__ Layout(int e, int hp, int wp, int c, int kh, int kw,
                             int event_par, size_t item) {
    coords = 0;
    tile = align16(coords + (size_t)e * 2 * sizeof(int));
    krot = align16(tile + (size_t)hp * wp * c * item);
    valid = align16(krot + (size_t)kh * kw * c * item);
    keep = align16(valid + (size_t)e);
    size_t n_keep = event_par > 1 ? (size_t)e : 0;
    kind = align16(keep + n_keep);
    size_t n_groups = event_par > 1 ? (size_t)(e / event_par) : 0;
    total = align16(kind + n_groups);
  }
};

// Stage one queue into shared memory; returns the last valid slot (-1
// when the queue is empty).  Block-uniform.
template <typename T>
__device__ int stage(const T* vm_in,
                     const int* __restrict__ coords,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ kernel, unsigned char* smem,
                     const Layout& L, int e, int hp, int wp, int c, int kh,
                     int kw, int* s_last) {
  const int q = blockIdx.x;
  int* s_coords = reinterpret_cast<int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  T* krot = reinterpret_cast<T*>(smem + L.krot);
  uint8_t* s_valid = smem + L.valid;
  const size_t n_tile = (size_t)hp * wp * c;
  const T* src = vm_in + (size_t)q * n_tile;
  for (size_t x = threadIdx.x; x < n_tile; x += blockDim.x) tile[x] = src[x];
  const int kwc = kw * c;
  const int n_k = kh * kwc;
  for (int x = threadIdx.x; x < n_k; x += blockDim.x) {
    const int a = x / kwc, r = x - a * kwc, b = r / c, ch = r - b * c;
    krot[x] = kernel[((kh - 1 - a) * kw + (kw - 1 - b)) * c + ch];
  }
  if (threadIdx.x == 0) *s_last = -1;
  __syncthreads();
  const int* qc = coords + (size_t)q * e * 2;
  const uint8_t* qv = valid + (size_t)q * e;
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

// Add the rotated kernel at event (i, j) for cells x = tid, tid+stride,
// ... of the window.  The start is clamped into the tile, as
// lax.dynamic_slice clamps it in the reference.
template <typename T>
__device__ __forceinline__ void apply_event(T* tile, const T* krot, int i,
                                            int j, int hp, int wp, int c,
                                            int kh, int kw, int x0,
                                            int stride) {
  i = min(max(i, 0), hp - kh);
  j = min(max(j, 0), wp - kw);
  T* base = tile + ((size_t)i * wp + j) * c;
  const int kwc = kw * c;
  const int n_k = kh * kwc;
  for (int x = x0; x < n_k; x += stride) {
    const int a = x / kwc, r = x - a * kwc;
    T* cell = base + (size_t)a * wp * c + r;
    *cell = sat_add(*cell, krot[x]);
  }
}

template <typename T>
__device__ __forceinline__ void unstage(T* vm_out, const T* tile,
                                        size_t n_tile) {
  T* dst = vm_out + (size_t)blockIdx.x * n_tile;
  for (size_t x = threadIdx.x; x < n_tile; x += blockDim.x) dst[x] = tile[x];
}

template <typename T>
__global__ void event_conv_seq_kernel(const T* vm_in, T* vm_out,
                                      const int* __restrict__ coords,
                                      const uint8_t* __restrict__ valid,
                                      const T* __restrict__ kernel, int e,
                                      int hp, int wp, int c, int kh, int kw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const Layout L(e, hp, wp, c, kh, kw, 1, sizeof(T));
  const int last = stage(vm_in, coords, valid, kernel, smem, L, e, hp, wp,
                         c, kh, kw, &s_last);
  const int* s_coords = reinterpret_cast<const int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  const T* krot = reinterpret_cast<const T*>(smem + L.krot);
  const uint8_t* s_valid = smem + L.valid;
  for (int ev = 0; ev <= last; ++ev) {
    if (!s_valid[ev]) continue;  // block-uniform: invalid slots add nothing
    apply_event(tile, krot, s_coords[2 * ev], s_coords[2 * ev + 1], hp, wp,
                c, kh, kw, threadIdx.x, blockDim.x);
    __syncthreads();  // the next window may overlap this one
  }
  unstage(vm_out, tile, (size_t)hp * wp * c);
}

enum GroupKind : uint8_t { kEmpty = 0, kHomogeneous = 1, kMixed = 2 };

template <typename T>
__global__ void event_conv_interlaced_kernel(
    const T* vm_in, T* vm_out, const int* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel, int e,
    int hp, int wp, int c, int kh, int kw, int event_par) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const Layout L(e, hp, wp, c, kh, kw, event_par, sizeof(T));
  const int last = stage(vm_in, coords, valid, kernel, smem, L, e, hp, wp,
                         c, kh, kw, &s_last);
  const int* s_coords = reinterpret_cast<const int*>(smem + L.coords);
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  const T* krot = reinterpret_cast<const T*>(smem + L.krot);
  const uint8_t* s_valid = smem + L.valid;
  uint8_t* s_keep = smem + L.keep;
  uint8_t* s_kind = smem + L.kind;
  const int n_groups = (last + event_par) / event_par;  // 0 when empty

  // Classify each group: the first valid slot is the anchor; the group is
  // homogeneous when every valid slot shares the anchor's interlace
  // column.  In a homogeneous group a slot repeating an earlier valid
  // slot's coordinates is dropped: the gather->add->scatter of the Pallas
  // kernel writes that window once.
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

  const int n_k = kh * kw * c;
  for (int g = 0; g < n_groups; ++g) {
    const int base = g * event_par;
    const uint8_t kind = s_kind[g];  // block-uniform
    if (kind == kEmpty) continue;
    if (kind == kHomogeneous) {
      // disjoint windows: thread x covers cell x % n_k of slot x / n_k
      for (int x = threadIdx.x; x < event_par * n_k; x += blockDim.x) {
        const int p = x / n_k;
        const int s = base + p;
        if (!s_keep[s]) continue;
        apply_event(tile, krot, s_coords[2 * s], s_coords[2 * s + 1], hp, wp,
                    c, kh, kw, x - p * n_k, n_k);
      }
      __syncthreads();
    } else {
      for (int p = 0; p < event_par; ++p) {
        const int s = base + p;
        if (!s_valid[s]) continue;
        apply_event(tile, krot, s_coords[2 * s], s_coords[2 * s + 1], hp, wp,
                    c, kh, kw, threadIdx.x, blockDim.x);
        __syncthreads();
      }
    }
  }
  unstage(vm_out, tile, (size_t)hp * wp * c);
}

int threads_for(int cells) {
  int t = (cells + 31) / 32 * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

template <typename T>
cudaError_t launch_seq(const void* vm_in, void* vm_out, const void* coords,
                       const void* valid, const void* kernel, int q, int e,
                       int hp, int wp, int c, int kh, int kw,
                       cudaStream_t stream) {
  const Layout L(e, hp, wp, c, kh, kw, 1, sizeof(T));
  if (L.total > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        event_conv_seq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.total);
    if (err != cudaSuccess) return err;
  }
  event_conv_seq_kernel<T><<<q, threads_for(kh * kw * c), L.total, stream>>>(
      static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
      static_cast<const int*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<const T*>(kernel), e, hp, wp, c, kh, kw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_interlaced(const void* vm_in, void* vm_out,
                              const void* coords, const void* valid,
                              const void* kernel, int q, int e, int hp,
                              int wp, int c, int kh, int kw, int event_par,
                              cudaStream_t stream) {
  const Layout L(e, hp, wp, c, kh, kw, event_par, sizeof(T));
  if (L.total > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        event_conv_interlaced_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
  }
  event_conv_interlaced_kernel<T>
      <<<q, threads_for(event_par * kh * kw * c), L.total, stream>>>(
          static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
          static_cast<const int*>(coords), static_cast<const uint8_t*>(valid),
          static_cast<const T*>(kernel), e, hp, wp, c, kh, kw, event_par);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the 227 KB per-block limit before launching).
size_t event_conv_smem_bytes(int e, int hp, int wp, int c, int kh, int kw,
                             int event_par, int itemsize) {
  return Layout(e, hp, wp, c, kh, kw, event_par, (size_t)itemsize).total;
}

// dtype: 0 float32, 1 int16, 2 int8.  Returns cudaGetLastError().
int event_conv_seq_batched(const void* vm_in, void* vm_out,
                           const void* coords, const void* valid,
                           const void* kernel, int q, int e, int hp, int wp,
                           int c, int kh, int kw, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_seq<float>(vm_in, vm_out, coords, valid, kernel, q,
                                     e, hp, wp, c, kh, kw, s);
    case 1: return launch_seq<int16_t>(vm_in, vm_out, coords, valid, kernel,
                                       q, e, hp, wp, c, kh, kw, s);
    case 2: return launch_seq<int8_t>(vm_in, vm_out, coords, valid, kernel,
                                      q, e, hp, wp, c, kh, kw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int event_conv_interlaced_batched(const void* vm_in, void* vm_out,
                                  const void* coords, const void* valid,
                                  const void* kernel, int q, int e, int hp,
                                  int wp, int c, int kh, int kw,
                                  int event_par, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_interlaced<float>(vm_in, vm_out, coords, valid,
                                            kernel, q, e, hp, wp, c, kh, kw,
                                            event_par, s);
    case 1: return launch_interlaced<int16_t>(vm_in, vm_out, coords, valid,
                                              kernel, q, e, hp, wp, c, kh, kw,
                                              event_par, s);
    case 2: return launch_interlaced<int8_t>(vm_in, vm_out, coords, valid,
                                             kernel, q, e, hp, wp, c, kh, kw,
                                             event_par, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
