// Event-driven k x k convolution for Hopper (sm_90a): the sequential and
// interlaced conv units of the paper's accelerator, batched and
// single-queue, as one output-stationary gather with two keep predicates.
//
// Replaces (src/repro/kernels/event_conv/kernel.py):
//   event_conv_seq_batched        <- event_conv_pallas_batched
//                                    (_event_conv_batched_kernel,
//                                     _apply_event_block, prefix=(0,))
//   event_conv_seq_single         <- event_conv_pallas
//                                    (_event_conv_kernel)
//   event_conv_interlaced_batched <- event_conv_pallas_interlaced_batched
//                                    (_apply_event_block_interlaced)
//   event_conv_interlaced_single  <- event_conv_pallas_interlaced
//                                    (_event_conv_interlaced_kernel)
//   each composed over the c_in fori_loop of apply_all_cins
//   (src/repro/core/scheduler.py:615-635): one launch takes every input
//   channel's queues of one (channel block, time step).
//
// Contract (all four): coords (C_in, Q, E, 2), valid (C_in, Q, E), kernel
// (C_in, kh, kw, C) unrotated, tiles (Q, Hp, Wp, C) halo-padded; Q = 1 for
// the single entries.  A kept event (i, j) of input channel ci adds the
// 180-degree-rotated kernel[ci] into the window starting at the clamped
// (i, j); int8/int16 widen to int32 and clip after every add.  Input
// channel 0's queue is applied first, then channel 1's, and so on: per
// membrane cell the order of adds is (input channel, kept slot), the order
// of the JAX package's per-channel Pallas calls, so float32 stays
// bit-exact and saturation exact.  vm_in and vm_out may alias (in-place
// update): a cell is read before it is written, by the one thread that
// owns it.
//
// The two predicates.  Sequential: a slot is kept iff it is valid.
// Interlaced (event_par > 1, E a multiple of it): per aligned group of
// event_par slots of one queue, the first valid slot is the anchor; the
// group is homogeneous when every valid slot shares the anchor's interlace
// column (i mod kh) * kw + (j mod kw) (floor modulo).  A homogeneous group
// is one gather -> add -> scatter in the Pallas kernel: windows of distinct
// coordinates are disjoint, and a slot repeating the raw (i, j) of an
// earlier valid slot lands once, so it is dropped.  A mixed group runs in
// queue order, every valid slot kept.  Replaying the kept slots in order is
// what the Pallas kernel computes.  Groups are aligned in the flat (channel,
// slot) order too (E % event_par == 0).  A slot can only be dropped where
// it repeats an earlier slot of its group, so each round first checks, by
// one warp shuffle per 32 slots, that every valid slot of a group lies
// above the one before it (channel, row, column): then nothing repeats.
// A segment-padded AEQ's groups are raster runs of one interlace column,
// valid slots first, so the check always passes there.  Elsewhere the
// exact predicate runs: where event_par divides 32 a warp's 32 consecutive
// slots are whole groups, read with warp shuffles; otherwise a candidate
// slot re-reads its group from global memory (L1 hits: the warp has just
// loaded it).
//
// What bounds the gather on the card is bytes: a conv1 launch at B=8
// reads and writes eight 30x30x8 float32 tiles (460 KB) and reads 32 x 8
// queues of 256 slots (590 KB; 320 segment-padded) and 9 KB of weights,
// for ~10^6 adds.  Every membrane cell has one owning thread: it loads the
// cell once (neighbouring threads on neighbouring (pixel, channel)
// addresses), keeps it in a register through every add of every input
// channel and stores it once: no barrier per event, no atomics, no tile in
// shared memory.  A CTA owns a PH x PW pixel patch of one queue's tile (by
// up to 256 channels), and the host sizes the patch so the grid covers the
// card's SMs at one sample as at B=8 (conv1: 256 CTAs of 8x4 pixels at
// B=8, 120 of 4x2 for one sample).  The CTA, at least 256 threads however
// few cells it owns, reads each input channel's queue once, all of a
// round's loads in flight before any is used, and keeps the slots that pass
// the predicate and whose window meets its patch, compacted in (channel,
// slot) order with a warp ballot and a prefix sum over the warps, into
// shared memory (packed: channel, row, column); one barrier separates the
// compaction from the walk.  Each warp then keeps, again by ballot, the
// kept slots whose window meets its own lanes' pixels and walks them in
// order, kWalkBatch at a time (their weight loads go out together, the adds
// follow in order); a lane adds kernel[ci] at its offset when its cell
// lies in the window.  The kernel is read through the read-only cache (L1,
// the same SRAM as shared memory).  What is left is latency: a cell's adds
// are one ordered chain (~94 at conv1's density) that only its owner can
// run, and a single tile has under two cell-owning warps per SM to hide it.

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

// Interlace column of a raw event address, with floor modulo (as JAX's and
// PyTorch's %): (i mod kh) * kw + (j mod kw).
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int column_of(int2 ij, int kh, int kw) {
  return floor_mod(ij.x, kh) * kw + floor_mod(ij.y, kw);
}

// The lanes whose slot the interlaced predicate drops, where event_par
// divides 32 and the warp's 32 slots start at a multiple of 32, so each
// aligned group is event_par consecutive lanes.  v: the lane's slot is
// valid; ij: its raw coordinates.  Called by the whole warp; every lane
// takes part in every shuffle (none sits behind a short-circuit).  Not
// inlined: it runs only where a group's slots do not rise, and inlined it
// cost the hot loop registers and a quarter of its time.
__device__ __noinline__ unsigned dropped_lanes(bool v, int2 ij, int lane,
                                                  int event_par, int kh,
                                                  int kw) {
  const unsigned vb = __ballot_sync(kFull, v);
  const int g0 = lane & -event_par;  // the group's first lane
  const unsigned gm =
      (event_par == 32 ? kFull : (1u << event_par) - 1u) << g0;
  const unsigned earlier = vb & gm & ((1u << lane) - 1u);
  // an earlier valid slot of the group with the same raw (i, j)
  bool repeat = false;
  for (int r = 0; r < event_par - 1; ++r) {
    const int oi = __shfl_sync(kFull, ij.x, r, event_par);
    const int oj = __shfl_sync(kFull, ij.y, r, event_par);
    repeat |= ((earlier >> (g0 + r)) & 1u) && oi == ij.x && oj == ij.y;
  }
  // homogeneous: every valid slot shares the anchor's column
  const unsigned gv = vb & gm;
  const int col = column_of(ij, kh, kw);
  const int acol = __shfl_sync(kFull, col, gv ? __ffs(gv) - 1 : lane);
  const bool homog = (__ballot_sync(kFull, v && col != acol) & gm) == 0u;
  return __ballot_sync(kFull, v && repeat && homog);
}

// The same for one valid slot at place p of its group, where event_par
// does not divide 32: qc / qv point at the group's first slot in global
// memory.
__device__ bool dropped_slot(const int2* __restrict__ qc,
                             const uint8_t* __restrict__ qv, int p, int2 ij,
                             int event_par, int kh, int kw) {
  bool repeat = false;
  for (int r = 0; r < p && !repeat; ++r) {
    const int2 o = qc[r];
    repeat = qv[r] && o.x == ij.x && o.y == ij.y;
  }
  if (!repeat) return false;
  int acol = -1;
  for (int r = 0; r < event_par; ++r) {
    if (!qv[r]) continue;
    const int col = column_of(qc[r], kh, kw);
    if (acol < 0) acol = col;
    else if (col != acol) return false;  // mixed: every valid slot applies
  }
  return true;
}

// The keep predicate of a launch: every valid slot (the sequential unit),
// or the interlaced one over groups of event_par slots, read by warp
// shuffles where event_par divides 32 and from global memory otherwise.
enum Keep { kValid, kGroupsInWarp, kGroupsAcross };

// Grid: x = pixel patch (row-major over the tile), y = queue, z = channel
// slice.  coords (C_in, Q, E, 2), valid (C_in, Q, E), kernel (C_in, kh,
// kw, C) unrotated; tiles (Q, Hp, Wp, C); event_par unused for kValid.
template <typename T, Keep K>
__global__ void __launch_bounds__(kGatherThreads) event_conv_gather_kernel(
    const T* vm_in, T* vm_out, const int2* __restrict__ coords,
    const uint8_t* __restrict__ valid, const T* __restrict__ kernel,
    int c_in, int q_count, int e, int hp, int wp, int c, int kh, int kw,
    int ph, int pw, int cs, int event_par) {
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
    // compaction: keep the slots that pass the predicate and whose window
    // meets the patch, in order
    int kept = 0;
    for (int r = base; r < end; r += round) {
      const int first = r + warp * 32 * kPerLane;  // a multiple of 32
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
      // interlaced: does every valid slot that does not open its group
      // follow a valid slot of its group with a lower (channel, clamped
      // row, clamped column)?  Then no group repeats a coordinate and the
      // predicate drops nothing.  A segment-padded AEQ's groups are raster
      // runs of one column segment, valid slots first, so this holds there.
      bool rises = true;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int s = first + k * 32 + lane;
        const bool v = s < end && ok[k];
        const int i = min(max(ij[k].x, 0), hp - kh);
        const int j = min(max(ij[k].y, 0), wp - kw);
        const bool keep = v && meets(i, j, kh, kw, y0, y1, x0, x1);
        slot[k] = pack_slot(ci[k], i, j);
        hit[k] = __ballot_sync(kFull, keep);
        if (K != kValid) {
          // the lane below's slot, or above every slot where it is invalid
          const uint32_t up =
              __shfl_up_sync(kFull, v ? slot[k] : 0xffffffffu, 1);
          const bool opens = K == kGroupsInWarp
                                 ? (lane & (event_par - 1)) == 0
                                 : s % event_par == 0;
          rises &= !v || opens || (lane > 0 && up < slot[k]);
        }
      }
      if (K != kValid && !__all_sync(kFull, rises)) {
        // the keep predicate, where a slot is a candidate
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (!hit[k]) continue;  // warp-uniform
          const int s = first + k * 32 + lane;
          const bool v = s < end && ok[k];
          if (K == kGroupsInWarp) {
            hit[k] &= ~dropped_lanes(v, ij[k], lane, event_par, kh, kw);
          } else {
            bool drop = false;
            if ((hit[k] >> lane) & 1u) {
              const int at = (ci[k] * q_count + q) * e + (s - ci[k] * e);
              const int g = (s - ci[k] * e) % event_par;
              drop = dropped_slot(coords + at - g, valid + at - g, g, ij[k],
                                  event_par, kh, kw);
            }
            hit[k] &= ~__ballot_sync(kFull, drop);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) n += __popc(hit[k]);
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

// event_par: 1 for the sequential predicate, > 1 for the interlaced one.
template <typename T>
cudaError_t launch_gather(const void* vm_in, void* vm_out, const void* coords,
                          const void* valid, const void* kernel, int c_in,
                          int q, int e, int hp, int wp, int c, int kh, int kw,
                          int event_par, cudaStream_t stream) {
  const int cs = c < kGatherChannels ? c : kGatherChannels;
  const int slices = (c + cs - 1) / cs;
  int ph, pw;
  gather_patch(q, hp, wp, cs, slices, &ph, &pw);
  const int cells = (ph * pw * cs + 31) / 32 * 32;
  const int threads = cells > kGatherMinThreads ? cells : kGatherMinThreads;
  const dim3 grid(((hp + ph - 1) / ph) * ((wp + pw - 1) / pw), q, slices);
  auto k = event_par <= 1        ? &event_conv_gather_kernel<T, kValid>
           : 32 % event_par == 0 ? &event_conv_gather_kernel<T, kGroupsInWarp>
                                 : &event_conv_gather_kernel<T, kGroupsAcross>;
  k<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
      static_cast<const int2*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<const T*>(kernel), c_in, q, e, hp, wp, c, kh, kw, ph, pw,
      cs, event_par);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define DISPATCH(call)                                 \
  switch (dtype) {                                     \
    case 0: return call(float);                        \
    case 1: return call(int16_t);                      \
    case 2: return call(int8_t);                       \
    default: return (int)cudaErrorInvalidValue;        \
  }

// dtype: 0 float32, 1 int16, 2 int8.  Each returns cudaGetLastError().
// Every entry takes C_in queues per tile: coords (C_in, Q, E, 2), valid
// (C_in, Q, E), kernel (C_in, kh, kw, C); Q = 1 for the single entries.
// The interlaced entries take event_par >= 2 dividing E.
int event_conv_seq_batched(const void* vm_in, void* vm_out,
                           const void* coords, const void* valid,
                           const void* kernel, int c_in, int q, int e, int hp,
                           int wp, int c, int kh, int kw, int dtype,
                           void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_gather<T>(vm_in, vm_out, coords, valid, kernel, c_in, \
                                 q, e, hp, wp, c, kh, kw, 1, s)
  DISPATCH(CALL)
#undef CALL
}

int event_conv_interlaced_batched(const void* vm_in, void* vm_out,
                                  const void* coords, const void* valid,
                                  const void* kernel, int c_in, int q, int e,
                                  int hp, int wp, int c, int kh, int kw,
                                  int event_par, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_gather<T>(vm_in, vm_out, coords, valid, kernel, c_in, \
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
                                 1, e, hp, wp, c, kh, kw, 1, s)
  DISPATCH(CALL)
#undef CALL
}

int event_conv_interlaced_single(const void* vm_in, void* vm_out,
                                 const void* coords, const void* valid,
                                 const void* kernel, int c_in, int e, int hp,
                                 int wp, int c, int kh, int kw, int event_par,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_gather<T>(vm_in, vm_out, coords, valid, kernel, c_in, \
                                 1, e, hp, wp, c, kh, kw, event_par, s)
  DISPATCH(CALL)
#undef CALL
}

#undef DISPATCH

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
