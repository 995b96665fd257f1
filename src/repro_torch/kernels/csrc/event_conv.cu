// Event-driven k x k convolution for Hopper (sm_90a): the sequential and
// interlaced conv units of the paper's accelerator, batched and
// single-queue, as one output-stationary gather with two keep predicates,
// and the batched interlaced unit also as one tile-stationary scatter.
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
// owns it (patch gather) or by the one CTA that owns its tile (tile path).
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
// it repeats an earlier slot of its group, so each round of the patch
// gather first checks, by one warp shuffle per 32 slots, that every valid
// slot of a group lies above the one before it (channel, row, column):
// then nothing repeats.
// A segment-padded AEQ's groups are raster runs of one interlace column,
// valid slots first, so the check always passes there.  Elsewhere the
// exact predicate runs: where event_par divides 32 a warp's 32 consecutive
// slots are whole groups, read with warp shuffles; otherwise a candidate
// slot re-reads its group from global memory (L1 hits: the warp has just
// loaded it).
//
// Two paths.  The batched interlaced entry takes one of them, chosen by
// the wrapper (kernels/event_conv/kernel.py, tile_path) from the number of
// tiles Q, the tile's bytes, the card's SM count and event_par; every
// other entry takes the patch gather.
//
// The tile path (event_conv_gather_kernel_tile): one CTA owns one whole
// membrane tile, the memory interlacing of the paper's conv unit.  It loads
// the tile into shared memory once and stores it once at the end (in place
// when vm_in aliases vm_out: nothing else touches the tile).  It reads
// every input channel's queue once, in queue order, a group of event_par
// slots a thread: the group's valid bits first, then the coordinates of its
// valid slots only (the segment-padded tail is mostly empty).  The keep
// predicate comes from the group alone: a group whose valid slots open it
// and rise strictly in (clamped row, clamped column) repeats nothing and
// keeps every valid slot; any other group runs the exact predicate
// (dropped_slot).  Kept slots are compacted, in order, into a list in
// shared memory, and the list is cut into phases: maximal runs of slots of
// one clamped interlace column whose clamped coordinates rise strictly.
// Their kh x kw windows are pairwise disjoint, so a phase is applied by
// all threads at once, a thread per (slot, window pixel, channel vector),
// each membrane cell receiving at most one add; one barrier separates two
// phases.  Phases run in list order, so every cell receives its adds in
// (input channel, queue) order: float32 stays bit-exact, int8/int16
// saturate after every add.  A segment-padded queue's phases are its
// column segments (conv1 of the paper's net: ~288 a tile and launch, ~14
// slots each); a mixed group or a repeated coordinate only cuts a phase
// short, down to one slot.  What bounds it: shared-memory read-add-write
// of the window cells and the barrier per phase, paid once per tile and
// not per patch; the weights of a thread's fixed (window pixel, channel
// vector) stay in registers while the input channel does not change.  One
// CTA per tile cannot fill the card's SMs when Q is small, so the wrapper
// takes it where Q reaches the crossover measured on the card, and where
// the tile and the list fit in 48 KB of shared memory.
//
// The patch gather (event_conv_gather_kernel): the sequential predicate,
// the single-queue entries, and the batched interlaced entry below the
// crossover.  What bounds it at a small Q is latency: every membrane cell
// has one owning thread: it loads the cell once (neighbouring threads on
// neighbouring (pixel, channel) addresses), keeps it in a register through
// every add of every input channel and stores it once: no barrier per
// event, no atomics, no tile in shared memory.  A CTA owns a PH x PW pixel
// patch of one queue's tile (by up to 256 channels), and the host sizes
// the patch so the grid covers the card's SMs at one sample as at B=8
// (conv1: 256 CTAs of 8x4 pixels at B=8, 120 of 4x2 for one sample).  The
// CTA, at least 256 threads however few cells it owns, reads each input
// channel's queue once, all of a round's loads in flight before any is
// used, and keeps the slots that pass the predicate and whose window meets
// its patch, compacted in (channel, slot) order with a warp ballot and a
// prefix sum over the warps, into shared memory (packed: channel, row,
// column); one barrier separates the compaction from the walk.  Each warp
// then keeps, again by ballot, the kept slots whose window meets its own
// lanes' pixels and walks them in order, kWalkBatch at a time (their
// weight loads go out together, the adds follow in order); a lane adds
// kernel[ci] at its offset when its cell lies in the window.  A cell's adds
// are one ordered chain that only its owner can run; at a large Q every
// queue slot is read and tested once per patch (16 times a conv1 tile), so
// there the tile path wins.

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

// ------------------------------------------------------------ tile path
constexpr int kTileThreads = 256;
// kept slots one CTA holds at once; a round reads at most this many slots
constexpr int kTileList = 2048;
// most slots of a group (event_par) the tile path reads in one thread
constexpr int kTileMaxPar = 16;
// dynamic shared memory besides the tile: the list and the phase starts
constexpr int kTileListBytes =
    kTileList * 4 + ((kTileList + 1) * 2 + 15) / 16 * 16;
// the largest tile of the tile path: tile, list and the static scan
// buffers fit the 48 KB a CTA has without opting in (TILE_MAX_BYTES in
// kernels/event_conv/kernel.py)
constexpr int kTileMaxBytes = 36720;
constexpr uint32_t kCoordMask = (1u << (kRowBits + kColBits)) - 1;

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

// The valid bits of one group's event_par slots at v: bit p is slot p.
// words: event_par % 4 == 0 and v 4-byte aligned, read as 32-bit words.
__device__ __forceinline__ unsigned group_valid(const uint8_t* __restrict__ v,
                                                int event_par, bool words) {
  unsigned m = 0;
  if (words) {
#pragma unroll
    for (int w = 0; w < kTileMaxPar / 4; ++w) {
      if (4 * w < event_par) {
        const unsigned b = __vcmpne4(
            __ldg(reinterpret_cast<const unsigned*>(v) + w), 0u);
        m |= ((b >> 7 & 1u) | (b >> 14 & 2u) | (b >> 21 & 4u) |
              (b >> 28 & 8u)) << (4 * w);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kTileMaxPar; ++r)
      if (r < event_par && v[r]) m |= 1u << r;
  }
  return m;
}

// Exclusive prefix sum of n over the CTA; *total gets the sum.  buf holds
// one int a warp and is read after the barrier inside: the caller lets a
// barrier pass before it hands the same buf to the next call.
__device__ __forceinline__ int cta_scan(int n, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  int off = incl - n, sum = 0;
#pragma unroll
  for (int w = 0; w < kTileThreads / 32; ++w) {
    const int cnt = buf[w];
    off += w < warp ? cnt : 0;
    sum += cnt;
  }
  *total = sum;
  return off;
}

// Does kept slot u open a new phase after kept slot p?  It stays in p's
// phase when both lie in one clamped interlace column and u's clamped
// (row, column) lies above p's: then every window of the phase is
// disjoint from every other.
__device__ __forceinline__ bool opens_phase(uint32_t p, uint32_t u, int kh,
                                            int kw) {
  const uint32_t pc = p & kCoordMask, uc = u & kCoordMask;
  if (pc >= uc) return true;
  return (int)(pc >> kColBits) % kh != (int)(uc >> kColBits) % kh ||
         (int)(pc & kColMask) % kw != (int)(uc & kColMask) % kw;
}

// Grid: x = queue.  One CTA applies every input channel's queue of tile q
// to the tile held in shared memory (the head of this file).  V: channels
// of one shared-memory access (C % V == 0, kernel aligned to V elements);
// words: see group_valid.
template <typename T, int V>
__global__ void __launch_bounds__(kTileThreads, 4)
    event_conv_gather_kernel_tile(const T* vm_in, T* vm_out,
                                  const int2* __restrict__ coords,
                                  const uint8_t* __restrict__ valid,
                                  const T* __restrict__ kernel, int c_in,
                                  int q_count, int e, int hp, int wp, int c,
                                  int kh, int kw, int event_par, int words) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_round[2][kTileThreads / 32];
  __shared__ int s_phase[kTileThreads / 32];
  const int t = threadIdx.x, q = blockIdx.x;
  const int tile_elems = hp * wp * c;
  const int tile_bytes = tile_elems * (int)sizeof(T);
  T* s_vm = reinterpret_cast<T*>(s_dyn);
  uint32_t* s_list = reinterpret_cast<uint32_t*>(s_dyn + round16(tile_bytes));
  uint16_t* s_start = reinterpret_cast<uint16_t*>(s_list + kTileList);

  // the tile, in 16-byte pieces where every tile is 16-byte aligned
  const T* src = vm_in + (size_t)q * tile_elems;
  T* dst = vm_out + (size_t)q * tile_elems;
  const bool vec16 = (tile_bytes & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(vm_in) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(vm_out) & 15) == 0;
  if (vec16) {
    for (int x = t; x < tile_bytes / 16; x += kTileThreads)
      reinterpret_cast<int4*>(s_vm)[x] = reinterpret_cast<const int4*>(src)[x];
  } else {
    for (int x = t; x < tile_elems; x += kTileThreads) s_vm[x] = src[x];
  }

  // this thread's share of a phase: a fixed (window pixel, channel vector)
  // r of slots le, le + lanes, ... where a slot's items fit the CTA, else
  // items t, t + kTileThreads, ... of the phase's slots by r
  const int cv = c / V, ipe = kh * kw * cv;
  const bool fixed = ipe <= kTileThreads;
  const int lanes = fixed ? kTileThreads / ipe : 1;
  const int le = t / ipe;
  const int kwc = kw * c, khkwc = kh * kwc;
  auto offsets = [&](int r, int* cell_off, int* w_off) {
    const int pix = r / cv, vq = r - pix * cv;
    const int dy = pix / kw, dx = pix - dy * kw;
    *cell_off = (dy * wp + dx) * c + vq * V;
    *w_off = (kh - 1 - dy) * kwc + (kw - 1 - dx) * c + vq * V;
  };
  int cell_off = 0, w_off = 0;
  if (fixed) offsets(t - le * ipe, &cell_off, &w_off);
  Vec<T, V> w{};
  int w_ci = -1;  // the input channel whose weights w holds
  auto add = [&](uint32_t u, int c_off, const Vec<T, V>& wv) {
    const int i = (u >> kColBits) & kRowMask, j = u & kColMask;
    Vec<T, V>* cell =
        reinterpret_cast<Vec<T, V>*>(s_vm + (i * wp + j) * c + c_off);
    Vec<T, V> x = *cell;
#pragma unroll
    for (int v = 0; v < V; ++v) x.x[v] = sat_add(x.x[v], wv.x[v]);
    *cell = x;
  };

  // apply kept slots [0, n) of the list, phase by phase
  auto apply_list = [&](int n) {
    __syncthreads();  // the list is written
    int m = (n + kTileThreads - 1) / kTileThreads;
    m |= 1;  // an odd stride: a warp's reads fall in distinct banks
    const int k0 = min(t * m, n), k1 = min(k0 + m, n);
    int cnt = 0;
    for (int k = k0; k < k1; ++k)
      cnt += k == 0 || opens_phase(s_list[k - 1], s_list[k], kh, kw);
    int n_phases;
    int at = cta_scan(cnt, s_phase, &n_phases);
    for (int k = k0; k < k1; ++k)
      if (k == 0 || opens_phase(s_list[k - 1], s_list[k], kh, kw))
        s_start[at++] = (uint16_t)k;
    if (t == 0) s_start[n_phases] = (uint16_t)n;
    __syncthreads();
    for (int ph = 0; ph < n_phases; ++ph) {
      const int a = s_start[ph], b = s_start[ph + 1];
      if (fixed) {
        for (int k = a + le; le < lanes && k < b; k += lanes) {
          const uint32_t u = s_list[k];
          const int ci = (int)(u >> (kRowBits + kColBits));
          if (ci != w_ci) {
            w = *reinterpret_cast<const Vec<T, V>*>(kernel + ci * khkwc +
                                                    w_off);
            w_ci = ci;
          }
          add(u, cell_off, w);
        }
      } else {
        for (int it = t; it < (b - a) * ipe; it += kTileThreads) {
          const int k = a + it / ipe;
          int c_off, wo;
          offsets(it - (k - a) * ipe, &c_off, &wo);
          const uint32_t u = s_list[k];
          const int ci = (int)(u >> (kRowBits + kColBits));
          add(u, c_off,
              *reinterpret_cast<const Vec<T, V>*>(kernel + ci * khkwc + wo));
        }
      }
      __syncthreads();  // the next phase may meet these cells
    }
  };

  // read the queues: a group of event_par slots a thread, in (channel,
  // slot) order, its kept slots compacted into the list in that order
  const int gpq = e / event_par;
  const int n_groups = c_in * gpq;
  const int per_round = min(kTileThreads, kTileList / event_par);
  int kept = 0, parity = 0;
  for (int g0 = 0; g0 < n_groups; g0 += per_round) {
    const int g = g0 + t;
    uint32_t pk[kTileMaxPar];  // clamped (row, column) of each valid slot
    unsigned keep = 0;
    int ci = 0;
    if (t < per_round && g < n_groups) {
      ci = g / gpq;
      const int at = (ci * q_count + q) * e + (g - ci * gpq) * event_par;
      keep = group_valid(valid + at, event_par, words);
      if (keep) {
        // the valid slots open the group and rise: nothing repeats, so
        // every one is kept
        bool rises = true;
#pragma unroll
        for (int p = 0; p < kTileMaxPar; ++p) {
          pk[p] = 0;
          if (p < event_par && (keep >> p & 1u)) {
            const int2 ij = coords[at + p];
            pk[p] = (uint32_t)min(max(ij.x, 0), hp - kh) << kColBits |
                    (uint32_t)min(max(ij.y, 0), wp - kw);
            if (p > 0) rises &= (keep >> (p - 1) & 1u) && pk[p - 1] < pk[p];
          }
        }
        if (!rises) {
          const unsigned v = keep;
          for (int p = 1; p < event_par; ++p)
            if ((v >> p & 1u) && dropped_slot(coords + at, valid + at, p,
                                              coords[at + p], event_par, kh,
                                              kw))
              keep &= ~(1u << p);
        }
      }
    }
    int total;
    int at = cta_scan(__popc(keep), s_round[parity], &total);
    parity ^= 1;  // the next round's counts go to the other buffer
    if (kept + total > kTileList) {
      apply_list(kept);
      kept = 0;
    }
    at += kept;
#pragma unroll
    for (int p = 0; p < kTileMaxPar; ++p)
      if (keep >> p & 1u)
        s_list[at++] = (uint32_t)ci << (kRowBits + kColBits) | pk[p];
    kept += total;
  }
  if (kept) apply_list(kept);
  __syncthreads();  // the last phase's cells (or the tile, unchanged)
  if (vec16) {
    for (int x = t; x < tile_bytes / 16; x += kTileThreads)
      reinterpret_cast<int4*>(dst)[x] = reinterpret_cast<const int4*>(s_vm)[x];
  } else {
    for (int x = t; x < tile_elems; x += kTileThreads) dst[x] = s_vm[x];
  }
}

// The tile path of the batched interlaced entry: one CTA per tile.
// Refuses (cudaErrorInvalidValue) an event_par outside [2, kTileMaxPar] or
// a tile over kTileMaxBytes: the wrapper takes the patch gather there.
template <typename T>
cudaError_t launch_tile(const void* vm_in, void* vm_out, const void* coords,
                        const void* valid, const void* kernel, int c_in, int q,
                        int e, int hp, int wp, int c, int kh, int kw,
                        int event_par, cudaStream_t stream) {
  const int tile_bytes = hp * wp * c * (int)sizeof(T);
  if (event_par < 2 || event_par > kTileMaxPar || tile_bytes > kTileMaxBytes)
    return cudaErrorInvalidValue;
  // four channels an access where they divide C and the kernel is aligned
  // to them, else one (two instances a type keep the build short)
  const bool v4 =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(kernel) % (4 * sizeof(T)) == 0;
  const int words =
      event_par % 4 == 0 && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  const int smem = round16(tile_bytes) + kTileListBytes;
  auto k = v4 ? &event_conv_gather_kernel_tile<T, 4>
              : &event_conv_gather_kernel_tile<T, 1>;
  k<<<q, kTileThreads, smem, stream>>>(
      static_cast<const T*>(vm_in), static_cast<T*>(vm_out),
      static_cast<const int2*>(coords), static_cast<const uint8_t*>(valid),
      static_cast<const T*>(kernel), c_in, q, e, hp, wp, c, kh, kw, event_par,
      words);
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

// The tile path of event_conv_interlaced_batched (same operands), which
// the wrapper chooses at a large Q; event_par in [2, 16], a tile of at
// most 36720 bytes.
int event_conv_interlaced_tile(const void* vm_in, void* vm_out,
                               const void* coords, const void* valid,
                               const void* kernel, int c_in, int q, int e,
                               int hp, int wp, int c, int kh, int kw,
                               int event_par, int dtype, void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T) launch_tile<T>(vm_in, vm_out, coords, valid, kernel, c_in, q, \
                               e, hp, wp, c, kh, kw, event_par, s)
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
