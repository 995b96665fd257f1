// Fused thresholding unit for Hopper (sm_90a), batched over Q tiles.
//
// Replaces threshold_pool_pallas (src/repro/kernels/threshold_pool/
// kernel.py, _threshold_pool_kernel):
//   threshold_pool_batched <- the base mode;
//   threshold_pool_emit    <- the emit mode (emit_capacity, with
//                             ref.emit_banked), described further down.
//
// Per neuron: bias add (saturating for int8/int16), spike = (vm > v_t) OR
// fired, then an optional p x p OR-pool of the spike map.  The pool
// window is ceil-sized at the ragged edge (cells past H or W do not
// exist), which is what the reference's pad-with-False pool computes.
//
// The membrane tile comes halo-padded, (Q, H+2hh, W+2hw, C), and is
// updated in place on its inner (H, W) region; the halo is neither read
// nor written.  fired_in / fired_out are (Q, H, W, C) bytes and may alias;
// pooled is (Q, ceil(H/p), ceil(W/p), C) bytes, or null without a pool.
//
// Base mode.  What bounds it on the card: nominally bytes, ~10 bytes and
// 3 operations per neuron (0.5 MB, 0.15 us at the FULL conv0/conv1 shapes
// at B=8); in practice latency.  The tiles were just written by the conv
// unit and sit in L2, a launch covers 4,000-50,000 neurons, and so the
// time is the launch plus the chain of dependent steps each CTA waits on.
// The first design gave one thread a pooled cell and walked its p x p
// window load, store, load, store: fired_in and fired_out may alias, so
// the compiler could not move a load above the store before it, and at
// pool 3 each thread waited on nine round trips, with 6,400 threads (25
// CTAs) at B=8 and 64-bit index division.
//
// This design:
// * one thread owns V consecutive channels of one pixel (V = 4 as one
//   16-byte float4 / 8-byte short4 / 4-byte char4 of vm and one 4-byte
//   word of fired, where C % 4 == 0 and every base pointer is aligned;
//   else V = 1, the scalar path of the same kernel, as at conv2's C = 5 or
//   a view at an odd offset).  It issues every load first (vm, fired_in,
//   bias through the read-only path), then stores vm and fired_out: one
//   round trip per thread.  A neuron is read and written by one thread at
//   one index, so fired_out may alias fired_in with no ordering between
//   threads.
// * a CTA owns whole rows of one tile: threads (channel group, pixel, row)
//   with channels innermost, so a warp covers contiguous bytes.  With a
//   pool it owns whole pool bands (p rows) of a column range; each thread
//   puts its spike bytes into shared memory, and after one barrier the
//   threads OR each pooled cell's p x p words there (4 channels at a time,
//   all reads of a window up to 3 x 3 at once) and store pooled
//   coalesced.  The spike map is not re-read from global memory.  A
//   thread stores the vm and spikes of its (first) access after the
//   barrier, where the compiler issues those reads ahead of the stores:
//   stores issued before the barrier held the reads behind them (in
//   clock probe builds the time from the barrier to the end of the OR
//   was most of a CTA's time).  Without a pool (a compile-time case)
//   there is no shared memory and no barrier.
// * the grid is sized from the SM count: without a pool, rows per CTA grow
//   until the CTAs fit on the SMs (conv0 at B=8: 112 CTAs of 2 rows); with
//   a pool, each band is split into column ranges until the bands' CTAs
//   cover the SMs (one sample at conv1: 100 CTAs of one pooled cell).
// * a CTA holds at least one pooled cell's p x p x C spike bytes in
//   shared memory, so a window of more than 227 KB of them is refused
//   (cudaErrorInvalidValue); no config comes near it.
// * index math is 32-bit (the wrapper refuses 2**31 elements); a CTA's
//   tile and band come from one division of blockIdx, a thread's
//   coordinates from its thread index, and no thread divides per neuron.

#include <cooperative_groups.h>
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

constexpr int kBaseMaxThreads = 1024;
constexpr int kBaseMaxRows = 64;          // blockDim.z
constexpr int kBaseSmem = 48 * 1024;      // pool bands held per CTA
constexpr int kBaseMaxSmem = 232448;      // with the opt-in attribute
constexpr int kBaseWindow = 3;            // pool windows ORed all at once

// Four consecutive channels as one access: vm, and their spike bytes.
__device__ __forceinline__ float4 sat_add(float4 a, float4 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}
__device__ __forceinline__ short4 sat_add(short4 a, short4 b) {
  return {sat_add(a.x, b.x), sat_add(a.y, b.y), sat_add(a.z, b.z),
          sat_add(a.w, b.w)};
}
__device__ __forceinline__ char4 sat_add(char4 a, char4 b) {
  return {sat_add(a.x, b.x), sat_add(a.y, b.y), sat_add(a.z, b.z),
          sat_add(a.w, b.w)};
}
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int16_t> { using type = short4; };
template <> struct Vec4<int8_t> { using type = char4; };

// spike = (vm > v_t) OR fired, per channel
template <typename T, typename V>
__device__ __forceinline__ uint8_t fire(T nv, uint8_t f, V v_t) {
  return (nv > v_t) || f != 0;
}
template <typename T4, typename V>
__device__ __forceinline__ uchar4 fire(T4 nv, uchar4 f, V v_t) {
  return make_uchar4(fire(nv.x, f.x, v_t), fire(nv.y, f.y, v_t),
                     fire(nv.z, f.z, v_t), fire(nv.w, f.w, v_t));
}
// the spike bytes of one access as one word, for the pool's OR
template <typename S> struct Word { using type = uint32_t; };
template <> struct Word<uint8_t> { using type = uint8_t; };

// One CTA's rows [y0, y0 + ny) x columns [x0, x0 + nx) of tile qq, A = the
// vm access of sizeof(S) channels, S = their spike bytes.
template <typename T, typename V, bool POOL, typename A, typename S>
__device__ __forceinline__ void threshold_cells(
    T* vm, const T* __restrict__ bias, const uint8_t* fired_in,
    uint8_t* fired_out, uint8_t* pooled, uint8_t* spk, int qq, int g,
    int y0, int x0, int ny, int nx, int h, int w, int c, int hh, int hw,
    int pool, int ph, int pw, int cols, V v_t) {
  constexpr int n = sizeof(S);
  const int hp = h + 2 * hh, wp = w + 2 * hw;
  // with a pool, a thread's first access is stored after the barrier, so
  // that the pool's shared-memory reads do not queue behind the stores
  A* held_vm = nullptr;
  S* held_fired = nullptr;
  A held_nv{};
  S held_s{};
  for (int dy = threadIdx.z; dy < ny; dy += blockDim.z) {
    for (int dx = threadIdx.y; dx < nx; dx += blockDim.y) {
      const int vi = ((qq * hp + y0 + dy + hh) * wp + x0 + dx + hw) * c;
      const int fi = ((qq * h + y0 + dy) * w + x0 + dx) * c;
      for (int ch = threadIdx.x * n; ch < c; ch += blockDim.x * n) {
        A* vp = reinterpret_cast<A*>(vm + vi + ch);
        S* fp = reinterpret_cast<S*>(fired_out + fi + ch);
        const A v = *vp;
        const S f = *reinterpret_cast<const S*>(fired_in + fi + ch);
        const A nv = sat_add(v, *reinterpret_cast<const A*>(bias + ch));
        const S s = fire(nv, f, v_t);
        if (POOL) {
          *reinterpret_cast<S*>(spk + (dy * cols + dx) * c + ch) = s;
          if (held_vm == nullptr) {
            held_vm = vp;
            held_fired = fp;
            held_nv = nv;
            held_s = s;
            continue;
          }
        } else if (pooled != nullptr) {  // pool 1: pooled is the spike map
          *reinterpret_cast<S*>(pooled + fi + ch) = s;
        }
        *vp = nv;
        *fp = s;
      }
    }
  }
  if (!POOL) return;
  __syncthreads();
  // the shared-memory reads below do not alias these stores, so they are
  // issued ahead of them
  if (held_vm != nullptr) {
    *held_vm = held_nv;
    *held_fired = held_s;
  }
  // OR each pooled cell's p x p spike words; cells past H or W are absent
  using W = typename Word<S>::type;
  for (int k = threadIdx.z * blockDim.y + threadIdx.y;
       k < (nx + pool - 1) / pool; k += blockDim.y * blockDim.z) {
    const int kx = min(pool, nx - k * pool);
    const uint8_t* s0 = spk + k * pool * c;
    uint8_t* out = pooled + ((qq * ph + g) * pw + x0 / pool + k) * c;
    for (int ch = threadIdx.x * n; ch < c; ch += blockDim.x * n) {
      W any = 0;
      if (pool <= kBaseWindow) {  // every read in flight at once
#pragma unroll
        for (int dy = 0; dy < kBaseWindow; ++dy)
#pragma unroll
          for (int dx = 0; dx < kBaseWindow; ++dx)
            if (dy < ny && dx < kx)
              any |= *reinterpret_cast<const W*>(
                  s0 + (dy * cols + dx) * c + ch);
      } else {
        for (int dy = 0; dy < ny; ++dy)
          for (int dx = 0; dx < kx; ++dx)
            any |= *reinterpret_cast<const W*>(s0 + (dy * cols + dx) * c + ch);
      }
      *reinterpret_cast<W*>(out + ch) = any;
    }
  }
}

// Grid: x = (tile, row group), y = column range; block: x = channel
// group, y = pixel of the range, z = row of the group.  rows x cols input
// cells per CTA; with POOL rows == pool and cols a multiple of pool, so
// the CTA holds whole pooled cells.  vec: four channels per access.
template <typename T, typename V, bool POOL>
__global__ void __launch_bounds__(kBaseMaxThreads) threshold_pool_kernel(
    T* vm, const T* __restrict__ bias, const uint8_t* fired_in,
    uint8_t* fired_out, uint8_t* pooled, int h, int w, int c, int hh,
    int hw, int pool, int ph, int pw, int groups, int rows, int cols,
    bool vec, V v_t) {
  extern __shared__ __align__(16) uint8_t spk[];  // POOL: [rows][cols][c]
  const int qq = blockIdx.x / groups;
  const int g = blockIdx.x - qq * groups;
  const int y0 = g * rows, x0 = blockIdx.y * cols;
  const int ny = min(rows, h - y0), nx = min(cols, w - x0);
  if (vec)
    threshold_cells<T, V, POOL, typename Vec4<T>::type, uchar4>(
        vm, bias, fired_in, fired_out, pooled, spk, qq, g, y0, x0, ny, nx,
        h, w, c, hh, hw, pool, ph, pw, cols, v_t);
  else
    threshold_cells<T, V, POOL, T, uint8_t>(
        vm, bias, fired_in, fired_out, pooled, spk, qq, g, y0, x0, ny, nx,
        h, w, c, hh, hw, pool, ph, pw, cols, v_t);
}

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  return n_sm;
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename V>
cudaError_t launch(void* vm, const void* bias, const void* fired_in,
                   void* fired_out, void* pooled, int q, int h, int w, int c,
                   int hh, int hw, int pool, V v_t, cudaStream_t stream) {
  if ((size_t)q * h * w * c == 0) return cudaSuccess;
  const bool vec = c % 4 == 0 && aligned(vm, 4 * sizeof(T)) &&
                   aligned(bias, 4 * sizeof(T)) && aligned(fired_in, 4) &&
                   aligned(fired_out, 4) && aligned(pooled, 4);
  const int n_sm = sm_count();
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  const int tx = min(vec ? c / 4 : c, kBaseMaxThreads);
  int rows, cols, groups, chunks;
  if (pool > 1) {
    // whole pool bands; split each band's columns until the bands' CTAs
    // cover the SMs, within the thread and shared-memory budgets (a window
    // wider than the map is the map)
    rows = min(pool, h);
    groups = ph;
    const int split = max(1, min(pw, n_sm / (q * ph)));
    const long long window = (long long)rows * pool;
    int pcols = (pw + split - 1) / split;
    pcols = (int)min((long long)pcols,
                     max(1LL, kBaseMaxThreads / (tx * window)));
    pcols = (int)min((long long)pcols, max(1LL, kBaseSmem / (window * c)));
    cols = (int)min((long long)pcols * pool, (long long)w);
    chunks = (pw + pcols - 1) / pcols;
  } else {
    // whole rows; more rows per CTA until the CTAs fit on the SMs
    cols = min(w, max(1, kBaseMaxThreads / tx));
    chunks = (w + cols - 1) / cols;
    rows = 1;
    while (rows < h && rows < kBaseMaxRows &&
           (size_t)q * ((h + rows - 1) / rows) * chunks > (size_t)n_sm &&
           tx * cols * (rows + 1) <= kBaseMaxThreads)
      ++rows;
    groups = (h + rows - 1) / rows;
  }
  const int ty = min(cols, kBaseMaxThreads / tx);
  const int tz = min(min(rows, kBaseMaxRows), kBaseMaxThreads / (tx * ty));
  if ((size_t)q * groups > 0x7fffffffu || chunks > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(q * groups), (unsigned)chunks);
  const dim3 block(tx, ty, tz);
  if (pool > 1) {
    const size_t smem = (size_t)rows * cols * c;
    if (smem > kBaseMaxSmem) return cudaErrorInvalidValue;
    auto kern = threshold_pool_kernel<T, V, true>;
    if (smem > kBaseSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<grid, block, smem, stream>>>(
        static_cast<T*>(vm), static_cast<const T*>(bias),
        static_cast<const uint8_t*>(fired_in),
        static_cast<uint8_t*>(fired_out), static_cast<uint8_t*>(pooled), h,
        w, c, hh, hw, pool, ph, pw, groups, rows, cols, vec, v_t);
  } else {
    threshold_pool_kernel<T, V, false><<<grid, block, 0, stream>>>(
        static_cast<T*>(vm), static_cast<const T*>(bias),
        static_cast<const uint8_t*>(fired_in),
        static_cast<uint8_t*>(fired_out), static_cast<uint8_t*>(pooled), h,
        w, c, hh, hw, pool, ph, pw, groups, rows, cols, vec, v_t);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Emit mode: the base unit, then the pooled map leaves the unit already
// compacted into the next layer's fused-handoff carrier (the paper's
// run-time AEQ builder right behind the comparators).
//
// Per slab (channel, tile) of the carrier: the pooled map is walked in
// the consumer's interlace order n = (s, I, J) (column s = kw*(i%kh) +
// j%kw, macro cell (I, J) = (i//kh, j//kw)) over the map padded to window
// multiples; P(n), the number of set bits before n, ranks each bit, and a
// bit is kept when P(n) < min(capacity, h'*w') (aeq.ranked_keep's tail
// drop).  The demand count is P at the end; the kept events of column s
// are seg_counts[s] = min(P(end of s), limit) - min(P(start of s),
// limit), straight from the scan.  Every byte of the slab (n_banks,
// HBp+2, WBp+2) is written on each launch, 0 or the kept bit placed by
// aeq.place_padded_banks' static offsets, so the zero ring and every
// unkept cell are cleared.
//
// What bounds it on the card: bytes (~0.6 MB per launch at the FULL conv0
// shapes, against ~10^5 operations), and below that, at these sizes,
// latency: the first design ran one 256-thread CTA per slab (64 CTAs at
// B=8, half the SMs idle), in four phases with three barriers, and its
// per-column counts were a serial loop of 9 threads over ~100 bytes each
// (8.94 us per launch against 4.50 us for the base mode).  This design:
//
// * splits each slab over a thread block cluster of K CTAs (K <= 8, the
//   smallest that gives CTAs to more than half the SMs: K = 2 at B=8, 128
//   CTAs), each CTA owning a contiguous range of n.  Reading the tile
//   coalesced across channels instead (a CTA per tile's channel block)
//   would leave 8 CTAs at B=8 and a scan per channel with lanes on the
//   channel axis; the cluster keeps one channel per CTA and the scan per
//   slab, and the C CTAs that read one pixel's channels share its sectors
//   through L2.
// * ranks by warp intrinsics: one cell per lane in interlace order,
//   __ballot_sync + __popc within a warp, one barrier for the warps'
//   counts, which warp 0 scans (shuffles) into the CTA's total.  The CTAs
//   exchange totals through distributed shared memory (one cluster
//   barrier), so each lane knows its P(n) without a second pass.
// * takes seg_counts from the scan: the lane at the first cell of each
//   column s >= 1 stores P there into CTA 0's table, and CTA 0 differences
//   the table after the second cluster barrier.  No serial loop.
// * writes the slab once, in 16-byte stores: each CTA holds a slice of
//   the slab image in shared memory, zeroed first; a kept bit is stored
//   into the slice's owner CTA (distributed shared memory), and after the
//   second barrier each CTA writes its slice.
// A lane thresholds its cell's p x p window (up to 3 x 3) with all its
// loads in flight before the first store (vm, fired_in and fired_out may
// alias: each neuron is read before it is written, by the one lane that
// owns it).  A CTA takes at most 1024 cells per round and 32 rounds, so a
// slab may hold 8 x 1024 x 32 interlace cells.  What is left (PERF.md):
// the tile's first read and the two cluster barriers, each waiting for
// the slower CTA.

constexpr int kEmitMaxCluster = 8;   // portable cluster size
constexpr int kEmitMaxThreads = 1024;
constexpr int kEmitMaxRounds = 32;   // bits of a lane's round mask
constexpr int kEmitWindow = 3;       // pool windows loaded all at once

__host__ __device__ __forceinline__ int emit_cells(int h, int w, int pool,
                                                   int kh, int kw) {
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  return kh * kw * ((ph + kh - 1) / kh) * ((pw + kw - 1) / kw);
}

// Bias, threshold and latch over the p x p window of pooled cell (py, px)
// of tile b, channel ch, in place; returns the window's OR.  Windows up to
// 3 x 3 issue every load before the first store; larger ones go row by
// row.
template <typename T, typename V>
__device__ __forceinline__ bool threshold_window_batched(
    T* vm, T bb, const uint8_t* fired_in, uint8_t* fired_out, size_t b,
    int py, int px, int ch, int h, int w, int c, int hh, int hw, int pool,
    V v_t) {
  const int wp = w + 2 * hw;
  const int y0 = py * pool, x0 = px * pool;
  const int ny = min(pool, h - y0), nx = min(pool, w - x0);
  T* v0 = vm + (((b * (h + 2 * hh) + y0 + hh) * wp + x0 + hw) * c + ch);
  const size_t f0 = ((b * h + y0) * w + x0) * c + ch;
  if (pool == 1) {  // no pool: the window is the neuron
    const uint8_t f = fired_in[f0];
    const T nv = sat_add(*v0, bb);
    *v0 = nv;
    const uint8_t s = (nv > v_t) || f != 0;
    fired_out[f0] = s;
    return s;
  }
  bool any = false;
  if (pool <= kEmitWindow) {
    T v[kEmitWindow][kEmitWindow];
    uint8_t f[kEmitWindow][kEmitWindow];
#pragma unroll
    for (int dy = 0; dy < kEmitWindow; ++dy)
#pragma unroll
      for (int dx = 0; dx < kEmitWindow; ++dx)
        if (dy < ny && dx < nx) {
          v[dy][dx] = v0[(dy * wp + dx) * c];
          f[dy][dx] = fired_in[f0 + (dy * w + dx) * c];
        }
#pragma unroll
    for (int dy = 0; dy < kEmitWindow; ++dy)
#pragma unroll
      for (int dx = 0; dx < kEmitWindow; ++dx)
        if (dy < ny && dx < nx) {
          const T nv = sat_add(v[dy][dx], bb);
          v0[(dy * wp + dx) * c] = nv;
          const uint8_t s = (nv > v_t) || f[dy][dx] != 0;
          fired_out[f0 + (dy * w + dx) * c] = s;
          any |= s;
        }
    return any;
  }
  for (int dy = 0; dy < ny; ++dy)
    for (int dx = 0; dx < nx; ++dx) {
      const T nv = sat_add(v0[(dy * wp + dx) * c], bb);
      v0[(dy * wp + dx) * c] = nv;
      const uint8_t s =
          (nv > v_t) || fired_in[f0 + (dy * w + dx) * c] != 0;
      fired_out[f0 + (dy * w + dx) * c] = s;
      any |= s;
    }
  return any;
}

// One CTA of a slab's cluster.  parts = K CTAs per slab, per_part cells
// each (the last may hold fewer), rounds = ceil(per_part / blockDim.x);
// the slab image is cut into slices of slice_words 16-byte words.
template <typename T, typename V>
__global__ void __launch_bounds__(kEmitMaxThreads) threshold_pool_emit_kernel(
    T* vm, const T* __restrict__ bias, const uint8_t* fired_in,
    uint8_t* fired_out, uint8_t* pooled, uint8_t* masks, int* count,
    int* seg_counts, int q, int h, int w, int c, int hh, int hw, int pool,
    int kh, int kw, int capacity, V v_t, int parts, int per_part,
    int rounds, int slice_words) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = (int)cluster.block_rank();
  const int slab = blockIdx.x / parts;  // = ch * q + b
  const int ch = slab / q, b = slab % q;
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  const int hb = (ph + kh - 1) / kh, wb = (pw + kw - 1) / kw;
  const int col = hb * wb, nb = kh * kw, n_cells = nb * col;
  const int ehh = kh / 2, ehw = kw / 2;
  const int hbq = (ph + 2 * ehh + kh - 1) / kh + 2;
  const int wbq = (pw + 2 * ehw + kw - 1) / kw + 2;
  const int slab_cells = nb * hbq * wbq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // shared memory: the slab image slice, the (round, warp) counts, this
  // CTA's total, and (CTA 0) P at every column start
  uint8_t* image = smem;
  int* tab = reinterpret_cast<int*>(smem + (size_t)slice_words * 16);
  int* part_total = tab + rounds * n_warps;
  int* bnd = part_total + 1;  // [nb + 1]
  for (int k = tid; k < slice_words; k += blockDim.x)
    reinterpret_cast<uint4*>(image)[k] = make_uint4(0, 0, 0, 0);

  // 1. threshold + pool one cell per lane per round, interlace order
  const int n_begin = part * per_part;
  const int n_end = min(n_begin + per_part, n_cells);
  const T bb = bias[ch];
  uint32_t mine = 0;  // bit r: this lane's cell of round r is set
  for (int r = 0; r < rounds; ++r) {
    const int n = n_begin + r * blockDim.x + tid;
    bool bit = false;
    if (n < n_end) {
      const int s = n / col, rr = n % col;
      const int i = (rr / wb) * kh + s / kw, j = (rr % wb) * kw + s % kw;
      if (i < ph && j < pw) {
        bit = threshold_window_batched(vm, bb, fired_in, fired_out, b, i, j,
                                       ch, h, w, c, hh, hw, pool, v_t);
        if (pooled != nullptr)
          pooled[(((size_t)b * ph + i) * pw + j) * c + ch] = bit;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) tab[r * n_warps + warp] = __popc(bal);
    mine |= (uint32_t)bit << r;
  }
  __syncthreads();

  // 2. exclusive scan of the (round, warp) counts: the CTA's prefixes
  if (warp == 0) {
    int run = 0;
    for (int base = 0; base < rounds * n_warps; base += 32) {
      const int idx = base + lane;
      const int v = idx < rounds * n_warps ? tab[idx] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (idx < rounds * n_warps) tab[idx] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) *part_total = run;
  }
  cluster.sync();  // every CTA's total and prefixes are in place

  // 3. this CTA's offset in the slab and the slab's demand
  int base = 0, total = 0;
  for (int p = 0; p < parts; ++p) {
    const int v = *cluster.map_shared_rank(part_total, p);
    base += p < part ? v : 0;
    total += v;
  }
  const int limit = min(capacity, ph * pw);
  const int gsh = (int)((uintptr_t)(masks + (size_t)slab * slab_cells) & 15);
  int* bnd0 = cluster.map_shared_rank(bnd, 0);
  for (int r = 0; r < rounds; ++r) {
    const bool bit = (mine >> r) & 1u;
    const unsigned bal = __ballot_sync(0xffffffffu, bit);
    const int n = n_begin + r * blockDim.x + tid;
    const int p = base + tab[r * n_warps + warp] +
                  __popc(bal & ((1u << lane) - 1u));  // P(n)
    if (n < n_end && n % col == 0 && n > 0) bnd0[n / col] = p;
    if (bit && p < limit) {  // kept: into the owner slice of the image
      const int s = n / col, rr = n % col;
      const int si = s / kw, sj = s % kw;
      const int tb = ((si + ehh) % kh) * kw + (sj + ehw) % kw;
      const int x = (tb * hbq + rr / wb + 1 + (si + ehh) / kh) * wbq +
                    rr % wb + 1 + (sj + ehw) / kw;
      const int at = gsh + x, owner = (at >> 4) / slice_words;
      *cluster.map_shared_rank(image + at - owner * slice_words * 16,
                               owner) = 1;
    }
  }
  if (part == 0 && tid == 0) {
    bnd[0] = 0;
    bnd[nb] = total;
  }
  cluster.sync();  // every kept bit and column start has landed

  // 4. CTA 0: demand and kept events per column
  if (part == 0) {
    if (tid == 0) count[slab] = total;
    for (int s = tid; s < nb; s += blockDim.x)
      seg_counts[(size_t)slab * nb + s] =
          min(bnd[s + 1], limit) - min(bnd[s], limit);
  }
  // 5. this CTA's slice of the slab, in 16-byte stores where whole
  uint8_t* out = masks + (size_t)slab * slab_cells;
  uint8_t* aligned = out - gsh;
  const int words = (gsh + slab_cells + 15) / 16;
  const int w0 = part * slice_words, w1 = min(w0 + slice_words, words);
  for (int k = w0 + tid; k < w1; k += blockDim.x) {
    const uint8_t* src = image + (k - w0) * 16;
    uint8_t* dst = aligned + 16 * k;
    if (dst >= out && dst + 16 <= out + slab_cells) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 16; ++e)
        if (dst + e >= out && dst + e < out + slab_cells) dst[e] = src[e];
    }
  }
}

// The cluster size, cells per CTA, threads and rounds of an emit launch;
// false when one slab holds more cells than a cluster takes.
bool emit_config(int slabs, int n_cells, int* parts, int* per_part,
                 int* threads, int* rounds) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const long cap = (long)kEmitMaxThreads * kEmitMaxRounds;
  int k = 1;
  // CTAs for more than half the SMs, each with at least a warp of cells;
  // more only as the map needs
  while (k < kEmitMaxCluster && 2L * slabs * k <= n_sm &&
         (n_cells + k) / (k + 1) >= 32)
    ++k;
  while (k < kEmitMaxCluster && (n_cells + k - 1) / k > cap) ++k;
  const int per = (n_cells + k - 1) / k;
  if (per > cap) return false;
  const int t = per < kEmitMaxThreads ? (per + 31) / 32 * 32 : kEmitMaxThreads;
  *parts = k;
  *per_part = per;
  *threads = t;
  *rounds = (per + t - 1) / t;
  return true;
}

template <typename T, typename V>
cudaError_t launch_emit(void* vm, const void* bias, const void* fired_in,
                        void* fired_out, void* pooled, void* masks,
                        void* count, void* seg_counts, int q, int h, int w,
                        int c, int hh, int hw, int pool, int kh, int kw,
                        int capacity, V v_t, cudaStream_t stream) {
  const int slabs = q * c;
  if (slabs == 0) return cudaSuccess;
  const int n_cells = emit_cells(h, w, pool, kh, kw);
  int parts, per_part, threads, rounds;
  if (!emit_config(slabs, n_cells, &parts, &per_part, &threads, &rounds))
    return cudaErrorInvalidValue;
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  const int hbq = (ph + 2 * (kh / 2) + kh - 1) / kh + 2;
  const int wbq = (pw + 2 * (kw / 2) + kw - 1) / kw + 2;
  const int slab_cells = kh * kw * hbq * wbq;
  const int slice_words = ((slab_cells + 30) / 16 + parts - 1) / parts;
  const size_t smem = (size_t)slice_words * 16 +
                      4 * ((size_t)rounds * (threads / 32) + 2 + kh * kw);
  auto kern = threshold_pool_emit_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)slabs * parts);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kern, static_cast<T*>(vm), static_cast<const T*>(bias),
      static_cast<const uint8_t*>(fired_in), static_cast<uint8_t*>(fired_out),
      static_cast<uint8_t*>(pooled), static_cast<uint8_t*>(masks),
      static_cast<int*>(count), static_cast<int*>(seg_counts), q, h, w, c,
      hh, hw, pool, kh, kw, capacity, v_t, parts, per_part, rounds,
      slice_words);
}

}  // namespace

extern "C" {

// Most interlace cells one emit slab may hold: (n_banks, HB, WB) of the
// pooled map under the consumer's window.
int threshold_pool_emit_max_cells(void) {
  return kEmitMaxCluster * kEmitMaxThreads * kEmitMaxRounds;
}

// Emit mode.  vm, bias, fired_in, fired_out, pooled as in
// threshold_pool_batched; masks (C, Q, kh*kw, HBp+2, WBp+2) bytes,
// count (C, Q) int32, seg_counts (C, Q, kh*kw) int32; kh x kw is
// the consumer's window and capacity its queue depth.
int threshold_pool_emit(void* vm, const void* bias, const void* fired_in,
                        void* fired_out, void* pooled, void* masks,
                        void* count, void* seg_counts, int q, int h, int w,
                        int c, int hh, int hw, int pool, int kh, int kw,
                        int capacity, float v_t_f, int v_t_i, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_emit<float, float>(
        vm, bias, fired_in, fired_out, pooled, masks, count, seg_counts, q,
        h, w, c, hh, hw, pool, kh, kw, capacity, v_t_f, s);
    case 1: return launch_emit<int16_t, int>(
        vm, bias, fired_in, fired_out, pooled, masks, count, seg_counts, q,
        h, w, c, hh, hw, pool, kh, kw, capacity, v_t_i, s);
    case 2: return launch_emit<int8_t, int>(
        vm, bias, fired_in, fired_out, pooled, masks, count, seg_counts, q,
        h, w, c, hh, hw, pool, kh, kw, capacity, v_t_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32 (compares against v_t_f), 1 int16, 2 int8 (compare
// against v_t_i).  pool = 1 means no pooling (pooled may be null).
// Returns cudaGetLastError().
int threshold_pool_batched(void* vm, const void* bias, const void* fired_in,
                           void* fired_out, void* pooled, int q, int h, int w,
                           int c, int hh, int hw, int pool, float v_t_f,
                           int v_t_i, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float>(vm, bias, fired_in, fired_out, pooled,
                                        q, h, w, c, hh, hw, pool, v_t_f, s);
    case 1: return launch<int16_t, int>(vm, bias, fired_in, fired_out,
                                        pooled, q, h, w, c, hh, hw, pool,
                                        v_t_i, s);
    case 2: return launch<int8_t, int>(vm, bias, fired_in, fired_out, pooled,
                                       q, h, w, c, hh, hw, pool, v_t_i, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
