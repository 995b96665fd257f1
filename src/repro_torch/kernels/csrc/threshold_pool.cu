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
// What bounds it on the card: bytes.  It reads and writes every neuron
// once and does a handful of operations on each, far below the ratio at
// which the ALUs would matter.  One thread owns one pooled cell and one
// channel, walks its p x p window, and keeps the OR in a register, so the
// spike map is never re-read; channels are innermost, so neighbouring
// threads touch neighbouring bytes.

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

// Bias, threshold and latch over the p x p window of pooled cell (py, px)
// of tile qq, channel ch, in place; returns the window's OR.
template <typename T, typename V>
__device__ __forceinline__ uint8_t threshold_window(
    T* vm, T b, const uint8_t* fired_in, uint8_t* fired_out, size_t qq,
    int py, int px, int ch, int h, int w, int c, int hh, int hw, int pool,
    V v_t) {
  const int hp = h + 2 * hh, wp = w + 2 * hw;
  uint8_t any = 0;
  const int y_end = min(py * pool + pool, h), x_end = min(px * pool + pool, w);
  for (int y = py * pool; y < y_end; ++y) {
    for (int x = px * pool; x < x_end; ++x) {
      const size_t vi = ((qq * hp + y + hh) * wp + x + hw) * c + ch;
      const T v = sat_add(vm[vi], b);
      vm[vi] = v;
      const size_t fi = ((qq * h + y) * w + x) * c + ch;
      const uint8_t s = (v > v_t) || fired_in[fi] != 0;
      fired_out[fi] = s;
      any |= s;
    }
  }
  return any;
}

template <typename T, typename V>
__global__ void threshold_pool_kernel(T* vm, const T* __restrict__ bias,
                                      const uint8_t* fired_in,
                                      uint8_t* fired_out, uint8_t* pooled,
                                      int q, int h, int w, int c, int hh,
                                      int hw, int pool, int ph, int pw,
                                      V v_t) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)q * ph * pw * c;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  size_t r = idx / c;
  const int px = (int)(r % pw);
  r /= pw;
  const int py = (int)(r % ph);
  const size_t qq = r / ph;
  const uint8_t any = threshold_window(vm, bias[ch], fired_in, fired_out, qq,
                                       py, px, ch, h, w, c, hh, hw, pool, v_t);
  if (pooled != nullptr) pooled[idx] = any;
}

template <typename T, typename V>
cudaError_t launch(void* vm, const void* bias, const void* fired_in,
                   void* fired_out, void* pooled, int q, int h, int w, int c,
                   int hh, int hw, int pool, V v_t, cudaStream_t stream) {
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  const size_t total = (size_t)q * ph * pw * c;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  threshold_pool_kernel<T, V><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(vm), static_cast<const T*>(bias),
      static_cast<const uint8_t*>(fired_in), static_cast<uint8_t*>(fired_out),
      static_cast<uint8_t*>(pooled), q, h, w, c, hh, hw, pool, ph, pw, v_t);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Emit mode: the base unit, then the pooled map leaves the unit already
// compacted into the next layer's fused-handoff carrier (the paper's
// run-time AEQ builder right behind the comparators).
//
// One CTA per (channel, tile) = slab (ch, q) of the carrier.  The CTA
// walks the pooled map in the consumer's interlace order n = (s, I, J)
// (column s = kw*(i%kh) + j%kw, macro cell (I, J) = (i//kh, j//kw)) over
// the map padded to window multiples; each thread owns a contiguous run
// of n, thresholds the p x p window of each of its cells in place
// (writing fired_out and pooled) and keeps the pooled bit in shared
// memory.  A block-wide exclusive scan of the per-thread bit counts
// (warp shuffles, then one shared-memory pass over the warp totals)
// gives each set bit its rank in the (s, i, j) read order; the block
// total is the demand count.  A bit is kept when its rank is below
// min(capacity, h'*w'): aeq.ranked_keep's tail drop.  Last, every byte of
// the slab (n_banks, HBp+2, WBp+2) is written once, 0 or the kept bit
// placed by aeq.place_padded_banks' static offsets, so the zero ring and
// every unkept cell are cleared on each launch.
//
// What bounds it on the card: bytes (~0.6 MB per launch at the FULL
// conv0 shapes, against ~10^5 operations), so each neuron is read and
// written once and the carrier is written once, with no second pass over
// the pooled map in device memory.  Its time is launch latency plus the
// CTA's serial phases and three barriers.  The (channel, tile) CTA reads
// the tile with a stride of C elements, so neighbouring CTAs share
// sectors through L2 rather than coalescing.

constexpr int EMIT_THREADS = 256;
constexpr int EMIT_WARPS = EMIT_THREADS / 32;
// shared memory ahead of the bit array: 8 warp prefixes and the total
constexpr int EMIT_SMEM_HEAD = 64;

__host__ __device__ __forceinline__ int emit_cells(int h, int w, int pool,
                                                   int kh, int kw) {
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  return kh * kw * ((ph + kh - 1) / kh) * ((pw + kw - 1) / kw);
}

template <typename T, typename V>
__global__ void __launch_bounds__(EMIT_THREADS) threshold_pool_emit_kernel(
    T* vm, const T* __restrict__ bias, const uint8_t* fired_in,
    uint8_t* fired_out, uint8_t* pooled, uint8_t* masks, int* count,
    int* seg_counts, int q, int h, int w, int c, int hh, int hw, int pool,
    int kh, int kw, int capacity, V v_t) {
  extern __shared__ unsigned char smem[];
  int* warp_pre = reinterpret_cast<int*>(smem);  // [EMIT_WARPS + 1]
  uint8_t* bits = smem + EMIT_SMEM_HEAD;

  const int slab = blockIdx.x;  // = ch * q + b
  const int ch = slab / q, b = slab % q;
  const int ph = (h + pool - 1) / pool, pw = (w + pool - 1) / pool;
  const int hb = (ph + kh - 1) / kh, wb = (pw + kw - 1) / kw;
  const int col = hb * wb, nb = kh * kw, n_cells = nb * col;
  const T bb = bias[ch];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. threshold + pool, one run of interlace-ordered cells per thread
  const int run = (n_cells + EMIT_THREADS - 1) / EMIT_THREADS;
  const int n0 = min(tid * run, n_cells), n1 = min(n0 + run, n_cells);
  int mine = 0;
  for (int n = n0; n < n1; ++n) {
    const int s = n / col, r = n % col;
    const int i = (r / wb) * kh + s / kw, j = (r % wb) * kw + s % kw;
    uint8_t any = 0;
    if (i < ph && j < pw) {
      any = threshold_window(vm, bb, fired_in, fired_out, b, i, j, ch, h, w,
                             c, hh, hw, pool, v_t);
      if (pooled != nullptr) pooled[(((size_t)b * ph + i) * pw + j) * c + ch] = any;
    }
    bits[n] = any;
    mine += any;
  }

  // 2. exclusive scan of the per-thread counts
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_pre[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int wv = lane < EMIT_WARPS ? warp_pre[lane] : 0;
    int wi = wv;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    __syncwarp();
    if (lane < EMIT_WARPS) warp_pre[lane] = wi - wv;
    if (lane == 31) warp_pre[EMIT_WARPS] = wi;  // block total
  }
  __syncthreads();

  // 3. truncate: keep ranks below min(capacity, h'*w')
  const int limit = min(capacity, ph * pw);
  int rank = warp_pre[warp] + incl - mine;
  for (int n = n0; n < n1; ++n) {
    if (bits[n]) {
      bits[n] = rank < limit;
      ++rank;
    }
  }
  if (tid == 0) count[slab] = warp_pre[EMIT_WARPS];
  __syncthreads();

  // 4. kept events per column, then every carrier byte of the slab
  for (int s = tid; s < nb; s += EMIT_THREADS) {
    int kept = 0;
    for (int r = 0; r < col; ++r) kept += bits[s * col + r];
    seg_counts[(size_t)slab * nb + s] = kept;
  }
  const int ehh = kh / 2, ehw = kw / 2;
  const int hbq = (ph + 2 * ehh + kh - 1) / kh + 2;
  const int wbq = (pw + 2 * ehw + kw - 1) / kw + 2;
  const int slab_cells = nb * hbq * wbq;
  uint8_t* out = masks + (size_t)slab * slab_cells;
  for (int m = tid; m < slab_cells; m += EMIT_THREADS) {
    const int tb = m / (hbq * wbq), r = m % (hbq * wbq);
    // the column whose centres land in padded bank tb
    const int si = (tb / kw - ehh + kh) % kh, sj = (tb % kw - ehw + kw) % kw;
    const int bi = r / wbq - 1 - (si + ehh) / kh;
    const int bj = r % wbq - 1 - (sj + ehw) / kw;
    uint8_t v = 0;
    if (bi >= 0 && bi < hb && bj >= 0 && bj < wb)
      v = bits[(si * kw + sj) * col + bi * wb + bj];
    out[m] = v;
  }
}

template <typename T, typename V>
cudaError_t launch_emit(void* vm, const void* bias, const void* fired_in,
                        void* fired_out, void* pooled, void* masks,
                        void* count, void* seg_counts, int q, int h, int w,
                        int c, int hh, int hw, int pool, int kh, int kw,
                        int capacity, V v_t, cudaStream_t stream) {
  const unsigned ctas = (unsigned)q * c;
  if (ctas == 0) return cudaSuccess;
  const size_t smem = EMIT_SMEM_HEAD + emit_cells(h, w, pool, kh, kw);
  auto kern = threshold_pool_emit_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<ctas, EMIT_THREADS, smem, stream>>>(
      static_cast<T*>(vm), static_cast<const T*>(bias),
      static_cast<const uint8_t*>(fired_in), static_cast<uint8_t*>(fired_out),
      static_cast<uint8_t*>(pooled), static_cast<uint8_t*>(masks),
      static_cast<int*>(count), static_cast<int*>(seg_counts), q, h, w, c,
      hh, hw, pool, kh, kw, capacity, v_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one emit CTA for an (h, w) map, pool window
// `pool` (1 = none) and a kh x kw emit window.
size_t threshold_pool_emit_smem_bytes(int h, int w, int pool, int kh,
                                      int kw) {
  return EMIT_SMEM_HEAD + (size_t)emit_cells(h, w, pool, kh, kw);
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
