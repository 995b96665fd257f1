// Banked event-driven convolution for Hopper (sm_90a): the conv unit of
// the "fused-handoff" and "banked-cuda" variants, consuming the
// fused-handoff carrier (centre-bank occupancy padded by one macro cell).
//
// Counterpart of the jnp function apply_banked_columns_fused
// (src/repro/core/event_conv.py), which the JAX package runs outside any
// Pallas kernel and XLA fuses into one pass per input channel.  Eager
// PyTorch has no such fusion (its plain version is n_banks^2 masked adds
// per input channel and block), so this kernel is that fusion.
//
// Contract: one launch per (channel block, time step) covers every input
// channel.  vm (Q, Hp, Wp, C) halo-padded tiles, updated in place; masks
// (C_in, Q, n_banks, HBp+2, WBp+2) bytes (0 or 1), the carrier slab of
// this time step; taps (C_in, n_banks, n_banks, C) in vm's type,
// tap_matrix of the block's kernel.  Padded cell (r, c) of a tile lies in
// bank t = kw*(r%kh) + c%kw at macro cell (I, J) = (r//kh, c//kw); column
// s writes it iff masks[ci, q, COL_BANK[s], I+1-DI[s,t], J+1-DJ[s,t]] is
// set, adding taps[ci, s, t].  The adds run input channel outer, column
// s inner, which is the reference's order per cell, so float32 sums are
// bit-exact and int8/int16 saturate after every add as there.
//
// What bounds it on the card.  The compulsory traffic is small (tiles in
// and out, the carrier slab, the taps: ~0.9 MB per launch at the FULL
// conv1 shapes, 0.26 us at 3.35 TB/s) and so are the adds (~10^6); what
// bounds it is latency and on-chip traffic.  The first design gave each
// (cell, channel) a thread that walked its C_in x n_banks mask bytes in
// global memory, one dependent load after another, the 8 threads of a
// cell loading the same bytes (30.9 us per conv1 launch at B=8).  This
// design:
//
// * stages in shared memory, by a producer warp.  A CTA owns a PH x PW
//   pixel patch of one tile.  Per stage of CPS = 64 / n_banks input
//   channels (7 at 3x3), one lane per channel copies the channel's carrier
//   span (bank 0 row I_lo through bank n_banks-1 row I_hi + 2: every byte
//   the patch reads) and one lane the stage's taps, each by one bulk copy
//   (cp.async.bulk) into a ring of up to kStages buffers.  The copies land
//   on an mbarrier per buffer ("full"); the consumer warps release a
//   buffer on a second one ("empty").  So the copies of the next stages
//   overlap the adds of this one, and the consumers never wait for the
//   producer's address arithmetic, only for data.  A copy keeps each
//   byte's address mod 16 (a carrier slab or a taps row may start at any
//   byte); bytes of a word that reaches outside the tensor (at most at its
//   two ends) go one by one.
// * walks set bits.  Per (cell, input channel) the n_banks carrier bytes
//   that may write the cell (byte offsets from a per-CTA table, fixed per
//   thread) form a word (bit s: column s writes the cell); two channels'
//   words share a 32-bit word (bit 16 p + s).  The thread visits the set
//   bits in ascending order (__ffs), which is input channel outer, column
//   inner, the tap loads of up to kWalk bits going out together before
//   their adds run in order.  An empty word costs one test.
// * shares the tests among a cell's channels.  A thread owns one cell and
//   a group of kGroup channels (accumulators in registers).  The lanes of
//   a cell sit in one warp; each builds one of a stage's words and
//   __shfl_sync hands them round, so every word is built once per cell.
// * covers the card.  The host halves the patch (and then the channel
//   group) until the grid has more CTAs than half the SMs: 128 CTAs of
//   8x8 pixels x 4 groups of 2 channels at conv1, B=8; 120 of 4x2 pixels
//   x 8 single channels for one sample; 72 of 4x4 x 5 at conv2.
// Each cell has exactly one owning thread per channel, which reads it once
// and writes it once (in place): no atomics.  Windows other than 9 or 25
// banks, or taps too large to stage, take the generic instance: one input
// channel per stage, taps through the read-only cache, the same order.
// What is left (PERF.md): staging the taps in every CTA (128 x 83 KB at
// conv1, B=8) and the walk, whose per-lane loops diverge across a warp's
// cells.

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

constexpr int kMaxThreads = 256;  // most consumer threads of one CTA
constexpr int kMinThreads = 64;   // a patch is not halved below two warps
constexpr int kGroup = 2;         // channels a thread owns, at most
constexpr int kWalk = 4;          // set bits whose tap loads go out together
constexpr int kStages = 4;        // most staging buffers
// shared memory the staging ring may take before the generic instance is
// used (two CTAs of this size still fit an SM)
constexpr int kStageBudget = 96 * 1024;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one CTA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// arrive (the one expected arrival) and expect `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait for phase `parity` of `bar` to complete; a copy that never lands
// traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}
// copy `bytes` (a multiple of 16) from 16-aligned global src to 16-aligned
// shared dst, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage the span [src, src + len) of a tensor [lo, hi) into shared memory
// at dst (16-aligned) + (src & 15): every byte keeps its address mod 16,
// so the span's 16-byte words go in one bulk copy; a word reaching outside
// the tensor (at most at its two ends) is copied byte by byte.  Returns
// the bytes the bulk copy brings.  Called by one thread.
__device__ __forceinline__ uint32_t stage_span(uint8_t* dst,
                                               const uint8_t* src, int len,
                                               const uint8_t* lo,
                                               const uint8_t* hi,
                                               uint64_t* bar) {
  const uintptr_t s = (uintptr_t)src, e = s + len;
  const uintptr_t w0 = s & ~(uintptr_t)15;
  uintptr_t a = w0 >= (uintptr_t)lo ? w0 : (s + 15) & ~(uintptr_t)15;
  uintptr_t z = ((e + 15) & ~(uintptr_t)15) <= (uintptr_t)hi
                    ? (e + 15) & ~(uintptr_t)15
                    : e & ~(uintptr_t)15;
  if (a >= z) a = z = s;  // the whole span by bytes
  for (uintptr_t g = s; g < a; ++g)
    dst[g - w0] = *reinterpret_cast<const uint8_t*>(g);
  for (uintptr_t g = z; g < e; ++g)
    dst[g - w0] = *reinterpret_cast<const uint8_t*>(g);
  if (a == z) return 0;
  bulk_copy(dst + (a - w0), reinterpret_cast<const void*>(a),
            (uint32_t)(z - a), bar);
  return (uint32_t)(z - a);
}

// Offset, from the cell's own carrier byte (bank t, macro cell (I, J)),
// of the byte that tells whether column s writes the cell: the column's
// centre bank COL_BANK[s], shifted by the (s, t) macro offset
// (DI, DJ) in {-1, 0, +1}.
__device__ __forceinline__ int bank_offset(int s, int t, int kh, int kw,
                                           int plane, int wbq) {
  const int hh = kh / 2, hw = kw / 2;
  const int si = s / kw, sj = s % kw, ti = t / kw, tj = t % kw;
  const int a = (ti - si + kh) % kh, b = (tj - sj + kw) % kw;
  const int di = (si + a) / kh - (si + hh) / kh;
  const int dj = (sj + b) / kw - (sj + hw) / kw;
  const int col_bank = ((si + hh) % kh) * kw + (sj + hw) % kw;
  return col_bank * plane + (1 - di) * wbq + 1 - dj;
}

// The G taps of one (column, bank) for the thread's channels: one float2
// load where `vec` says the taps are aligned for it.
template <int G, typename T>
__device__ __forceinline__ void load_taps(T (&w)[G], const T* p, int gc,
                                          bool vec) {
  if constexpr (sizeof(T) == 4 && G == 2) {
    if (vec) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      w[0] = v.x, w[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < gc) w[j] = p[j];
}

// Add the taps of the set bits of `word` to the thread's G channels (gc
// of them valid) in ascending bit order.  Bit b is column s0 + b % SLOT
// of input channel b / SLOT of the word; tp points at taps[ci, 0, t, ch0]
// of its first channel, and the next channel's taps lie ch_stride
// elements further.  The loads of up to kWalk bits go out together, then
// their adds run in order.
template <int G, int SLOT, typename T>
__device__ __forceinline__ void walk(uint32_t word, int s0, const T* tp,
                                     int ch_stride, int s_stride, int gc,
                                     bool vec, T (&acc)[G]) {
  while (word) {
    int at[kWalk];
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      const int b = __ffs(word) - 1;  // -1 once the word is empty
      at[k] = b < 0 ? -1
                    : (b / SLOT) * ch_stride + (s0 + b % SLOT) * s_stride;
      word &= word - 1;
    }
    T w[kWalk][G];
#pragma unroll
    for (int k = 0; k < kWalk; ++k)
      if (at[k] >= 0) load_taps<G>(w[k], tp + at[k], gc, vec);
#pragma unroll
    for (int k = 0; k < kWalk; ++k)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (at[k] >= 0 && j < gc) acc[j] = sat_add(acc[j], w[k][j]);
  }
}

// A consumer thread owns one cell and G channels; one more warp, the
// producer, stages the input channels.  NB > 0: exactly NB banks (9 or
// 25), bank offsets in registers, taps staged, CPS = 64 / NB input
// channels per stage.  NB == 0: any window, one input channel per stage,
// taps through the read-only cache.
template <typename T, int NB, int G>
__global__ void __launch_bounds__(kMaxThreads + 32) event_conv_banked_kernel(
    T* vm, const uint8_t* __restrict__ masks, const T* __restrict__ taps,
    int q, int hp, int wp, int c, int c_in, int kh, int kw, int hbq, int wbq,
    int ph, int pw, int stages, int span_bytes, int stage_bytes,
    int taps_at) {
  constexpr int CPS = NB > 0 ? 64 / NB : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  const int nb = NB > 0 ? NB : kh * kw, plane = hbq * wbq;
  const int ng = (c + G - 1) / G;
  const int tiles_x = (wp + pw - 1) / pw;
  const int r0 = (blockIdx.x / tiles_x) * ph, c0 = (blockIdx.x % tiles_x) * pw;
  const int qq = blockIdx.y;
  const int consumers = blockDim.x - 32;  // the last warp produces
  const int n_stage = (c_in + CPS - 1) / CPS;
  // the carrier bytes the patch reads: bank 0 row i_lo through bank nb-1
  // row i_hi (the patch's macro rows plus two), one span per channel
  const int i_lo = r0 / kh, i_hi = (min(r0 + ph, hp) - 1) / kh + 2;
  const uint8_t* m_src = masks + (size_t)qq * nb * plane + (size_t)i_lo * wbq;
  const size_t m_step = (size_t)q * nb * plane;  // next input channel
  const int tlen = nb * nb * c * (int)sizeof(T);
  const uint8_t* t_lo = reinterpret_cast<const uint8_t*>(taps);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  int* table = reinterpret_cast<int*>(empty + stages);  // [s * nb + t]
  // the producer warp stages a span per lane: lane l < CPS channel
  // ci0 + l's carrier span, lane 31 the stage's taps
  const bool producer = threadIdx.x >= consumers;
  const int lane = threadIdx.x & 31;
  auto issue = [&](int k) {
    const int st = k % stages, ci0 = k * CPS;
    const int nch = min(CPS, c_in - ci0);
    if (k >= stages) mbar_wait(empty + st, (uint32_t)(k / stages - 1) & 1u);
    // the buffer was last read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint8_t* buf = smem + st * stage_bytes;
    uint32_t bytes = 0;
    if (lane < nch)
      bytes = stage_span(buf + lane * span_bytes,
                         m_src + (ci0 + lane) * m_step,
                         (nb - 1) * plane + (i_hi - i_lo + 1) * wbq, masks,
                         masks + (size_t)c_in * m_step, full + st);
    else if (NB > 0 && lane == 31)
      bytes = stage_span(buf + taps_at, t_lo + (size_t)ci0 * tlen, nch * tlen,
                         t_lo, t_lo + (size_t)c_in * tlen, full + st);
    mbar_expect(full + st, bytes);
  };
  if (producer) {  // the first stages go out before the CTA's set-up
    if (lane == 0) {
      for (int st = 0; st < stages; ++st) {
        mbar_init(full + st, 32);
        mbar_init(empty + st, consumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int k = 0; k < min(stages, n_stage); ++k) issue(k);
  }
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x)
    table[e] = bank_offset(e / nb, e % nb, kh, kw, plane, wbq);
  __syncthreads();
  if (producer) {
    for (int k = stages; k < n_stage; ++k) issue(k);
    return;
  }

  // a consumer: its cell and channel group
  const int cell = threadIdx.x / ng, g = threadIdx.x % ng;
  const int r = r0 + cell / pw, cc = c0 + cell % pw;
  const bool mine = cell < ph * pw && r < hp && cc < wp;
  const int ch0 = g * G;
  const int gc = mine ? min(G, c - ch0) : 0;
  // a lane past the patch reads the patch's first cell (and adds nothing)
  const int t = mine ? (r % kh) * kw + cc % kw : (r0 % kh) * kw + c0 % kw;
  const int cellbase = mine ? (r / kh - i_lo) * wbq + cc / kw : c0 / kw;
  T* vp = vm + (((size_t)qq * hp + r) * wp + cc) * c + ch0;
  T acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < gc) acc[j] = vp[j];
  int off[NB > 0 ? NB : 1];
  if constexpr (NB > 0) {
#pragma unroll
    for (int s = 0; s < NB; ++s) off[s] = table[s * NB + t] + cellbase;
  }
  const int s_stride = nb * c;  // taps[ci, s] -> taps[ci, s + 1]
  constexpr int PER = NB > 0 && NB <= 16 ? 2 : 1;  // channels a word
  constexpr int NW = NB > 0 ? (CPS + PER - 1) / PER : 1;  // words a stage
  // the lanes of a cell share a warp and are enough to build a stage's
  // words one each
  const bool share = 32 % ng == 0 && ng >= NW;
  const int lead = (threadIdx.x & 31) - g;  // the cell's first lane

  for (int k = 0; k < n_stage; ++k) {
    const int st = k % stages, ci0 = k * CPS;
    mbar_wait(full + st, (uint32_t)(k / stages) & 1u);
    const uint8_t* buf = smem + st * stage_bytes;
    if constexpr (NB > 0) {
      const int nch = min(CPS, c_in - ci0);
      const uint8_t* tsrc = t_lo + (size_t)ci0 * tlen;
      const T* tp = reinterpret_cast<const T*>(buf + taps_at +
                                               ((uintptr_t)tsrc & 15)) +
                    t * c + ch0;
      // every tap of the stage aligned for float2 loads
      const bool vec = sizeof(T) == 4 && c % 2 == 0 &&
                       (((uintptr_t)tp) & 7) == 0;
      // word j of the stage: bit 16 p + s (NB <= 16, two channels a
      // word) or bit s (NB = 25) is column s of channel j * PER + p, so
      // ascending bits keep the (input channel, column) order
      auto build = [&](int j) {
        uint32_t word = 0;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int l = j * PER + p;
          if (l < nch) {
            const uint8_t* m = buf + l * span_bytes +
                               ((uintptr_t)(m_src + (ci0 + l) * m_step) & 15);
#pragma unroll
            for (int s = 0; s < NB; ++s)
              word |= (uint32_t)m[off[s]] << (16 * p + s);
          }
        }
        return word;
      };
      uint32_t wd[NW];
      if (share) {  // lane g of a cell builds word g, the cell's lanes swap
        const uint32_t own = g < NW ? build(g) : 0;
#pragma unroll
        for (int j = 0; j < NW; ++j)
          wd[j] = __shfl_sync(0xffffffffu, own, lead + j);
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j) wd[j] = build(j);
      }
      if (gc > 0) {
        const int ch_stride = nb * nb * c;  // taps[ci] -> taps[ci + 1]
#pragma unroll
        for (int j = 0; j < NW; ++j)
          walk<G, 32 / PER>(wd[j], 0, tp + j * PER * ch_stride, ch_stride,
                            s_stride, gc, vec, acc);
      }
    } else if (gc > 0) {
      const uint8_t* m = buf + ((uintptr_t)(m_src + ci0 * m_step) & 15);
      const T* tp = taps + (size_t)ci0 * nb * nb * c + t * c + ch0;
      for (int s0 = 0; s0 < nb; s0 += 16) {
        uint32_t word = 0;
        for (int s = s0; s < min(nb, s0 + 16); ++s)
          word |= (uint32_t)m[table[s * nb + t] + cellbase] << (s - s0);
        walk<G, 32>(word, s0, tp, 0, s_stride, gc, false, acc);
      }
    }
    __syncwarp();  // the warp is done with buffer st
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + st);
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < gc) vp[j] = acc[j];
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

// The patch and channel group of one thread: channel groups of kGroup, a
// patch from 8 x 8 pixels halved (columns first) to fit kMaxThreads, then
// halved while the grid has no more CTAs than half the SMs and a CTA
// keeps kMinThreads; where that is not enough, the group is halved too.
void banked_patch(int q, int hp, int wp, int c, int* ph, int* pw, int* grp) {
  const int n_sm = sm_count();
  int h = 8, w = 8, g = c < kGroup ? c : kGroup;
  auto ng = [&] { return (c + g - 1) / g; };
  auto halve = [&] {
    if (w >= h) w /= 2;
    else h /= 2;
  };
  auto ctas = [&] {
    return (long)q * ((hp + h - 1) / h) * ((wp + w - 1) / w);
  };
  for (;;) {
    while (h * w * ng() > kMaxThreads && h * w > 1) halve();
    while (2 * ctas() <= n_sm && h * w > 1 &&
           h * w * ng() / 2 >= kMinThreads)
      halve();
    if (2 * ctas() > n_sm || g == 1) break;
    g /= 2;
  }
  *ph = h;
  *pw = w;
  *grp = g;
}

long round16(long x) { return (x + 15) / 16 * 16; }

template <typename T, int NB, int G>
cudaError_t launch_kernel(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, T* vm, const uint8_t* masks,
                          const T* taps, int q, int hp, int wp, int c,
                          int c_in, int kh, int kw, int hbq, int wbq, int ph,
                          int pw, int stages, int span_bytes,
                          int stage_bytes, int taps_at) {
  auto k = event_conv_banked_kernel<T, NB, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  k<<<grid, threads, smem, stream>>>(vm, masks, taps, q, hp, wp, c, c_in, kh,
                                     kw, hbq, wbq, ph, pw, stages,
                                     span_bytes, stage_bytes, taps_at);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t launch_group(int grp, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, T* vm, const uint8_t* masks,
                         const T* taps, int q, int hp, int wp, int c,
                         int c_in, int kh, int kw, int hbq, int wbq, int ph,
                         int pw, int stages, int span_bytes, int stage_bytes,
                         int taps_at) {
#define ARGS                                                              \
  grid, threads, smem, stream, vm, masks, taps, q, hp, wp, c, c_in, kh,   \
      kw, hbq, wbq, ph, pw, stages, span_bytes, stage_bytes, taps_at
  if (grp == 2) return launch_kernel<T, NB, 2>(ARGS);
  return launch_kernel<T, NB, 1>(ARGS);
#undef ARGS
}

template <typename T>
cudaError_t launch(void* vm, const void* masks, const void* taps, int q,
                   int hp, int wp, int c, int c_in, int kh, int kw, int hbq,
                   int wbq, cudaStream_t stream) {
  if ((long)q * hp * wp * c == 0) return cudaSuccess;
  int ph, pw, grp;
  banked_patch(q, hp, wp, c, &ph, &pw, &grp);
  const int nb = kh * kw;
  const long plane = (long)hbq * wbq;
  // an input channel's longest carrier span (the patch's macro rows plus
  // two) with room for its 16-byte alignment
  const long rows = (ph + kh - 2) / kh + 3;
  const long span = round16((nb - 1) * plane + rows * wbq + 32);
  // the fast instances stage 64 / n_banks input channels' spans and taps
  // at once; the generic one a span and keeps a table of bank offsets
  const long cps = nb == 9 || nb == 25 ? 64 / nb : 1;
  const long t_bytes = round16(cps * nb * nb * c * (long)sizeof(T) + 32);
  const bool fast = cps > 1 && 2 * (cps * span + t_bytes) <= kStageBudget;
  const long stage_bytes = fast ? cps * span + t_bytes : span;
  const long table = 4L * nb * nb;
  const long budget = fast ? kStageBudget : kSmemMax - table - 16 * kStages;
  int stages = kStages;
  while (stages > 2 && stages * stage_bytes > budget) --stages;
  const size_t smem = stages * stage_bytes + 16 * stages + table;
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidConfiguration;
  const int ng = (c + grp - 1) / grp;
  // the consumers, and the producer warp
  const int threads = (ph * pw * ng + 31) / 32 * 32 + 32;
  const dim3 grid(((hp + ph - 1) / ph) * ((wp + pw - 1) / pw), q);
  T* v = static_cast<T*>(vm);
  const uint8_t* m = static_cast<const uint8_t*>(masks);
  const T* tp = static_cast<const T*>(taps);
#define ARGS                                                                \
  grp, grid, threads, smem, stream, v, m, tp, q, hp, wp, c, c_in, kh, kw,   \
      hbq, wbq, ph, pw, stages, (int)span, (int)stage_bytes,                \
      (int)(cps * span)
  if (fast && nb == 9) return launch_group<T, 9>(ARGS);
  if (fast) return launch_group<T, 25>(ARGS);
  return launch_group<T, 0>(ARGS);
#undef ARGS
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 int16, 2 int8.  Returns cudaGetLastError().
int event_conv_banked(void* vm, const void* masks, const void* taps, int q,
                      int hp, int wp, int c, int c_in, int kh, int kw,
                      int hbq, int wbq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(vm, masks, taps, q, hp, wp, c, c_in, kh, kw,
                                 hbq, wbq, s);
    case 1: return launch<int16_t>(vm, masks, taps, q, hp, wp, c, c_in, kh,
                                   kw, hbq, wbq, s);
    case 2: return launch<int8_t>(vm, masks, taps, q, hp, wp, c, c_in, kh, kw,
                                  hbq, wbq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
