// Event-set builder for Hopper (sm_90a): dense binary spike maps straight
// into the conv unit's segment-padded interlaced queues, in its launch
// layout.
//
// Replaces no Pallas kernel: the JAX package builds its queues with jnp (a
// sort in build_aeq_batched, then segment_pad), which XLA fuses.  The port
// ran the same composition as some thirty torch ops a conv layer and chunk
// (a radix sort of every (t, b, c_in) map with int64 permutations, three
// int64 cumsums over 9-element rows, an int64 scatter into a padded copy,
// then a permuted copy into the launch layout); this kernel computes the
// one thing they compute, an order-preserving, n_banks-way partitioned
// stream compaction, in one launch.  Its plain version is
// kernels/aeq_build/ref.py (that composition, unchanged).
//
// Contract.  spikes (B, T, H, W, C) bytes (0 or not), read through the
// given element strides (any view, no copy).  For every queue (t, c, b):
//   * order: interlace column s = kw*(i % kh) + (j % kw), then (i, j)
//     raster within a column;
//   * truncation: the first take_n = min(capacity, H*W) events of that
//     order are kept, so column s keeps clip(take_n - cum_s, 0, count_s)
//     (cum_s: the events of the columns before s) -- the same as
//     aeq._kept_segments' clip(min(count, take_n) - cum_s, 0, count_s);
//   * layout: each column's kept events start at a multiple of event_par
//     and their segment is padded up to one; pad and tail slots hold
//     coords (-1, -1) and valid 0; cap_pad slots a queue;
//   * count: the full demand, not the kept events.
// Outputs: coords (T, C, B, cap_pad) int2, valid (T, C, B, cap_pad) bytes,
// count (T, B, C) int32, all contiguous.  Every output slot is written
// exactly once.
//
// What bounds it: bytes written.  A queue is cap_pad * 9 bytes (an int2
// and a valid byte a slot) against H*W/8 bytes of input bits, so the
// paper net's forward at B=1024 writes 1.48 GB of queues (0.44 ms at
// 3.35 TB/s) for 149 MB of maps read; VGG-16's at B=256 writes 2.86 GB.
//
// Design.  One CTA per (t, b) slab and chunk of input channels:
// * stage: the slab's bits go to shared memory already interlaced, one
//   32-bit word per 32 cells of a column's (ceil(H/kh), ceil(W/kw)) grid,
//   [channel][column][word].  A thread builds one word from 32 byte
//   loads; consecutive threads take consecutive channels of the same
//   cells, so a channel-last slab is read coalesced.  A channel needs
//   n_banks * ceil(cells/32) * 4 bytes (4.6 KB for the paper's 28x28x32
//   slab, 18 KB for VGG's 2x2x512 one); the chunk holds as many channels
//   as 48 KB takes.
// * walk: a group of G lanes owns one queue at a time and walks its
//   columns in order.  Lane k of a word tests cell k's bit; its rank in
//   the column is the popcount of the bits below it, so no atomics, no
//   shuffles and no ballots (the groups of a warp never need each other).
//   The kept events of column s land in [off_s, off_s + seg_s), written
//   in order by consecutive lanes; then the G lanes write the segment's
//   padding, and at the end the queue's tail.  seg_s depends only on the
//   events before column s (the clip above), so one pass suffices.
// * adapting to the slab's shape, with no knob: G is 32 where a column
//   has at least 32 cells (the paper's 28x28, VGG's 32x32 and 16x16) and
//   the power of two that covers the column below (16 at 10x10 and 8x8,
//   4 at 4x4, 1 at 2x2: there each lane owns whole queues); the CTA has
//   G lanes per channel of its chunk, 32 to 256 threads.
// Index math into the outputs is 64-bit; strides are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// staged bits a CTA may hold: the static shared-memory limit, so no
// opt-in attribute is needed
constexpr int kSmemBudget = 48 * 1024;

// Hides a running sum from the optimizer.  Without it NVVM at -O3 does not
// finish (over 150 s, where the file builds in 3 s with it) deriving
// closed forms of the walk's nested running sums (cum, off, r) over
// loops whose trip counts are kernel parameters.
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

struct Shape {
  long long sb, st, sh, sw, sc;  // element strides of spikes (B, T, H, W, C)
  int b, t, h, w, c;
  int kh, kw, nb;                // window and n_banks = kh * kw
  int hb, wb, cells, wpc;        // column grid, its cells, words a column
  int cpc, chunks;               // channels a CTA, CTAs a slab
  int g;                         // lanes a queue
  int take_n, ep, cap_pad;
};

__global__ void __launch_bounds__(kMaxThreads) aeq_build_kernel(
    const uint8_t* __restrict__ spikes, int2* __restrict__ coords,
    uint8_t* __restrict__ valid, int* __restrict__ count, const Shape s) {
  extern __shared__ uint32_t bits[];  // [channel][column][word]
  const int chunk = blockIdx.x % s.chunks;
  const int slab = blockIdx.x / s.chunks;  // t * B + b: neighbouring CTAs
  const int b = slab % s.b;                // write neighbouring queues
  const int t = slab / s.b;
  const int c0 = chunk * s.cpc;
  const int nc = min(s.cpc, s.c - c0);
  const uint8_t* base = spikes + t * s.st + b * s.sb + c0 * s.sc;

  // stage: task x = (column word, channel), channel fastest
  const int tasks = s.nb * s.wpc * nc;
  for (int x = threadIdx.x; x < tasks; x += blockDim.x) {
    const int c = x % nc;
    const int cw = x / nc;  // column * wpc + word
    const int col = cw / s.wpc;
    const int cell0 = (cw % s.wpc) * 32;
    const int si = col / s.kw, sj = col % s.kw;
    const uint8_t* p = base + c * s.sc;
    int I = cell0 / s.wb, J = cell0 % s.wb;
    uint32_t word = 0;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int i = si + s.kh * I, j = sj + s.kw * J;
      if (i < s.h && j < s.w && p[i * s.sh + j * s.sw] != 0) word |= 1u << k;
      if (++J == s.wb) {
        J = 0;
        ++I;
      }
    }
    bits[(c * s.nb + col) * s.wpc + (cw % s.wpc)] = word;
  }
  __syncthreads();

  // walk: group gid owns channels gid, gid + groups, ...; lane gl tests
  // cell gl of each word (G covers a word's cells: G = 32, or a column
  // has fewer than G cells and one word)
  const int gl = threadIdx.x % s.g;
  const int groups = blockDim.x / s.g;
  const uint32_t below = (1u << gl) - 1u;
  const int2 none = make_int2(-1, -1);
#pragma unroll 1
  for (int c = threadIdx.x / s.g; c < nc; c += groups) {
    const long long q = (long long)(t * s.c + c0 + c) * s.b + b;
    int2* qc = coords + q * s.cap_pad;
    uint8_t* qv = valid + q * s.cap_pad;
    const uint32_t* cb = bits + c * s.nb * s.wpc;
    int cum = 0, off = 0;
#pragma unroll 1
    for (int col = 0; col < s.nb; ++col) {
      const int si = col / s.kw, sj = col % s.kw;
      int r = 0;  // events of this column so far
#pragma unroll 1
      for (int wd = 0; wd < s.wpc; ++wd) {
        const uint32_t word = cb[col * s.wpc + wd];
        const int rank = r + __popc(word & below);
        if (((word >> gl) & 1u) && cum + rank < s.take_n) {
          const int cell = wd * 32 + gl;
          qc[off + rank] =
              make_int2(si + s.kh * (cell / s.wb), sj + s.kw * (cell % s.wb));
          qv[off + rank] = 1;
        }
        r += __popc(word);
        opaque(r);
      }
      const int seg = min(max(s.take_n - cum, 0), r);
      const int pad = (seg + s.ep - 1) / s.ep * s.ep;
#pragma unroll 1
      for (int p = seg + gl; p < pad; p += s.g) {
        qc[off + p] = none;
        qv[off + p] = 0;
      }
      cum += r;
      off += pad;
      opaque(cum);
      opaque(off);
    }
#pragma unroll 1
    for (int p = off + gl; p < s.cap_pad; p += s.g) {
      qc[p] = none;
      qv[p] = 0;
    }
    if (gl == 0) count[(long long)slab * s.c + c0 + c] = cum;
  }
}

}  // namespace

extern "C" {

// Bytes of staged bits one input channel needs (the wrapper refuses a map
// whose one channel exceeds aeq_build_smem_budget()).
int aeq_build_smem_budget(void) { return kSmemBudget; }

// spikes (B, T, H, W, C) bytes at element strides sb..sc; coords (T, C, B,
// cap_pad) int2, valid (T, C, B, cap_pad) bytes, count (T, B, C) int32.
// take_n = min(capacity, H*W); event_par >= 1; cap_pad as
// aeq.interlaced_capacity.  Returns cudaGetLastError().
int aeq_build(const void* spikes, void* coords, void* valid, void* count,
              int b, int t, int h, int w, int c, long long sb, long long st,
              long long sh, long long sw, long long sc, int kh, int kw,
              int take_n, int event_par, int cap_pad, void* stream) {
  if (b <= 0 || t <= 0 || c <= 0) return 0;
  if (h <= 0 || w <= 0 || kh <= 0 || kw <= 0 || event_par <= 0 ||
      take_n < 0 || cap_pad < 0)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.sb = sb;
  s.st = st;
  s.sh = sh;
  s.sw = sw;
  s.sc = sc;
  s.b = b;
  s.t = t;
  s.h = h;
  s.w = w;
  s.c = c;
  s.kh = kh;
  s.kw = kw;
  s.nb = kh * kw;
  s.hb = (h + kh - 1) / kh;
  s.wb = (w + kw - 1) / kw;
  s.cells = s.hb * s.wb;
  s.wpc = (s.cells + 31) / 32;
  const long long per_channel = 4LL * s.nb * s.wpc;
  if (per_channel > kSmemBudget) return (int)cudaErrorInvalidValue;
  const int fit = (int)(kSmemBudget / per_channel);
  s.chunks = (c + fit - 1) / fit;
  s.cpc = (c + s.chunks - 1) / s.chunks;  // balanced chunks
  s.g = 1;
  while (s.g < 32 && s.g < s.cells) s.g *= 2;
  s.take_n = take_n;
  s.ep = event_par;
  s.cap_pad = cap_pad;
  const long long grid = (long long)t * b * s.chunks;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int threads = (s.cpc * s.g + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = (size_t)(s.cpc * per_channel);
  aeq_build_kernel<<<(unsigned)grid, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(spikes), static_cast<int2*>(coords),
      static_cast<uint8_t*>(valid), static_cast<int*>(count), s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
