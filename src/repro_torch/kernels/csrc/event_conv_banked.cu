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
// (C_in, Q, n_banks, HBp+2, WBp+2) bytes, the carrier slab of this time
// step; taps (C_in, n_banks, n_banks, C) in vm's type, tap_matrix of the
// block's kernel.  Padded cell (r, c) of a tile lies in bank
// t = kw*(r%kh) + c%kw at macro cell (I, J) = (r//kh, c//kw); column s
// writes it iff masks[ci, q, COL_BANK[s], I+1-DI[s,t], J+1-DJ[s,t]] is
// set, adding taps[ci, s, t].  The adds run input channel outer, column
// s inner, which is the reference's order per cell, so float32 sums are
// bit-exact and int8/int16 saturate after every add as there.
//
// What bounds it on the card: bytes (tiles in and out, the carrier slab,
// the taps: ~0.9 MB per launch at the FULL conv1 shapes, against a few
// 10^6 adds), so the design moves each byte once.  One thread per
// (tile, padded cell, channel) reads its cell once, walks C_in x n_banks
// mask bytes (cache-resident: a (ci, q) slab is ~1.3 KB and the C threads
// of a cell read the same byte) and writes its cell once, so the tile
// crosses device memory once per launch instead of once per input
// channel.  The walk itself, C_in x n_banks dependent loads per thread,
// is what its time is spent on.  No barrier, no atomics: each thread owns
// its cell.  The (s, t) mask offsets are tabled in shared memory.

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

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) event_conv_banked_kernel(
    T* vm, const uint8_t* __restrict__ masks, const T* __restrict__ taps,
    int q, int hp, int wp, int c, int c_in, int kh, int kw, int hbq,
    int wbq) {
  extern __shared__ int off[];  // [s * nb + t]: mask offset from (I, J)
  const int nb = kh * kw, hh = kh / 2, hw = kw / 2;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int s = e / nb, t = e % nb;
    const int si = s / kw, sj = s % kw, ti = t / kw, tj = t % kw;
    const int a = (ti - si + kh) % kh, b = (tj - sj + kw) % kw;
    const int di = (si + a) / kh - (si + hh) / kh;
    const int dj = (sj + b) / kw - (sj + hw) / kw;
    const int col_bank = ((si + hh) % kh) * kw + (sj + hw) % kw;
    off[e] = (col_bank * hbq + 1 - di) * wbq + 1 - dj;
  }
  __syncthreads();

  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)q * hp * wp * c) return;
  const int ch = (int)(idx % c);
  size_t rest = idx / c;
  const int cc = (int)(rest % wp);
  rest /= wp;
  const int rr = (int)(rest % hp);
  const int qq = (int)(rest / hp);
  const int t = (rr % kh) * kw + cc % kw;
  const size_t slab = (size_t)nb * hbq * wbq;
  const uint8_t* m = masks + qq * slab + (size_t)(rr / kh) * wbq + cc / kw;
  const T* tp = taps + (size_t)t * c + ch;  // taps[ci, s, t, ch]
  T acc = vm[idx];
  for (int ci = 0; ci < c_in; ++ci) {
    for (int s = 0; s < nb; ++s) {
      if (m[off[s * nb + t]]) acc = sat_add(acc, tp[(size_t)s * nb * c]);
    }
    m += (size_t)q * slab;
    tp += (size_t)nb * nb * c;
  }
  vm[idx] = acc;
}

template <typename T>
cudaError_t launch(void* vm, const void* masks, const void* taps, int q,
                   int hp, int wp, int c, int c_in, int kh, int kw, int hbq,
                   int wbq, cudaStream_t stream) {
  const size_t total = (size_t)q * hp * wp * c;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const size_t smem = sizeof(int) * kh * kw * kh * kw;
  event_conv_banked_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<T*>(vm), static_cast<const uint8_t*>(masks),
      static_cast<const T*>(taps), q, hp, wp, c, c_in, kh, kw, hbq, wbq);
  return cudaGetLastError();
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
