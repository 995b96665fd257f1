// Fused thresholding unit for Hopper (sm_90a), batched over Q tiles.
//
// Replaces threshold_pool_pallas (src/repro/kernels/threshold_pool/
// kernel.py, _threshold_pool_kernel) in its base mode; the fused-emission
// outputs (emit_capacity) are not ported yet.
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
  const int hp = h + 2 * hh, wp = w + 2 * hw;
  const T b = bias[ch];
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

}  // namespace

extern "C" {

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
