// Streaming decode epilogue for sm_90a: crossfade taper + peak-scaled int16
// quantization of decoded windows.
//
// Replaces the TPU kernel sonata_tpu/models/decode_opts.py::_pallas_epilogue
// (_pallas_epilogue_kernel).  Per row of wav [B, S] with its emitted range
// [lo, hi):
//   gain   = quarter-sine fade-in over the first n = min(fade, hi - lo)
//            samples after lo, times a quarter-cosine fade-out over the
//            last n before hi, times 0 outside [lo, hi)
//   peak   = max |wav * gain|
//   q      = int16(clip(wav * gain * 32767 / max(peak, 0.01)))
// with the float32 operation order of the reference's _taper_gains and
// _quantize_rows, and truncation toward zero as XLA's convert does.
//
// Bound on the card: memory (read S floats, write S int16 per row; 6 bytes
// a sample).  The peak is a reduction over the whole row that must finish
// before any sample is written, so one block owns one row: pass 1 computes
// the gain and reduces max|.| with warp shuffles and then shared memory;
// pass 2 recomputes the gain (cheaper than keeping S floats around) and
// writes int16.  A single block per row leaves most SMs idle at batch 1;
// splitting wide rows across blocks is later work.
//
// Built without --use_fast_math: sinf/cosf and the division are the
// IEEE-accurate versions the +-1 LSB tolerance assumes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float taper_gain(int idx, int lo, int hi,
                                            int fade) {
  const int n = min(fade, hi - lo);
  const float nf = (float)max(n, 1);
  const float half_pi = 1.57079632679489661923f;
  const float in_gain =
      (idx - lo < n) ? sinf((float)(idx - lo) / nf * half_pi) : 1.0f;
  const float out_gain =
      (idx >= hi - n) ? cosf((float)(idx - (hi - n)) / nf * half_pi) : 1.0f;
  const float mask = (idx >= lo && idx < hi) ? 1.0f : 0.0f;
  return in_gain * out_gain * mask;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const float* __restrict__ wav, const int* __restrict__ lo,
                    const int* __restrict__ hi, int16_t* __restrict__ q,
                    float* __restrict__ peak, int S, int fade) {
  __shared__ float warp_peaks[kThreads / 32];
  __shared__ float row_peak;
  const int row = blockIdx.x;
  const float* w = wav + (int64_t)row * S;
  int16_t* qr = q + (int64_t)row * S;
  const int l = lo[row];
  const int h = hi[row];

  float m = 0.0f;
  for (int i = threadIdx.x; i < S; i += kThreads)
    m = fmaxf(m, fabsf(w[i] * taper_gain(i, l, h, fade)));
  m = warp_max(m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_peaks[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kThreads / 32 ? warp_peaks[lane] : 0.0f);
    if (lane == 0) {
      row_peak = m;
      peak[row] = m;
    }
  }
  __syncthreads();

  const float scale = 32767.0f / fmaxf(row_peak, 0.01f);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float v = w[i] * taper_gain(i, l, h, fade) * scale;
    qr[i] = (int16_t)fminf(fmaxf(v, -32768.0f), 32767.0f);
  }
}

}  // namespace

extern "C" int sonata_epilogue_f32(const float* wav, const int* lo,
                                   const int* hi, int16_t* q, float* peak,
                                   int B, int S, int fade, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  epilogue_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(wav, lo, hi, q,
                                                            peak, S, fade);
  return (int)cudaGetLastError();
}
