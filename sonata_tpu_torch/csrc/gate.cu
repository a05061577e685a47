// WaveNet gate for sm_90a: out = tanh(a) * sigmoid(b), where a and b are
// the two channel halves of a WaveNet pre-activation plus an optional
// per-row conditioning vector g.
//
// Replaces the TPU kernel sonata_tpu/ops/gate.py::fused_gate_pallas
// (_gate_kernel).  Bound on the card: memory.  Each output element reads
// two floats and writes one (12 bytes per element, 12*H bytes per row of
// the [rows, 2H] pre-activation), so the kernel is a single streaming pass:
// one thread per output element in a grid-stride loop, neighbouring
// threads on neighbouring time steps, so loads and stores coalesce.  The
// broadcast conditioning add (x + g) is folded into the loads, so the
// caller's add costs no extra pass over memory.
//
// Layout: channels first, as the port's WaveNet keeps its activations
// between convolutions: y [B, 2H, T] -> out [B, H, T].  g, when not null,
// is [B, 2H] (the [B, 1, 2H] conditioning, squeezed).
//
// Built without --use_fast_math: tanhf and expf are the IEEE-accurate
// library versions the tolerances assume.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gate_kernel(const float* __restrict__ y,
                            const float* __restrict__ g,
                            float* __restrict__ out, int64_t n, int T,
                            int H) {
  const int64_t step = (int64_t)blockDim.x * gridDim.x;
  const int64_t half = (int64_t)H * T;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t t = i % T;
    const int64_t bc = i / T;  // b * H + c
    const int64_t c = bc % H;
    const int64_t b = bc / H;
    const int64_t ia = (b * 2 * H + c) * T + t;
    float a = y[ia];
    float s = y[ia + half];
    if (g != nullptr) {
      a += g[b * 2 * H + c];
      s += g[b * 2 * H + H + c];
    }
    out[i] = tanhf(a) * (1.0f / (1.0f + expf(-s)));
  }
}

}  // namespace

extern "C" int sonata_gate_f32(const float* y, const float* g, float* out,
                               int B, int T, int H, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * T * H;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride covers the rest
  gate_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      y, g, out, n, T, H);
  return (int)cudaGetLastError();
}

extern "C" const char* sonata_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
