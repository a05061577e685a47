// WaveNet gate for sm_90a: out = tanh(a) * sigmoid(b), where a and b are
// the two channel halves of a WaveNet pre-activation plus an optional
// per-row conditioning vector g.
//
// Replaces the TPU kernel sonata_tpu/ops/gate.py::fused_gate_pallas
// (_gate_kernel).  Bound on the card: memory.  Each output element reads
// two floats and writes one (12 bytes), against a few operations, so the
// kernel is one streaming pass shaped for Hopper's memory system:
//
// - 2-D launch: grid (x, y, z) = (time slots, channel rows, batch).  A
//   thread owns one 16-byte vector of one (b, c) row: it loads a float4 of
//   a and a float4 of b and stores a float4 of output.  The row bases and
//   the b-half offset (H*T) are products computed once per thread; no
//   division anywhere.
// - One wave: at [4, 384, 384] (B, T, 2H) the 73,728 threads are all
//   resident at once (the card holds 270,336), and each SM has about 18 KB
//   of loads in flight, which is what 3.35 TB/s needs at ~0.7 us of memory
//   latency (Little's law over 132 SMs).  So one vector per thread.
// - Ragged rows: a row is read and written in float4s when its a, b and
//   out rows start at the same position within 16 bytes (always on the
//   main path, where T is a frame bucket, a multiple of 64).  Such a row
//   has a scalar head up to the first 16-byte boundary and a scalar tail,
//   both done by the thread after the last vector.  A row whose three
//   starts differ in phase (T % 4 != 0 on some rows, or x at a storage
//   offset) is done with scalar accesses, four elements a thread.
// - Conditioning: g[b, c] and g[b, H + c] are read once per thread, with
//   g's row stride from the caller, so the strided [B, 1, 2H] view that wn
//   passes (one layer's slice of every layer's conditioning) is read in
//   place.
//
// Layout: channels first, as the port's WaveNet keeps its activations
// between convolutions: y [B, 2H, T] -> out [B, H, T].
//
// Built without --use_fast_math: tanhf and expf are the IEEE-accurate
// library versions the tolerances assume, in the 1/(1+e^-s) form of
// torch.sigmoid.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float gate1(float a, float s) {
  return tanhf(a) * (1.0f / (1.0f + expf(-s)));
}

__device__ __forceinline__ int phase4(const void* p) {
  return (int)(((uintptr_t)p >> 2) & 3);  // position within 16 bytes, in floats
}

template <bool kHasG>
__global__ void gate_kernel(const float* __restrict__ y,
                            const float* __restrict__ g, int64_t g_stride,
                            float* __restrict__ out, int T, int H) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // slot in the row
  const int c = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (c >= H || j >= (T + 3) / 4) return;
  const float* ya = y + ((int64_t)b * 2 * H + c) * T;
  const float* yb = ya + (int64_t)H * T;
  float* o = out + ((int64_t)b * H + c) * T;
  float ga = 0.0f, gb = 0.0f;
  if (kHasG) {
    ga = g[b * g_stride + c];
    gb = g[b * g_stride + H + c];
  }
  auto scalar = [&](int i) {
    o[i] = gate1(kHasG ? ya[i] + ga : ya[i], kHasG ? yb[i] + gb : yb[i]);
  };
  const int pa = phase4(ya);
  if (pa == phase4(yb) && pa == phase4(o)) {
    const int head = min((4 - pa) & 3, T);
    const int nv = (T - head) >> 2;  // ceil(T/4) slots hold nv + 1 if needed
    if (j < nv) {
      const int i = head + 4 * j;
      float4 va = __ldg(reinterpret_cast<const float4*>(ya + i));
      float4 vb = __ldg(reinterpret_cast<const float4*>(yb + i));
      if (kHasG) {
        va.x += ga; va.y += ga; va.z += ga; va.w += ga;
        vb.x += gb; vb.y += gb; vb.z += gb; vb.w += gb;
      }
      *reinterpret_cast<float4*>(o + i) =
          make_float4(gate1(va.x, vb.x), gate1(va.y, vb.y),
                      gate1(va.z, vb.z), gate1(va.w, vb.w));
    } else if (j == nv) {
      for (int i = 0; i < head; ++i) scalar(i);
      for (int i = head + 4 * nv; i < T; ++i) scalar(i);
    }
  } else {
    const int end = min(4 * j + 4, T);
    for (int i = 4 * j; i < end; ++i) scalar(i);
  }
}

}  // namespace

// g_stride: elements between g[b, 0] and g[b + 1, 0]; g's channel stride
// is 1.  The caller's current device is restored before returning.
extern "C" int sonata_gate_f32(const float* y, const float* g,
                               int64_t g_stride, float* out, int B, int T,
                               int H, int device, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess && (int64_t)B * T * H > 0) {
    const int slots = (T + 3) / 4;
    const int tx = std::min(256, (slots + 31) / 32 * 32);
    const int ty = std::max(1, std::min(256 / tx, H));
    const dim3 block(tx, ty);
    const dim3 grid((slots + tx - 1) / tx, (H + ty - 1) / ty, B);
    if (g != nullptr)
      gate_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          y, g, g_stride, out, T, H);
    else
      gate_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          y, g, 0, out, T, H);
    err = cudaGetLastError();
  }
  cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* sonata_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
