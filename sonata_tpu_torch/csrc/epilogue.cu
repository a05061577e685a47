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
// a sample), and at batch 1 the latency of the loads.  The peak is a
// reduction over the whole row that must finish before any sample is
// written.  So one thread-block cluster of C <= 8 blocks (the portable
// cluster size) owns a row, grid (C, B), and each block a contiguous slice
// of lv float4 vectors:
//
// - Fade table: while each thread's first 16-byte loads (up to kVecs) are
//   in flight, the block computes the row's 2n fade gains (sinf, cosf, one
//   a thread) into shared memory.  A sample's gain is then 0 outside
//   [lo, hi), 1 between the fades (one test finds a whole vector in either
//   case), or a product of table entries: the reference's own arithmetic,
//   bit for bit, with no transcendental in the vector loops.
// - Pass 1: the gain, then max|.| reduced over the block by warp max
//   instructions on the float bits (|x| >= 0, so the unsigned order of the
//   bits is the float order) into the block's partial peak.
// - Cluster reduction, through distributed shared memory: each block
//   arrives on the cluster barrier as it starts and waits on that phase
//   only after pass 1, so the wait costs nothing, and it then knows every
//   peer has started and its shared memory exists.  It writes its partial
//   peak into every peer's slot for it (map_shared_rank), then
//   cluster.sync() (release/acquire) makes all C partials visible in every
//   block, each takes their max (order-free, so the peak is exact), and
//   rank 0 writes peak[row].  No block touches another's shared memory
//   after that sync, so any block may exit.  Every block reaches both
//   barrier phases, even one whose slice is empty: none returns early.
// - Pass 2: the slice's first kVecs * kThreads vectors are still in
//   registers (all of a slice at rows up to 65,536 samples), so they are
//   not read again; longer slices re-read the rest from L2, where the row
//   landed microseconds earlier.  int16 is written four samples (8 bytes)
//   at a time.
//
// Alignment: row r starts at r*S floats, so for S % 4 != 0 a row start is
// not 16-byte aligned.  A row whose wav and q start at the same position
// within a vector (always, unless wav sits at an odd storage offset) has a
// scalar head up to the first 16-byte boundary and a scalar tail, done by
// rank 0; the vectors between are sliced over the cluster.  A row whose
// starts differ is sliced in samples (4*lv a block) with scalar accesses.
// The gain is a function of the sample index only, so a slice boundary
// inside a fade region or at lo/hi changes nothing.
//
// Built without --use_fast_math: sinf/cosf and the division are the
// IEEE-accurate versions the +-1 LSB tolerance assumes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kVecs = 4;                  // float4 loads in flight a thread
constexpr int kChunk = kThreads * kVecs;  // vectors a block takes at once
constexpr int kMaxFade = 1024;  // longest fade the table holds (the wrapper checks)
constexpr int kMaxCluster = 8;  // the portable cluster size

// the two halves of a cluster barrier phase (cluster.sync() is both)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int16_t quantize(float tapered, float scale) {
  return (int16_t)fminf(fmaxf(tapered * scale, -32768.0f), 32767.0f);
}

__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const float* __restrict__ wav, const int* __restrict__ lo_,
                    const int* __restrict__ hi_, int16_t* __restrict__ q,
                    float* __restrict__ peak, int S, int fade, int lv) {
  __shared__ float fades[2 * kMaxFade];  // [0, n): fade-in, [n, 2n): fade-out
  __shared__ unsigned warp_peaks[kThreads / 32];  // float bits
  __shared__ unsigned partial_peaks[kMaxCluster];  // one a block of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int row = blockIdx.y;
  const float* w = wav + (int64_t)row * S;
  int16_t* qr = q + (int64_t)row * S;
  const int lo = lo_[row], hi = hi_[row];
  const int n = min(fade, hi - lo);
  const int flat_lo = lo + max(n, 0), flat_hi = hi - max(n, 0);

  // the row's vectors start where wav and q both reach a vector boundary
  const int wphase = (int)(((uintptr_t)w >> 2) & 3);
  const bool vec = wphase == (int)(((uintptr_t)qr >> 1) & 3);
  const int head = vec ? min((4 - wphase) & 3, S) : 0;
  const int nv = vec ? (S - head) >> 2 : 0;
  const int v0 = min(rank * lv, nv), v1 = min(v0 + lv, nv);
  const float4* w4 = reinterpret_cast<const float4*>(w + head);
  short4* q4 = reinterpret_cast<short4*>(qr + head);

  // the slice's first chunk: in flight while the fade table is filled, and
  // kept in registers for pass 2
  float4 keep[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = v0 + k * kThreads + t;
    keep[k] = i < v1 ? __ldg(w4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float nf = (float)max(n, 1);
  const float half_pi = 1.57079632679489661923f;
  for (int j = t; j < 2 * n; j += kThreads)
    fades[j] = j < n ? sinf((float)j / nf * half_pi)
                     : cosf((float)(j - n) / nf * half_pi);
  __syncthreads();

  // in_gain * out_gain * mask of the reference: +-0 outside [lo, hi) (a
  // zero either way), 1 * 1 * 1 between the fades
  auto gain = [&](int idx) -> float {
    if (idx < lo || idx >= hi) return 0.0f;
    if (idx >= flat_lo && idx < flat_hi) return 1.0f;
    const float in_gain = idx - lo < n ? fades[idx - lo] : 1.0f;
    const float out_gain = idx >= hi - n ? fades[n + idx - (hi - n)] : 1.0f;
    return in_gain * out_gain;
  };
  auto gain4 = [&](int s) -> float4 {
    if (s >= flat_lo && s + 3 < flat_hi) return make_float4(1.f, 1.f, 1.f, 1.f);
    if (s + 3 < lo || s >= hi) return make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(gain(s), gain(s + 1), gain(s + 2), gain(s + 3));
  };
  // chunk ``base`` of the slice, from registers for the first one
  auto chunk = [&](int base, float4 (&v)[kVecs]) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = base + k * kThreads + t;
      v[k] = base == v0 ? keep[k]
             : i < v1   ? __ldg(w4 + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // the samples this thread takes one at a time: in vector mode rank 0's
  // head and tail, otherwise the block's slice of 4*lv samples
  auto for_scalars = [&](auto&& f) {
    if (vec) {
      if (rank == 0) {
        if (t < head) f(t);
        if (head + 4 * nv + t < S) f(head + 4 * nv + t);
      }
    } else {
      const int s1 = min((rank + 1) * 4 * lv, S);
      for (int s = rank * 4 * lv + t; s < s1; s += kThreads) f(s);
    }
  };

  // -- pass 1: the block's partial peak ------------------------------------
  float m = 0.0f;
  for (int base = v0; base < v1; base += kChunk) {
    float4 v[kVecs];
    chunk(base, v);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = base + k * kThreads + t;
      if (i < v1) {
        const float4 g = gain4(head + 4 * i);
        m = fmaxf(m, fabsf(v[k].x * g.x));
        m = fmaxf(m, fabsf(v[k].y * g.y));
        m = fmaxf(m, fabsf(v[k].z * g.z));
        m = fmaxf(m, fabsf(v[k].w * g.w));
      }
    }
  }
  for_scalars([&](int s) { m = fmaxf(m, fabsf(w[s] * gain(s))); });
  unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if ((t & 31) == 0) warp_peaks[t >> 5] = bits;
  __syncthreads();
  bits = __reduce_max_sync(
      0xffffffffu, (t & 31) < kThreads / 32 ? warp_peaks[t & 31] : 0u);

  // -- the cluster's row peak, through distributed shared memory -----------
  const int blocks = (int)cluster.num_blocks();
  cluster_wait();  // every block of the cluster has started
  if (t < blocks) *cluster.map_shared_rank(&partial_peaks[rank], t) = bits;
  cluster.sync();  // every partial has landed; no remote access after this
  unsigned row_bits = 0;
  for (int r = 0; r < blocks; ++r) row_bits = max(row_bits, partial_peaks[r]);
  const float row_peak = __uint_as_float(row_bits);
  if (rank == 0 && t == 0) peak[row] = row_peak;
  const float scale = 32767.0f / fmaxf(row_peak, 0.01f);

  // -- pass 2: quantize the slice ------------------------------------------
  for (int base = v0; base < v1; base += kChunk) {
    float4 v[kVecs];
    chunk(base, v);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = base + k * kThreads + t;
      if (i < v1) {
        const float4 g = gain4(head + 4 * i);
        q4[i] = make_short4(quantize(v[k].x * g.x, scale),
                            quantize(v[k].y * g.y, scale),
                            quantize(v[k].z * g.z, scale),
                            quantize(v[k].w * g.w, scale));
      }
    }
  }
  for_scalars([&](int s) { qr[s] = quantize(w[s] * gain(s), scale); });
}

}  // namespace

// cluster (C <= 8 blocks a row) and lv (float4 vectors a block) come from
// decode_opts.epilogue_plan; fade <= kMaxFade.  A refused cluster launch
// never runs: its error is returned.  The caller's current device is
// restored before returning.
extern "C" int sonata_epilogue_f32(const float* wav, const int* lo,
                                   const int* hi, int16_t* q, float* peak,
                                   int B, int S, int fade, int cluster,
                                   int lv, int device, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess && B > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, epilogue_kernel, wav, lo, hi, q, peak, S,
                             fade, lv);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  cudaSetDevice(prev);
  return (int)err;
}
