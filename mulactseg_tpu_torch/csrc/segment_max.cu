// Segment max with first argmax over arbitrary float32 values (K5): for
// each (segment, class), the max of values[p, c] over the pixels p with
// sid[p] == segment, and the smallest pixel index that attains it.
//
// Replaces the TPU kernel of mulactseg_tpu/ops/segment_pallas.py:
//   K5  segment_max_pallas / _max_kernel_db (pallas_call at :295), with the
//       global argsort, the 128-lane padded gather and the order remap of
//       mulactseg_tpu/ops/segment.py:274-299 (_seg_max_argmax_impl) that
//       surround it; reached from segment_max_grad (ops/segment.py:303),
//       which the pseudo-labeller calls for each prototype's source pixel
//       (plbl/cosine_prop.py:129).
//
// Semantics: values (P, C) float32 addressed as values[p * ps + c * cs],
// so one kernel reads a contiguous (P, C) array (ps = C, cs = 1) and the
// (C, P) class planes of an NCHW tensor (ps = 1, cs = P); sid (P,) int32,
// anything outside [0, S) is invalid. Outputs (S, C) float32 max and
// (S, C) int32 argmax pixel; an absent segment gives (0.0, P). Ties go to
// the smallest pixel index. A present segment whose values are all 0.0
// still records its first pixel. -0.0 counts as +0.0. NaN is outside the
// contract.
//
// What bounds it on an H100: bytes. At the pseudo-labeller's shapes
// (P = 1024 * 2048, C = 20, S = 2048, ~30% of pixels valid) it must read
// the 8.4 MB of segment ids and the ~50 MB of values of the valid pixels,
// and write 0.3 MB: ~59 MB, ~18 us at 3.35 TB/s. A warp none of whose
// pixels is valid stops after reading its ids.
//
// Design (K3's scheme, csrc/segment.cu, without the softmax). The TPU
// kernel walks segment-sorted rows with double-buffered DMAs; here no sort
// is needed. One thread per pixel loops over the C classes; with planes, a
// warp's loads for one class are 32 consecutive floats and coalesce. Each
// value becomes an order-preserving 32-bit key (sign bit flipped for
// positives, all bits flipped for negatives, after -0.0 -> +0.0), and the
// 64-bit word (key << 32) | ~pixel goes into a zeroed (S, C) table by one
// atomicMax: the largest value wins, then the smallest pixel, exactly and
// in any order of arrival. Every non-NaN float gives a key above 0, so
// key 0 marks "absent". Lanes of a warp that share a segment are merged by
// a shuffle reduction first, so one atomic stands for each raster run
// (superpixels at 1024x2048 with nseg 2048 are runs of ~45 pixels). A
// second small kernel decodes the words.

#include <cuda_runtime.h>

#define THREADS 256

typedef unsigned long long u64;

namespace {

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 -> +0.0
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k >> 31) ? (k ^ 0x80000000u) : ~k);
}

__global__ void __launch_bounds__(THREADS) seg_max_scatter_kernel(
    const float* __restrict__ values, const int* __restrict__ sid,
    u64* __restrict__ keys, int P, int C, long long ps, long long cs,
    int S) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  int s = p < P ? sid[p] : S;
  const bool valid = s >= 0 && s < S;
  if (!valid) s = -1;
  if (__ballot_sync(full, valid) == 0) return;  // warp-uniform exit

  const int prev = __shfl_up_sync(full, s, 1);
  const bool leader = valid && (lane == 0 || prev != s);
  const u64 lo = (u64)(~(unsigned)p);
  const float* vp = values + p * ps;
  for (int c = 0; c < C; ++c) {
    u64 key = 0;
    if (valid) key = ((u64)order_key(vp[(long long)c * cs]) << 32) | lo;
    // max over the lanes of this warp that share the segment: after the
    // step with offset d, a lane holds the max over [lane, lane + 2d) of
    // its contiguous run, so each run leader ends with its whole run
    for (int d = 1; d < 32; d <<= 1) {
      const u64 other = __shfl_down_sync(full, key, d);
      const int os = __shfl_down_sync(full, s, d);
      if (lane + d < 32 && os == s && other > key) key = other;
    }
    if (leader) atomicMax(&keys[(long long)s * C + c], key);
  }
}

__global__ void seg_max_decode_kernel(const u64* __restrict__ keys,
                                      float* __restrict__ vals,
                                      int* __restrict__ pix, long long n,
                                      int P) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 k = keys[i];
  if (k == 0) {
    vals[i] = 0.f;
    pix[i] = P;
  } else {
    vals[i] = key_value((unsigned)(k >> 32));
    pix[i] = (int)(~(unsigned)(k & 0xffffffffull));
  }
}

}  // namespace

extern "C" int seg_max_fwd(const float* values, const int* sid, u64* keys,
                           float* vals, int* pix, int P, int C, long long ps,
                           long long cs, int S, cudaStream_t stream) {
  if (P > 0) {
    seg_max_scatter_kernel<<<(unsigned)(((long long)P + THREADS - 1) /
                                        THREADS),
                             THREADS, 0, stream>>>(values, sid, keys, P, C,
                                                   ps, cs, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)S * C;
  seg_max_decode_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                          0, stream>>>(keys, vals, pix, n, P);
  return (int)cudaGetLastError();
}
