// Raster-block pre-reduction of a softmax, the front end of the sorted
// group term: per pixel p = softmax(x * inv_temp), and for each block of
// R = 4 consecutive pixels of one image, the block's first pixel (the
// leader) takes the per-class max over the block pixels that share its
// segment id, with the first offset that reaches it. Every value is then
// rounded to bf16.
//
// Replaces the TPU kernels of mulactseg_tpu/ops/segment_pallas.py:
//   K6  prereduce_softmax_nchw / _prereduce_nchw_kernel (pallas_call at
//       :665), reached from mulactseg_tpu/ops/segment.py:670-686 when
//       num_segments + 1 > 9216
//   K8  prereduce_softmax_blocks / _prereduce_kernel (pallas_call at
//       :351), reached from ops/segment.py:454-475 (the row-major
//       segment_softmax_max under MULACTSEG_SSM_PREREDUCE=1)
// K6 reads (B, C, HW) logits (pixel stride 1, class stride HW, image
// stride C*HW) with blocks counted from each image's first pixel; K8
// reads (P, C) pre-scaled rows (pixel stride C, class stride 1) as one
// image with inv_temp 1, blocks counted from row 0. An image's last block
// is short when HW % 4 != 0.
//
// Semantics (segment_pallas.py:389-430 and :318-336): u = x * inv_temp,
// e = exp(u - max), p = e / sum (a true division, as the TPU kernel). In
// a block, pixels whose sid equals the leader's contribute p, the others
// -1; the leader's row holds the float32 max of these and choice[c] is
// the first offset that reaches it. Other rows hold their own p. Each
// value is rounded to bf16 (round to nearest even) and stored as float32,
// exactly, in (C, P) planes, so K5 (csrc/segment_max.cu) reads them
// through a .t() view. choice is written as (C, B * ceil(HW/4)) planes.
// sid2 retires merged rows: the leader keeps its sid, other rows whose sid
// equals the leader's get S, the rest keep theirs (ops/segment.py:682-686).
//
// What bounds it on an H100: bytes. At the stage-1 shapes (B 4, C 20,
// 768^2) it reads 189 MB of logits and 9.4 MB of ids and writes 189 MB of
// planes, 47 MB of choices and 9.4 MB of sid2: ~0.44 GB, ~0.13 ms at
// 3.35 TB/s. The C exps and divides a pixel are far below the float32
// rate.
//
// Design: grid (pixel blocks, B), one thread per pixel; a block of
// THREADS pixels starts at a multiple of 4 of its image, so each group of
// 4 lanes is one raster block. The leader's sid reaches its group by one
// shuffle, each class's 4 values by three, so the merge needs no shared
// memory. With NCHW logits the loads and the plane stores of a warp are
// 32 consecutive floats; the leaders' choice stores for one class are 8
// consecutive ints. The TPU kernel's lane rolls, lane padding to 128 and
// selector matmul are not needed.

#include <cuda_runtime.h>
#include <math.h>

#define MAXC 32
#define THREADS 256
#define BLOCK 4

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  unsigned u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (finite v)
  return __uint_as_float(u & 0xffff0000u);
}

__global__ void __launch_bounds__(THREADS) prereduce_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    float* __restrict__ out, int* __restrict__ choice,
    int* __restrict__ sid2, int C, int HW, long long ps, long long cs,
    long long bs, int S, float inv_temp) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  const bool in = hw < HW;
  const long long P = (long long)gridDim.y * HW;
  const long long p = (long long)b * HW + hw;
  const int s = in ? sid[p] : 0;
  const int lead = __shfl_sync(full, s, lane & ~(BLOCK - 1));
  const bool leader = (hw & (BLOCK - 1)) == 0;
  const bool match = in && s == lead;

  float e[MAXC];
  float z = 0.f;
  if (in) {
    const float* xp = x + b * bs + hw * ps;
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        e[c] = xp[c * cs] * inv_temp;
        m = fmaxf(m, e[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        e[c] = expf(e[c] - m);
        z += e[c];
      }
    }
  }
  const int nb = (HW + BLOCK - 1) / BLOCK;
  const long long NB = (long long)gridDim.y * nb;
  const long long blk = (long long)b * nb + hw / BLOCK;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      const float pc = in ? e[c] / z : 0.f;
      const float v = match ? pc : -1.f;
      const float v1 = __shfl_down_sync(full, v, 1);
      const float v2 = __shfl_down_sync(full, v, 2);
      const float v3 = __shfl_down_sync(full, v, 3);
      if (!in) continue;
      float keep = pc;
      if (leader) {
        // lanes past the image hold v = -1, which never reaches the max
        // (the leader's own p >= 0 is in it)
        const float mx = fmaxf(fmaxf(v, v1), fmaxf(v2, v3));
        const int ch = v == mx ? 0 : v1 == mx ? 1 : v2 == mx ? 2 : 3;
        choice[(long long)c * NB + blk] = ch;
        keep = mx;
      }
      out[(long long)c * P + p] = round_bf16(keep);
    }
  }
  if (in) sid2[p] = (leader || s != lead) ? s : S;
}

}  // namespace

extern "C" int prereduce_fwd(const float* x, const int* sid, float* out,
                             int* choice, int* sid2, int B, int C, int HW,
                             long long ps, long long cs, long long bs, int S,
                             float inv_temp, cudaStream_t stream) {
  dim3 grid((HW + THREADS - 1) / THREADS, B);
  prereduce_kernel<<<grid, THREADS, 0, stream>>>(x, sid, out, choice, sid2,
                                                 C, HW, ps, cs, bs, S,
                                                 inv_temp);
  return (int)cudaGetLastError();
}
