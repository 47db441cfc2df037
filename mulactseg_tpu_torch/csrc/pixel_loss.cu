// Per-pixel partial-label CE/MC terms of the stage-1 lossdecomp loss,
// forward (K1) and backward (K2), over NCHW logits viewed as (B, C, HW),
// and the same over (N, C) rows (K9, K10).
//
// Replaces the TPU kernels of mulactseg_tpu/ops/pixel_loss_pallas.py:
//   K1  _fwd_pallas_cs / _fwd_kernel_cs  (pallas_call at :257)
//   K2  _bwd_pallas_cs / _bwd_kernel_cs  (pallas_call at :292)
//   K9  _fwd_pallas / _fwd_kernel        (pallas_call at :94), the same
//       forward over (N, C) rows: pixel_ce_rows_fwd
//   K10 _bwd_pallas / _bwd_kernel        (pallas_call at :130), its
//       backward: pixel_ce_rows_bwd
// One template serves both layouts: a pixel's C logits lie HW apart in
// (B, C, HW) logits and next to each other in (N, C) rows, where a warp's
// loads for one class are C floats apart and the rest of each row then
// comes from L1.
//
// Semantics (pixel_loss_pallas.py:214-250): per pixel, p = softmax(x / T)
// over the C classes, t_c = bit c of the candidate bitmask, pos = sum_c p_c
// t_c, n = popcount of the low C bits, nll = -log(pos + 1e-8). K1 returns
// (sum nll | n == 1, count n == 1, sum nll | n > 1, count n > 1); K2 writes
// dl = g_bucket / (T (pos + 1e-8)) * (pos p - p t), g_bucket = g[0] for
// n == 1, g[1] for n > 1, 0 otherwise, recomputed from the inputs.
//
// What bounds it on an H100: bytes. At the recipe shapes (B 4, C 20,
// 768^2) the float32 logits are 189 MB. K1 must read the 9.4 MB of
// bitmasks and the logits of the pixels that have a candidate (at most
// ~198 MB, ~59 us at 3.35 TB/s; about half of that on the recipe's 50%
// selection); K2 reads the same and writes the 189 MB of dl (at most
// ~387 MB, ~116 us). A pixel without candidates skips its logits in both.
// The arithmetic (C exps per pixel) is far below the float32 rate, but
// only if each pixel pays for its C exps once.
//
// Design: grid (pixel blocks, B), one thread per pixel (no loop, so no
// chain of dependent loads in a thread), no integer division. For each
// class the threads of a warp read consecutive pixels, so every load and
// store is coalesced, and each logit is read once into registers (C <= 31
// is unrolled over MAXC). Each exp is taken once and kept; one reciprocal
// of the normaliser replaces C divides. K1 reduces its four sums per
// block in shared memory into a partials buffer (4 floats per 256
// pixels), and a second one-block pass adds the partials in a fixed order
// in double: no float atomics, so the loss is bitwise reproducible. K2
// reads the two cotangent scalars from a device buffer (no host sync).

#include <cuda_runtime.h>
#include <math.h>

#define MAXC 32
#define THREADS 256

namespace {

constexpr float kEps = 1e-8f;

// Loads one pixel's C logits (class stride cs) and leaves
// e[c] = exp(x_c/T - m), the reciprocal of their sum and pos = sum over
// candidates of p_c.
__device__ __forceinline__ void pixel_softmax(const float* __restrict__ xp,
                                              int C, int cs, float inv_temp,
                                              unsigned bits, float (&e)[MAXC],
                                              float& rz, float& pos) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      e[c] = xp[(long long)c * cs] * inv_temp;
      m = fmaxf(m, e[c]);
    }
  }
  float z = 0.f, s = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      e[c] = expf(e[c] - m);
      z += e[c];
      if ((bits >> c) & 1u) s += e[c];
    }
  }
  rz = 1.f / z;
  pos = s * rz;
}

// Offset of pixel hw of image b's first logit, and the class stride: (N, C)
// rows (kRows) are one image of N pixels.
template <bool kRows>
__device__ __forceinline__ long long pixel_base(int b, int hw, int C,
                                                int HW) {
  return kRows ? (long long)hw * C : (long long)b * C * HW + hw;
}

template <bool kRows>
__global__ void __launch_bounds__(THREADS) pixel_ce_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ bits,
    float* __restrict__ partials, int C, int HW, float inv_temp) {
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  const int cs = kRows ? 1 : HW;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (hw < HW) {
    const long long base = pixel_base<kRows>(blockIdx.y, hw, C, HW);
    const unsigned bt = (unsigned)bits[(long long)blockIdx.y * HW + hw];
    const int n = __popc(bt & ((1u << C) - 1u));
    if (n > 0) {  // a pixel without candidates needs no logits
      float e[MAXC], rz, pos;
      pixel_softmax(x + base, C, cs, inv_temp, bt, e, rz, pos);
      const float nll = -logf(pos + kEps);
      if (n == 1) {  // constant indices keep acc in registers
        acc[0] = nll;
        acc[1] = 1.f;
      } else {
        acc[2] = nll;
        acc[3] = 1.f;
      }
    }
  }
  __shared__ float red[4][THREADS];
#pragma unroll
  for (int i = 0; i < 4; ++i) red[i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[i][threadIdx.x] += red[i][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 4)
    partials[(blockIdx.y * gridDim.x + blockIdx.x) * 4 + threadIdx.x] =
        red[threadIdx.x][0];
}

// One block: thread t adds partials t, t + THREADS, ... of each sum in
// double, then a fixed tree adds the threads' sums.
__global__ void __launch_bounds__(THREADS) pixel_ce_finish_kernel(
    const float* __restrict__ partials, float* __restrict__ out,
    int nblocks) {
  __shared__ double red[4][THREADS];
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int k = threadIdx.x; k < nblocks; k += THREADS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += partials[k * 4 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[i][threadIdx.x] += red[i][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) out[threadIdx.x] = (float)red[threadIdx.x][0];
}

template <bool kRows>
__global__ void __launch_bounds__(THREADS) pixel_ce_bwd_kernel(
    const float* __restrict__ x, const int* __restrict__ bits,
    const float* __restrict__ g, float* __restrict__ dl, int C, int HW,
    float temp, float inv_temp) {
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  if (hw >= HW) return;
  const int cs = kRows ? 1 : HW;
  const long long base = pixel_base<kRows>(blockIdx.y, hw, C, HW);
  const unsigned bt = (unsigned)bits[(long long)blockIdx.y * HW + hw];
  const int n = __popc(bt & ((1u << C) - 1u));
  if (n == 0) {  // no bucket, no gradient
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) dl[base + (long long)c * cs] = 0.f;
    }
    return;
  }
  float e[MAXC], rz, pos;
  pixel_softmax(x + base, C, cs, inv_temp, bt, e, rz, pos);
  const float scale = n == 1 ? g[0] : g[1];
  const float coef = scale / (temp * (pos + kEps));
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      float pc = e[c] * rz;
      float tc = ((bt >> c) & 1u) ? 1.f : 0.f;
      dl[base + (long long)c * cs] = coef * (pos * pc - pc * tc);
    }
  }
}

template <bool kRows>
int fwd(const float* x, const int* bits, float* partials, float* out, int B,
        int C, int HW, float temp, cudaStream_t stream) {
  const int blocks_x = (HW + THREADS - 1) / THREADS;
  dim3 grid(blocks_x, B);
  pixel_ce_fwd_kernel<kRows><<<grid, THREADS, 0, stream>>>(
      x, bits, partials, C, HW, 1.f / temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pixel_ce_finish_kernel<<<1, THREADS, 0, stream>>>(partials, out,
                                                    blocks_x * B);
  return (int)cudaGetLastError();
}

template <bool kRows>
int bwd(const float* x, const int* bits, const float* g, float* dl, int B,
        int C, int HW, float temp, cudaStream_t stream) {
  dim3 grid((HW + THREADS - 1) / THREADS, B);
  pixel_ce_bwd_kernel<kRows><<<grid, THREADS, 0, stream>>>(
      x, bits, g, dl, C, HW, temp, 1.f / temp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pixel_ce_fwd(const float* x, const int* bits, float* partials,
                            float* out, int B, int C, int HW, float temp,
                            cudaStream_t stream) {
  return fwd<false>(x, bits, partials, out, B, C, HW, temp, stream);
}

extern "C" int pixel_ce_bwd(const float* x, const int* bits, const float* g,
                            float* dl, int B, int C, int HW, float temp,
                            cudaStream_t stream) {
  return bwd<false>(x, bits, g, dl, B, C, HW, temp, stream);
}

// K9 and K10: (N, C) rows.
extern "C" int pixel_ce_rows_fwd(const float* x, const int* bits,
                                 float* partials, float* out, int N, int C,
                                 float temp, cudaStream_t stream) {
  return fwd<true>(x, bits, partials, out, 1, C, N, temp, stream);
}

extern "C" int pixel_ce_rows_bwd(const float* x, const int* bits,
                                 const float* g, float* dl, int N, int C,
                                 float temp, cudaStream_t stream) {
  return bwd<true>(x, bits, g, dl, 1, C, N, temp, stream);
}
