// Group (MIL) term of the stage-1 lossdecomp loss: per-(segment, class)
// max of softmax(x / T) with its first argmax pixel (K3), and the sparse
// backward through it (K4), over NCHW logits viewed as (B, C, HW).
//
// Replaces the TPU kernels of mulactseg_tpu/ops/segment_pallas.py:
//   K3  scatter_softmax_max_nchw / _scatter_max_nchw_kernel (pallas_call
//       at :560), reached from mulactseg_tpu/ops/segment.py:653-669
//   K4  scatter_softmax_bwd_nchw / _ssm_bwd_nchw_kernel (pallas_call at
//       :641), with the coefficient scatter of ops/segment.py:781-820
//   K7  segment_softmax_max_pallas / _softmax_kernel (pallas_call at :230
//       in _run_segment_kernel), with the bf16 cast, lane pad and sorted
//       row gather of ops/segment.py:384-425 around it: the row-major
//       segment_softmax_max over pre-scaled (P, C) rows
//
// Semantics: sid[p] in [0, S) is pixel p's global segment (b*nseg +
// local); anything else (the marker S) is invalid. K3 returns, for each
// (s, c), the max of p_c over the segment's pixels and the FIRST pixel in
// raster order (global index b*HW + hw) that attains it; an absent segment
// gives (0.0, P); a present segment whose probabilities all underflowed to
// exactly 0.0 still records its pixel. K4 takes the cotangent g (S, C) of
// the max, puts g*max at each argmax pixel (dlm) and writes
// dl = (dlm - (sum_c dlm) * p) / T.
//
// What bounds them on an H100: bytes. At the recipe shapes (B 4, C 20,
// 768^2, S 8192) K3 reads the 9.4 MB of segment ids and the logits of the
// valid (multi-hot) pixels only: at most the 189 MB of float32 logits
// (~199 MB, ~59 us at 3.35 TB/s), about 40% of them on the recipe's data,
// plus atomic traffic to an (S, C) table that lives in L2. A warp none of
// whose pixels is valid stops after reading its ids. K4's function needs
// the 189 MB dl write,
// the sparse (S, C) inputs and the logits only at pixels that carry a
// coefficient (~60 us); this first version also zero-fills, writes and
// reads a dense (B, C, HW) dlm buffer (+378 MB).
//
// Design. Both per-pixel kernels run on a grid (pixel blocks, B), so a
// pixel's image and offset need no integer division, take each exp once
// and multiply by one reciprocal of the normaliser instead of C divides.
// K3: one thread per pixel computes its softmax in registers and
// packs each class's value as the 64-bit key (float_bits(p) << 32) |
// ~pixel. p >= 0, so its bits order like its value, and ~pixel makes ties
// go to the lowest raster index; atomicMax of the key into a zeroed (S, C)
// table is then exactly "max, first argmax", and a 0.0 probability still
// beats the zero init. Raster runs of one segment are merged inside each
// warp first (shuffle reduction over lanes of equal sid), so only the run
// leader issues the atomic. The TPU kernel's doubling-scan run merge, SMEM
// walk, -1 init and S <= 9216 VMEM guard are not needed. K4: a scatter
// kernel over the S*C entries fills dlm (each (pixel, class) receives at
// most one entry, so plain stores suffice); the per-pixel kernel reads a
// pixel's C dlm values and only where one is non-zero reads its logits to
// recompute the softmax.
//
// K7 (ssm_rows_fwd) is K3's scheme over (P, C) rows that the caller has
// already divided by T: one thread per row reads its C contiguous floats
// (a warp's loads for one class are 80 bytes apart, but the row's other
// classes then come from L1, so each byte leaves device memory once),
// rounds each to bf16 as the TPU path's gather stream does, and divides
// by the normaliser as the TPU kernel does. At (2,359,296, 20) rows it
// must read 9.4 MB of ids and the 189 MB of rows only where valid.

#include <cuda_runtime.h>
#include <math.h>

#define MAXC 32
#define THREADS 256

typedef unsigned long long u64;

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  unsigned u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (finite v)
  return __uint_as_float(u & 0xffff0000u);
}

// Max of key over the lanes of this warp that share the segment s: after
// the step with offset d, a lane holds the max over [lane, lane + 2d) of
// its contiguous run, so each run leader ends with its whole run.
__device__ __forceinline__ u64 run_max(u64 key, int s, int lane) {
  const unsigned full = 0xffffffffu;
  for (int d = 1; d < 32; d <<= 1) {
    const u64 other = __shfl_down_sync(full, key, d);
    const int os = __shfl_down_sync(full, s, d);
    if (lane + d < 32 && os == s && other > key) key = other;
  }
  return key;
}

__global__ void __launch_bounds__(THREADS) ssm_scatter_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    u64* __restrict__ keys, int C, int HW, int S, float inv_temp) {
  const unsigned full = 0xffffffffu;
  const int b = blockIdx.y;
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)b * HW + hw;
  int s = hw < HW ? sid[p] : S;
  bool valid = s >= 0 && s < S;
  if (!valid) s = -1;
  if (__ballot_sync(full, valid) == 0) return;  // warp-uniform exit

  const float* xp = x + (long long)b * C * HW + hw;
  float e[MAXC];
  float rz = 0.f;
  if (valid) {
    float m = -INFINITY, z = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        e[c] = xp[(long long)c * HW] * inv_temp;
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
    rz = 1.f / z;
  }
  int prev = __shfl_up_sync(full, s, 1);
  bool leader = valid && (lane == 0 || prev != s);
  u64 lo = (u64)(~(unsigned)p);
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      u64 key = 0;
      if (valid) key = ((u64)__float_as_uint(e[c] * rz) << 32) | lo;
      key = run_max(key, s, lane);
      if (leader) atomicMax(&keys[(long long)s * C + c], key);
    }
  }
}

// K7: one thread per pre-scaled (P, C) row. Each value is rounded to bf16
// on load (segment.py:394 feeds the TPU kernel bf16 rows), the softmax is
// taken in float32 with a true division (segment_pallas.py:172-176), and
// the keys go into the table as in K3.
__global__ void __launch_bounds__(THREADS) ssm_rows_scatter_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    u64* __restrict__ keys, int P, int C, int S) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  int s = p < P ? sid[p] : S;
  const bool valid = s >= 0 && s < S;
  if (!valid) s = -1;
  if (__ballot_sync(full, valid) == 0) return;  // warp-uniform exit

  float e[MAXC];
  float z = 0.f;
  if (valid) {
    const float* xp = x + p * C;
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        e[c] = round_bf16(xp[c]);
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
  const int prev = __shfl_up_sync(full, s, 1);
  const bool leader = valid && (lane == 0 || prev != s);
  const u64 lo = (u64)(~(unsigned)p);
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      u64 key = 0;
      if (valid) key = ((u64)__float_as_uint(e[c] / z) << 32) | lo;
      key = run_max(key, s, lane);
      if (leader) atomicMax(&keys[(long long)s * C + c], key);
    }
  }
}

__global__ void ssm_decode_kernel(const u64* __restrict__ keys,
                                  float* __restrict__ vals,
                                  int* __restrict__ pix, long long n, int P) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 k = keys[i];
  if (k == 0) {
    vals[i] = 0.f;
    pix[i] = P;
  } else {
    vals[i] = __uint_as_float((unsigned)(k >> 32));
    pix[i] = (int)(~(unsigned)(k & 0xffffffffull));
  }
}

__global__ void ssm_bwd_scatter_kernel(const float* __restrict__ vals,
                                       const int* __restrict__ pix,
                                       const float* __restrict__ g,
                                       float* __restrict__ dlm, int C,
                                       long long HW, long long n, int P) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int q = pix[i];
  float gi = g[i];
  if (q < 0 || q >= P || gi == 0.f) return;
  long long c = i % C;
  long long b = q / HW, hw = q - b * HW;
  dlm[(b * C + c) * HW + hw] = gi * vals[i];
}

__global__ void __launch_bounds__(THREADS) ssm_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dlm,
    float* __restrict__ dl, int C, int HW, float inv_temp) {
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  if (hw >= HW) return;
  const long long base = (long long)blockIdx.y * C * HW + hw;
  float d[MAXC];
  float w = 0.f;
  bool any = false;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      d[c] = dlm[base + (long long)c * HW];
      w += d[c];
      any = any || d[c] != 0.f;
    }
  }
  if (!any) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) dl[base + (long long)c * HW] = 0.f;
    }
    return;
  }
  float e[MAXC];
  float m = -INFINITY, z = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      e[c] = x[base + (long long)c * HW] * inv_temp;
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
  const float rz = 1.f / z;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) dl[base + (long long)c * HW] = (d[c] - w * (e[c] * rz)) * inv_temp;
  }
}

}  // namespace

extern "C" int ssm_fwd(const float* x, const int* sid, u64* keys, float* vals,
                       int* pix, int B, int C, int HW, int S, float inv_temp,
                       cudaStream_t stream) {
  dim3 grid((HW + THREADS - 1) / THREADS, B);
  ssm_scatter_kernel<<<grid, THREADS, 0, stream>>>(x, sid, keys, C, HW, S,
                                                   inv_temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long n = (long long)S * C;
  ssm_decode_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(keys, vals, pix, n, B * HW);
  return (int)cudaGetLastError();
}

extern "C" int ssm_rows_fwd(const float* x, const int* sid, u64* keys,
                            float* vals, int* pix, int P, int C, int S,
                            cudaStream_t stream) {
  if (P > 0) {
    ssm_rows_scatter_kernel<<<(unsigned)(((long long)P + THREADS - 1) /
                                         THREADS),
                              THREADS, 0, stream>>>(x, sid, keys, P, C, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long n = (long long)S * C;
  ssm_decode_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(keys, vals, pix, n, P);
  return (int)cudaGetLastError();
}

extern "C" int ssm_bwd(const float* x, const float* vals, const int* pix,
                       const float* g, float* dlm, float* dl, int B, int C,
                       int HW, int S, float inv_temp, cudaStream_t stream) {
  long long n = (long long)S * C;
  ssm_bwd_scatter_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                           stream>>>(vals, pix, g, dlm, C, HW, n, B * HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((HW + THREADS - 1) / THREADS, B);
  ssm_bwd_kernel<<<grid, THREADS, 0, stream>>>(x, dlm, dl, C, HW, inv_temp);
  return (int)cudaGetLastError();
}
