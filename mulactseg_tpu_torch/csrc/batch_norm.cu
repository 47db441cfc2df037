// FastBatchNorm's training pass (models/layers.py, ops/batch_norm.py):
// batch statistics, the running-statistics update, the affine, and the
// exact gradient of all of it, over an (N, C, H, W) activation in bf16 or
// float32.
//
// Replaces no TPU kernel: the JAX package leaves its FastBatchNorm
// (mulactseg_tpu/models/layers.py:43-96) to XLA's fusion, which sums the
// bf16 activation straight into float32 accumulators. The port's plain
// version (ops/batch_norm.batch_norm_plain) runs as ~55 PyTorch kernels a
// BN, a float32 copy of the activation among them; these six kernels
// replace it on the card.
//
// The activation is NCHW or channels-last (NHWC in memory), and y, dy and
// dx share its layout. Semantics, per channel c over the n = N * H * W
// elements (times the ranks under data parallelism, whose partial sums
// the wrapper all-reduces):
//   m = sum x / n,  vr = sum x^2 / n - m^2,  v = max(vr, 0)
//   r = 1 / sqrt(v + eps),  a = w * r,  b = beta - m * a
//   running = keep * running + momentum * (m, v)
//   y = x * at + bt, with at, bt = a, b rounded to x's dtype, the product
//       and sum in float32 and rounded once to x's dtype.
// Backward, with dB = sum dy and dA = sum dy * x:
//   dbeta = dB, dw = (dA - m dB) r                 (this rank's sums)
//   dr = (dA - m dB) w, dvr = -r^3 dr / 2 where vr >= 0 (torch's clamp
//   passes the gradient there), dm = -a dB - 2 m dvr  (the global sums)
//   dx = dy * at + dm / n + (2 dvr / n) x, rounded once to x's dtype.
//
// What bounds it on an H100: bytes. A bf16 element is read once for the
// statistics, read and written once by the affine, read twice with its
// gradient and its input gradient written once: 16 bytes over the four
// full passes (32 in float32). At city_stage1's 805 M BN elements a step
// that is 12.9 GB, 3.8 ms at 3.35 TB/s. The (C,)-sized work between the
// passes is one thread a channel.
//
// Design. Every full pass keeps several independent loads in flight in
// each thread (kUE, reduce_channel's kUR) and spreads each block's range
// over all its threads whatever the plane size: a block that walked its
// planes run by run kept half its threads idle on VOC's 33^2 maps and
// ran the affine at 42% of its bound there (PERF.md).
// - bn_stats_kernel and bn_bwd_stats_kernel: NCHW, a (C, splits) grid.
//   Block (c, s) sums its share of channel c's N planes in float32
//   registers, 16-byte loads where the planes hold whole packs (H * W % 8
//   == 0 in bf16, every city_stage1 map) and single elements where they
//   do not (VOC's odd maps), then reduces the block in a fixed order and
//   writes one partial. Channels-last, a column sum of the (N H W, C)
//   matrix: each block takes 32 units of channels over a range of rows,
//   a warp a row at a time. The wrapper picks the splits from C and
//   N * H * W so that every layer puts a few blocks on each SM.
// - bn_finalize_kernel and bn_bwd_finalize_kernel: one thread a channel
//   sums the partials in split order (no float atomics, so a CUDA graph
//   replay gives the eager values) and computes the per-channel values.
// - bn_apply_kernel and bn_dx_kernel: each block owns a fixed flat range
//   of 16-byte packs; in NCHW a pack's channel comes from its first
//   element, and the rare pack that crosses a plane takes each element's
//   own; channels-last, a pack's elements are consecutive channels.
// Every launch goes on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256

namespace {

// 16 bytes of T as floats, and single elements.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float v) { *p = v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static unsigned bits(float v) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 u;
    u.x = bits(f[0]) | (bits(f[1]) << 16);
    u.y = bits(f[2]) | (bits(f[3]) << 16);
    u.z = bits(f[4]) | (bits(f[5]) << 16);
    u.w = bits(f[6]) | (bits(f[7]) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  }
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// Units (16-byte packs of x's dtype, or single elements) whose loads each
// thread of an elementwise pass issues before it uses any of them.
constexpr int kUE = 4;

// Sums a and b over the block, in a fixed order; thread 0 holds the sums.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS / 32], sb[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? sa[lane] : 0.0f;
    b = lane < THREADS / 32 ? sb[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// A unit of kW elements of T as floats: a 16-byte pack (kW = Pack<T>::kN)
// or one element (kW = 1).
template <typename T, int kW>
__device__ __forceinline__ void load_unit(const T* p, float* f) {
  if constexpr (kW == 1)
    f[0] = Pack<T>::get(p);
  else
    Pack<T>::load(p, f);
}

template <typename T, int kW>
__device__ __forceinline__ void store_unit(T* p, const float* f) {
  if constexpr (kW == 1)
    Pack<T>::put(p, f[0]);
  else
    Pack<T>::store(p, f);
}

// Block (c, s) of a per-channel reduction over elements [s * chunk,
// (s + 1) * chunk) of channel c's L = N * HW (element j of the channel is
// x[(j / HW * C + c) * HW + j % HW]), in units of kW elements (kW = 8 or
// 4 needs HW % kW == 0 and 16-byte aligned tensors, so a unit never
// leaves its plane). Each thread walks units threadIdx.x + k * THREADS of
// the range, its (plane, offset) cursor advanced without a division
// until it crosses a plane, kUR units' loads in flight (2 packs or 4
// elements: the fastest of 1, 2 and 4 timed on an H100, PERF.md). Sums
// x and x^2 (g == nullptr) or dy and dy * x, and writes part[s][c] and
// part[S + s][c].
template <typename T, int kW>
__device__ __forceinline__ void reduce_channel(const T* __restrict__ x,
                                               const T* __restrict__ g,
                                               float* __restrict__ part,
                                               int C, unsigned HW,
                                               unsigned L, unsigned chunk) {
  constexpr int kUR = kW == 1 ? 4 : 2;
  const int c = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const unsigned j0 = (unsigned)s * chunk;
  const unsigned j1 = min(L, j0 + chunk);
  const unsigned step = THREADS * kW;
  unsigned j = j0 + threadIdx.x * kW;
  unsigned n = j / HW, o = j - n * HW;
  float s1 = 0.0f, s2 = 0.0f;
  while (j < j1) {
    size_t at[kUR];
    int live = 0;
#pragma unroll
    for (int k = 0; k < kUR; ++k) {
      at[k] = ((size_t)n * C + c) * HW + o;
      if (j < j1) live = k + 1;
      j += step;
      o += step;
      if (o >= HW) {
        n += o / HW;
        o %= HW;
      }
    }
    float f[kUR][kW], d[kUR][kW];
#pragma unroll
    for (int k = 0; k < kUR; ++k) {
      if (k < live) {
        load_unit<T, kW>(x + at[k], f[k]);
        if (g != nullptr) load_unit<T, kW>(g + at[k], d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUR; ++k) {
      if (k < live) {
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if (g != nullptr) {
            s1 += d[k][i];
            s2 += d[k][i] * f[k][i];
          } else {
            s1 += f[k][i];
            s2 += f[k][i] * f[k][i];
          }
        }
      }
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    part[(size_t)s * C + c] = s1;
    part[(size_t)(S + s) * C + c] = s2;
  }
}

// The same over a channels-last tensor, a row-major (L = N * HW, C)
// matrix: block (t, s) sums channels [t * 32 * kW, (t + 1) * 32 * kW) over
// rows [s * chunk, (s + 1) * chunk). Lane l of warp w takes the kW
// channels at t * 32 * kW + l * kW (kW > 1 needs C % kW == 0 and 16-byte
// aligned tensors) in rows w, w + 8, ..., kUR rows' loads in flight; the
// warps' sums meet in shared memory and are added in warp order.
template <typename T, int kW>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ x,
                                            const T* __restrict__ g,
                                            float* __restrict__ part, int C,
                                            unsigned L, unsigned chunk) {
  constexpr int kUR = kW == 1 ? 4 : 2;
  constexpr int kWarps = THREADS / 32;
  __shared__ float sums[2][kWarps][32 * 8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int c0 = t * 32 * kW + lane * kW;
  const unsigned r1 = min(L, (unsigned)s * chunk + chunk);
  float s1[kW], s2[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) s1[i] = s2[i] = 0.0f;
  if (c0 < C) {
    for (unsigned r = (unsigned)s * chunk + warp; r < r1;
         r += kUR * kWarps) {
      float f[kUR][kW], d[kUR][kW];
#pragma unroll
      for (int k = 0; k < kUR; ++k) {
        const unsigned rk = r + k * kWarps;
        if (rk < r1) {
          load_unit<T, kW>(x + (size_t)rk * C + c0, f[k]);
          if (g != nullptr) load_unit<T, kW>(g + (size_t)rk * C + c0, d[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUR; ++k) {
        if (r + k * kWarps < r1) {
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const float a = g != nullptr ? d[k][i] : f[k][i];
            s1[i] += a;
            s2[i] += a * f[k][i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    sums[0][warp][lane * kW + i] = s1[i];
    sums[1][warp][lane * kW + i] = s2[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 32 * kW; j += THREADS) {
    const int c = t * 32 * kW + j;
    if (c >= C) continue;
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += sums[0][w][j];
      b += sums[1][w][j];
    }
    part[(size_t)s * C + c] = a;
    part[(size_t)(S + s) * C + c] = b;
  }
}

// Block b of an elementwise pass: flat elements [b * chunk, (b + 1) *
// chunk) in units of kW (kW > 1: 16-byte aligned tensors, chunk a
// multiple of kW), unit u of the block to thread u % THREADS, kUE units'
// loads in flight; the last block takes the elements past the last whole
// unit one by one. Element e's channel is (e / HW) % C, computed once a
// unit where the unit stays in one plane; channels-last (kRows), e % C,
// counted up along the unit. op(c, xv, gv) gives the output of one
// element of channel c; g may be nullptr.
template <typename T, int kW, bool kRows, typename Op>
__device__ __forceinline__ void eltwise(const T* __restrict__ x,
                                        const T* __restrict__ g,
                                        T* __restrict__ out, unsigned C,
                                        unsigned HW, unsigned total,
                                        unsigned chunk, const Op& op) {
  const unsigned e0 = blockIdx.x * chunk;
  const unsigned e1 = min(total, e0 + chunk);
  const unsigned ea = e1 == total ? total - total % kW : e1;
  for (unsigned e = e0 + threadIdx.x * kW; e < ea;
       e += kUE * THREADS * kW) {
    float f[kUE][kW], d[kUE][kW];
#pragma unroll
    for (int k = 0; k < kUE; ++k) {
      const unsigned ek = e + k * THREADS * kW;
      if (ek < ea) {
        load_unit<T, kW>(x + ek, f[k]);
        if (g != nullptr) load_unit<T, kW>(g + ek, d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUE; ++k) {
      const unsigned ek = e + k * THREADS * kW;
      if (ek < ea) {
        if constexpr (kRows) {
          unsigned c = ek % C;
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            f[k][i] = op(c, f[k][i], g != nullptr ? d[k][i] : 0.0f);
            if (++c == C) c = 0;
          }
        } else {
          const unsigned plane = ek / HW;
          const bool one = ek - plane * HW + kW <= HW;
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const unsigned p = one ? plane : (ek + i) / HW;
            f[k][i] = op(p % C, f[k][i], g != nullptr ? d[k][i] : 0.0f);
          }
        }
        store_unit<T, kW>(out + ek, f[k]);
      }
    }
  }
  for (unsigned e = ea + threadIdx.x; e < e1; e += THREADS) {
    const float gv = g != nullptr ? Pack<T>::get(g + e) : 0.0f;
    Pack<T>::put(out + e, op(kRows ? e % C : e / HW % C,
                             Pack<T>::get(x + e), gv));
  }
}

}  // namespace

// The kernels, outside the anonymous namespace so that each symbol starts
// with bn_ in a profiler's trace. kW: elements a load takes; kRows: a
// channels-last tensor (see reduce_channel, reduce_rows and eltwise).

template <typename T, int kW, bool kRows>
__global__ void __launch_bounds__(THREADS)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int C,
                    unsigned HW, unsigned L, unsigned chunk) {
  if constexpr (kRows)
    reduce_rows<T, kW>(x, nullptr, part, C, L, chunk);
  else
    reduce_channel<T, kW>(x, nullptr, part, C, HW, L, chunk);
}

template <typename T, int kW, bool kRows>
__global__ void __launch_bounds__(THREADS)
    bn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        float* __restrict__ part, int C, unsigned HW,
                        unsigned L, unsigned chunk) {
  if constexpr (kRows)
    reduce_rows<T, kW>(x, g, part, C, L, chunk);
  else
    reduce_channel<T, kW>(x, g, part, C, HW, L, chunk);
}

// stats rows: m, vr, r, a, at, bt (each C floats)
enum { kM, kVr, kR, kA, kAt, kBt };

static __device__ __forceinline__ float to_dtype(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// One thread a channel. The _rn intrinsics keep nvcc from contracting
// these into fmas, so each value rounds where the plain version's does.
__global__ void bn_finalize_kernel(const float* __restrict__ part, int S,
                                   int C, float n, float eps, float keep,
                                   float momentum, int bf16,
                                   const float* __restrict__ w,
                                   const float* __restrict__ beta,
                                   float* __restrict__ rmean,
                                   float* __restrict__ rvar,
                                   float* __restrict__ stats) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int s = 0; s < S; ++s) {
    s1 += part[(long long)s * C + c];
    s2 += part[(long long)(S + s) * C + c];
  }
  const float m = __fdiv_rn(s1, n);
  const float vr = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(m, m));
  const float v = fmaxf(vr, 0.0f);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(v, eps)));
  const float a = __fmul_rn(w[c], r);
  const float b = __fsub_rn(beta[c], __fmul_rn(m, a));
  rmean[c] = __fadd_rn(__fmul_rn(rmean[c], keep), __fmul_rn(momentum, m));
  rvar[c] = __fadd_rn(__fmul_rn(rvar[c], keep), __fmul_rn(momentum, v));
  stats[kM * C + c] = m;
  stats[kVr * C + c] = vr;
  stats[kR * C + c] = r;
  stats[kA * C + c] = a;
  stats[kAt * C + c] = to_dtype(a, bf16);
  stats[kBt * C + c] = to_dtype(b, bf16);
}

// part: this rank's (sum dy, sum dy * x) partials; gpart: the same summed
// over the ranks (part itself without data parallelism). Writes dw, db
// and coef = (k1, k2) for bn_dx_kernel.
__global__ void bn_bwd_finalize_kernel(
    const float* __restrict__ part, const float* __restrict__ gpart, int S,
    int C, float n, const float* __restrict__ w,
    const float* __restrict__ stats, float* __restrict__ dw,
    float* __restrict__ db, float* __restrict__ coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dB = 0.0f, dA = 0.0f, gB = 0.0f, gA = 0.0f;
  for (int s = 0; s < S; ++s) {
    dB += part[(long long)s * C + c];
    dA += part[(long long)(S + s) * C + c];
    gB += gpart[(long long)s * C + c];
    gA += gpart[(long long)(S + s) * C + c];
  }
  const float m = stats[kM * C + c], vr = stats[kVr * C + c];
  const float r = stats[kR * C + c], a = stats[kA * C + c];
  dw[c] = (dA - m * dB) * r;
  db[c] = dB;
  const float dr = (gA - m * gB) * w[c];
  const float dv = vr >= 0.0f ? -0.5f * dr * r * r * r : 0.0f;
  const float dm = -a * gB - 2.0f * m * dv;
  coef[c] = dm / n;
  coef[C + c] = 2.0f * dv / n;
}

struct AffineOp {
  const float* at;
  const float* bt;
  __device__ __forceinline__ float operator()(unsigned c, float xv,
                                              float) const {
    return fmaf(xv, at[c], bt[c]);
  }
};

// dx = dy * at + k1 + k2 * x
struct DxOp {
  const float* at;
  const float* coef;
  unsigned C;
  __device__ __forceinline__ float operator()(unsigned c, float xv,
                                              float gv) const {
    return fmaf(gv, at[c], fmaf(coef[C + c], xv, coef[c]));
  }
};

template <typename T, int kW, bool kRows>
__global__ void __launch_bounds__(THREADS)
    bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ stats, int C, unsigned HW,
                    unsigned total, unsigned chunk) {
  eltwise<T, kW, kRows>(x, (const T*)nullptr, y, (unsigned)C, HW, total, chunk,
                 AffineOp{stats + kAt * C, stats + kBt * C});
}

template <typename T, int kW, bool kRows>
__global__ void __launch_bounds__(THREADS)
    bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 T* __restrict__ dx, const float* __restrict__ stats,
                 const float* __restrict__ coef, int C, unsigned HW,
                 unsigned total, unsigned chunk) {
  eltwise<T, kW, kRows>(x, g, dx, (unsigned)C, HW, total, chunk,
                 DxOp{stats + kAt * C, coef, (unsigned)C});
}

namespace {

// Elements a tensor may hold: the kernels index in 32 bits.
constexpr long long kMaxElements = 1LL << 31;

inline bool bad_shape(int C, long long HW, long long L, long long chunk,
                      int splits) {
  return C < 1 || HW < 1 || L < 1 || chunk < 1 || chunk % 64 != 0 ||
         splits < 1 || splits > 65535 || (long long)splits * chunk < L ||
         L * C > kMaxElements;
}

inline bool bad_flat(int C, long long HW, long long total, long long chunk) {
  return C < 1 || HW < 1 || total < 1 || chunk < 1 || chunk % 64 != 0 ||
         total > kMaxElements;
}

inline unsigned grid_of(long long total, long long chunk) {
  return (unsigned)((total + chunk - 1) / chunk);
}

// Runs f.run<T, kW, kRows>() for the instance the flags name: x's dtype
// (bf16), 16-byte units or single elements (wide), channels-last (rows).
template <typename T, typename F>
void pick(int wide, int rows, const F& f) {
  constexpr int kN = Pack<T>::kN;
  if (wide)
    rows ? f.template run<T, kN, true>() : f.template run<T, kN, false>();
  else
    rows ? f.template run<T, 1, true>() : f.template run<T, 1, false>();
}

template <typename F>
int dispatch(int bf16, int wide, int rows, const F& f) {
  if (bf16)
    pick<__nv_bfloat16>(wide, rows, f);
  else
    pick<float>(wide, rows, f);
  return (int)cudaGetLastError();
}

// A reduction's grid: a block a channel (NCHW) or 32 units of channels
// (channels-last), times the splits.
inline dim3 reduce_grid(int C, int splits, int wide, int rows, int bf16) {
  const int unit = wide ? (bf16 ? 8 : 4) : 1;
  return dim3(rows ? (unsigned)((C + 32 * unit - 1) / (32 * unit))
                   : (unsigned)C,
              (unsigned)splits);
}

// 16-byte units need whole units in each plane (NCHW) or row (channels-
// last) of a reduction.
inline bool bad_units(int C, long long HW, int wide, int rows, int bf16) {
  const int unit = bf16 ? 8 : 4;
  return wide && (rows ? C % unit : HW % unit) != 0;
}

struct StatsCall {
  dim3 grid;
  cudaStream_t st;
  const void* x;
  float* part;
  int C;
  long long HW, L, chunk;
  template <typename T, int kW, bool kRows>
  void run() const {
    bn_stats_kernel<T, kW, kRows><<<grid, THREADS, 0, st>>>(
        (const T*)x, part, C, (unsigned)HW, (unsigned)L, (unsigned)chunk);
  }
};

struct BwdStatsCall {
  dim3 grid;
  cudaStream_t st;
  const void* x;
  const void* g;
  float* part;
  int C;
  long long HW, L, chunk;
  template <typename T, int kW, bool kRows>
  void run() const {
    bn_bwd_stats_kernel<T, kW, kRows><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const T*)g, part, C, (unsigned)HW, (unsigned)L,
        (unsigned)chunk);
  }
};

struct ApplyCall {
  unsigned grid;
  cudaStream_t st;
  const void* x;
  void* y;
  const float* stats;
  int C;
  long long HW, total, chunk;
  template <typename T, int kW, bool kRows>
  void run() const {
    bn_apply_kernel<T, kW, kRows><<<grid, THREADS, 0, st>>>(
        (const T*)x, (T*)y, stats, C, (unsigned)HW, (unsigned)total,
        (unsigned)chunk);
  }
};

struct DxCall {
  unsigned grid;
  cudaStream_t st;
  const void* x;
  const void* g;
  void* dx;
  const float* stats;
  const float* coef;
  int C;
  long long HW, total, chunk;
  template <typename T, int kW, bool kRows>
  void run() const {
    bn_dx_kernel<T, kW, kRows><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const T*)g, (T*)dx, stats, coef, C, (unsigned)HW,
        (unsigned)total, (unsigned)chunk);
  }
};

}  // namespace

// C entry points (ops/batch_norm.py). bf16 != 0: x, y, dy and dx are
// bf16, else float32. rows != 0: they are channels-last, else NCHW.
// wide != 0: 16-byte units (every tensor argument 16-byte aligned, and
// for bn_stats and bn_bwd_stats whole units in each plane or row), else
// single elements. chunk: a multiple of 64 (elements of a channel, or
// rows, for the reductions; flat elements for bn_apply and bn_dx); at
// most 2^31 elements a tensor. Each returns cudaGetLastError().

extern "C" int bn_stats(const void* x, float* part, int C, long long HW,
                        long long L, long long chunk, int splits, int wide,
                        int rows, int bf16, cudaStream_t stream) {
  if (bad_shape(C, HW, L, chunk, splits) ||
      bad_units(C, HW, wide, rows, bf16))
    return (int)cudaErrorInvalidValue;
  return dispatch(bf16, wide, rows,
                  StatsCall{reduce_grid(C, splits, wide, rows, bf16), stream,
                            x, part, C, HW, L, chunk});
}

extern "C" int bn_finalize(const float* part, int splits, int C, float n,
                           float eps, float keep, float momentum, int bf16,
                           const float* w, const float* beta, float* rmean,
                           float* rvar, float* stats, cudaStream_t stream) {
  if (C < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  bn_finalize_kernel<<<grid_of(C, THREADS), THREADS, 0, stream>>>(
      part, splits, C, n, eps, keep, momentum, bf16, w, beta, rmean, rvar,
      stats);
  return (int)cudaGetLastError();
}

extern "C" int bn_apply(const void* x, void* y, const float* stats, int C,
                        long long HW, long long total, long long chunk,
                        int wide, int rows, int bf16, cudaStream_t stream) {
  if (bad_flat(C, HW, total, chunk)) return (int)cudaErrorInvalidValue;
  return dispatch(bf16, wide, rows,
                  ApplyCall{grid_of(total, chunk), stream, x, y, stats, C,
                            HW, total, chunk});
}

extern "C" int bn_bwd_stats(const void* x, const void* g, float* part,
                            int C, long long HW, long long L,
                            long long chunk, int splits, int wide, int rows,
                            int bf16, cudaStream_t stream) {
  if (bad_shape(C, HW, L, chunk, splits) ||
      bad_units(C, HW, wide, rows, bf16))
    return (int)cudaErrorInvalidValue;
  return dispatch(bf16, wide, rows,
                  BwdStatsCall{reduce_grid(C, splits, wide, rows, bf16),
                               stream, x, g, part, C, HW, L, chunk});
}

extern "C" int bn_bwd_finalize(const float* part, const float* gpart,
                               int splits, int C, float n, const float* w,
                               const float* stats, float* dw, float* db,
                               float* coef, cudaStream_t stream) {
  if (C < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  bn_bwd_finalize_kernel<<<grid_of(C, THREADS), THREADS, 0, stream>>>(
      part, gpart, splits, C, n, w, stats, dw, db, coef);
  return (int)cudaGetLastError();
}

extern "C" int bn_dx(const void* x, const void* g, void* dx,
                     const float* stats, const float* coef, int C,
                     long long HW, long long total, long long chunk,
                     int wide, int rows, int bf16, cudaStream_t stream) {
  if (bad_flat(C, HW, total, chunk)) return (int)cudaErrorInvalidValue;
  return dispatch(bf16, wide, rows,
                  DxCall{grid_of(total, chunk), stream, x, g, dx, stats,
                         coef, C, HW, total, chunk});
}
