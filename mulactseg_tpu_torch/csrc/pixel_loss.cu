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
// bitmasks and the logits of the pixels that have a candidate (about half
// on the recipe's 50% selection: ~0.030 ms at 3.35 TB/s); K2 reads the
// same and writes the 189 MB of dl (~0.086 ms). The arithmetic (C exps per
// live pixel) is far below the float32 rate.
//
// Design. Grid (pixel blocks of PIXELS, B); each thread owns 4 pixels.
// - The class count is a template parameter for the stage-1 model's 20
//   outputs (any other C <= 31 takes a run-time instance, MAXC registers
//   per pixel), so a thread's loads are issued back to back and its
//   softmaxes stay in registers. p_c = exp2((x_c / T - max) log2(e)) *
//   (1 / sum) and dl_c = (coef / sum) e_c (pos - t_c): a class costs an
//   exp2 and a few multiplies and adds, about half the instructions of
//   expf and the plain version's order of operations.
// - Layout kVec: when HW % 4 == 0 and logits and bits are 16-byte aligned
//   (the wrapper checks), a thread's pixels are 4 consecutive ones: one
//   int4 load of their bits and one float4 load per class, so each warp
//   access is 512 bytes and C of them are in flight at once. Otherwise
//   (kNchw, and K9's (N, C) rows kRows) the 4 pixels lie THREADS apart and
//   each logit is one 4-byte load, coalesced across the warp for NCHW; a
//   row's other classes come from L1.
// - A group without a candidate loads no logits; in K2 it only stores
//   zeros, in the same store instructions as the warp's live groups, so
//   each store of a class fills whole 32-byte sectors. K2 writes dl once,
//   with plain stores: streaming ones (st.global.cs) made ptxas keep 172
//   registers a thread against 128, so half as many warps an SM, and K2
//   ran 4% slower on the recipe's data on an H100 (PERF.md).
// - K10 (pixel_ce_rows_bwd) stages a tile of PIXELS consecutive rows
//   through shared memory, so that every global access is coalesced:
//   K2's kernel over kRows read each logit with a 4-byte load and wrote
//   each dl with a 4-byte store 4 C bytes from its neighbour lane's, so
//   each 32-byte sector of dl was written in pieces by several store
//   instructions (0.665 ms against a 0.086 ms bound on an H100, PERF.md).
//   A block of TILE_THREADS threads loads the tile's bitmasks (int4
//   loads), then the live rows' logits (popcount of the low C bits > 0)
//   into a row-major (row, class) tile, unit j of the tile's rows going to
//   row j / W, where a unit is a float4 (W = C / 4 a row, when C % 4 == 0
//   and logits and bits are 16-byte aligned) or a float (W = C); a dead
//   row's units are never read, so only live rows' bytes leave device
//   memory. A row's units lie W | 1 units apart in the tile: an odd
//   stride, so a quarter-warp's 16-byte or a warp's 4-byte accesses to
//   its threads' rows hit distinct banks (at C = 20, W = 5: 80 bytes, the
//   rows packed). One thread per row then reads its row, takes K2's
//   arithmetic in K2's order (so dl is bitwise K2's on the same row),
//   writes its dl, or zeros for a dead row, back over the row, and the
//   block stores the tile with the same units, each warp instruction 32
//   consecutive units: whole 128-byte lines of dl. The last tile may be
//   short (N % PIXELS != 0, N % 4 != 0).
// - K1 is one launch and bitwise reproducible: each block adds its sums in
//   a fixed order (each thread its 4 pixels in order, warp shuffles, the
//   warps in order) into one float4 partial; the block then takes a ticket
//   from a device counter after a __threadfence(), and the last block to
//   finish adds every partial in index order, in double, and resets the
//   counter for the next launch. No float atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

// PIXELS: pixels per block, 4 per thread; ops/_build.py passes it from
// ops/pixel_loss.py (PIXELS_PER_BLOCK), which sizes K1's partials with it.
#if !defined(PIXELS)
#error "build with -DPIXELS=... (ops/pixel_loss.py PIXELS_PER_BLOCK)"
#endif
#if PIXELS % 128 != 0 || PIXELS > 4096
#error "PIXELS must be a multiple of 128 and at most 4096"
#endif
#define THREADS (PIXELS / 4)
#define WARPS (THREADS / 32)
#define MAXC 31  // candidate bitmasks are int32
#define TILE_THREADS 256  // K10: threads of a block, PIXELS rows a tile

namespace {

constexpr float kEps = 1e-8f;
constexpr float kLog2e = 1.4426950408889634f;

// Classes known at compile time (NC > 0) or at run time (NC == 0, C <=
// MAXC): per-class registers and loops are sized by kMax.
template <int NC>
struct Cls {
  static constexpr int kMax = NC > 0 ? NC : MAXC;
  __device__ __forceinline__ static int n(int c) { return NC > 0 ? NC : c; }
};

enum Layout { kVec, kNchw, kRows };

// Pixel k of the thread's group; hw0 is the first.
template <int L>
__device__ __forceinline__ int pixel_of(int hw0, int k) {
  return L == kVec ? hw0 + k : hw0 + k * THREADS;
}

template <int L>
__device__ __forceinline__ int first_pixel() {
  return blockIdx.x * PIXELS + (L == kVec ? 4 * threadIdx.x : threadIdx.x);
}

// The group's bitmasks, 0 past HW (with kVec, HW % 4 == 0, so a group
// is all inside or all past it).
template <int L>
__device__ __forceinline__ void load_bits(const int* __restrict__ bb, int hw0,
                                          int HW, unsigned (&bt)[4]) {
  if (L == kVec) {
    const int4 v = hw0 < HW ? __ldg(reinterpret_cast<const int4*>(bb + hw0))
                            : make_int4(0, 0, 0, 0);
    bt[0] = v.x;
    bt[1] = v.y;
    bt[2] = v.z;
    bt[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int hw = pixel_of<L>(hw0, k);
      bt[k] = hw < HW ? (unsigned)__ldg(bb + hw) : 0u;
    }
  }
}

// v[c][k] = logit c of pixel k, for the pixels of `live` (kVec loads the
// whole group once any pixel is live). kStream marks K1's 16-byte loads
// evict-first (ld.global.cs): it reads each logit once; K2's keep the
// default policy.
template <int NC, int L, bool kStream>
__device__ __forceinline__ void load_logits(const float* __restrict__ xb,
                                            int hw0, int C, int HW,
                                            unsigned live,
                                            float (&v)[Cls<NC>::kMax][4]) {
  constexpr int K = Cls<NC>::kMax;
  if (L == kVec) {
    const float4* p = reinterpret_cast<const float4*>(xb + hw0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < C) {
        const float4 f =
            kStream ? __ldcs(p + c * (HW / 4)) : __ldg(p + c * (HW / 4));
        v[c][0] = f.x;
        v[c][1] = f.y;
        v[c][2] = f.z;
        v[c][3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((live >> k) & 1u) {
        const int hw = pixel_of<L>(hw0, k);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          if (c < C) v[c][k] = __ldg(L == kRows ? xb + hw * C + c
                                                : xb + c * HW + hw);
        }
      }
    }
  }
}

// Softmax of pixel k of a group of G: leaves v[c][k] = exp(x_c / T - m)
// and rz = 1 / sum, and returns pos = sum over candidates of p_c. u = x *
// (1/T) and u - max follow the plain version's x / T and u - max (u may
// round one ulp apart): at |u| ~ 100 a rounding of u moves p_c by ~1e-5,
// so the exponent is not refolded. The exponential is exp2((u - max)
// log2(e)), one multiply and one exp2 where expf takes about eight
// instructions.
template <int K, int G>
__device__ __forceinline__ float softmax_pos(float (&v)[K][G], int k, int C,
                                             float inv_temp, unsigned bits,
                                             float& rz) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
      v[c][k] *= inv_temp;
      m = fmaxf(m, v[c][k]);
    }
  }
  float z = 0.f, s = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
      v[c][k] = exp2f((v[c][k] - m) * kLog2e);
      z += v[c][k];
      if ((bits >> c) & 1u) s += v[c][k];
    }
  }
  rz = 1.f / z;
  return s * rz;
}

// K2's and K10's dl of a live pixel k (n candidates, n > 0) in place of its
// logits: dl_c = coef (pos p_c - p_c t_c) = (coef / sum) e_c (pos - t_c).
template <int K, int G>
__device__ __forceinline__ void dl_of(float (&v)[K][G], int k, int C,
                                      unsigned bits, int n, float g_oh,
                                      float g_mh, float temp,
                                      float inv_temp) {
  float rz;
  const float pos = softmax_pos(v, k, C, inv_temp, bits, rz);
  const float a = (n == 1 ? g_oh : g_mh) / (temp * (pos + kEps)) * rz;
  const float pos_m1 = pos - 1.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) v[c][k] *= a * (((bits >> c) & 1u) ? pos_m1 : pos);
  }
}

// Offset of image b's logits: (N, C) rows are one image.
template <int L>
__device__ __forceinline__ long long image_base(int C, int HW) {
  return L == kRows ? 0 : (long long)blockIdx.y * C * HW;
}

// The block's four sums in a fixed order into its partial; the last block
// to take a ticket adds all partials in index order into out.
__device__ __forceinline__ void finish_sums(float (&acc)[4],
                                            float4* __restrict__ partials,
                                            unsigned* __restrict__ ticket,
                                            float* __restrict__ out) {
  __shared__ float4 warp_sums[WARPS];
  __shared__ double warp_totals[WARPS][4];
  __shared__ bool last;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += __shfl_down_sync(full, acc[i], d);
  }
  if (lane == 0) warp_sums[warp] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  const unsigned nblocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    float4 s = warp_sums[0];
    for (int w = 1; w < WARPS; ++w) {
      s.x += warp_sums[w].x;
      s.y += warp_sums[w].y;
      s.z += warp_sums[w].z;
      s.w += warp_sums[w].w;
    }
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // thread t adds partials t, t + THREADS, ... (from L2: other SMs wrote
  // them), then the threads' sums are added in a fixed tree
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  for (unsigned i = threadIdx.x; i < nblocks; i += THREADS) {
    const float4 p = __ldcg(partials + i);
    d[0] += p.x;
    d[1] += p.y;
    d[2] += p.z;
    d[3] += p.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += __shfl_down_sync(full, d[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) warp_totals[warp][i] = d[i];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += warp_totals[w][threadIdx.x];
    out[threadIdx.x] = (float)s;
  }
  if (threadIdx.x == 0) *ticket = 0u;  // for the next launch
}

template <int NC, int L>
__global__ void __launch_bounds__(THREADS) pixel_ce_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ bits,
    float4* __restrict__ partials, unsigned* __restrict__ ticket,
    float* __restrict__ out, int C_, int HW, float inv_temp) {
  constexpr int K = Cls<NC>::kMax;
  const int C = Cls<NC>::n(C_);
  const int hw0 = first_pixel<L>();
  unsigned bt[4];
  load_bits<L>(bits + (long long)blockIdx.y * HW, hw0, HW, bt);
  const unsigned mask = (1u << C) - 1u;
  int n[4];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = __popc(bt[k] & mask);
    if (n[k] > 0) live |= 1u << k;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {  // a group without candidates needs no logits
    float v[K][4];
    load_logits<NC, L, true>(x + image_base<L>(C, HW), hw0, C, HW, live,
                             v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n[k] > 0) {
        float rz;
        const float nll =
            -logf(softmax_pos(v, k, C, inv_temp, bt[k], rz) + kEps);
        if (n[k] == 1) {  // constant indices keep acc in registers
          acc[0] += nll;
          acc[1] += 1.f;
        } else {
          acc[2] += nll;
          acc[3] += 1.f;
        }
      }
    }
  }
  finish_sums(acc, partials, ticket, out);
}

// The group's dl for class c (NCHW layouts).
template <int L>
__device__ __forceinline__ void store_class(float* __restrict__ ob, int hw0,
                                            int c, int HW,
                                            const float (&d)[4]) {
  if (L == kVec) {
    *reinterpret_cast<float4*>(ob + c * HW + hw0) =
        make_float4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int hw = pixel_of<L>(hw0, k);
      if (hw < HW) ob[c * HW + hw] = d[k];
    }
  }
}

template <int NC, int L>
__global__ void __launch_bounds__(THREADS) pixel_ce_bwd_kernel(
    const float* __restrict__ x, const int* __restrict__ bits,
    const float* __restrict__ g, float* __restrict__ dl, int C_, int HW,
    float temp, float inv_temp) {
  constexpr int K = Cls<NC>::kMax;
  const int C = Cls<NC>::n(C_);
  const int hw0 = first_pixel<L>();
  if (hw0 >= HW) return;
  unsigned bt[4];
  load_bits<L>(bits + (long long)blockIdx.y * HW, hw0, HW, bt);
  const unsigned mask = (1u << C) - 1u;
  int n[4];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = __popc(bt[k] & mask);
    if (n[k] > 0) live |= 1u << k;
  }
  const long long base = image_base<L>(C, HW);
  float v[K][4];
  if (live) {
    load_logits<NC, L, false>(x + base, hw0, C, HW, live, v);
    const float g_oh = __ldg(g), g_mh = __ldg(g + 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n[k] > 0) {
        dl_of(v, k, C, bt[k], n[k], g_oh, g_mh, temp, inv_temp);
      } else {
#pragma unroll
        for (int c = 0; c < K; ++c) v[c][k] = 0.f;
      }
    }
  } else {  // no bucket, no gradient
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[c][k] = 0.f;
    }
  }
  // Dead and live groups store together: each class is one store for the
  // whole warp, so its lines are written whole. Stored from the two sides
  // of the branch, a 32-byte sector at a live/dead border was written in
  // two halves by two stores (K2 0.146 ms against 0.129 on an H100,
  // PERF.md).
  __syncwarp();
  float* ob = dl + base;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) store_class<L>(ob, hw0, c, HW, v[c]);
  }
}

// K10's shared memory: PIXELS bitmasks, then PIXELS rows of W | 1 units.
size_t rows_smem_bytes(int C, bool wide) {
  const int W = wide ? C / 4 : C;
  return (size_t)PIXELS * 4 + (size_t)PIXELS * (W | 1) * (wide ? 16 : 4);
}

// K10: one block per tile of PIXELS rows (see the note at the top).
template <int NC, bool kWide>
__global__ void __launch_bounds__(TILE_THREADS) pixel_ce_rows_bwd_kernel(
    const float* __restrict__ x, const int* __restrict__ bits,
    const float* __restrict__ g, float* __restrict__ dl, int C_, int N,
    float temp, float inv_temp) {
  typedef Unit<kWide> Un;
  typedef typename Un::T U;
  constexpr int F = Un::kFloats;
  constexpr int K = (Cls<NC>::kMax + F - 1) / F * F;  // whole units
  constexpr int kBatch = 32 / F;  // units a thread has in flight
  const int C = Cls<NC>::n(C_);
  const int W = C / F;   // units a row
  const int ws = W | 1;  // units from one row of the tile to the next
  extern __shared__ float4 smem[];
  unsigned* sbits = reinterpret_cast<unsigned*>(smem);
  U* tile = reinterpret_cast<U*>(smem + PIXELS / 4);
  const long long r0 = (long long)blockIdx.x * PIXELS;
  const int rows = (int)min((long long)PIXELS, (long long)N - r0);
  const unsigned mask = (1u << C) - 1u;

  // the tile's bitmasks, 0 past N
  if (kWide) {
    for (int i = threadIdx.x; i < PIXELS / 4; i += TILE_THREADS) {
      int4 b;
      if (4 * i + 4 <= rows) {
        b = __ldg(reinterpret_cast<const int4*>(bits + r0) + i);
      } else {
        const int* bp = bits + r0 + 4 * i;
        b.x = 4 * i < rows ? __ldg(bp) : 0;
        b.y = 4 * i + 1 < rows ? __ldg(bp + 1) : 0;
        b.z = 4 * i + 2 < rows ? __ldg(bp + 2) : 0;
        b.w = 4 * i + 3 < rows ? __ldg(bp + 3) : 0;
      }
      reinterpret_cast<int4*>(sbits)[i] = b;
    }
  } else {
    for (int r = threadIdx.x; r < PIXELS; r += TILE_THREADS)
      sbits[r] = r < rows ? (unsigned)__ldg(bits + r0 + r) : 0u;
  }
  __syncthreads();

  // the live rows' units, kBatch a thread in flight at once
  const U* xu = reinterpret_cast<const U*>(x + r0 * C);
  const int units = rows * W;
  for (int j0 = threadIdx.x; j0 < units; j0 += kBatch * TILE_THREADS) {
    U h[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = j0 + i * TILE_THREADS;
      live[i] = j < units && (sbits[j / W] & mask);
      if (live[i]) h[i] = __ldg(xu + j);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = j0 + i * TILE_THREADS;
      const int r = j / W;
      if (live[i]) tile[r * ws + (j - r * W)] = h[i];
    }
  }
  __syncthreads();

  // one thread per row: its dl over its logits, zeros for a dead row
  const float g_oh = __ldg(g), g_mh = __ldg(g + 1);
  for (int r = threadIdx.x; r < rows; r += TILE_THREADS) {
    U* row = tile + r * ws;
    const unsigned bt = sbits[r];
    const int n = __popc(bt & mask);
    float v[K][1];
    float f[F];
    if (n > 0) {
#pragma unroll
      for (int i = 0; i < K / F; ++i) {
        if (i < W) {
          Un::get(row[i], f);
#pragma unroll
          for (int q = 0; q < F; ++q) v[F * i + q][0] = f[q];
        }
      }
      dl_of(v, 0, C, bt, n, g_oh, g_mh, temp, inv_temp);
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) v[c][0] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < K / F; ++i) {
      if (i < W) {
#pragma unroll
        for (int q = 0; q < F; ++q) f[q] = v[F * i + q][0];
        row[i] = Un::put(f);
      }
    }
  }
  __syncthreads();

  // the tile's dl, 32 consecutive units a warp instruction
  U* du = reinterpret_cast<U*>(dl + r0 * C);
  for (int j = threadIdx.x; j < units; j += TILE_THREADS) {
    const int r = j / W;
    du[j] = tile[r * ws + (j - r * W)];
  }
}

template <int NC, int L>
int launch_fwd(const float* x, const int* bits, float* partials,
               unsigned* ticket, float* out, int B, int C, int HW,
               float temp, cudaStream_t stream) {
  dim3 grid((HW + PIXELS - 1) / PIXELS, B);
  pixel_ce_fwd_kernel<NC, L><<<grid, THREADS, 0, stream>>>(
      x, bits, reinterpret_cast<float4*>(partials), ticket, out, C, HW,
      1.f / temp);
  return (int)cudaGetLastError();
}

template <int NC, int L>
int launch_bwd(const float* x, const int* bits, const float* g, float* dl,
               int B, int C, int HW, float temp, cudaStream_t stream) {
  dim3 grid((HW + PIXELS - 1) / PIXELS, B);
  pixel_ce_bwd_kernel<NC, L><<<grid, THREADS, 0, stream>>>(
      x, bits, g, dl, C, HW, temp, 1.f / temp);
  return (int)cudaGetLastError();
}

template <int NC, bool kWide>
int launch_rows_bwd(const float* x, const int* bits, const float* g,
                    float* dl, int N, int C, float temp,
                    cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(C, kWide);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        pixel_ce_rows_bwd_kernel<NC, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const unsigned blocks = (unsigned)(((long long)N + PIXELS - 1) / PIXELS);
  pixel_ce_rows_bwd_kernel<NC, kWide><<<blocks, TILE_THREADS, smem, stream>>>(
      x, bits, g, dl, C, N, temp, 1.f / temp);
  return (int)cudaGetLastError();
}

// The instance the wrapper chose: nc = 20 (C == 20 compiled) or 0 (C at
// run time); vec asks for kVec, which needs HW % 4 == 0 and 16-byte
// aligned logits, bits and dl.
bool bad_choice(int nc, int C) { return (nc != 0 && nc != C) || C > MAXC; }

bool misaligned(const void* a, const void* b, int HW) {
  return HW % 4 != 0 || ((uintptr_t)a | (uintptr_t)b) % 16 != 0;
}

}  // namespace

extern "C" int pixel_ce_fwd(const float* x, const int* bits, float* partials,
                            unsigned* ticket, float* out, int B, int C,
                            int HW, float temp, int nc, int vec,
                            cudaStream_t stream) {
  if (bad_choice(nc, C) || (vec && misaligned(x, bits, HW)))
    return (int)cudaErrorInvalidValue;
  if (vec)
    return nc == 20 ? launch_fwd<20, kVec>(x, bits, partials, ticket, out, B,
                                            C, HW, temp, stream)
                    : launch_fwd<0, kVec>(x, bits, partials, ticket, out, B,
                                           C, HW, temp, stream);
  return nc == 20 ? launch_fwd<20, kNchw>(x, bits, partials, ticket, out, B,
                                          C, HW, temp, stream)
                  : launch_fwd<0, kNchw>(x, bits, partials, ticket, out, B,
                                         C, HW, temp, stream);
}

extern "C" int pixel_ce_bwd(const float* x, const int* bits, const float* g,
                            float* dl, int B, int C, int HW, float temp,
                            int nc, int vec, cudaStream_t stream) {
  if (bad_choice(nc, C) ||
      (vec && (misaligned(x, bits, HW) || misaligned(dl, dl, HW))))
    return (int)cudaErrorInvalidValue;
  if (vec)
    return nc == 20 ? launch_bwd<20, kVec>(x, bits, g, dl, B, C, HW, temp,
                                            stream)
                    : launch_bwd<0, kVec>(x, bits, g, dl, B, C, HW, temp,
                                           stream);
  return nc == 20 ? launch_bwd<20, kNchw>(x, bits, g, dl, B, C, HW, temp,
                                          stream)
                  : launch_bwd<0, kNchw>(x, bits, g, dl, B, C, HW, temp,
                                         stream);
}

// K9: (N, C) rows, K1's kernel.
extern "C" int pixel_ce_rows_fwd(const float* x, const int* bits,
                                 float* partials, unsigned* ticket,
                                 float* out, int N, int C, float temp, int nc,
                                 cudaStream_t stream) {
  if (bad_choice(nc, C)) return (int)cudaErrorInvalidValue;
  return nc == 20 ? launch_fwd<20, kRows>(x, bits, partials, ticket, out, 1,
                                          C, N, temp, stream)
                  : launch_fwd<0, kRows>(x, bits, partials, ticket, out, 1, C,
                                         N, temp, stream);
}

// K10: wide asks for 16-byte units, which need C % 4 == 0 and 16-byte
// aligned logits, bits and dl (the wrapper checks).
extern "C" int pixel_ce_rows_bwd(const float* x, const int* bits,
                                 const float* g, float* dl, int N, int C,
                                 float temp, int nc, int wide,
                                 cudaStream_t stream) {
  if (bad_choice(nc, C) || C < 1 ||
      (wide && (C % 4 != 0 || misaligned(x, bits, 0) ||
                misaligned(dl, dl, 0))))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (wide)
    return nc == 20 ? launch_rows_bwd<20, true>(x, bits, g, dl, N, C, temp,
                                                stream)
                    : launch_rows_bwd<0, true>(x, bits, g, dl, N, C, temp,
                                               stream);
  return nc == 20 ? launch_rows_bwd<20, false>(x, bits, g, dl, N, C, temp,
                                               stream)
                  : launch_rows_bwd<0, false>(x, bits, g, dl, N, C, temp,
                                              stream);
}
