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
//       num_segments + 1 > 9216: prereduce_nchw_fwd
//   K8  prereduce_softmax_blocks / _prereduce_kernel (pallas_call at
//       :351), reached from ops/segment.py:454-475 (the row-major
//       segment_softmax_max under MULACTSEG_SSM_PREREDUCE=1):
//       prereduce_rows_fwd
// K6 reads (B, C, HW) logits with blocks counted from each image's first
// pixel; K8 reads (P, C) pre-scaled rows (pixel stride C, class stride 1)
// as one image with inv_temp 1, blocks counted from row 0. An image's last
// block is short when HW % 4 != 0.
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
// K6 design (prereduce_nchw_kernel): one thread per raster block. A
// thread owns the 4 pixels of one block, so the merge, the tie order of
// choice and an image's short last block all stay in its registers, with
// no shuffle. The class count is a template parameter for the stage-1
// model's 20 outputs (any other C <= 32 takes a run-time instance), so a
// thread's C loads are issued back to back and its 4 softmaxes stay in
// registers. Layout kVec (HW % 4 == 0, logits and ids 16-byte aligned;
// the wrapper checks and the entry point refuses a request that breaks
// it): a class's 4 logits are one float4 load and its 4 rounded values
// one float4 store, the 4 ids one int4 load and sid2 one int4 store, so
// each warp access is 512 contiguous bytes. Otherwise (kScalar) each
// value is a 4-byte access, a warp's accesses for one class 16 bytes
// apart, the rest of each 32-byte sector from L1. Either way a warp's
// choice stores for one class are 32 consecutive ints. The arithmetic
// (x * inv_temp, expf, the sum in class order, e / z, the merge and
// round_bf16, common.cuh: the same bits as the first design's integer
// trick) is the first design's, so the outputs are bitwise the same.
// The true division takes its slow path for a denormal quotient, which
// the model's cosine logits (|x| <= 1 at T 0.1) never give; logits such
// as 3 N(0, 1) do, and then K6 takes ~2.5x as long (PERF.md).
//
// K8 (prereduce_rows_kernel, the first design, kept for the rows): one
// thread per row, each group of 4 lanes one raster block merged by warp
// shuffles; a row's classes are C contiguous floats, so a warp's loads for
// one class are 80 bytes apart and the rest come from L1.
// The TPU kernel's lane rolls, lane padding to 128 and selector matmul are
// not needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define MAXC 32
#define THREADS 256
#define BLOCK 4

namespace {

// Classes known at compile time (NC > 0) or at run time (NC == 0, C <=
// MAXC): per-class registers and loops are sized by kMax.
template <int NC>
struct Cls {
  static constexpr int kMax = NC > 0 ? NC : MAXC;
  __device__ __forceinline__ static int n(int c) { return NC > 0 ? NC : c; }
};

enum Layout { kScalar, kVec };

// K6: grid (raster blocks / THREADS, B), one thread per raster block.
template <int NC, Layout L>
__global__ void __launch_bounds__(THREADS) prereduce_nchw_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    float* __restrict__ out, int* __restrict__ choice,
    int* __restrict__ sid2, int C_, int HW, int S, float inv_temp) {
  constexpr int K = Cls<NC>::kMax;
  const int C = Cls<NC>::n(C_);
  const int b = blockIdx.y;
  const int nb = (HW + BLOCK - 1) / BLOCK;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= nb) return;
  const int n = min(BLOCK, HW - BLOCK * k);  // pixels of this block
  const long long P = (long long)gridDim.y * HW;
  const long long p0 = (long long)b * HW + BLOCK * k;
  const float* xp = x + (long long)b * C * HW + BLOCK * k;

  int s[BLOCK];
  if (L == kVec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(sid + p0));
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < BLOCK; ++j) s[j] = j < n ? __ldg(sid + p0 + j) : 0;
  }

  float e[K][BLOCK];
  float m[BLOCK], z[BLOCK];
#pragma unroll
  for (int j = 0; j < BLOCK; ++j) m[j] = -INFINITY, z[j] = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
      if (L == kVec) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(xp + (long long)c * HW));
        e[c][0] = v.x, e[c][1] = v.y, e[c][2] = v.z, e[c][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < BLOCK; ++j)
          e[c][j] = j < n ? __ldg(xp + (long long)c * HW + j) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BLOCK; ++j) {
        e[c][j] *= inv_temp;
        m[j] = fmaxf(m[j], e[c][j]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
#pragma unroll
      for (int j = 0; j < BLOCK; ++j) {
        e[c][j] = expf(e[c][j] - m[j]);
        z[j] += e[c][j];
      }
    }
  }

  // pixels past the image, and pixels of another segment than the
  // leader's, hold -1, which never reaches the max (the leader's own
  // p >= 0 is in it)
  bool match[BLOCK];
#pragma unroll
  for (int j = 0; j < BLOCK; ++j) match[j] = j < n && s[j] == s[0];
  const long long NB = (long long)gridDim.y * nb;
  int* ch_out = choice + (long long)b * nb + k;
  float* o = out + p0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
      float pc[BLOCK], v[BLOCK];
#pragma unroll
      for (int j = 0; j < BLOCK; ++j) {
        pc[j] = e[c][j] / z[j];
        v[j] = match[j] ? pc[j] : -1.f;
      }
      const float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      ch_out[(long long)c * NB] =
          v[0] == mx ? 0 : v[1] == mx ? 1 : v[2] == mx ? 2 : 3;
      float* oc = o + (long long)c * P;
      if (L == kVec) {
        *reinterpret_cast<float4*>(oc) =
            make_float4(round_bf16(mx), round_bf16(pc[1]),
                        round_bf16(pc[2]), round_bf16(pc[3]));
      } else {
        oc[0] = round_bf16(mx);
#pragma unroll
        for (int j = 1; j < BLOCK; ++j)
          if (j < n) oc[j] = round_bf16(pc[j]);
      }
    }
  }
  int r[BLOCK];
#pragma unroll
  for (int j = 0; j < BLOCK; ++j) r[j] = (j == 0 || s[j] != s[0]) ? s[j] : S;
  if (L == kVec) {
    *reinterpret_cast<int4*>(sid2 + p0) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < BLOCK; ++j)
      if (j < n) sid2[p0 + j] = r[j];
  }
}

// K8: one thread per (P, C) row, blocks of 4 rows counted from row 0;
// the rows are already divided by T.
__global__ void __launch_bounds__(THREADS) prereduce_rows_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    float* __restrict__ out, int* __restrict__ choice,
    int* __restrict__ sid2, int C, int P, int S) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool in = p < P;
  const int s = in ? sid[p] : 0;
  const int lead = __shfl_sync(full, s, lane & ~(BLOCK - 1));
  const bool leader = (p & (BLOCK - 1)) == 0;
  const bool match = in && s == lead;

  float e[MAXC];
  float z = 0.f;
  if (in) {
    const float* xp = x + p * C;
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        e[c] = xp[c];
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
  const long long NB = ((long long)P + BLOCK - 1) / BLOCK;
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
        // lanes past the last row hold v = -1, which never reaches the
        // max (the leader's own p >= 0 is in it)
        const float mx = fmaxf(fmaxf(v, v1), fmaxf(v2, v3));
        const int ch = v == mx ? 0 : v1 == mx ? 1 : v2 == mx ? 2 : 3;
        choice[(long long)c * NB + p / BLOCK] = ch;
        keep = mx;
      }
      out[(long long)c * P + p] = round_bf16(keep);
    }
  }
  if (in) sid2[p] = (leader || s != lead) ? s : S;
}

template <int NC, Layout L>
int launch_nchw(const float* x, const int* sid, float* out, int* choice,
                int* sid2, int B, int C, int HW, int S, float inv_temp,
                cudaStream_t stream) {
  const int nb = (HW + BLOCK - 1) / BLOCK;
  dim3 grid((nb + THREADS - 1) / THREADS, B);
  prereduce_nchw_kernel<NC, L><<<grid, THREADS, 0, stream>>>(
      x, sid, out, choice, sid2, C, HW, S, inv_temp);
  return (int)cudaGetLastError();
}

bool misaligned(const void* a, const void* b) {
  return ((uintptr_t)a | (uintptr_t)b) % 16 != 0;
}

}  // namespace

// K6 over contiguous (B, C, HW) logits and (B, HW) ids. nc is the class
// instance the wrapper chose (20, or 0 for C at run time); vec asks for
// kVec, which needs HW % 4 == 0 and 16-byte aligned logits, ids, planes
// and sid2.
extern "C" int prereduce_nchw_fwd(const float* x, const int* sid, float* out,
                                  int* choice, int* sid2, int B, int C,
                                  int HW, int S, float inv_temp, int nc,
                                  int vec, cudaStream_t stream) {
  if ((nc != 0 && nc != C) || C > MAXC ||
      (vec && (HW % 4 != 0 || misaligned(x, sid) || misaligned(out, sid2))))
    return (int)cudaErrorInvalidValue;
  if (HW == 0 || B == 0) return 0;
  if (vec)
    return nc == 20 ? launch_nchw<20, kVec>(x, sid, out, choice, sid2, B, C,
                                             HW, S, inv_temp, stream)
                    : launch_nchw<0, kVec>(x, sid, out, choice, sid2, B, C,
                                            HW, S, inv_temp, stream);
  return nc == 20 ? launch_nchw<20, kScalar>(x, sid, out, choice, sid2, B, C,
                                             HW, S, inv_temp, stream)
                  : launch_nchw<0, kScalar>(x, sid, out, choice, sid2, B, C,
                                            HW, S, inv_temp, stream);
}

// K8 over contiguous (P, C) rows already divided by T.
extern "C" int prereduce_rows_fwd(const float* x, const int* sid, float* out,
                                  int* choice, int* sid2, int P, int C, int S,
                                  cudaStream_t stream) {
  if (C > MAXC) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  prereduce_rows_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      x, sid, out, choice, sid2, C, P, S);
  return (int)cudaGetLastError();
}
