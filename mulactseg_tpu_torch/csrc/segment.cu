// Group (MIL) term of the stage-1 lossdecomp loss: per-(segment, class)
// max of softmax(x / T) with its first argmax pixel (K3), and the sparse
// backward through it (K4), over NCHW logits viewed as (B, C, HW); and
// K3's function over pre-scaled (P, C) rows (K7).
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
// the max and writes dl = (d - (sum_c d) * p) / T, where d holds g*max at
// each argmax (pixel, class) with g != 0, and 0 elsewhere.
//
// K4's precondition: every live entry's pixel lies in its own segment,
// sid[pix[s, c]] == s wherever pix[s, c] < P. K3 keys only valid pixels of
// s; the pre-reduced term's winner (ops/segment.py _ssm_prereduced,
// csrc/prereduce.cu) is a block member that shares its leader's id. So
// both forward branches meet it, and a pixel's entries all sit in the row
// of its own segment. ops/segment.py ssm_bwd_plain keeps the dense form,
// which holds on any input.
//
// What bounds them on an H100: bytes. At the recipe shapes (B 4, C 20,
// 768^2, S 8192) K3 needs the 9.4 MB of segment ids, the logits of the
// valid (multi-hot) pixels only (about 40% of the 189 MB on the recipe's
// data) and the 1.3 MB (S, C) key table: ~0.026 ms at 3.35 TB/s. K4 needs
// its 189 MB dl write, the three (S, C) tables and the logits of the
// pixels that carry a coefficient (~7%): ~0.057 ms.
//
// Both kernels take the class count as a template parameter for the
// stage-1 model's 20 outputs (any other C <= 32 takes a run-time
// instance), so a pixel's C loads are issued back to back and its softmax
// stays in registers. p_c = exp(x_c / T - max) * (1 / sum):
// one exp per class and one reciprocal, the same arithmetic in K3 and K4.
//
// K3 design. Each block owns a span of SPAN consecutive pixels of one
// image (grid (spans, B)) and walks it 32 pixels a warp at a time, the
// next ids loaded one step ahead. A pixel's class value is the 64-bit key
// (float_bits(p) << 32) | ~pixel: p >= 0, so its bits order like its
// value, and ~pixel makes ties go to the lowest raster index; the max of
// the keys is then exactly "max, first argmax" under any order of
// merging, and a 0.0 probability still beats the zero init. One ballot
// marks where the warp's raster runs start. The warp stages its values in
// shared memory as (class, lane) words; lane c then walks class c over
// the 32 pixels (16-byte loads) and at the end of each run has the run's
// max and first argmax, with no shuffle per class. It merges them into a
// direct-mapped shared table of NSLOT slots (slot = s mod NSLOT, its tag
// claimed once per run with atomicCAS, a 64-bit shared atomicMax). A run
// whose slot another segment holds sends its keys straight to the global
// table, so the result stays exact whatever the ids are. After the span,
// each non-zero slot key goes to the global (S, C) table with one
// atomicMax: one global atomic per (span, segment, class) instead of one
// per raster run and class. A decode kernel turns the table into (vals,
// pix). SPAN and NSLOT come from ops/segment.py (K3_SPAN, K3_SLOTS) as
// -D flags: the fastest of the spans (256 to 8192) and slot counts timed
// on an H100 (PERF.md); global atomics proved cheap (the first K3
// without them was 5% faster), so a short span that keeps more blocks in
// flight beats a long one that merges more. The TPU
// kernel's doubling-scan run merge, SMEM jump walk, -1 init and S <= 9216
// VMEM guard are not needed.
//
// K4 design. One thread per pixel gathers by its segment id instead of
// scattering into a dense buffer: it reads s = sid[p] and, for a valid s,
// the row pix[s, :] (a warp's lanes mostly share s, so the row comes from
// L1), reads g and vals only where pix[s, c] == p, and only where some
// coefficient is non-zero reads the pixel's logits to recompute the
// softmax. It writes dl once, one coalesced streaming store per class
// plane, with the dense form's arithmetic (sum in class order), so the
// result does not depend on the design.
//
// K7 design (ssm_rows_fwd, over (P, C) rows that the caller has already
// divided by T): K3's span walk over the valid rows only. At (2,359,296,
// 20) rows it must read the 9.4 MB of ids, the rows of the valid
// (multi-hot) pixels (about 40% of 189 MB) and the 2.6 MB key table:
// ~0.027 ms. Its arithmetic is the first K7's: each value rounded to bf16
// (the TPU path feeds its kernel bf16 rows, mulactseg_tpu/ops/segment.py:
// 394), the max, expf, the sum in class order and the true division e / z
// (segment_pallas.py:172-176), heavier than K3's, so with all 32 lanes of
// a warp computing whatever share of its rows is valid, the arithmetic,
// not the bytes, set the time (a K3-shaped walk over all rows took 0.12 ms
// on an H100, PERF.md). So each block owns a span of
// ROWS_SPAN rows and each warp a contiguous share of it; the warp reads
// its ids 32 at a time (two chunks ahead), appends its valid rows to a
// queue in shared memory (a ballot and a popcount give each its place)
// and takes 32 valid rows a step. Each lane loads its own row as units,
// 16-byte ones where C % 4 == 0 and the rows are 16-byte aligned (5
// float4s at C = 20), else 4-byte ones, in flight during the run
// analysis; only valid rows are read. Runs are formed over the queued
// rows, so an invalid row does not end a run. Then K3's pieces: the run
// heads claim slots of a direct-mapped shared table of 64-bit keys
// ((float_bits(p) << 32) | ~row), the values go to the warp's (class,
// lane) stage, lane c walks class c at the end of each run (the key takes
// the row from the queue), a run whose slot another id holds goes
// straight to the global table, and the slots are flushed after the span.
// ROWS_SPAN and ROWS_NSLOT come from ops/segment.py (K7_SPAN, K7_SLOTS),
// chosen by a grid timed on an H100. The values and keys are bitwise the
// first design's, whose one thread per row merged each class across the
// warp by 64-bit shuffles and issued one global atomicMax per run and
// class (0.2253 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define MAXC 32
#define THREADS 256
#define WARPS (THREADS / 32)
// SPAN: pixels of one image per K3 block (a multiple of 32); NSLOT: slots
// of K3's shared table (a power of two). ROWS_SPAN and ROWS_NSLOT: the
// same for K7. ops/_build.py passes all four.
#if !defined(SPAN) || !defined(NSLOT)
#error "build with -DSPAN=... -DNSLOT=... (ops/segment.py K3_SPAN, K3_SLOTS)"
#endif
#if !defined(ROWS_SPAN) || !defined(ROWS_NSLOT)
#error "build with -DROWS_SPAN=... -DROWS_NSLOT=... (ops/segment.py K7_SPAN, K7_SLOTS)"
#endif
#if ROWS_SPAN % (32 * WARPS) != 0 || \
    (ROWS_NSLOT & (ROWS_NSLOT - 1)) != 0 || ROWS_NSLOT < 4
#error "ROWS_SPAN must be a multiple of 256 and ROWS_NSLOT a power of two >= 4"
#endif
// words between two classes' rows of a warp's staged values: a multiple
// of 4 for 16-byte loads, and 4 * 8 lanes cover the 32 banks once
#define STAGE 36
#define EMPTY (-1)  // an unclaimed slot's tag

typedef unsigned long long u64;

namespace {

// Classes known at compile time (NC > 0) or at run time (NC == 0, C <=
// MAXC): per-class registers and loops are sized by kMax.
template <int NC>
struct Cls {
  static constexpr int kMax = NC > 0 ? NC : MAXC;
  __device__ __forceinline__ static int n(int c) { return NC > 0 ? NC : c; }
};

// Softmax of x / T at one pixel whose C classes lie `stride` floats apart.
template <int NC>
__device__ __forceinline__ void softmax_at(const float* __restrict__ xp,
                                           int stride, int C, float inv_temp,
                                           float (&p)[Cls<NC>::kMax]) {
  float m = -INFINITY, z = 0.f;
#pragma unroll
  for (int c = 0; c < Cls<NC>::kMax; ++c) {
    if (c < C) {
      p[c] = __ldg(xp + c * stride) * inv_temp;
      m = fmaxf(m, p[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < Cls<NC>::kMax; ++c) {
    if (c < C) {
      p[c] = expf(p[c] - m);
      z += p[c];
    }
  }
  const float rz = 1.f / z;
#pragma unroll
  for (int c = 0; c < Cls<NC>::kMax; ++c) {
    if (c < C) p[c] *= rz;
  }
}

constexpr int span_smem_bytes(int C) {
  return NSLOT * C * 8 + NSLOT * 4 + WARPS * 32 * 4 + WARPS * C * STAGE * 4;
}

// The span walk of K3 and K7, in pieces. NS is the slot count of the
// block's shared table: NS * C keys (slot-major) and NS tags.
template <int NS>
__device__ __forceinline__ void clear_slots(u64* skeys, int* tags, int C) {
  for (int i = threadIdx.x; i < NS * C; i += THREADS) skeys[i] = 0;
  for (int i = threadIdx.x; i < NS; i += THREADS) tags[i] = EMPTY;
}

// The raster runs of a warp's 32 pixels or rows (s = -1 where invalid):
// returns `starts`, whose bit j marks lane j as the first of a run; each
// valid run's first lane claims its run's slot (slot = s mod NS, tag by
// atomicCAS), and bit j of `held` says that lane j's run holds it.
template <int NS>
__device__ __forceinline__ unsigned claim_runs(int s, bool valid, int lane,
                                               int* tags, unsigned& held) {
  const unsigned full = 0xffffffffu;
  const int up = __shfl_up_sync(full, s, 1);
  const unsigned starts = __ballot_sync(full, lane == 0 || up != s);
  bool mine = false;
  if (valid && ((starts >> lane) & 1u)) {
    const int t = atomicCAS(&tags[s & (NS - 1)], EMPTY, s);
    mine = t == EMPTY || t == s;
  }
  held = __ballot_sync(full, mine);
  return starts;
}

// Lane c walks class c over the warp's 32 staged values (st: (C, STAGE)
// words, 4 per load; wsid: the 32 ids) and at the end of each valid run
// merges its max and first argmax (global index w0 + lane, or wrow[lane]
// where the warp's rows are not consecutive) into the run's slot, or
// straight into the global table where another id holds the slot, so the
// result stays exact whatever the ids are.
template <int NS>
__device__ __forceinline__ void walk_runs(const unsigned* st, const int* wsid,
                                          unsigned starts, unsigned held,
                                          unsigned w0, int lane, int C,
                                          u64* skeys, u64* keys,
                                          const int* wrow = nullptr) {
  if (lane >= C) return;
  const uint4* row = reinterpret_cast<const uint4*>(st + lane * STAGE);
  unsigned best = 0;
  int arg = 0, first = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v4 = row[q];
    const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      if ((starts >> j) & 1u) {
        best = v[k];
        arg = first = j;
      } else if (v[k] > best) {
        best = v[k];
        arg = j;
      }
      if (j == 31 || ((starts >> (j + 1)) & 1u)) {
        const int sj = wsid[j];
        if (sj >= 0) {
          const unsigned at =
              wrow ? (unsigned)wrow[arg] : w0 + (unsigned)arg;
          const u64 key = ((u64)best << 32) | (u64)(~at);
          if ((held >> first) & 1u)
            atomicMax(&skeys[(sj & (NS - 1)) * C + lane], key);
          else
            atomicMax(&keys[(long long)sj * C + lane], key);
        }
      }
    }
  }
}

// After the span: a slot key is non-zero only where a segment claimed the
// slot; each goes to the global table with one atomicMax.
template <int NS>
__device__ __forceinline__ void flush_slots(const u64* skeys, const int* tags,
                                            u64* keys, int C) {
  for (int i = threadIdx.x; i < NS * C; i += THREADS) {
    const u64 k = skeys[i];
    if (k != 0) atomicMax(&keys[(long long)tags[i / C] * C + i % C], k);
  }
}

// K3. Shared memory: NSLOT * C keys (slot-major), NSLOT tags, each warp's
// 32 ids, and each warp's values as (C, STAGE) words.
template <int NC>
__global__ void __launch_bounds__(THREADS) ssm_span_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    u64* __restrict__ keys, int C_, int HW, int S, float inv_temp) {
  constexpr int K = Cls<NC>::kMax;
  const int C = Cls<NC>::n(C_);
  extern __shared__ u64 skeys[];
  int* tags = reinterpret_cast<int*>(skeys + NSLOT * C);
  int* sids = tags + NSLOT;
  unsigned* stage = reinterpret_cast<unsigned*>(sids + WARPS * 32);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int start = blockIdx.x * SPAN;
  const int end = min(start + SPAN, HW);
  clear_slots<NSLOT>(skeys, tags, C);
  __syncthreads();

  const float* xb = x + (long long)b * C * HW;
  const int* sb = sid + (long long)b * HW;
  const unsigned pb = (unsigned)b * (unsigned)HW;  // P < 2^31
  unsigned* st = stage + warp * C * STAGE;
  int hw = start + threadIdx.x;
  int s_next = hw < end ? __ldg(sb + hw) : S;
  for (; hw - lane < end; hw += THREADS) {  // warp-uniform
    int s = s_next;
    s_next = hw + THREADS < end ? __ldg(sb + hw + THREADS) : S;
    const bool valid = s >= 0 && s < S;
    if (!__any_sync(full, valid)) continue;
    if (!valid) s = -1;
    float p[K];
    if (valid) softmax_at<NC>(xb + hw, HW, C, inv_temp, p);

    // raster runs and slot claims, then the values as (class, lane) words
    const unsigned w0 = pb + (unsigned)(hw - lane);
    unsigned held;
    const unsigned starts = claim_runs<NSLOT>(s, valid, lane, tags, held);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < C) st[c * STAGE + lane] = valid ? __float_as_uint(p[c]) : 0u;
    }
    sids[warp * 32 + lane] = s;
    __syncwarp();
    walk_runs<NSLOT>(st, sids + warp * 32, starts, held, w0, lane, C, skeys,
                     keys);
    __syncwarp();
  }
  __syncthreads();
  flush_slots<NSLOT>(skeys, tags, keys, C);
}

// K7's shared memory: ROWS_NSLOT * C keys (slot-major), ROWS_NSLOT tags,
// and a warp's ids and rows of a step (32 each), its queue (64 ids, 64
// rows) and its (C, STAGE) stage words (16-byte aligned: ROWS_NSLOT is a
// multiple of 4).
#define QUEUE 64
#define ROWS_WARP_INTS (32 + 32 + 2 * QUEUE)

constexpr int rows_smem_bytes(int C) {
  return ROWS_NSLOT * C * 8 + ROWS_NSLOT * 4 + WARPS * ROWS_WARP_INTS * 4 +
         WARPS * C * STAGE * 4;
}

template <int NC, bool kWide>
__global__ void __launch_bounds__(THREADS) ssm_rows_span_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    u64* __restrict__ keys, int P, int C_, int S) {
  typedef Unit<kWide> Un;
  typedef typename Un::T U;
  constexpr int F = Un::kFloats;
  constexpr int K = Cls<NC>::kMax;
  constexpr int KU = (K + F - 1) / F;  // units a row, at most
  const int C = Cls<NC>::n(C_);
  const int W = C / F;  // units a row
  extern __shared__ u64 skeys[];
  int* tags = reinterpret_cast<int*>(skeys + ROWS_NSLOT * C);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  int* wsid = tags + ROWS_NSLOT + warp * ROWS_WARP_INTS;
  int* wrow = wsid + 32;
  int* qsid = wrow + 32;
  int* qrow = qsid + QUEUE;
  unsigned* st = reinterpret_cast<unsigned*>(tags + ROWS_NSLOT +
                                             WARPS * ROWS_WARP_INTS) +
                 warp * C * STAGE;
  // the warp's share of the block's span
  const int start = blockIdx.x * ROWS_SPAN + warp * (ROWS_SPAN / WARPS);
  const int end = min(start + ROWS_SPAN / WARPS, P);
  clear_slots<ROWS_NSLOT>(skeys, tags, C);
  __syncthreads();

  int next = start;         // the next chunk of 32 ids, loaded two ahead
  int head = 0, count = 0;  // the queue of valid rows (warp-uniform)
  int s1 = next + lane < end ? __ldg(sid + next + lane) : S;
  int s2 = next + 32 + lane < end ? __ldg(sid + next + 32 + lane) : S;
  while (true) {
    // queue valid rows until a step's worth is there or the share ends
    while (count < 32 && next < end) {
      const int s = s1, r = next + lane;
      s1 = s2;
      next += 32;
      s2 = next + 32 + lane < end ? __ldg(sid + next + 32 + lane) : S;
      const bool valid = s >= 0 && s < S;
      const unsigned vm = __ballot_sync(full, valid);
      if (valid) {
        const int at = (head + count + __popc(vm & lt)) % QUEUE;
        qsid[at] = s;
        qrow[at] = r;
      }
      count += __popc(vm);
    }
    if (count == 0) break;
    __syncwarp();
    const int n = min(count, 32);
    const bool valid = lane < n;
    int s = -1, row = 0;
    if (valid) {
      s = qsid[(head + lane) % QUEUE];
      row = qrow[(head + lane) % QUEUE];
    }
    head = (head + n) % QUEUE;
    count -= n;
    // the lane's row, in flight during the run analysis
    U h[KU];
    if (valid) {
      const U* xr = reinterpret_cast<const U*>(x + (long long)row * C);
#pragma unroll
      for (int i = 0; i < KU; ++i) {
        if (i < W) h[i] = __ldg(xr + i);
      }
    }
    unsigned held;
    const unsigned starts =
        claim_runs<ROWS_NSLOT>(s, valid, lane, tags, held);
    // bf16, max, expf and the sum in class order, then e / z
    float e[K];
    float z = 0.f;
    if (valid) {
      float f[F];
#pragma unroll
      for (int i = 0; i < KU; ++i) {
        if (i < W) {
          Un::get(h[i], f);
#pragma unroll
          for (int q = 0; q < F; ++q) e[F * i + q] = f[q];
        }
      }
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (c < C) {
          e[c] = round_bf16(e[c]);
          m = fmaxf(m, e[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (c < C) {
          e[c] = expf(e[c] - m);
          z += e[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < C)
        st[c * STAGE + lane] = valid ? __float_as_uint(e[c] / z) : 0u;
    }
    wsid[lane] = s;
    wrow[lane] = row;
    __syncwarp();
    walk_runs<ROWS_NSLOT>(st, wsid, starts, held, 0u, lane, C, skeys, keys,
                          wrow);
    __syncwarp();
  }
  __syncthreads();
  flush_slots<ROWS_NSLOT>(skeys, tags, keys, C);
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

// The row pix[s, 0..C) of argmax pixels: 16-byte loads where C is a
// compile-time multiple of 4 (the wrapper checks that pix is 16-byte
// aligned), else one load per class.
template <int NC>
__device__ __forceinline__ void load_row(const int* __restrict__ row, int C,
                                         int (&q)[Cls<NC>::kMax]) {
  if constexpr (NC > 0 && NC % 4 == 0) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int i = 0; i < Cls<NC>::kMax / 4; ++i) {
      const int4 v = __ldg(r4 + i);
      q[4 * i] = v.x;
      q[4 * i + 1] = v.y;
      q[4 * i + 2] = v.z;
      q[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < Cls<NC>::kMax; ++c) {
      if (c < C) q[c] = __ldg(row + c);
    }
  }
}

// K4: grid (pixel blocks, B), one thread per pixel. dl is written once
// and never read here, so its stores stream past the caches (st.global.cs).
template <int NC>
__global__ void __launch_bounds__(THREADS) ssm_bwd_kernel(
    const float* __restrict__ x, const int* __restrict__ sid,
    const float* __restrict__ vals, const int* __restrict__ pix,
    const float* __restrict__ g, float* __restrict__ dl, int C_, int HW,
    int S, float inv_temp) {
  constexpr int K = Cls<NC>::kMax;
  const int C = Cls<NC>::n(C_);
  const int hw = blockIdx.x * THREADS + threadIdx.x;
  if (hw >= HW) return;
  const int b = blockIdx.y;
  const int p = b * HW + hw;  // P < 2^31
  const long long at = (long long)b * C * HW + hw;
  const int s = __ldg(sid + p);
  const bool valid = s >= 0 && s < S;
  const long long row = valid ? (long long)s * C : 0;
  unsigned hit = 0;
  if (valid) {
    int q[K];
    load_row<NC>(pix + row, C, q);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < C && q[c] == p) hit |= 1u << c;
    }
  }
  float d[K];
  float w = 0.f;
  bool any = false;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) {
      d[c] = 0.f;
      if ((hit >> c) & 1u) {
        const float gc = __ldg(g + row + c);
        if (gc != 0.f) d[c] = gc * __ldg(vals + row + c);
      }
      w += d[c];
      any = any || d[c] != 0.f;
    }
  }
  float* out = dl + at;
  if (!any) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < C) __stcs(out + c * HW, 0.f);
    }
    return;
  }
  float pr[K];
  softmax_at<NC>(x + at, HW, C, inv_temp, pr);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (c < C) __stcs(out + c * HW, (d[c] - w * pr[c]) * inv_temp);
  }
}

template <int NC>
int launch_span(const float* x, const int* sid, u64* keys, int B, int C,
                int HW, int S, float inv_temp, cudaStream_t stream) {
  const int smem = span_smem_bytes(C);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        ssm_span_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  dim3 grid((HW + SPAN - 1) / SPAN, B);
  ssm_span_kernel<NC><<<grid, THREADS, smem, stream>>>(x, sid, keys, C, HW,
                                                        S, inv_temp);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bwd(const float* x, const int* sid, const float* vals,
               const int* pix, const float* g, float* dl, int B, int C,
               int HW, int S, float inv_temp, cudaStream_t stream) {
  dim3 grid((HW + THREADS - 1) / THREADS, B);
  ssm_bwd_kernel<NC><<<grid, THREADS, 0, stream>>>(x, sid, vals, pix, g, dl,
                                                    C, HW, S, inv_temp);
  return (int)cudaGetLastError();
}

template <int NC, bool kWide>
int launch_rows_span(const float* x, const int* sid, u64* keys, int P, int C,
                     int S, cudaStream_t stream) {
  const int smem = rows_smem_bytes(C);
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        ssm_rows_span_kernel<NC, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const unsigned blocks =
      (unsigned)(((long long)P + ROWS_SPAN - 1) / ROWS_SPAN);
  ssm_rows_span_kernel<NC, kWide><<<blocks, THREADS, smem, stream>>>(
      x, sid, keys, P, C, S);
  return (int)cudaGetLastError();
}

int launch_decode(const u64* keys, float* vals, int* pix, int S, int C,
                  int P, cudaStream_t stream) {
  long long n = (long long)S * C;
  ssm_decode_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(keys, vals, pix, n, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssm_fwd(const float* x, const int* sid, u64* keys, float* vals,
                       int* pix, int B, int C, int HW, int S, float inv_temp,
                       cudaStream_t stream) {
  if (HW > 0) {
    const int err =
        C == 20 ? launch_span<20>(x, sid, keys, B, C, HW, S, inv_temp, stream)
                : launch_span<0>(x, sid, keys, B, C, HW, S, inv_temp, stream);
    if (err != 0) return err;
  }
  return launch_decode(keys, vals, pix, S, C, B * HW, stream);
}

// K7: nc = 20 (C == 20 compiled) or 0 (C at run time); wide asks for
// 16-byte units, which need C % 4 == 0 and 16-byte aligned rows (the
// wrapper checks; a choice they forbid is refused).
extern "C" int ssm_rows_fwd(const float* x, const int* sid, u64* keys,
                            float* vals, int* pix, int P, int C, int S,
                            int nc, int wide, cudaStream_t stream) {
  if ((nc != 0 && nc != C) || C < 1 || C > MAXC ||
      (wide && (C % 4 != 0 || (uintptr_t)x % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const int err =
        wide ? (nc == 20 ? launch_rows_span<20, true>(x, sid, keys, P, C, S,
                                                       stream)
                         : launch_rows_span<0, true>(x, sid, keys, P, C, S,
                                                      stream))
             : (nc == 20 ? launch_rows_span<20, false>(x, sid, keys, P, C, S,
                                                        stream)
                         : launch_rows_span<0, false>(x, sid, keys, P, C, S,
                                                       stream));
    if (err != 0) return err;
  }
  return launch_decode(keys, vals, pix, S, C, P, stream);
}

extern "C" int ssm_bwd(const float* x, const int* sid, const float* vals,
                       const int* pix, const float* g, float* dl, int B,
                       int C, int HW, int S, float inv_temp,
                       cudaStream_t stream) {
  if (HW == 0) return 0;
  return C == 20 ? launch_bwd<20>(x, sid, vals, pix, g, dl, B, C, HW, S,
                                  inv_temp, stream)
                 : launch_bwd<0>(x, sid, vals, pix, g, dl, B, C, HW, S,
                                 inv_temp, stream);
}
