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
//       (plbl/cosine_prop.py:129), and behind the pre-reduction (K6, K8)
//       of the sorted group term.
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
// and write 0.3 MB: ~59 MB, ~18 us at 3.35 TB/s. Behind K6 (P = 2,359,296,
// S = 16,384) the retired ids leave about one pixel in ten valid.
//
// Keys. Each value becomes an order-preserving 32-bit key (sign bit
// flipped for positives, all bits flipped for negatives, after -0.0 ->
// +0.0), and the 64-bit word (key << 32) | ~pixel goes into a zeroed
// (S, C) table by atomicMax: the largest value wins, then the smallest
// pixel, exactly and in any order of arrival. Every non-NaN float gives a
// key above 0, so key 0 marks "absent". A decode kernel turns the table
// into (vals, pix).
//
// Design (K3's staged walk, csrc/segment.cu, without the softmax). Each
// block owns a span of SPAN consecutive pixels and walks it 32 pixels a
// warp at a time, the next ids loaded one step ahead. A warp none of whose
// pixels is valid loads no values. With C compiled (20) and 16-byte loads
// the step's values are loaded into registers before its run analysis,
// so the loads are in flight meanwhile. Raster runs are formed over the
// valid pixels only: an invalid pixel is transparent, so the retired
// pixels of K6's blocks do not break a run, and a run's first valid pixel
// claims the run's slot in a direct-mapped shared table of NSLOT slots
// (slot = s mod NSLOT, tag claimed with atomicCAS). The warp stages the
// keys of its valid pixels in shared memory as (class, lane) words; lane
// c then walks class c over the 32 pixels (16-byte shared loads),
// skipping invalid lanes, and at the end of each run merges the run's max
// and first argmax into its slot with a 64-bit shared atomicMax, or
// straight into the global table where another segment holds the slot,
// so the result stays exact whatever the ids. After the span each claimed
// slot goes to the global table with one atomicMax per class. The table
// keeps a segment that covers many warps of a span (a large superpixel)
// from serialising on the same global words: on an H100 it costs ~4% on
// the recipe's data and halves the time where 4 segments cover the image
// (PERF.md). Loads, by layout (the wrapper chooses, the entry point
// refuses a choice the strides or alignment do not allow):
// - kPlanes (ps = 1, cs and P multiples of 4, values 16-byte aligned):
//   a class's 32 values are contiguous, so 8 lanes read them as four
//   16-byte words each and the warp loads 4 classes an instruction; a
//   group of 4 pixels none of which is valid loads nothing.
// - kRows (a contiguous (P, C) array, C a multiple of 4, aligned): each
//   valid lane reads its row as C / 4 16-byte words.
// - kAny: each valid lane reads its C values one by one.
// SPAN and NSLOT come from ops/segment_max.py (K5_SPAN, K5_SLOTS) as -D
// flags. The TPU kernel's sort, padded gather and double-buffered DMA
// walk are not needed.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAXC 128
// SPAN: pixels per block (a multiple of 32); NSLOT: slots of the shared
// table (a power of two). ops/_build.py passes both.
#if !defined(SPAN) || !defined(NSLOT)
#error "build with -DSPAN=... -DNSLOT=... (ops/segment_max.py K5_SPAN, K5_SLOTS)"
#endif
#if SPAN % 32 != 0 || (NSLOT & (NSLOT - 1)) != 0 || NSLOT < 4
#error "SPAN must be a multiple of 32 and NSLOT a power of two >= 4"
#endif
// words between two classes' rows of a warp's staged keys: a multiple of
// 4 for 16-byte accesses, and 4 * 8 lanes cover the 32 banks once
#define STAGE 36
#define EMPTY (-1)  // an unclaimed slot's tag

typedef unsigned long long u64;

namespace {

template <int NC>
struct Cls {
  __device__ __forceinline__ static int n(int c) { return NC > 0 ? NC : c; }
};

enum Layout { kAny, kPlanes, kRows };

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 -> +0.0
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k >> 31) ? (k ^ 0x80000000u) : ~k);
}

size_t smem_bytes(int C) {
  return (size_t)NSLOT * C * 8 + NSLOT * 4 + WARPS * 32 * 4 +
         (size_t)WARPS * C * STAGE * 4;
}

// A warp's values of one step, loaded before the step's run analysis so
// that the loads are in flight meanwhile: with C compiled (NC > 0) and
// 16-byte loads, NV float4 registers a lane. kPlanes: lane = 8 * class
// group + quad, word i holds class (lane >> 3) + 4 i of the lane's quad;
// kRows: word i holds classes 4 i .. 4 i + 3 of the lane's row.
template <int NC, Layout L>
struct StepValues {
  static constexpr bool kHeld = NC > 0 && L != kAny;
  static constexpr int NV = kHeld ? (NC + 3) / 4 : 1;
  float4 v[NV];

  __device__ __forceinline__ void load(const float* __restrict__ values,
                                       long long w0, int lane, unsigned vm,
                                       bool valid, long long ps,
                                       long long cs) {
    if (!kHeld) return;
    if (L == kPlanes) {
      const int q = lane & 7;
      if ((vm >> (4 * q)) & 0xfu) {
        const float* v0 = values + w0 + 4 * q;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (lane >> 3) + 4 * i;
          if (c < NC)
            v[i] = __ldg(
                reinterpret_cast<const float4*>(v0 + (long long)c * cs));
        }
      }
    } else if (valid) {
      const float4* r4 =
          reinterpret_cast<const float4*>(values + (w0 + lane) * ps);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = __ldg(r4 + i);
    }
  }

  // the step's keys into the warp's (class, lane) stage; without held
  // values (kAny, or C at run time) the loads happen here
  __device__ __forceinline__ void stage(unsigned* st,
                                        const float* __restrict__ values,
                                        long long w0, int lane, unsigned vm,
                                        bool valid, int C, long long ps,
                                        long long cs) const {
    if (L == kPlanes) {
      const int q = lane & 7;
      if (!((vm >> (4 * q)) & 0xfu)) return;
      if (kHeld) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (lane >> 3) + 4 * i;
          if (c < NC)
            *reinterpret_cast<uint4*>(st + c * STAGE + 4 * q) =
                make_uint4(order_key(v[i].x), order_key(v[i].y),
                           order_key(v[i].z), order_key(v[i].w));
        }
      } else {
        const float* v0 = values + w0 + 4 * q;
        for (int c = lane >> 3; c < C; c += 4) {
          const float4 f =
              __ldg(reinterpret_cast<const float4*>(v0 + (long long)c * cs));
          *reinterpret_cast<uint4*>(st + c * STAGE + 4 * q) =
              make_uint4(order_key(f.x), order_key(f.y), order_key(f.z),
                         order_key(f.w));
        }
      }
      return;
    }
    if (!valid) return;
    const float* vp = values + (w0 + lane) * ps;
    if (L == kRows) {
      const float4* r4 = reinterpret_cast<const float4*>(vp);
      for (int i = 0; i < C / 4; ++i) {
        float4 f;
        if constexpr (kHeld)
          f = v[i];
        else
          f = __ldg(r4 + i);
        st[(4 * i) * STAGE + lane] = order_key(f.x);
        st[(4 * i + 1) * STAGE + lane] = order_key(f.y);
        st[(4 * i + 2) * STAGE + lane] = order_key(f.z);
        st[(4 * i + 3) * STAGE + lane] = order_key(f.w);
      }
    } else {
      for (int c = 0; c < C; ++c)
        st[c * STAGE + lane] = order_key(__ldg(vp + c * cs));
    }
  }
};

// Shared memory: NSLOT * C keys (slot-major), NSLOT tags, each warp's 32
// ids, and each warp's keys as (C, STAGE) words.
template <int NC, Layout L>
__global__ void __launch_bounds__(THREADS) seg_max_span_kernel(
    const float* __restrict__ values, const int* __restrict__ sid,
    u64* __restrict__ keys, int P, int C_, long long ps, long long cs,
    int S) {
  const int C = Cls<NC>::n(C_);
  extern __shared__ u64 skeys[];
  int* tags = reinterpret_cast<int*>(skeys + NSLOT * C);
  int* sids = tags + NSLOT;
  unsigned* stage = reinterpret_cast<unsigned*>(sids + WARPS * 32);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * SPAN;
  const long long end = min(start + SPAN, (long long)P);
  for (int i = threadIdx.x; i < NSLOT * C; i += THREADS) skeys[i] = 0;
  for (int i = threadIdx.x; i < NSLOT; i += THREADS) tags[i] = EMPTY;
  __syncthreads();

  unsigned* st = stage + warp * C * STAGE;
  int* wsid = sids + warp * 32;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  long long p = start + threadIdx.x;
  int s_next = p < end ? __ldg(sid + p) : S;
  for (; p - lane < end; p += THREADS) {  // warp-uniform
    int s = s_next;
    s_next = p + THREADS < end ? __ldg(sid + p + THREADS) : S;
    const bool valid = s >= 0 && s < S;
    const unsigned vm = __ballot_sync(full, valid);
    if (vm == 0) continue;
    const long long w0 = p - lane;
    StepValues<NC, L> buf;
    buf.load(values, w0, lane, vm, valid, ps, cs);

    // runs over the valid lanes: a valid lane starts a run where the
    // valid lane before it (if any) holds another id, and ends one where
    // the valid lane after it (if any) starts a run
    const unsigned below = vm & lt;
    const int up = __shfl_sync(full, s, below ? 31 - __clz(below) : lane);
    const bool first = valid && (below == 0 || up != s);
    const unsigned starts = __ballot_sync(full, first);
    const unsigned above = vm & ~lt & ~(1u << lane);
    const bool last =
        valid && (above == 0 || ((starts >> (__ffs(above) - 1)) & 1u));
    const unsigned ends = __ballot_sync(full, last);
    bool mine = false;
    if (first) {
      const int t = atomicCAS(&tags[s & (NSLOT - 1)], EMPTY, s);
      mine = t == EMPTY || t == s;
    }
    const unsigned held = __ballot_sync(full, mine);
    wsid[lane] = s;
    buf.stage(st, values, w0, lane, vm, valid, C, ps, cs);
    __syncwarp();
    // lane c walks class c over the warp's valid pixels, 4 per load, and
    // at the end of each run merges its max and first argmax
    for (int c = lane; c < C; c += 32) {
      const uint4* row = reinterpret_cast<const uint4*>(st + c * STAGE);
      unsigned best = 0;
      int arg = 0, head = 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        if (((vm >> (4 * g)) & 0xfu) == 0) continue;
        const uint4 v4 = row[g];
        const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * g + k;
          if (!((vm >> j) & 1u)) continue;
          if ((starts >> j) & 1u) {
            best = v[k];
            arg = head = j;
          } else if (v[k] > best) {
            best = v[k];
            arg = j;
          }
          if ((ends >> j) & 1u) {
            const int sj = wsid[j];
            const u64 key =
                ((u64)best << 32) | (u64)(~(unsigned)(w0 + arg));
            if ((held >> head) & 1u)
              atomicMax(&skeys[(sj & (NSLOT - 1)) * C + c], key);
            else
              atomicMax(&keys[(long long)sj * C + c], key);
          }
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // a slot key is non-zero only where a segment claimed the slot
  for (int i = threadIdx.x; i < NSLOT * C; i += THREADS) {
    const u64 k = skeys[i];
    if (k != 0) atomicMax(&keys[(long long)tags[i / C] * C + i % C], k);
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

template <int NC, Layout L>
int launch_span(const float* values, const int* sid, u64* keys, int P, int C,
                long long ps, long long cs, int S, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        seg_max_span_kernel<NC, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const unsigned blocks = (unsigned)(((long long)P + SPAN - 1) / SPAN);
  seg_max_span_kernel<NC, L><<<blocks, THREADS, smem, stream>>>(
      values, sid, keys, P, C, ps, cs, S);
  return (int)cudaGetLastError();
}

template <Layout L>
int launch_layout(const float* values, const int* sid, u64* keys, int P,
                  int C, long long ps, long long cs, int S,
                  cudaStream_t stream) {
  return C == 20 ? launch_span<20, L>(values, sid, keys, P, C, ps, cs, S,
                                      stream)
                 : launch_span<0, L>(values, sid, keys, P, C, ps, cs, S,
                                     stream);
}

// The layout the wrapper chose (ops/segment_max.py layout): 0 kAny, 1
// kPlanes, 2 kRows; refused where the strides or alignment forbid it.
bool bad_layout(const float* values, int P, int C, long long ps,
                long long cs, int layout) {
  const bool aligned = (uintptr_t)values % 16 == 0;
  if (layout == kPlanes) return !(ps == 1 && cs % 4 == 0 && P % 4 == 0 &&
                                  aligned);
  if (layout == kRows) return !(cs == 1 && ps == C && C % 4 == 0 && aligned);
  return layout != kAny;
}

}  // namespace

extern "C" int seg_max_fwd(const float* values, const int* sid, u64* keys,
                           float* vals, int* pix, int P, int C, long long ps,
                           long long cs, int S, int layout,
                           cudaStream_t stream) {
  if (C < 1 || C > MAXC || bad_layout(values, P, C, ps, cs, layout))
    return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const int err =
        layout == kPlanes
            ? launch_layout<kPlanes>(values, sid, keys, P, C, ps, cs, S,
                                     stream)
        : layout == kRows
            ? launch_layout<kRows>(values, sid, keys, P, C, ps, cs, S, stream)
            : launch_layout<kAny>(values, sid, keys, P, C, ps, cs, S, stream);
    if (err != 0) return err;
  }
  const long long n = (long long)S * C;
  seg_max_decode_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                          0, stream>>>(keys, vals, pix, n, P);
  return (int)cudaGetLastError();
}
