// Segmented statistics over sorted segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segstats.py::segstats_pallas
// (body _segstats_kernel), with the wrapper's empty-segment finalisation
// (src/repro/kernels/ops.py::segstats) folded in.
//
// out[s] = [sum, count, min, max, sumsq, 0, 0, 0] over vals[ids == s], f32.
// ids are int32 and sorted ascending; ids outside [0, S) are sentinels and
// contribute nothing, NaN included.  Empty segments are all zero.  A
// segment that holds a NaN has NaN sum, min, max and sumsq, as in the
// reference's oracle (src/repro/kernels/ref.py::segstats_ref): min and max
// keep NaN, which fminf/fmaxf would drop.
//
// What bounds it on this card: bytes.  Each value is read once (8 bytes
// with its id) and each segment writes 32 bytes; the arithmetic is a few
// adds per value.  The TPU kernel was a one-hot matrix contraction because
// a TPU has no scatter; here the sorted ids make every segment a contiguous
// run, so no one-hot work and no atomics are needed.
//
// The design: one launch, one coalesced pass, no search.  A thread per
// position p in [0, n] reads ids[p] and takes its neighbours' ids by
// shuffle (the warp's edge lanes load theirs), with ids[-1] = -1 and
// ids[n] = S standing in past the ends.  So each thread knows whether p
// heads a run, ends one, and which rows lie empty between ids[p - 1] and
// ids[p]; the n + 1 boundaries cover every empty row exactly once, so the
// zero rows need no second launch.  A warp fills each empty stretch with
// all its lanes.
//
// Runs.  Inside a warp a run ends at the first tail lane at or after its
// head (ballots of heads and tails), so it is at most 32 long and its head
// thread sums it alone, in ascending position.  Only the warp's last run
// can continue past the warp's end: the whole warp then walks on from its
// head 32 positions a step, each lane summing the positions lane, lane +
// 32, ... of the run, until the ids change; a run that proves longer than
// 32 is then reduced by a fixed xor-shuffle tree, a shorter one again by
// its head alone.  So the summation order of a run depends on its length
// and values alone, never on its offset, on n or on the grid: a run gives
// the same bits alone or among other runs, and no float atomics are used.
// Each row is written as two 16-byte stores.
//
// Cost of the rare paths: a long run is reduced by one warp (n / 32
// steps for a run of n); an empty stretch of E rows is written by one warp
// (E / 16 steps).  On the analyze path the ids are dense ranks, so neither
// occurs there.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 32;  // a run this long or shorter: its head alone
constexpr unsigned kFull = 0xffffffffu;

// min and max that keep NaN (fminf/fmaxf drop it), as the reference does
__device__ __forceinline__ float nan_min(float a, float v) {
  return (v != v || v < a) ? v : a;
}
__device__ __forceinline__ float nan_max(float a, float v) {
  return (v != v || v > a) ? v : a;
}

struct Stats {
  float s, q, mn, mx;
};

__device__ __forceinline__ Stats empty_stats() {
  return {0.f, 0.f, CUDART_INF_F, -CUDART_INF_F};
}

__device__ __forceinline__ void add(Stats& a, float v) {
  a.s += v;
  a.q = fmaf(v, v, a.q);
  a.mn = nan_min(a.mn, v);
  a.mx = nan_max(a.mx, v);
}

// [lo, lo + len) summed by one thread in ascending position.
__device__ Stats serial(const float* __restrict__ vals, int64_t lo,
                        int len) {
  Stats a = empty_stats();
  for (int k = 0; k < len; ++k) add(a, __ldg(vals + lo + k));
  return a;
}

__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          int64_t seg, const Stats& a,
                                          int64_t cnt) {
  float4* o = reinterpret_cast<float4*>(out) + 2 * seg;
  o[0] = make_float4(a.s, (float)cnt, a.mn, a.mx);
  o[1] = make_float4(a.q, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ int64_t clamp(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
segstats_kernel(const int32_t* __restrict__ ids,
                const float* __restrict__ vals, int64_t n,
                int32_t num_segments, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t S = num_segments;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cur = p < n ? (int64_t)__ldg(ids + p) : S;
  int64_t prev = __shfl_up_sync(kFull, cur, 1);
  if (lane == 0) prev = p == 0 ? -1 : (p - 1 < n ? __ldg(ids + p - 1) : S);
  int64_t next = __shfl_down_sync(kFull, cur, 1);
  if (lane == 31) next = p + 1 < n ? __ldg(ids + p + 1) : S;

  // the empty rows between ids[p - 1] and ids[p], a stretch at a time
  const int64_t glo = clamp(prev + 1, S), ghi = clamp(cur, S);
  unsigned gaps = __ballot_sync(kFull, p <= n && ghi > glo);
  float4* const rows = reinterpret_cast<float4*>(out);
  while (gaps) {
    const int src = __ffs(gaps) - 1;
    gaps &= gaps - 1;
    const int64_t lo = __shfl_sync(kFull, glo, src);
    const int64_t hi = __shfl_sync(kFull, ghi, src);
    for (int64_t r = 2 * lo + lane; r < 2 * hi; r += 32)
      rows[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // runs that end inside the warp: each head alone
  const bool live = p < n && cur >= 0 && cur < S;
  const unsigned heads = __ballot_sync(kFull, live && cur != prev);
  const unsigned tails = __ballot_sync(kFull, live && cur != next);
  const unsigned ends_after = tails & ~((1u << lane) - 1);
  if (live && cur != prev && ends_after) {
    const int len = __ffs(ends_after) - lane;
    store_row(out, cur, serial(vals, p, len), len);
  }
  if (!heads) return;  // uniform across the warp

  // the warp's last run, if it continues past the warp: the whole warp
  const int hl = 31 - __clz(heads);
  if (tails >> hl) return;
  const int64_t lo = __shfl_sync(kFull, p, hl);
  const int64_t run = __shfl_sync(kFull, cur, hl);
  Stats a = empty_stats();
  int64_t hi;
  for (int64_t k = lo;; k += 32) {
    const int64_t i = k + lane;
    const bool in = i < n && __ldg(ids + i) == run;
    const unsigned m = __ballot_sync(kFull, in);  // a prefix of the lanes
    if (in) add(a, __ldg(vals + i));
    if (m != kFull) {
      hi = k + __popc(m);
      break;
    }
  }
  const int64_t len = hi - lo;
  if (len <= kShort) {
    if (lane == hl) store_row(out, run, serial(vals, lo, (int)len), len);
    return;
  }
  for (int off = 16; off > 0; off >>= 1) {
    a.s += __shfl_xor_sync(kFull, a.s, off);
    a.q += __shfl_xor_sync(kFull, a.q, off);
    a.mn = nan_min(a.mn, __shfl_xor_sync(kFull, a.mn, off));
    a.mx = nan_max(a.mx, __shfl_xor_sync(kFull, a.mx, off));
  }
  if (lane == 0) store_row(out, run, a, len);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  One
// thread per boundary 0..n, so n = 0 still writes the S empty rows.
extern "C" int segstats_f32(const int32_t* ids, const float* vals, int64_t n,
                            int32_t num_segments, float* out, void* stream) {
  if (num_segments > 0) {
    const int64_t blocks = n / kThreads + 1;
    segstats_kernel<<<(unsigned)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(ids, vals, n, num_segments, out);
  }
  return (int)cudaGetLastError();
}
