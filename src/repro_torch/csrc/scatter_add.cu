// Scatter-add and its histogram, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scatter_add.py::
// scatter_add_pallas (body _scatter_kernel) and its wrappers
// src/repro/kernels/ops.py::scatter_add and ::histogram.
//
// histogram: counts[s] = #{i : ids[i] == s} as int64, ids int32 or int64,
//   ids outside [0, S) dropped.  Integer atomicAdd is exact and its result
//   does not depend on the order the adds land in, so the count needs no
//   f32 exactness guard.  One launch, which zeroes the counts behind a
//   barrier, reads the ids in 16-byte loads and adds each run of equal
//   neighbouring ids once (see "The histogram" below).
//
// scatter-add: out[s, :] = sum of vals[i, :] over ids[i] == s, f32, with
//   every segment's rows added in ascending row order, so the result never
//   depends on the launch, on timing or on the rows of other segments, and
//   no float atomics are used.  Three steps, each the port's own kernels:
//
//   1. A stable LSD radix sort of (key, row), key = id for an id in [0, S)
//      and S otherwise, over the ceil(log2(S + 1)) bits the keys use, 9
//      bits a pass (two passes at S = 196,049).  A pass is radix_count (a
//      block counts the digits of its tile of 2,048 rows into its row of a
//      (tiles, 512) table), a scan down the table's columns (the caller
//      runs blockscan's int32 kernel on it), and radix_scatter: a block
//      takes each digit's start from its own row of the scanned table less
//      its counts and a scan over the digits of the table's last row,
//      ranks each row of
//      its tile among the rows with the same digit before it (a ballot
//      per digit bit and __popc within a warp, plus the counts of the
//      warp's earlier rows and of the tile's earlier warps), stages the
//      tile in shared memory in digit order and writes each digit's rows
//      out as one run.  Stability keeps each segment's rows in ascending
//      order.
//   2. seg_bounds: a thread per boundary of the sorted keys writes the
//      start offset of every segment that begins there, empty ones
//      included, from its neighbours' keys: off[s] for s in (key[p - 1],
//      key[p]] is p.  No search, no count.
//   3. The reduce, in an order that is a function of the segment's rows
//      alone: a segment of at most kChunk rows is added by one thread per
//      column in ascending order; a longer one in chunks of kChunk rows
//      from its start, seg_chunks adding chunks 1, 2, ... in parallel and
//      seg_sums adding chunk 0 and then the chunk sums in chunk order.
//      Columns go to a team of min(M, 32) threads, so for M >= 32 each
//      row is read coalesced.
//
// What bounds it on this card: bytes.  The least a scatter-add moves is
// its ids, its values and its output once; the sort adds two reads and
// two writes of 8 bytes a row a pass.  The TPU kernel was a one-hot matrix
// contraction because a TPU has no scatter unit; the sort takes its place
// here because float atomics would make the sums depend on timing.
//
// Limits (the wrapper checks them): n < 2^31 rows and S < 2^31 segments,
// so keys, rows and offsets fit in 32 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // rows a thread, a pass
constexpr int kTile = kThreads * kItems;       // rows a radix tile
constexpr int kWarpRows = 32 * kItems;         // rows a warp, a pass
constexpr int kMaxBits = 9;                    // digit bits a pass
constexpr int kMaxBuckets = 1 << kMaxBits;
constexpr int kChunk = 128;                    // rows a reduce chunk
constexpr int kCols = 4;                       // columns a reduce thread
static_assert(kMaxBuckets == 2 * kThreads, "a thread owns two digits");
constexpr unsigned kFull = 0xffffffffu;

// The sort key of an id: itself in [0, S), else S.  Keys of a later pass
// (uint32, already in [0, S]) map to themselves.
template <typename I>
__device__ __forceinline__ uint32_t key_of(I id, int64_t S) {
  const int64_t v = (int64_t)id;
  return (uint32_t)(v >= 0 && v < S ? v : S);
}

// table[t * buckets + d] = the rows of tile t with digit d: a (tiles,
// buckets) array, written a row a block, so every store is coalesced.
template <typename I>
__global__ void __launch_bounds__(kThreads)
radix_count(const I* __restrict__ keys, int64_t n, int64_t S, int shift,
            int bits, int32_t* __restrict__ table) {
  __shared__ int hist[kMaxBuckets];
  const int buckets = 1 << bits;
  for (int d = threadIdx.x; d < buckets; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = start + j * kThreads + threadIdx.x;
    if (i < n) atomicAdd(hist + ((key_of(keys[i], S) >> shift) &
                                 (buckets - 1)), 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < buckets; d += kThreads)
    table[(int64_t)blockIdx.x * buckets + d] = hist[d];
}

// The lanes of `valid` whose digit equals this lane's: one ballot a bit
// (the hardware's match.any is slower for 9-bit digits).  Every lane of
// the warp calls it.
__device__ __forceinline__ unsigned match_digit(uint32_t d, int bits,
                                                unsigned valid) {
  unsigned peers = valid;
  for (int b = 0; b < bits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Warp w of a tile takes its rows [w * kWarpRows, (w + 1) * kWarpRows) in
// kItems steps of 32, so (warp, step, lane) is the rows' order.  A row's
// place in the tile's digit-sorted order is its digit's start in the tile,
// plus the rows of that digit in earlier warps, plus those before it in
// its warp; the tile is staged in that order in shared memory and written
// out from there, so each digit's rows go out as one run of consecutive
// addresses.  scanned is the count table scanned down its columns: row t
// holds each digit's rows in tiles 0..t, the last row its rows in all.
template <typename I>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const I* __restrict__ keys, const int32_t* __restrict__ rows,
              int64_t n, int64_t S, int shift, int bits, int tiles,
              const int32_t* __restrict__ scanned,
              uint32_t* __restrict__ keys_out, int32_t* __restrict__ rows_out) {
  __shared__ int base[kWarps][kMaxBuckets];  // per warp and digit
  __shared__ int out_at[kMaxBuckets];        // digit's output less its start
  __shared__ int2 warp_sum[kWarps];
  __shared__ uint32_t tile_keys[kTile];
  __shared__ int32_t tile_rows[kTile];
  const int buckets = 1 << bits, mask = buckets - 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < kMaxBuckets; d += kThreads)
#pragma unroll
    for (int g = 0; g < kWarps; ++g) base[g][d] = 0;
  __syncthreads();

  const int64_t tile = (int64_t)blockIdx.x * kTile;
  const int64_t start = tile + w * kWarpRows;
  const unsigned lower = (1u << lane) - 1;
  uint32_t key[kItems];
  int32_t row[kItems];
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = start + j * 32 + lane;
    const bool valid = i < n;
    key[j] = valid ? key_of(keys[i], S) : 0;
    row[j] = valid ? (rows ? rows[i] : (int32_t)i) : 0;
    const uint32_t d = (key[j] >> shift) & mask;
    const unsigned peers = match_digit(d, bits, __ballot_sync(kFull, valid));
    const int before = valid ? base[w][d] : 0;
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      base[w][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // thread t owns digits 2t and 2t + 1: its warps' counts become offsets
  // within the digit; then one block scan over the digits of the tile's
  // counts gives each digit's start in the tile, and of the digits' counts
  // in all tiles each digit's start in the output
  int total[2], before[2], all[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = 2 * threadIdx.x + k;
    int run = 0;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) {
      const int c = base[g][d];
      base[g][d] = run;
      run += c;
    }
    total[k] = run;
    const bool used = d < buckets;
    before[k] = used ? scanned[(int64_t)blockIdx.x * buckets + d] - run : 0;
    all[k] = used ? scanned[(int64_t)(tiles - 1) * buckets + d] : 0;
  }
  int2 incl = make_int2(total[0] + total[1], all[0] + all[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl.x, off);
    const int y = __shfl_up_sync(kFull, incl.y, off);
    if (lane >= off) incl.x += x, incl.y += y;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  int first = incl.x - total[0] - total[1];
  int out_first = incl.y - all[0] - all[1];
  for (int g = 0; g < w; ++g) first += warp_sum[g].x, out_first += warp_sum[g].y;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = 2 * threadIdx.x + k;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) base[g][d] += first;
    out_at[d] = out_first + before[k] - first;
    first += total[k];
    out_first += all[k];
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (start + j * 32 + lane < n) {
      const int at = base[w][(key[j] >> shift) & mask] + rank[j];
      tile_keys[at] = key[j];
      tile_rows[at] = row[j];
    }
  }
  __syncthreads();
  const int64_t left = n - tile;
  const int here = left < kTile ? (int)left : kTile;
  for (int k = threadIdx.x; k < here; k += kThreads) {
    const uint32_t kk = tile_keys[k];
    const int at = out_at[(kk >> shift) & mask] + k;
    keys_out[at] = kk;
    rows_out[at] = tile_rows[k];
  }
}

// off[s] for s in (key[p - 1], key[p]] is p, with key[-1] = -1 and key[n]
// = S, so off[s + 1] - off[s] is segment s's length and off[S] the count
// of rows in range.  A stretch of more than 8 segments is written by the
// whole warp.
__global__ void __launch_bounds__(kThreads)
seg_bounds(const uint32_t* __restrict__ keys, int64_t n, int64_t S,
           int32_t* __restrict__ off) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cur = p < n ? (int64_t)keys[p] : S;
  const int64_t prev = p == 0 ? -1 : (p <= n ? (int64_t)keys[p - 1] : S);
  const int64_t lo = prev + 1, hi = p <= n ? cur + 1 : lo;
  const bool wide = hi - lo > 8;
  if (!wide)
    for (int64_t s = lo; s < hi; ++s) off[s] = (int32_t)p;
  unsigned todo = __ballot_sync(kFull, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t a = __shfl_sync(kFull, lo, src);
    const int64_t b = __shfl_sync(kFull, hi, src);
    const int32_t at = (int32_t)__shfl_sync(kFull, p, src);
    for (int64_t s = a + lane; s < b; s += 32) off[s] = at;
  }
}

// Rows [lo, hi) of the sorted order added in ascending order, in the
// columns c, c + step, ... below m, at most kCols of them: one pass over
// the rows for all of them.
__device__ __forceinline__ void run_sums(const int32_t* __restrict__ rows,
                                         const float* __restrict__ vals,
                                         int64_t m, int64_t c, int step,
                                         int64_t lo, int64_t hi,
                                         float (&acc)[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
  for (int64_t i = lo; i < hi; ++i) {
    const float* v = vals + (int64_t)rows[i] * m + c;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (c + q * step < m) acc[q] += v[q * step];
  }
}

// Chunks 1, 2, ... of every segment longer than kChunk: the chunk that
// starts at sorted position q goes to slot q / kChunk (distinct: two such
// starts lie at least kChunk + 1 apart unless they are kChunk apart in one
// segment).  A warp takes 32 positions; its lanes take the columns.
__global__ void __launch_bounds__(kThreads)
seg_chunks(const uint32_t* __restrict__ keys,
           const int32_t* __restrict__ rows, const float* __restrict__ vals,
           int64_t n, int64_t m, int64_t S, const int32_t* __restrict__ off,
           float* __restrict__ chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t end = 0;
  bool head = false;
  if (p < n) {
    const int64_t k = keys[p];
    if (k < S) {
      const int64_t lo = off[k], r = p - lo;
      end = off[k + 1];
      head = end - lo > kChunk && r >= kChunk && r % kChunk == 0;
      end = end < p + kChunk ? end : p + kChunk;
    }
  }
  unsigned todo = __ballot_sync(kFull, head);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t q = __shfl_sync(kFull, p, src);
    const int64_t e = __shfl_sync(kFull, end, src);
    float* slot = chunks + (q / kChunk) * m;
    for (int64_t c = lane; c < m; c += 32 * kCols) {
      float acc[kCols];
      run_sums(rows, vals, m, c, 32, q, e, acc);
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (c + 32 * u < m) slot[c + 32 * u] = acc[u];
    }
  }
}

// A team of `team` threads a segment, its threads taking the columns.
__global__ void __launch_bounds__(kThreads)
seg_sums(const int32_t* __restrict__ rows, const float* __restrict__ vals,
         int64_t m, int64_t S, int team, const int32_t* __restrict__ off,
         const float* __restrict__ chunks, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t s = g / team;
  if (s >= S) return;
  const int64_t lo = off[s], hi = off[s + 1];
  for (int64_t c = g % team; c < m; c += (int64_t)team * kCols) {
    float acc[kCols];
    if (hi - lo <= kChunk) {
      run_sums(rows, vals, m, c, team, lo, hi, acc);
    } else {
      run_sums(rows, vals, m, c, team, lo, lo + kChunk, acc);
      for (int64_t q = lo + kChunk; q < hi; q += kChunk) {
        const float* slot = chunks + (q / kChunk) * m + c;
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (c + u * team < m) acc[u] += slot[u * team];
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      if (c + u * team < m) out[s * m + c + u * team] = acc[u];
  }
}

// ---------------------------------------------------------------------------
// The histogram: counts[s] = #{i : ids[i] == s} for s in [0, S), int64.
//
// What bounds it on this card: bytes, the ids read once and the counts
// written once (8.4 MB for the census's 1,710,918 int32 ids into 196,049
// counts), and the latency of one wave.  The design:
//
// * One launch zeroes the counts and counts.  A block loads its first
//   tile, then zeroes (zero_counts), then counts, so the read overlaps the
//   zeroing and the barrier behind it.
// * Streamed reads: a tile is kHistThreads * kHistRows 16-byte vectors
//   (1,024 int64 or 2,048 int32 ids); warp w of a block takes kHistRows
//   rows of 32 vectors, one 16-byte load a lane a row, all issued before
//   the first atomic: a contiguous chunk of 32 * kHistRows * V ids (V ids
//   a vector).  A view that starts off a 16-byte boundary is read from the
//   boundary below it, its partial vectors id by id.
// * Equal neighbours merged before the atomic: within a warp's chunk a run
//   of equal ids adds its length once, at its last id, so a sorted input
//   costs one atomic a run and not one an id (the census: runs of ~8).
//   The adds' results are unused, so they compile to REDG, not ATOMG.
// Integer addition is exact and does not depend on order, so the counts
// are the same bits whatever order the adds land in.
// ---------------------------------------------------------------------------
using u64 = unsigned long long;
constexpr int kHistThreads = 256;
constexpr int kHistRows = 2;      // 16-byte loads a lane keeps in flight
constexpr int kZeroWords = 2048;  // counts a zeroing chunk (16 KB)

template <typename I> struct Vec16;
template <> struct Vec16<int32_t> {
  using T = int4;
  static constexpr int kN = 4;
  __device__ static void unpack(const int4& v, int32_t (&x)[4]) {
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
};
template <> struct Vec16<int64_t> {
  using T = longlong2;
  static constexpr int kN = 2;
  __device__ static void unpack(const longlong2& v, int64_t (&x)[2]) {
    x[0] = v.x, x[1] = v.y;
  }
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(u64* p, u64 v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Vector k of the aligned array covers ids [k * V - head, k * V - head + V);
// one wholly inside [0, n) is one 16-byte load, a partial one (the head
// and the tail of the array) is loaded id by id; ids outside are 0 and are
// never counted.
template <typename I>
__device__ __forceinline__ void load_rows(const I* __restrict__ ids,
                                          int64_t n, int head, int64_t k0,
                                          I (&x)[kHistRows][Vec16<I>::kN]) {
  constexpr int V = Vec16<I>::kN;
  using T = typename Vec16<I>::T;
  const T* vec = reinterpret_cast<const T*>(
      reinterpret_cast<uintptr_t>(ids) & ~uintptr_t(15));
#pragma unroll
  for (int u = 0; u < kHistRows; ++u) {
    const int64_t k = k0 + u * 32;
    const int64_t e0 = k * V - head;
    if (e0 >= 0 && e0 + V <= n) {
      Vec16<I>::unpack(__ldg(vec + k), x[u]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t e = e0 + j;
        x[u][j] = e >= 0 && e < n ? ids[e] : I(0);
      }
    }
  }
}

// One warp's chunk, ids [e0, e0 + 32 * kHistRows * V) of which those in
// [0, n) count (all of them when kWhole).  Position q = (row * 32 + lane)
// * V + j.  A head is a position whose left neighbour in the chunk differs
// or is missing, a tail one whose right neighbour does; the tail of a run
// adds q - (its head) + 1.  A run's head is the last head at or before its
// tail: in the lane, in a lower lane of the row (a ballot of the lanes
// holding heads and a shuffle of the highest one's last head), or in an
// earlier row (`open`).
template <typename I, bool kWhole>
__device__ __forceinline__ void count_rows(
    const I (&x)[kHistRows][Vec16<I>::kN], int64_t e0, int64_t n, int64_t S,
    u64* __restrict__ counts, int lane) {
  constexpr int V = Vec16<I>::kN;
  constexpr int kLen = 32 * kHistRows * V;
  int open = 0;
#pragma unroll
  for (int u = 0; u < kHistRows; ++u) {
    // the left neighbour of a lane's first id is the previous lane's last
    // (for lane 0, lane 31's of the previous row); the right neighbour of
    // its last id the next lane's first (for lane 31, lane 0's of the next
    // row): one shuffle each
    I give = x[u][V - 1];
    if (u > 0 && lane == 31) give = x[u - 1][V - 1];
    const I left = __shfl_sync(kFull, give, (lane + 31) & 31);
    I take = x[u][0];
    if (u + 1 < kHistRows && lane == 0) take = x[u + 1][0];
    const I right = __shfl_sync(kFull, take, (lane + 1) & 31);
    const int q0 = (u * 32 + lane) * V;
    unsigned heads = 0, tails = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int q = q0 + j;
      const I prev = j > 0 ? x[u][j - 1] : left;
      const I next = j + 1 < V ? x[u][j + 1] : right;
      bool head = q == 0 || x[u][j] != prev;
      bool tail = q == kLen - 1 || x[u][j] != next;
      if (!kWhole) {
        const int64_t e = e0 + q;
        const bool valid = e >= 0 && e < n;
        head = valid && (head || e == 0);
        tail = valid && (tail || e == n - 1);
      }
      heads |= (unsigned)head << j;
      tails |= (unsigned)tail << j;
    }
    const unsigned holders = __ballot_sync(kFull, heads != 0);
    const unsigned below = holders & ((1u << lane) - 1);
    const int last = heads ? q0 + 31 - __clz(heads) : 0;
    const int from = __shfl_sync(kFull, last, below ? 31 - __clz(below) : 0);
    int start = below ? from : open;
    if (holders) open = __shfl_sync(kFull, last, 31 - __clz(holders));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if ((heads >> j) & 1) start = q0 + j;
      const I id = x[u][j];
      if (((tails >> j) & 1) && (uint64_t)(int64_t)id < (uint64_t)S)
        atomicAdd(counts + id, (u64)(q0 + j - start + 1));
    }
  }
}

// Zero the counts, then return once all of them are zero.  `bar` is this
// call's (claims, done) pair, zero when the call starts; block 0 zeroes
// `next`, the other pair, for the next call on the stream (the call before,
// which used it, has ended).  A block claims 16-KB chunks from `claims`,
// zeroes each and adds one to `done` with a release after its stores, until
// the chunks run out; then it waits for `done` to reach the chunk count.
// The first `chunks` blocks claim at once (without reading the counter
// first); the others only after a first wait, so few contend for the
// counter, and any block that waits takes what is left, so no block waits
// for a block that is not running: the barrier cannot deadlock, whatever
// the grid and whatever else the card runs.
__device__ __forceinline__ void zero_counts(u64* __restrict__ counts,
                                            int64_t S, u64* bar, u64* next,
                                            int64_t chunks) {
  __shared__ int64_t s_chunk;
  if (blockIdx.x == 0 && threadIdx.x < 2) next[threadIdx.x] = 0ull;
  bool eager = blockIdx.x < chunks, first = eager;
  for (;;) {
    if (threadIdx.x == 0) {
      int64_t c = -1;
      for (;;) {
        if (eager && (first || ld_relaxed(bar) < (u64)chunks)) {
          first = false;
          const u64 got = atomicAdd(bar, 1ull);
          if (got < (u64)chunks) {
            c = (int64_t)got;
            break;
          }
        }
        if (ld_acquire(bar + 1) >= (u64)chunks) break;
        __nanosleep(eager ? 32 : 512);
        eager = true;
      }
      s_chunk = c;
    }
    __syncthreads();
    const int64_t c = s_chunk;
    if (c < 0) break;
    const int64_t lo = c * kZeroWords;
    const int64_t hi = S < lo + kZeroWords ? S : lo + kZeroWords;
    if (hi - lo == kZeroWords) {
      ulonglong2* p = reinterpret_cast<ulonglong2*>(counts + lo);
      for (int k = threadIdx.x; k < kZeroWords / 2; k += kHistThreads)
        p[k] = make_ulonglong2(0ull, 0ull);
    } else {
      for (int64_t k = lo + threadIdx.x; k < hi; k += kHistThreads)
        counts[k] = 0ull;
    }
    __syncthreads();  // the block's stores, then one release of them all
    if (threadIdx.x == 0) red_release(bar + 1, 1ull);
  }
}

// The tiles are taken grid-stride.
template <typename I>
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const I* __restrict__ ids, int64_t n, int64_t S,
                 u64* __restrict__ counts, u64* bar, u64* next,
                 int64_t chunks) {
  constexpr int V = Vec16<I>::kN;
  constexpr int kTile = kHistThreads * kHistRows;
  const int lane = threadIdx.x & 31;
  const int64_t warp_at = (int64_t)(threadIdx.x >> 5) * 32 * kHistRows;
  const int head = (int)((reinterpret_cast<uintptr_t>(ids) & 15) / sizeof(I));
  const int64_t tiles = ((n + head + V - 1) / V + kTile - 1) / kTile;
  I x[kHistRows][V];
  load_rows(ids, n, head, blockIdx.x * (int64_t)kTile + warp_at + lane, x);
  zero_counts(counts, S, bar, next, chunks);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t != blockIdx.x) load_rows(ids, n, head, t * kTile + warp_at + lane, x);
    const int64_t e0 = (t * kTile + warp_at) * V - head;
    if (e0 >= 0 && e0 + 32 * kHistRows * V <= n)
      count_rows<I, true>(x, e0, n, S, counts, lane);
    else
      count_rows<I, false>(x, e0, n, S, counts, lane);
  }
}

constexpr int kErrPlan = -1;

template <typename I>
int histogram_launch(const I* ids, int64_t n, int64_t S, int64_t* counts,
                     u64* sync, int parity, int64_t chunks, int grid,
                     void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (chunks != (S + kZeroWords - 1) / kZeroWords || grid < 1)
    return kErrPlan;
  histogram_kernel<I><<<grid, kHistThreads, 0, (cudaStream_t)stream>>>(
      ids, n, S, reinterpret_cast<u64*>(counts), sync + 2 * (parity & 1),
      sync + 2 * (1 - (parity & 1)), chunks);
  return (int)cudaGetLastError();
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename I>
int count_pass(const I* keys, int64_t n, int64_t S, int shift, int bits,
               int tiles, int32_t* table, void* stream) {
  if (bits < 1 || bits > kMaxBits) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    radix_count<I><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
        keys, n, S, shift, bits, table);
  return (int)cudaGetLastError();
}

template <typename I>
int scatter_pass(const I* keys, const int32_t* rows, int64_t n, int64_t S,
                 int shift, int bits, int tiles, const int32_t* scanned,
                 uint32_t* keys_out,
                 int32_t* rows_out, void* stream) {
  if (bits < 1 || bits > kMaxBits) return (int)cudaErrorInvalidValue;
  if (tiles > 0)
    radix_scatter<I><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
        keys, rows, n, S, shift, bits, tiles, scanned, keys_out,
        rows_out);
  return (int)cudaGetLastError();
}

}  // namespace

// (16-byte vectors a histogram tile, counts a zeroing chunk, histogram
// blocks the card holds at once); returns cudaGetLastError() or the
// occupancy query's error.
extern "C" int histogram_layout(int64_t* out) {
  int dev = 0, sms = 0, a = 0, b = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a, histogram_kernel<int32_t>, kHistThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, histogram_kernel<int64_t>, kHistThreads, 0);
  out[0] = kHistThreads * kHistRows;
  out[1] = kZeroWords;
  out[2] = (int64_t)sms * (a < b ? a : b);
  return (int)err;
}

// counts[s] = #{i : ids[i] == s} for s in [0, S), ids outside [0, S)
// dropped: one launch on `stream` that zeroes the counts and counts.
// `sync` is four u64, zero when allocated and used by this stream alone;
// `parity` is the number of calls made on it before, mod 2.  `chunks` must
// be ceil(S / 2048) and grid >= 1, else kErrPlan; otherwise returns
// cudaGetLastError().  S == 0 launches nothing.
extern "C" int histogram_i32(const int32_t* ids, int64_t n, int64_t S,
                             int64_t* counts, u64* sync, int parity,
                             int64_t chunks, int grid, void* stream) {
  return histogram_launch(ids, n, S, counts, sync, parity, chunks, grid,
                          stream);
}
extern "C" int histogram_i64(const int64_t* ids, int64_t n, int64_t S,
                             int64_t* counts, u64* sync, int parity,
                             int64_t chunks, int grid, void* stream) {
  return histogram_launch(ids, n, S, counts, sync, parity, chunks, grid,
                          stream);
}

// (rows a radix tile, digit bits a pass, rows a reduce chunk)
extern "C" void scatter_add_layout(int64_t* out) {
  out[0] = kTile;
  out[1] = kMaxBits;
  out[2] = kChunk;
}

// One radix pass's count: table[t * 2^bits + d] = rows of tile t with
// digit d, the digit being bits [shift, shift + bits) of the key.  The first pass
// reads the ids (i32, i64), later ones the previous pass's keys (u32).
extern "C" int radix_count_i32(const int32_t* keys, int64_t n, int64_t S,
                               int shift, int bits, int tiles, int32_t* table,
                               void* stream) {
  return count_pass(keys, n, S, shift, bits, tiles, table, stream);
}
extern "C" int radix_count_i64(const int64_t* keys, int64_t n, int64_t S,
                               int shift, int bits, int tiles, int32_t* table,
                               void* stream) {
  return count_pass(keys, n, S, shift, bits, tiles, table, stream);
}
extern "C" int radix_count_u32(const uint32_t* keys, int64_t n, int64_t S,
                               int shift, int bits, int tiles, int32_t* table,
                               void* stream) {
  return count_pass(keys, n, S, shift, bits, tiles, table, stream);
}

// One radix pass's stable scatter; `rows` null on the first pass (row i is
// i).  `scanned` is the count table, (tiles, 2^bits), scanned down its
// columns.
extern "C" int radix_scatter_i32(const int32_t* keys, const int32_t* rows,
                                 int64_t n, int64_t S, int shift, int bits,
                                 int tiles, const int32_t* scanned,
                                 uint32_t* keys_out,
                                 int32_t* rows_out, void* stream) {
  return scatter_pass(keys, rows, n, S, shift, bits, tiles, scanned,
                      keys_out, rows_out, stream);
}
extern "C" int radix_scatter_i64(const int64_t* keys, const int32_t* rows,
                                 int64_t n, int64_t S, int shift, int bits,
                                 int tiles, const int32_t* scanned,
                                 uint32_t* keys_out,
                                 int32_t* rows_out, void* stream) {
  return scatter_pass(keys, rows, n, S, shift, bits, tiles, scanned,
                      keys_out, rows_out, stream);
}
extern "C" int radix_scatter_u32(const uint32_t* keys, const int32_t* rows,
                                 int64_t n, int64_t S, int shift, int bits,
                                 int tiles, const int32_t* scanned,
                                 uint32_t* keys_out,
                                 int32_t* rows_out, void* stream) {
  return scatter_pass(keys, rows, n, S, shift, bits, tiles, scanned,
                      keys_out, rows_out, stream);
}

// The bounds and the reduce over sorted (keys, rows): three launches.
// `off` holds S + 1 int32, `chunks` (n / kChunk + 1) * m floats; out is
// (S, m).  n may be 0 (keys and rows unread): every segment is then 0.
extern "C" int segsum_f32(const uint32_t* keys, const int32_t* rows,
                          const float* vals, int64_t n, int64_t m, int64_t S,
                          int32_t* off, float* chunks, float* out,
                          void* stream) {
  if (S <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  seg_bounds<<<blocks_for(n + 1), kThreads, 0, st>>>(keys, n, S, off);
  if (n > 0)
    seg_chunks<<<blocks_for(n), kThreads, 0, st>>>(keys, rows, vals, n, m, S,
                                                   off, chunks);
  const int team = m < 32 ? (int)m : 32;
  seg_sums<<<blocks_for(S * team), kThreads, 0, st>>>(rows, vals, m, S, team,
                                                      off, chunks, out);
  return (int)cudaGetLastError();
}
