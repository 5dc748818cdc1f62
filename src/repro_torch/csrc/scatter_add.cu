// Scatter-add and its histogram, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scatter_add.py::
// scatter_add_pallas (body _scatter_kernel) and its wrappers
// src/repro/kernels/ops.py::scatter_add and ::histogram.
//
// histogram: counts[s] = #{i : ids[i] == s} as int64, ids int32 or int64,
//   ids outside [0, S) dropped.  Integer atomicAdd is exact and its result
//   does not depend on the order the adds land in, so the count needs no
//   f32 exactness guard.
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

template <typename I>
__global__ void histogram_kernel(const I* __restrict__ ids, int64_t n,
                                 int64_t num_bins,
                                 unsigned long long* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t s = (int64_t)ids[i];
    if (s >= 0 && s < num_bins) atomicAdd(counts + s, 1ull);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

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

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int histogram_i32(const int32_t* ids, int64_t n, int64_t num_bins,
                             int64_t* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zeroed =
      cudaMemsetAsync(counts, 0, sizeof(int64_t) * num_bins, st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (n > 0)
    histogram_kernel<int32_t><<<grid_for(n), kThreads, 0, st>>>(
        ids, n, num_bins, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int histogram_i64(const int64_t* ids, int64_t n, int64_t num_bins,
                             int64_t* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zeroed =
      cudaMemsetAsync(counts, 0, sizeof(int64_t) * num_bins, st);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (n > 0)
    histogram_kernel<int64_t><<<grid_for(n), kThreads, 0, st>>>(
        ids, n, num_bins, (unsigned long long*)counts);
  return (int)cudaGetLastError();
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
