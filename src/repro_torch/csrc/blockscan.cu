// Inclusive prefix sum along axis 0 of a row-major (N, M) array, for Hopper
// (sm_90a).  Types: f32, f64, int32, int64; (N,) is the case M = 1.
//
// Replaces the TPU kernel src/repro/kernels/blockscan.py::blockscan_pallas
// (body _scan_kernel), which walked row blocks in order on one core and
// carried the running total in VMEM: one read and one write of the array.
// Blocks on this card run in parallel and in no order, so the carry has to
// come from the other blocks.
//
// What bounds it on this card: bytes.  One add per element; the least it
// can move is one read of the input and one write of the output.
//
// The design: one launch, one read of the input and one write of the
// output.  Each block takes a chunk of rows (in one 32-column slice: a
// tile) from an atomic ticket, sums it, publishes its column totals, and
// builds its carry from the totals the blocks before it published.  A
// block waits for totals only, never for another block's prefix, so no
// serial chain forms.  Tickets are handed out in chunk order, so every
// tile waited on belongs to a block that has already started, which
// guarantees progress whatever the scheduler does.  A tile publishes its
// totals by storing them, then __threadfence(), then setting its flag to
// the call's tag with a release store; a reader polls the flag with
// acquire loads, then reads the totals from L2.
//
// Two bodies:
//   * scan_tiles, for every floating type and for integers with M > 1: a
//     tile is 64 KB (512 rows of 4-byte values or 256 of 8-byte ones, x 32
//     columns), copied into shared memory with cp.async (16 bytes a copy
//     when a row's bytes are a multiple of 16 and both arrays are 16-byte
//     aligned, else one element a copy).  256 threads: warp g owns rows
//     [g * rows/8, (g + 1) * rows/8) of the tile, lane l column l.  The
//     prefixes are written over the tile in shared memory and stored from
//     there with 16-byte stores, so the input is read once.  Three blocks
//     fit on an SM (3 x 68.5 KB of the 227 KB).
//   * scan_column, for int32 and int64 with M = 1: threads run along rows,
//     32 bytes each (two 16-byte loads when aligned), a serial sum in
//     registers, then a warp-shuffle block scan; 2,048 int32 or 1,024 int64
//     rows a block.  Integer addition is exact, so its order is free.
// Both start copying chunk blockIdx.x before the ticket comes back (tickets
// almost always come in block order) and copy again if it differs.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): scan_tiles 40-48 registers (32-40
// for int32) and 4,624 bytes of static shared memory (2,320 for int32)
// beside its 64 KB tile; scan_column 28 (int32) and 32 (int64) registers;
// no spills.
//
// Carries.  Chunk c's carry is the totals of the chunks before it in its
// super-chunk (16 chunks), added in order, plus the totals of the whole
// super-chunks before that, so a carry reads at most 15 + c/16 totals per
// column.  The block of the chunk that closes a super-chunk publishes the
// super-chunk's total (its 15 predecessors' totals, in order, plus its own)
// before it waits on any other super-chunk, so waits never chain.
//
// Determinism.  f32 input is accumulated in f64 and each output rounded
// once to f32, so every stored prefix is within half an ulp of the exact
// one (the caller takes differences of prefixes, ps[end] - ps[i]).  Other
// types accumulate in their own type.  In scan_tiles every sum is taken in
// an order fixed by N, the type and the constants below, never by M, the
// other columns or timing: a row group's sum is its rows in batches of 4,
// each batch added as a balanced pair; a tile's total is its 8 row groups
// in order; a carry is the super-chunks in 8 interleaved partitions (g, g +
// 8, ..., each in increasing order, the partitions then added in order),
// then the chunks before it in its super-chunk; a prefix is that carry,
// then the earlier row groups of its tile, then its own rows.  So a column
// scanned alone equals the same column inside a batch, bit for bit, and
// repeated launches give the same bits.  No float atomics: the only atomic
// is the integer ticket.
//
// Scratch, kept per stream by the caller and reused call after call:
//   sync (u64 words, zeroed when allocated): [0] the ticket counter,
//     [1, 4) unused, then one flag per tile, then one per (super-chunk,
//     column tile) (one per block in scan_column);
//   data (no initial value): the totals in the accumulator type, one per
//     chunk and column, then one per super-chunk and column.
// Nothing is reset between calls: the flags are reset by an epoch.  The
// caller numbers its calls on a scratch (the tag, from 1) and counts the
// blocks it has launched on it, one ticket each (the base): a block's
// ticket is the counter's old value less the base, a flag is set to the
// call's tag, and a flag left by an earlier call holds a smaller tag.
// Flags live apart from the totals, so no word that an earlier call of
// another shape used for a total is ever read as a flag.  So one scratch
// serves every call on its stream with no memset launch and no reset pass.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;        // scan_column's block
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;           // row groups of a tile
constexpr int kTileCols = 32;
constexpr int kTileBytes = 64 * 1024;  // one tile's values
constexpr int kSuper = 16;           // chunks a super-chunk total covers
constexpr int64_t kHeader = 4;       // sync words before the flags
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// returned by the launchers, besides cudaError codes
constexpr int kErrScratch = -1;      // scratch too small for this shape
constexpr int kErrShape = -2;        // more tiles than a grid may have

template <typename T> struct Acc { using type = T; };
template <> struct Acc<float> { using type = double; };

template <typename T> __host__ __device__ constexpr int64_t tile_rows() {
  return kTileBytes / (kTileCols * (int)sizeof(T));
}
template <typename T> __host__ __device__ constexpr int column_items() {
  return 32 / sizeof(T);
}
template <typename T> __host__ __device__ constexpr int64_t column_rows() {
  return (int64_t)kThreads * column_items<T>();
}
static_assert(tile_rows<double>() % (4 * kGroups) == 0,
              "a row group is whole batches of 4 rows");

// Publication: the totals are stored, then __threadfence(), then a flag
// word is set to the call's tag with a release store.  A reader polls the
// flag with acquire loads and then reads the totals from L2.
__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Spin until the flag holds `tag`, backing off so that waiting threads do
// not crowd the L2.
__device__ __forceinline__ void wait_flag(const u64* f, u64 tag) {
  unsigned ns = 16;
  while (ld_acquire(f) != tag) {
    __nanosleep(ns);
    if (ns < 256) ns *= 2;
  }
}

__device__ __forceinline__ double ld_cg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ int32_t ld_cg(const int32_t* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int64_t ld_cg(const int64_t* p) {
  return (int64_t)__ldcg(reinterpret_cast<const long long*>(p));
}

// Copy `Bytes` from global to shared memory; src_size 0 fills zeros.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(src_size) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(d), "l"(src), "n"(Bytes), "r"(src_size) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy tile t of (x, n, m) into shared memory, thread `k` of `workers`.
template <typename T, bool Vec>
__device__ __forceinline__ void stage_tile(T* tile, const T* x, int64_t n,
                                           int64_t m, int64_t ct, int64_t t,
                                           int k, int workers) {
  constexpr int kRows = (int)tile_rows<T>();
  const int64_t c = t / ct;
  const int64_t r0 = c * kRows, c0 = (t - c * ct) * kTileCols;
  if constexpr (Vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kPerRow = kTileCols / V;
    for (int i = k; i < kRows * kPerRow; i += workers) {
      const int r = i / kPerRow, q = i % kPerRow;
      const int64_t row = r0 + r, col = c0 + (int64_t)q * V;
      const bool ok = row < n && col < m;  // m % V == 0: whole or none
      cp_async<16>(tile + r * kTileCols + q * V, ok ? x + row * m + col : x,
                   ok ? 16 : 0);
    }
  } else {
    for (int i = k; i < kRows * kTileCols; i += workers) {
      const int r = i / kTileCols, q = i % kTileCols;
      const int64_t row = r0 + r, col = c0 + q;
      const bool ok = row < n && col < m;
      cp_async<(int)sizeof(T)>(tile + i, ok ? x + row * m + col : x,
                               ok ? (int)sizeof(T) : 0);
    }
  }
}

// Write tile t of `out` from shared memory, as stage_tile read it.
template <typename T, bool Vec>
__device__ __forceinline__ void store_tile(const T* tile, T* out, int64_t n,
                                           int64_t m, int64_t ct, int64_t t,
                                           int k, int workers) {
  constexpr int kRows = (int)tile_rows<T>();
  const int64_t c = t / ct;
  const int64_t r0 = c * kRows, c0 = (t - c * ct) * kTileCols;
  if constexpr (Vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kPerRow = kTileCols / V;
    for (int i = k; i < kRows * kPerRow; i += workers) {
      const int r = i / kPerRow, q = i % kPerRow;
      const int64_t row = r0 + r, col = c0 + (int64_t)q * V;
      if (row < n && col < m)
        *reinterpret_cast<int4*>(out + row * m + col) =
            *reinterpret_cast<const int4*>(tile + r * kTileCols + q * V);
    }
  } else {
    for (int i = k; i < kRows * kTileCols; i += workers) {
      const int r = i / kTileCols, q = i % kTileCols;
      const int64_t row = r0 + r, col = c0 + q;
      if (row < n && col < m) out[row * m + col] = tile[i];
    }
  }
}

// One tile a block; see the note at the top.  `totals` holds the totals
// of each (chunk, column) and `flags` one flag per tile; `stotals` and
// `sflags` the same per super-chunk.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const T* __restrict__ x, int64_t n, int64_t m, int64_t ct,
           u64* ticket, u64 base, u64 tag, u64* flags, u64* sflags,
           typename Acc<T>::type* totals, typename Acc<T>::type* stotals,
           T* __restrict__ out) {
  using A = typename Acc<T>::type;
  constexpr int kRows = (int)tile_rows<T>();
  constexpr int kGroupRows = kRows / kGroups;
  constexpr int kBatch = 8;  // totals loaded together in the carry
  constexpr int kLast = kWarps - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tile = reinterpret_cast<T*>(smem);  // [kRows][kTileCols]
  __shared__ A part[kGroups][kTileCols];  // row-group sums
  __shared__ A pre[kGroups][kTileCols];   // partial carries
  __shared__ A own[kTileCols];            // the tile's totals
  __shared__ A inner[kTileCols];          // its super-chunk's before it
  __shared__ int64_t s_ticket;

  // Tickets almost always come in block order: start the copy of tile
  // blockIdx.x while the ticket is taken, and copy again if it differs.
  stage_tile<T, Vec>(tile, x, n, m, ct, blockIdx.x, threadIdx.x, kThreads);
  cp_async_commit();
  if (threadIdx.x == 0)
    s_ticket = (int64_t)(atomicAdd(ticket, 1ull) - base);
  __syncthreads();
  const int64_t t = s_ticket;
  if (t != (int64_t)blockIdx.x) {
    cp_async_wait_all();
    __syncthreads();
    stage_tile<T, Vec>(tile, x, n, m, ct, t, threadIdx.x, kThreads);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int64_t c = t / ct, j = t - c * ct;
  const int64_t col = j * kTileCols + lane;
  T* const mine = tile + g * kGroupRows * kTileCols + lane;
  A s = A(0);  // batches of 4 rows, each added as a balanced pair
  for (int r0 = 0; r0 < kGroupRows; r0 += 4) {
    A v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = (A)mine[(r0 + u) * kTileCols];
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  part[g][lane] = s;
  __syncthreads();
  if (g == 0) {  // publish the tile's column totals
    A tot = A(0);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) tot += part[k][lane];
    own[lane] = tot;
    if (col < m) totals[c * m + col] = tot;
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(&flags[t], tag);
  }
  __syncthreads();

  // The carry: the chunks before this one in its super-chunk, added in
  // order by warp kLast, which also publishes the super-chunk's total when
  // this chunk closes it; then the whole super-chunks before it in 8
  // interleaved partitions, warp g taking super-chunks g, g + 8, ... in
  // increasing order.  A super-chunk's total is published before its block
  // waits on any other super-chunk, so waits never chain.
  const int64_t sc = c / kSuper, first = sc * kSuper;
  const int n_inner = (int)(c - first);
  if (g == kLast) {
    if (lane < n_inner) wait_flag(&flags[(first + lane) * ct + j], tag);
    __syncwarp();
    A in = A(0);
    if (col < m) {
      A v[kSuper - 1];
#pragma unroll
      for (int u = 0; u < kSuper - 1; ++u)
        v[u] = u < n_inner ? ld_cg(&totals[(first + u) * m + col]) : A(0);
#pragma unroll
      for (int u = 0; u < kSuper - 1; ++u)
        if (u < n_inner) in += v[u];
    }
    inner[lane] = in;
    if (n_inner == kSuper - 1) {  // this chunk closes its super-chunk
      if (col < m) stotals[sc * m + col] = in + own[lane];
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(&sflags[sc * ct + j], tag);
    }
  }
  A acc = A(0);
  for (int64_t p = g; p < sc; p += kBatch * kGroups) {
    // lane u waits for super-chunk p + 8u; then every lane reads them
    if (lane < kBatch && p + lane * kGroups < sc)
      wait_flag(&sflags[(p + lane * kGroups) * ct + j], tag);
    __syncwarp();
    if (col < m) {
      A v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = p + u * kGroups < sc
                   ? ld_cg(&stotals[(p + u * kGroups) * m + col]) : A(0);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p + u * kGroups < sc) acc += v[u];
    }
  }
  pre[g][lane] = acc;
  __syncthreads();

  // the prefixes, written over the tile: carry, earlier row groups, rows
  A run = A(0);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) run += pre[k][lane];
  run += inner[lane];
  for (int k = 0; k < g; ++k) run += part[k][lane];
  for (int r0 = 0; r0 < kGroupRows; r0 += 4) {  // 4 loads in flight
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = mine[(r0 + u) * kTileCols];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      run += (A)v[u];
      mine[(r0 + u) * kTileCols] = (T)run;
    }
  }
  __syncthreads();
  store_tile<T, Vec>(tile, out, n, m, ct, t, threadIdx.x, kThreads);
}

// Chunk c's values of one int32 or int64 column, in registers.
template <typename T, bool Vec>
__device__ __forceinline__ void load_column(T* v, const T* x, int64_t n,
                                            int64_t c) {
  constexpr int kItems = column_items<T>();
  const int64_t base = c * column_rows<T>() + (int64_t)threadIdx.x * kItems;
  if (Vec && base + kItems <= n) {
    const int4* p = reinterpret_cast<const int4*>(x + base);
#pragma unroll
    for (int k = 0; k < kItems * (int)sizeof(T) / 16; ++k) {
      const int4 q = p[k];
      memcpy(&v[k * (16 / sizeof(T))], &q, 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = base + i < n ? x[base + i] : T(0);
  }
}

// One column of int32 or int64, column_rows<T>() rows a block; `totals`
// and `flags` hold one total and one flag per block.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
scan_column(const T* __restrict__ x, int64_t n, u64* ticket, u64 base,
            u64 tag, u64* flags, T* totals, T* __restrict__ out) {
  constexpr int kItems = column_items<T>();
  __shared__ T warp_inc[kWarps];
  __shared__ T red[kWarps];
  __shared__ int64_t s_ticket;

  // Tickets almost always come in block order: load chunk blockIdx.x while
  // the ticket is taken, and load again if it differs.
  T v[kItems];
  load_column<T, Vec>(v, x, n, blockIdx.x);
  if (threadIdx.x == 0)
    s_ticket = (int64_t)(atomicAdd(ticket, 1ull) - base);
  __syncthreads();
  const int64_t c = s_ticket;
  if (c != (int64_t)blockIdx.x) load_column<T, Vec>(v, x, n, c);
#pragma unroll
  for (int i = 1; i < kItems; ++i) v[i] += v[i - 1];

  // exclusive prefix of this thread's total within the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T mine = v[kItems - 1];
  T inc = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_inc[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_inc[lane] : T(0);
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const T y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_inc[lane] = w;
  }
  __syncthreads();
  T offset = (warp > 0 ? warp_inc[warp - 1] : T(0)) + (inc - mine);
  if (threadIdx.x == 0) {  // publish the block's total
    totals[c] = warp_inc[kWarps - 1];
    __threadfence();
    st_release(&flags[c], tag);
  }

  T acc = T(0);
  for (int64_t p = threadIdx.x; p < c; p += kThreads) {
    wait_flag(&flags[p], tag);
    acc += ld_cg(&totals[p]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWarps; ++k) offset += red[k];

#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] += offset;
  const int64_t row0 = c * column_rows<T>() + (int64_t)threadIdx.x * kItems;
  if (Vec && row0 + kItems <= n) {
    int4* p = reinterpret_cast<int4*>(out + row0);
#pragma unroll
    for (int k = 0; k < kItems * (int)sizeof(T) / 16; ++k) {
      int4 q;
      memcpy(&q, &v[k * (16 / sizeof(T))], 16);
      p[k] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (row0 + i < n) out[row0 + i] = v[i];
  }
}

// Opt a tile body into its dynamic shared memory, once per device.
template <typename T, bool Vec>
cudaError_t allow_tile_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(scan_tiles<T, Vec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTileBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const T* x, int64_t n, int64_t m, u64* sync, int64_t sync_words,
           void* data, int64_t data_words, u64 tag, u64 base, T* out,
           void* stream_) {
  using A = typename Acc<T>::type;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0 || m <= 0) return 0;
  const bool column = std::is_integral<T>::value && m == 1;
  const int64_t rows = column ? column_rows<T>() : tile_rows<T>();
  const int64_t chunks = (n + rows - 1) / rows;
  const int64_t ct = column ? 1 : (m + kTileCols - 1) / kTileCols;
  const int64_t tiles = chunks * ct;  // one block, and one ticket, each
  const int64_t supers = column ? 0 : chunks / kSuper;
  if (tiles > 0x7fffffff) return kErrShape;
  if (kHeader + tiles + supers * ct > sync_words ||
      (chunks + supers) * m > data_words)
    return kErrScratch;
  u64* ticket = sync;
  u64* flags = sync + kHeader;
  u64* sflags = flags + tiles;
  A* totals = reinterpret_cast<A*>(data);
  A* stotals = totals + chunks * m;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const unsigned grid = (unsigned)tiles;
  if constexpr (std::is_integral<T>::value) {
    if (column) {
      if (aligned)
        scan_column<T, true><<<grid, kThreads, 0, stream>>>(
            x, n, ticket, base, tag, flags, totals, out);
      else
        scan_column<T, false><<<grid, kThreads, 0, stream>>>(
            x, n, ticket, base, tag, flags, totals, out);
      return (int)cudaGetLastError();
    }
  }
  if (aligned && (m * (int64_t)sizeof(T)) % 16 == 0) {
    const cudaError_t err = allow_tile_smem<T, true>();
    if (err != cudaSuccess) return (int)err;
    scan_tiles<T, true><<<grid, kThreads, kTileBytes, stream>>>(
        x, n, m, ct, ticket, base, tag, flags, sflags, totals, stotals, out);
  } else {
    const cudaError_t err = allow_tile_smem<T, false>();
    if (err != cudaSuccess) return (int)err;
    scan_tiles<T, false><<<grid, kThreads, kTileBytes, stream>>>(
        x, n, m, ct, ticket, base, tag, flags, sflags, totals, stotals, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The constants the caller sizes scratch with: [header words, tile
// columns, tile rows of 4-byte and of 8-byte types, column rows of int32
// and of int64, chunks a super-chunk covers].
extern "C" void blockscan_layout(int64_t* out) {
  out[0] = kHeader;
  out[1] = kTileCols;
  out[2] = tile_rows<float>();
  out[3] = tile_rows<double>();
  out[4] = column_rows<int32_t>();
  out[5] = column_rows<int64_t>();
  out[6] = kSuper;
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success),
// kErrScratch when `sync` or `data` has fewer than the shape's words, or
// kErrShape.  `sync` is zeroed when allocated and only ever holds the
// ticket count and tags; `data` holds totals and needs no initial value;
// both belong to one stream.  `tag` is this call's number on them,
// counting from 1, and `base` the blocks that the calls before launched on
// them (one ticket each).
#define BLOCKSCAN_ENTRY(suffix, T)                                          \
  extern "C" int blockscan_##suffix(                                        \
      const T* x, int64_t n, int64_t m, u64* sync, int64_t sync_words,      \
      void* data, int64_t data_words, u64 tag, u64 base, T* out,            \
      void* stream) {                                                       \
    return launch<T>(x, n, m, sync, sync_words, data, data_words, tag,     \
                     base, out, stream);                                    \
  }
BLOCKSCAN_ENTRY(f32, float)
BLOCKSCAN_ENTRY(f64, double)
BLOCKSCAN_ENTRY(i32, int32_t)
BLOCKSCAN_ENTRY(i64, int64_t)
