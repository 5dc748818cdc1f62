// The training head's two passes over a chunk of f32 logits, for Hopper
// (sm_90a): the per-row terms of the cross-entropy in the forward, and the
// logit gradient split exactly into three bf16 terms in the backward.
//
// Replaces no TPU kernel: the reference leaves its loss head to XLA
// (src/repro/models/layers.py::chunked_softmax_xent).  These passes serve
// repro_torch/kernels/xent.py::head_xent, which runs the head's products on
// the tensor cores as bf16 GEMMs with f32 accumulation and recomputes each
// chunk's logits in the backward instead of keeping them.
//
// xent_rows_f32, for each row r of logits (rows, V):
//   logz[r] = log(sum_v exp(logits[r, v]))   (an online max and sum)
//   gold[r] = logits[r, labels[r]], NaN for a label outside [0, V)
// A NaN logit makes logz NaN; an infinite maximum is logz itself.
//
// xent_split_f32, for each (r, v):
//   d = scale[r] * (exp(logits[r, v] - logz[r]) - (v == labels[r]))
//   hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid)
// written to three planes of out (3, rows, V).  Each remainder is exact in
// f32 and holds at most 16, then 8 significant bits, so hi + mid + lo == d
// for every d of magnitude at least 2^-110 (below it lo is off by at most
// 2^-134, bf16's subnormal spacing) and below bf16's overflow.  A product
// of a bf16 value with a bf16 weight is exact in f32, so three bf16 GEMMs
// with f32 accumulation over (hi, mid, lo) form the same products as one
// f32 GEMM over d.
//
// What bounds them on this card: bytes.  xent_rows reads 4 bytes a logit
// and writes 8 a row; xent_split reads 4 and writes 6 a logit.  The
// exponentials (1.5 and 1 a logit) stay under the read time.  Design: one
// block per row, each thread walking the row in 16-byte loads (8-byte
// stores of four bf16 in the split), the row's maximum and sum carried
// online so the row is read once; the block combines its threads' (max,
// sum) pairs by warp shuffles and then across warps, in a fixed order, so
// a row's result does not depend on the launch.  A row whose length or
// pointers do not allow the vector path takes a scalar one with the same
// arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// (m, s) absorbs (m2, s2), each a maximum and the sum of exp(v - max) over
// its values; (-inf, 0) holds no value.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                     float s2) {
  const float top = nan_max(m, m2);
  if (top == -INFINITY) return;
  s = s * expf(m - top) + s2 * expf(m2 - top);
  m = top;
}

__device__ __forceinline__ void absorb4(float& m, float& s, float4 v) {
  const float lm = nan_max(nan_max(v.x, v.y), nan_max(v.z, v.w));
  const float ls = lm == -INFINITY
                       ? 0.f
                       : expf(v.x - lm) + expf(v.y - lm) + expf(v.z - lm) +
                             expf(v.w - lm);
  merge(m, s, lm, ls);
}

__global__ void __launch_bounds__(kThreads)
    xent_rows_kernel(const float* __restrict__ logits, int64_t V, bool vec,
                     const int64_t* __restrict__ labels,
                     float* __restrict__ logz, float* __restrict__ gold) {
  __shared__ float warp_m[kThreads / 32], warp_s[kThreads / 32];
  const int64_t row = blockIdx.x;
  const float* x = logits + row * V;
  float m = -INFINITY, s = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = threadIdx.x; i < V / 4; i += kThreads)
      absorb4(m, s, x4[i]);
  } else {
    for (int64_t i = threadIdx.x; i < V; i += kThreads)
      merge(m, s, x[i], x[i] == -INFINITY ? 0.f : 1.f);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float s2 = __shfl_xor_sync(kFull, s, off);
    merge(m, s, m2, s2);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_m[threadIdx.x >> 5] = m;
    warp_s[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float top = warp_m[0], sum = warp_s[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(top, sum, warp_m[w], warp_s[w]);
    logz[row] = isinf(top) ? top : top + logf(sum);
    const int64_t lab = labels[row];
    gold[row] = (lab >= 0 && lab < V) ? x[lab] : NAN;
  }
}

__device__ __forceinline__ float grad(float l, float lz, float sc,
                                      bool gold) {
  return __fmul_rn(sc, __fsub_rn(expf(l - lz), gold ? 1.f : 0.f));
}

// hi, mid, lo of d; returns their bits as three 16-bit values
__device__ __forceinline__ void split3(float d, uint16_t& h, uint16_t& m,
                                       uint16_t& l) {
  const __nv_bfloat16 hb = __float2bfloat16_rn(d);
  const float r = __fsub_rn(d, __bfloat162float(hb));
  const __nv_bfloat16 mb = __float2bfloat16_rn(r);
  const __nv_bfloat16 lb =
      __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mb)));
  h = __bfloat16_as_ushort(hb);
  m = __bfloat16_as_ushort(mb);
  l = __bfloat16_as_ushort(lb);
}

__device__ __forceinline__ uint2 pack4(const uint16_t* t) {
  return make_uint2((uint32_t)t[0] | ((uint32_t)t[1] << 16),
                    (uint32_t)t[2] | ((uint32_t)t[3] << 16));
}

__global__ void __launch_bounds__(kThreads)
    xent_split_kernel(const float* __restrict__ logits, int64_t rows,
                      int64_t V, bool vec, const int64_t* __restrict__ labels,
                      const float* __restrict__ logz,
                      const float* __restrict__ scale,
                      uint16_t* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const float* x = logits + row * V;
  const int64_t plane = rows * V;
  uint16_t* hi = out + row * V;
  uint16_t* mid = hi + plane;
  uint16_t* lo = mid + plane;
  const float lz = logz[row], sc = scale[row];
  const int64_t lab = labels[row];
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = threadIdx.x; i < V / 4; i += kThreads) {
      const float4 v = x4[i];
      const float vs[4] = {v.x, v.y, v.z, v.w};
      uint16_t h[4], m[4], l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split3(grad(vs[k], lz, sc, 4 * i + k == lab), h[k], m[k], l[k]);
      reinterpret_cast<uint2*>(hi)[i] = pack4(h);
      reinterpret_cast<uint2*>(mid)[i] = pack4(m);
      reinterpret_cast<uint2*>(lo)[i] = pack4(l);
    }
  } else {
    for (int64_t i = threadIdx.x; i < V; i += kThreads)
      split3(grad(x[i], lz, sc, i == lab), hi[i], mid[i], lo[i]);
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// One block per row of logits (rows, V); logz and gold get one value a
// row.  Returns cudaGetLastError().
extern "C" int xent_rows_f32(const float* logits, int64_t rows, int64_t V,
                             const int64_t* labels, float* logz, float* gold,
                             void* stream) {
  if (rows > 0) {
    const bool vec = V % 4 == 0 && aligned(logits, 16);
    xent_rows_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        logits, V, vec, labels, logz, gold);
  }
  return (int)cudaGetLastError();
}

// One block per row of logits (rows, V); out holds the three bf16 planes
// (3, rows, V).  Returns cudaGetLastError().
extern "C" int xent_split_f32(const float* logits, int64_t rows, int64_t V,
                              const int64_t* labels, const float* logz,
                              const float* scale, void* out, void* stream) {
  if (rows > 0) {
    const bool vec = V % 4 == 0 && aligned(logits, 16) && aligned(out, 8);
    xent_split_kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        logits, rows, V, vec, labels, logz, scale,
        reinterpret_cast<uint16_t*>(out));
  }
  return (int)cudaGetLastError();
}
