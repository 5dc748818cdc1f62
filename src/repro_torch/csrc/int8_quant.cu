// Block-scaled symmetric int8 quantization with error feedback, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int8_quant.py::int8_quant_pallas
// (body _quant_kernel), with its wrapper's zero padding of a ragged last
// block (src/repro/kernels/ops.py::int8_quant) folded in: values past n
// read as 0 and nothing past n is written.
//
// For each block b of block_n values of x (f32):
//   amax      = max |x| over the block, NaN if any value is NaN
//   scale[b]  = amax > 0 ? amax * R : 1      (R: the f32 nearest 1/127)
//   q[i]      = (int8) clamp(rint(x[i] / scale), -127, 127), NaN -> 0
//   err[i]    = x[i] - q[i] * scale, rounded once (an FMA)
// This is the arithmetic of the reference as XLA runs it, not of its
// literal expression: XLA turns the division by the constant 127 into a
// multiplication by R, and contracts x - q*scale into one FMA.  It is
// written out with intrinsics so that neither nvcc's --fmad nor its
// division flags can change a bit.  rint rounds half to even, as
// jnp.round does; XLA converts a NaN to integer 0.
//
// What bounds it on this card: bytes.  Per value it reads 4 bytes and
// writes 5 (q and err); per block it writes a 4-byte scale.  The work is a
// few operations per value.  Design: one thread block per quantization
// block.  Pass 1 reads the block with 16-byte loads and reduces |x| with a
// NaN-propagating max (fmaxf would drop a NaN; torch.amax keeps it), by
// warp shuffles and then across the block's warps.  Pass 2 reads the block
// again (an L2 hit: it is block_n * 4 bytes) and writes q with 4-byte and
// err with 16-byte stores.  A ragged last block, or unaligned pointers,
// take a scalar path with the same arithmetic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 0x1.020408p-7f;  // == float(1/127): kernels/int8_quant.py INV_127

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (isnan(r)) return 0;
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ float residual(float v, int8_t q, float scale) {
  return __fmaf_rn(-(float)q, scale, v);
}

__global__ void int8_quant_kernel(const float* __restrict__ x, int64_t n,
                                  int block_n, bool vec,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scales,
                                  float* __restrict__ err) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * block_n;
  const int64_t rem = n - base;
  const int len = rem < block_n ? (int)rem : block_n;
  const bool full4 = vec && len == block_n;

  // pass 1: NaN-propagating max of |x|; padding values are 0
  float m = 0.f;
  if (full4) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    for (int i = threadIdx.x; i < block_n / 4; i += kThreads) {
      const float4 v = x4[i];
      m = nan_max(m, nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                             nan_max(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads)
      m = nan_max(m, fabsf(x[base + i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) amax = nan_max(amax, warp_max[w]);
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.0f;
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;

  // pass 2: q and the residual
  if (full4) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    char4* q4 = reinterpret_cast<char4*>(q + base);
    float4* e4 = reinterpret_cast<float4*>(err + base);
    for (int i = threadIdx.x; i < block_n / 4; i += kThreads) {
      const float4 v = x4[i];
      char4 qq;
      qq.x = quant(v.x, scale);
      qq.y = quant(v.y, scale);
      qq.z = quant(v.z, scale);
      qq.w = quant(v.w, scale);
      q4[i] = qq;
      e4[i] = make_float4(residual(v.x, qq.x, scale),
                          residual(v.y, qq.y, scale),
                          residual(v.z, qq.z, scale),
                          residual(v.w, qq.w, scale));
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float v = x[base + i];
      const int8_t qi = quant(v, scale);
      q[base + i] = qi;
      err[base + i] = residual(v, qi, scale);
    }
  }
}

}  // namespace

// Launches on `stream` one block per ceil(n / block_n) quantization block;
// scales has that many entries, q and err n.  Returns cudaGetLastError().
extern "C" int int8_quant_f32(const float* x, int64_t n, int32_t block_n,
                              int8_t* q, float* scales, float* err,
                              void* stream) {
  if (n > 0 && block_n > 0) {
    const int64_t blocks = (n + block_n - 1) / block_n;
    const bool vec = block_n % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(err) % 16 == 0;
    int8_quant_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(x, n, block_n, vec, q,
                                                scales, err);
  }
  return (int)cudaGetLastError();
}
