// Fused residual add + LayerNorm: y = x + r; out = (y - mean) * rsqrt(var +
// eps) * g + b, both written in the input dtype, statistics in f32.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/fused_norm.py:_kernel
// (pallas_call at :76), which reads x and r once, keeps the sum in VMEM and
// writes the residual stream and the normed tensor in one pass.
//
// Bound on an H100 SXM at the ViT-B/16 shape (batch 8: 1576 rows of 768,
// bf16): 2 reads + 2 writes = 9.7 MB, so ~2.9 us at 3.35 TB/s; the
// arithmetic is negligible. Memory-bound.
//
// Design: one block of 256 threads per row. Each thread reads its columns
// of x and r once (consecutive threads on consecutive addresses), keeps the
// f32 sum y in shared memory, and the block reduces mean and then variance
// (two-pass, as the TPU kernel does) with warp shuffles. The variance runs
// over the valid d columns only. Each element is read once and written
// twice, which is the bytes the bound counts; what this design leaves on
// the table is wide (16-byte) loads and several rows per block for short
// rows.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Sum over the block, the same value in every thread. Warps reduce with
// shuffles, then every thread adds the per-warp partials in one fixed
// order, so the result does not depend on scheduling.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x % 32) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();  // red is reused by the next call
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
residual_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const float* __restrict__ g,
                          const float* __restrict__ b, T* __restrict__ y,
                          T* __restrict__ out, int d, float eps) {
  extern __shared__ float ys[];  // d floats: the f32 residual sum of this row
  __shared__ float red[WARPS];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = r + row * d;

  float sum = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float v = to_f32(xr[c]) + to_f32(rr[c]);
    ys[c] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / d;
  float sq = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float dv = ys[c] - mean;
    sq += dv * dv;
  }
  const float var = block_sum(sq, red) / d;
  const float rstd = 1.f / sqrtf(var + eps);

  T* yr = y + row * d;
  T* orow = out + row * d;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float v = ys[c];
    yr[c] = from_f32<T>(v);
    orow[c] = from_f32<T>((v - mean) * rstd * g[c] + b[c]);
  }
}

}  // namespace

extern "C" int residual_layernorm(int dtype, const void* x, const void* r,
                                  const void* g, const void* b, void* y,
                                  void* out, int rows, int d, float eps,
                                  void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  if (dtype == DTYPE_BF16) {
    residual_layernorm_kernel<__nv_bfloat16><<<rows, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
        gp, bp, static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out),
        d, eps);
  } else if (dtype == DTYPE_F32) {
    residual_layernorm_kernel<float><<<rows, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(r), gp, bp,
        static_cast<float*>(y), static_cast<float*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
