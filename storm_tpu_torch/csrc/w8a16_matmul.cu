// w8a16 dequant-matmul: out(M, N) = (x(M, K) @ q(K, N)) * s(N), in x's dtype.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/quant_matmul.py:_qmm_kernel
// (pallas_call at :107), which upcasts each int8 weight tile in VMEM,
// accumulates in f32 on the MXU and applies the per-output-channel scale
// once to the accumulator (valid because quantization is symmetric per
// output channel: x @ (q * s) == (x @ q) * s).
//
// Bound on an H100 SXM at the ViT-B/16 shapes (batch 8, M = 8 * 197 = 1576):
// the MLP products move ~14.5 MB and do 7.4 GFLOP, so at 989 TFLOP/s (bf16
// tensor cores) and 3.35 TB/s they are compute-bound (~7.5 us vs ~4.3 us);
// the 768x768 projections are at the balance point (~1.9 us either way).
//
// Design (simple first): f32 FMAs on the CUDA cores from tiles in shared
// memory, which caps this kernel far below the tensor-core bound above
// (mma/wgmma tiles are the follow-up). A block of 128 threads
// owns a 64x128 output tile; each thread accumulates an 8x8 sub-tile in
// registers (rows ty*4 + {0..3} and 32 + ty*4 + {0..3}, columns tx*4 +
// {0..3} and 64 + tx*4 + {0..3}, so each 4-wide column group is one 16-byte
// shared-memory read and a warp's reads are conflict-free). K is walked 16
// at a time: the x chunk is converted to f32 and stored transposed, the
// int8 q chunk is upcast to f32, both read from device memory in 8-element
// vectors where the shapes and pointers allow it. Only int8 weight bytes
// leave device memory. Ragged M, N and K are zero-filled on load and masked
// on store. Each output sums its K products in order, one FMA at a time.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 128;  // 8 rows x 16 columns of threads, 8x8 each
constexpr int XS_STRIDE = BM + 2;  // +2: conflict-free transposed stores

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(b[i]);
}

// VEC: K and N are multiples of 8 and the pointers are aligned, so a chunk
// of 8 consecutive elements that lies inside the matrix is one vector load.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, T* __restrict__ out,
             int M, int N, int K) {
  __shared__ float xs[BK][XS_STRIDE];
  __shared__ __align__(16) float qs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // This thread's share of each x chunk: row xr, k offsets xk..xk+7
  // (64 rows x 16 = 128 threads x 8); of each q chunk, two runs of 8
  // (16 rows x 128 = 2 x 128 threads x 8).
  const int xr = tid / 2, xk = (tid % 2) * 8;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      float v[8];
      const int m = m0 + xr, k = k0 + xk;
      if (VEC && m < M && k + 8 <= K) {
        load8(x + static_cast<size_t>(m) * K + k, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = (m < M && k + i < K) ? to_f32(x[static_cast<size_t>(m) * K + k + i]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[xk + i][xr] = v[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * THREADS;
      const int kr = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const int k = k0 + kr, n = n0 + c;
      float v[8];
      if (VEC && k < K && n + 8 <= N) {
        load8(q + static_cast<size_t>(k) * N + n, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = (k < K && n + i < N) ? static_cast<float>(q[static_cast<size_t>(k) * N + n + i]) : 0.f;
      }
      reinterpret_cast<float4*>(&qs[kr][c])[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(&qs[kr][c])[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty * 4 + i];
        a[4 + i] = xs[kk][32 + ty * 4 + i];
      }
      const float4 b0 = reinterpret_cast<const float4*>(&qs[kk][tx * 4])[0];
      const float4 b1 = reinterpret_cast<const float4*>(&qs[kk][64 + tx * 4])[0];
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    if (n >= N) continue;
    const float sc = s[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
      if (m < M) out[static_cast<size_t>(m) * N + n] = from_f32<T>(acc[i][j] * sc);
    }
  }
}

template <typename T>
void launch(const void* x, const int8_t* q, const float* s, void* out, int M,
            int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec)
    w8a16_kernel<T, true><<<grid, THREADS, 0, st>>>(xp, q, s, op, M, N, K);
  else
    w8a16_kernel<T, false><<<grid, THREADS, 0, st>>>(xp, q, s, op, M, N, K);
}

}  // namespace

extern "C" int w8a16_matmul(int dtype, const void* x, const void* q,
                            const void* s, void* out, int M, int N, int K,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  if (dtype == DTYPE_BF16) {
    launch<__nv_bfloat16>(x, qp, sp, out, M, N, K, st);
  } else if (dtype == DTYPE_F32) {
    launch<float>(x, qp, sp, out, M, N, K, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
