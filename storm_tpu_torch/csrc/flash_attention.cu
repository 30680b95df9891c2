// Flash attention, non-causal: o = softmax(q k^T * scale) v over (B*H, S, D),
// with an f32 online-softmax carry, so the (S, S) score matrix never
// reaches device memory.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/flash_attention.py:_attn_kernel
// (pallas_call at :123). Kept from it: the running max / denominator /
// accumulator in f32, key columns past S masked with -1e30 (not -inf, so a
// fully masked tile cannot produce NaN), and p cast to the dtype of v
// before the P.V product. Not kept: the padding of D to 128 lanes and of S
// to the block size; here D is a template parameter and the ragged S tile
// is masked in place.
//
// Bound on an H100 SXM at the ViT-B/16 shape (batch 8, 12 heads, S = 197,
// D = 64, bf16): q, k, v in and o out are 9.7 MB (~2.9 us at 3.35 TB/s)
// against 0.95 GFLOP (~1 us at 989 TFLOP/s). Memory-bound.
//
// Design (simple first): one block of 128 threads per (b*h, 64-row q tile).
// The q tile sits in shared memory as f32; K and V walk through shared
// memory 32 keys at a time. Thread (ty, tx), ty < 16 and tx < 8, owns q
// rows ty + 16 i (i < 4), key columns tx + 8 j of each tile and output
// columns tx + 8 j (j < D / 8); row max and row sum are reduced across the
// 8 tx lanes of a row with warp shuffles. P goes through shared memory for
// the P.V product. Every input byte is read once per q tile, i.e. K and V
// ceil(S / 64) times, all from L2 at these sizes; f32 FMAs rather than
// tensor cores are the limit, left for a later change.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int RI = 4;  // q rows per thread: ty + 16 * i
constexpr int CJ = 4;  // key columns per thread: tx + 8 * j
constexpr float NEG = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x (D + 1)
  float* Ks = Qs + BQ * (D + 1);    // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);    // BK x D
  float* Ps = Vs + BK * D;          // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + c] = qi < S ? to_f32(q[base + static_cast<size_t>(qi) * D + c]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][D / 8];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's K, V and P fully consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int ki = k0 + r;
      const bool ok = ki < S;
      const size_t at = base + static_cast<size_t>(ki) * D + c;
      Ks[r * (D + 1) + c] = ok ? to_f32(k[at]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[RI], kb[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kb[j] = Ks[(tx + 8 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float s = (k0 + tx + 8 * j < S) ? sc[i][j] * scale : NEG;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 8 * j] = round_through<T>(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float* prow = Ps + (ty + 16 * i) * (BK + 1);
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float p = prow[c];
        const float* vrow = Vs + c * D + tx;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) acc[i][j] = fmaf(p, vrow[8 * j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) orow[tx + 8 * j] = from_f32<T>(acc[i][j] / l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB (D = 128) dynamic shared memory must be opted into, once per
  // process: the call is not one a CUDA graph capture may record, so a
  // launch captured after a first (eager) launch makes none.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int BH, int S, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, int BH, int S, int D,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, BH, S, scale, st);
  if (dtype == DTYPE_F32) return dispatch_d<float>(D, q, k, v, o, BH, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
