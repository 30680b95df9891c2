// Flash attention on Hopper's tensor cores, bf16, non-causal:
// o = softmax(q k^T * scale) v over (B*H, S, D), D in {16, 32, 64, 128}.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/flash_attention.py:_attn_kernel
// (pallas_call at :123) on the bf16 path; csrc/flash_attention.cu stays the
// f32 variant. Kept from the TPU kernel: scores, running max, denominator
// and accumulator in f32; key columns past S masked with -1e30 (never -inf,
// so a masked column cannot make a NaN); p rounded to v's dtype (bf16)
// before the P.V product while the denominator sums the f32 p; the output
// divided by the denominator at the end.
//
// Bound on an H100 SXM at the ViT-B/16 shape (batch 8, 12 heads, S = 197,
// D = 64): q, k, v in and o out are 9.7 MB (~2.9 us at 3.35 TB/s) against
// 0.95 GFLOP (~1 us at 989 TFLOP/s): bytes bound it.
//
// Design, FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, f32 out): one block
// of four warps per (b*h, 64 query rows); each warp owns 16 query rows,
// whose q fragment is loaded once (ldmatrix) and kept in registers. K and V
// walk through shared memory 64 keys at a time, bf16 as in device memory,
// double-buffered by cp.async with zero-fill past S; rows are padded by 16
// bytes so ldmatrix reads are free of bank conflicts. S = q k^T accumulates
// in f32 registers; the row max and sum reduce over the four lanes that
// share a row (quad shuffles); p is rounded to bf16 and reused in registers
// as the A operand of P.V, with V read by ldmatrix.trans. O stays in f32
// registers and is stored as bf16 once.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // row stride in elements: +16 bytes
  __nv_bfloat16 q[BQ * LD];
  __nv_bfloat16 k[2][BKV * LD];
  __nv_bfloat16 v[2][BKV * LD];
};

// 64 rows of D bf16 starting at row r0 of a (S, D) matrix, into a padded
// tile; rows >= S are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async<16>(dst + r * Smem<D>::LD + c,
                 ok ? src + static_cast<size_t>(r0 + r) * D + c : src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_sm90_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  int S, float scale) {
  static_assert(D % 16 == 0 && BQ * (D / 8) % THREADS == 0, "D is 16, 32, 64 or 128");
  constexpr int LD = Smem<D>::LD;
  constexpr int KS = D / 16;   // k16 steps of q k^T
  constexpr int NB = BKV / 8;  // n8 blocks of a score tile
  constexpr int DB = D / 8;    // n8 blocks of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  const int tiles = (S + BKV - 1) / BKV;
  const float sl2 = scale * LOG2E;  // scores in the log2 domain: exp2 = exp

  load_rows<D>(sm.q, q + base, q0, S);
  load_rows<D>(sm.k[0], k + base, 0, S);
  load_rows<D>(sm.v[0], v + base, 0, S);
  cp_async_commit();

  uint32_t qa[KS][4];
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // rows lane/4 and lane/4 + 8
  const int mi = lane / 8, mr = lane % 8;               // ldmatrix: matrix, row

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {  // the other buffer was released by the barrier ending tile t - 1
      load_rows<D>(sm.k[buf ^ 1], k + base, (t + 1) * BKV, S);
      load_rows<D>(sm.v[buf ^ 1], v + base, (t + 1) * BKV, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and the q tile) landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qa[ks], sm.q + (16 * warp + (mi & 1) * 8 + mr) * LD + 16 * ks + (mi >> 1) * 8);
    }

    // s = q k^T for this warp's 16 rows x 64 keys.
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
    const __nv_bfloat16* ks_ = sm.k[buf];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks_ + (16 * np + (mi >> 1) * 8 + mr) * LD + 16 * ks + (mi & 1) * 8);
        mma_bf16_16816(s[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // Scale, mask, online softmax over the two rows this lane holds.
    const int key0 = t * BKV + 2 * (lane % 4);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float z = (key0 + nb * 8 + (i & 1) < S) ? s[nb][i] * sl2 : NEG;
        s[nb][i] = z;
        mx[i >> 1] = fmaxf(mx[i >> 1], z);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    uint32_t pa[NB / 2][4];  // p as the A operand of P.V, one k16 step per 16 keys
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float p0 = exp2f(s[nb][0] - m_run[0]), p1 = exp2f(s[nb][1] - m_run[0]);
      const float p2 = exp2f(s[nb][2] - m_run[1]), p3 = exp2f(s[nb][3] - m_run[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[nb / 2][(nb & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + psum[h];
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }

    // acc += p v: V rows are keys (k), columns d (n); .trans gives the
    // col-major B fragments.
    const __nv_bfloat16* vs = sm.v[buf];
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (mi & 1) * 8 + mr) * LD + 16 * dp + (mi >> 1) * 8);
        mma_bf16_16816(acc[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is free for tile t + 2
  }

  // o = acc / l, rows past S never written.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= S) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* orow = o + base + static_cast<size_t>(row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           float scale, cudaStream_t st) {
  constexpr int smem = static_cast<int>(sizeof(Smem<D>));
  // Above 48 KB (D = 128) dynamic shared memory must be opted into, once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_sm90_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_sm90(const void* q, const void* k, const void* v,
                                    void* o, int BH, int S, int D, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, BH, S, scale, st);
    case 32: return launch<32>(q, k, v, o, BH, S, scale, st);
    case 64: return launch<64>(q, k, v, o, BH, S, scale, st);
    case 128: return launch<128>(q, k, v, o, BH, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
