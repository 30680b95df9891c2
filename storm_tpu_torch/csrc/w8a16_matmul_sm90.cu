// w8a16 dequant-matmul on Hopper's tensor cores, bf16 activations:
// out(M, N) = (x(M, K) @ q(K, N)) * s(N), x and out bf16, q int8, s f32.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/quant_matmul.py:_qmm_kernel
// (pallas_call at :107) on the bf16 path; csrc/w8a16_matmul.cu stays the
// f32 variant. As on the TPU: the int8 weight tile is upcast where the
// product reads it, the products are summed in f32, and the per-output-
// channel scale multiplies the accumulator once (x @ (q * s) == (x @ q) * s
// for symmetric per-channel quantization).
//
// Exactness: every int8 value |q| <= 127 is exact in bf16, and the product
// of two bf16 values is exact in f32, so this kernel differs from the plain
// version (f32 product of the upcast operands) only in the order of the f32
// sum.
//
// Bound on an H100 SXM at the ViT-B/16 shapes (batch 8, M = 8 * 197 = 1576):
// the MLP products do 7.4 GFLOP and move ~14.5 MB, compute-bound at the
// tensor cores' 989 TFLOP/s (~7.5 us); the 768x768 projections sit near the
// balance point. Measured, what holds the kernel back is feeding the tensor
// cores, not their rate: operands re-read from L2 (x once per block column,
// q once per block row) and each warpgroup's K steps issued one at a time.
// So blocks are as large as the grid allows. Design:
//
// - The product runs transposed, out^T = q^T x^T, so the int8 weights are
//   wgmma's A operand, held in registers, and the activations its B operand,
//   read from shared memory: wgmma.mma_async m64nBTk16, A from registers.
//   A block is WG warpgroups (1 or 2) of 64 output channels each, sharing
//   BT tokens (64, 128 or 160); ops/quant_matmul.py:sm90_tile picks both.
//   Each weight is converted once per block, by the thread whose A
//   fragment holds it, and never written back to shared memory.
// - Loads: a 4-stage ring in shared memory, three K tiles (64 deep) ahead.
//   x arrives by TMA: one thread asks for the BT x 64 tile as a 2-D tensor
//   copy, which lands in the 128-byte swizzle that wgmma reads without bank
//   conflicts (the unswizzled core-matrix layout was far slower) and reads
//   as zero past M and K, and completes on the stage's mbarrier. The
//   weights travel as int8 (1 byte a weight from device memory and in the
//   ring) by cp.async, zero-filled past N and K, row-major as in device
//   memory, rows padded by 16 bytes, their addresses worked out once per
//   thread. TMA needs x's rows 16-byte aligned (K % 8 == 0); the weights
//   take 16-byte copies where N % 16 == 0 (MODE 2) and 8-byte ones where
//   N % 8 == 0 (MODE 1: the ViT head's 1000-byte rows); any other shape
//   loads both element by element (MODE 0, the ragged test shapes),
//   synchronously but through the same ring.
// - Conversion: output channels are assigned so that a thread's two A
//   fragment rows are adjacent columns n, n + 1 of q; ldmatrix.trans of the
//   int8 tile, read as byte pairs, then hands each thread (q[k][n],
//   q[k][n + 1], q[k + 1][n], q[k + 1][n + 1]) as one word, and
//   int8_pair_to_bf16x2 turns each k pair into bf16x2 exactly with two
//   integer operations and one bf16 subtraction (no int-to-float
//   instruction).
// - Per K tile: issue its wgmma group, then, while it runs, wait for the
//   next tile (one barrier), start the next loads and convert the next
//   tile's A fragments into the other register buffer; then wait for the
//   group. The fragments a running group reads are never written, so ptxas
//   keeps the wgmmas asynchronous.
// - Epilogue: the f32 accumulator times s[n], rounded to bf16, stored as
//   bf16 pairs with masks on M and N.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int KCH = BK / 8;           // 16-byte (8 x bf16) chunks of a row

// WG warpgroups, each 64 output channels (wgmma's M, the A operand), share
// one tile of BT tokens (wgmma's N, the B operand).
template <int WG>
struct Cfg {
  static constexpr int THREADS = 128 * WG;
  static constexpr int BN = 64 * WG;         // output channels per block
  static constexpr int Q_LD = BN + 16;       // int8 ring row stride (bank conflicts)
};

template <int WG, int BT>
struct Smem {
  __nv_bfloat16 x[STAGES][BT * BK];          // K-major, 128-byte rows, 128-byte swizzle
  int8_t q[STAGES][BK * Cfg<WG>::Q_LD];      // row-major (k, n), padded rows
  uint64_t x_full[STAGES];                   // mbarriers: a stage's x tile landed
};

// The bytes 0 and 2 of w, two int8 values, to bf16x2 (byte 0 in the low
// half), exactly: with v = l7 - 128 b7 (l7 the low 7 bits, b7 the sign
// bit), the bf16 0x4300 | l7 is 128 + l7 and 0x4300 | (b7 << 7) is 128 or
// 256, and their difference, an integer in [-128, 127], is exact in bf16.
__device__ __forceinline__ uint32_t int8_pair_to_bf16x2(uint32_t w) {
  const uint32_t mag = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t sgn = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sgn));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Issues the loads of a K tile into a ring stage. x: with MODE > 0 one
// thread asks the TMA unit for the BT x 64 tile, in the 128-byte swizzle,
// rows past M zero-filled, completing on the stage's mbarrier; with MODE 0
// each thread loads 8 elements at a time (a warp covers rows 0-7 x chunks
// 0-3 or 4-7, whole 32-byte sectors, and its stores hit 8 bank groups).
// q: BK rows x BN bytes, copied as they lie in device memory. Each thread
// copies the same chunks of every tile, so their addresses are worked out
// once.
template <int WG, int BT, int MODE>
struct Loader {
  using C = Cfg<WG>;
  static constexpr int XR = MODE > 0 ? 0 : BT * KCH / C::THREADS;  // x items per thread
  static constexpr int QV = MODE == 2 ? 16 : 8;  // bytes per q copy (MODE 0: per item)
  static constexpr int QR = BK * (C::BN / QV) / C::THREADS;
  const CUtensorMap* xmap;
  const int8_t* __restrict__ q;
  int N, K, m0;
  const __nv_bfloat16* xp[XR > 0 ? XR : 1];  // MODE 0: row m, chunk c, at k0 = 0
  const int8_t* qp[QR];                      // row kr, column n, at k0 = 0
  int xdst[XR > 0 ? XR : 1], xk[XR > 0 ? XR : 1], qdst[QR], qk[QR], qn[QR];
  bool xok[XR > 0 ? XR : 1], qok[QR];

  __device__ __forceinline__ Loader(const CUtensorMap* xmap_, const __nv_bfloat16* x,
                                    const int8_t* q_, int M, int N_, int K_, int m0_, int n0)
      : xmap(xmap_), q(q_), N(N_), K(K_), m0(m0_) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int e = tid + r * C::THREADS;
      const int row = (e & 7) + 8 * (e >> 6);
      const int c = (e >> 3) & 7;
      xdst[r] = row * 128 + ((c ^ (row & 7)) << 4);  // 128-byte swizzle
      xk[r] = c * 8;
      xok[r] = m0 + row < M;
      xp[r] = x + static_cast<size_t>(xok[r] ? m0 + row : 0) * K + c * 8;
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int e = tid + r * C::THREADS;
      const int kr = e / (C::BN / QV);
      const int c = (e % (C::BN / QV)) * QV;
      qdst[r] = kr * C::Q_LD + c;
      qk[r] = kr;
      qn[r] = n0 + c;
      qok[r] = n0 + c < N;
      qp[r] = q + static_cast<size_t>(kr) * N + (qok[r] ? n0 + c : 0);
    }
  }

  __device__ __forceinline__ void issue(Smem<WG, BT>& sm, int st, int kt) const {
    const int k0 = kt * BK;
    unsigned char* xs = reinterpret_cast<unsigned char*>(sm.x[st]);
    int8_t* qs = sm.q[st];
    const size_t qoff = static_cast<size_t>(k0) * N;
    if constexpr (MODE > 0) {
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&sm.x_full[st], BT * BK * 2);
        tma_load_2d(xs, xmap, k0, m0, &sm.x_full[st]);
      }
    }
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (xok[r] && k0 + xk[r] + i < K) ? xp[r][k0 + i] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(xs + xdst[r]) = *reinterpret_cast<const uint4*>(v);
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const bool row_ok = k0 + qk[r] < K;
      if constexpr (MODE > 0) {
        const bool ok = qok[r] && row_ok;
        cp_async<QV>(qs + qdst[r], ok ? qp[r] + qoff : q, ok ? QV : 0);
      } else {
        __align__(8) int8_t v[QV];
#pragma unroll
        for (int i = 0; i < QV; ++i)
          v[i] = (row_ok && qn[r] + i < N) ? qp[r][qoff + i] : int8_t(0);
        *reinterpret_cast<uint2*>(qs + qdst[r]) = *reinterpret_cast<const uint2*>(v);
      }
    }
  }

  // Wait until this thread sees K tile kt in ring stage st: its own copies
  // (cp.async groups: all but the newest `pending`) and, with TMA, the x tile.
  template <int PENDING>
  __device__ __forceinline__ void wait(Smem<WG, BT>& sm, int st, int kt) const {
    cp_async_wait<PENDING>();
    if constexpr (MODE > 0) mbar_wait(&sm.x_full[st], (kt / STAGES) & 1);
  }
};

// The A fragments (q^T, bf16) of the four k16 steps of a K tile. Lane l of
// warp w holds rows v0 = 16 w + l / 4 and v1 = v0 + 8 of its warpgroup's
// 64-row operand; they stand for output channels n = col + 2 (l / 4) and
// n + 1, col = 64 g + 16 w, so that ldmatrix.trans of the int8 tile, read
// as pairs of bytes, hands lane l the word (q[k][n], q[k][n + 1],
// q[k + 1][n], q[k + 1][n + 1]) for k = 2 (l % 4) of each 8-row block.
template <int Q_LD>
__device__ __forceinline__ void convert_a(const int8_t* __restrict__ qs, int col,
                                          uint32_t (&a)[BK / 16][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int jj = 0; jj < BK / 32; ++jj) {
    uint32_t r[4];  // k rows 32 jj + {0-7, 8-15, 16-23, 24-31}
    ldmatrix_x4_trans(r, qs + (32 * jj + lane) * Q_LD + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * jj + h;
      a[j][0] = int8_pair_to_bf16x2(r[2 * h]);           // row v0, k and k + 1
      a[j][1] = int8_pair_to_bf16x2(r[2 * h] >> 8);      // row v1
      a[j][2] = int8_pair_to_bf16x2(r[2 * h + 1]);       // row v0, k + 8 and k + 9
      a[j][3] = int8_pair_to_bf16x2(r[2 * h + 1] >> 8);  // row v1
    }
  }
}

template <int BT>
__device__ __forceinline__ void wgmma_rs(float (&acc)[BT / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BT == 64) wgmma_m64n64k16_rs(acc, a, db);
  else if constexpr (BT == 128) wgmma_m64n128k16_rs(acc, a, db);
  else wgmma_m64n160k16_rs(acc, a, db);
}

// One K tile. On entry `a` holds tile kt's A fragments and no wgmma is in
// flight. Issue tile kt's wgmma group; while it runs, wait for tile kt + 1,
// start the loads STAGES - 1 tiles ahead into the stage tile kt - 1 used,
// and convert tile kt + 1 into `an`; then wait for the group. (Converting
// for a group that is issued only after the running one retires keeps
// ptxas from serializing the wgmmas.)
template <int WG, int BT, int MODE>
__device__ __forceinline__ void k_step(Smem<WG, BT>& sm, const Loader<WG, BT, MODE>& ld,
                                       int kt, int KT, float (&acc)[BT / 2],
                                       const uint32_t (&a)[BK / 16][4],
                                       uint32_t (&an)[BK / 16][4], int col) {
  wgmma_fence();
  const unsigned char* xs = reinterpret_cast<const unsigned char*>(sm.x[kt % STAGES]);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_rs<BT>(acc, a[j], wgmma_desc_sw128(xs + j * 32));
  wgmma_commit();
  if (kt + 1 < KT) {
    ld.template wait<STAGES - 3>(sm, (kt + 1) % STAGES, kt + 1);
    fence_proxy_async();  // this thread's writes of tile kt + 1, before wgmma reads them
    __syncthreads();      // tile kt + 1 landed for all; tile kt - 1's stage is free
    const int nt = kt + STAGES - 1;
    if (nt < KT) ld.issue(sm, nt % STAGES, nt);
    cp_async_commit();
    convert_a<Cfg<WG>::Q_LD>(sm.q[(kt + 1) % STAGES], col, an);
  }
  wgmma_wait<0>();
}

template <int WG, int BT, int MODE>
__global__ void __launch_bounds__(128 * WG)
w8a16_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                  int M, int N, int K) {
  using C = Cfg<WG>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The swizzle is a function of the address: every x tile starts on 1024 bytes.
  Smem<WG, BT>& sm = *reinterpret_cast<Smem<WG, BT>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n0 = blockIdx.x * C::BN;
  const int m0 = blockIdx.y * BT;
  const int KT = (K + BK - 1) / BK;
  const int g = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int col = 64 * g + 16 * warp;  // this warp's 16 output channels
  const int nl = col + 2 * (lane / 4);  // this thread's: nl, nl + 1
  const int t = lane % 4;

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  uint32_t a0[BK / 16][4], a1[BK / 16][4];

  if (MODE > 0 && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&sm.x_full[i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const Loader<WG, BT, MODE> ld(&xmap, x, q, M, N, K, m0, n0);
  // Prologue: tiles 0 .. STAGES - 2 in flight, tile 0 converted.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < KT) ld.issue(sm, i, i);
    cp_async_commit();
  }
  ld.template wait<STAGES - 2>(sm, 0, 0);
  fence_proxy_async();
  __syncthreads();
  convert_a<C::Q_LD>(sm.q[0], col, a0);
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) reg_fence(acc[i]);
  for (int kt = 0; kt < KT; kt += 2) {
    k_step<WG, BT, MODE>(sm, ld, kt, KT, acc, a0, a1, col);
    if (kt + 1 < KT)
      k_step<WG, BT, MODE>(sm, ld, kt + 1, KT, acc, a1, a0, col);
  }
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) reg_fence(acc[i]);

  // acc[4 j + {0, 1}]: channel nl, tokens 8 j + 2 t + {0, 1};
  // acc[4 j + {2, 3}]: channel nl + 1, the same tokens.
  const int n = n0 + nl;
  if (n >= N) return;
  const bool two = n + 1 < N;
  const bool pair = two && (N % 2) == 0;  // 4-byte aligned bf16 pairs
  const float s0 = s[n];
  const float s1 = two ? s[n + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * j + 2 * t + i;
      if (m >= M) continue;
      const float v0 = acc[4 * j + i] * s0;
      const float v1 = acc[4 * j + 2 + i] * s1;
      __nv_bfloat16* o = out + static_cast<size_t>(m) * N + n;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (two) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int WG, int BT, int MODE>
int launch(const void* x, const void* q, const void* s, void* out, int M, int N,
           int K, cudaStream_t st) {
  constexpr int smem = static_cast<int>(sizeof(Smem<WG, BT>)) + 1024;  // + alignment
  // Above 48 KB dynamic shared memory must be opted into (once per kernel).
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a16_sm90_kernel<WG, BT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // x as a TMA tensor (MODE > 0: K % 8 == 0 and x 16-byte aligned, so its
  // row stride is a multiple of 16 bytes): boxes of 64 x BT, 128-byte
  // swizzle, out-of-range elements read as zero.
  CUtensorMap xmap = {};
  if (MODE > 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t box[2] = {BK, BT};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult r = cuTensorMapEncodeTiled(
        &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + Cfg<WG>::BN - 1) / Cfg<WG>::BN, (M + BT - 1) / BT);
  w8a16_sm90_kernel<WG, BT, MODE><<<grid, Cfg<WG>::THREADS, smem, st>>>(xmap,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int WG, int BT>
int dispatch_mode(int mode, const void* x, const void* q, const void* s, void* out,
                  int M, int N, int K, cudaStream_t st) {
  switch (mode) {
    case 2: return launch<WG, BT, 2>(x, q, s, out, M, N, K, st);
    case 1: return launch<WG, BT, 1>(x, q, s, out, M, N, K, st);
    case 0: return launch<WG, BT, 0>(x, q, s, out, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tile: 64 output channels per warpgroup times wg warpgroups (1 or 2), by
// tile_m tokens (64, 128 or 160); mode: 2 = 16-byte copies of x and
// q, 1 = 16-byte copies of x and 8-byte copies of q, 0 = element loads
// (the wrapper's sm90_load_mode states when each applies).
extern "C" int w8a16_matmul_sm90(const void* x, const void* q, const void* s,
                                 void* out, int M, int N, int K, int wg, int tile_m,
                                 int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define W8A16_TILE(W, T) \
  if (wg == W && tile_m == T) return dispatch_mode<W, T>(mode, x, q, s, out, M, N, K, st);
  W8A16_TILE(1, 64) W8A16_TILE(1, 128) W8A16_TILE(1, 160)
  W8A16_TILE(2, 64) W8A16_TILE(2, 128) W8A16_TILE(2, 160)
#undef W8A16_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
