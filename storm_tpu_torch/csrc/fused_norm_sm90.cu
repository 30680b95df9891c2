// Fused residual add + LayerNorm, designed for Hopper: y = x + r; out =
// (y - mean) * rsqrt(var + eps) * g + b. The sum y is formed in f32 and
// written rounded to the input dtype; mean and the centred variance are
// two passes over the d valid columns of that f32 sum, and out is computed
// from the unrounded f32 y, then rounded — the arithmetic of the TPU kernel.
//
// Replaces the Pallas TPU kernel storm_tpu/ops/fused_norm.py:_kernel
// (pallas_call at :76), which reads x and r once, keeps the sum in VMEM and
// writes the residual stream and the normed tensor in one pass.
//
// Bound on an H100 SXM at the ViT-B/16 shape (batch 8: 1576 rows of 768,
// bf16): 2 reads + 2 writes = 9.7 MB, so ~2.9 us a call at 3.35 TB/s; the
// arithmetic (~10 operations an element) is negligible. Memory-bound, and
// at 4.8 MB of reads a call, bound in practice by how many bytes are in
// flight: the first version (fused_norm.cu: one 256-thread block per row,
// 2-byte loads, the row in shared memory, four barriers) waits on latency.
//
// Design:
// - A row group of lanes owns a row: LANES (8, 16 or 32) lanes of one warp
//   for the widths the model zoo uses, or, for every other width (the
//   runtime-d instantiation, LANES = 0), the whole block of up to 256 lanes.
//   Lane l owns the 16-byte vectors l, l + lanes, l + 2 lanes, ... of the
//   row (8 bf16 or 4 f32 each), so a warp's loads cover contiguous 512-byte
//   spans.
// - Each lane issues all its loads of x and r before any arithmetic, so a
//   warp has its whole row in flight, and keeps the row in registers:
//   both statistics are taken from the registers by warp shuffles. Only a
//   row that spans warps exchanges per-warp partials through shared memory,
//   with one barrier per statistic; no barrier on a row of one warp.
// - g and b are read once per lane, in their own dtype (bf16 or f32; P is a
//   template parameter, so the wrapper casts nothing), in 8- or 16-byte
//   loads where they are aligned, and kept as loaded: each value becomes
//   f32 only in the output's multiply-add. Converting them as they arrive
//   made every warp wait for them before it issued its row's loads (on the
//   card, ~2 us a call of the ~6). They are reused for every row the group
//   handles: the grid is at most the card's resident capacity and loops
//   over rows.
// - 16-byte loads and stores where d is a multiple of the vector and x and
//   r start 16-byte aligned (VEC_IO); otherwise the same kernel moves one
//   element at a time (an offset view, a ragged width).
//
// What is left (ViT-B/16, batch 8): a call is one wave of ~12 warps per SM,
// so launch, DRAM latency and the tail, not bandwidth, take the time beyond
// the byte bound; kernel_sweep.py norm times the kernel beside a one-kernel
// copy of the same bytes.
#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // threads of a block; lanes of a block-wide group

// The bits of one element, and their conversion to and from f32.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = uint32_t;
  __device__ static float to_f32(U u) { return __uint_as_float(u); }
  __device__ static U from_f32(float v) { return __float_as_uint(v); }
};
template <>
struct Bits<__nv_bfloat16> {
  using U = uint16_t;
  __device__ static float to_f32(U u) { return __uint_as_float(static_cast<uint32_t>(u) << 16); }
  __device__ static U from_f32(float v) { return __bfloat16_as_ushort(__float2bfloat16(v)); }
};

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes

// 16 bytes of a row: one vector load or store, or kVec element ones.
template <typename T>
union Chunk {
  uint4 v;
  typename Bits<T>::U e[kVec<T>];
};

// The N parameters (g or b) of one vector, in their own dtype P: 8, 16 or 32
// bytes, kept as loaded and converted to f32 only where they are used, so
// no instruction waits on them before the row's statistics are done.
template <typename P, int N>
union Params {
  uint32_t w[N * sizeof(P) / 4];
  typename Bits<P>::U e[N];
};

// The parameters of columns c .. c + N - 1 (zeros past d). vec: p is
// 16-byte aligned and d a multiple of N, so they are one 8-byte load or one
// or two 16-byte loads.
template <typename P, int N>
__device__ __forceinline__ void load_params(Params<P, N>& dst, const P* __restrict__ p,
                                            bool vec, int c, int d) {
  constexpr int kWords = N * sizeof(P) / 4;
  if (vec && c < d) {
    if constexpr (kWords == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(p + c);
      dst.w[0] = t.x;
      dst.w[1] = t.y;
    } else {
#pragma unroll
      for (int k = 0; k < kWords / 4; ++k) {
        const uint4 t = reinterpret_cast<const uint4*>(p + c)[k];
        dst.w[4 * k] = t.x;
        dst.w[4 * k + 1] = t.y;
        dst.w[4 * k + 2] = t.z;
        dst.w[4 * k + 3] = t.w;
      }
    }
  } else {
    const typename Bits<P>::U* q = reinterpret_cast<const typename Bits<P>::U*>(p);
#pragma unroll
    for (int e = 0; e < N; ++e) dst.e[e] = c + e < d ? q[c + e] : 0;
  }
}

// Sum over a row group, the same value in every lane of it. LANES > 0:
// LANES consecutive lanes of one warp (an xor below LANES stays inside the
// group). LANES == 0: the whole block; each warp reduces by shuffles, then
// the warps' partials go through red (one barrier) and every thread adds
// them in one fixed order. The caller passes a separate red for each
// statistic of a row: the barrier of the next use then orders every read of
// the previous one before any write.
template <int LANES>
__device__ __forceinline__ float group_sum(float v, float* red) {
  constexpr int kWidth = LANES ? LANES : 32;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (LANES == 0) {
    const int warps = blockDim.x / 32;
    if (warps > 1) {
      if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
      __syncthreads();
      v = 0.f;
      for (int w = 0; w < warps; ++w) v += red[w];
    }
  }
  return v;
}

// Every load of one row by one lane: VPL 16-byte chunks each of x and r
// (zeros past d, or for a group past the last row), all issued before any
// of them is used.
template <typename T, int VPL, bool VEC_IO>
__device__ __forceinline__ void load_row(Chunk<T> (&xa)[VPL], Chunk<T> (&ra)[VPL],
                                         const T* __restrict__ x, const T* __restrict__ r,
                                         bool live, size_t off, int lanes, int lane, int d) {
  using U = typename Bits<T>::U;
  constexpr int N = kVec<T>;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c0 = (v * lanes + lane) * N;
    if constexpr (VEC_IO) {
      if (live && c0 < d) {
        xa[v].v = *reinterpret_cast<const uint4*>(x + off + c0);
        ra[v].v = *reinterpret_cast<const uint4*>(r + off + c0);
      } else {
        xa[v].v = ra[v].v = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const U* xu = reinterpret_cast<const U*>(x) + off;
      const U* ru = reinterpret_cast<const U*>(r) + off;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const bool ok = live && c0 + e < d;
        xa[v].e[e] = ok ? xu[c0 + e] : U(0);
        ra[v].e[e] = ok ? ru[c0 + e] : U(0);
      }
    }
  }
}

// VPL vectors per lane cover a row of up to lanes * VPL * kVec<T> columns.
// Every lane of a block runs the same number of row iterations (the loop
// steps over whole blocks of rows), so the shuffles always see a full warp;
// a group past the last row computes on zeros and stores nothing.
template <typename T, typename P, int LANES, int VPL, bool VEC_IO>
__global__ void __launch_bounds__(MAX_THREADS)
residual_layernorm_sm90_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               const P* __restrict__ g, const P* __restrict__ b,
                               bool vec_params, T* __restrict__ y,
                               T* __restrict__ out, int rows, int d, float eps) {
  using U = typename Bits<T>::U;
  constexpr int N = kVec<T>;
  __shared__ float red_mean[MAX_THREADS / 32], red_var[MAX_THREADS / 32];
  constexpr int kLanes = LANES ? LANES : 1;  // a divisor in both cases
  const int lanes = LANES ? LANES : static_cast<int>(blockDim.x);
  const int lane = LANES ? static_cast<int>(threadIdx.x % kLanes) : static_cast<int>(threadIdx.x);
  const int groups = LANES ? static_cast<int>(blockDim.x / kLanes) : 1;
  const int group = LANES ? static_cast<int>(threadIdx.x / kLanes) : 0;

  Params<P, N> gp[VPL], bp[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    load_params(gp[v], g, vec_params, (v * lanes + lane) * N, d);
    load_params(bp[v], b, vec_params, (v * lanes + lane) * N, d);
  }

  for (int base = blockIdx.x * groups; base < rows; base += gridDim.x * groups) {
    const int row = base + group;
    const bool live = row < rows;
    const size_t off = static_cast<size_t>(row) * d;
    Chunk<T> xa[VPL], ra[VPL];
    load_row<T, VPL, VEC_IO>(xa, ra, x, r, live, off, lanes, lane, d);

    // Columns past d hold 0 + 0 and add nothing to the sum; they are
    // masked out of the variance, and both divide by the valid d.
    float yv[VPL][N];
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        yv[v][e] = Bits<T>::to_f32(xa[v].e[e]) + Bits<T>::to_f32(ra[v].e[e]);
        s += yv[v][e];
      }
    }
    const float mean = group_sum<LANES>(s, red_mean) / d;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float dv = yv[v][e] - mean;
        if ((v * lanes + lane) * N + e < d) q += dv * dv;
      }
    }
    const float rstd = rsqrtf(group_sum<LANES>(q, red_var) / d + eps);

#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c0 = (v * lanes + lane) * N;
      Chunk<T> yc, oc;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        yc.e[e] = Bits<T>::from_f32(yv[v][e]);
        oc.e[e] = Bits<T>::from_f32((yv[v][e] - mean) * rstd * Bits<P>::to_f32(gp[v].e[e]) +
                                    Bits<P>::to_f32(bp[v].e[e]));
      }
      if constexpr (VEC_IO) {
        if (live && c0 < d) {
          *reinterpret_cast<uint4*>(y + off + c0) = yc.v;
          *reinterpret_cast<uint4*>(out + off + c0) = oc.v;
        }
      } else {
        U* yu = reinterpret_cast<U*>(y) + off;
        U* ou = reinterpret_cast<U*>(out) + off;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          if (live && c0 + e < d) {
            yu[c0 + e] = yc.e[e];
            ou[c0 + e] = oc.e[e];
          }
        }
      }
    }
  }
}

struct Args {
  const void *x, *r, *g, *b;
  bool bf16_params;
  void *y, *out;
  int rows, d;
  float eps;
  int lanes, rows_per_block;
  bool vec_io;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of `threads` threads of KERNEL that the current card holds
// resident at once. The runtime is asked on the first launch per device and
// block size only: the occupancy query costs host time of the order of a
// launch, on a kernel launched 12 times a forward.
template <auto KERNEL>
cudaError_t resident_blocks(int threads, int* blocks) {
  constexpr int kDevices = 64;
  static std::atomic<long long> cache[kDevices];  // threads << 32 | blocks; 0: not yet asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const long long hit = dev < kDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (hit >> 32 == threads) {
    *blocks = static_cast<int>(hit & 0xffffffff);
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, threads, 0);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  if (dev < kDevices)
    cache[dev].store(static_cast<long long>(threads) << 32 | *blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// One launch of the (LANES, VPL) instantiation: a block holds
// rows_per_block groups of LANES lanes (or, for LANES = 0, one group of
// a.lanes), and the grid is the fewer of one block per rows_per_block rows
// and the blocks the card holds resident at once.
template <typename T, typename P, int LANES, int VPL>
int launch_with(const Args& a) {
  const int lanes = LANES ? LANES : a.lanes;
  const int groups = LANES ? a.rows_per_block : 1;
  const int threads = lanes * groups;
  if (threads < 32 || threads % 32 || threads > MAX_THREADS ||
      (LANES == 0 && a.rows_per_block != 1) ||
      static_cast<long long>(lanes) * VPL * kVec<T> < a.d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.vec_io && (a.d % kVec<T> || !aligned16(a.x) || !aligned16(a.r) ||
                   !aligned16(a.y) || !aligned16(a.out)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kVecKernel = residual_layernorm_sm90_kernel<T, P, LANES, VPL, true>;
  constexpr auto kElemKernel = residual_layernorm_sm90_kernel<T, P, LANES, VPL, false>;
  auto kernel = a.vec_io ? kVecKernel : kElemKernel;
  int resident = 0;
  const cudaError_t e = a.vec_io ? resident_blocks<kVecKernel>(threads, &resident)
                                 : resident_blocks<kElemKernel>(threads, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (a.rows + groups - 1) / groups;
  const int grid = std::max(1, std::min(blocks, resident));
  kernel<<<grid, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), static_cast<const P*>(a.g),
      static_cast<const P*>(a.b), a.d % kVec<T> == 0 && aligned16(a.g) && aligned16(a.b),
      static_cast<T*>(a.y), static_cast<T*>(a.out), a.rows, a.d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LANES, int VPL>
int launch(const Args& a) {
  return a.bf16_params ? launch_with<T, __nv_bfloat16, LANES, VPL>(a)
                       : launch_with<T, float, LANES, VPL>(a);
}

}  // namespace

// The instantiations (lanes, vectors per lane), mirrored in
// storm_tpu_torch/ops/fused_norm.py: NORM_PLANS for the zoo's widths (and
// (16, 6), bf16 at 768, for the plan sweep), RUNTIME_VECTORS for the
// runtime-d one, which takes any lanes that are a multiple of 32.
extern "C" int residual_layernorm_sm90(int dtype, int param_dtype, const void* x,
                                       const void* r, const void* g, const void* b,
                                       void* y, void* out, int rows, int d, float eps,
                                       int lanes, int vectors, int load_mode,
                                       int rows_per_block, void* stream) {
  if ((param_dtype != DTYPE_BF16 && param_dtype != DTYPE_F32) || load_mode < 0 ||
      load_mode > 1 || rows_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, r, g, b, param_dtype == DTYPE_BF16, y, out, rows, d, eps,
               lanes, rows_per_block, load_mode == 1, static_cast<cudaStream_t>(stream)};
  if (dtype == DTYPE_BF16) {
    using T = __nv_bfloat16;
    if (lanes == 8 && vectors == 1) return launch<T, 8, 1>(a);     // d = 64
    if (lanes == 32 && vectors == 1) return launch<T, 32, 1>(a);   // d = 256
    if (lanes == 32 && vectors == 2) return launch<T, 32, 2>(a);   // d = 512
    if (lanes == 32 && vectors == 3) return launch<T, 32, 3>(a);   // d = 768
    if (lanes == 16 && vectors == 6) return launch<T, 16, 6>(a);   // d = 768, sweep
    if (lanes % 32 == 0 && vectors == 6) return launch<T, 0, 6>(a);  // runtime d
  } else if (dtype == DTYPE_F32) {
    using T = float;
    if (lanes == 16 && vectors == 1) return launch<T, 16, 1>(a);   // d = 64
    if (lanes == 32 && vectors == 2) return launch<T, 32, 2>(a);   // d = 256
    if (lanes == 32 && vectors == 4) return launch<T, 32, 4>(a);   // d = 512
    if (lanes == 32 && vectors == 6) return launch<T, 32, 6>(a);   // d = 768
    if (lanes % 32 == 0 && vectors == 12) return launch<T, 0, 12>(a);  // runtime d
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
