// AdderNet "matmul" for Hopper (sm_90a): forward and both gradients.
//
// Replaces holocron_tpu/kernels/add2d.py: the Pallas TPU kernel _add2d_kernel behind
// add2d_matmul (the forward) and the XLA backward _add2d_bwd of add2d_matmul_ad:
//
//   out[l,o] = -sum_d |p[l,d] - w[d,o]|
//   dp[l,d]  = -sum_o g[l,o] * sign(p[l,d] - w[d,o])
//   dw[d,o]  =  sum_l g[l,o] * sign(p[l,d] - w[d,o])
//
// p is (L, D), w is (D, O), g and out are (L, O), all row-major and of one dtype
// (float32 or bfloat16). Sums are float32; each result is rounded once into the
// dtype. sign(0) = 0 and a NaN difference gives NaN, as torch.sign and jnp.sign do.
//
// What bounds it: operations. |x - w| has no tensor-core form, so every element step
// of the L*D*O product is CUDA-core work: a subtract and an add of an absolute value
// (the |.| is a free operand modifier) in the forward, a subtract, a sign select and
// a fused multiply-add in each gradient. At the JAX package's measured layer (L 12544,
// D 576, O 128) that is 0.92 G element steps a pass against 35 MB of operands, so the
// design spends everything on keeping the FP32 pipes fed:
//
// - one block computes a 64 x 64 output tile with 256 threads; each thread owns a 4 x 4
//   register block, so one element step costs two float4 shared-memory loads per 16
//   (l, o) pairs;
// - the reduced dimension is streamed through shared memory in chunks of 16, both
//   operands laid out [chunk][64] so a thread's four values are one 16-byte load;
// - ragged edges are masked at the load: a position past the end is staged as 0 in
//   both operands (|0 - 0| = 0, and g = 0 kills a gradient term), nothing is padded in
//   device memory, and stores are guarded;
// - dw reduces over L, the longest dimension, with only (D/64)*(O/64) output tiles, so
//   L is split into slices over blocks; each slice writes float32 partial sums and a
//   second pass adds the slices in slice order. No atomics: the result is the same on
//   every run.
//
// Next step: double-buffered chunks (cp.async) and an 8 x 4 register block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 16;    // reduced-dimension chunk staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = kTile + 4;  // row pitch of a staged chunk: keeps float4 alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// sign(x) with sign(0) = 0 and sign(NaN) = NaN
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// Stages src[r0 + r, k0 + k] (row-major, leading dimension ld, rows < R, cols < K) as
// dst[k][r]: a tile whose rows are the output rows and whose columns are the reduced
// dimension, transposed so that the reduced dimension indexes the chunk.
template <typename T>
__device__ __forceinline__ void stage_transposed(float (*dst)[kPitch], const T* __restrict__ src, int ld,
                                                 int r0, int R, int k0, int K) {
  for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
    const int r = idx / kChunk, k = idx % kChunk;
    const int gr = r0 + r, gk = k0 + k;
    dst[k][r] = (gr < R && gk < K) ? to_f32(src[static_cast<long long>(gr) * ld + gk]) : 0.f;
  }
}

// Stages src[k0 + k, c0 + c] as dst[k][c]: rows are the reduced dimension already.
template <typename T>
__device__ __forceinline__ void stage_direct(float (*dst)[kPitch], const T* __restrict__ src, int ld,
                                             int k0, int K, int c0, int C) {
  for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
    const int k = idx / kTile, c = idx % kTile;
    const int gk = k0 + k, gc = c0 + c;
    dst[k][c] = (gk < K && gc < C) ? to_f32(src[static_cast<long long>(gk) * ld + gc]) : 0.f;
  }
}

// Loads the thread's 4 x 4 block src[r0 + 4*ty + i, c0 + 4*tx + j] into registers.
template <typename T>
__device__ __forceinline__ void load_block(float (&v)[4][4], const T* __restrict__ src, int ld,
                                           int r0, int R, int c0, int C) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      v[i][j] = (r < R && c < C) ? to_f32(src[static_cast<long long>(r) * ld + c]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_block(T* __restrict__ dst, int ld, int r0, int R, int c0, int C,
                                            const float (&v)[4][4], float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * ty + i, c = c0 + 4 * tx + j;
      if (r < R && c < C) store(dst + static_cast<long long>(r) * ld + c, scale * v[i][j]);
    }
  }
}

// out[l,o] = -sum_d |p[l,d] - w[d,o]|; grid (ceil(O/64), ceil(L/64))
template <typename T>
__global__ void __launch_bounds__(kThreads) add2d_forward_kernel(
    const T* __restrict__ p, const T* __restrict__ w, T* __restrict__ out, int L, int D, int O) {
  __shared__ __align__(16) float ps[kChunk][kPitch];  // p[l, d] as [d][l]
  __shared__ __align__(16) float ws[kChunk][kPitch];  // w[d, o] as [d][o]
  const int l0 = blockIdx.y * kTile, o0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    stage_transposed(ps, p, D, l0, L, d0, D);
    stage_direct(ws, w, O, d0, D, o0, O);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ps[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(av[i] - bv[j]);
      }
    }
    __syncthreads();
  }
  store_block(out, O, l0, L, o0, O, acc, -1.f);
}

// dp[l,d] = -sum_o g[l,o] * sign(p[l,d] - w[d,o]); grid (ceil(D/64), ceil(L/64))
template <typename T>
__global__ void __launch_bounds__(kThreads) add2d_backward_dp_kernel(
    const T* __restrict__ p, const T* __restrict__ w, const T* __restrict__ g, T* __restrict__ dp,
    int L, int D, int O) {
  __shared__ __align__(16) float gs[kChunk][kPitch];  // g[l, o] as [o][l]
  __shared__ __align__(16) float ws[kChunk][kPitch];  // w[d, o] as [o][d]
  const int l0 = blockIdx.y * kTile, d0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float pv[4][4];
  load_block(pv, p, D, l0, L, d0, D);
  float acc[4][4] = {};
  for (int o0 = 0; o0 < O; o0 += kChunk) {
    stage_transposed(gs, g, O, l0, L, o0, O);
    stage_transposed(ws, w, O, d0, D, o0, O);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      const float gv[4] = {a.x, a.y, a.z, a.w}, wv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], sgn(pv[i][j] - wv[j]), acc[i][j]);
      }
    }
    __syncthreads();
  }
  store_block(dp, D, l0, L, d0, D, acc, -1.f);
}

// partial[s, d, o] = sum_{l in slice s} g[l,o] * sign(p[l,d] - w[d,o]);
// grid (ceil(O/64), ceil(D/64), slices), each slice `rows` rows of L long
template <typename T>
__global__ void __launch_bounds__(kThreads) add2d_backward_dw_partial_kernel(
    const T* __restrict__ p, const T* __restrict__ w, const T* __restrict__ g, float* __restrict__ partial,
    int L, int D, int O, int rows) {
  __shared__ __align__(16) float ps[kChunk][kPitch];  // p[l, d] as [l][d]
  __shared__ __align__(16) float gs[kChunk][kPitch];  // g[l, o] as [l][o]
  const int d0 = blockIdx.y * kTile, o0 = blockIdx.x * kTile;
  const int l_begin = blockIdx.z * rows;
  const int l_end = min(L, l_begin + rows);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float wv[4][4];
  load_block(wv, w, O, d0, D, o0, O);
  float acc[4][4] = {};
  for (int l0 = l_begin; l0 < l_end; l0 += kChunk) {
    stage_direct(ps, p, D, l0, l_end, d0, D);
    stage_direct(gs, g, O, l0, l_end, o0, O);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ps[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[k][4 * tx]);
      const float pv[4] = {a.x, a.y, a.z, a.w}, gv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[j], sgn(pv[i] - wv[i][j]), acc[i][j]);
      }
    }
    __syncthreads();
  }
  store_block(partial + static_cast<long long>(blockIdx.z) * D * O, O, d0, D, o0, O, acc, 1.f);
}

// dw[i] = sum_s partial[s, i], in slice order
template <typename T>
__global__ void __launch_bounds__(kThreads) add2d_backward_dw_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ dw, long long size, int slices) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += partial[s * size + idx];
  store(dw + idx, acc);
}

dim3 tiles(int cols, int rows, int depth = 1) {
  return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, depth);
}

}  // namespace

extern "C" const char* holocron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns cudaGetLastError() after
// its launches.
extern "C" int add2d_forward(const void* p, const void* w, void* out, int dtype, int L, int D, int O,
                             void* stream) {
  if (L == 0 || O == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    add2d_forward_kernel<float><<<tiles(O, L), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), static_cast<float*>(out), L, D, O);
  } else if (dtype == 1) {
    add2d_forward_kernel<__nv_bfloat16><<<tiles(O, L), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), L, D, O);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int add2d_backward_dp(const void* p, const void* w, const void* g, void* dp, int dtype,
                                 int L, int D, int O, void* stream) {
  if (L == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    add2d_backward_dp_kernel<float><<<tiles(D, L), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), static_cast<const float*>(g),
        static_cast<float*>(dp), L, D, O);
  } else if (dtype == 1) {
    add2d_backward_dp_kernel<__nv_bfloat16><<<tiles(D, L), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dp), L, D, O);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial: float32 scratch of slices * D * O elements; rows: rows of L per slice
// (slices * rows >= L).
extern "C" int add2d_backward_dw(const void* p, const void* w, const void* g, void* partial, void* dw,
                                 int dtype, int L, int D, int O, int slices, int rows, void* stream) {
  if (D == 0 || O == 0) return 0;
  if (slices <= 0 || rows <= 0 || static_cast<long long>(slices) * rows < L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const long long size = static_cast<long long>(D) * O;
  const unsigned int reduce_blocks = static_cast<unsigned int>((size + kThreads - 1) / kThreads);
  if (dtype == 0) {
    add2d_backward_dw_partial_kernel<float><<<tiles(O, D, slices), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), static_cast<const float*>(g), part,
        L, D, O, rows);
    add2d_backward_dw_reduce_kernel<float><<<reduce_blocks, kThreads, 0, s>>>(
        part, static_cast<float*>(dw), size, slices);
  } else if (dtype == 1) {
    add2d_backward_dw_partial_kernel<__nv_bfloat16><<<tiles(O, D, slices), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(g), part, L, D, O, rows);
    add2d_backward_dw_reduce_kernel<__nv_bfloat16><<<reduce_blocks, kThreads, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), size, slices);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
