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
// dtype. sign(0) = 0 and a NaN difference gives NaN, as jnp.sign does.
//
// What bounds it: operations. |x - w| has no tensor-core form, so every element step
// of the L*D*O product is CUDA-core work: a subtract and an add of an absolute value
// (the |.| is a free operand modifier) in the forward, a subtract, a sign select and
// a fused multiply-add in each gradient. At the JAX package's measured layer (L 12544,
// D 576, O 128) that is 0.92 G element steps a pass against 35 MB of operands, so the
// design spends everything on keeping the FP32 pipes fed:
//
// - one block computes a 64 x 64 output tile; in the forward and dp 256 threads each
//   own a 4 x 4 register block, so one element step costs two float4 shared-memory
//   loads per 16 (l, o) pairs;
// - there the reduced dimension is streamed through shared memory in chunks of 16, both
//   operands laid out [chunk][64] so a thread's four values are one 16-byte load;
// - ragged edges are masked at the load: a position past the end is staged as 0 in
//   both operands (|0 - 0| = 0, and g = 0 kills a gradient term), nothing is padded in
//   device memory, and stores are guarded;
// - dw reduces over L, the longest dimension, with only (D/64)*(O/64) output tiles, so
//   L is split into slices over blocks; each slice writes float32 partial sums and a
//   second pass adds the slices in slice order. No atomics: the result is the same on
//   every run. dw's operands need no transpose (p[l, d0:d0+64] and g[l, o0:o0+64] are
//   contiguous rows), so its chunks of 32 rows stream into a ring of three stages with
//   16-byte cp.async copies, the next chunks in flight during this chunk's products; 128
//   threads each own an 8 x 4 register block, w's block held in registers; and the
//   slice count makes the (tile, slice) blocks the same whole number for every SM
//   (kernels/add2d.py:dw_slices). Its element step, sign included, is four
//   instructions of which one (a bitwise op) goes to the integer/logic pipe, which
//   issues at half the float pipe's rate: a sign by compares and selects takes three or
//   four of that pipe's slots a step, which bounded the earlier dw (add_g_sign_scaled).
//
// Next step for the forward and dp: the same ring and register block.

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

// ---- dw ----

constexpr int kDwRows = 32;     // rows of L a ring stage holds
constexpr int kDwStages = 3;    // ring stages: two chunks in flight while one is used
constexpr int kDwThreads = 128; // 8 x 16 threads, an 8 (d) x 4 (o) block of sums each

// acc + g * sign(d), with sign(0) = 0 and sign(NaN) = NaN as jnp.sign: copysign(1, d)
// where |d| > 0 (false for NaN, where d != 0 would be true), else d itself.
__device__ __forceinline__ float add_g_sign(float acc, float g, float d) {
  const float s = fabsf(d) > 0.f ? __uint_as_float((__float_as_uint(d) & 0x80000000u) | 0x3f800000u) : d;
  return fmaf(g, s, acc);
}

// The same step with one integer/logic-pipe op where add_g_sign takes three (a compare,
// a bitwise op and a select), for finite p and |w| < 2^100, given nw = -w * 2^24 (exact):
// d = fma(p, 2^24, nw) is (p - w) * 2^24 rounded, so it has the sign of p - w and is 0
// exactly where p == w; a nonzero p - w is at least 2^-149, so |d| >= 2^-125 and
// sat(|d| * 2^125) is exactly 1, else 0. g with d's sign bit, times that, is g * sign(p - w),
// and the sum is add_g_sign's, bit for bit.
constexpr float kDwScale = 0x1p24f, kDwUnscale = 0x1p125f, kDwScaledLimit = 0x1p124f;  // |nw| < 2^100 * 2^24
__device__ __forceinline__ float add_g_sign_scaled(float acc, float g, float p, float nw) {
  const float d = fmaf(p, kDwScale, nw);
  const float t = __uint_as_float(__float_as_uint(g) ^ (__float_as_uint(d) & 0x80000000u));
  return fmaf(t, __saturatef(fabsf(d) * kDwUnscale), acc);
}

// N consecutive values from shared memory as float32
template <int N>
__device__ __forceinline__ void load_row(const float* s, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(s)[q];
    v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* s, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {  // bfloat16 is the upper half of a float32
    const unsigned int u = reinterpret_cast<const unsigned int*>(s)[q];
    v[2 * q] = __uint_as_float(u << 16), v[2 * q + 1] = __uint_as_float(u & 0xffff0000u);
  }
}

// Starts staging rows [l0, l0 + kDwRows) x columns [c0, c0 + 64) of the row-major src
// (leading dimension ld = its column count C) into dst, zeros past l_end or C. vec: ld
// and src are 16-byte aligned, so whole 16-byte cp.async copies, zero-filled past the
// edges; else element by element through registers.
template <typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[kTile], const T* __restrict__ src, int ld, int l0, int l_end,
                                           int c0, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), kUnits = kTile / E;
  if (vec) {
    for (int i = threadIdx.x; i < kDwRows * kUnits; i += kDwThreads) {
      const int r = i / kUnits, col = c0 + (i % kUnits) * E;
      const bool in = l0 + r < l_end && col < ld;
      const T* from = in ? src + static_cast<long long>(l0 + r) * ld + col : src;
      const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(&dst[r][(i % kUnits) * E]));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < kDwRows * kTile; i += kDwThreads) {
      const int r = i / kTile, col = c0 + i % kTile;
      dst[r][i % kTile] = (l0 + r < l_end && col < ld) ? src[static_cast<long long>(l0 + r) * ld + col]
                                                       : static_cast<T>(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// partial[s, d, o] = sum_{l in slice s} g[l,o] * sign(p[l,d] - w[d,o]); block b takes
// the 64 x 64 (d, o) tile b % tiles and the slice b / tiles, `rows` rows of L long.
template <typename T>
__global__ void __launch_bounds__(kDwThreads) add2d_backward_dw_partial_kernel(
    const T* __restrict__ p, const T* __restrict__ w, const T* __restrict__ g, float* __restrict__ partial,
    int L, int D, int O, int rows, bool vec_p, bool vec_g) {
  __shared__ __align__(16) T ps[kDwStages][kDwRows][kTile];  // p[l, d] as [l][d]
  __shared__ __align__(16) T gs[kDwStages][kDwRows][kTile];  // g[l, o] as [l][o]
  const int tiles_o = (O + kTile - 1) / kTile, tiles = tiles_o * ((D + kTile - 1) / kTile);
  const int d0 = (blockIdx.x % tiles / tiles_o) * kTile, o0 = (blockIdx.x % tiles % tiles_o) * kTile;
  const int l_begin = (blockIdx.x / tiles) * rows, l_end = min(L, l_begin + rows);
  const int chunks = max(0, (l_end - l_begin + kDwRows - 1) / kDwRows);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // rows d0 + 8 ty + i, columns o0 + 4 tx + j
  // nw: -w * 2^24 for add_g_sign_scaled; chk[i]: the sum of p * 0 over row i's values,
  // NaN once one of them is not finite
  float nw[8][4], acc[8][4], chk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    chk[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 8 * ty + i, o = o0 + 4 * tx + j;
      nw[i][j] = (d < D && o < O) ? -kDwScale * to_f32(w[static_cast<long long>(d) * O + o]) : 0.f;
      acc[i][j] = 0.f;
    }
  }
  for (int c = 0; c < kDwStages - 1; ++c) {  // the ring's first chunks (empty copy groups past the end)
    if (c < chunks) {
      stage_rows(ps[c], p, D, l_begin + c * kDwRows, l_end, d0, vec_p);
      stage_rows(gs[c], g, O, l_begin + c * kDwRows, l_end, o0, vec_g);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed (at most kDwStages - 2 later groups pending), and every thread
    // is done with chunk c - 1, whose stage is refilled next
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDwStages - 2) : "memory");
    __syncthreads();
    const int next = c + kDwStages - 1, slot = next % kDwStages;
    if (next < chunks) {
      stage_rows(ps[slot], p, D, l_begin + next * kDwRows, l_end, d0, vec_p);
      stage_rows(gs[slot], g, O, l_begin + next * kDwRows, l_end, o0, vec_g);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const T (*pc)[kTile] = ps[c % kDwStages];
    const T (*gc)[kTile] = gs[c % kDwStages];
#pragma unroll 4
    for (int r = 0; r < kDwRows; ++r) {  // rows past l_end are zeros: g = 0 adds +-0
      float pv[8], gv[4];
      load_row(&pc[r][8 * ty], pv);
      load_row(&gc[r][4 * tx], gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        chk[i] = fmaf(pv[i], 0.f, chk[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = add_g_sign_scaled(acc[i][j], gv[j], pv[i], nw[i][j]);
      }
    }
  }
  // A sum that met a p that is not finite, or a w outside the scaled step's range, again
  // with add_g_sign from device memory, in the same order.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 8 * ty + i, o = o0 + 4 * tx + j;
      if (d < D && o < O && (chk[i] != chk[i] || !(fabsf(nw[i][j]) < kDwScaledLimit))) {
        const float wf = to_f32(w[static_cast<long long>(d) * O + o]);
        float a = 0.f;
        for (int l = l_begin; l < l_end; ++l)
          a = add_g_sign(a, to_f32(g[static_cast<long long>(l) * O + o]),
                         to_f32(p[static_cast<long long>(l) * D + d]) - wf);
        acc[i][j] = a;
      }
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x / tiles) * D * O;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 8 * ty + i, o = o0 + 4 * tx + j;
      if (d < D && o < O) out[static_cast<long long>(d) * O + o] = acc[i][j];
    }
  }
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

dim3 tiles(int cols, int rows) { return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile); }

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
  const long long blocks = static_cast<long long>(slices) * ((D + kTile - 1) / kTile) * ((O + kTile - 1) / kTile);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const long long size = static_cast<long long>(D) * O;
  const unsigned int reduce_blocks = static_cast<unsigned int>((size + kThreads - 1) / kThreads);
  const int elems = dtype == 0 ? 4 : 8;  // per 16 bytes
  const auto aligned = [](const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; };
  const bool vec_p = D % elems == 0 && aligned(p), vec_g = O % elems == 0 && aligned(g);
  if (dtype == 0) {
    add2d_backward_dw_partial_kernel<float><<<static_cast<unsigned int>(blocks), kDwThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), static_cast<const float*>(g), part,
        L, D, O, rows, vec_p, vec_g);
    add2d_backward_dw_reduce_kernel<float><<<reduce_blocks, kThreads, 0, s>>>(
        part, static_cast<float*>(dw), size, slices);
  } else if (dtype == 1) {
    add2d_backward_dw_partial_kernel<__nv_bfloat16><<<static_cast<unsigned int>(blocks), kDwThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(g), part, L, D, O, rows, vec_p, vec_g);
    add2d_backward_dw_reduce_kernel<__nv_bfloat16><<<reduce_blocks, kThreads, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), size, slices);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
