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
// (the |.| is a free operand modifier) in the forward, a subtract, a sign and a fused
// multiply-add in each gradient. At the JAX package's measured layer (L 12544, D 576,
// O 128) that is 0.92 G element steps a pass against 35 MB of operands, so the design
// spends everything on keeping the FP32 pipes fed. The three kernels share one shape:
//
// - a block computes a tile of outputs, each thread a register block of them whose
//   rows and columns are spread over the tile so that a warp's 16-byte shared-memory
//   loads fall on distinct banks (Config: register block, thread grid, chunk, stages);
// - the reduced dimension streams through shared memory in chunks, in a ring of
//   16-byte cp.async copies (stage_box), the next chunks in flight while this one is
//   used, one barrier a chunk. Every operand is staged row by row as it lies in device
//   memory, with no transpose: the forward's p rows run along D (its reduced axis) and
//   w's chunk is rows of D; dp's g and w rows both run along O (its reduced axis); dw's
//   p and g rows are chunks of L. A row whose length or pointer is not a whole 16-byte
//   vector is staged element by element instead;
// - ragged edges are masked at the load: a position past the end is staged as 0 in
//   both operands (|0 - 0| = 0, and g = 0 kills a gradient term), nothing is padded in
//   device memory, and stores are guarded;
// - no atomics: every sum is taken in one order, so two runs give the same bits.
//
// The forward's element step is the two instructions above. A gradient's sign by
// compares and selects takes three or four integer/logic-pipe instructions a step, a
// pipe that runs at half the float pipe's rate. Both gradients scale the difference
// by 2^24 so that a saturating instruction turns it into the sign exactly: dw's step
// (add_g_sign_scaled) is two fused multiply-adds, a saturating multiply and one bitwise
// op; dp's (half_step) is three fused multiply-adds, one of them saturating, and no
// integer op, at the price of a running sum of g a row and of bit-equality with the
// exact step. A sum that meets an operand outside the steps' range, or a row of dp whose
// sum of g is not finite (an infinite g, an overflow), is redone with the exact step
// (add_g_sign) from device memory, so infinities and NaNs are the exact step's. dp
// scales its p, fixed per thread, once; dw its w. dw reduces over L, the longest
// dimension, with only (D/64)*(O/64) output tiles, so L is split into slices over
// blocks, each writing float32 partial sums that a second pass adds in slice order; the
// slice count makes the (tile, slice) blocks the same whole number for every SM
// (kernels/add2d.py:dw_slices).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // dw's output tile edge
constexpr int kThreads = 256; // threads of a block of the dw reduction pass

// A kernel's blocking: each thread owns RL x RC sums, the TY x TX threads a TILE_L x
// TILE_C tile; the reduced dimension is staged K at a time in a ring of STAGES chunks,
// and a chunk is walked KU 16-byte vectors an iteration (the unrolled body, whose
// loads the compiler may hoist: more unrolling, more registers).
template <int RL_, int RC_, int TY_, int TX_, int K_, int STAGES_, int KU_>
struct Config {
  static constexpr int RL = RL_, RC = RC_, TY = TY_, TX = TX_, K = K_, STAGES = STAGES_, KU = KU_;
  static constexpr int THREADS = TY * TX, TILE_L = RL * TY, TILE_C = RC * TX;
};

// Chosen by timing candidates at L 12544, D 576, O 128 (PERF.md, PR 7's table).
using FwdConfig = Config<8, 4, 8, 16, 32, 3, 1>;
using DpConfig = Config<8, 4, 8, 16, 32, 3, 2>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// N consecutive values from shared memory as float32, 16 (or for four bf16, 8) bytes a load
template <int N>
__device__ __forceinline__ void load_vals(const float* s, float (&v)[N]) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(s)[q];
    v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void unpack_bf16x2(unsigned int u, float* v) {  // bfloat16 is the upper half of a float32
  v[0] = __uint_as_float(u << 16), v[1] = __uint_as_float(u & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* s, float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(s)[q];
      unpack_bf16x2(u.x, v + 8 * q), unpack_bf16x2(u.y, v + 8 * q + 2);
      unpack_bf16x2(u.z, v + 8 * q + 4), unpack_bf16x2(u.w, v + 8 * q + 6);
    }
  } else {
    static_assert(N % 4 == 0, "whole 8-byte groups");
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 u = reinterpret_cast<const uint2*>(s)[q];
      unpack_bf16x2(u.x, v + 4 * q), unpack_bf16x2(u.y, v + 4 * q + 2);
    }
  }
}

// Starts staging rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the row-major src
// (ld columns, row_end rows) into dst (a row every PITCH elements), zeros past row_end
// or ld, and commits the copies as one cp.async group. vec: ld and src are whole
// 16-byte vectors, so whole 16-byte cp.async copies, zero-filled past the edges; else
// element by element through registers.
template <int ROWS, int COLS, int PITCH, int THREADS, typename T>
__device__ __forceinline__ void stage_box(T* dst, const T* __restrict__ src, int ld, int r0, int row_end, int c0,
                                          bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), kUnits = COLS / E;
  static_assert(COLS % E == 0 && PITCH % E == 0, "rows of whole 16-byte vectors");
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * kUnits; i += THREADS) {
      const int r = i / kUnits, c = (i % kUnits) * E;
      const bool in = r0 + r < row_end && c0 + c < ld;
      const T* from = in ? src + static_cast<long long>(r0 + r) * ld + c0 + c : src;
      const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(dst + r * PITCH + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      dst[r * PITCH + c] = (r0 + r < row_end && c0 + c < ld) ? src[static_cast<long long>(r0 + r) * ld + c0 + c]
                                                            : static_cast<T>(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void commit_empty() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void wait_groups() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The pitch of a staged row of K reduced-dimension values read 16 bytes at a time
// along the row: one 16-byte vector more than K, an odd number of vectors, so the
// rows that the threads of a warp read at once start on distinct banks.
template <typename T, int K>
__host__ __device__ constexpr int row_pitch() {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  static_assert(K % (2 * E) == 0, "an even number of 16-byte vectors a chunk");
  return K + E;
}

// ---- forward ----

// The forward's ring: p's chunk [TILE_L][pitch] and w's [K][TILE_C] a stage.
template <typename T, class C>
__host__ __device__ constexpr int forward_smem_bytes() {
  return C::STAGES * (C::TILE_L * row_pitch<T, C::K>() + C::K * C::TILE_C) * static_cast<int>(sizeof(T));
}

// out[l,o] = -sum_d |p[l,d] - w[d,o]|; grid (ceil(L / TILE_L), ceil(O / TILE_C)). Thread
// (ty, tx) owns rows l0 + ty + TY i and the column quads o0 + 4 tx + 4 TX q: per 16-byte
// vector of p (E values of d) it reads RL vectors of p and, for each of the E values of
// d, RC / 4 quads of w's row.
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS) add2d_forward_kernel(
    const T* __restrict__ p, const T* __restrict__ w, T* __restrict__ out, int L, int D, int O, bool vec_p,
    bool vec_w) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), PP = row_pitch<T, C::K>();
  constexpr int KU = C::KU < C::K / E ? C::KU : C::K / E;  // 16-byte vectors an iteration
  static_assert(C::RC % 4 == 0 && C::K % (E * KU) == 0, "whole column quads, whole unrolled bodies");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ps = reinterpret_cast<T*>(smem);              // [STAGES][TILE_L][PP]: p[l, d] as [l][d]
  T* ws = ps + C::STAGES * C::TILE_L * PP;         // [STAGES][K][TILE_C]: w[d, o] as [d][o]
  const int l0 = blockIdx.x * C::TILE_L, o0 = blockIdx.y * C::TILE_C;
  const int ty = threadIdx.x / C::TX, tx = threadIdx.x % C::TX;
  const int chunks = (D + C::K - 1) / C::K;
  const auto stage = [&](int c) {
    stage_box<C::TILE_L, C::K, PP, C::THREADS>(ps + (c % C::STAGES) * C::TILE_L * PP, p, D, l0, L, c * C::K, vec_p);
    stage_box<C::K, C::TILE_C, C::TILE_C, C::THREADS>(ws + (c % C::STAGES) * C::K * C::TILE_C, w, O, c * C::K, D, o0,
                                                      vec_w);
  };
  float acc[C::RL][C::RC] = {};
  for (int c = 0; c < C::STAGES - 1; ++c) {  // the ring's first chunks (empty groups past the end)
    if (c < chunks) stage(c); else commit_empty();
  }
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed, and every thread is done with chunk c - 1, whose stage is refilled next
    wait_groups<C::STAGES - 2>();
    __syncthreads();
    if (c + C::STAGES - 1 < chunks) stage(c + C::STAGES - 1); else commit_empty();
    const T* pc = ps + (c % C::STAGES) * C::TILE_L * PP;
    const T* wc = ws + (c % C::STAGES) * C::K * C::TILE_C;
#pragma unroll 1
    for (int k0 = 0; k0 < C::K; k0 += E * KU) {
#pragma unroll
      for (int k = k0; k < k0 + E * KU; k += E) {
        float pv[C::RL][E];
#pragma unroll
        for (int i = 0; i < C::RL; ++i) load_vals<E>(pc + (ty + C::TY * i) * PP + k, pv[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float wv[C::RC];
#pragma unroll
          for (int q = 0; q < C::RC / 4; ++q) {
            float quad[4];
            load_vals<4>(wc + (k + e) * C::TILE_C + 4 * tx + 4 * C::TX * q, quad);
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[4 * q + j] = quad[j];
          }
#pragma unroll
          for (int i = 0; i < C::RL; ++i) {
#pragma unroll
            for (int j = 0; j < C::RC; ++j) acc[i][j] += fabsf(pv[i][e] - wv[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C::RL; ++i) {
    const int l = l0 + ty + C::TY * i;
#pragma unroll
    for (int j = 0; j < C::RC; ++j) {
      const int o = o0 + 4 * tx + 4 * C::TX * (j / 4) + j % 4;
      if (l < L && o < O) store(out + static_cast<long long>(l) * O + o, -acc[i][j]);
    }
  }
}

// ---- the gradients' sign step ----

// acc + g * sign(d), with sign(0) = 0 and sign(NaN) = NaN as jnp.sign: copysign(1, d)
// where |d| > 0 (false for NaN, where d != 0 would be true), else d itself.
__device__ __forceinline__ float add_g_sign(float acc, float g, float d) {
  const float s = fabsf(d) > 0.f ? __uint_as_float((__float_as_uint(d) & 0x80000000u) | 0x3f800000u) : d;
  return fmaf(g, s, acc);
}

// dw's step: the same with one integer/logic-pipe op where add_g_sign takes three (a
// compare, a bitwise op and a select), given d = fma(a, 2^24, nb) for a - b with nb =
// -b 2^24, or d = fma(b, -2^24, na) with na = a 2^24, a and b finite and below 2^100 in
// magnitude so the scaled operand is exact: d is (a - b) 2^24 rounded once, so it has
// the sign of a - b and is 0 exactly where a == b; a nonzero a - b is at least 2^-149,
// so |d| >= 2^-125 and sat(|d| 2^125) is exactly 1, else 0. g with d's sign bit, times
// that, is g * sign(a - b), and the sum is add_g_sign's, bit for bit.
constexpr float kScale = 0x1p24f, kUnscale = 0x1p125f, kInRange = 0x1p100f;
__device__ __forceinline__ float add_g_sign_scaled(float acc, float g, float d) {
  const float t = __uint_as_float(__float_as_uint(g) ^ (__float_as_uint(d) & 0x80000000u));
  return fmaf(t, __saturatef(fabsf(d) * kUnscale), acc);
}

// dp's step: (sign(a - b) + 1) / 2 from the same d, in one saturating fused
// multiply-add and no integer op: sat(d 2^125 + 1/2) is 1 where d >= 2^-125, 1/2 where
// d == 0 and 0 where d <= -2^-125 (a NaN d saturates to 0: NaNs take the exact redo).
// So sum g * sign(a - b) = 2 sum g * half_step(d) - sum g, which is exactly 0 where
// a == b all along the sum (halving commutes with rounding); elsewhere it differs from
// add_g_sign's sum in rounding, so dp is not bit-equal to the exact step's. The sum of
// g can also overflow, or meet an infinite g (Inf - Inf = NaN where the signed sum is
// -Inf), where the signed sum does not: a row whose sum of g is not finite is redone
// exactly. The other sum overflows alone only where the signed sum does too, and then
// gives its infinity (a finite sum g minus twice +-Inf).
__device__ __forceinline__ float half_step(float d) { return __saturatef(fmaf(d, kUnscale, 0.5f)); }

// ---- dp ----

// dp's ring: g's chunk [TILE_L][pitch] and w's [TILE_C][pitch] a stage; then w's flags.
template <typename T, class C>
__host__ __device__ constexpr int dp_smem_bytes() {
  return C::STAGES * (C::TILE_L + C::TILE_C) * row_pitch<T, C::K>() * static_cast<int>(sizeof(T)) +
         C::TILE_C * static_cast<int>(sizeof(int));
}

// dp[l,d] = -sum_o g[l,o] * sign(p[l,d] - w[d,o]); grid (ceil(L / TILE_L), ceil(D / TILE_C)).
// Thread (ty, tx) owns rows l0 + ty + TY i and columns d0 + tx + TX j, its p values held
// in registers as p 2^24. Per 16-byte vector along O it reads RL vectors of g and RC of
// w (rows of w are contiguous along O), and sums g * half_step and, a row, g: dp is
// sum g - 2 sum g * half_step. A block's threads check each staged chunk of w for values
// outside the step's range (flags, one a row of the tile); a sum whose p is not below
// 2^100 (NaN and infinities included), whose row of w was flagged or whose row's sum of
// g is not finite is redone exactly from device memory, in the same order.
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS) add2d_backward_dp_kernel(
    const T* __restrict__ p, const T* __restrict__ w, const T* __restrict__ g, T* __restrict__ dp, int L, int D,
    int O, bool vec_g, bool vec_w) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), PP = row_pitch<T, C::K>();
  constexpr int kStage = (C::TILE_L + C::TILE_C) * PP, kUnits = C::TILE_C * C::K / E;
  constexpr int KU = C::KU < C::K / E ? C::KU : C::K / E;  // 16-byte vectors an iteration
  static_assert(C::K % (E * KU) == 0, "whole unrolled bodies");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES]: g[l, o] as [l][o], then w[d, o] as [d][o]
  int* w_out_of_range = reinterpret_cast<int*>(ring + C::STAGES * kStage);  // [TILE_C]
  const int l0 = blockIdx.x * C::TILE_L, d0 = blockIdx.y * C::TILE_C;
  const int ty = threadIdx.x / C::TX, tx = threadIdx.x % C::TX;
  const int chunks = (O + C::K - 1) / C::K;
  const auto stage = [&](int c) {
    T* s = ring + (c % C::STAGES) * kStage;
    stage_box<C::TILE_L, C::K, PP, C::THREADS>(s, g, O, l0, L, c * C::K, vec_g);
    stage_box<C::TILE_C, C::K, PP, C::THREADS>(s + C::TILE_L * PP, w, O, d0, D, c * C::K, vec_w);
  };
  for (int i = threadIdx.x; i < C::TILE_C; i += C::THREADS) w_out_of_range[i] = 0;  // before the first barrier
  float na[C::RL][C::RC], acc[C::RL][C::RC], gsum[C::RL];
  bool p_in_range = true;
#pragma unroll
  for (int i = 0; i < C::RL; ++i) {
    gsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::RC; ++j) {
      const int l = l0 + ty + C::TY * i, d = d0 + tx + C::TX * j;
      const float v = (l < L && d < D) ? to_f32(p[static_cast<long long>(l) * D + d]) : 0.f;
      p_in_range = p_in_range && fabsf(v) < kInRange;
      na[i][j] = v * kScale;
      acc[i][j] = 0.f;
    }
  }
  for (int c = 0; c < C::STAGES - 1; ++c) {  // the ring's first chunks (empty groups past the end)
    if (c < chunks) stage(c); else commit_empty();
  }
  for (int c = 0; c < chunks; ++c) {
    wait_groups<C::STAGES - 2>();
    __syncthreads();
    if (c + C::STAGES - 1 < chunks) stage(c + C::STAGES - 1); else commit_empty();
    const T* gc = ring + (c % C::STAGES) * kStage;
    const T* wc = gc + C::TILE_L * PP;
#pragma unroll
    for (int u = threadIdx.x; u < kUnits; u += C::THREADS) {  // flag rows of w with a value outside the range
      float v[E];
      const int r = u / (C::K / E);
      load_vals<E>(wc + r * PP + (u % (C::K / E)) * E, v);
      bool out_of_range = false;
#pragma unroll
      for (int e = 0; e < E; ++e) out_of_range = out_of_range || !(fabsf(v[e]) < kInRange);
      if (out_of_range) w_out_of_range[r] = 1;
    }
#pragma unroll 1
    for (int k0 = 0; k0 < C::K; k0 += E * KU) {
#pragma unroll
      for (int k = k0; k < k0 + E * KU; k += E) {
        float gv[C::RL][E], wv[C::RC][E];
#pragma unroll
        for (int i = 0; i < C::RL; ++i) load_vals<E>(gc + (ty + C::TY * i) * PP + k, gv[i]);
#pragma unroll
        for (int j = 0; j < C::RC; ++j) load_vals<E>(wc + (tx + C::TX * j) * PP + k, wv[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int i = 0; i < C::RL; ++i) {
            gsum[i] += gv[i][e];
#pragma unroll
            for (int j = 0; j < C::RC; ++j)
              acc[i][j] = fmaf(gv[i][e], half_step(fmaf(wv[j][e], -kScale, na[i][j])), acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();  // every chunk's flags are written
#pragma unroll
  for (int i = 0; i < C::RL; ++i) {
    const int l = l0 + ty + C::TY * i;
    const bool exact = !p_in_range || !isfinite(gsum[i]);
#pragma unroll
    for (int j = 0; j < C::RC; ++j) {
      const int d = d0 + tx + C::TX * j;
      if (l >= L || d >= D) continue;
      const float v = fmaf(-2.f, acc[i][j], gsum[i]);
      if (exact || w_out_of_range[tx + C::TX * j]) {
        const float pf = to_f32(p[static_cast<long long>(l) * D + d]);
        float a = 0.f;
        for (int o = 0; o < O; ++o)
          a = add_g_sign(a, to_f32(g[static_cast<long long>(l) * O + o]),
                         pf - to_f32(w[static_cast<long long>(d) * O + o]));
        store(dp + static_cast<long long>(l) * D + d, -a);
      } else {
        store(dp + static_cast<long long>(l) * D + d, v);
      }
    }
  }
}

// ---- dw ----

constexpr int kDwRows = 32;     // rows of L a ring stage holds
constexpr int kDwStages = 3;    // ring stages: two chunks in flight while one is used
constexpr int kDwThreads = 128; // 8 x 16 threads, an 8 (d) x 4 (o) block of sums each

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
  const auto stage = [&](int c) {
    const int slot = c % kDwStages, l0 = l_begin + c * kDwRows;
    stage_box<kDwRows, kTile, kTile, kDwThreads>(&ps[slot][0][0], p, D, l0, l_end, d0, vec_p);
    stage_box<kDwRows, kTile, kTile, kDwThreads>(&gs[slot][0][0], g, O, l0, l_end, o0, vec_g);
  };
  // nw: -w * 2^24 for add_g_sign_scaled; chk[i]: the sum of p * 0 over row i's values,
  // NaN once one of them is not finite
  float nw[8][4], acc[8][4], chk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    chk[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 8 * ty + i, o = o0 + 4 * tx + j;
      nw[i][j] = (d < D && o < O) ? -kScale * to_f32(w[static_cast<long long>(d) * O + o]) : 0.f;
      acc[i][j] = 0.f;
    }
  }
  for (int c = 0; c < kDwStages - 1; ++c) {  // the ring's first chunks (empty copy groups past the end)
    if (c < chunks) stage(c); else commit_empty();
  }
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed (at most kDwStages - 2 later groups pending), and every thread
    // is done with chunk c - 1, whose stage is refilled next
    wait_groups<kDwStages - 2>();
    __syncthreads();
    if (c + kDwStages - 1 < chunks) stage(c + kDwStages - 1); else commit_empty();
    const T (*pc)[kTile] = ps[c % kDwStages];
    const T (*gc)[kTile] = gs[c % kDwStages];
#pragma unroll 4
    for (int r = 0; r < kDwRows; ++r) {  // rows past l_end are zeros: g = 0 adds +-0
      float pv[8], gv[4];
      load_vals(&pc[r][8 * ty], pv);
      load_vals(&gc[r][4 * tx], gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        chk[i] = fmaf(pv[i], 0.f, chk[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = add_g_sign_scaled(acc[i][j], gv[j], fmaf(pv[i], kScale, nw[i][j]));
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
      if (d < D && o < O && (chk[i] != chk[i] || !(fabsf(nw[i][j]) < kInRange * kScale))) {
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

bool aligned16(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }
unsigned int blocks_for(int n, int tile) { return static_cast<unsigned int>((n + tile - 1) / tile); }

template <typename T>
int forward(const void* p, const void* w, void* out, int L, int D, int O, cudaStream_t s) {
  using C = FwdConfig;
  constexpr int E = 16 / static_cast<int>(sizeof(T)), kBytes = forward_smem_bytes<T, C>();
  const auto kernel = add2d_forward_kernel<T, C>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks_for(L, C::TILE_L), blocks_for(O, C::TILE_C)), C::THREADS, kBytes, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(w), static_cast<T*>(out), L, D, O,
      D % E == 0 && aligned16(p), O % E == 0 && aligned16(w));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_dp(const void* p, const void* w, const void* g, void* dp, int L, int D, int O, cudaStream_t s) {
  using C = DpConfig;
  constexpr int E = 16 / static_cast<int>(sizeof(T)), kBytes = dp_smem_bytes<T, C>();
  const auto kernel = add2d_backward_dp_kernel<T, C>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = O % E == 0;
  kernel<<<dim3(blocks_for(L, C::TILE_L), blocks_for(D, C::TILE_C)), C::THREADS, kBytes, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(dp), L, D, O,
      vec && aligned16(g), vec && aligned16(w));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_dw(const void* p, const void* w, const void* g, void* partial, void* dw, int L, int D, int O,
                int slices, int rows, cudaStream_t s) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const long long blocks = static_cast<long long>(slices) * blocks_for(D, kTile) * blocks_for(O, kTile);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long size = static_cast<long long>(D) * O;
  float* part = static_cast<float*>(partial);
  add2d_backward_dw_partial_kernel<T><<<static_cast<unsigned int>(blocks), kDwThreads, 0, s>>>(
      static_cast<const T*>(p), static_cast<const T*>(w), static_cast<const T*>(g), part, L, D, O, rows,
      D % E == 0 && aligned16(p), O % E == 0 && aligned16(g));
  add2d_backward_dw_reduce_kernel<T><<<static_cast<unsigned int>((size + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, static_cast<T*>(dw), size, slices);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return forward<float>(p, w, out, L, D, O, s);
  if (dtype == 1) return forward<__nv_bfloat16>(p, w, out, L, D, O, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int add2d_backward_dp(const void* p, const void* w, const void* g, void* dp, int dtype,
                                 int L, int D, int O, void* stream) {
  if (L == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward_dp<float>(p, w, g, dp, L, D, O, s);
  if (dtype == 1) return backward_dp<__nv_bfloat16>(p, w, g, dp, L, D, O, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 0) return backward_dw<float>(p, w, g, partial, dw, L, D, O, slices, rows, s);
  if (dtype == 1) return backward_dw<__nv_bfloat16>(p, w, g, partial, dw, L, D, O, slices, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
