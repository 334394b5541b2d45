// int8 x int8 -> int32 2D convolution with the float requantize epilogue, for Hopper
// (sm_90a).
//
// Replaces the int8 convolution of holocron_tpu/quant.py:_quantized_conv
// (quant.py:259-274), which the JAX package leaves to XLA
// (lax.conv_general_dilated with preferred_element_type=int32). PyTorch has no int8
// convolution on CUDA, so the port needs its own.
//
//   acc[n,oy,ox,o] = sum_{r,s,c} x[n, oy*sh - ph + r*dh, ox*sw - pw + s*dw, c] * w[r,s,c,o]
//   y = float(acc) * (s_x * w_scale[o]) + bias[o]        (quant.py:270-273's order)
//
// x is int8 NHWC, w is int8 HWIO, acc is int32 (exact), y is stored as float32 or
// bfloat16; out_dtype 2 stores the raw int32 accumulator instead. groups must be 1.
//
// Form: implicit GEMM on the tensor cores. Rows are output pixels (M = N*OH*OW),
// columns output channels (O), and the reduction runs over K = KH*KW*C in the
// (r, s, c) order in which HWIO weights already lie as a row-major (K, O) matrix. A
// block of 8 warps computes a 128x64 tile of the output, 64 reduction elements a
// step; each warp owns a 32x32 sub-tile and issues 2 x 4 x 2
// mma.sync.m16n8k32.s32.s8.s8.s32 a step. Shared memory holds A and B as packed
// 4-byte words of 4 consecutive reduction elements (low byte first), which is the
// register fragment layout of that mma, so fragments load with plain 32-bit reads.
// Two shared-memory stages: the global loads of step i+1 are in flight while the
// tensor cores work on step i, with one barrier a step.
//
// Staging is what bounds a simple form of this kernel (a first version that loaded
// A word by word and B byte by byte ran no faster on the tensor cores than with
// dp4a). So, on the fast path (C % 16 == 0, O % 4 == 0, aligned operands, which all
// of repvgg_a0's int8 layers meet): A is gathered as one 16-byte load of 16
// channels of one pixel per thread and row, the filter tap is tracked incrementally
// instead of divided out, and B is read as 4-byte runs of 4 output channels from 4
// reduction rows, transposed in registers with byte permutes. Other shapes take
// byte-wise loads into the same layout.
//
// Next: a deeper cp.async (or TMA) ring feeding wgmma, and the activation
// quantization fused into the A-tile load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 64;        // reduction elements per step (two m16n8k32 steps)
constexpr int BKW = BK / 4;   // packed 4-byte words per step
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 outputs each
// Row pitches in words. A: 20, so that the 32 lanes of a fragment read (8 rows x 4
// words) fall in 32 different banks and a row start stays 16-byte aligned. B: 72, for
// the same reason (4 rows x 8 columns).
constexpr int A_LD = BKW + 4;
constexpr int B_LD = BN + 8;

struct ConvShape {
  int h, w, c, o;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int oh, ow;
  long long m;  // N * OH * OW
  int k;        // KH * KW * C
};

// The byte-wise path: 4 reduction elements kk..kk+3 of one output pixel, packed
// little-endian; zero outside the image and past K.
__device__ __forceinline__ int gather_a_word(const int8_t* __restrict__ x, const ConvShape& s, long long img,
                                             int iy0, int ix0, int kk) {
  int packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = kk + i;
    if (e >= s.k) break;
    const int tap = e / s.c;
    const int ch = e - tap * s.c;
    const int r = tap / s.kw;
    const int iy = iy0 + r * s.dh;
    const int ix = ix0 + (tap - r * s.kw) * s.dw;
    if (static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
        static_cast<unsigned>(ix) < static_cast<unsigned>(s.w)) {
      const int8_t v = x[((img * s.h + iy) * s.w + ix) * s.c + ch];
      packed |= static_cast<int>(static_cast<uint8_t>(v)) << (8 * i);
    }
  }
  return packed;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool kFast, typename OutT>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ s_x,
    const float* __restrict__ w_scale, const void* __restrict__ bias, int bias_bf16,
    OutT* __restrict__ out, ConvShape s) {
  __shared__ __align__(16) int a_tile[2][BM][A_LD];
  __shared__ __align__(16) int b_tile[2][BKW][B_LD];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int o0 = blockIdx.y * BN;

  // A stager: 16 reduction elements (4 words, the a_q-th quarter of the step) of rows
  // tid / 4 and tid / 4 + 64
  const int a_q = tid % 4;
  long long a_img[2];
  int a_iy0[2], a_ix0[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + tid / 4 + r * (BM / 2);
    a_ok[r] = m < s.m;
    const long long mm = a_ok[r] ? m : 0;
    const int ox = static_cast<int>(mm % s.ow);
    const long long t = mm / s.ow;
    const int oy = static_cast<int>(t % s.oh);
    a_img[r] = t / s.oh;
    a_iy0[r] = oy * s.sh - s.ph;
    a_ix0[r] = ox * s.sw - s.pw;
  }
  // fast path: filter tap (fr, fs) and channel of this thread's first element,
  // advanced by BK every step
  int fr = 0, fs = 0, fch = 16 * a_q;
  if (kFast) {
    while (fch >= s.c) {
      fch -= s.c;
      if (++fs == s.kw) {
        fs = 0;
        ++fr;
      }
    }
  }
  // B stager: reduction rows 4 * b_kq .. +3, output channels 4 * b_oq .. +3
  const int b_kq = tid / 16;
  const int b_oq = tid % 16;
  const int b_o = o0 + 4 * b_oq;

  int4 a_reg[2];
  int4 b_reg;

  auto load_stage = [&](int k0) {
    if constexpr (kFast) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a_reg[r] = make_int4(0, 0, 0, 0);
        const int iy = a_iy0[r] + fr * s.dh;
        const int ix = a_ix0[r] + fs * s.dw;
        if (a_ok[r] && fr < s.kh && static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
            static_cast<unsigned>(ix) < static_cast<unsigned>(s.w)) {
          a_reg[r] = *reinterpret_cast<const int4*>(x + ((a_img[r] * s.h + iy) * s.w + ix) * s.c + fch);
        }
      }
      fch += BK;
      while (fch >= s.c) {
        fch -= s.c;
        if (++fs == s.kw) {
          fs = 0;
          ++fr;
        }
      }
      int rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + 4 * b_kq + i;
        rows[i] = (kk < s.k && b_o < s.o)
                      ? *reinterpret_cast<const int*>(w + static_cast<long long>(kk) * s.o + b_o)
                      : 0;
      }
      // 4x4 byte transpose: word j takes byte j of rows 0..3, i.e. the 4 reduction
      // elements of output channel b_o + j
      const int lo01 = __byte_perm(rows[0], rows[1], 0x5140);
      const int hi01 = __byte_perm(rows[0], rows[1], 0x7362);
      const int lo23 = __byte_perm(rows[2], rows[3], 0x5140);
      const int hi23 = __byte_perm(rows[2], rows[3], 0x7362);
      b_reg = make_int4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                        __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = a_ok[r] ? gather_a_word(x, s, a_img[r], a_iy0[r], a_ix0[r], k0 + 16 * a_q + 4 * j) : 0;
        }
        a_reg[r] = make_int4(v[0], v[1], v[2], v[3]);
      }
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int packed = 0;
        const int o = b_o + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = k0 + 4 * b_kq + i;
          if (kk < s.k && o < s.o) {
            packed |= static_cast<int>(static_cast<uint8_t>(w[static_cast<long long>(kk) * s.o + o])) << (8 * i);
          }
        }
        v[j] = packed;
      }
      b_reg = make_int4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<int4*>(&a_tile[buf][tid / 4 + r * (BM / 2)][4 * a_q]) = a_reg[r];
    }
    // b_tile[kw][o] holds reduction elements 4kw..4kw+3 of output channel o
    const int o = 4 * b_oq;
    b_tile[buf][b_kq][o + 0] = b_reg.x;
    b_tile[buf][b_kq][o + 1] = b_reg.y;
    b_tile[buf][b_kq][o + 2] = b_reg.z;
    b_tile[buf][b_kq][o + 3] = b_reg.w;
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row (A, C) or column (B) within its group of 8
  const int t = lane % 4;  // fragment word within each half of a 32-element k step
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int steps = (s.k + BK - 1) / BK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_stage((step + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BKW; ks += 8) {
      int a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm + 16 * i + g;
        a[i][0] = a_tile[buf][row][ks + t];
        a[i][1] = a_tile[buf][row + 8][ks + t];
        a[i][2] = a_tile[buf][row][ks + t + 4];
        a[i][3] = a_tile[buf][row + 8][ks + t + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + 8 * j + g;
        b[j][0] = b_tile[buf][ks + t][col];
        b[j][1] = b_tile[buf][ks + t + 4][col];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    if (step + 1 < steps) store_stage(buf ^ 1);
    __syncthreads();
  }

  // accumulator fragment: acc[i][j][q] is row wm + 16i + g + 8(q / 2), column
  // wn + 8j + 2t + (q % 2)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int o = o0 + wn + 8 * j + 2 * t + q2;
      if (o >= s.o) continue;
      float scale = 0.f, bv = 0.f;
      if constexpr (!std::is_same<OutT, int>::value) {
        scale = __fmul_rn(*s_x, w_scale[o]);
        if (bias != nullptr) {
          bv = bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o])
                         : static_cast<const float*>(bias)[o];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int q1 = 0; q1 < 2; ++q1) {
          const long long m = m0 + wm + 16 * i + g + 8 * q1;
          if (m >= s.m) continue;
          const int v = acc[i][j][2 * q1 + q2];
          if constexpr (std::is_same<OutT, int>::value) {
            out[m * s.o + o] = v;
          } else {
            float y = __fmul_rn(__int2float_rn(v), scale);
            if (bias != nullptr) y = __fadd_rn(y, bv);
            store_out(out + m * s.o + o, y);
          }
        }
      }
    }
  }
}

template <bool kFast>
void launch(const void* x, const void* w, const void* s_x, const void* w_scale, const void* bias,
            int bias_bf16, void* out, int out_dtype, const ConvShape& s, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((s.m + BM - 1) / BM), static_cast<unsigned int>((s.o + BN - 1) / BN));
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sx = static_cast<const float*>(s_x);
  const auto* ws = static_cast<const float*>(w_scale);
  if (out_dtype == 0) {
    int8_conv_kernel<kFast, float><<<grid, THREADS, 0, stream>>>(xq, wq, sx, ws, bias, bias_bf16,
                                                                 static_cast<float*>(out), s);
  } else if (out_dtype == 1) {
    int8_conv_kernel<kFast, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        xq, wq, sx, ws, bias, bias_bf16, static_cast<__nv_bfloat16*>(out), s);
  } else {
    int8_conv_kernel<kFast, int><<<grid, THREADS, 0, stream>>>(xq, wq, sx, ws, bias, bias_bf16,
                                                               static_cast<int*>(out), s);
  }
}

}  // namespace

extern "C" const char* holocron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out_dtype: 0 = float32, 1 = bfloat16 (both with the epilogue), 2 = raw int32
// accumulator. fast requires C % 16 == 0, O % 4 == 0, x 16-byte aligned and w
// 4-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int int8_conv_forward(const void* x, const void* w, const void* s_x, const void* w_scale,
                                 const void* bias, int bias_bf16, void* out, int out_dtype, int n, int h,
                                 int w_in, int c, int o, int kh, int kw, int sh, int sw, int ph, int pw,
                                 int dh, int dw, int oh, int ow, int fast, void* stream) {
  if (out_dtype < 0 || out_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape s{h, w_in, c, o, kh, kw, sh, sw, ph, pw, dh, dw, oh, ow,
                    static_cast<long long>(n) * oh * ow, kh * kw * c};
  if (s.m == 0 || s.o == 0) return 0;
  if (fast && (c % 16 != 0 || o % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(w) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  if (fast) {
    launch<true>(x, w, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, cu_stream);
  } else {
    launch<false>(x, w, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, cu_stream);
  }
  return static_cast<int>(cudaGetLastError());
}
