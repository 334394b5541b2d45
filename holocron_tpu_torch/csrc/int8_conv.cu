// int8 x int8 -> int32 2D convolution with the float requantize epilogue, and the
// activation quantization that feeds it: the Hopper route (sm_90a, wgmma).
//
// Replaces holocron_tpu/quant.py:_quantized_conv (quant.py:228-274): its activation
// quantization (quant.py:237-244) and its int8 convolution (quant.py:259-274), which
// the JAX package leaves to XLA (lax.conv_general_dilated with
// preferred_element_type=int32). PyTorch has no int8 convolution on CUDA.
//
//   x_q = clip(round_half_even(float(x) / s_x), -127, 127)             (int8_quantize)
//   acc[m, o] = sum_{r,s,c} x_q[n, oy*sh - ph + r*dh, ox*sw - pw + s*dw, c] * w[r,s,c,o]
//   y = float(acc) * (s_x * w_scale[o]) + bias[o]         (quant.py:270-273's order)
//
// x is NHWC at a pixel pitch of P = C rounded up to whole 16-byte copies, channels C ..
// P - 1 zero (int8_quantize writes it so); w is packed once per layer
// (kernels/int8_conv.py:pack_weights) from HWIO into an (O_pad, K_pad) K-major int8
// matrix over the same pitch, zero beyond C, O and K, so the reduction runs over
// K = KH*KW*P and the zeros add nothing. y is float32 or bfloat16; out_dtype 2 stores
// the raw int32 accumulator. Every ungrouped conv takes this route; grouped convs go to
// int8_conv_general.cu.
//
// What bounds it on an H100: at repvgg_a0's 192- and 1280-channel layers the int8
// tensor-core rate (1,979 TOP/s, reachable only through wgmma); at the 48- and
// 96-channel layers the bytes (the activation read, the output written). The design:
//
// - Implicit GEMM: rows are output pixels (M = N*OH*OW), columns output channels, the
//   reduction K = KH*KW*C runs in (r, s, c) order. A block holds two consumer
//   warpgroups of 64 rows (BM = 128) and one column tile of BN = the layer's whole O
//   rounded up to a wgmma width (48, 64, 96, 128, 192, 256; O > 256 in tiles of 256),
//   so each A element is gathered once per filter tap, not once per 64 columns.
// - Each step is 128 reduction bytes, one 128-byte row of the canonical
//   128-byte-swizzled K-major layout that int8 wgmma reads from shared memory, and
//   four wgmma.m64nBNk32.s32.s8.s8 per warpgroup.
// - Warp specialisation: a third warpgroup only copies, into a ring of up to 4 stages
//   guarded by `full` and `empty` mbarriers; its cp.async.cg 16-byte copies arrive on
//   `full` when they land (cp.async.mbarrier.arrive.noinc). The consumers keep one
//   step's products in flight and release a slot as soon as its products are done.
//   Copies therefore run ahead through the consumers' waits and epilogues. A copy is
//   16 channels of one pixel at one filter tap; the tap is tracked incrementally, so
//   C = 48 (K = 432, not a whole number of steps) needs no padding of the activation;
//   outside the image and past K the copy zero-fills (src-size 0). B is 16-byte
//   copies of the packed weights: no transpose in registers.
// - A persistent grid: each block walks over tiles with stride gridDim.x, as many
//   blocks as are resident at once (two an SM for BN <= 96). The 9 geometries of
//   repvgg_a0 at batch 256 span 98 x 5 to 25,088 x 1 tiles; one resident wave over
//   them keeps the ring flowing across tiles instead of refilling it at each block's
//   start. Index arithmetic is 32-bit: 64-bit division in the per-tile set-up took
//   13% of the kernel's time at the 48-channel 112x112 layer.
// - The epilogue is where the tensor cores idle (one block an SM for BN >= 128), so
//   nothing in it waits on device memory: s_x * w_scale and the bias of the tile's
//   columns go into a shared-memory table before the tile's products, and each
//   warpgroup stages 32 columns at a time in shared memory and writes whole rows with
//   16-byte stores. Where a row of y is not whole 16-byte pieces (O * bytes % 16 != 0,
//   rexnet's odd widths; an instance of its own, kRuns, so that the whole-row one is
//   unchanged), a row is staged from byte (its address in y) % 16 of its staging row,
//   so that y's 16-byte slots are 16-byte pieces of shared memory: a slot the chunk
//   covers wholly is one 16-byte load and store; the slot a chunk shares with the next
//   one of the row is carried over in shared memory, so only a row's first and last
//   slot in a tile go element by element (store_row_runs). A tile that holds all of O,
//   whose 64 rows a warpgroup fit its staging area (O <= 72 in bf16), stages them
//   compactly: one contiguous run of y, 16-byte aligned (64 * O * bytes is a multiple
//   of 128), that leaves in 16-byte pieces (store_flat). Few tiles of 256 columns (an
//   SE excitation at M = the batch) take 64-wide ones instead (kernels/int8_conv.py),
//   which spread the epilogue over more SMs.
// - Quantization is a prologue kernel (int8_quantize: 16 elements a thread, IEEE
//   division, round half to even, clamp), 3 bytes an element. It writes x_q at the
//   pitch P, zero beyond C, 16 bytes a store; where 2C or 4C bytes are not whole
//   16-byte pieces it reads x with the widest loads the row's alignment allows.
//   Quantizing inside the A copy instead moves fewer bytes but divides each element
//   once per filter tap and makes the producer's loads synchronous; it measured 8-14x
//   slower (PERF.md).

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output pixels per tile: two consumer warpgroups of 64 rows
constexpr int BK = 128;          // reduction bytes per step: one 128-byte swizzle row
constexpr int CONSUMERS = 256;   // warpgroups 0 and 1: wgmma and the epilogue
constexpr int PRODUCERS = 128;   // warpgroup 2: the copies
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int A_BYTES = BM * BK;
constexpr int SM_SMEM = 233472;  // shared memory of an SM; each block reserves 1 KB of it
constexpr int MAX_STAGES = 4;    // deeper rings measured no faster (PERF.md)
// Epilogue staging, per consumer warpgroup: 64 rows of 32 columns of up to 4 bytes, each
// row padded by 16 bytes against bank conflicts.
constexpr int EPI_PITCH = 32 * 4 + 16;
constexpr int EPI_WG_BYTES = 64 * EPI_PITCH;

// The copy ring of a BN-wide tile: as many stages as fit, at most MAX_STAGES. Narrow
// tiles run two blocks an SM, so that one block's epilogue overlaps the other's
// products; wider tiles run one, whose consumers take the registers the producer gives
// up (setmaxnreg).
template <int BN>
struct Ring {
  static constexpr int BLOCKS = BN <= 96 ? 2 : 1;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  // alignment slack, epilogue staging, the tile's scales and biases, barriers
  static constexpr int EXTRA = 1024 + 2 * EPI_WG_BYTES + 2 * 256 * 4 + 256;
  static constexpr int FIT = (SM_SMEM / BLOCKS - 1024 - EXTRA) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + EXTRA;
};

struct ConvShape {
  int h, w, c, o;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int oh, ow;
  int m;      // N * OH * OW (below 2^31: index arithmetic in 32 bits, as 64-bit division is slow)
  int k;      // KH * KW * C
  int k_pad;    // K rounded up to whole steps: the row pitch of the packed weights
};

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, both operands K-major in shared memory;
// accumulates into d (scale-d = 1).
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int (&d)[48], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared8(uint32_t dst, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

// synchronizes `threads` threads (whole warps) on barrier `id` (0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row
// atoms of 1024 bytes stacked along M (or N); the atom base must be 1024-aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in that layout.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return static_cast<uint32_t>(row * BK + ((chunk ^ (row & 7)) << 4));
}

// quant.py:244: clip(round(x / s_x), -127, 127) with IEEE division and round half to
// even. A zero (half of a ReLU's output) is answered without dividing: div.rn.f32 sends
// a zero dividend down its slow path.
__device__ __forceinline__ uint32_t quantize_one(float v, float s) {
  if (v == 0.f) return 0u;
  const int q = min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
  return static_cast<uint32_t>(q) & 0xFFu;
}

__device__ __forceinline__ uint32_t quantize4(float a, float b, float c, float d, float s) {
  return quantize_one(a, s) | (quantize_one(b, s) << 8) | (quantize_one(c, s) << 16) | (quantize_one(d, s) << 24);
}

// 8 bfloat16 in a 16-byte word, little-endian: element 2i is the low half of word i
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t quantize4_bf16(uint32_t w0, uint32_t w1, float s) {
  return quantize4(bf16_lo(w0), bf16_hi(w0), bf16_lo(w1), bf16_hi(w1), s);
}

// 16 consecutive elements quantized into one 16-byte word
__device__ __forceinline__ uint4 quantize16(const __nv_bfloat16* p, float s) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 8);
  return make_uint4(quantize4_bf16(lo.x, lo.y, s), quantize4_bf16(lo.z, lo.w, s), quantize4_bf16(hi.x, hi.y, s),
                    quantize4_bf16(hi.z, hi.w, s));
}

__device__ __forceinline__ uint4 quantize16(const float* p, float s) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = v[0], b = v[1], c = v[2], d = v[3];
  return make_uint4(quantize4(a.x, a.y, a.z, a.w, s), quantize4(b.x, b.y, b.z, b.w, s),
                    quantize4(c.x, c.y, c.z, c.w, s), quantize4(d.x, d.y, d.z, d.w, s));
}

// The quantization prologue where C % 16 == 0: the pitch is C, so x_q is x's flat NHWC
// buffer, 16 elements a thread (pieces = elements / 16); x 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(256) int8_quantize_kernel(const T* __restrict__ x, const float* __restrict__ s_x,
                                                            int8_t* __restrict__ q, long long pieces) {
  const float s = *s_x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < pieces; g += stride) {
    *reinterpret_cast<uint4*>(q + 16 * g) = quantize16(x + 16 * g, s);
  }
}

template <int VEC>
struct LoadUnit;
template <>
struct LoadUnit<4> {
  using T = uint32_t;
  static __device__ __forceinline__ void words(T v, uint32_t* w) { w[0] = v; }
};
template <>
struct LoadUnit<8> {
  using T = uint2;
  static __device__ __forceinline__ void words(T v, uint32_t* w) {
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct LoadUnit<16> {
  using T = uint4;
  static __device__ __forceinline__ void words(T v, uint32_t* w) {
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};

// The first `valid` of the 16 elements at p, the rest zero, as the little-endian words
// of their bytes, read VEC bytes a load: p is VEC-byte aligned and `valid` elements are
// whole loads. VEC = 2 (a bfloat16 row of odd C) reads 2 bytes a load.
template <typename T, int VEC>
__device__ __forceinline__ void load_run16(const T* p, int valid, uint32_t (&w)[4 * sizeof(T)]) {
  constexpr int WORDS = 4 * sizeof(T);
  if constexpr (VEC == 2) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      const uint32_t lo = 2 * i < valid ? h[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < valid ? h[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
  } else {
    constexpr int PER = VEC / 4;                          // words a load
    constexpr int ELEMS = VEC / static_cast<int>(sizeof(T));  // elements a load
    const auto* v = reinterpret_cast<const typename LoadUnit<VEC>::T*>(p);
#pragma unroll
    for (int i = 0; i < WORDS / PER; ++i) {
      if (ELEMS * i < valid) {
        LoadUnit<VEC>::words(v[i], w + PER * i);
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) w[PER * i + j] = 0u;
      }
    }
  }
}

__device__ __forceinline__ uint4 quantize_words(const uint32_t (&w)[8], float s) {  // 16 bfloat16
  return make_uint4(quantize4_bf16(w[0], w[1], s), quantize4_bf16(w[2], w[3], s), quantize4_bf16(w[4], w[5], s),
                    quantize4_bf16(w[6], w[7], s));
}

__device__ __forceinline__ uint4 quantize_words(const uint32_t (&w)[16], float s) {  // 16 float32
  uint32_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = quantize4(__uint_as_float(w[4 * i]), __uint_as_float(w[4 * i + 1]), __uint_as_float(w[4 * i + 2]),
                     __uint_as_float(w[4 * i + 3]), s);
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// The quantization prologue where C % 16 != 0: x_q at the pitch P = C rounded up to 16,
// one thread a 16-byte piece (pixel g / chunks, channels 16 (g % chunks) .. + 15),
// channels C .. P - 1 zero. x's rows are C * sizeof(T) bytes, so a pixel's run is only
// VEC-byte aligned; VEC is the widest load that alignment allows.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) int8_quantize_pitched_kernel(const T* __restrict__ x,
                                                                    const float* __restrict__ s_x,
                                                                    int8_t* __restrict__ q, unsigned pieces, int c,
                                                                    unsigned chunks) {
  const float s = *s_x;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned g = blockIdx.x * blockDim.x + threadIdx.x; g < pieces; g += stride) {
    const unsigned pixel = g / chunks;
    const int c0 = 16 * static_cast<int>(g - pixel * chunks);
    uint32_t w[4 * sizeof(T)];
    load_run16<T, VEC>(x + static_cast<long long>(pixel) * c + c0, min(16, c - c0), w);
    *reinterpret_cast<uint4*>(q + 16LL * g) = quantize_words(w, s);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// waits until the barrier's phase with the given parity has completed; traps (a launch
// error, not a hang) if that takes seconds
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 24)) __trap();
  }
}

__device__ __forceinline__ void st_shared2(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// y's elements (b0, b1) of `bytes` bytes each, or b0 alone, into the staging area at
// `addr` (aligned to `bytes`): one store where the pair's alignment allows, else one a
// element.
__device__ __forceinline__ void stage_pair(uint32_t addr, int bytes, uint32_t b0, uint32_t b1, bool second) {
  if (bytes == 2) {
    if (second && (addr & 3) == 0) {
      st_shared4(addr, b0 | b1 << 16);
    } else {
      st_shared2(addr, b0);
      if (second) st_shared2(addr + 2, b1);
    }
  } else if (second && (addr & 7) == 0) {
    st_shared8(addr, b0, b1);
  } else {
    st_shared4(addr, b0);
    if (second) st_shared4(addr + 4, b1);
  }
}

// Bytes [lo, hi) of the 16-byte piece v (whole elements of B bytes) to dst .. dst + 15.
template <int B>
__device__ __forceinline__ void store_part(char* dst, uint4 v, int lo, int hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16 / B; ++j) {
    if (j * B < lo || j * B >= hi) continue;
    if constexpr (B == 2) {
      *reinterpret_cast<uint16_t*>(dst + 2 * j) = static_cast<uint16_t>(w[j / 2] >> (16 * (j % 2)));
    } else {
      *reinterpret_cast<uint32_t*>(dst + 4 * j) = w[j];
    }
  }
}

// The epilogue's stores where a row of y is not whole 16-byte pieces, by the 128
// threads (t) of a warpgroup. store_flat: `nbytes` of y from byte `start` (16-byte
// aligned), staged compactly, leave as 16-byte pieces (the last one element by element).
template <int B>
__device__ __forceinline__ void store_flat(char* __restrict__ out, long long start, int nbytes, uint32_t staging,
                                           int t) {
  for (int p = 16 * t; p < nbytes; p += 16 * 128) {
    const uint4 v = ld_shared16(staging + p);
    if (p + 16 <= nbytes) {
      *reinterpret_cast<uint4*>(out + start + p) = v;
    } else {
      store_part<B>(out + start + p, v, 0, nbytes - p);
    }
  }
}

// store_row_runs: columns [c0, c0 + w) (w <= 32) of rows [m_base, m_base + rows) of y
// (O columns), row r staged from byte a_r % 16 of its staging row, where a_r is the
// byte offset of its first element in y: so y's 16-byte slot k of the run is bytes
// 16k .. 16k + 15 of the staging row. A slot the run covers wholly is one 16-byte
// store. The slot at a run's end that the next chunk of the row completes
// (carry_out) is not stored: it moves to slot 0 of the staging row, where the next
// chunk's elements fill it up (carry_in), so that only a row's first and last slot in
// the tile go element by element. One thread takes a row's slots 0 and SLOTS - 1, so
// the carried slot lands after slot 0 has left.
template <int B>
__device__ __forceinline__ void store_row_runs(char* __restrict__ out, int o, uint32_t staging, int m_base, int rows,
                                               int c0, int w, bool carry_in, bool carry_out, int t) {
  constexpr int SLOTS = 2 * B + 1;  // the most 16-byte slots a run of 32 columns touches
  if (w <= 0) return;
  for (int item = t; item < rows * (SLOTS - 1); item += 128) {
    const int r = item / (SLOTS - 1), k = item - r * (SLOTS - 1);
    const long long a = (static_cast<long long>(m_base + r) * o + c0) * B;
    const int off = static_cast<int>(a & 15);
    const uint32_t row = staging + r * EPI_PITCH;
    char* const dst = out + (a - off);
    auto store_slot = [&](int slot, int lo) {
      const int hi = min(off + w * B - 16 * slot, 16);
      if (hi <= lo) return;
      const uint4 v = ld_shared16(row + 16 * slot);
      if (hi - lo == 16) {
        *reinterpret_cast<uint4*>(dst + 16 * slot) = v;
      } else {
        store_part<B>(dst + 16 * slot, v, lo, hi);
      }
    };
    if (k != 0) {
      store_slot(k, 0);
      continue;
    }
    store_slot(0, carry_in ? 0 : off);
    if (carry_out && off != 0) {  // w == 32: the run's last slot holds bytes [0, off) of the next chunk's first
      st_shared16(row, ld_shared16(row + 16 * (SLOTS - 1)));
    } else {
      store_slot(SLOTS - 1, 0);
    }
  }
}

// One block walks over output tiles (m tile, column tile) t = blockIdx.x, + gridDim.x,
// ... as one stream of steps. Warpgroup 2 copies each step into the ring and signals
// its slot's `full` barrier; warpgroups 0 and 1 wait on it, run the step's products
// and release the slot through its `empty` barrier. The producer runs up to STAGES
// steps ahead, across tile boundaries and through the consumers' epilogues. kRuns: a
// row of y is not whole 16-byte pieces (O * bytes % 16 != 0), so the epilogue stages
// rows at y's alignment (store_flat, store_row_runs); the other instance is the
// epilogue of whole 16-byte rows alone.
template <int BN, bool kRuns>
__global__ void __launch_bounds__(THREADS, Ring<BN>::BLOCKS) int8_conv_wgmma_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wp, const float* __restrict__ s_x,
    const float* __restrict__ w_scale, const void* __restrict__ bias, int bias_bf16, void* __restrict__ out,
    int out_dtype, ConvShape s) {
  constexpr int STAGE_BYTES = Ring<BN>::STAGE_BYTES;
  constexpr int STAGES = Ring<BN>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_stage = smem + STAGES * STAGE_BYTES;    // the consumers' epilogue staging
  // s_x * w_scale and the bias of the tile's columns, for the epilogue
  float* const col_scale = reinterpret_cast<float*>(smem_raw + (out_stage + 2 * EPI_WG_BYTES - smem_addr(smem_raw)));
  float* const col_bias = col_scale + 256;
  const uint32_t full_bar = out_stage + 2 * EPI_WG_BYTES + 2 * 256 * 4;  // STAGES barriers of 8 bytes, then `empty`
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n_tiles = (s.o + BN - 1) / BN;
  const int tiles = (s.m + BM - 1) / BM * n_tiles;
  const int ktiles = s.k_pad / BK;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar + 8 * i, PRODUCERS);
      mbar_init(empty_bar + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: warpgroup 2 ----
    if constexpr (Ring<BN>::BLOCKS == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int ptid = tid - CONSUMERS;
    // chunk `j` (reduction bytes 16j..16j+15 of each step) of rows ptid / 8 + 16i;
    // (fr, fs, fch) is the filter tap and channel of that chunk in the step to copy
    const int j = ptid & 7;
    int row_base[8], row_iy0[8], row_ix0[8];
    int fr = 0, fs = 0, fch = 0;
    int slot = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int8_t* b_src = wp + static_cast<long long>(tile - mt * n_tiles) * BN * s.k_pad;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = mt * BM + ptid / 8 + 16 * i;
        const int t = m / s.ow;
        const int img = t / s.oh;
        const int iy0 = (t - img * s.oh) * s.sh - s.ph;
        const int ix0 = (m - t * s.ow) * s.sw - s.pw;
        row_iy0[i] = m < s.m ? iy0 : -(1 << 28);  // a row past M is never inside the image
        row_ix0[i] = ix0;
        row_base[i] = ((img * s.h + iy0) * s.w + ix0) * s.c;
      }
      fr = 0;
      fs = 0;
      fch = 16 * j;
      for (int kt = 0; kt < ktiles; ++kt) {
        while (fch >= s.c) {
          fch -= s.c;
          if (++fs == s.kw) {
            fs = 0;
            ++fr;
          }
        }
        mbar_wait(empty_bar + 8 * slot, phase ^ 1);
        const uint32_t a_dst = smem + slot * STAGE_BYTES;
        const int dy = fr * s.dh, dx = fs * s.dw;
        const int tap = (dy * s.w + dx) * s.c + fch;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = ptid / 8 + 16 * i;
          const bool valid = fr < s.kh && static_cast<unsigned>(row_iy0[i] + dy) < static_cast<unsigned>(s.h) &&
                             static_cast<unsigned>(row_ix0[i] + dx) < static_cast<unsigned>(s.w);
          cp_async16(a_dst + swizzled(row, j), x + (valid ? row_base[i] + tap : 0), valid ? 16 : 0);
        }
        const uint32_t b_dst = a_dst + A_BYTES;
        const int8_t* b_step = b_src + kt * BK;
#pragma unroll
        for (int c = ptid; c < BN * 8; c += PRODUCERS) {
          cp_async16(b_dst + swizzled(c >> 3, c & 7), b_step + (c >> 3) * s.k_pad + 16 * (c & 7), 16);
        }
        mbar_arrive_on_copies(full_bar + 8 * slot);
        fch += BK;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: warpgroups 0 and 1 ----
    if constexpr (Ring<BN>::BLOCKS == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const float sx = out_dtype != 2 ? *s_x : 0.f;
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    int acc[BN / 2];
    int slot = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int n0 = (tile - mt * n_tiles) * BN;
      const int col_end = min(s.o, n0 + BN);
      if (out_dtype != 2) {
        // the table of the previous tile has been read; its loads are hidden by the
        // products below
        named_barrier(3, CONSUMERS);
        for (int c = tid; c < col_end - n0; c += CONSUMERS) {
          col_scale[c] = __fmul_rn(sx, w_scale[n0 + c]);
          if (bias != nullptr) {
            col_bias[c] = bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n0 + c])
                                    : static_cast<const float*>(bias)[n0 + c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(full_bar + 8 * slot, phase);
        // the producer's copies, visible to this thread, made visible to the tensor
        // cores' async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t stage = smem + slot * STAGE_BYTES;
        const uint32_t a_addr = stage + wg * 64 * BK;
        const uint32_t b_addr = stage + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          Wgmma<BN>::mma(acc, smem_desc(a_addr + 32 * kk), smem_desc(b_addr + 32 * kk));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the products of the previous step are done: release its slot
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(empty_bar + 8 * prev);
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) asm volatile("" : "+r"(acc[k])::"memory");

      // epilogue, 32 columns at a time through this warpgroup's staging area in shared
      // memory: acc[4jj + 2h + e] is row 16 * warp + lane / 4 + 8h of the warpgroup's 64,
      // column 8jj + 2 * (lane % 4) + e. Column pairs go in; rows leave as 16-byte stores.
      if (out_dtype != 2) named_barrier(3, CONSUMERS);  // the table is written
      const int out_bytes = out_dtype == 1 ? 2 : 4;
      const int m_base = mt * BM + wg * 64;
      const uint32_t staging = out_stage + wg * EPI_WG_BYTES;
      if constexpr (kRuns) {
        // Rows of y are not whole 16-byte pieces (O * bytes % 16 != 0), and the second
        // column of a pair is masked past O. Where the tile holds all of O and the
        // warpgroup's 64 rows fit its staging area, they are staged compactly (row r at
        // r * O * bytes): one contiguous run of y, 16-byte aligned, that leaves after the
        // last chunk (store_flat). Else each chunk's row r is staged from byte
        // (its address in y) % 16 of its staging row (store_row_runs).
        const bool flat = n0 == 0 && col_end == s.o && 64 * s.o * out_bytes <= EPI_WG_BYTES;
        int row_off[2];  // y's byte offset % 16 of this thread's two rows, the same at every chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned row = static_cast<unsigned>(m_base + warp * 16 + lane / 4 + 8 * h);
          row_off[h] = static_cast<int>((row * static_cast<unsigned>(s.o) + n0) * out_bytes & 15u);
        }
#pragma unroll
        for (int chunk = 0; chunk < (BN / 8 + 3) / 4; ++chunk) {
          if (!flat || chunk == 0) named_barrier(1 + wg, 128);  // the previous rows have left
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int jj = 4 * chunk + q;
            if (jj >= BN / 8) break;
            const int col = n0 + 8 * jj + 2 * (lane % 4);
            if (col >= col_end) continue;
            const int c = col - n0;
            const bool second = col + 1 < col_end;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = warp * 16 + lane / 4 + 8 * h;
              const uint32_t dst = flat ? staging + (row * s.o + c) * out_bytes
                                        : staging + row * EPI_PITCH + row_off[h] + (8 * q + 2 * (lane % 4)) * out_bytes;
              uint32_t b0 = static_cast<uint32_t>(acc[4 * jj + 2 * h]);
              uint32_t b1 = static_cast<uint32_t>(acc[4 * jj + 2 * h + 1]);
              if (out_dtype != 2) {
                float y0 = __fmul_rn(__int2float_rn(static_cast<int>(b0)), col_scale[c]);
                float y1 = second ? __fmul_rn(__int2float_rn(static_cast<int>(b1)), col_scale[c + 1]) : 0.f;
                if (bias != nullptr) {
                  y0 = __fadd_rn(y0, col_bias[c]);
                  if (second) y1 = __fadd_rn(y1, col_bias[c + 1]);
                }
                if (out_dtype == 0) {
                  b0 = __float_as_uint(y0);
                  b1 = __float_as_uint(y1);
                } else {
                  __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
                  const uint32_t bits = *reinterpret_cast<uint32_t*>(&pair);
                  b0 = bits & 0xFFFFu;
                  b1 = bits >> 16;
                }
              }
              stage_pair(dst, out_bytes, b0, b1, second);
            }
          }
          if (flat) continue;
          named_barrier(1 + wg, 128);
          const int c0 = n0 + 32 * chunk, rows = min(64, s.m - m_base), w = min(32, col_end - c0);
          const bool carry_out = c0 + 32 < col_end;  // the next chunk continues these rows
          if (out_bytes == 2) {
            store_row_runs<2>(static_cast<char*>(out), s.o, staging, m_base, rows, c0, w, chunk > 0, carry_out,
                              tid % 128);
          } else {
            store_row_runs<4>(static_cast<char*>(out), s.o, staging, m_base, rows, c0, w, chunk > 0, carry_out,
                              tid % 128);
          }
        }
        if (flat) {
          named_barrier(1 + wg, 128);
          const long long start = static_cast<long long>(m_base) * s.o * out_bytes;
          const int nbytes = max(min(64, s.m - m_base), 0) * s.o * out_bytes;
          if (out_bytes == 2) {
            store_flat<2>(static_cast<char*>(out), start, nbytes, staging, tid % 128);
          } else {
            store_flat<4>(static_cast<char*>(out), start, nbytes, staging, tid % 128);
          }
        }
        continue;
      }
#pragma unroll
      for (int chunk = 0; chunk < (BN / 8 + 3) / 4; ++chunk) {
        named_barrier(1 + wg, 128);  // the previous chunk's rows have left
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = 4 * chunk + q;
          if (jj >= BN / 8) break;
          const int col = n0 + 8 * jj + 2 * (lane % 4);
          if (col >= col_end) continue;  // O is even, so col + 1 < O too
          const int c = col - n0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
            const uint32_t dst =
                staging + (warp * 16 + lane / 4 + 8 * h) * EPI_PITCH + (8 * q + 2 * (lane % 4)) * out_bytes;
            if (out_dtype == 2) {
              st_shared8(dst, static_cast<uint32_t>(v0), static_cast<uint32_t>(v1));
              continue;
            }
            float y0 = __fmul_rn(__int2float_rn(v0), col_scale[c]);
            float y1 = __fmul_rn(__int2float_rn(v1), col_scale[c + 1]);
            if (bias != nullptr) {
              y0 = __fadd_rn(y0, col_bias[c]);
              y1 = __fadd_rn(y1, col_bias[c + 1]);
            }
            if (out_dtype == 0) {
              st_shared8(dst, __float_as_uint(y0), __float_as_uint(y1));
            } else {
              __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
              st_shared4(dst, *reinterpret_cast<uint32_t*>(&pair));
            }
          }
        }
        named_barrier(1 + wg, 128);
        const int per_row = 2 * out_bytes;  // 16-byte pieces in a row of 32 columns
        for (int piece = tid % 128; piece < 64 * per_row; piece += 128) {
          const int r = piece / per_row, part = piece - r * per_row;
          const int m = m_base + r;
          const int col = n0 + 32 * chunk + part * (16 / out_bytes);
          if (m < s.m && col < col_end) {
            const uint4 v = ld_shared16(staging + r * EPI_PITCH + 16 * part);
            *reinterpret_cast<uint4*>(static_cast<char*>(out) + (static_cast<long long>(m) * s.o + col) * out_bytes) =
                v;
          }
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int BN, bool kRuns>
int launch_instance(const void* x, const void* wp, const void* s_x, const void* w_scale, const void* bias,
                    int bias_bf16, void* out, int out_dtype, const ConvShape& s, cudaStream_t stream) {
  constexpr int smem_bytes = Ring<BN>::SMEM;
  auto* kernel = int8_conv_wgmma_kernel<BN, kRuns>;
  // per device: blocks of this kernel an SM holds at once (0 until the device's shared
  // memory limit for the kernel is raised), and its SMs
  static int resident[MAX_DEVICES];
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], kernel, THREADS, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[dev] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long tiles = (static_cast<long long>(s.m) + BM - 1) / BM * ((s.o + BN - 1) / BN);
  const long long slots = static_cast<long long>(resident[dev]) * sms[dev];
  const long long grid = tiles < slots ? tiles : slots;
  kernel<<<static_cast<unsigned int>(grid), THREADS, smem_bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp), static_cast<const float*>(s_x),
      static_cast<const float*>(w_scale), bias, bias_bf16, out, out_dtype, s);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgmma(const void* x, const void* wp, const void* s_x, const void* w_scale, const void* bias, int bias_bf16,
                 void* out, int out_dtype, const ConvShape& s, cudaStream_t stream) {
  const int out_bytes = out_dtype == 1 ? 2 : 4;  // y's rows whole 16-byte pieces, or runs
  if (s.o * out_bytes % 16 == 0) {
    return launch_instance<BN, false>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
  }
  return launch_instance<BN, true>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
}

int dispatch(int bn, const void* x, const void* wp, const void* s_x, const void* w_scale, const void* bias,
             int bias_bf16, void* out, int out_dtype, const ConvShape& s, cudaStream_t stream) {
  switch (bn) {
    case 48: return launch_wgmma<48>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    case 64: return launch_wgmma<64>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    case 96: return launch_wgmma<96>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    case 128: return launch_wgmma<128>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    case 192: return launch_wgmma<192>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    case 256: return launch_wgmma<256>(x, wp, s_x, w_scale, bias, bias_bf16, out, out_dtype, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_quantize_pitched(const T* x, const float* s_x, int8_t* q, long long pieces, int c, int vec,
                            unsigned int grid, cudaStream_t stream) {
  const unsigned n = static_cast<unsigned>(pieces), chunks = static_cast<unsigned>((c + 15) / 16);
  switch (vec) {
    case 16: int8_quantize_pitched_kernel<T, 16><<<grid, 256, 0, stream>>>(x, s_x, q, n, c, chunks); break;
    case 8: int8_quantize_pitched_kernel<T, 8><<<grid, 256, 0, stream>>>(x, s_x, q, n, c, chunks); break;
    case 4: int8_quantize_pitched_kernel<T, 4><<<grid, 256, 0, stream>>>(x, s_x, q, n, c, chunks); break;
    default:
      if constexpr (sizeof(T) == 2) {
        int8_quantize_pitched_kernel<T, 2><<<grid, 256, 0, stream>>>(x, s_x, q, n, c, chunks);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* holocron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: int8 NHWC at pixel pitch c (a multiple of 16: the activation's channels rounded
// up, zero beyond them); wp: the packed (ceil(O / bn) * bn, k_pad) weights over that
// pitch; bn: the column tile, one of 48, 64, 96, 128, 192, 256. out_dtype: 0 = float32,
// 1 = bfloat16 (both with the epilogue), 2 = raw int32 accumulator. Requires k_pad =
// KH*KW*c rounded up to a multiple of 128, and x and wp 16-byte aligned. Returns
// cudaGetLastError() after the last launch.
//
// The kernel's index arithmetic is 32-bit (64-bit division is slow): a launch's M and
// its x elements (with one image of margin, for rows past M) stay below 2^31. A batch
// beyond that runs as launches of equal runs of whole images (x and y advance an image
// at a time, and no output pixel reads another image), one image of margin included;
// a single image beyond it is refused.
extern "C" int int8_conv_wgmma_forward(const void* x, const void* wp, const void* s_x, const void* w_scale,
                                       const void* bias, int bias_bf16, void* out, int out_dtype, int n, int h,
                                       int w_in, int c, int o, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                                       int dw, int oh, int ow, int bn, int k_pad, void* stream) {
  const long long x_image = static_cast<long long>(h) * w_in * c, m_image = static_cast<long long>(oh) * ow;
  if (n < 0 || 2 * x_image > 0x7FFFFFFFLL || m_image + BM > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long fit =
      std::min(0x7FFFFFFFLL / std::max(x_image, 1LL) - 1, (0x7FFFFFFFLL - BM) / std::max(m_image, 1LL));
  const long long launches = n == 0 ? 1 : (n + fit - 1) / fit;
  const int per = static_cast<int>((n + launches - 1) / launches);  // images a launch
  const ConvShape s{h, w_in, c, o, kh, kw, sh, sw, ph, pw, dh, dw, oh, ow, static_cast<int>(per * m_image),
                    kh * kw * c, k_pad};
  if (out_dtype < 0 || out_dtype > 2 || c % 16 != 0 || o < 1 || k_pad != (s.k + BK - 1) / BK * BK ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long y_image = m_image * o * (out_dtype == 1 ? 2 : 4);  // bytes of an output image
  int err = 0;
  for (int i0 = 0; i0 < n && err == 0; i0 += per) {
    ConvShape run = s;
    run.m = static_cast<int>(std::min(per, n - i0) * m_image);
    if (run.m == 0) continue;
    err = dispatch(bn, static_cast<const int8_t*>(x) + i0 * x_image, wp, s_x, w_scale, bias, bias_bf16,
                   static_cast<char*>(out) + i0 * y_image, out_dtype, run, static_cast<cudaStream_t>(stream));
  }
  return err;
}

// q = clip(round_half_even(float(x) / *s_x), -127, 127) over `rows` rows of c elements
// (NHWC pixels); x float32 (x_bf16 = 0) or bfloat16, contiguous. q is written at a row
// pitch of c rounded up to 16, zero beyond c. x and q 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_quantize_forward(const void* x, const void* s_x, void* q, int x_bf16, long long rows, int c,
                                     void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 || rows < 0 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pieces = rows * ((c + 15) / 16);
  if (pieces == 0) return 0;
  const long long blocks = (pieces + 255) / 256;
  const unsigned int grid = static_cast<unsigned int>(blocks > 8 * 132 * 16 ? 8 * 132 * 16 : blocks);
  cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  const auto* sx = static_cast<const float*>(s_x);
  auto* out = static_cast<int8_t*>(q);
  if (c % 16 == 0) {
    if (x_bf16) {
      int8_quantize_kernel<__nv_bfloat16><<<grid, 256, 0, cu_stream>>>(static_cast<const __nv_bfloat16*>(x), sx, out,
                                                                      pieces);
    } else {
      int8_quantize_kernel<float><<<grid, 256, 0, cu_stream>>>(static_cast<const float*>(x), sx, out, pieces);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (pieces > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit piece indices
  const int row_bytes = c * (x_bf16 ? 2 : 4);
  const int vec = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 2;
  if (x_bf16) {
    return launch_quantize_pitched(static_cast<const __nv_bfloat16*>(x), sx, out, pieces, c, vec, grid, cu_stream);
  }
  return launch_quantize_pitched(static_cast<const float*>(x), sx, out, pieces, c, vec, grid, cu_stream);
}
