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
// the raw int32 accumulator. Three ungrouped routes read that packing, chosen by shape
// in kernels/int8_conv.py:conv_route: a 1x1, stride-1, unpadded conv takes the
// pointwise GEMM (int8_pointwise_wgmma_kernel); a KxK, stride-1, undilated one with
// O % 8 == 0 and C <= 48, launched on at least 401,408 output pixels, takes the halo conv
// (int8_conv_halo_kernel, at the end of this file); every other takes this one
// (int8_conv_wgmma_kernel). Grouped convs go to
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

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
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

// ---- The pointwise route: int8_pointwise_wgmma_kernel --------------------------------
//
// A 1x1, stride-1, unpadded conv is a GEMM over the pixels: y (M, O) = x (M, P) w^T,
// x_q a dense (M, P) int8 matrix at its pitch, w the packed (O_pad, K_pad) matrix. Same
// arithmetic and epilogue as the route above (quant.py:259-274), bit for bit. What
// bounds it on an H100 is the bytes: at the expansions (96 -> 384 at 56 x 56) y's bf16
// writes are 8x x's reads, and a 1-2 step reduction leaves each tile almost all
// epilogue. The design:
//
// - TMA loads: one producer thread issues cp.async.bulk.tensor.2d copies of 64 x 128-byte
//   boxes of x (rows past M and bytes past P zero-filled by the tensor map's bounds) into
//   a ring of mbarrier-guarded stages (expect_tx). Each block keeps one column tile for
//   its life (blockIdx.x % column tiles) and walks row tiles; where BN x K_pad fits
//   beside the ring, its weights are copied into shared memory once ("resident"), else
//   each stage carries the step's BN x 128 bytes of them beside two tiles' x, read by
//   both warpgroups ("streamed"). Blocks of one row tile run side by side, so x is
//   read from device memory about once.
// - No padded products: a step issues only the k32 wgmmas over bytes below P.
// - Ping-pong consumers: each of the two consumer warpgroups owns whole 64-row tiles,
//   taken alternately; with resident weights an order barrier (named barriers 4 and 5)
//   passes the tensor cores from one to the other, so one warpgroup's products run
//   during the other's epilogue (streamed, they multiply side by side).
// - Asynchronous stores: where a row of y is whole 16-byte pieces, the epilogue writes
//   128-byte-wide column chunks into two staging buffers a warpgroup in TMA's 128-byte
//   swizzle, each leaving as one cp.async.bulk.tensor.2d store (rows past M and columns
//   past O clipped by the map); else, where all of O lies in one column tile of at most
//   192, each warp stages its 16 rows compactly, one contiguous 16-byte-aligned run of
//   y, which leaves as one 1D cp.async.bulk copy. cp.async.bulk.wait_group.read guards a
//   buffer's reuse, so the stores drain during the next chunk and the next tile's
//   products. The remaining widths (rexnet's expansions to 570, 636, 702, ...: rows
//   neither whole 16-byte pieces nor in one tile) copy the staged chunks out in the
//   widest units their rows' alignment allows (8, 4 or 2 bytes).

constexpr int PW_ROWS = 64;                     // rows of a tile: one warpgroup's wgmma M
constexpr int PW_A_BYTES = PW_ROWS * BK;        // one step of a tile's x: 64 rows of 128 bytes
constexpr int PW_MAX_STAGES = 6;   // 4, 8, 12 and 16 measured slower on the read-bound layers (PERF.md)
constexpr int PW_CHUNK_BYTES = PW_ROWS * 128;   // a 2D store chunk: 64 rows of 128 bytes
constexpr int PW_SMEM = 232448 - 1024;          // a block's dynamic shared memory, less the alignment slack
constexpr long long PW_RUN_ROWS = 1LL << 30;    // rows a launch: TMA's coordinates are 32-bit
constexpr int PW_FLAT_MAX = 192;                // the widest column tile with 1D stores (its staging fits a ring)
// the epilogue's store forms: 2D tensor stores of column chunks (rows of y whole
// 16-byte pieces), a 1D bulk copy of each warp's rows (O <= PW_FLAT_MAX, one column
// tile), or the staged chunks copied out by the threads (the other widths)
constexpr int PW_STORE_TENSOR = 0, PW_STORE_FLAT = 1, PW_STORE_COPY = 2;

struct PointwiseShape {
  int m, o, p;          // rows of this launch, output channels, reduction bytes (x's pitch)
  int ksteps;           // 128-byte steps, ceil(P / 128)
  int col_tiles, row_tiles, blocks_per_col;
  int stages, resident, store, out_dtype, bias_bf16;  // store: PW_STORE_*
  int vec;              // PW_STORE_COPY's unit in bytes
  // byte offsets from the 1024-aligned base of shared memory
  int off_w, off_epi, epi_warp_bytes, off_table, off_bar;
};

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// this thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// this thread's bulk stores have completed
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// this thread's shared-memory writes made visible to the bulk copies (the async proxy)
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared2(uint32_t src) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(src) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_shared4(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}

// float(acc) * (s_x * w_scale[o]) + bias[o] in float32, quant.py:270-273's order; no
// bias, no addition (+0 would turn a -0 into +0)
__device__ __forceinline__ float requantize(int a, float scale, float bias, bool has_bias) {
  const float y = __fmul_rn(__int2float_rn(a), scale);
  return has_bias ? __fadd_rn(y, bias) : y;
}

// The bits of a thread's two elements of y: raw int32, float32, or a bfloat16 each.
template <int B>
__device__ __forceinline__ void epilogue_pair(int a0, int a1, int c, const float* col_scale, const float* col_bias,
                                              bool has_bias, int out_dtype, uint32_t& b0, uint32_t& b1) {
  if (B == 4 && out_dtype == 2) {
    b0 = static_cast<uint32_t>(a0);
    b1 = static_cast<uint32_t>(a1);
    return;
  }
  const float2 scale = *reinterpret_cast<const float2*>(col_scale + c);  // c is even
  const float2 add = *reinterpret_cast<const float2*>(col_bias + c);
  const float y0 = requantize(a0, scale.x, add.x, has_bias);
  const float y1 = requantize(a1, scale.y, add.y, has_bias);
  if constexpr (B == 4) {
    b0 = __float_as_uint(y0);
    b1 = __float_as_uint(y1);
  } else {
    __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
    const uint32_t bits = *reinterpret_cast<uint32_t*>(&pair);
    b0 = bits & 0xFFFFu;
    b1 = bits >> 16;
  }
}

// The epilogue of one 64 x BN tile, by the 128 threads (t) of a warpgroup:
// 128-byte-wide column chunks (CW columns) staged in TMA's 128-byte swizzle (row r's
// 16-byte piece k at r * 128 + (k ^ (r % 8)) * 16, so a warp's eight rows fall in
// different banks), alternating between the warpgroup's two buffers. Where a row of y
// is whole 16-byte pieces (`tensor`), each chunk leaves as one bulk tensor store at
// (n0 + chunk * CW, m0); before the barrier that releases a chunk, thread 0 waits
// until the previous chunk's store has read its buffer, the one the next chunk writes.
// Else the warpgroup copies each chunk out in units of `vec` bytes, a row's run by
// consecutive threads (a rolled loop: no registers beyond the accumulators'); the next
// chunk's barrier orders the copy before the buffer's next use. `chunk_no` counts
// the warpgroup's chunks across tiles.
template <int BN, int B>
__device__ __forceinline__ void pointwise_epilogue_2d(const int (&acc)[BN / 2], const CUtensorMap* tm_y, bool tensor,
                                                      char* __restrict__ out, uint32_t bufs, const float* col_scale,
                                                      const float* col_bias, bool has_bias, int out_dtype, int o,
                                                      int m, int vec, int cols, int n0, int m0, int t, int bar_id,
                                                      int& chunk_no) {
  constexpr int CW = 128 / B;
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int ch = 0; ch < (BN + CW - 1) / CW; ++ch) {
    if (ch * CW >= cols) break;
    const uint32_t buf = bufs + (chunk_no & 1) * PW_CHUNK_BYTES;
#pragma unroll
    for (int q = 0; q < CW / 8; ++q) {
      const int jj = ch * (CW / 8) + q;
      if (jj >= BN / 8) break;
      const int c = 8 * jj + 2 * (lane % 4);
      const int byte = (8 * q + 2 * (lane % 4)) * B;  // in the chunk's row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;
        const uint32_t dst = buf + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
        uint32_t b0, b1;
        epilogue_pair<B>(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], c, col_scale, col_bias, has_bias, out_dtype,
                         b0, b1);
        if constexpr (B == 4) {
          st_shared8(dst, b0, b1);
        } else {
          st_shared4(dst, b0 | b1 << 16);
        }
      }
    }
    if (tensor) {
      fence_async_shared();
      if (t == 0) bulk_wait_read();
    }
    named_barrier(bar_id, 128);
    if (tensor) {
      if (t == 0) {
        tma_store_2d(tm_y, buf, n0 + ch * CW, m0);
        bulk_commit();
      }
    } else {
      // `vec` bytes at a time (8, 4 or one element: what y's row alignment allows; a
      // unit never straddles a 16-byte piece of the staging row)
      // thread t takes unit t % units of rows t / units, + 128 / units, ...: no division
      // in the loop (units <= 64, so every row is covered)
      const int c0 = ch * CW, units = min(CW, cols - c0) * B / vec, rows = min(PW_ROWS, m - m0);
      const int step = 128 / units, byte = (t % units) * vec;
      char* const base = out + (static_cast<long long>(m0) * o + n0 + c0) * B + byte;
#pragma unroll 1
      for (int r = t < step * units ? t / units : rows; r < rows; r += step) {
        const uint32_t src = buf + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
        char* const dst = base + static_cast<long long>(r) * o * B;
        if (vec == 8) {
          uint2 v;
          asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(src) : "memory");
          *reinterpret_cast<uint2*>(dst) = v;
        } else if (vec == 4) {
          *reinterpret_cast<uint32_t*>(dst) = ld_shared4(src);
        } else {
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(ld_shared2(src));
        }
      }
    }
    ++chunk_no;
  }
}

// The epilogue of one tile where a row of y is not whole 16-byte pieces (odd O, all of
// it in this column tile), by one warp: its 16 rows staged compactly in its buffer,
// element (r, c) at (r * O + c) * B, the same bytes as the run of y they go to, which
// starts on a 16-byte boundary and is 16 * O * B bytes long: one 1D bulk copy. A warp
// whose rows run past M (the launch's last tile) stores its valid rows directly.
template <int BN, int B>
__device__ __forceinline__ void pointwise_epilogue_flat(const int (&acc)[BN / 2], char* __restrict__ out,
                                                        uint32_t wbuf, const float* col_scale, const float* col_bias,
                                                        bool has_bias, int out_dtype, int o, int m, int m0, int t) {
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) bulk_wait_read();  // the warp's previous run has left its buffer
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = 8 * jj + 2 * (lane % 4);
    if (c >= o) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane / 4 + 8 * h;
      uint32_t b0, b1;
      // the second column past O reads the table's zero entry and is not stored
      epilogue_pair<B>(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1], c, col_scale, col_bias, has_bias, out_dtype,
                       b0, b1);
      stage_pair(wbuf + (r * o + c) * B, B, b0, b1, c + 1 < o);
    }
  }
  fence_async_shared();
  __syncwarp();
  const int row0 = m0 + 16 * warp;
  const int rows = min(16, m - row0);
  char* const dst = out + static_cast<long long>(row0) * o * B;
  if (rows == 16) {
    if (lane == 0) {
      bulk_store(dst, wbuf, 16 * o * B);
      bulk_commit();
    }
  } else {
    for (int i = lane; i < rows * o; i += 32) {
      if constexpr (B == 2) {
        *reinterpret_cast<uint16_t*>(dst + 2 * i) = static_cast<uint16_t>(ld_shared2(wbuf + 2 * i));
      } else {
        *reinterpret_cast<uint32_t*>(dst + 4 * i) = ld_shared4(wbuf + 4 * i);
      }
    }
  }
}

// One block keeps column tile blockIdx.x % col_tiles and walks row tiles first_row,
// first_row + blocks_per_col, ... (its tiles j = 0, 1, ...); warpgroup w takes the
// tiles j = w, w + 2, ..., in rounds of two. Where the weights are resident, the
// producer thread copies them once, then each tile's steps of x into the ring in j
// order, and the warpgroups ping-pong: in each round a warpgroup waits for the other's
// products before issuing its own (the order barrier), then runs its epilogue while the
// other multiplies. Where they are streamed, a stage holds a round's two tiles of x and
// the step's weights, which both warpgroups read (a 64-row tile a stage would copy the
// weights twice as often, through L2): the warpgroups multiply side by side.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) int8_pointwise_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ s_x, const float* __restrict__ w_scale,
    const void* __restrict__ bias, void* __restrict__ out, PointwiseShape s) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t smem = (raw + 1023u) & ~1023u;
  uint8_t* const smem_ptr = smem_raw + (smem - raw);
  const uint32_t full_bar = smem + s.off_bar, empty_bar = full_bar + 8 * s.stages, w_bar = empty_bar + 8 * s.stages;
  float* const col_scale = reinterpret_cast<float*>(smem_ptr + s.off_table);
  float* const col_bias = col_scale + BN;
  const bool resident = s.resident != 0;
  // resident: one tile's step of x; streamed: a round's two and the step's weights
  const uint32_t stage_bytes = resident ? PW_A_BYTES : 2 * PW_A_BYTES + BN * BK;

  const int tid = threadIdx.x;
  const int n0 = static_cast<int>(blockIdx.x % s.col_tiles) * BN;
  const int first_row = static_cast<int>(blockIdx.x / s.col_tiles);
  const int tiles = first_row < s.row_tiles ? (s.row_tiles - first_row + s.blocks_per_col - 1) / s.blocks_per_col : 0;
  const int rounds = (tiles + 1) / 2;
  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(full_bar + 8 * i, 1);                                // the producer's expect_tx, then the bytes
      mbar_init(empty_bar + 8 * i, resident ? 128 : CONSUMERS);      // the warpgroups that read the stage
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread of warpgroup 2 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != CONSUMERS) return;
    int slot = 0, phase = 0;
    if (resident) {
      mbar_expect_tx(w_bar, BN * BK * s.ksteps);
      for (int kt = 0; kt < s.ksteps; ++kt) tma_load_2d(smem + s.off_w + kt * BN * BK, &tm_w, w_bar, kt * BK, n0);
      for (int j = 0; j < tiles; ++j) {
        const int m0 = (first_row + j * s.blocks_per_col) * PW_ROWS;
        for (int kt = 0; kt < s.ksteps; ++kt) {
          mbar_wait(empty_bar + 8 * slot, phase ^ 1);
          const uint32_t stage = smem + slot * stage_bytes;
          mbar_expect_tx(full_bar + 8 * slot, PW_A_BYTES);
          tma_load_2d(stage, &tm_x, full_bar + 8 * slot, kt * BK, m0);
          if (++slot == s.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      for (int rd = 0; rd < rounds; ++rd) {
        const bool pair = 2 * rd + 1 < tiles;
        const int m0 = (first_row + 2 * rd * s.blocks_per_col) * PW_ROWS;
        for (int kt = 0; kt < s.ksteps; ++kt) {
          mbar_wait(empty_bar + 8 * slot, phase ^ 1);
          const uint32_t stage = smem + slot * stage_bytes;
          const uint32_t bar = full_bar + 8 * slot;
          mbar_expect_tx(bar, (pair ? 2 : 1) * PW_A_BYTES + BN * BK);
          tma_load_2d(stage, &tm_x, bar, kt * BK, m0);
          if (pair) tma_load_2d(stage + PW_A_BYTES, &tm_x, bar, kt * BK, m0 + s.blocks_per_col * PW_ROWS);
          tma_load_2d(stage + 2 * PW_A_BYTES, &tm_w, bar, kt * BK, n0);
          if (++slot == s.stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 0 and 1 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // the warpgroup, broadcast from lane 0 so that the compiler sees it warp-uniform (the
  // wgmmas below sit in branches on it)
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int t = tid % 128;
  const int cols = min(BN, s.o - n0);
  const bool has_bias = bias != nullptr;
  if (s.out_dtype != 2) {  // the column tile's s_x * w_scale and bias, for the block's life
    const float sx = *s_x;
    for (int c = tid; c < BN; c += CONSUMERS) {
      const bool in = c < cols;
      col_scale[c] = in ? __fmul_rn(sx, w_scale[n0 + c]) : 0.f;
      col_bias[c] = !in || !has_bias ? 0.f
                    : s.bias_bf16    ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n0 + c])
                                     : static_cast<const float*>(bias)[n0 + c];
    }
  }
  named_barrier(3, CONSUMERS);
  if (resident) mbar_wait(w_bar, 0);
  const uint32_t epi = smem + s.off_epi;
  int acc[BN / 2];
  int chunk_no = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const int j = 2 * rd + wg;
    const bool have = j < tiles;
    if (resident) {
      if (wg == 0) {
        if (rd > 0) named_barrier(4, CONSUMERS);  // warpgroup 1 has issued round rd - 1's products
      } else {
        named_barrier(5, CONSUMERS);              // warpgroup 0 has issued round rd's
      }
    }
    if (have || !resident) {
      const int pos = (resident ? j : rd) * s.ksteps;  // the tile's (round's) first step in the ring's order
      int slot = pos % s.stages, phase = (pos / s.stages) & 1;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < s.ksteps; ++kt) {
        mbar_wait(full_bar + 8 * slot, phase);
        const uint32_t stage = smem + slot * stage_bytes;
        if (have) {
          const uint32_t a = resident ? stage : stage + wg * PW_A_BYTES;
          const uint32_t b = resident ? smem + s.off_w + kt * BN * BK : stage + 2 * PW_A_BYTES;
          const int nk = min(BK / 32, (s.p - kt * BK + 31) / 32);  // k32 products over bytes below P
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          Wgmma<BN>::mma(acc, smem_desc(a), smem_desc(b));
          if (nk > 1) Wgmma<BN>::mma(acc, smem_desc(a + 32), smem_desc(b + 32));
          if (nk > 2) Wgmma<BN>::mma(acc, smem_desc(a + 64), smem_desc(b + 64));
          if (nk > 3) Wgmma<BN>::mma(acc, smem_desc(a + 96), smem_desc(b + 96));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        }
        if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
        prev = slot;
        if (++slot == s.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      if (have) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(empty_bar + 8 * prev);
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) asm volatile("" : "+r"(acc[k])::"memory");
    }
    if (resident) {  // the tensor cores pass to the other warpgroup
      if (wg == 0) {
        named_arrive(5, CONSUMERS);
      } else if (rd + 1 < rounds) {
        named_arrive(4, CONSUMERS);
      }
    }
    if (!have) continue;
    const int m0 = (first_row + j * s.blocks_per_col) * PW_ROWS;
    if constexpr (BN <= PW_FLAT_MAX) {
      if (s.store == PW_STORE_FLAT) {
        const uint32_t wbuf = epi + (wg * 4 + t / 32) * s.epi_warp_bytes;
        if (s.out_dtype == 1) {
          pointwise_epilogue_flat<BN, 2>(acc, static_cast<char*>(out), wbuf, col_scale, col_bias, has_bias,
                                         s.out_dtype, s.o, s.m, m0, t);
        } else {
          pointwise_epilogue_flat<BN, 4>(acc, static_cast<char*>(out), wbuf, col_scale, col_bias, has_bias,
                                         s.out_dtype, s.o, s.m, m0, t);
        }
        continue;
      }
    }
    const uint32_t bufs = epi + wg * 2 * PW_CHUNK_BYTES;
    const bool tensor = s.store == PW_STORE_TENSOR;
    if (s.out_dtype == 1) {
      pointwise_epilogue_2d<BN, 2>(acc, &tm_y, tensor, static_cast<char*>(out), bufs, col_scale, col_bias, has_bias,
                                   s.out_dtype, s.o, s.m, s.vec, cols, n0, m0, t, 1 + wg, chunk_no);
    } else {
      pointwise_epilogue_2d<BN, 4>(acc, &tm_y, tensor, static_cast<char*>(out), bufs, col_scale, col_bias, has_bias,
                                   s.out_dtype, s.o, s.m, s.vec, cols, n0, m0, t, 1 + wg, chunk_no);
    }
  }
  bulk_wait_all();  // the block's shared memory outlives every store this thread issued
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query (so the
// library needs no link to libcuda); null where it is not available.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) matrix at `pitch` bytes a row, moved in
// boxes of box_rows x box_cols elements (box_cols * element bytes = 128) in the 128-byte
// swizzle; outside the matrix a load reads zeros and a store writes nothing.
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long cols, long long rows,
                     long long pitch, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
int launch_pointwise(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_y, const void* s_x,
                     const void* w_scale, const void* bias, void* out, const PointwiseShape& s, int grid,
                     int smem_bytes, cudaStream_t stream) {
  auto* kernel = int8_pointwise_wgmma_kernel<BN>;
  static bool ready[MAX_DEVICES];  // per device: the kernel's shared memory limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PW_SMEM + 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  kernel<<<grid, THREADS, smem_bytes, stream>>>(tm_x, tm_w, tm_y, static_cast<const float*>(s_x),
                                                static_cast<const float*>(w_scale), bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_pointwise(int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_y,
                       const void* s_x, const void* w_scale, const void* bias, void* out, const PointwiseShape& s,
                       int grid, int smem_bytes, cudaStream_t stream) {
  switch (bn) {
    case 48: return launch_pointwise<48>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 64: return launch_pointwise<64>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 96: return launch_pointwise<96>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 128: return launch_pointwise<128>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 192: return launch_pointwise<192>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 256: return launch_pointwise<256>(tm_x, tm_w, tm_y, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- The halo route: int8_conv_halo_kernel ----------------------------------------
//
// Replaces holocron_tpu/quant.py:_quantized_conv's int8 convolution (quant.py:259-274,
// left to XLA by the JAX package) for the KxK, stride-1, undilated convs whose output
// rows are whole 16-byte pieces (O % 8 == 0): the same function and epilogue as the
// routes above, bit for bit. The wgmma route gathers the activation once per filter tap
// from L2; this one copies each tile's input halo into shared memory once and feeds
// every tap from it. What bounds it on an H100 at the layers conv_route gives it (C <=
// 48: repvgg_a0's 48 -> 48 at 112 and 56 px) is the bytes: x read once and y written
// once (48 -> 48 at 112 px, batch 256: 0.138 ms at 3.35 TB/s).
//
// - The q space: an image's output pixel (y, x) is row q = y * WQ + x of the GEMM,
//   where WQ = W + 2 PW is the row pitch of the padded input as the halo holds it. Tap
//   (r, s) of row q then reads halo pixel q + r * WQ + s: every tap is the same linear
//   run of halo pixels, shifted. The columns x >= OW of each row are computed and never
//   stored (2 of 114 at 112 x 112, 2 of 16 at 14 x 14), and so are the rows past the
//   image's last q in its last 64-row chunk: up to a third more products on the small
//   maps, which is why conv_route keeps C > 48 on the wgmma route (PERF.md). A tile's
//   halo and weights arrive whole before its first product, a latency the wgmma
//   route's per-step ring hides, so conv_route also keeps small launches on wgmma.
// - The halo layout: 16-byte channel planes, each a dense run of pixels at 16 bytes,
//   the canonical no-swizzle K-major layout of wgmma (core matrices of 8 rows of 16
//   bytes): a chunk's A operand for tap t and plane c is a descriptor whose start
//   address is the plane's pixel q0 + shift(t), its 8-row stride 128 bytes (SBO) and its
//   K stride (LBO) the distance to the k32 step's second 16-byte chunk of K, the next
//   plane. K runs in the packed weights' (tap, channel) order; where the pixel pitch is
//   an odd number of planes above one (C = 48), a k32 step's second chunk is the next
//   tap's plane 0, which the halo holds again one plane past the last, so that LBO stays
//   positive. No tap is ever copied.
// - Loads: three producer warps copy a tile's halo with 16-byte cp.async copies, a row
//   a warp at a time, a warp's copies reading contiguous bytes of an input row
//   (zero-filled outside the image: the padding), each pixel of the halo once a tile.
//   (TMA boxes of 16-byte rows were slower in trials whose figures were not kept.) One
//   thread of the fourth warp loads the weights by TMA, 128 reduction bytes x BN rows a
//   box in the 128-byte swizzle: once per block where BN x K_pad fits beside two A
//   stages ("resident"), else a ring of steps ("streamed").
// - A tile: up to 2 * CPW 64-row chunks of q space, CPW a consumer warpgroup (CPW * BN /
//   2 <= 128 accumulator registers), either a band of one image's chunks or, where an
//   image has no more chunks than that, whole images; fewer where its halo does not
//   fit two A stages. Both warpgroups multiply side by side on a weight step; a step's
//   4 x CPW k32 products a warpgroup are issued as one straight run (a branch between
//   two wgmmas made ptxas wait for each one alone). Each block keeps one column tile.
// - The epilogue stages 128 bytes of each row at a time in shared memory and stores
//   whole 16-byte pieces, as the wgmma route's; it does not overlap the products (the
//   warpgroups taking turns on the tensor cores were no faster in trials whose figures
//   were not kept; PERF.md).
template <int BN>
struct Halo {
  static constexpr int CPW = BN <= 64 ? 4 : 2;  // chunks a warpgroup holds: CPW * BN / 2 <= 128 registers
};

constexpr int HALO_CHUNK = 64;       // q rows of a chunk: one warpgroup's wgmma M
constexpr int HALO_MAX_A = 4;        // A stages
constexpr int HALO_MAX_B = 8;        // streamed weight stages
constexpr int HALO_MAX_TAPS = 64;
constexpr int HALO_EPI_BYTES = 2 * EPI_WG_BYTES;
constexpr int HALO_COPIERS = 96;     // producer warps 0-2 copy the halo; warp 3 loads the weights

struct HaloShape {
  int n, h, w, p;         // x_q: images, rows, columns, pixel pitch in bytes
  int oh, ow, o;
  int kw, taps, ph, pw;
  int wq;                 // the q space's row pitch: the padded input's columns
  int chunks;             // 64-row chunks of an image's q space
  int tile_chunks;        // chunks a tile: at most 2 CPW
  int images;             // images a tile (1: a band of tile_chunks of one image's chunks)
  int tiles_img;          // tiles an image (band tiles), or 1
  int row_tiles, col_tiles, blocks_per_col;
  int planes, slots;      // 16-byte planes of x_q; the halo's plane slots (plus a copy of plane 0 where planes is odd and above 1)
  int nr;                 // halo rows of an image a stage holds
  int img_bytes;          // nr * wq * 16 rounded up to 128: an image's part of a plane slot
  int plane_bytes;        // images * img_bytes + 16 (a pixel's slots in different banks)
  int a_stage_bytes, a_stages, b_stages, resident;
  int ksteps, subs;       // 128-byte steps of the packed K; k32 steps (ceil(planes * taps / 2))
  int out_dtype, bias_bf16;
  int off_b, off_epi, off_table, off_shift, off_bar;  // from the aligned base; A stages at 0
};

// Descriptor of a K-major operand in the no-swizzle layout: core matrices of 8 rows x 16
// bytes (rows 16 bytes apart), `lbo` bytes between the two core matrices of a k32 step
// along K, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// The epilogue of a tile's chunks held by one warpgroup (its 128 threads t): chunk by
// chunk, 128 bytes of each row at a time (CW = 64 bf16 or 32 four-byte columns)
// through the warpgroup's staging area, acc[k][4jj + 2h + e] being row 16 * warp +
// lane / 4 + 8h of chunk k, column 8jj + 2 * (lane % 4) + e. Column pairs go in (the
// requantize epilogue, or the raw accumulator: RAW); rows leave as 16-byte stores,
// except a row whose q is a computed-only column or past the image. B: the output's
// bytes an element. (Storing each thread's column pairs straight to y, 4 or 8 bytes a
// store, took about twice as long at 48 channels in a trial whose figures were not kept.)
template <int BN, int CPW, int B, bool RAW>
__device__ __forceinline__ void halo_epilogue(const int (&acc)[CPW][BN / 2], const bool (&valid)[CPW],
                                              const int (&cq)[CPW], const int (&cimg)[CPW], const HaloShape& s,
                                              char* __restrict__ out, uint32_t staging, const float* col_scale,
                                              const float* col_bias, bool has_bias, int n0, int cols, int t, int wg) {
  constexpr int CW = 128 / B;  // columns a round
  constexpr int ROWS = 4;      // rows a thread stores a round: 64 rows x 8 pieces of 16 bytes / 128 threads
  const int warp = t / 32, lane = t % 32, part = t % 8;
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    if (!valid[k]) continue;
    long long row_off[ROWS];  // the output element offsets of this thread's rows t / 8 + 16 i
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int q = cq[k] + t / 8 + 16 * i;
      const int y = q / s.wq, x = q - y * s.wq;
      row_off[i] = x < s.ow && y < s.oh ? ((static_cast<long long>(cimg[k]) * s.oh + y) * s.ow + x) * s.o : -1;
    }
#pragma unroll
    for (int round = 0; round < (BN + CW - 1) / CW; ++round) {
      named_barrier(1 + wg, 128);  // the previous round's rows have left
#pragma unroll
      for (int qq = 0; qq < CW / 8; ++qq) {
        const int jj = round * (CW / 8) + qq;
        if (jj >= BN / 8) break;
        const int c = 8 * jj + 2 * (lane % 4);
        float2 scale = make_float2(0.f, 0.f), add = make_float2(0.f, 0.f);
        if constexpr (!RAW) {
          scale = *reinterpret_cast<const float2*>(col_scale + c);
          add = *reinterpret_cast<const float2*>(col_bias + c);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a0 = acc[k][4 * jj + 2 * h], a1 = acc[k][4 * jj + 2 * h + 1];
          const uint32_t dst = staging + (warp * 16 + lane / 4 + 8 * h) * EPI_PITCH + (8 * qq + 2 * (lane % 4)) * B;
          if constexpr (RAW) {
            st_shared8(dst, static_cast<uint32_t>(a0), static_cast<uint32_t>(a1));
          } else {
            const float y0 = requantize(a0, scale.x, add.x, has_bias), y1 = requantize(a1, scale.y, add.y, has_bias);
            if constexpr (B == 4) {
              st_shared8(dst, __float_as_uint(y0), __float_as_uint(y1));
            } else {
              __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
              st_shared4(dst, *reinterpret_cast<uint32_t*>(&pair));
            }
          }
        }
      }
      named_barrier(1 + wg, 128);
      const int col = round * CW + part * (16 / B);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (row_off[i] >= 0 && col < cols) {
          const uint4 v = ld_shared16(staging + (t / 8 + 16 * i) * EPI_PITCH + 16 * part);
          *reinterpret_cast<uint4*>(out + (row_off[i] + n0 + col) * B) = v;
        }
      }
    }
  }
}

// One block keeps column tile blockIdx.x % col_tiles and walks row tiles first_row,
// first_row + blocks_per_col, ... Warpgroups 0 and 1 multiply side by side, warpgroup w
// on the tile's chunks w * CPW .. w * CPW + CPW - 1, each weight step read by both.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) int8_conv_halo_kernel(
    const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s_x,
    const float* __restrict__ w_scale, const void* __restrict__ bias, void* __restrict__ out, HaloShape s) {
  constexpr int CPW = Halo<BN>::CPW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t smem = (raw + 1023u) & ~1023u;
  uint8_t* const smem_ptr = smem_raw + (smem - raw);
  const uint32_t a_full = smem + s.off_bar, a_empty = a_full + 8 * HALO_MAX_A;
  const uint32_t b_full = a_empty + 8 * HALO_MAX_A, b_empty = b_full + 8 * HALO_MAX_B;
  const uint32_t w_bar = b_empty + 8 * HALO_MAX_B;
  float* const col_scale = reinterpret_cast<float*>(smem_ptr + s.off_table);
  float* const col_bias = col_scale + BN;
  int* const shift = reinterpret_cast<int*>(smem_ptr + s.off_shift);

  const int tid = threadIdx.x;
  const int n0 = static_cast<int>(blockIdx.x % s.col_tiles) * BN;
  const int first_row = static_cast<int>(blockIdx.x / s.col_tiles);
  const int tiles =
      first_row < s.row_tiles ? (s.row_tiles - first_row + s.blocks_per_col - 1) / s.blocks_per_col : 0;
  const int steps = (s.subs + 3) / 4;  // 128-byte weight steps a tile
  if (tid == 0) {
    for (int i = 0; i < HALO_MAX_A; ++i) {
      mbar_init(a_full + 8 * i, HALO_COPIERS);
      mbar_init(a_empty + 8 * i, CONSUMERS);
    }
    for (int i = 0; i < HALO_MAX_B; ++i) {
      mbar_init(b_full + 8 * i, 1);
      mbar_init(b_empty + 8 * i, CONSUMERS);
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the tile's first image, its images, its first chunk and its chunks, and the first
  // padded input row its halo holds
  auto place = [&](int rt, int& img0, int& imgs, int& c0, int& nch, int& r0) {
    if (s.images > 1) {
      img0 = rt * s.images;
      imgs = min(s.images, s.n - img0);
      c0 = 0;
      nch = imgs * s.chunks;
      r0 = 0;
    } else {
      img0 = rt / s.tiles_img;
      imgs = 1;
      c0 = (rt - img0 * s.tiles_img) * s.tile_chunks;
      nch = min(s.tile_chunks, s.chunks - c0);
      r0 = c0 * HALO_CHUNK / s.wq;
    }
  };

  if (tid >= CONSUMERS) {
    // ---- producers: warpgroup 2 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ptid = tid - CONSUMERS;
    if (ptid >= HALO_COPIERS) {
      // the weights, by one thread of warp 3, through TMA
      if (ptid != HALO_COPIERS) return;
      if (s.resident) {
        mbar_expect_tx(w_bar, BN * BK * s.ksteps);
        for (int kt = 0; kt < s.ksteps; ++kt) tma_load_2d(smem + s.off_b + kt * BN * BK, &tm_w, w_bar, kt * BK, n0);
        return;
      }
      int bslot = 0, bphase = 0;
      for (int j = 0; j < tiles; ++j) {
        for (int kt = 0; kt < steps; ++kt) {
          mbar_wait(b_empty + 8 * bslot, bphase ^ 1);
          mbar_expect_tx(b_full + 8 * bslot, BN * BK);
          tma_load_2d(smem + s.off_b + bslot * BN * BK, &tm_w, b_full + 8 * bslot, kt * BK, n0);
          if (++bslot == s.b_stages) {
            bslot = 0;
            bphase ^= 1;
          }
        }
      }
      return;
    }
    // the halo, by warps 0-2, a halo row a warp at a time: the row's 16-byte chunks in
    // (pixel, slot) order, a lane every 32nd, so that a warp's copies read contiguous
    // bytes of an input row and write each plane's 16-byte slots (slot C / 16, where
    // there is one, is plane 0 again); outside the image a slot is zero-filled (the
    // padding). A lane's place in the row is carried without division.
    const int cw = ptid / 32, lane = ptid % 32;
    const int ns = s.slots, row_chunks = s.wq * ns;
    const int lane_x = lane / ns, lane_sl = lane % ns, step_x = 32 / ns, step_sl = 32 % ns;
    int aslot = 0, aphase = 0;
    for (int j = 0; j < tiles; ++j) {
      int img0, imgs, c0, nch, r0;
      place(first_row + j * s.blocks_per_col, img0, imgs, c0, nch, r0);
      mbar_wait(a_empty + 8 * aslot, aphase ^ 1);
      const uint32_t stage = smem + aslot * s.a_stage_bytes;
      for (int r = cw; r < imgs * s.nr; r += HALO_COPIERS / 32) {
        const int gi = r / s.nr, hr = r - gi * s.nr, iy = r0 + hr - s.ph;
        const bool row_in = static_cast<unsigned>(iy) < static_cast<unsigned>(s.h);
        const int8_t* const src = x + ((static_cast<long long>(img0 + gi) * s.h + iy) * s.w - s.pw) * s.p;
        const uint32_t dst = stage + gi * s.img_bytes + hr * s.wq * 16;
        int hx = lane_x, sl = lane_sl;
#pragma unroll 4
        for (int c = lane; c < row_chunks; c += 32) {
          const bool in = row_in && static_cast<unsigned>(hx - s.pw) < static_cast<unsigned>(s.w);
          const int plane = sl < s.planes ? sl : 0;
          cp_async16(dst + sl * s.plane_bytes + hx * 16, in ? src + static_cast<long long>(hx) * s.p + 16 * plane : x,
                     in ? 16 : 0);
          sl += step_sl;
          hx += step_x;
          if (sl >= ns) {
            sl -= ns;
            ++hx;
          }
        }
      }
      mbar_arrive_on_copies(a_full + 8 * aslot);
      if (++aslot == s.a_stages) {
        aslot = 0;
        aphase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warpgroups 0 and 1 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int t = tid % 128;
  const int cols = min(BN, s.o - n0);
  const bool has_bias = bias != nullptr;
  if (s.out_dtype != 2) {  // the column tile's s_x * w_scale and bias, for the block's life
    const float sx = *s_x;
    for (int c = tid; c < BN; c += CONSUMERS) {
      const bool in = c < cols;
      col_scale[c] = in ? __fmul_rn(sx, w_scale[n0 + c]) : 0.f;
      col_bias[c] = !in || !has_bias ? 0.f
                    : s.bias_bf16    ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n0 + c])
                                     : static_cast<const float*>(bias)[n0 + c];
    }
  }
  for (int i = tid; i < s.taps; i += CONSUMERS) shift[i] = ((i / s.kw) * s.wq + i % s.kw) * 16;
  named_barrier(3, CONSUMERS);
  if (s.resident) mbar_wait(w_bar, 0);
  const int total_chunks = s.planes * s.taps;
  const uint32_t staging = smem + s.off_epi + wg * EPI_WG_BYTES;
  int acc[CPW][BN / 2];
  int aslot = 0, aphase = 0, bslot = 0, bphase = 0;
  for (int j = 0; j < tiles; ++j) {
    int img0, imgs, c0, nch, r0;
    place(first_row + j * s.blocks_per_col, img0, imgs, c0, nch, r0);
    // this warpgroup's chunks: valid, byte offset in a plane, image and first q
    bool valid[CPW];
    uint32_t qoff[CPW];
    int cimg[CPW], cq[CPW];
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int i = wg * CPW + k;  // the chunk in the tile
      valid[k] = i < nch;
      const int gi = s.images > 1 ? i / s.chunks : 0;
      const int q = s.images > 1 ? (i - gi * s.chunks) * HALO_CHUNK : (c0 + i) * HALO_CHUNK;
      cimg[k] = img0 + gi;
      cq[k] = q;
      qoff[k] = static_cast<uint32_t>(gi * s.img_bytes + (q - r0 * s.wq) * 16);
    }
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[k][i] = 0;
    }
    mbar_wait(a_full + 8 * aslot, aphase);
    // the copies (cp.async: the generic proxy), visible to the tensor cores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t a_stage = smem + aslot * s.a_stage_bytes;
    const int a_cur = aslot;
    if (++aslot == s.a_stages) {
      aslot = 0;
      aphase ^= 1;
    }
    // One 128-byte weight step a pass: its four k32 steps' products are one commit group,
    // issued as straight-line code after their descriptors (a branch between two wgmmas
    // makes ptxas fence and wait for each one alone). Every chunk's products are issued,
    // valid or not (a chunk past the tile reads the stage and is never stored), and the
    // k32 steps past K read zero weights.
    int tp = 0, pl = 0;  // tap and plane of the next k32 step's first 16-byte chunk of K
    int b_prev = -1;
    for (int kt = 0; kt < steps; ++kt) {
      uint32_t b_stage;
      int b_cur = -1;
      if (s.resident) {
        b_stage = smem + s.off_b + kt * BN * BK;
      } else {
        mbar_wait(b_full + 8 * bslot, bphase);
        b_cur = bslot;
        b_stage = smem + s.off_b + bslot * BN * BK;
        if (++bslot == s.b_stages) {
          bslot = 0;
          bphase ^= 1;
        }
      }
      // each k32 step's two 16-byte chunks of K: (tp, pl) and the next, the next plane
      // of the tap, or the next tap's plane 0 (slot C / 16, a copy of plane 0 one plane
      // past the last, where there are several planes: LBO stays positive); past K the
      // weights are zero and the next pixel will do (the halo holds one pixel more than
      // the tile reads)
      uint32_t addr[4], lbo[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int sh0 = shift[tp];
        const bool same_tap = pl + 1 < s.planes;
        const int tp1 = same_tap ? tp : tp + 1;
        const int slot1 = same_tap ? pl + 1 : s.planes > 1 ? s.planes : 0;
        const int sh1 = shift[tp1 < s.taps ? tp1 : tp];
        addr[kk] = a_stage + pl * s.plane_bytes + sh0;
        lbo[kk] = 2 * (4 * kt + kk) + 1 >= total_chunks
                      ? 16u
                      : static_cast<uint32_t>((slot1 - pl) * s.plane_bytes + sh1 - sh0);
        pl += 2;
        while (pl >= s.planes) {
          pl -= s.planes;
          ++tp;
        }
        tp = min(tp, s.taps - 1);  // past K: any tap will do
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(b_stage + 32 * kk);
#pragma unroll
        for (int k = 0; k < CPW; ++k) Wgmma<BN>::mma(acc[k], smem_desc_plain(addr[kk] + qoff[k], lbo[kk], 128), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (b_prev >= 0) mbar_arrive(b_empty + 8 * b_prev);
      b_prev = b_cur;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mbar_arrive(a_empty + 8 * a_cur);
    if (b_prev >= 0) mbar_arrive(b_empty + 8 * b_prev);
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[k][i])::"memory");
    }

    // the epilogue, by output type (each a loop with no branch on it)
    char* const y = static_cast<char*>(out);
    if (s.out_dtype == 1) {
      halo_epilogue<BN, CPW, 2, false>(acc, valid, cq, cimg, s, y, staging, col_scale, col_bias, has_bias, n0, cols,
                                        t, wg);
    } else if (s.out_dtype == 0) {
      halo_epilogue<BN, CPW, 4, false>(acc, valid, cq, cimg, s, y, staging, col_scale, col_bias, has_bias, n0, cols,
                                        t, wg);
    } else {
      halo_epilogue<BN, CPW, 4, true>(acc, valid, cq, cimg, s, y, staging, col_scale, col_bias, has_bias, n0, cols,
                                       t, wg);
    }
  }
}

template <int BN>
int launch_halo(const void* x, const CUtensorMap& tm_w, const void* s_x, const void* w_scale, const void* bias,
                void* out, const HaloShape& s, int grid, int smem_bytes, cudaStream_t stream) {
  auto* kernel = int8_conv_halo_kernel<BN>;
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PW_SMEM + 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  kernel<<<grid, THREADS, smem_bytes, stream>>>(static_cast<const int8_t*>(x), tm_w, static_cast<const float*>(s_x),
                                                static_cast<const float*>(w_scale), bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

int halo_cpw(int bn) { return bn <= 64 ? Halo<64>::CPW : Halo<128>::CPW; }

int dispatch_halo(int bn, const void* x, const CUtensorMap& tm_w, const void* s_x, const void* w_scale,
                  const void* bias, void* out, const HaloShape& s, int grid, int smem_bytes, cudaStream_t stream) {
  switch (bn) {
    case 48: return launch_halo<48>(x, tm_w, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 64: return launch_halo<64>(x, tm_w, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 96: return launch_halo<96>(x, tm_w, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    case 128: return launch_halo<128>(x, tm_w, s_x, w_scale, bias, out, s, grid, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The pointwise conv (1x1, stride 1, no padding) as a GEMM: x an (m, p) int8 matrix at
// pitch p (a multiple of 16: the activation's channels rounded up, zero beyond them);
// wp the packed (o_rows, k_pad) weights over that pitch (k_pad = p rounded up to a
// multiple of 128, o_rows >= o); bn the column tile (48, 64, 96, 128, 192 or 256);
// out_dtype as int8_conv_wgmma_forward's; out (m, o). The epilogue stores by the
// tensor map where a row of y is whole 16-byte pieces, as each warp's contiguous run
// where it is not and o <= 192 (then o <= bn), else copied out by the threads. x, wp
// and out 16-byte aligned. Runs of 2^30 rows a launch (TMA's coordinates are 32-bit).
// Refuses what it does not take (cudaErrorInvalidValue), and cudaErrorNotSupported
// where cuTensorMapEncodeTiled is not available; else returns cudaGetLastError()
// after the last launch.
extern "C" int int8_pointwise_forward(const void* x, const void* wp, const void* s_x, const void* w_scale,
                                      const void* bias, int bias_bf16, void* out, int out_dtype, long long m, int p,
                                      int o, int bn, int o_rows, int k_pad, void* stream) {
  const int out_bytes = out_dtype == 1 ? 2 : 4;
  const int store = static_cast<long long>(o) * out_bytes % 16 == 0 ? PW_STORE_TENSOR
                    : o <= PW_FLAT_MAX                                ? PW_STORE_FLAT
                                                                      : PW_STORE_COPY;
  const bool width = bn == 48 || bn == 64 || bn == 96 || bn == 128 || bn == 192 || bn == 256;
  if (out_dtype < 0 || out_dtype > 2 || m < 0 || p < 16 || p % 16 != 0 || o < 1 || !width || o_rows < o ||
      k_pad != (p + BK - 1) / BK * BK || (store == PW_STORE_FLAT && (o > bn || bn > PW_FLAT_MAX)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;

  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  CUtensorMap tm_w, tm_y{};
  err = make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, k_pad, o_rows, k_pad, BK, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUtensorMapDataType y_type = out_dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : out_dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_INT32;
  PointwiseShape s{};
  s.o = o;
  s.p = p;
  s.ksteps = k_pad / BK;
  s.store = store;
  s.out_dtype = out_dtype;
  s.bias_bf16 = bias_bf16;
  s.vec = o * out_bytes % 8 == 0 ? 8 : o * out_bytes % 4 == 0 ? 4 : out_bytes;
  s.col_tiles = (o + bn - 1) / bn;
  // shared memory: the ring, the resident weights, the epilogue's staging, the column
  // table and the barriers
  s.epi_warp_bytes = store == PW_STORE_FLAT ? 16 * bn * out_bytes : 0;
  const int epi_bytes = store == PW_STORE_FLAT ? 8 * s.epi_warp_bytes : 4 * PW_CHUNK_BYTES;
  const int table_bytes = 2 * bn * 4, bar_bytes = 8 * (2 * PW_MAX_STAGES + 1);
  const int fixed = epi_bytes + table_bytes + bar_bytes;
  const int w_bytes = bn * k_pad;
  int code = 0;
  for (long long r0 = 0; r0 < m && code == 0; r0 += PW_RUN_ROWS) {
    const long long rows = std::min(PW_RUN_ROWS, m - r0);
    s.m = static_cast<int>(rows);
    s.row_tiles = static_cast<int>((rows + PW_ROWS - 1) / PW_ROWS);
    s.blocks_per_col = std::max(1, std::min(sms[dev] / s.col_tiles, s.row_tiles));
    // the weights are resident where they fit beside a ring of 4 stages and a block
    // walks more than one round of tiles; else streamed, a step at a time
    const int tiles = (s.row_tiles + s.blocks_per_col - 1) / s.blocks_per_col;
    s.resident = tiles > 2 && w_bytes + fixed + 4 * PW_A_BYTES <= PW_SMEM;
    const int stage_bytes = s.resident ? PW_A_BYTES : 2 * PW_A_BYTES + bn * BK;
    s.stages = std::min(PW_MAX_STAGES, (PW_SMEM - fixed - (s.resident ? w_bytes : 0)) / stage_bytes);
    if (s.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
    s.off_w = s.stages * stage_bytes;
    s.off_epi = s.off_w + (s.resident ? w_bytes : 0);
    s.off_table = s.off_epi + epi_bytes;
    s.off_bar = s.off_table + table_bytes;
    CUtensorMap tm_x;
    err = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, static_cast<const int8_t*>(x) + r0 * p, p, rows, p, BK,
                   PW_ROWS);
    char* const y = static_cast<char*>(out) + r0 * o * out_bytes;
    if (err == cudaSuccess && store == PW_STORE_TENSOR) {
      err = make_map(&tm_y, y_type, y, o, rows, static_cast<long long>(o) * out_bytes, 128 / out_bytes, PW_ROWS);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    code = dispatch_pointwise(bn, tm_x, tm_w, tm_y, s_x, w_scale, bias, y, s, s.blocks_per_col * s.col_tiles,
                              s.off_bar + bar_bytes + 1024, static_cast<cudaStream_t>(stream));
  }
  return code;
}

// The halo route (int8_conv_halo_kernel): a KxK (KH * KW >= 2, at most 64 taps),
// stride-1, undilated conv of x_q (NHWC at pixel pitch p, a multiple of 16, zero beyond
// the channels) into out (N, OH, OW, o), o % 8 == 0. wp: the packed weights, as
// int8_conv_wgmma_forward reads them (o_rows >= o rows of k_pad = KH * KW * p rounded up
// to a multiple of 128 bytes); bn the column tile (48, 64, 96 or 128). out_dtype as
// int8_conv_wgmma_forward's. x, wp and out 16-byte aligned.
// Refuses what it does not take (cudaErrorInvalidValue) and a conv where two A stages
// of a one-chunk tile's halo do not fit shared memory (cudaErrorLaunchOutOfResources);
// returns cudaErrorNotSupported where cuTensorMapEncodeTiled is not available, else
// cudaGetLastError(). Pixel
// offsets are 64-bit and tile indices 32-bit: any batch is one launch.
extern "C" int int8_conv_halo_forward(const void* x, const void* wp, const void* s_x, const void* w_scale,
                                      const void* bias, int bias_bf16, void* out, int out_dtype, int n, int h, int w,
                                      int p, int o, int kh, int kw, int ph, int pw, int bn, int o_rows, int k_pad,
                                      void* stream) {
  const int oh = h + 2 * ph - kh + 1, ow = w + 2 * pw - kw + 1, taps = kh * kw;
  const bool width = bn == 48 || bn == 64 || bn == 96 || bn == 128;
  if (out_dtype < 0 || out_dtype > 2 || n < 0 || h < 1 || w < 1 || p < 16 || p % 16 != 0 || o < 1 || o % 8 != 0 ||
      kh < 1 || kw < 1 || taps < 2 || taps > HALO_MAX_TAPS || ph < 0 || pw < 0 || oh < 1 || ow < 1 || !width ||
      o_rows < o || static_cast<long long>(k_pad) != (static_cast<long long>(taps) * p + BK - 1) / BK * BK ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  HaloShape s{};
  s.n = n;
  s.h = h;
  s.w = w;
  s.p = p;
  s.oh = oh;
  s.ow = ow;
  s.o = o;
  s.kw = kw;
  s.taps = taps;
  s.ph = ph;
  s.pw = pw;
  s.out_dtype = out_dtype;
  s.bias_bf16 = bias_bf16;
  s.wq = w + 2 * pw;
  const long long mq = static_cast<long long>(oh - 1) * s.wq + ow;
  if (mq + HALO_CHUNK > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  s.chunks = static_cast<int>((mq + HALO_CHUNK - 1) / HALO_CHUNK);
  s.planes = p / 16;
  s.slots = s.planes + (s.planes % 2 == 1 && s.planes > 1 ? 1 : 0);
  s.ksteps = k_pad / BK;
  s.subs = (s.planes * taps + 1) / 2;
  s.col_tiles = (o + bn - 1) / bn;
  // shared memory: the A stages, the weights (resident, or a ring of steps), the
  // epilogue's staging, the column table, the tap shifts and the barriers
  const int fixed = HALO_EPI_BYTES + 2 * bn * 4 + HALO_MAX_TAPS * 4 + 8 * (2 * HALO_MAX_A + 2 * HALO_MAX_B + 1) + 1024;
  const long long budget = PW_SMEM - fixed;  // 1024: the weights' 1024-byte alignment after the A stages
  const long long w_bytes = static_cast<long long>(bn) * k_pad, b_step = bn * BK;
  // the tile: the most chunks (at most 2 CPW) whose halo fits two A stages beside the
  // weights, resident where they fit, else a ring of at least two steps; whole images
  // where an image has no more chunks than that, else a band of one image's chunks.
  // The halo rows an image needs (the last chunk's rows past the image read the rows
  // below it, which are computed and not stored; one pixel more for the k32 steps past K)
  bool fits = false;
  for (int tc = 2 * halo_cpw(bn); tc >= 1 && !fits; --tc) {
    long long last;
    s.tile_chunks = tc;
    if (s.chunks <= tc) {
      s.images = tc / s.chunks;
      s.tiles_img = 1;
      last = static_cast<long long>(s.chunks) * HALO_CHUNK + static_cast<long long>(kh - 1) * s.wq + kw - 1;
    } else {
      s.images = 1;
      s.tiles_img = (s.chunks + tc - 1) / tc;
      last = (s.wq - 1) + static_cast<long long>(tc) * HALO_CHUNK + static_cast<long long>(kh - 1) * s.wq + kw - 1;
    }
    s.nr = static_cast<int>(last / s.wq) + 1;
    const long long img_bytes = (static_cast<long long>(s.nr) * s.wq * 16 + 127) / 128 * 128;
    const long long plane_bytes = s.images * img_bytes + 16;
    const long long stage = s.slots * plane_bytes;
    if (plane_bytes >= (1 << 18) / 2) continue;  // the descriptors' 18-bit offsets (LBO is up to two planes)
    s.img_bytes = static_cast<int>(img_bytes);
    s.plane_bytes = static_cast<int>(plane_bytes);
    s.a_stage_bytes = static_cast<int>(stage);
    if (w_bytes + 2 * stage <= budget) {
      s.resident = 1;
      s.a_stages = static_cast<int>(std::min<long long>(HALO_MAX_A, (budget - w_bytes) / stage));
      s.b_stages = 0;
      fits = true;
    } else if (2 * stage + 2 * b_step <= budget) {
      s.resident = 0;
      s.a_stages = 2;
      s.b_stages = static_cast<int>(std::min<long long>(HALO_MAX_B, (budget - 2 * stage) / b_step));
      fits = true;
    }
  }
  if (!fits) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long row_tiles = s.images > 1 ? (n + s.images - 1) / s.images : static_cast<long long>(n) * s.tiles_img;
  if (row_tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  s.row_tiles = static_cast<int>(row_tiles);
  s.blocks_per_col = std::max(1, std::min(sms[dev] / s.col_tiles, s.row_tiles));
  s.off_b = (s.a_stages * s.a_stage_bytes + 1023) / 1024 * 1024;
  s.off_epi = s.off_b + static_cast<int>(s.resident ? w_bytes : s.b_stages * b_step);
  s.off_table = s.off_epi + HALO_EPI_BYTES;
  s.off_shift = s.off_table + 2 * bn * 4;
  s.off_bar = s.off_shift + HALO_MAX_TAPS * 4;
  const int smem_bytes = s.off_bar + 8 * (2 * HALO_MAX_A + 2 * HALO_MAX_B + 1) + 1024;
  if (smem_bytes > PW_SMEM + 1024) return static_cast<int>(cudaErrorLaunchOutOfResources);
  CUtensorMap tm_w;
  err = make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, k_pad, o_rows, k_pad, BK, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_halo(bn, x, tm_w, s_x, w_scale, bias, out, s, s.blocks_per_col * s.col_tiles, smem_bytes,
                       static_cast<cudaStream_t>(stream));
}
