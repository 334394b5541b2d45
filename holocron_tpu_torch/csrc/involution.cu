// Involution stencil for Hopper (sm_90a): forward and both gradients.
//
// The forward replaces holocron_tpu/kernels/involution.py:_involution_kernel, the
// Pallas TPU kernel behind Involution2d's stride-1, dilation-1 path; the two backward
// kernels replace the XLA backward _involution_bwd of involution_stencil_ad:
//
//   out[n,h,w,c] = sum_{tap=(dy,dx)} kern[n,h,w,tap*G + c/(C/G)] * xp[n,h+dy,w+dx,c]
//
// xp is the pre-padded NHWC input (N, H+k-1, W+k-1, C); kern is the tap-major kernel
// field (N, H, W, k*k*G). Accumulation is float32; the result is stored in the
// input's dtype (float32 or bfloat16).
//
// What would bound it is device-memory bytes: the kernel field holds k*k*G values for
// every output pixel, each used by only the C/G channels of its group at that pixel, so
// it is read once and never reused (at N32, 56x56, C128, G8, k7 that is 392 values per
// pixel against C = 128 of input: 0.041 ms for xp, kern and out in bf16).
//
// Backward, for the cotangent g of out (N, H, W, C):
//
//   dxp[n,yy,xx,c]       = sum_{dy,dx: 0<=yy-dy<H, 0<=xx-dx<W} kern[n,yy-dy,xx-dx,tap*G+c/(C/G)]
//                                                              * g[n,yy-dy,xx-dx,c]
//   dkern[n,h,w,tap*G+j] = sum_{c in group j} xp[n,h+dy,w+dx,c] * g[n,h,w,c]
//
// Both would be bound by device-memory bytes (xp, kern and g read once, dxp and dkern
// written once: 0.041 ms at the same shape). But a kernel that reads each of the k*k
// taps through the cache, two bytes at a time, is bound instead by the load (and
// shuffle) instructions it issues and their latency (the general route below: 0.7 ms
// for the forward there, 1.1 and 1.6 ms for the gradients). So all three take one of
// two routes, chosen by shape alone in kernels/involution.py:bwd_route.
//
// Tiled route, where one group's channels are whole 16-byte vectors (cg * itemsize a
// multiple of 16). A block takes a TH x TW tile of pixels of one image and a chunk of
// whole groups, and first copies into shared memory, once, the tile's halo (TH+k-1) x
// (TW+k-1) of the tensor it re-reads k*k times, with 16-byte cp.async copies, a warp
// along each row (copy_halo_tile, then cp_async_wait_all_and_sync). Every other access
// is a 16-byte vector, and index arithmetic is 32-bit (the wrapper refuses tensors of
// 2^31 elements or more). With the loads gone, what bounds the three kernels on the H100
// is the instructions they issue per product: the bf16 unpack and the float32
// arithmetic, and the shared-memory reads (PERF.md gives the measured split).
//  - the forward: the halo is of xp, and beside it the tile's kern values, copied as
//    runs (one run a tile row when the block holds every group). A thread owns one
//    output pixel and one 16-byte vector of channels (inside one group) and walks the
//    taps in the plain version's order, multiplying and adding with separate roundings
//    (__fmul_rn, __fadd_rn) in float32, so it agrees with the plain version bit for bit.
//  - dkern: the halo is of xp. A thread owns one (pixel, group), holds the group's cg
//    values of g in registers, and for each tap reads the group's cg values of xp from
//    shared memory, with no shuffles: the cg products are summed in float32 (four
//    partial sums of fused multiply-adds, so in another order than the plain version)
//    and the tap's value is staged in shared memory. The staged (pixel, tap, group)
//    rows then go out as whole 16-byte stores. The vector a thread reads first is
//    rotated by its group, so the eight threads of a quarter-warp hit distinct banks.
//  - dxp (gather form: no atomics, deterministic): the halo is of g, every output pixel
//    q that reaches the tile, and beside it the kern values the tile needs, copied as
//    runs (for a q and a tap row dy, the taps dx that land in the tile are contiguous
//    in kern): each (q, tap) value feeds one dxp pixel, so kern is read once, but
//    through shared memory its loads leave the taps' critical path. A thread owns one
//    dxp pixel and one 16-byte vector of channels (inside one group), and walks the
//    taps in the plain version's order, multiplying and adding with separate roundings
//    (__fmul_rn, __fadd_rn) in float32, so it agrees with the plain version bit for bit.
//
// General route, every other shape (e.g. cg = 4 in bfloat16, cg = 1): one thread per
// element, loads through the cache, 64-bit indices. The forward and dxp as above, in tap
// order, bit for bit (the C/G threads of a group read the same kern value: one
// broadcast transaction); dkern sums a group's lanes with a warp butterfly (when cg is
// a power of two that divides 32 and C is a multiple of 32), else one thread per dkern
// element sums its group's channels in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256) involution_forward_general_kernel(
    const T* __restrict__ xp, const T* __restrict__ kern, T* __restrict__ out,
    int h, int w, int c, int groups, int k, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  const long long pix = idx / c;  // (n * h + y) * w + x
  const int x = static_cast<int>(pix % w);
  const long long ny = pix / w;   // n * h + y
  const int y = static_cast<int>(ny % h);
  const long long n = ny / h;
  const int wp = w + k - 1;
  const int hp = h + k - 1;
  const int g = ch / (c / groups);
  const T* kp = kern + pix * (static_cast<long long>(k) * k * groups) + g;
  const T* xb = xp + ((n * hp + y) * wp + x) * c + ch;
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    for (int dx = 0; dx < k; ++dx) {
      const float kv = load_f32(kp + (dy * k + dx) * groups);
      const float xv = load_f32(xb + (static_cast<long long>(dy) * wp + dx) * c);
      acc = __fadd_rn(acc, __fmul_rn(kv, xv));
    }
  }
  store_f32(out + idx, acc);
}

template <typename T>
__global__ void __launch_bounds__(256) involution_backward_dxp_kernel(
    const T* __restrict__ kern, const T* __restrict__ g, T* __restrict__ dxp,
    int h, int w, int c, int groups, int k, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int wp = w + k - 1;
  const int hp = h + k - 1;
  const int ch = static_cast<int>(idx % c);
  const long long pix = idx / c;  // (n * hp + yy) * wp + xx
  const int xx = static_cast<int>(pix % wp);
  const long long ny = pix / wp;
  const int yy = static_cast<int>(ny % hp);
  const long long n = ny / hp;
  const int g_idx = ch / (c / groups);
  const int kk = k * k * groups;
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int y = yy - dy;
    if (y < 0 || y >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int x = xx - dx;
      if (x < 0 || x >= w) continue;
      const long long q = (n * h + y) * w + x;  // output pixel that reads xp here at this tap
      const float kv = load_f32(kern + q * kk + (dy * k + dx) * groups + g_idx);
      const float gv = load_f32(g + q * c + ch);
      acc = __fadd_rn(acc, __fmul_rn(kv, gv));
    }
  }
  store_f32(dxp + idx, acc);
}

// One thread per (pixel, channel); the group's cg lanes are adjacent and aligned
// within a warp (cg a power of two dividing 32, c a multiple of 32).
template <typename T>
__global__ void __launch_bounds__(256) involution_backward_dkern_warp_kernel(
    const T* __restrict__ xp, const T* __restrict__ g, T* __restrict__ dkern,
    int h, int w, int c, int groups, int k, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of 32, so a warp is either wholly in range or wholly out
  if (idx >= total) return;
  const int cg = c / groups;
  const int ch = static_cast<int>(idx % c);
  const long long pix = idx / c;  // (n * h + y) * w + x
  const int x = static_cast<int>(pix % w);
  const long long ny = pix / w;
  const int y = static_cast<int>(ny % h);
  const long long n = ny / h;
  const int wp = w + k - 1;
  const int hp = h + k - 1;
  const float gv = load_f32(g + idx);
  const T* xb = xp + ((n * hp + y) * wp + x) * c + ch;
  T* out = dkern + pix * (static_cast<long long>(k) * k * groups) + ch / cg;
  const bool leader = (ch % cg) == 0;
  for (int dy = 0; dy < k; ++dy) {
    for (int dx = 0; dx < k; ++dx) {
      float v = __fmul_rn(load_f32(xb + (static_cast<long long>(dy) * wp + dx) * c), gv);
      for (int off = cg / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (leader) store_f32(out + (dy * k + dx) * groups, v);
    }
  }
}

// One thread per dkern element (any cg), the group's channels summed in order.
template <typename T>
__global__ void __launch_bounds__(256) involution_backward_dkern_kernel(
    const T* __restrict__ xp, const T* __restrict__ g, T* __restrict__ dkern,
    int h, int w, int c, int groups, int k, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int kk = k * k * groups;
  const int j = static_cast<int>(idx % kk);  // tap * groups + group
  const long long pix = idx / kk;
  const int tap = j / groups, grp = j % groups;
  const int dy = tap / k, dx = tap % k;
  const int x = static_cast<int>(pix % w);
  const long long ny = pix / w;
  const int y = static_cast<int>(ny % h);
  const long long n = ny / h;
  const int wp = w + k - 1;
  const int hp = h + k - 1;
  const int cg = c / groups;
  const T* xb = xp + ((n * hp + y + dy) * wp + x + dx) * c + grp * cg;
  const T* gb = g + pix * c + grp * cg;
  float acc = 0.f;
  for (int i = 0; i < cg; ++i) acc = __fadd_rn(acc, __fmul_rn(load_f32(xb + i), load_f32(gb + i)));
  store_f32(dkern + idx, acc);
}

// ---- tiled route ------------------------------------------------------------------

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void to_float(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y), f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}

// bfloat16 is the upper half of a float32; element 0 is the low half of v.x
__device__ __forceinline__ void to_float(const uint4& v, float (&f)[8]) {
  const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) f[2 * i] = __uint_as_float(u[i] << 16), f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
}

__device__ __forceinline__ uint4 from_float(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&p);
}

__device__ __forceinline__ uint4 from_float(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) { return *reinterpret_cast<const uint4*>(p); }

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// Waits for this thread's cp.async copies, then for the block's.
__device__ __forceinline__ void cp_async_wait_all_and_sync() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Starts copying rows [oy, oy + rows) x columns [ox, ox + cols) of image n of the NHWC
// tensor src (hs x ws x c), channels [c0, c0 + cc), into shared memory laid out
// [rows][cols][cc], with 16-byte cp.async copies. Pixels outside the image are not
// written: callers never read them. cc, c0 and c are whole 16-byte vectors and the
// image has fewer than 2^31 elements.
template <typename T>
__device__ void copy_halo_tile(T* tile, const T* __restrict__ src, int n, int hs, int ws, int c, int oy, int ox,
                               int rows, int cols, int c0, int cc) {
  constexpr int E = kVec<T>;
  // a warp per row; the row's pixels inside the image are one run of vectors (one
  // contiguous run of src when the tile holds every channel)
  const int vecs = cc / E, x_lo = max(ox, 0), run = (min(ox + cols, ws) - x_lo) * vecs;
  for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {
    const int y = oy + r;
    if (y < 0 || y >= hs) continue;
    const T* from = src + ((n * hs + y) * ws + x_lo) * c + c0;
    const unsigned int to = smem_addr(tile + (r * cols + x_lo - ox) * cc);
    for (int j = threadIdx.x % 32; j < run; j += 32) {
      const int offset = cc == c ? j * E : (j / vecs) * c + (j % vecs) * E;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to + 16u * j), "l"(from + offset) : "memory");
    }
  }
}

// Starts copying `bytes` from global to shared memory in units of `unit` bytes (16, 8,
// 4 or 2; both addresses and `bytes` are multiples of it): cp.async where the unit is 4
// bytes or more, else through registers. Shared by `lanes` threads, of which this is
// `lane`: it copies units lane, lane + lanes, ...
__device__ __forceinline__ void copy_run(void* dst, const void* src, int bytes, int unit, int lane = 0,
                                         int lanes = 1) {
  const unsigned int d = smem_addr(dst);
  const char* s = static_cast<const char*>(src);
  const int first = lane * unit, step = lanes * unit;
  if (unit == 16) {
    for (int b = first; b < bytes; b += step)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + b), "l"(s + b) : "memory");
  } else if (unit == 8) {
    for (int b = first; b < bytes; b += step)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d + b), "l"(s + b) : "memory");
  } else if (unit == 4) {
    for (int b = first; b < bytes; b += step)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + b), "l"(s + b) : "memory");
  } else {
    for (int b = first; b < bytes; b += step)
      *reinterpret_cast<unsigned short*>(static_cast<char*>(dst) + b) = *reinterpret_cast<const unsigned short*>(s + b);
  }
}

// The tiles of a tiled launch: block t takes (image, chunk of gb groups, TH x TW tile of
// a rows x cols grid), the tile fastest, so that neighbouring blocks, which run at the
// same time, share their halos' rows through L2.
struct Tiling {
  int n, g0, y0, x0;
  __device__ Tiling(int rows, int cols, int groups, int th, int tw, int gb) {
    const int tiles_x = (cols + tw - 1) / tw, tiles = tiles_x * ((rows + th - 1) / th);
    const int tile = blockIdx.x % tiles, rest = blockIdx.x / tiles, chunks = groups / gb;
    n = rest / chunks, g0 = (rest % chunks) * gb;
    y0 = (tile / tiles_x) * th, x0 = (tile % tiles_x) * tw;
  }
};

// One tap of the forward or of dxp: acc += kv * v, a multiply and an add, each rounded
// (the plain version's arithmetic), for one 16-byte vector v in shared memory.
template <typename T>
__device__ __forceinline__ void tap_mul_add(float (&acc)[kVec<T>], T kv, const T* v) {
  const float kf = to_f32(kv);
  float vf[kVec<T>];
  to_float(ld16(v), vf);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(kf, vf[e]));
}

// The forward: shared memory holds the halo of xp, [TH+k-1][TW+k-1][cc], then the tile's
// kern values [pixel][tap][group of the chunk]: when the block holds every group, a tile
// row's pixels are one contiguous run of kern, copied by a warp. A thread owns one output
// pixel and one 16-byte vector of channels (inside one group) and walks the taps in the
// plain version's order: one kern value and one 16-byte vector of xp a tap, both from
// shared memory. K as for dxp below; every tap of an output pixel lies inside the
// pre-padded xp, so the taps need no checks.
template <typename T, int K>
__global__ void __launch_bounds__(256) involution_forward_tiled_kernel(
    const T* __restrict__ xp, const T* __restrict__ kern, T* __restrict__ out, int h, int w, int c, int groups,
    int k_arg, int th, int tw, int gb) {
  extern __shared__ uint4 smem[];
  constexpr int E = kVec<T>, kUnrolled = K > 0 ? K : 1;  // K = 0 never takes the unrolled loops
  const int k = K > 0 ? K : k_arg;
  const int cols = tw + k - 1, taps = k * k, kk = taps * groups;
  const int cg = c / groups, cc = gb * cg, vecs = cc / E;
  const Tiling at(h, w, groups, th, tw, gb);
  const int n = at.n, g0 = at.g0, y0 = at.y0, x0 = at.x0, c0 = g0 * cg, tw_in = min(tw, w - x0);
  T* tile = reinterpret_cast<T*>(smem);
  T* ks = tile + (th + k - 1) * cols * cc;  // a whole number of 16-byte vectors in
  copy_halo_tile(tile, xp, n, h + k - 1, w + k - 1, c, y0, x0, th + k - 1, cols, c0, cc);
  if (gb == groups) {
    const int bytes = kk * static_cast<int>(sizeof(T)), unit = min(16, bytes & -bytes);
    for (int r = threadIdx.x / 32; r < th; r += blockDim.x / 32) {
      if (y0 + r >= h) continue;
      copy_run(ks + r * tw * kk, kern + ((n * h + y0 + r) * w + x0) * kk, tw_in * bytes, unit, threadIdx.x % 32, 32);
    }
  } else {  // a thread per (pixel, tap): the chunk's gb values
    const int bytes = gb * static_cast<int>(sizeof(T)), unit = min(16, bytes & -bytes);
    for (int i = threadIdx.x; i < th * tw * taps; i += blockDim.x) {
      const int p = i / taps, py = p / tw, px = p % tw;
      if (y0 + py >= h || px >= tw_in) continue;
      copy_run(ks + i * gb, kern + ((n * h + y0 + py) * w + x0 + px) * kk + (i % taps) * groups + g0, bytes, unit);
    }
  }
  cp_async_wait_all_and_sync();

  for (int i = threadIdx.x; i < th * tw * vecs; i += blockDim.x) {
    const int v = i % vecs, p = i / vecs, py = p / tw, px = p % tw;
    if (y0 + py >= h || px >= tw_in) continue;
    // tap (dy, dx) reads kv[(dy * k + dx) * gb] and xv[(dy * cols + dx) * cc]
    const T* kv = ks + p * taps * gb + v * E / cg;
    const T* xv = tile + (py * cols + px) * cc + v * E;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (K > 0) {
#pragma unroll
      for (int dy = 0; dy < kUnrolled; ++dy)
#pragma unroll
        for (int dx = 0; dx < kUnrolled; ++dx)
          tap_mul_add(acc, kv[(dy * kUnrolled + dx) * gb], xv + (dy * cols + dx) * cc);
    } else {
      for (int dy = 0; dy < k; ++dy)
        for (int dx = 0; dx < k; ++dx) tap_mul_add(acc, kv[(dy * k + dx) * gb], xv + (dy * cols + dx) * cc);
    }
    *reinterpret_cast<uint4*>(out + ((n * h + y0 + py) * w + x0 + px) * c + c0 + v * E) = from_float(acc);
  }
}

// dxp: shared memory holds the halo of g, [TH+k-1][TW+k-1][cc], and the kern values the
// tile needs, [dy][TH][TW+k-1][dx][gb]: for each tap row dy and each q of the TH rows
// that reach the tile through it, the values of the taps (dy, dx) that land inside the
// tile, a contiguous run of kern when the block holds every group. K: the kernel size
// when it is known at compile time (3, 5, 7), else 0; with K known the taps of a pixel
// whose k x k taps all lie inside the image unroll with no checks.
template <typename T, int K>
__global__ void __launch_bounds__(256) involution_backward_dxp_tiled_kernel(
    const T* __restrict__ kern, const T* __restrict__ g, T* __restrict__ dxp, int h, int w, int c, int groups,
    int k_arg, int th, int tw, int gb) {
  extern __shared__ uint4 smem[];
  constexpr int E = kVec<T>, kUnrolled = K > 0 ? K : 1;  // K = 0 never takes the unrolled loops
  const int k = K > 0 ? K : k_arg;
  const int hp = h + k - 1, wp = w + k - 1, cols = tw + k - 1, kk = k * k * groups;
  const int cg = c / groups, cc = gb * cg, vecs = cc / E;
  const Tiling at(hp, wp, groups, th, tw, gb);
  const int n = at.n, g0 = at.g0, y0 = at.y0, x0 = at.x0, c0 = g0 * cg;
  T* tile = reinterpret_cast<T*>(smem);
  T* ks = tile + (th + k - 1) * cols * cc;  // a whole number of 16-byte vectors in
  copy_halo_tile(tile, g, n, h, w, c, y0 - (k - 1), x0 - (k - 1), th + k - 1, cols, c0, cc);
  {
    // a warp per (dy, q row), a lane per q: the run of taps dx in [lo, hi) whose dxp
    // column lies in the tile
    const int bytes = gb * static_cast<int>(sizeof(T)), unit = min(16, bytes & -bytes);
    for (int r = threadIdx.x / 32; r < k * th; r += blockDim.x / 32) {
      const int dy = r / th, qy = y0 - dy + r % th;
      if (qy < 0 || qy >= h) continue;
      for (int qc = threadIdx.x % 32; qc < cols; qc += 32) {
        const int qx = x0 - (k - 1) + qc;
        if (qx < 0 || qx >= w) continue;
        const int lo = max(0, k - 1 - qc), hi = min(k, cols - qc);
        const T* src = kern + ((n * h + qy) * w + qx) * kk + dy * k * groups + g0;
        T* dst = ks + ((r * cols + qc) * k) * gb;
        if (gb == groups) {
          copy_run(dst + lo * gb, src + lo * groups, (hi - lo) * bytes, unit);
        } else {
          for (int dx = lo; dx < hi; ++dx) copy_run(dst + dx * gb, src + dx * groups, bytes, unit);
        }
      }
    }
  }
  cp_async_wait_all_and_sync();

  for (int i = threadIdx.x; i < th * tw * vecs; i += blockDim.x) {
    const int v = i % vecs, p = i / vecs, py = p / tw, px = p % tw;
    const int yy = y0 + py, xx = x0 + px;
    if (yy >= hp || xx >= wp) continue;
    // tap (dy, dx) reads kv[dy * kv_dy + dx * kv_dx] and gv[-(dy * cols + dx) * cc]
    const T* kv = ks + ((py * cols + px + k - 1) * k) * gb + (c0 + v * E) / cg - g0;
    const int kv_dy = th * cols * k * gb, kv_dx = (1 - k) * gb;
    const T* gv = tile + ((py + k - 1) * cols + px + k - 1) * cc + v * E;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (K > 0 && yy >= k - 1 && yy < h && xx >= k - 1 && xx < w) {  // every tap inside the image
#pragma unroll
      for (int dy = 0; dy < kUnrolled; ++dy)
#pragma unroll
        for (int dx = 0; dx < kUnrolled; ++dx)
          tap_mul_add(acc, kv[dy * kv_dy + dx * kv_dx], gv - (dy * cols + dx) * cc);
    } else {
      for (int dy = 0; dy < k; ++dy) {
        if (yy - dy < 0 || yy - dy >= h) continue;
        for (int dx = 0; dx < k; ++dx)
          if (xx - dx >= 0 && xx - dx < w) tap_mul_add(acc, kv[dy * kv_dy + dx * kv_dx], gv - (dy * cols + dx) * cc);
      }
    }
    *reinterpret_cast<uint4*>(dxp + ((n * hp + yy) * wp + xx) * c + c0 + v * E) = from_float(acc);
  }
}

// The dot product of a group's cg values of xp (shared memory, 16-byte vectors at xt +
// off[j]) and of g (registers), in float32: four partial sums of fused multiply-adds.
template <typename T, int NV>
__device__ __forceinline__ float group_dot(const T* xt, const int (&off)[NV], const float (&gf)[NV][kVec<T>]) {
  constexpr int E = kVec<T>;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float xf[E];
    to_float(ld16(xt + off[j]), xf);
#pragma unroll
    for (int e = 0; e < E; ++e) a[e % 4] = fmaf(xf[e], gf[j][e], a[e % 4]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Writes the 16-byte-aligned chunk [a, a + E) of out that a run [start, start + len)
// covers, from src (src[j - start] is element j): a whole vector where the run covers
// the chunk, else element by element.
template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ out, int start, int len, const T* src, int a) {
  constexpr int E = kVec<T>;
  if (a >= start && a + E <= start + len) {
    float f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_f32(src[a + e - start]);
    *reinterpret_cast<uint4*>(out + a) = from_float(f);
  } else {
    for (int j = max(a, start); j < min(a + E, start + len); ++j) out[j] = src[j - start];
  }
}

// dkern: shared memory holds the halo of xp, [TH+k-1][TW+k-1][cc], then the tile's
// staged dkern values [pixel][tap][group of the chunk]. NV: 16-byte vectors in a group,
// held in registers (1, 2 or 4), or 0: any count, g read per tap. K as for dxp.
template <typename T, int NV, int K>
__global__ void __launch_bounds__(256) involution_backward_dkern_tiled_kernel(
    const T* __restrict__ xp, const T* __restrict__ g, T* __restrict__ dkern, int h, int w, int c, int groups,
    int k_arg, int th, int tw, int gb) {
  extern __shared__ uint4 smem[];
  constexpr int E = kVec<T>;
  const int k = K > 0 ? K : k_arg;
  const int hp = h + k - 1, wp = w + k - 1, cols = tw + k - 1, taps = k * k;
  const int cg = c / groups, cc = gb * cg;
  const Tiling at(h, w, groups, th, tw, gb);
  const int n = at.n, g0 = at.g0, y0 = at.y0, x0 = at.x0;
  T* tile = reinterpret_cast<T*>(smem);
  T* staged = tile + (th + k - 1) * cols * cc;  // a whole number of 16-byte vectors in
  copy_halo_tile(tile, xp, n, hp, wp, c, y0, x0, th + k - 1, cols, g0 * cg, cc);
  cp_async_wait_all_and_sync();

  for (int i = threadIdx.x; i < th * tw * gb; i += blockDim.x) {
    const int gl = i % gb, p = i / gb;
    const int py = p / tw, px = p % tw;
    if (y0 + py >= h || x0 + px >= w) continue;
    const T* gp = g + ((n * h + y0 + py) * w + x0 + px) * c + (g0 + gl) * cg;
    const T* xb = tile + (py * cols + px) * cc + gl * cg;
    T* out = staged + p * taps * gb + gl;
    if constexpr (NV > 0) {
      // rotate the first vector by the group, so that a quarter-warp's eight threads
      // (eight groups of one pixel) read eight distinct 16-byte bank slots
      const int rot = ((gl * NV) >> 3) % NV;
      int off[NV];
      float gf[NV][E];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        off[j] = ((j + rot) % NV) * E;
        to_float(ldg16(gp + off[j]), gf[j]);
      }
      if constexpr (K > 0) {
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            store_f32(out + (dy * k + dx) * gb, group_dot<T, NV>(xb + (dy * cols + dx) * cc, off, gf));
      } else {
        for (int dy = 0; dy < k; ++dy)
          for (int dx = 0; dx < k; ++dx)
            store_f32(out + (dy * k + dx) * gb, group_dot<T, NV>(xb + (dy * cols + dx) * cc, off, gf));
      }
    } else {
      for (int dy = 0; dy < k; ++dy) {
        for (int dx = 0; dx < k; ++dx) {
          const T* xt = xb + (dy * cols + dx) * cc;
          float a0 = 0.f, a1 = 0.f;
          for (int j = 0; j < cg; j += E) {
            float xf[E], gf[E];
            to_float(ld16(xt + j), xf);
            to_float(ldg16(gp + j), gf);
#pragma unroll
            for (int e = 0; e < E; e += 2) a0 = fmaf(xf[e], gf[e], a0), a1 = fmaf(xf[e + 1], gf[e + 1], a1);
          }
          store_f32(out + (dy * k + dx) * gb, a0 + a1);
        }
      }
    }
  }
  __syncthreads();

  // Out in contiguous runs of 16-byte-aligned chunks: when the block holds every group,
  // each tile row's whole dkern rows are one run, a warp per run; else each (pixel,
  // tap)'s gb values are one, a thread per run.
  const int row = taps * groups;
  if (gb == groups) {
    for (int r = threadIdx.x / 32; r < th; r += blockDim.x / 32) {
      if (y0 + r >= h) continue;
      const int start = ((n * h + y0 + r) * w + x0) * row, len = min(tw, w - x0) * row;
      for (int a = (start & ~(E - 1)) + (threadIdx.x % 32) * E; a < start + len; a += 32 * E)
        store_chunk(dkern, start, len, staged + r * tw * row, a);
    }
  } else {
    for (int r = threadIdx.x; r < th * tw * taps; r += blockDim.x) {
      const int p = r / taps, tap = r % taps;
      if (y0 + p / tw >= h || x0 + p % tw >= w) continue;
      const int start = ((n * h + y0 + p / tw) * w + x0 + p % tw) * row + tap * groups + g0;
      for (int a = start & ~(E - 1); a < start + gb; a += E) store_chunk(dkern, start, gb, staged + r * gb, a);
    }
  }
}

}  // namespace

extern "C" const char* holocron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The general route's forward (one thread per element, any shape). dtype: 0 = float32,
// 1 = bfloat16. Each entry point returns cudaGetLastError() after its launch.
extern "C" int involution_forward_general(const void* xp, const void* kern, void* out, int dtype,
                                          int n, int h, int w, int c, int groups, int k, void* stream) {
  const long long total = static_cast<long long>(n) * h * w * c;
  if (total == 0) return 0;
  if (groups <= 0 || k <= 0 || c % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    involution_forward_general_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(kern), static_cast<float*>(out),
        h, w, c, groups, k, total);
  } else if (dtype == 1) {
    involution_forward_general_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(kern),
        static_cast<__nv_bfloat16*>(out), h, w, c, groups, k, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The general route's two gradients, one entry point each; dtype as above.
extern "C" int involution_backward_dxp_general(const void* kern, const void* g, void* dxp, int dtype, int n, int h,
                                       int w, int c, int groups, int k, void* stream) {
  if (groups <= 0 || k <= 0 || c % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * (h + k - 1) * (w + k - 1) * c;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    involution_backward_dxp_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(kern), static_cast<const float*>(g), static_cast<float*>(dxp),
        h, w, c, groups, k, total);
  } else if (dtype == 1) {
    involution_backward_dxp_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(kern), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dxp), h, w, c, groups, k, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static void launch_dkern(const void* xp, const void* g, void* dkern, int n, int h, int w, int c, int groups,
                         int k, cudaStream_t s) {
  const int threads = 256;
  const int cg = c / groups;
  const long long pix = static_cast<long long>(n) * h * w;
  if (c % 32 == 0 && cg <= 32 && (cg & (cg - 1)) == 0) {
    const long long total = pix * c;
    involution_backward_dkern_warp_kernel<T><<<static_cast<unsigned int>((total + threads - 1) / threads),
                                               threads, 0, s>>>(
        static_cast<const T*>(xp), static_cast<const T*>(g), static_cast<T*>(dkern), h, w, c, groups, k, total);
  } else {
    const long long total = pix * k * k * groups;
    involution_backward_dkern_kernel<T><<<static_cast<unsigned int>((total + threads - 1) / threads),
                                          threads, 0, s>>>(
        static_cast<const T*>(xp), static_cast<const T*>(g), static_cast<T*>(dkern), h, w, c, groups, k, total);
  }
}

extern "C" int involution_backward_dkern_general(const void* xp, const void* g, void* dkern, int dtype, int n,
                                                 int h, int w, int c, int groups, int k, void* stream) {
  if (groups <= 0 || k <= 0 || c % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(n) * h * w * c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dkern<float>(xp, g, dkern, n, h, w, c, groups, k, s);
  } else if (dtype == 1) {
    launch_dkern<__nv_bfloat16>(xp, g, dkern, n, h, w, c, groups, k, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---- tiled route: launch -----------------------------------------------------------

// Shared memory a tiled block plans for: first at most half of an SM's 228 KB, so that
// at least two blocks share an SM; else all a block may have.
constexpr long long kHalfSmBytes = 113 * 1024;
constexpr long long kBlockSmemMax = 227 * 1024;

template <typename T>
using TiledKernel = void (*)(const T*, const T*, T*, int, int, int, int, int, int, int, int);

// Tiles of the forward and dkern (they tile the H x W grid) and of dxp (the padded
// Hp x Wp grid), in the order tried. The first are the fastest measured at N32, 56x56,
// C128, G8, k7 on an H100 (PERF.md): the forward in 8 x 8 tiles, dxp in rows of 16
// pixels, dkern in 4 x 8 tiles; larger tiles re-read less of the halo but hold fewer
// blocks an SM.
constexpr int kFwdTiles[][2] = {{8, 8}, {4, 8}, {2, 8}, {1, 8}, {1, 4}, {1, 2}, {1, 1}};
constexpr int kDxpTiles[][2] = {{1, 16}, {1, 8}, {1, 4}, {1, 2}, {1, 1}};
constexpr int kDkernTiles[][2] = {{4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};

// Launches a tiled kernel, one block a tile, on the first plan that fits: the most
// groups a block (all of them down to one), then the first tile of `tiles`, within half
// an SM's shared memory, else within a block's. `padded`: the tiles cover dxp's padded
// grid. Shared memory: the halo, then the forward's or dxp's kern values or dkern's
// staged output.
template <typename T, int N>
static int launch_tiled(TiledKernel<T> kernel, const int (&tiles)[N][2], bool padded, const void* a, const void* b,
                        void* out, int n, int h, int w, int c, int groups, int k, cudaStream_t s) {
  const int cg = c / groups;
  const int rows = padded ? h + k - 1 : h, cols = padded ? w + k - 1 : w;
  const long long budgets[] = {kHalfSmBytes, kBlockSmemMax};
  for (long long budget : budgets) {
    for (int gb = groups; gb >= 1; --gb) {
      if (groups % gb != 0) continue;
      for (int t = 0; t < N; ++t) {
        const int th = std::min(tiles[t][0], rows), tw = std::min(tiles[t][1], cols);
        const long long halo = static_cast<long long>(th + k - 1) * (tw + k - 1) * gb * cg;
        const long long staged = static_cast<long long>(th) * (padded ? tw + k - 1 : tw) * k * k * gb;
        const long long bytes = (halo + staged) * sizeof(T);
        if (bytes > budget) continue;
        const int smem = static_cast<int>(bytes);
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const long long blocks =
            static_cast<long long>((rows + th - 1) / th) * ((cols + tw - 1) / tw) * (groups / gb) * n;
        if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
        kernel<<<static_cast<unsigned int>(blocks), 256, smem, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                                    static_cast<T*>(out), h, w, c, groups, k, th, tw,
                                                                    gb);
        return static_cast<int>(cudaGetLastError());
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);  // even one pixel of one group exceeds a block's shared memory
}

// What the tiled route takes: a non-empty output, whole 16-byte vectors in a group,
// 32-bit indices (xp, and kern as if it spanned the padded grid, below 2^31 elements).
static bool tiled_shape_ok(int n, int h, int w, int c, int groups, int k, int itemsize) {
  if (n <= 0 || h < 0 || w < 0 || c <= 0 || groups <= 0 || k <= 0 || c % groups != 0) return false;
  if ((c / groups) * itemsize % 16 != 0) return false;
  const long long pixels = static_cast<long long>(n) * (h + k - 1) * (w + k - 1);
  return pixels * c < (1LL << 31) && pixels * k * k * groups < (1LL << 31);
}

template <typename T>
static int launch_dxp_tiled(const void* kern, const void* g, void* dxp, int n, int h, int w, int c, int groups, int k,
                            cudaStream_t s) {
  TiledKernel<T> kernel;
  switch (k) {
    case 3: kernel = involution_backward_dxp_tiled_kernel<T, 3>; break;
    case 5: kernel = involution_backward_dxp_tiled_kernel<T, 5>; break;
    case 7: kernel = involution_backward_dxp_tiled_kernel<T, 7>; break;
    default: kernel = involution_backward_dxp_tiled_kernel<T, 0>; break;
  }
  return launch_tiled<T>(kernel, kDxpTiles, true, kern, g, dxp, n, h, w, c, groups, k, s);
}

template <typename T, int NV>
static TiledKernel<T> dkern_kernel(int k) {
  switch (k) {
    case 3: return involution_backward_dkern_tiled_kernel<T, NV, 3>;
    case 5: return involution_backward_dkern_tiled_kernel<T, NV, 5>;
    case 7: return involution_backward_dkern_tiled_kernel<T, NV, 7>;
    default: return involution_backward_dkern_tiled_kernel<T, NV, 0>;
  }
}

template <typename T>
static int launch_dkern_tiled(const void* xp, const void* g, void* dkern, int n, int h, int w, int c, int groups,
                              int k, cudaStream_t s) {
  TiledKernel<T> kernel;
  switch ((c / groups) * static_cast<int>(sizeof(T)) / 16) {
    case 1: kernel = dkern_kernel<T, 1>(k); break;
    case 2: kernel = dkern_kernel<T, 2>(k); break;
    case 4: kernel = dkern_kernel<T, 4>(k); break;
    default: kernel = involution_backward_dkern_tiled_kernel<T, 0, 0>; break;
  }
  return launch_tiled<T>(kernel, kDkernTiles, false, xp, g, dkern, n, h, w, c, groups, k, s);
}

template <typename T>
static int launch_forward_tiled(const void* xp, const void* kern, void* out, int n, int h, int w, int c, int groups,
                                int k, cudaStream_t s) {
  TiledKernel<T> kernel;
  switch (k) {
    case 3: kernel = involution_forward_tiled_kernel<T, 3>; break;
    case 5: kernel = involution_forward_tiled_kernel<T, 5>; break;
    case 7: kernel = involution_forward_tiled_kernel<T, 7>; break;
    default: kernel = involution_forward_tiled_kernel<T, 0>; break;
  }
  return launch_tiled<T>(kernel, kFwdTiles, false, xp, kern, out, n, h, w, c, groups, k, s);
}

// The tiled route's forward and two gradients; dtype as above.
extern "C" int involution_forward(const void* xp, const void* kern, void* out, int dtype, int n, int h, int w, int c,
                                  int groups, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tiled_shape_ok(n, h, w, c, groups, k, 4))
    return launch_forward_tiled<float>(xp, kern, out, n, h, w, c, groups, k, s);
  if (dtype == 1 && tiled_shape_ok(n, h, w, c, groups, k, 2))
    return launch_forward_tiled<__nv_bfloat16>(xp, kern, out, n, h, w, c, groups, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int involution_backward_dxp(const void* kern, const void* g, void* dxp, int dtype, int n, int h, int w,
                                       int c, int groups, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tiled_shape_ok(n, h, w, c, groups, k, 4))
    return launch_dxp_tiled<float>(kern, g, dxp, n, h, w, c, groups, k, s);
  if (dtype == 1 && tiled_shape_ok(n, h, w, c, groups, k, 2))
    return launch_dxp_tiled<__nv_bfloat16>(kern, g, dxp, n, h, w, c, groups, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int involution_backward_dkern(const void* xp, const void* g, void* dkern, int dtype, int n, int h, int w,
                                         int c, int groups, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tiled_shape_ok(n, h, w, c, groups, k, 4))
    return launch_dkern_tiled<float>(xp, g, dkern, n, h, w, c, groups, k, s);
  if (dtype == 1 && tiled_shape_ok(n, h, w, c, groups, k, 2))
    return launch_dkern_tiled<__nv_bfloat16>(xp, g, dkern, n, h, w, c, groups, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
