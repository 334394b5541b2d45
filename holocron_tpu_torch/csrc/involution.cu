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
// What bounds it: device-memory bytes. The kernel field holds k*k*G values for every
// output pixel and each is used by only the C/G channels of its group at that pixel,
// so it is read once and never reused; at the repo's benchmark shape (N32, 56x56,
// C128, G8, k7) that is k*k*G = 392 values per pixel against C = 128 values of input,
// three times the input's bytes. The design keeps that one
// read coalesced-friendly and adds nothing to it: one thread per output element
// (n,h,w,c) with c fastest, so a warp reads 32 neighbouring channels of xp per tap,
// and the C/G threads of one group read the same kernel value (one transaction,
// broadcast). The k*k re-reads of xp by neighbouring pixels hit L1/L2, not device
// memory. Multiplies and adds are rounded separately (no fused multiply-add) in tap
// order, which is the order of the plain PyTorch version, so the two agree bit for bit.
//
// Backward, for the cotangent g of out (N, H, W, C):
//
//   dxp[n,yy,xx,c]       = sum_{dy,dx: 0<=yy-dy<H, 0<=xx-dx<W} kern[n,yy-dy,xx-dx,tap*G+c/(C/G)]
//                                                              * g[n,yy-dy,xx-dx,c]
//   dkern[n,h,w,tap*G+j] = sum_{c in group j} xp[n,h+dy,w+dx,c] * g[n,h,w,c]
//
// Both are bound by device-memory bytes too (xp, kern and g read once, dxp and dkern
// written once). dxp is written in gather form: one thread per element of dxp, c
// fastest, looping over the k*k taps that reach it, so no two threads write one
// element and no atomics are needed; it adds in tap order with separate roundings, as
// the plain version does, so the two agree bit for bit. dkern gives one thread per
// (pixel, channel), c fastest as in the forward; for each tap the cg = C/G products of
// a group are summed across the group's lanes with warp shuffles (a butterfly, when cg
// is a power of two that divides 32 and C is a multiple of 32), and the group's first
// lane stores the sum. Other shapes take one thread per dkern element summing its
// group's channels in order. Sums are float32, rounded once into the dtype.
//
// Next step: a shared-memory halo tile of xp per block (each element loaded once
// instead of k*k times through the cache) and several channels per thread with
// 16-byte loads, in all three kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256) involution_forward_kernel(
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

}  // namespace

extern "C" const char* holocron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int involution_forward(const void* xp, const void* kern, void* out, int dtype,
                                  int n, int h, int w, int c, int groups, int k, void* stream) {
  const long long total = static_cast<long long>(n) * h * w * c;
  if (total == 0) return 0;
  if (groups <= 0 || k <= 0 || c % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    involution_forward_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(kern), static_cast<float*>(out),
        h, w, c, groups, k, total);
  } else if (dtype == 1) {
    involution_forward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(kern),
        static_cast<__nv_bfloat16*>(out), h, w, c, groups, k, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two gradients, one entry point each; dtype as above.
extern "C" int involution_backward_dxp(const void* kern, const void* g, void* dxp, int dtype, int n, int h,
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

extern "C" int involution_backward_dkern(const void* xp, const void* g, void* dkern, int dtype, int n, int h,
                                         int w, int c, int groups, int k, void* stream) {
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
