// Involution stencil forward for Hopper (sm_90a).
//
// Replaces holocron_tpu/kernels/involution.py:_involution_kernel, the Pallas TPU
// kernel behind Involution2d's stride-1, dilation-1 path:
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
// Next step: a shared-memory halo tile of xp per block (each element loaded once
// instead of k*k times through the cache) and several channels per thread with
// 16-byte loads.

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
