// Serve-mask kernel: f32 probabilities (or logits) -> {0, 255} uint8 mask.
//
// Replaces the Pallas kernel `sigmoid_threshold_mask` of the JAX package
// (distributedpytorch_tpu/ops/kernels.py:493-539, kernel body at :519,
// pallas_call at :531). That kernel pads the flattened plane to
// (n_blk*512, 128) tiles on the host and runs one grid step per tile; here
// the kernel walks the flat array itself and masks the ragged edge, so the
// host pads nothing.
//
// Bound on an H100: pure streaming, 5 bytes moved per pixel (4 read,
// 1 written) and one compare per pixel. At the serve bucket of
// 8 x 640 x 960 that is 24.6 MB, about 7.3 us at 3.35 TB/s; the compare
// work is negligible beside it. The design answers only the byte bound:
// each thread reads 16 bytes (one float4) and writes 4 (one uchar4), so a
// warp issues 512-byte coalesced loads, and a grid-stride loop keeps the
// grid at a few blocks per SM whatever the plane size. A scalar tail
// handles sizes that are not a multiple of 4.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use): pointers, the stream and the threshold's float bits travel as
// void* / int, and the function returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ uint8_t mask_of(float v, float thr, int from_logits) {
  if (from_logits) {
    v = 1.0f / (1.0f + __expf(-v));
  }
  return v >= thr ? uint8_t(255) : uint8_t(0);
}

__global__ void serve_mask_kernel(const float* __restrict__ x,
                                  uint8_t* __restrict__ out, long long n,
                                  float thr, int from_logits) {
  const long long n4 = n >> 2;
  const long long stride = (long long)blockDim.x * gridDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  uchar4* __restrict__ o4 = reinterpret_cast<uchar4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    const float4 v = x4[i];
    uchar4 m;
    m.x = mask_of(v.x, thr, from_logits);
    m.y = mask_of(v.y, thr, from_logits);
    m.z = mask_of(v.z, thr, from_logits);
    m.w = mask_of(v.w, thr, from_logits);
    o4[i] = m;
  }
  const long long tail = (n4 << 2) + tid;  // at most 3 elements remain
  if (tail < n) {
    out[tail] = mask_of(x[tail], thr, from_logits);
  }
}

}  // namespace

extern "C" int dpt_serve_mask(void* x, void* out, int n, int thr_bits,
                              int from_logits, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int threads = 256;
  const long long n4 = (long long)n >> 2;
  long long blocks = (n4 + threads - 1) / threads;
  // 132 SMs x 8 resident blocks of 256 threads: beyond that the
  // grid-stride loop covers the rest
  const long long max_blocks = 132LL * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  float thr;
  static_assert(sizeof(thr) == sizeof(thr_bits), "float and int widths");
  memcpy(&thr, &thr_bits, sizeof(thr));
  serve_mask_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), (long long)n,
      thr, from_logits);
  return (int)cudaGetLastError();
}
