// Loss/Dice statistics kernel (K1) and the fused loss's backward (K1-bwd).
//
// K1 replaces the Pallas kernel `_stats_kernel` of the JAX package
// (distributedpytorch_tpu/ops/pallas_kernels.py:55, pallas_call at :98),
// which the eval step reaches through `eval_stats_pallas` (:121) and the
// training loss's forward through `ops/fused_loss._stats_fwd` (:63). Over
// the flattened probabilities p and targets t, with t_b = [t == 1], it
// gives six float32 sums:
//   [0] sum of -(t_b max(log p, -100) + (1 - t_b) max(log(1 - p), -100))
//   [1] the element count n
//   [2] sum p t_b            [3] sum p + sum t_b
//   [4] sum [p >= .5] t_b    [5] sum [p >= .5] + sum t_b
//
// The Pallas kernel carries six scalars in SMEM across a sequential grid.
// CUDA blocks run in no order, so here each block reduces its share to one
// partial per sum in a scratch buffer, and a second launch of one block
// adds the partials in a fixed order. No float atomics: the grid size
// depends only on n, every thread walks a fixed set of elements, and every
// tree is fixed, so two calls on the same input give bitwise-equal sums.
// The three counts (sum t_b, sum [p >= .5], sum [p >= .5] t_b) are kept as
// integers all the way and turned into float32 once at the end, so [4] and
// [5] are exact below 2^24 (4 x 640 x 960 gives at most 4.9 M). The count
// [1] is written from n on the card.
//
// K1-bwd replaces the custom VJP's backward `_stats_bwd`
// (ops/fused_loss.py:67-78), which the JAX package runs as XLA elementwise
// code: grad_i = ct0 dbce_i + ct2 t_b,i + ct3, with
// dbce = -(t_b [o >= m] / o - (1 - t_b) [1 - o >= m] / (1 - o)) and
// m = 1.1754944e-38 (losses._LOG_SAFE_MIN), so a saturated pixel gets an
// exactly zero BCE gradient. ct is read from device memory: autograd hands
// it over as a tensor on the card, and taking it to the host would stall
// the step.
//
// Bound on an H100: both are streaming passes. K1 reads 8 bytes per
// element (p and t as float32) and writes 24 bytes in all; K1-bwd reads 8
// and writes 4. At 4 x 640 x 960 that is 19.7 MB (5.9 us at 3.35 TB/s) and
// 29.5 MB (8.8 us). A log and a few compares per element are far below the
// card's float32 rate. The design answers the byte bound only: each thread
// loads one float4 of p and one of t per step (a warp issues 512-byte
// coalesced loads), and a grid-stride loop keeps the grid at up to eight
// 256-thread blocks per SM whatever the size. A scalar tail takes sizes
// that are not a multiple of 4.
//
// Build without --use_fast_math: flush-to-zero would change log p for
// subnormal p, and the plain version keeps IEEE logf and division.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use); each entry point returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 132 SMs x 8 resident blocks of 256 threads; the grid-stride loop covers
// the rest
constexpr int kMaxBlocks = 132 * 8;
constexpr float kLogClamp = -100.0f;
constexpr float kLogSafeMin = 1.1754944e-38f;

struct Acc {
  float bce = 0.0f;    // sum of the per-element BCE terms
  float inter = 0.0f;  // sum p t_b
  float sum_p = 0.0f;  // sum p
  unsigned int n_t = 0u;     // sum t_b
  unsigned int n_pred = 0u;  // sum [p >= .5]
  unsigned int n_both = 0u;  // sum [p >= .5] t_b
};

__device__ __forceinline__ void add_element(Acc& a, float p, float t) {
  const bool tb = (t == 1.0f);
  const bool pb = (p >= 0.5f);
  // t_b max(log p, -100) + (1 - t_b) max(log(1 - p), -100) with t_b in
  // {0, 1} and both logs clamped finite is exactly the selected term
  a.bce -= fmaxf(logf(tb ? p : 1.0f - p), kLogClamp);
  a.inter += tb ? p : 0.0f;
  a.sum_p += p;
  a.n_t += tb;
  a.n_pred += pb;
  a.n_both += (tb && pb);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sums v over the block in a fixed tree; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // `shared` may still be read from the previous call
  if (lane == 0) {
    shared[warp] = v;
  }
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += shared[w];
    }
  }
  return total;
}

// Pass 1: block b writes its six partial sums to pf[k * G + b] (floats,
// k < 3) and pu[k * G + b] (counts), G = gridDim.x.
__global__ void stats_partial_kernel(const float* __restrict__ p,
                                     const float* __restrict__ t,
                                     long long n, float* __restrict__ pf,
                                     unsigned int* __restrict__ pu) {
  __shared__ float sf[kWarps];
  __shared__ unsigned int su[kWarps];
  Acc a;
  const long long n4 = n >> 2;
  const long long stride = (long long)blockDim.x * gridDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* __restrict__ p4 = reinterpret_cast<const float4*>(p);
  const float4* __restrict__ t4 = reinterpret_cast<const float4*>(t);
  for (long long i = tid; i < n4; i += stride) {
    const float4 pv = p4[i];
    const float4 tv = t4[i];
    add_element(a, pv.x, tv.x);
    add_element(a, pv.y, tv.y);
    add_element(a, pv.z, tv.z);
    add_element(a, pv.w, tv.w);
  }
  const long long tail = (n4 << 2) + tid;  // at most 3 elements remain
  if (tail < n) {
    add_element(a, p[tail], t[tail]);
  }
  const int g = gridDim.x;
  const int b = blockIdx.x;
  const float bce = block_sum(a.bce, sf);
  const float inter = block_sum(a.inter, sf);
  const float sum_p = block_sum(a.sum_p, sf);
  const unsigned int n_t = block_sum(a.n_t, su);
  const unsigned int n_pred = block_sum(a.n_pred, su);
  const unsigned int n_both = block_sum(a.n_both, su);
  if (threadIdx.x == 0) {
    pf[b] = bce;
    pf[g + b] = inter;
    pf[2 * g + b] = sum_p;
    pu[b] = n_t;
    pu[g + b] = n_pred;
    pu[2 * g + b] = n_both;
  }
}

// Pass 2, one block: adds the G partials in a fixed order and writes the
// six statistics.
__global__ void stats_final_kernel(const float* __restrict__ pf,
                                   const unsigned int* __restrict__ pu,
                                   int g, long long n,
                                   float* __restrict__ out) {
  __shared__ float sf[kWarps];
  __shared__ unsigned long long su[kWarps];
  float bce = 0.0f, inter = 0.0f, sum_p = 0.0f;
  unsigned long long n_t = 0ull, n_pred = 0ull, n_both = 0ull;
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    bce += pf[i];
    inter += pf[g + i];
    sum_p += pf[2 * g + i];
    n_t += pu[i];
    n_pred += pu[g + i];
    n_both += pu[2 * g + i];
  }
  bce = block_sum(bce, sf);
  inter = block_sum(inter, sf);
  sum_p = block_sum(sum_p, sf);
  n_t = block_sum(n_t, su);
  n_pred = block_sum(n_pred, su);
  n_both = block_sum(n_both, su);
  if (threadIdx.x == 0) {
    out[0] = bce;
    out[1] = (float)n;
    out[2] = inter;
    out[3] = sum_p + (float)n_t;
    out[4] = (float)n_both;
    out[5] = (float)(n_pred + n_t);
  }
}

__device__ __forceinline__ float grad_of(float o, float t, float c0, float c2,
                                         float c3) {
  const float tb = (t == 1.0f) ? 1.0f : 0.0f;
  const float inv_o = (o >= kLogSafeMin) ? 1.0f / fmaxf(o, kLogSafeMin) : 0.0f;
  const float q = 1.0f - o;
  const float inv_1mo =
      (q >= kLogSafeMin) ? 1.0f / fmaxf(q, kLogSafeMin) : 0.0f;
  // -(t_b inv_o - (1 - t_b) inv_1mo) with t_b in {0, 1}
  const float dbce = (t == 1.0f) ? -inv_o : inv_1mo;
  // the plain version rounds after every product and sum; __fmul_rn and
  // __fadd_rn keep nvcc from contracting them into fmas, so the kernel
  // rounds at the same places
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, dbce), __fmul_rn(c2, tb)), c3);
}

__global__ void stats_bwd_kernel(const float* __restrict__ o,
                                 const float* __restrict__ t,
                                 const float* __restrict__ ct, long long n,
                                 float* __restrict__ grad) {
  const float c0 = ct[0];
  const float c2 = ct[2];  // ct[1], the count's cotangent, adds nothing
  const float c3 = ct[3];
  const long long n4 = n >> 2;
  const long long stride = (long long)blockDim.x * gridDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* __restrict__ o4 = reinterpret_cast<const float4*>(o);
  const float4* __restrict__ t4 = reinterpret_cast<const float4*>(t);
  float4* __restrict__ g4 = reinterpret_cast<float4*>(grad);
  for (long long i = tid; i < n4; i += stride) {
    const float4 ov = o4[i];
    const float4 tv = t4[i];
    float4 gv;
    gv.x = grad_of(ov.x, tv.x, c0, c2, c3);
    gv.y = grad_of(ov.y, tv.y, c0, c2, c3);
    gv.z = grad_of(ov.z, tv.z, c0, c2, c3);
    gv.w = grad_of(ov.w, tv.w, c0, c2, c3);
    g4[i] = gv;
  }
  const long long tail = (n4 << 2) + tid;
  if (tail < n) {
    grad[tail] = grad_of(o[tail], t[tail], c0, c2, c3);
  }
}

int grid_for(long long n) {
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

}  // namespace

// 32-bit words of scratch that dpt_loss_stats needs: six partials for
// each of at most kMaxBlocks blocks.
extern "C" int dpt_loss_stats_scratch_words(void) { return 6 * kMaxBlocks; }

// p, t: n float32 each, 16-byte aligned. scratch: dpt_loss_stats_scratch_words()
// 32-bit words. out: 6 float32.
extern "C" int dpt_loss_stats(void* p, void* t, int n, void* scratch,
                              void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(n);
  float* pf = static_cast<float*>(scratch);
  unsigned int* pu = reinterpret_cast<unsigned int*>(pf + 3 * g);
  stats_partial_kernel<<<g, kThreads, 0, s>>>(
      static_cast<const float*>(p), static_cast<const float*>(t),
      (long long)n, pf, pu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  stats_final_kernel<<<1, kThreads, 0, s>>>(pf, pu, g, (long long)n,
                                            static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// o, t, grad: n float32 each, 16-byte aligned. ct: 4 float32 on the card.
extern "C" int dpt_loss_stats_bwd(void* o, void* t, void* ct, int n,
                                  void* grad, void* stream) {
  if (n <= 0) {
    return 0;
  }
  stats_bwd_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(t),
      static_cast<const float*>(ct), (long long)n, static_cast<float*>(grad));
  return (int)cudaGetLastError();
}
