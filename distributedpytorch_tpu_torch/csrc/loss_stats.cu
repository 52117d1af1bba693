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
// card's float32 rate.
//
// K1's design answers the byte bound and a fixed cost per launch that is
// a third of it:
// - One launch. The Pallas kernel carries six scalars in SMEM across a
//   sequential grid; CUDA blocks run in no order, so each block reduces its
//   share to six partials in a workspace and takes a ticket from an integer
//   counter there, with one atomic add of acquire-release semantics (the
//   release makes the block's partials visible before its ticket is
//   taken). The block that takes the last ticket adds every block's
//   partials in an order fixed by block index (its thread i takes blocks
//   i, i + kStatsThreads, ... in turn, then one fixed tree), writes the six
//   sums and sets the counter back to 0 for the next call on the stream.
//   No float atomics and no dependence on which block finishes first, so
//   two calls on the same input give bitwise-equal sums. A cooperative
//   launch with a grid barrier would do the same with every block waiting
//   on the slowest and the grid bound to stay co-resident; the ticket lets
//   all but one block leave at once, so it was chosen.
// - A grid of whole waves: SMs x resident blocks per SM (this kernel's
//   occupancy on the card), each block one contiguous, float4-aligned
//   chunk of at least one float4 per thread. The plan is computed in
//   Python (ops/loss_kernels.loss_stats_plan) and the entry point refuses
//   any other geometry.
// - Each thread issues kUnroll float4 loads of p and of t before it
//   computes, as streaming loads (__ldcs: the inputs are read once); a
//   scalar tail in the last block takes sizes that are not a multiple of 4.
// - One block-wide reduction of all six values in one shared-memory round
//   trip; the last block issues all its loads of partials before it adds.
// The counts (sum t_b, sum [p >= .5], sum [p >= .5] t_b) are integers all
// the way, summed in 64 bits in the last block and turned into float32 once,
// so [4] and [5] are exact below 2^24 (4 x 640 x 960 gives at most 4.9 M).
// The count [1] is written from n. The workspace (counter and partials) is
// allocated once per (device, stream) by the wrapper, zeroed there, and
// left at zero by every call.
//
// K1-bwd keeps its first design: a grid-stride loop over float4s at up to
// eight 256-thread blocks per SM.
//
// Build without --use_fast_math: flush-to-zero would change log p for
// subnormal p (log 1e-40 is about -92, above the -100 clamp), and the plain
// version keeps IEEE logf and division.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use); each entry point returns a CUDA error code (cudaGetLastError()
// after the launch) so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K1-bwd's block
constexpr int kThreads = 256;
// K1's block, and float4 loads of each input one of its threads has in
// flight before it computes
constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kUnroll = 2;
// K1 keeps at least this many blocks resident per SM (at most 64
// registers a thread); the plan takes what the occupancy API reports
constexpr int kMinBlocksPerSm = 4;
// partials one thread of the last block loads before it adds them: one
// round of loads covers 1,024 blocks
constexpr int kFinalLoads = 1024 / kStatsThreads;
// K1-bwd's grid: 132 SMs x 8 resident blocks of 256 threads; the
// grid-stride loop covers the rest
constexpr int kMaxBlocks = 132 * 8;
// the workspace's first 128 bytes hold the ticket counter alone; the
// partials follow
constexpr int kCounterWords = 32;
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

__device__ __forceinline__ void add_float4(Acc& a, float4 p, float4 t) {
  add_element(a, p.x, t.x);
  add_element(a, p.y, t.y);
  add_element(a, p.z, t.z);
  add_element(a, p.w, t.w);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The first half of a block-wide sum of six values (three floats f, three
// counts c of type C): each warp adds its lanes in a fixed tree and lane 0
// stores the warp's six sums. After the caller's one __syncthreads, sum k
// over the block is row k summed in warp order (sum_warps).
template <typename C>
__device__ __forceinline__ void store_warp_sums(const float (&f)[3],
                                                const C (&c)[3],
                                                float (&sf)[3][kStatsWarps],
                                                C (&sc)[3][kStatsWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float fk = warp_sum(f[k]);
    const C ck = warp_sum(c[k]);
    if (lane == 0) {
      sf[k][warp] = fk;
      sc[k][warp] = ck;
    }
  }
}

template <typename T>
__device__ __forceinline__ T sum_warps(const T (&row)[kStatsWarps]) {
  T s = row[0];
#pragma unroll
  for (int w = 1; w < kStatsWarps; ++w) {
    s += row[w];
  }
  return s;
}

// Takes a ticket: an atomic add at device scope with acquire-release
// semantics. Release: the partials this thread wrote just before are
// visible to the block that takes the last ticket. Acquire: that block
// reads every other block's partials after it. (__threadfence() and
// atomicAdd give the same order through a seq_cst fence, which is
// stronger than the pattern needs and was slower on an H100.)
__device__ __forceinline__ unsigned int take_ticket(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Block b streams float4s [b chunk4, min((b + 1) chunk4, n / 4)) of p and
// t (the last block also the n mod 4 tail) and writes its six partials to
// pf[k G + b] (floats, k < 3) and pu[k G + b] (counts), G = gridDim.x,
// with pf and pu in the workspace after the counter ws[0]. The block that
// takes the last ticket adds the partials and writes out[0..5].
__global__ void __launch_bounds__(kStatsThreads, kMinBlocksPerSm)
stats_kernel(const float* __restrict__ p, const float* __restrict__ t,
             int n, int chunk4, unsigned int* __restrict__ ws,
             float* __restrict__ out) {
  __shared__ float sf[3][kStatsWarps];
  __shared__ unsigned int su[3][kStatsWarps];
  __shared__ unsigned long long sl[3][kStatsWarps];
  __shared__ bool last;
  const int g = gridDim.x;
  const int b = blockIdx.x;
  float* pf = reinterpret_cast<float*>(ws + kCounterWords);
  unsigned int* pu = ws + kCounterWords + 3 * g;

  const int n4 = n >> 2;
  const int begin = b * chunk4;
  const int end = min(begin + chunk4, n4);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  Acc a;
  for (int base = begin + threadIdx.x; base < end;
       base += kUnroll * kStatsThreads) {
    float4 pv[kUnroll];
    float4 tv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kStatsThreads < end) {
        pv[u] = __ldcs(p4 + base + u * kStatsThreads);
        tv[u] = __ldcs(t4 + base + u * kStatsThreads);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kStatsThreads < end) {
        add_float4(a, pv[u], tv[u]);
      }
    }
  }
  if (b == g - 1 && (int)threadIdx.x < n - (n4 << 2)) {
    const int i = (n4 << 2) + threadIdx.x;  // at most 3 elements remain
    add_element(a, __ldcs(p + i), __ldcs(t + i));
  }

  {
    const float f[3] = {a.bce, a.inter, a.sum_p};
    const unsigned int c[3] = {a.n_t, a.n_pred, a.n_both};
    store_warp_sums(f, c, sf, su);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      pf[j * g + b] = sum_warps(sf[j]);
      pu[j * g + b] = sum_warps(su[j]);
    }
    last = take_ticket(ws) == (unsigned int)(g - 1);
  }
  __syncthreads();
  if (!last) {
    return;
  }

  // The last block: thread i adds partials i, i + kStatsThreads, ... in
  // turn, each round's loads issued before its adds; read from the L2
  // (__ldcg), where the other SMs' writes are.
  float f[3] = {0.0f, 0.0f, 0.0f};
  unsigned long long c[3] = {0ull, 0ull, 0ull};
  for (int base = threadIdx.x; base < g;
       base += kFinalLoads * kStatsThreads) {
    float lf[3][kFinalLoads];
    unsigned int lc[3][kFinalLoads];
#pragma unroll
    for (int r = 0; r < kFinalLoads; ++r) {
      const int i = base + r * kStatsThreads;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        lf[j][r] = i < g ? __ldcg(pf + j * g + i) : 0.0f;
        lc[j][r] = i < g ? __ldcg(pu + j * g + i) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < kFinalLoads; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        f[j] += lf[j][r];
        c[j] += lc[j][r];
      }
    }
  }
  store_warp_sums(f, c, sf, sl);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long n_t = sum_warps(sl[0]);
    const unsigned long long n_pred = sum_warps(sl[1]);
    const unsigned long long n_both = sum_warps(sl[2]);
    out[0] = sum_warps(sf[0]);
    out[1] = (float)n;
    out[2] = sum_warps(sf[1]);
    out[3] = sum_warps(sf[2]) + (float)n_t;
    out[4] = (float)n_both;
    out[5] = (float)(n_pred + n_t);
    ws[0] = 0u;  // the next call on this stream counts from 0 again
  }
}

// (blocks, chunk in elements) of a call over n elements on a card that
// holds `most` resident blocks: the same plan as
// ops/loss_kernels.loss_stats_plan. A chunk holds at least one float4 per
// thread, so a small input takes few blocks and a short last pass.
void plan_for(int n, int most, int* blocks, int* chunk) {
  const int n4 = n >> 2;
  int chunk4 = (n4 + most - 1) / most;
  if (chunk4 < kStatsThreads) chunk4 = kStatsThreads;  // a float4 each
  int g = (n4 + chunk4 - 1) / chunk4;
  if (g < 1) g = 1;
  *blocks = g;
  *chunk = 4 * chunk4;
}

// The current device's SM count and K1's resident blocks per SM.
cudaError_t card_geometry(int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stats_kernel,
                                                       kStatsThreads, 0);
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

// K1's resident blocks per SM on the current device (0 on an error).
extern "C" int dpt_loss_stats_blocks_per_sm(void) {
  int sms = 0, per_sm = 0;
  if (card_geometry(&sms, &per_sm) != cudaSuccess) return 0;
  return per_sm;
}

// 32-bit words of workspace a call of up to max_blocks blocks needs: the
// counter's 128 bytes and six partials per block.
extern "C" int dpt_loss_stats_workspace_words(int max_blocks) {
  return kCounterWords + 6 * max_blocks;
}

// p, t: n float32 each, 16-byte aligned. (blocks, chunk): the call's plan,
// refused (cudaErrorInvalidValue) unless it is plan_for's on this card.
// ws: ws_words 32-bit words, its counter 0 (zeroed once at allocation;
// every call leaves it 0); one workspace per stream. out: 6 float32.
extern "C" int dpt_loss_stats(void* p, void* t, int n, int blocks, int chunk,
                              void* ws, int ws_words, void* out,
                              void* stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err = card_geometry(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  int want_blocks = 0, want_chunk = 0;
  plan_for(n, sms * per_sm, &want_blocks, &want_chunk);
  if (n < 0 || per_sm < 1 || blocks != want_blocks || chunk != want_chunk ||
      ws_words < dpt_loss_stats_workspace_words(blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  stats_kernel<<<blocks, kStatsThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(p), static_cast<const float*>(t), n,
      chunk / 4, static_cast<unsigned int*>(ws), static_cast<float*>(out));
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
