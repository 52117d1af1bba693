// Weight gradient of a SAME, stride-1 3x3 convolution as nine tap
// contractions (K5).
//
// Replaces the Pallas kernel `_wgrad_kernel` of the JAX package
// (distributedpytorch_tpu/ops/wgrad_pallas.py:72, pallas_call at :133,
// wrapper `wgrad_9tap_pallas` :94), which `ops/conv_backward.py` engages
// for convs with min(Cin, Cout) >= 128 under DPT_WGRAD_BACKEND=pallas. With
// x (B, H, W, Cin) and dy (B, H, W, Cout) both NHWC in memory it computes
//   dW[ky, kx, ci, co] = sum_{b, y, x} Xpad[b, y + ky, x + kx, ci] dY[b, y, x, co]
// (Xpad = x with one zero pixel around each image) in f32, shape
// (3, 3, Cin, Cout).
//
// The Pallas kernel runs one (batch, row) per sequential grid step and
// keeps the whole (3, 3, Cin, Cout) sum in VMEM across the grid. Here:
// * Work is cut into row segments of kTK = 32 pixels: segment (b, y, x0)
//   covers dY[b, y, x0 .. x0 + 31] and, for the three taps of one kernel
//   row ky, the 34-pixel window X[b, y + ky - 1, x0 - 1 .. x0 + 32]. Both
//   are loaded once into shared memory (zero outside the image and past
//   the row's end) and the three kx taps read the window at offsets 0, 1
//   and 2: the Pallas kernel's shifted operands, without copies.
// * A block owns one ky, a 64 x 64 (ci, co) tile and a contiguous range of
//   segments; its four warps each own 16 ci rows and all 64 co columns of
//   the three kx taps, twelve 16 x 16 f32 accumulators in registers, fed by
//   bf16 tensor-core products (nvcuda::wmma, 16 x 16 x 16).
// * The sum over K = B H W runs across blocks: the segments are split into
//   `splits` contiguous ranges, each writes its own (3, 3, Cin, Cout)
//   partial, and a second launch adds the partials in split order. No float
//   atomics: two calls on the same input give bitwise-equal results. The
//   split count is sized by Cin Cout (`dpt_wgrad_9tap_splits`): enough
//   blocks to fill the card, but never more partial memory than 64 MiB, so
//   the 1024 -> 1024 convs, which already have 768 tile blocks, take one
//   split and write the output directly.
// f32 inputs take a CUDA-core kernel with the same decomposition (16 x 16
// tiles, one output element and its three kx taps per thread), exact f32
// products and sums.
//
// Bound on an H100: 2 B H W Cin Cout 9 operations. At milesial's engaged
// shapes that is 181 GFLOP at both 128 -> 128 on 4 x 320 x 480 and
// 1024 -> 1024 on 4 x 40 x 60, 0.183 ms at 989 TFLOP/s (bf16 tensor cores),
// against 0.094 ms and 0.023 ms for their bytes: bound by operations. This
// first version loads each segment synchronously and issues warp-level
// mma.sync through wmma, not Hopper's wgmma; it is built to be right, and
// PERF.md holds its time beside cuDNN's.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use); each entry point returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kTK = 32;    // pixels of one row segment
constexpr int kWin = kTK + 2;  // the X window: one more pixel each side
constexpr int kTile = 64;  // (ci, co) tile of the tensor-core kernel
// shared-memory row of one pixel, in elements: 160 bytes keeps every
// wmma pointer on the 32-byte alignment it needs
constexpr int kLd = 80;
constexpr int kWarps = 4;
constexpr int kTileF = 16;  // (ci, co) tile of the f32 kernel
// blocks to aim for: four per SM
constexpr long long kTargetBlocks = 132LL * 4;
constexpr long long kMaxPartialBytes = 64LL << 20;

struct Geom {
  int b, h, w, cin, cout;
  int segs_w;        // segments per image row
  long long n_segs;  // b h segs_w
};

__device__ __forceinline__ void segment_of(const Geom& g, long long seg,
                                           int& bi, int& y, int& x0) {
  const long long per_image = (long long)g.h * g.segs_w;
  bi = (int)(seg / per_image);
  const int rem = (int)(seg - (long long)bi * per_image);
  y = rem / g.segs_w;
  x0 = (rem - y * g.segs_w) * kTK;
}

__device__ __forceinline__ long long split_begin(long long n, int split,
                                                 int splits) {
  return n * split / splits;
}

// -- the bf16 tensor-core kernel ---------------------------------------------------

// grid.x: 3 * ci_tiles * co_tiles (ky major, co minor), grid.y: splits.
// out: splits x (3, 3, Cin, Cout) f32 (the output itself when splits == 1).
__global__ void __launch_bounds__(kWarps * 32)
    wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      Geom g, float* __restrict__ out) {
  __shared__ __align__(128) bf16 xs[kWin * kLd];  // X window: pixel p, ci
  __shared__ __align__(128) bf16 ds[kTK * kLd];   // dY segment: pixel, co
  const int ci_tiles = (g.cin + kTile - 1) / kTile;
  const int co_tiles = (g.cout + kTile - 1) / kTile;
  int t = blockIdx.x;
  const int co_t = t % co_tiles;
  t /= co_tiles;
  const int ci_t = t % ci_tiles;
  const int ky = t / ci_tiles;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int ci_base = ci_t * kTile;
  const int co_base = co_t * kTile;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fill_fragment(acc[kx][n], 0.0f);
    }
  }

  const long long s_end = split_begin(g.n_segs, split + 1, splits);
  for (long long seg = split_begin(g.n_segs, split, splits); seg < s_end;
       ++seg) {
    int bi, y, x0;
    segment_of(g, seg, bi, y, x0);
    const int yy = y + ky - 1;  // the X row of this kernel row
    const bool row_in = yy >= 0 && yy < g.h;
    // 16-byte chunks: 8 per pixel (64 channels)
    for (int i = threadIdx.x; i < kWin * 8; i += kWarps * 32) {
      const int p = i >> 3;
      const int q = (i & 7) * 8;
      const int col = x0 - 1 + p;
      const int ci = ci_base + q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row_in && col >= 0 && col < g.w && ci < g.cin) {
        v = *reinterpret_cast<const uint4*>(
            x + (((long long)bi * g.h + yy) * g.w + col) * g.cin + ci);
      }
      *reinterpret_cast<uint4*>(xs + p * kLd + q) = v;
    }
    for (int i = threadIdx.x; i < kTK * 8; i += kWarps * 32) {
      const int p = i >> 3;
      const int q = (i & 7) * 8;
      const int col = x0 + p;
      const int co = co_base + q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < g.w && co < g.cout) {
        v = *reinterpret_cast<const uint4*>(
            dy + (((long long)bi * g.h + y) * g.w + col) * g.cout + co);
      }
      *reinterpret_cast<uint4*>(ds + p * kLd + q) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kTK; k0 += 16) {
      // B(k, n) = dY[pixel k0 + k][co n]: row-major, ld kLd
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::load_matrix_sync(bf[n], ds + k0 * kLd + n * 16, kLd);
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A(m, k) = X window[pixel k0 + k + kx][ci m]: column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::load_matrix_sync(af, xs + (k0 + kx) * kLd + warp * 16, kLd);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::mma_sync(acc[kx][n], af, bf[n], acc[kx][n]);
        }
      }
    }
    __syncthreads();
  }

  const int ci0 = ci_base + warp * 16;
  if (ci0 >= g.cin) return;
  const long long plane = (long long)g.cin * g.cout;
  float* base = out + (long long)split * 9 * plane;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int co0 = co_base + n * 16;
      if (co0 < g.cout) {
        wmma::store_matrix_sync(
            base + (ky * 3 + kx) * plane + (long long)ci0 * g.cout + co0,
            acc[kx][n], g.cout, wmma::mem_row_major);
      }
    }
  }
}

// -- the f32 kernel ----------------------------------------------------------------

// grid.x: 3 * ci_tiles * co_tiles with 16-wide tiles, grid.y: splits.
// Block (16, 16): thread (tx, ty) owns dW[ky, 0..2, ci_base + ty, co_base + tx].
__global__ void wgrad_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ dy, Geom g,
                                 float* __restrict__ out) {
  __shared__ float xs[kWin][kTileF + 1];
  __shared__ float ds[kTK][kTileF + 1];
  const int ci_tiles = (g.cin + kTileF - 1) / kTileF;
  const int co_tiles = (g.cout + kTileF - 1) / kTileF;
  int t = blockIdx.x;
  const int co_t = t % co_tiles;
  t /= co_tiles;
  const int ci_t = t % ci_tiles;
  const int ky = t / ci_tiles;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileF + tx;
  const int ci_base = ci_t * kTileF;
  const int co_base = co_t * kTileF;
  float acc[3] = {0.0f, 0.0f, 0.0f};

  const long long s_end = split_begin(g.n_segs, split + 1, splits);
  for (long long seg = split_begin(g.n_segs, split, splits); seg < s_end;
       ++seg) {
    int bi, y, x0;
    segment_of(g, seg, bi, y, x0);
    const int yy = y + ky - 1;
    const bool row_in = yy >= 0 && yy < g.h;
    for (int i = tid; i < kWin * kTileF; i += kTileF * kTileF) {
      const int p = i / kTileF;
      const int q = i % kTileF;
      const int col = x0 - 1 + p;
      const int ci = ci_base + q;
      float v = 0.0f;
      if (row_in && col >= 0 && col < g.w && ci < g.cin) {
        v = x[(((long long)bi * g.h + yy) * g.w + col) * g.cin + ci];
      }
      xs[p][q] = v;
    }
    for (int i = tid; i < kTK * kTileF; i += kTileF * kTileF) {
      const int p = i / kTileF;
      const int q = i % kTileF;
      const int col = x0 + p;
      const int co = co_base + q;
      float v = 0.0f;
      if (col < g.w && co < g.cout) {
        v = dy[(((long long)bi * g.h + y) * g.w + col) * g.cout + co];
      }
      ds[p][q] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kTK; ++j) {
      const float d = ds[j][tx];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        acc[kx] = fmaf(xs[j + kx][ty], d, acc[kx]);
      }
    }
    __syncthreads();
  }

  const int ci = ci_base + ty;
  const int co = co_base + tx;
  if (ci >= g.cin || co >= g.cout) return;
  const long long plane = (long long)g.cin * g.cout;
  float* base = out + (long long)split * 9 * plane;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    base[(ky * 3 + kx) * plane + (long long)ci * g.cout + co] = acc[kx];
  }
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  int splits, long long n,
                                  float* __restrict__ out) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float t = 0.0f;
    for (int s = 0; s < splits; ++s) {
      t += partial[(long long)s * n + i];
    }
    out[i] = t;
  }
}

Geom make_geom(int b, int h, int w, int cin, int cout) {
  Geom g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.segs_w = (w + kTK - 1) / kTK;
  g.n_segs = (long long)b * h * g.segs_w;
  return g;
}

long long tile_blocks(int cin, int cout, int is_bf16) {
  const int tile = is_bf16 ? kTile : kTileF;
  return 3LL * ((cin + tile - 1) / tile) * ((cout + tile - 1) / tile);
}

}  // namespace

// How many ranges the sum over B H W is split into for this shape: enough
// blocks to fill the card, at most one per segment, and at most 64 MiB of
// (3, 3, Cin, Cout) f32 partials. 1 means the kernel writes the output
// directly and needs no partial buffer.
extern "C" int dpt_wgrad_9tap_splits(int b, int h, int w, int cin, int cout,
                                     int is_bf16) {
  const Geom g = make_geom(b, h, w, cin, cout);
  const long long tiles = tile_blocks(cin, cout, is_bf16);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  if (splits > g.n_segs) splits = g.n_segs;
  const long long by_memory =
      kMaxPartialBytes / (9LL * cin * cout * (long long)sizeof(float));
  if (splits > by_memory) splits = by_memory;
  if (splits < 1) splits = 1;
  return (int)splits;
}

// x: (B, H, W, Cin), dy: (B, H, W, Cout), both bf16 (is_bf16 = 1) or both
// f32, contiguous, 16-byte aligned; with bf16, Cin and Cout multiples of 16.
// partial: splits x 9 x Cin x Cout f32 (unused when splits == 1); out:
// 9 x Cin x Cout f32.
extern "C" int dpt_wgrad_9tap(const void* x, const void* dy, int is_bf16,
                              int b, int h, int w, int cin, int cout,
                              int splits, void* partial, void* out,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = 9LL * cin * cout;
  if (n <= 0) {
    return 0;
  }
  const Geom g = make_geom(b, h, w, cin, cout);
  if (g.n_segs <= 0) {
    // no pixels: the gradient is zero
    return (int)cudaMemsetAsync(out, 0, n * sizeof(float), s);
  }
  float* dst = splits > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(out);
  const dim3 grid((unsigned)tile_blocks(cin, cout, is_bf16), (unsigned)splits);
  if (is_bf16) {
    wgrad_bf16_kernel<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), g, dst);
  } else {
    wgrad_f32_kernel<<<grid, dim3(kTileF, kTileF), 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), g, dst);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) {
    return (int)err;
  }
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(partial), splits, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
