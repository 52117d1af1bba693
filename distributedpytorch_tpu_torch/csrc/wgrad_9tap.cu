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
// The bf16 kernel: a TMA-fed wgmma pipeline for Hopper (sm_90a).
// * Work is cut into row segments of kSeg = 64 pixels: segment (b, y, x0)
//   covers dY[b, y, x0 .. x0 + 63] and, for kernel row ky, the X pixels
//   X[b, y + ky - 1, x0 - 1 + kx .. x0 + 62 + kx] of the three kx taps.
// * One producer warp issues TMA loads into a ring of kStages = 5
//   shared-memory stages guarded by full/empty mbarriers. Tensor maps view
//   x and dy as 4-D (C, W, H, B) with 128-byte swizzle and 64-channel
//   inner boxes of 64 pixels; one stage holds three X boxes, at x
//   coordinates x0 - 1, x0 and x0 + 1, and two dY boxes (co halves):
//   5 x 8 KiB = 40 KiB. TMA fills coordinates outside the tensor (-1, W,
//   -1, H) with zeros: that fill is the SAME padding, so no load is
//   predicated (the JAX kernel pads X and dY in HBM instead).
// * The kx shift is one 128-byte pixel row inside a 128B-swizzle atom, and
//   a wgmma descriptor cannot start there without its base-offset field.
//   Of the two routes (A from registers by ldmatrix at the shifted row, or
//   three TMA boxes in the SS form) this takes the second: every operand
//   stays a plain swizzled tile at a 1024-byte-aligned base, so the
//   descriptors need no base offset and the consumers no ldmatrix; the
//   price is three X boxes per stage where one window would do, served by
//   the L2 (each X byte leaves HBM once, enters shared memory three times).
// * Two consumer warpgroups run wgmma.mma_async m64n64k16 (bf16 in, f32
//   sums in registers), both operands from shared memory by descriptor
//   with the transpose bit (X is ci-contiguous, dY co-contiguous). A block
//   owns one ky and a 64 x 128 (ci, co) tile, all three kx taps: each
//   consumer owns 64 ci x 64 co x 3 taps, 96 f32 accumulators a thread.
//   The block launches with 168 registers a thread (384 threads, one
//   block per SM); setmaxnreg then gives the consumers 232 and the
//   producer warpgroup 40, the same 64,512 in all.
//   Per stage a consumer issues 4 k16 steps x 3 taps = 12 wgmma, commits
//   and waits for the previous stage's group, which frees that stage.
// * The sum over K = B H W splits across blocks: segments are cut into
//   `splits` contiguous ranges (grid.y), each block writes its own
//   (3, 3, Cin, Cout) partial, and a second launch adds the partials in
//   split order. No float atomics: two calls give bitwise-equal results.
//   The split count comes from the caller (ops/wgrad_kernels.wgrad_plan):
//   whole waves of one block per SM (a block holds 200 KiB of shared
//   memory), partials capped at 64 MiB. Blocks of one split are launched
//   next to each other (grid.x is the tile), so they read one pixel range
//   together and the L2 serves its repeats: HBM reads stay near one pass
//   over x and dy.
// * Bound on an H100: 2 B H W Cin Cout 9 operations. At 128 -> 128 on
//   4 x 320 x 480: 181 GFLOP, 0.183 ms at 989 TFLOP/s, against 0.094 ms
//   for the bytes (314.6 MB of x and dy read once, 0.6 MB written; the
//   22 partials add 13 MB written and read). Shared-memory fill: 40 KiB
//   per 3.1 MFLOP of a block, 0.013 B/FLOP, ~13 TB/s from the L2 at the
//   tensor-core peak: the L2 and the m64n64 wgmma width, not HBM, are
//   what this design leaves between it and the bound.
// What changed from the first, wmma version: warp-level mma.sync through
// wmma on a 64 x 64 tile, synchronous uint4 loads through registers with
// two __syncthreads per 32-pixel segment, predicated padding, 64-bit
// divides in every thread and 164 registers; now TMA, wgmma, a 5-stage
// ring, divides in the producer thread only.
//
// f32 inputs take a CUDA-core kernel (16 x 16 tiles, 32-pixel segments,
// one output element and its three kx taps per thread), exact f32
// products and sums.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use); the entry point returns 0, a cudaError_t, or the negated CUresult
// of a failed tensor-map encode, so the Python wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// -- the bf16 wgmma kernel ---------------------------------------------------------

constexpr int kSeg = 64;    // pixels of one row segment: K of one stage
constexpr int kTileCi = 64;   // ci rows of a block: one wgmma M
constexpr int kTileCo = 128;  // co columns of a block: 64 per consumer
constexpr int kStages = 5;
constexpr int kBox = 64;     // channels of one TMA box: 128 bytes of bf16
constexpr int kBoxBytes = kSeg * kBox * 2;       // 8 KiB
constexpr int kStageBytes = 5 * kBoxBytes;       // 3 X taps + 2 dY halves
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kK16 = kSeg / 16;   // wgmma k steps per stage

// -- the f32 kernel ----------------------------------------------------------------

constexpr int kTK = 32;    // pixels of one row segment
constexpr int kWin = kTK + 2;  // the X window: one more pixel each side
constexpr int kTileF = 16;  // (ci, co) tile of the f32 kernel

struct Geom {
  int b, h, w, cin, cout;
  int segs_w;        // segments per image row
  long long n_segs;  // b h segs_w
};

__device__ __forceinline__ void segment_of(const Geom& g, long long seg,
                                           int seg_px, int& bi, int& y,
                                           int& x0) {
  const long long per_image = (long long)g.h * g.segs_w;
  bi = (int)(seg / per_image);
  const int rem = (int)(seg - (long long)bi * per_image);
  y = rem / g.segs_w;
  x0 = (rem - y * g.segs_w) * seg_px;
}

__device__ __forceinline__ long long split_begin(long long n, int split,
                                                 int splits) {
  return n * split / splits;
}

// -- PTX helpers -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// one box of a 4-D tensor map at coordinates (c, x, y, b); coordinates
// outside the tensor read as zero
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int x, int y,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

// Shared-memory descriptor of a 128B-swizzled MN-major tile: 64 elements
// of M (or N) contiguous in one 128-byte row per pixel, pixel rows 128
// bytes apart, so a group of 8 K rows spans 1024 bytes (the stride byte
// offset); M and N are one 64-wide atom here, so the leading byte offset
// is never stepped. Bases are 1024-byte aligned: base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(kBoxBytes >> 4) << 16;  // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;       // stride byte offset
  d |= (uint64_t)1 << 62;                 // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    asm volatile("" : "+f"(d[i])::"memory");
  }
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B MN-major (transpose bits 1)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));  // scale-d 1: d += a b
}

// grid.x: 3 * ci_tiles * co_tiles (ky major, co minor), grid.y: splits.
// out: splits x (3, 3, Cin, Cout) f32 (the output itself when splits == 1).
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap dy_map, Geom g,
                      float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int ci_tiles = (g.cin + kTileCi - 1) / kTileCi;
  const int co_tiles = (g.cout + kTileCo - 1) / kTileCo;
  int t = blockIdx.x;
  const int co_t = t % co_tiles;
  t /= co_tiles;
  const int ci_t = t % ci_tiles;
  const int ky = t / ci_tiles;
  const int split = blockIdx.y;
  const long long s_begin = split_begin(g.n_segs, split, gridDim.y);
  const long long s_end = split_begin(g.n_segs, split + 1, gridDim.y);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // -- producer: one thread keeps the ring full ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      const int ci0 = ci_t * kTileCi;
      const int co0 = co_t * kTileCo;
      int stage = 0;
      uint32_t phase = 0;
      for (long long seg = s_begin; seg < s_end; ++seg) {
        int bi, y, x0;
        segment_of(g, seg, kSeg, bi, y, x0);
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);
        const uint32_t bar = smem_u32(&full[stage]);
        mbar_expect_tx(bar, kStageBytes);
        const uint32_t dst = base + stage * kStageBytes;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          tma_load(dst + kx * kBoxBytes, &x_map, bar, ci0, x0 + kx - 1,
                   y + ky - 1, bi);
        }
#pragma unroll
        for (int half = 0; half < kConsumers; ++half) {
          tma_load(dst + (3 + half) * kBoxBytes, &dy_map, bar,
                   co0 + half * kBox, x0, y, bi);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns co columns wg * 64 .. wg * 64 + 63 -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    float acc[3][32];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[kx][i] = 0.0f;
      }
    }
    const bool leader = threadIdx.x % 128 == 0;
    int stage = 0;
    int prev = -1;
    uint32_t phase = 0;
    for (long long seg = s_begin; seg < s_end; ++seg) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t src = base + stage * kStageBytes;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        fence_acc(acc[kx]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kK16; ++k) {
        // 16 pixel rows of 128 bytes per k step
        const uint64_t db =
            smem_desc(src + (3 + wg) * kBoxBytes + k * 16 * 128);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          wgmma_m64n64k16(acc[kx],
                          smem_desc(src + kx * kBoxBytes + k * 16 * 128), db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        fence_acc(acc[kx]);
      }
      if (prev >= 0 && leader) {
        mbar_arrive(smem_u32(&empty[prev]));
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      fence_acc(acc[kx]);
    }

    // accumulator layout of m64nNk16: warp w holds rows 16 w .. 16 w + 15;
    // register j of lane l sits at row l / 4 + 8 ((j / 2) % 2) of the warp
    // and column 8 (j / 4) + 2 (l % 4) + j % 2
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int ci_base = ci_t * kTileCi + warp * 16 + lane / 4;
    const int co_base = co_t * kTileCo + wg * 64 + 2 * (lane % 4);
    const long long plane = (long long)g.cin * g.cout;
    float* dst = out + (long long)split * 9 * plane;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      float* tap = dst + (ky * 3 + kx) * plane;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int ci = ci_base + 8 * ((j / 2) % 2);
        const int co = co_base + 8 * (j / 4);
        if (ci < g.cin && co < g.cout) {
          *reinterpret_cast<float2*>(tap + (long long)ci * g.cout + co) =
              make_float2(acc[kx][j], acc[kx][j + 1]);
        }
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
    segment_of(g, seg, kTK, bi, y, x0);
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

Geom make_geom(int b, int h, int w, int cin, int cout, int seg_px) {
  Geom g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.segs_w = (w + seg_px - 1) / seg_px;
  g.n_segs = (long long)b * h * g.segs_w;
  return g;
}

// -- tensor maps -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: fetched through the
// runtime, so the library links against nothing but cudart
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (C, W, H, B) view of a contiguous NHWC bf16 tensor; boxes of 64 channels
// x kSeg pixels of one row, 128-byte swizzled, zero outside the tensor
CUresult make_map(CUtensorMap* map, const void* ptr, int b, int h, int w,
                  int c) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    return CUDA_ERROR_NOT_FOUND;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t row = (cuuint64_t)c * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {kBox, kSeg, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// x: (B, H, W, Cin), dy: (B, H, W, Cout), both bf16 (is_bf16 = 1) or both
// f32, contiguous, 16-byte aligned; with bf16, Cin and Cout multiples of 16.
// seg, tile_ci, tile_co: the launch plan's geometry, which must be this
// file's for the dtype (ops/wgrad_kernels.wgrad_plan); splits in
// [1, segments]. partial: splits x 9 x Cin x Cout f32 (unused when
// splits == 1); out: 9 x Cin x Cout f32.
extern "C" int dpt_wgrad_9tap(const void* x, const void* dy, int is_bf16,
                              int b, int h, int w, int cin, int cout, int seg,
                              int tile_ci, int tile_co, int splits,
                              void* partial, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = 9LL * cin * cout;
  if (n <= 0) {
    return 0;
  }
  const int want_seg = is_bf16 ? kSeg : kTK;
  const int want_ci = is_bf16 ? kTileCi : kTileF;
  const int want_co = is_bf16 ? kTileCo : kTileF;
  if (seg != want_seg || tile_ci != want_ci || tile_co != want_co) {
    return (int)cudaErrorInvalidValue;
  }
  const Geom g = make_geom(b, h, w, cin, cout, seg);
  if (g.n_segs <= 0) {
    // no pixels: the gradient is zero
    return (int)cudaMemsetAsync(out, 0, n * sizeof(float), s);
  }
  if (splits < 1 || splits > g.n_segs) {
    return (int)cudaErrorInvalidValue;
  }
  float* dst = splits > 1 ? static_cast<float*>(partial)
                          : static_cast<float*>(out);
  const long long tiles = 3LL * ((cin + tile_ci - 1) / tile_ci) *
                          ((cout + tile_co - 1) / tile_co);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  if (is_bf16) {
    CUtensorMap x_map, dy_map;
    CUresult r = make_map(&x_map, x, b, h, w, cin);
    if (r == CUDA_SUCCESS) {
      r = make_map(&dy_map, dy, b, h, w, cout);
    }
    if (r != CUDA_SUCCESS) {
      return -(int)r;
    }
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) {
      return (int)err;
    }
    wgrad_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(x_map, dy_map, g,
                                                         dst);
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
