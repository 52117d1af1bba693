// BatchNorm-normalize + ReLU epilogue of milesial's DoubleConv: the forward
// (K2) and its backward (K3).
//
// K2 replaces the Pallas kernel `_bn_act_kernel` of the JAX package
// (distributedpytorch_tpu/ops/kernels.py:324, pallas_call at :422) and K3
// its backward `_bn_act_bwd_kernel` (:333, pallas_call at :457), the two
// halves of `fused_bn_act` (:385). With the affine folded on the host side,
//   a = rsqrt(var + eps) scale,   b = bias - mean a,
// K2 computes y = relu(x a + b) per element, and K3, given the cotangent g
// of y, computes
//   dz = g [z > 0]  (z = x a + b, recomputed),   dx = dz a,
//   s1[c] = sum_rows dz,   s2[c] = sum_rows dz (x - mean),
// from which the wrapper forms dbias, dscale, dmean and dvar in (C,)-sized
// ops. The activation is an NCHW tensor in channels_last memory, i.e.
// physically R = B H W rows of C channels, the `_rows_of` view of the
// Pallas kernels.
//
// x is the conv's output in its own dtype (bf16 under the bf16 policy, or
// f32); widening bf16 to f32 is exact, so reading it directly is the same
// function as the JAX kernel's f32 input, in fewer bytes. y is f32; dx is
// written in x's dtype, rounded to nearest even once, as the JAX wrapper's
// `.astype(x.dtype)` of its f32 dx does. Products and sums are rounded one
// at a time (__fmul_rn, __fadd_rn, __fsub_rn keep nvcc from contracting them
// into fmas), so y, the ReLU mask and dx equal the plain PyTorch versions
// bit for bit; only s1 and s2 are summed in another order.
//
// Bound on an H100: both are streaming passes. At milesial's largest
// epilogue, 4 x 640 x 960 x 64 with a bf16 x, K2 moves 6 bytes per element
// (2 read, 4 written): 943.7 MB, 0.282 ms at 3.35 TB/s. K3 moves 8 (x 2, g 4,
// dx 2): 1.258 GB, 0.376 ms. (The JAX kernel reads an f32 x and writes an
// f32 dx: 8 and 12 bytes per element.) A multiply-add and a compare per
// element are far below the card's f32 rate. The design answers the byte
// bound only:
// * K2: each thread moves four channels of one row per step (an 8- or
//   16-byte load, a 16-byte store); the channel's [a, b] pair comes from
//   shared memory, loaded once per block; a grid-stride loop keeps the grid
//   at up to eight 256-thread blocks per SM.
// * K3: a 2-D block, threadIdx.x over groups of four channels, threadIdx.y
//   over rows; each thread walks a fixed set of rows and keeps its four
//   channels' s1 and s2 in registers, the block adds its rows' sums in a
//   fixed order in shared memory and writes one partial per channel, and a
//   second launch adds the blocks' partials in a fixed order. No float
//   atomics: two calls on the same input give bitwise-equal sums.
// Channel counts that are not a multiple of 4 take a scalar path.
//
// Plain C interface for ctypes (ops/_build.py builds it with nvcc at first
// use); each entry point returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads; the grid-stride loops cover
// the rest
constexpr int kMaxBlocks = 132 * 8;

// -- element access ------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements at p (aligned to four elements)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) =
      __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  *reinterpret_cast<__nv_bfloat162*>(&q.y) =
      __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = q;
}

template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float v[V]) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    v[0] = to_f(p[0]);
  }
}
template <int V>
__device__ __forceinline__ void load_vf(const float* p, float v[V]) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    v[0] = p[0];
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float v[V]) {
  if constexpr (V == 4) {
    store4(p, v);
  } else {
    p[0] = from_f<T>(v[0]);
  }
}

// z = x a + b, rounded after the product and after the sum
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// -- K2 --------------------------------------------------------------------------

// y[r, c] = relu(x[r, c] a[c] + b[c]); ab holds a[0..C) then b[0..C).
// Each thread handles V consecutive elements per step, V = 4 when C is a
// multiple of 4 (then the V elements share one row) and 1 otherwise.
template <typename T, int V>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const float* __restrict__ ab, long long n,
                              int c, float* __restrict__ y) {
  extern __shared__ float s_ab[];  // a then b
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) {
    s_ab[i] = ab[i];
  }
  __syncthreads();
  const long long groups = n / V;
  const long long stride = (long long)blockDim.x * gridDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the channel of element V i, kept up to date without a 64-bit modulo
  // per step
  int ch = (int)((i * V) % c);
  const int ch_step = (int)((stride * V) % c);
  for (; i < groups; i += stride) {
    float v[V];
    load_v<V>(x + i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float z = affine(v[k], s_ab[ch + k], s_ab[c + ch + k]);
      v[k] = z > 0.0f ? z : 0.0f;
    }
    if constexpr (V == 4) {
      store4(y + i * V, v);
    } else {
      y[i] = v[0];
    }
    ch += ch_step;
    if (ch >= c) ch -= c;
  }
}

// -- K3 --------------------------------------------------------------------------

// Pass 1. Block (TX, TY); thread (tx, ty) owns channels
// [V (blockIdx.y TX + tx), +V) and rows blockIdx.x TY + ty + k gridDim.x TY.
// abm holds a, b and mean, C each. Writes dx and partial[blockIdx.x][0..2][C].
template <typename T, int V>
__global__ void bn_act_bwd_partial_kernel(
    const T* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ abm, long long rows, int c,
    T* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ float s_sum[];  // [2][TY][TX V]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int width = blockDim.x * V;
  const int ch0 = (blockIdx.y * blockDim.x + tx) * V;
  const bool active = ch0 < c;
  float a[V], b[V], mean[V], s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = active ? abm[ch0 + k] : 0.0f;
    b[k] = active ? abm[c + ch0 + k] : 0.0f;
    mean[k] = active ? abm[2 * c + ch0 + k] : 0.0f;
    s1[k] = 0.0f;
    s2[k] = 0.0f;
  }
  if (active) {
    const long long step = (long long)gridDim.x * blockDim.y;
    for (long long r = (long long)blockIdx.x * blockDim.y + ty; r < rows;
         r += step) {
      const long long off = r * c + ch0;
      float xv[V], gv[V], dv[V];
      load_v<V>(x + off, xv);
      load_vf<V>(g + off, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float z = affine(xv[k], a[k], b[k]);
        const float dz = z > 0.0f ? gv[k] : 0.0f;
        dv[k] = __fmul_rn(dz, a[k]);
        s1[k] = __fadd_rn(s1[k], dz);
        s2[k] = __fadd_rn(s2[k], __fmul_rn(dz, __fsub_rn(xv[k], mean[k])));
      }
      store_v<V>(dx + off, dv);
    }
  }
  // the block's rows, added over ty in a fixed order
  float* sm1 = s_sum;
  float* sm2 = s_sum + blockDim.y * width;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sm1[ty * width + tx * V + k] = s1[k];
    sm2[ty * width + tx * V + k] = s2[k];
  }
  __syncthreads();
  if (ty == 0 && active) {
    float* out = partial + (long long)blockIdx.x * 2 * c;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int j = 0; j < (int)blockDim.y; ++j) {
        t1 += sm1[j * width + tx * V + k];
        t2 += sm2[j * width + tx * V + k];
      }
      out[ch0 + k] = t1;
      out[c + ch0 + k] = t2;
    }
  }
}

// Pass 2: sums[0..2][C] = the G blocks' partials, added in block order.
__global__ void bn_act_bwd_final_kernel(const float* __restrict__ partial,
                                        int blocks, int c,
                                        float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // over 2 C
  if (i >= 2 * c) return;
  float t = 0.0f;
  for (int k = 0; k < blocks; ++k) {
    t += partial[(long long)k * 2 * c + i];
  }
  sums[i] = t;
}

// The K3 launch geometry for `rows` x `c`.
struct BwdGeom {
  int vec, tx, ty, gy, gx;
};

BwdGeom bwd_geom(long long rows, int c) {
  BwdGeom geo;
  geo.vec = (c % 4 == 0) ? 4 : 1;
  const int groups = c / geo.vec;
  geo.tx = groups < 64 ? groups : 64;
  geo.ty = kThreads / geo.tx;
  geo.gy = (groups + geo.tx - 1) / geo.tx;
  long long gx = (kMaxBlocks + geo.gy - 1) / geo.gy;
  const long long need = (rows + geo.ty - 1) / geo.ty;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  geo.gx = (int)gx;
  return geo;
}

template <typename T>
int launch_fwd(const void* x, const void* ab, long long rows, int c, void* y,
               cudaStream_t s) {
  const long long n = rows * c;
  const int vec = (c % 4 == 0) ? 4 : 1;
  long long blocks = (n / vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const size_t smem = 2 * (size_t)c * sizeof(float);
  if (vec == 4) {
    bn_act_kernel<T, 4><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(ab), n, c,
        static_cast<float*>(y));
  } else {
    bn_act_kernel<T, 1><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(ab), n, c,
        static_cast<float*>(y));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* abm, long long rows,
               int c, void* dx, void* partial, void* sums, cudaStream_t s) {
  const BwdGeom geo = bwd_geom(rows, c);
  const dim3 block(geo.tx, geo.ty);
  const dim3 grid(geo.gx, geo.gy);
  const size_t smem = 2 * (size_t)geo.ty * geo.tx * geo.vec * sizeof(float);
  if (geo.vec == 4) {
    bn_act_bwd_partial_kernel<T, 4><<<grid, block, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(g),
        static_cast<const float*>(abm), rows, c, static_cast<T*>(dx),
        static_cast<float*>(partial));
  } else {
    bn_act_bwd_partial_kernel<T, 1><<<grid, block, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(g),
        static_cast<const float*>(abm), rows, c, static_cast<T*>(dx),
        static_cast<float*>(partial));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  bn_act_bwd_final_kernel<<<(2 * c + kThreads - 1) / kThreads, kThreads, 0,
                            s>>>(static_cast<const float*>(partial), geo.gx,
                                 c, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of K3's first pass for rows x c: its partial buffer holds
// blocks x 2 x c floats.
extern "C" int dpt_bn_act_bwd_blocks(long long rows, int c) {
  return bwd_geom(rows, c).gx;
}

// x: rows x c elements, bf16 (x_bf16 = 1) or f32; ab: 2 c f32; y: rows x c
// f32. x and y 16-byte aligned.
extern "C" int dpt_bn_act(const void* x, int x_bf16, const void* ab,
                          long long rows, int c, void* y, void* stream) {
  if (rows <= 0 || c <= 0) {
    return 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? launch_fwd<__nv_bfloat16>(x, ab, rows, c, y, s)
                : launch_fwd<float>(x, ab, rows, c, y, s);
}

// x, dx: rows x c in x's dtype; g: rows x c f32; abm: 3 c f32 (a, b, mean);
// partial: dpt_bn_act_bwd_blocks(rows, c) x 2 x c f32; sums: 2 c f32 (s1
// then s2). All 16-byte aligned.
extern "C" int dpt_bn_act_bwd(const void* x, int x_bf16, const void* g,
                              const void* abm, long long rows, int c,
                              void* dx, void* partial, void* sums,
                              void* stream) {
  if (rows <= 0 || c <= 0) {
    return 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? launch_bwd<__nv_bfloat16>(x, g, abm, rows, c, dx, partial,
                                            sums, s)
                : launch_bwd<float>(x, g, abm, rows, c, dx, partial, sums, s);
}
