// RMSNorm over the rows of a (T, d) matrix for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py: rmsnorm_kernel
// (body _rms_kernel): y = x * rsqrt(mean(x^2) + eps) * scale, the sum of
// squares and the products in f32, y written in x's dtype.  x and scale
// may each be f32 or bf16 (the reference casts scale to f32 itself).
//
// What bounds it on the H100: bytes.  Every element of x is read once from
// device memory and y written once, with 3 flops an element: at the
// admission shape (2048 x 1024, bf16) 8.4 MB, ~2.5 us at 3.35 TB/s.
//
// Two routes, picked by the wrapper from the shape and the alignment
// (kernels/rmsnorm/kernel.py:rmsnorm_route), never by failure:
// * rms_reg_kernel, one pass with the row in registers, for rows whose
//   first element is 16-byte aligned and whose width d * itemsize is a
//   multiple of 16.  d <= 1024: one warp per row, at most 8 vectors of 16
//   bytes a lane; d up to MAX_D: one block of 256 threads per row, at most
//   12 f32 or 6 bf16 vectors a thread.  A thread issues every load of its
//   part of the row before the reduction (warp shuffles, then shared
//   memory across the warps of a block-wide row), keeps the values, and
//   writes y from them with 16-byte stores: device memory sees x once, and
//   nothing waits on a second read.  The grid is a few blocks an SM
//   (enough to keep every row of the serving shapes in flight at once);
//   warps or blocks walk rows, so each thread converts its slice of scale
//   to f32 once and keeps it in registers.
// * rms_kernel, two passes over the row, for every other row (a view off
//   the 16-byte boundary, d * itemsize not a multiple of 16): x and y are
//   moved in 16-byte vectors where they can be (a scalar head up to the
//   row's first 16-byte boundary, the vector body, a scalar tail), the sum
//   of squares first, then y from a second read of x that hits L1 or L2.
//   A row belongs to one warp when d <= 1024 (8 rows to a block of 256
//   threads) and to a whole block of 256 threads above that.
// The TPU grid walks blocks of rows with the whole feature dim resident in
// VMEM and pads the last block (masking its rows); here rows past T are
// never touched, so there is no padding to mask.

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;            // threads per block
constexpr int MAX_D = 12288;       // widest row the reference takes

// 16 bytes at p (16-byte aligned) that no thread writes during the kernel,
// streamed: not kept in L1, and L2 fetches 256-byte blocks from device
// memory.  In trials on the card this brought the register route to the
// time of a plain copy of the same bytes; plain loads, the L2 hint alone,
// and bulk copies into shared memory were slower.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "l"(p));
  return u;
}

// 16 bytes of x or y as N f32 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned int lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * i]));
      const unsigned int hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  Vec<T>::unpack(*reinterpret_cast<const uint4*>(p), v);
}

// N elements of scale at p as f32: vector loads where p is 16-byte aligned
// (`vec`), else one element at a time
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* p, float* v, bool vec) {
  if (!vec) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f32(p[j]);
  } else if constexpr (sizeof(S) * N == 8) {
    load_f32<4>(p, v);                            // four bf16
  } else {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(S) * N / 16); ++i)
      load_vec(p + i * Vec<S>::N, v + i * Vec<S>::N);
  }
}

// TPR threads own one row: 32 (a warp) or NT (the block)
template <typename T, typename S, int TPR>
__global__ void __launch_bounds__(NT) rms_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
    int n_rows, int d, float eps, int vec_ok) {
  constexpr int VN = Vec<T>::N;
  const int row = blockIdx.x * (NT / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  if (row >= n_rows) return;       // a whole warp or a whole block leaves
  const T* xr = x + (long long)row * d;
  T* yr = y + (long long)row * d;

  // split the row into a scalar head up to the first 16-byte boundary, a
  // vector body and a scalar tail (x and y share their alignment: vec_ok)
  int head = d;
  if (vec_ok) {
    const unsigned int mis = (unsigned int)(reinterpret_cast<unsigned long long>(xr) & 15ull);
    head = min(d, (int)(((16u - mis) & 15u) / sizeof(T)));
  }
  const int n_vec = (d - head) / VN;
  const int tail = head + n_vec * VN;

  float ss = 0.f;
  for (int i = lane; i < head; i += TPR) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  for (int k = lane; k < n_vec; k += TPR) {
    float v[VN];
    load_vec(xr + head + k * VN, v);
#pragma unroll
    for (int j = 0; j < VN; ++j) ss += v[j] * v[j];
  }
  for (int i = tail + lane; i < d; i += TPR) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if constexpr (TPR > 32) {
    __shared__ float part[TPR / 32];
    if ((lane & 31) == 0) part[lane >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += part[w];
  }
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < head; i += TPR)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
  for (int k = lane; k < n_vec; k += TPR) {
    const int base = head + k * VN;
    float v[VN];
    load_vec(xr + base, v);
#pragma unroll
    for (int j = 0; j < VN; ++j) v[j] = v[j] * inv * to_f32(scale[base + j]);
    Vec<T>::store(yr + base, v);
  }
  for (int i = tail + lane; i < d; i += TPR)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

// The register route.  TPR threads own one row (32: a warp, NT: the
// block), each at most VPT vectors of the row: vector k of the row is
// thread (k % TPR)'s, slot k / TPR.  Rows are walked with a stride of the
// grid's rows, so every warp (TPR = 32) or the whole block (TPR = NT)
// leaves the loop together.
template <typename T, typename S, int TPR, int VPT>
__global__ void __launch_bounds__(NT) rms_reg_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
    int n_rows, int d, float eps, int vec_scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int ROWS = NT / TPR;                 // rows a block holds at once
  const int lane = threadIdx.x % TPR;
  const int n_vec = d / VN;
  float sc[VPT][VN];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (lane + k * TPR < n_vec)
      load_scale<S, VN>(scale + (lane + k * TPR) * VN, sc[k], vec_scale != 0);
  __shared__ float part[2][NT / 32];             // block rows: per-warp sums
  int parity = 0;
  for (int row = blockIdx.x * ROWS + threadIdx.x / TPR; row < n_rows;
       row += gridDim.x * ROWS) {
    const T* xr = x + (long long)row * d;
    T* yr = y + (long long)row * d;
    float v[VPT][VN];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (lane + k * TPR < n_vec) {
        Vec<T>::unpack(load_stream(xr + (lane + k * TPR) * VN), v[k]);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) v[k][j] = 0.f;
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
#pragma unroll
      for (int j = 0; j < VN; ++j) ss += v[k][j] * v[k][j];
    ss = warp_sum(ss);
    if constexpr (TPR > 32) {
      if ((lane & 31) == 0) part[parity][lane >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < TPR / 32; ++w) ss += part[parity][w];
      parity ^= 1;                   // the next row's sums go to the other half
    }
    const float inv = rsqrtf(ss / (float)d + eps);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (lane + k * TPR < n_vec) {
#pragma unroll
        for (int j = 0; j < VN; ++j) v[k][j] = v[k][j] * inv * sc[k][j];
        Vec<T>::store(yr + (lane + k * TPR) * VN, v[k]);
      }
    }
  }
}

// the register route's grid: every row in flight where the card holds
// them, at most a few blocks an SM otherwise
template <typename T, typename S, int TPR, int VPT>
int launch_reg(const T* x, const S* scale, T* y, int n_rows, int d, float eps,
               cudaStream_t stream) {
  static const int max_blocks = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * (TPR > 32 ? 2 : 8);
  }();
  const int rows_per_block = NT / TPR;
  const int grid = min(max_blocks, (n_rows + rows_per_block - 1) / rows_per_block);
  const int vec_scale = (reinterpret_cast<unsigned long long>(scale) & 15ull) == 0;
  rms_reg_kernel<T, S, TPR, VPT><<<grid, NT, 0, stream>>>(x, scale, y, n_rows,
                                                          d, eps, vec_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_reg_route(const void* x, const void* scale, void* y, int n_rows,
                     int d, float eps, cudaStream_t stream) {
  constexpr int VN = Vec<T>::N;
  if ((reinterpret_cast<unsigned long long>(x) & 15ull) != 0
      || (reinterpret_cast<unsigned long long>(y) & 15ull) != 0 || d % VN != 0)
    return (int)cudaErrorInvalidValue;           // not the register route's rows
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* yp = static_cast<T*>(y);
  const int n_vec = d / VN;
  if (d <= 1024) {                               // a warp a row
    const int per = (n_vec + 31) / 32;
    if (per <= 1) return launch_reg<T, S, 32, 1>(xp, sp, yp, n_rows, d, eps, stream);
    if (per <= 2) return launch_reg<T, S, 32, 2>(xp, sp, yp, n_rows, d, eps, stream);
    if (per <= 4) return launch_reg<T, S, 32, 4>(xp, sp, yp, n_rows, d, eps, stream);
    return launch_reg<T, S, 32, 8>(xp, sp, yp, n_rows, d, eps, stream);
  }
  const int per = (n_vec + NT - 1) / NT;         // a block a row
  if (per <= 2) return launch_reg<T, S, NT, 2>(xp, sp, yp, n_rows, d, eps, stream);
  if (per <= 4) return launch_reg<T, S, NT, 4>(xp, sp, yp, n_rows, d, eps, stream);
  if (per <= 6) return launch_reg<T, S, NT, 6>(xp, sp, yp, n_rows, d, eps, stream);
  return launch_reg<T, S, NT, 12>(xp, sp, yp, n_rows, d, eps, stream);
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int n_rows, int d,
           float eps, int route, cudaStream_t stream) {
  if (route) return launch_reg_route<T, S>(x, scale, y, n_rows, d, eps, stream);
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x);
  const unsigned long long ya = reinterpret_cast<unsigned long long>(y);
  const int vec_ok = (xa & 15ull) == (ya & 15ull);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* yp = static_cast<T*>(y);
  if (d <= 1024) {
    const int rows_per_block = NT / 32;
    const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
    rms_kernel<T, S, 32><<<grid, NT, 0, stream>>>(xp, sp, yp, n_rows, d, eps, vec_ok);
  } else {
    rms_kernel<T, S, NT><<<n_rows, NT, 0, stream>>>(xp, sp, yp, n_rows, d, eps, vec_ok);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// route: 1 the rows in registers (rms_reg_kernel), 0 two passes (rms_kernel)
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int n_rows, int d, float eps, int x_bf16,
                             int scale_bf16, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || d <= 0 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    if (scale_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n_rows, d, eps, route, s);
    return launch<__nv_bfloat16, float>(x, scale, y, n_rows, d, eps, route, s);
  }
  if (scale_bf16) return launch<float, __nv_bfloat16>(x, scale, y, n_rows, d, eps, route, s);
  return launch<float, float>(x, scale, y, n_rows, d, eps, route, s);
}
