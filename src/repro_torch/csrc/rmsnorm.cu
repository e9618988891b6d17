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
// Design:
// * The TPU grid walks blocks of rows with the whole feature dim resident
//   in VMEM and pads the last block (masking its rows).  Here a row belongs
//   to one warp when d <= 1024 (8 rows to a block of 256 threads) and to a
//   whole block of 256 threads above that; rows past T are never touched,
//   so there is no padding to mask.
// * x and y are moved in 16-byte vectors (8 bf16 or 4 f32): a scalar head
//   up to the row's first 16-byte boundary, the vector body, a scalar tail,
//   so any d and any row alignment is taken.  scale is read by element; it
//   is the same for every row and stays in L1.
// * Two passes over the row: the sum of squares (warp shuffles, then shared
//   memory across the warps of a block-wide row), then y.  The second read
//   of x hits L1 or L2, so device memory still sees x once.
// * Shortfall, left for a later version: rows are not kept in registers
//   between the passes, and a row of a wide block waits on a barrier.

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;            // threads per block
constexpr int MAX_D = 12288;       // widest row the reference takes

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
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
    Vec<T>::load(xr + head + k * VN, v);
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
    Vec<T>::load(xr + base, v);
#pragma unroll
    for (int j = 0; j < VN; ++j) v[j] = v[j] * inv * to_f32(scale[base + j]);
    Vec<T>::store(yr + base, v);
  }
  for (int i = tail + lane; i < d; i += TPR)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int n_rows, int d,
           float eps, cudaStream_t stream) {
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

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int n_rows, int d, float eps, int x_bf16,
                             int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || d <= 0 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    if (scale_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n_rows, d, eps, s);
    return launch<__nv_bfloat16, float>(x, scale, y, n_rows, d, eps, s);
  }
  if (scale_bf16) return launch<float, __nv_bfloat16>(x, scale, y, n_rows, d, eps, s);
  return launch<float, float>(x, scale, y, n_rows, d, eps, s);
}
