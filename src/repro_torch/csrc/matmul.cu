// Tiled matrix product (M, K) @ (K, N) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/matmul/kernel.py: matmul_kernel
// (body _mm_kernel): the output tiled over (M, N), the contraction walked
// in slabs, f32 accumulation, one cast to the output dtype at the end.
// Inputs are both f32 or both bf16; the output is f32 or bf16.
//
// What bounds it on the H100: operations at the serving shapes.  The
// admission's (2048, 1024) @ (1024, 3072) is 12.9 GFLOP against 23.1 MB of
// bf16 operands and output: 13 us at the 989 TFLOP/s bf16 tensor-core peak,
// 6.9 us of bytes.  A decode-shaped (8, 1024) @ (1024, 3072) is bound by the
// 6.3 MB of b instead.
//
// Design (the simple first version; the tensor cores come later):
// * The TPU grid (nM, nN, nK) carries the f32 accumulator tile in VMEM
//   across its sequential K axis.  Here one block of 256 threads owns a
//   64 x 64 output tile and loops over K itself in slabs of 32, with the
//   accumulator in registers: 4 x 4 outputs a thread.
// * Each slab of a (64 x 32) and b (32 x 64) is staged in shared memory as
//   f32 (a transposed, so a thread reads its 4 rows as one float4), and
//   every thread does its 16 f32 FMAs per k on the CUDA cores.
// * Ragged M, N and K are masked: out-of-range operands load as zero and
//   out-of-range outputs are not stored, where the reference pads.
// * Shortfall: f32 FMAs on the CUDA cores (67 TFLOP/s peak, not the 989 of
//   bf16 wgmma), no cp.async or TMA double buffering, and the transposed
//   store of a into shared memory conflicts on banks.  It is the yardstick
//   for the redesign (wgmma, TMA, a pipelined ring of slabs).

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int NT = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;             // keeps float4 rows aligned

template <typename T, typename O>
__global__ void __launch_bounds__(NT) mm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ c,
    int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // a slab, transposed
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of a row of a, and
    // consecutive n of a row of b: both loads coalesce
#pragma unroll
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? to_f32(a[(long long)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gn = n0 + cc;
      Bs[kk][cc] = (gk < K && gn < N) ? to_f32(b[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) c[(long long)gm * N + gn] = from_f32<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<T, O><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int in_bf16, int out_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (in_bf16) {
    if (out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, s);
    return launch<__nv_bfloat16, float>(a, b, c, M, N, K, s);
  }
  if (out_bf16) return launch<float, __nv_bfloat16>(a, b, c, M, N, K, s);
  return launch<float, float>(a, b, c, M, N, K, s);
}
