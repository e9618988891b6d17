// Tiled matrix product (M, K) @ (K, N) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/matmul/kernel.py: matmul_kernel
// (body _mm_kernel): the output tiled over (M, N), the contraction walked
// in slabs, f32 accumulation, one cast to the output dtype at the end.
// Inputs are both f32 or both bf16; the output is f32 or bf16.
//
// What bounds it on the H100: operations at the serving shapes.  The
// admission's (2048, 1024) @ (1024, 3072) is 12.9 GFLOP against 23.1 MB of
// bf16 operands and output: 13.0 us at the 989 TFLOP/s bf16 tensor-core
// peak, 6.9 us of bytes.  A decode-shaped (8, 1024) @ (1024, 3072) is bound
// by the 6.3 MB of b instead (1.9 us).
//
// Two routes, picked by kernels/matmul/kernel.py:matmul_route from the
// dtypes, shapes, strides and alignment alone (never by failure):
//
// * wgmma (bf16 a and b, K and N multiples of 8, 16-byte aligned bases):
//   mm_wgmma_kernel.  A block of 3 warpgroups owns a 128 x 128 output tile
//   and walks K in slabs of 64.  Warpgroup 0 is the producer: one thread
//   keeps a ring of 4 slabs in flight with TMA (a: one 64 x 128-row box;
//   b: two 64-column by 64-row boxes, read as the caller holds it, (K, N)
//   row-major), each slab completing on its own mbarrier.  Warpgroups 1
//   and 2 are the consumers, 64 output rows each: per slab, 4 wgmma
//   m64n128k16 (a K-major, b MN-major through the transpose-B immediate),
//   the f32 sum in registers; a slab is handed back to the producer (its
//   "empty" mbarrier) once the next slab's wgmmas are issued and its own
//   have retired, so the tensor cores never wait on the hand-back.  The
//   epilogue converts once to the output dtype and stores straight from the
//   fragments, masked at the ragged M and N edges; TMA's zero fill covers
//   ragged M, N and K on the load side.  The grid is one block per tile:
//   (2048, 1024) @ (1024, 3072) gets 16 x 24 = 384 tiles on 132 SMs (one
//   block of 128 KB of slabs a SM), (2048, 3072) @ (3072, 1024) 128 tiles,
//   and the decode-shaped 8 rows one row of 24 tiles (TMA fills the
//   missing rows with zeros; 120 of the 128 rows are wasted, and with only
//   24 blocks the 6.3 MB of b stream through 24 SMs).
// * CUDA cores (f32, or a shape TMA cannot describe, e.g. a 600-byte row
//   of a (100, 300) @ (300, 72)): mm_simt_kernel, the first version.  One
//   block of 256 threads owns a 64 x 64 output tile, stages slabs of 32 as
//   f32 in shared memory and runs 16 f32 FMAs per k a thread.  f32 inputs
//   stay exact to 1e-5 (no TF32).

#include "attn_common.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int NT = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;             // keeps float4 rows aligned

template <typename T, typename O>
__global__ void __launch_bounds__(NT) mm_simt_kernel(
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
int launch_simt(const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_simt_kernel<T, O><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(c), M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 384;                      // producer + 2 consumers
constexpr int A_SLAB = TC_BM * TC_BK * 2;            // 16 KB
constexpr int B_HALF = TC_BK * 64 * 2;               // 8 KB: 64 columns of b
constexpr int B_SLAB = 2 * B_HALF;
constexpr int STAGE_BYTES = A_SLAB + B_SLAB;
// slabs, their barriers, and slack to align the slabs to 1024 bytes
constexpr size_t TC_SMEM = (size_t)TC_STAGES * STAGE_BYTES
                           + 2 * TC_STAGES * sizeof(uint64_t) + 1024;

template <typename O>
__device__ __forceinline__ void store_pair(O* p, float x, float y);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                          float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename O>
__global__ void __launch_bounds__(TC_THREADS, 1) mm_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, O* __restrict__ c, int M, int N,
    int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* slabs = smem_raw + pad;
  unsigned char* a_s = slabs;                                  // [stage][A_SLAB]
  unsigned char* b_s = slabs + TC_STAGES * A_SLAB;             // [stage][B_SLAB]
  uint64_t* full = reinterpret_cast<uint64_t*>(slabs + TC_STAGES * STAGE_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);          // one arrival per consumer
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {                              // producer
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % TC_STAGES;
        sm90::mbar_wait(&empty[s], ((kt / TC_STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* bs = b_s + s * B_SLAB;
        sm90::tma_load_2d(a_s + s * A_SLAB, &map_a, &full[s], kt * TC_BK, m0);
        sm90::tma_load_2d(bs, &map_b, &full[s], n0, kt * TC_BK);
        sm90::tma_load_2d(bs + B_HALF, &map_b, &full[s], n0 + 64, kt * TC_BK);
      }
    }
    return;
  }

  const int cw = wg - 1;                      // consumer: rows 64 cw .. + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % TC_STAGES;
    sm90::mbar_wait(&full[s], (kt / TC_STAGES) & 1);
    const unsigned char* as = a_s + s * A_SLAB + cw * 64 * 128;
    const unsigned char* bs = b_s + s * B_SLAB;
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      sm90::wgmma_m64n128k16<1>(acc, sm90::desc_sw128(as + kk * 32, 16, 1024),
                                sm90::desc_sw128(bs + kk * 16 * 128, B_HALF, 1024));
    sm90::wgmma_commit();
    sm90::fence_acc(acc);
    sm90::wgmma_wait<1>();                    // slab kt - 1 is read
    sm90::fence_acc(acc);
    if (kt > 0 && t == 0) sm90::mbar_arrive(&empty[(kt - 1) % TC_STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);

  const int row = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gn = col + 8 * j;
    if (gn >= N) continue;                    // N is even: gn + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm < M)
        store_pair<O>(c + (long long)gm * N + gn, acc[4 * j + 2 * h],
                      acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename O>
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                 cudaStream_t stream) {
  // what TMA needs: 16-byte aligned bases and rows
  if (K % 8 != 0 || N % 8 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || (M + TC_BM - 1) / TC_BM > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int err = sm90::make_map_bf16(&map_a, a, M, K, (uint64_t)K * 2, TC_BM, TC_BK);
  if (err) return err;
  err = sm90::make_map_bf16(&map_b, b, K, N, (uint64_t)N * 2, TC_BK, 64);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      mm_wgmma_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  mm_wgmma_kernel<O><<<grid, TC_THREADS, TC_SMEM, stream>>>(
      map_a, map_b, static_cast<O*>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// route 1: wgmma (bf16 inputs only); route 0: CUDA cores
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int in_bf16, int out_bf16, int route,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (!in_bf16) return (int)cudaErrorInvalidValue;
    if (out_bf16) return launch_wgmma<__nv_bfloat16>(a, b, c, M, N, K, s);
    return launch_wgmma<float>(a, b, c, M, N, K, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (in_bf16) {
    if (out_bf16) return launch_simt<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, s);
    return launch_simt<__nv_bfloat16, float>(a, b, c, M, N, K, s);
  }
  if (out_bf16) return launch_simt<float, __nv_bfloat16>(a, b, c, M, N, K, s);
  return launch_simt<float, float>(a, b, c, M, N, K, s);
}
