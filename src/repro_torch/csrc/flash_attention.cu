// Prefill flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel (body _fa_kernel): GQA attention with a causal mask,
// an optional sliding window and a q_offset, f32 online softmax, fully
// masked tiles skipped.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (B=8, S=256, H=16, Hkv=8, dh=128, bf16) the call moves ~25 MB (q, k, v
// read once, out written once: ~7.5 us at 3.35 TB/s) and does ~2.2 GFLOP of
// causal QK^T and PV (~2.2 us at the 989 TFLOP/s bf16 tensor-core peak), so
// the bound is bytes.  This first version runs its products as f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), which makes it compute-bound in
// practice; mma/wgmma and TMA staging are later work.
//
// Design:
// * The TPU grid (B, H, nQ, nK) runs its nK axis in order and carries
//   (m, l, acc) in VMEM scratch.  Here one thread block owns one
//   (q-tile, head, batch) cell and loops over the k-tiles itself; (m, l,
//   acc) stay in f32 registers for the whole loop.
// * Inputs stay in the model layout (B, S, H, dh) / (B, S, Hkv, dh): the
//   kernel computes its own offsets, so the wrapper makes no transposes.
//   The kv head of q head h is h / (H / Hkv).
// * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns the score entries
//   (rows ty + 16 i, cols tx + 16 j), i, j < 4, and the output entries (rows
//   ty + 16 i, dims tx + 16 j), j < dh / 16: its rows are the same in both
//   products, so the online-softmax rescale stays in registers.  Row
//   max/sum reduce over the 16 tx lanes with warp shuffles.
// * Q, K, V and P tiles are staged in shared memory as f32; Q and K rows
//   are padded by one word so the column walks hit distinct banks.
// * Ragged Sq and Sk are masked in the kernel (rows >= Sq are never written,
//   cols >= Sk are masked), so unlike the TPU kernel no multiple of the
//   tile is required.  Masked scores take -1e30 as on the TPU, so the
//   result matches the reference's masking arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per k-tile
constexpr int NT = 256;         // threads per block (16 x 16)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reduce over the 16 lanes that share one ty (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DH>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int Hkv, int causal,
    int has_window, int window, int q_offset) {
  constexpr int LD = DH + 1;      // padded row stride of the Q and K tiles
  constexpr int NJ = DH / 16;     // output dims per thread
  constexpr int LP = BK + 1;      // padded row stride of the P tile
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x LD
  float* Ks = Qs + BQ * LD;       // BK x LD
  float* Vs = Ks + BK * LD;       // BK x DH
  float* Ps = Vs + BK * DH;       // BQ x LP

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = qt * BQ;               // first query row of the tile
  const int q_lo = row0 + q_offset;       // its absolute position
  const float sm = sqrtf((float)DH);

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH, row = row0 + r;
    Qs[r * LD + d] = row < Sq
        ? to_f32(q[(((long long)b * Sq + row) * H + h) * DH + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k_lo = kt * BK;
    // tile-level skip, the same test as the TPU kernel (uniform per block)
    if (causal && k_lo > q_lo + BQ - 1) continue;
    if (has_window && k_lo + BK - 1 <= q_lo - window) continue;

    __syncthreads();              // the previous tile's readers are done
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH, col = k_lo + r;
      float kv = 0.f, vv = 0.f;
      if (col < Sk) {
        const long long off = (((long long)b * Sk + col) * Hkv + hk) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * LD + d] = kv;
      Vs[r * DH + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;     // absolute query position
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_lo + tx + 16 * j;
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (has_window) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] / sm : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float scale = expf(m[i] - m_new);
      l[i] = l[i] * scale + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int has_window, int window,
           int q_offset, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, Hkv, causal, has_window, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int Sq,
              int Sk, int H, int Hkv, int dh, int causal, int has_window,
              int window, int q_offset, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int H, int Hkv, int dh, int causal, int has_window, int window, int q_offset,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, dh, causal,
                                    has_window, window, q_offset, s);
  return launch_dh<float>(q, k, v, o, B, Sq, Sk, H, Hkv, dh, causal, has_window,
                          window, q_offset, s);
}
