// Dense ring-buffer decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// decode_attention_kernel (body _dec_kernel): one new query token per slot
// against its KV cache of C slots, all `group` q-heads of one kv head
// computed together, validity from the stored absolute positions: a slot is
// attended iff 0 <= pos <= cur (and pos > cur - window with a window), so
// pos = -1 marks an empty slot and the ring needs no data movement.
//
// What bounds it on the H100: bytes.  Every cached K/V byte is read once per
// token and each is used for only `group` (2 on qwen3-0.6b) multiply-adds:
// at the serving path's shapes (B=8, C=322, Hkv=8, dh=128, bf16) one call
// reads ~10.5 MB of K/V, ~3.1 us at 3.35 TB/s, against ~5 MFLOP.
//
// Design:
// * The TPU grid (B, Hkv, nC) carries (m, l, acc) across its sequential nC
//   axis.  Here one block owns one (kv head, batch) cell and loops over C in
//   tiles of 64 slots, keeping the same f32 online softmax.
// * The block's `group` query rows reuse every K/V tile staged in shared
//   memory, which is the GQA reuse the TPU kernel gets from VMEM.
// * Layout stays the model's: q (B, H, dh), k/v (B, C, Hkv, dh), pos (B, C),
//   cur (B,); the kernel computes its own offsets.
// * Shortfall, left for a later version: the grid has only B * Hkv blocks
//   (64 on the serving path, on 132 SMs) and no load pipelining, so it cannot
//   reach the bandwidth bound.  Splitting C across blocks with a second
//   merge pass (flash-decoding) is the fix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int BC = 64;          // cache slots per tile
constexpr int NT = 128;         // threads per block (4 warps)
constexpr int MAX_GROUP = 16;   // q heads per kv head the kernel takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DH>
size_t dec_smem_bytes(int group) {
  return sizeof(float) * (size_t)(group * DH + BC * (DH + 1) + BC * DH + group * BC + 3 * group)
       + sizeof(int) * BC;
}

// slot flags in shared memory
constexpr int SLOT_MASKED = 0, SLOT_VALID = 1, SLOT_PAD = 2;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) dec_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, const int* __restrict__ cur, T* __restrict__ o,
    int C, int H, int Hkv, int has_window, int window) {
  constexpr int LD = DH + 1;                      // padded K row stride
  constexpr int MAXR = MAX_GROUP * DH / NT;       // acc entries per thread
  const int group = H / Hkv;
  extern __shared__ float smem[];
  float* Qs = smem;                   // group x DH
  float* Ks = Qs + group * DH;        // BC x LD
  float* Vs = Ks + BC * LD;           // BC x DH
  float* Ss = Vs + BC * DH;           // group x BC (scores, then p)
  float* Ms = Ss + group * BC;        // running max per q head
  float* Ls = Ms + group;             // running sum per q head
  float* Sc = Ls + group;             // this tile's rescale per q head
  int* flag = reinterpret_cast<int*>(Sc + group);   // BC slot flags

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur_b = cur[b];
  const float sm = sqrtf((float)DH);
  const int n_out = group * DH;

  const T* qb = q + ((long long)b * H + (long long)hk * group) * DH;
  for (int idx = tid; idx < n_out; idx += NT) Qs[idx] = to_f32(qb[idx]);
  for (int g = tid; g < group; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    __syncthreads();                  // the previous tile's readers are done
    for (int idx = tid; idx < BC * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH, c = c0 + r;
      float kv = 0.f, vv = 0.f;
      if (c < C) {
        const long long off = (((long long)b * C + c) * Hkv + hk) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * LD + d] = kv;
      Vs[r * DH + d] = vv;
    }
    for (int r = tid; r < BC; r += NT) {
      const int c = c0 + r;
      int f = SLOT_PAD;
      if (c < C) {
        const int p = pos[(long long)b * C + c];
        bool ok = p >= 0 && p <= cur_b;
        if (has_window) ok = ok && p > cur_b - window;
        f = ok ? SLOT_VALID : SLOT_MASKED;
      }
      flag[r] = f;
    }
    __syncthreads();

    // scores: one (q head, slot) dot product per thread and pass
    for (int idx = tid; idx < group * BC; idx += NT) {
      const int g = idx / BC, c = idx % BC;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(Qs[g * DH + d], Ks[c * LD + d], dot);
      Ss[idx] = flag[c] == SLOT_VALID ? dot / sm : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per q head row, two slots per lane
    for (int g = warp; g < group; g += NT / 32) {
      float s0 = Ss[g * BC + lane], s1 = Ss[g * BC + lane + 32];
      const bool pad0 = flag[lane] == SLOT_PAD, pad1 = flag[lane + 32] == SLOT_PAD;
      float mx = fmaxf(pad0 ? -CUDART_INF_F : s0, pad1 ? -CUDART_INF_F : s1);
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      const float p0 = pad0 ? 0.f : expf(s0 - m_new);
      const float p1 = pad1 ? 0.f : expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ss[g * BC + lane] = p0;
      Ss[g * BC + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float scale = expf(m_prev - m_new);
        Ls[g] = Ls[g] * scale + sum;
        Ms[g] = m_new;
        Sc[g] = scale;
      }
    }
    __syncthreads();

    // acc = acc * scale + P @ V; thread owns (q head, dim) pairs tid + NT * r
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int idx = tid + NT * r;
      if (idx < n_out) {
        const int g = idx / DH, d = idx % DH;
        float a = acc[r] * Sc[g];
#pragma unroll 8
        for (int c = 0; c < BC; ++c) a = fmaf(Ss[g * BC + c], Vs[c * DH + d], a);
        acc[r] = a;
      }
    }
  }

  T* ob = o + ((long long)b * H + (long long)hk * group) * DH;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int idx = tid + NT * r;
    if (idx < n_out) ob[idx] = from_f32<T>(acc[r] / fmaxf(Ls[idx / DH], 1e-30f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* cur, void* o, int B, int C, int H, int Hkv,
           int has_window, int window, cudaStream_t stream) {
  const size_t smem = dec_smem_bytes<DH>(H / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      dec_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  dec_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(cur), static_cast<T*>(o),
      C, H, Hkv, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* pos,
              const void* cur, void* o, int B, int C, int H, int Hkv, int dh,
              int has_window, int window, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, pos, cur, o, B, C, H, Hkv, has_window, window, stream);
    case 64: return launch<T, 64>(q, k, v, pos, cur, o, B, C, H, Hkv, has_window, window, stream);
    case 128: return launch<T, 128>(q, k, v, pos, cur, o, B, C, H, Hkv, has_window, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, const void* cur,
    void* o, int B, int C, int H, int Hkv, int dh, int has_window, int window,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, pos, cur, o, B, C, H, Hkv, dh,
                                    has_window, window, s);
  return launch_dh<float>(q, k, v, pos, cur, o, B, C, H, Hkv, dh, has_window,
                          window, s);
}
