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
// the bound is bytes, as long as the products run on the tensor cores.
//
// Two routes, chosen by dtype (a bf16 tensor never reaches the f32 one):
// * bf16, the serving path: fa_mma_kernel, attn_mma.cuh's FlashAttention-2
//   tile (mma.sync m16n8k16 bf16 -> f32).  4 warps own a 64-row q tile, Q
//   stays in registers as A fragments, K/V tiles of 64 keys are staged in
//   shared memory as bf16 by 16-byte cp.async, double-buffered so tile
//   k + 1 loads while tile k computes, and the online softmax runs on the f32
//   score fragments.  P is rounded to bf16 in registers as the A operand of
//   P V.  The TPU kernel keeps p in f32 there (its `p.astype(v.dtype)`,
//   kernel.py:90, casts to f32, since v was cast at :69); the rounding adds
//   ~2^-9 relative to each weight, well inside the bf16 tolerance (2e-2),
//   and the row sum l stays the f32 sum of the unrounded p.  The q tiles
//   with the most k-tiles launch first (grid z walks them in reverse), so
//   the causal tail does not straggle.
// * f32: fa_kernel, attn_common.cuh's CUDA-core tile in full f32 (256
//   threads as a 16 x 16 grid, Q, K, V and P staged as f32), so f32
//   callers keep full f32 products (no TF32).
//
// Both: the TPU grid (B, H, nQ, nK) runs its nK axis in order and carries
// (m, l, acc) in VMEM scratch; here one block owns one (q-tile, head,
// batch) cell and loops over the k-tiles itself, skipping fully masked ones
// by the TPU kernel's test, with (m, l, acc) in f32 registers.  Inputs stay
// in the model layout (B, S, H, dh) / (B, S, Hkv, dh) and the kv head of q
// head h is h / (H / Hkv).  Ragged Sq and Sk are masked in the kernel (rows
// >= Sq are never written, cols >= Sk are masked), so unlike the TPU kernel
// no multiple of the tile is required.  Masked scores take -1e30 as on the
// TPU, so the result matches the reference's masking arithmetic.
//
// The log-sum-exp for training: given a non-null `lse` (f32, (B, Sq, H),
// the model layout), each route also writes m + log(l) of every row, in the
// units of the reference's _flash_fwd_lse (repro/models/attention.py:242):
// scores scaled by 1/sqrt(DH), natural log.  The f32 route keeps m in those
// units already; the bf16 route keeps the unscaled row max (its exponent is
// 2^(s c - m c), c = log2e / sqrt(DH)), so m / sqrt(DH) is written.  A row
// with no valid key keeps m = -1e30 and writes -1e30 + log(l), which is
// -1e30 in f32, as the reference's does.  Serving passes a null pointer and
// the kernels skip the write.

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace {

using namespace attn;

using bf16 = __nv_bfloat16;

template <int DH>
__global__ void __launch_bounds__(TILE_NT) fa_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int Hkv, int causal, int has_window, int window,
    int q_offset) {
  extern __shared__ float smem[];
  const Tiles<DH> t(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = qt * BQ;               // first query row of the tile
  const int q_lo = row0 + q_offset;       // its absolute position
  const float sm = sqrtf((float)DH);

  load_q_tile<float, DH>(q, b, Sq, H, h, row0, t.Qs, tid);
  RowState<DH> st;
  // row and col are absolute positions
  const auto attend = [=](int row, int col) {
    bool ok = col < Sk;
    if (causal) ok = ok && col <= row;
    if (has_window) ok = ok && col > row - window;
    return ok;
  };

  const int n_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k_lo = kt * BK;
    // tile-level skip, the same test as the TPU kernel (uniform per block)
    if (causal && k_lo > q_lo + BQ - 1) continue;
    if (has_window && k_lo + BK - 1 <= q_lo - window) continue;

    __syncthreads();              // the previous tile's readers are done
    stage_kv<float, DH>(k, v, b, Sk, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, attend, st);
  }
  store_rows<float, DH>(o, b, Sq, H, h, row0, tx, ty, st);
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row < Sq)
        lse[((long long)b * Sq + row) * H + h] = st.m[i] + logf(fmaxf(st.l[i], 1e-30f));
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(MMA_NT) fa_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int Hkv, int causal, int has_window, int window,
    int q_offset) {
  constexpr int LD = mma_ld<DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // MMA_BQ x LD, then O
  bf16* Ks = Qs + MMA_BQ * LD;                    // [2][MMA_BK][LD]
  bf16* Vs = Ks + 2 * MMA_BK * LD;                // [2][MMA_BK][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;      // most k-tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * MMA_BQ;                   // first query row of the tile
  const int q_lo = row0 + q_offset;               // its absolute position
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  const auto score = [=](int row, int col, float s) {
    bool ok = col < Sk;
    if (causal) ok = ok && col <= row;
    if (has_window) ok = ok && col > row - window;
    return ok ? s : NEG_INF;
  };

  // the k-tiles the TPU kernel's skip test keeps: causal drops those with
  // k_lo > q_lo + BQ - 1, the window those with k_lo + BK - 1 <= q_lo - window
  int kt_begin = 0, kt_end = (Sk + MMA_BK - 1) / MMA_BK;
  if (causal) {
    const int last = q_lo + MMA_BQ - 1;
    kt_end = min(kt_end, last >= 0 ? last / MMA_BK + 1 : 0);
  }
  if (has_window) {
    const int first = q_lo - window + 1;
    kt_begin = first > 0 ? first / MMA_BK : 0;
  }

  mma_stage_rows<DH, MMA_BQ>(Qs, q, b, Sq, H, h, row0, tid);
  const auto stage_kv_tile = [&](int kt, int buf) {
    mma_stage_rows<DH, MMA_BK>(Ks + buf * MMA_BK * LD, k, b, Sk, Hkv, hk, kt * MMA_BK, tid);
    mma_stage_rows<DH, MMA_BK>(Vs + buf * MMA_BK * LD, v, b, Sk, Hkv, hk, kt * MMA_BK, tid);
  };
  if (kt_begin < kt_end) stage_kv_tile(kt_begin, 0);
  cp_async_commit();

  MmaRows<DH> st;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      stage_kv_tile(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile kt (and at first Q) visible
    if (kt == kt_begin) st.load_q(Qs, warp, lane);
    st.step(Ks + buf * MMA_BK * LD, Vs + buf * MMA_BK * LD, kt * MMA_BK,
            q_lo + warp * 16 + (lane >> 2), scale_log2, score, lane);
    __syncthreads();                  // readers done before the buffer refills
  }
  cp_async_wait<0>();                 // Q still in flight when no tile ran
  __syncthreads();
  st.store(Qs, o, b, Sq, H, h, row0, warp, lane);
  // the four lanes of a quad hold the same m and l of rows g and g + 8
  if (lse != nullptr && (lane & 3) == 0) {
    const float inv_sqrt = 1.f / sqrtf((float)DH);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + warp * 16 + (lane >> 2) + 8 * i;
      const float m = st.m[i] <= NEG_INF ? NEG_INF : st.m[i] * inv_sqrt;
      if (row < Sq)
        lse[((long long)b * Sq + row) * H + h] = m + logf(fmaxf(st.l[i], 1e-30f));
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int Sq, int Sk, int H, int Hkv, int causal,
               int has_window, int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<DH><<<grid, TILE_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, causal, has_window, window,
      q_offset);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
                int has_window, int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(H, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  fa_mma_kernel<DH><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, causal, has_window, window,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int Hkv, int dh, int causal, int has_window,
    int window, int q_offset, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (dh) {
      case 32: return launch_bf16<32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
      case 64: return launch_bf16<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
      case 128: return launch_bf16<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 32: return launch_f32<32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
    case 64: return launch_f32<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
    case 128: return launch_f32<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, has_window, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
