// Prefix-context flash attention (suffix prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/prefix_attention/kernel.py:
// prefix_flash_attention_kernel (body _pfx_kernel).  Shared-prefix
// admission runs only the uncached tail of a prompt: suffix queries attend
// to [cached prefix K/V ; fresh suffix K/V] with one f32 online softmax, and
// the concat of the two is never built.  Every prefix position precedes
// every suffix row, so the prefix phase masks only its ragged edge
// (col < Lp); the suffix phase is causal in suffix coordinates
// (col <= q_offset + row, col < Sk), which is exactly rows [Lp:] of the
// full-sequence causal attention: the cached == cold contract.
//
// What bounds it on the H100: at the serving path's cached-admission shapes
// (B=8, Sq=Sk=64 suffix rows, Lp=192, H=16, Hkv=8, dh=128, bf16) the call
// moves ~12.6 MB (q, pk, pv, k, v read once, out written once: ~3.76 us at
// 3.35 TB/s) and does ~0.94 GFLOP of QK^T and PV over the prefix and the
// causal suffix (~0.95 us at the 989 TFLOP/s bf16 tensor-core peak), so the
// bound is bytes as long as the products run on the tensor cores
// (chip_smoke.py's time_prefix computes the same bound).
//
// Two routes, chosen by dtype (a bf16 tensor never reaches the f32 one):
// * bf16, the serving path: pfx_mma_kernel, attn_mma.cuh's FlashAttention-2
//   tile (mma.sync m16n8k16 bf16 -> f32), as flash_attention.cu's
//   fa_mma_kernel runs prefill.  4 warps own a 64-row q tile and keep Q in
//   registers as A fragments.  The prefix's k-tiles and then the suffix's
//   form ONE sequence of 64-key tiles, staged by 16-byte cp.async into
//   padded rows and double-buffered across the phase boundary: the first
//   suffix tile loads while the last prefix tile computes.  The online
//   softmax runs on the f32 score fragments; P is rounded to bf16 in
//   registers as the A operand of P V.  The TPU kernel keeps p in f32 there
//   (its `p.astype(v.dtype)`, kernel.py:63, casts to f32, since v was cast
//   at :71-72 and :85-86); the rounding adds ~2^-9 relative to each
//   weight, well inside the bf16 tolerance (2e-2), and the row sum l stays
//   the f32 sum of the unrounded p (ref.prefix_flash_attention_mma_ref
//   emulates it for the CPU tests).  The q tiles with the most suffix
//   tiles launch first (grid z walks them in reverse).
// * f32: pfx_kernel, attn_common.cuh's CUDA-core tile in full f32 (256
//   threads as a 16 x 16 grid, Q, K, V and P staged as f32, no TF32),
//   shared with the f32 prefill kernel; two loops, prefix then suffix.
//
// Both:
// * The TPU grid (B, H, nQ, nKp + nKs) carries (m, l, acc) across its
//   sequential k axis, clamping each operand's block index during the other
//   phase.  Here one block owns one (q-tile, head, batch) cell and walks the
//   prefix's k-tiles and then the suffix's, with (m, l, acc) in f32
//   registers throughout.
// * Both operands are read in the model layout (B, S, Hkv, dh); the kv head
//   of q head h is h / (H / Hkv).  The wrapper makes no transposes, pads
//   nothing and copies nothing.
// * Suffix tiles wholly above the causal diagonal are skipped, as in the
//   TPU kernel.  Ragged Sq, Lp and Sk are masked in the kernel: rows >= Sq
//   are never written, cols >= Lp or >= Sk are masked.
// * Masked scores take -1e30 as on the TPU.  Every row sees col 0 of the
//   prefix first (or col 0 of the suffix when Lp = 0), so the running max
//   is a real score from the first tile on and masked entries weigh 0.

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace {

using namespace attn;

using bf16 = __nv_bfloat16;

template <int DH>
__global__ void __launch_bounds__(TILE_NT) pfx_kernel(
    const float* __restrict__ q, const float* __restrict__ pk,
    const float* __restrict__ pv, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Lp,
    int Sk, int H, int Hkv, int q_offset) {
  extern __shared__ float smem[];
  const Tiles<DH> t(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = qt * BQ;               // first query row of the tile
  const int q_lo = row0 + q_offset;       // its suffix-local position
  const float sm = sqrtf((float)DH);

  load_q_tile<float, DH>(q, b, Sq, H, h, row0, t.Qs, tid);
  RowState<DH> st;

  // phase 1: the cached prefix, visible to every suffix row
  const auto in_prefix = [=](int, int col) { return col < Lp; };
  for (int k_lo = 0; k_lo < Lp; k_lo += BK) {
    __syncthreads();              // the previous tile's readers are done
    stage_kv<float, DH>(pk, pv, b, Lp, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, in_prefix, st);
  }
  // phase 2: the fresh suffix, causal in suffix coordinates; the tiles
  // wholly above the diagonal end the loop (the test is uniform per block)
  const auto causal = [=](int row, int col) { return col < Sk && col <= row; };
  for (int k_lo = 0; k_lo < Sk && k_lo <= q_lo + BQ - 1; k_lo += BK) {
    __syncthreads();
    stage_kv<float, DH>(k, v, b, Sk, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, causal, st);
  }
  store_rows<float, DH>(o, b, Sq, H, h, row0, tx, ty, st);
}

template <int DH>
__global__ void __launch_bounds__(MMA_NT) pfx_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pk,
    const bf16* __restrict__ pv, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Lp, int Sk,
    int H, int Hkv, int q_offset) {
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
  const int q_lo = row0 + q_offset;               // its suffix-local position
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);

  // one sequence of k-tiles: the prefix's n_p, then the suffix's n_s that
  // the TPU kernel's skip test keeps (k_lo <= q_lo + BQ - 1)
  const int n_p = (Lp + MMA_BK - 1) / MMA_BK;
  const int n_s = min((Sk + MMA_BK - 1) / MMA_BK, (q_lo + MMA_BQ - 1) / MMA_BK + 1);
  const int n_t = n_p + n_s;

  mma_stage_rows<DH, MMA_BQ>(Qs, q, b, Sq, H, h, row0, tid);
  const auto stage_tile = [&](int i, int buf) {
    const bool pre = i < n_p;
    const int k_lo = (pre ? i : i - n_p) * MMA_BK;
    mma_stage_rows<DH, MMA_BK>(Ks + buf * MMA_BK * LD, pre ? pk : k, b,
                               pre ? Lp : Sk, Hkv, hk, k_lo, tid);
    mma_stage_rows<DH, MMA_BK>(Vs + buf * MMA_BK * LD, pre ? pv : v, b,
                               pre ? Lp : Sk, Hkv, hk, k_lo, tid);
  };
  if (n_t > 0) stage_tile(0, 0);
  cp_async_commit();

  MmaRows<DH> st;
  for (int i = 0; i < n_t; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_t) {
      stage_tile(i + 1, buf ^ 1);     // across the phase boundary too
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile i (and at first Q) visible
    if (i == 0) st.load_q(Qs, warp, lane);
    const bool pre = i < n_p;
    // prefix: only the ragged edge; suffix: causal in suffix coordinates
    const auto score = [=](int row, int col, float s) {
      return (pre ? col < Lp : (col < Sk && col <= row)) ? s : NEG_INF;
    };
    st.step(Ks + buf * MMA_BK * LD, Vs + buf * MMA_BK * LD,
            (pre ? i : i - n_p) * MMA_BK, q_lo + warp * 16 + (lane >> 2),
            scale_log2, score, lane);
    __syncthreads();                  // readers done before the buffer refills
  }
  cp_async_wait<0>();                 // Q still in flight when no tile ran
  __syncthreads();
  st.store(Qs, o, b, Sq, H, h, row0, warp, lane);
}

template <int DH>
int launch_f32(const void* q, const void* pk, const void* pv, const void* k,
               const void* v, void* o, int B, int Sq, int Lp, int Sk, int H,
               int Hkv, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      pfx_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  pfx_kernel<DH><<<grid, TILE_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pk),
      static_cast<const float*>(pv), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Lp, Sk, H,
      Hkv, q_offset);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* pk, const void* pv, const void* k,
                const void* v, void* o, int B, int Sq, int Lp, int Sk, int H,
                int Hkv, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      pfx_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(H, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  pfx_mma_kernel<DH><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Lp, Sk, H, Hkv,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_prefix_flash_attention(
    const void* q, const void* pk, const void* pv, const void* k, const void* v,
    void* o, int B, int Sq, int Lp, int Sk, int H, int Hkv, int dh,
    int q_offset, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || Sq < 1 || Lp < 0 || Sk < 0 || Lp + Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (dh) {
      case 32: return launch_bf16<32>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
      case 64: return launch_bf16<64>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
      case 128: return launch_bf16<128>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 32: return launch_f32<32>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
    case 64: return launch_f32<64>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
    case 128: return launch_f32<128>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
