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
// bound is bytes (chip_smoke.py's check_prefix computes the same bound).
// This first version runs its products as f32 FMAs on the CUDA cores, like
// the prefill kernel it shares its tile with (csrc/flash_attention.cu).
//
// Design (the prefill kernel's, with two operands):
// * The TPU grid (B, H, nQ, nKp + nKs) carries (m, l, acc) across its
//   sequential k axis, clamping each operand's block index during the other
//   phase.  Here one block owns one (q-tile, head, batch) cell and runs two
//   loops over k-tiles, first the prefix operand, then the suffix operand,
//   with (m, l, acc) in f32 registers throughout.
// * The tile, staging and online-softmax step are attn_common.cuh's, shared
//   with the prefill kernel; only the masks and the two loops are here.
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

namespace {

using namespace attn;

template <typename T, int DH>
__global__ void __launch_bounds__(TILE_NT) pfx_kernel(
    const T* __restrict__ q, const T* __restrict__ pk, const T* __restrict__ pv,
    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int Sq, int Lp, int Sk, int H, int Hkv, int q_offset) {
  extern __shared__ float smem[];
  const Tiles<DH> t(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = qt * BQ;               // first query row of the tile
  const int q_lo = row0 + q_offset;       // its suffix-local position
  const float sm = sqrtf((float)DH);

  load_q_tile<T, DH>(q, b, Sq, H, h, row0, t.Qs, tid);
  RowState<DH> st;

  // phase 1: the cached prefix, visible to every suffix row
  const auto in_prefix = [=](int, int col) { return col < Lp; };
  for (int k_lo = 0; k_lo < Lp; k_lo += BK) {
    __syncthreads();              // the previous tile's readers are done
    stage_kv<T, DH>(pk, pv, b, Lp, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, in_prefix, st);
  }
  // phase 2: the fresh suffix, causal in suffix coordinates; the tiles
  // wholly above the diagonal end the loop (the test is uniform per block)
  const auto causal = [=](int row, int col) { return col < Sk && col <= row; };
  for (int k_lo = 0; k_lo < Sk && k_lo <= q_lo + BQ - 1; k_lo += BK) {
    __syncthreads();
    stage_kv<T, DH>(k, v, b, Sk, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, causal, st);
  }
  store_rows<T, DH>(o, b, Sq, H, h, row0, tx, ty, st);
}

template <typename T, int DH>
int launch(const void* q, const void* pk, const void* pv, const void* k,
           const void* v, void* o, int B, int Sq, int Lp, int Sk, int H, int Hkv,
           int q_offset, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      pfx_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  pfx_kernel<T, DH><<<grid, TILE_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      Sq, Lp, Sk, H, Hkv, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* pk, const void* pv, const void* k,
              const void* v, void* o, int B, int Sq, int Lp, int Sk, int H,
              int Hkv, int dh, int q_offset, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, stream);
    case 64: return launch<T, 64>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, stream);
    case 128: return launch<T, 128>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_prefix_flash_attention(
    const void* q, const void* pk, const void* pv, const void* k, const void* v,
    void* o, int B, int Sq, int Lp, int Sk, int H, int Hkv, int dh,
    int q_offset, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || Sq < 1 || Lp < 0 || Sk < 0 || Lp + Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv,
                                    dh, q_offset, s);
  return launch_dh<float>(q, pk, pv, k, v, o, B, Sq, Lp, Sk, H, Hkv, dh,
                          q_offset, s);
}
