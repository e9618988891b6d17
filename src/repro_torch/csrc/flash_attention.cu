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
// * The tile, staging and online-softmax step are attn_common.cuh's, shared
//   with the prefix kernel: 256 threads as a 16 x 16 grid over a 64-row q
//   tile and 64-key k-tiles, Q, K, V and P staged in shared memory as f32,
//   (m, l, acc) in registers.
// * Ragged Sq and Sk are masked in the kernel (rows >= Sq are never written,
//   cols >= Sk are masked), so unlike the TPU kernel no multiple of the
//   tile is required.  Masked scores take -1e30 as on the TPU, so the
//   result matches the reference's masking arithmetic.

#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T, int DH>
__global__ void __launch_bounds__(TILE_NT) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int Hkv, int causal,
    int has_window, int window, int q_offset) {
  extern __shared__ float smem[];
  const Tiles<DH> t(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = qt * BQ;               // first query row of the tile
  const int q_lo = row0 + q_offset;       // its absolute position
  const float sm = sqrtf((float)DH);

  load_q_tile<T, DH>(q, b, Sq, H, h, row0, t.Qs, tid);
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
    stage_kv<T, DH>(k, v, b, Sk, Hkv, hk, k_lo, t.Ks, t.Vs, tid);
    __syncthreads();
    online_tile<DH>(t, tx, ty, k_lo, q_lo, sm, attend, st);
  }
  store_rows<T, DH>(o, b, Sq, H, h, row0, tx, ty, st);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int has_window, int window,
           int q_offset, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, DH><<<grid, TILE_NT, smem, stream>>>(
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
