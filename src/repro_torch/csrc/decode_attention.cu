// Dense ring-buffer decode attention for Hopper, sm_90a: split-KV
// (flash-decoding) in two passes.
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
// reads ~9.2 MB of valid K/V, ~2.7 us at 3.35 TB/s, against ~5 MFLOP.
//
// Design:
// * The TPU grid (B, Hkv, nC) carries (m, l, acc) across its sequential nC
//   axis.  A grid of only B * Hkv blocks (64 on the serving path) leaves
//   half of the 132 SMs idle, so the cache axis is split across blocks:
//   pass 1 runs a grid (n_split, Hkv, B); each block owns one contiguous
//   range of split_len slots of one (kv head, batch row) and computes the
//   unnormalised (m, l, acc) of all `group` q heads there, so each K/V
//   byte is read once.  The wrapper picks n_split (kernel.py:plan_splits)
//   so the grid reaches ~2 x 132 blocks and every split holds a real slot.
// * Pass 2 (dec_merge_kernel), one block per (q head, batch row):
//   m* = max_s m_s, out = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*)
//   l_s, 1e-30), cast to q's dtype.  The partials live in f32 scratch the
//   wrapper allocates: acc (B, H, n_split, dh) and (m, l) (B, H, n_split, 2).
//   It is launched as a programmatic dependent launch (cudaLaunchKernelEx),
//   so its launch overlaps the split pass's tail.  On request (ml_out not
//   null) it also writes each (batch row, q head)'s m* and denominator
//   sum_s e^(m_s - m*) l_s to ml_out (B, H, 2): the statistics with which
//   a cache whose length is sharded over several ranks merges their
//   outputs (distributed/spmd.py), in the same NEG_INF convention.
// * K/V tiles of BC = 32 slots are staged in shared memory in their own
//   dtype (bf16 stays bf16) with 16-byte cp.async, double-buffered so tile
//   t + 1 loads while tile t computes: ~34 KB of shared memory a block at
//   bf16, dh=128, group 2, so several blocks share an SM.  Of the variants
//   timed on the card at the serving shape (4 or 8 warps a block, splits
//   of 32, 64 or 128 slots), 8 warps and splits of 64 were the fastest:
//   more, smaller blocks cost more than they hide at C = 322.
// * Scores: four lanes per (q head, slot) dot product, each reading 16-byte
//   chunks of the K row (odd rows rotated by four chunks, so the eight
//   lanes of one 128-byte shared-memory phase hit distinct banks), reduced
//   with two shuffles.  Softmax: one warp per q head, one lane per slot.
//   P V: each thread owns (q head, dim pair) accumulators in registers.
//   This tile step, the partial write and the merge body are
//   attn_common.cuh's (decode_tile, decode_write_partials, decode_merge),
//   shared with paged_decode_attention.cu.
//
// Why the merge reproduces ref.py in every case: masked slots score
// NEG_INF = -1e30 (as on the TPU) and take part in the softmax; slots past
// the split's end or past C (pad) take no part at all.
// * A row with a valid slot: its max m* is a real score, so a split whose
//   slots are all masked (m_s = -1e30) is weighted e^(-1e30 - m*) = 0, and
//   inside a split the masked slots' e^(-1e30 - m) = 0 too.
// * A row with no valid slot (ROADMAP.md Queue 3): every split has
//   m_s = -1e30 = m*, l_s = its count of slots and acc_s = the sum of their
//   V rows, so the merge gives the mean of V over exactly the C slots, as
//   ref.py's softmax over C columns of -1e30 does.

#include <math_constants.h>

#include "attn_common.cuh"

namespace {

using namespace attn;
// tiles of BC = 32 cache slots (split_len is a multiple), NT = 256 threads
// a block of the split pass, at most MAX_GROUP = 16 q heads per kv head
using namespace attn::dec;

template <typename T, int DH>
constexpr size_t split_smem_bytes(int group) {
  // K and V (2 buffers x BC x DH each), Qs (group x DH), Ss (group x BC),
  // Ms, Ls, Sc (group each), slot positions (2 x BC)
  return sizeof(T) * (size_t)(4 * BC * DH)
       + sizeof(float) * (size_t)(group * DH + group * BC + 3 * group)
       + sizeof(int) * (size_t)(2 * BC);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) dec_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, const int* __restrict__ cur,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int C, int H,
    int Hkv, int split_len, int has_window, int window) {
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int CHUNKS = DH / VEC;                // chunks per K/V row
  const int group = H / Hkv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);         // [2][BC][DH]
  T* Vs = Ks + 2 * BC * DH;                       // [2][BC][DH]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * BC * DH);   // [group][DH]
  float* Ss = Qs + group * DH;                    // [group][BC] scores, then p
  float* Ms = Ss + group * BC;                    // running max per q head
  float* Ls = Ms + group;                         // running sum per q head
  float* Sc = Ls + group;                         // this tile's rescale
  int* Pos = reinterpret_cast<int*>(Sc + group);  // [2][BC] slot positions

  // the merge pass may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int c_begin = split * split_len;
  const int c_end = min(C, c_begin + split_len);
  const int n_tiles = (c_end - c_begin + BC - 1) / BC;
  const int cur_b = cur[b];
  const float sm = sqrtf((float)DH);
  const long long slot_stride = (long long)Hkv * DH;
  const T* kb = k + ((long long)b * C * Hkv + hk) * DH;
  const T* vb = v + ((long long)b * C * Hkv + hk) * DH;
  const int* posb = pos + (long long)b * C;

  // stage tile t of this split into buffer buf by cp.async: K/V rows and
  // slot positions, those past c_end zero-filled (and never read as slots)
  const auto stage = [&](int t, int buf) {
    const int c0 = c_begin + t * BC;
    for (int idx = tid; idx < BC * CHUNKS; idx += NT) {
      const int r = idx / CHUNKS, ch = idx % CHUNKS, c = c0 + r;
      const bool in = c < c_end;
      const long long off = (in ? c : c_begin) * slot_stride + ch * VEC;
      const int dst = (buf * BC + r) * DH + ch * VEC;
      cp_async16(Ks + dst, kb + off, in);
      cp_async16(Vs + dst, vb + off, in);
    }
    if (tid < BC) {
      const bool in = c0 + tid < c_end;
      cp_async4(Pos + buf * BC + tid, posb + (in ? c0 + tid : c_begin), in);
    }
    cp_async_commit();
  };

  stage(0, 0);
  const T* qb = q + ((long long)b * H + (long long)hk * group) * DH;
  for (int idx = tid; idx < group * DH; idx += NT) Qs[idx] = to_f32(qb[idx]);
  for (int g = tid; g < group; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float2 acc[MAXR<DH>];
#pragma unroll
  for (int r = 0; r < MAXR<DH>; ++r) acc[r] = make_float2(0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile t (and Qs) visible
    const int* pt = Pos + buf * BC;
    const int n_in = c_end - (c_begin + t * BC);   // real slots of the tile
    // slots past the split's end take no part; masked slots score NEG_INF
    decode_tile<T, DH>(Ks + buf * BC * DH, Vs + buf * BC * DH, Qs, Ss, Ms, Ls,
                       Sc, acc, group, tid, [&](int c, float dot) {
      if (c >= n_in) return -CUDART_INF_F;
      const int p = pt[c];
      bool ok = p >= 0 && p <= cur_b;
      if (has_window) ok = ok && p > cur_b - window;
      return ok ? dot / sm : NEG_INF;
    });
    __syncthreads();                  // readers done before the buffer refills
  }

  decode_write_partials<DH>(
      acc, Ms, Ls, part_acc, part_ml,
      ((long long)b * H + (long long)hk * group) * n_split + split, n_split,
      group, tid);
}

// pass 2: one block of dh threads per (q head, batch row), merging the
// splits (attn_common.cuh's decode_merge).  Launched as a programmatic
// dependent of the split pass, so its blocks may start while the split
// pass drains.  With ml_out, thread 0 then writes the row's m* (the
// largest m_s) and its denominator, which decode_merge left in w[n_split].
template <typename T>
__global__ void dec_merge_kernel(const float* __restrict__ part_acc,
                                 const float* __restrict__ part_ml,
                                 T* __restrict__ o, float* __restrict__ ml_out,
                                 int H, int DH, int n_split) {
  decode_merge(part_acc, part_ml, o, H, DH, n_split);
  if (ml_out != nullptr && threadIdx.x == 0) {
    extern __shared__ float wsh[];    // decode_merge's weights, then the denominator
    const long long row = (long long)blockIdx.y * H + blockIdx.x;
    float m_star = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s)
      m_star = fmaxf(m_star, part_ml[(row * n_split + s) * 2]);
    ml_out[row * 2] = m_star;
    ml_out[row * 2 + 1] = wsh[n_split];
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* cur, void* part_acc, void* part_ml, void* o,
           void* ml_out, int B, int C, int H, int Hkv, int n_split,
           int split_len, int has_window, int window, cudaStream_t stream) {
  // once per instantiation (the port drives one card): room for MAX_GROUP
  static const cudaError_t attr = cudaFuncSetAttribute(
      dec_split_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_smem_bytes<T, DH>(MAX_GROUP));
  if (attr != cudaSuccess) return (int)attr;
  dec_split_kernel<T, DH><<<dim3(n_split, Hkv, B), NT,
                            split_smem_bytes<T, DH>(H / Hkv), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(cur),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), C, H, Hkv,
      split_len, has_window, window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dependent(dec_merge_kernel<T>, dim3(H, B), dim3(DH),
                          sizeof(float) * (size_t)(n_split + 1), stream,
                          static_cast<const float*>(part_acc),
                          static_cast<const float*>(part_ml),
                          static_cast<T*>(o), static_cast<float*>(ml_out),
                          H, (int)DH, n_split);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* pos,
              const void* cur, void* part_acc, void* part_ml, void* o,
              void* ml_out, int B, int C, int H, int Hkv, int dh, int n_split,
              int split_len, int has_window, int window, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, pos, cur, part_acc, part_ml, o, ml_out, B, C, H, Hkv, n_split, split_len, has_window, window, stream);
    case 64: return launch<T, 64>(q, k, v, pos, cur, part_acc, part_ml, o, ml_out, B, C, H, Hkv, n_split, split_len, has_window, window, stream);
    case 128: return launch<T, 128>(q, k, v, pos, cur, part_acc, part_ml, o, ml_out, B, C, H, Hkv, n_split, split_len, has_window, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc: f32 (B, H, n_split, dh) and part_ml: f32 (B, H, n_split, 2),
// scratch the caller allocates; splits of split_len slots (a multiple of
// BC), each holding at least one of the C slots; ml_out: f32 (B, H, 2) or
// null (not written)
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, const void* cur,
    void* part_acc, void* part_ml, void* o, void* ml_out, int B, int C, int H,
    int Hkv, int dh, int n_split, int split_len, int has_window, int window,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (C < 1 || split_len < BC || split_len % BC != 0 || n_split < 1
      || (long long)(n_split - 1) * split_len >= C
      || (long long)n_split * split_len < C)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, pos, cur, part_acc, part_ml, o,
                                    ml_out, B, C, H, Hkv, dh, n_split,
                                    split_len, has_window, window, s);
  return launch_dh<float>(q, k, v, pos, cur, part_acc, part_ml, o, ml_out, B,
                          C, H, Hkv, dh, n_split, split_len, has_window,
                          window, s);
}
