// Device helpers shared by the attention kernels of this directory, the
// programmatic dependent launch of their merge passes, the tile step, the
// partial write and the merge of the two decode kernels' split passes
// (decode_attention.cu, paged_decode_attention.cu), which differ only in
// how they stage key rows and score masked ones, and the tiled f32 online-softmax step of the prefill-shaped kernels (the f32 route
// of flash_attention.cu, prefix_flash_attention.cu), which differ only in
// their masks and in which K/V operands their k-tile loops walk.  The bf16
// tensor-core tile is attn_mma.cuh's.
//
// Every function here is inline, so each kernel source still compiles on
// its own; _build.py rebuilds the library when this header changes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace attn {

constexpr float NEG_INF = -1e30f;   // masked scores, as on the TPU

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements at p (aligned to N elements) as f32, one vector load
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  } else {
    static_assert(N == 1, "dh / 32 must be 1, 2 or 4");
    x[0] = *p;
  }
}
// bf16 -> f32 is the 16 bits moved to the top of the word
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const unsigned int u = *reinterpret_cast<const unsigned int*>(p);
    x[0] = __uint_as_float(u << 16); x[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    static_assert(N == 1, "dh / 32 must be 1, 2 or 4");
    x[0] = __bfloat162float(*p);
  }
}

// 16- and 4-byte asynchronous copies global -> shared (cp.async, sm_80+).
// With `pred` false nothing is read and the bytes are zero-filled, so a tile
// past a ragged edge stages as zeros.  `gmem` must stay a valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// reductions over the 32 lanes of a warp
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

// The merge pass of the split-KV kernels (decode_attention.cu,
// paged_verify_attention.cu), called by every thread of a block of DH
// threads that owns one output row: the row's n_split partials hold acc at
// part_acc[(row0 + s) * DH ..] and (m, l) at part_ml[(row0 + s) * 2 ..].
// Warp 0 turns the (m, l) into weights e^(m_s - m*) (0 for a split that saw
// no key, m_s = -inf) and the denominator in `w` (n_split + 1 floats of
// shared memory); then each thread returns its dim d of
// sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30).
__device__ __forceinline__ float merge_splits(const float* __restrict__ part_acc,
                                              const float* __restrict__ part_ml,
                                              long long row0, int n_split, int DH,
                                              int d, float* w) {
  if (d < 32) {
    float m_star = -CUDART_INF_F;
    for (int s = d; s < n_split; s += 32) m_star = fmaxf(m_star, part_ml[(row0 + s) * 2]);
    m_star = warp_max(m_star);
    float den = 0.f;
    for (int s = d; s < n_split; s += 32) {
      const float ms = part_ml[(row0 + s) * 2];
      const float ws = ms == -CUDART_INF_F ? 0.f : expf(ms - m_star);
      w[s] = ws;
      den = fmaf(ws, part_ml[(row0 + s) * 2 + 1], den);
    }
    den = warp_sum(den);
    if (d == 0) w[n_split] = den;
  }
  __syncthreads();
  float num = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) num = fmaf(w[s], part_acc[(row0 + s) * DH + d], num);
  return num / fmaxf(w[n_split], 1e-30f);
}

// 16 bytes of K/V (8 bf16 or 4 f32) as f32
__device__ __forceinline__ void chunk_to_f32(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void chunk_to_f32(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

// two consecutive elements as f32
__device__ __forceinline__ float2 pair_to_f32(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 pair_to_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Launch a merge pass as a programmatic dependent of the split pass just
// launched on `stream`: its blocks may be scheduled while the split pass
// drains, and its griddepcontrol.wait holds them until the split pass's
// partials are complete and visible.  Returns the launch's error.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split pass of the decode kernels (decode_attention.cu over ring
// slots, paged_decode_attention.cu over pages): one query row per q head,
// the `group` q heads of one kv head in a block of dec::NT threads, key
// rows staged in shared memory in tiles of dec::BC, products on the CUDA
// cores in f32.  The block's shared memory holds Qs [group][DH] (q as f32),
// Ss [group][BC] (scores, then p) and Ms, Ls, Sc [group] (running max,
// running sum, this tile's rescale); thread tid owns the accumulators of
// (q head, dim pair) tid + NT * r.
// ---------------------------------------------------------------------------

namespace dec {
constexpr int BC = 32;              // key rows per staged tile (a lane each)
constexpr int NT = 256;             // threads per block (8 warps)
constexpr int SUB = 4;              // lanes per q.k dot product
constexpr int MAX_GROUP = 16;       // q heads per kv head
template <int DH>
constexpr int MAXR = MAX_GROUP * (DH / 2) / NT;   // accumulator pairs a thread
}  // namespace dec

// One staged tile through the online softmax.  score(c, dot) gives row c's
// score from its q.k dot: dot / sqrt(DH) where attended, NEG_INF where
// masked (the row takes part at -1e30), -inf where the row takes no part
// (weight 0; its V row must be staged as zeros).  While every row so far
// took no part, the max stays -inf and the state (0, 0) is kept.  The
// caller brackets the tile with __syncthreads(): after staging, and before
// the buffer refills.
template <typename T, int DH, typename Score>
__device__ __forceinline__ void decode_tile(
    const T* Kt, const T* Vt, const float* Qs, float* Ss, float* Ms,
    float* Ls, float* Sc, float2 (&acc)[dec::MAXR<DH>], int group, int tid,
    Score score) {
  using namespace dec;
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int CHUNKS = DH / VEC;                // chunks per K/V row
  constexpr int NP = DH / 2;                      // dim pairs per q head
  static_assert(CHUNKS % SUB == 0, "a K row must split over SUB lanes");
  static_assert(BC == 32, "the softmax takes one lane per row");
  const int lane = tid & 31, warp = tid >> 5;

  // scores: SUB lanes per (q head, row), each reading 16-byte chunks of the
  // K row (odd rows rotated by SUB chunks, so the eight lanes of one
  // 128-byte shared-memory phase hit distinct banks), reduced with two
  // shuffles.  Every lane runs every pass (the pass count is rounded up to
  // whole passes), so the shuffles are uniform
  const int sub = tid % SUB;
  const int n_pairs = group * BC;
  const int pass_end = (n_pairs + NT / SUB - 1) / (NT / SUB) * (NT / SUB);
  for (int pair = tid / SUB; pair < pass_end; pair += NT / SUB) {
    const int g = min(pair, n_pairs - 1) / BC, c = pair % BC;
    const T* krow = Kt + c * DH;
    const float* qrow = Qs + g * DH;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS / SUB; ++j) {     // independent chunk sums
      const int ch = (j * SUB + sub + (c & 1) * SUB) % CHUNKS;
      float kx[VEC];
      chunk_to_f32(krow + ch * VEC, kx);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part = fmaf(qrow[ch * VEC + e], kx[e], part);
      dot += part;
    }
#pragma unroll
    for (int off = 1; off < SUB; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && pair < n_pairs) Ss[pair] = score(c, dot);
  }
  __syncthreads();

  // online softmax: one warp per q head, one lane per row
  for (int g = warp; g < group; g += NT / 32) {
    const float s = Ss[g * BC + lane];
    const float m_prev = Ms[g];
    const float m_new = fmaxf(m_prev, warp_max(s));
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float p = s == -CUDART_INF_F ? 0.f : expf(s - m_use);
    const float sum = warp_sum(p);
    Ss[g * BC + lane] = p;
    if (lane == 0) {
      const float scale = expf(m_prev - m_use);
      Ls[g] = Ls[g] * scale + sum;
      Ms[g] = m_new;
      Sc[g] = scale;
    }
  }
  __syncthreads();

  // acc = acc * scale + P V; the V rows of rows that take no part are
  // zeros and their p is 0
#pragma unroll
  for (int r = 0; r < MAXR<DH>; ++r) {
    const int idx = tid + NT * r;
    if (idx < group * NP) {
      const int g = idx / NP, d = 2 * (idx % NP);
      const float scale = Sc[g];
      float2 a[2] = {make_float2(acc[r].x * scale, acc[r].y * scale),
                     make_float2(0.f, 0.f)};      // even and odd rows
#pragma unroll 8
      for (int c = 0; c < BC; ++c) {
        const float p = Ss[g * BC + c];
        const float2 vv = pair_to_f32(Vt + c * DH + d);
        a[c & 1].x = fmaf(p, vv.x, a[c & 1].x);
        a[c & 1].y = fmaf(p, vv.y, a[c & 1].y);
      }
      acc[r] = make_float2(a[0].x + a[1].x, a[0].y + a[1].y);
    }
  }
}

// The split's unnormalised partials: acc at part_acc (B, H, n_split, DH)
// and (m, l) at part_ml (B, H, n_split, 2); row0 is the (batch row, first
// q head of the kv head, split) row of both
template <int DH>
__device__ __forceinline__ void decode_write_partials(
    const float2 (&acc)[dec::MAXR<DH>], const float* Ms, const float* Ls,
    float* __restrict__ part_acc, float* __restrict__ part_ml, long long row0,
    int n_split, int group, int tid) {
  constexpr int NP = DH / 2;
#pragma unroll
  for (int r = 0; r < dec::MAXR<DH>; ++r) {
    const int idx = tid + dec::NT * r;
    if (idx < group * NP) {
      const int g = idx / NP, d = 2 * (idx % NP);
      *reinterpret_cast<float2*>(part_acc + (row0 + (long long)g * n_split) * DH + d) = acc[r];
    }
  }
  for (int g = tid; g < group; g += dec::NT) {
    part_ml[(row0 + (long long)g * n_split) * 2] = Ms[g];
    part_ml[(row0 + (long long)g * n_split) * 2 + 1] = Ls[g];
  }
}

// The body of the decode merge passes: one block of DH threads per (q
// head, batch row), one dim each, merging the row's splits (merge_splits)
// into q's dtype.  The kernels are launched as programmatic dependents of
// their split pass, so griddepcontrol.wait holds the block until the
// partials are complete and visible.
template <typename T>
__device__ __forceinline__ void decode_merge(const float* __restrict__ part_acc,
                                             const float* __restrict__ part_ml,
                                             T* __restrict__ o, int H, int DH,
                                             int n_split) {
  extern __shared__ float w[];        // n_split weights, then the denominator
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long row = (long long)b * H + h;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  o[row * DH + d] = from_f32<T>(
      merge_splits(part_acc, part_ml, row * n_split, n_split, DH, d, w));
}

// reductions over the 16 lanes that share one ty (lanes 0-15 or 16-31)
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

// ---------------------------------------------------------------------------
// The tiled online softmax of the prefill-shaped kernels.
//
// One block of TILE_NT threads, a 16 x 16 grid, owns BQ query rows of one
// head.  Thread (ty, tx) owns the score entries (rows ty + 16 i, cols
// tx + 16 j), i, j < 4, and the output entries (rows ty + 16 i, dims
// tx + 16 j), j < DH / 16: its rows are the same in both products, so the
// rescale stays in registers.  Row max and sum reduce over the 16 tx lanes.
// Q, K, V and P tiles are staged in shared memory as f32; Q and K rows are
// padded by one word so the column walks hit distinct banks.  Operands are
// read in the model layout (B, S, H or Hkv, DH); rows >= Sq are loaded as 0
// and never written, cols >= S are staged as 0 and left to the mask.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per k-tile
constexpr int TILE_NT = 256;        // threads per block (16 x 16)

template <int DH>
constexpr size_t tile_smem_bytes() {
  // Q (BQ x DH+1), K (BK x DH+1), V (BK x DH), P (BQ x BK+1)
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

// the block's shared-memory tiles, carved from the dynamic allocation
template <int DH>
struct Tiles {
  float* Qs;
  float* Ks;
  float* Vs;
  float* Ps;
  __device__ __forceinline__ explicit Tiles(float* smem)
      : Qs(smem), Ks(smem + BQ * (DH + 1)), Vs(Ks + BK * (DH + 1)), Ps(Vs + BK * DH) {}
};

// the online-softmax state of one thread's 4 rows
template <int DH>
struct RowState {
  float m[4], l[4], acc[4][DH / 16];
  __device__ __forceinline__ RowState() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) acc[i][j] = 0.f;
    }
  }
};

// stage query rows [row0, row0 + BQ) of head h
template <typename T, int DH>
__device__ __forceinline__ void load_q_tile(
    const T* __restrict__ q, int b, int Sq, int H, int h, int row0, float* Qs,
    int tid) {
  constexpr int LD = DH + 1;
  for (int idx = tid; idx < BQ * DH; idx += TILE_NT) {
    const int r = idx / DH, d = idx % DH, row = row0 + r;
    Qs[r * LD + d] = row < Sq
        ? to_f32(q[(((long long)b * Sq + row) * H + h) * DH + d]) : 0.f;
  }
}

// stage k-tile [k_lo, k_lo + BK) of kv head hk of one (B, S, Hkv, DH) pair
template <typename T, int DH>
__device__ __forceinline__ void stage_kv(
    const T* __restrict__ k, const T* __restrict__ v, int b, int S, int Hkv,
    int hk, int k_lo, float* Ks, float* Vs, int tid) {
  constexpr int LD = DH + 1;
  for (int idx = tid; idx < BK * DH; idx += TILE_NT) {
    const int r = idx / DH, d = idx % DH, col = k_lo + r;
    float kv = 0.f, vv = 0.f;
    if (col < S) {
      const long long off = (((long long)b * S + col) * Hkv + hk) * DH + d;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    Ks[r * LD + d] = kv;
    Vs[r * DH + d] = vv;
  }
}

// one staged k-tile through the online softmax: S = Q K^T / sqrt(DH), masked
// to NEG_INF where attend(row, col) is false (row = q_lo + the tile row, col
// = k_lo + the tile col), then P V into the state.  The caller brackets the
// staging with __syncthreads(); the one between P and P V is here.
template <int DH, typename Attend>
__device__ __forceinline__ void online_tile(
    const Tiles<DH>& t, int tx, int ty, int k_lo, int q_lo, float sm,
    Attend attend, RowState<DH>& st) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  constexpr int LP = BK + 1;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = t.Qs[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = t.Ks[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k_lo + tx + 16 * j;
      s[i][j] = attend(row, col) ? s[i][j] / sm : NEG_INF;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(st.m[i], max16(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m_new);
      sum += s[i][j];
    }
    const float scale = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * scale + sum16(sum);
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) st.acc[i][j] *= scale;
#pragma unroll
    for (int j = 0; j < 4; ++j) t.Ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
  }
  __syncthreads();

#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = t.Ps[(ty + 16 * i) * LP + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float vv = t.Vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[i][j] = fmaf(p[i], vv, st.acc[i][j]);
    }
  }
}

// write the normalised rows [row0, row0 + BQ) of head h that lie below Sq
template <typename T, int DH>
__device__ __forceinline__ void store_rows(
    T* __restrict__ o, int b, int Sq, int H, int h, int row0, int tx, int ty,
    const RowState<DH>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
    T* dst = o + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dst[tx + 16 * j] = from_f32<T>(st.acc[i][j] / denom);
  }
}

}  // namespace attn
