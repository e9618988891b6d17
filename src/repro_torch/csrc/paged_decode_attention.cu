// Paged decode attention for Hopper, sm_90a: the page table split across
// blocks (flash-decoding), then a merge pass.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py:
// paged_decode_attention_kernel (body _paged_dec_kernel): one new query
// token per slot attends to K/V scattered over a shared pool of fixed-size
// pages, (n_pages + 1, page_size, Hkv, dh) with a trash page at n_pages.
// Paged placement is position-indexed (logical page j, offset o IS absolute
// position j * page_size + o), so a key is attended iff its page is mapped
// and its position is <= cur_pos; no per-token pos array exists.
//
// What bounds it on the H100: bytes.  Each mapped K/V row is read once per
// token and used for only `group` multiply-adds (2 on qwen3-0.6b): at the
// serving path's shapes (B=8, H=16, Hkv=8, dh=128, page_size=16, up to 21
// pages a slot, bf16) a call reads ~10 MB of pages (~3 us at 3.35 TB/s)
// against ~5 MFLOP.  What the design removes is latency: the first port
// ran one block per (kv head, slot), 64 blocks on 132 SMs, each warp
// walking its pages with 8-byte loads and a 5-shuffle reduction a score.
//
// Design (the dense decode kernel's split pass, decode_attention.cu, over
// pages instead of ring slots):
// * The TPU grid (B, Hkv, max_pages) carries (m, l, acc) across its
//   sequential page axis.  Here pass 1, paged_decode_split_kernel, runs a
//   grid (n_split, Hkv, B): each block owns a contiguous run of
//   pages_per_split table entries of one (kv head, slot) and writes the
//   unnormalised (m, l, acc) of all `group` q heads of its kv head to f32
//   scratch the wrapper allocates, in the dense decode's layout: acc
//   (B, H, n_split, dh), (m, l) (B, H, n_split, 2).  The wrapper's
//   plan_page_splits fills ~2 x 132 blocks and gives every split at least
//   one table entry (6 splits of 4 pages at the serving shape, 384 blocks).
//   Pass 2, paged_decode_merge_kernel, one block of dh threads per (q head,
//   slot), merges the splits (merge_splits) and writes q's dtype; it is a
//   programmatic dependent launch, so its launch overlaps pass 1's tail.
// * The block reads its slot's table row once: every thread scans a
//   stride of it for an attendable position (__syncthreads_or gives the
//   block has_valid) and keeps the block's own entries in shared memory.
//   Entries outside [0, n_pages) (the -1 of an unmapped page) read the
//   trash page, the mapping the reference's wrapper does before its
//   kernel; the raw table goes in, so there is no sanitising launch.
// * Key rows are staged in tiles of 32 (two pages of 16; pages of 4 or 8
//   fill a tile with several, a page of 64 spans two) in their own dtype by
//   16-byte cp.async, double-buffered so tile t + 1 loads while tile t
//   computes; row r of a tile reads pool row table[b, j] * page_size + o.
//   Each row carries a code: VALID (attended), MASKED (walked at -1e30) or
//   PAD (takes no part: not loaded, score -inf, weight 0).
// * Products on the CUDA cores in f32, through the dense decode's tile
//   step (attn_common.cuh's decode_tile; the row codes become its scores):
//   four lanes per (q head, row) dot on 16-byte chunks with the bank
//   rotation, one warp per q head for the softmax, (q head, dim pair)
//   accumulators in registers.  P stays f32, so the tolerances are the
//   plain version's.  With one query row per q head, mma tiles padded to
//   16 rows would waste 7/8 of each product.
//
// Masking is the reference's, bit for bit.  has_valid: the slot attends to
// some position (a mapped page j with j * page_size <= cur_pos), over the
// whole table row.
// * has_valid: a row is VALID iff its page is mapped and its position is
//   <= cur_pos, else PAD.  In ref.py such a row scores -1e30 and weighs
//   e^(-1e30 - m*) = 0 exactly, m* being a real score, so skipping it
//   changes no bit and saves its bytes.  Tiles past the last page that can
//   hold a VALID row are not walked.  A split with no VALID row (its pages
//   unmapped or past cur_pos) saw no key: m = -inf, l = 0, acc = 0, and
//   merge_splits gives it weight 0.
// * not has_valid: every row of every entry is MASKED, the trash page
//   included, so every split carries m = -1e30 (the same bits everywhere),
//   l = its count of rows and acc = the sum of their V rows; the merge
//   weighs each split 1 and gives the mean of V over all max_pages *
//   page_size gathered rows, as ref.py's softmax over that many columns of
//   -1e30 does (the argument of decode_attention.cu).

#include <math_constants.h>

#include "attn_common.cuh"

namespace {

using namespace attn;
// tiles of BC = 32 key rows, NT = 256 threads a block of the split pass, at
// most MAX_GROUP = 16 q heads per kv head
using namespace attn::dec;

constexpr int KEY_PAD = -2;             // row code: takes no part (weight 0)
constexpr int KEY_MASKED = -1;          // row code: walked at -1e30
constexpr int KEY_VALID = 0;            // row code: attended

template <typename T, int DH>
constexpr size_t split_smem_bytes(int group, int pages_per_split) {
  // K and V (2 buffers x BC x DH each), Qs (group x DH), Ss (group x BC),
  // Ms, Ls, Sc (group each), row codes (2 x BC), the split's table entries
  return sizeof(T) * (size_t)(4 * BC * DH)
       + sizeof(float) * (size_t)(group * DH + group * BC + 3 * group)
       + sizeof(int) * (size_t)(2 * BC + pages_per_split);
}

// Stage tile t of a split's key rows into buffer buf by cp.async, with each
// row's code: PAD rows (past the split's keys, or skipped) are zero-filled
// and never read from memory; a MASKED row of an unmapped entry reads the
// trash page.
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(
    T* Ks, T* Vs, int* Codes, const int* Tab, const T* kb, const T* vb, int t,
    int buf, int n_keys, int ps, int n_pages, bool has_valid, int p_begin,
    int cur_b, long long row_stride, int tid) {
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int CHUNKS = DH / VEC;                // chunks per K/V row
  for (int idx = tid; idx < BC * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    const int key = t * BC + r;
    int code = KEY_PAD;
    long long row = 0;                            // pool row: page * ps + o
    if (key < n_keys) {
      const int jj = key / ps, o = key % ps;
      const int pid = Tab[jj];
      const bool mapped = pid >= 0 && pid < n_pages;
      if (!has_valid) {
        code = KEY_MASKED;
        row = (long long)(mapped ? pid : n_pages) * ps + o;
      } else if (mapped && (long long)(p_begin + jj) * ps + o <= cur_b) {
        code = KEY_VALID;
        row = (long long)pid * ps + o;
      }
    }
    const bool in = code != KEY_PAD;
    const long long off = row * row_stride + ch * VEC;
    const int dst = (buf * BC + r) * DH + ch * VEC;
    cp_async16(Ks + dst, kb + off, in);
    cp_async16(Vs + dst, vb + off, in);
    if (ch == 0) Codes[buf * BC + r] = code;
  }
  cp_async_commit();
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ cur,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int Hkv,
    int n_pages, int ps, int max_pages, int pages_per_split) {
  const int group = H / Hkv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);         // [2][BC][DH]
  T* Vs = Ks + 2 * BC * DH;                       // [2][BC][DH]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * BC * DH);   // [group][DH]
  float* Ss = Qs + group * DH;                    // [group][BC] scores, then p
  float* Ms = Ss + group * BC;                    // running max per q head
  float* Ls = Ms + group;                         // running sum per q head
  float* Sc = Ls + group;                         // this tile's rescale
  int* Codes = reinterpret_cast<int*>(Sc + group);   // [2][BC] row codes
  int* Tab = Codes + 2 * BC;                      // [pages_per_split] entries

  // the merge pass may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int p_begin = split * pages_per_split;
  const int p_end = min(max_pages, p_begin + pages_per_split);
  const int cur_b = cur[b];
  const int* trow = table + (long long)b * max_pages;

  // the table row, read once: has_valid over all of it, this split's
  // entries kept
  int any = 0;
  for (int j = tid; j < max_pages; j += NT) {
    const int pid = trow[j];
    any |= (pid >= 0 && pid < n_pages && (long long)j * ps <= cur_b) ? 1 : 0;
    if (j >= p_begin && j < p_end) Tab[j - p_begin] = pid;
  }
  const T* qb = q + ((long long)b * H + (long long)hk * group) * DH;
  for (int idx = tid; idx < group * DH; idx += NT) Qs[idx] = to_f32(qb[idx]);
  for (int g = tid; g < group; g += NT) {
    Ms[g] = -CUDART_INF_F;                        // no key seen yet
    Ls[g] = 0.f;
  }
  const bool has_valid = __syncthreads_or(any) != 0;   // Tab, Qs visible

  // with has_valid, no page past cur_b's holds a VALID row
  const int p_last = has_valid ? min(p_end, cur_b / ps + 1) : p_end;
  const int n_keys = max(0, p_last - p_begin) * ps;
  const int n_tiles = (n_keys + BC - 1) / BC;
  const float sm = sqrtf((float)DH);
  const long long row_stride = (long long)Hkv * DH;
  const T* kb = kp + (long long)hk * DH;
  const T* vb = vp + (long long)hk * DH;

  float2 acc[MAXR<DH>];
#pragma unroll
  for (int r = 0; r < MAXR<DH>; ++r) acc[r] = make_float2(0.f, 0.f);

  if (n_tiles > 0)
    stage_tile<T, DH>(Ks, Vs, Codes, Tab, kb, vb, 0, 0, n_keys, ps, n_pages,
                      has_valid, p_begin, cur_b, row_stride, tid);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage_tile<T, DH>(Ks, Vs, Codes, Tab, kb, vb, t + 1, buf ^ 1, n_keys, ps,
                        n_pages, has_valid, p_begin, cur_b, row_stride, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile t and its codes visible
    const int* codes = Codes + buf * BC;
    decode_tile<T, DH>(Ks + buf * BC * DH, Vs + buf * BC * DH, Qs, Ss, Ms, Ls,
                       Sc, acc, group, tid, [&](int c, float dot) {
      const int code = codes[c];
      return code == KEY_PAD ? -CUDART_INF_F
                             : (code == KEY_VALID ? dot / sm : NEG_INF);
    });
    __syncthreads();                  // readers done before the buffer refills
  }

  // m = -inf, l = 0, acc = 0 where the split saw no key
  decode_write_partials<DH>(
      acc, Ms, Ls, part_acc, part_ml,
      ((long long)b * H + (long long)hk * group) * n_split + split, n_split,
      group, tid);
}

// pass 2: one block of dh threads per (q head, slot), merging the splits
// (attn_common.cuh's decode_merge); a kernel of its own name, so a trace
// tells it from the dense decode's merge
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          T* __restrict__ o, int H, int DH,
                                          int n_split) {
  decode_merge(part_acc, part_ml, o, H, DH, n_split);
}

struct Args {
  const void *q, *k, *v, *table, *cur;
  void *part_acc, *part_ml, *o;
  int B, H, Hkv, n_pages, ps, max_pages, n_split, pages_per_split;
};

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  // once per instantiation (the port drives one card): the opt-in maximum,
  // since the split's table entries size the block's shared memory
  static const cudaError_t attr = [] {
    int dev = 0, max_smem = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_decode_split_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  paged_decode_split_kernel<T, DH><<<
      dim3(a.n_split, a.Hkv, a.B), NT,
      split_smem_bytes<T, DH>(a.H / a.Hkv, a.pages_per_split), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.table),
      static_cast<const int*>(a.cur), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.H, a.Hkv, a.n_pages, a.ps,
      a.max_pages, a.pages_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dependent(paged_decode_merge_kernel<T>, dim3(a.H, a.B),
                          dim3(DH), sizeof(float) * (size_t)(a.n_split + 1),
                          stream, static_cast<const float*>(a.part_acc),
                          static_cast<const float*>(a.part_ml),
                          static_cast<T*>(a.o), a.H, (int)DH, a.n_split);
}

template <typename T>
int launch_dh(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc: f32 (B, H, n_split, dh) and part_ml: f32 (B, H, n_split, 2),
// scratch the caller allocates; splits of pages_per_split table entries,
// each holding at least one
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* cur, void* part_acc, void* part_ml, void* o, int B, int H,
    int Hkv, int dh, int n_pages, int page_size, int max_pages, int n_split,
    int pages_per_split, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > MAX_GROUP || n_pages < 1 ||
      page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (n_split < 1 || pages_per_split < 1
      || (long long)(n_split - 1) * pages_per_split >= max_pages
      || (long long)n_split * pages_per_split < max_pages)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, table, cur, part_acc, part_ml, o, B, H, Hkv,
               n_pages, page_size, max_pages, n_split, pages_per_split};
  if (is_bf16) return launch_dh<__nv_bfloat16>(a, dh, s);
  return launch_dh<float>(a, dh, s);
}
