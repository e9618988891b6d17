// Paged multi-query (draft-verify) attention for Hopper, sm_90a: the page
// axis split across blocks (flash-decoding), then a merge pass.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py:
// paged_verify_attention_kernel (body _paged_verify_kernel): a window of W
// query tokens per slot, at absolute positions cur_pos + [0, W), attends to
// K/V scattered over the shared page pool (n_pages + 1, page_size, Hkv, dh)
// with the trash page at n_pages.  The window's own K/V is already in the
// pool (the caller writes it first).  Query w attends a key iff the key's
// page is mapped and its position is <= cur_pos + w, which is also the
// causality inside the window.
//
// What bounds it on the H100: bytes.  Each mapped K/V row is read once per
// window and used for W * group multiply-adds (8 on the speculative path of
// qwen3-0.6b, W = 4, group 2): at B=8, H=16, Hkv=8, dh=128, page_size=16,
// windows at positions 256..321, bf16, a call must move ~9.9 MB of q, out
// and the K/V rows the windows attend (~2.9 us at 3.35 TB/s) against ~76
// MFLOP, far below the ~295 operations a byte where the tensor cores would
// bound it.  What the design removes is instruction latency: one block per
// (kv head, slot) (64 on 132 SMs) and a 5-shuffle reduction per score.
//
// Design:
// * The TPU grid (B, Hkv, max_pages) carries (m, l, acc) across its
//   sequential page axis.  Here pass 1 runs a grid (n_split, Hkv, B): each
//   block owns a contiguous range of pages_per_split pages of one (kv head,
//   slot) and writes the unnormalised (m, l, acc) of all W * group query
//   rows to f32 scratch the wrapper allocates (part_acc (B, Hkv, rows,
//   n_split, dh), part_ml (B, Hkv, rows, n_split, 2), m in units of
//   q.k / sqrt(dh)).  The wrapper's plan_page_splits fills ~2 x 132
//   blocks and gives every split at least one page of the table.  Pass 2,
//   paged_verify_merge_kernel, one block of dh threads per (row, kv head,
//   slot), merges the splits and writes q's dtype; it is a programmatic
//   dependent launch, so its launch overlaps pass 1's tail.
// * Query rows are window-major, row r = w * group + h (the reference's
//   order), read straight from the model layout (B, W, H, dh): row r of kv
//   head kh is q[b, r / group, kh * group + r % group].  The reference's
//   wrapper transposes q into that order and back; here the indexing does
//   it.  At most MAX_ROWS = 32 rows a kv head.
// * bf16, the serving path: paged_verify_mma_kernel, 4 warps.  Keys, not
//   rows, are split over the warps: a round stages 64 key rows (4 pages of
//   16) of K and V into shared memory by 16-byte cp.async, double-buffered
//   so round k + 1 loads while round k computes, and warp w takes keys
//   16 w .. 16 w + 15 of the round (one page of 16; pages of 4 or 8 fill a
//   tile with several).  The rows take the M side of mma.sync.m16n8k16
//   (attn_mma.cuh's MmaRows with 16-key tiles): Q as A fragments padded
//   with zero rows to 16 (or 32), S = Q K^T in f32 fragments, the online
//   softmax on the fragments, P rounded to bf16 as the A operand of P V,
//   V by ldmatrix.trans.  Keys on the M side would waste no rows at 8
//   query rows, but their softmax would reduce across lanes g and P V
//   would need P transposed between fragment layouts; at ~76 MFLOP a call
//   the wasted half of each mma costs nothing that shows.  The 4 warps'
//   states merge in shared memory (the staging buffers, reused) before
//   the block writes its partial.  The TPU kernel keeps p in f32 at
//   kernel.py:186 (v was cast to f32 at :164); rounding P adds ~2^-9
//   relative to each weight, inside the bf16 tolerance (2e-2), and l stays
//   the f32 sum of the unrounded p; a CPU test bounds it
//   (ref.paged_verify_attention_split_ref with round_p=True).
// * f32: paged_verify_f32_kernel keeps the CUDA-core products (no TF32)
//   but takes the split: 8 warps, warp w walks pages w, w + 8, ... of the
//   block's range, lane l owns dims [l * dh/32, (l+1) * dh/32) of every
//   row, K/V rows go straight to registers and each q.k dot is a 5-step
//   shuffle reduction; the warps merge in shared memory.
//
// Masking is the reference's, bit for bit.  Masked scores are -1e30.  The
// rows' valid key sets are nested (row r sees every key row r' sees when
// r / group >= r' / group), so when row 0 has an attendable key
// (has_valid) every row has one, and a page with no key attendable by the
// LAST row changes no bit of any row (its weights are exp(-1e30 - m) = 0):
// such pages are skipped.  Otherwise every page is walked at -1e30, so a
// row with no valid key averages V over all max_pages * page_size gathered
// rows, trash included, as the plain version does.  Table entries outside
// [0, n_pages) read the trash page.  Key rows of a skipped page, and past
// the split's last page, take no part at all (score -inf, weight 0).
//
// Why the merge reproduces ref.py in every case:
// * has_valid: every row's global max m* is a real score.  Inside a split,
//   masked keys weigh e^(-1e30 - m) = 0 once a real score is in the row's
//   max, and a split in which a row saw only masked keys carries
//   m = -1e30 and weighs e^(-1e30 - m*) = 0.  A split whose pages were all
//   skipped saw no key: it carries m = -inf, l = 0, acc = 0 and weighs 0.
//   Skipped pages weigh 0 in ref.py too, so the sums agree.
// * not has_valid: no page is skipped and every split holds a page, so
//   every split saw keys.  A row with a valid key (a later window row may
//   have one) is the case above.  A row with none scores -1e30 everywhere:
//   every split carries m = -1e30 (the same bits in every split), l = its
//   count of key rows and acc = the sum of their V rows, so the merge
//   weighs each split 1 and gives the mean of V over exactly the
//   max_pages * page_size gathered rows, as ref.py's softmax over that
//   many columns of -1e30 does.

#include <math_constants.h>

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace {

using namespace attn;

using bf16 = __nv_bfloat16;

constexpr int MAX_ROWS = 32;    // largest W * group the kernels take
constexpr int KEY_PAD = -2;     // key code: takes no part (weight 0)
constexpr int KEY_MASKED = -1;  // key code: an unmapped page walked at -1e30

// does row 0 (position cur) attend to any key: a mapped page j, j*ps <= cur
// (every lane of the warp gets the answer)
__device__ __forceinline__ bool row0_has_key(const int* __restrict__ trow,
                                             int max_pages, int n_pages,
                                             int ps, int cur, int lane) {
  int any = 0;
  for (int j = lane; j < max_pages; j += 32) {
    const int pid = trow[j];
    any |= (pid >= 0 && pid < n_pages && (long long)j * ps <= cur) ? 1 : 0;
  }
  return __any_sync(0xffffffffu, any) != 0;
}

// ---------------------------------------------------------------------------
// pass 1, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MW = 4;                 // warps per block
constexpr int MNT = MW * 32;          // threads per block
constexpr int KT = 16;                // keys a warp takes per round
constexpr int RK = MW * KT;           // keys staged per round

template <int DH, int MT>
constexpr size_t mma_split_smem_bytes() {
  // Q (16 MT rows), K and V (2 buffers x RK rows each), key codes (2 x RK);
  // after the loop the same bytes hold the warps' states for the merge
  constexpr size_t stage = sizeof(bf16) * (size_t)mma_ld<DH>() * (16 * MT + 4 * RK)
                         + sizeof(int) * 2 * RK;
  constexpr size_t merge = sizeof(float) * (size_t)MW * 16 * MT * (DH + 2);
  return stage > merge ? stage : merge;
}

template <int DH, int MT>
__global__ void __launch_bounds__(MNT) paged_verify_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ cur, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int W, int H, int Hkv, int n_pages, int ps,
    int max_pages, int pages_per_split) {
  constexpr int LD = mma_ld<DH>();
  constexpr int RP = 16 * MT;               // query rows padded to m-tiles
  constexpr int CH = DH / 8;                // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);              // [RP][LD]
  bf16* Ks = Qs + RP * LD;                                   // [2][RK][LD]
  bf16* Vs = Ks + 2 * RK * LD;                               // [2][RK][LD]
  int* Codes = reinterpret_cast<int*>(Vs + 2 * RK * LD);     // [2][RK]

  // the merge pass may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = H / Hkv, rows = W * group;
  const int cur_b = cur[b];
  const int* trow = table + (long long)b * max_pages;
  const int p_begin = split * pages_per_split;
  const int p_end = min(max_pages, p_begin + pages_per_split);
  const int n_keys = (p_end - p_begin) * ps;                 // the split's key rows
  const int n_rounds = (n_keys + RK - 1) / RK;
  const bool has_valid = row0_has_key(trow, max_pages, n_pages, ps, cur_b, lane);
  const long long last_pos = (long long)cur_b + W - 1;       // the last row's
  const long long row_stride = (long long)Hkv * DH;

  // Q: row r reads q[b, r / group, hk * group + r % group]; pad rows are 0
  for (int idx = tid; idx < RP * CH; idx += MNT) {
    const int r = idx / CH, ch = idx % CH;
    const bool in = r < rows;
    const int w = in ? r / group : 0, g = in ? r % group : 0;
    cp_async16(Qs + r * LD + ch * 8,
               q + (((long long)b * W + w) * H + (long long)hk * group + g) * DH + ch * 8,
               in);
  }

  // stage round `rd` (the split's keys rd * RK ..) into buffer `buf`: two
  // threads a key row, each copying every other 16-byte chunk of its K and
  // V rows; a key of a skipped page or past the split is zero-filled and
  // coded KEY_PAD, a walked unmapped page reads the trash page
  const auto stage = [&](int rd, int buf) {
    const int kr = tid >> 1, sub = tid & 1;
    const int key = rd * RK + kr;
    int code = KEY_PAD;
    long long row = 0;                      // pool row: page * ps + t
    if (key < n_keys) {
      const int j = p_begin + key / ps, t = key % ps;
      const int pid = trow[j];
      const bool mapped = pid >= 0 && pid < n_pages;
      if (!has_valid || (mapped && (long long)j * ps <= last_pos)) {
        code = mapped ? j * ps + t : KEY_MASKED;
        row = (long long)(mapped ? pid : n_pages) * ps + t;
      }
    }
    const bool in = code != KEY_PAD;
    const long long off = row * row_stride + (long long)hk * DH;
    bf16* kd = Ks + (buf * RK + kr) * LD;
    bf16* vd = Vs + (buf * RK + kr) * LD;
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const int ch = sub + 2 * i;
      cp_async16(kd + ch * 8, kp + off + ch * 8, in);
      cp_async16(vd + ch * 8, vp + off + ch * 8, in);
    }
    if (sub == 0) Codes[buf * RK + kr] = code;
  };

  if (n_rounds > 0) stage(0, 0);
  cp_async_commit();                        // with Q

  MmaRows<DH, KT> st[MT];
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  for (int rd = 0; rd < n_rounds; ++rd) {
    const int buf = rd & 1;
    if (rd + 1 < n_rounds) {
      stage(rd + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // round rd (and at first Q) visible
    if (rd == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) st[mt].load_q(Qs, mt, lane);
    }
    const int* codes = Codes + buf * RK + warp * KT;
    // warp-uniform: a tile of keys that all take no part is skipped
    if (__any_sync(0xffffffffu, lane < KT && codes[lane] != KEY_PAD)) {
      const auto score = [&](int row, int col, float s) {
        const int c = codes[col];
        if (c == KEY_PAD) return -CUDART_INF_F;
        return (c >= 0 && c <= cur_b + row / group) ? s : NEG_INF;
      };
      const bf16* kt = Ks + (buf * RK + warp * KT) * LD;
      const bf16* vt = Vs + (buf * RK + warp * KT) * LD;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        st[mt].step(kt, vt, 0, mt * 16 + (lane >> 2), scale_log2, score, lane);
    }
    __syncthreads();                        // readers done before the refill
  }
  cp_async_wait<0>();                       // Q still in flight when no round ran
  __syncthreads();

  // merge the 4 warps' states in shared memory (a warp that took no key
  // has m = NEG_INF, l = 0, acc = 0 and adds nothing), then write the
  // block's partial: m in units of q.k / sqrt(dh), -inf when no key was seen
  float* Racc = reinterpret_cast<float*>(smem_raw);          // [MW][RP][DH]
  float* Rm = Racc + MW * RP * DH;                           // [MW][RP]
  float* Rl = Rm + MW * RP;                                  // [MW][RP]
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * RP + mt * 16 + g4 + 8 * i;
      if (t4 == 0) {
        Rm[r] = st[mt].m[i];
        Rl[r] = st[mt].l[i];
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(Racc + r * DH + 8 * j + 2 * t4) =
            make_float2(st[mt].o[j][2 * i], st[mt].o[j][2 * i + 1]);
    }
  __syncthreads();
  const float sm = sqrtf((float)DH);
  for (int idx = tid; idx < rows * DH; idx += MNT) {
    const int r = idx / DH, d = idx % DH;
    float mx = Rm[r];
#pragma unroll
    for (int w = 1; w < MW; ++w) mx = fmaxf(mx, Rm[w * RP + r]);
    const float mx_scaled = __fmul_rn(mx, scale_log2);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      const float wt = exp2f(__fmul_rn(Rm[w * RP + r], scale_log2) - mx_scaled);
      num = fmaf(wt, Racc[(w * RP + r) * DH + d], num);
      den = fmaf(wt, Rl[w * RP + r], den);
    }
    const long long prow = (((long long)b * Hkv + hk) * rows + r) * n_split + split;
    part_acc[prow * DH + d] = num;
    if (d == 0) {
      part_ml[prow * 2] = den > 0.f ? mx / sm : -CUDART_INF_F;
      part_ml[prow * 2 + 1] = den;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1, f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FW = 8;                 // warps per block
constexpr int FNT = FW * 32;          // threads per block

template <int DH, int RB>
constexpr size_t f32_split_smem_bytes() {
  // q (RB x DH) and the warps' partial accumulators (FW x RB x DH)
  return sizeof(float) * (size_t)(RB * DH + FW * RB * DH);
}

template <int DH, int RB, int R>
__global__ void __launch_bounds__(FNT) paged_verify_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ cur, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int W, int H, int Hkv, int n_pages, int ps,
    int max_pages, int pages_per_split) {
  constexpr int DPL = DH / 32;                  // dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                             // RB x DH
  float* As = Qs + RB * DH;                     // FW x RB x DH partial acc
  __shared__ float Ms[FW][RB], Ls[FW][RB];      // partial max and sum

  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int group = H / Hkv;
  const int rows = W * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur_b = cur[b];
  const int* trow = table + (long long)b * max_pages;
  const int p_begin = split * pages_per_split;
  const int p_end = min(max_pages, p_begin + pages_per_split);
  const float sm = sqrtf((float)DH);

  // row r = w * group + g reads q[b, w, hk * group + g, :]
  for (int idx = tid; idx < rows * DH; idx += FNT) {
    const int r = idx / DH, d = idx % DH;
    const int w = r / group, g = r % group;
    Qs[idx] = q[(((long long)b * W + w) * H + (long long)hk * group + g) * DH + d];
  }
  const bool has_valid = row0_has_key(trow, max_pages, n_pages, ps, cur_b, lane);
  const long long last_pos = (long long)cur_b + W - 1;   // the last row's
  __syncthreads();                              // Qs is complete

  float m[RB], l[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -CUDART_INF_F;                       // no key seen yet
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }

  const long long row_stride = (long long)Hkv * DH;
  const long long page_stride = (long long)ps * row_stride;
  for (int j = p_begin + warp; j < p_end; j += FW) {
    const int pid = trow[j];
    const bool mapped = pid >= 0 && pid < n_pages;
    // warp-uniform skip of a page no row attends to (exact, see above)
    if (has_valid && !(mapped && (long long)j * ps <= last_pos)) continue;
    const long long page = mapped ? pid : n_pages;          // trash page
    const float* kb = kp + page * page_stride + (long long)hk * DH + lane * DPL;
    const float* vb = vp + page * page_stride + (long long)hk * DH + lane * DPL;
    for (int t0 = 0; t0 < ps; t0 += R) {
      float kf[R][DPL], vf[R][DPL];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        if (t0 + t < ps) {
          load_f32<DPL>(kb + (t0 + t) * row_stride, kf[t]);
          load_f32<DPL>(vb + (t0 + t) * row_stride, vf[t]);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) kf[t][d] = vf[t][d] = 0.f;
        }
      }
      const int key0 = j * ps + t0;             // position of page row t0
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {                         // uniform across the block
          const int qpos = cur_b + r / group;
          float qv[DPL];
#pragma unroll
          for (int d = 0; d < DPL; ++d) qv[d] = Qs[r * DH + lane * DPL + d];
          float s[R];
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            float part = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) part = fmaf(qv[d], kf[t][d], part);
            const float dot = warp_sum(part);
            const bool valid = mapped && key0 + t <= qpos;
            // rows past the page do not exist: -inf gives them weight 0
            s[t] = t0 + t >= ps ? -CUDART_INF_F : (valid ? dot / sm : NEG_INF);
            mx = fmaxf(mx, s[t]);
          }
          const float m_new = fmaxf(m[r], mx);  // finite: row t0 exists
          const float scale = expf(m[r] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            s[t] = expf(s[t] - m_new);
            sum += s[t];
          }
          l[r] = l[r] * scale + sum;
          m[r] = m_new;
#pragma unroll
          for (int d = 0; d < DPL; ++d) {
            float a = acc[r][d] * scale;
#pragma unroll
            for (int t = 0; t < R; ++t) a = fmaf(s[t], vf[t][d], a);
            acc[r][d] = a;
          }
        }
      }
    }
  }

  // merge the FW warps' states into the block's partial; a warp that took
  // no page has m = -inf and weighs 0, and so does the block if none did
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < rows) {
      if (lane == 0) {
        Ms[warp][r] = m[r];
        Ls[warp][r] = l[r];
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        As[(warp * RB + r) * DH + lane * DPL + d] = acc[r][d];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * DH; idx += FNT) {
    const int r = idx / DH, d = idx % DH;
    float mmax = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < FW; ++w) mmax = fmaxf(mmax, Ms[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < FW; ++w) {
      const float mw = Ms[w][r];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - mmax);
      num = fmaf(wt, As[(w * RB + r) * DH + d], num);
      den = fmaf(wt, Ls[w][r], den);
    }
    const long long prow = (((long long)b * Hkv + hk) * rows + r) * n_split + split;
    part_acc[prow * DH + d] = num;
    if (d == 0) {
      part_ml[prow * 2] = mmax;
      part_ml[prow * 2 + 1] = den;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: merge the splits
// ---------------------------------------------------------------------------

// One block of dh threads per (query row, kv head, slot), one dim each,
// merging the splits (attn_common.cuh's merge_splits) and writing q's dtype
// to the model layout.  griddepcontrol.wait holds the block until pass 1's
// partials are complete and visible.
template <typename T>
__global__ void paged_verify_merge_kernel(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          T* __restrict__ o, int W, int H,
                                          int Hkv, int DH, int n_split) {
  extern __shared__ float w[];        // n_split weights, then the denominator
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int group = H / Hkv, rows = gridDim.x;
  const long long row0 = (((long long)b * Hkv + hk) * rows + r) * n_split;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float out = merge_splits(part_acc, part_ml, row0, n_split, DH, d, w);
  o[(((long long)b * W + r / group) * H + (long long)hk * group + r % group) * DH + d] =
      from_f32<T>(out);
}

template <typename T>
int launch_merge(const void* part_acc, const void* part_ml, void* o, int B,
                 int W, int H, int Hkv, int dh, int n_split, cudaStream_t stream) {
  return launch_dependent(paged_verify_merge_kernel<T>,
                          dim3(W * (H / Hkv), Hkv, B), dim3(dh),
                          sizeof(float) * (size_t)(n_split + 1), stream,
                          static_cast<const float*>(part_acc),
                          static_cast<const float*>(part_ml),
                          static_cast<T*>(o), W, H, Hkv, dh, n_split);
}

struct Args {
  const void *q, *k, *v, *table, *cur;
  void *part_acc, *part_ml, *o;
  int B, W, H, Hkv, n_pages, ps, max_pages, n_split, pages_per_split;
};

template <int DH, int MT>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_split_smem_bytes<DH, MT>();
  // once per instantiation (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_verify_mma_kernel<DH, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  paged_verify_mma_kernel<DH, MT><<<dim3(a.n_split, a.Hkv, a.B), MNT, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.table),
      static_cast<const int*>(a.cur), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.W, a.H, a.Hkv, a.n_pages, a.ps,
      a.max_pages, a.pages_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge<bf16>(a.part_acc, a.part_ml, a.o, a.B, a.W, a.H, a.Hkv,
                            DH, a.n_split, stream);
}

template <int DH, int RB>
int launch_f32(const Args& a, cudaStream_t stream) {
  // page rows held in registers at a time: fewer at 32 query rows, where
  // the row states already take most of a thread's registers
  constexpr int R = RB >= 32 ? 4 : 8;
  constexpr size_t smem = f32_split_smem_bytes<DH, RB>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_verify_f32_kernel<DH, RB, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  paged_verify_f32_kernel<DH, RB, R><<<dim3(a.n_split, a.Hkv, a.B), FNT, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.table),
      static_cast<const int*>(a.cur), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.W, a.H, a.Hkv, a.n_pages, a.ps,
      a.max_pages, a.pages_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge<float>(a.part_acc, a.part_ml, a.o, a.B, a.W, a.H, a.Hkv,
                             DH, a.n_split, stream);
}

template <int DH>
int launch_dh(const Args& a, int is_bf16, cudaStream_t stream) {
  const int rows = a.W * (a.H / a.Hkv);
  if (is_bf16) return rows <= 16 ? launch_bf16<DH, 1>(a, stream) : launch_bf16<DH, 2>(a, stream);
  if (rows <= 8) return launch_f32<DH, 8>(a, stream);
  if (rows <= 16) return launch_f32<DH, 16>(a, stream);
  return launch_f32<DH, 32>(a, stream);
}

}  // namespace

// part_acc: f32 (B, Hkv, W * H / Hkv, n_split, dh) and part_ml: f32
// (B, Hkv, W * H / Hkv, n_split, 2), scratch the caller allocates; splits
// of pages_per_split pages of the table, each holding at least one
extern "C" int repro_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* cur, void* part_acc, void* part_ml, void* o, int B, int W,
    int H, int Hkv, int dh, int n_pages, int page_size, int max_pages,
    int n_split, int pages_per_split, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || W < 1 || W * (H / Hkv) > MAX_ROWS ||
      n_pages < 1 || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (n_split < 1 || pages_per_split < 1
      || (long long)(n_split - 1) * pages_per_split >= max_pages
      || (long long)n_split * pages_per_split < max_pages)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, table, cur, part_acc, part_ml, o, B, W, H, Hkv,
               n_pages, page_size, max_pages, n_split, pages_per_split};
  switch (dh) {
    case 32: return launch_dh<32>(a, is_bf16, s);
    case 64: return launch_dh<64>(a, is_bf16, s);
    case 128: return launch_dh<128>(a, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
