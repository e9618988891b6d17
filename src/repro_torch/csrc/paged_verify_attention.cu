// Paged multi-query (draft-verify) attention for Hopper, sm_90a.
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
// bound it.
//
// Design (the paged decode kernel's, with W * group query rows):
// * One block of 8 warps per (kv head, slot).  Warp w takes pages w, w + 8,
//   ... and keeps an f32 online softmax in registers for all the block's
//   query rows; the 8 partial states merge in shared memory at the end.
//   The TPU grid carried (m, l, acc) across its sequential page axis; here
//   the page axis is split over the warps instead.
// * Query rows are window-major, row r = w * group + h (the reference's
//   order), and are read straight from the model layout (B, W, H, dh):
//   row r of kv head kh is q[b, r / group, kh * group + r % group].  The
//   reference's wrapper transposes q into that order and back; here the
//   indexing does it, so no transpose is launched.
// * Lane l owns dims [l * dh/32, (l+1) * dh/32) of every row: a K or V row
//   is one coalesced load, the q.k dot a 5-step shuffle reduction, and each
//   page row loaded into registers is reused by every query row.  RB (a
//   compile-time bound on W * group: 8, 16 or 32) sizes the register
//   arrays; more rows are refused.
// * Masking is the reference's, bit for bit.  Masked scores are -1e30.  The
//   rows' valid key sets are nested (row r sees every key row r' sees when
//   r / group >= r' / group), so when row 0 has an attendable key every row
//   has one, and a page with no key attendable by the LAST row changes no
//   bit of any row (its weights are exp(-1e30 - m) = 0): such pages are
//   skipped.  Otherwise every page is walked at -1e30, so a row with no
//   valid key averages V over all max_pages * page_size gathered rows,
//   trash included, as the plain version does.  Table entries outside
//   [0, n_pages) read the trash page in the kernel.
// * Shortfall, left for a later version: B * Hkv blocks (64 on the serving
//   path, on 132 SMs), and the W * group-row products run as shuffled f32
//   FMAs on the CUDA cores, not as mma on the tensor cores.

#include <math_constants.h>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int NW = 8;           // warps per block
constexpr int NT = NW * 32;     // threads per block
constexpr int MAX_ROWS = 32;    // largest W * group the kernel takes

template <int DH, int RB>
size_t smem_bytes() {
  // q (RB x DH) and the warps' partial accumulators (NW x RB x DH)
  return sizeof(float) * (size_t)(RB * DH + NW * RB * DH);
}

template <typename T, int DH, int RB, int R>
__global__ void __launch_bounds__(NT) paged_verify_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ cur, T* __restrict__ o,
    int W, int H, int Hkv, int n_pages, int ps, int max_pages) {
  constexpr int DPL = DH / 32;                  // dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                             // RB x DH
  float* As = Qs + RB * DH;                     // NW x RB x DH partial acc
  __shared__ float Ms[NW][RB], Ls[NW][RB];      // partial max and sum

  const int group = H / Hkv;
  const int rows = W * group;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur_b = cur[b];
  const int* trow = table + (long long)b * max_pages;
  const float sm = sqrtf((float)DH);

  // row r = w * group + g reads q[b, w, hk * group + g, :]
  for (int idx = tid; idx < rows * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    const int w = r / group, g = r % group;
    Qs[idx] = to_f32(q[(((long long)b * W + w) * H + (long long)hk * group + g) * DH + d]);
  }

  // does row 0 (position cur) attend to any key: a mapped page j, j*ps <= cur
  int any = 0;
  for (int j = lane; j < max_pages; j += 32) {
    const int pid = trow[j];
    any |= (pid >= 0 && pid < n_pages && (long long)j * ps <= cur_b) ? 1 : 0;
  }
  const bool has_valid = __any_sync(0xffffffffu, any) != 0;
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
  for (int j = warp; j < max_pages; j += NW) {
    const int pid = trow[j];
    const bool mapped = pid >= 0 && pid < n_pages;
    // warp-uniform skip of a page no row attends to (exact, see above)
    if (has_valid && !(mapped && (long long)j * ps <= last_pos)) continue;
    const long long page = mapped ? pid : n_pages;          // trash page
    const T* kb = kp + page * page_stride + (long long)hk * DH + lane * DPL;
    const T* vb = vp + page * page_stride + (long long)hk * DH + lane * DPL;
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

  // merge the NW partial states; a warp that took no page has m = -inf
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
  for (int idx = tid; idx < rows * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH;
    float mmax = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) mmax = fmaxf(mmax, Ms[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = Ms[w][r];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - mmax);
      num = fmaf(wt, As[(w * RB + r) * DH + d], num);
      den = fmaf(wt, Ls[w][r], den);
    }
    const int w = r / group, g = r % group;
    o[(((long long)b * W + w) * H + (long long)hk * group + g) * DH + d] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int RB>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* cur, void* o, int B, int W, int H, int Hkv, int n_pages,
           int ps, int max_pages, cudaStream_t stream) {
  // page rows held in registers at a time: fewer at 32 query rows, where
  // the row states already take most of a thread's registers
  constexpr int R = RB >= 32 ? 4 : 8;
  const size_t smem = smem_bytes<DH, RB>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_kernel<T, DH, RB, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_verify_kernel<T, DH, RB, R><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(table), static_cast<const int*>(cur),
      static_cast<T*>(o), W, H, Hkv, n_pages, ps, max_pages);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(const void* q, const void* k, const void* v, const void* table,
                const void* cur, void* o, int B, int W, int H, int Hkv,
                int n_pages, int ps, int max_pages, cudaStream_t stream) {
  const int rows = W * (H / Hkv);
  if (rows <= 8)
    return launch<T, DH, 8>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
  if (rows <= 16)
    return launch<T, DH, 16>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
  return launch<T, DH, 32>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* table,
              const void* cur, void* o, int B, int W, int H, int Hkv, int dh,
              int n_pages, int ps, int max_pages, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_rows<T, 32>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
    case 64: return launch_rows<T, 64>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
    case 128: return launch_rows<T, 128>(q, k, v, table, cur, o, B, W, H, Hkv, n_pages, ps, max_pages, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* cur, void* o, int B, int W, int H, int Hkv, int dh,
    int n_pages, int page_size, int max_pages, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || W < 1 || W * (H / Hkv) > MAX_ROWS ||
      n_pages < 1 || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, table, cur, o, B, W, H, Hkv, dh,
                                    n_pages, page_size, max_pages, s);
  return launch_dh<float>(q, k, v, table, cur, o, B, W, H, Hkv, dh, n_pages,
                          page_size, max_pages, s);
}
