// Paged decode attention for Hopper, sm_90a.
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
// against ~5 MFLOP.
//
// Design:
// * The page walk happens in the kernel: a block reads its slot's row of the
//   page table and loads only the mapped pages' rows for its kv head.  The
//   (B, max_pages * page_size, Hkv, dh) gather of the plain version is never
//   made.  Table entries outside [0, n_pages) (the -1 of an unmapped page)
//   read the trash page and are masked, the mapping the reference's wrapper
//   does before its kernel.
// * The TPU grid (B, Hkv, max_pages) carries (m, l, acc) across its
//   sequential page axis.  Here one block of 8 warps owns one (kv head,
//   slot) cell; warp w takes pages w, w + 8, ..., keeps its own f32 online
//   softmax in registers, and the 8 partial states are merged in shared
//   memory at the end (the flash-decoding merge, inside one block).  That
//   keeps 8 pages' loads in flight per block where the dense decode kernel
//   of the first slice streamed one tile at a time with one block.
// * Inside a warp, lane l owns dims [l * dh/32, (l+1) * dh/32) of every row:
//   a row of K or V is one coalesced 256-byte load (bf16, dh=128), and the
//   q.k dot is a 5-step shuffle reduction.  All `group` q heads of the kv
//   head reuse each page held in registers (the GQA reuse the TPU kernel
//   gets from VMEM).  G (a compile-time bound on group) sizes the register
//   arrays.
// * Masking follows the reference exactly: masked scores take -1e30, so a
//   slot with no attendable position (every page unmapped, an inactive
//   slot) averages V over all max_pages * page_size gathered rows, trash
//   included, as the plain version does, and stays finite.  When the slot
//   has an attendable position, pages with none are skipped: their weight
//   exp(-1e30 - m) is exactly 0 once m is a real score, so skipping them
//   changes no bit of the result and saves their bytes.
// * Shortfall, left for a later version: the grid is B * Hkv blocks (64 on
//   the serving path, on 132 SMs); splitting a slot's pages across blocks
//   with a second merge pass would fill the card.

#include <math_constants.h>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int NW = 8;           // warps per block
constexpr int NT = NW * 32;     // threads per block
constexpr int R = 8;            // page rows held in registers at a time
constexpr int MAX_G = 16;       // largest q-head group the kernel takes

template <int DH, int G>
size_t smem_bytes() {
  // q (G x DH) and the warps' partial accumulators (NW x G x DH)
  return sizeof(float) * (size_t)(G * DH + NW * G * DH);
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT) paged_dec_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ cur, T* __restrict__ o,
    int H, int Hkv, int n_pages, int ps, int max_pages) {
  constexpr int DPL = DH / 32;                  // dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                             // G x DH
  float* As = Qs + G * DH;                      // NW x G x DH partial acc
  __shared__ float Ms[NW][G], Ls[NW][G];        // partial max and sum

  const int group = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cur_b = cur[b];
  const int* trow = table + (long long)b * max_pages;
  const float sm = sqrtf((float)DH);

  const T* qb = q + ((long long)b * H + (long long)hk * group) * DH;
  for (int idx = tid; idx < group * DH; idx += NT) Qs[idx] = to_f32(qb[idx]);

  // does the slot attend to any position: a mapped page j with j*ps <= cur
  int any = 0;
  for (int j = lane; j < max_pages; j += 32) {
    const int pid = trow[j];
    any |= (pid >= 0 && pid < n_pages && (long long)j * ps <= cur_b) ? 1 : 0;
  }
  const bool has_valid = __any_sync(0xffffffffu, any) != 0;
  __syncthreads();                              // Qs is complete

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;                       // no row seen yet
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  const long long row_stride = (long long)Hkv * DH;
  const long long page_stride = (long long)ps * row_stride;
  for (int j = warp; j < max_pages; j += NW) {
    const int pid = trow[j];
    const bool mapped = pid >= 0 && pid < n_pages;
    // warp-uniform skip of a page with no attendable position
    if (has_valid && !(mapped && (long long)j * ps <= cur_b)) continue;
    const long long page = mapped ? pid : n_pages;          // trash page
    const T* kb = kp + page * page_stride + (long long)hk * DH + lane * DPL;
    const T* vb = vp + page * page_stride + (long long)hk * DH + lane * DPL;
    for (int t0 = 0; t0 < ps; t0 += R) {
      float kf[R][DPL], vf[R][DPL];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (t0 + r < ps) {
          load_f32<DPL>(kb + (t0 + r) * row_stride, kf[r]);
          load_f32<DPL>(vb + (t0 + r) * row_stride, vf[r]);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) kf[r][d] = vf[r][d] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {                        // uniform across the block
          float qv[DPL];
#pragma unroll
          for (int d = 0; d < DPL; ++d) qv[d] = Qs[g * DH + lane * DPL + d];
          float s[R];
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float part = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) part = fmaf(qv[d], kf[r][d], part);
            const float dot = warp_sum(part);
            const int t = t0 + r;
            const bool valid = mapped && j * ps + t <= cur_b;
            // rows past the page do not exist: -inf gives them weight 0
            s[r] = t >= ps ? -CUDART_INF_F : (valid ? dot / sm : NEG_INF);
            mx = fmaxf(mx, s[r]);
          }
          const float m_new = fmaxf(m[g], mx);  // finite: row t0 exists
          const float scale = expf(m[g] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r] = expf(s[r] - m_new);
            sum += s[r];
          }
          l[g] = l[g] * scale + sum;
          m[g] = m_new;
#pragma unroll
          for (int d = 0; d < DPL; ++d) {
            float a = acc[g][d] * scale;
#pragma unroll
            for (int r = 0; r < R; ++r) a = fmaf(s[r], vf[r][d], a);
            acc[g][d] = a;
          }
        }
      }
    }
  }

  // merge the NW partial states; a warp that took no page has m = -inf
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      if (lane == 0) {
        Ms[warp][g] = m[g];
        Ls[warp][g] = l[g];
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        As[(warp * G + g) * DH + lane * DPL + d] = acc[g][d];
    }
  }
  __syncthreads();
  T* ob = o + ((long long)b * H + (long long)hk * group) * DH;
  for (int idx = tid; idx < group * DH; idx += NT) {
    const int g = idx / DH, d = idx % DH;
    float mmax = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) mmax = fmaxf(mmax, Ms[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = Ms[w][g];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - mmax);
      num = fmaf(wt, As[(w * G + g) * DH + d], num);
      den = fmaf(wt, Ls[w][g], den);
    }
    ob[idx] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int G>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* cur, void* o, int B, int H, int Hkv, int n_pages, int ps,
           int max_pages, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH, G>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_dec_kernel<T, DH, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_dec_kernel<T, DH, G><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(table), static_cast<const int*>(cur),
      static_cast<T*>(o), H, Hkv, n_pages, ps, max_pages);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_g(const void* q, const void* k, const void* v, const void* table,
             const void* cur, void* o, int B, int H, int Hkv, int n_pages,
             int ps, int max_pages, cudaStream_t stream) {
  const int group = H / Hkv;
  if (group <= 2)
    return launch<T, DH, 2>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
  if (group <= 4)
    return launch<T, DH, 4>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
  if (group <= 8)
    return launch<T, DH, 8>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
  return launch<T, DH, 16>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* table,
              const void* cur, void* o, int B, int H, int Hkv, int dh,
              int n_pages, int ps, int max_pages, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_g<T, 32>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
    case 64: return launch_g<T, 64>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
    case 128: return launch_g<T, 128>(q, k, v, table, cur, o, B, H, Hkv, n_pages, ps, max_pages, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* cur, void* o, int B, int H, int Hkv, int dh, int n_pages,
    int page_size, int max_pages, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > MAX_G || n_pages < 1 ||
      page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, table, cur, o, B, H, Hkv, dh,
                                    n_pages, page_size, max_pages, s);
  return launch_dh<float>(q, k, v, table, cur, o, B, H, Hkv, dh, n_pages,
                          page_size, max_pages, s);
}
