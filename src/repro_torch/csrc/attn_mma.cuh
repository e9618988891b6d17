// Tensor-core tile code of the attention kernels for bf16 inputs:
// mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix from
// shared-memory tiles staged with cp.async, in the FlashAttention-2 shape.
// flash_attention.cu and prefix_flash_attention.cu take it for bf16 with
// 64-key tiles; paged_verify_attention.cu takes it with 16-key tiles (one
// page of 16 a warp), since a step only sees the staged K/V tile and a
// score functor.
//
// A block of MMA_NT = 128 threads (4 warps) owns MMA_BQ = 64 query rows of
// one head; warp w owns rows 16 w .. 16 w + 15 and keeps, in registers,
// * its Q rows as mma A fragments (ldmatrix once, then for the whole loop);
// * the f32 online-softmax state: O (16 x DH) as mma accumulators, and the
//   row max m and sum l of its two rows per lane (g = lane / 4 and g + 8).
// A k-tile holds BK keys (MMA_BK = 64 unless the kernel picks another
// multiple of 16).  S = Q K^T accumulates in f32 fragments;
// the mask and the online softmax work on those fragments (row max and sum
// across the 4 lanes of a quad); P is rounded to bf16 in registers and used
// as the A operand of P V, with no round trip through shared memory.  V is
// read with ldmatrix.trans.
//
// Shared tiles are bf16 with rows padded by 8 elements (16 bytes): the 8 row
// addresses of one ldmatrix then fall in 8 distinct 16-byte bank groups for
// DH = 32, 64 and 128, so the loads are free of bank conflicts.

#pragma once

#include "attn_common.cuh"

namespace attn {

constexpr int MMA_BQ = 64;          // query rows per block
constexpr int MMA_BK = 64;          // keys per k-tile
constexpr int MMA_NT = 128;         // threads per block (4 warps x 16 rows)

template <int DH>
__host__ __device__ constexpr int mma_ld() { return DH + 8; }   // padded row, in elements

// Q tile, then two buffers each of the K and V tiles
template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_ld<DH>() * (MMA_BQ + 4 * MMA_BK);
}

// cp.async rows [row0, row0 + ROWS) of head h of a (B, S, Hh, DH) bf16
// tensor into a padded tile; rows >= S are zero-filled.  The caller commits.
template <int DH, int ROWS>
__device__ __forceinline__ void mma_stage_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int b, int S,
    int Hh, int h, int row0, int tid) {
  constexpr int CH = DH / 8;                  // 16-byte chunks per row
  for (int idx = tid; idx < ROWS * CH; idx += MMA_NT) {
    const int r = idx / CH, ch = idx % CH, row = row0 + r;
    const bool in = row < S;
    const __nv_bfloat16* g =
        src + (((long long)b * S + (in ? row : 0)) * Hh + h) * DH + ch * 8;
    cp_async16(dst + r * mma_ld<DH>() + ch * 8, g, in);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One warp's 16 query rows through the k-tiles of BK keys.  Fragment
// layouts are the PTX ISA's for m16n8k16: lane = 4 g + t holds, of an f32
// accumulator tile, rows g and g + 8 at cols 2 t and 2 t + 1.
template <int DH, int BK = MMA_BK>
struct MmaRows {
  static_assert(BK % 16 == 0, "a k-tile is whole 16-key mma steps");
  static constexpr int LD = mma_ld<DH>();
  static constexpr int NS = BK / 8;           // score n-tiles per k-tile
  static constexpr int NO = DH / 8;           // output n-tiles
  unsigned qf[DH / 16][4];                    // Q A-fragments per 16 dims
  float o[NO][4];
  float m[2], l[2];                           // rows g and g + 8

  __device__ __forceinline__ MmaRows() {
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // A fragments of this warp's rows of the staged Q tile
  __device__ __forceinline__ void load_q(const __nv_bfloat16* Qs, int warp, int lane) {
    const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldsm_x4(qf[kk], Qs + r * LD + kk * 16 + 8 * (lane >> 4));
  }

  // one staged k-tile (keys k_lo .. k_lo + BK - 1): S = Q K^T, each score
  // replaced by score(row, col, s) (row = `row_g` for this lane's first
  // row, row_g + 8 for its second): s where the key is attended, NEG_INF
  // where it is masked, -inf for a key that takes no part at all (weight 0
  // even in a row with no valid key); then the online softmax of
  // S / sqrt(DH) and O += P V.  m holds the unscaled row max (it starts at
  // NEG_INF, so a tile of keys that take no part leaves the state as it
  // was) and p = 2^(s * c - m * c), c = `scale_log2` = log2e / sqrt(DH).
  // Both products are rounded (__fmul_rn, never fused into an FMA), so
  // s == m gives exactly 2^0: a masked score stays NEG_INF, and a row with
  // no valid key yet gives p = 1 for it, as the TPU kernel's scaled -1e30
  // does.
  template <typename Score>
  __device__ __forceinline__ void step(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                       int k_lo, int row_g, float scale_log2,
                                       Score score, int lane) {
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        unsigned kb[4];
        ldsm_x4(kb, Ks + (j2 * 16 + (lane & 7) + 8 * (lane >> 4)) * LD
                        + kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16_16816(s[2 * j2], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * j2 + 1], qf[kk], kb[2], kb[3]);
      }
    }

    const int col0 = k_lo + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_g + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = score(row, col0 + 8 * j + e, x);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_scaled = __fmul_rn(m_new, scale_log2);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = exp2f(__fmul_rn(x, scale_log2) - m_scaled);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float scale = exp2f(__fmul_rn(m[i], scale_log2) - m_scaled);
      l[i] = l[i] * scale + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * i] *= scale;
        o[j][2 * i + 1] *= scale;
      }
    }

    // P (bf16, in registers: score n-tiles 2c and 2c + 1 are the A fragment
    // of keys 16 c .. 16 c + 15) times V
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const unsigned pa[4] = {pack_bf16x2(s[2 * c][0], s[2 * c][1]),
                              pack_bf16x2(s[2 * c][2], s[2 * c][3]),
                              pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        unsigned vb[4];
        ldsm_x4_trans(vb, Vs + (c * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                              + j2 * 16 + 8 * (lane >> 4));
        mma_bf16_16816(o[2 * j2], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * j2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // normalise and write this warp's rows [row0 + 16 warp, +16) of head h
  // that lie below Sq, staged through the warp's rows of `Os` (a padded
  // tile no other warp touches) so the global stores are 16 bytes a lane
  __device__ __forceinline__ void store(__nv_bfloat16* Os, __nv_bfloat16* __restrict__ out,
                                        int b, int Sq, int H, int h, int row0,
                                        int warp, int lane) {
    const int r = warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<unsigned*>(Os + (r + 8 * i) * LD + 8 * j + 2 * (lane & 3)) =
            pack_bf16x2(o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
    }
    __syncwarp();
    constexpr int CH = DH / 8;
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int rr = warp * 16 + idx / CH, ch = idx % CH, row = row0 + rr;
      if (row < Sq)
        *reinterpret_cast<uint4*>(out + (((long long)b * Sq + row) * H + h) * DH + ch * 8) =
            *reinterpret_cast<const uint4*>(Os + rr * LD + ch * 8);
    }
  }
};

}  // namespace attn
