// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py: ssd_scan_kernel
// (body _ssd_kernel).  For one (batch, head) it computes, chunk by chunk of
// L rows, with cum the in-chunk prefix sum of dA = dt * A:
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     intra-chunk
//         + exp(cum_i) C_i . state^T                               inter-chunk
//   state = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
//
// and returns y and the final (hd, N) state.  All arithmetic is f32; x, B,
// C and y are f32 or bf16, dt, dA and the state f32.
//
// What bounds it on the H100: at the serving path's admission shape (B=8,
// S=1024 in 4 chunks of 256, nh=32, hd=64, G=1, N=128, bf16) the call moves
// ~82 MB (x, dt, dA, B, C read once, y and the final state written once:
// ~24 us at 3.35 TB/s) and needs ~13.2 GFLOP for the causal half of
// C.B^T, its product with x, the state read and the state update (~13 us
// at the 989 TFLOP/s bf16 tensor-core peak), so its bound is the bytes;
// chip_smoke.py's check_ssd computes both from the run's shapes.  This
// first version runs the products as f32
// FMAs on the CUDA cores (67 TFLOP/s at most), so it is bound by those and
// by the shared-memory reads that feed them: the tensor cores, TMA and one
// C.B^T per group shared by its nh/G heads are later work.
//
// Design:
// * The TPU grid (B, nh, n_chunks) carries the state in VMEM scratch along
//   its sequential chunk axis.  Blocks of a GPU carry nothing between them,
//   so one block of 256 threads owns one (batch, head) and loops over the
//   chunks, keeping the (hd, N) f32 state in shared memory (32 KB at hd 64,
//   N 128); 256 blocks at the main shape on 132 SMs, two per SM.
// * B and C are read at group h / (nh / G), as the TPU kernel's index map
//   does; nothing is repeated in memory.
// * cum is a block-wide inclusive scan of the chunk's dA.
// * y is computed in tiles of 32 query rows: first the inter-chunk term
//   from the state as it stood before this chunk, then, per tile of 32 key
//   rows up to the diagonal, the 32 x 32 score tile C.B^T (2 x 2 entries a
//   thread), masked and decayed, and its product with x.  A whole (L, L)
//   score matrix would not fit: 256 KB at L = 256.
// * The mask is applied before exp: above the diagonal cum_i - cum_j > 0
//   and exp may overflow, and inf * 0 is NaN.  exp(cum) underflowing to 0
//   over a long chunk is the right value and is not clamped.
// * The state update runs after every query tile has read the old state:
//   each thread owns a (hd / 16 or so) x (8 or 2) register block of the
//   state and sums exp(cum_L - cum_j) dt_j x_j[p] B_j[n] over the chunk.
// * Shared-memory rows are padded by one float so the column reads of the
//   score, state and output tiles fall in distinct banks.
// * S must be a multiple of L (the wrapper pads with dt = 0, which is
//   exact); rows of a tile past L are masked, so L need not divide by 32.

#include "attn_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int NT = 256;      // threads per block
constexpr int TQ = 32;       // query rows per tile
constexpr int TK = 32;       // key rows per tile
constexpr int LMAX = 256;    // longest chunk (one scan element a thread)

template <int HD, int N>
struct Smem {
  static constexpr int NP = N + 1;    // padded rows of the state, C and B
  static constexpr int XP = HD + 1;   // padded rows of x
  static constexpr int SP = TK + 1;   // padded rows of the score tile
  float* st;    // [HD][NP]  the carried state
  float* cq;    // [TQ][NP]  C rows of the query tile
  float* bk;    // [TK][NP]  B rows of the key tile
  float* xk;    // [TK][XP]  x rows of the key tile
  float* sc;    // [TQ][SP]  masked, decayed scores
  float* cum;   // [LMAX]    in-chunk prefix sum of dA
  float* dts;   // [LMAX]    dt of the chunk
  __device__ explicit Smem(float* base)
      : st(base), cq(st + HD * NP), bk(cq + TQ * NP), xk(bk + TK * NP),
        sc(xk + TK * XP), cum(sc + TQ * SP), dts(cum + LMAX) {}
  static constexpr size_t bytes() {
    return sizeof(float) *
           (size_t)(HD * NP + TQ * NP + TK * NP + TK * XP + TQ * SP + 2 * LMAX);
  }
};

// rows r0 .. r0 + 31 of a chunk's (L, N) slab of B or C as f32, 0 past L
template <typename T, int N>
__device__ __forceinline__ void load_bc(const T* __restrict__ src, int r0,
                                        int L, float* dst, int tid) {
  constexpr int NP = N + 1;
  for (int idx = tid; idx < 32 * N; idx += NT) {
    const int r = idx / N, n = idx % N;
    dst[r * NP + n] = (r0 + r < L) ? to_f32(src[(size_t)(r0 + r) * N + n]) : 0.f;
  }
}

// rows r0 .. r0 + 31 of a chunk's (L, HD) slab of x as f32, 0 past L; with
// `weighted`, row j is scaled by exp(total - cum_j) * dt_j (the state update)
template <typename T, int HD>
__device__ __forceinline__ void load_x(const T* __restrict__ src, int r0, int L,
                                       float* dst, const float* cum,
                                       const float* dts, bool weighted,
                                       float total, int tid) {
  constexpr int XP = HD + 1;
  for (int idx = tid; idx < 32 * HD; idx += NT) {
    const int r = idx / HD, p = idx % HD, j = r0 + r;
    float v = 0.f;
    if (j < L) {
      v = to_f32(src[(size_t)j * HD + p]);
      if (weighted) v *= expf(total - cum[j]) * dts[j];
    }
    dst[r * XP + p] = v;
  }
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ dA, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state_out,
    int nh, int S, int G, int L) {
  using Sm = Smem<HD, N>;
  constexpr int NP = Sm::NP, XP = Sm::XP, SP = Sm::SP;
  extern __shared__ float smem[];
  const Sm s(smem);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = (size_t)b * nh + h;
  const size_t bg = (size_t)b * G + h / (nh / G);
  const T* xb = x + bh * S * HD;
  T* yb = y + bh * S * HD;
  const float* dtb = dt + bh * S;
  const float* dAb = dA + bh * S;
  const T* Bb = Bm + bg * S * N;
  const T* Cb = Cm + bg * S * N;

  // output tile: RY rows x 2 columns a thread
  constexpr int CG = HD / 2;            // column groups
  constexpr int RG = NT / CG;           // row groups (8 or 16)
  constexpr int RY = TQ / RG;           // rows a thread (4 or 2)
  const int tc = tid % CG, tr = tid / CG;
  // score tile: 2 x 2 entries a thread
  const int sx = tid % 16, sy = tid / 16;
  // state: PT rows (p) x NTH columns (n) a thread
  constexpr int NTH = N >= 128 ? 8 : 2;
  constexpr int NC = N / NTH;
  constexpr int PC = NT / NC;
  constexpr int PT = HD / PC;
  static_assert(PT >= 1 && PC * PT == HD && NC * NTH == N, "state tiling");
  const int tn = tid % NC, tp = tid / NC;

  for (int i = tid; i < HD * NP; i += NT) s.st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const T* xc = xb + (size_t)c0 * HD;
    const T* Bc = Bb + (size_t)c0 * N;
    const T* Cc = Cb + (size_t)c0 * N;
    __syncthreads();                    // the previous chunk is done
    if (tid < L) {
      s.dts[tid] = dtb[c0 + tid];
      s.cum[tid] = dAb[c0 + tid];
    }
    __syncthreads();
    for (int off = 1; off < L; off <<= 1) {   // inclusive scan of dA
      const float v = (tid < L && tid >= off) ? s.cum[tid - off] : 0.f;
      __syncthreads();
      if (tid < L) s.cum[tid] += v;
      __syncthreads();
    }
    const float total = s.cum[L - 1];

    for (int q0 = 0; q0 < L; q0 += TQ) {
      __syncthreads();                  // earlier readers of cq, sc, xk
      load_bc<T, N>(Cc, q0, L, s.cq, tid);
      __syncthreads();

      // inter-chunk: exp(cum_i) C_i . state[p, :], the state before this
      // chunk's update
      float acc[RY][2];
#pragma unroll
      for (int a = 0; a < RY; ++a) acc[a][0] = acc[a][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s0 = s.st[tc * NP + n], s1 = s.st[(tc + CG) * NP + n];
#pragma unroll
        for (int a = 0; a < RY; ++a) {
          const float cv = s.cq[(tr + RG * a) * NP + n];
          acc[a][0] += cv * s0;
          acc[a][1] += cv * s1;
        }
      }
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        const int i = q0 + tr + RG * a;
        const float e = (i < L) ? expf(s.cum[i]) : 0.f;
        acc[a][0] *= e;
        acc[a][1] *= e;
      }

      // intra-chunk: key tiles up to the diagonal
      const int k_end = min(L, q0 + TQ);
      for (int k0 = 0; k0 < k_end; k0 += TK) {
        __syncthreads();                // earlier readers of bk, xk, sc
        load_bc<T, N>(Bc, k0, L, s.bk, tid);
        load_x<T, HD>(xc, k0, L, s.xk, s.cum, s.dts, false, 0.f, tid);
        __syncthreads();
        float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
        const float* c0r = s.cq + (2 * sy) * NP;
        const float* b0r = s.bk + (2 * sx) * NP;
        for (int n = 0; n < N; ++n) {
          const float ca = c0r[n], cb = c0r[NP + n];
          const float ba = b0r[n], bb = b0r[NP + n];
          d00 += ca * ba;
          d01 += ca * bb;
          d10 += cb * ba;
          d11 += cb * bb;
        }
        const float d[2][2] = {{d00, d01}, {d10, d11}};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = q0 + 2 * sy + a, j = k0 + 2 * sx + c;
            // mask first: exp of cum_i - cum_j > 0 above the diagonal
            // may overflow
            float v = 0.f;
            if (j <= i && i < L) v = d[a][c] * expf(s.cum[i] - s.cum[j]) * s.dts[j];
            s.sc[(2 * sy + a) * SP + 2 * sx + c] = v;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < TK; ++jj) {
          const float x0 = s.xk[jj * XP + tc], x1 = s.xk[jj * XP + tc + CG];
#pragma unroll
          for (int a = 0; a < RY; ++a) {
            const float sv = s.sc[(tr + RG * a) * SP + jj];
            acc[a][0] += sv * x0;
            acc[a][1] += sv * x1;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        const int i = q0 + tr + RG * a;
        if (i < L) {
          yb[(size_t)(c0 + i) * HD + tc] = from_f32<T>(acc[a][0]);
          yb[(size_t)(c0 + i) * HD + tc + CG] = from_f32<T>(acc[a][1]);
        }
      }
    }

    // state update: sum_j w_j x_j[p] B_j[n], w_j = exp(total - cum_j) dt_j
    float sacc[PT][NTH];
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
      for (int c = 0; c < NTH; ++c) sacc[a][c] = 0.f;
    for (int k0 = 0; k0 < L; k0 += TK) {
      __syncthreads();                  // earlier readers of bk, xk
      load_bc<T, N>(Bc, k0, L, s.bk, tid);
      load_x<T, HD>(xc, k0, L, s.xk, s.cum, s.dts, true, total, tid);
      __syncthreads();
      for (int jj = 0; jj < TK; ++jj) {
        float xv[PT], bv[NTH];
#pragma unroll
        for (int a = 0; a < PT; ++a) xv[a] = s.xk[jj * XP + tp + PC * a];
#pragma unroll
        for (int c = 0; c < NTH; ++c) bv[c] = s.bk[jj * NP + tn + NC * c];
#pragma unroll
        for (int a = 0; a < PT; ++a)
#pragma unroll
          for (int c = 0; c < NTH; ++c) sacc[a][c] += xv[a] * bv[c];
      }
    }
    // every reader of the old state (the query tiles) passed a barrier above
    const float et = expf(total);
#pragma unroll
    for (int a = 0; a < PT; ++a)
#pragma unroll
      for (int c = 0; c < NTH; ++c) {
        float* e = s.st + (tp + PC * a) * NP + tn + NC * c;
        *e = et * *e + sacc[a][c];
      }
  }
  __syncthreads();
  float* so = state_out + bh * HD * N;
  for (int e = tid; e < HD * N; e += NT) so[e] = s.st[(e / N) * NP + e % N];
}

template <typename T, int HD, int N>
int launch(const void* x, const void* dt, const void* dA, const void* Bm,
           const void* Cm, void* y, void* state, int B, int nh, int S, int G,
           int L, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, N>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, B);
  ssd_kernel<T, HD, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<float*>(state),
      nh, S, G, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const void* x, const void* dt, const void* dA, const void* Bm,
                const void* Cm, void* y, void* state, int B, int nh, int S,
                int hd, int G, int N, int L, cudaStream_t stream) {
  if (hd == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, dA, Bm, Cm, y, state, B, nh, S, G, L, stream);
  if (hd == 32 && N == 128)
    return launch<T, 32, 128>(x, dt, dA, Bm, Cm, y, state, B, nh, S, G, L, stream);
  if (hd == 64 && N == 16)
    return launch<T, 64, 16>(x, dt, dA, Bm, Cm, y, state, B, nh, S, G, L, stream);
  if (hd == 32 && N == 16)
    return launch<T, 32, 16>(x, dt, dA, Bm, Cm, y, state, B, nh, S, G, L, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* dA,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int B, int nh, int S, int hd, int G,
                              int N, int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || nh < 1 || G < 1 || nh % G != 0 || chunk < 1 || chunk > LMAX ||
      S < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_dims<__nv_bfloat16>(x, dt, dA, Bm, Cm, y, state, B, nh, S, hd,
                                      G, N, chunk, s);
  return launch_dims<float>(x, dt, dA, Bm, Cm, y, state, B, nh, S, hd, G, N,
                            chunk, s);
}
