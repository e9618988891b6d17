// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py: ssd_scan_kernel
// (body _ssd_kernel).  For each (batch, head) it computes, chunk by chunk
// of L rows, with cum the in-chunk prefix sum of dA = dt * A:
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     intra-chunk
//         + exp(cum_i) C_i . state^T                               inter-chunk
//   state = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
//
// and returns y and the final (hd, N) f32 state.  Inputs are read in the
// model layout through strides (kernels/ssd_scan/kernel.py checks them):
// x (B, S, nh, hd), e.g. xBC[..., :d_in] with a row stride of the conv
// width; dt (B, S, nh) f32; A (nh,) f32, dA formed here; B and C (B, S, G,
// N), shared by the nh / G heads of a group.  y is written (B, S, nh, hd)
// contiguous.  S must be a multiple of L (the wrapper pads with dt = 0,
// which is exact).
//
// What bounds it on the H100: at the serving path's admission shape (B=8,
// S=1024 in 4 chunks of 256, nh=32, hd=64, G=1, N=128, bf16) the call moves
// ~82 MB (x, dt, A, B, C read once, y and the final state written once:
// 24.1 us at 3.35 TB/s) and needs ~13.2 GFLOP (the causal half of C.B^T
// once a group, its product with x, the state read and the state update a
// head: ~13 us at the 989 TFLOP/s bf16 tensor-core peak), so its bound is
// the bytes; chip_smoke.py's check_ssd computes both from the run's shapes.
//
// Two routes, by dtype (kernel.py: ssd_route), never by failure:
//
// * bf16: five passes over (batch, chunk) cells, Mamba-2's own
//   decomposition of the SSD (Dao & Gu 2024, section 7), the products on
//   the tensor cores (mma.sync m16n8k16 through attn_mma.cuh's ldmatrix
//   fragments, f32 accumulation), operands staged by 16-byte cp.async:
//   1. ssd_cumsum_kernel: cum of dA per (batch, head, chunk), a warp-shuffle
//      scan, with dt, into head-major f32 scratch (B, nh, S).
//   2. ssd_cb_kernel: C.B^T once per (batch, group, chunk), the 64 x 64
//      tiles on or below the diagonal, rounded to bf16 (as the plain version
//      rounds it) into scratch (B G, n_chunks, lt, lt), lt = L rounded up to
//      128: at G = 1 the 32 heads share one, 4.2 MB at the main shape, read
//      back from L2.
//   3. ssd_chunk_state_kernel: each chunk's own state sum_j w_j x_j^T B_j,
//      w_j = exp(cum_L - cum_j) dt_j, in parallel over (batch, head, chunk)
//      (1,024 blocks at the main shape, where the first version had 256),
//      the key tiles of x and B double-buffered.
//      The weighted operand w_j x_j is split into bf16 hi + lo and both go
//      through the product: one bf16 rounding (2^-9 a term) would miss the
//      state's 1e-4 tolerance, the pair keeps ~2^-17.  f32 out.
//   4. ssd_state_pass_kernel: the only sequential part left, an elementwise
//      walk over the chunks of each (batch, head) state: the state entering
//      chunk c (bf16, for step 5's product) and the final f32 state.
//   5. ssd_chunk_scan_kernel: per (head, 64-row query tile, batch x
//      chunk): exp(cum_i) C_i . state_in^T, then the 64-key tiles up to the
//      diagonal: the C.B^T tile from step 2 as mma A fragments, scaled in
//      f32 by exp(cum_i - cum_j) dt_j, masked (j <= i, before the exp,
//      whose argument above the diagonal may overflow), rounded to bf16 and
//      multiplied with x.  Off the diagonal, where cum falls along the
//      chunk (checked a block), the decay is a row factor times a column
//      factor, both in [0, 1]: 2 exps a tile for a warp's rows instead of
//      32 a thread.  Exps are exp2 of the difference times log2 e.  y is
//      rounded to bf16 once.  The first round of loads (cum, dt, C rows,
//      the entering state, the first key tile) is one cp.async group;
//      later key tiles are double-buffered, the second buffer taking the
//      space of C and the state once they are read.  (Blocks of 128 rows,
//      or of two heads sharing C and C.B^T, move fewer bytes but ran
//      slower at the main shape.)
//   Scratch (the wrapper allocates it): cum and dt (B, nh, S) f32, C.B^T,
//   the chunk states (B, n_chunks, nh, hd, N) f32 and the entering states
//   in bf16.  Shortfall: the chunk states go through device memory twice
//   (33.5 MB f32 at the main shape), each key tile of x is staged once per
//   query tile, and pass 3 reads B once per head.
// * f32: ssd_f32_kernel, the first version: one block of 256 threads per
//   (batch, head) walks its chunks in order with the (hd, N) state in shared
//   memory and runs every product as f32 FMAs on the CUDA cores (exact to
//   the plain version's summation order; 256 blocks at the main shape).
//
// Head dims 32, 64 and 128 (jamba-1.5-large: hd 128, N 128, G 8), each
// with N 16 or 128.  At hd 128 nothing is split: pass 3's eight warps each
// take 16 rows p of the state and all N columns (64 f32 sums a thread), pass
// 5 holds a 16-row slice of y across hd (64 sums a thread) and stages
// 80 KB, pass 3 102 KB; the f32 kernel's state tile doubles to 64 KB and
// its shared memory to 119 KB (N 128), under the 227 KB a block may opt
// into.  Every column p of x moves through the SSD on its own (dt, the
// decay, B and C are shared by all p), so halving hd across the grid would
// be exact, were the budget short.

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;
using bf16 = __nv_bfloat16;

// element strides of the model-layout operands; the inner strides are
// fixed: x's head stride hd, dt's head stride 1, B's and C's group stride N,
// and every last axis 1
struct SsdStrides {
  long long xb, xs;     // x: batch, sequence
  long long db, ds;     // dt
  long long bb, bs;     // B
  long long cb, cs;     // C
};

constexpr int LMAX = 256;    // longest chunk

// ===========================================================================
// f32 route: the first version
// ===========================================================================

constexpr int NT = 256;      // threads per block
constexpr int TQ = 32;       // query rows per tile
constexpr int TK = 32;       // key rows per tile

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

// rows r0 .. r0 + 31 of a chunk's (L, N) slab of B or C (row stride rs) as
// f32, 0 past L
template <typename T, int N>
__device__ __forceinline__ void load_bc(const T* __restrict__ src, long long rs,
                                        int r0, int L, float* dst, int tid) {
  constexpr int NP = N + 1;
  for (int idx = tid; idx < 32 * N; idx += NT) {
    const int r = idx / N, n = idx % N;
    dst[r * NP + n] = (r0 + r < L) ? to_f32(src[(r0 + r) * rs + n]) : 0.f;
  }
}

// rows r0 .. r0 + 31 of a chunk's (L, HD) slab of x (row stride rs) as f32,
// 0 past L; with `weighted`, row j is scaled by exp(total - cum_j) * dt_j
// (the state update)
template <typename T, int HD>
__device__ __forceinline__ void load_x(const T* __restrict__ src, long long rs,
                                       int r0, int L, float* dst,
                                       const float* cum, const float* dts,
                                       bool weighted, float total, int tid) {
  constexpr int XP = HD + 1;
  for (int idx = tid; idx < 32 * HD; idx += NT) {
    const int r = idx / HD, p = idx % HD, j = r0 + r;
    float v = 0.f;
    if (j < L) {
      v = to_f32(src[j * rs + p]);
      if (weighted) v *= expf(total - cum[j]) * dts[j];
    }
    dst[r * XP + p] = v;
  }
}

// grid (nh, B), NT threads
template <typename T, int HD, int N>
__global__ void __launch_bounds__(NT) ssd_f32_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state_out,
    int nh, int S, int G, int L, SsdStrides sd) {
  using Sm = Smem<HD, N>;
  constexpr int NP = Sm::NP, XP = Sm::XP, SP = Sm::SP;
  extern __shared__ float smem[];
  const Sm s(smem);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = (size_t)b * nh + h;
  const int g = h / (nh / G);
  const T* xb = x + b * sd.xb + (long long)h * HD;
  const long long yrs = (long long)nh * HD;          // y's row stride
  T* yb = y + (long long)b * S * yrs + (long long)h * HD;
  const float* dtb = dt + b * sd.db + h;
  const float a_h = A[h];
  const T* Bb = Bm + b * sd.bb + (long long)g * N;
  const T* Cb = Cm + b * sd.cb + (long long)g * N;

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
    const T* xc = xb + c0 * sd.xs;
    const T* Bc = Bb + c0 * sd.bs;
    const T* Cc = Cb + c0 * sd.cs;
    __syncthreads();                    // the previous chunk is done
    if (tid < L) {
      const float d = dtb[(c0 + tid) * sd.ds];
      s.dts[tid] = d;
      s.cum[tid] = d * a_h;
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
      load_bc<T, N>(Cc, sd.cs, q0, L, s.cq, tid);
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
        load_bc<T, N>(Bc, sd.bs, k0, L, s.bk, tid);
        load_x<T, HD>(xc, sd.xs, k0, L, s.xk, s.cum, s.dts, false, 0.f, tid);
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
          yb[(c0 + i) * yrs + tc] = from_f32<T>(acc[a][0]);
          yb[(c0 + i) * yrs + tc + CG] = from_f32<T>(acc[a][1]);
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
      load_bc<T, N>(Bc, sd.bs, k0, L, s.bk, tid);
      load_x<T, HD>(xc, sd.xs, k0, L, s.xk, s.cum, s.dts, true, total, tid);
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

template <int HD, int N>
int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* state, int B, int nh, int S,
               int G, int L, const SsdStrides& sd, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, N>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_kernel<float, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_f32_kernel<float, HD, N><<<dim3(nh, B), NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), nh, S, G, L, sd);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bf16 route: five passes on the tensor cores
// ===========================================================================

constexpr int RT = 64;       // rows (queries or keys) of a tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PNT = 128;     // threads of a pass block: 4 warps x 16 rows
constexpr int SNT = 256;     // threads of a chunk-state block: 8 warps

// a staged bf16 row of COLS elements, padded by 16 bytes: the 8 rows of one
// ldmatrix fall in distinct bank groups
template <int COLS>
__host__ __device__ constexpr int ld() { return COLS + 8; }

// cp.async rows [row0, row0 + RT) of a chunk's (L, COLS) bf16 slab at src
// (row stride rs elements) into a padded tile; rows >= L are zero-filled.
// The caller commits.
template <int COLS, int NTHREADS = PNT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           long long rs, int row0, int L, int tid) {
  constexpr int CH = COLS / 8;                 // 16-byte chunks a row
  for (int idx = tid; idx < RT * CH; idx += NTHREADS) {
    const int r = idx / CH, ch = idx % CH, row = row0 + r;
    const bool in = row < L;
    attn::cp_async16(dst + r * ld<COLS>() + ch * 8, src + (in ? row : 0) * rs + ch * 8, in);
  }
}

// pass 1.  grid (n_chunks, nh, B), LMAX threads: cum and dt of one chunk of
// one head into (B, nh, S) f32
__global__ void __launch_bounds__(LMAX) ssd_cumsum_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    float* __restrict__ cum, float* __restrict__ dtT, int nh, int S, int L,
    SsdStrides sd) {
  __shared__ float wsum[LMAX / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const int s = c * L + t;
  const float d = t < L ? dt[b * sd.db + s * sd.ds + h] : 0.f;
  float v = d * A[h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  for (int i = 0; i < w; ++i) v += wsum[i];
  if (t < L) {
    const size_t o = ((size_t)b * nh + h) * S + s;
    cum[o] = v;
    dtT[o] = d;
  }
}

// pass 2.  grid (nt (nt + 1) / 2, n_chunks, B G), PNT threads, nt the 64-row
// tiles of a chunk: the tile (qt, kt <= qt) of C.B^T of one (batch, group,
// chunk), bf16, into (B G, n_chunks, lt, lt), lt = 64 nt.
// Rows and columns past L are zero; tiles above the diagonal are not
// written (pass 5 never reads them).
template <int N>
__global__ void __launch_bounds__(PNT) ssd_cb_kernel(
    const bf16* __restrict__ Cm, const bf16* __restrict__ Bm,
    bf16* __restrict__ cb, int G, int L, int lt, SsdStrides sd) {
  __shared__ __align__(16) bf16 Cs[RT * ld<N>()];
  __shared__ __align__(16) bf16 Bs[RT * ld<N>()];
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = blockIdx.x - qt * (qt + 1) / 2;
  const int c = blockIdx.y, nc = gridDim.y, bg = blockIdx.z;
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = (long long)c * L;
  stage_rows<N>(Cs, Cm + b * sd.cb + row0 * sd.cs + (long long)g * N, sd.cs,
                qt * RT, L, tid);
  stage_rows<N>(Bs, Bm + b * sd.bb + row0 * sd.bs + (long long)g * N, sd.bs,
                kt * RT, L, tid);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();

  float s[RT / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    unsigned af[4];
    attn::ldsm_x4(af, Cs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld<N>()
                          + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int j2 = 0; j2 < RT / 16; ++j2) {
      unsigned kb[4];
      attn::ldsm_x4(kb, Bs + (j2 * 16 + (lane & 7) + 8 * (lane >> 4)) * ld<N>()
                            + kk * 16 + 8 * ((lane >> 3) & 1));
      attn::mma_bf16_16816(s[2 * j2], af, kb[0], kb[1]);
      attn::mma_bf16_16816(s[2 * j2 + 1], af, kb[2], kb[3]);
    }
  }
  bf16* out = cb + (((size_t)bg * nc + c) * lt + qt * RT + warp * 16 + lane / 4) * lt
              + kt * RT + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < RT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<unsigned*>(out + (size_t)r * 8 * lt + 8 * j) =
          attn::pack_bf16x2(s[j][2 * r], s[j][2 * r + 1]);
}

// pass 3.  grid (n_chunks, nh, B), SNT threads: the chunk's own state
// sum_j w_j x_j^T B_j (HD x N) f32 into (B, n_chunks, nh, HD, N).  Key
// tiles of x and B are double-buffered (the next one is in flight while
// this one is weighted and multiplied).  The 8 warps split p in 16-row
// groups and n in 16-column pairs (at most 64 f32 sums a thread; a warp
// with no share at the smallest widths only helps stage).
template <int HD, int N>
constexpr size_t state_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * (RT * ld<HD>() + RT * ld<N>()) + 2 * RT * ld<HD>())
         + sizeof(float) * RT;
}

template <int HD, int N>
__global__ void __launch_bounds__(SNT) ssd_chunk_state_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm,
    const float* __restrict__ cum, const float* __restrict__ dtT,
    float* __restrict__ states, int nh, int S, int G, int L, SsdStrides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xr0 = reinterpret_cast<bf16*>(smem_raw);     // [RT][HD] x, buffer 0
  bf16* Br0 = Xr0 + RT * ld<HD>();                   // [RT][N]  B, buffer 0
  bf16* Xr1 = Br0 + RT * ld<N>();                    // buffer 1
  bf16* Br1 = Xr1 + RT * ld<HD>();
  bf16* Xh = Br1 + RT * ld<N>();                     // [RT][HD] w x, bf16 hi
  bf16* Xl = Xh + RT * ld<HD>();                     // [RT][HD] w x - hi
  float* wts = reinterpret_cast<float*>(Xl + RT * ld<HD>());
  constexpr int PW = HD / 16;
  constexpr int NW = (SNT / 32 / PW < N / 16) ? SNT / 32 / PW : N / 16;
  constexpr int NCW = N / NW;                  // columns a warp
  constexpr int NJ = NCW / 8;
  const int c = blockIdx.x, nc = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pw = warp % PW, nw = warp / PW;
  const bool active = warp < PW * NW;
  const size_t vo = ((size_t)b * nh + h) * S + (size_t)c * L;
  const float* cumc = cum + vo;
  const float* dtc = dtT + vo;
  const float total = cumc[L - 1];
  const long long row0 = (long long)c * L;
  const bf16* xc = x + b * sd.xb + row0 * sd.xs + (long long)h * HD;
  const bf16* Bc = Bm + b * sd.bb + row0 * sd.bs + (long long)g * N;
  const int nk = (L + RT - 1) / RT;

  stage_rows<HD, SNT>(Xr0, xc, sd.xs, 0, L, tid);
  stage_rows<N, SNT>(Br0, Bc, sd.bs, 0, L, tid);
  attn::cp_async_commit();
  float acc[NJ][4] = {};
  for (int k = 0; k < nk; ++k) {
    const int k0 = k * RT;
    const bf16* Xr = (k & 1) ? Xr1 : Xr0;
    const bf16* Bs = (k & 1) ? Br1 : Br0;
    if (k + 1 < nk) {                          // the next tile into the other buffer
      stage_rows<HD, SNT>((k & 1) ? Xr0 : Xr1, xc, sd.xs, k0 + RT, L, tid);
      stage_rows<N, SNT>((k & 1) ? Br0 : Br1, Bc, sd.bs, k0 + RT, L, tid);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    if (tid < RT) {
      const int j = k0 + tid;
      wts[tid] = j < L ? expf(total - cumc[j]) * dtc[j] : 0.f;
    }
    __syncthreads();
    // w_j x_j as bf16 hi + lo
    for (int idx = tid; idx < RT * HD / 2; idx += SNT) {
      const int r = idx / (HD / 2), p = 2 * (idx % (HD / 2));
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Xr + r * ld<HD>() + p));
      const float w = wts[r];
      const float a0 = v.x * w, a1 = v.y * w;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
      const float2 hf = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(Xh + r * ld<HD>() + p) = hi;
      *reinterpret_cast<__nv_bfloat162*>(Xl + r * ld<HD>() + p) =
          __floats2bfloat162_rn(a0 - hf.x, a1 - hf.y);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < RT / 16; ++kk) {
        // A = (w x)^T: rows p, columns j, from the [j][p] tiles transposed
        const int off = (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * ld<HD>()
                        + pw * 16 + 8 * ((lane >> 3) & 1);
        unsigned ah[4], al[4];
        attn::ldsm_x4_trans(ah, Xh + off);
        attn::ldsm_x4_trans(al, Xl + off);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          unsigned bb[4];
          attn::ldsm_x4_trans(bb, Bs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld<N>()
                                      + nw * NCW + jp * 16 + 8 * (lane >> 4));
          attn::mma_bf16_16816(acc[2 * jp], ah, bb[0], bb[1]);
          attn::mma_bf16_16816(acc[2 * jp + 1], ah, bb[2], bb[3]);
          attn::mma_bf16_16816(acc[2 * jp], al, bb[0], bb[1]);
          attn::mma_bf16_16816(acc[2 * jp + 1], al, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                           // buffers and Xh, Xl are free
  }
  if (!active) return;
  float* out = states + ((((size_t)b * nc + c) * nh + h) * HD + pw * 16 + lane / 4) * N
               + nw * NCW + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (size_t)r * 8 * N + 8 * j) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
}

// pass 4.  grid (ceil(HD N / 256), nh, B), 256 threads, one state element a
// thread: the state entering each chunk (bf16) and the final state (f32)
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(
    const float* __restrict__ states, const float* __restrict__ cum,
    bf16* __restrict__ state_in, float* __restrict__ final_state, int nh,
    int S, int L, int hdn) {
  const int e = blockIdx.x * 256 + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (e >= hdn) return;
  const int nc = S / L;
  const float* totals = cum + ((size_t)b * nh + h) * S + L - 1;   // every L
  float st = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t o = (((size_t)b * nc + c) * nh + h) * hdn + e;
    state_in[o] = __float2bfloat16(st);
    const float et = expf(totals[(size_t)c * L]);
    st = st * et + states[o];
  }
  final_state[((size_t)b * nh + h) * hdn + e] = st;
}

// pass 5's shared memory: two key buffers (a C.B^T tile [RT][RT], then an
// x tile [RT][HD]); the second one first holds the C rows of the query tile
// [RT][N] and the entering state [HD][N], which only the inter-chunk
// product reads; then cum, dt and the column factors of the decay [LMAX]
template <int HD, int N>
struct ScanSmem {
  static constexpr int KEY = RT * ld<RT>() + RT * ld<HD>();      // elements
  static constexpr int CS = RT * ld<N>() + HD * ld<N>();
  static constexpr int SECOND = CS > KEY ? CS : KEY;
  static constexpr size_t bytes() {
    return sizeof(bf16) * (size_t)(KEY + SECOND) + sizeof(float) * 3 * LMAX;
  }
};

// pass 5.  grid (nh, nt, B n_chunks), PNT threads: y of one 64-row query
// tile of one chunk of one head; warp w owns rows 16 w .. 16 w + 15 and
// skips a key tile that none of its rows attends.  Below the diagonal
// (every row of the warp after every key of the tile) and where cum does
// not rise within the chunk (dA <= 0, as Mamba-2's A < 0, dt > 0 give
// it), exp(cum_i - cum_j) is taken as exp(cum_i - cum_r) exp(cum_r -
// cum_j), r the tile's last key: both factors lie in [0, 1], the column
// factors (with dt_j) are computed once a block, and a warp's rows need 2
// exps a tile instead of 32 a thread.
template <int HD, int N>
__global__ void __launch_bounds__(PNT) ssd_chunk_scan_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Cm,
    const bf16* __restrict__ cb, const bf16* __restrict__ state_in,
    const float* __restrict__ cum, const float* __restrict__ dtT,
    bf16* __restrict__ y, int nh, int S, int G, int L, int lt, SsdStrides sd) {
  using Sm = ScanSmem<HD, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* key0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* key1 = key0 + Sm::KEY;
  bf16* Cs = key1;                                   // [RT][N]  C, query rows
  bf16* Ss = Cs + RT * ld<N>();                      // [HD][N]  entering state
  float* cum_s = reinterpret_cast<float*>(key1 + Sm::SECOND);
  float* dt_s = cum_s + LMAX;
  float* f_s = dt_s + LMAX;                          // column factors
  constexpr int NO = HD / 8;                         // output n-tiles
  const int h = blockIdx.x, qt = blockIdx.y, nc = S / L;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int g = h / (nh / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w0 = qt * RT + warp * 16;                // the warp's first row
  const bool live = w0 < L;
  const int k_last = qt;
  const long long row0 = (long long)c * L;
  const size_t vo = ((size_t)b * nh + h) * S + (size_t)c * L;
  const bf16* cbq = cb + (((size_t)(b * G + g) * nc + c) * lt + qt * RT) * lt;
  const bf16* xc = x + b * sd.xb + row0 * sd.xs + (long long)h * HD;
  // key tile kt's C.B^T columns and x rows into a key buffer
  auto stage_key = [&](int kt, bf16* buf) {
    constexpr int CH = RT / 8;
    for (int idx = tid; idx < RT * CH; idx += PNT) {
      const int r = idx / CH, ch = idx % CH;
      attn::cp_async16(buf + r * ld<RT>() + ch * 8,
                       cbq + (size_t)r * lt + kt * RT + ch * 8, true);
    }
    stage_rows<HD>(buf + RT * ld<RT>(), xc, sd.xs, kt * RT, L, tid);
  };
  const int k_first = 0;                     // key tiles k_first .. k_last

  // one round of loads: cum, dt, C rows, the entering state, the first key
  // tile
  for (int i = tid; i < L; i += PNT) {
    attn::cp_async4(cum_s + i, cum + vo + i, true);
    attn::cp_async4(dt_s + i, dtT + vo + i, true);
  }
  stage_rows<N>(Cs, Cm + b * sd.cb + row0 * sd.cs + (long long)g * N, sd.cs,
                qt * RT, L, tid);
  {
    const bf16* src = state_in + (((size_t)b * nc + c) * nh + h) * HD * N;
    constexpr int CH = N / 8;
    for (int idx = tid; idx < HD * CH; idx += PNT) {
      const int r = idx / CH, ch = idx % CH;
      attn::cp_async16(Ss + r * ld<N>() + ch * 8, src + r * N + ch * 8, true);
    }
  }
  stage_key(k_first, key0);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();

  // whether cum falls (or stays) along the chunk; the column factors
  // exp(cum_r - cum_j) dt_j, r the last key of j's tile
  int ok = 1;
  for (int i = tid; i + 1 < L; i += PNT) ok &= cum_s[i + 1] <= cum_s[i];
  const bool falls = __syncthreads_and(ok);
  for (int j = tid; j < L; j += PNT) {
    const int r = min(j / RT * RT + RT - 1, L - 1);
    f_s[j] = exp2f((cum_s[r] - cum_s[j]) * LOG2E) * dt_s[j];
  }

  // inter-chunk: exp(cum_i) C_i . state_in^T
  float o[NO][4] = {};
  if (live) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      unsigned af[4];
      attn::ldsm_x4(af, Cs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld<N>()
                            + kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        unsigned kb[4];
        attn::ldsm_x4(kb, Ss + (j2 * 16 + (lane & 7) + 8 * (lane >> 4)) * ld<N>()
                              + kk * 16 + 8 * ((lane >> 3) & 1));
        attn::mma_bf16_16816(o[2 * j2], af, kb[0], kb[1]);
        attn::mma_bf16_16816(o[2 * j2 + 1], af, kb[2], kb[3]);
      }
    }
  }
  const int i_lo = w0 + lane / 4;                    // rows i_lo, i_lo + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_lo + 8 * r;
    const float e = i < L ? exp2f(cum_s[i] * LOG2E) : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * r] *= e;
      o[j][2 * r + 1] *= e;
    }
  }
  __syncthreads();                           // C and state read: key1 is free

  // intra-chunk: key tiles up to the diagonal, the next one in flight.  On
  // the diagonal, exp(cum_i - cum_j) dt_j where key j is attended, else 0
  // (masked before the exp, which may overflow above the diagonal)
  auto decay = [&](int i, int j) {
    return (j <= i && i < L) ? exp2f((cum_s[i] - cum_s[j]) * LOG2E) * dt_s[j] : 0.f;
  };
  for (int kt = k_first; kt <= k_last; ++kt) {
    const bf16* Ps = ((kt - k_first) & 1) ? key1 : key0;   // [RT][RT] C.B^T
    const bf16* Xs = Ps + RT * ld<RT>();                    // [RT][HD] x
    if (kt < k_last) {
      stage_key(kt + 1, ((kt - k_first) & 1) ? key0 : key1);
      attn::cp_async_commit();
    }
    if (live && w0 + 15 >= kt * RT) {        // some row of the warp attends
      const int r_key = min(kt * RT + RT - 1, L - 1);
      const bool below = falls && w0 > r_key;
      float grow[2];                         // exp(cum_i - cum_r) of the rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i_lo + 8 * r;
        grow[r] = (below && i < L) ? exp2f((cum_s[i] - cum_s[r_key]) * LOG2E) : 0.f;
      }
#pragma unroll
      for (int cc = 0; cc < RT / 16; ++cc) {
        // C.B^T as A fragments (rows i, keys j), scaled and masked in f32,
        // rounded to bf16
        unsigned pa[4];
        attn::ldsm_x4(pa, Ps + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld<RT>()
                              + cc * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i_lo + 8 * (q & 1);
          const int j = kt * RT + cc * 16 + 2 * (lane & 3) + 8 * (q >> 1);
          const float lo = __uint_as_float(pa[q] << 16);         // bf16 -> f32
          const float hi = __uint_as_float(pa[q] & 0xffff0000u);
          if (below)
            pa[q] = attn::pack_bf16x2(lo * (grow[q & 1] * f_s[j]),
                                      hi * (grow[q & 1] * f_s[j + 1]));
          else
            pa[q] = attn::pack_bf16x2(lo * decay(i, j), hi * decay(i, j + 1));
        }
#pragma unroll
        for (int j2 = 0; j2 < NO / 2; ++j2) {
          unsigned vb[4];
          attn::ldsm_x4_trans(vb, Xs + (cc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld<HD>()
                                      + j2 * 16 + 8 * (lane >> 4));
          attn::mma_bf16_16816(o[2 * j2], pa, vb[0], vb[1]);
          attn::mma_bf16_16816(o[2 * j2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    attn::cp_async_wait<0>();
    __syncthreads();                         // the next tile is in; this one is free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_lo + 8 * r;
    if (i >= L) continue;
    bf16* dst = y + (((size_t)b * S + row0 + i) * nh + h) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<unsigned*>(dst + 8 * j) = attn::pack_bf16x2(o[j][2 * r], o[j][2 * r + 1]);
  }
}

template <int HD, int N>
int launch_passes(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, void* y, void* state, void* ws_cum,
                  void* ws_dt, void* ws_cb, void* ws_states, void* ws_state_in,
                  int B, int nh, int S, int G, int L, const SsdStrides& sd,
                  cudaStream_t stream) {
  const int nc = S / L, nt = (L + RT - 1) / RT, lt = nt * RT;
  if ((long long)B * nc > 65535 || (long long)B * G > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  float* cum = static_cast<float*>(ws_cum);
  float* dtT = static_cast<float*>(ws_dt);
  bf16* cb = static_cast<bf16*>(ws_cb);
  float* states = static_cast<float*>(ws_states);
  bf16* s_in = static_cast<bf16*>(ws_state_in);
  cudaError_t err;

  ssd_cumsum_kernel<<<dim3(nc, nh, B), LMAX, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A), cum, dtT,
      nh, S, L, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_cb_kernel<N><<<dim3(nt * (nt + 1) / 2, nc, B * G), PNT, 0, stream>>>(
      Cb, Bb, cb, G, L, lt, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr size_t state_smem = state_smem_bytes<HD, N>();
  err = cudaFuncSetAttribute(ssd_chunk_state_kernel<HD, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)state_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<HD, N><<<dim3(nc, nh, B), SNT, state_smem, stream>>>(
      xb, Bb, cum, dtT, states, nh, S, G, L, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_pass_kernel<<<dim3((HD * N + 255) / 256, nh, B), 256, 0, stream>>>(
      states, cum, s_in, static_cast<float*>(state), nh, S, L, HD * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr size_t smem = ScanSmem<HD, N>::bytes();
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<HD, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<HD, N><<<dim3(nh, nt, B * nc), PNT, smem, stream>>>(
      xb, Cb, cb, s_in, cum, dtT, static_cast<bf16*>(y), nh, S, G, L, lt, sd);
  return (int)cudaGetLastError();
}

template <int HD, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* ws_cum, void* ws_dt,
           void* ws_cb, void* ws_states, void* ws_state_in, int B, int nh,
           int S, int G, int L, int is_bf16, const SsdStrides& sd,
           cudaStream_t stream) {
  if (is_bf16)
    return launch_passes<HD, N>(x, dt, A, Bm, Cm, y, state, ws_cum, ws_dt,
                                ws_cb, ws_states, ws_state_in, B, nh, S, G, L,
                                sd, stream);
  if (B > 65535) return (int)cudaErrorInvalidValue;
  return launch_f32<HD, N>(x, dt, A, Bm, Cm, y, state, B, nh, S, G, L, sd, stream);
}

}  // namespace

// is_bf16 picks the route: the five passes (bf16; ws_* is their scratch)
// or the f32 kernel (ws_* unused)
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, void* ws_cum, void* ws_dt,
                              void* ws_cb, void* ws_states, void* ws_state_in,
                              int B, int nh, int S, int hd, int G, int N,
                              int chunk, int is_bf16, int x_sb, int x_ss,
                              int dt_sb, int dt_ss, int b_sb, int b_ss,
                              int c_sb, int c_ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || nh < 1 || G < 1 || nh % G != 0 || chunk < 1 || chunk > LMAX ||
      S < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const SsdStrides sd{x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
#define SSD_ARGS x, dt, A, Bm, Cm, y, state, ws_cum, ws_dt, ws_cb, ws_states, \
                 ws_state_in, B, nh, S, G, chunk, is_bf16, sd, s
  if (hd == 128 && N == 128) return launch<128, 128>(SSD_ARGS);
  if (hd == 128 && N == 16) return launch<128, 16>(SSD_ARGS);
  if (hd == 64 && N == 128) return launch<64, 128>(SSD_ARGS);
  if (hd == 32 && N == 128) return launch<32, 128>(SSD_ARGS);
  if (hd == 64 && N == 16) return launch<64, 16>(SSD_ARGS);
  if (hd == 32 && N == 16) return launch<32, 16>(SSD_ARGS);
#undef SSD_ARGS
  return (int)cudaErrorInvalidValue;
}
