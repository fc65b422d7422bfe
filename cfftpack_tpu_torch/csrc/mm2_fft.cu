// K11 for Hopper: the two-matmul FFT of n = 128*m points, any integer
// 2 <= m <= 256, over (b, n) pairs of float32 re/im planes.
//
// Replaces the TPU kernel cfftpack_tpu/ops/pallas_stream.py:_mm2_2d
// (:762, body _make_mm2_kernel :706).  With the natural tile x[q, r] at
// flat index j = 128*q + r, both DFTs are dense matrix products:
//
//   S[k2, r]      = sum_q D_m[k2, q] x[q, r]         inner, over q
//   Y[k2, r]      = S[k2, r] * W_n^{r*k2}            outer twiddle
//   X[k2 + m*k1]  = sum_r Y[k2, r] D_128[r, k1]      outer, over r
//
// The spectrum leaves as (m, 128) tiles [k2, k1] (permuted, K2's layout)
// or in natural order (flat k2 + m*k1); the inverse mirrors the pipeline
// (outer product, conjugate twiddle, inner product) from either layout to
// natural order.
//
// What bounds it: operations.  The dense form does 8*128*m*(m + 128) real
// flops a transform in four-product complex arithmetic, against
// 5*n*log2(n) for a fast transform, so both products run on the tensor
// cores in the float32-accurate 3xTF32 split of cgemm.cuh (165 TFLOP/s of
// useful work at this card's peak; 48-58 reached on an NVIDIA H100 80GB
// HBM3 at 700 W, see cgemm.cuh for what holds the rest).
//
// * m <= 64 (n <= 8192), one kernel: a block of 256 threads takes whole
//   transforms into a 64-row tile in shared memory (64 KB as two planes:
//   one transform at m = 64, two stacked up to m = 32, four up to m = 16,
//   so D_128 is streamed once for all of them), streams the DFT matrix of
//   the first product through a ring of K chunks, holds the product in its
//   accumulators (64 a thread), multiplies by the twiddle and writes it
//   back over the tile in the layout the second product reads, streams the
//   second DFT matrix, and stores the result from the accumulators: device
//   memory is read once and written once, 16 bytes an element, as the TPU
//   kernel holds the transform on-chip.  The four IO forms are the indices
//   of the tile's load and the last store.  The product over the 128
//   columns sees the stacked rows as one matrix; the product over the rows
//   gives each warp columns of one transform.
// * m > 64: a transform with its ring passes what one block should hold
//   (at m = 256 the tile alone is 256 KB), so each direction is two passes
//   of cg_kernel through scratch planes the caller allocates (32 bytes an
//   element): D_m and D_128 are tiled and stay in L2, the twiddle rides in
//   the first pass's store, the layout in the operands' strides.
//
// Ragged m (3, 100, 255) is zero-filled in the copies and masked in the
// stores.
#include <cuda_runtime.h>

#include "cgemm.cuh"

#define MM2_N1 128
#define MM2_MAX_M 256
#define MM2_ONE_MAX_M 64
#define MM2_THREADS 256
#define MM2_ROWS 64  // rows of a block's tile
#define MM2_STAGES 2
// the tile's row stride as the B operand [q][r], as the A operand [k2][r],
// and of a ring chunk of D_128
#define MM2_LDB (MM2_N1 + 8)
#define MM2_LDA_IK (MM2_N1 + 4)

struct MM2Params {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  const float* dmr;  // (m, m), symmetric
  const float* dmi;
  const float* d1r;  // (128, 128)
  const float* d1i;
  const float* t1r;  // (m, 128) twiddle [k2][r]
  const float* t1i;
  int b, m, inverse, natural;
  int vec_x, vec_m, vec_d1, pair_y;
};

// f(row, col, re0, re1, im0, im1) for every pair of neighbouring columns
// that this thread's accumulators hold, rows and columns within the warp's
// (16*MT) x (8*NT) tile
template <int MT, int NT, class F>
__device__ __forceinline__ void mm2_each(const float (&cr)[MT][NT][4],
                                         const float (&ci)[MT][NT][4], F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(16 * mt + g + 8 * h, 8 * nt + 2 * t, cr[mt][nt][2 * h],
          cr[mt][nt][2 * h + 1], ci[mt][nt][2 * h], ci[mt][nt][2 * h + 1]);
}

// MP is m rounded up to 16, 32 or 64 rows; a block takes 64 / MP whole
// transforms, stacked as the 64 rows of one tile.
template <int MP>
struct MM2Tile {
  static constexpr int G = MM2_ROWS / MP;  // transforms a block
  // the inner product's warp tile: every warp holds 64 accumulators in
  // both products
  static constexpr int MTI = MP >= 32 ? 2 : 1;
  static constexpr int NTI = 8 / MTI;
  static constexpr int WIT = MP / (16 * MTI);       // warps down a transform
  static constexpr int WJT = MM2_N1 / (8 * NTI);    // and across it
  static_assert(G * WIT * WJT == MM2_THREADS / 32, "the warps cover the tile");
  static constexpr int LDM = MP + 8;            // a ring chunk of D_m: [q][k2]
  static constexpr int LDA_KI = MM2_ROWS + 8;   // the tile as [k1][row]
  static constexpr int T_PLANE = MM2_ROWS * MM2_LDB > MM2_N1 * LDA_KI
                                     ? MM2_ROWS * MM2_LDB
                                     : MM2_N1 * LDA_KI;
  static constexpr int RING_PLANE = CG_TK * MM2_LDB;
  static constexpr int SMEM_BYTES =
      4 * (2 * T_PLANE + MM2_STAGES * 2 * RING_PLANE);
};

template <int MP>
__global__ void __launch_bounds__(MM2_THREADS) mm2_one_kernel(MM2Params p) {
  using T = MM2Tile<MP>;
  constexpr int G = T::G, MTI = T::MTI, NTI = T::NTI;
  constexpr int MTO = 2, NTO = 4;  // the outer product: 2 x 4 warps of 32 x 32
  extern __shared__ __align__(16) float mm2_smem[];
  float* Tr = mm2_smem;
  float* Ti = Tr + T::T_PLANE;
  float* ring = Ti + T::T_PLANE;
  const int m = p.m;
  const long long n = (long long)MM2_N1 * m;
  const int warp = threadIdx.x >> 5;
  const long long bat0 = (long long)blockIdx.x * G;
  // the outer product's warp tile in the stacked rows
  const int ro = (warp & 1) * 32, co = (warp >> 1) * 32;
  // the inner product's: transform ti of the block, rows wi of it
  const int ti = warp / (T::WIT * T::WJT);
  const int wi = (warp % T::WIT) * (16 * MTI);
  const int ci = (warp % (T::WIT * T::WJT)) / T::WIT * (8 * NTI);
  const int ri = ti * MP + wi;

  float inr[MTI][NTI][4], ini[MTI][NTI][4];
  float our[MTO][NTO][4], oui[MTO][NTO][4];

  // acc = D_m . x of each transform: D_m streamed as A (i unit-stride: it
  // is symmetric), the transform resident as B [q][r] in its rows of the
  // tile
  auto inner = [&]() {
    const int col = cg_col<MP>(p.vec_m);
    cg_zero<MTI, NTI>(inr, ini);
    cg_pipeline<MM2_STAGES>(
        (m + CG_TK - 1) / CG_TK,
        [&](int c, int slot) {
          float* sr = ring + slot * 2 * T::RING_PLANE;
          const long long k0 = (long long)c * CG_TK;
          cg_copy_any<CG_TK, MP, MM2_THREADS>(
              p.vec_m, sr, sr + T::RING_PLANE, T::LDM, p.dmr + k0 * m,
              p.dmi + k0 * m, col, m, m - (int)k0, col < m);
        },
        [&](int c, int slot) {
          const float* sr = ring + slot * 2 * T::RING_PLANE;
          const int at = (ti * MP + c * CG_TK) * MM2_LDB + ci;
          cg_warp_mma<MTI, NTI>(inr, ini, sr + wi, sr + T::RING_PLANE + wi, 1,
                                T::LDM, Tr + at, Ti + at, MM2_LDB,
                                cg_ksteps(c * CG_TK, m));
        });
  };
  // acc = tile . D_128 over the stacked rows: the tile resident as A(row,
  // k) at row*a_si + k*a_sk, D_128 streamed as B
  auto outer = [&](int a_si, int a_sk) {
    const int col = cg_col<MM2_N1>(p.vec_d1);
    cg_zero<MTO, NTO>(our, oui);
    cg_pipeline<MM2_STAGES>(
        MM2_N1 / CG_TK,
        [&](int c, int slot) {
          float* sr = ring + slot * 2 * T::RING_PLANE;
          const int k0 = c * CG_TK;
          cg_copy_any<CG_TK, MM2_N1, MM2_THREADS>(
              p.vec_d1, sr, sr + T::RING_PLANE, MM2_LDB,
              p.d1r + k0 * MM2_N1, p.d1i + k0 * MM2_N1, col, MM2_N1, CG_TK,
              true);
        },
        [&](int c, int slot) {
          const float* sr = ring + slot * 2 * T::RING_PLANE;
          const int at = ro * a_si + c * CG_TK * a_sk;
          cg_warp_mma<MTO, NTO>(our, oui, Tr + at, Ti + at, a_si, a_sk,
                                sr + co, sr + T::RING_PLANE + co, MM2_LDB,
                                CG_TK / 8);
        });
  };
  // tile[row][col] = acc * t1[row % MP][col] at row stride ld, zero from row
  // m of a transform on; (r0, c0) is the warp tile's corner
  auto to_tile = [&](int r0, int c0, int ld) {
    return [=](int r, int c, float re0, float re1, float im0, float im1) {
      const int row = r0 + r, col = c0 + c, i = row & (MP - 1);
      float2 vr = make_float2(0.0f, 0.0f), vi = vr;
      if (i < m) {
        const float2 wr =
            *reinterpret_cast<const float2*>(p.t1r + i * MM2_N1 + col);
        const float2 wm =
            *reinterpret_cast<const float2*>(p.t1i + i * MM2_N1 + col);
        vr = make_float2(re0 * wr.x - im0 * wm.x, re1 * wr.y - im1 * wm.y);
        vi = make_float2(re0 * wm.x + im0 * wr.x, re1 * wm.y + im1 * wr.y);
      }
      *reinterpret_cast<float2*>(Tr + row * ld + col) = vr;
      *reinterpret_cast<float2*>(Ti + row * ld + col) = vi;
    };
  };
  // the result: C(i, j) of the transform a stacked row belongs to, at
  // i*c_si + j*c_sj in its planes
  auto to_planes = [&](int r0, int c0, long long c_si, long long c_sj,
                       bool pair) {
    return [=](int r, int c, float re0, float re1, float im0, float im1) {
      const int row = r0 + r, col = c0 + c, i = row & (MP - 1);
      const long long bat = bat0 + row / MP;
      if (i >= m || bat >= p.b) return;
      const long long at = bat * n + i * c_si + col * c_sj;
      if (pair) {
        *reinterpret_cast<float2*>(p.yr + at) = make_float2(re0, re1);
        *reinterpret_cast<float2*>(p.yi + at) = make_float2(im0, im1);
      } else {
        p.yr[at] = re0, p.yr[at + c_sj] = re1;
        p.yi[at] = im0, p.yi[at + c_sj] = im1;
      }
    };
  };
  // each transform's 128-float rows into its MP rows of the tile at row
  // stride ld; the copies land with the first chunk of the ring
  auto rows_in = [&](int ld) {
    const int col = cg_col<MM2_N1>(p.vec_x);
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const bool here = bat0 + t < p.b;
      const long long at = here ? (bat0 + t) * n : 0;
      cg_copy_any<MP, MM2_N1, MM2_THREADS>(
          p.vec_x, Tr + t * MP * ld, Ti + t * MP * ld, ld, p.xr + at,
          p.xi + at, col, MM2_N1, here ? m : 0, true);
    }
  };

  if (!p.inverse) {
    rows_in(MM2_LDB);  // x[q][r], the inner product's B
    inner();
    // Y[k2][r], the outer product's A
    mm2_each<MTI, NTI>(inr, ini, to_tile(ri, ci, MM2_LDA_IK));
    __syncthreads();
    outer(MM2_LDA_IK, 1);
    if (p.natural)  // X[k2 + m*k1]
      mm2_each<MTO, NTO>(our, oui, to_planes(ro, co, 1, m, false));
    else  // [k2][k1]
      mm2_each<MTO, NTO>(our, oui,
                         to_planes(ro, co, MM2_N1, 1, p.pair_y != 0));
  } else {
    // the spectrum as the outer product's A(k2, k1)
    if (p.natural) {
      // X[k2 + m*k1] as [k1][row]
      const bool vec = p.vec_m && p.vec_x;
      const int col = cg_col<MP>(vec);
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const bool here = bat0 + t < p.b;
        const long long at = here ? (bat0 + t) * n : 0;
        cg_copy_any<MM2_N1, MP, MM2_THREADS>(
            vec, Tr + t * MP, Ti + t * MP, T::LDA_KI, p.xr + at, p.xi + at,
            col, m, here ? MM2_N1 : 0, col < m);
      }
      outer(1, T::LDA_KI);
    } else {
      rows_in(MM2_LDA_IK);
      outer(MM2_LDA_IK, 1);
    }
    // Y[k2][r], the inner product's B
    mm2_each<MTO, NTO>(our, oui, to_tile(ro, co, MM2_LDB));
    __syncthreads();
    inner();
    // x[q][r]
    mm2_each<MTI, NTI>(inr, ini, to_planes(ri, ci, MM2_N1, 1, p.pair_y != 0));
  }
}

template <int MP>
static cudaError_t mm2_one_launch(const MM2Params& p, cudaStream_t st) {
  using T = MM2Tile<MP>;
  static CGOnce once;  // one for each MP
  cudaError_t err = cg_prepare(once, mm2_one_kernel<MP>, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  mm2_one_kernel<MP><<<(unsigned)((p.b + T::G - 1) / T::G), MM2_THREADS,
                       T::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

// One direction on `stream`.  x and y are the (b, n) input and output
// planes; dm (m, m) and d1 (128, 128) the DFT matrices and t1 the (m, 128)
// outer twiddle [k2][r], all in the transform's sign.  `natural` selects
// the spectrum's layout (the forward's output, the inverse's input):
// natural order, or permuted [k2][k1].  s is a pair of scratch planes of
// the size of x for m > 64, where the transform takes two passes; below
// that it is not read and may be null.  Returns the first CUDA error, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int mm2_fft_f32(const void* xr, const void* xi, void* yr, void* yi,
                           void* sr, void* si, const void* dmr,
                           const void* dmi, const void* d1r, const void* d1i,
                           const void* t1r, const void* t1i, int b, int m,
                           int inverse, int natural, void* stream) {
  if (b < 1 || m < 2 || m > MM2_MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)MM2_N1 * m;

  if (m <= MM2_ONE_MAX_M) {
    MM2Params q;
    q.xr = (const float*)xr, q.xi = (const float*)xi;
    q.yr = (float*)yr, q.yi = (float*)yi;
    q.dmr = (const float*)dmr, q.dmi = (const float*)dmi;
    q.d1r = (const float*)d1r, q.d1i = (const float*)d1i;
    q.t1r = (const float*)t1r, q.t1i = (const float*)t1i;
    q.b = b, q.m = m, q.inverse = inverse, q.natural = natural;
    q.vec_x = cg_aligned(xr, 16) && cg_aligned(xi, 16);
    q.vec_m = m % 4 == 0 && cg_aligned(dmr, 16) && cg_aligned(dmi, 16);
    q.vec_d1 = cg_aligned(d1r, 16) && cg_aligned(d1i, 16);
    q.pair_y = cg_aligned(yr, 8) && cg_aligned(yi, 8);
    if (!cg_aligned(t1r, 8) || !cg_aligned(t1i, 8))
      return (int)cudaErrorInvalidValue;
    if (m <= 16) return (int)mm2_one_launch<16>(q, st);
    if (m <= 32) return (int)mm2_one_launch<32>(q, st);
    return (int)mm2_one_launch<64>(q, st);
  }
  if (sr == nullptr || si == nullptr) return (int)cudaErrorInvalidValue;

  // the m-point product over the tile's rows; both DFT matrices are
  // symmetric, so A is read with i contiguous
  CGParams inner;
  inner.ar = (const float*)dmr;
  inner.ai = (const float*)dmi;
  inner.a_sb = 0, inner.a_si = 1, inner.a_sk = m;
  inner.b_sb = n, inner.b_sk = MM2_N1, inner.b_sj = 1;
  inner.c_sb = n, inner.c_si = MM2_N1, inner.c_sj = 1;
  inner.M = m, inner.N = MM2_N1, inner.K = m;

  // the 128-point product over the tile's columns
  CGParams outer;
  outer.br = (const float*)d1r;
  outer.bi = (const float*)d1i;
  outer.b_sb = 0, outer.b_sk = MM2_N1, outer.b_sj = 1;
  outer.a_sb = n, outer.c_sb = n;
  outer.M = m, outer.N = MM2_N1, outer.K = MM2_N1;

  if (!inverse) {
    inner.br = (const float*)xr;
    inner.bi = (const float*)xi;
    inner.cr = (float*)sr;
    inner.ci = (float*)si;
    inner.tr = (const float*)t1r;
    inner.ti = (const float*)t1i;
    cudaError_t err = cg_launch(inner, b, st);
    if (err != cudaSuccess) return (int)err;
    outer.ar = (const float*)sr;
    outer.ai = (const float*)si;
    outer.a_si = MM2_N1, outer.a_sk = 1;
    outer.cr = (float*)yr;
    outer.ci = (float*)yi;
    if (natural) {
      outer.c_si = 1, outer.c_sj = m;  // X[k2 + m*k1]
    } else {
      outer.c_si = MM2_N1, outer.c_sj = 1;  // [k2][k1]
    }
    outer.tr = nullptr;
    outer.ti = nullptr;
    return (int)cg_launch(outer, b, st);
  }
  outer.ar = (const float*)xr;
  outer.ai = (const float*)xi;
  if (natural) {
    outer.a_si = 1, outer.a_sk = m;
  } else {
    outer.a_si = MM2_N1, outer.a_sk = 1;
  }
  outer.cr = (float*)sr;
  outer.ci = (float*)si;
  outer.c_si = MM2_N1, outer.c_sj = 1;
  outer.tr = (const float*)t1r;
  outer.ti = (const float*)t1i;
  cudaError_t err = cg_launch(outer, b, st);
  if (err != cudaSuccess) return (int)err;
  inner.br = (const float*)sr;
  inner.bi = (const float*)si;
  inner.cr = (float*)yr;
  inner.ci = (float*)yi;
  inner.tr = nullptr;
  inner.ti = nullptr;
  return (int)cg_launch(inner, b, st);
}

// The product of cgemm.cuh alone, for checks against a float64 matmul:
// C = tw o (A . B) for `batch` matrices with every stride given in floats;
// tr and ti may be null.
extern "C" int cgemm_f32(const void* ar, const void* ai, long long a_sb,
                         long long a_si, long long a_sk, const void* br,
                         const void* bi, long long b_sb, long long b_sk,
                         long long b_sj, void* cr, void* ci, long long c_sb,
                         long long c_si, long long c_sj, const void* tr,
                         const void* ti, int M, int N, int K, int batch,
                         void* stream) {
  CGParams p;
  p.ar = (const float*)ar, p.ai = (const float*)ai;
  p.a_sb = a_sb, p.a_si = a_si, p.a_sk = a_sk;
  p.br = (const float*)br, p.bi = (const float*)bi;
  p.b_sb = b_sb, p.b_sk = b_sk, p.b_sj = b_sj;
  p.cr = (float*)cr, p.ci = (float*)ci;
  p.c_sb = c_sb, p.c_si = c_si, p.c_sj = c_sj;
  p.tr = (const float*)tr, p.ti = (const float*)ti;
  p.M = M, p.N = N, p.K = K;
  return (int)cg_launch(p, batch, (cudaStream_t)stream);
}
