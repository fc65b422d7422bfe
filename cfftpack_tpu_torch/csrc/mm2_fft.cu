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
// natural order.  Those four IO cases are the strides of the products'
// operands.
//
// What bounds it: float32 operations.  The dense form does
// 8*128*m*(m + 128) real flops a transform in four-product complex
// arithmetic, against 5*n*log2(n) for a fast transform, so past small m
// the CUDA cores' float32 rate, not the memory, is the limit.  The
// products run in full float32 (no tensor cores: TF32's 10-bit mantissa
// breaks the 1e-5 bar).  A transform at m = 256 is 256 KB, more than a
// block's shared memory, so each direction is two passes of the tiled
// product of cgemm.cuh through scratch planes the caller allocates: D_m
// (512 KB at m = 256) and D_128 are tiled through shared memory and stay
// in L2, the twiddle rides in the first pass's store, the layout in the
// operands' strides.  Ragged m (3, 100, 255) is masked in the tiles.
#include <cuda_runtime.h>

#include "cgemm.cuh"

#define MM2_N1 128
#define MM2_MAX_M 256

// Both passes on `stream`.  x and y are the (b, n) input and output
// planes, s the scratch planes of the same size; dm (m, m) and d1
// (128, 128) the DFT matrices and t1 the (m, 128) outer twiddle
// [k2][r], all in the transform's sign.  `natural` selects the spectrum's
// layout (the forward's output, the inverse's input): natural order, or
// permuted [k2][k1].  Returns the first CUDA error, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int mm2_fft_f32(const void* xr, const void* xi, void* yr, void* yi,
                           void* sr, void* si, const void* dmr,
                           const void* dmi, const void* d1r, const void* d1i,
                           const void* t1r, const void* t1i, int b, int m,
                           int inverse, int natural, void* stream) {
  if (b < 1 || m < 2 || m > MM2_MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)MM2_N1 * m;

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
