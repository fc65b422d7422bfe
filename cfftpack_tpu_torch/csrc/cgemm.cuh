// A batched complex matrix product on split float32 planes, written for
// the dense-DFT passes of K10 (fourstep_fft.cu) and K11 (mm2_fft.cu):
//
//   C[bat][i][j] = tw[i][j] * sum_k A[bat][i][k] * B[bat][k][j]
//
// with i < M, j < N, k < K, every operand addressed through its own
// strides (a batch stride of 0 shares a DFT matrix among all transforms),
// and an optional (M, N) twiddle table in the store.  The strides carry
// the layouts of the callers: a natural or a permuted spectrum, a
// transposed read of a symmetric DFT matrix.
//
// What bounds it: float32 operations on the CUDA cores.  A complex
// multiply-add is four FMAs (the four-product form; no Karatsuba sum
// plane), all in full float32: no tensor cores, so no TF32 rounding.  A
// block of 256 threads computes a (16*MI) x 64 tile of C; a thread holds
// an MI x 4 micro-tile in registers and walks K in chunks of 32 through
// shared memory, A as [k][i] and B as [k][j], so every inner step reads
// MI + 4 complex values for 4*MI complex multiply-adds.  MI is 1, 2 or 4
// by M, so a short matrix (m = 2 or 16) does not pay for 64 rows.  Ragged
// edges (M, K any integers) are zero-filled in the loads and masked in
// the store.  The result passes through shared memory, so the store runs
// along whichever of i and j is contiguous in C.
#pragma once

#include <cuda_runtime.h>

#define CG_THREADS 256
#define CG_TJ 64
#define CG_TK 32
#define CG_SC (CG_TJ + 1)

struct CGParams {
  const float* ar;  // A[bat][i][k] at bat*a_sb + i*a_si + k*a_sk
  const float* ai;
  long long a_sb, a_si, a_sk;
  const float* br;  // B[bat][k][j] at bat*b_sb + k*b_sk + j*b_sj
  const float* bi;
  long long b_sb, b_sk, b_sj;
  float* cr;  // C[bat][i][j] at bat*c_sb + i*c_si + j*c_sj
  float* ci;
  long long c_sb, c_si, c_sj;
  const float* tr;  // (M, N) row-major twiddle, or nullptr
  const float* ti;
  int M, N, K;
  int tiles_i, tiles_j;  // set by cg_launch
};

// Internal linkage: each source that includes this header owns its copy.
namespace {

template <int MI>
struct CGTile {
  static constexpr int TI = 16 * MI;
  // row stride of the A chunk: a multiple of 4 floats past TI, so a
  // thread's MI values stay 16-byte aligned
  static constexpr int SA = TI + 4;
  static constexpr int A_FLOATS = CG_TK * SA;
  static constexpr int B_FLOATS = CG_TK * CG_TJ;
  static constexpr int C_FLOATS = TI * CG_SC;
  static constexpr int LOAD_FLOATS = 2 * (A_FLOATS + B_FLOATS);
  static constexpr int SMEM_FLOATS =
      LOAD_FLOATS > 2 * C_FLOATS ? LOAD_FLOATS : 2 * C_FLOATS;
};

template <int MI>
__global__ void __launch_bounds__(CG_THREADS) cg_kernel(CGParams p) {
  using T = CGTile<MI>;
  constexpr int TI = T::TI;
  constexpr int SA = T::SA;
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  float* sAr = smem;
  float* sAi = sAr + T::A_FLOATS;
  float* sBr = sAi + T::A_FLOATS;
  float* sBi = sBr + T::B_FLOATS;
  // the result tile reuses the chunks' memory after the last product
  float* sCr = smem;
  float* sCi = sCr + T::C_FLOATS;

  long long blk = blockIdx.x;
  const int j0 = (int)(blk % p.tiles_j) * CG_TJ;
  blk /= p.tiles_j;
  const int i0 = (int)(blk % p.tiles_i) * TI;
  const long long bat = blk / p.tiles_i;
  const float* __restrict__ Ar = p.ar + bat * p.a_sb;
  const float* __restrict__ Ai = p.ai + bat * p.a_sb;
  const float* __restrict__ Br = p.br + bat * p.b_sb;
  const float* __restrict__ Bi = p.bi + bat * p.b_sb;
  const int tx = threadIdx.x & 15;  // columns j = 4*tx .. 4*tx + 3
  const int ty = threadIdx.x >> 4;  // rows i = MI*ty .. MI*ty + MI - 1
  // consecutive threads follow the index that is contiguous in memory
  const bool a_ifast = p.a_si == 1;

  float accr[MI][4], acci[MI][4];
#pragma unroll
  for (int ii = 0; ii < MI; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) accr[ii][jj] = acci[ii][jj] = 0.0f;

  for (int k0 = 0; k0 < p.K; k0 += CG_TK) {
    for (int e = threadIdx.x; e < TI * CG_TK; e += CG_THREADS) {
      int i, k;
      if (a_ifast) {
        i = e % TI;
        k = e / TI;
      } else {
        k = e % CG_TK;
        i = e / CG_TK;
      }
      float vr = 0.0f, vi = 0.0f;
      if (i0 + i < p.M && k0 + k < p.K) {
        const long long g = (long long)(i0 + i) * p.a_si +
                            (long long)(k0 + k) * p.a_sk;
        vr = Ar[g];
        vi = Ai[g];
      }
      sAr[k * SA + i] = vr;
      sAi[k * SA + i] = vi;
    }
    for (int e = threadIdx.x; e < CG_TJ * CG_TK; e += CG_THREADS) {
      const int j = e % CG_TJ;
      const int k = e / CG_TJ;
      float vr = 0.0f, vi = 0.0f;
      if (k0 + k < p.K && j0 + j < p.N) {
        const long long g = (long long)(k0 + k) * p.b_sk +
                            (long long)(j0 + j) * p.b_sj;
        vr = Br[g];
        vi = Bi[g];
      }
      sBr[k * CG_TJ + j] = vr;
      sBi[k * CG_TJ + j] = vi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < CG_TK; ++k) {
      float a_r[MI], a_i[MI], b_r[4], b_i[4];
#pragma unroll
      for (int ii = 0; ii < MI; ++ii) {
        a_r[ii] = sAr[k * SA + MI * ty + ii];
        a_i[ii] = sAi[k * SA + MI * ty + ii];
      }
      const float4 br4 =
          *reinterpret_cast<const float4*>(&sBr[k * CG_TJ + 4 * tx]);
      const float4 bi4 =
          *reinterpret_cast<const float4*>(&sBi[k * CG_TJ + 4 * tx]);
      b_r[0] = br4.x, b_r[1] = br4.y, b_r[2] = br4.z, b_r[3] = br4.w;
      b_i[0] = bi4.x, b_i[1] = bi4.y, b_i[2] = bi4.z, b_i[3] = bi4.w;
#pragma unroll
      for (int ii = 0; ii < MI; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          accr[ii][jj] += a_r[ii] * b_r[jj] - a_i[ii] * b_i[jj];
          acci[ii][jj] += a_r[ii] * b_i[jj] + a_i[ii] * b_r[jj];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < MI; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      sCr[(MI * ty + ii) * CG_SC + 4 * tx + jj] = accr[ii][jj];
      sCi[(MI * ty + ii) * CG_SC + 4 * tx + jj] = acci[ii][jj];
    }
  __syncthreads();

  float* __restrict__ Cr = p.cr + bat * p.c_sb;
  float* __restrict__ Ci = p.ci + bat * p.c_sb;
  const bool c_ifast = p.c_si == 1 && p.c_sj != 1;
  for (int e = threadIdx.x; e < TI * CG_TJ; e += CG_THREADS) {
    int i, j;
    if (c_ifast) {
      i = e % TI;
      j = e / TI;
    } else {
      j = e % CG_TJ;
      i = e / CG_TJ;
    }
    if (i0 + i >= p.M || j0 + j >= p.N) continue;
    float vr = sCr[i * CG_SC + j], vi = sCi[i * CG_SC + j];
    if (p.tr != nullptr) {
      const long long t = (long long)(i0 + i) * p.N + (j0 + j);
      const float wr = p.tr[t], wi = p.ti[t];
      const float ur = vr * wr - vi * wi;
      vi = vr * wi + vi * wr;
      vr = ur;
    }
    const long long g =
        (long long)(i0 + i) * p.c_si + (long long)(j0 + j) * p.c_sj;
    Cr[g] = vr;
    Ci[g] = vi;
  }
}

// One product for `batch` matrices on `stream`; the tile height follows M.
static inline cudaError_t cg_launch(CGParams p, long long batch,
                                    cudaStream_t stream) {
  if (batch < 1 || p.M < 1 || p.N < 1 || p.K < 1)
    return cudaErrorInvalidValue;
  const int mi = p.M <= 16 ? 1 : (p.M <= 32 ? 2 : 4);
  const int ti = 16 * mi;
  p.tiles_i = (p.M + ti - 1) / ti;
  p.tiles_j = (p.N + CG_TJ - 1) / CG_TJ;
  const long long grid = batch * p.tiles_i * p.tiles_j;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (mi == 1)
    cg_kernel<1><<<(unsigned)grid, CG_THREADS, 0, stream>>>(p);
  else if (mi == 2)
    cg_kernel<2><<<(unsigned)grid, CG_THREADS, 0, stream>>>(p);
  else
    cg_kernel<4><<<(unsigned)grid, CG_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
