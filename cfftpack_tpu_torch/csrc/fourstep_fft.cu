// K10 for Hopper: the four-step FFT of n = 64*n2 points, n2 in
// {16, 64, 256, 1024, 4096}, over (b, n) pairs of float32 re/im planes,
// natural order in and out, both signs.
//
// Replaces the TPU kernel
// cfftpack_tpu/ops/pallas_fourstep.py:_fourstep_pallas_2d (:225, body
// _make_kernel :121).  With j = j1*n2 + j2 and k = k1 + 64*k2,
//
//   X[k1 + 64*k2] = sum_j2 W_n2^{j2*k2} * W_n^{k1*j2}
//                   * sum_j1 x[j1*n2 + j2] W_64^{j1*k1}
//
// What bounds it: device-memory bytes, once the dense product is on the
// tensor cores.  The TPU kernel holds whole transforms in 100 MB of VMEM; a
// Hopper block has 227 KB of shared memory, less than one transform past
// n = 16384, so every length runs as two passes through a scratch pair of
// planes the caller allocates (32 bytes an element moved instead of 16).
// Neither pass reaches its 20 us of bytes at 2^22 elements yet: on an
// NVIDIA H100 80GB HBM3 at 700 W pass A takes 48 us from n = 16384 up
// (most of it what a warp issues around its mma, see cgemm.cuh; a block's
// store does not overlap its next product) and pass B 53-147 us.
//
// * pass A (fs_dft64_kernel): the dense 64-point DFT over j1 as a complex
//   matrix product D64 (64 x 64) times the transform viewed as (64, n2), on
//   the tensor cores in the float32-accurate 3xTF32 split of cgemm.cuh
//   (2.1 GFLOP at 2^22 elements: 13 us at the split's 165 TFLOP/s, under
//   the pass's 20 us of bytes).  D64 comes split into its TF32 halves from
//   the wrapper and stays in shared memory (72 KB) for the block's whole
//   life; one block an SM walks the 64 x 128 column tiles of the batch, the
//   next tile's 64 KB arriving by 16-byte cp.async while the current one is
//   multiplied, with the outer twiddle W_n^{k1*j2} in the store from the
//   accumulators; the scratch holds [k1][j2].  From n2 = 256 on a block
//   keeps to one column tile of every transform it visits, so its 64
//   twiddle values a thread stay in registers (read from the table in each
//   store they cost 15 of 60 us at n = 65536).  Below n2 = 128 a tile spans
//   the columns of `group` transforms of the batch (eight at n2 = 16), the
//   last group masked, so no part of a tile is idle at n = 1024; its
//   twiddle table is small enough for the L1 cache;
// * pass B (fs_row_kernel): the n2-point Stockham transform over j2 of R
//   rows k1 of one transform, contiguous in the scratch, through the
//   radix-4 stages of stream_pass.cuh (the TPU kernel's DFT-16 tail is two
//   of them), stored at k1 + 64*k2.  That store has a stride of 64
//   elements, so a block takes R consecutive k1 and writes runs of R
//   floats; the wrapper picks R, a power of two up to 32, as the widest
//   whose buffers fit 64 KB (three blocks an SM), and at least 2.  Rows in
//   shared memory are padded by 32/R words, which keeps the transposed
//   read of the store free of bank conflicts.
//
// The DFT matrix and the outer twiddle come in the transform's sign; the
// stage twiddles in the forward sign, conjugated in the stages.  Every
// block owns whole rows or whole tiles of one transform, so a ragged batch
// needs no mask past pass A's groups.  Offsets into the planes are 64-bit.
#include <cuda_runtime.h>

#define CG_PIECES_ONLY
#include "cgemm.cuh"
#include "stream_pass.cuh"

#define FS_N1 64
#define FS_MAX_THREADS 512
// pass A: 8 warps as 2 x 4, each 32 x 32 of a 64 x 128 tile
#define FS_TJ 128
#define FS_A_THREADS 256
#define FS_LDD (FS_N1 + 8)
#define FS_LDB (FS_TJ + 8)
#define FS_D_PLANE (FS_N1 * FS_LDD)
#define FS_B_PLANE (FS_N1 * FS_LDB)
#define FS_A_STAGES 2
#define FS_A_SMEM (4 * (4 * FS_D_PLANE + FS_A_STAGES * 2 * FS_B_PLANE))

// d4 is D64 as four (64, 64) planes: re and im of the TF32 hi half, then
// of the lo half.  Tile t of `tiles` takes columns of `group` transforms
// from transform t*group on (n2 < 128), or 128 columns of one transform.
// With TW_REGS (n2 >= 128) the grid is a multiple of the tiles a transform
// has, so every tile of a block has the same columns of the twiddle and
// they stay in registers; a tile that spans whole transforms reads the
// (64, n2) table, 32 KB at most, from the L1 cache.
template <bool TW_REGS>
__global__ void __launch_bounds__(FS_A_THREADS)
    fs_dft64_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ sr, float* __restrict__ si,
                    const float* __restrict__ d4, const float* __restrict__ t1r,
                    const float* __restrict__ t1i, int n2, long long b,
                    int group, long long tiles, int vec) {
  extern __shared__ __align__(16) float fsa_smem[];
  constexpr int MT = 2, NT = 4;
  float* sD = fsa_smem;
  float* ring = sD + 4 * FS_D_PLANE;
  const int warp = threadIdx.x >> 5;
  const int wi = (warp & 1) * 32, wj = (warp >> 1) * 32;
  const long long n = (long long)FS_N1 * n2;
  const int per = n2 / FS_TJ;  // tiles a transform, where group == 1

  // column c of tile t: its offset in a row of the planes, its column of
  // the twiddle, and whether it exists
  auto column = [=](long long t, int c, long long& off, int& twc) {
    if (group > 1) {
      const int q = c / n2;
      const long long bat = t * group + q;
      twc = c - q * n2;
      off = bat * n + twc;
      return q < group && bat < b;
    }
    twc = (int)(t % per) * FS_TJ + c;
    off = (t / per) * n + twc;
    return true;
  };

  // D64 is symmetric: its rows serve as [k][i]; it lands with tile 0
  {
    const int col = cg_col<FS_N1>(true);
    for (int h = 0; h < 2; ++h)
      cg_copy<FS_N1, FS_N1, FS_A_THREADS, true>(
          sD + 2 * h * FS_D_PLANE, sD + (2 * h + 1) * FS_D_PLANE, FS_LDD,
          d4 + 2 * h * FS_N1 * FS_N1, d4 + (2 * h + 1) * FS_N1 * FS_N1, col,
          FS_N1, FS_N1, true);
  }
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  float2 twr[MT][NT][2], twi[MT][NT][2];
  if (TW_REGS) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      long long off;
      int twc;
      column(blockIdx.x, wj + 8 * nt + 2 * q4, off, twc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long at =
              (long long)(wi + 16 * mt + g + 8 * h) * n2 + twc;
          twr[mt][nt][h] = *reinterpret_cast<const float2*>(t1r + at);
          twi[mt][nt][h] = *reinterpret_cast<const float2*>(t1i + at);
        }
    }
  }
  const int mine = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int lcol = cg_col<FS_TJ>(vec);
  cg_pipeline<FS_A_STAGES>(
      mine,
      [&](int c, int slot) {
        float* sBr = ring + slot * 2 * FS_B_PLANE;
        long long off;
        int twc;
        const bool ok =
            column(blockIdx.x + (long long)c * gridDim.x, lcol, off, twc);
        cg_copy_any<FS_N1, FS_TJ, FS_A_THREADS>(vec, sBr, sBr + FS_B_PLANE,
                                                FS_LDB, xr, xi, off, n2,
                                                FS_N1, ok);
      },
      [&](int c, int slot) {
        const float* sBr = ring + slot * 2 * FS_B_PLANE;
        const long long t = blockIdx.x + (long long)c * gridDim.x;
        float accr[MT][NT][4], acci[MT][NT][4];
        cg_zero<MT, NT>(accr, acci);
        cg_warp_mma<MT, NT, true>(accr, acci, sD + wi, sD + FS_D_PLANE + wi,
                                  1, FS_LDD, sBr + wj, sBr + FS_B_PLANE + wj,
                                  FS_LDB, FS_N1 / 8, 2 * FS_D_PLANE);
        if (!TW_REGS) {
          cg_store<MT, NT>(accr, acci, sr, si, n2, t1r, t1i, n2, wi, FS_N1,
                           true, [=](int cc, long long& off, int& twc) {
                             return column(t, wj + cc, off, twc);
                           });
          return;
        }
        // the store: acc * twiddle, pairs of neighbouring columns
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          long long off;
          int twc;
          if (!column(t, wj + 8 * nt + 2 * q4, off, twc)) continue;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long at =
                  (long long)(wi + 16 * mt + g + 8 * h) * n2 + off;
              const float2 wr = twr[mt][nt][h], wm = twi[mt][nt][h];
              const float r0 = accr[mt][nt][2 * h], r1 = accr[mt][nt][2 * h + 1];
              const float i0 = acci[mt][nt][2 * h], i1 = acci[mt][nt][2 * h + 1];
              *reinterpret_cast<float2*>(sr + at) = make_float2(
                  r0 * wr.x - i0 * wm.x, r1 * wr.y - i1 * wm.y);
              *reinterpret_cast<float2*>(si + at) = make_float2(
                  r0 * wm.x + i0 * wr.x, r1 * wm.y + i1 * wr.y);
            }
        }
      });
}

__global__ void __launch_bounds__(FS_MAX_THREADS)
    fs_row_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ twr, const float* __restrict__ twi,
                  int n2, int rshift, int inverse, SFPlan plan) {
  extern __shared__ __align__(16) float fs_smem[];
  const int R = 1 << rshift;
  const int G = FS_N1 >> rshift;
  const long long row = blockIdx.x / G;
  const int k10 = (int)(blockIdx.x % G) * R;
  const int rs = n2 + 32 / R;
  const int cnt = R * n2;
  float* ar = fs_smem;
  float* ai = ar + R * rs;
  float* br = ai + R * rs;
  float* bi = br + R * rs;
  const long long n = (long long)FS_N1 * n2;

  // rows k10 .. k10 + R - 1 of the scratch's (64, n2) are one run
  const long long in0 = row * n + (long long)k10 * n2;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int r = e / n2;
    const int j = e - r * n2;
    ar[r * rs + j] = xr[in0 + e];
    ai[r * rs + j] = xi[in0 + e];
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<false>(ar, ai, br, bi, R, n2, rs, 1, plan, twr, twi, inverse != 0,
                   &sr, &si);

  const long long out0 = row * n + k10;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int r = e & (R - 1);
    const int k2 = e >> rshift;
    yr[out0 + (long long)k2 * FS_N1 + r] = sr[r * rs + k2];
    yi[out0 + (long long)k2 * FS_N1 + r] = si[r * rs + k2];
  }
}

// Both passes on `stream`.  x and y are the (b, n) input and output
// planes, s the scratch planes of the same size; d4 the (64, 64) DFT
// matrix split into TF32 halves (re hi, im hi, re lo, im lo) and t1 the
// (64, n2) outer twiddle [k1][j2], both in the transform's sign; (tw, fac,
// off) the n2-point plan with forward-sign twiddles.  Returns the first
// CUDA error, or cudaErrorInvalidValue for arguments the kernels do not
// take.
extern "C" int fourstep_fft_f32(const void* xr, const void* xi, void* yr,
                                void* yi, void* sr, void* si, const void* d4,
                                const void* t1r, const void* t1i,
                                const void* twr, const void* twi, int nstages,
                                const int* fac, const int* off, int b, int n2,
                                int rshift, int inverse, void* stream) {
  SFPlan plan;
  if (b < 1 || n2 < 1 || rshift < 0 || rshift > 5 ||
      !sf_make_plan(&plan, n2, nstages, fac, off))
    return (int)cudaErrorInvalidValue;
  const int R = 1 << rshift;
  const size_t smem = 16 * (size_t)R * (size_t)(n2 + 32 / R);
  const long long grid = (long long)b * (FS_N1 >> rshift);
  if (smem > SF_SMEM_MAX || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;

  // pass A: a 128-column tile spans `group` whole transforms of the batch
  // below n2 = 128, the last group ragged, or is one of n2 / 128 tiles of a
  // transform; the float2 stores and 16-byte copies need their alignment
  const bool grouped = n2 < FS_TJ;
  if (grouped ? FS_TJ % n2 != 0 : n2 % FS_TJ != 0)
    return (int)cudaErrorInvalidValue;
  const int group = grouped ? FS_TJ / n2 : 1;
  const long long tiles = grouped ? ((long long)b + group - 1) / group
                                  : (long long)b * (n2 / FS_TJ);
  if (n2 % 4 != 0 || !cg_aligned(d4, 16) || !cg_aligned(sr, 8) ||
      !cg_aligned(si, 8) || !cg_aligned(t1r, 8) || !cg_aligned(t1i, 8))
    return (int)cudaErrorInvalidValue;
  static CGOnce once_a[2], once_b;
  auto* pass_a = grouped ? fs_dft64_kernel<false> : fs_dft64_kernel<true>;
  int sms = 0;
  cudaError_t err = cg_prepare(once_a[grouped], pass_a, FS_A_SMEM, &sms);
  if (err != cudaSuccess) return (int)err;
  const int vec = cg_aligned(xr, 16) && cg_aligned(xi, 16);
  // one block an SM, in whole transforms' worth of tiles
  const int tper = grouped ? 1 : n2 / FS_TJ;
  const long long blocks = tper > sms ? tper : sms / tper * tper;
  pass_a<<<(unsigned)(tiles < blocks ? tiles : blocks), FS_A_THREADS,
           FS_A_SMEM, st>>>(
      (const float*)xr, (const float*)xi, (float*)sr, (float*)si,
      (const float*)d4, (const float*)t1r, (const float*)t1i, n2, b, group,
      tiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the most a length asks for, so once serves every n2
  err = cg_prepare(once_b, fs_row_kernel, SF_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const int per = R * n2 / 4;  // butterflies a stage
  const int threads = per < FS_MAX_THREADS ? per : FS_MAX_THREADS;
  fs_row_kernel<<<(unsigned)grid, threads, smem, st>>>(
      (const float*)sr, (const float*)si, (float*)yr, (float*)yi,
      (const float*)twr, (const float*)twi, n2, rshift, inverse, plan);
  return (int)cudaGetLastError();
}
