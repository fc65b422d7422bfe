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
// What bounds it: device-memory bytes.  The TPU kernel holds whole
// transforms in 100 MB of VMEM; a Hopper block has 227 KB of shared
// memory, less than one transform past n = 16384, so every length runs
// as two passes through a scratch pair of planes the caller allocates
// (32 bytes an element moved instead of 16):
//
// * pass A (cg_kernel of cgemm.cuh): the dense 64-point DFT over j1 as a
//   complex matrix product D64 (64 x 64) times the transform viewed as
//   (64, n2), in full float32 on the CUDA cores, tiles of up to 64
//   contiguous j2, with the outer twiddle W_n^{k1*j2} in its store; the
//   scratch holds [k1][j2];
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
// needs no mask.  Offsets into the planes are 64-bit.
#include <cuda_runtime.h>

#include "cgemm.cuh"
#include "stream_pass.cuh"

#define FS_N1 64
#define FS_MAX_THREADS 512

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
// planes, s the scratch planes of the same size; d the (64, 64) DFT
// matrix and t1 the (64, n2) outer twiddle [k1][j2], both in the
// transform's sign; (tw, fac, off) the n2-point plan with forward-sign
// twiddles.  Returns the first CUDA error, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int fourstep_fft_f32(const void* xr, const void* xi, void* yr,
                                void* yi, void* sr, void* si, const void* dr,
                                const void* di, const void* t1r,
                                const void* t1i, const void* twr,
                                const void* twi, int nstages, const int* fac,
                                const int* off, int b, int n2, int rshift,
                                int inverse, void* stream) {
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
  const long long n = (long long)FS_N1 * n2;

  CGParams p;
  p.ar = (const float*)dr;  // D64 is symmetric: read it with i contiguous
  p.ai = (const float*)di;
  p.a_sb = 0, p.a_si = 1, p.a_sk = FS_N1;
  p.br = (const float*)xr;
  p.bi = (const float*)xi;
  p.b_sb = n, p.b_sk = n2, p.b_sj = 1;
  p.cr = (float*)sr;
  p.ci = (float*)si;
  p.c_sb = n, p.c_si = n2, p.c_sj = 1;
  p.tr = (const float*)t1r;
  p.ti = (const float*)t1i;
  p.M = FS_N1, p.N = n2, p.K = FS_N1;
  cudaError_t err = cg_launch(p, b, st);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(fs_row_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = R * n2 / 4;  // butterflies a stage
  const int threads = per < FS_MAX_THREADS ? per : FS_MAX_THREADS;
  fs_row_kernel<<<(unsigned)grid, threads, smem, st>>>(
      (const float*)sr, (const float*)si, (float*)yr, (float*)yi,
      (const float*)twr, (const float*)twi, n2, rshift, inverse, plan);
  return (int)cudaGetLastError();
}
