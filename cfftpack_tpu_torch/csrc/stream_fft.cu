// K2, K3 and K4 for Hopper: the streaming four-step FFT of n = 128*m
// points over (b, m, 128) pairs of float32 re/im planes.
//
// Replaces the TPU kernel cfftpack_tpu/ops/pallas_stream.py:_make_kernel
// (:249) in its five modes: fwd/inv (K2, through _stream_pallas_2d),
// fwd_nat/inv_nat (K3, through _stream_pallas_2d_nat) and filter (K4,
// through _stream_filter_inv_2d).  With the natural tile x[q, r] at flat
// index j = 128*q + r it computes
//
//   X[k2 + m*k1] = sum_r W_128^{r*k1} * W_n^{r*k2} * sum_q x[q, r] W_m^{q*k2}
//
// fwd:     natural (b, m, 128) -> permuted (b, m, 128), X[k2 + m*k1] at
//          [k2, k1];
// inv:     permuted -> natural, the unscaled conjugate transform;
// fwd_nat: natural (b, m, 128) -> natural spectrum (b, 128, m);
// inv_nat: natural spectrum (b, 128, m) -> natural (b, m, 128);
// filter:  inv on the permuted spectrum times a permuted (s, m, 128)
//          filter, slice (row % s) for batch row `row`.
//
// What bounds it: device-memory bytes.  The TPU kernel holds whole
// transforms in 100 MB of VMEM and reads and writes each element once.
// A Hopper block has 227 KB of shared memory, less than one transform
// past n = 16384, so each direction runs as two passes through a
// scratch pair of planes that the caller allocates:
//
// * the column pass: the m-point DFT over q of L lanes r of one row of
//   the batch, held in shared memory as [q][lane] (consecutive threads
//   on consecutive lanes, so each row segment is one coalesced read),
//   with the outer twiddle W_n^{r*k2} fused into its store (forward) or
//   its load (inverse).  The wrapper picks L, a power of two up to 32:
//   the widest whose two ping-pong buffers of both planes fit 64 KB, so
//   three blocks share an SM, and at least 2 (128 KB at m = 4096);
// * the row pass: the 128-point DFT over r of 16 rows k2 at a time,
//   whose 128 values are contiguous.  Its load does the K4 filter
//   multiply and the inv_nat transpose; its store the fwd_nat
//   transpose, each as runs of 16 contiguous k2 through shared memory.
//
// The forward runs column then row pass, the inverse row then column.
// That moves 32 bytes per complex element instead of the one-pass 16.
// A one-pass design (thread-block clusters with distributed shared
// memory, or TMA) is left for later.  Butterflies are the closed forms
// of radix 2/3/4/5 in full float32 (no tensor cores); stage twiddles
// and the outer twiddle are float64-built tables cast to float32.  The
// ragged batch needs no mask and no pad: every block owns whole rows.
// Offsets into the planes are 64-bit.  The pass bodies live in
// stream_pass.cuh, shared with K7 and K8 (rstream_fft.cu); this file
// gives them the IO of the five modes.
#include <cuda_runtime.h>

#include "stream_pass.cuh"

// Column-pass IO: (b, m, 128) planes in and out.
struct SFColIO {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  long long n;
  __device__ __forceinline__ void load(long long row, int j, float& vr,
                                       float& vi) const {
    vr = xr[row * n + j];
    vi = xi[row * n + j];
  }
  __device__ __forceinline__ void store(long long row, int j, float vr,
                                        float vi) const {
    yr[row * n + j] = vr;
    yi[row * n + j] = vi;
  }
};

// Row-pass IO: slot s is row k2 = k20 + s of transform `row`.  The input
// is (b, m, 128), or (b, 128, m) with load_t; the output (b, m, 128), or
// (b, 128, m) with store_t.  With a filter (fr != nullptr, nfilt slices
// of (m, 128)) the load multiplies by slice (row % nfilt).
struct SFRowIO {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  const float* __restrict__ fr;
  const float* __restrict__ fi;
  int nfilt;
  long long row;
  int k20, m;
  bool load_t, store_t;
  __device__ __forceinline__ long long at(int s, int c, bool nat) const {
    const long long base = row * (long long)m * SF_N1;
    return nat ? base + (long long)c * m + k20 + s
               : base + (long long)(k20 + s) * SF_N1 + c;
  }
  __device__ __forceinline__ void load(int s, int c, float& vr,
                                       float& vi) const {
    const long long g = at(s, c, load_t);
    vr = xr[g];
    vi = xi[g];
    if (fr != nullptr) {
      const long long f = (row % nfilt) * (long long)m * SF_N1 +
                          (long long)(k20 + s) * SF_N1 + c;
      sf_cmul(vr, vi, fr[f], fi[f]);
    }
  }
  __device__ __forceinline__ void store(const float* sr,
                                        const float* si) const {
    for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
      int s, c;
      sf_row_slot(e, store_t, s, c);
      const long long g = at(s, c, store_t);
      yr[g] = sr[s * SF_RS + c];
      yi[g] = si[s * SF_RS + c];
    }
  }
};

__global__ void __launch_bounds__(SF_COL_THREADS)
    sf_col_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ t1r, const float* __restrict__ t1i,
                  const float* __restrict__ twr, const float* __restrict__ twi,
                  int m, int lshift, int inverse, SFPlan plan) {
  extern __shared__ __align__(16) float sf_col_smem[];
  const SFColIO io{xr, xi, yr, yi, (long long)m * SF_N1};
  sf_col_pass(io, sf_col_smem, t1r, t1i, twr, twi, m, lshift, inverse != 0,
              plan);
}

// Row pass: block (row, g) takes rows k2 in [16g, 16g + 16).
__global__ void __launch_bounds__(SF_ROW_THREADS)
    sf_row_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ fr, const float* __restrict__ fi,
                  int nfilt, const float* __restrict__ twr,
                  const float* __restrict__ twi, int m, int load_nat,
                  int store_nat, int inverse, SFPlan plan) {
  __shared__ __align__(16) float sf_row_smem[4 * SF_ROWS * SF_RS];
  const int G = m / SF_ROWS;
  const SFRowIO io{xr, xi, yr, yi, fr, fi, nfilt,
                   (long long)(blockIdx.x / G),
                   (int)(blockIdx.x % G) * SF_ROWS, m, load_nat != 0,
                   store_nat != 0};
  sf_row_pass(io, sf_row_smem, twr, twi, inverse != 0, plan);
}

enum { SF_FWD = 0, SF_INV = 1, SF_FWD_NAT = 2, SF_INV_NAT = 3, SF_FILTER = 4 };

// Both passes of one mode on `stream`.  x and y are the input and output
// planes, s the (b, m, 128) scratch planes; t1 the outer twiddle in the
// mode's sign; (ctw, cfac, coff) the m-point plan of the column pass and
// (rtw, rfac, roff) the 128-point plan of the row pass, both with
// forward-sign twiddles; f the filter (mode 4 only).  Returns the first
// CUDA error, or cudaErrorInvalidValue for arguments the kernels do not
// take.
extern "C" int stream_fft_f32(
    const void* xr, const void* xi, void* yr, void* yi, void* sr, void* si,
    const void* t1r, const void* t1i, const void* ctwr, const void* ctwi,
    int cstages, const int* cfac, const int* coff, const void* rtwr,
    const void* rtwi, int rstages, const int* rfac, const int* roff,
    const void* fr, const void* fi, int nfilt, int b, int m, int mode,
    int lshift, void* stream) {
  SFPlan cplan, rplan;
  if (b < 1 || m < SF_ROWS || m % SF_ROWS || mode < SF_FWD ||
      mode > SF_FILTER || lshift < 0 || lshift > 7 ||
      !sf_make_plan(&cplan, m, cstages, cfac, coff) ||
      !sf_make_plan(&rplan, SF_N1, rstages, rfac, roff))
    return (int)cudaErrorInvalidValue;
  if (mode == SF_FILTER && (fr == nullptr || fi == nullptr || nfilt < 1))
    return (int)cudaErrorInvalidValue;
  const size_t csmem = 16 * (size_t)m * ((size_t)1 << lshift);
  const long long cgrid = (long long)b * (SF_N1 >> lshift);
  const long long rgrid = (long long)b * (m / SF_ROWS);
  if (csmem > SF_SMEM_MAX || cgrid > 0x7fffffffLL || rgrid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sf_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const bool inv = mode != SF_FWD && mode != SF_FWD_NAT;
  const float* F_r = mode == SF_FILTER ? (const float*)fr : nullptr;
  const float* F_i = mode == SF_FILTER ? (const float*)fi : nullptr;
  if (!inv) {
    sf_col_kernel<<<(unsigned)cgrid, SF_COL_THREADS, csmem, st>>>(
        (const float*)xr, (const float*)xi, (float*)sr, (float*)si,
        (const float*)t1r, (const float*)t1i, (const float*)ctwr,
        (const float*)ctwi, m, lshift, 0, cplan);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sf_row_kernel<<<(unsigned)rgrid, SF_ROW_THREADS, 0, st>>>(
        (const float*)sr, (const float*)si, (float*)yr, (float*)yi, nullptr,
        nullptr, 1, (const float*)rtwr, (const float*)rtwi, m, 0,
        mode == SF_FWD_NAT, 0, rplan);
    return (int)cudaGetLastError();
  }
  sf_row_kernel<<<(unsigned)rgrid, SF_ROW_THREADS, 0, st>>>(
      (const float*)xr, (const float*)xi, (float*)sr, (float*)si, F_r, F_i,
      nfilt, (const float*)rtwr, (const float*)rtwi, m, mode == SF_INV_NAT, 0,
      1, rplan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sf_col_kernel<<<(unsigned)cgrid, SF_COL_THREADS, csmem, st>>>(
      (const float*)sr, (const float*)si, (float*)yr, (float*)yi,
      (const float*)t1r, (const float*)t1i, (const float*)ctwr,
      (const float*)ctwi, m, lshift, 1, cplan);
  return (int)cudaGetLastError();
}
