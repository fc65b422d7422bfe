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
// Offsets into the planes are 64-bit.
#include <cuda_runtime.h>

#include "butterfly.cuh"

#define SF_MAX_STAGES 16
#define SF_COL_THREADS 512
#define SF_ROW_THREADS 256
#define SF_N1 128
// rows k2 per row-pass block, and their padded stride in shared memory
// (130 words keeps the transposed loads and stores free of bank
// conflicts)
#define SF_ROWS 16
#define SF_RS 130
#define SF_SMEM_MAX 232448

struct SFPlan {
  int nstages;
  int p[SF_MAX_STAGES];
  int off[SF_MAX_STAGES];
};

// (vr, vi) *= (wr, wi)
__device__ __forceinline__ void sf_cmul(float& vr, float& vi, float wr,
                                        float wi) {
  const float ur = vr * wr - vi * wi;
  vi = vr * wi + vi * wr;
  vr = ur;
}

// One Stockham stage of radix P over `ntr` transforms of length N held in
// shared memory, element e of transform t at t*rs + e*es.  The stage
// reads index (l*P + k)*mn + j, runs the butterfly over k, multiplies
// output k by tw[off + k*mn + j] (conjugated for the inverse) and writes
// index (k*Lst + l)*mn + j, as cfftpack_tpu/ops/core.py:_stockham does.
// LANES_FAST maps consecutive threads to consecutive transforms (the
// column pass, es = lanes) instead of consecutive j (the row pass).
template <int P, bool LANES_FAST>
__device__ __forceinline__ void sf_stage(
    const float* __restrict__ ir, const float* __restrict__ ii,
    float* __restrict__ orr, float* __restrict__ oi, int ntr, int N, int Lst,
    int mn, int rs, int es, const float* __restrict__ twr,
    const float* __restrict__ twi, int off, bool inv) {
  const int per = N / P;
  const int total = ntr * per;
  const float sgn = inv ? 1.0f : -1.0f;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int tr, bf;
    if (LANES_FAST) {
      tr = t % ntr;
      bf = t / ntr;
    } else {
      bf = t % per;
      tr = t / per;
    }
    const int l = bf / mn;
    const int j = bf - l * mn;
    const int base = tr * rs;
    const int in0 = l * P * mn + j;
    const int out0 = l * mn + j;
    float R[P], I[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      R[k] = ir[base + (in0 + k * mn) * es];
      I[k] = ii[base + (in0 + k * mn) * es];
    }
    radix_butterfly<float, P>(R, I, sgn);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float vr = R[k], vi = I[k];
      if (k > 0 && mn > 1) {
        const float wi = twi[off + k * mn + j];
        sf_cmul(vr, vi, twr[off + k * mn + j], inv ? -wi : wi);
      }
      orr[base + (out0 + k * Lst * mn) * es] = vr;
      oi[base + (out0 + k * Lst * mn) * es] = vi;
    }
  }
}

// Every stage of `plan` between the ping-pong buffers (a, b); returns
// the buffer that holds the result in *outr, *outi.
template <bool LANES_FAST>
__device__ void sf_stages(float* ar, float* ai, float* br, float* bi,
                          int ntr, int N, int rs, int es, const SFPlan& plan,
                          const float* __restrict__ twr,
                          const float* __restrict__ twi, bool inv,
                          float** outr, float** outi) {
  int Lst = 1, rem = N;
  for (int st = 0; st < plan.nstages; ++st) {
    const int p = plan.p[st];
    const int mn = rem / p;
    const int off = plan.off[st];
    switch (p) {
      case 2:
        sf_stage<2, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      case 3:
        sf_stage<3, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      case 4:
        sf_stage<4, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      default:
        sf_stage<5, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
    }
    __syncthreads();
    float* tr = ar;
    ar = br;
    br = tr;
    float* ti = ai;
    ai = bi;
    bi = ti;
    Lst *= p;
    rem = mn;
  }
  *outr = ar;
  *outi = ai;
}

// Column pass: block (row, g) takes lanes [g*L, g*L + L) of one row of the
// batch; x and y are (b, m, 128).  The outer twiddle table t1 is (m, 128)
// in the transform's sign, read at the same in-row index as the data.
__global__ void __launch_bounds__(SF_COL_THREADS)
    sf_col_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ t1r, const float* __restrict__ t1i,
                  const float* __restrict__ twr, const float* __restrict__ twi,
                  int m, int lshift, int tw_at_load, int inverse,
                  SFPlan plan) {
  extern __shared__ __align__(16) float sf_col_smem[];
  const int L = 1 << lshift;
  const int G = SF_N1 >> lshift;
  const long long row = blockIdx.x / G;
  const int r0 = (int)(blockIdx.x % G) * L;
  const long long base = row * (long long)m * SF_N1;
  const int cnt = m * L;
  float* ar = sf_col_smem;
  float* ai = ar + cnt;
  float* br = ai + cnt;
  float* bi = br + cnt;

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int g = (e >> lshift) * SF_N1 + r0 + (e & (L - 1));
    float vr = xr[base + g], vi = xi[base + g];
    if (tw_at_load) sf_cmul(vr, vi, t1r[g], t1i[g]);
    ar[e] = vr;
    ai[e] = vi;
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<true>(ar, ai, br, bi, L, m, 1, L, plan, twr, twi, inverse != 0,
                  &sr, &si);

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int g = (e >> lshift) * SF_N1 + r0 + (e & (L - 1));
    float vr = sr[e], vi = si[e];
    if (!tw_at_load) sf_cmul(vr, vi, t1r[g], t1i[g]);
    yr[base + g] = vr;
    yi[base + g] = vi;
  }
}

// Row pass: block (row, g) takes rows k2 in [16g, 16g + 16) of one row of
// the batch.  The input is (b, m, 128), or (b, 128, m) with load_nat; the
// output (b, m, 128), or (b, 128, m) with store_nat.  With a filter
// (fr != nullptr, nfilt slices of (m, 128)) the load multiplies by slice
// (row % nfilt).
__global__ void __launch_bounds__(SF_ROW_THREADS)
    sf_row_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ fr, const float* __restrict__ fi,
                  int nfilt, const float* __restrict__ twr,
                  const float* __restrict__ twi, int m, int load_nat,
                  int store_nat, int inverse, SFPlan plan) {
  __shared__ __align__(16) float sf_row_smem[4 * SF_ROWS * SF_RS];
  const int G = m / SF_ROWS;
  const long long row = blockIdx.x / G;
  const int k20 = (int)(blockIdx.x % G) * SF_ROWS;
  const long long n = (long long)m * SF_N1;
  const long long base = row * n;
  const int cnt = SF_ROWS * SF_N1;
  float* ar = sf_row_smem;
  float* ai = ar + SF_ROWS * SF_RS;
  float* br = ai + SF_ROWS * SF_RS;
  float* bi = br + SF_ROWS * SF_RS;

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    int rr, c;
    long long g;
    if (load_nat) {
      rr = e % SF_ROWS;
      c = e / SF_ROWS;
      g = base + (long long)c * m + k20 + rr;
    } else {
      rr = e >> 7;
      c = e & (SF_N1 - 1);
      g = base + (long long)k20 * SF_N1 + e;
    }
    float vr = xr[g], vi = xi[g];
    if (fr != nullptr) {
      const long long f =
          (row % nfilt) * n + (long long)(k20 + rr) * SF_N1 + c;
      sf_cmul(vr, vi, fr[f], fi[f]);
    }
    ar[rr * SF_RS + c] = vr;
    ai[rr * SF_RS + c] = vi;
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<false>(ar, ai, br, bi, SF_ROWS, SF_N1, SF_RS, 1, plan, twr, twi,
                   inverse != 0, &sr, &si);

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    int rr, c;
    long long g;
    if (store_nat) {
      rr = e % SF_ROWS;
      c = e / SF_ROWS;
      g = base + (long long)c * m + k20 + rr;
    } else {
      rr = e >> 7;
      c = e & (SF_N1 - 1);
      g = base + (long long)k20 * SF_N1 + e;
    }
    yr[g] = sr[rr * SF_RS + c];
    yi[g] = si[rr * SF_RS + c];
  }
}

static bool sf_make_plan(SFPlan* plan, int N, int nstages, const int* factors,
                         const int* offs) {
  if (nstages < 1 || nstages > SF_MAX_STAGES) return false;
  long long prod = 1;
  plan->nstages = nstages;
  for (int s = 0; s < nstages; ++s) {
    const int p = factors[s];
    if (p < 2 || p > 5) return false;
    plan->p[s] = p;
    plan->off[s] = offs[s];
    prod *= p;
  }
  return prod == N;
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
        (const float*)ctwi, m, lshift, 0, 0, cplan);
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
      (const float*)ctwi, m, lshift, 1, 1, cplan);
  return (int)cudaGetLastError();
}
