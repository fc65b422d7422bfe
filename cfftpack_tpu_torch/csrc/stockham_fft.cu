// K1 for Hopper: the whole mixed-radix Stockham DFT of each row of a
// (B, n) pair of re/im planes, held in shared memory.
//
// Replaces the TPU kernel cfftpack_tpu/ops/pallas_fft.py:_make_kernel
// (called through _sfft_pallas_2d and sfft_pallas).  It computes what
// that kernel computes: the unscaled forward or inverse DFT of every
// row, on the stage schedule of plan.factor(n).  Stage s with radix p,
// L = product of the earlier radices and mn = (remaining length) / p
// reads index (l*p + k)*mn + j, runs the p-point butterfly over k,
// multiplies output k by tw_s[k, j] (conjugated for the inverse) when
// mn > 1, and writes index (k*L + l)*mn + j, as cfftpack_tpu/ops/
// core.py:_stockham does.  Radix 2/3/4/5 use the closed forms and
// constants of core._butterfly; odd radices 7..31 are a dense p-term
// sum over plan.dft_matrix(p).
//
// What bounds it: device-memory bytes.  The ideal is one read and one
// write of both planes; everything between stays on chip.  Each block
// loads T whole rows with coalesced loads into one of two ping-pong
// buffers of both planes in dynamic shared memory (4*T*n*sizeof(scalar)
// bytes, at most 227 KB), runs every stage between them with a
// __syncthreads() after each, and stores coalesced.  The grid is
// ceil(B / T); the last block masks the ragged batch.  Twiddles and
// dense matrices are flat tables in device memory, read through the
// cache, kept once and not broadcast across lanes (the broadcast and
// the batch-in-lanes transpose of the Pallas kernel were Mosaic
// workarounds).
//
// Left for later: a register-resident last stage, vectorised 16-byte
// loads and stores, and fusing the rfft merge tables or the filter FMA
// into the epilogue.
#include <cuda_runtime.h>

#include "butterfly.cuh"

#define K1_MAX_STAGES 40
#define K1_MAX_THREADS 512

struct StagePlan {
  int nstages;
  int p[K1_MAX_STAGES];
  int tw_off[K1_MAX_STAGES];
  int dense_off[K1_MAX_STAGES];
};

// Applies the stage twiddle to butterfly output k and stores it.
template <typename T>
__device__ __forceinline__ void k1_emit(T* __restrict__ outr,
                                        T* __restrict__ outi, int out0,
                                        int ostride, int k, T vr, T vi,
                                        const T* __restrict__ twr,
                                        const T* __restrict__ twi,
                                        int twbase, int mn, bool inverse) {
  if (mn > 1) {
    const T wr = twr[twbase + k * mn];
    const T wi = inverse ? -twi[twbase + k * mn] : twi[twbase + k * mn];
    const T ur = vr * wr - vi * wi;
    const T ui = vr * wi + vi * wr;
    vr = ur;
    vi = ui;
  }
  outr[out0 + k * ostride] = vr;
  outi[out0 + k * ostride] = vi;
}

// One stage with a closed-form radix P over `rows` rows held in shared
// memory.  Consecutive threads take consecutive j, so reads and writes
// of one k are contiguous.
template <typename T, int P>
__device__ void k1_stage_fixed(const T* __restrict__ inr,
                               const T* __restrict__ ini,
                               T* __restrict__ outr, T* __restrict__ outi,
                               int rows, int n, int L, int mn,
                               const T* __restrict__ twr,
                               const T* __restrict__ twi, int tw_off,
                               bool inverse) {
  const int per = n / P;
  const int total = rows * per;
  const T sgn = inverse ? T(1) : T(-1);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int b = t / per;
    const int q = t - b * per;
    const int l = q / mn;
    const int j = q - l * mn;
    const int in0 = b * n + l * P * mn + j;
    const int out0 = b * n + l * mn + j;
    T R[P], I[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      R[k] = inr[in0 + k * mn];
      I[k] = ini[in0 + k * mn];
    }
    radix_butterfly<T, P>(R, I, sgn);
#pragma unroll
    for (int k = 0; k < P; ++k)
      k1_emit<T>(outr, outi, out0, L * mn, k, R[k], I[k], twr, twi,
                 tw_off + j, mn, inverse);
  }
}

// One stage with an odd radix 7..31: Y_k = sum_q D[k, q] X_q over the
// dense forward matrix D (conjugated for the inverse).
template <typename T>
__device__ void k1_stage_dense(const T* __restrict__ inr,
                               const T* __restrict__ ini,
                               T* __restrict__ outr, T* __restrict__ outi,
                               int rows, int n, int p, int L, int mn,
                               const T* __restrict__ twr,
                               const T* __restrict__ twi, int tw_off,
                               const T* __restrict__ dr,
                               const T* __restrict__ di, bool inverse) {
  const int per = n / p;
  const int total = rows * per;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int b = t / per;
    const int q = t - b * per;
    const int l = q / mn;
    const int j = q - l * mn;
    const int in0 = b * n + l * p * mn + j;
    const int out0 = b * n + l * mn + j;
    for (int k = 0; k < p; ++k) {
      T accr = T(0), acci = T(0);
      for (int c = 0; c < p; ++c) {
        const T mr = dr[k * p + c];
        const T mi = inverse ? -di[k * p + c] : di[k * p + c];
        const T xr = inr[in0 + c * mn];
        const T xi = ini[in0 + c * mn];
        accr += mr * xr - mi * xi;
        acci += mr * xi + mi * xr;
      }
      k1_emit<T>(outr, outi, out0, L * mn, k, accr, acci, twr, twi,
                 tw_off + j, mn, inverse);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(K1_MAX_THREADS)
    k1_stockham_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                       T* __restrict__ yr, T* __restrict__ yi,
                       const T* __restrict__ twr, const T* __restrict__ twi,
                       const T* __restrict__ dr, const T* __restrict__ di,
                       int B, int n, int tb, StagePlan plan, int inverse) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* s = reinterpret_cast<T*>(k1_smem);
  const int chunk = tb * n;
  T* ar = s;
  T* ai = s + chunk;
  T* br = s + 2 * chunk;
  T* bi = s + 3 * chunk;

  const long long row0 = (long long)blockIdx.x * tb;
  const int rows = (int)min((long long)tb, (long long)B - row0);
  const int cnt = rows * n;
  const long long g0 = row0 * n;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    ar[e] = xr[g0 + e];
    ai[e] = xi[g0 + e];
  }
  __syncthreads();

  const bool inv = inverse != 0;
  int L = 1, m = n;
  for (int st = 0; st < plan.nstages; ++st) {
    const int p = plan.p[st];
    const int mn = m / p;
    const int off = plan.tw_off[st];
    switch (p) {
      case 2:
        k1_stage_fixed<T, 2>(ar, ai, br, bi, rows, n, L, mn, twr, twi, off,
                             inv);
        break;
      case 3:
        k1_stage_fixed<T, 3>(ar, ai, br, bi, rows, n, L, mn, twr, twi, off,
                             inv);
        break;
      case 4:
        k1_stage_fixed<T, 4>(ar, ai, br, bi, rows, n, L, mn, twr, twi, off,
                             inv);
        break;
      case 5:
        k1_stage_fixed<T, 5>(ar, ai, br, bi, rows, n, L, mn, twr, twi, off,
                             inv);
        break;
      default:
        k1_stage_dense<T>(ar, ai, br, bi, rows, n, p, L, mn, twr, twi, off,
                          dr + plan.dense_off[st], di + plan.dense_off[st],
                          inv);
        break;
    }
    __syncthreads();
    T* tr = ar;
    ar = br;
    br = tr;
    T* ti = ai;
    ai = bi;
    bi = ti;
    L *= p;
    m = mn;
  }

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    yr[g0 + e] = ar[e];
    yi[g0 + e] = ai[e];
  }
}

template <typename T>
static int k1_launch(const void* xr, const void* xi, void* yr, void* yi,
                     const void* twr, const void* twi, const void* dr,
                     const void* di, int B, int n, int nstages,
                     const int* factors, const int* tw_offs,
                     const int* dense_offs, int inverse, int tb,
                     int threads, void* stream) {
  if (nstages < 1 || nstages > K1_MAX_STAGES || threads < 1 ||
      threads > K1_MAX_THREADS || tb < 1 || B < 1 || n < 2)
    return (int)cudaErrorInvalidValue;
  StagePlan plan;
  plan.nstages = nstages;
  for (int s = 0; s < nstages; ++s) {
    plan.p[s] = factors[s];
    plan.tw_off[s] = tw_offs[s];
    plan.dense_off[s] = dense_offs[s];
  }
  const size_t smem = 4 * (size_t)tb * (size_t)n * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      k1_stockham_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tb - 1) / tb;
  k1_stockham_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)xr, (const T*)xi, (T*)yr, (T*)yi, (const T*)twr,
      (const T*)twi, (const T*)dr, (const T*)di, B, n, tb, plan, inverse);
  return (int)cudaGetLastError();
}

extern "C" int cfft_stockham_f32(const void* xr, const void* xi, void* yr,
                                 void* yi, const void* twr, const void* twi,
                                 const void* dr, const void* di, int B,
                                 int n, int nstages, const int* factors,
                                 const int* tw_offs, const int* dense_offs,
                                 int inverse, int tb, int threads,
                                 void* stream) {
  return k1_launch<float>(xr, xi, yr, yi, twr, twi, dr, di, B, n, nstages,
                          factors, tw_offs, dense_offs, inverse, tb, threads,
                          stream);
}

extern "C" int cfft_stockham_f64(const void* xr, const void* xi, void* yr,
                                 void* yi, const void* twr, const void* twi,
                                 const void* dr, const void* di, int B,
                                 int n, int nstages, const int* factors,
                                 const int* tw_offs, const int* dense_offs,
                                 int inverse, int tb, int threads,
                                 void* stream) {
  return k1_launch<double>(xr, xi, yr, yi, twr, twi, dr, di, B, n, nstages,
                           factors, tw_offs, dense_offs, inverse, tb, threads,
                           stream);
}
