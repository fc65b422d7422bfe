// K1 for Hopper: the whole mixed-radix Stockham DFT of each row of a
// (B, n) pair of re/im planes, on chip, one read and one write of each
// element, times `scale` in the store.
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
// write of both planes; everything between stays on chip.  Two kernels:
//
// * k1_reg_kernel, for the lengths the main path runs (480, 512, 960,
//   1024, 2048, 4096 and 8192 in float32, the same but 8192 in float64):
//   the plan's stages grouped into passes of radix up to 16 that run in
//   registers (regfft.cuh), a thread holding about 16 elements of one
//   row, so 1024 = (4*4)(4*4)(4) is three passes and two shared-memory
//   exchanges where the stage loop below has five stages and six
//   barriers.  Each schedule is compiled for its radices (no runtime
//   division by a radix, inner twiddles as literals).  The first pass
//   reads device memory and the last writes it, each warp access 32
//   consecutive elements (128 contiguous bytes in float32); one padded
//   buffer of both planes (a word after every 16) holds the rows between
//   passes.  The pass twiddles are one float64-built table read once per
//   butterfly output.  Rows a block (tb) come from the wrapper's measured
//   rule; threads = tb * ceil(n / 16).
// * k1_stockham_kernel, every other length K1 takes (the dense odd radices
//   among them): each block loads T whole rows with coalesced loads into
//   one of two ping-pong buffers of both planes in dynamic shared memory
//   (4*T*n*sizeof(scalar) bytes, at most 227 KB), runs every stage
//   between them with a __syncthreads() after each, and stores
//   coalesced.  Twiddles and dense matrices are flat tables in device
//   memory, read through the cache.
//
// The grid is ceil(B / T); the last block masks the ragged batch.  The
// host picks the kernel by length alone.  Left for later: fusing the rfft
// merge tables or the filter FMA into the epilogue.
#include <cuda_runtime.h>

#include "butterfly.cuh"
#include "regfft.cuh"

#define K1_MAX_STAGES 40
#define K1_MAX_THREADS 512
#define K1_MAX_DEVICES 64
// elements a thread holds in a register pass
#define K1_ELEMS 16

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
                       int B, int n, int tb, StagePlan plan, int inverse,
                       T scale) {
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
    yr[g0 + e] = scale * ar[e];
    yi[g0 + e] = scale * ai[e];
  }
}

// K1's IO in a register pass: row `row` of the planes, held in shared
// memory at sr, si with a pad word after every 16.
template <typename T>
struct K1RowIO {
  static constexpr bool last_in_smem = false;
  const T* __restrict__ xr;
  const T* __restrict__ xi;
  T* __restrict__ yr;
  T* __restrict__ yi;
  T* sr;
  T* si;
  long long g0;
  bool active;
  T scale;
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void gload(int e, T& vr, T& vi) const {
    vr = active ? xr[g0 + e] : T(0);
    vi = active ? xi[g0 + e] : T(0);
  }
  __device__ __forceinline__ void gstore(int e, T vr, T vi) const {
    if (active) {
      yr[g0 + e] = scale * vr;
      yi[g0 + e] = scale * vi;
    }
  }
};

template <typename T>
__host__ __device__ constexpr int k1_reg_threads() {
  return sizeof(T) == 4 ? 512 : 256;
}

// The padded row of a register schedule, in elements.
template <int N>
__host__ __device__ constexpr int k1_reg_row() {
  return N + (N >> 4);
}

// Rows [blockIdx.x * tb, + tb): thread tid of row rl runs its part of
// every pass.
template <typename T, int N, class... Ps>
__global__ void __launch_bounds__(k1_reg_threads<T>())
    k1_reg_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ yr, T* __restrict__ yi,
                  const T* __restrict__ ptw, int B, int tb, int inverse,
                  T scale) {
  extern __shared__ __align__(16) unsigned char k1_reg_smem[];
  constexpr int TPR = (N + K1_ELEMS - 1) / K1_ELEMS;
  constexpr int RS = k1_reg_row<N>();
  T* s = reinterpret_cast<T*>(k1_reg_smem);
  const int rl = threadIdx.x / TPR;
  const int tid = threadIdx.x - rl * TPR;
  const long long row = (long long)blockIdx.x * tb + rl;
  const K1RowIO<T> io{xr, xi, yr, yi, s + rl * RS, s + (tb + rl) * RS,
                      row * N, row < B, scale};
  rf_chain<T, N, TPR, 1, 0, true, K1RowIO<T>, Ps...>(
      io, tid, ptw, inverse ? T(1) : T(-1));
}

static bool k1_ready[2][K1_MAX_DEVICES];

// Raises a kernel's cap on dynamic shared memory to 227 KB, once per
// device and kernel.
template <class Kernel>
static cudaError_t k1_allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= K1_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

struct K1Args {
  const void *xr, *xi;
  void *yr, *yi;
  const void* ptw;
  int B, tb, threads, inverse;
  double scale;
};

template <typename T, int N, class... Ps>
static int k1_reg_launch(const K1Args& a, int nstages, const int* factors,
                         int npass, const int* pass_len,
                         cudaStream_t stream) {
  static bool ready[K1_MAX_DEVICES];
  constexpr int TPR = (N + K1_ELEMS - 1) / K1_ELEMS;
  if (!rf_matches<Ps...>(nstages, factors, npass, pass_len) ||
      a.threads != a.tb * TPR || a.threads > k1_reg_threads<T>())
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)a.tb * k1_reg_row<N>() * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = k1_allow_smem(k1_reg_kernel<T, N, Ps...>, ready);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.B + a.tb - 1) / a.tb;
  k1_reg_kernel<T, N, Ps...><<<grid, a.threads, smem, stream>>>(
      (const T*)a.xr, (const T*)a.xi, (T*)a.yr, (T*)a.yi, (const T*)a.ptw,
      a.B, a.tb, a.inverse, (T)a.scale);
  return (int)cudaGetLastError();
}

// The compiled register schedules: plan.factor(n) grouped greedily into
// passes of radix at most 16 (plan.reg_passes).
template <typename T>
static int k1_reg_dispatch(const K1Args& a, int n, int nstages,
                           const int* factors, int npass, const int* pass_len,
                           cudaStream_t st) {
  switch (n) {
    case 480:
      return k1_reg_launch<T, 480, RfPass<4, 4>, RfPass<2, 3>, RfPass<5>>(
          a, nstages, factors, npass, pass_len, st);
    case 512:
      return k1_reg_launch<T, 512, RfPass<4, 4>, RfPass<4, 4>, RfPass<2>>(
          a, nstages, factors, npass, pass_len, st);
    case 960:
      return k1_reg_launch<T, 960, RfPass<4, 4>, RfPass<4, 3>, RfPass<5>>(
          a, nstages, factors, npass, pass_len, st);
    case 1024:
      return k1_reg_launch<T, 1024, RfPass<4, 4>, RfPass<4, 4>, RfPass<4>>(
          a, nstages, factors, npass, pass_len, st);
    case 2048:
      return k1_reg_launch<T, 2048, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<4, 2>>(a, nstages, factors, npass, pass_len,
                                         st);
    case 4096:
      return k1_reg_launch<T, 4096, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<4, 4>>(a, nstages, factors, npass, pass_len,
                                         st);
    case 8192:
      if constexpr (sizeof(T) == 4)
        return k1_reg_launch<T, 8192, RfPass<4, 4>, RfPass<4, 4>,
                             RfPass<4, 4>, RfPass<2>>(a, nstages, factors,
                                                      npass, pass_len, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int k1_launch(const void* xr, const void* xi, void* yr, void* yi,
                     const void* twr, const void* twi, const void* dr,
                     const void* di, const void* ptw, int B, int n,
                     int nstages, const int* factors, const int* tw_offs,
                     const int* dense_offs, int npass, const int* pass_len,
                     int inverse, int tb, int threads, double scale,
                     void* stream) {
  if (nstages < 1 || nstages > K1_MAX_STAGES || threads < 1 ||
      threads > K1_MAX_THREADS || tb < 1 || B < 1 || n < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (npass > 0) {
    const K1Args a{xr, xi, yr, yi, ptw, B, tb, threads, inverse, scale};
    return k1_reg_dispatch<T>(a, n, nstages, factors, npass, pass_len, st);
  }
  StagePlan plan;
  plan.nstages = nstages;
  for (int s = 0; s < nstages; ++s) {
    plan.p[s] = factors[s];
    plan.tw_off[s] = tw_offs[s];
    plan.dense_off[s] = dense_offs[s];
  }
  const size_t smem = 4 * (size_t)tb * (size_t)n * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      k1_allow_smem(k1_stockham_kernel<T>, k1_ready[sizeof(T) == 8]);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tb - 1) / tb;
  k1_stockham_kernel<T><<<grid, threads, smem, st>>>(
      (const T*)xr, (const T*)xi, (T*)yr, (T*)yi, (const T*)twr,
      (const T*)twi, (const T*)dr, (const T*)di, B, n, tb, plan, inverse,
      (T)scale);
  return (int)cudaGetLastError();
}

// One launch of K1 on `stream`: the register kernel when npass > 0 (the
// passes group the stages `factors` by `pass_len`, and must be the
// schedule compiled for n), else the stage loop.  ptw is the register
// kernel's pass-twiddle table; (twr, twi, tw_offs) the stage tables and
// (dr, di, dense_offs) the dense radices of the stage loop.
extern "C" int cfft_stockham_f32(
    const void* xr, const void* xi, void* yr, void* yi, const void* twr,
    const void* twi, const void* dr, const void* di, const void* ptw, int B,
    int n, int nstages, const int* factors, const int* tw_offs,
    const int* dense_offs, int npass, const int* pass_len, int inverse,
    int tb, int threads, double scale, void* stream) {
  return k1_launch<float>(xr, xi, yr, yi, twr, twi, dr, di, ptw, B, n,
                          nstages, factors, tw_offs, dense_offs, npass,
                          pass_len, inverse, tb, threads, scale, stream);
}

extern "C" int cfft_stockham_f64(
    const void* xr, const void* xi, void* yr, void* yi, const void* twr,
    const void* twi, const void* dr, const void* di, const void* ptw, int B,
    int n, int nstages, const int* factors, const int* tw_offs,
    const int* dense_offs, int npass, const int* pass_len, int inverse,
    int tb, int threads, double scale, void* stream) {
  return k1_launch<double>(xr, xi, yr, yi, twr, twi, dr, di, ptw, B, n,
                           nstages, factors, tw_offs, dense_offs, npass,
                           pass_len, inverse, tb, threads, scale, stream);
}
