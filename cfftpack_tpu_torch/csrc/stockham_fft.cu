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
// host picks the kernel by length alone.
//
// The interleaved complex mode (C entries k1_cplx_f32/f64, K1CplxIO) is
// K1RowIO's transform on one buffer of (re, im) pairs, as a complex64 or
// complex128 tensor holds them: the first pass loads a pair with one
// 8-byte (16 in float64) read and the last stores the scaled pair, so
// fft/ifft of such rows need no copy into planes and no join after.
//
// The real modes (C entries k1_real_f32/f64) are two more IO policies of
// k1_reg_kernel at the half length h = n/2 of a real transform, one launch
// where the real route ran K1 between strided copies, a packed merge or
// unmerge, a scale and an interleave.  r2c (K1RealFwdIO) reads the real
// row as h complex pairs x[2e] + i x[2e+1], runs the forward passes, and
// leaves the last in shared memory, where an epilogue writes the h + 1
// packed bins as a 4-term table FMA over Z[k] and its mirror Z[h - k].
// c2r (K1RealInvIO) starts with a prologue that reads bins k and h - k of
// the packed planes and writes the unmerge table FMA over them into
// shared memory, runs the inverse passes, and stores each z_e as the
// interleaved pair (x[2e], x[2e+1]).  A thread takes a bin and its mirror
// for every row of the block, so a block reads each table row once.
// Both take their coefficients as one float64-built table of 8 per bin
// (ops/fused_fft.py) and the scale in the store, so a table set and its
// transpose give a mode and its adjoint.  Left for later: the filter FMA
// of a conv step.
#include <cuda_runtime.h>

#include "butterfly.cuh"
#include "regfft.cuh"

#define K1_MAX_STAGES 40
#define K1_MAX_THREADS 512
#define K1_MAX_DEVICES 64
// elements a thread holds in a register pass
#define K1_ELEMS 16
// rows a block of a real mode (the c2r prologue holds them all at once)
#define K1_REAL_MAX_TB 4

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

template <typename T>
__host__ __device__ constexpr int k1_reg_threads() {
  return sizeof(T) == 4 ? 512 : 256;
}

// The padded row of a register schedule, in elements.
template <int N>
__host__ __device__ constexpr int k1_reg_row() {
  return N + (N >> 4);
}

// Where an IO of a register launch finds its data: the kernel's pointers
// (inputs a0, a1, outputs b0, b1, a mode's table), the block's shared
// rows s (row r's planes at s + r*RS and s + (tb + r)*RS), the block's
// first row row0 of B, and this thread's row rl of the block.
template <typename T>
struct K1Block {
  const T* a0;
  const T* a1;
  T* b0;
  T* b1;
  const T* tab;
  T* s;
  int tb, rl, B;
  long long row0;
  T scale;
};

// K1's IO in a register pass (the complex mode): row `row` of the planes
// (a0, a1) -> (b0, b1), held in shared memory at sr, si with a pad word
// after every 16.
template <typename T, int N>
struct K1RowIO {
  static constexpr bool first_in_smem = false;
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
  static __device__ __forceinline__ K1RowIO at(const K1Block<T>& k) {
    constexpr int RS = k1_reg_row<N>();
    return {k.a0, k.a1, k.b0, k.b1, k.s + k.rl * RS, k.s + (k.tb + k.rl) * RS,
            (k.row0 + k.rl) * N, k.row0 + k.rl < k.B, k.scale};
  }
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

// K1's IO in a register pass (the interleaved complex mode): row `row` of
// the interleaved buffer a0 (N (re, im) pairs, torch.view_as_real of a
// complex tensor), one 8-byte load a pair (16 in float64), -> the
// interleaved row of b0, the scaled pair in one store, held in shared
// memory between passes as K1RowIO holds it.
template <typename T, int N>
struct K1CplxIO {
  using T2 = typename RfVec<T>::type;
  static constexpr bool first_in_smem = false;
  static constexpr bool last_in_smem = false;
  const T2* __restrict__ x;
  T2* __restrict__ y;
  T* sr;
  T* si;
  bool active;
  T scale;
  static __device__ __forceinline__ K1CplxIO at(const K1Block<T>& k) {
    constexpr int RS = k1_reg_row<N>();
    const long long row = k.row0 + k.rl;
    return {reinterpret_cast<const T2*>(k.a0) + row * N,
            reinterpret_cast<T2*>(k.b0) + row * N, k.s + k.rl * RS,
            k.s + (k.tb + k.rl) * RS, row < k.B, k.scale};
  }
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void gload(int e, T& vr, T& vi) const {
    if (active) {
      const T2 v = x[e];
      vr = v.x;
      vi = v.y;
    } else {
      vr = vi = T(0);
    }
  }
  __device__ __forceinline__ void gstore(int e, T vr, T vi) const {
    if (active) {
      T2 v;
      v.x = scale * vr;
      v.y = scale * vi;
      y[e] = v;
    }
  }
};

// Row k of a real mode's coefficient table (bins, 8): two 16-byte loads
// in float32, four in float64.
__device__ __forceinline__ void k1_coeffs(const float* __restrict__ tab,
                                          int k, float* c) {
  const float4* p = reinterpret_cast<const float4*>(tab) + 2 * k;
  const float4 u = __ldg(p), v = __ldg(p + 1);
  c[0] = u.x;
  c[1] = u.y;
  c[2] = u.z;
  c[3] = u.w;
  c[4] = v.x;
  c[5] = v.y;
  c[6] = v.z;
  c[7] = v.w;
}

__device__ __forceinline__ void k1_coeffs(const double* __restrict__ tab,
                                          int k, double* c) {
  const double2* p = reinterpret_cast<const double2*>(tab) + 4 * k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 u = __ldg(p + i);
    c[2 * i] = u.x;
    c[2 * i + 1] = u.y;
  }
}

// The real modes pair bin p with its mirror N - p, p = 0 .. N/2: both
// read Z (or y) at p and N - p, so one thread takes both, for every row
// of the block (a table row is read once a block).

// The r2c mode's IO, N = n/2: the first pass reads real row `row` of a0
// (2N values) as N complex pairs z_e = x[2e] + i x[2e+1], one 8-byte load
// a pair (16 in float64); the last pass leaves Z = DFT_N(z) in shared
// memory, and the epilogue writes bins k = 0 .. N of the packed spectrum
// into rows of N + 1 of b0, b1:
//   yr[k] = scale * (c0 Zr + c1 Zi + c2 Zmr + c3 Zmi),
//   yi[k] = scale * (c4 Zr + c5 Zi + c6 Zmr + c7 Zmi),
// Z = Z[k % N], Zm = Z[(N - k) % N], c row k of the table (N + 1 rows).
// Bins 0 and N read Z[0] twice and have rows of their own, so DC and
// Nyquist need no branch; with their c4..c7 zero, imag is an exact zero.
template <typename T, int N>
struct K1RealFwdIO {
  using T2 = typename RfVec<T>::type;
  static constexpr bool first_in_smem = false;
  static constexpr bool last_in_smem = true;
  static constexpr int RS = k1_reg_row<N>();
  const T2* __restrict__ x;
  T* __restrict__ yr;
  T* __restrict__ yi;
  const T* __restrict__ tab;
  T* sr;
  T* si;
  T* s;
  int tb, rows;
  bool active;
  T scale;
  static __device__ __forceinline__ K1RealFwdIO at(const K1Block<T>& k) {
    const long long row = k.row0 + k.rl;
    return {reinterpret_cast<const T2*>(k.a0) + row * N,
            k.b0 + k.row0 * (N + 1), k.b1 + k.row0 * (N + 1), k.tab,
            k.s + k.rl * RS, k.s + (k.tb + k.rl) * RS, k.s, k.tb,
            (int)min((long long)k.tb, k.B - k.row0), row < k.B, k.scale};
  }
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void gload(int e, T& vr, T& vi) const {
    if (active) {
      const T2 v = x[e];
      vr = v.x;
      vi = v.y;
    } else {
      vr = vi = T(0);
    }
  }
  // Bins p and N - p of every row of the block.
  __device__ __forceinline__ void epilogue() const {
    for (int p = threadIdx.x; 2 * p <= N; p += blockDim.x) {
      const int q = N - p;
      const int a = sidx(p), m = sidx(q % N);
      T c[8], d[8];
      k1_coeffs(tab, p, c);
      k1_coeffs(tab, q, d);
      for (int r = 0; r < rows; ++r) {
        const T* pr = s + r * RS;
        const T* pi = s + (tb + r) * RS;
        const T zr = pr[a], zi = pi[a], mr = pr[m], mi = pi[m];
        T* outr = yr + r * (N + 1);
        T* outi = yi + r * (N + 1);
        outr[p] = scale * (c[0] * zr + c[1] * zi + c[2] * mr + c[3] * mi);
        outi[p] = scale * (c[4] * zr + c[5] * zi + c[6] * mr + c[7] * mi);
        if (q != p) {
          outr[q] = scale * (d[0] * mr + d[1] * mi + d[2] * zr + d[3] * zi);
          outi[q] = scale * (d[4] * mr + d[5] * mi + d[6] * zr + d[7] * zi);
        }
      }
    }
  }
};

// The c2r mode's IO, N = n/2: a prologue reads the packed planes a0, a1
// (rows of N + 1) of every row of the block, a thread the pair of bins
// (p, N - p) of each row (both reads coalesced, one ascending and one
// descending; the table rows read once a block), and writes into the
// rows' shared planes
//   Zr[e] = c0 yr[e] + c1 yi[e] + c2 yr[N - e] + c3 yi[N - e],
//   Zi[e] = c4 yr[e] + c5 yi[e] + c6 yr[N - e] + c7 yi[N - e]
// for e = p and N - p, c row e of the table (N rows).  The first pass
// reads Z there, and the last writes z = IDFT_N(Z) into real row `row` of
// b0 (2N values) as x[2e] = scale Re z_e, x[2e+1] = scale Im z_e, one
// 8-byte store a pair (16 in float64).
template <typename T, int N>
struct K1RealInvIO {
  using T2 = typename RfVec<T>::type;
  static constexpr bool first_in_smem = true;
  static constexpr bool last_in_smem = false;
  static constexpr int RS = k1_reg_row<N>();
  const T* __restrict__ yr;
  const T* __restrict__ yi;
  T2* __restrict__ x;
  const T* __restrict__ tab;
  T* sr;
  T* si;
  T* s;
  int tb, rows;
  bool active;
  T scale;
  static __device__ __forceinline__ K1RealInvIO at(const K1Block<T>& k) {
    const long long row = k.row0 + k.rl;
    return {k.a0 + k.row0 * (N + 1), k.a1 + k.row0 * (N + 1),
            reinterpret_cast<T2*>(k.b0) + row * N, k.tab, k.s + k.rl * RS,
            k.s + (k.tb + k.rl) * RS, k.s, k.tb,
            (int)min((long long)k.tb, k.B - k.row0), row < k.B, k.scale};
  }
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void prologue() const {
    for (int p = threadIdx.x; 2 * p <= N; p += blockDim.x) {
      const int q = N - p;
      T ar[K1_REAL_MAX_TB], ai[K1_REAL_MAX_TB];
      T mr[K1_REAL_MAX_TB], mi[K1_REAL_MAX_TB];
#pragma unroll
      for (int r = 0; r < K1_REAL_MAX_TB; ++r) {
        if (r < rows) {
          ar[r] = yr[r * (N + 1) + p];
          ai[r] = yi[r * (N + 1) + p];
          mr[r] = yr[r * (N + 1) + q];
          mi[r] = yi[r * (N + 1) + q];
        }
      }
      T c[8];
      k1_coeffs(tab, p, c);
#pragma unroll
      for (int r = 0; r < K1_REAL_MAX_TB; ++r) {
        if (r < rows) {
          s[r * RS + sidx(p)] =
              c[0] * ar[r] + c[1] * ai[r] + c[2] * mr[r] + c[3] * mi[r];
          s[(tb + r) * RS + sidx(p)] =
              c[4] * ar[r] + c[5] * ai[r] + c[6] * mr[r] + c[7] * mi[r];
        }
      }
      if (p > 0 && q != p) {
        k1_coeffs(tab, q, c);
#pragma unroll
        for (int r = 0; r < K1_REAL_MAX_TB; ++r) {
          if (r < rows) {
            s[r * RS + sidx(q)] =
                c[0] * mr[r] + c[1] * mi[r] + c[2] * ar[r] + c[3] * ai[r];
            s[(tb + r) * RS + sidx(q)] =
                c[4] * mr[r] + c[5] * mi[r] + c[6] * ar[r] + c[7] * ai[r];
          }
        }
      }
    }
  }
  __device__ __forceinline__ void gstore(int e, T vr, T vi) const {
    if (active) {
      T2 v;
      v.x = scale * vr;
      v.y = scale * vi;
      x[e] = v;
    }
  }
};

// Rows [blockIdx.x * tb, + tb): thread tid of row rl runs its part of
// every pass through the mode's IO; an IO whose first pass reads shared
// memory has its prologue run before it, one that leaves the last pass
// there its epilogue after it.
template <typename T, int N, class IO, class... Ps>
__global__ void __launch_bounds__(k1_reg_threads<T>())
    k1_reg_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                  T* __restrict__ b0, T* __restrict__ b1,
                  const T* __restrict__ tab, const T* __restrict__ ptw,
                  int B, int tb, int inverse, T scale) {
  extern __shared__ __align__(16) unsigned char k1_reg_smem[];
  constexpr int TPR = (N + K1_ELEMS - 1) / K1_ELEMS;
  T* s = reinterpret_cast<T*>(k1_reg_smem);
  const int rl = threadIdx.x / TPR;
  const int tid = threadIdx.x - rl * TPR;
  const IO io = IO::at(K1Block<T>{a0, a1, b0, b1, tab, s, tb, rl, B,
                                  (long long)blockIdx.x * tb, scale});
  if constexpr (IO::first_in_smem) {
    io.prologue();
    __syncthreads();
  }
  rf_chain<T, N, TPR, 1, 0, !IO::first_in_smem, IO, Ps...>(
      io, tid, ptw, inverse ? T(1) : T(-1));
  if constexpr (IO::last_in_smem) io.epilogue();
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

// A register launch: inputs a0, a1, outputs b0, b1 and the table as the
// mode's IO reads them.
struct K1Args {
  const void *a0, *a1;
  void *b0, *b1;
  const void *tab, *ptw;
  int B, tb, threads, inverse;
  double scale;
};

template <typename T, int N, template <typename, int> class IO, class... Ps>
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
  cudaError_t err = k1_allow_smem(k1_reg_kernel<T, N, IO<T, N>, Ps...>,
                                  ready);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.B + a.tb - 1) / a.tb;
  k1_reg_kernel<T, N, IO<T, N>, Ps...><<<grid, a.threads, smem, stream>>>(
      (const T*)a.a0, (const T*)a.a1, (T*)a.b0, (T*)a.b1, (const T*)a.tab,
      (const T*)a.ptw, a.B, a.tb, a.inverse, (T)a.scale);
  return (int)cudaGetLastError();
}

// The compiled register schedules: plan.factor(n) grouped greedily into
// passes of radix at most 16 (plan.reg_passes), each for the IO of a mode.
template <typename T, template <typename, int> class IO>
static int k1_reg_dispatch(const K1Args& a, int n, int nstages,
                           const int* factors, int npass, const int* pass_len,
                           cudaStream_t st) {
  switch (n) {
    case 480:
      return k1_reg_launch<T, 480, IO, RfPass<4, 4>, RfPass<2, 3>,
                           RfPass<5>>(a, nstages, factors, npass, pass_len,
                                      st);
    case 512:
      return k1_reg_launch<T, 512, IO, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<2>>(a, nstages, factors, npass, pass_len,
                                      st);
    case 960:
      return k1_reg_launch<T, 960, IO, RfPass<4, 4>, RfPass<4, 3>,
                           RfPass<5>>(a, nstages, factors, npass, pass_len,
                                      st);
    case 1024:
      return k1_reg_launch<T, 1024, IO, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<4>>(a, nstages, factors, npass, pass_len,
                                      st);
    case 2048:
      return k1_reg_launch<T, 2048, IO, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<4, 2>>(a, nstages, factors, npass,
                                         pass_len, st);
    case 4096:
      return k1_reg_launch<T, 4096, IO, RfPass<4, 4>, RfPass<4, 4>,
                           RfPass<4, 4>>(a, nstages, factors, npass,
                                         pass_len, st);
    case 8192:
      if constexpr (sizeof(T) == 4)
        return k1_reg_launch<T, 8192, IO, RfPass<4, 4>, RfPass<4, 4>,
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
    const K1Args a{xr, xi, yr, yi, nullptr, ptw, B, tb, threads, inverse,
                   scale};
    return k1_reg_dispatch<T, K1RowIO>(a, n, nstages, factors, npass,
                                       pass_len, st);
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

// mode 0 (r2c): a0 the real rows of 2h, b0, b1 the packed planes' rows of
// h + 1, the table (h + 1, 8); mode 1 (c2r): a0, a1 the packed planes,
// b0 the real rows, the table (h, 8).  h must be a register length.
template <typename T>
static int k1_real_launch(int mode, const void* a0, const void* a1,
                          void* b0, void* b1, const void* tab,
                          const void* ptw, int B, int h, int nstages,
                          const int* factors, int npass, const int* pass_len,
                          int tb, int threads, double scale, void* stream) {
  if ((mode != 0 && mode != 1) || nstages < 1 || nstages > K1_MAX_STAGES ||
      npass < 1 || threads < 1 || threads > K1_MAX_THREADS || tb < 1 ||
      tb > K1_REAL_MAX_TB || B < 1 || !tab)
    return (int)cudaErrorInvalidValue;
  const K1Args a{a0, a1, b0, b1, tab, ptw, B, tb, threads, mode, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0)
    return k1_reg_dispatch<T, K1RealFwdIO>(a, h, nstages, factors, npass,
                                           pass_len, st);
  return k1_reg_dispatch<T, K1RealInvIO>(a, h, nstages, factors, npass,
                                         pass_len, st);
}

// The interleaved complex mode: x, y rows of n (re, im) pairs, n a
// register length.
template <typename T>
static int k1_cplx_launch(const void* x, void* y, const void* ptw, int B,
                          int n, int nstages, const int* factors, int npass,
                          const int* pass_len, int inverse, int tb,
                          int threads, double scale, void* stream) {
  if (nstages < 1 || nstages > K1_MAX_STAGES || npass < 1 || threads < 1 ||
      threads > K1_MAX_THREADS || tb < 1 || B < 1 || !x || !y || !ptw)
    return (int)cudaErrorInvalidValue;
  const K1Args a{x, nullptr, y, nullptr, nullptr, ptw, B, tb, threads,
                 inverse, scale};
  return k1_reg_dispatch<T, K1CplxIO>(a, n, nstages, factors, npass,
                                      pass_len, (cudaStream_t)stream);
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

// One launch of K1's interleaved complex mode on `stream`
// (k1_cplx_launch): the register kernel of n, its schedule as for
// cfft_stockham_f32, reading and writing rows of (re, im) pairs.
extern "C" int k1_cplx_f32(const void* x, void* y, const void* ptw, int B,
                           int n, int nstages, const int* factors, int npass,
                           const int* pass_len, int inverse, int tb,
                           int threads, double scale, void* stream) {
  return k1_cplx_launch<float>(x, y, ptw, B, n, nstages, factors, npass,
                               pass_len, inverse, tb, threads, scale, stream);
}

extern "C" int k1_cplx_f64(const void* x, void* y, const void* ptw, int B,
                           int n, int nstages, const int* factors, int npass,
                           const int* pass_len, int inverse, int tb,
                           int threads, double scale, void* stream) {
  return k1_cplx_launch<double>(x, y, ptw, B, n, nstages, factors, npass,
                                pass_len, inverse, tb, threads, scale,
                                stream);
}

// One launch of a real mode of K1 on `stream` (k1_real_launch): the
// register kernel of the half length h, its schedule as for
// cfft_stockham_f32, the forward DFT in mode 0 and the inverse in mode 1.
extern "C" int k1_real_f32(int mode, const void* a0, const void* a1,
                           void* b0, void* b1, const void* tab,
                           const void* ptw, int B, int h, int nstages,
                           const int* factors, int npass,
                           const int* pass_len, int tb, int threads,
                           double scale, void* stream) {
  return k1_real_launch<float>(mode, a0, a1, b0, b1, tab, ptw, B, h, nstages,
                               factors, npass, pass_len, tb, threads, scale,
                               stream);
}

extern "C" int k1_real_f64(int mode, const void* a0, const void* a1,
                           void* b0, void* b1, const void* tab,
                           const void* ptw, int B, int h, int nstages,
                           const int* factors, int npass,
                           const int* pass_len, int tb, int threads,
                           double scale, void* stream) {
  return k1_real_launch<double>(mode, a0, a1, b0, b1, tab, ptw, B, h,
                                nstages, factors, npass, pass_len, tb,
                                threads, scale, stream);
}
