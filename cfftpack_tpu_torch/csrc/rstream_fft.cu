// K7 and K8 for Hopper: real transforms over the paired-row stream
// passes, float32.
//
// Replaces the TPU functions
//   K7  cfftpack_tpu/ops/pallas_rstream.py: srfft_stream_pallas (:157),
//       sirfft_stream_pallas (:166), sdct2_stream_pallas (:252) and
//       sdct3_stream_pallas (:260), which reach the Pallas stream kernel
//       through _stream_pallas_2d (:117, :152, :198, :240);
//   K8  cfftpack_tpu/ops/dct.py:_dct4_stream_tail (:285), which reaches it
//       through sfft_stream_pallas_permuted (:299).
// The passes are those of K2 (stream_pass.cuh); each mode fuses its
// layout work into their loads and stores.  N = 128*m is the complex
// transform length; x and y are (B, n) real rows unless said otherwise.
//
// rfft  (K7)  N = n, B = 2b.  Column load: z = x[2p] + i*x[2p+1] straight
//             from the input through its row stride.  Row store: the
//             conjugate-mirror merge U = (Z + conj(Zm))/2,
//             V = -i(Z - conj(Zm))/2, written in natural packed order into
//             (B, n/2 + 1) planes (row 2p gets U, row 2p+1 gets V; the
//             Nyquist bin from row 0, lane 64; imag(DC) and imag(Nyquist)
//             stored as exact zeros).
// irfft (K7)  Row load: Z = U + iV rebuilt from the natural packed
//             (B, n/2 + 1) planes, bins past n/2 from bin n - k.  Column
//             store: zr to row 2p, zi to row 2p+1.  Unscaled: n*x.
// dct2  (K7)  Column load: the Makhoul gather v = [x_even, reversed
//             x_odd].  Row store: the merge, then Re(ph*U) and Re(ph*V)
//             in natural order.
// dct3  (K7)  Row load: U_k = conj(ph_k)(y_k - i*y_{(n-k)%n}) with
//             U_0 = y_0 and U_{n/2} = sqrt(2)*y_{n/2}, for both rows of a
//             pair, and Z = U + iV.  Column store: 0.5*z scattered by the
//             inverse Makhoul permutation.
// dct4  (K8)  N = n/2, B = b.  Column load: c[p] = x[2p] + i*x[n-1-2p]
//             times the pre-rotation e^{-i pi p/n}.  Row store: the
//             post-phase, then y[2t] = Re z[t] and y[2t+1] = -Im z[N-1-t]
//             (N-1-t sits at [m-1-k2, 127-k1]) as one 8-byte store.
//
// Mirror rows.  A forward row-pass block holds 8 row pairs, so each row's
// mirror is in its shared memory: block g takes j in [8g, 8g + 8), slot
// j - 8g holds row j and slot j - 8g + 8 its mirror row.  K7's mirror of
// bin k2 + m*k1 is bin (n - k) % n, at row (m - k2) % m and lane
// (128 - k1) % 128 on row 0, 127 - k1 elsewhere; rows 0 and m/2 are their
// own mirrors, so block 0 puts row m/2 in the mirror slot of row 0.
// K8's mirror row is m - 1 - k2, lane 127 - k1, with no self-mirror row.
//
// What bounds it: device-memory bytes, as for K2 (two passes of 32 bytes
// per complex element through scratch planes).  The TPU version runs the
// mirror merge, the Makhoul gather and scatter, the DCT-III assembly and
// the DCT-IV riffle as separate XLA passes, because Mosaic has no `rev`
// (pallas_rstream.py:35-44); here they are the passes' loads and stores,
// so each transform moves its data through device memory twice (once
// per pass) and nothing else: no deinterleave, merge, transpose or
// riffle pass.  Strided gathers and scatters (Makhoul, DCT-IV pairs) are
// scalar accesses, and the packed (n/2 + 1)-float rows are stored as
// scalars (every other row breaks 16-byte alignment).
#include <cuda_runtime.h>

#include "stream_pass.cuh"

enum { RS_RFFT = 0, RS_IRFFT = 1, RS_DCT2 = 2, RS_DCT3 = 3, RS_DCT4 = 4 };

struct RSArgs {
  const float* xr;  // input: real rows (B, n), or U/V re plane (irfft)
  const float* xi;  // irfft: U/V im plane (same row stride)
  long long xs;     // input row stride in floats
  float* yr;        // output: real rows (B, n), or re plane (rfft)
  float* yi;        // rfft: im plane (B, n/2 + 1)
  float* sr;        // scratch (b, m, 128) planes
  float* si;
  const float* t1r;  // outer twiddle (m, 128), in the direction's sign
  const float* t1i;
  const float* par;  // dct2/dct3: phase e^{-i pi k/(2n)} at [k2, k1];
  const float* pai;  // dct4: pre-rotation (N,)
  const float* pbr;  // dct4: post-phase at [k2, k1]
  const float* pbi;
  int m;
};

__host__ __device__ constexpr bool rs_forward(int mode) {
  return mode == RS_RFFT || mode == RS_DCT2 || mode == RS_DCT4;
}

// Column-pass IO: transform row p reads its input (forward) or the
// scratch (inverse), and writes the scratch (forward) or its output.
template <int MODE>
struct RSColIO {
  RSArgs a;
  __device__ __forceinline__ void load(long long p, int j, float& vr,
                                       float& vi) const {
    const long long N = (long long)a.m * SF_N1;
    if constexpr (MODE == RS_RFFT) {
      const float* x = a.xr + 2 * p * a.xs;
      vr = x[j];
      vi = x[a.xs + j];
    } else if constexpr (MODE == RS_DCT2) {
      const float* x = a.xr + 2 * p * a.xs;
      const long long src = j < N / 2 ? 2LL * j : 2 * N - 1 - 2LL * j;
      vr = x[src];
      vi = x[a.xs + src];
    } else if constexpr (MODE == RS_DCT4) {
      const float* x = a.xr + p * a.xs;
      vr = x[2LL * j];
      vi = x[2 * N - 1 - 2LL * j];
      sf_cmul(vr, vi, a.par[j], a.pai[j]);
    } else {
      vr = a.sr[p * N + j];
      vi = a.si[p * N + j];
    }
  }
  __device__ __forceinline__ void store(long long p, int j, float vr,
                                        float vi) const {
    const long long N = (long long)a.m * SF_N1;
    if constexpr (MODE == RS_IRFFT) {
      a.yr[2 * p * N + j] = vr;
      a.yr[(2 * p + 1) * N + j] = vi;
    } else if constexpr (MODE == RS_DCT3) {
      const long long dst = j < N / 2 ? 2LL * j : 2 * (N - 1 - j) + 1;
      a.yr[2 * p * N + dst] = 0.5f * vr;
      a.yr[(2 * p + 1) * N + dst] = 0.5f * vi;
    } else {
      a.sr[p * N + j] = vr;
      a.si[p * N + j] = vi;
    }
  }
};

// Forward row-pass IO: 8 row pairs per block (see "Mirror rows").
template <int MODE>
struct RSRowFwdIO {
  static constexpr bool load_t = false;
  RSArgs a;
  long long p;
  int g;
  // row k2 of slot s
  __device__ __forceinline__ int row_of(int s) const {
    const int j = 8 * g + (s & 7);
    if (s < 8) return j;
    if constexpr (MODE == RS_DCT4) {
      return a.m - 1 - j;
    } else {
      return j == 0 ? a.m / 2 : a.m - j;
    }
  }
  // slot of the mirror row of slot s
  __device__ __forceinline__ int mirror_slot(int s) const {
    if constexpr (MODE != RS_DCT4) {
      if (g == 0 && (s & 7) == 0) return s;  // rows 0 and m/2
    }
    return s ^ 8;
  }
  __device__ __forceinline__ void load(int s, int c, float& vr,
                                       float& vi) const {
    const long long at =
        p * a.m * (long long)SF_N1 + (long long)row_of(s) * SF_N1 + c;
    vr = a.sr[at];
    vi = a.si[at];
  }
  // the merge of K7's forward modes at slot s, lane c, from the tile
  __device__ __forceinline__ void merge(const float* R, const float* I, int s,
                                        int c, int k2, float& Ur, float& Ui,
                                        float& Vr, float& Vi) const {
    const int ms = mirror_slot(s);
    const int mc = k2 == 0 ? (SF_N1 - c) & (SF_N1 - 1) : SF_N1 - 1 - c;
    const float Zr = R[s * SF_RS + c], Zi = I[s * SF_RS + c];
    const float Zmr = R[ms * SF_RS + mc], Zmi = I[ms * SF_RS + mc];
    Ur = 0.5f * (Zr + Zmr);
    Ui = 0.5f * (Zi - Zmi);
    Vr = 0.5f * (Zi + Zmi);
    Vi = 0.5f * (Zmr - Zr);
  }
  __device__ __forceinline__ void store(const float* R,
                                        const float* I) const {
    const int m = a.m;
    const long long N = (long long)m * SF_N1;
    if constexpr (MODE == RS_RFFT) {
      // bins k = k2 + m*k1 < n/2 sit at lanes k1 < 64
      const long long h1 = N / 2 + 1;
      float* ur = a.yr + 2 * p * h1;
      float* ui = a.yi + 2 * p * h1;
      for (int e = threadIdx.x; e < SF_ROWS * (SF_N1 / 2);
           e += blockDim.x) {
        const int s = e % SF_ROWS, c = e / SF_ROWS;
        const int k2 = row_of(s);
        float Ur, Ui, Vr, Vi;
        merge(R, I, s, c, k2, Ur, Ui, Vr, Vi);
        const long long k = k2 + (long long)m * c;
        if (k == 0) Ui = Vi = 0.0f;
        ur[k] = Ur;
        ui[k] = Ui;
        ur[h1 + k] = Vr;
        ui[h1 + k] = Vi;
      }
      if (g == 0 && threadIdx.x == 0) {
        // Nyquist: row 0, lane 64, its own mirror
        const float Zr = R[SF_N1 / 2], Zi = I[SF_N1 / 2];
        ur[N / 2] = 0.5f * (Zr + Zr);
        ui[N / 2] = 0.0f;
        ur[h1 + N / 2] = 0.5f * (Zi + Zi);
        ui[h1 + N / 2] = 0.0f;
      }
    } else if constexpr (MODE == RS_DCT2) {
      float* yu = a.yr + 2 * p * N;
      for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
        const int s = e % SF_ROWS, c = e / SF_ROWS;
        const int k2 = row_of(s);
        float Ur, Ui, Vr, Vi;
        merge(R, I, s, c, k2, Ur, Ui, Vr, Vi);
        const float phr = a.par[k2 * SF_N1 + c], phi = a.pai[k2 * SF_N1 + c];
        const long long k = k2 + (long long)m * c;
        yu[k] = Ur * phr - Ui * phi;
        yu[N + k] = Vr * phr - Vi * phi;
      }
    } else {
      // RS_DCT4: z[t] = W[t] * post[t], t = k2 + m*k1
      float* y = a.yr + p * 2 * N;
      for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
        const int s = e % SF_ROWS, c = e / SF_ROWS;
        const int k2 = row_of(s);
        const int ms = s ^ 8, mc = SF_N1 - 1 - c, mk2 = m - 1 - k2;
        float zr = R[s * SF_RS + c], zi = I[s * SF_RS + c];
        sf_cmul(zr, zi, a.pbr[k2 * SF_N1 + c], a.pbi[k2 * SF_N1 + c]);
        float wr = R[ms * SF_RS + mc], wi = I[ms * SF_RS + mc];
        sf_cmul(wr, wi, a.pbr[mk2 * SF_N1 + mc], a.pbi[mk2 * SF_N1 + mc]);
        const long long t = k2 + (long long)m * c;
        *reinterpret_cast<float2*>(y + 2 * t) = make_float2(zr, -wi);
      }
    }
  }
};

// Inverse row-pass IO: slot s is row k2 = 16g + s; the load assembles
// the spectrum in natural order (slots fastest), the store writes the
// scratch.
template <int MODE>
struct RSRowInvIO {
  static constexpr bool load_t = true;
  RSArgs a;
  long long p;
  int k20;
  __device__ __forceinline__ void load(int s, int c, float& vr,
                                       float& vi) const {
    const int m = a.m;
    const long long N = (long long)m * SF_N1;
    const int k2 = k20 + s;
    const long long k = k2 + (long long)m * c;
    const long long xs = a.xs;
    if constexpr (MODE == RS_IRFFT) {
      const float* ur = a.xr + 2 * p * xs;
      const float* ui = a.xi + 2 * p * xs;
      if (k <= N / 2) {
        vr = ur[k] - ui[xs + k];
        vi = ui[k] + ur[xs + k];
      } else {
        const long long kk = N - k;
        vr = ur[kk] + ui[xs + kk];
        vi = ur[xs + kk] - ui[kk];
      }
    } else {
      // RS_DCT3
      const float* yu = a.xr + 2 * p * xs;
      const long long km = k == 0 ? 0 : N - k;
      const float phr = a.par[k2 * SF_N1 + c], phi = a.pai[k2 * SF_N1 + c];
      float Ur, Ui, Vr, Vi;
      const float tu = yu[k], tum = yu[km];
      const float tv = yu[xs + k], tvm = yu[xs + km];
      if (k == 0 || k == N / 2) {
        const float w = k == 0 ? 1.0f : 1.41421356237309515f;
        Ur = k == 0 ? tu : w * tu;
        Vr = k == 0 ? tv : w * tv;
        Ui = Vi = 0.0f;
      } else {
        Ur = tu * phr - tum * phi;
        Ui = -(tu * phi + tum * phr);
        Vr = tv * phr - tvm * phi;
        Vi = -(tv * phi + tvm * phr);
      }
      vr = Ur - Vi;
      vi = Ui + Vr;
    }
  }
  __device__ __forceinline__ void store(const float* R,
                                        const float* I) const {
    const long long base = p * a.m * (long long)SF_N1 + (long long)k20 * SF_N1;
    for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
      const int s = e >> 7, c = e & (SF_N1 - 1);
      a.sr[base + e] = R[s * SF_RS + c];
      a.si[base + e] = I[s * SF_RS + c];
    }
  }
};

template <int MODE>
__global__ void __launch_bounds__(SF_COL_THREADS)
    rs_col_kernel(RSArgs a, const float* __restrict__ twr,
                  const float* __restrict__ twi, int lshift, SFPlan plan) {
  extern __shared__ __align__(16) float rs_col_smem[];
  const RSColIO<MODE> io{a};
  sf_col_pass(io, rs_col_smem, a.t1r, a.t1i, twr, twi, a.m, lshift,
              !rs_forward(MODE), plan);
}

template <int MODE>
__global__ void __launch_bounds__(SF_ROW_THREADS)
    rs_row_kernel(RSArgs a, const float* __restrict__ twr,
                  const float* __restrict__ twi, SFPlan plan) {
  __shared__ __align__(16) float rs_row_smem[4 * SF_ROWS * SF_RS];
  const int G = a.m / SF_ROWS;
  const long long p = blockIdx.x / G;
  const int g = (int)(blockIdx.x % G);
  if constexpr (rs_forward(MODE)) {
    const RSRowFwdIO<MODE> io{a, p, g};
    sf_row_pass(io, rs_row_smem, twr, twi, false, plan);
  } else {
    const RSRowInvIO<MODE> io{a, p, g * SF_ROWS};
    sf_row_pass(io, rs_row_smem, twr, twi, true, plan);
  }
}

// Both passes of one mode: forward modes column then row pass, inverse
// modes row then column pass.
template <int MODE>
static int rs_run(const RSArgs& a, const void* ctwr, const void* ctwi,
                  const SFPlan& cplan, const void* rtwr, const void* rtwi,
                  const SFPlan& rplan, long long b, int lshift,
                  cudaStream_t st) {
  const size_t csmem = 16 * (size_t)a.m * ((size_t)1 << lshift);
  const long long cgrid = b * (SF_N1 >> lshift);
  const long long rgrid = b * (a.m / SF_ROWS);
  if (csmem > SF_SMEM_MAX || cgrid > 0x7fffffffLL || rgrid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rs_col_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)csmem);
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0; pass < 2; ++pass) {
    if ((pass == 0) == rs_forward(MODE)) {
      rs_col_kernel<MODE><<<(unsigned)cgrid, SF_COL_THREADS, csmem, st>>>(
          a, (const float*)ctwr, (const float*)ctwi, lshift, cplan);
    } else {
      rs_row_kernel<MODE><<<(unsigned)rgrid, SF_ROW_THREADS, 0, st>>>(
          a, (const float*)rtwr, (const float*)rtwi, rplan);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One mode over b transforms of N = 128*m points on `stream` (b = B/2
// pairs for K7, B rows for K8).  x is the input (xi the im plane of
// irfft), xs its row stride; y the output (yi the im plane of rfft), s
// the (b, m, 128) scratch planes; t1 the outer twiddle in the mode's
// direction; (ctw, cfac, coff) the m-point and (rtw, rfac, roff) the
// 128-point plans with forward-sign twiddles; pa and pb the mode's
// tables (see RSArgs).  Returns the first CUDA error, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int rstream_fft_f32(
    const void* xr, const void* xi, long long xs, void* yr, void* yi,
    void* sr, void* si, const void* t1r, const void* t1i, const void* ctwr,
    const void* ctwi, int cstages, const int* cfac, const int* coff,
    const void* rtwr, const void* rtwi, int rstages, const int* rfac,
    const int* roff, const void* par, const void* pai, const void* pbr,
    const void* pbi, int b, int m, int mode, int lshift, void* stream) {
  SFPlan cplan, rplan;
  if (b < 1 || m < SF_ROWS || m % SF_ROWS || mode < RS_RFFT ||
      mode > RS_DCT4 || lshift < 0 || lshift > 7 || xs < 1 ||
      !sf_make_plan(&cplan, m, cstages, cfac, coff) ||
      !sf_make_plan(&rplan, SF_N1, rstages, rfac, roff))
    return (int)cudaErrorInvalidValue;
  if ((mode == RS_IRFFT && xi == nullptr) || (mode == RS_RFFT && yi == nullptr) ||
      ((mode == RS_DCT2 || mode == RS_DCT3 || mode == RS_DCT4) &&
       (par == nullptr || pai == nullptr)) ||
      (mode == RS_DCT4 && (pbr == nullptr || pbi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const RSArgs a{(const float*)xr, (const float*)xi, xs, (float*)yr,
                 (float*)yi, (float*)sr, (float*)si, (const float*)t1r,
                 (const float*)t1i, (const float*)par, (const float*)pai,
                 (const float*)pbr, (const float*)pbi, m};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case RS_RFFT:
      return rs_run<RS_RFFT>(a, ctwr, ctwi, cplan, rtwr, rtwi, rplan, b,
                             lshift, st);
    case RS_IRFFT:
      return rs_run<RS_IRFFT>(a, ctwr, ctwi, cplan, rtwr, rtwi, rplan, b,
                              lshift, st);
    case RS_DCT2:
      return rs_run<RS_DCT2>(a, ctwr, ctwi, cplan, rtwr, rtwi, rplan, b,
                             lshift, st);
    case RS_DCT3:
      return rs_run<RS_DCT3>(a, ctwr, ctwi, cplan, rtwr, rtwi, rplan, b,
                             lshift, st);
    default:
      return rs_run<RS_DCT4>(a, ctwr, ctwi, cplan, rtwr, rtwi, rplan, b,
                             lshift, st);
  }
}
