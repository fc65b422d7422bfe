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
//             (N-1-t sits at [m-1-k2, 127-k1]) as one 8-byte store.  The
//             cluster route below also takes DST-IV, (-1)^k dct4(flip(x)):
//             the flip swaps the pair load's two reads, the sign is that
//             of the odd outputs.
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
// scalars (every other row breaks 16-byte alignment).  At m = 128, 256,
// 512 and 1024 (n = 16384 .. 131072; K8 at twice those n) every mode
// runs in one pass instead, on a thread-block cluster (cluster_pass.cuh,
// ClRsMode below): 16 bytes an element, the same loads and stores on the
// natural index, and the norm's scale (and the ortho weight of bin 0) in
// them.
#include <cuda_runtime.h>

#include "cluster_pass.cuh"
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
  static bool ready[CL_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= CL_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(rs_col_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SF_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
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

// K7 and K8 on the cluster engine (cluster_pass.cuh) at m = 128, 256, 512
// and 1024: pair p (rows 2p, 2p+1; K8: row p) is one cluster's transform
// of N = 128*M points, natural order throughout.  The loads and stores
// are those of the two-pass modes above, on the natural index; the
// mirror of bin (k2, k1) and the partners of dct3's and dct4's output t
// sit in rows another block owns, read through the cluster's shared
// memory between two barriers.
//
// rfft   load z = x[2p][j] + i*x[2p+1][j]; store the merge of bins
//        k = k2 + M*k1 < n/2 (k1 < 64) with their mirrors, as runs of m/C
//        bins of U (row 2p) and V (row 2p+1), the Nyquist bin from row 0,
//        lane 64, imag(DC) and imag(Nyquist) exact zeros;
// dct2   load the Makhoul gather v[j] = x[2j] (j < N/2), x[2N-1-2j]: scalar
//        stride-2 reads, whose other half the same block reads for the
//        rows q >= m/2 moments later (from L2); store the merge and
//        Re(ph_k U_k), Re(ph_k V_k) with the natural phase table, bin 0
//        times w0;
// irfft  load conj(Z[j]), Z = U + iV from the packed rows (bins past n/2
//        from bin n - j); store zr to row 2p and zi to row 2p+1 (the
//        conjugated forward: z = conj(X));
// dct3   load conj(Z[k]), U_k = conj(ph_k)(y_k - i*y_{(n-k)%n}) for both
//        rows, U_0 = w0*y_0, U_{n/2} = sqrt(2)*y_{n/2}; store 0.5*z through
//        the inverse Makhoul permutation: the pair (2t, 2t+1) is v[t] and
//        v[N-1-t], N-1-t at row m-1-k2, lane 127-k1 of another block, one
//        8-byte store;
// dct4   (K8, rows of n = 2N) load c[j] = x[2j] + i*x[n-1-2j] times the
//        pre-rotation pre[j] (with `dst` the two reads swap: flip(x));
//        store z = Z*post on the natural index, y[2t] = Re z[t] and
//        y[2t+1] = osgn * Im z[N-1-t] (osgn -1, +1 with `dst`), N-1-t at
//        row m-1-k2, lane 127-k1 of another block, one 8-byte store.
// Every store multiplies by `scale`.
template <int M, int MODE>
struct ClRsMode {
  static constexpr long long N = (long long)M * SF_N1;
  const float* __restrict__ xr;  // input rows, or the packed re plane
  const float* __restrict__ xi;  // irfft: the packed im plane
  long long xs;                  // input row stride
  float* __restrict__ yr;        // output rows, or rfft's re plane
  float* __restrict__ yi;        // rfft: the im plane
  // dct2/dct3: e^{-i pi k/(2n)}; dct4: the pre-rotation (natural order)
  const float* __restrict__ phr;
  const float* __restrict__ phi;
  // dct4: the post-phase (natural order)
  const float* __restrict__ pbr;
  const float* __restrict__ pbi;
  int cshift;                     // pair p = blockIdx.x >> cshift
  float scale, w0;
  bool dst;                       // dct4: DST-IV
  __device__ __forceinline__ long long pair() const {
    return blockIdx.x >> cshift;
  }
  __device__ __forceinline__ void col_load(int q, int r, float& vr,
                                           float& vi) const {
    const long long p = pair();
    const long long j = (long long)q * SF_N1 + r;
    if constexpr (MODE == RS_RFFT) {
      const float* x = xr + 2 * p * xs;
      vr = x[j];
      vi = x[xs + j];
    } else if constexpr (MODE == RS_DCT2) {
      const float* x = xr + 2 * p * xs;
      const long long src = j < N / 2 ? 2 * j : 2 * N - 1 - 2 * j;
      vr = x[src];
      vi = x[xs + src];
    } else if constexpr (MODE == RS_DCT4) {
      const float* x = xr + p * xs;
      const float a = x[2 * j], c = x[2 * N - 1 - 2 * j];
      vr = dst ? c : a;
      vi = dst ? a : c;
      sf_cmul(vr, vi, __ldg(phr + j), __ldg(phi + j));
    } else if constexpr (MODE == RS_IRFFT) {
      const float* ur = xr + 2 * p * xs;
      const float* ui = xi + 2 * p * xs;
      if (j <= N / 2) {
        vr = ur[j] - ui[xs + j];
        vi = -(ui[j] + ur[xs + j]);
      } else {
        const long long kk = N - j;
        vr = ur[kk] + ui[xs + kk];
        vi = -(ur[xs + kk] - ui[kk]);
      }
    } else {
      // RS_DCT3
      const float* yu = xr + 2 * p * xs;
      float Ur, Ui, Vr, Vi;
      if (j == 0 || j == N / 2) {
        const float w = j == 0 ? w0 : 1.41421356237309515f;
        Ur = w * yu[j];
        Vr = w * yu[xs + j];
        Ui = Vi = 0.0f;
      } else {
        const long long jm = N - j;
        const float pr = phr[j], pi = phi[j];
        const float tu = yu[j], tum = yu[jm];
        const float tv = yu[xs + j], tvm = yu[xs + jm];
        Ur = tu * pr - tum * pi;
        Ui = -(tu * pi + tum * pr);
        Vr = tv * pr - tvm * pi;
        Vi = -(tv * pi + tvm * pr);
      }
      vr = Ur - Vi;
      vi = -(Ui + Vr);
    }
  }
  // U = (Z + conj(Zm))/2, V = -i(Z - conj(Zm))/2 at bin (k2, k1), slot s
  __device__ __forceinline__ void merge(const ClTile& t, int s, int k2,
                                        int k1, float& Ur, float& Ui,
                                        float& Vr, float& Vi) const {
    float Zr, Zi, Zmr, Zmi;
    t.own(s, k1, Zr, Zi);
    t.any((M - k2) & (M - 1),
          k2 == 0 ? (SF_N1 - k1) & (SF_N1 - 1) : SF_N1 - 1 - k1, Zmr, Zmi);
    Ur = 0.5f * (Zr + Zmr);
    Ui = 0.5f * (Zi - Zmi);
    Vr = 0.5f * (Zi + Zmi);
    Vi = 0.5f * (Zmr - Zr);
  }
  template <int>
  __device__ __forceinline__ void store(const ClTile& t) const {
    const long long p = pair();
    const int rows = 1 << t.sh.rshift;
    const int k20 = t.sh.c << t.sh.rshift;
    if constexpr (MODE == RS_RFFT) {
      const long long h1 = N / 2 + 1;
      float* ur = yr + 2 * p * h1;
      float* ui = yi + 2 * p * h1;
      for (int e = threadIdx.x; e < rows * (SF_N1 / 2); e += blockDim.x) {
        int s, k1;
        cl_tile(e, t.sh.rshift, s, k1);
        const int k2 = k20 + s;
        float Ur, Ui, Vr, Vi;
        merge(t, s, k2, k1, Ur, Ui, Vr, Vi);
        const long long k = k2 + (long long)M * k1;
        if (k == 0) Ui = Vi = 0.0f;
        ur[k] = scale * Ur;
        ui[k] = scale * Ui;
        ur[h1 + k] = scale * Vr;
        ui[h1 + k] = scale * Vi;
      }
      if (t.sh.c == 0 && threadIdx.x == 0) {
        // Nyquist: row 0, lane 64, its own mirror
        float Zr, Zi;
        t.own(0, SF_N1 / 2, Zr, Zi);
        ur[N / 2] = scale * Zr;
        ui[N / 2] = 0.0f;
        ur[h1 + N / 2] = scale * Zi;
        ui[h1 + N / 2] = 0.0f;
      }
    } else if constexpr (MODE == RS_DCT2) {
      float* yu = yr + 2 * p * N;
      for (int e = threadIdx.x; e < rows * SF_N1; e += blockDim.x) {
        int s, k1;
        cl_tile(e, t.sh.rshift, s, k1);
        const int k2 = k20 + s;
        float Ur, Ui, Vr, Vi;
        merge(t, s, k2, k1, Ur, Ui, Vr, Vi);
        const long long k = k2 + (long long)M * k1;
        const float pr = phr[k], pi = phi[k];
        const float w = k == 0 ? scale * w0 : scale;
        yu[k] = w * (Ur * pr - Ui * pi);
        yu[N + k] = w * (Vr * pr - Vi * pi);
      }
    } else if constexpr (MODE == RS_IRFFT) {
      float* y = yr + 2 * p * N;
      for (int e = threadIdx.x; e < rows * SF_N1; e += blockDim.x) {
        const int s = e & (rows - 1), k1 = e >> t.sh.rshift;
        float Xr, Xi;
        t.own(s, k1, Xr, Xi);
        const long long k = k20 + s + (long long)M * k1;
        y[k] = scale * Xr;
        y[N + k] = -scale * Xi;
      }
    } else if constexpr (MODE == RS_DCT4) {
      // t = k2 + M*k1, its partner u = N-1-t
      float* y = yr + 2 * p * N;
      const float oscale = dst ? scale : -scale;
      for (int e = threadIdx.x; e < rows * SF_N1; e += blockDim.x) {
        int s, k1;
        cl_tile(e, t.sh.rshift, s, k1);
        const int k2 = k20 + s;
        float Zr, Zi, Pr, Pi;
        t.own(s, k1, Zr, Zi);
        t.any(M - 1 - k2, SF_N1 - 1 - k1, Pr, Pi);
        const long long at = k2 + (long long)M * k1, u = N - 1 - at;
        const float zr = Zr * __ldg(pbr + at) - Zi * __ldg(pbi + at);
        const float wi = Pr * __ldg(pbi + u) + Pi * __ldg(pbr + u);
        *reinterpret_cast<float2*>(y + 2 * at) =
            make_float2(scale * zr, oscale * wi);
      }
    } else {
      // RS_DCT3: t = k2 + M*k1 < N/2, its partner N-1-t
      float* y = yr + 2 * p * N;
      const float f = 0.5f * scale;
      for (int e = threadIdx.x; e < rows * (SF_N1 / 2); e += blockDim.x) {
        int s, k1;
        cl_tile(e, t.sh.rshift, s, k1);
        const int k2 = k20 + s;
        float Xr, Xi, Pr, Pi;
        t.own(s, k1, Xr, Xi);
        t.any(M - 1 - k2, SF_N1 - 1 - k1, Pr, Pi);
        const long long at = 2 * (k2 + (long long)M * k1);
        *reinterpret_cast<float2*>(y + at) = make_float2(f * Xr, f * Pr);
        *reinterpret_cast<float2*>(y + N + at) =
            make_float2(-f * Xi, -f * Pi);
      }
    }
  }
};

// One cluster of C = 128 >> lshift blocks a pair (md.cshift = log2 C).
// The modes whose store reads other blocks' rows (rfft, dct2, dct3, dct4)
// wait for the whole cluster before it, and again after it, so no block's
// shared memory goes while another still reads it.
template <int M, int MODE>
__global__ void __launch_bounds__(CL_MAX_THREADS)
    cl_rs_kernel(ClRsMode<M, MODE> md, const float* __restrict__ t1r,
                 const float* __restrict__ t1i,
                 const float* __restrict__ cptw,
                 const float* __restrict__ rptw, int lshift) {
  extern __shared__ __align__(16) float cl_rs_smem[];
  constexpr bool remote = MODE != RS_IRFFT;
  const ClShape sh = cl_fft<M>(md, cl_rs_smem, t1r, t1i, cptw, rptw, lshift);
  if constexpr (remote) cooperative_groups::this_cluster().sync();
  md.template store<M>(ClTile{cl_rs_smem, sh});
  if constexpr (remote) cooperative_groups::this_cluster().sync();
}

template <int M, int MODE>
static int cl_rs_run(const RSArgs& a, const void* cptw, const void* rptw,
                     long long b, int C, float scale, float w0, bool dst,
                     cudaStream_t st) {
  static ClReady ready;
  const ClRsMode<M, MODE> md{a.xr,  a.xi,  a.xs,  a.yr,       a.yi,
                             a.par, a.pai, a.pbr, a.pbi,      cl_log2(C),
                             scale, w0,    dst};
  cudaError_t err =
      cl_launch(cl_rs_kernel<M, MODE>, ready, M, C, b, st, md, a.t1r, a.t1i,
                (const float*)cptw, (const float*)rptw, cl_log2(SF_N1 / C));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
static int cl_rs_mode(const RSArgs& a, const void* cptw, const void* rptw,
                      long long b, int C, float scale, float w0, bool dst,
                      cudaStream_t st) {
  switch (a.m) {
    case 128:
      return cl_rs_run<128, MODE>(a, cptw, rptw, b, C, scale, w0, dst, st);
    case 256:
      return cl_rs_run<256, MODE>(a, cptw, rptw, b, C, scale, w0, dst, st);
    case 512:
      return cl_rs_run<512, MODE>(a, cptw, rptw, b, C, scale, w0, dst, st);
    default:
      return cl_rs_run<1024, MODE>(a, cptw, rptw, b, C, scale, w0, dst, st);
  }
}

// One mode over b transforms of N = 128*m points on `stream` (b = B/2
// pairs for K7, B rows for K8).  x is the input (xi the im plane of
// irfft), xs its row stride; y the output (yi the im plane of rfft).
// Every mode at m = 128, 256, 512, 1024 runs on clusters of `csize`
// blocks (cluster_pass.cuh): t1 the forward outer twiddle, (cptw, rptw)
// the register pass twiddles of m and 128, pa the natural phase table
// (dct2/dct3) or pre-rotation (dct4), pb dct4's natural post-phase, times
// `scale` in the store and w0 on bin 0 (dct2's store, dct3's load); dst
// makes dct4 the DST-IV.  Every other (mode, m) runs the two stage-loop
// passes through the (b, m, 128) scratch s: t1 in the mode's direction,
// (ctw, cfac, coff) the m-point and (rtw, rfac, roff) the 128-point plans
// with forward-sign twiddles, pa and pb the mode's tables (see RSArgs);
// they take scale = w0 = 1 and dst = 0 only (the caller flips and
// multiplies).  Returns the first CUDA error, or cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int rstream_fft_f32(
    const void* xr, const void* xi, long long xs, void* yr, void* yi,
    void* sr, void* si, const void* t1r, const void* t1i, const void* ctwr,
    const void* ctwi, int cstages, const int* cfac, const int* coff,
    const void* rtwr, const void* rtwi, int rstages, const int* rfac,
    const int* roff, const void* par, const void* pai, const void* pbr,
    const void* pbi, const void* cptw, const void* rptw, int b, int m,
    int mode, int csize, int lshift, float scale, float w0, int dst,
    void* stream) {
  if (b < 1 || m < SF_ROWS || m % SF_ROWS || mode < RS_RFFT ||
      mode > RS_DCT4 || xs < 1 || (dst != 0 && mode != RS_DCT4))
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
  if (cl_takes(m)) {
    if (cptw == nullptr || rptw == nullptr) return (int)cudaErrorInvalidValue;
    const bool d = dst != 0;
    switch (mode) {
      case RS_RFFT:
        return cl_rs_mode<RS_RFFT>(a, cptw, rptw, b, csize, scale, w0, d, st);
      case RS_IRFFT:
        return cl_rs_mode<RS_IRFFT>(a, cptw, rptw, b, csize, scale, w0, d,
                                    st);
      case RS_DCT2:
        return cl_rs_mode<RS_DCT2>(a, cptw, rptw, b, csize, scale, w0, d, st);
      case RS_DCT3:
        return cl_rs_mode<RS_DCT3>(a, cptw, rptw, b, csize, scale, w0, d, st);
      default:
        return cl_rs_mode<RS_DCT4>(a, cptw, rptw, b, csize, scale, w0, d, st);
    }
  }
  SFPlan cplan, rplan;
  if (lshift < 0 || lshift > 7 || scale != 1.0f || w0 != 1.0f || dst != 0 ||
      !sf_make_plan(&cplan, m, cstages, cfac, coff) ||
      !sf_make_plan(&rplan, SF_N1, rstages, rfac, roff))
    return (int)cudaErrorInvalidValue;
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
