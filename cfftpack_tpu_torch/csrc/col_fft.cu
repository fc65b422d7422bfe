// K6 and K9 for Hopper: transforms over axis -2 of contiguous
// (B, n0, n1) float32 planes in their natural layout, with no
// transposing copy around them.
//
// Replaces the TPU functions
//   K6  cfftpack_tpu/ops/pallas_colfft.py:_colfft_pallas_3d (:122, kernel
//       _make_col_kernel :101, wrapper scolfft_pallas :158): the length-n0
//       DFT down the columns, the norm scale fused into the store;
//   K9  cfftpack_tpu/ops/dct.py:_coldct2_core (:569) and _coldct3_core
//       (:595), which reach that kernel between separate gather, mirror
//       and phase passes.
//
// One block holds the whole length-n0 column of L neighbouring lanes
// (columns) of one image in shared memory as [row][lane], runs the
// Stockham stages of stream_pass.cuh over the rows (the body K2's column
// pass uses, consecutive threads on consecutive lanes) and stores in the
// natural layout.  There is no outer twiddle, no second pass and no
// scratch: every element is read once and written once.  The last lane
// group of a row is masked, so n1 is free (the packed n1/2 + 1 columns of
// a 2-D real transform need no pad).
//
// Modes.
//   fwd, inv (K6)  (xr, xi) -> (yr, yi) = scale * DFT(x) down the columns.
//   dct2 (K9)  b = B/2 image pairs.  Load: images 2b and 2b+1 as re and
//              im, rows gathered in Makhoul order (v[j] = x[2j] for
//              j < n0/2, x[2*n0 - 1 - 2j] above).  After the stages the
//              whole column sits in shared memory, so the conjugate
//              mirror Z[(n0 - k) % n0] is a shared-memory read; the store
//              writes ya = Re(ph_k (Z + conj Zm)) to image 2b and
//              yb = Re(-i ph_k (Z - conj Zm)) to image 2b+1, with ph the
//              half phase exp(-i pi k/(2 n0))/2, times scale and the row
//              weight w[k].
//   dct3 (K9)  Load: both images' columns (times the row weight w[k])
//              are staged in the second buffer, then
//              Z_k = ph_k (a_k - i a_{n0-k}) + i ph_k (b_k - i b_{n0-k})
//              with x_{n0} := 0 and ph = exp(+i pi k/(2 n0)) is built in
//              shared memory.  The inverse stages run, and the store
//              scatters y[2j] = v[j], y[2j+1] = v[n0-1-j] times scale
//              (the wrapper folds the core's 1/2 into it).
//
// What bounds it: device-memory bytes (16 per complex element for K6, 8
// per real element for K9; the arithmetic is 5 n0 log2 n0 flops a column,
// far under the float32 rate).  A row of the block is 4*L bytes at a
// stride of 4*n1 bytes and the card reads 32-byte sectors, so L < 8
// leaves part of each sector to the neighbouring blocks (which find it
// in L2 when they run close in time), while the two ping-pong buffers of
// both planes take 16*n0*L bytes of the 227 KB a block may use.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W on (64, n0, 1024) planes
// (chip_smoke.py, phase 19): room for three blocks on an SM matters
// more than a full sector (n0 = 1024: L = 4, 64 KB, 1.24 ms; L = 8,
// 128 KB, 1.64 ms; L = 2 1.88 ms; n0 = 512: L = 8, 64 KB, 0.55 ms
// against 0.70 at L = 4 and 0.82 at L = 16).  So the wrapper takes the
// stream column pass's rule: the widest L up to 32 whose buffers fit
// 64 KB, and at least 2.  At n0 = 4096 that is L = 2 in 128 KB, one
// block an SM and a quarter sector a row: 2.75 ms at (16, 4096, 1024)
// (3.58 ms at L = 1), 0.12 of the memory rate against 0.27 at n0 = 1024.
// A single buffer with register-held butterflies (half the shared
// memory, so twice the lanes), or 16-byte loads along lanes, are left
// for later.  Offsets into the planes are 64-bit.
#include <cuda_runtime.h>

#include "stream_pass.cuh"

#define CF_THREADS 512

enum { CF_FWD = 0, CF_INV = 1, CF_DCT2 = 2, CF_DCT3 = 3 };

struct CFArgs {
  const float* xr;   // input re plane (B, n0, n1); K9: the real images
  const float* xi;   // input im plane (K6 only)
  float* yr;         // output re plane; K9: the real images
  float* yi;         // output im plane (K6 only)
  const float* phr;  // K9: phase (n0,), see the modes above
  const float* phi;
  const float* w;    // K9: row weight (n0,) or nullptr
  int n0, n1, lshift;
  float scale;
};

__host__ __device__ constexpr bool cf_inverse(int mode) {
  return mode == CF_INV || mode == CF_DCT3;
}

// Block (t, group): lanes [c0, c0 + L) of transform t (an image for K6,
// an image pair for K9).  Element e of the block is row e >> lshift,
// lane e & (L - 1); lanes at or past n1 hold zeros and are not stored.
template <int MODE>
__global__ void __launch_bounds__(CF_THREADS)
    cf_kernel(CFArgs a, const float* __restrict__ twr,
              const float* __restrict__ twi, SFPlan plan) {
  extern __shared__ __align__(16) float cf_smem[];
  const int n0 = a.n0, n1 = a.n1, lshift = a.lshift;
  const int L = 1 << lshift;
  const int G = (n1 + L - 1) >> lshift;
  const long long t = blockIdx.x / G;
  const int c0 = (int)(blockIdx.x % G) * L;
  const int cnt = n0 * L;
  const long long img = (long long)n0 * n1;  // elements of one image
  float* ar = cf_smem;
  float* ai = ar + cnt;
  float* br = ai + cnt;
  float* bi = br + cnt;

  if constexpr (MODE == CF_FWD || MODE == CF_INV) {
    const float* xr = a.xr + t * img;
    const float* xi = a.xi + t * img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int k = e >> lshift, c = c0 + (e & (L - 1));
      const bool in = c < n1;
      const long long g = (long long)k * n1 + c;
      ar[e] = in ? xr[g] : 0.0f;
      ai[e] = in ? xi[g] : 0.0f;
    }
  } else if constexpr (MODE == CF_DCT2) {
    const float* x0 = a.xr + 2 * t * img;
    const float* x1 = x0 + img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int j = e >> lshift, c = c0 + (e & (L - 1));
      const int src = 2 * j < n0 ? 2 * j : 2 * n0 - 1 - 2 * j;
      const bool in = c < n1;
      const long long g = (long long)src * n1 + c;
      ar[e] = in ? x0[g] : 0.0f;
      ai[e] = in ? x1[g] : 0.0f;
    }
  } else {
    const float* x0 = a.xr + 2 * t * img;
    const float* x1 = x0 + img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int k = e >> lshift, c = c0 + (e & (L - 1));
      const bool in = c < n1;
      const long long g = (long long)k * n1 + c;
      const float wk = a.w != nullptr ? a.w[k] : 1.0f;
      br[e] = in ? wk * x0[g] : 0.0f;
      bi[e] = in ? wk * x1[g] : 0.0f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int k = e >> lshift;
      const int em = k == 0 ? e : e + (n0 - 2 * k) * L;  // row n0-k
      const float pa = br[e], pb = bi[e];
      const float pam = k == 0 ? 0.0f : br[em];
      const float pbm = k == 0 ? 0.0f : bi[em];
      const float phr = a.phr[k], phi = a.phi[k];
      ar[e] = phr * pa + phi * pam - (phi * pb - phr * pbm);
      ai[e] = phi * pa - phr * pam + (phr * pb + phi * pbm);
    }
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<true>(ar, ai, br, bi, L, n0, 1, L, plan, twr, twi,
                  cf_inverse(MODE), &sr, &si);

  if constexpr (MODE == CF_FWD || MODE == CF_INV) {
    float* yr = a.yr + t * img;
    float* yi = a.yi + t * img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int k = e >> lshift, c = c0 + (e & (L - 1));
      if (c < n1) {
        const long long g = (long long)k * n1 + c;
        yr[g] = a.scale * sr[e];
        yi[g] = a.scale * si[e];
      }
    }
  } else if constexpr (MODE == CF_DCT2) {
    float* y0 = a.yr + 2 * t * img;
    float* y1 = y0 + img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int k = e >> lshift, c = c0 + (e & (L - 1));
      if (c < n1) {
        const int em = k == 0 ? e : e + (n0 - 2 * k) * L;
        const float Zr = sr[e], Zi = si[e], Zmr = sr[em], Zmi = si[em];
        const float phr = a.phr[k], phi = a.phi[k];
        const float s = a.w != nullptr ? a.scale * a.w[k] : a.scale;
        const long long g = (long long)k * n1 + c;
        y0[g] = s * ((Zr + Zmr) * phr - (Zi - Zmi) * phi);
        y1[g] = s * ((Zi + Zmi) * phr + (Zr - Zmr) * phi);
      }
    }
  } else {
    float* y0 = a.yr + 2 * t * img;
    float* y1 = y0 + img;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int j = e >> lshift, c = c0 + (e & (L - 1));
      if (c < n1) {
        const int dst = 2 * j < n0 ? 2 * j : 2 * (n0 - 1 - j) + 1;
        const long long g = (long long)dst * n1 + c;
        y0[g] = a.scale * sr[e];
        y1[g] = a.scale * si[e];
      }
    }
  }
}

template <int MODE>
static int cf_run(const CFArgs& a, const void* twr, const void* twi,
                  const SFPlan& plan, long long b, cudaStream_t st) {
  const size_t smem = 16 * (size_t)a.n0 * ((size_t)1 << a.lshift);
  const long long L = 1LL << a.lshift;
  const long long grid = b * ((a.n1 + L - 1) / L);
  if (smem > SF_SMEM_MAX || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cf_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cf_kernel<MODE><<<(unsigned)grid, CF_THREADS, smem, st>>>(
      a, (const float*)twr, (const float*)twi, plan);
  return (int)cudaGetLastError();
}

// One mode over b transforms on `stream`: b images of (n0, n1) for K6
// (modes 0, 1), b image pairs for K9 (modes 2, 3; x and y then hold 2*b
// real images, xi and yi are unused).  (tw, fac, off) is the n0-point
// plan with forward-sign twiddles; ph the K9 phase and w its row weight
// (or null); lanes of a block are 1 << lshift.  Returns the first CUDA
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int col_fft_f32(const void* xr, const void* xi, void* yr, void* yi,
                           const void* twr, const void* twi, int nstages,
                           const int* fac, const int* off, const void* phr,
                           const void* phi, const void* w, int b, int n0,
                           int n1, int mode, int lshift, float scale,
                           void* stream) {
  SFPlan plan;
  if (b < 1 || n0 < 2 || n1 < 1 || mode < CF_FWD || mode > CF_DCT3 ||
      lshift < 0 || lshift > 5 || xr == nullptr || yr == nullptr ||
      !sf_make_plan(&plan, n0, nstages, fac, off))
    return (int)cudaErrorInvalidValue;
  const bool dct = mode == CF_DCT2 || mode == CF_DCT3;
  if (dct ? (phr == nullptr || phi == nullptr || n0 % 2 != 0)
          : (xi == nullptr || yi == nullptr))
    return (int)cudaErrorInvalidValue;
  const CFArgs a{(const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
                 (const float*)phr, (const float*)phi, (const float*)w,
                 n0, n1, lshift, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case CF_FWD:
      return cf_run<CF_FWD>(a, twr, twi, plan, b, st);
    case CF_INV:
      return cf_run<CF_INV>(a, twr, twi, plan, b, st);
    case CF_DCT2:
      return cf_run<CF_DCT2>(a, twr, twi, plan, b, st);
    default:
      return cf_run<CF_DCT3>(a, twr, twi, plan, b, st);
  }
}
