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
// A block owns L neighbouring lanes (columns) [c0, c0 + L) of one image
// (K6) or one image pair (K9), the whole length-n0 column of each, and
// the block index runs over the lane groups fastest, so neighbouring
// blocks read neighbouring parts of the same rows.  Every element is read
// once and written once; there is no outer twiddle, no second pass and
// no scratch.  Lanes at or past n1 hold zeros and are not stored, so n1
// is free (the packed n1/2 + 1 columns of a 2-D real transform need no
// pad).  Two routes of the one kernel family:
//
// * register route, n0 = 512, 1024, 2048, 4096 (cf_reg_kernel): the
//   plan's stages grouped into register passes of radix up to 16
//   (regfft.cuh, the schedule plan.reg_passes(n0) compiled per length in
//   CfRegCol, checked against the wrapper's with rf_matches), n0/16
//   threads a lane and 16 elements a thread.  Lanes are fastest in the
//   thread index and in one shared buffer of both planes, element e of
//   lane l at (e + e/16) * L + l: a warp reads and writes 32/L row
//   segments of 4*L bytes, and the pad word after every 16 rows keeps
//   the passes' strided exchanges off one bank.  Each thread issues the
//   16 loads of its first pass before any butterfly.  One buffer is half
//   the stage loop's two, so a block holds twice the lanes in the same
//   shared memory: 8*(n0 + n0/16)*L bytes, at most 1024 threads and 64
//   registers a thread.  Optionally C neighbouring lane groups launch as
//   one thread-block cluster, only so that they run at the same time:
//   where a block's row segment is part of a 32-byte sector, the blocks
//   that read the rest of it then find it in L2 (no shared memory is
//   exchanged; a transform's groups are padded to a multiple of C).
// * stage-loop route, every other n0 the gate takes (16, 48, 80, 960,
//   ...; cf_kernel): the whole column in shared memory as [row][lane]
//   between two ping-pong buffers, the Stockham stages of stream_pass.cuh
//   (consecutive threads on consecutive lanes), 16*n0*L bytes.
//
// Modes, as IO objects of the first pass's loads and the last pass's
// stores (the stage loop does the same in its load and store loops):
//   fwd, inv (K6)  (xr, xi) -> (yr, yi) = scale * DFT(x) down the columns.
//   dct2 (K9)  b = B/2 image pairs.  Load: images 2b and 2b+1 as re and
//              im, rows gathered in Makhoul order (v[j] = x[2j] for
//              j < n0/2, x[2*n0 - 1 - 2j] above).  The last pass leaves
//              the column in shared memory, so the conjugate mirror
//              Z[(n0 - k) % n0] is a shared-memory read; the store writes
//              ya = Re(ph_k (Z + conj Zm)) to image 2b and
//              yb = Re(-i ph_k (Z - conj Zm)) to image 2b+1, with ph the
//              half phase exp(-i pi k/(2 n0))/2, times scale and the row
//              weight w[k].
//   dct3 (K9)  Load: the rows of both images (times the row weight) are
//              staged once in the buffer, then the first pass builds
//              Z_k = ph_k (a_k - i a_{n0-k}) + i ph_k (b_k - i b_{n0-k})
//              from rows k and n0 - k there (x_{n0} := 0,
//              ph = exp(+i pi k/(2 n0))) and waits for the block before
//              its first write.  The inverse transform runs, and the store
//              scatters y[2j] = v[j], y[2j+1] = v[n0-1-j] times scale (the
//              wrapper folds the core's 1/2 into it).  (Building Z from
//              two reads of device memory a row, the second through L1,
//              would need 64 loads a thread in flight against 64
//              registers.)
//
// What bounds it: device-memory bytes (16 per complex element for K6, 8
// per real element for K9; the arithmetic is 5 n0 log2 n0 flops a column,
// far under the float32 rate).  A row of a block is 4*L bytes at a
// stride of 4*n1 bytes and the card reads 32-byte sectors, so L < 8
// leaves part of each sector to the neighbouring blocks, which find it in
// L2 only when they run close in time.  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py phases 19 and 25, device time), the rule
// (colfft.py, _REG_LANES and _REG_CLUSTER) takes L = 16 at n0 = 512
// (219 us at (64, 512, 1024)), 8 at 1024 (477 us at (64, 1024, 1024),
// 0.67 of the bound's rate; 4 lanes 1492 us, 16 lanes 470 us but K9's
// dct2 369 us there against 314), 8 at 2048 (1067 us at (64, 2048,
// 1024); 4 lanes 3263 us), 4 at 4096 with clusters of 4 (1028 us at
// (16, 4096, 1024) against 1337 without, 0.31 of the rate: 1024 threads
// hold no more lanes).  With n1 below L the block and the cluster narrow.  The stage
// loop keeps the stream column pass's rule (the widest L up to 32 whose
// buffers fit 64 KB, and at least 2).  Left for later: n0 = 4096 across
// a thread-block cluster that exchanges through distributed shared
// memory (four blocks of 1024 rows, the radix-4 step between them), and
// a persistent kernel with TMA column slabs.  Offsets into the planes
// are 64-bit.
#include <cuda_runtime.h>

#include "regfft.cuh"
#include "stream_pass.cuh"

#define CF_THREADS 512
#define CF_REG_THREADS 1024
#define CF_MAX_DEVICES 64

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
  int groups;        // register route: lane groups a transform, padded to
                     // a multiple of the cluster size
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

// ------------------------------------------------------ register route

// The compiled register schedules: plan.reg_passes(n0).
template <int N>
struct CfRegCol;
template <>
struct CfRegCol<512> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<2>>;
};
template <>
struct CfRegCol<1024> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4>>;
};
template <>
struct CfRegCol<2048> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4, 2>>;
};
template <>
struct CfRegCol<4096> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4, 4>>;
};

// Floats of one plane of the padded buffer: (n + n/16) rows of L lanes.
__host__ __device__ constexpr int cf_reg_plane(int n, int lshift) {
  return (n + (n >> 4)) << lshift;
}

// What every mode's IO object shares: the block's buffer and this
// thread's lane, and column c of the planes (in: c < n1).
struct CFRegBase {
  float* sr;
  float* si;
  int lshift, lane;
  bool in;
  __device__ __forceinline__ int sidx(int e) const {
    return ((e + (e >> 4)) << lshift) + lane;
  }
};

// fwd/inv: row e of the column in, scale * row e out.  x and y point at
// element (row 0, column c) of the image.
struct CFRegFftIO : CFRegBase {
  static constexpr bool last_in_smem = false;
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* yr;
  float* yi;
  long long n1;
  float scale;
  __device__ __forceinline__ void gload(int e, float& vr, float& vi) const {
    vr = in ? xr[e * n1] : 0.0f;
    vi = in ? xi[e * n1] : 0.0f;
  }
  __device__ __forceinline__ void gstore(int e, float vr, float vi) const {
    if (in) {
      yr[e * n1] = scale * vr;
      yi[e * n1] = scale * vi;
    }
  }
};

// dct2: the Makhoul row of both images in; the store is the block's loop
// after the passes (last_in_smem).  x points at (row 0, column c) of
// image 2b; image 2b+1 is img further.
template <int N>
struct CFRegDct2IO : CFRegBase {
  static constexpr bool last_in_smem = true;
  const float* __restrict__ x;
  long long n1, img;
  __device__ __forceinline__ void gload(int j, float& vr, float& vi) const {
    const int src = 2 * j < N ? 2 * j : 2 * N - 1 - 2 * j;
    vr = in ? x[src * n1] : 0.0f;
    vi = in ? x[img + src * n1] : 0.0f;
  }
  __device__ __forceinline__ void gstore(int, float, float) const {}
};

// dct3: the kernel first stages w[k]*(a_k, b_k) of every row of both
// images in the buffer (one coalesced read of each input element); gload
// builds Z_k from rows k and n0 - k there, and every thread waits
// (after_load) before the first pass overwrites them.  The un-permuting
// scatter out.  y points at (row 0, column c) of image 2b.
template <int N>
struct CFRegDct3IO : CFRegBase {
  static constexpr bool last_in_smem = false;
  float* y;
  const float* __restrict__ phr;
  const float* __restrict__ phi;
  long long n1, img;
  float scale;
  __device__ __forceinline__ void gload(int k, float& vr, float& vi) const {
    const float pa = sr[sidx(k)], pb = si[sidx(k)];
    const float pam = k > 0 ? sr[sidx(N - k)] : 0.0f;
    const float pbm = k > 0 ? si[sidx(N - k)] : 0.0f;
    const float cr = phr[k], ci = phi[k];
    vr = cr * pa + ci * pam - (ci * pb - cr * pbm);
    vi = ci * pa - cr * pam + (cr * pb + ci * pbm);
  }
  __device__ __forceinline__ void after_load() const { __syncthreads(); }
  __device__ __forceinline__ void gstore(int j, float vr, float vi) const {
    if (in) {
      const int dst = 2 * j < N ? 2 * j : 2 * (N - 1 - j) + 1;
      y[dst * n1] = scale * vr;
      y[img + dst * n1] = scale * vi;
    }
  }
};

// Block (t, group), the group fastest: lanes [c0, c0 + L) of transform t,
// (N/16) << lshift threads, lane = threadIdx.x & (L - 1) and thread
// threadIdx.x >> lshift of that lane's N/16.  ptw: the pass twiddles
// (plan.reg_twiddles(N)) as float (re, im) pairs.
template <int MODE, int N>
__global__ void __launch_bounds__(CF_REG_THREADS)
    cf_reg_kernel(CFArgs a, const float* __restrict__ ptw) {
  extern __shared__ __align__(16) float cf_reg_smem[];
  constexpr int TPR = N / 16;
  const int lshift = a.lshift, L = 1 << lshift;
  const long long t = blockIdx.x / a.groups;
  const int c0 = (int)(blockIdx.x % a.groups) << lshift;
  const int lane = threadIdx.x & (L - 1);
  const int tid = threadIdx.x >> lshift;
  const int c = c0 + lane;
  const bool in = c < a.n1;
  const long long n1 = a.n1, img = (long long)N * n1;
  const CFRegBase base{cf_reg_smem, cf_reg_smem + cf_reg_plane(N, lshift),
                       lshift, lane, in};
  // column c of the first image of the transform (column 0 when c is
  // past the edge, which is never read)
  const long long at = (MODE == CF_FWD || MODE == CF_INV ? t : 2 * t) * img +
                       (in ? c : 0);
  using Sched = typename CfRegCol<N>::type;

  if constexpr (MODE == CF_FWD || MODE == CF_INV) {
    CFRegFftIO io;
    static_cast<CFRegBase&>(io) = base;
    io.xr = a.xr + at;
    io.xi = a.xi + at;
    io.yr = a.yr + at;
    io.yi = a.yi + at;
    io.n1 = n1;
    io.scale = a.scale;
    rf_run<float, N, TPR>(io, tid, ptw, MODE == CF_INV ? 1.0f : -1.0f,
                          Sched{});
  } else if constexpr (MODE == CF_DCT2) {
    CFRegDct2IO<N> io;
    static_cast<CFRegBase&>(io) = base;
    io.x = a.xr + at;
    io.n1 = n1;
    io.img = img;
    rf_run<float, N, TPR>(io, tid, ptw, -1.0f, Sched{});
    // the passes end with a barrier: the whole column is in the buffer
    float* y0 = a.yr + 2 * t * img;
    for (int f = threadIdx.x; f < (N << lshift); f += blockDim.x) {
      const int k = f >> lshift, km = k == 0 ? 0 : N - k;
      if (in) {
        const int i = base.sidx(k), im = base.sidx(km);
        const float Zr = base.sr[i], Zi = base.si[i];
        const float Zmr = base.sr[im], Zmi = base.si[im];
        const float phr = a.phr[k], phi = a.phi[k];
        const float s = a.w != nullptr ? a.scale * a.w[k] : a.scale;
        const long long g = k * n1 + c;
        y0[g] = s * ((Zr + Zmr) * phr - (Zi - Zmi) * phi);
        y0[img + g] = s * ((Zi + Zmi) * phr + (Zr - Zmr) * phi);
      }
    }
  } else {
    // stage the rows: element i*blockDim.x + threadIdx.x of the block, lanes
    // fastest (the block has (N/16) << lshift threads)
    const float* x = a.xr + at;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = (threadIdx.x + i * blockDim.x) >> lshift;
      const float wk = a.w != nullptr ? a.w[k] : 1.0f;
      base.sr[base.sidx(k)] = in ? wk * x[k * n1] : 0.0f;
      base.si[base.sidx(k)] = in ? wk * x[img + k * n1] : 0.0f;
    }
    __syncthreads();
    CFRegDct3IO<N> io;
    static_cast<CFRegBase&>(io) = base;
    io.y = a.yr + at;
    io.phr = a.phr;
    io.phi = a.phi;
    io.n1 = n1;
    io.img = img;
    io.scale = a.scale;
    rf_run<float, N, TPR>(io, tid, ptw, 1.0f, Sched{});
  }
}

// ------------------------------------------------------------ launch

// Raises a kernel's cap on dynamic shared memory to SF_SMEM_MAX, once per
// device: a launch asks only for what it uses.
template <class Kernel>
static cudaError_t cf_allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= CF_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SF_SMEM_MAX);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int MODE>
static int cf_run(const CFArgs& a, const void* twr, const void* twi,
                  const SFPlan& plan, long long b, cudaStream_t st) {
  static bool ready[CF_MAX_DEVICES];
  const long long L = 1LL << a.lshift;
  const size_t smem = 16 * (size_t)a.n0 * (size_t)L;
  const long long grid = b * ((a.n1 + L - 1) / L);
  if (smem > SF_SMEM_MAX || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cf_allow_smem(cf_kernel<MODE>, ready);
  if (err != cudaSuccess) return (int)err;
  cf_kernel<MODE><<<(unsigned)grid, CF_THREADS, smem, st>>>(
      a, (const float*)twr, (const float*)twi, plan);
  return (int)cudaGetLastError();
}

template <int MODE, int N, class... Ps>
static int cf_reg_launch(CFArgs a, const void* ptw, long long b,
                         int nstages, const int* fac, int npass,
                         const int* pass_len, int csize, cudaStream_t st,
                         RfList<Ps...>) {
  static bool ready[CF_MAX_DEVICES];
  const int threads = (N / 16) << a.lshift;
  const size_t smem = 2 * sizeof(float) * (size_t)cf_reg_plane(N, a.lshift);
  const long long L = 1LL << a.lshift;
  const long long groups = ((a.n1 + L - 1) / L + csize - 1) / csize * csize;
  const long long grid = b * groups;
  if (!rf_matches<Ps...>(nstages, fac, npass, pass_len) || ptw == nullptr ||
      threads > CF_REG_THREADS || smem > SF_SMEM_MAX || grid > 0x7fffffffLL ||
      csize < 1 || csize > 8)
    return (int)cudaErrorInvalidValue;
  a.groups = (int)groups;
  cudaError_t err = cf_allow_smem(cf_reg_kernel<MODE, N>, ready);
  if (err != cudaSuccess) return (int)err;
  if (csize == 1) {
    cf_reg_kernel<MODE, N><<<(unsigned)grid, threads, smem, st>>>(
        a, (const float*)ptw);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cf_reg_kernel<MODE, N>, a,
                                 (const float*)ptw);
}

template <int MODE>
static int cf_reg_dispatch(const CFArgs& a, const void* ptw, long long b,
                           int nstages, const int* fac, int npass,
                           const int* pass_len, int csize, cudaStream_t st) {
  switch (a.n0) {
    case 512:
      return cf_reg_launch<MODE, 512>(a, ptw, b, nstages, fac, npass,
                                      pass_len, csize, st, CfRegCol<512>::type{});
    case 1024:
      return cf_reg_launch<MODE, 1024>(a, ptw, b, nstages, fac, npass,
                                       pass_len, csize, st, CfRegCol<1024>::type{});
    case 2048:
      return cf_reg_launch<MODE, 2048>(a, ptw, b, nstages, fac, npass,
                                       pass_len, csize, st, CfRegCol<2048>::type{});
    case 4096:
      return cf_reg_launch<MODE, 4096>(a, ptw, b, nstages, fac, npass,
                                       pass_len, csize, st, CfRegCol<4096>::type{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
static int cf_launch(const CFArgs& a, const void* twr, const void* twi,
                     const SFPlan& plan, const void* ptw, int nstages,
                     const int* fac, int npass, const int* pass_len,
                     int csize, long long b, cudaStream_t st) {
  if (npass > 0)
    return cf_reg_dispatch<MODE>(a, ptw, b, nstages, fac, npass, pass_len,
                                 csize, st);
  return cf_run<MODE>(a, twr, twi, plan, b, st);
}

// One mode over b transforms on `stream`: b images of (n0, n1) for K6
// (modes 0, 1), b image pairs for K9 (modes 2, 3; x and y then hold 2*b
// real images, xi and yi are unused).  (tw, fac, off) is the n0-point
// plan with forward-sign twiddles.  npass > 0 takes the register route:
// the passes group the stages `fac` by `pass_len` and must be the
// schedule compiled for n0, and ptw is its pass-twiddle table; npass = 0
// the stage loop.  ph is the K9 phase and w its row weight (or null);
// lanes of a block are 1 << lshift, and on the register route csize
// blocks (1 to 8) launch as one cluster.  Returns the first CUDA error,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int col_fft_f32(const void* xr, const void* xi, void* yr, void* yi,
                           const void* twr, const void* twi, int nstages,
                           const int* fac, const int* off, const void* ptw,
                           int npass, const int* pass_len, const void* phr,
                           const void* phi, const void* w, int b, int n0,
                           int n1, int mode, int lshift, int csize, float scale,
                           void* stream) {
  SFPlan plan;
  if (b < 1 || n0 < 2 || n1 < 1 || mode < CF_FWD || mode > CF_DCT3 ||
      lshift < 0 || lshift > 5 || npass < 0 || xr == nullptr ||
      yr == nullptr || !sf_make_plan(&plan, n0, nstages, fac, off))
    return (int)cudaErrorInvalidValue;
  const bool dct = mode >= CF_DCT2;
  if (dct ? (phr == nullptr || phi == nullptr || n0 % 2 != 0)
          : (xi == nullptr || yi == nullptr))
    return (int)cudaErrorInvalidValue;
  const CFArgs a{(const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
                 (const float*)phr, (const float*)phi, (const float*)w,
                 n0, n1, lshift, scale, 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case CF_FWD:
      return cf_launch<CF_FWD>(a, twr, twi, plan, ptw, nstages, fac, npass,
                               pass_len, csize, b, st);
    case CF_INV:
      return cf_launch<CF_INV>(a, twr, twi, plan, ptw, nstages, fac, npass,
                               pass_len, csize, b, st);
    case CF_DCT2:
      return cf_launch<CF_DCT2>(a, twr, twi, plan, ptw, nstages, fac, npass,
                                pass_len, csize, b, st);
    default:
      return cf_launch<CF_DCT3>(a, twr, twi, plan, ptw, nstages, fac, npass,
                                pass_len, csize, b, st);
  }
}
