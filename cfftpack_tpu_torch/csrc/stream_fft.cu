// K2, K3 and K4 for Hopper: the streaming four-step FFT of n = 128*m
// points over (b, m, 128) pairs of float32 re/im planes.
//
// Replaces the TPU kernel cfftpack_tpu/ops/pallas_stream.py:_make_kernel
// (:249) in its five modes: fwd/inv (K2, through _stream_pallas_2d
// :352), fwd_nat/inv_nat (K3, through _stream_pallas_2d_nat :386) and
// filter (K4, through _stream_filter_inv_2d :444).  With the natural
// tile x[q, r] at flat index j = 128*q + r it computes
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
// K2 and K3 (K3's entry stream_nat_f32, at the end of this file) run
// their forward in one pass on a thread-block cluster at m = 128 .. 1024
// (cluster_pass.cuh) and in K5's two register-pass kernels at s = 1 at
// m = 2048 and 4096: K3 stores the natural spectrum, K2 the rows k2 a
// block owns as they are (ClPermMode; the register route's row pass in
// its permuted store), reading its input through a row stride (the
// caller's paired rows).  K4 and K2's inverse run one pass on the same
// cluster engine at m = 128 .. 1024 in its rows-first order (the
// 128-point DFT of the permuted rows first, then the m-point one,
// ClRfMode): K4 with the filter multiply in its row load and its natural
// rows written through an output row stride (the caller's paired rows)
// times the norm's scale, K2's inverse with neither; K3's inverse is the
// conjugated forward.  Only the other (mode, m) take these two passes:
// K2's inverse and K4 at m = 2048 and 4096, and every mode at the m
// that no one-pass or register kernel is compiled for.  Butterflies are
// the closed forms of radix 2/3/4/5 in full float32 (no tensor cores); stage
// twiddles and the outer twiddle are float64-built tables cast to
// float32.  The ragged batch needs no mask and no pad: every block owns
// whole rows.  Offsets into the planes are 64-bit.  The pass bodies live
// in stream_pass.cuh, shared with K7 and K8 (rstream_fft.cu); this file
// gives them the IO of the five modes.
//
// K5, entry stream_split_f32: the natural-order FFT of n = s*n_in
// points, n_in = 128*m, s = 2 or 4, past the one-transform cap.  Replaces
// the TPU function cfftpack_tpu/ops/pallas_stream.py:sfft_stream_split
// (:583), which runs the s-point butterfly, the split twiddle and the
// digit riffle as XLA passes around K2.  Here they are the passes' loads
// and stores, so a call is exactly two kernels between the caller's
// planes:
//
// * column pass, block (b, group, k1): its load reads the s values
//   x[b, j1*n_in + j] (j1 < s) through the input's row stride, keeps
//   output k1 of their s-point DFT (a signed sum with factors +-1, +-i)
//   and multiplies by the split twiddle W_n^{k1*j}; then the m-point DFT
//   of sub-transform b*s + k1 runs as K2's, or at m = 4096 in K1's
//   register passes (regfft.cuh) on 4 lanes a block in one buffer, which
//   four lanes need (two buffers would not fit).  The s blocks that read the
//   same inputs are adjacent in the grid (k1 fastest), so their extra
//   reads hit L2 and device memory is read about once;
// * row pass, block (b, g), in register passes: 16/s rows k2 of each of
//   the s sub-transforms, so its store writes the natural spectrum
//   X[k1 + s*k2 + s*m*c] as runs of 16 contiguous floats (the riffle),
//   times `scale`, times a natural n-bin filter when one is given.
//
// The inverse cannot put the combine across sub-transforms into the last
// pass's store (a block would hold all s sub-transforms, 16*s*m*L bytes
// with two buffers: 256 KB at s = 4, m = 4096, L = 1), so it runs as the
// conjugate of the forward, ifft(X) = conj(fft(conj(X))): flag bit 1
// negates the imaginary plane in the first load, bit 2 in the last
// store.  The streaming filter past the cap is two such calls: Y =
// conj(fft(z) * F) with the filter in the first call's store, then
// conj(fft(Y)) into the caller's paired rows.
#include <cuda_runtime.h>

#include "cluster_pass.cuh"
#include "regfft.cuh"
#include "stream_pass.cuh"

#define SF_MAX_DEVICES 64

// K5's column pass in register passes at m = 2048 and 4096: the schedule
// (plan.reg_passes(m)), 16 elements a thread, m/16 threads a lane, and
// lanes a block such that it has 1024 threads in one padded buffer of
// 139 KB: 8 lanes at 2048, 4 at 4096 (on an H100 at (8, 2^20) 1, 2 and 4
// lanes took 911, 464 and 298 us a route, as the row segment a warp reads
// grows from 4 to 16 bytes of a 32-byte sector).
template <int M>
struct SfRegCol;
template <>
struct SfRegCol<2048> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4, 2>>;
};
template <>
struct SfRegCol<4096> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4, 4>>;
};
#define SF_REG_THREADS 1024

__host__ __device__ constexpr bool sf_reg_takes(int m) {
  return m == 2048 || m == 4096;
}
__host__ __device__ constexpr int sf_reg_lanes(int m) {
  return SF_REG_THREADS * 16 / m;
}

// Raises a kernel's cap on dynamic shared memory to SF_SMEM_MAX, once per
// device: a launch asks only for what it uses.
template <class Kernel>
static cudaError_t sf_allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SF_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SF_SMEM_MAX);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

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

// (vr, vi) times (-i)^p.
__device__ __forceinline__ void sf_quarter(float& vr, float& vi, int p) {
  const float r = vr, i = vi;
  switch (p & 3) {
    case 1: vr = i; vi = -r; break;
    case 2: vr = -r; vi = -i; break;
    case 3: vr = -i; vi = r; break;
    default: break;
  }
}

// K5 column-pass IO: the load combines the s input rows into output k1 of
// their s-point DFT and applies the split twiddle (s, n_in) at [k1, j];
// the store writes sub-transform `row` = b*S + k1 of the (b*S, m, 128)
// scratch.  `isgn` = -1 conjugates the input.  At S = 1 (K3's register
// route) the load is the input alone.
template <int S>
struct SFSplitColIO {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  const float* __restrict__ spr;
  const float* __restrict__ spi;
  long long in_rs, n_in, b;
  int k1;
  float isgn;
  __device__ __forceinline__ void load(long long, int j, float& vr,
                                       float& vi) const {
    const long long at = b * in_rs + j;
    if constexpr (S == 1) {
      vr = xr[at];
      vi = isgn * xi[at];
    } else {
      float ar = 0.0f, ai = 0.0f;
#pragma unroll
      for (int j1 = 0; j1 < S; ++j1) {
        float ur = xr[at + j1 * n_in], ui = isgn * xi[at + j1 * n_in];
        sf_quarter(ur, ui, j1 * k1 * (4 / S));
        ar += ur;
        ai += ui;
      }
      const long long t = k1 * n_in + j;
      sf_cmul(ar, ai, spr[t], spi[t]);
      vr = ar;
      vi = ai;
    }
  }
  __device__ __forceinline__ void store(long long row, int j, float vr,
                                        float vi) const {
    yr[row * n_in + j] = vr;
    yi[row * n_in + j] = vi;
  }
};

// K5's row pass in register passes: the 128-point DFT of 16 slots a block,
// (4*4)(4*2), 8 threads a slot.  Slot k1*(16/S) + kk of block (b, g) holds
// row k2 = g*(16/S) + kk of sub-transform b*S + k1.  The last pass leaves
// the tile in shared memory, a slot every 137 words (the pad word after
// every 16, and an odd stride, so the store's reads of 16 slots at one
// lane hit 16 banks); the store writes X[k1 + S*k2 + S*m*c] =
// X[c*S*m + 16*g + p], p = kk*S + k1, so each lane c is a run of 16
// contiguous floats, times `scale` and the natural filter (when fr is
// given), the imaginary plane times `osgn`.  With PERM (K2's forward,
// S = 1) it writes the rows as they are, X[k2 + m*c] at [k2, c], so a
// warp stores 32 consecutive lanes c of one row; the choice is compiled
// in, so K5's and K3's store stays as it was.
#define SF_ROW_REG_TPR 8
#define SF_ROW_REG_RS 137

template <int S, bool PERM>
struct SFSplitRowIO {
  static_assert(S == 1 || !PERM, "the permuted store is K2's, at S = 1");
  static constexpr int K = SF_ROWS / S;
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  const float* __restrict__ fr;
  const float* __restrict__ fi;
  long long out_rs, b;
  int g, m;
  float scale, osgn;
  __device__ __forceinline__ void store(const float* sr,
                                        const float* si) const {
    for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
      const int c = PERM ? e & (SF_N1 - 1) : e >> 4;
      const int p = PERM ? e >> 7 : e & (SF_ROWS - 1);
      const int at = ((p % S) * K + p / S) * SF_ROW_REG_RS + c + (c >> 4);
      const long long k =
          PERM ? (long long)g * SF_ROWS * SF_N1 + e
               : (long long)c * S * m + (long long)g * SF_ROWS + p;
      float vr = scale * sr[at], vi = scale * si[at];
      if (fr != nullptr) sf_cmul(vr, vi, fr[k], fi[k]);
      yr[b * out_rs + k] = vr;
      yi[b * out_rs + k] = osgn * vi;
    }
  }
};

// The column pass of K5 at m other than 2048 and 4096, in the stage loop:
// block (b, group, k1), k1 fastest.
template <int S>
__global__ void __launch_bounds__(SF_COL_THREADS)
    sf_split_col_kernel(SFSplitColIO<S> io, const float* __restrict__ t1r,
                        const float* __restrict__ t1i,
                        const float* __restrict__ twr,
                        const float* __restrict__ twi, int m, int lshift,
                        SFPlan plan) {
  extern __shared__ __align__(16) float sf_split_smem[];
  const int G = SF_N1 >> lshift;
  const long long blk = blockIdx.x / S;
  io.k1 = (int)(blockIdx.x % S);
  io.b = blk / G;
  sf_col_pass_at(io, sf_split_smem, t1r, t1i, twr, twi, m, lshift, false,
                 plan, io.b * S + io.k1, (int)(blk % G) << lshift);
}

// K5's column pass at m = 2048 and 4096 in register passes (regfft.cuh,
// the schedule SfRegCol<M>): sf_reg_lanes(M) lanes a block, lanes fastest
// in the thread index and in shared memory, one padded buffer of both
// planes ((M + M/16) * lanes floats each); the split load in the first
// pass, the outer twiddle and the scratch store in the last.
template <int S, int LANES>
struct SFSplitColRegIO {
  static constexpr bool last_in_smem = false;
  SFSplitColIO<S> io;
  const float* __restrict__ t1r;
  const float* __restrict__ t1i;
  float* sr;
  float* si;
  long long row;
  int r, lane;
  __device__ __forceinline__ int sidx(int e) const {
    return (e + (e >> 4)) * LANES + lane;
  }
  __device__ __forceinline__ void gload(int e, float& vr, float& vi) const {
    io.load(row, e * SF_N1 + r, vr, vi);
  }
  __device__ __forceinline__ void gstore(int e, float vr, float vi) const {
    const int g = e * SF_N1 + r;
    sf_cmul(vr, vi, t1r[g], t1i[g]);
    io.store(row, g, vr, vi);
  }
};

// Block (b, group, k1), k1 fastest.
template <int S, int M>
__global__ void __launch_bounds__(SF_REG_THREADS)
    sf_split_col_reg_kernel(SFSplitColIO<S> io, const float* __restrict__ t1r,
                            const float* __restrict__ t1i,
                            const float* __restrict__ ptw) {
  extern __shared__ __align__(16) float sf_split_reg_smem[];
  constexpr int LANES = sf_reg_lanes(M);
  constexpr int G = SF_N1 / LANES;
  constexpr int RS = (M + (M >> 4)) * LANES;
  const long long blk = blockIdx.x / S;
  io.k1 = (int)(blockIdx.x % S);
  io.b = blk / G;
  const int lane = threadIdx.x % LANES;
  const SFSplitColRegIO<S, LANES> rio{
      io, t1r, t1i, sf_split_reg_smem, sf_split_reg_smem + RS,
      io.b * S + io.k1, (int)(blk % G) * LANES + lane, lane};
  rf_run<float, M, M / 16>(rio, threadIdx.x / LANES, ptw, -1.0f,
                           typename SfRegCol<M>::type{});
}

// One slot's 128 points in the register passes.
struct SFSplitRowRegIO {
  static constexpr bool last_in_smem = true;
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* sr;
  float* si;
  long long at;
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void gload(int e, float& vr, float& vi) const {
    vr = xr[at + e];
    vi = xi[at + e];
  }
  __device__ __forceinline__ void gstore(int, float, float) const {}
};

template <int S, bool PERM>
__global__ void __launch_bounds__(SF_ROWS * SF_ROW_REG_TPR)
    sf_split_row_kernel(SFSplitRowIO<S, PERM> io,
                        const float* __restrict__ ptw) {
  __shared__ __align__(16) float sm[2 * SF_ROWS * SF_ROW_REG_RS];
  constexpr int K = SF_ROWS / S;
  const int G = io.m * S / SF_ROWS;
  io.b = blockIdx.x / G;
  io.g = (int)(blockIdx.x % G);
  const int sl = threadIdx.x / SF_ROW_REG_TPR;
  const long long row = io.b * S + sl / K;
  const SFSplitRowRegIO rio{
      io.xr, io.xi, sm + sl * SF_ROW_REG_RS,
      sm + (SF_ROWS + sl) * SF_ROW_REG_RS,
      (row * io.m + (long long)io.g * K + sl % K) * SF_N1};
  rf_chain<float, SF_N1, SF_ROW_REG_TPR, 1, 0, true, SFSplitRowRegIO,
           RfPass<4, 4>, RfPass<4, 2>>(rio, threadIdx.x % SF_ROW_REG_TPR, ptw,
                                       -1.0f);
  io.store(sm, sm + SF_ROWS * SF_ROW_REG_RS);
}

enum { SF_FWD = 0, SF_INV = 1, SF_FWD_NAT = 2, SF_INV_NAT = 3, SF_FILTER = 4 };
enum { SF_CONJ_IN = 1, SF_CONJ_OUT = 2 };

static bool sf_col_ready[SF_MAX_DEVICES];

// The column pass of K5 in register passes at m = M.
template <int S, int M>
static cudaError_t sf_split_col_reg(const SFSplitColIO<S>& cio,
                                    const void* t1r, const void* t1i,
                                    const void* ptw, int b, cudaStream_t st) {
  static bool ready[SF_MAX_DEVICES];
  constexpr int LANES = sf_reg_lanes(M);
  const size_t smem = 2 * sizeof(float) * (M + (M >> 4)) * (size_t)LANES;
  const long long grid = (long long)b * S * (SF_N1 / LANES);
  if (ptw == nullptr || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = sf_allow_smem(sf_split_col_reg_kernel<S, M>, ready);
  if (err != cudaSuccess) return err;
  sf_split_col_reg_kernel<S, M><<<(unsigned)grid, SF_REG_THREADS, smem, st>>>(
      cio, (const float*)t1r, (const float*)t1i, (const float*)ptw);
  return cudaSuccess;
}

// Both passes of K5 over b rows of n = S*128*m points (S = 1 is K3's
// register route, and K2's forward's with PERM): the column pass in
// register passes at m = 2048 and 4096 (pass twiddles ptw), else in the
// stage loop on 1 << lshift lanes; the row pass in register passes
// (rptw).
template <int S, bool PERM = false>
static int sf_split_run(const void* xr, const void* xi, void* yr, void* yi,
                        void* sr, void* si, const void* t1r, const void* t1i,
                        const void* ctwr, const void* ctwi,
                        const SFPlan& cplan, const void* spr, const void* spi,
                        const void* ptw, const void* rptw, const void* fr,
                        const void* fi, int b, int m, int lshift,
                        long long in_rs, long long out_rs, float scale,
                        int conj, cudaStream_t st) {
  static bool col_ready[SF_MAX_DEVICES];
  const long long rgrid = (long long)b * (m * S / SF_ROWS);
  if (rgrid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const SFSplitColIO<S> cio{(const float*)xr, (const float*)xi, (float*)sr,
                            (float*)si, (const float*)spr, (const float*)spi,
                            in_rs, (long long)m * SF_N1, 0, 0,
                            (conj & SF_CONJ_IN) ? -1.0f : 1.0f};
  cudaError_t err;
  if (sf_reg_takes(m)) {
    err = m == 2048 ? sf_split_col_reg<S, 2048>(cio, t1r, t1i, ptw, b, st)
                    : sf_split_col_reg<S, 4096>(cio, t1r, t1i, ptw, b, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t smem = 16 * (size_t)m * ((size_t)1 << lshift);
    const long long grid = (long long)b * S * (SF_N1 >> lshift);
    if (smem > SF_SMEM_MAX || grid > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    err = sf_allow_smem(sf_split_col_kernel<S>, col_ready);
    if (err != cudaSuccess) return (int)err;
    sf_split_col_kernel<S><<<(unsigned)grid, SF_COL_THREADS, smem, st>>>(
        cio, (const float*)t1r, (const float*)t1i, (const float*)ctwr,
        (const float*)ctwi, m, lshift, cplan);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const SFSplitRowIO<S, PERM> rio{
      (const float*)sr, (const float*)si, (float*)yr, (float*)yi,
      (const float*)fr, (const float*)fi, out_rs, 0, 0, m, scale,
      (conj & SF_CONJ_OUT) ? -1.0f : 1.0f};
  sf_split_row_kernel<S, PERM>
      <<<(unsigned)rgrid, SF_ROWS * SF_ROW_REG_TPR, 0, st>>>(
          rio, (const float*)rptw);
  return (int)cudaGetLastError();
}

// K2's inverse and K4 on the cluster engine's rows-first order
// (cluster_pass.cuh): row blockIdx.x >> cshift of the permuted (b, m, 128)
// spectrum, with FILT times filter slice (row % nfilt), conjugated in the
// load; the natural output row at yr/yi + row*ys, conjugated and times
// `scale` in the store (K2: ys = n, scale = 1).  Without FILT the load
// reads the spectrum alone, the filter compiled out.  The kernel keeps
// the mode as it came, so its fields stay kernel parameters.
//
// K2's inverse replaces the inverse of cfftpack_tpu/ops/pallas_stream.py:
// _stream_pallas_2d (:352).  Device-memory bytes bound it: this one pass
// reads and writes each element once, 16 bytes, where the two stage-loop
// passes it replaces moved 32.
template <bool FILT>
struct ClRfMode {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  const float* __restrict__ fr;
  const float* __restrict__ fi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  long long n, ys;
  int nfilt, cshift;
  float scale, oscale;  // oscale = -scale
  __device__ __forceinline__ long long row() const {
    return blockIdx.x >> cshift;
  }
  __device__ __forceinline__ void row_load(int k2, int k1, float& vr,
                                           float& vi) const {
    const long long p = row();
    const long long at = (long long)k2 * SF_N1 + k1;
    const float ar = xr[p * n + at], ai = xi[p * n + at];
    if constexpr (FILT) {
      const long long f = (p % nfilt) * n + at;
      const float br = __ldg(fr + f), bi = __ldg(fi + f);
      vr = ar * br - ai * bi;
      vi = -(ar * bi + ai * br);
    } else {
      vr = ar;
      vi = -ai;
    }
  }
  __device__ __forceinline__ void col_store(int q, int r, float vr,
                                            float vi) const {
    const long long at = row() * ys + (long long)q * SF_N1 + r;
    yr[at] = scale * vr;
    yi[at] = oscale * vi;
  }
};

// One cluster of C = 128 >> lshift blocks a row.
template <int M, bool FILT>
__global__ void __launch_bounds__(CL_MAX_THREADS)
    cl_rf_kernel(ClRfMode<FILT> md, const float* __restrict__ t1r,
                 const float* __restrict__ t1i,
                 const float* __restrict__ cptw,
                 const float* __restrict__ rptw, int lshift) {
  extern __shared__ __align__(16) float cl_rf_smem[];
  cl_fft_rows_first<M>(md, cl_rf_smem, t1r, t1i, cptw, rptw, lshift);
}

template <int M, bool FILT>
static cudaError_t cl_rf_run(const ClRfMode<FILT>& md, const void* t1r,
                             const void* t1i, const void* cptw,
                             const void* rptw, int b, int C,
                             cudaStream_t st) {
  static ClReady ready;
  return cl_launch<CL_RF_RS>(cl_rf_kernel<M, FILT>, ready, M, C, b, st, md,
                             (const float*)t1r, (const float*)t1i,
                             (const float*)cptw, (const float*)rptw,
                             cl_log2(SF_N1 / C));
}

// K2's forward on the cluster engine (cluster_pass.cuh): transform
// blockIdx.x >> cshift, its natural input row at xr/xi + row*in_rs
// (in_rs >= n: the caller's paired rows, read with no copy), the permuted
// spectrum out, X[k2 + m*k1] at [k2, k1] of row*n.  After the exchange
// block c owns rows k2 in [c*m/C, (c+1)*m/C), and in the permuted order
// those are one contiguous run of (m/C)*128 floats a plane: its store
// writes them as they lie, threads fastest along k1, so a warp stores 128
// contiguous bytes a plane.
//
// It replaces the forward of cfftpack_tpu/ops/pallas_stream.py:
// _stream_pallas_2d (:352).  Device-memory bytes bound it: this one pass
// reads and writes each element once, 16 bytes, where the two stage-loop
// passes it replaces moved 32 (and the caller's copy of the paired rows
// 16 more).  It is K3's kernel (ClNatMode) with the simplest store of the
// engine.
struct ClPermMode {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  long long n, in_rs;
  int cshift;
  __device__ __forceinline__ long long row() const {
    return blockIdx.x >> cshift;
  }
  __device__ __forceinline__ void col_load(int q, int r, float& vr,
                                           float& vi) const {
    const long long g = row() * in_rs + q * SF_N1 + r;
    vr = xr[g];
    vi = xi[g];
  }
  __device__ __forceinline__ void store(const ClTile& t) const {
    const int count = SF_N1 << t.sh.rshift;
    const long long at =
        row() * n + ((long long)t.sh.c << t.sh.rshift) * SF_N1;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      float vr, vi;
      t.own(e >> 7, e & (SF_N1 - 1), vr, vi);
      yr[at + e] = vr;
      yi[at + e] = vi;
    }
  }
};

// One cluster of C = 128 >> lshift blocks a transform.  After the row
// phase's exchange no block reads another's shared memory, so the store
// needs no cluster barrier.
template <int M>
__global__ void __launch_bounds__(CL_MAX_THREADS)
    cl_perm_kernel(ClPermMode md, const float* __restrict__ t1r,
                   const float* __restrict__ t1i,
                   const float* __restrict__ cptw,
                   const float* __restrict__ rptw, int lshift) {
  extern __shared__ __align__(16) float cl_perm_smem[];
  const ClShape sh =
      cl_fft<M>(md, cl_perm_smem, t1r, t1i, cptw, rptw, lshift);
  md.store(ClTile{cl_perm_smem, sh});
}

template <int M>
static cudaError_t cl_perm_run(const ClPermMode& md, const void* t1r,
                               const void* t1i, const void* cptw,
                               const void* rptw, int b, int C,
                               cudaStream_t st) {
  static ClReady ready;
  return cl_launch(cl_perm_kernel<M>, ready, M, C, b, st, md,
                   (const float*)t1r, (const float*)t1i, (const float*)cptw,
                   (const float*)rptw, cl_log2(SF_N1 / C));
}

// One of K2-K4's modes on `stream`.  x and y are the input and output
// planes, input row p at x + p*in_rs; s the scratch planes; f the (nfilt,
// m, 128) permuted filter slices of mode filter.  The route is
// (mode, m)'s:
//
// * modes fwd, inv (K2) and filter (K4) at m = 128, 256, 512, 1024: one
//   kernel on clusters of `csize` blocks (cluster_pass.cuh), no scratch,
//   fwd columns first (ClPermMode), inv and filter rows first (ClRfMode);
//   t1 is the forward outer twiddle, cptw and rptw the register pass
//   twiddles of m and 128; mode filter writes output row p at y + p*ys
//   (ys >= n) times `scale`;
// * mode fwd at m = 2048 and 4096: K5's two register-pass kernels at
//   S = 1 through the (b, n) scratch, the row pass's store permuted; t1,
//   cptw and rptw as above;
// * every other (mode, m): the two stage-loop passes through the
//   (b, m, 128) scratch, t1 in the mode's sign with the stage plans (ctw,
//   cfac, coff) of the m-point column pass and (rtw, rfac, roff) of the
//   128-point row pass, both with forward-sign twiddles.
//
// Only mode fwd off the stage loop takes in_rs > n, and only mode filter
// on its cluster ys > n or scale != 1.  Returns the first CUDA error, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int stream_fft_f32(
    const void* xr, const void* xi, void* yr, void* yi, void* sr, void* si,
    const void* t1r, const void* t1i, const void* ctwr, const void* ctwi,
    int cstages, const int* cfac, const int* coff, const void* rtwr,
    const void* rtwi, int rstages, const int* rfac, const int* roff,
    const void* cptw, const void* rptw, const void* fr, const void* fi,
    int nfilt, int b, int m, int mode, int csize, int lshift,
    long long in_rs, long long ys, float scale, void* stream) {
  if (b < 1 || m < SF_ROWS || m % SF_ROWS || mode < SF_FWD ||
      mode > SF_FILTER)
    return (int)cudaErrorInvalidValue;
  if (mode == SF_FILTER && (fr == nullptr || fi == nullptr || nfilt < 1))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * SF_N1;
  const bool k2_fwd = mode == SF_FWD && (cl_takes(m) || sf_reg_takes(m));
  const bool k4_cl = mode == SF_FILTER && cl_takes(m);
  if (in_rs < n || (in_rs != n && !k2_fwd) || ys < n ||
      ((ys != n || scale != 1.0f) && !k4_cl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cl_takes(m) && mode != SF_FWD_NAT && mode != SF_INV_NAT) {
    if (cptw == nullptr || rptw == nullptr ||
        !cl_config_ok(m, csize, mode == SF_FWD ? CL_RS : CL_RF_RS))
      return (int)cudaErrorInvalidValue;
    const int cs = cl_log2(csize);
    cudaError_t err;
    if (mode == SF_FWD) {
      const ClPermMode md{(const float*)xr, (const float*)xi, (float*)yr,
                          (float*)yi, n, in_rs, cs};
      err = cl_for_m(m, [&](auto M) {
        return cl_perm_run<decltype(M)::value>(md, t1r, t1i, cptw, rptw, b,
                                               csize, st);
      });
    } else if (mode == SF_FILTER) {
      const ClRfMode<true> md{(const float*)xr, (const float*)xi,
                              (const float*)fr, (const float*)fi,
                              (float*)yr,       (float*)yi,
                              n,                ys,
                              nfilt,            cs,
                              scale,            -scale};
      err = cl_for_m(m, [&](auto M) {
        return cl_rf_run<decltype(M)::value>(md, t1r, t1i, cptw, rptw, b,
                                             csize, st);
      });
    } else {
      const ClRfMode<false> md{(const float*)xr, (const float*)xi,
                               nullptr,          nullptr,
                               (float*)yr,       (float*)yi,
                               n,                n,
                               1,                cs,
                               1.0f,             -1.0f};
      err = cl_for_m(m, [&](auto M) {
        return cl_rf_run<decltype(M)::value>(md, t1r, t1i, cptw, rptw, b,
                                             csize, st);
      });
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (k2_fwd) {
    if (cptw == nullptr || rptw == nullptr) return (int)cudaErrorInvalidValue;
    SFPlan none{};
    return sf_split_run<1, true>(xr, xi, yr, yi, sr, si, t1r, t1i, nullptr,
                                 nullptr, none, nullptr, nullptr, cptw, rptw,
                                 nullptr, nullptr, b, m, 0, in_rs, n, 1.0f,
                                 0, st);
  }
  SFPlan cplan, rplan;
  if (lshift < 0 || lshift > 7 ||
      !sf_make_plan(&cplan, m, cstages, cfac, coff) ||
      !sf_make_plan(&rplan, SF_N1, rstages, rfac, roff))
    return (int)cudaErrorInvalidValue;
  const size_t csmem = 16 * (size_t)m * ((size_t)1 << lshift);
  const long long cgrid = (long long)b * (SF_N1 >> lshift);
  const long long rgrid = (long long)b * (m / SF_ROWS);
  if (csmem > SF_SMEM_MAX || cgrid > 0x7fffffffLL || rgrid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = sf_allow_smem(sf_col_kernel, sf_col_ready);
  if (err != cudaSuccess) return (int)err;
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

// K5 on `stream`: b rows of n = split*128*m points (split = 2 or 4), row
// strides in_rs of x and out_rs of y, the (b*split, m, 128) scratch s.
// t1 is the forward outer twiddle of n/split points, (ctw, cfac, coff) the
// m-point plan of the stage-loop column pass (m other than 4096), sp the
// (split, m, 128) split twiddle, ptw the register pass twiddles of the
// column pass at m = 4096 (else null) and rptw those of the 128-point row
// pass; f a natural n-bin filter or null; the row pass's store multiplies
// by scale; conj bit 1 negates the imaginary plane of the load, bit 2 of
// the store.  Returns the first CUDA error, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int stream_split_f32(
    const void* xr, const void* xi, void* yr, void* yi, void* sr, void* si,
    const void* t1r, const void* t1i, const void* ctwr, const void* ctwi,
    int cstages, const int* cfac, const int* coff, const void* spr,
    const void* spi, int split, const void* ptw, const void* rptw,
    const void* fr, const void* fi, int b, int m, int lshift, long long in_rs,
    long long out_rs, float scale, int conj, void* stream) {
  SFPlan cplan;
  const long long n = (long long)split * m * SF_N1;
  if (b < 1 || m < SF_ROWS || m % SF_ROWS || lshift < 0 || lshift > 7 ||
      !sf_make_plan(&cplan, m, cstages, cfac, coff) ||
      (split != 2 && split != 4) || spr == nullptr || spi == nullptr ||
      rptw == nullptr || in_rs < n || out_rs < n ||
      (fr == nullptr) != (fi == nullptr) || conj < 0 || conj > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return split == 2
             ? sf_split_run<2>(xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi,
                               cplan, spr, spi, ptw, rptw, fr, fi, b, m,
                               lshift, in_rs, out_rs, scale, conj, st)
             : sf_split_run<4>(xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi,
                               cplan, spr, spi, ptw, rptw, fr, fi, b, m,
                               lshift, in_rs, out_rs, scale, conj, st);
}

// K3 on the cluster engine (cluster_pass.cuh): transform blockIdx.x >>
// cshift (one a cluster of 1 << cshift blocks) of the (b, n) natural
// planes, the imaginary plane times isgn in the load and times osgn in
// the store (-1 both ways for the inverse, the conjugated forward), the
// store times `scale`.  The kernel keeps it as it came (no field is
// written), so its fields stay kernel parameters, not registers.
struct ClNatMode {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  float* __restrict__ yr;
  float* __restrict__ yi;
  long long n;
  int cshift;
  float isgn, scale, oscale;  // oscale = osgn * scale
  __device__ __forceinline__ long long at() const {
    return (long long)(blockIdx.x >> cshift) * n;
  }
  __device__ __forceinline__ void col_load(int q, int r, float& vr,
                                           float& vi) const {
    const long long g = at() + q * SF_N1 + r;
    vr = xr[g];
    vi = isgn * xi[g];
  }
  // for each k1 a run of m/C contiguous k2: X[k2 + M*k1]
  template <int M>
  __device__ __forceinline__ void store(const ClTile& t) const {
    const int rows = 1 << t.sh.rshift;
    const long long k20 = at() + ((long long)t.sh.c << t.sh.rshift);
    for (int e = threadIdx.x; e < rows * SF_N1; e += blockDim.x) {
      const int s = e & (rows - 1), k1 = e >> t.sh.rshift;
      float vr, vi;
      t.own(s, k1, vr, vi);
      yr[k20 + (long long)k1 * M + s] = scale * vr;
      yi[k20 + (long long)k1 * M + s] = oscale * vi;
    }
  }
};

// One cluster of C = 128 >> lshift blocks a transform.  After the row
// phase's exchange no block reads another's shared memory, so the store
// needs no cluster barrier.
template <int M>
__global__ void __launch_bounds__(CL_MAX_THREADS)
    cl_nat_kernel(ClNatMode md, const float* __restrict__ t1r,
                  const float* __restrict__ t1i,
                  const float* __restrict__ cptw,
                  const float* __restrict__ rptw, int lshift) {
  extern __shared__ __align__(16) float cl_nat_smem[];
  const ClShape sh =
      cl_fft<M>(md, cl_nat_smem, t1r, t1i, cptw, rptw, lshift);
  md.template store<M>(ClTile{cl_nat_smem, sh});
}

template <int M>
static cudaError_t cl_nat_run(const ClNatMode& md, const void* t1r,
                              const void* t1i, const void* cptw,
                              const void* rptw, int b, int C,
                              cudaStream_t st) {
  static ClReady ready;
  return cl_launch(cl_nat_kernel<M>, ready, M, C, b, st, md,
                   (const float*)t1r, (const float*)t1i, (const float*)cptw,
                   (const float*)rptw, cl_log2(SF_N1 / C));
}

// K3 on `stream`: the natural-order FFT of b rows of n = 128*m points,
// natural (b, n) planes in and out (the inverse unscaled), times `scale`.
// The route is m's:
//
// * m = 128, 256, 512, 1024: one kernel on clusters of `csize` blocks
//   (cluster_pass.cuh), no scratch; t1 is the forward outer twiddle, cptw
//   and rptw the register pass twiddles of m and 128;
// * m = 2048, 4096: K5's two register-pass kernels at S = 1 through the
//   (b, n) scratch s; t1 forward, cptw and rptw as above;
// * every other m: the stage-loop passes of stream_fft_f32 (modes fwd_nat,
//   inv_nat) through the (b, m, 128) scratch s, on 1 << lshift lanes, t1
//   in the direction's sign with the stage plans (ctw, cfac, coff) and
//   (rtw, rfac, roff); it takes scale = 1 only (the caller multiplies).
//
// Returns the first CUDA error, or cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" int stream_nat_f32(
    const void* xr, const void* xi, void* yr, void* yi, void* sr, void* si,
    const void* t1r, const void* t1i, const void* ctwr, const void* ctwi,
    int cstages, const int* cfac, const int* coff, const void* rtwr,
    const void* rtwi, int rstages, const int* rfac, const int* roff,
    const void* cptw, const void* rptw, int b, int m, int inverse, int csize,
    int lshift, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || (inverse != 0 && inverse != 1))
    return (int)cudaErrorInvalidValue;
  const int conj = inverse ? SF_CONJ_IN | SF_CONJ_OUT : 0;
  if (cl_takes(m)) {
    if (cptw == nullptr || rptw == nullptr || !cl_config_ok(m, csize))
      return (int)cudaErrorInvalidValue;
    const float sgn = inverse ? -1.0f : 1.0f;
    const ClNatMode md{(const float*)xr, (const float*)xi, (float*)yr,
                       (float*)yi, (long long)m * SF_N1, cl_log2(csize), sgn,
                       scale, sgn * scale};
    const cudaError_t err = cl_for_m(m, [&](auto M) {
      return cl_nat_run<decltype(M)::value>(md, t1r, t1i, cptw, rptw, b,
                                            csize, st);
    });
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (sf_reg_takes(m)) {
    const long long n = (long long)m * SF_N1;
    if (cptw == nullptr || rptw == nullptr) return (int)cudaErrorInvalidValue;
    SFPlan none{};
    return sf_split_run<1>(xr, xi, yr, yi, sr, si, t1r, t1i, nullptr,
                           nullptr, none, nullptr, nullptr, cptw, rptw,
                           nullptr, nullptr, b, m, 0, n, n, scale, conj, st);
  }
  if (scale != 1.0f) return (int)cudaErrorInvalidValue;
  return stream_fft_f32(xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi,
                        cstages, cfac, coff, rtwr, rtwi, rstages, rfac, roff,
                        nullptr, nullptr, nullptr, nullptr, 1, b, m,
                        inverse ? SF_INV_NAT : SF_FWD_NAT, 0, lshift,
                        (long long)m * SF_N1, (long long)m * SF_N1, 1.0f,
                        stream);
}
