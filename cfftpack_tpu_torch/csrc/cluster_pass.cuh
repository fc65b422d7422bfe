// The streaming four-step FFT of n = 128*m points in one pass, on a
// thread-block cluster of C blocks that read each other's shared memory
// (distributed shared memory).  Used by K2, K3 and K4 (stream_fft.cu) and
// by K7's modes rfft, irfft, dct2 and dct3 and K8's dct4 (rstream_fft.cu).
//
// Replaces, on Hopper, the TPU kernels
//   K2  cfftpack_tpu/ops/pallas_stream.py:_stream_pallas_2d (:352);
//   K3  cfftpack_tpu/ops/pallas_stream.py:_stream_pallas_2d_nat (:386);
//   K4  cfftpack_tpu/ops/pallas_stream.py:_stream_filter_inv_2d (:444);
//   K7  cfftpack_tpu/ops/pallas_rstream.py: srfft_stream_pallas (:157),
//       sirfft_stream_pallas (:166), sdct2_stream_pallas (:252) and
//       sdct3_stream_pallas (:260);
//   K8  cfftpack_tpu/ops/dct.py:_dct4_stream_tail (:285),
// which hold a whole transform in VMEM.  With the natural tile x[q, r]
// at flat index j = 128*q + r, as stream_pass.cuh:
//
//   X[k2 + m*k1] = sum_r W_128^{r*k1} * W_n^{r*k2} * sum_q x[q, r] W_m^{q*k2}
//
// What bounds it: device-memory bytes, 16 an element (one read and one
// write of both float32 planes).  One transform (8n bytes: 512 KB at
// n = 65536) is more than a block's 227 KB, so C blocks of one cluster
// hold it between them, and a transform moves through device memory once.
// cl_fft runs it columns first (natural input):
//
// * column phase: block c owns lanes r in [c*L, (c+1)*L), L = 128/C, of
//   all m rows q.  Its first register pass (regfft.cuh, 16 elements a
//   thread, lanes fastest in the thread index) reads row segments of L
//   consecutive floats through the mode's col_load (64 bytes a plane at
//   C = 8, 32 at C = 16); the m-point DFT over q runs in register passes
//   and its result stays in the block's shared memory, [q][lane] with a
//   pad row after every 16 and the lane XOR-swizzled by q (see ClShape),
//   so that the exchange's reads below hit 32 banks;
// * exchange: cluster.sync(); block c then owns rows k2 in
//   [c*m/C, (c+1)*m/C).  The first register pass of its 128-point row DFT
//   reads lane r of row k2 from block r / L in the cluster's shared
//   memory (cl_ld: mapa, ld.shared::cluster) and multiplies the outer twiddle
//   W_n^{r*k2} (an (m, 128) table, read once a call, held in L2).  Every
//   thread waits at a second cluster.sync() (regfft.cuh's after_load
//   hook) between those reads and its first write, so no block overwrites
//   rows another block is still reading;
// * row phase and store: the 128-point DFT in register passes, (4*4)(4*2)
//   on 8 threads a row, left in shared memory at a row stride of 137
//   words (a pad word after every 16 lanes; odd, so a store reading one
//   lane of 32 consecutive rows hits 32 banks).  The mode's store then
//   writes what it owns: for K3, for each k1 a run of m/C contiguous
//   outputs k2 + m*k1, times `scale`; for K2, its rows in the permuted
//   order as they lie, one contiguous run.  A store that reads another
//   block's rows (K7's mirror merge, the pairs of dct3 and K8) runs
//   between two more cluster.sync()s, the last one keeping every block's
//   shared memory alive until no block reads it.
//
// cl_fft_rows_first runs the same formula the other way round, for an
// input in the permuted order X[k2 + m*k1] at [k2, k1] (the spectrum of
// K4 and of K2's inverse):
// block c first owns rows k2 and loads them through the mode's row_load
// (contiguous 512-byte rows), runs the 128-point DFT over k1 -> r and
// leaves it in a row layout of its own (cl_rf_row); after a cluster.sync()
// each block takes its L lanes r, its first column pass reads lane r of
// every row k2 from the block that owns it and multiplies the outer
// twiddle W_n^{r*k2}, a second cluster.sync() (after_load) comes before
// any write, the m-point DFT over k2 -> q runs in register passes, and
// its last pass hands each output x[128*q + r] to the mode's col_store
// from registers.
//
// The inverse is the conjugated forward, ifft(X) = conj(fft(conj(X))):
// the modes negate the imaginary plane in their first load and last
// store, so one kernel and one twiddle direction serve both, and every
// input and output keeps its order.
//
// Size of C.  One buffer of both planes, m*L*8 bytes plus 1/16 of pad in
// the column layout, (m/C)*137*8 (rows first: (m/C)*152*8) in the row
// layout, whichever is larger; 8m/C threads (16 elements each), so
// C >= m/128.  C = 16 is past the portable cluster size, so every cluster
// kernel opts in (cudaFuncAttributeNonPortableClusterSizeAllowed).  The
// rule (stream_fft._cluster_size) takes C = m/16 up to 16: 128 threads a
// block at m = 128 and 256, 256 at 512 (35 KB), 512 at 1024 (70 KB).  On
// an H100 the smallest blocks were the fastest from m = 256 on (the more
// blocks an SM holds, the more their phases overlap); chip_smoke.py's
// phase 25c sweeps C at m = 512.  The rows-first order ran fastest with
// the largest blocks at small m: it takes C = 2 at m = 128 and 256 and
// 16 at 512 and 1024 (stream_fft._filter_cluster_size).  A cluster of C
// blocks must fit the card at once: the launch checks
// cudaOccupancyMaxActiveClusters once per (kernel, C, device) and
// refuses a configuration that fits no cluster.
//
// Registers.  At 1024 threads an SM (four blocks of 256 at m = 512) a
// thread has 64 registers, and the kernels spill some 16 to 140 bytes.
// Bounds of 256 threads and 3 blocks an SM (85 registers, little spill)
// measured faster at m = 128 and 512 but do not admit m = 1024's 512
// threads or the C sweep; 512 threads at 128 registers (no spill)
// measured slower.
//
// Reads of another block's rows.  The exchange reads runs of 8
// contiguous floats (32 bytes), 4 a warp; the stores that read mirror
// rows take them in tiles (cl_tile): a warp reading one float from each
// of 32 rows made K7's stores far slower.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "regfft.cuh"
#include "stream_pass.cuh"

#define CL_MAX_DEVICES 64
// threads a block at most (64 registers a thread; see "Registers" above)
#define CL_MAX_THREADS 1024
// C = 16 is past the portable cluster size: its kernels opt in
#define CL_MAX_SIZE 16
// elements a thread holds, as in K1 and K5
#define CL_ELEMS 16
// the row phase: threads a 128-point row, and the padded row stride
#define CL_ROW_TPR 8
#define CL_RS 137
// the row stride of the rows-first order (cl_rf_row)
#define CL_RF_RS 152

// The column schedules compiled, plan.reg_passes(m) for each m.
template <int M>
struct ClCol;
template <>
struct ClCol<128> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 2>>;
};
template <>
struct ClCol<256> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>>;
};
template <>
struct ClCol<512> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<2>>;
};
template <>
struct ClCol<1024> {
  using type = RfList<RfPass<4, 4>, RfPass<4, 4>, RfPass<4>>;
};
// plan.reg_passes(128)
using ClRow = RfList<RfPass<4, 4>, RfPass<4, 2>>;

// Where a block keeps its part of the transform (in floats, from the
// start of its buffer; the imaginary plane follows the real one).
struct ClShape {
  int c;       // this block's rank in the cluster
  int lshift;  // log2 L: lanes a block owns in the column phase
  int rshift;  // log2 (m/C): rows a block owns in the row phase
  int cs;      // one plane in the column layout
  int rsz;     // one plane in the row layout
  // Column layout: element q of lane `lane`.  The XOR swizzle puts the
  // exchange's reads (4 consecutive rows q, 8 consecutive lanes a warp)
  // in 4 different groups of 8 banks, and permutes only within one row's
  // group of 32 (16) lanes, which a column-phase warp reads together; at
  // 8 lanes the rows alone do that.
  __device__ __forceinline__ int col(int q, int lane) const {
    const int sw = lshift >= 5   ? (q & 3) << 3
                   : lshift == 4 ? ((q >> 1) & 1) << 3
                                 : 0;
    return ((q + (q >> 4)) << lshift) + (lane ^ sw);
  }
  // Row layout: lane k1 of row slot s.
  __device__ __forceinline__ static int row(int s, int k1) {
    return s * CL_RS + k1 + (k1 >> 4);
  }
};

// The float at `p` in the shared memory of block `rank` of this cluster
// (p is this block's address of it): ld.shared::cluster on the address
// mapa gives.  The memory clobber keeps it between the barriers around it.
__device__ __forceinline__ float cl_ld(const float* p, unsigned rank) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned ra;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(ra)
               : "memory");
  return v;
#else
  return *cooperative_groups::this_cluster().map_shared_rank(p, rank);
#endif
}

// Every thread of the cluster waits here.
__device__ __forceinline__ void cl_sync() {
  cooperative_groups::this_cluster().sync();
}

// The row-phase result of the whole cluster.
struct ClTile {
  float* buf;
  ClShape sh;
  // bin (k2, k1) from this block's rows, s = k2 - c*m/C
  __device__ __forceinline__ void own(int s, int k1, float& vr,
                                      float& vi) const {
    const int at = ClShape::row(s, k1);
    vr = buf[at];
    vi = buf[sh.rsz + at];
  }
  // bin (k2, k1) from whichever block owns row k2
  __device__ __forceinline__ void any(int k2, int k1, float& vr,
                                      float& vi) const {
    const unsigned o = (unsigned)(k2 >> sh.rshift);
    const float* p = buf + ClShape::row(k2 & ((1 << sh.rshift) - 1), k1);
    vr = cl_ld(p, o);
    vi = cl_ld(p + sh.rsz, o);
  }
};

// The bin (slot s, lane k1) of item e of a store loop over rows x K1
// bins (K1 a multiple of 8) that reads another block's rows: each warp
// takes a tile of 1 << CL_STORE_TILE consecutive rows by 32 >>
// CL_STORE_TILE consecutive lanes, so that its reads of the mirror rows
// are runs of contiguous floats in the other block, where one row a
// thread would make 32 single-word reads.  On an H100, tiles of 8 rows
// by 4 lanes were the fastest of 4, 8 and 32 rows a warp for K7's three
// modes that read mirror rows; 32 (one row a thread) the slowest by far.
#define CL_STORE_TILE 3
__device__ __forceinline__ void cl_tile(int e, int rshift, int& s, int& k1) {
  const int ts = CL_STORE_TILE < rshift ? CL_STORE_TILE : rshift;
  const int lane = e & 31, w = e >> 5, tr = rshift - ts;
  s = ((w & ((1 << tr) - 1)) << ts) + (lane >> (5 - ts));
  k1 = ((w >> tr) << (5 - ts)) + (lane & ((32 >> ts) - 1));
}

// Column-phase IO of lane `lane` (global lane r): the mode's load, the
// result left in shared memory.
template <class Mode>
struct ClColIO {
  static constexpr bool last_in_smem = true;
  Mode md;
  float* sr;
  float* si;
  ClShape sh;
  int lane, r;
  __device__ __forceinline__ int sidx(int e) const { return sh.col(e, lane); }
  __device__ __forceinline__ void gload(int e, float& vr, float& vi) const {
    md.col_load(e, r, vr, vi);
  }
  __device__ __forceinline__ void gstore(int, float, float) const {}
};

// Row-phase IO of row k2: lane r from block r / L, times the outer
// twiddle; the cluster waits between the first pass's reads and writes.
struct ClRowIO {
  static constexpr bool last_in_smem = true;
  float* sr;
  float* si;
  float* buf;
  const float* __restrict__ t1r;
  const float* __restrict__ t1i;
  ClShape sh;
  int k2;
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 4); }
  __device__ __forceinline__ void gload(int r, float& vr, float& vi) const {
    const unsigned o = (unsigned)(r >> sh.lshift);
    const float* p = buf + sh.col(k2, r & ((1 << sh.lshift) - 1));
    vr = cl_ld(p, o);
    vi = cl_ld(p + sh.cs, o);
    const int g = k2 * SF_N1 + r;
    sf_cmul(vr, vi, __ldg(t1r + g), __ldg(t1i + g));
  }
  __device__ __forceinline__ void gstore(int, float, float) const {}
  __device__ __forceinline__ void after_load() const {
    cooperative_groups::this_cluster().sync();
  }
};

__host__ __device__ constexpr int cl_log2(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// Both phases of one transform of n = 128*M on this cluster (L = 1 <<
// lshift lanes a block): the mode's column load, the column DFT, the
// exchange with the outer twiddle t1 (forward, (M, 128)), the row DFT.
// cptw and rptw are the pass twiddles of M and of 128
// (plan.reg_twiddles).  Returns where the result lies; the caller runs
// the mode's store.
template <int M, class Mode>
__device__ __forceinline__ ClShape cl_fft(const Mode& md, float* buf,
                                          const float* __restrict__ t1r,
                                          const float* __restrict__ t1i,
                                          const float* __restrict__ cptw,
                                          const float* __restrict__ rptw,
                                          int lshift) {
  constexpr int LOGM = cl_log2(M);
  const int c = (int)cooperative_groups::this_cluster().block_rank();
  const int rshift = LOGM + lshift - 7;
  const ClShape sh{c, lshift, rshift, (M + (M >> 4)) << lshift,
                   (1 << rshift) * CL_RS};
  {
    const int lane = threadIdx.x & ((1 << lshift) - 1);
    const ClColIO<Mode> io{md, buf, buf + sh.cs, sh, lane,
                           (c << lshift) + lane};
    rf_run<float, M, M / CL_ELEMS>(io, threadIdx.x >> lshift, cptw, -1.0f,
                                   typename ClCol<M>::type{});
  }
  cooperative_groups::this_cluster().sync();
  {
    const int s = threadIdx.x / CL_ROW_TPR;
    const ClRowIO io{buf + s * CL_RS, buf + sh.rsz + s * CL_RS, buf, t1r,
                     t1i, sh, (c << rshift) + s};
    rf_run<float, SF_N1, CL_ROW_TPR>(io, threadIdx.x % CL_ROW_TPR, rptw,
                                     -1.0f, ClRow{});
  }
  return sh;
}

// The row layout of the rows-first order: lane k1 of row slot s, a pad
// word after every 8 lanes, rows CL_RF_RS = 152 words apart (24 mod 32).
// A row-phase warp writes 8 consecutive lanes, or reads 8 lanes 8 apart,
// of 4 consecutive rows, and a column-phase warp at L = 8 reads 8
// consecutive lanes of 4 consecutive rows: each hits 32 banks (at L = 64
// a column-phase warp reads 32 lanes of one row, two threads on 3 banks).
// 137, odd, does not serve: rows 9 banks apart overlap a run of 8.
__device__ __forceinline__ int cl_rf_row(int s, int k1) {
  return s * CL_RF_RS + k1 + (k1 >> 3);
}

// Row-phase IO of the rows-first order: row k2 through the mode's
// row_load, the result left in the row layout.
template <class Mode>
struct ClRfRowIO {
  static constexpr bool last_in_smem = true;
  Mode md;
  float* sr;
  float* si;
  int k2;
  __device__ __forceinline__ int sidx(int e) const { return e + (e >> 3); }
  __device__ __forceinline__ void gload(int k1, float& vr, float& vi) const {
    md.row_load(k2, k1, vr, vi);
  }
  __device__ __forceinline__ void gstore(int, float, float) const {}
};

// Column-phase IO of the rows-first order, lane `lane` (global lane r):
// row k2 from block k2 >> rshift times the outer twiddle W_n^{r*k2}; the
// cluster waits between the first pass's reads and writes; the last pass
// hands output q to the mode's col_store.
template <class Mode>
struct ClRfColIO {
  static constexpr bool last_in_smem = false;
  Mode md;
  float* sr;
  float* si;
  float* buf;
  const float* __restrict__ t1r;
  const float* __restrict__ t1i;
  ClShape sh;
  int lane, r;
  __device__ __forceinline__ int sidx(int e) const { return sh.col(e, lane); }
  __device__ __forceinline__ void gload(int k2, float& vr, float& vi) const {
    const unsigned o = (unsigned)(k2 >> sh.rshift);
    const float* p = buf + cl_rf_row(k2 & ((1 << sh.rshift) - 1), r);
    vr = cl_ld(p, o);
    vi = cl_ld(p + sh.rsz, o);
    const int g = k2 * SF_N1 + r;
    sf_cmul(vr, vi, __ldg(t1r + g), __ldg(t1i + g));
  }
  __device__ __forceinline__ void gstore(int q, float vr, float vi) const {
    md.col_store(q, r, vr, vi);
  }
  __device__ __forceinline__ void after_load() const { cl_sync(); }
};

// The forward transform of n = 128*M from the permuted order on this
// cluster (L = 1 << lshift lanes a block): the mode's row load, the row
// DFT, the exchange with the outer twiddle t1 (forward, (M, 128)), the
// column DFT and the mode's column store.  cptw and rptw are the pass
// twiddles of M and of 128 (plan.reg_twiddles).  No block reads another's
// shared memory after the exchange, so the cluster needs no barrier at
// the end.
template <int M, class Mode>
__device__ __forceinline__ void cl_fft_rows_first(
    const Mode& md, float* buf, const float* __restrict__ t1r,
    const float* __restrict__ t1i, const float* __restrict__ cptw,
    const float* __restrict__ rptw, int lshift) {
  constexpr int LOGM = cl_log2(M);
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int rshift = LOGM + lshift - 7;
  const ClShape sh{rank, lshift, rshift, (M + (M >> 4)) << lshift,
                   (1 << rshift) * CL_RF_RS};
  {
    const int s = threadIdx.x / CL_ROW_TPR;
    const ClRfRowIO<Mode> io{md, buf + s * CL_RF_RS,
                             buf + sh.rsz + s * CL_RF_RS,
                             (rank << rshift) + s};
    rf_run<float, SF_N1, CL_ROW_TPR>(io, threadIdx.x % CL_ROW_TPR, rptw,
                                     -1.0f, ClRow{});
  }
  cl_sync();
  {
    const int lane = threadIdx.x & ((1 << lshift) - 1);
    const ClRfColIO<Mode> io{md,  buf, buf + sh.cs, buf, t1r, t1i,
                             sh,  lane, (rank << lshift) + lane};
    rf_run<float, M, M / CL_ELEMS>(io, threadIdx.x >> lshift, cptw, -1.0f,
                                   typename ClCol<M>::type{});
  }
}

// Whether cl_fft is compiled for m.
__host__ __device__ constexpr bool cl_takes(int m) {
  return m == 128 || m == 256 || m == 512 || m == 1024;
}

// f(std::integral_constant<int, m>{}) for an m that cl_takes: the launch
// of a kernel compiled for that m.
template <class F>
static inline cudaError_t cl_for_m(int m, F&& f) {
  switch (m) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return f(std::integral_constant<int, 1024>{});
  }
}

// Threads and dynamic shared memory of a cluster block at (m, C), with
// row stride rs (CL_RS columns first, CL_RF_RS rows first).
static inline int cl_threads(int m, int C) { return 8 * m / C; }
static inline size_t cl_smem(int m, int C, int rs = CL_RS) {
  const size_t L = SF_N1 / C;
  const size_t col = 2 * (size_t)(m + m / 16) * L;
  const size_t row = 2 * (size_t)(m / C) * rs;
  return sizeof(float) * (col > row ? col : row);
}

// Whether (m, C) is a configuration the kernels take: C a power of two
// up to CL_MAX_SIZE, at most CL_MAX_THREADS threads and SF_SMEM_MAX bytes
// a block.
static inline bool cl_config_ok(int m, int C, int rs = CL_RS) {
  return cl_takes(m) && C >= 1 && C <= CL_MAX_SIZE && (C & (C - 1)) == 0 &&
         cl_threads(m, C) <= CL_MAX_THREADS &&
         cl_smem(m, C, rs) <= SF_SMEM_MAX;
}

// Once-per-device state of one cluster kernel: its shared-memory cap
// raised (and C = 16 allowed), and for each C whether a cluster of it
// fits (0 unknown, 1 yes).
struct ClReady {
  bool smem[CL_MAX_DEVICES];
  signed char fits[CL_MAX_DEVICES][5];
};

// Launches `kernel` on b clusters of C blocks (grid b*C) on `st`, its
// row layout at stride RS.  The first launch on a device raises the
// kernel's dynamic shared-memory cap; the first at each C checks that at
// least one cluster fits the card (cudaErrorInvalidConfiguration if none
// does).
template <int RS = CL_RS, class... Exp, class... Act>
static cudaError_t cl_launch(void (*kernel)(Exp...), ClReady& ready, int m,
                             int C, long long b, cudaStream_t st,
                             Act&&... args) {
  if (!cl_config_ok(m, C, RS) || b < 1 || b * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= CL_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready.smem[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SF_SMEM_MAX);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready.smem[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * C));
  cfg.blockDim = dim3((unsigned)cl_threads(m, C));
  cfg.dynamicSmemBytes = cl_smem(m, C, RS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int ci = cl_log2(C);
  if (ready.fits[dev][ci] == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    ready.fits[dev][ci] = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}
