// A batched complex matrix product on split float32 planes, written for
// the dense-DFT passes of K10 (fourstep_fft.cu) and K11 (mm2_fft.cu):
//
//   C[bat][i][j] = tw[i][j] * sum_k A[bat][i][k] * B[bat][k][j]
//
// with i < M, j < N, k < K, every operand addressed through its own
// strides (a batch stride of 0 shares a DFT matrix among all transforms),
// and an optional (M, N) twiddle table in the store, applied in plain
// float32.  The strides carry the layouts of the callers: a natural or a
// permuted spectrum, a transposed read of a symmetric DFT matrix.  A and C
// have one unit-stride index (i or k; i or j), B has unit-stride j.
//
// What bounds it: operations, sent through mma.sync.  The dense DFT does
// 20-40 times a fast transform's operations, so the product runs on the
// tensor cores,
// float32-accurate by a compensated split (3xTF32): every operand is cut
// into a_hi = tf32(a), rounded to nearest, and a_lo = a - a_hi cut to TF32
// (cg_split), and
//
//   a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
//
// is summed in float32, the two small terms first, on mma.sync.m16n8k8
// (TF32 in, float32 out).  That keeps about 22 of the 24 mantissa bits,
// where one TF32 product keeps 10, at a third of the TF32 rate: 165
// TFLOP/s of useful work on this card's 495, against 67 on the CUDA cores.
// A complex product is four real ones (12 mma a tile step; Karatsuba's 9
// measured slower, its extra sums and splits cost more than three mma);
// the subtraction of the imaginary pair is a sign flip of B's fragments.
// The tensor core's own adder truncates, so only the twelve products of
// one 8-step are summed there, from zero; the CUDA cores add that to the
// accumulators, rounded to nearest, which keeps the error flat in K.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, the kernels built on it
// reach 36-58 TFLOP/s of useful work, 0.22-0.35 of the 165: a warp runs
// the splits, the fragment loads and the adds between its mma (a third of
// the mma taken away saves a quarter to a third of the time; twice the
// warps on half the tile each, or Karatsuba, none).  wgmma, with both
// halves of both operands laid out in shared memory, is what is left.
//
// What the design does about the rest:
// * loads: 16-byte cp.async along each operand's unit-stride index into a
//   ring of K chunks in shared memory, so the next chunks arrive under the
//   current one's mma; 4-byte cp.async where an operand's extents or
//   strides are not multiples of 4 floats (m = 3, 100, 255).  A thread's
//   column of a chunk is fixed, so the load loop has no division.  Ragged
//   M, N and K are zero-filled by the copies and masked in the store.
// * shared-memory strides are 8 (rows along k) or 4 (rows along i) past a
//   multiple of 32 words, so every fragment load is free of bank conflicts
//   in either layout.
// * the store goes from the accumulator fragments straight to C: a quad
//   of lanes writes 8 consecutive j (as float2 pairs where C allows it), 8
//   lanes write 8 consecutive i, so either layout fills 32-byte sectors.
//
// The warp-level product (cg_warp_mma), the copies, the ring (cg_pipeline)
// and the store are shared with K11's one-pass kernel in mm2_fft.cu, which
// keeps a whole transform in shared memory between its two products, and
// with K10's pass A in fourstep_fft.cu, which keeps the DFT matrix there,
// split in advance, and walks the batch's column tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CG_THREADS 128
#define CG_TI 64
#define CG_TJ 64
#define CG_TK 32
#define CG_STAGES 3
// shared-memory row strides: rows along k (A as [k][i], B as [k][j]) and
// rows along i (A as [i][k])
#define CG_LDA_KI (CG_TI + 8)
#define CG_LDA_IK (CG_TK + 4)
#define CG_LDB (CG_TJ + 8)
#define CG_A_PLANE \
  (CG_TK * CG_LDA_KI > CG_TI * CG_LDA_IK ? CG_TK * CG_LDA_KI \
                                         : CG_TI * CG_LDA_IK)
#define CG_B_PLANE (CG_TK * CG_LDB)
#define CG_STAGE_FLOATS (2 * CG_A_PLANE + 2 * CG_B_PLANE)
#define CG_SMEM_BYTES (CG_STAGES * CG_STAGE_FLOATS * 4)

struct CGParams {
  const float* ar;  // A[bat][i][k] at bat*a_sb + i*a_si + k*a_sk
  const float* ai;
  long long a_sb, a_si, a_sk;
  const float* br;  // B[bat][k][j] at bat*b_sb + k*b_sk + j*b_sj
  const float* bi;
  long long b_sb, b_sk, b_sj;
  float* cr;  // C[bat][i][j] at bat*c_sb + i*c_si + j*c_sj
  float* ci;
  long long c_sb, c_si, c_sj;
  const float* tr;  // (M, N) row-major twiddle, or nullptr
  const float* ti;
  int M, N, K;
  // set by cg_launch
  int tiles_i, tiles_j;
  int vec_a, vec_b, pair_c;
};

// Internal linkage: each source that includes this header owns its copy.
namespace {

__device__ __forceinline__ void cg_cp16(float* s, const float* g, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(s);
  const int nbytes = ok ? 16 : 0;  // the rest of the 16 bytes is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(g), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cg_cp4(float* s, const float* g, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(s);
  const int nbytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(g), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cg_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The column of a ROWS x COLS tile that this thread copies (the same in
// every row): COLS / 4 chunks of 16 bytes a row, or COLS floats.
template <int COLS>
__device__ __forceinline__ int cg_col(bool vec) {
  return vec ? (int)(threadIdx.x % (COLS / 4)) * 4
             : (int)(threadIdx.x % COLS);
}

// Copy a ROWS x COLS tile of a pair of planes, columns along the
// unit-stride index of device memory, into shared memory at row stride
// lds.  (gr, gi) is the tile's origin, col_off this thread's column there
// (cg_col, or what the caller maps it to), gld the stride between rows.
// Rows from rows_valid on, and the column where col_ok is false, are
// zero-filled.
template <int ROWS, int COLS, int THREADS, bool VEC>
__device__ __forceinline__ void cg_copy(float* sr, float* si, int lds,
                                        const float* gr, const float* gi,
                                        long long col_off, long long gld,
                                        int rows_valid, bool col_ok) {
  constexpr int CPR = VEC ? COLS / 4 : COLS;
  static_assert(CPR <= THREADS && THREADS % CPR == 0, "tile against block");
  const int c = (int)(threadIdx.x % CPR) * (VEC ? 4 : 1);
  for (int r = threadIdx.x / CPR; r < ROWS; r += THREADS / CPR) {
    const bool ok = col_ok && r < rows_valid;
    // an address that is not read still has to be a valid one
    const long long g = ok ? col_off + (long long)r * gld : 0;
    if (VEC) {
      cg_cp16(sr + r * lds + c, gr + g, ok);
      cg_cp16(si + r * lds + c, gi + g, ok);
    } else {
      cg_cp4(sr + r * lds + c, gr + g, ok);
      cg_cp4(si + r * lds + c, gi + g, ok);
    }
  }
}

template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void cg_copy_any(bool vec, float* sr, float* si,
                                            int lds, const float* gr,
                                            const float* gi, long long col_off,
                                            long long gld, int rows_valid,
                                            bool col_ok) {
  if (vec)
    cg_copy<ROWS, COLS, THREADS, true>(sr, si, lds, gr, gi, col_off, gld,
                                       rows_valid, col_ok);
  else
    cg_copy<ROWS, COLS, THREADS, false>(sr, si, lds, gr, gi, col_off, gld,
                                        rows_valid, col_ok);
}

// x = hi + lo + (an error below 2^-21 |x|): hi is x rounded to TF32, to
// nearest with ties away from zero as cvt.rna.tf32.f32 rounds, in two
// integer operations (cvt runs at a quarter of their rate); lo is the
// rest, exact in float32, cut to TF32.  The PTX ISA defines mma's .tf32
// operand as a 32-bit register holding a value in the tf32 format, and
// leaves the result undefined for one that is not, so the low 13 bits of
// both halves are cleared here and not left for the tensor core to drop.
// |x| within 2^-12 of the largest float32 rounds up to infinity, as
// rounding to nearest does on overflow; a NaN stays one through lo.
__device__ __forceinline__ void cg_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16 x 8, float32) += a (16 x 8, TF32, row) * b (8 x 8, TF32, col)
__device__ __forceinline__ void cg_mma(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the first product of a sum
__device__ __forceinline__ void cg_mma0(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// One warp's (16*MT) x (8*NT) complex tile: acc += A * B over 8*ksteps
// values of k, operands in shared memory.  A(i, k) is at i*a_si + k*a_sk
// from (ar, ai), B(k, j) at k*b_sk + j from (br, bi), both already at the
// warp's corner.  Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
// a[e] = A(g + 8*(e & 1), t + 4*(e >> 1)); b[e] = B(t + 4*e, g);
// acc[e] = C(g + 8*(e >> 1), 2*t + (e & 1)).
// With PRE, A comes split already: its hi planes at (ar, ai), its lo planes
// a_lo floats after them.
template <int MT, int NT, bool PRE = false>
__device__ __forceinline__ void cg_warp_mma(
    float (&cr)[MT][NT][4], float (&ci)[MT][NT][4], const float* ar,
    const float* ai, int a_si, int a_sk, const float* br, const float* bi,
    int b_sk, int ksteps, int a_lo = 0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = 8 * ks + t;
    uint32_t arh[MT][4], arl[MT][4], aih[MT][4], ail[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (16 * mt + g + 8 * (e & 1)) * a_si +
                       (k + 4 * (e >> 1)) * a_sk;
        if (PRE) {
          arh[mt][e] = __float_as_uint(ar[at]);
          arl[mt][e] = __float_as_uint(ar[at + a_lo]);
          aih[mt][e] = __float_as_uint(ai[at]);
          ail[mt][e] = __float_as_uint(ai[at + a_lo]);
        } else {
          cg_split(ar[at], arh[mt][e], arl[mt][e]);
          cg_split(ai[at], aih[mt][e], ail[mt][e]);
        }
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t brh[2], brl[2], bih[2], bil[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = (k + 4 * e) * b_sk + 8 * nt + g;
        cg_split(br[at], brh[e], brl[e]);
        cg_split(bi[at], bih[e], bil[e]);
      }
      uint32_t nih[2], nil[2];  // -b_i, for re = ar*br - ai*bi
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        nih[e] = bih[e] ^ 0x80000000u;
        nil[e] = bil[e] ^ 0x80000000u;
      }
      // the eight small terms, then the four large ones, summed in the
      // tensor core from zero and added to the accumulators below
      float pr[MT][4], pi[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma0(pr[mt], arl[mt], brh);
        cg_mma0(pi[mt], arl[mt], bih);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma(pr[mt], arh[mt], brl);
        cg_mma(pi[mt], arh[mt], bil);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma(pr[mt], ail[mt], nih);
        cg_mma(pi[mt], ail[mt], brh);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma(pr[mt], aih[mt], nil);
        cg_mma(pi[mt], aih[mt], brl);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma(pr[mt], arh[mt], brh);
        cg_mma(pi[mt], arh[mt], bih);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        cg_mma(pr[mt], aih[mt], nih);
        cg_mma(pi[mt], aih[mt], brh);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cr[mt][nt][e] += pr[mt][e];
          ci[mt][nt][e] += pi[mt][e];
        }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void cg_zero(float (&cr)[MT][NT][4],
                                        float (&ci)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cr[mt][nt][e] = ci[mt][nt][e] = 0.0f;
}

// The ring over nk chunks of K: load(c, slot) starts chunk c's cp.async
// into a slot, compute(c, slot) multiplies it.  Chunk c + STAGES - 1 is
// started before chunk c is multiplied, into the slot that chunk c - 1 has
// left.  Copies that the caller started before the call, uncommitted, arrive
// with chunk 0.  Returns with every copy landed and every warp past its
// last read of shared memory.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void cg_pipeline(int nk, Load load,
                                            Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cg_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cg_wait<STAGES - 2>();
    __syncthreads();
    const int nx = c + STAGES - 1;
    if (nx < nk) load(nx, nx % STAGES);
    cg_commit();
    compute(c, c % STAGES);
  }
  cg_wait<0>();
  __syncthreads();
}

// 8-step count of a chunk that starts at k0
__device__ __forceinline__ int cg_ksteps(int k0, int K) {
  const int left = K - k0 < CG_TK ? K - k0 : CG_TK;
  return (left + 7) >> 3;
}

// Store one warp's accumulators, times the twiddle where there is one.
// i0 is the warp tile's first row of the M rows, row i at i*c_si; col(c,
// off, twc) maps column c of the warp tile (even, when `pair`) to its
// offset in C and its column of the twiddle, and returns false for a
// column outside the matrix.  With `pair`, columns c and c + 1 are
// neighbours in C and in the twiddle and 8-byte aligned.
template <int MT, int NT, class Col>
__device__ __forceinline__ void cg_store(
    const float (&cr)[MT][NT][4], const float (&ci)[MT][NT][4], float* Cr,
    float* Ci, long long c_si, const float* tr, const float* ti, int tw_ld,
    int i0, int M, bool pair, Col col) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (pair) {
      long long off;
      int twc;
      if (!col(8 * nt + 2 * t, off, twc)) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + 16 * mt + g + 8 * h;
          if (i >= M) continue;
          float2 vr = make_float2(cr[mt][nt][2 * h], cr[mt][nt][2 * h + 1]);
          float2 vi = make_float2(ci[mt][nt][2 * h], ci[mt][nt][2 * h + 1]);
          if (tr != nullptr) {
            const long long at = (long long)i * tw_ld + twc;
            const float2 wr = *reinterpret_cast<const float2*>(tr + at);
            const float2 wi = *reinterpret_cast<const float2*>(ti + at);
            const float2 ur = make_float2(vr.x * wr.x - vi.x * wi.x,
                                          vr.y * wr.y - vi.y * wi.y);
            vi = make_float2(vr.x * wi.x + vi.x * wr.x,
                             vr.y * wi.y + vi.y * wr.y);
            vr = ur;
          }
          *reinterpret_cast<float2*>(Cr + i * c_si + off) = vr;
          *reinterpret_cast<float2*>(Ci + i * c_si + off) = vi;
        }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        long long off;
        int twc;
        if (!col(8 * nt + 2 * t + q, off, twc)) continue;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + 16 * mt + g + 8 * h;
            if (i >= M) continue;
            float vr = cr[mt][nt][2 * h + q], vi = ci[mt][nt][2 * h + q];
            if (tr != nullptr) {
              const long long at = (long long)i * tw_ld + twc;
              const float wr = tr[at], wi = ti[at];
              const float ur = vr * wr - vi * wi;
              vi = vr * wi + vi * wr;
              vr = ur;
            }
            Cr[i * c_si + off] = vr;
            Ci[i * c_si + off] = vi;
          }
      }
    }
  }
}

static inline bool cg_aligned(const void* p, size_t bytes) {
  return (size_t)p % bytes == 0;
}

#define CG_MAX_DEVICES 64

// What a launch needs of the current device, asked once a device and not
// at every launch.  Each kernel has a CGOnce of its own, static at its
// launch site: the first launch on a device raises the kernel's dynamic
// shared memory to smem_bytes and reads the count of SMs, which every call
// returns in *sms where that is given.  A first call made by two threads
// at once does the same work twice.
struct CGOnce {
  int sms[CG_MAX_DEVICES];  // 0 until the device is prepared
};

template <class Kernel>
static inline cudaError_t cg_prepare(CGOnce& once, Kernel kernel,
                                     int smem_bytes, int* sms = nullptr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= CG_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (once.sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    once.sms[dev] = n;
  }
  if (sms != nullptr) *sms = once.sms[dev];
  return cudaSuccess;
}

// A source that takes only the pieces above defines CG_PIECES_ONLY and is
// spared the compilation of the kernel.
#ifndef CG_PIECES_ONLY

// A block of four warps computes a 64 x 64 tile of C, each warp 32 x 32
// of it (2 x 4 mma tiles, 64 accumulators a thread), K in chunks of 32
// through a three-slot ring (111 KB: two blocks an SM).
__global__ void __launch_bounds__(CG_THREADS, 2) cg_kernel(CGParams p) {
  extern __shared__ __align__(16) float cg_smem[];
  constexpr int MT = 2, NT = 4;
  const int warp = threadIdx.x >> 5;
  const int wi = (warp & 1) * 32, wj = (warp >> 1) * 32;

  long long blk = blockIdx.x;
  const int j0 = (int)(blk % p.tiles_j) * CG_TJ;
  blk /= p.tiles_j;
  const int i0 = (int)(blk % p.tiles_i) * CG_TI;
  const long long bat = blk / p.tiles_i;

  // A: rows of the chunk along k where i is the unit-stride index
  const bool a_ki = p.a_si == 1;
  const int a_si_s = a_ki ? 1 : CG_LDA_IK, a_sk_s = a_ki ? CG_LDA_KI : 1;
  const float* Ar = p.ar + bat * p.a_sb + (long long)i0 * p.a_si;
  const float* Ai = p.ai + bat * p.a_sb + (long long)i0 * p.a_si;
  const int a_col = a_ki ? cg_col<CG_TI>(p.vec_a)
                         : cg_col<CG_TK>(p.vec_a);
  const int b_col = j0 + cg_col<CG_TJ>(p.vec_b);
  const long long b_off = bat * p.b_sb + b_col;
  const bool b_ok = b_col < p.N;

  float accr[MT][NT][4], acci[MT][NT][4];
  cg_zero<MT, NT>(accr, acci);

  auto load = [&](int c, int slot) {
    float* sAr = cg_smem + slot * CG_STAGE_FLOATS;
    float* sAi = sAr + CG_A_PLANE;
    float* sBr = sAi + CG_A_PLANE;
    float* sBi = sBr + CG_B_PLANE;
    const int k0 = c * CG_TK;
    if (a_ki)
      cg_copy_any<CG_TK, CG_TI, CG_THREADS>(
          p.vec_a, sAr, sAi, CG_LDA_KI, Ar + (long long)k0 * p.a_sk,
          Ai + (long long)k0 * p.a_sk, a_col, p.a_sk, p.K - k0,
          i0 + a_col < p.M);
    else
      cg_copy_any<CG_TI, CG_TK, CG_THREADS>(
          p.vec_a, sAr, sAi, CG_LDA_IK, Ar + k0, Ai + k0, a_col, p.a_si,
          p.M - i0, k0 + a_col < p.K);
    cg_copy_any<CG_TK, CG_TJ, CG_THREADS>(
        p.vec_b, sBr, sBi, CG_LDB, p.br + (long long)k0 * p.b_sk,
        p.bi + (long long)k0 * p.b_sk, b_off, p.b_sk, p.K - k0, b_ok);
  };
  auto compute = [&](int c, int slot) {
    const float* sAr = cg_smem + slot * CG_STAGE_FLOATS;
    const float* sAi = sAr + CG_A_PLANE;
    const float* sBr = sAi + CG_A_PLANE;
    const float* sBi = sBr + CG_B_PLANE;
    cg_warp_mma<MT, NT>(accr, acci, sAr + wi * a_si_s, sAi + wi * a_si_s,
                        a_si_s, a_sk_s, sBr + wj, sBi + wj, CG_LDB,
                        cg_ksteps(c * CG_TK, p.K));
  };
  cg_pipeline<CG_STAGES>((p.K + CG_TK - 1) / CG_TK, load, compute);

  const int N = p.N;
  const long long c0 = bat * p.c_sb, c_sj = p.c_sj;
  cg_store<MT, NT>(accr, acci, p.cr, p.ci, p.c_si, p.tr, p.ti, N, i0 + wi,
                   p.M, p.pair_c != 0, [=](int c, long long& off, int& twc) {
                     twc = j0 + wj + c;
                     off = c0 + twc * c_sj;
                     return twc < N;
                   });
}

// One product for `batch` matrices on `stream`.
static inline cudaError_t cg_launch(CGParams p, long long batch,
                                    cudaStream_t stream) {
  if (batch < 1 || p.M < 1 || p.N < 1 || p.K < 1)
    return cudaErrorInvalidValue;
  if (p.b_sj != 1 || (p.a_si != 1 && p.a_sk != 1) ||
      (p.c_si != 1 && p.c_sj != 1))
    return cudaErrorInvalidValue;
  p.tiles_i = (p.M + CG_TI - 1) / CG_TI;
  p.tiles_j = (p.N + CG_TJ - 1) / CG_TJ;
  const long long grid = batch * p.tiles_i * p.tiles_j;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 16-byte copies: the unit-stride extent, every other stride and the
  // planes' addresses are multiples of 4 floats
  const bool a_ki = p.a_si == 1;
  p.vec_a = (a_ki ? p.M : p.K) % 4 == 0 && (a_ki ? p.a_sk : p.a_si) % 4 == 0 &&
            p.a_sb % 4 == 0 && cg_aligned(p.ar, 16) && cg_aligned(p.ai, 16);
  p.vec_b = p.N % 4 == 0 && p.b_sk % 4 == 0 && p.b_sb % 4 == 0 &&
            cg_aligned(p.br, 16) && cg_aligned(p.bi, 16);
  p.pair_c = p.c_sj == 1 && p.N % 2 == 0 && p.c_si % 2 == 0 &&
             p.c_sb % 2 == 0 && cg_aligned(p.cr, 8) && cg_aligned(p.ci, 8) &&
             cg_aligned(p.tr, 8) && cg_aligned(p.ti, 8);
  static CGOnce once;
  cudaError_t err = cg_prepare(once, cg_kernel, CG_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cg_kernel<<<(unsigned)grid, CG_THREADS, CG_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

#endif  // CG_PIECES_ONLY

}  // namespace
