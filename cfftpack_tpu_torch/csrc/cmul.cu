// The spectral multiply of the flagship step and its adjoint, for Hopper:
// t = s * F over (rows, h1) re/im planes with one broadcast filter F of
// h1 bins, and the two gradients of that map.
//
// Replaces no TPU kernel.  Under JAX, XLA fused the step's pointwise
// multiply (entry.step: tr = sr*fr - si*fi, ti = sr*fi + si*fr) into its
// neighbours, so the JAX package has no Pallas counterpart; in eager
// PyTorch it was six elementwise launches forward (four broadcast
// multiplies that do not vectorise, an add and a subtract, 1.76 GB at
// (65536, 481) float32) and more for the backward and the filter's row
// sums.  Arithmetic is in the planes' dtype (FMA contraction allowed);
// the filter's gradient sums in float64.
//
// What bounds it: device-memory bytes, each plane element read or written
// once.  The forward reads sr, si and writes tr, ti: 4 planes, 504 MB at
// (65536, 481) float32, 150 us at 3.35 TB/s.  The adjoint reads g_tr,
// g_ti, sr, si and writes g_sr, g_si: 6 planes, 756 MB, 226 us; the
// filter's gradient adds its partial sums, about 1% of that.
//
// * cmul_kernel (forward, and the adjoint in the spectrum alone, which is
//   the same map with the filter conjugated): one flat grid-stride pass
//   over rows*h1 elements with 16-byte loads and stores (4 float32 or 2
//   float64 an access), CM_UNROLL vectors of each plane in flight a
//   thread.  A row of 481 bins is not 16-byte aligned, so the pass does
//   not tile by row: an element's bin is its flat index mod h1, kept as a
//   counter that steps by the grid's stride mod h1 (no division in the
//   loop).  The filter (2*h1 values, 3.8 KB at 481 float32) is staged in
//   shared memory once a block; past 48 KB it is read through the cache.
//   The last total mod 4 (or 2) elements run in scalar code.
// * cmul_adj_kernel (both gradients): blocks own contiguous strips of
//   groups of N rows (N = 4 float32, 2 float64).  A group of N rows of h1
//   bins is h1 16-byte vectors on an aligned base whatever h1 is, and
//   vector t of every group holds the same N bins ((N t + e) mod h1), so
//   a thread owns vector t across its strip: 16-byte loads and stores,
//   and its 2 N partial sums of the filter's gradient (Re and Im of
//   conj(s) * g) stay in registers, in float64.  CMA_GROUPS groups are
//   loaded before any is used; the rows mod N past the last whole group
//   run in scalar code.  Each block writes its sums, one a slot, to a
//   (2, blocks, N h1) float64 scratch that the wrapper allocates (8 MB at
//   book's shape); cmul_reduce_kernel then sums the slots of each bin over
//   blocks in a fixed order (no atomics), so the gradient is the same bit
//   for bit from run to run.  Without `xr` the plane stores are skipped
//   (the filter's gradient alone).
//
// `fs` is the sign of the filter's imaginary part (+1, or -1 for the
// conjugate filter): the map is t = s * (fr + i fs fi).

#include <cuda_runtime.h>

#define CM_THREADS 256
#define CM_UNROLL 4
#define CM_SMEM_MAX (48 * 1024)
#define CMA_THREADS 512
#define CMA_GROUPS 2
#define CMR_X 32
#define CMR_Y 32

template <typename T> struct CmVec;
template <> struct CmVec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <> struct CmVec<double> {
  using type = double2;
  static constexpr int N = 2;
};

template <typename T>
__device__ __forceinline__ void cm_one(T a, T b, T fr, T fi, T& x, T& y) {
  x = a * fr - b * fi;
  y = a * fi + b * fr;
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(CM_THREADS)
    cmul_kernel(const T* __restrict__ sr, const T* __restrict__ si,
                const T* __restrict__ fr, const T* __restrict__ fi,
                T* __restrict__ tr, T* __restrict__ ti, long long total,
                int h1, T fs) {
  using V = typename CmVec<T>::type;
  constexpr int N = CmVec<T>::N;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  const T* gfr = fr;
  const T* gfi = fi;
  if (kSmem) {
    T* s = reinterpret_cast<T*>(cm_smem);
    for (int k = threadIdx.x; k < h1; k += blockDim.x) {
      s[k] = fr[k];
      s[h1 + k] = fi[k];
    }
    __syncthreads();
    gfr = s;
    gfi = s + h1;
  }
  const long long nvec = total / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // bin of the first element of vector v, and how far the bin moves when
  // v moves by the grid's stride
  int bin = (int)((v * N) % h1);
  const int step = (int)((stride * N) % h1);
  const V* vr = reinterpret_cast<const V*>(sr);
  const V* vi = reinterpret_cast<const V*>(si);
  V* wr = reinterpret_cast<V*>(tr);
  V* wi = reinterpret_cast<V*>(ti);
  for (; v < nvec; v += CM_UNROLL * stride) {
    V a[CM_UNROLL], b[CM_UNROLL];
#pragma unroll
    for (int u = 0; u < CM_UNROLL; ++u) {
      const long long w = v + u * stride;
      if (w < nvec) {
        a[u] = __ldg(vr + w);
        b[u] = __ldg(vi + w);
      }
    }
#pragma unroll
    for (int u = 0; u < CM_UNROLL; ++u) {
      const long long w = v + u * stride;
      if (w < nvec) {
        const T* pa = reinterpret_cast<const T*>(&a[u]);
        const T* pb = reinterpret_cast<const T*>(&b[u]);
        V x, y;
        T* px = reinterpret_cast<T*>(&x);
        T* py = reinterpret_cast<T*>(&y);
        int k = bin;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          cm_one(pa[e], pb[e], gfr[k], fs * gfi[k], px[e], py[e]);
          k = (k + 1 == h1) ? 0 : k + 1;
        }
        wr[w] = x;
        wi[w] = y;
      }
      bin += step;
      if (bin >= h1) bin -= h1;
    }
  }
  // the ragged end: fewer than N elements
  if (blockIdx.x == 0 && threadIdx.x < total - nvec * N) {
    const long long e = nvec * N + threadIdx.x;
    const int k = (int)(e % h1);
    cm_one(sr[e], si[e], gfr[k], fs * gfi[k], tr[e], ti[e]);
  }
}

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(CMA_THREADS)
    cmul_adj_kernel(const T* __restrict__ gr, const T* __restrict__ gi,
                    const T* __restrict__ sr, const T* __restrict__ si,
                    const T* __restrict__ fr, const T* __restrict__ fi,
                    T* __restrict__ xr, T* __restrict__ xi,
                    double* __restrict__ part, int rows, int h1,
                    int groups_per_block, T fs) {
  using V = typename CmVec<T>::type;
  constexpr int N = CmVec<T>::N;
  const int full = rows / N;                  // whole groups of N rows
  const int g0 = blockIdx.x * groups_per_block;
  const int g1 = min((rows + N - 1) / N, g0 + groups_per_block);
  const int gf = min(g1, full);
  const long long total = (long long)rows * h1;
  double* pr = part + (long long)blockIdx.x * N * h1;
  double* pi = pr + (long long)gridDim.x * N * h1;
  const V* vgr = reinterpret_cast<const V*>(gr);
  const V* vgi = reinterpret_cast<const V*>(gi);
  const V* vsr = reinterpret_cast<const V*>(sr);
  const V* vsi = reinterpret_cast<const V*>(si);
  V* vxr = reinterpret_cast<V*>(xr);
  V* vxi = reinterpret_cast<V*>(xi);
  // vector t of every group: the slots N*t .. N*t + N - 1, bins mod h1
  for (int t = threadIdx.x; t < h1; t += blockDim.x) {
    T a[N], c[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int k = (N * t + e) % h1;
      a[e] = kPlanes ? fr[k] : T(0);
      c[e] = kPlanes ? fs * fi[k] : T(0);
    }
    double ar[N], ai[N];
#pragma unroll
    for (int e = 0; e < N; ++e) ar[e] = ai[e] = 0.0;
    for (int g = g0; g < gf; g += CMA_GROUPS) {
      V la[CMA_GROUPS], lb[CMA_GROUPS], lc[CMA_GROUPS], ld[CMA_GROUPS];
#pragma unroll
      for (int j = 0; j < CMA_GROUPS; ++j) {
        if (g + j < gf) {
          const long long o = (long long)(g + j) * h1 + t;
          la[j] = __ldg(vgr + o);
          lb[j] = __ldg(vgi + o);
          lc[j] = __ldg(vsr + o);
          ld[j] = __ldg(vsi + o);
        }
      }
#pragma unroll
      for (int j = 0; j < CMA_GROUPS; ++j) {
        if (g + j < gf) {
          const T* pa = reinterpret_cast<const T*>(&la[j]);
          const T* pb = reinterpret_cast<const T*>(&lb[j]);
          const T* pc = reinterpret_cast<const T*>(&lc[j]);
          const T* pd = reinterpret_cast<const T*>(&ld[j]);
          V x, y;
          T* px = reinterpret_cast<T*>(&x);
          T* py = reinterpret_cast<T*>(&y);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            if (kPlanes) {
              px[e] = pa[e] * a[e] + pb[e] * c[e];
              py[e] = pb[e] * a[e] - pa[e] * c[e];
            }
            ar[e] += (double)pa[e] * (double)pc[e] +
                     (double)pb[e] * (double)pd[e];
            ai[e] += (double)pb[e] * (double)pc[e] -
                     (double)pa[e] * (double)pd[e];
          }
          if (kPlanes) {
            const long long o = (long long)(g + j) * h1 + t;
            vxr[o] = x;
            vxi[o] = y;
          }
        }
      }
    }
    if (g1 > full) {
      // the last rows mod N, a partial group: scalar code
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const long long o = (long long)full * N * h1 + (long long)N * t + e;
        if (o < total) {
          const T ga = gr[o], gb = gi[o], sa = sr[o], sb = si[o];
          if (kPlanes) {
            xr[o] = ga * a[e] + gb * c[e];
            xi[o] = gb * a[e] - ga * c[e];
          }
          ar[e] += (double)ga * (double)sa + (double)gb * (double)sb;
          ai[e] += (double)gb * (double)sa - (double)ga * (double)sb;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      pr[N * t + e] = ar[e];
      pi[N * t + e] = ai[e];
    }
  }
}

// dfr[k] = sum over the `slots` rows of h1 partials of their real part,
// dfi[k] = fs times that of the imaginary part: each (x, y) thread sums
// rows y, y + CMR_Y, ... of bin k in order, then thread y = 0 sums the
// CMR_Y results in order.
template <typename T>
__global__ void __launch_bounds__(CMR_X * CMR_Y)
    cmul_reduce_kernel(const double* __restrict__ part, T* __restrict__ dfr,
                       T* __restrict__ dfi, int slots, int h1, T fs) {
  __shared__ double acc[2][CMR_Y][CMR_X + 1];
  const int k = blockIdx.x * CMR_X + threadIdx.x;
  double ar = 0.0, ai = 0.0;
  if (k < h1) {
#pragma unroll 8
    for (int p = threadIdx.y; p < slots; p += CMR_Y) {
      ar += part[(long long)p * h1 + k];
      ai += part[((long long)slots + p) * h1 + k];
    }
  }
  acc[0][threadIdx.y][threadIdx.x] = ar;
  acc[1][threadIdx.y][threadIdx.x] = ai;
  __syncthreads();
  if (threadIdx.y == 0 && k < h1) {
    double sr = 0.0, si = 0.0;
    for (int y = 0; y < CMR_Y; ++y) {
      sr += acc[0][y][threadIdx.x];
      si += acc[1][y][threadIdx.x];
    }
    dfr[k] = (T)sr;
    dfi[k] = fs * (T)si;
  }
}

// ------------------------------------------------------------ launch

template <typename T>
static int cmul_launch(const void* sr, const void* si, const void* fr,
                       const void* fi, void* tr, void* ti, long long total,
                       int h1, int conj, int blocks, void* stream) {
  if (total <= 0 || h1 <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const T fs = conj ? T(-1) : T(1);
  const size_t smem = 2 * (size_t)h1 * sizeof(T);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem <= CM_SMEM_MAX) {
    cmul_kernel<T, true><<<blocks, CM_THREADS, smem, st>>>(
        (const T*)sr, (const T*)si, (const T*)fr, (const T*)fi, (T*)tr,
        (T*)ti, total, h1, fs);
  } else {
    cmul_kernel<T, false><<<blocks, CM_THREADS, 0, st>>>(
        (const T*)sr, (const T*)si, (const T*)fr, (const T*)fi, (T*)tr,
        (T*)ti, total, h1, fs);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int cmul_adj_launch(const void* gr, const void* gi, const void* sr,
                           const void* si, const void* fr, const void* fi,
                           void* xr, void* xi, void* part, void* dfr,
                           void* dfi, int rows, int h1, int conj, int blocks,
                           int groups_per_block, int threads, void* stream) {
  if (rows <= 0 || h1 <= 0 || blocks <= 0 || groups_per_block <= 0 ||
      threads <= 0 || threads > CMA_THREADS)
    return (int)cudaErrorInvalidValue;
  const T fs = conj ? T(-1) : T(1);
  cudaStream_t st = (cudaStream_t)stream;
  if (xr != nullptr) {
    cmul_adj_kernel<T, true><<<blocks, threads, 0, st>>>(
        (const T*)gr, (const T*)gi, (const T*)sr, (const T*)si, (const T*)fr,
        (const T*)fi, (T*)xr, (T*)xi, (double*)part, rows, h1,
        groups_per_block, fs);
  } else {
    cmul_adj_kernel<T, false><<<blocks, threads, 0, st>>>(
        (const T*)gr, (const T*)gi, (const T*)sr, (const T*)si, nullptr,
        nullptr, nullptr, nullptr, (double*)part, rows, h1,
        groups_per_block, fs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cmul_reduce_kernel<T><<<(h1 + CMR_X - 1) / CMR_X, dim3(CMR_X, CMR_Y), 0,
                          st>>>((const double*)part, (T*)dfr, (T*)dfi,
                                blocks * CmVec<T>::N, h1, fs);
  return (int)cudaGetLastError();
}

// t = s * (fr + i fs fi) over `total` elements of the (rows, h1) planes,
// fs = -1 where `conj`; `blocks` of CM_THREADS, a grid-stride pass.  The
// planes' bases must be 16-byte aligned.
extern "C" int cmul_f32(const void* sr, const void* si, const void* fr,
                        const void* fi, void* tr, void* ti, long long total,
                        int h1, int conj, int blocks, void* stream) {
  return cmul_launch<float>(sr, si, fr, fi, tr, ti, total, h1, conj, blocks,
                            stream);
}

extern "C" int cmul_f64(const void* sr, const void* si, const void* fr,
                        const void* fi, void* tr, void* ti, long long total,
                        int h1, int conj, int blocks, void* stream) {
  return cmul_launch<double>(sr, si, fr, fi, tr, ti, total, h1, conj, blocks,
                             stream);
}

// The adjoint for the cotangent planes (gr, gi): the spectrum's gradient
// into (xr, xi) unless xr is null, and the filter's into (dfr, dfi)
// through `part`, 2 * blocks * N * h1 float64 (N = 4 in float32, 2 in
// float64); `blocks` strips of `groups_per_block` groups of N rows,
// `threads` a block, then the reduce.  The planes' bases must be 16-byte
// aligned.
extern "C" int cmul_adj_f32(const void* gr, const void* gi, const void* sr,
                            const void* si, const void* fr, const void* fi,
                            void* xr, void* xi, void* part, void* dfr,
                            void* dfi, int rows, int h1, int conj, int blocks,
                            int groups_per_block, int threads, void* stream) {
  return cmul_adj_launch<float>(gr, gi, sr, si, fr, fi, xr, xi, part, dfr,
                                dfi, rows, h1, conj, blocks, groups_per_block,
                                threads, stream);
}

extern "C" int cmul_adj_f64(const void* gr, const void* gi, const void* sr,
                            const void* si, const void* fr, const void* fi,
                            void* xr, void* xi, void* part, void* dfr,
                            void* dfi, int rows, int h1, int conj, int blocks,
                            int groups_per_block, int threads, void* stream) {
  return cmul_adj_launch<double>(gr, gi, sr, si, fr, fi, xr, xi, part, dfr,
                                 dfi, rows, h1, conj, blocks,
                                 groups_per_block, threads, stream);
}
