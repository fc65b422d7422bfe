// The two passes of the streaming four-step FFT of n = 128*m points,
// shared by K2-K4 (stream_fft.cu) and K7/K8 (rstream_fft.cu).
//
// With the natural tile x[q, r] at flat index j = 128*q + r,
//
//   X[k2 + m*k1] = sum_r W_128^{r*k1} * W_n^{r*k2} * sum_q x[q, r] W_m^{q*k2}
//
// * the column pass runs the m-point DFT over q of L lanes r of one
//   transform, held in shared memory as [q][lane] (consecutive threads on
//   consecutive lanes), with the outer twiddle W_n^{r*k2} fused into its
//   store (forward) or its load (inverse);
// * the row pass runs the 128-point DFT over r of 16 rows k2 at a time
//   ("slots"), through a padded 16 x 130 tile (130 words keep transposed
//   accesses free of bank conflicts).
//
// A kernel supplies the passes' input and output as an IO object, so the
// layouts, gathers and merges of each mode fuse into the loads and
// stores.  Column IO: load(row, j, vr, vi) and store(row, j, vr, vi) at
// the in-transform index j = 128*q + r.  Row IO: load(s, c, vr, vi) for
// slot s and lane c, a flag load_t (slots fastest in the load loop, for
// inputs in natural order), and store(sr, si), which reads the whole
// transformed tile (so a store may pair a row with its mirror).
#pragma once

#include "butterfly.cuh"

#define SF_MAX_STAGES 16
#define SF_COL_THREADS 512
#define SF_ROW_THREADS 256
#define SF_N1 128
#define SF_ROWS 16
#define SF_RS 130
#define SF_SMEM_MAX 232448

struct SFPlan {
  int nstages;
  int p[SF_MAX_STAGES];
  int off[SF_MAX_STAGES];
};

// (vr, vi) *= (wr, wi)
__device__ __forceinline__ void sf_cmul(float& vr, float& vi, float wr,
                                        float wi) {
  const float ur = vr * wr - vi * wi;
  vi = vr * wi + vi * wr;
  vr = ur;
}

// One Stockham stage of radix P over `ntr` transforms of length N held in
// shared memory, element e of transform t at t*rs + e*es.  The stage
// reads index (l*P + k)*mn + j, runs the butterfly over k, multiplies
// output k by tw[off + k*mn + j] (conjugated for the inverse) and writes
// index (k*Lst + l)*mn + j, as cfftpack_tpu/ops/core.py:_stockham does.
// LANES_FAST maps consecutive threads to consecutive transforms (the
// column pass, es = lanes) instead of consecutive j (the row pass).
template <int P, bool LANES_FAST>
__device__ __forceinline__ void sf_stage(
    const float* __restrict__ ir, const float* __restrict__ ii,
    float* __restrict__ orr, float* __restrict__ oi, int ntr, int N, int Lst,
    int mn, int rs, int es, const float* __restrict__ twr,
    const float* __restrict__ twi, int off, bool inv) {
  const int per = N / P;
  const int total = ntr * per;
  const float sgn = inv ? 1.0f : -1.0f;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int tr, bf;
    if (LANES_FAST) {
      tr = t % ntr;
      bf = t / ntr;
    } else {
      bf = t % per;
      tr = t / per;
    }
    const int l = bf / mn;
    const int j = bf - l * mn;
    const int base = tr * rs;
    const int in0 = l * P * mn + j;
    const int out0 = l * mn + j;
    float R[P], I[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      R[k] = ir[base + (in0 + k * mn) * es];
      I[k] = ii[base + (in0 + k * mn) * es];
    }
    radix_butterfly<float, P>(R, I, sgn);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float vr = R[k], vi = I[k];
      if (k > 0 && mn > 1) {
        const float wi = twi[off + k * mn + j];
        sf_cmul(vr, vi, twr[off + k * mn + j], inv ? -wi : wi);
      }
      orr[base + (out0 + k * Lst * mn) * es] = vr;
      oi[base + (out0 + k * Lst * mn) * es] = vi;
    }
  }
}

// Every stage of `plan` between the ping-pong buffers (a, b); returns
// the buffer that holds the result in *outr, *outi.
template <bool LANES_FAST>
__device__ void sf_stages(float* ar, float* ai, float* br, float* bi,
                          int ntr, int N, int rs, int es, const SFPlan& plan,
                          const float* __restrict__ twr,
                          const float* __restrict__ twi, bool inv,
                          float** outr, float** outi) {
  int Lst = 1, rem = N;
  for (int st = 0; st < plan.nstages; ++st) {
    const int p = plan.p[st];
    const int mn = rem / p;
    const int off = plan.off[st];
    switch (p) {
      case 2:
        sf_stage<2, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      case 3:
        sf_stage<3, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      case 4:
        sf_stage<4, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
      default:
        sf_stage<5, LANES_FAST>(ar, ai, br, bi, ntr, N, Lst, mn, rs, es, twr,
                                twi, off, inv);
        break;
    }
    __syncthreads();
    float* tr = ar;
    ar = br;
    br = tr;
    float* ti = ai;
    ai = bi;
    bi = ti;
    Lst *= p;
    rem = mn;
  }
  *outr = ar;
  *outi = ai;
}

// Column pass of lanes [r0, r0 + L) of transform `row`, L = 1 << lshift;
// `smem` holds 4*m*L floats.  The outer twiddle table t1 is (m, 128) in
// the transform's sign, read at the same in-transform index as the data.
template <class IO>
__device__ __forceinline__ void sf_col_pass_at(
    const IO& io, float* smem, const float* __restrict__ t1r,
    const float* __restrict__ t1i, const float* __restrict__ twr,
    const float* __restrict__ twi, int m, int lshift, bool inverse,
    const SFPlan& plan, long long row, int r0) {
  const int L = 1 << lshift;
  const int cnt = m * L;
  float* ar = smem;
  float* ai = ar + cnt;
  float* br = ai + cnt;
  float* bi = br + cnt;

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int g = (e >> lshift) * SF_N1 + r0 + (e & (L - 1));
    float vr, vi;
    io.load(row, g, vr, vi);
    if (inverse) sf_cmul(vr, vi, t1r[g], t1i[g]);
    ar[e] = vr;
    ai[e] = vi;
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<true>(ar, ai, br, bi, L, m, 1, L, plan, twr, twi, inverse, &sr,
                  &si);

  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int g = (e >> lshift) * SF_N1 + r0 + (e & (L - 1));
    float vr = sr[e], vi = si[e];
    if (!inverse) sf_cmul(vr, vi, t1r[g], t1i[g]);
    io.store(row, g, vr, vi);
  }
}

// Column pass of block (row, group) = (blockIdx.x / G, blockIdx.x % G):
// lanes [group*L, group*L + L) of transform `row`.
template <class IO>
__device__ __forceinline__ void sf_col_pass(
    const IO& io, float* smem, const float* __restrict__ t1r,
    const float* __restrict__ t1i, const float* __restrict__ twr,
    const float* __restrict__ twi, int m, int lshift, bool inverse,
    const SFPlan& plan) {
  const int G = SF_N1 >> lshift;
  sf_col_pass_at(io, smem, t1r, t1i, twr, twi, m, lshift, inverse, plan,
                 (long long)(blockIdx.x / G),
                 (int)(blockIdx.x % G) << lshift);
}

// Load-loop and store-loop order of the row pass: element e is slot s,
// lane c, lanes fastest (a slot's 128 values contiguous), or with
// `transposed` slots fastest (runs of 16 slots at one lane).
__device__ __forceinline__ void sf_row_slot(int e, bool transposed, int& s,
                                            int& c) {
  if (transposed) {
    s = e % SF_ROWS;
    c = e / SF_ROWS;
  } else {
    s = e >> 7;
    c = e & (SF_N1 - 1);
  }
}

// Row pass of one block: the 128-point DFT of the 16 slots the IO
// object names; `smem` holds 4*16*SF_RS floats.
template <class IO>
__device__ __forceinline__ void sf_row_pass(
    const IO& io, float* smem, const float* __restrict__ twr,
    const float* __restrict__ twi, bool inverse, const SFPlan& plan) {
  float* ar = smem;
  float* ai = ar + SF_ROWS * SF_RS;
  float* br = ai + SF_ROWS * SF_RS;
  float* bi = br + SF_ROWS * SF_RS;

  for (int e = threadIdx.x; e < SF_ROWS * SF_N1; e += blockDim.x) {
    int s, c;
    sf_row_slot(e, io.load_t, s, c);
    float vr, vi;
    io.load(s, c, vr, vi);
    ar[s * SF_RS + c] = vr;
    ai[s * SF_RS + c] = vi;
  }
  __syncthreads();

  float *sr, *si;
  sf_stages<false>(ar, ai, br, bi, SF_ROWS, SF_N1, SF_RS, 1, plan, twr, twi,
                   inverse, &sr, &si);
  io.store(sr, si);
}

static inline bool sf_make_plan(SFPlan* plan, int N, int nstages,
                                const int* factors, const int* offs) {
  if (nstages < 1 || nstages > SF_MAX_STAGES) return false;
  long long prod = 1;
  plan->nstages = nstages;
  for (int s = 0; s < nstages; ++s) {
    const int p = factors[s];
    if (p < 2 || p > 5) return false;
    plan->p[s] = p;
    plan->off[s] = offs[s];
    prod *= p;
  }
  return prod == N;
}
