// Register passes: a Stockham FFT of N points whose stages run in
// registers, a few at a time, with one shared-memory exchange between
// such groups instead of one per stage.  Used by K1 (stockham_fft.cu) and
// by both passes of K5 (stream_fft.cu).
//
// A pass groups consecutive plan stages of radices q_1..q_g (outer to
// inner, as plan.factor lists them) into one radix R = q_1*...*q_g.  With
// L the product of the earlier passes' radices and MN = N / (L*R), the
// butterfly (l, j), l < L, j < MN, reads element (l*R + t)*MN + j for
// t < R, runs the R-point DFT in registers and writes element
// (u*L + l)*MN + j times the pass twiddle W_{R*MN}^{u*j}.  That is the
// composition of its plan stages: a stage's twiddle splits into a part
// that depends on j, which commutes with the later butterflies and
// gathers into the one pass twiddle, and a constant W_{Q_i}^{k*lo}
// (Q_i = q_i*...*q_g, lo the register's lower digits), compiled in.
// Register t holds digits (t_1..t_g), t_1 most significant; stage i
// transforms digit i in place, so the result at register t is output
// u = k_1 + q_1*k_2 + q_1*q_2*k_3 + ... (the digits reversed).
//
// Each thread runs NB = ceil((N/R) / TPR) butterflies b of a pass,
// beta = tid + b*TPR, (l, j) = (beta / MN, beta % MN).  The first pass
// reads device memory and the last writes it through the IO object (each
// warp access is 32 consecutive elements); between passes the data stays
// in one shared-memory buffer, exchanged in place: every read of a pass
// happens before a barrier and every write after it.  The pass twiddles
// are one float64-built table of (re, im) pairs (plan.reg_twiddles), pass
// after pass for the passes with MN > 1: for each j, W_{R*MN}^{d*h_i*j}
// for every digit i of the output index (place h_i = q_1*...*q_{i-1}) and
// 1 <= d < q_i.  A butterfly reads its sum(q_i - 1) entries into registers
// before its DFT (6 for R = 4*4, not 15) and builds the twiddle of output
// u = sum d_i*h_i as the product of its digits' entries.  Only the first
// pass's table is large (MN = N/R), and there each j is one butterfly of
// a row (L = 1), so a block holding one row reads each entry once: staging
// it in shared memory would add a copy and save no read.  The later
// passes' tables are MN*NW pairs and stay in L1.  The constants of the
// inner stages are literals.
// Indices into the register arrays are compile-time throughout (rf_for),
// so the arrays stay in registers.
//
// An IO object gives: gload(e, vr, vi) and gstore(e, vr, vi) of element e
// of this thread's transform (device memory; they mask what is not
// there), and sr, si, sidx(e), where element e sits in shared memory.
// With last_in_smem the last pass writes shared memory too (gstore is not
// called), for a store that needs the whole block's results.  An IO
// object with a member after_load() has it called by every thread
// between the first pass's loads and its first writes (the cluster
// engine, cluster_pass.cuh, waits there until every block of its
// cluster has read the shared memory it is about to overwrite).
#pragma once

#include <type_traits>
#include <utility>

#include "butterfly.cuh"

template <class F, int... I>
__device__ __forceinline__ void rf_for_seq(F& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled.
template <int N, class F>
__device__ __forceinline__ void rf_for(F&& f) {
  rf_for_seq(f, std::make_integer_sequence<int, N>{});
}

// cos and sin of 2*pi*k/d at compile time: the quadrant, then Taylor
// series on [0, pi/2) in double.
__host__ __device__ constexpr double rf_taylor(double x, bool sine) {
  double term = sine ? x : 1.0, sum = term;
  for (int i = 1; i < 14; ++i) {
    const int a = sine ? 2 * i : 2 * i - 1;
    term *= -x * x / (double(a) * double(a + 1));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double rf_cs(int k, int d, bool sine) {
  k = ((k % d) + d) % d;
  const int quad = (4 * k) / d;
  const double r = 6.283185307179586476925 * (double(k) / double(d)) -
                   1.570796326794896619231 * quad;
  const double c = rf_taylor(r, false), s = rf_taylor(r, true);
  switch (quad) {
    case 0: return sine ? s : c;
    case 1: return sine ? c : -s;
    case 2: return sine ? -s : -c;
    default: return sine ? -c : s;
  }
}

// A pass of sub-radices Q... (each 2, 3, 4 or 5).
template <int... Q>
struct RfPass {
  static constexpr int G = sizeof...(Q);
  static constexpr int R = (Q * ... * 1);
  static constexpr int q[G] = {Q...};
  // stride of digit i in the register index: q_{i+1} * ... * q_g
  __host__ __device__ static constexpr int stride(int i) {
    int s = 1;
    for (int k = i + 1; k < G; ++k) s *= q[k];
    return s;
  }
  // the output held by register t
  __host__ __device__ static constexpr int out(int t) {
    int u = 0, h = 1;
    for (int i = 0; i < G; ++i) {
      u += ((t / stride(i)) % q[i]) * h;
      h *= q[i];
    }
    return u;
  }
  // place of digit i in the output index: q_1 * ... * q_{i-1}
  __host__ __device__ static constexpr int place(int i) {
    int h = 1;
    for (int k = 0; k < i; ++k) h *= q[k];
    return h;
  }
  __host__ __device__ static constexpr int digit(int u, int i) {
    return (u / place(i)) % q[i];
  }
  // the first of digit i's twiddle entries; NW entries a butterfly
  __host__ __device__ static constexpr int entry(int i) {
    int o = 0;
    for (int k = 0; k < i; ++k) o += q[k] - 1;
    return o;
  }
  static constexpr int NW = ((Q - 1) + ... + 0);
  // the lowest digit of u that is not 0 (u > 0)
  __host__ __device__ static constexpr int first(int u) {
    int i = 0;
    while (digit(u, i) == 0) ++i;
    return i;
  }
};

// The forward pass twiddle of output U > 0 from a butterfly's digit
// entries w: the product of the entries of U's nonzero digits.
template <class P, int U, typename T, typename T2>
__device__ __forceinline__ void rf_pass_twiddle(const T2* w, T& wr, T& wi) {
  rf_for<P::G>([&](auto iI) {
    constexpr int i = decltype(iI)::value;
    constexpr int d = P::digit(U, i);
    if constexpr (d > 0) {
      const T2 b = w[P::entry(i) + d - 1];
      if constexpr (i == P::first(U)) {
        wr = b.x;
        wi = b.y;
      } else {
        const T r = wr * b.x - wi * b.y;
        wi = wr * b.y + wi * b.x;
        wr = r;
      }
    }
  });
}

// (vr, vi) *= W_d^k (its conjugate when sgn = +1), k and d compiled in;
// quarter turns are sign swaps.
template <typename T, int K, int D>
__device__ __forceinline__ void rf_const_twiddle(T& vr, T& vi, T sgn) {
  constexpr int k = ((K % D) + D) % D;
  if constexpr (k == 0) {
    return;
  } else if constexpr ((4 * k) % D == 0) {
    constexpr int quad = (4 * k) / D;
    const T r = vr, i = vi;
    if constexpr (quad == 2) {
      vr = -r;
      vi = -i;
    } else {
      // W = (0, -+1): forward quarter turn -i, inverse +i
      const T s = quad == 1 ? sgn : -sgn;
      vr = -s * i;
      vi = s * r;
    }
  } else {
    constexpr double c = rf_cs(k, D, false), s = rf_cs(k, D, true);
    const T wr = T(c), wi = sgn * T(s);
    const T r = vr * wr - vi * wi;
    vi = vr * wi + vi * wr;
    vr = r;
  }
}

// The R-point DFT of one butterfly in registers, in place (output u at
// register t with P::out(t) = u).
template <typename T, class P>
__device__ __forceinline__ void rf_dft(T* vr, T* vi, T sgn) {
  rf_for<P::G>([&](auto iI) {
    constexpr int i = decltype(iI)::value;
    constexpr int q = P::q[i];
    constexpr int S = P::stride(i);
    constexpr int H = P::R / (q * S);
    rf_for<H>([&](auto hI) {
      rf_for<S>([&](auto loI) {
        constexpr int base =
            decltype(hI)::value * q * S + decltype(loI)::value;
        T ar[q], ai[q];
        rf_for<q>([&](auto dI) {
          constexpr int d = decltype(dI)::value;
          ar[d] = vr[base + d * S];
          ai[d] = vi[base + d * S];
        });
        radix_butterfly<T, q>(ar, ai, sgn);
        rf_for<q>([&](auto kI) {
          constexpr int k = decltype(kI)::value;
          rf_const_twiddle<T, k * decltype(loI)::value, q * S>(ar[k], ai[k],
                                                               sgn);
          vr[base + k * S] = ar[k];
          vi[base + k * S] = ai[k];
        });
      });
    });
  });
}

template <class IO, class = void>
struct RfAfterLoad : std::false_type {};
template <class IO>
struct RfAfterLoad<IO, std::void_t<decltype(&IO::after_load)>>
    : std::true_type {};

template <typename T> struct RfVec;
template <> struct RfVec<float> { using type = float2; };
template <> struct RfVec<double> { using type = double2; };

// One pass of radix P::R after passes whose radices multiply to L; the
// pass twiddles of this pass start at pair TWOFF of ptw.
template <typename T, int N, int TPR, int L, int TWOFF, bool FIRST, bool LAST,
          class P, class IO>
__device__ __forceinline__ void rf_pass(const IO& io, int tid,
                                        const T* __restrict__ ptw, T sgn) {
  constexpr int R = P::R, MN = N / (L * R), NBF = N / R;
  constexpr int NB = (NBF + TPR - 1) / TPR;
  using T2 = typename RfVec<T>::type;
  T vr[NB][R], vi[NB][R];
  rf_for<NB>([&](auto bI) {
    constexpr int b = decltype(bI)::value;
    const int beta = tid + b * TPR;
    if (NBF % TPR == 0 || beta < NBF) {
      const int l = beta / MN, j = beta - l * MN;
      rf_for<R>([&](auto tI) {
        constexpr int t = decltype(tI)::value;
        const int e = (l * R + t) * MN + j;
        if constexpr (FIRST) {
          io.gload(e, vr[b][t], vi[b][t]);
        } else {
          vr[b][t] = io.sr[io.sidx(e)];
          vi[b][t] = io.si[io.sidx(e)];
        }
      });
    }
  });
  if constexpr (!FIRST) __syncthreads();
  if constexpr (FIRST && RfAfterLoad<IO>::value) io.after_load();
  rf_for<NB>([&](auto bI) {
    constexpr int b = decltype(bI)::value;
    const int beta = tid + b * TPR;
    if (NBF % TPR == 0 || beta < NBF) {
      const int l = beta / MN, j = beta - l * MN;
      T2 w[MN > 1 ? P::NW : 1];
      if constexpr (MN > 1) {
        const T2* tw = reinterpret_cast<const T2*>(ptw) + TWOFF + j * P::NW;
        rf_for<P::NW>([&](auto kI) {
          constexpr int k = decltype(kI)::value;
          w[k] = __ldg(tw + k);
        });
      }
      rf_dft<T, P>(vr[b], vi[b], sgn);
      rf_for<R>([&](auto tI) {
        constexpr int t = decltype(tI)::value;
        constexpr int u = P::out(t);
        T xr = vr[b][t], xi = vi[b][t];
        if constexpr (MN > 1 && u > 0) {
          // the table holds the forward twiddles; the inverse conjugates
          T wr, wi;
          rf_pass_twiddle<P, u>(w, wr, wi);
          wi = -sgn * wi;
          const T r = xr * wr - xi * wi;
          xi = xr * wi + xi * wr;
          xr = r;
        }
        const int e = (u * L + l) * MN + j;
        if constexpr (LAST && !IO::last_in_smem) {
          io.gstore(e, xr, xi);
        } else {
          io.sr[io.sidx(e)] = xr;
          io.si[io.sidx(e)] = xi;
        }
      });
    }
  });
  if constexpr (!LAST || IO::last_in_smem) __syncthreads();
}

// Every pass of the schedule P, Rest... after passes of product L.
template <typename T, int N, int TPR, int L, int TWOFF, bool FIRST, class IO,
          class P, class... Rest>
__device__ __forceinline__ void rf_chain(const IO& io, int tid,
                                         const T* __restrict__ ptw, T sgn) {
  constexpr int MN = N / (L * P::R);
  rf_pass<T, N, TPR, L, TWOFF, FIRST, sizeof...(Rest) == 0, P>(io, tid, ptw,
                                                               sgn);
  if constexpr (sizeof...(Rest) > 0)
    rf_chain<T, N, TPR, L * P::R, TWOFF + (MN > 1 ? MN * P::NW : 0), false,
             IO, Rest...>(io, tid, ptw, sgn);
}

// A schedule as a type: the passes of one length, outer to inner.
template <class... Ps>
struct RfList {};

// Every pass of a schedule, the first reading device memory.
template <typename T, int N, int TPR, class IO, class... Ps>
__device__ __forceinline__ void rf_run(const IO& io, int tid,
                                       const T* __restrict__ ptw, T sgn,
                                       RfList<Ps...>) {
  rf_chain<T, N, TPR, 1, 0, true, IO, Ps...>(io, tid, ptw, sgn);
}

// Whether the passes P... are the plan's stages `factors` grouped by
// `pass_len` (host side: the wrapper's schedule against the compiled one).
template <class... Ps>
static bool rf_matches(int nstages, const int* factors, int npass,
                       const int* pass_len) {
  if (npass != (int)sizeof...(Ps)) return false;
  int s = 0, p = 0;
  bool ok = true;
  auto one = [&](auto pass) {
    using P = decltype(pass);
    if (!ok || pass_len[p] != P::G || s + P::G > nstages) {
      ok = false;
      return;
    }
    for (int i = 0; i < P::G; ++i) ok = ok && factors[s + i] == P::q[i];
    s += P::G;
    ++p;
  };
  (one(Ps{}), ...);
  return ok && s == nstages;
}
