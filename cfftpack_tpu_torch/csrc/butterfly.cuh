// Closed-form p-point DFT butterflies (p = 2, 3, 4, 5) shared by the
// port's kernels.  Same closed forms and constants as
// cfftpack_tpu/ops/core.py:_butterfly; sgn is -1 for the forward and +1
// for the inverse transform.
#pragma once

// p-point DFT in place over R, I.
template <typename T, int P>
__device__ __forceinline__ void radix_butterfly(T* R, T* I, T sgn) {
  if constexpr (P == 2) {
    const T r0 = R[0], i0 = I[0];
    R[0] = r0 + R[1];
    I[0] = i0 + I[1];
    R[1] = r0 - R[1];
    I[1] = i0 - I[1];
  } else if constexpr (P == 3) {
    const T sq = T(0.8660254037844386);
    const T tr = R[1] + R[2], ti = I[1] + I[2];
    const T dr = R[1] - R[2], di = I[1] - I[2];
    const T m1r = R[0] - T(0.5) * tr;
    const T m1i = I[0] - T(0.5) * ti;
    const T m2r = -(sgn * sq) * di;
    const T m2i = (sgn * sq) * dr;
    R[0] = R[0] + tr;
    I[0] = I[0] + ti;
    R[1] = m1r + m2r;
    I[1] = m1i + m2i;
    R[2] = m1r - m2r;
    I[2] = m1i - m2i;
  } else if constexpr (P == 4) {
    const T ar = R[0] + R[2], ai = I[0] + I[2];
    const T br = R[0] - R[2], bi = I[0] - I[2];
    const T cr = R[1] + R[3], ci = I[1] + I[3];
    const T dr = -sgn * (I[1] - I[3]);
    const T di = sgn * (R[1] - R[3]);
    R[0] = ar + cr;
    I[0] = ai + ci;
    R[1] = br + dr;
    I[1] = bi + di;
    R[2] = ar - cr;
    I[2] = ai - ci;
    R[3] = br - dr;
    I[3] = bi - di;
  } else if constexpr (P == 5) {
    const T c1 = T(0.30901699437494745), s1 = T(0.9510565162951535);
    const T c2 = T(-0.8090169943749473), s2 = T(0.5877852522924732);
    const T t1r = R[1] + R[4], t1i = I[1] + I[4];
    const T t2r = R[2] + R[3], t2i = I[2] + I[3];
    const T t3r = R[1] - R[4], t3i = I[1] - I[4];
    const T t4r = R[2] - R[3], t4i = I[2] - I[3];
    const T u0r = R[0] + t1r + t2r, u0i = I[0] + t1i + t2i;
    const T a1r = R[0] + c1 * t1r + c2 * t2r;
    const T a1i = I[0] + c1 * t1i + c2 * t2i;
    const T a2r = R[0] + c2 * t1r + c1 * t2r;
    const T a2i = I[0] + c2 * t1i + c1 * t2i;
    const T b1r = -sgn * (s1 * t3i + s2 * t4i);
    const T b1i = sgn * (s1 * t3r + s2 * t4r);
    const T b2r = -sgn * (s2 * t3i - s1 * t4i);
    const T b2i = sgn * (s2 * t3r - s1 * t4r);
    R[0] = u0r;
    I[0] = u0i;
    R[1] = a1r + b1r;
    I[1] = a1i + b1i;
    R[2] = a2r + b2r;
    I[2] = a2i + b2i;
    R[3] = a2r - b2r;
    I[3] = a2i - b2i;
    R[4] = a1r - b1r;
    I[4] = a1i - b1i;
  }
}
