// ristretto255 decoding and coset equality, and the per-signature sr25519
// verify by a quad of four threads, on the edwards25519 field and curve
// code of fe25519.cuh and ge25519.cuh. Shared by the CUDA kernel
// (sr25519_verify.cu) and the host build the tests use.
//
// Semantics are those of tmtpu/tpu/kernel.py::_sr_verify_body and its plain
// twin tmtpu/tpu/sr_verify.py (draft-irtf-cfrg-ristretto255 DECODE):
// SQRT_RATIO_M1 accepts `correct | flipped` and multiplies by sqrt(-1) on
// `flipped | flipped_i`; CT_ABS negates on the parity of the canonical
// value; a decode is valid when it was square, t = x*y is even and y != 0;
// equality is x1*y2 == y1*x2 || x1*x2 == y1*y2 on canonical values, with no
// inversion and no re-encoding. The host has already cleared the schnorrkel
// marker bit from s, rejected s >= L, and rejected (and zeroed) A or R
// encodings that are >= p or odd, so bit 255 of every encoding that reaches
// here is clear.
#pragma once

#include "fe25519.cuh"
#include "ge25519.cuh"

#define RIST_FN __host__ __device__ __forceinline__

RIST_FN bool fe_is_zero(const fe& f) {
    uint8_t b[32];
    fe_tobytes(b, f);
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < 32; k++) any |= b[k];
    return any == 0;
}

RIST_FN bool fe_is_odd(const fe& f) {
    uint8_t b[32];
    fe_tobytes(b, f);
    return (b[0] & 1) != 0;
}

RIST_FN bool fe_equal(const fe& f, const fe& g) {
    uint8_t a[32], b[32];
    fe_tobytes(a, f);
    fe_tobytes(b, g);
    return fe_bytes_eq(a, b);
}

// CT_ABS: -x when the canonical value of x is odd, else x.
RIST_FN void fe_abs(fe& out, const fe& x) {
    if (fe_is_odd(x)) {
        fe_neg(out, x);
    } else {
        out = x;
    }
}

// SQRT_RATIO_M1(1, w): r = |1/sqrt(w)| when w is a non-zero square.
// Returns was_square.
TAIL_FN bool fe_invsqrt(fe& out, const fe& w) {
    fe t, w3, w7, r, check, one, minus_one, sqrtm1, minus_sqrtm1;
    fe_sq(t, w);
    fe_mul(w3, t, w);
    fe_sq(t, w3);
    fe_mul(w7, t, w);
    fe_pow22523(t, w7);
    fe_mul(r, w3, t);
    fe_sq(t, r);
    fe_mul(check, w, t);

    fe_set_small(one, 1);
    fe_neg(minus_one, one);
    fe_const_sqrtm1(sqrtm1);
    fe_neg(minus_sqrtm1, sqrtm1);
    const bool correct = fe_equal(check, one);
    const bool flipped = fe_equal(check, minus_one);
    const bool flipped_i = fe_equal(check, minus_sqrtm1);
    if (flipped || flipped_i) fe_mul(r, r, sqrtm1);
    fe_abs(out, r);
    return correct || flipped;
}

// DECODE of a 32-byte encoding (value < p and even, host-checked) into an
// extended point (x, y, 1, x*y). Returns valid; an invalid lane holds a
// finite point that the complete formulas never fault on.
TAIL_FN bool ristretto_decode(ge_p3& out, const uint8_t enc[32]) {
    fe s, one, d, ss, u1, u2, u2_sqr, v, t, invsqrt, den_x, den_y, x, y;
    fe_frombytes(s, enc);
    fe_set_small(one, 1);
    fe_const_d(d);
    fe_sq(ss, s);
    fe_sub(u1, one, ss);
    fe_add(u2, one, ss);
    fe_sq(u2_sqr, u2);
    fe_sq(t, u1);  // v = -(d u1^2) - u2^2
    fe_mul(t, d, t);
    fe_neg(t, t);
    fe_sub(v, t, u2_sqr);
    fe_mul(t, v, u2_sqr);
    const bool ok = fe_invsqrt(invsqrt, t);
    fe_mul(den_x, invsqrt, u2);
    fe_mul(den_y, invsqrt, den_x);
    fe_mul(den_y, den_y, v);
    fe_add(t, s, s);
    fe_mul(t, t, den_x);
    fe_abs(x, t);
    fe_mul(y, u1, den_y);
    out.X = x;
    out.Y = y;
    out.Z = one;
    fe_mul(out.T, x, y);
    return ok && !fe_is_odd(out.T) && !fe_is_zero(y);
}

// Coset equality of two points given by X and Y (any common Z each):
// x1 y2 == y1 x2 or x1 x2 == y1 y2.
RIST_FN bool ristretto_equal(const fe& x1, const fe& y1, const fe& x2, const fe& y2) {
    fe a, b, t;
    fe_mul(a, x1, y2);
    fe_mul(t, y1, x2);
    fe_sub(a, a, t);
    fe_mul(b, x1, x2);
    fe_mul(t, y1, y2);
    fe_sub(b, b, t);
    return fe_is_zero(a) || fe_is_zero(b);
}

// The whole per-signature sr25519 verify of
// tmtpu/tpu/kernel.py::_sr_verify_body, by one quad: roles 0 and 1 decode
// A while roles 2 and 3 decode R, at once; one exchange gives roles 2 and 3
// A's Z and T, and every role keeps its coordinate of -A; the ladder
// [s]B + [k](-A) shared with ed25519; then every role compares the result
// with R by coset equality. lane is the signature's 128 bytes (pk | r | s
// with the marker cleared | k), s and k below L; btab is the niels table of
// d*B for d in 0..15. Returns 1 when the signature verifies.
QUAD_FN int sr25519_verify_quad(const quad& q, const uint8_t lane[128],
                                const ge_niels* btab, quad_table& tab) {
    qv<fe> own, other, a, p, x1, y1, x2, y2;
    qv<int> ok, a_ok, r_ok, v;
    QUAD_EACH(q, j) {
        ge_p3 pt;
        ok[j] = ristretto_decode(pt, j < 2 ? lane : lane + 32) ? 1 : 0;
        ge_coord(own[j], pt, j);
        ge_coord(other[j], pt, j ^ 2);  // A's Z, T on roles 0, 1; R's X, Y on 2, 3
    }
    quad_xchg(q, a, other, 0, 1, 0, 1);
    QUAD_EACH(q, j) {
        if (j < 2) a[j] = own[j];
        if (j == 0 || j == 3) fe_neg(a[j], a[j]);
    }
    ge4_double_scalar(q, p, lane + 64, lane + 96, a, btab, tab);

    quad_xchg(q, a_ok, ok, 0, 0, 0, 0);
    quad_xchg(q, r_ok, ok, 2, 2, 2, 2);
    quad_xchg(q, x1, p, 0, 0, 0, 0);
    quad_xchg(q, y1, p, 1, 1, 1, 1);
    quad_xchg(q, x2, other, 2, 2, 2, 2);
    quad_xchg(q, y2, other, 3, 3, 3, 3);
    QUAD_EACH(q, j) {
        v[j] = (a_ok[j] && r_ok[j] && ristretto_equal(x1[j], y1[j], x2[j], y2[j])) ? 1 : 0;
    }
    return quad_result(v);
}
