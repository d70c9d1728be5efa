// ristretto255 decoding and coset equality, and the per-lane sr25519
// verify, on the edwards25519 field and curve code of fe25519.cuh and
// ge25519.cuh. Shared by the CUDA kernel (sr25519_verify.cu) and the host
// build the tests use.
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
RIST_FN bool fe_invsqrt(fe& out, const fe& w) {
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
RIST_FN bool ristretto_decode(ge_p3& out, const uint8_t enc[32]) {
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

// Coset equality of two extended points (any Z): x1 y2 == y1 x2 or
// x1 x2 == y1 y2.
RIST_FN bool ristretto_equal(const ge_p3& p, const ge_p3& q) {
    fe a, b, t;
    fe_mul(a, p.X, q.Y);
    fe_mul(t, p.Y, q.X);
    fe_sub(a, a, t);
    fe_mul(b, p.X, q.X);
    fe_mul(t, p.Y, q.Y);
    fe_sub(b, b, t);
    return fe_is_zero(a) || fe_is_zero(b);
}

// The whole per-lane sr25519 verify of tmtpu/tpu/kernel.py::_sr_verify_body:
// decode A and R, run the ladder [s]B + [k](-A) shared with ed25519, and
// compare the result with R by coset equality. s (marker cleared) and k
// are 32-byte little-endian scalars below L; btab is the niels table of
// d*B for d in 0..15. Returns 1 when the signature verifies.
RIST_FN int sr25519_verify_lane(const uint8_t pk[32], const uint8_t r[32],
                                const uint8_t s[32], const uint8_t k[32],
                                const ge_niels* btab) {
    ge_p3 a, rp, res;
    const bool a_ok = ristretto_decode(a, pk);
    const bool r_ok = ristretto_decode(rp, r);
    ge_negate(a, a);
    ge_double_scalar(res, s, k, a, btab);
    return (a_ok && r_ok && ristretto_equal(res, rp)) ? 1 : 0;
}
