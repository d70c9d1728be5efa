// secp256k1 point arithmetic and the per-lane ECDSA verify, shared by the
// CUDA kernel (k1_verify.cu) and the host build the tests use.
//
// Points are projective (X, Y, Z), x = X/Z, y = Y/Z, the identity (0, 1, 0),
// with the complete formulas of Renes, Costello and Batina 2016 for a = 0
// (algorithm 7 to add, algorithm 9 to double, b3 = 3 * 7 = 21), as in
// tmtpu/tpu/k1_verify.py: one formula for every pair of inputs, so the
// identity, doublings and inverses need no branch.
#pragma once

#include "fe_secp256k1.cuh"

struct k1_point {
    fe8 X, Y, Z;
};

#define K1_B3 21u

K1_FN void k1_identity(k1_point& p) {
    fe8_set_small(p.X, 0);
    fe8_set_small(p.Y, 1);
    fe8_set_small(p.Z, 0);
}

// p + q, valid for all inputs (RCB16 algorithm 7, a = 0): 12 multiplies.
// r may alias p or q.
K1_FN void k1_add(k1_point& r, const k1_point& p, const k1_point& q) {
    fe8 t0, t1, t2, t3, t4, x3, y3, z3, u, v;
    fe8_mul(t0, p.X, q.X);
    fe8_mul(t1, p.Y, q.Y);
    fe8_mul(t2, p.Z, q.Z);
    fe8_add(u, p.X, p.Y);
    fe8_add(v, q.X, q.Y);
    fe8_mul(t3, u, v);
    fe8_add(u, t0, t1);
    fe8_sub(t3, t3, u);
    fe8_add(u, p.Y, p.Z);
    fe8_add(v, q.Y, q.Z);
    fe8_mul(t4, u, v);
    fe8_add(u, t1, t2);
    fe8_sub(t4, t4, u);
    fe8_add(u, p.X, p.Z);
    fe8_add(v, q.X, q.Z);
    fe8_mul(y3, u, v);
    fe8_add(u, t0, t2);
    fe8_sub(y3, y3, u);
    fe8_mul_small(t0, t0, 3);
    fe8_mul_small(t2, t2, K1_B3);
    fe8_add(z3, t1, t2);
    fe8_sub(t1, t1, t2);
    fe8_mul_small(y3, y3, K1_B3);
    fe8_mul(u, t3, t1);
    fe8_mul(v, t4, y3);
    fe8_sub(x3, u, v);
    fe8_mul(u, y3, t0);
    fe8_mul(v, t1, z3);
    fe8_add(y3, u, v);
    fe8_mul(u, z3, t4);
    fe8_mul(v, t0, t3);
    fe8_add(z3, u, v);
    r.X = x3;
    r.Y = y3;
    r.Z = z3;
}

// 2p, valid for all inputs (RCB16 algorithm 9, a = 0): 6 multiplies and
// 2 squarings. r may alias p.
K1_FN void k1_double(k1_point& r, const k1_point& p) {
    fe8 t0, t1, t2, x3, y3, z3, u;
    fe8_sq(t0, p.Y);
    fe8_add(z3, t0, t0);
    fe8_add(z3, z3, z3);
    fe8_add(z3, z3, z3);  // 8 Y^2
    fe8_mul(t1, p.Y, p.Z);
    fe8_sq(u, p.Z);
    fe8_mul_small(t2, u, K1_B3);  // b3 Z^2
    fe8_mul(x3, t2, z3);
    fe8_add(y3, t0, t2);
    fe8_mul(z3, t1, z3);
    fe8_add(t1, t2, t2);
    fe8_add(t2, t1, t2);
    fe8_sub(t0, t0, t2);
    fe8_mul(u, t0, y3);
    fe8_add(y3, x3, u);
    fe8_mul(t1, p.X, p.Y);
    fe8_mul(x3, t0, t1);
    fe8_add(x3, x3, x3);
    r.X = x3;
    r.Y = y3;
    r.Z = z3;
}

// SEC 1 decompression of x (host-checked < p) with the prefix's parity:
// y = (x^3 + 7)^((p+1)/4), valid when it squares back, negated when its
// canonical parity differs. As tmtpu/tpu/k1_verify.py::decompress.
K1_FN bool k1_decompress(k1_point& q, const fe8& x, uint32_t parity) {
    fe8 y2, y, t, seven;
    fe8_sq(t, x);
    fe8_mul(t, t, x);
    fe8_set_small(seven, 7);
    fe8_add(y2, t, seven);
    fe8_sqrt_candidate(y, y2);
    fe8_freeze(y, y);
    fe8_sq(t, y);
    const bool valid = fe8_equal(t, y2);
    if ((y.v[0] & 1u) != parity) fe8_neg(y, y);
    q.X = x;
    q.Y = y;
    fe8_set_small(q.Z, 1);
    return valid;
}

// 4-bit window w (0 = most significant) of a 32-byte big-endian scalar.
K1_FN int k1_digit_msb(const uint8_t s[32], int w) {
    const uint8_t b = s[w >> 1];
    return (w & 1) ? (b & 15) : (b >> 4);
}

// The whole per-lane verify of tmtpu/tpu/k1_kernel.py::_k1_verify_body:
// decompress Q, build the table of d*Q (d = 0..15, thread-local memory) by
// 14 complete additions, run the 64-window Straus/Shamir ladder
// [u1]G + [u2]Q (gtab: the projective table of d*G), and accept when the
// key decoded, the result is finite and X == r Z or X == rpn Z. All
// scalars and r, rpn are 32-byte big-endian. Returns 1 when the signature
// verifies.
K1_FN int k1_verify_lane(const uint8_t pkx[32], uint32_t parity,
                         const uint8_t u1[32], const uint8_t u2[32],
                         const uint8_t r[32], const uint8_t rpn[32],
                         const k1_point* gtab) {
    fe8 x;
    fe8_from_be(x, pkx);
    k1_point q;
    const bool q_ok = k1_decompress(q, x, parity);

    k1_point tab[16];
    k1_identity(tab[0]);
    tab[1] = q;
#pragma unroll 1
    for (int d = 2; d < 16; d++) k1_add(tab[d], tab[d - 1], q);

    k1_point p;
    k1_identity(p);
#pragma unroll 1
    for (int w = 0; w < 64; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) k1_double(p, p);
        k1_add(p, p, gtab[k1_digit_msb(u1, w)]);
        k1_add(p, p, tab[k1_digit_msb(u2, w)]);
    }

    const bool finite = !fe8_is_zero(p.Z);
    fe8 c, t;
    fe8_from_be(c, r);
    fe8_mul(t, c, p.Z);
    const bool m1 = fe8_equal(p.X, t);
    fe8_from_be(c, rpn);
    fe8_mul(t, c, p.Z);
    const bool m2 = fe8_equal(p.X, t);
    return (q_ok && finite && (m1 || m2)) ? 1 : 0;
}
