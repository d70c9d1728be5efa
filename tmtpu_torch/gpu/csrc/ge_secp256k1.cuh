// secp256k1 point arithmetic and the per-signature ECDSA verify, shared by
// the CUDA kernel (k1_verify.cu) and the host build the tests use.
//
// Points are projective (X, Y, Z), x = X/Z, y = Y/Z, the identity (0, 1, 0),
// with the complete formulas of Renes, Costello and Batina 2016 for a = 0
// (algorithm 7 to add, algorithm 9 to double, b3 = 3 * 7 = 21), as in
// tmtpu/tpu/k1_verify.py: one formula for every pair of inputs, so the
// identity, doublings and inverses need no branch.
//
// A signature is verified by a quad of four threads (quad.cuh). The three
// coordinates do not split four ways as the Edwards ones do, so every role
// holds the whole point (k1q: X, Y, Z each a qv<fe8>) and the products of
// each level of a formula are shared out over the roles, one a role a
// round, and broadcast over the quad: a doubling is two rounds (two
// products a role, six broadcasts), an addition four (two rounds of its six
// level-1 products, two rounds of its six level-2 products, summed in pairs
// by roles 0-2; nine broadcasts), in place of 6M + 2S and 12M on one
// thread. An operand from a table is read from shared memory by every role.
#pragma once

#include "fe_secp256k1.cuh"
#include "quad.cuh"

struct k1_point {
    fe8 X, Y, Z;
};

// A point as the four roles of a quad hold it: each role the whole point.
struct k1q {
    qv<fe8> X, Y, Z;
};

#define K1_B3 21u
// Field elements in the per-lane table of d*Q, d = 1..15.
#define K1_TAB_ELEMS (15 * 3)

// SEC 1 decompression of x (host-checked < p) with the prefix's parity:
// y = (x^3 + 7)^((p+1)/4), valid when it squares back, negated when its
// canonical parity differs. As tmtpu/tpu/k1_verify.py::decompress.
TAIL_FN bool k1_decompress(k1_point& q, const fe8& x, uint32_t parity) {
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

// The identity (0, 1, 0) on every role.
QUAD_FN void k1q_identity(const quad& q, k1q& p) {
    QUAD_EACH(q, j) {
        fe8_set_small(p.X[j], 0);
        fe8_set_small(p.Y[j], 1);
        fe8_set_small(p.Z[j], 0);
    }
}

// 2p (RCB16 algorithm 9, a = 0). Round 1: roles 0-3 form Y^2, YZ, Z^2, XY;
// Y^2 and Z^2 go to every role. Round 2: 21Z^2 * 8Y^2, YZ * 8Y^2,
// (Y^2 - 63Z^2)(Y^2 + 21Z^2) and (Y^2 - 63Z^2) * XY; then X3 = 2 (role 3),
// Y3 = (role 0) + (role 2), Z3 = (role 1) on every role.
QUAD_FN void k1q_double(const quad& q, k1q& p) {
    qv<fe8> s, y2, z2, r, a, b;
    QUAD_EACH(q, j) {
        fe8 u, v;
        fe8_select4(u, j, p.Y[j], p.Y[j], p.Z[j], p.X[j]);
        fe8_select4(v, j, p.Y[j], p.Z[j], p.Z[j], p.Y[j]);
        fe8_mul(s[j], u, v);
    }
    quad_xchg(q, y2, s, 0, 0, 0, 0);
    quad_xchg(q, z2, s, 2, 2, 2, 2);
    QUAD_EACH(q, j) {
        const int b3 = (int)K1_B3;
        fe8 y8, bz, f, g, u, v;
        fe8_mul_small(y8, y2[j], 8);
        fe8_mul_small(bz, z2[j], K1_B3);
        fe8_lin(f, 1, y2[j], -3 * b3, z2[j], 0, z2[j]);
        fe8_lin(g, 1, y2[j], b3, z2[j], 0, z2[j]);
        fe8_select4(u, j, bz, s[j], f, f);
        fe8_select4(v, j, y8, y8, g, s[j]);
        fe8_mul(r[j], u, v);
    }
    quad_xchg(q, a, r, 0, 0, 0, 0);
    quad_xchg(q, b, r, 2, 2, 2, 2);
    QUAD_EACH(q, j) fe8_add(p.Y[j], a[j], b[j]);
    quad_xchg(q, a, r, 3, 3, 3, 3);
    QUAD_EACH(q, j) fe8_add(p.X[j], a[j], a[j]);
    quad_xchg(q, p.Z, r, 1, 1, 1, 1);
}

// p + o (RCB16 algorithm 7, a = 0). Level 1, two rounds at once: roles 0-2
// form X1X2, Y1Y2 and Z1Z2 (role 3 Y1Y2 again, unread), and roles 0-2 the
// three products of sums (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
// (role 3 the first again); all six go to every role. Level 2, two
// rounds: role 0 forms X3 = t3 t1 - t4 y3, role 1 Y3 = y3 t0 + t1 z3, role
// 2 Z3 = z3 t4 + t0 t3 (role 3 a copy of role 0's work), and each goes to
// every role.
QUAD_FN void k1q_add(const quad& q, k1q& p, const k1q& o) {
    qv<fe8> s, m, t0, t1, t2, m3, m4, m5, r;
    QUAD_EACH(q, j) {
        fe8 u, v, w;
        fe8_select4(u, j, p.X[j], p.Y[j], p.Z[j], p.Y[j]);
        fe8_select4(v, j, o.X[j], o.Y[j], o.Z[j], o.Y[j]);
        fe8_mul(s[j], u, v);
        fe8_select4(u, j, p.X[j], p.Y[j], p.X[j], p.X[j]);
        fe8_select4(w, j, p.Y[j], p.Z[j], p.Z[j], p.Y[j]);
        fe8_add(u, u, w);
        fe8_select4(v, j, o.X[j], o.Y[j], o.X[j], o.X[j]);
        fe8_select4(w, j, o.Y[j], o.Z[j], o.Z[j], o.Y[j]);
        fe8_add(v, v, w);
        fe8_mul(m[j], u, v);
    }
    quad_xchg(q, t0, s, 0, 0, 0, 0);
    quad_xchg(q, t1, s, 1, 1, 1, 1);
    quad_xchg(q, t2, s, 2, 2, 2, 2);
    quad_xchg(q, m3, m, 0, 0, 0, 0);
    quad_xchg(q, m4, m, 1, 1, 1, 1);
    quad_xchg(q, m5, m, 2, 2, 2, 2);
    QUAD_EACH(q, j) {
        // t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, y3 = b3 (m5 - t0 - t2),
        // 3 t0, z3 = t1 + b3 t2, t1 - b3 t2, and -y3 for role 0's X3
        const int b3 = (int)K1_B3;
        fe8 t3, t4, y3, ny3, x0, z3, w, u, v;
        fe8_lin(t3, 1, m3[j], -1, t0[j], -1, t1[j]);
        fe8_lin(t4, 1, m4[j], -1, t1[j], -1, t2[j]);
        fe8_lin(y3, b3, m5[j], -b3, t0[j], -b3, t2[j]);
        fe8_lin(ny3, -b3, m5[j], b3, t0[j], b3, t2[j]);
        fe8_mul_small(x0, t0[j], 3);
        fe8_lin(z3, 1, t1[j], b3, t2[j], 0, t2[j]);
        fe8_lin(w, 1, t1[j], -b3, t2[j], 0, t2[j]);
        fe8_select4(u, j, t3, y3, z3, t3);
        fe8_select4(v, j, w, x0, t4, w);
        fe8_mul(r[j], u, v);
        fe8_select4(u, j, t4, w, x0, t4);
        fe8_select4(v, j, ny3, z3, t3, ny3);
        fe8_mul(w, u, v);
        fe8_add(r[j], r[j], w);
    }
    quad_xchg(q, p.X, r, 0, 0, 0, 0);
    quad_xchg(q, p.Y, r, 1, 1, 1, 1);
    quad_xchg(q, p.Z, r, 2, 2, 2, 2);
}

// Entry d of the per-lane table (d = 1..15): X, Y, Z of d*Q as elements
// 3(d-1) .. 3(d-1)+2.
QUAD_FN void k1q_table_put(quad_tab<fe8>& tab, int d, const k1q& p) {
    quad_table_put(tab, 3 * (d - 1), p.X);
    quad_table_put(tab, 3 * (d - 1) + 1, p.Y);
    quad_table_put(tab, 3 * (d - 1) + 2, p.Z);
}

QUAD_FN void k1q_table_get(const quad_tab<fe8>& tab, int d, k1q& p) {
    quad_table_get(tab, 3 * (d - 1), p.X);
    quad_table_get(tab, 3 * (d - 1) + 1, p.Y);
    quad_table_get(tab, 3 * (d - 1) + 2, p.Z);
}

// [u1]G + [u2]Q by the 64-window 4-bit Straus/Shamir ladder of
// tmtpu/tpu/k1_kernel.py::_k1_verify_body: the table of d*Q by 14 complete
// additions into tab, then per window four doublings and the additions of
// gtab[digit of u1] and of the table entry of the digit of u2. A zero digit
// adds nothing (adding the identity leaves the group element, and so every
// verdict, as it is); the four roles read the same digit, so the branch is
// uniform within the quad.
QUAD_FN void k1q_double_scalar(const quad& q, k1q& p, const uint8_t u1[32],
                               const uint8_t u2[32], const k1q& Q, const k1_point* gtab,
                               quad_tab<fe8>& tab) {
    k1q acc = Q, o;
    k1q_table_put(tab, 1, Q);
#pragma unroll 1
    for (int d = 2; d < 16; d++) {
        k1q_add(q, acc, Q);
        k1q_table_put(tab, d, acc);
    }

    k1q_identity(q, p);
#pragma unroll 1
    for (int w = 0; w < 64; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) k1q_double(q, p);
        const int d1 = k1_digit_msb(u1, w);
        if (d1 != 0) {
            QUAD_EACH(q, j) {
                o.X[j] = gtab[d1].X;
                o.Y[j] = gtab[d1].Y;
                o.Z[j] = gtab[d1].Z;
            }
            k1q_add(q, p, o);
        }
        const int d2 = k1_digit_msb(u2, w);
        if (d2 != 0) {
            k1q_table_get(tab, d2, o);
            k1q_add(q, p, o);
        }
    }
}

// Accept when R = (X, Y, Z) is finite and X == r Z or X == rpn Z (r, rpn
// 32-byte big-endian, both below p by the host's checks).
TAIL_FN bool k1_accept(const fe8& X, const fe8& Z, const uint8_t r[32],
                       const uint8_t rpn[32]) {
    const bool finite = !fe8_is_zero(Z);
    fe8 c, t;
    fe8_from_be(c, r);
    fe8_mul(t, c, Z);
    const bool m1 = fe8_equal(X, t);
    fe8_from_be(c, rpn);
    fe8_mul(t, c, Z);
    const bool m2 = fe8_equal(X, t);
    return finite && (m1 || m2);
}

// The whole per-signature verify of tmtpu/tpu/k1_kernel.py::_k1_verify_body,
// by one quad: every role decompresses Q (the same chain, so no exchange),
// the ladder [u1]G + [u2]Q, then every role runs the final compare on its
// copy of the result. lane is the signature's 168 plane bytes (pkx | u1 |
// u2 | r | rpn big-endian, the parity at byte 160); gtab is the projective
// table of d*G for d in 0..15. Returns 1 when the signature verifies.
QUAD_FN int k1_verify_quad(const quad& q, const uint8_t lane[168], const k1_point* gtab,
                           quad_tab<fe8>& tab) {
    k1q Q, p;
    qv<int> q_ok, v;
    QUAD_EACH(q, j) {
        fe8 x;
        fe8_from_be(x, lane);
        k1_point pt;
        q_ok[j] = k1_decompress(pt, x, lane[160]) ? 1 : 0;
        Q.X[j] = pt.X;
        Q.Y[j] = pt.Y;
        Q.Z[j] = pt.Z;
    }
    k1q_double_scalar(q, p, lane + 32, lane + 64, Q, gtab, tab);
    QUAD_EACH(q, j) {
        v[j] = (q_ok[j] && k1_accept(p.X[j], p.Z[j], lane + 96, lane + 128)) ? 1 : 0;
    }
    return quad_result(v);
}
