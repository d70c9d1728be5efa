// edwards25519 point arithmetic and the per-signature ed25519 verify,
// shared by the CUDA kernel (ed25519_verify.cu) and the host build the
// tests use.
//
// Points are extended coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, T = XY/Z,
// with the formulas of tmtpu/tpu/curve.py: dbl-2008-hwcd doubling and the
// unified add-2008-hwcd-3 addition against a cached (Y-X, Y+X, 2Z, 2dT)
// operand, or a niels one (Y-X, Y+X, 2dT; Z = 1). Both are complete on
// ed25519, so identity, low-order and mixed-order inputs need no branch.
//
// A signature is verified by a quad of four threads (quad.cuh), role j
// holding coordinate j of every point, in the four-way split of Hisil,
// Wong, Carter and Dawson, "Twisted Edwards Curves Revisited" (ASIACRYPT
// 2008), section 4 (the split of curve25519-dalek's AVX2 backend). Both
// formulas end in the same step: with (E, H, F, G) spread over the roles,
// (X3, Y3, Z3, T3) = (E F, G H, F G, E H) is one multiply a role. A doubling
// is then one squaring and one multiply a role, an addition two multiplies
// a role, in place of 4S + 4M and 7-8M on one thread.
#pragma once

#include "fe25519.cuh"
#include "quad.cuh"

struct ge_p3 {
    fe X, Y, Z, T;
};

// Layout matches the [16, 3, 10] int32 fixed-base table built on the host
// (tmtpu_torch/gpu/kernel.py::base_table_limbs).
struct ge_niels {
    fe YmX, YpX, T2d;
};

#define GE_FN __host__ __device__ __forceinline__

// d, 2d and sqrt(-1) as carried radix-2^25.5 limbs.
GE_FN void fe_const_d(fe& h) {
    const int32_t v[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                           24766616, 60832955, 30306712, 48412415, 21499315};
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = v[i];
}

GE_FN void fe_const_d2(fe& h) {
    const int32_t v[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                           15978800, 54557047, 27058993, 29715967, 9444199};
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = v[i];
}

GE_FN void fe_const_sqrtm1(fe& h) {
    const int32_t v[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                           33281959, 41962654, 31548777, 326685, 11406482};
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = v[i];
}

// Point decompression with the exact semantics of
// tmtpu/tpu/verify.py::decompress (which mirrors ed25519_ref._recover_x):
// x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1; accept when
// v x^2 = u, or = -u after x *= sqrt(-1); reject x = 0 with the sign bit
// set. The y limbs may hold a value >= p: the host masks such lanes.
TAIL_FN bool ge_decompress(ge_p3& out, const fe& y, int sign) {
    fe one, d, y2, u, v, v3, v7, t, x, vxx;
    fe_set_small(one, 1);
    fe_const_d(d);
    fe_sq(y2, y);
    fe_sub(u, y2, one);
    fe_mul(v, d, y2);
    fe_add(v, v, one);
    fe_sq(t, v);
    fe_mul(v3, t, v);
    fe_sq(t, v3);
    fe_mul(v7, t, v);
    fe_mul(t, u, v7);
    fe_pow22523(t, t);
    fe_mul(x, u, v3);
    fe_mul(x, x, t);
    fe_sq(t, x);
    fe_mul(vxx, v, t);

    uint8_t vxx_b[32], u_b[32], nu_b[32], x_b[32];
    fe_tobytes(vxx_b, vxx);
    fe_tobytes(u_b, u);
    fe_neg(t, u);
    fe_tobytes(nu_b, t);
    const bool ok_direct = fe_bytes_eq(vxx_b, u_b);
    const bool ok_twist = fe_bytes_eq(vxx_b, nu_b);
    if (ok_twist) {
        fe sqrtm1;
        fe_const_sqrtm1(sqrtm1);
        fe_mul(x, x, sqrtm1);
    }
    bool valid = ok_direct || ok_twist;
    fe_tobytes(x_b, x);
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < 32; k++) any |= x_b[k];
    if (any == 0 && sign == 1) valid = false;
    if ((int)(x_b[0] & 1) != sign) fe_neg(x, x);
    out.X = x;
    out.Y = y;
    fe_set_small(out.Z, 1);
    fe_mul(out.T, x, y);
    return valid;
}

// 4-bit window w (0 = most significant) of a 32-byte little-endian scalar.
GE_FN int scalar_digit_msb(const uint8_t s[32], int w) {
    const int j = 63 - w;
    return (s[j >> 1] >> ((j & 1) * 4)) & 15;
}

// Coordinate j of the point (X, Y, Z, T).
GE_FN void ge_coord(fe& out, const ge_p3& p, int j) {
    fe_select4(out, j, p.X, p.Y, p.Z, p.T);
}

// ---------------------------------------------------------------------------
// The four-way formulas. qv<fe> p holds a point, role j its coordinate j.

// (E, H, F, G) -> (E F, G H, F G, E H).
QUAD_FN void ge4_finish(const quad& q, qv<fe>& p, const qv<fe>& e) {
    qv<fe> a, b;
    quad_xchg(q, a, e, 0, 3, 2, 0);
    quad_xchg(q, b, e, 2, 1, 3, 1);
    QUAD_EACH(q, j) fe_mul(p[j], a[j], b[j]);
}

// dbl-2008-hwcd: roles square X, Y, Z and X + Y (A, B, Z^2, S), then form
// E = A + B - S, H = A + B, F = 2Z^2 + A - B, G = A - B (the negated
// E, F, G, H of the paper, whose products are the same).
QUAD_FN void ge4_double(const quad& q, qv<fe>& p) {
    qv<fe> x, y, s, a, b, e;
    quad_xchg(q, x, p, 0, 0, 0, 0);
    quad_xchg(q, y, p, 1, 1, 1, 1);
    QUAD_EACH(q, j) {
        fe t;
        const int own = j == 3 ? 0 : 1, sum = j == 3 ? 1 : 0;
        fe_lin3(t, own, p[j], sum, x[j], sum, y[j]);
        fe_sq(s[j], t);
    }
    quad_xchg(q, a, s, 1, 0, 0, 0);
    quad_xchg(q, b, s, 3, 1, 1, 1);
    QUAD_EACH(q, j) {
        fe_lin3(e[j], quad_pick(j, 1, 1, 2, 0), s[j], 1, a[j],
                quad_pick(j, -1, 0, -1, -1), b[j]);
    }
    ge4_finish(q, p, e);
}

// p + c, c a cached operand (Y2-X2, Y2+X2, 2Z2, 2dT2) spread over the roles:
// (Y-X, Y+X, Z, T) times c gives (A, B, D, C), then E = B - A, H = B + A,
// F = D - C, G = D + C. A niels operand enters with 2 in place of 2Z2.
QUAD_FN void ge4_add(const quad& q, qv<fe>& p, const qv<fe>& c) {
    qv<fe> v, w, e;
    quad_xchg(q, v, p, 1, 0, 3, 2);
    QUAD_EACH(q, j) {
        fe u;
        fe_lin2(u, quad_pick(j, -1, 1, 1, 1), p[j], quad_pick(j, 1, 1, 0, 0), v[j]);
        fe_mul(w[j], u, c[j]);
    }
    quad_xchg(q, v, w, 1, 0, 3, 2);
    QUAD_EACH(q, j) {
        fe_lin2(e[j], quad_pick(j, -1, 1, 1, 1), w[j], quad_pick(j, 1, 1, -1, 1), v[j]);
    }
    ge4_finish(q, p, e);
}

// Cached form (Y-X, Y+X, 2Z, 2dT) of p.
QUAD_FN void ge4_to_cached(const quad& q, qv<fe>& c, const qv<fe>& p) {
    qv<fe> v;
    quad_xchg(q, v, p, 1, 0, 3, 2);
    QUAD_EACH(q, j) {
        fe_lin2(c[j], quad_pick(j, -1, 1, 2, 1), p[j], quad_pick(j, 1, 1, 0, 0), v[j]);
        if (j == 3) {
            fe d2;
            fe_const_d2(d2);
            fe_mul(c[j], c[j], d2);
        }
    }
}

// Niels entry n as an addition operand: (Y-X, Y+X, 2, 2dT).
QUAD_FN void ge4_niels(const quad& q, qv<fe>& c, const ge_niels& n) {
    QUAD_EACH(q, j) {
        if (j == 2) {
            fe_set_small(c[j], 2);
        } else {
            c[j] = j == 0 ? n.YmX : j == 1 ? n.YpX : n.T2d;
        }
    }
}

// [s]B + [h]A by the 64-window 4-bit Straus/Shamir ladder of
// tmtpu/tpu/kernel.py::_shamir_ladder (the doublings shared by both
// scalars): build the cached table of d*A, d = 1..15, in tab (entry d-1),
// then per window double four times and add btab[digit of s] and the table
// entry of the digit of h. A zero digit adds nothing (adding the identity
// leaves the group element, and so every verdict, as it is); the four roles
// read the same digit, so the branch is uniform within the quad. s and h
// are 32-byte little-endian scalars; btab is the niels table of d*B for d
// in 0..15. Shared by the ed25519 and sr25519 verifies.
QUAD_FN void ge4_double_scalar(const quad& q, qv<fe>& p, const uint8_t s[32],
                               const uint8_t h[32], const qv<fe>& a,
                               const ge_niels* btab, quad_table& tab) {
    qv<fe> c1, c, acc = a;
    ge4_to_cached(q, c1, a);
    quad_table_put(tab, 0, c1);
#pragma unroll 1
    for (int d = 2; d < 16; d++) {
        ge4_add(q, acc, c1);
        ge4_to_cached(q, c, acc);
        quad_table_put(tab, d - 1, c);
    }

    QUAD_EACH(q, j) fe_set_small(p[j], (j == 1 || j == 2) ? 1 : 0);
#pragma unroll 1
    for (int w = 0; w < 64; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) ge4_double(q, p);
        const int ds = scalar_digit_msb(s, w);
        if (ds != 0) {
            ge4_niels(q, c, btab[ds]);
            ge4_add(q, p, c);
        }
        const int dh = scalar_digit_msb(h, w);
        if (dh != 0) {
            quad_table_get(tab, dh - 1, c);
            ge4_add(q, p, c);
        }
    }
}

// The whole per-signature verify of tmtpu/tpu/kernel.py::_verify_body, by
// one quad: every role decompresses A (the same chain, so no exchange) and
// keeps its coordinate of -A; the ladder [s]B + [h](-A); then every role
// inverts Z and byte-compares the encoding of the result with R. lane is
// the signature's 128 bytes (pk | r | s | h); btab is the niels table of
// d*B for d in 0..15. Returns 1 when the signature verifies.
QUAD_FN int ed25519_verify_quad(const quad& q, const uint8_t lane[128],
                                const ge_niels* btab, quad_table& tab) {
    const uint8_t* pk = lane;
    const uint8_t* r = lane + 32;
    qv<fe> a, p, X, Y, Z;
    qv<int> a_ok, v;
    QUAD_EACH(q, j) {
        fe y;
        fe_frombytes(y, pk);
        ge_p3 pt;
        a_ok[j] = ge_decompress(pt, y, pk[31] >> 7) ? 1 : 0;
        ge_coord(a[j], pt, j);
        if (j == 0 || j == 3) fe_neg(a[j], a[j]);
    }
    ge4_double_scalar(q, p, lane + 64, lane + 96, a, btab, tab);

    quad_xchg(q, X, p, 0, 0, 0, 0);
    quad_xchg(q, Y, p, 1, 1, 1, 1);
    quad_xchg(q, Z, p, 2, 2, 2, 2);
    QUAD_EACH(q, j) {
        fe zinv, x, yr;
        fe_invert(zinv, Z[j]);
        fe_mul(yr, Y[j], zinv);
        fe_mul(x, X[j], zinv);
        uint8_t y_b[32], x_b[32], r_y[32];
        fe_tobytes(y_b, yr);
        fe_tobytes(x_b, x);
#pragma unroll
        for (int k = 0; k < 32; k++) r_y[k] = r[k];
        r_y[31] &= 0x7F;
        const bool ok = fe_bytes_eq(y_b, r_y) && ((x_b[0] & 1) == (r[31] >> 7));
        v[j] = (a_ok[j] && ok) ? 1 : 0;
    }
    return quad_result(v);
}
