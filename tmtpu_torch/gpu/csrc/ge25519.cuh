// edwards25519 point arithmetic and the per-lane ed25519 verify, shared by
// the CUDA kernel (ed25519_verify.cu) and the host build the tests use.
//
// Points are extended coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, T = XY/Z,
// with the same formulas as tmtpu/tpu/curve.py: dbl-2008-hwcd doubling and
// the unified add-2008-hwcd-3 addition against a niels (Y-X, Y+X, 2dT;
// Z = 1) or cached (Y-X, Y+X, 2Z, 2dT) operand. Both are complete on
// ed25519, so identity, low-order and mixed-order inputs need no branch.
#pragma once

#include "fe25519.cuh"

struct ge_p3 {
    fe X, Y, Z, T;
};

struct ge_cached {
    fe YmX, YpX, Z2, T2d;
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

GE_FN void ge_identity(ge_p3& p) {
    fe_set_small(p.X, 0);
    fe_set_small(p.Y, 1);
    fe_set_small(p.Z, 1);
    fe_set_small(p.T, 0);
}

// 4 squarings + 4 multiplies.
GE_FN void ge_double(ge_p3& r, const ge_p3& p) {
    fe A, B, C, E, F, G, H, t;
    fe_sq(A, p.X);
    fe_sq(B, p.Y);
    fe_sq(t, p.Z);
    fe_add(C, t, t);
    fe_add(H, A, B);
    fe_add(t, p.X, p.Y);
    fe_sq(t, t);
    fe_sub(E, H, t);
    fe_sub(G, A, B);
    fe_add(F, C, G);
    fe_mul(r.X, E, F);
    fe_mul(r.Y, G, H);
    fe_mul(r.Z, F, G);
    fe_mul(r.T, E, H);
}

// p + n, n a niels operand: 7 multiplies.
GE_FN void ge_add_niels(ge_p3& r, const ge_p3& p, const ge_niels& n) {
    fe A, B, C, D, E, F, G, H, t;
    fe_sub(t, p.Y, p.X);
    fe_mul(A, t, n.YmX);
    fe_add(t, p.Y, p.X);
    fe_mul(B, t, n.YpX);
    fe_mul(C, p.T, n.T2d);
    fe_add(D, p.Z, p.Z);
    fe_sub(E, B, A);
    fe_sub(F, D, C);
    fe_add(G, D, C);
    fe_add(H, B, A);
    fe_mul(r.X, E, F);
    fe_mul(r.Y, G, H);
    fe_mul(r.Z, F, G);
    fe_mul(r.T, E, H);
}

// p + c, c a cached operand: 8 multiplies.
GE_FN void ge_add_cached(ge_p3& r, const ge_p3& p, const ge_cached& c) {
    fe A, B, C, D, E, F, G, H, t;
    fe_sub(t, p.Y, p.X);
    fe_mul(A, t, c.YmX);
    fe_add(t, p.Y, p.X);
    fe_mul(B, t, c.YpX);
    fe_mul(C, p.T, c.T2d);
    fe_mul(D, p.Z, c.Z2);
    fe_sub(E, B, A);
    fe_sub(F, D, C);
    fe_add(G, D, C);
    fe_add(H, B, A);
    fe_mul(r.X, E, F);
    fe_mul(r.Y, G, H);
    fe_mul(r.Z, F, G);
    fe_mul(r.T, E, H);
}

GE_FN void ge_to_cached(ge_cached& c, const ge_p3& p) {
    fe d2;
    fe_const_d2(d2);
    fe_sub(c.YmX, p.Y, p.X);
    fe_add(c.YpX, p.Y, p.X);
    fe_add(c.Z2, p.Z, p.Z);
    fe_mul(c.T2d, p.T, d2);
}

GE_FN void ge_negate(ge_p3& r, const ge_p3& p) {
    fe_neg(r.X, p.X);
    r.Y = p.Y;
    r.Z = p.Z;
    fe_neg(r.T, p.T);
}

// Point decompression with the exact semantics of
// tmtpu/tpu/verify.py::decompress (which mirrors ed25519_ref._recover_x):
// x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1; accept when
// v x^2 = u, or = -u after x *= sqrt(-1); reject x = 0 with the sign bit
// set. The y limbs may hold a value >= p: the host masks such lanes.
GE_FN bool ge_decompress(ge_p3& out, const fe& y, int sign) {
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

// [s]B + [h]A by the 64-window 4-bit Straus/Shamir ladder of
// tmtpu/tpu/kernel.py::_shamir_ladder (the doublings shared by both
// scalars): build the 16-entry cached table of d*A, then per window double
// four times and add btab[digit of s] and tab[digit of h]. s and h are
// 32-byte little-endian scalars; btab is the niels table of d*B for d in
// 0..15. Shared by the ed25519 and sr25519 verifies.
GE_FN void ge_double_scalar(ge_p3& p, const uint8_t s[32], const uint8_t h[32],
                            const ge_p3& a, const ge_niels* btab) {
    // per-lane table of d*A, d = 0..15 (thread-local memory)
    ge_cached tab[16];
    fe_set_small(tab[0].YmX, 1);
    fe_set_small(tab[0].YpX, 1);
    fe_set_small(tab[0].Z2, 2);
    fe_set_small(tab[0].T2d, 0);
    ge_to_cached(tab[1], a);
    ge_p3 acc = a;
#pragma unroll 1
    for (int d = 2; d < 16; d++) {
        ge_add_cached(acc, acc, tab[1]);
        ge_to_cached(tab[d], acc);
    }

    ge_identity(p);
#pragma unroll 1
    for (int w = 0; w < 64; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) ge_double(p, p);
        ge_add_niels(p, p, btab[scalar_digit_msb(s, w)]);
        ge_add_cached(p, p, tab[scalar_digit_msb(h, w)]);
    }
}

// The whole per-lane verify of tmtpu/tpu/kernel.py::_verify_body:
// decompress A, run the ladder [s]B + [h](-A) and byte-compare the
// encoding of the result with R. btab is the niels table of d*B for d in
// 0..15. Returns 1 when the signature verifies.
GE_FN int ed25519_verify_lane(const uint8_t pk[32], const uint8_t r[32],
                              const uint8_t s[32], const uint8_t h[32],
                              const ge_niels* btab) {
    fe y;
    fe_frombytes(y, pk);
    ge_p3 a;
    const bool a_ok = ge_decompress(a, y, pk[31] >> 7);
    ge_negate(a, a);
    ge_p3 p;
    ge_double_scalar(p, s, h, a, btab);

    fe zinv, x, yr;
    fe_invert(zinv, p.Z);
    fe_mul(yr, p.Y, zinv);
    fe_mul(x, p.X, zinv);
    uint8_t y_b[32], x_b[32], r_y[32];
    fe_tobytes(y_b, yr);
    fe_tobytes(x_b, x);
#pragma unroll
    for (int k = 0; k < 32; k++) r_y[k] = r[k];
    r_y[31] &= 0x7F;
    const bool ok = fe_bytes_eq(y_b, r_y) && ((x_b[0] & 1) == (r[31] >> 7));
    return (a_ok && ok) ? 1 : 0;
}
