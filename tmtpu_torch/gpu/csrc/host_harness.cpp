// Host build of the kernels' field and curve headers, for the tests only
// (tests/test_torch_host_kernel.py compiles it with g++ into a temporary
// shared library). No entry point of the package loads it.

#include <stddef.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe_secp256k1.cuh"
#include "ge25519.cuh"
#include "ge_secp256k1.cuh"
#include "ristretto255.cuh"

// The n bytes of lane t of a packed [n, B] plane (n = 128: pk | r | s |
// h-or-k; n = 168: pkx | u1 | u2 | r | rpn | parity), which the kernels
// gather into shared memory for the lane's quad.
static void lane_bytes(const uint8_t* packed, int B, int t, int n, uint8_t* out) {
    for (int k = 0; k < n; k++) out[k] = packed[(size_t)k * B + t];
}

// The ed25519 kernel's per-signature verify over a packed [128, B] plane:
// each lane runs the quad code with its four roles in lockstep (-1 where
// the roles disagree).
extern "C" void host_verify(const uint8_t* packed, int B, const int32_t* btab,
                            int32_t* out) {
    const ge_niels* tab = reinterpret_cast<const ge_niels*>(btab);
    for (int t = 0; t < B; t++) {
        uint8_t lane[128];
        lane_bytes(packed, B, t, 128, lane);
        quad q;
        quad_table qt;
        out[t] = ed25519_verify_quad(q, lane, tab, qt);
    }
}

// The sr25519 kernel's per-signature verify, the same way.
extern "C" void host_sr_verify(const uint8_t* packed, int B, const int32_t* btab,
                               int32_t* out) {
    const ge_niels* tab = reinterpret_cast<const ge_niels*>(btab);
    for (int t = 0; t < B; t++) {
        uint8_t lane[128];
        lane_bytes(packed, B, t, 128, lane);
        quad q;
        quad_table qt;
        out[t] = sr25519_verify_quad(q, lane, tab, qt);
    }
}

// The sr25519 kernel's ristretto255 DECODE of n 32-byte encodings: valid
// flags, and the decoded (x, y) as canonical 32-byte encodings.
extern "C" void host_ristretto_decode(const uint8_t* enc, int n, int32_t* valid,
                                      uint8_t* xy) {
    for (int i = 0; i < n; i++) {
        ge_p3 p;
        valid[i] = ristretto_decode(p, enc + 32 * i) ? 1 : 0;
        fe_tobytes(xy + 64 * i, p.X);
        fe_tobytes(xy + 64 * i + 32, p.Y);
    }
}

// The secp256k1 kernel's per-signature verify over a packed [168, B]
// plane, the same way.
extern "C" void host_k1_verify(const uint8_t* packed, int B, const uint32_t* gtab,
                               int32_t* out) {
    const k1_point* tab = reinterpret_cast<const k1_point*>(gtab);
    for (int t = 0; t < B; t++) {
        uint8_t lane[168];
        lane_bytes(packed, B, t, 168, lane);
        quad q;
        quad_tab<fe8> qt;
        out[t] = k1_verify_quad(q, lane, tab, qt);
    }
}

// One field op on n pairs of 32-byte little-endian inputs (255 bits used),
// written as canonical 32-byte encodings:
// 0 mul, 1 add, 2 sub, 3 neg, 4 invert, 5 pow22523, 6 freeze (a alone),
// 7 sq, 8 sq of a - b (the signed limbs fe_sub leaves).
extern "C" void host_fe(int op, const uint8_t* a, const uint8_t* b, uint8_t* out,
                        int n) {
    for (int i = 0; i < n; i++) {
        fe x, y, z;
        fe_frombytes(x, a + 32 * i);
        fe_frombytes(y, b + 32 * i);
        switch (op) {
            case 0: fe_mul(z, x, y); break;
            case 1: fe_add(z, x, y); break;
            case 2: fe_sub(z, x, y); break;
            case 3: fe_neg(z, x); break;
            case 4: fe_invert(z, x); break;
            case 5: fe_pow22523(z, x); break;
            case 7: fe_sq(z, x); break;
            case 8: fe_sub(z, x, y); fe_sq(z, z); break;
            default: z = x; break;
        }
        fe_tobytes(out + 32 * i, z);
    }
}

// fe_mul (op 0) or fe_sq (op 1) of n raw limb vectors a[10 i..] (and
// b[10 i..]) as given, loose limbs included, written as canonical 32-byte
// encodings.
extern "C" void host_fe_limbs(int op, const int32_t* a, const int32_t* b, uint8_t* out,
                              int n) {
    for (int i = 0; i < n; i++) {
        fe x, y, z;
        for (int k = 0; k < 10; k++) {
            x.v[k] = a[10 * i + k];
            y.v[k] = b[10 * i + k];
        }
        if (op == 0) {
            fe_mul(z, x, y);
        } else {
            fe_sq(z, x);
        }
        fe_tobytes(out + 32 * i, z);
    }
}

// One secp256k1 field op on n pairs of 32-byte big-endian inputs (any value
// below 2^256), written as canonical 32-byte big-endian values:
// 0 mul, 1 add, 2 sub, 3 neg, 4 sq, 5 times 21, 6 sqrt candidate,
// 7 freeze (a alone), 8 21 a - 63 b (fe8_lin).
extern "C" void host_fe8(int op, const uint8_t* a, const uint8_t* b, uint8_t* out,
                         int n) {
    for (int i = 0; i < n; i++) {
        fe8 x, y, z;
        fe8_from_be(x, a + 32 * i);
        fe8_from_be(y, b + 32 * i);
        switch (op) {
            case 0: fe8_mul(z, x, y); break;
            case 1: fe8_add(z, x, y); break;
            case 2: fe8_sub(z, x, y); break;
            case 3: fe8_neg(z, x); break;
            case 4: fe8_sq(z, x); break;
            case 5: fe8_mul_small(z, x, 21); break;
            case 6: fe8_sqrt_candidate(z, x); break;
            case 8: fe8_lin(z, 21, x, -63, y, 0, y); break;
            default: z = x; break;
        }
        fe8_freeze(z, z);
        for (int w = 0; w < 8; w++) {
            for (int k = 0; k < 4; k++) {
                out[32 * i + 31 - 4 * w - k] = (uint8_t)(z.v[w] >> (8 * k));
            }
        }
    }
}
