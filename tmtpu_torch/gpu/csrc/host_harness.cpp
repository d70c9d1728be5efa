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

// Byte k of lane t of a packed plane with B lanes, as each kernel thread
// reads it.
static void lane_bytes(const uint8_t* packed, int B, int t, int row0, uint8_t out[32]) {
    for (int k = 0; k < 32; k++) out[k] = packed[(size_t)(row0 + k) * B + t];
}

// The ed25519 kernel's per-lane verify over a packed [128, B] plane.
extern "C" void host_verify(const uint8_t* packed, int B, const int32_t* btab,
                            int32_t* out) {
    const ge_niels* tab = reinterpret_cast<const ge_niels*>(btab);
    for (int t = 0; t < B; t++) {
        uint8_t pk[32], r[32], s[32], h[32];
        lane_bytes(packed, B, t, 0, pk);
        lane_bytes(packed, B, t, 32, r);
        lane_bytes(packed, B, t, 64, s);
        lane_bytes(packed, B, t, 96, h);
        out[t] = ed25519_verify_lane(pk, r, s, h, tab);
    }
}

// The sr25519 kernel's per-lane verify over a packed [128, B] plane.
extern "C" void host_sr_verify(const uint8_t* packed, int B, const int32_t* btab,
                               int32_t* out) {
    const ge_niels* tab = reinterpret_cast<const ge_niels*>(btab);
    for (int t = 0; t < B; t++) {
        uint8_t pk[32], r[32], s[32], k[32];
        lane_bytes(packed, B, t, 0, pk);
        lane_bytes(packed, B, t, 32, r);
        lane_bytes(packed, B, t, 64, s);
        lane_bytes(packed, B, t, 96, k);
        out[t] = sr25519_verify_lane(pk, r, s, k, tab);
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

// The secp256k1 kernel's per-lane verify over a packed [168, B] plane.
extern "C" void host_k1_verify(const uint8_t* packed, int B, const uint32_t* gtab,
                               int32_t* out) {
    const k1_point* tab = reinterpret_cast<const k1_point*>(gtab);
    for (int t = 0; t < B; t++) {
        uint8_t pkx[32], u1[32], u2[32], r[32], rpn[32];
        lane_bytes(packed, B, t, 0, pkx);
        lane_bytes(packed, B, t, 32, u1);
        lane_bytes(packed, B, t, 64, u2);
        lane_bytes(packed, B, t, 96, r);
        lane_bytes(packed, B, t, 128, rpn);
        out[t] = k1_verify_lane(pkx, packed[(size_t)160 * B + t], u1, u2, r, rpn, tab);
    }
}

// One field op on n pairs of 32-byte little-endian inputs (255 bits used),
// written as canonical 32-byte encodings:
// 0 mul, 1 add, 2 sub, 3 neg, 4 invert, 5 pow22523, 6 freeze (a alone).
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
            default: z = x; break;
        }
        fe_tobytes(out + 32 * i, z);
    }
}

// One secp256k1 field op on n pairs of 32-byte big-endian inputs (any value
// below 2^256), written as canonical 32-byte big-endian values:
// 0 mul, 1 add, 2 sub, 3 neg, 4 sq, 5 times 21, 6 sqrt candidate,
// 7 freeze (a alone).
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
