// GF(2^256 - 2^32 - 977) arithmetic for one lane, secp256k1's base field,
// shared by the CUDA kernel (k1_verify.cu) and a host build used only by the
// tests (g++ compiles this header with __host__/__device__ defined away).
//
// Representation: eight unsigned 32-bit words, little-endian, holding any
// value below 2^256 (so a value in [p, 2^256) is a valid input to every
// routine; only fe8_freeze makes it canonical). The TPU kernel used twenty
// 13-bit limbs with non-uniform loose bounds because the TPU has no 64-bit
// multiply; here a product is 64 32x32->64 multiplies (IMAD.WIDE)
// accumulated row by row with exact carries into a 512-bit result, which
// then folds through 2^256 = 2^32 + 977 (mod p) twice. Every routine keeps
// the value below 2^256 by folding each carry out of bit 256 back in.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define K1_FN __host__ __device__ __forceinline__

struct fe8 {
    uint32_t v[8];
};

K1_FN void fe8_set_small(fe8& r, uint32_t x) {
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = 0;
    r.v[0] = x;
}

// r += c * (2^32 + 977) for c < 2^34 (a carry out of bit 256 folded back);
// returns the new carry out of bit 256 (0 or 1).
K1_FN uint32_t fe8_fold(fe8& r, uint64_t c) {
    uint64_t x = (uint64_t)r.v[0] + c * 977u;
    r.v[0] = (uint32_t)x;
    x >>= 32;
    x += (uint64_t)r.v[1] + (c & 0xFFFFFFFFu);
    r.v[1] = (uint32_t)x;
    x >>= 32;
    x += (uint64_t)r.v[2] + (c >> 32);
    r.v[2] = (uint32_t)x;
    x >>= 32;
#pragma unroll
    for (int i = 3; i < 8; i++) {
        x += r.v[i];
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    return (uint32_t)x;
}

// r -= c * (2^32 + 977) for c in {0, 1} (a borrow out of bit 256 folded
// back); returns the new borrow (0 or 1).
K1_FN uint32_t fe8_unfold(fe8& r, uint32_t c) {
    uint64_t d = (uint64_t)r.v[0] - (uint64_t)c * 977u;
    r.v[0] = (uint32_t)d;
    uint32_t br = (uint32_t)(d >> 63);
    d = (uint64_t)r.v[1] - c - br;
    r.v[1] = (uint32_t)d;
    br = (uint32_t)(d >> 63);
#pragma unroll
    for (int i = 2; i < 8; i++) {
        d = (uint64_t)r.v[i] - br;
        r.v[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    return br;
}

// a + b: a carry out of bit 256 folds back as 2^32 + 977; a second fold
// covers the case where that addition carries too (then the value is tiny
// and a third cannot).
K1_FN void fe8_add(fe8& r, const fe8& a, const fe8& b) {
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)a.v[i] + b.v[i];
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    fe8_fold(r, fe8_fold(r, x));
}

// a - b: a borrow out of bit 256 means 2^256 was added, so 2^32 + 977 is
// taken off, twice at most.
K1_FN void fe8_sub(fe8& r, const fe8& a, const fe8& b) {
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint64_t d = (uint64_t)a.v[i] - b.v[i] - br;
        r.v[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    fe8_unfold(r, fe8_unfold(r, br));
}

K1_FN void fe8_neg(fe8& r, const fe8& a) {
    fe8 z;
    fe8_set_small(z, 0);
    fe8_sub(r, z, a);
}

// a * b: the 512-bit schoolbook product t = H * 2^256 + L, then
// L + 977 H + 2^32 H (at most 2^290), whose carry word folds once more.
K1_FN void fe8_mul(fe8& r, const fe8& a, const fe8& b) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: no overflow
            const uint64_t x = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)x;
            c = x >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    x += t[15];  // the top word of 2^32 H lands at word 8
    fe8_fold(r, fe8_fold(r, x));
}

K1_FN void fe8_sq(fe8& r, const fe8& a) { fe8_mul(r, a, a); }

// a * k for a small constant k (3 and b3 = 21 in the complete formulas).
K1_FN void fe8_mul_small(fe8& r, const fe8& a, uint32_t k) {
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)a.v[i] * k;
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    fe8_fold(r, fe8_fold(r, x));
}

K1_FN void fe8_sqn(fe8& r, const fe8& a, int n) {
    fe8 t = a;
#pragma unroll 1
    for (int i = 0; i < n; i++) fe8_sq(t, t);
    r = t;
}

// The canonical value in [0, p): a < 2^256 < 2p, and a >= p exactly when
// a + (2^32 + 977) carries out of bit 256, which then leaves a - p.
K1_FN void fe8_freeze(fe8& r, const fe8& a) {
    fe8 t = a;
    const uint32_t ge_p = fe8_fold(t, 1);
    r = ge_p ? t : a;
}

K1_FN bool fe8_is_zero(const fe8& a) {
    fe8 f;
    fe8_freeze(f, a);
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) any |= f.v[i];
    return any == 0;
}

K1_FN bool fe8_equal(const fe8& a, const fe8& b) {
    fe8 fa, fb;
    fe8_freeze(fa, a);
    fe8_freeze(fb, b);
    uint32_t d = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) d |= fa.v[i] ^ fb.v[i];
    return d == 0;
}

// a^((p+1)/4), a square root of a whenever one exists (p = 3 mod 4): the
// addition chain of tmtpu/tpu/fe_k1.py::sqrt_candidate, 253 squarings and
// 13 multiplies.
K1_FN void fe8_sqrt_candidate(fe8& r, const fe8& a) {
    fe8 x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
    fe8_sq(t, a);
    fe8_mul(x2, t, a);
    fe8_sq(t, x2);
    fe8_mul(x3, t, a);
    fe8_sqn(t, x3, 3);
    fe8_mul(x6, t, x3);
    fe8_sqn(t, x6, 3);
    fe8_mul(x9, t, x3);
    fe8_sqn(t, x9, 2);
    fe8_mul(x11, t, x2);
    fe8_sqn(t, x11, 11);
    fe8_mul(x22, t, x11);
    fe8_sqn(t, x22, 22);
    fe8_mul(x44, t, x22);
    fe8_sqn(t, x44, 44);
    fe8_mul(x88, t, x44);
    fe8_sqn(t, x88, 88);
    fe8_mul(x176, t, x88);
    fe8_sqn(t, x176, 44);
    fe8_mul(x220, t, x44);
    fe8_sqn(t, x220, 3);
    fe8_mul(x223, t, x3);
    fe8_sqn(t, x223, 23);
    fe8_mul(t, t, x22);
    fe8_sqn(t, t, 6);
    fe8_mul(t, t, x2);
    fe8_sqn(r, t, 2);
}

// 32 big-endian bytes (SEC 1 order) as a value below 2^256.
K1_FN void fe8_from_be(fe8& r, const uint8_t b[32]) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const int k = 31 - 4 * i;
        r.v[i] = (uint32_t)b[k] | ((uint32_t)b[k - 1] << 8) |
                 ((uint32_t)b[k - 2] << 16) | ((uint32_t)b[k - 3] << 24);
    }
}
