// GF(2^256 - 2^32 - 977) arithmetic for one lane, secp256k1's base field,
// shared by the CUDA kernel (k1_verify.cu) and a host build used only by the
// tests (g++ compiles this header with __host__/__device__ defined away).
//
// Representation: eight unsigned 32-bit words, little-endian, holding any
// value below 2^256 (so a value in [p, 2^256) is a valid input to every
// routine; only fe8_freeze makes it canonical). The TPU kernel used twenty
// 13-bit limbs with non-uniform loose bounds because the TPU has no 64-bit
// multiply; here a product is 64 32x32 products accumulated with exact
// carries into a 512-bit result, which folds through 2^256 = 2^32 + 977
// (mod p). Full words leave no headroom for lazy carries, so every routine
// folds its carry out of bit 256 back in at once; the fold touches words
// 0-2, and only when it carries on out of word 2 (word 2 within a few of
// 2^32: about once in 2^30 products, far more rarely after a sum) does an
// out-of-line path carry it through the rest.
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

// The rare tails of the folds, out of line on the card so that the hot
// path keeps only a test and a branch that is almost never taken.
#ifdef __CUDACC__
#define K1_RARE_FN __host__ __device__ __noinline__
#else
#define K1_RARE_FN K1_FN
#endif

// r + 2^(32k), carried through; a carry out of bit 256 folds back once
// (the words it leaves are then small, so it cannot carry again). By
// value, so that no caller's element has to live in memory.
K1_RARE_FN fe8 fe8_carry_rare(fe8 r, int k) {
    uint64_t x = 1;
#pragma unroll 1
    for (int i = k; i < 8; i++) {
        x += r.v[i];
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    if (x) fe8_fold(r, 1);
    return r;
}

// r - 2^(32k), borrowed through; a borrow out of bit 256 unfolds once more
// (the value is then near 2^256, so it cannot borrow again).
K1_RARE_FN fe8 fe8_borrow_rare(fe8 r, int k) {
    uint32_t br = 1;
#pragma unroll 1
    for (int i = k; i < 8; i++) {
        const uint64_t d = (uint64_t)r.v[i] - br;
        r.v[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    if (br) fe8_unfold(r, 1);
    return r;
}

// r += c * (2^32 + 977) for c < 2^34: c * 977 into words 0-1, c into words
// 1-2; a carry out of word 2 goes on through fe8_carry_rare.
K1_FN void fe8_fold_fast(fe8& r, uint64_t c) {
    const uint32_t cl = (uint32_t)c, ch = (uint32_t)(c >> 32);
    const uint64_t m = (uint64_t)cl * 977u;
    uint64_t x = (uint64_t)r.v[0] + (uint32_t)m;
    r.v[0] = (uint32_t)x;
    x = (x >> 32) + r.v[1] + (m >> 32) + cl + (uint64_t)ch * 977u;
    r.v[1] = (uint32_t)x;
    x = (x >> 32) + r.v[2] + ch;
    r.v[2] = (uint32_t)x;
    if (x >> 32) r = fe8_carry_rare(r, 3);
}

// a + b: the carry out of bit 256 folds back as 2^32 + 977.
K1_FN void fe8_add(fe8& r, const fe8& a, const fe8& b) {
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)a.v[i] + b.v[i];
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    fe8_fold_fast(r, (uint32_t)x);
}

// a - b: a borrow out of bit 256 means 2^256 was added, so 2^32 + 977 is
// taken off (words 0-1; a borrow out of word 1 goes on through
// fe8_borrow_rare).
K1_FN void fe8_sub(fe8& r, const fe8& a, const fe8& b) {
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint64_t d = (uint64_t)a.v[i] - b.v[i] - br;
        r.v[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    uint64_t d = (uint64_t)r.v[0] - br * 977u;
    r.v[0] = (uint32_t)d;
    d = (uint64_t)r.v[1] - br - (uint32_t)(d >> 63);
    r.v[1] = (uint32_t)d;
    if (d >> 63) r = fe8_borrow_rare(r, 2);
}

// r += c * (2^32 + 977) for a signed |c| < 2^31: words 0-2, and a carry
// or borrow out of word 2 goes on through the rare tails.
K1_FN void fe8_fold_signed(fe8& r, int64_t c) {
    int64_t x = (int64_t)r.v[0] + c * 977;
    r.v[0] = (uint32_t)x;
    x = (x >> 32) + (int64_t)r.v[1] + c;
    r.v[1] = (uint32_t)x;
    x = (x >> 32) + (int64_t)r.v[2];
    r.v[2] = (uint32_t)x;
    x >>= 32;
    if (x) r = x > 0 ? fe8_carry_rare(r, 3) : fe8_borrow_rare(r, 3);
}

// ka a + kb b + kc c for small signed constants (|k| <= 63): one signed
// carry pass, then one signed fold, in place of a chain of adds, subs and
// small multiples that would each fold.
K1_FN void fe8_lin(fe8& r, int ka, const fe8& a, int kb, const fe8& b, int kc,
                   const fe8& c) {
    int64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (int64_t)ka * a.v[i] + (int64_t)kb * b.v[i] + (int64_t)kc * c.v[i];
        r.v[i] = (uint32_t)x;
        x >>= 32;  // arithmetic: the carry keeps its sign
    }
    fe8_fold_signed(r, x);
}

K1_FN void fe8_neg(fe8& r, const fe8& a) {
    fe8 z;
    fe8_set_small(z, 0);
    fe8_sub(r, z, a);
}

// The 512-bit t = H * 2^256 + L (16 words) reduced below 2^256: L + 977 H
// + 2^32 H is below 2^289, so its carry word c (up to 2^32 + 977, 33 bits)
// folds once more.
K1_FN void fe8_reduce512(fe8& r, const uint32_t t[16]) {
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    const uint64_t c = x + t[15];  // the top word of 2^32 H lands at word 8
    fe8_fold_fast(r, c);
}

// t[0..8] += ai * b, t[8] entering as 0; the sum fits in nine words.
K1_FN void fe8_mac_row(uint32_t* t, uint32_t ai, const fe8& b) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: no overflow
        const uint64_t x = (uint64_t)ai * b.v[j] + t[j] + c;
        t[j] = (uint32_t)x;
        c = x >> 32;
    }
    t[8] = (uint32_t)c;
}

// a * b: the 512-bit schoolbook product, 64 32x32->64 products (IMAD.WIDE)
// accumulated row by row with exact carries, then fe8_reduce512.
K1_FN void fe8_mul(fe8& r, const fe8& a, const fe8& b) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) fe8_mac_row(t + i, a.v[i], b);
    fe8_reduce512(r, t);
}

// a^2 in 36 products: the 28 off-diagonal a_i a_j (i < j), row by row into
// t[1..14] (their sum is below 2^480, so t[15] stays 0), doubled by a
// one-bit shift, plus the eight squares a_i^2 on the diagonal.
K1_FN void fe8_sq(fe8& r, const fe8& a) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < 8; j++) {
            const uint64_t x = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)x;
            c = x >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
#pragma unroll
    for (int k = 15; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
    t[0] <<= 1;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint64_t d = (uint64_t)a.v[i] * a.v[i];
        c += (uint64_t)t[2 * i] + (uint32_t)d;
        t[2 * i] = (uint32_t)c;
        c >>= 32;
        c += (uint64_t)t[2 * i + 1] + (d >> 32);
        t[2 * i + 1] = (uint32_t)c;
        c >>= 32;
    }
    fe8_reduce512(r, t);
}

// out = (a, b, c, d)[j], word by word, through masks: x ^ ((x ^ y) & m)
// is one LOP3, so a four-way choice is three a word and no branch (a chain
// of compares on j compiles into a branch tree on every word).
K1_FN void fe8_select4(fe8& out, int j, const fe8& a, const fe8& b, const fe8& c,
                       const fe8& d) {
    const uint32_t odd = 0u - (uint32_t)(j & 1), high = 0u - (uint32_t)(j >> 1);
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint32_t ab = a.v[i] ^ ((a.v[i] ^ b.v[i]) & odd);
        const uint32_t cd = c.v[i] ^ ((c.v[i] ^ d.v[i]) & odd);
        out.v[i] = ab ^ ((ab ^ cd) & high);
    }
}

// a * k for a small constant k < 2^32 (3, 8, 21 and 63 in the complete
// formulas).
K1_FN void fe8_mul_small(fe8& r, const fe8& a, uint32_t k) {
    uint64_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        x += (uint64_t)a.v[i] * k;
        r.v[i] = (uint32_t)x;
        x >>= 32;
    }
    fe8_fold_fast(r, (uint32_t)x);
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
