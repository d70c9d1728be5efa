// GF(2^255 - 19) arithmetic for one thread, shared by the CUDA kernels and
// a host build used only by the tests (g++ compiles this header with
// __host__/__device__ defined away).
//
// Representation: ten signed 32-bit limbs in radix 2^25.5 (the ref10
// layout): value = sum v[i] * 2^ceil(25.5 i), even limbs 26 bits, odd
// limbs 25 bits. The TPU kernel used 20 x 13-bit limbs because the TPU has
// no 64-bit multiply; here every limb product is one 32x32->64 multiply
// (IMAD.WIDE) accumulated in int64: a field multiply is 100 such products
// plus ten multiplies by 19, a squaring 55 (the symmetric ref10 form).
//
// Every routine returns limbs carried to |v[i]| <= ~1.01 * 2^25 (even) /
// 2^24 (odd), and accepts those or the non-negative limbs of fe_frombytes
// (< 2^26 / 2^25): fe_mul's ten terms of at most 2^27 * 19 * 2^26 and
// fe_sq's six of at most 2^28 * 19 * 2^26 keep every int64 accumulator
// below 2^61, the input bound of fe_reduce64.
// fe_tobytes is exactly canonical (value in [0, p)), which the byte-exact
// compare at the end of verification depends on.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define FE_FN __host__ __device__ __forceinline__

// The serial head and tail of a verify (the exponentiations, decompression,
// ristretto decoding) run once per thread. On the card they are compiled
// out of line, so that their many live field elements are allocated, and
// under the kernels' register cap spilled, apart from the ladder's.
#ifdef __CUDACC__
#define TAIL_FN __host__ __device__ __noinline__
#else
#define TAIL_FN FE_FN
#endif

struct fe {
    int32_t v[10];
};

// Limb i starts at bit ceil(25.5 i).
FE_FN int fe_limb_bits(int i) { return (i & 1) ? 25 : 26; }

FE_FN void fe_set_small(fe& h, int32_t x) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = 0;
    h.v[0] = x;
}

// Carry a 64-bit accumulator vector (|h[i]| < 2^61) down to the limb
// bounds above, in two parallel passes: every limb at once keeps its low
// bits and passes the floor of the rest up (|carry| < 2^36, the top one
// times 19 to limb 0), leaving |t| < 2^41; then every limb at once keeps
// its centred low bits and passes the rest (now |carry| < 2^16) up. The
// result: |v| <= 2^25 + 2^15 (even) / 2^24 + 2^15 (odd). Each pass is a few
// instructions deep where ref10's carry chain is twelve steps long (on an
// H100 the chain made the ed25519 kernel 12% slower, with 39% more SASS
// instructions).
FE_FN void fe_reduce64(fe& out, const int64_t h[10]) {
    int64_t c[10], t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) c[i] = h[i] >> fe_limb_bits(i);
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int64_t low = h[i] & ((1 << fe_limb_bits(i)) - 1);
        t[i] = low + (i == 0 ? 19 * c[9] : c[i - 1]);
    }
    int32_t c2[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int nb = fe_limb_bits(i);
        c2[i] = (int32_t)((t[i] + (1 << (nb - 1))) >> nb);
    }
#pragma unroll
    for (int i = 0; i < 10; i++) {
        // t - c2 * 2^nb lies in [-2^(nb-1), 2^(nb-1)): exact in 32-bit wrap
        const int32_t r = (int32_t)((uint32_t)t[i] - ((uint32_t)c2[i] << fe_limb_bits(i)));
        out.v[i] = r + (i == 0 ? 19 * c2[9] : c2[i - 1]);
    }
}

// One parallel carry pass over int32 limbs with |h[i]| < 2^28 (a sum of at
// most four carried or fe_frombytes limbs): each limb keeps its centred
// low bits and passes the rest (|c| <= 4) up, the top one times 19 to limb
// 0. The result is carried: |v| <= 2^25 + 76 (even) / 2^24 + 4 (odd). Every
// carry is independent, so the pass is three instructions deep where
// fe_reduce64's chain is twelve steps long.
FE_FN void fe_carry32(fe& out, const int32_t h[10]) {
    int32_t c[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int nb = fe_limb_bits(i);
        c[i] = (h[i] + (1 << (nb - 1))) >> nb;
    }
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int nb = fe_limb_bits(i);
        out.v[i] = h[i] - c[i] * (1 << nb) + (i == 0 ? 19 * c[9] : c[i - 1]);
    }
}

FE_FN void fe_add(fe& out, const fe& f, const fe& g) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = f.v[i] + g.v[i];
    fe_carry32(out, h);
}

FE_FN void fe_sub(fe& out, const fe& f, const fe& g) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = f.v[i] - g.v[i];
    fe_carry32(out, h);
}

FE_FN void fe_neg(fe& out, const fe& f) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = -f.v[i];
    fe_carry32(out, h);
}

// a f + b g + c k for small integer coefficients (|a| + |b| + |c| <= 4),
// carried: the linear steps of the four-thread point formulas, where each
// thread takes its own coefficients.
FE_FN void fe_lin3(fe& out, int a, const fe& f, int b, const fe& g, int c,
                   const fe& k) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = a * f.v[i] + b * g.v[i] + c * k.v[i];
    fe_carry32(out, h);
}

FE_FN void fe_lin2(fe& out, int a, const fe& f, int b, const fe& g) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = a * f.v[i] + b * g.v[i];
    fe_carry32(out, h);
}

// out = (a, b, c, d)[j], limb by limb (no indexed address, so every operand
// stays in registers).
FE_FN void fe_select4(fe& out, int j, const fe& a, const fe& b, const fe& c,
                      const fe& d) {
#pragma unroll
    for (int i = 0; i < 10; i++)
        out.v[i] = j == 0 ? a.v[i] : j == 1 ? b.v[i] : j == 2 ? c.v[i] : d.v[i];
}

// h_k = sum_{i+j=k mod 10} f_i g_j, times 2 when i and j are both odd
// (25-bit limbs: ceil(25.5 i) + ceil(25.5 j) = ceil(25.5 (i+j)) - 1), and
// times 19 when i+j >= 10 (2^255 = 19 mod p). The 2 rides on f and the 19
// on g so that both factors stay 32-bit.
FE_FN void fe_mul(fe& out, const fe& f, const fe& g) {
    int32_t f2[10], g19[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        f2[i] = 2 * f.v[i];
        g19[i] = 19 * g.v[i];
    }
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            const int32_t a = (i & j & 1) ? f2[i] : f.v[i];
            const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
            h[(i + j) % 10] += (int64_t)a * b;
        }
    }
    fe_reduce64(out, h);
}

// f^2 in 55 products: the terms f_i f_j and f_j f_i of fe_mul are taken
// once, doubled on the side of f_i (so 4 f_i when both are odd, at most
// 2^28) while the 19 of a wrap rides on f_j (at most 19 * 2^26 < 2^31).
FE_FN void fe_sq(fe& out, const fe& f) {
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            const int32_t a = f.v[i] * ((i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1));
            const int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
            h[(i + j) % 10] += (int64_t)a * b;
        }
    }
    fe_reduce64(out, h);
}

FE_FN void fe_sqn(fe& out, const fe& f, int n) {
    fe t = f;
#pragma unroll 1
    for (int i = 0; i < n; i++) fe_sq(t, t);
    out = t;
}

// z^(2^255 - 21) = z^-1: 254 squarings + 11 multiplies (the chain of
// tmtpu/tpu/fe.py::invert).
TAIL_FN void fe_invert(fe& out, const fe& z) {
    fe t0, t1, t2, t3;
    fe_sq(t0, z);             // 2
    fe_sqn(t1, t0, 2);        // 8
    fe_mul(t1, z, t1);        // 9
    fe_mul(t0, t0, t1);       // 11
    fe_sq(t2, t0);            // 22
    fe_mul(t1, t1, t2);       // 2^5 - 1
    fe_sqn(t2, t1, 5);
    fe_mul(t1, t2, t1);       // 2^10 - 1
    fe_sqn(t2, t1, 10);
    fe_mul(t2, t2, t1);       // 2^20 - 1
    fe_sqn(t3, t2, 20);
    fe_mul(t2, t3, t2);       // 2^40 - 1
    fe_sqn(t2, t2, 10);
    fe_mul(t1, t2, t1);       // 2^50 - 1
    fe_sqn(t2, t1, 50);
    fe_mul(t2, t2, t1);       // 2^100 - 1
    fe_sqn(t3, t2, 100);
    fe_mul(t2, t3, t2);       // 2^200 - 1
    fe_sqn(t2, t2, 50);
    fe_mul(t1, t2, t1);       // 2^250 - 1
    fe_sqn(t1, t1, 5);        // 2^255 - 2^5
    fe_mul(out, t1, t0);      // 2^255 - 21
}

// z^((p-5)/8) = z^(2^252 - 3): 251 squarings + 11 multiplies (the chain of
// tmtpu/tpu/fe.py::pow_p58).
TAIL_FN void fe_pow22523(fe& out, const fe& z) {
    fe t0, t1, t2;
    fe_sq(t0, z);             // 2
    fe_sqn(t1, t0, 2);        // 8
    fe_mul(t1, z, t1);        // 9
    fe_mul(t0, t0, t1);       // 11
    fe_sq(t0, t0);            // 22
    fe_mul(t0, t1, t0);       // 2^5 - 1
    fe_sqn(t1, t0, 5);
    fe_mul(t0, t1, t0);       // 2^10 - 1
    fe_sqn(t1, t0, 10);
    fe_mul(t1, t1, t0);       // 2^20 - 1
    fe_sqn(t2, t1, 20);
    fe_mul(t1, t2, t1);       // 2^40 - 1
    fe_sqn(t1, t1, 10);
    fe_mul(t0, t1, t0);       // 2^50 - 1
    fe_sqn(t1, t0, 50);
    fe_mul(t1, t1, t0);       // 2^100 - 1
    fe_sqn(t2, t1, 100);
    fe_mul(t1, t2, t1);       // 2^200 - 1
    fe_sqn(t1, t1, 50);
    fe_mul(t0, t1, t0);       // 2^250 - 1
    fe_sqn(t0, t0, 2);        // 2^252 - 4
    fe_mul(out, t0, z);       // 2^252 - 3
}

// Low 255 bits of a 32-byte little-endian string, exactly (bit 255, the
// ed25519 sign bit, is dropped). No reduction: a value in [p, 2^255) is a
// valid loose input to every routine above.
FE_FN void fe_frombytes(fe& h, const uint8_t s[32]) {
    int bit = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int nb = fe_limb_bits(i);
        uint32_t acc = 0;
        const int k0 = bit >> 3, off = bit & 7;
        // a limb spans at most 5 bytes; read 4 and the 5th when needed
#pragma unroll
        for (int k = 0; k < 4; k++) {
            if (k0 + k < 32) acc |= (uint32_t)s[k0 + k] << (8 * k);
        }
        uint32_t v = acc >> off;
        if (off + nb > 32 && k0 + 4 < 32) v |= (uint32_t)s[k0 + 4] << (32 - off);
        v &= (1u << nb) - 1u;  // for limb 9 (bits 230..254) this drops bit 255
        h.v[i] = (int32_t)v;
        bit += nb;
    }
}

// Canonical little-endian encoding (value in [0, p)), the ref10 freeze:
// q = floor(h / p) from the top, subtract q*p, then an exact carry chain.
FE_FN void fe_tobytes(uint8_t s[32], const fe& f) {
    int32_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = f.v[i];
    int32_t q = (19 * h[9] + (1 << 24)) >> 25;
#pragma unroll
    for (int i = 0; i < 10; i++) q = (h[i] + q) >> fe_limb_bits(i);
    h[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int nb = fe_limb_bits(i);
        const int32_t c = h[i] >> nb;
        h[i + 1] += c;
        h[i] -= c * (1 << nb);
    }
    h[9] &= (1 << 25) - 1;  // drop the 2^255 carry (it is q*2^255)
    uint64_t acc = 0;
    int bits = 0, k = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        acc |= (uint64_t)(uint32_t)h[i] << bits;
        bits += fe_limb_bits(i);
        while (bits >= 8) {
            s[k++] = (uint8_t)acc;
            acc >>= 8;
            bits -= 8;
        }
    }
    s[31] = (uint8_t)acc;  // the last 7 bits
}

FE_FN bool fe_bytes_eq(const uint8_t a[32], const uint8_t b[32]) {
    uint32_t d = 0;
#pragma unroll
    for (int k = 0; k < 32; k++) d |= (uint32_t)(a[k] ^ b[k]);
    return d == 0;
}
