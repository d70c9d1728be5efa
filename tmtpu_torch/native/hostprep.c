/* Host preparation of the port's verify flush, in C.
 *
 * Three batched prep entries, each threaded over ranges of lanes:
 *
 *   tmtpu_prep_ed25519   the lengths, s < L, A.y < p and h = SHA-512(R ||
 *                        A || M) mod L per lane, the host half of ed25519
 *                        verification (the cofactorless Go-stdlib verify:
 *                        crypto/ed25519's Verify; Go's scMinimal for s <
 *                        L), written as the kernel's [128, n] plane;
 *   tmtpu_sr_challenges  the merlin transcript walk of an sr25519
 *                        (schnorrkel) verify, k = challenge mod L per lane;
 *   tmtpu_prep_k1        the checks, SHA-256 and u1 = e/s, u2 = r/s mod n
 *                        of a low-S secp256k1 ECDSA verify, written as the
 *                        kernel's [168, n] plane;
 *
 * their arithmetic alone (tmtpu_reduce_mod_l and tmtpu_mod_n, which only
 * the tests call); and the verified-signature cache's store
 * (tmtpu_cache_*): a sharded, lock-striped LRU set of 32-byte keys, with
 * tmtpu_cache_resolve, which computes a flush's keys (SHA-256 of the
 * length-prefixed (curve, pk, msg, sig), byte-identical to
 * crypto/sigcache.py's ``cache_key``) on threads, looks each up and folds
 * the flush's repeated misses onto their first index, in one pass. Beside them, tmtpu_walk_verify, the sidecar's
 * walk of a VerifyRequest frame, which records where each field lies.
 *
 * A flush's keys, signatures and messages arrive as columns: one buffer
 * and int64 [lo, hi) offsets a lane (bytes_col), which may be the
 * sidecar's frame body itself, so no caller joins them first.
 *
 * Every prep output and key is a function of its lane's inputs alone, so
 * the bytes do not depend on the thread count. Pure C99 and POSIX threads;
 * built by tmtpu_torch/native/__init__.py with the system C compiler and
 * bound with ctypes. Byte order: the keccak state is permuted in place as
 * 25 little-endian 64-bit words, so the host must be little-endian
 * (x86-64, aarch64).
 */

#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Ranges of lanes on up to MAX_THREADS threads.                       */

#define MAX_THREADS 16

typedef void (*range_fn)(const void *ctx, size_t lo, size_t hi);

typedef struct {
    range_fn fn;
    const void *ctx;
    size_t lo, hi;
} range_job;

static void *range_worker(void *arg) {
    range_job *j = (range_job *)arg;
    j->fn(j->ctx, j->lo, j->hi);
    return NULL;
}

/* Split [0, n) into nthreads chunks; the last runs on the calling thread,
 * and a chunk whose thread cannot be started runs inline. */
static void run_ranges(size_t n, int nthreads, range_fn fn, const void *ctx) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > MAX_THREADS) nthreads = MAX_THREADS;
    if ((size_t)nthreads > n) nthreads = n ? (int)n : 1;
    size_t chunk = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    pthread_t tids[MAX_THREADS];
    range_job jobs[MAX_THREADS];
    int started = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t lo = (size_t)t * chunk;
        if (lo >= n) break;
        size_t hi = lo + chunk < n ? lo + chunk : n;
        jobs[t] = (range_job){fn, ctx, lo, hi};
        if (hi == n) {
            fn(ctx, lo, hi);
            break;
        }
        if (pthread_create(&tids[started], NULL, range_worker, &jobs[t]) != 0) {
            fn(ctx, lo, hi);
            continue;
        }
        started++;
    }
    for (int t = 0; t < started; t++) pthread_join(tids[t], NULL);
}

/* ------------------------------------------------------------------ */
/* Columns of byte strings: lane i is buf[lo[i], hi[i]).               */

typedef struct {
    const uint8_t *buf;
    const int64_t *lo, *hi;
} bytes_col;

static const uint8_t *col_at(const bytes_col *c, size_t i) { return c->buf + c->lo[i]; }

static size_t col_len(const bytes_col *c, size_t i) { return (size_t)(c->hi[i] - c->lo[i]); }

/* ------------------------------------------------------------------ */
/* SHA-512 (FIPS 180-4).                                               */

static const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

#define ROTR64(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

typedef struct {
    uint64_t h[8];
    uint8_t buf[128];
    size_t buflen;
    uint64_t total; /* message bytes so far */
} sha512_ctx;

static void sha512_init(sha512_ctx *c) {
    static const uint64_t iv[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    memcpy(c->h, iv, sizeof iv);
    c->buflen = 0;
    c->total = 0;
}

static uint64_t load_be64(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

static uint64_t load_le64(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
    return v;
}

static void sha512_block(uint64_t h[8], const uint8_t *p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) w[i] = load_be64(p + 8 * i);
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = ROTR64(w[i - 15], 1) ^ ROTR64(w[i - 15], 8) ^ (w[i - 15] >> 7);
        uint64_t s1 = ROTR64(w[i - 2], 19) ^ ROTR64(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], k = h[7];
    for (int i = 0; i < 80; i++) {
        uint64_t t1 = k + (ROTR64(e, 14) ^ ROTR64(e, 18) ^ ROTR64(e, 41)) +
                      ((e & f) ^ (~e & g)) + K512[i] + w[i];
        uint64_t t2 = (ROTR64(a, 28) ^ ROTR64(a, 34) ^ ROTR64(a, 39)) +
                      ((a & b) ^ (a & c) ^ (b & c));
        k = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

static void sha512_update(sha512_ctx *c, const uint8_t *p, size_t n) {
    c->total += n;
    if (c->buflen) {
        size_t take = 128 - c->buflen;
        if (take > n) take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take;
        p += take;
        n -= take;
        if (c->buflen < 128) return;
        sha512_block(c->h, c->buf);
        c->buflen = 0;
    }
    for (; n >= 128; p += 128, n -= 128) sha512_block(c->h, p);
    memcpy(c->buf, p, n);
    c->buflen = n;
}

static void sha512_final(sha512_ctx *c, uint8_t out[64]) {
    uint64_t bits = c->total * 8;
    c->buf[c->buflen++] = 0x80;
    if (c->buflen > 112) {
        memset(c->buf + c->buflen, 0, 128 - c->buflen);
        sha512_block(c->h, c->buf);
        c->buflen = 0;
    }
    memset(c->buf + c->buflen, 0, 120 - c->buflen); /* high 64 length bits 0 */
    for (int i = 0; i < 8; i++) c->buf[127 - i] = (uint8_t)(bits >> (8 * i));
    sha512_block(c->h, c->buf);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(c->h[i] >> (56 - 8 * j));
}

/* ------------------------------------------------------------------ */
/* SHA-256 (FIPS 180-4).                                               */

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROTR32(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

typedef struct {
    uint32_t h[8];
    uint8_t buf[64];
    size_t buflen;
    uint64_t total;
} sha256_ctx;

static void sha256_init(sha256_ctx *c) {
    static const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, iv, sizeof iv);
    c->buflen = 0;
    c->total = 0;
}

static void sha256_block(uint32_t h[8], const uint8_t *p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ROTR32(w[i - 15], 7) ^ ROTR32(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = ROTR32(w[i - 2], 17) ^ ROTR32(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], k = h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t t1 = k + (ROTR32(e, 6) ^ ROTR32(e, 11) ^ ROTR32(e, 25)) +
                      ((e & f) ^ (~e & g)) + K256[i] + w[i];
        uint32_t t2 = (ROTR32(a, 2) ^ ROTR32(a, 13) ^ ROTR32(a, 22)) +
                      ((a & b) ^ (a & c) ^ (b & c));
        k = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#include <cpuid.h>
#include <immintrin.h>
#define HAVE_SHA_NI 1

/* The same block with the x86 SHA extensions: the state as ABEF / CDGH,
 * two rounds an instruction, the message schedule by sha256msg1/2. */
__attribute__((target("sha,sse4.1"))) static void sha256_block_ni(uint32_t h[8],
                                                                  const uint8_t *p) {
    const __m128i bswap = _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i t = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&h[0]), 0xB1);
    __m128i s1 = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&h[4]), 0x1B);
    __m128i s0 = _mm_alignr_epi8(t, s1, 8);  /* ABEF */
    s1 = _mm_blend_epi16(s1, t, 0xF0);       /* CDGH */
    const __m128i abef = s0, cdgh = s1;
    __m128i w[4];
    for (int g = 0; g < 16; g++) {
        __m128i m;
        if (g < 4) {
            m = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(p + 16 * g)), bswap);
        } else { /* w[g & 3] holds words 4g-16.., the next three the later groups */
            m = _mm_sha256msg1_epu32(w[g & 3], w[(g + 1) & 3]);
            m = _mm_add_epi32(m, _mm_alignr_epi8(w[(g + 3) & 3], w[(g + 2) & 3], 4));
            m = _mm_sha256msg2_epu32(m, w[(g + 3) & 3]);
        }
        w[g & 3] = m;
        __m128i k = _mm_add_epi32(m, _mm_loadu_si128((const __m128i *)&K256[4 * g]));
        s1 = _mm_sha256rnds2_epu32(s1, s0, k);
        s0 = _mm_sha256rnds2_epu32(s0, s1, _mm_shuffle_epi32(k, 0x0E));
    }
    s0 = _mm_add_epi32(s0, abef);
    s1 = _mm_add_epi32(s1, cdgh);
    t = _mm_shuffle_epi32(s0, 0x1B);                          /* FEBA */
    s1 = _mm_shuffle_epi32(s1, 0xB1);                         /* DCHG */
    _mm_storeu_si128((__m128i *)&h[0], _mm_blend_epi16(t, s1, 0xF0)); /* A..D */
    _mm_storeu_si128((__m128i *)&h[4], _mm_alignr_epi8(s1, t, 8));    /* E..H */
}

static int cpu_has_sha_ni(void) {
    unsigned a, b, c, d;
    if (!__get_cpuid_count(7, 0, &a, &b, &c, &d) || !(b & (1u << 29))) return 0;
    return __get_cpuid(1, &a, &b, &c, &d) && (c & (1u << 19)); /* SSE4.1 */
}
#endif

/* The block function the cache keys use: the SHA extensions where the CPU
 * has them, else the portable one. Both give the same bytes. */
typedef void (*sha256_block_fn)(uint32_t h[8], const uint8_t *p);
static sha256_block_fn sha256_blocks = sha256_block;

/* Allow (1) or forbid (0) the SHA extensions; -1 only asks. Returns 1 if
 * the cache keys now use them. */
int tmtpu_sha256_ni(int allow) {
#ifdef HAVE_SHA_NI
    if (allow >= 0) sha256_blocks = allow && cpu_has_sha_ni() ? sha256_block_ni : sha256_block;
    return sha256_blocks == sha256_block_ni;
#else
    (void)allow;
    return 0;
#endif
}

#ifdef HAVE_SHA_NI
__attribute__((constructor)) static void sha256_pick(void) { tmtpu_sha256_ni(1); }
#endif

static void sha256_update(sha256_ctx *c, const uint8_t *p, size_t n) {
    c->total += n;
    if (c->buflen) {
        size_t take = 64 - c->buflen;
        if (take > n) take = n;
        memcpy(c->buf + c->buflen, p, take);
        c->buflen += take;
        p += take;
        n -= take;
        if (c->buflen < 64) return;
        sha256_blocks(c->h, c->buf);
        c->buflen = 0;
    }
    for (; n >= 64; p += 64, n -= 64) sha256_blocks(c->h, p);
    memcpy(c->buf, p, n);
    c->buflen = n;
}

static void sha256_final(sha256_ctx *c, uint8_t out[32]) {
    uint64_t bits = c->total * 8;
    c->buf[c->buflen++] = 0x80;
    if (c->buflen > 56) {
        memset(c->buf + c->buflen, 0, 64 - c->buflen);
        sha256_blocks(c->h, c->buf);
        c->buflen = 0;
    }
    memset(c->buf + c->buflen, 0, 56 - c->buflen);
    for (int i = 0; i < 8; i++) c->buf[63 - i] = (uint8_t)(bits >> (8 * i));
    sha256_blocks(c->h, c->buf);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(c->h[i] >> (24 - 8 * j));
}

/* ------------------------------------------------------------------ */
/* Reduction of a 512-bit little-endian value mod                      */
/* L = 2^252 + 27742317777372353535851937790883648493 (Barrett, b = 2^64). */

typedef unsigned __int128 u128;

static const uint64_t L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                                    0x0000000000000000ULL, 0x1000000000000000ULL};
/* mu = floor(2^512 / L) */
static const uint64_t MU[5] = {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
                               0xffffffffffffffebULL, 0xffffffffffffffffULL,
                               0x000000000000000fULL};

/* a >= b over n little-endian limbs */
static int geq_n(const uint64_t *a, const uint64_t *b, int n) {
    for (int i = n - 1; i >= 0; i--)
        if (a[i] != b[i]) return a[i] > b[i];
    return 1;
}

static void sub_n(uint64_t *a, const uint64_t *b, int n) {
    uint64_t borrow = 0;
    for (int i = 0; i < n; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
    }
}

static void mul_n(const uint64_t *a, int na, const uint64_t *b, int nb, uint64_t *out) {
    memset(out, 0, sizeof(uint64_t) * (size_t)(na + nb));
    for (int i = 0; i < na; i++) {
        uint64_t carry = 0;
        for (int j = 0; j < nb; j++) {
            u128 t = (u128)a[i] * b[j] + out[i + j] + carry;
            out[i + j] = (uint64_t)t;
            carry = (uint64_t)(t >> 64);
        }
        out[i + nb] = carry;
    }
}

/* 64 bytes little-endian -> 32 bytes little-endian, reduced mod L. With
 * x = q1 2^192 + x0 (x0 < 2^192) and mu = 2^512 / L - d, d = 0.22492 the
 * fraction of 2^512 / L, the estimate q^ = floor(q1 mu / 2^320) falls
 * short of x / L by x0 / L + q1 d / 2^320 < 2^-60 + 0.2250 < 1, so q^ is
 * the true quotient q or q - 1 (and never above it): r = x - q^ L < 2L
 * and one subtraction of L suffices. The loop stays correct whatever the
 * bound; tests/test_torch_native.py derives the bound from the constants
 * above. */
static void reduce_mod_l(const uint8_t in[64], uint8_t out[32]) {
    uint64_t x[8], t[10], ql[9], r[8];
    for (int k = 0; k < 8; k++) x[k] = load_le64(in + 8 * k);
    mul_n(x + 3, 5, MU, 5, t);
    mul_n(t + 5, 5, L_LIMBS, 4, ql);
    memcpy(r, x, sizeof r);
    sub_n(r, ql, 8); /* r < 2L < 2^254: limbs 4..7 cancel */
    while (geq_n(r, L_LIMBS, 4)) sub_n(r, L_LIMBS, 4);
    for (int k = 0; k < 4; k++)
        for (int b = 0; b < 8; b++) out[8 * k + b] = (uint8_t)(r[k] >> (8 * b));
}

/* For the tests only: n 64-byte little-endian values in, each reduced mod
 * L to 32 bytes out. The prep entries call reduce_mod_l directly. */
void tmtpu_reduce_mod_l(size_t n, const uint8_t *in, uint8_t *out) {
    for (size_t i = 0; i < n; i++) reduce_mod_l(in + 64 * i, out + 32 * i);
}

/* ------------------------------------------------------------------ */
/* ed25519: the kernel's plane of every lane.                          */

typedef struct {
    size_t n;
    bytes_col pks, sigs, msgs;
    uint8_t *packed, *ok;
} ed_ctx;

/* 32 bytes into rows [row, row + 32) of lane i's column of a plane of n
 * lanes. */
static void put_col(uint8_t *packed, size_t n, size_t i, int row, const uint8_t b[32]) {
    for (int k = 0; k < 32; k++) packed[(size_t)(row + k) * n + i] = b[k];
}

static void ed_range(const void *arg, size_t lo, size_t hi) {
    static const uint8_t zero[64];
    const ed_ctx *c = (const ed_ctx *)arg;
    for (size_t i = lo; i < hi; i++) {
        int len_ok = col_len(&c->pks, i) == 32 && col_len(&c->sigs, i) == 64;
        const uint8_t *pk = len_ok ? col_at(&c->pks, i) : zero;
        const uint8_t *sig = len_ok ? col_at(&c->sigs, i) : zero;
        sha512_ctx sc;
        uint8_t digest[64], h[32];
        sha512_init(&sc);
        sha512_update(&sc, sig, 32);
        sha512_update(&sc, pk, 32);
        sha512_update(&sc, col_at(&c->msgs, i), col_len(&c->msgs, i));
        sha512_final(&sc, digest);
        reduce_mod_l(digest, h);
        uint64_t s[4];
        for (int k = 0; k < 4; k++) s[k] = load_le64(sig + 32 + 8 * k);
        int keep = len_ok && !geq_n(s, L_LIMBS, 4);
        /* A.y < p on the sign-masked encoding: p = 2^255 - 19 */
        int y_ok = pk[0] < 0xED || (pk[31] & 0x7F) != 0x7F;
        for (int k = 1; k < 31 && !y_ok; k++) y_ok = pk[k] != 0xFF;
        c->ok[i] = (uint8_t)(keep && y_ok);
        put_col(c->packed, c->n, i, 0, pk);
        put_col(c->packed, c->n, i, 32, sig);
        put_col(c->packed, c->n, i, 64, keep ? sig + 32 : zero);
        put_col(c->packed, c->n, i, 96, h);
    }
}

/* Per lane: a key of 32 bytes and a signature of 64 (else both read as
 * zero bytes), h = SHA-512(R || A || M) mod L, s < L, and A.y < p.
 * packed_out: [128, n] row-major, lane i's column pk | r | s | h, s zero
 * where the lengths or s < L refuse the lane; ok_out: n bytes, 1 where
 * every check accepts it. */
void tmtpu_prep_ed25519(size_t n, const uint8_t *pkbuf, const int64_t *pklo,
                        const int64_t *pkhi, const uint8_t *sigbuf, const int64_t *siglo,
                        const int64_t *sighi, const uint8_t *mbuf, const int64_t *mlo,
                        const int64_t *mhi, uint8_t *packed_out, uint8_t *ok_out,
                        int nthreads) {
    ed_ctx c = {n, {pkbuf, pklo, pkhi}, {sigbuf, siglo, sighi}, {mbuf, mlo, mhi},
                packed_out, ok_out};
    run_ranges(n, nthreads, ed_range, &c);
}

/* ------------------------------------------------------------------ */
/* Arithmetic mod the secp256k1 group order                            */
/* n = 2^256 - NC, NC = 2^256 - n < 2^129 (4 x 64-bit limbs, folding). */

static const uint64_t N_LIMBS[4] = {0xbfd25e8cd0364141ULL, 0xbaaedce6af48a03bULL,
                                    0xfffffffffffffffeULL, 0xffffffffffffffffULL};
/* floor(n / 2): the low-S rule's largest s */
static const uint64_t HALF_N[4] = {0xdfe92f46681b20a0ULL, 0x5d576e7357a4501dULL,
                                   0xffffffffffffffffULL, 0x7fffffffffffffffULL};
static const uint64_t NC[3] = {0x402da1732fc9bebfULL, 0x4551231950b75fc4ULL,
                               0x0000000000000001ULL};
/* the field prime p = 2^256 - 2^32 - 977 */
static const uint64_t P_LIMBS[4] = {0xfffffffefffffc2fULL, 0xffffffffffffffffULL,
                                    0xffffffffffffffffULL, 0xffffffffffffffffULL};

/* One fold of t = lo + hi 2^256, hi the nhi limbs t[4 .. 4 + nhi): t =
 * lo + hi NC, which is t mod n, since 2^256 = NC mod n. The sum's carries
 * stay inside t's eight limbs: hi NC < 2^(64 nhi + 129). */
static void fold_n(uint64_t t[8], int nhi) {
    uint64_t hi[4];
    memcpy(hi, t + 4, (size_t)nhi * sizeof *hi);
    memset(t + 4, 0, (size_t)nhi * sizeof *t);
    for (int i = 0; i < nhi; i++) {
        uint64_t carry = 0;
        for (int j = 0; j < 3; j++) {
            u128 s = (u128)hi[i] * NC[j] + t[i + j] + carry;
            t[i + j] = (uint64_t)s;
            carry = (uint64_t)(s >> 64);
        }
        for (int k = i + 3; carry && k < 8; k++) {
            u128 s = (u128)t[k] + carry;
            t[k] = (uint64_t)s;
            carry = (uint64_t)(s >> 64);
        }
    }
}

/* t (8 limbs, any value below 2^512) mod n into r (4 limbs); t is used as
 * scratch. From t < 2^512, the first fold leaves t < 2^256 (NC + 1) <
 * 2^386 (limbs 0-6), the second t < 2^256 + NC^2 < 2^258 (limbs 0-4), the
 * third t < 2^256 + 2 NC; a fourth is needed only where that left limb 4
 * at 1, and then the low limbs hold less than 2 NC, so t < 3 NC < 2^256.
 * At most four folds, and t < 2^256 < 2n leaves at most one subtraction
 * of n; the loops stay correct whatever the bounds past the second fold.
 * tests/test_torch_native.py derives them from the constants above. */
static void reduce_mod_n(uint64_t t[8], uint64_t r[4]) {
    fold_n(t, 4);
    fold_n(t, 3);
    while (t[4]) fold_n(t, 1);
    while (geq_n(t, N_LIMBS, 4)) sub_n(t, N_LIMBS, 4);
    memcpy(r, t, 4 * sizeof *t);
}

/* r = a b mod n for any a, b below 2^256; r may alias a or b. */
static void mul_mod_n(const uint64_t a[4], const uint64_t b[4], uint64_t r[4]) {
    uint64_t t[8];
    mul_n(a, 4, b, 4, t);
    reduce_mod_n(t, r);
}

/* r = a^(n - 2) mod n, the inverse of a where a mod n is not 0 (Fermat;
 * variable time: verification handles public data). */
static void inv_mod_n(const uint64_t a[4], uint64_t r[4]) {
    uint64_t e[4], acc[4] = {1, 0, 0, 0};
    memcpy(e, N_LIMBS, sizeof e);
    e[0] -= 2; /* the low limb of n is above 2 */
    for (int i = 255; i >= 0; i--) {
        mul_mod_n(acc, acc, acc);
        if ((e[i / 64] >> (i % 64)) & 1) mul_mod_n(acc, a, acc);
    }
    memcpy(r, acc, sizeof acc);
}

static void be32_to_limbs(const uint8_t in[32], uint64_t v[4]) {
    for (int k = 0; k < 4; k++) v[k] = load_be64(in + 8 * (3 - k));
}

static void limbs_to_be32(const uint64_t v[4], uint8_t out[32]) {
    for (int k = 0; k < 32; k++) out[k] = (uint8_t)(v[3 - k / 8] >> (56 - 8 * (k % 8)));
}

/* For the tests only: n 64-byte big-endian values x in; x mod n and
 * (x mod n)^-1 (0 where x mod n is 0) out, 32 bytes big-endian each. The
 * prep reduces its products with reduce_mod_n through mul_mod_n. */
void tmtpu_mod_n(size_t n, const uint8_t *in, uint8_t *red_out, uint8_t *inv_out) {
    for (size_t i = 0; i < n; i++) {
        uint64_t t[8], r[4];
        for (int k = 0; k < 8; k++) t[k] = load_be64(in + 64 * i + 8 * (7 - k));
        reduce_mod_n(t, r);
        limbs_to_be32(r, red_out + 32 * i);
        inv_mod_n(r, r);
        limbs_to_be32(r, inv_out + 32 * i);
    }
}

/* ------------------------------------------------------------------ */
/* secp256k1: the host half of the low-S ECDSA verify.                 */

#define K1_ROWS 168
#define K1_PARITY_ROW 160
/* The fewest lanes a thread's range takes: a range pays one inversion mod n
 * and its thread's start, which cost as much as a few hundred lanes. */
#define K1_MIN_RANGE 512

typedef struct {
    size_t n;
    bytes_col pks, sigs, msgs;
    uint8_t *packed, *ok;
    uint64_t *prefix; /* n rows of 4 limbs: the batch inversion's products */
} k1_ctx;

/* 32 big-endian bytes into rows [row, row + 32) of lane i's column. */
static void k1_put(const k1_ctx *c, size_t i, int row, const uint8_t be[32]) {
    put_col(c->packed, c->n, i, row, be);
}

/* Lane i's key and signature, or zero bytes for both where either has the
 * wrong length (the prefix check then refuses the lane). */
static int k1_len_ok(const k1_ctx *c, size_t i) {
    return col_len(&c->pks, i) == 33 && col_len(&c->sigs, i) == 64;
}

static const uint8_t *k1_pk(const k1_ctx *c, size_t i) {
    static const uint8_t zero[33];
    return k1_len_ok(c, i) ? col_at(&c->pks, i) : zero;
}

static const uint8_t *k1_sig(const k1_ctx *c, size_t i) {
    static const uint8_t zero[64];
    return k1_len_ok(c, i) ? col_at(&c->sigs, i) : zero;
}

static int is_zero4(const uint64_t v[4]) { return !(v[0] | v[1] | v[2] | v[3]); }

/* One range's lanes: the checks, and for the lanes they accept the plane's
 * columns, with w = s^-1 mod n from Montgomery's batch inversion over the
 * range (prefix products, one inversion, the backward sweep). A refused
 * lane stays out of the products. The inverse is unique, so the bytes do
 * not depend on the ranges. */
static void k1_range(const void *arg, size_t lo, size_t hi) {
    static const uint8_t zero[32], one[32] = {[31] = 1};
    const k1_ctx *c = (const k1_ctx *)arg;
    uint64_t acc[4] = {1, 0, 0, 0};
    for (size_t i = lo; i < hi; i++) {
        const uint8_t *pk = k1_pk(c, i), *sig = k1_sig(c, i);
        uint64_t x[4], r[4], s[4];
        be32_to_limbs(pk + 1, x);
        be32_to_limbs(sig, r);
        be32_to_limbs(sig + 32, s);
        int ok = (pk[0] == 2 || pk[0] == 3) && !geq_n(x, P_LIMBS, 4) && !is_zero4(r) &&
                 !geq_n(r, N_LIMBS, 4) && !is_zero4(s) && geq_n(HALF_N, s, 4);
        c->ok[i] = (uint8_t)ok;
        c->packed[(size_t)K1_PARITY_ROW * c->n + i] = pk[0] & 1;
        for (int k = K1_PARITY_ROW + 1; k < K1_ROWS; k++) c->packed[(size_t)k * c->n + i] = 0;
        if (!ok) { /* x = 0, u1 = u2 = r = rpn = 1 */
            k1_put(c, i, 0, zero);
            for (int row = 32; row < K1_PARITY_ROW; row += 32) k1_put(c, i, row, one);
            continue;
        }
        k1_put(c, i, 0, pk + 1);
        k1_put(c, i, 96, sig);
        uint64_t rpn[4];
        memcpy(rpn, r, sizeof rpn);
        uint64_t carry = 0; /* rpn = r + n where that is below p, else r */
        for (int k = 0; k < 4; k++) {
            u128 t = (u128)rpn[k] + N_LIMBS[k] + carry;
            rpn[k] = (uint64_t)t;
            carry = (uint64_t)(t >> 64);
        }
        uint8_t be[32];
        if (!carry && !geq_n(rpn, P_LIMBS, 4)) {
            limbs_to_be32(rpn, be);
            k1_put(c, i, 128, be);
        } else {
            k1_put(c, i, 128, sig);
        }
        memcpy(c->prefix + 4 * i, acc, sizeof acc);
        mul_mod_n(acc, s, acc);
    }
    uint64_t inv[4];
    inv_mod_n(acc, inv); /* acc is 1 where the range accepted no lane */
    for (size_t i = hi; i-- > lo;) {
        if (!c->ok[i]) continue;
        const uint8_t *sig = k1_sig(c, i);
        uint64_t w[4], s[4], r[4], e[4], u[4];
        mul_mod_n(inv, c->prefix + 4 * i, w);
        be32_to_limbs(sig + 32, s);
        mul_mod_n(inv, s, inv);
        sha256_ctx sc;
        uint8_t be[32];
        sha256_init(&sc);
        sha256_update(&sc, col_at(&c->msgs, i), col_len(&c->msgs, i));
        sha256_final(&sc, be);
        be32_to_limbs(be, e);
        mul_mod_n(e, w, u);
        limbs_to_be32(u, be);
        k1_put(c, i, 32, be);
        be32_to_limbs(sig, r);
        mul_mod_n(r, w, u);
        limbs_to_be32(u, be);
        k1_put(c, i, 64, be);
    }
}

/* Per lane: a key of 33 bytes and a signature of 64 (r || s, big-endian;
 * else both read as zero bytes), the SEC 1 prefix is 2 or 3 and x < p, r
 * is in [1, n - 1], s in [1, n / 2] (low-S); e = SHA-256(msg), w = s^-1,
 * u1 = e w, u2 = r w mod n, rpn = r + n where that is below p, else r.
 * Keys, signatures and messages are columns (buf, lo, hi). packed_out:
 * [168, n] row-major, lane i's column pkx | u1 | u2 | r | rpn as
 * big-endian 32-byte rows, the prefix's parity in row 160 and rows
 * 161-167 zero; a refused lane gets x = 0, u1 = u2 = r = rpn = 1 and its
 * prefix's parity. ok_out: n bytes, 1 where the checks accept the lane. On nthreads threads, or fewer where a range
 * would hold under K1_MIN_RANGE lanes. Returns 0, or -1 when out of
 * memory. */
int64_t tmtpu_prep_k1(size_t n, const uint8_t *pkbuf, const int64_t *pklo,
                      const int64_t *pkhi, const uint8_t *sigbuf, const int64_t *siglo,
                      const int64_t *sighi, const uint8_t *mbuf, const int64_t *mlo,
                      const int64_t *mhi, uint8_t *packed_out, uint8_t *ok_out,
                      int nthreads) {
    if (!n) return 0;
    uint64_t *prefix = malloc(n * 4 * sizeof *prefix);
    if (!prefix) return -1;
    k1_ctx c = {n, {pkbuf, pklo, pkhi}, {sigbuf, siglo, sighi}, {mbuf, mlo, mhi},
                packed_out, ok_out, prefix};
    size_t most = (n + K1_MIN_RANGE - 1) / K1_MIN_RANGE;
    run_ranges(n, (size_t)nthreads < most ? nthreads : (int)most, k1_range, &c);
    free(prefix);
    return 0;
}

/* ------------------------------------------------------------------ */
/* keccak-f[1600], STROBE-128 and the merlin transcript.               */

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

#define ROL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static void keccak_f1600(uint64_t st[25]) {
    /* rho offsets and pi lane order along the pi cycle starting at lane 1 */
    static const int rho[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
                                27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
    static const int pi[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
                               15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
    uint64_t bc[5];
    for (int round = 0; round < 24; round++) {
        for (int x = 0; x < 5; x++)
            bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
        for (int x = 0; x < 5; x++) {
            uint64_t d = bc[(x + 4) % 5] ^ ROL64(bc[(x + 1) % 5], 1);
            for (int y = 0; y < 25; y += 5) st[y + x] ^= d;
        }
        uint64_t carry = st[1];
        for (int i = 0; i < 24; i++) {
            uint64_t next = st[pi[i]];
            st[pi[i]] = ROL64(carry, rho[i]);
            carry = next;
        }
        for (int y = 0; y < 25; y += 5) {
            for (int x = 0; x < 5; x++) bc[x] = st[y + x];
            for (int x = 0; x < 5; x++) st[y + x] = bc[x] ^ (~bc[(x + 1) % 5] & bc[(x + 2) % 5]);
        }
        st[0] ^= KECCAK_RC[round];
    }
}

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A (1 << 1)
#define FLAG_C (1 << 2)
#define FLAG_M (1 << 4)
#define FLAG_K (1 << 5)

typedef struct {
    union {
        uint8_t b[200];
        uint64_t w[25];
    } st;
    uint8_t pos, pos_begin;
} strobe128;

static void strobe_run_f(strobe128 *s) {
    s->st.b[s->pos] ^= s->pos_begin;
    s->st.b[s->pos + 1] ^= 0x04;
    s->st.b[STROBE_R + 1] ^= 0x80;
    keccak_f1600(s->st.w);
    s->pos = 0;
    s->pos_begin = 0;
}

static void strobe_absorb(strobe128 *s, const uint8_t *d, size_t n) {
    for (size_t i = 0; i < n; i++) {
        s->st.b[s->pos++] ^= d[i];
        if (s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_squeeze(strobe128 *s, uint8_t *out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        out[i] = s->st.b[s->pos];
        s->st.b[s->pos++] = 0;
        if (s->pos == STROBE_R) strobe_run_f(s);
    }
}

/* begin an operation (never a continuation: merlin uses none) */
static void strobe_begin(strobe128 *s, uint8_t flags) {
    uint8_t hdr[2] = {s->pos_begin, flags};
    s->pos_begin = (uint8_t)(s->pos + 1);
    strobe_absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) strobe_run_f(s);
}

static void strobe_init(strobe128 *s, const char *label) {
    static const uint8_t hdr[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
    memset(s->st.b, 0, sizeof s->st.b);
    memcpy(s->st.b, hdr, 6);
    memcpy(s->st.b + 6, "STROBEv1.0.2", 12);
    keccak_f1600(s->st.w);
    s->pos = 0;
    s->pos_begin = 0;
    strobe_begin(s, FLAG_M | FLAG_A);
    strobe_absorb(s, (const uint8_t *)label, strlen(label));
}

/* merlin: meta-AD(label || le32(n)), then AD(message) or PRF(n) */
static void merlin_meta(strobe128 *s, const char *label, size_t n) {
    uint8_t le[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16), (uint8_t)(n >> 24)};
    strobe_begin(s, FLAG_M | FLAG_A);
    strobe_absorb(s, (const uint8_t *)label, strlen(label));
    strobe_absorb(s, le, 4);
}

static void merlin_append(strobe128 *s, const char *label, const uint8_t *msg, size_t n) {
    merlin_meta(s, label, n);
    strobe_begin(s, FLAG_A);
    strobe_absorb(s, msg, n);
}

static void merlin_challenge(strobe128 *s, const char *label, uint8_t *out, size_t n) {
    merlin_meta(s, label, n);
    strobe_begin(s, FLAG_I | FLAG_A | FLAG_C);
    strobe_squeeze(s, out, n);
}

/* ------------------------------------------------------------------ */
/* sr25519: the challenge k of schnorrkel's verify.                    */

typedef struct {
    const strobe128 *base; /* the transcript up to the message */
    const uint8_t *pks, *rs;
    bytes_col msgs;
    uint8_t *k_out;
} sr_ctx;

static void sr_range(const void *arg, size_t lo, size_t hi) {
    const sr_ctx *c = (const sr_ctx *)arg;
    for (size_t i = lo; i < hi; i++) {
        strobe128 s = *c->base;
        uint8_t wide[64];
        merlin_append(&s, "sign-bytes", col_at(&c->msgs, i), col_len(&c->msgs, i));
        merlin_append(&s, "proto-name", (const uint8_t *)"Schnorr-sig", 11);
        merlin_append(&s, "sign:pk", c->pks + 32 * i, 32);
        merlin_append(&s, "sign:R", c->rs + 32 * i, 32);
        merlin_challenge(&s, "sign:c", wide, 64);
        reduce_mod_l(wide, c->k_out + 32 * i);
    }
}

/* Per lane: t = merlin("SigningContext"); t.append("", "");
 * t.append("sign-bytes", msg); t.append("proto-name", "Schnorr-sig");
 * t.append("sign:pk", pk); t.append("sign:R", r);
 * k = challenge_bytes("sign:c", 64) mod L. pks, rs: n rows of 32 bytes;
 * the messages a column (buf, lo, hi). k_out: n rows of 32 bytes. */
void tmtpu_sr_challenges(size_t n, const uint8_t *pks, const uint8_t *rs,
                         const uint8_t *mbuf, const int64_t *mlo, const int64_t *mhi,
                         uint8_t *k_out, int nthreads) {
    strobe128 base;
    strobe_init(&base, "Merlin v1.0");
    merlin_append(&base, "dom-sep", (const uint8_t *)"SigningContext", 14);
    merlin_append(&base, "", (const uint8_t *)"", 0);
    sr_ctx c = {&base, pks, rs, {mbuf, mlo, mhi}, k_out};
    run_ranges(n, nthreads, sr_range, &c);
}

/* ------------------------------------------------------------------ */
/* Signature cache: keys, store, resolve.                              */

typedef struct {
    bytes_col names;          /* the flush's distinct curve names */
    const int32_t *kind;      /* lane i's name; NULL: name 0 for every lane */
    bytes_col fields[3];      /* pks, msgs, sigs */
    uint8_t *keys_out;
} key_ctx;

static void key_part(sha256_ctx *sc, const bytes_col *col, size_t i) {
    uint64_t len = col_len(col, i);
    uint8_t be[4] = {(uint8_t)(len >> 24), (uint8_t)(len >> 16), (uint8_t)(len >> 8),
                     (uint8_t)len};
    sha256_update(sc, be, 4);
    sha256_update(sc, col_at(col, i), (size_t)len);
}

static void key_range(const void *arg, size_t lo, size_t hi) {
    const key_ctx *c = (const key_ctx *)arg;
    for (size_t i = lo; i < hi; i++) {
        sha256_ctx sc;
        sha256_init(&sc);
        key_part(&sc, &c->names, c->kind ? (size_t)c->kind[i] : 0);
        for (int f = 0; f < 3; f++) key_part(&sc, &c->fields[f], i);
        sha256_final(&sc, c->keys_out + 32 * i);
    }
}

/* Keys are SHA-256 outputs: byte 0 picks the shard, bytes 4..7 the bucket
 * and bytes 8..11 the slot of the resolve's in-flush table. */
static uint32_t key_word(const uint8_t *k, int at) {
    uint32_t w;
    memcpy(&w, k + at, 4);
    return w;
}

typedef struct {
    uint8_t key[32];
    int32_t older, newer; /* recency list, oldest first; -1 ends it */
    int32_t chain;        /* next entry of the same bucket; -1 ends it */
} cache_entry;

/* Live entries are always slots [0, size): a slot is appended while the
 * shard is under its cap and reused by the eviction that makes room once
 * it is full; only clear and a shrink take entries out, and both compact. */
typedef struct {
    pthread_mutex_t lock;
    cache_entry *e;
    int32_t *bucket;
    uint32_t nbucket; /* a power of two, or 0 before the first insert */
    int32_t alloc, size, oldest, newest;
} cache_shard;

typedef struct {
    uint32_t mask;   /* shards - 1; shards is a power of two */
    int32_t cap;     /* entries a shard holds */
    cache_shard *s;
} sig_cache;

static int32_t shard_find(const cache_shard *s, const uint8_t *key) {
    if (!s->nbucket) return -1;
    int32_t i = s->bucket[key_word(key, 4) & (s->nbucket - 1)];
    while (i >= 0 && memcmp(s->e[i].key, key, 32)) i = s->e[i].chain;
    return i;
}

static void lru_unlink(cache_shard *s, int32_t i) {
    cache_entry *x = &s->e[i];
    if (x->older >= 0) s->e[x->older].newer = x->newer; else s->oldest = x->newer;
    if (x->newer >= 0) s->e[x->newer].older = x->older; else s->newest = x->older;
}

static void lru_push(cache_shard *s, int32_t i) {
    s->e[i].older = s->newest;
    s->e[i].newer = -1;
    if (s->newest >= 0) s->e[s->newest].newer = i; else s->oldest = i;
    s->newest = i;
}

static void chain_push(cache_shard *s, int32_t i) {
    int32_t *head = &s->bucket[key_word(s->e[i].key, 4) & (s->nbucket - 1)];
    s->e[i].chain = *head;
    *head = i;
}

static void chain_remove(cache_shard *s, int32_t i) {
    int32_t *at = &s->bucket[key_word(s->e[i].key, 4) & (s->nbucket - 1)];
    while (*at != i) at = &s->e[*at].chain;
    *at = s->e[i].chain;
}

/* Room for at least one more slot (up to cap): doubles the slots and
 * keeps twice as many buckets, rehashing the live entries. 0 or -1 when
 * out of memory. */
static int shard_grow(cache_shard *s, int32_t cap) {
    int64_t want = s->alloc ? 2 * (int64_t)s->alloc : 64;
    if (want > cap) want = cap;
    cache_entry *e = realloc(s->e, (size_t)want * sizeof *e);
    if (!e) return -1;
    s->e = e;
    s->alloc = (int32_t)want;
    uint32_t nb = s->nbucket ? s->nbucket : 64;
    while ((int64_t)nb < 2 * want) nb *= 2;
    if (nb != s->nbucket) {
        int32_t *b = realloc(s->bucket, (size_t)nb * sizeof *b);
        if (!b) return -1;
        s->bucket = b;
        s->nbucket = nb;
        memset(b, 0xff, (size_t)nb * sizeof *b);
        for (int32_t i = 0; i < s->size; i++) chain_push(s, i);
    }
    return 0;
}

/* Insert or refresh one key: 1 if it was new, 0 if it was there, -1 when
 * out of memory. A full shard first evicts its least recently used key. */
static int shard_insert(cache_shard *s, int32_t cap, const uint8_t *key, int64_t *evicted) {
    int32_t i = shard_find(s, key);
    if (i >= 0) {
        lru_unlink(s, i);
        lru_push(s, i);
        return 0;
    }
    if (s->size < cap) {
        if (s->size == s->alloc && shard_grow(s, cap)) return -1;
        i = s->size++;
    } else {
        i = s->oldest;
        lru_unlink(s, i);
        chain_remove(s, i);
        (*evicted)++;
    }
    memcpy(s->e[i].key, key, 32);
    chain_push(s, i);
    lru_push(s, i);
    return 1;
}

static int shard_lookup(cache_shard *s, const uint8_t *key) {
    pthread_mutex_lock(&s->lock);
    int32_t i = shard_find(s, key);
    if (i >= 0) {
        lru_unlink(s, i);
        lru_push(s, i);
    }
    pthread_mutex_unlock(&s->lock);
    return i >= 0;
}

static void shard_reset(cache_shard *s) {
    free(s->e);
    free(s->bucket);
    s->e = NULL;
    s->bucket = NULL;
    s->nbucket = 0;
    s->alloc = s->size = 0;
    s->oldest = s->newest = -1;
}

/* A store of ``shards`` (a power of two) LRU shards of ``cap`` keys each;
 * NULL when out of memory. */
void *tmtpu_cache_new(int32_t shards, int32_t cap) {
    sig_cache *c = calloc(1, sizeof *c);
    if (!c) return NULL;
    c->s = calloc((size_t)shards, sizeof *c->s);
    if (!c->s) {
        free(c);
        return NULL;
    }
    c->mask = (uint32_t)shards - 1;
    c->cap = cap;
    for (int32_t k = 0; k < shards; k++) {
        pthread_mutex_init(&c->s[k].lock, NULL);
        shard_reset(&c->s[k]);
    }
    return c;
}

void tmtpu_cache_free(void *h) {
    sig_cache *c = h;
    for (uint32_t k = 0; k <= c->mask; k++) {
        shard_reset(&c->s[k]);
        pthread_mutex_destroy(&c->s[k].lock);
    }
    free(c->s);
    free(c);
}

/* Drop every entry and free the shards' memory. */
void tmtpu_cache_clear(void *h) {
    sig_cache *c = h;
    for (uint32_t k = 0; k <= c->mask; k++) {
        pthread_mutex_lock(&c->s[k].lock);
        shard_reset(&c->s[k]);
        pthread_mutex_unlock(&c->s[k].lock);
    }
}

int64_t tmtpu_cache_size(void *h) {
    sig_cache *c = h;
    int64_t n = 0;
    for (uint32_t k = 0; k <= c->mask; k++) {
        pthread_mutex_lock(&c->s[k].lock);
        n += c->s[k].size;
        pthread_mutex_unlock(&c->s[k].lock);
    }
    return n;
}

/* A new cap for every shard; a shard over it keeps its ``cap`` most
 * recently used keys, in their order. Returns the keys evicted, or -1 when
 * out of memory (the shards already done keep the new cap). */
int64_t tmtpu_cache_resize(void *h, int32_t cap) {
    sig_cache *c = h;
    int64_t evicted = 0;
    c->cap = cap;
    for (uint32_t k = 0; k <= c->mask; k++) {
        cache_shard *s = &c->s[k];
        pthread_mutex_lock(&s->lock);
        int32_t keep = s->size < cap ? s->size : cap;
        int32_t drop = s->size - keep;
        uint8_t *keys = keep ? malloc((size_t)keep * 32) : NULL;
        if (keep && !keys) {
            pthread_mutex_unlock(&s->lock);
            return -1;
        }
        int32_t i = s->oldest;
        for (int32_t j = 0; j < drop; j++) i = s->e[i].newer;
        for (int32_t j = 0; j < keep; j++, i = s->e[i].newer) memcpy(keys + 32 * j, s->e[i].key, 32);
        shard_reset(s);
        int64_t none = 0;
        int rc = 0;
        for (int32_t j = 0; j < keep && rc >= 0; j++) rc = shard_insert(s, cap, keys + 32 * j, &none);
        free(keys);
        pthread_mutex_unlock(&s->lock);
        if (rc < 0) return -1;
        evicted += drop;
    }
    return evicted;
}

/* Look up n keys in order; a hit refreshes its key's recency. hit_out:
 * n bytes, 1 for a hit. Returns the hits. */
int64_t tmtpu_cache_lookup(void *h, size_t n, const uint8_t *keys, uint8_t *hit_out) {
    sig_cache *c = h;
    int64_t hits = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t *k = keys + 32 * i;
        hit_out[i] = (uint8_t)shard_lookup(&c->s[k[0] & c->mask], k);
        hits += hit_out[i];
    }
    return hits;
}

/* Insert n keys in order; a key already there is refreshed. Returns the
 * keys that were new, or -1 when out of memory; *evicted counts the
 * evictions. */
int64_t tmtpu_cache_add(void *h, size_t n, const uint8_t *keys, int64_t *evicted) {
    sig_cache *c = h;
    int64_t inserted = 0;
    *evicted = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t *k = keys + 32 * i;
        cache_shard *s = &c->s[k[0] & c->mask];
        pthread_mutex_lock(&s->lock);
        int rc = shard_insert(s, c->cap, k, evicted);
        pthread_mutex_unlock(&s->lock);
        if (rc < 0) return -1;
        inserted += rc;
    }
    return inserted;
}

/* One flush's resolve. keys_out[i] = SHA-256(be32(len t) t be32(len pk) pk
 * be32(len m) m be32(len s) s) of lane i, t its curve's name: name
 * kind[i] of the columns names (buf, lo, hi), or name 0 for every lane
 * where kind is NULL; pk, m and s from their columns (buf, lo, hi); every
 * field shorter than 2^32 bytes (on ``nthreads`` threads). Then, in lane
 * order, each key is looked up in the store ``h`` (a hit refreshes it; h
 * NULL: no lookups, every lane a miss): rep_out[i]
 * is -1 for a hit, else the first lane of the flush that missed with the
 * same key (i itself for the first). Returns the hits, or -1 when out of
 * memory. */
int64_t tmtpu_cache_resolve(void *h, size_t n, const uint8_t *namebuf,
                            const int64_t *namelo, const int64_t *namehi,
                            const int32_t *kind, const uint8_t *pkbuf, const int64_t *pklo,
                            const int64_t *pkhi, const uint8_t *mbuf, const int64_t *mlo,
                            const int64_t *mhi, const uint8_t *sigbuf, const int64_t *siglo,
                            const int64_t *sighi, uint8_t *keys_out, int32_t *rep_out,
                            int nthreads) {
    key_ctx kc = {{namebuf, namelo, namehi},
                  kind,
                  {{pkbuf, pklo, pkhi}, {mbuf, mlo, mhi}, {sigbuf, siglo, sighi}},
                  keys_out};
    run_ranges(n, nthreads, key_range, &kc);
    size_t nslot = 16;
    while (nslot < 2 * n) nslot *= 2;
    int32_t *slot = malloc(nslot * sizeof *slot);
    if (!slot) return -1;
    memset(slot, 0xff, nslot * sizeof *slot);
    sig_cache *c = h;
    int64_t hits = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t *k = keys_out + 32 * i;
        if (c && shard_lookup(&c->s[k[0] & c->mask], k)) {
            rep_out[i] = -1;
            hits++;
            continue;
        }
        size_t j = key_word(k, 8) & (nslot - 1);
        while (slot[j] >= 0 && memcmp(keys_out + 32 * (size_t)slot[j], k, 32))
            j = (j + 1) & (nslot - 1);
        if (slot[j] < 0) slot[j] = (int32_t)i;
        rep_out[i] = slot[j];
    }
    free(slot);
    return hits;
}

/* ------------------------------------------------------------------ */
/* The sidecar's VerifyRequest walk.                                   */

/* sidecar/protocol.py's _walk_verify_request in C, recording where each
 * field lies. The rules are the Python walk's: a known field is read by
 * its declared type whatever its wire type, the last of a repeated field
 * wins, unknown fields are skipped by wire type (a fixed64, fixed32 or
 * length skip that runs past the end just ends the loop), and a lane is
 * read within its own length. Every read is checked against the lane's or
 * the body's end: the frame comes from the network. Whatever the walk does
 * not take (a cut field, wire type 3, 4, 6 or 7, a varint over 64 bits, a
 * curve before the last one holding a non-ASCII byte, which Python would
 * decode as UTF-8) returns WV_DEFER, and the caller runs the Python walk
 * on the same body for its result or its exact error. */

#define WV_DEFER (-1)

/* A uvarint from [*pos, end) that fits in 64 bits, else WV_DEFER. */
static int wv_uvarint(const uint8_t *b, size_t *pos, size_t end, uint64_t *out) {
    size_t p = *pos;
    uint64_t v = 0;
    for (int shift = 0; shift < 64; shift += 7) {
        if (p >= end) return WV_DEFER;
        uint8_t c = b[p++];
        if (shift == 63 && c > 1) return WV_DEFER;
        v |= (uint64_t)(c & 0x7f) << shift;
        if (!(c & 0x80)) {
            *pos = p;
            *out = v;
            return 0;
        }
    }
    return WV_DEFER;
}

/* Skip one field of wire type wt; a skip past end stops at end. */
static int wv_skip(const uint8_t *b, size_t *pos, size_t end, uint64_t wt) {
    uint64_t n;
    if (wt == 0) return wv_uvarint(b, pos, end, &n);
    if (wt == 1) n = 8;
    else if (wt == 5) n = 4;
    else if (wt == 2) {
        if (wv_uvarint(b, pos, end, &n)) return WV_DEFER;
    } else return WV_DEFER;
    *pos = n < end - *pos ? *pos + n : end;
    return 0;
}

/* A length-delimited field's value at *pos: its [lo, hi) in the body. */
static int wv_bytes(const uint8_t *b, size_t *pos, size_t end, int64_t *lo, int64_t *hi) {
    uint64_t n;
    if (wv_uvarint(b, pos, end, &n) || n > end - *pos) return WV_DEFER;
    *lo = (int64_t)*pos;
    *hi = (int64_t)(*pos + n);
    *pos += n;
    return 0;
}

/* One Lane in [pos, end): the [lo, hi) of its pub_key, msg and sig in
 * span[0..5] (0, 0 when absent) and its power as int64. */
static int wv_lane(const uint8_t *b, size_t pos, size_t end, int64_t span[6], int64_t *power) {
    memset(span, 0, 6 * sizeof *span);
    *power = 0;
    while (pos < end) {
        uint64_t k, v;
        if (wv_uvarint(b, &pos, end, &k)) return WV_DEFER;
        uint64_t f = k >> 3;
        if (f >= 1 && f <= 3) {
            if (wv_bytes(b, &pos, end, &span[2 * (f - 1)], &span[2 * (f - 1) + 1]))
                return WV_DEFER;
        } else if (f == 4) {
            if (wv_uvarint(b, &pos, end, &v)) return WV_DEFER;
            *power = (int64_t)v;
        } else if (wv_skip(b, &pos, end, k & 7)) {
            return WV_DEFER;
        }
    }
    return 0;
}

/* Walk the VerifyRequest payload body[1:len): returns its lane count, or
 * WV_DEFER. With out NULL it only counts (the lanes' insides unread);
 * otherwise out holds cap + 1 rows of 7 int64: lane i's pub_key, msg and
 * sig as [lo, hi) and its power in row i, and in row cap (as uint64) the
 * request_id, curve's [lo, hi), tally, deadline_ms and trace_ctx's [lo, hi). */
int64_t tmtpu_walk_verify(const uint8_t *b, size_t len, int64_t cap, int64_t *out) {
    size_t pos = 1, end = len;
    int64_t lanes = 0, curve[2] = {0, 0}, ctx[2] = {0, 0};
    uint64_t request_id = 0, tally = 0, deadline_ms = 0;
    while (pos < end) {
        uint64_t key, n;
        if (wv_uvarint(b, &pos, end, &key)) return WV_DEFER;
        uint64_t fn = key >> 3;
        if (fn == 5) {
            if (wv_uvarint(b, &pos, end, &n) || n > end - pos) return WV_DEFER;
            if (out) {
                int64_t *row = out + 7 * lanes;
                if (lanes >= cap || wv_lane(b, pos, pos + n, row, row + 6)) return WV_DEFER;
            }
            lanes++;
            pos += n;
        } else if (fn == 1) {
            if (wv_uvarint(b, &pos, end, &request_id)) return WV_DEFER;
        } else if (fn == 2) {
            for (int64_t i = curve[0]; i < curve[1]; i++)
                if (b[i] & 0x80) return WV_DEFER;
            if (wv_bytes(b, &pos, end, &curve[0], &curve[1])) return WV_DEFER;
        } else if (fn == 6) {
            if (wv_bytes(b, &pos, end, &ctx[0], &ctx[1])) return WV_DEFER;
        } else if (fn == 3) {
            if (wv_uvarint(b, &pos, end, &n)) return WV_DEFER;
            tally = n != 0;
        } else if (fn == 4) {
            if (wv_uvarint(b, &pos, end, &deadline_ms)) return WV_DEFER;
        } else if (wv_skip(b, &pos, end, key & 7)) {
            return WV_DEFER;
        }
    }
    if (out) {
        uint64_t top[7] = {request_id, (uint64_t)curve[0], (uint64_t)curve[1], tally,
                           deadline_ms, (uint64_t)ctx[0], (uint64_t)ctx[1]};
        memcpy(out + 7 * cap, top, sizeof top);
    }
    return lanes;
}
