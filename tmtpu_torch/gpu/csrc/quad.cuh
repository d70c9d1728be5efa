// Four threads per signature: the "quad" primitives shared by the ed25519,
// sr25519 and secp256k1 kernels and by their host build in the tests.
//
// A quad is warp lanes 4q..4q+3, and j = lane mod 4 is a thread's role. In
// the Edwards formulas (ge25519.cuh) role j holds coordinate j of a point
// (X, Y, Z, T, or the four coordinates of a table entry); in secp256k1's
// (ge_secp256k1.cuh) every role holds the whole point and the roles share
// out the products. The formulas are written once, as code that one role
// runs, for any field element type T with a word array v[] (fe, fe8):
//
//   qv<T>          a value each role holds its own copy of;
//   QUAD_EACH(q,j) { ... }  a block that role j runs on its own copies,
//                  x[j], with no exchange inside it;
//   quad_xchg      the only step between roles: role j receives role
//                  src_j's copy.
//
// On the card (nvcc) a qv<T> is one T in the thread's registers, x[j] is
// that T, QUAD_EACH runs its block once with j = the thread's role, and
// quad_xchg is __shfl_sync over the quad's four lanes. In the host build
// (g++) a qv<T> holds the four roles' copies, QUAD_EACH runs its block for
// j = 0..3 in turn, and quad_xchg permutes the copies: the four roles run
// in lockstep, through the very blocks and exchanges that the four threads
// of a quad run.
//
// Every exchange names all four lanes of its quad in its mask, so all four
// must reach it: the kernels keep control flow uniform within a quad (the
// four threads branch on the same digits and flags) and let a quad past the
// ragged edge leave as a whole before the first exchange.
#pragma once

#include <stdint.h>

#include "fe25519.cuh"

// 32-bit words of a field element type (fe: ten limbs; fe8: eight words).
#define QUAD_WORDS(T) ((int)(sizeof(T) / 4))
// Elements a host-build table holds (secp256k1: 15 points of 3).
#define QUAD_TAB_MAX 45

// (a0, a1, a2, a3)[j] for the role j: the per-role constants of a block.
FE_FN int quad_pick(int j, int a0, int a1, int a2, int a3) {
    return j == 0 ? a0 : j == 1 ? a1 : j == 2 ? a2 : a3;
}

#ifdef __CUDACC__

#define QUAD_FN __device__ __forceinline__

template <class T>
struct qv {
    T v;
    __device__ __forceinline__ T& operator[](int) { return v; }
    __device__ __forceinline__ const T& operator[](int) const { return v; }
};

struct quad {
    int role;       // lane mod 4
    unsigned mask;  // the quad's four lanes
};

QUAD_FN quad quad_of_thread() {
    const int lane = threadIdx.x & 31;
    return quad{lane & 3, 0xFu << (lane & ~3)};
}

#define QUAD_EACH(q, j) for (int j = (q).role, j##_once = 1; j##_once; j##_once = 0)

template <class T>
QUAD_FN void quad_xchg(const quad& q, qv<T>& out, const qv<T>& in, int s0, int s1, int s2,
                       int s3) {
    const int src = quad_pick(q.role, s0, s1, s2, s3);
    T t;
#pragma unroll
    for (int i = 0; i < QUAD_WORDS(T); i++) t.v[i] = __shfl_sync(q.mask, in.v.v[i], src, 4);
    out.v = t;
}

QUAD_FN void quad_xchg(const quad& q, qv<int>& out, const qv<int>& in, int s0, int s1,
                       int s2, int s3) {
    out.v = __shfl_sync(q.mask, in.v, quad_pick(q.role, s0, s1, s2, s3), 4);
}

// The thread's verdict (every role computes the same one).
QUAD_FN int quad_result(const qv<int>& v) { return v.v; }

// A table of field elements in shared memory: word i of element e at
// col[(e * QUAD_WORDS(T) + i) * stride]. The caller picks the column and
// stride: the Edwards kernels give each thread a column of its own (col =
// base + thread, stride = blockDim.x), where role j keeps coordinate j of
// every entry, so the 32 threads of a warp always hit 32 different banks;
// secp256k1 gives each quad one column (col = base + quad, stride =
// blockDim.x / 4), which all four roles write with the same value and read
// at the same word, so the eight quads of a warp hit eight banks.
template <class T>
struct quad_tab {
    int32_t* col;
    int stride;
};

template <class T>
QUAD_FN void quad_table_put(quad_tab<T>& t, int e, const qv<T>& x) {
#pragma unroll
    for (int i = 0; i < QUAD_WORDS(T); i++) {
        t.col[(e * QUAD_WORDS(T) + i) * t.stride] = (int32_t)x.v.v[i];
    }
}

template <class T>
QUAD_FN void quad_table_get(const quad_tab<T>& t, int e, qv<T>& x) {
#pragma unroll
    for (int i = 0; i < QUAD_WORDS(T); i++) {
        x.v.v[i] = t.col[(e * QUAD_WORDS(T) + i) * t.stride];
    }
}

#else  // host build: the four roles in lockstep

#define QUAD_FN inline

template <class T>
struct qv {
    T v[4];
    T& operator[](int j) { return v[j]; }
    const T& operator[](int j) const { return v[j]; }
};

struct quad {};

#define QUAD_EACH(q, j) for (int j = 0; j < 4; j++)

template <class T>
QUAD_FN void quad_xchg(const quad&, qv<T>& out, const qv<T>& in, int s0, int s1, int s2,
                       int s3) {
    qv<T> t;
    for (int j = 0; j < 4; j++) t[j] = in[quad_pick(j, s0, s1, s2, s3)];
    out = t;
}

// The verdict, or -1 when the roles disagree (a fault the tests catch).
QUAD_FN int quad_result(const qv<int>& v) {
    return (v[0] == v[1] && v[0] == v[2] && v[0] == v[3]) ? v[0] : -1;
}

// The roles' copies of every element, as the four threads hold them (a
// table that the quad shares on the card holds four equal copies here).
template <class T>
struct quad_tab {
    T e[QUAD_TAB_MAX][4];
};

template <class T>
QUAD_FN void quad_table_put(quad_tab<T>& t, int e, const qv<T>& x) {
    for (int j = 0; j < 4; j++) t.e[e][j] = x[j];
}

template <class T>
QUAD_FN void quad_table_get(const quad_tab<T>& t, int e, qv<T>& x) {
    for (int j = 0; j < 4; j++) x[j] = t.e[e][j];
}

#endif

// The Edwards kernels' per-thread table of cached points.
using quad_table = quad_tab<fe>;
