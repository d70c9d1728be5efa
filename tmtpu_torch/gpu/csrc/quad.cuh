// Four threads per signature: the "quad" primitives shared by the ed25519
// and sr25519 kernels and by their host build in the tests.
//
// A quad is warp lanes 4q..4q+3; role j = lane mod 4 holds coordinate j of
// a point (X, Y, Z, T, or the four coordinates of a table entry). The point
// formulas (ge25519.cuh) are written once, as code that one role runs:
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

QUAD_FN void quad_xchg(const quad& q, qv<fe>& out, const qv<fe>& in, int s0, int s1,
                       int s2, int s3) {
    const int src = quad_pick(q.role, s0, s1, s2, s3);
    fe t;
#pragma unroll
    for (int i = 0; i < 10; i++) t.v[i] = __shfl_sync(q.mask, in.v.v[i], src, 4);
    out.v = t;
}

QUAD_FN void quad_xchg(const quad& q, qv<int>& out, const qv<int>& in, int s0, int s1,
                       int s2, int s3) {
    out.v = __shfl_sync(q.mask, in.v, quad_pick(q.role, s0, s1, s2, s3), 4);
}

// The thread's verdict (every role computes the same one).
QUAD_FN int quad_result(const qv<int>& v) { return v.v; }

// The per-lane table of a quad in shared memory: role j keeps coordinate j
// of each entry in its own column, limb i of entry e at col[(e*10 + i) *
// stride] with stride = blockDim.x, so the 32 threads of a warp always hit
// 32 different banks, whatever entries their quads read.
struct quad_table {
    int32_t* col;
    int stride;
};

QUAD_FN void quad_table_put(quad_table& t, int e, const qv<fe>& x) {
#pragma unroll
    for (int i = 0; i < 10; i++) t.col[(e * 10 + i) * t.stride] = x.v.v[i];
}

QUAD_FN void quad_table_get(const quad_table& t, int e, qv<fe>& x) {
#pragma unroll
    for (int i = 0; i < 10; i++) x.v.v[i] = t.col[(e * 10 + i) * t.stride];
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

struct quad_table {
    fe e[16][4];
};

QUAD_FN void quad_table_put(quad_table& t, int e, const qv<fe>& x) {
    for (int j = 0; j < 4; j++) t.e[e][j] = x[j];
}

QUAD_FN void quad_table_get(const quad_table& t, int e, qv<fe>& x) {
    for (int j = 0; j < 4; j++) x[j] = t.e[e][j];
}

#endif
