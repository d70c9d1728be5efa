// The kernel shape shared by the ed25519 and sr25519 verifies: one quad of
// four threads per signature (quad.cuh), any block size that is a multiple
// of 4 up to QUAD_MAX_THREADS.
//
// Dynamic shared memory of a block of n threads:
//   the fixed-base niels table of d*B, 16 x 3 field elements (1,920 B),
//     copied from device memory once per block; the quads of a warp read it
//     at different digits, which __constant__ would serialize;
//   each quad's 128 lane bytes (pk | r | s | h-or-k), n/4 x 128 B: role j
//     gathers plane rows 32j..32j+31 of its lane, and all four roles then
//     read the scalars' digits from here (a broadcast within the quad);
//   the per-lane tables of d*(-A), d = 1..15, one column of 15 x 10 limbs a
//     thread (600 B), laid out [entry][limb][thread] so that a warp's 32
//     threads always read 32 different banks.
// At 64 threads that is 42,368 B, so five blocks (80 signatures) fit on an
// SM with room to spare; above 48 KB (n > 72) the launch raises the
// kernel's dynamic shared memory limit first.
//
// The ragged edge: a quad whose signature lies past B gathers nothing and
// leaves, all four threads together, after the block's one barrier and
// before the first exchange; only role 0 writes the verdict.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"
#include "quad.cuh"

#define QUAD_MAX_THREADS 128
// Blocks of QUAD_MAX_THREADS that must fit on one SM: it caps a thread's
// registers at 65,536 / (3 * 128) = 168 (ptxas takes up to 255 unasked),
// so that 10,000 signatures' 40,000 threads fit on the card at once.
#define QUAD_MIN_BLOCKS 3
#define QUAD_TABLE_ENTRIES 15
#define QUAD_BTAB_WORDS (16 * 3 * 10)

inline size_t quad_smem_bytes(int threads) {
    return (size_t)QUAD_BTAB_WORDS * 4 + (size_t)(threads / 4) * 128 +
           (size_t)QUAD_TABLE_ENTRIES * 10 * 4 * threads;
}

// VERIFY is a functor whose operator() is the per-signature quad verify.
template <class VERIFY>
__global__ void __launch_bounds__(QUAD_MAX_THREADS, QUAD_MIN_BLOCKS)
quad_verify_kernel(const uint8_t* __restrict__ packed, int B,
                   const int32_t* __restrict__ btab, int32_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const ge_niels* s_btab = reinterpret_cast<const ge_niels*>(smem);
    uint8_t* s_lanes = reinterpret_cast<uint8_t*>(smem + QUAD_BTAB_WORDS);
    int32_t* s_tab = smem + QUAD_BTAB_WORDS + (blockDim.x / 4) * 32;
    for (int i = threadIdx.x; i < QUAD_BTAB_WORDS; i += blockDim.x) smem[i] = btab[i];

    const int role = threadIdx.x & 3;
    const int sig = blockIdx.x * (blockDim.x >> 2) + (threadIdx.x >> 2);
    uint8_t* lane = s_lanes + 128 * (threadIdx.x >> 2);
    if (sig < B) {
#pragma unroll 4
        for (int k = 0; k < 32; k++) {
            lane[32 * role + k] = packed[(size_t)(32 * role + k) * B + sig];
        }
    }
    __syncthreads();
    if (sig >= B) return;

    const quad q = quad_of_thread();
    quad_table tab{s_tab + threadIdx.x, (int)blockDim.x};
    const int v = VERIFY()(q, lane, s_btab, tab);
    if (role == 0) out[sig] = v;
}

// Launch on ``stream`` with ``threads`` threads a block; returns
// cudaGetLastError() (0 when the launch was accepted).
template <class VERIFY>
int quad_verify_launch(const void* packed, int B, const void* btab, void* out, void* stream,
                       int threads) {
    if (B <= 0) return 0;
    if (threads < 4 || threads > QUAD_MAX_THREADS || threads % 4 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = quad_smem_bytes(threads);
    cudaError_t err = cudaFuncSetAttribute(quad_verify_kernel<VERIFY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int quads = threads / 4;
    const int blocks = (B + quads - 1) / quads;
    quad_verify_kernel<VERIFY><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(packed), B, static_cast<const int32_t*>(btab),
        static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}
