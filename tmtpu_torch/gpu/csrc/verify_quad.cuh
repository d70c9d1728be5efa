// The kernel shape shared by the ed25519, sr25519 and secp256k1 verifies:
// one quad of four threads per signature (quad.cuh), any block size that is
// a multiple of 4 up to QUAD_MAX_THREADS.
//
// VERIFY describes the curve's kernel: its fixed-base table (base_t,
// BASE_WORDS), the bytes of one lane of its packed plane (LANE_BYTES), the
// words of the per-lane table each quad keeps (QUAD_TAB_WORDS), how a
// thread finds its column of that table (table()), and the per-signature
// quad verify (operator()). Dynamic shared memory of a block of n threads:
//   the fixed-base table, copied from device memory once per block; the
//     quads of a warp read it at different digits, which __constant__
//     would serialize;
//   each quad's lane bytes, n/4 x LANE_BYTES: role j gathers the quarter
//     j of its lane's rows, and all four roles then read the scalars'
//     digits from here (a broadcast within the quad);
//   the per-lane tables, n/4 x QUAD_TAB_WORDS words.
// Above 48 KB the launch raises the kernel's dynamic shared memory limit
// first.
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

// The ed25519 and sr25519 kernels' layout: the niels table of d*B, 16 x 3
// field elements (1,920 B); 128 lane bytes (pk | r | s | h-or-k); the
// per-lane tables of d*(-A), d = 1..15, one column of 15 x 10 limbs a
// thread (600 B), laid out [entry][limb][thread] so that a warp's 32
// threads always read 32 different banks. At 64 threads that is 42,368 B.
struct EdwardsQuadLayout {
    using base_t = ge_niels;
    using table_t = quad_table;
    static constexpr int BASE_WORDS = 16 * 3 * 10;
    static constexpr int LANE_BYTES = 128;
    static constexpr int QUAD_TAB_WORDS = 4 * 15 * 10;
    __device__ static table_t table(int32_t* s_tab) {
        return table_t{s_tab + threadIdx.x, (int)blockDim.x};
    }
};

template <class VERIFY>
inline size_t quad_smem_bytes(int threads) {
    return (size_t)VERIFY::BASE_WORDS * 4 +
           (size_t)(threads / 4) * (VERIFY::LANE_BYTES + (size_t)VERIFY::QUAD_TAB_WORDS * 4);
}

template <class VERIFY>
__global__ void __launch_bounds__(QUAD_MAX_THREADS, QUAD_MIN_BLOCKS)
quad_verify_kernel(const uint8_t* __restrict__ packed, int B,
                   const int32_t* __restrict__ base, int32_t* __restrict__ out) {
    constexpr int ROWS = VERIFY::LANE_BYTES / 4;  // gathered by each role
    extern __shared__ int32_t smem[];
    const auto* s_base = reinterpret_cast<const typename VERIFY::base_t*>(smem);
    uint8_t* s_lanes = reinterpret_cast<uint8_t*>(smem + VERIFY::BASE_WORDS);
    int32_t* s_tab = smem + VERIFY::BASE_WORDS + (blockDim.x / 4) * (VERIFY::LANE_BYTES / 4);
    for (int i = threadIdx.x; i < VERIFY::BASE_WORDS; i += blockDim.x) smem[i] = base[i];

    const int role = threadIdx.x & 3;
    const int sig = blockIdx.x * (blockDim.x >> 2) + (threadIdx.x >> 2);
    uint8_t* lane = s_lanes + VERIFY::LANE_BYTES * (threadIdx.x >> 2);
    if (sig < B) {
#pragma unroll 4
        for (int k = 0; k < ROWS; k++) {
            lane[ROWS * role + k] = packed[(size_t)(ROWS * role + k) * B + sig];
        }
    }
    __syncthreads();
    if (sig >= B) return;

    const quad q = quad_of_thread();
    typename VERIFY::table_t tab = VERIFY::table(s_tab);
    const int v = VERIFY()(q, lane, s_base, tab);
    if (role == 0) out[sig] = v;
}

// Launch on ``stream`` with ``threads`` threads a block; returns
// cudaGetLastError() (0 when the launch was accepted).
template <class VERIFY>
int quad_verify_launch(const void* packed, int B, const void* base, void* out, void* stream,
                       int threads) {
    if (B <= 0) return 0;
    if (threads < 4 || threads > QUAD_MAX_THREADS || threads % 4 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = quad_smem_bytes<VERIFY>(threads);
    cudaError_t err = cudaFuncSetAttribute(quad_verify_kernel<VERIFY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int quads = threads / 4;
    const int blocks = (B + quads - 1) / quads;
    quad_verify_kernel<VERIFY><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(packed), B, static_cast<const int32_t*>(base),
        static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}
