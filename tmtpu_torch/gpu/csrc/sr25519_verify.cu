// Batched sr25519 (schnorrkel) verification on Hopper (sm_90a): one thread
// per lane.
//
// Replaces the Pallas TPU kernel tmtpu/tpu/kernel.py::_sr_verify_kernel
// (launched by _sr_verify_pallas_jit / sr_verify_compact_kernel) and
// computes the same verify, lane for lane: ristretto255 decode of A and R,
// R' = [s]B + [k](-A) by the 64-window 4-bit Straus/Shamir ladder that the
// ed25519 kernel runs, and coset equality of R' with R. The host has
// already checked the marker bit, s < L and the canonical encodings of A
// and R, and computed the merlin challenge k.
//
// Input: the packed [128, B] uint8 plane (pk | r | s | k rows, lanes on the
// trailing axis), so thread t reads byte k of a plane at k*B + t. Any B:
// the grid covers ceil(B / 64) blocks and the ragged edge is masked.
// Output: int32 [B], 1 where the lane verifies.
//
// Tables: the fixed-base niels table of d*B (the ed25519 kernel's, 1,920
// bytes) is copied into shared memory once per block; the per-lane cached
// table of d*(-A) (2,560 bytes) lives in thread-local memory.
//
// Bound on an H100 SXM: integer multiplies. The reference's algorithm
// needs per lane two ristretto decodes (about 22 multiplies M and 256
// squarings S each), the table of d*(-A) (99M + 28S), 63 windows of four
// doublings (13M + 16S), 8M for each non-zero digit of k and 6M for each
// non-zero digit of s, and 4M of coset equality: about 1,800M + 1,550S
// for random scalars (chip_smoke.py counts the digits of the run). At 100
// 32x32->64 products per M and 55 per S (ten radix-2^25.5 limbs) that is
// about 266,000 products per lane; at 64 integer multiply-adds per SM per
// clock, 132 SMs at 1.98 GHz (16.7e12 per second), 10,000 lanes cannot take
// less than ~0.16 ms. The 132 bytes a lane moves are noise. This first
// version does what the ed25519 kernel does about that bound, one thread
// per lane and nothing more; the mixed vote set gives it only 500 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "ge25519.cuh"
#include "ristretto255.cuh"

#define SR_VERIFY_THREADS 64

__global__ void __launch_bounds__(SR_VERIFY_THREADS)
sr25519_verify_kernel(const uint8_t* __restrict__ packed, int B,
                      const int32_t* __restrict__ btab,
                      int32_t* __restrict__ out) {
    __shared__ ge_niels s_btab[16];
    int32_t* s_flat = reinterpret_cast<int32_t*>(s_btab);
    for (int i = threadIdx.x; i < 16 * 3 * 10; i += blockDim.x) s_flat[i] = btab[i];
    __syncthreads();

    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    uint8_t pk[32], r[32], s[32], k[32];
#pragma unroll
    for (int j = 0; j < 32; j++) {
        pk[j] = packed[(size_t)j * B + t];
        r[j] = packed[(size_t)(32 + j) * B + t];
        s[j] = packed[(size_t)(64 + j) * B + t];
        k[j] = packed[(size_t)(96 + j) * B + t];
    }
    out[t] = sr25519_verify_lane(pk, r, s, k, s_btab);
}

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int sr25519_verify_launch(const void* packed, int B, const void* btab,
                                     void* out, void* stream) {
    if (B <= 0) return 0;
    const int blocks = (B + SR_VERIFY_THREADS - 1) / SR_VERIFY_THREADS;
    sr25519_verify_kernel<<<blocks, SR_VERIFY_THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(packed), B, static_cast<const int32_t*>(btab),
        static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}
