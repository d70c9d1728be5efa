// Batched sr25519 (schnorrkel) verification on Hopper (sm_90a): four
// threads (a quad) per signature.
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
// trailing axis). Any B: the grid covers ceil(B / (threads / 4)) blocks and
// the ragged edge is masked (verify_quad.cuh). Output: int32 [B], 1 where
// the lane verifies.
//
// Bound on an H100 SXM: integer multiplies. The reference's algorithm
// needs per lane two ristretto decodes (about 24 multiplies M and 257
// squarings S each), the table of d*(-A) (99M + 28S), 63 windows of four
// doublings (13M + 16S), 8M for each non-zero digit of k and 6M for each
// non-zero digit of s, and 4M of coset equality: about 1,800M + 1,550S
// for random scalars (chip_smoke.py counts the digits of the run). At 100
// 32x32->64 products per M and 55 per S (ten radix-2^25.5 limbs) that is
// about 266,000 products per lane; at 64 integer multiply-adds per SM per
// clock, 132 SMs at 1.98 GHz (16.7e12 per second), 10,000 lanes cannot take
// less than ~0.16 ms. The 132 bytes a lane moves are noise.
//
// Design: the ed25519 kernel's (quads, the four-way ladder of ge25519.cuh,
// a dedicated squaring, parallel carries, the per-lane table in shared
// memory), with roles 0 and 1 decoding A while roles 2 and 3 decode R, so
// that each thread runs one decode (24M + 257S), not two in a row. Per
// thread, for random scalars: one decode, the table (43M), the ladder
// (256M + 256S and ~240M of additions) and coset equality (4M): about
// 570M + 515S, ~85,000 products. The mixed vote set gives this kernel 500
// lanes: 2,000 threads, which 64-thread blocks spread over 32 SMs. ptxas:
// 168 registers, 92 B spilled in one out-of-line decode function.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"
#include "ristretto255.cuh"
#include "verify_quad.cuh"

#define SR25519_THREADS 64

struct Sr25519Quad : EdwardsQuadLayout {
    __device__ __forceinline__ int operator()(const quad& q, const uint8_t* lane,
                                              const ge_niels* btab, quad_table& tab) const {
        return sr25519_verify_quad(q, lane, btab, tab);
    }
};

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int sr25519_verify_launch(const void* packed, int B, const void* btab,
                                     void* out, void* stream) {
    return quad_verify_launch<Sr25519Quad>(packed, B, btab, out, stream, SR25519_THREADS);
}

// The dynamic shared memory a launch gives each block, in bytes.
extern "C" int sr25519_verify_smem_bytes(void) {
    return (int)quad_smem_bytes<Sr25519Quad>(SR25519_THREADS);
}
