// Batched ed25519 verification on Hopper (sm_90a): four threads (a quad)
// per signature.
//
// Replaces the Pallas TPU kernel tmtpu/tpu/kernel.py::_verify_kernel
// (launched by _verify_pallas_jit / verify_compact_kernel) and computes
// the same cofactorless Go-stdlib verify, lane for lane: decompress A,
// R' = [s]B + [h](-A) by a 64-window 4-bit Straus/Shamir ladder, and a
// byte-exact compare of encode(R') with R. The host has already masked
// malformed lanes (wrong lengths, s >= L, non-canonical A.y).
//
// Input: the packed [128, B] uint8 plane (pk | r | s | h rows, lanes on the
// trailing axis). Any B: the grid covers ceil(B / (threads / 4)) blocks and
// the ragged edge is masked (verify_quad.cuh). Output: int32 [B], 1 where
// the lane verifies.
//
// Bound on an H100 SXM: the work is integer multiplies. Verification needs
// about 1,790 field multiplies and 1,545 squarings per lane (chip_smoke.py
// counts them from the run's digits), about 264,000 32x32->64 products at
// 100 per multiply and 55 per squaring; at 64 integer multiply-adds per SM
// per clock, 132 SMs at 1.98 GHz give 16.7e12 per second, so 10,000 lanes
// cannot take less than ~0.16 ms. The 132 bytes a lane moves are noise
// (1.3 MB at 3.35 TB/s = 0.4 us), so neither TMA nor the tensor cores (the
// work is a dependent chain of integer products on ten-limb elements) have
// anything to offer: what is scarce is issue parallelism to hide the
// chain's latency.
//
// Design: a quad of four threads verifies a signature, so that 10,000
// lanes make 40,000 threads (~9.5 warps an SM) and each thread's dependent
// chain is about a quarter of one-thread-per-lane's ~408,000 products. In
// the ladder each thread runs one squaring and one multiply per doubling
// and two multiplies per addition (ge25519.cuh), zero digits add nothing,
// squarings take 55 products, carries run as parallel passes
// (fe25519.cuh), and the per-lane table of d*(-A) lies in shared memory.
// Per thread, for random scalars: decompressing A 20M + 255S (every role
// runs it, so no exchange), the table 14 additions and 15 conversions
// (43M), 64 windows of four doublings (256M + 256S) and about 120
// additions (240M), the final inversion and two products (13M + 254S):
// about 570M + 765S, ~99,000 products. Decompression and inversion are
// serial on every role, ~31,000 of them (~31%); a Montgomery batch
// inversion across a warp's eight signatures would cut the work of the
// inversion but not its latency, and is not done. ptxas: 168 registers
// (the cap of verify_quad.cuh), no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"
#include "verify_quad.cuh"

#define ED25519_THREADS 64

struct Ed25519Quad : EdwardsQuadLayout {
    __device__ __forceinline__ int operator()(const quad& q, const uint8_t* lane,
                                              const ge_niels* btab, quad_table& tab) const {
        return ed25519_verify_quad(q, lane, btab, tab);
    }
};

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int ed25519_verify_launch(const void* packed, int B, const void* btab,
                                     void* out, void* stream) {
    return quad_verify_launch<Ed25519Quad>(packed, B, btab, out, stream, ED25519_THREADS);
}

// The dynamic shared memory a launch gives each block, in bytes.
extern "C" int ed25519_verify_smem_bytes(void) {
    return (int)quad_smem_bytes<Ed25519Quad>(ED25519_THREADS);
}
