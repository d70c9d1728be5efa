// Batched secp256k1 ECDSA (low-S) verification on Hopper (sm_90a): one
// thread per lane.
//
// Replaces the Pallas TPU kernel tmtpu/tpu/k1_kernel.py::_k1_verify_kernel
// (launched by _k1_verify_pallas_jit / k1_verify_compact_kernel) and
// computes the same verify, lane for lane: SEC 1 decompression of Q with
// the prefix's parity, a per-lane table of d*Q by complete additions,
// R = [u1]G + [u2]Q by the 64-window 4-bit Straus/Shamir ladder (RCB16
// complete formulas), and acceptance when Q decoded, R is finite and
// X == r Z or X == (r + n) Z. The host has already rejected wrong lengths,
// prefixes other than 2 or 3, x >= p, r or s outside [1, n - 1] and high S,
// and computed u1 = h/s and u2 = r/s mod n.
//
// Input: the packed [168, B] uint8 plane (pkx | u1 | u2 | r | rpn as
// big-endian 32-byte rows, the parity in row 160, seven zero rows; lanes on
// the trailing axis), so thread t reads byte k of a plane at k*B + t. Any
// B: the grid covers ceil(B / 64) blocks and the ragged edge is masked.
// Output: int32 [B], 1 where the lane verifies.
//
// Field: eight 32-bit words with 32x32->64 products and reduction by
// 2^256 = 2^32 + 977 (fe_secp256k1.cuh), in place of the TPU's twenty 13-bit
// limbs. Tables: the projective table of d*G (16 x 3 field elements, 1,536
// bytes), built on the host from the oracle, is copied into shared memory
// once per block (lanes index it by different digits); the per-lane table
// of d*Q (1,536 bytes) lives in thread-local memory.
//
// Bound on an H100 SXM: integer multiplies. The reference's algorithm
// needs per lane 64 windows of four doublings (6M + 2S each), an addition
// (12M) for each non-zero digit of u1 and of u2, the table of d*Q (14
// additions), the decompression (about 13M + 254S) and the final compare
// (2M): about 3,260M + 770S for random scalars (chip_smoke.py counts the
// digits of the run). A 256-bit operand is eight 32-bit words whatever the
// representation, so a multiply needs at least 64 32x32->64 products and a
// squaring 36: about 236,000 products per lane; at 64 integer
// multiply-adds per SM per clock, 132 SMs at 1.98 GHz (16.7e12 per second),
// 10,000 lanes cannot take less than ~0.14 ms. The 172 bytes a lane moves
// are noise. This first version does nothing for that bound beyond one
// thread per lane: squarings are full products, each product carries
// word by word in 64-bit arithmetic rather than with PTX add-with-carry
// chains, and the mixed vote set gives it only 500 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe_secp256k1.cuh"
#include "ge_secp256k1.cuh"

#define K1_VERIFY_THREADS 64
#define K1_PARITY_ROW 160

__global__ void __launch_bounds__(K1_VERIFY_THREADS)
k1_verify_kernel(const uint8_t* __restrict__ packed, int B,
                 const uint32_t* __restrict__ gtab, int32_t* __restrict__ out) {
    __shared__ k1_point s_gtab[16];
    uint32_t* s_flat = reinterpret_cast<uint32_t*>(s_gtab);
    for (int i = threadIdx.x; i < 16 * 3 * 8; i += blockDim.x) s_flat[i] = gtab[i];
    __syncthreads();

    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    uint8_t pkx[32], u1[32], u2[32], r[32], rpn[32];
#pragma unroll
    for (int j = 0; j < 32; j++) {
        pkx[j] = packed[(size_t)j * B + t];
        u1[j] = packed[(size_t)(32 + j) * B + t];
        u2[j] = packed[(size_t)(64 + j) * B + t];
        r[j] = packed[(size_t)(96 + j) * B + t];
        rpn[j] = packed[(size_t)(128 + j) * B + t];
    }
    const uint32_t parity = packed[(size_t)K1_PARITY_ROW * B + t];
    out[t] = k1_verify_lane(pkx, parity, u1, u2, r, rpn, s_gtab);
}

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int k1_verify_launch(const void* packed, int B, const void* gtab,
                                void* out, void* stream) {
    if (B <= 0) return 0;
    const int blocks = (B + K1_VERIFY_THREADS - 1) / K1_VERIFY_THREADS;
    k1_verify_kernel<<<blocks, K1_VERIFY_THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(packed), B, static_cast<const uint32_t*>(gtab),
        static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}
