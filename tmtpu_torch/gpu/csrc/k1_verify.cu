// Batched secp256k1 ECDSA (low-S) verification on Hopper (sm_90a): four
// threads (a quad) per signature.
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
// the trailing axis). Any B: the grid covers ceil(B / (threads / 4)) blocks
// and the ragged edge is masked (verify_quad.cuh). Output: int32 [B], 1
// where the lane verifies.
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
// are noise, so neither TMA nor the tensor cores have anything to offer:
// what is scarce is issue parallelism to hide the chain's latency.
//
// Design: a quad of four threads verifies a signature (ge_secp256k1.cuh):
// every role holds the whole point and the products of each formula level
// are shared out, one a role a round, and broadcast by __shfl_sync over the
// quad; a doubling is two products a thread, an addition four, and zero
// digits add nothing. Per thread, for random scalars: 256 doublings and
// about 120 additions (992M), the table (56M), the decompression on every
// role (14M + 255S, out of line, with 36-product squarings) and the final
// compare (2M): about 1,064M + 255S, ~77,000 products, against ~236,000 on
// one thread per lane. Field products are C rows of 64-bit multiply-adds
// (fe_secp256k1.cuh); PTX add-with-carry chains compiled to four SASS
// instructions a product and ran 7% slower. Every step of the formulas is
// branch-free within a quad except the folds' rare tails, out of line.
// Tables: the projective table of d*G (16 x 3 field elements, 1,536 B),
// built on the host from the oracle, is copied into shared memory once per
// block; the per-lane table of d*Q, d = 1..15 (1,440 B a signature), lies
// in shared memory once per quad, laid out [element][word][quad], which
// all four roles read at the same word and the eight quads of a warp at
// eight banks. With the quads' 168 lane bytes a 128-thread block takes
// 52,992 B. 128-thread blocks timed 4% faster than 64 or 32 at 10,000
// lanes and the same at 500. ptxas: 128 registers, under the cap of
// verify_quad.cuh (168); no spill; the stack is the out-of-line tails'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ge_secp256k1.cuh"
#include "verify_quad.cuh"

#define K1_THREADS 128

struct K1Quad {
    using base_t = k1_point;
    using table_t = quad_tab<fe8>;
    static constexpr int BASE_WORDS = 16 * 3 * 8;
    static constexpr int LANE_BYTES = 168;
    static constexpr int QUAD_TAB_WORDS = K1_TAB_ELEMS * 8;
    __device__ static table_t table(int32_t* s_tab) {
        return table_t{s_tab + (threadIdx.x >> 2), (int)(blockDim.x >> 2)};
    }
    __device__ __forceinline__ int operator()(const quad& q, const uint8_t* lane,
                                              const k1_point* gtab, table_t& tab) const {
        return k1_verify_quad(q, lane, gtab, tab);
    }
};

// Plain C entry for ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int k1_verify_launch(const void* packed, int B, const void* gtab, void* out,
                                void* stream) {
    return quad_verify_launch<K1Quad>(packed, B, gtab, out, stream, K1_THREADS);
}

// The dynamic shared memory a launch gives each block, in bytes.
extern "C" int k1_verify_smem_bytes(void) {
    return (int)quad_smem_bytes<K1Quad>(K1_THREADS);
}

