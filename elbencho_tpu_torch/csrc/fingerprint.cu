// (sum mod 2^32, xor) fingerprint of a block of 32-bit words.
//
// Replaces the TPU kernel elbencho_tpu/ops/verify.py::_fingerprint_kernel
// (driven by _pallas_fingerprint_call and fingerprint_block_pallas), which
// reduced a whole (rows, 128) uint32 block in VMEM with no grid.
//
// Bound: device-memory bytes. The kernel reads each word once and does two
// integer operations on it, so on an H100 (3.35 TB/s) a 16 MiB block can
// take no less than about 5 us, and a fixed cost of a few microseconds is
// a large share of that. The design:
//   - one launch per call and nothing else on the stream: each block
//     stores its (sum, xor) partial in a scratch array and counts itself
//     done on a counter with one acquire-release atomic (measured a little
//     faster than __threadfence() and a relaxed atomic); the block that
//     counts last folds the partials, writes the 2-word output with plain
//     stores and resets the counter to 0 for the next launch on the same
//     stream (the caller keeps one scratch per stream, zeroed once when it
//     is made);
//   - a persistent grid (about as many blocks as fit on the SMs at once)
//     in which each block walks one contiguous chunk of the 16-byte body;
//   - each thread issues kUnroll independent 16-byte loads before it adds
//     any of them, with the non-coherent, no-L1-allocate load and a 256-byte
//     L2 prefetch hint, since every byte is read exactly once;
//   - per-thread sum and xor in registers, then __shfl_xor_sync within the
//     warp, then shared memory across the warps of a block.
// Addition mod 2^32 and xor do not depend on order, so the result is exact
// whatever order the blocks finish in.
//
// The partition of the n words is made on the host by
// elbencho_tpu_torch/ops/verify.py::fingerprint_plan and passed in: a
// scalar head of up to 3 words before the first 16-byte boundary, a body of
// n_vec 16-byte vectors cut into chunks of `chunk` vectors (block b takes
// [b * chunk, min((b + 1) * chunk, n_vec))), and a scalar tail of up to 3
// words. Block 0 also adds the head and the tail.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (elbencho_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kTile = kThreads * kUnroll;  // vectors per block per step
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint4 load_once(const uint4* p) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
}

__device__ __forceinline__ void add(uint32_t& s, uint32_t& x, uint4 q) {
    s += (q.x + q.y) + (q.z + q.w);
    x ^= (q.x ^ q.y) ^ (q.z ^ q.w);
}

__device__ __forceinline__ void warp_reduce(uint32_t& s, uint32_t& x) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, offset);
        x ^= __shfl_xor_sync(0xffffffffu, x, offset);
    }
}

// Leaves the block's (sum, xor) in thread 0. Callers separate two uses
// with a __syncthreads().
__device__ __forceinline__ void block_reduce(uint32_t& s, uint32_t& x) {
    __shared__ uint32_t warp_s[kWarps];
    __shared__ uint32_t warp_x[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    warp_reduce(s, x);
    if (lane == 0) {
        warp_s[warp] = s;
        warp_x[warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
        s = lane < kWarps ? warp_s[lane] : 0u;
        x = lane < kWarps ? warp_x[lane] : 0u;
        warp_reduce(s, x);
    }
}

// Adds 1 to the counter and returns its old value. Release: this thread's
// earlier stores are visible to whoever sees the new count. Acquire: the
// stores that other blocks made before their counts are visible here.
__device__ __forceinline__ uint32_t count_done(uint32_t* counter) {
    uint32_t old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

__global__ void __launch_bounds__(kThreads)
fingerprint_u32_kernel(const uint32_t* __restrict__ words, int head,
                       long long n_vec, long long chunk, int tail,
                       uint32_t* __restrict__ out,
                       uint32_t* __restrict__ scratch) {
    uint32_t s = 0, x = 0;
    const int t = threadIdx.x;

    if (blockIdx.x == 0) {
        if (t < head) {
            const uint32_t w = words[t];
            s += w;
            x ^= w;
        }
        if (t < tail) {
            const uint32_t w = words[head + 4 * n_vec + t];
            s += w;
            x ^= w;
        }
    }

    // the block's chunk: full tiles of kUnroll loads per thread, all issued
    // before any is added, then one ragged tile (only the last block has
    // one, as the host rounds the chunk to whole tiles)
    const uint4* vec = reinterpret_cast<const uint4*>(words + head);
    const long long begin = (long long)blockIdx.x * chunk;
    const long long end = begin + chunk < n_vec ? begin + chunk : n_vec;
    long long base = begin;
    for (; base + kTile <= end; base += kTile) {
        uint4 q[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            q[j] = load_once(vec + base + j * kThreads + t);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            add(s, x, q[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
        const long long i = base + j * kThreads + t;
        if (i < end)
            add(s, x, load_once(vec + i));
    }

    // scratch: [0] counter, [1] unused, [2..] one (sum, xor) per block
    uint32_t* counter = scratch;
    uint2* partials = reinterpret_cast<uint2*>(scratch + 2);
    __shared__ bool is_last;
    block_reduce(s, x);
    if (t == 0) {
        partials[blockIdx.x] = make_uint2(s, x);
        is_last = count_done(counter) == gridDim.x - 1;
    }
    __syncthreads();  // orders thread 0's acquire before the reads below
    if (!is_last)
        return;

    // last block: fold every block's partial. __ldcg reads from L2, past
    // this SM's L1, which may hold partials of an earlier launch.
    s = 0;
    x = 0;
    for (int b = t; b < (int)gridDim.x; b += kThreads) {
        const uint2 p = __ldcg(partials + b);
        s += p.x;
        x ^= p.y;
    }
    block_reduce(s, x);
    if (t == 0) {
        out[0] = s;
        out[1] = x;
        *counter = 0;
    }
}

}  // namespace

// Vectors one block reads per step; ops/verify.py::fingerprint_plan rounds
// each block's chunk to whole steps of this size and checks that it agrees.
extern "C" int fingerprint_u32_tile_vecs(void) { return kTile; }

// Blocks of the kernel that fit on one SM at once (the persistent grid is
// this times the SM count). Returns the cudaError_t of the query.
extern "C" int fingerprint_u32_blocks_per_sm(int* blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fingerprint_u32_kernel, kThreads, 0);
}

// words: device pointer to 4-byte-aligned 32-bit words; head, n_vec,
// chunk, grid, tail: the plan of fingerprint_plan; out: device pointer to 2
// words (sum, xor), written by the kernel; scratch: device pointer to
// 2 + 2 * grid words or more, zeroed before its first use and used by one
// stream only; stream: the cudaStream_t to launch on. Returns the
// cudaError_t of the launch.
extern "C" int fingerprint_u32(const void* words, int head, long long n_vec,
                               long long chunk, int grid, int tail,
                               void* out, void* scratch, void* stream) {
    fingerprint_u32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(words), head, n_vec, chunk, tail,
        static_cast<uint32_t*>(out), static_cast<uint32_t*>(scratch));
    return (int)cudaGetLastError();
}
