// (sum mod 2^32, xor) fingerprint of a block of 32-bit words.
//
// Replaces the TPU kernel elbencho_tpu/ops/verify.py::_fingerprint_kernel
// (driven by _pallas_fingerprint_call and fingerprint_block_pallas), which
// reduced a whole (rows, 128) uint32 block in VMEM with no grid.
//
// Bound: device-memory bytes. The kernel reads each word once and does two
// integer operations on it, so on an H100 (3.35 TB/s) a 16 MiB block can
// take no less than about 5 us. The design keeps the loads wide and the
// reduction out of device memory:
//   - a grid-stride loop over 16-byte (uint4) loads, with a scalar head up
//     to the first 16-byte boundary and a scalar tail, so any word count
//     and any 4-byte-aligned base are accepted;
//   - per-thread sum and xor in registers, then __shfl_xor_sync within the
//     warp, then shared memory across the warps of a block;
//   - one atomicAdd and one atomicXor per block into a 2-word output that
//     the caller zeroed on the same stream.
// Addition mod 2^32 and xor do not depend on order, so the result is
// exact whatever order the blocks finish in.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (elbencho_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void warp_reduce(uint32_t& s, uint32_t& x) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, offset);
        x ^= __shfl_xor_sync(0xffffffffu, x, offset);
    }
}

__global__ void __launch_bounds__(kThreads)
fingerprint_u32_kernel(const uint32_t* __restrict__ words, long long n,
                       uint32_t* __restrict__ out) {
    uint32_t s = 0, x = 0;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // scalar head: words before the first 16-byte boundary
    long long head = (long long)(((16u - ((uintptr_t)words & 15u)) & 15u) >> 2);
    if (head > n) head = n;
    if (tid < head) {
        const uint32_t w = words[tid];
        s += w;
        x ^= w;
    }

    // vector body: 16-byte loads, neighbouring threads on neighbouring words
    const uint4* vec = reinterpret_cast<const uint4*>(words + head);
    const long long n_vec = (n - head) >> 2;
    for (long long i = tid; i < n_vec; i += stride) {
        const uint4 q = __ldg(vec + i);
        s += (q.x + q.y) + (q.z + q.w);
        x ^= (q.x ^ q.y) ^ (q.z ^ q.w);
    }

    // scalar tail: fewer than 4 words after the last full vector
    for (long long i = head + (n_vec << 2) + tid; i < n; i += stride) {
        const uint32_t w = words[i];
        s += w;
        x ^= w;
    }

    warp_reduce(s, x);
    __shared__ uint32_t warp_s[kThreads / 32];
    __shared__ uint32_t warp_x[kThreads / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        warp_s[warp] = s;
        warp_x[warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
        s = lane < kThreads / 32 ? warp_s[lane] : 0u;
        x = lane < kThreads / 32 ? warp_x[lane] : 0u;
        warp_reduce(s, x);
        if (lane == 0) {
            atomicAdd(out, s);
            atomicXor(out + 1, x);
        }
    }
}

}  // namespace

// words: device pointer to n 32-bit words (4-byte aligned); out: device
// pointer to 2 zeroed words (sum, xor); grid: number of blocks; stream: the
// cudaStream_t to launch on. Returns the cudaError_t of the launch.
extern "C" int fingerprint_u32(const void* words, long long n, void* out,
                               int grid, void* stream) {
    fingerprint_u32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(words), n, static_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}
