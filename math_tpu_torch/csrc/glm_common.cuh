// Pieces shared by the GLM kernels of this directory (glm_fused.cu,
// glm_categorical.cu): the shared-memory limit and the 128-byte rounding of
// their block layouts, a place in a ring of stages, the staging of one 64-row
// tile of x and y by bulk copies, the second pass that adds the blocks'
// partials, and the dynamic shared-memory attribute set once a kernel.
// sm_90a only (the bulk copy).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "tf32x3.cuh"

namespace glm_common {

constexpr int TILE_ROWS = 64;  // rows of x per tile in every GLM kernel
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory one block may take on sm_90

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~(size_t)127; }

// A consumer's or a producer's place in a ring of stages: the stage and the
// parity of its barriers' phase.
struct RingPlace {
    int stages, st = 0;
    uint32_t parity = 0;
    __device__ __forceinline__ explicit RingPlace(int s) : stages(s) {}
    __device__ __forceinline__ void next() {
        if (++st == stages) {
            st = 0;
            parity ^= 1u;
        }
    }
};

// Lets kernel f take smem bytes of dynamic shared memory on the current
// device.  The attribute stays with the kernel, so the runtime is asked once
// per (kernel, device) and size, not at every launch.
inline cudaError_t allow_smem(const void* f, size_t smem) {
    struct Allowed {
        const void* f;
        int device;
        size_t smem;
    };
    static std::mutex mu;
    static std::vector<Allowed> allowed;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    for (const Allowed& a : allowed) {
        if (a.f == f && a.device == device && a.smem >= smem) return cudaSuccess;
    }
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed.push_back({f, device, smem});
    return err;
}

// One thread: asks for the 64 rows of x (d floats each, one contiguous span of
// 256*d bytes) and of y (4 bytes each) of row tile `tile`, by 1-D bulk copies
// into xdst and ydst that complete on bar.  x, y, xdst and ydst 16-byte aligned.
__device__ __forceinline__ void request_row_tile(float* xdst, void* ydst, const float* __restrict__ x,
                                                 const void* __restrict__ y, int tile, int d, uint64_t* bar) {
    const uint32_t x_bytes = (uint32_t)TILE_ROWS * d * 4;
    tf32x3::fence_proxy_async();
    tf32x3::mbar_expect_bytes(bar, x_bytes + TILE_ROWS * 4);
    tf32x3::bulk_copy(xdst, x + (size_t)tile * TILE_ROWS * d, x_bytes, bar);
    tf32x3::bulk_copy(ydst, static_cast<const char*>(y) + (size_t)tile * TILE_ROWS * 4, TILE_ROWS * 4, bar);
}

// out[i] = sum over blocks of partials[b][i], in block order, in double.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                       int row_blocks, long long m) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    double s = 0.0;
    for (int b = 0; b < row_blocks; ++b) s += (double)partials[(size_t)b * m + i];
    out[i] = (float)s;
}

// The second pass over row_blocks partials of m floats each into out.
inline cudaError_t reduce_partials(const float* partials, void* out, int row_blocks, long long m, cudaStream_t stream) {
    reduce_partials_kernel<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(partials, static_cast<float*>(out),
                                                                            row_blocks, m);
    return cudaGetLastError();
}

}  // namespace glm_common
