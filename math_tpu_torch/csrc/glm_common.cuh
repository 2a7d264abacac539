// Pieces shared by the GLM kernels of this directory (glm_fused.cu,
// glm_categorical.cu): the staging of one 64-row tile of x and y by bulk
// copies, and the second pass that adds the blocks' partials.  sm_90a only
// (the bulk copy).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace glm_common {

constexpr int TILE_ROWS = 64;  // rows of x per tile in every GLM kernel

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
