// The column-by-column block kernel that csrc/chol_inv_block.cu replaced, kept
// only to measure it: tools/phase_clocks.py builds it and reads clock64()
// stamps that thread 0 of each block writes at five points (start, loaded,
// factored, inverted, stored) into stamps (Cb, 5).  Otherwise the kernel as it
// was:
//
// Diagonal-block Cholesky + triangular inverse for a batch of small SPD matrices.
//
// Replaces the TPU kernel math_tpu/ops/chol_pallas.py::_chol_inv_kernel (launched
// by _run_block_kernel).  For d (Cb, B, B) float32, row-major, each d[c]
// symmetric positive definite:
//
//     U[c] upper-triangular with d[c] = U[c]^T U[c]     (B right-looking steps)
//     W[c] = U[c]^-1, upper-triangular                  (B back-substitution steps)
//
// Only the upper triangle of d (j >= i) is read.  A pivot that is not positive
// (or is NaN) makes that matrix's U NaN from the pivot's row on and its W NaN
// everywhere; the other matrices of the batch are untouched.  Nothing is
// reported through an error code: a density built on the factor sees the NaN.
//
// What bounds it: neither bytes nor operations.  The work is 3*Cb*B*B*4 bytes
// and about (4/3)*B^3*Cb operations, microseconds at the card's rates; the time
// is the chain of 2*B dependent steps, each a few shared-memory round trips and
// (in the factor phase) two block-wide barriers.  So the design keeps every
// step on chip and as short as it can be:
//  * One thread block per matrix (gridDim.x = Cb).  The TPU kernel folded the
//    batch into one program because its grid runs in order; here the blocks
//    run side by side on different SMs.
//  * The residual lives in shared memory for all steps and U overwrites it in
//    place: row k is final once it is scaled.  W has its own shared array.
//  * The pivot is a shared-memory read of m[k][k].  The rank-1 update touches
//    only k < i <= j: one warp per row i, lanes along j, so a warp reads and
//    writes consecutive words (no bank conflicts) and u[k][i] is a broadcast.
//  * The inverse phase has no dependence across columns: column c of W needs
//    only column c of the rows below.  Each thread runs the whole substitution
//    for its own column; the loop over rows is uniform over the block so that
//    U[k][j] is a broadcast read, and there is no barrier per step.
//  * B is a runtime argument; shared memory is (2*B*B + B + 1) words, sized at
//    launch (128.5 KB at B = 128; B <= 170 fits a block's 232,448 bytes).
//  * Plain float32 FMAs, sqrtf and IEEE division (no fast-math).
//
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: a warp per row of the rank-1 update

__global__ void __launch_bounds__(THREADS)
chol_inv_block_kernel(const float* __restrict__ d, float* __restrict__ u_out,
                      float* __restrict__ w_out, int B, long long* __restrict__ stamps) {
    extern __shared__ float smem[];
    float* m = smem;                  // (B, B): residual, then U in its upper triangle
    float* w = smem + (size_t)B * B;  // (B, B): W
    float* urow = w + (size_t)B * B;  // (B,): row k of U during step k
    int* bad = reinterpret_cast<int*>(urow + B);  // a pivot of this matrix was not positive

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    constexpr int WARPS = THREADS / 32;
    const size_t base = (size_t)blockIdx.x * B * B;
    const int bb = B * B;

    if (tid == 0) stamps[5 * blockIdx.x + 0] = clock64();
    if (tid == 0) *bad = 0;
    for (int idx = tid; idx < bb; idx += THREADS) m[idx] = d[base + idx];
    __syncthreads();

    if (tid == 0) stamps[5 * blockIdx.x + 1] = clock64();
    // --- factor: d = U^T U, right-looking, upper triangle only ---------------
    for (int k = 0; k < B; ++k) {
        const float p = m[k * B + k];
        const bool ok = p > 0.0f;  // false for NaN too
        const float pivot = ok ? sqrtf(p) : nanf("");
        if (!ok && tid == 0) *bad = 1;
        for (int j = k + tid; j < B; j += THREADS) urow[j] = m[k * B + j] / pivot;
        __syncthreads();  // every read of row k is done; urow is visible
        for (int j = k + tid; j < B; j += THREADS) m[k * B + j] = urow[j];
        for (int i = k + 1 + warp; i < B; i += WARPS) {
            const float ui = urow[i];
            float* mi = m + i * B;
            for (int j = i + lane; j < B; j += 32) mi[j] = fmaf(-ui, urow[j], mi[j]);
        }
        __syncthreads();  // the residual is updated before the next pivot is read
    }

    if (tid == 0) stamps[5 * blockIdx.x + 2] = clock64();
    // --- inverse: column c of W = U^-1 by back substitution, no barriers -----
    for (int c = tid; c < B; c += THREADS) {
        for (int k = B - 1; k >= 0; --k) {
            float val = 0.0f;
            if (k <= c) {
                float acc = (k == c) ? 1.0f : 0.0f;
                const float* uk = m + k * B;
                for (int j = k + 1; j <= c; ++j) acc = fmaf(-uk[j], w[j * B + c], acc);
                val = acc / uk[k];
            }
            w[k * B + c] = val;
        }
    }
    __syncthreads();

    if (tid == 0) stamps[5 * blockIdx.x + 3] = clock64();
    const bool poisoned = *bad != 0;
    for (int idx = tid; idx < bb; idx += THREADS) {
        const int i = idx / B;
        const int j = idx - i * B;
        u_out[base + idx] = (j >= i) ? m[idx] : 0.0f;
        w_out[base + idx] = poisoned ? nanf("") : w[idx];
    }
    __syncthreads();
    if (tid == 0) stamps[5 * blockIdx.x + 4] = clock64();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for (b, b) matrices.
extern "C" long long chol_inv_block_smem_bytes(int b) {
    return (long long)sizeof(float) * (2LL * b * b + b + 1);
}

// d, u, w: (cb, b, b) float32, contiguous; stamps (cb, 5) int64.  Returns the
// CUDA error code of the launch (0: it was accepted).
extern "C" int chol_inv_block_launch(const void* d, void* u, void* w, void* stamps, int cb, int b,
                                     void* stream_ptr) {
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const size_t smem = (size_t)chol_inv_block_smem_bytes(b);
    cudaError_t err = cudaFuncSetAttribute(chol_inv_block_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_block_kernel<<<cb, THREADS, smem, stream>>>(
        static_cast<const float*>(d), static_cast<float*>(u), static_cast<float*>(w), b,
        static_cast<long long*>(stamps));
    return (int)cudaGetLastError();
}
