// Diagonal-block Cholesky + triangular inverse for a batch of small SPD matrices.
//
// Replaces the TPU kernel math_tpu/ops/chol_pallas.py::_chol_inv_kernel (launched
// by _run_block_kernel).  For d (Cb, B, B) float32, row-major, each d[c]
// symmetric positive definite:
//
//     U[c] upper-triangular with d[c] = U[c]^T U[c]
//     W[c] = U[c]^-1, upper-triangular
//
// Only the upper triangle of d (j >= i) is read.  A pivot that is not positive
// (or is NaN) makes that matrix's U NaN from the pivot's row on and its W NaN
// everywhere; the other matrices of the batch are untouched.  Nothing is
// reported through an error code: a density built on the factor sees the NaN.
//
// What bounds it: neither bytes nor operations.  The work is 3*Cb*B*B*4 bytes
// and about (4/3)*B^3*Cb operations, microseconds at the card's rates; the time
// is the chain of dependent steps and the barriers between them.  Done column
// by column (2*B steps, two block barriers per factor column and one thread's
// serial back substitution per column of W), it took about 1 us a step.  So
// the work goes in panels of P = 16 columns, with few barriers and register
// tiles in between:
//  * One thread block per matrix (gridDim.x = Cb).  The TPU kernel folded the
//    batch into one program because its grid runs in order; here the blocks
//    run side by side on different SMs.
//  * Factor, right-looking, upper triangle only, per panel k0:
//      1. one warp factors the diagonal block U_kk in registers, a lane per
//         column, the pivot and the row of U passed by shuffles (P steps, no
//         barrier);
//      2. each thread solves one column of the panel's row block,
//         U[k0:k0+P, k0+P:] = U_kk^-T M[k0:k0+P, k0+P:] (forward substitution,
//         IEEE division), the column in registers;
//      3. all threads make the trailing update M -= U_panel^T U_panel, a warp
//         per 4 rows and a lane per 4 columns 32 apart, depth P in registers.
//    Steps 2 and 3 are compiled for the full panel width (only the last panel
//    may be ragged, and it has no trailing part), so their loops unroll and
//    their loads leave the dependent chains; the clock64 stamps showed these
//    chains, not the barriers, to be the time.
//    Three barriers per panel (24 at B=128) where there were 256.
//  * Inverse by panels: the diagonal blocks W_pp = U_pp^-1 are independent
//    (half a warp each, a lane per column, back substitution).  Then from the
//    bottom row panel up, T = U[i, i+1:] W[i+1:, i+1:] as a register-tiled
//    product and W[i, i+1:] by back substitution with U_ii (a thread per
//    column, P steps), two barriers per panel; T is kept in the unused lower
//    triangle of M, transposed and skewed so that a warp's stores fall on
//    different banks.  The serial column chain of up to B*B/2 dependent FMAs
//    becomes chains of P.  Multiplying by the explicit inverse instead,
//    -W_ii T, put the GP path's float32 error against float64 past its gate.
//  * The residual lives in shared memory and U overwrites it in place; W has
//    its own shared array, zeroed first so that the products may run over its
//    (zero) lower triangle.  B is a runtime argument, any size (ragged
//    panels are masked); shared memory is (2*B*B + 1) words, sized at launch
//    (128 KB at B = 128; B <= 170 fits a block's 232,448 bytes).
//  * Plain float32 FMAs, sqrtf and IEEE division (no fast-math): the products
//    are too small for the tensor cores to pay.
//  * stamps (optional, may be null): thread 0 of block c writes clock64() at
//    five points, stamps[5c + 0..4] = start, loaded, factored, inverted,
//    stored, to split the time between the phases.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int P = 16;         // panel width

__device__ __forceinline__ void stamp(long long* stamps, int at) {
    if (stamps != nullptr && threadIdx.x == 0) stamps[5 * blockIdx.x + at] = clock64();
}

__global__ void __launch_bounds__(THREADS)
chol_inv_block_kernel(const float* __restrict__ d, float* __restrict__ u_out,
                      float* __restrict__ w_out, long long* __restrict__ stamps, int B) {
    extern __shared__ float smem[];
    float* m = smem;                  // (B, B): residual, then U in its upper triangle
    float* w = smem + (size_t)B * B;  // (B, B): W
    int* bad = reinterpret_cast<int*>(w + (size_t)B * B);  // a pivot of this matrix was not positive

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t base = (size_t)blockIdx.x * B * B;
    const int bb = B * B;
    const int np = (B + P - 1) / P;

    stamp(stamps, 0);
    if (tid == 0) *bad = 0;
    for (int idx = tid; idx < bb; idx += THREADS) {
        m[idx] = d[base + idx];
        w[idx] = 0.0f;
    }
    __syncthreads();
    stamp(stamps, 1);

    // --- factor: d = U^T U, by panels of P columns ---------------------------
    for (int k0 = 0; k0 < B; k0 += P) {
        const int kb = min(P, B - k0);
        // 1. the diagonal block, by warp 0 in registers: lane c < kb holds
        //    column c of the block; the pivot and row j of U travel by shuffles
        if (warp == 0) {
            const int c = lane;
            float col[P];
#pragma unroll
            for (int a = 0; a < P; ++a) col[a] = (c < kb && a <= c) ? m[(k0 + a) * B + k0 + c] : 0.0f;
#pragma unroll
            for (int j = 0; j < P; ++j) {
                if (j < kb) {
                    const float p = __shfl_sync(0xffffffffu, col[j], j);
                    const bool ok = p > 0.0f;  // false for NaN too
                    const float pivot = ok ? sqrtf(p) : nanf("");
                    if (!ok && lane == 0) *bad = 1;
                    if (c >= j && c < kb) col[j] = col[j] / pivot;  // row j of U
#pragma unroll
                    for (int a = j + 1; a < P; ++a) {
                        const float uja = __shfl_sync(0xffffffffu, col[j], a);
                        if (c >= a && c < kb) col[a] = fmaf(-uja, col[j], col[a]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < P; ++a) {
                if (c < kb && a <= c) m[(k0 + a) * B + k0 + c] = col[a];
            }
        }
        const int t0 = k0 + kb;  // first trailing row / column
        if (t0 >= B) break;      // the last panel, the only one that may be ragged
        __syncthreads();
        // 2. the panel's row block, a thread per column, the column in registers
        for (int j = t0 + tid; j < B; j += THREADS) {
            float xc[P];
#pragma unroll
            for (int i = 0; i < P; ++i) xc[i] = m[(k0 + i) * B + j];
#pragma unroll
            for (int i = 0; i < P; ++i) {
                float acc = xc[i];
#pragma unroll
                for (int l = 0; l < i; ++l) acc = fmaf(-m[(k0 + l) * B + k0 + i], xc[l], acc);
                xc[i] = acc / m[(k0 + i) * B + k0 + i];
            }
#pragma unroll
            for (int i = 0; i < P; ++i) m[(k0 + i) * B + j] = xc[i];
        }
        __syncthreads();
        // 3. trailing update of the upper triangle: rows i0..i0+3 a warp,
        //    columns lane + 32c a lane
        const int tn = B - t0;
        for (int rg = warp; 4 * rg < tn; rg += WARPS) {
            const int i0 = t0 + 4 * rg;
            for (int jb = t0 + ((4 * rg) & ~31); jb < B; jb += 128) {
                float s[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll
                for (int l = 0; l < P; ++l) {
                    const float* ul = m + (k0 + l) * B;
                    float ui[4], uj[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) ui[r] = i0 + r < B ? ul[i0 + r] : 0.0f;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int j = jb + lane + 32 * c;
                        uj[c] = j < B ? ul[j] : 0.0f;
                    }
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(ui[r], uj[c], s[r][c]);
                }
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int i = i0 + r;
                        const int j = jb + lane + 32 * c;
                        if (i < B && j < B && j >= i) m[i * B + j] -= s[r][c];
                    }
                }
            }
        }
        __syncthreads();
    }
    __syncthreads();
    stamp(stamps, 2);

    // --- inverse: W = U^-1 by panels -----------------------------------------
    // diagonal blocks, half a warp each, a lane per column (back substitution)
    for (int p = tid >> 4; p < np; p += THREADS / 16) {
        const int p0 = p * P;
        const int cc = tid & 15;
        if (cc < min(P, B - p0)) {
            const int col = p0 + cc;
            for (int k = cc; k >= 0; --k) {
                const int rk = p0 + k;
                float acc = (k == cc) ? 1.0f : 0.0f;
                for (int j = k + 1; j <= cc; ++j) acc = fmaf(-m[rk * B + p0 + j], w[(p0 + j) * B + col], acc);
                w[rk * B + col] = acc / m[rk * B + rk];
            }
        }
    }
    __syncthreads();
    // off-diagonal row panels, bottom up: rows i0 + 2*warp, +1; columns lane + 32c
    for (int ip = np - 2; ip >= 0; --ip) {
        const int i0 = ip * P;
        const int j0 = i0 + P;
        const int r0 = 2 * warp;
        // T[r][j] = sum_{l >= j0} U[i0+r][l] W[l][j]   (W[l][j] = 0 for l > j),
        // kept at m[j][i0 + (r + j) % P], below the diagonal since j >= j0
        for (int jb = j0; jb < B; jb += 128) {
            float s[2][4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
            const int lend = min(B, jb + 128);
            for (int l = j0; l < lend; ++l) {
                const float u0 = m[(i0 + r0) * B + l];
                const float u1 = m[(i0 + r0 + 1) * B + l];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = jb + lane + 32 * c;
                    const float wv = j < B ? w[l * B + j] : 0.0f;
                    s[0][c] = fmaf(u0, wv, s[0][c]);
                    s[1][c] = fmaf(u1, wv, s[1][c]);
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = jb + lane + 32 * c;
                if (j < B) {
#pragma unroll
                    for (int r = 0; r < 2; ++r) m[j * B + i0 + (r0 + r + j) % P] = s[r][c];
                }
            }
        }
        __syncthreads();
        // rows i0 .. i0+P-1 of W beyond the panel by back substitution with
        // U_ii, a thread per column: W[k][j] = (-T[k][j] - sum_{k < q < i0+P}
        // U[k][q] W[q][j]) / U[k][k], the order of the column-by-column kernel
        for (int j = j0 + tid; j < B; j += THREADS) {
            float xc[P];
#pragma unroll
            for (int k = P - 1; k >= 0; --k) {
                const int rk = i0 + k;
                float acc = -m[j * B + i0 + (k + j) % P];
#pragma unroll
                for (int q = k + 1; q < P; ++q) acc = fmaf(-m[rk * B + i0 + q], xc[q], acc);
                xc[k] = acc / m[rk * B + rk];
            }
#pragma unroll
            for (int k = 0; k < P; ++k) w[(i0 + k) * B + j] = xc[k];
        }
        __syncthreads();
    }
    stamp(stamps, 3);

    const bool poisoned = *bad != 0;
    for (int idx = tid; idx < bb; idx += THREADS) {
        const int i = idx / B;
        const int j = idx - i * B;
        u_out[base + idx] = (j >= i) ? m[idx] : 0.0f;
        w_out[base + idx] = poisoned ? nanf("") : w[idx];
    }
    stamp(stamps, 4);
}

}  // namespace

// Bytes of dynamic shared memory one block needs for (b, b) matrices.
extern "C" long long chol_inv_block_smem_bytes(int b) {
    return (long long)sizeof(float) * (2LL * b * b + 1);
}

// d, u, w: (cb, b, b) float32, contiguous; stamps: (cb, 5) int64 or null.
// Returns the CUDA error code of the launch (0: it was accepted).
extern "C" int chol_inv_block_launch_stamped(const void* d, void* u, void* w, void* stamps, int cb, int b,
                                             void* stream_ptr) {
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const size_t smem = (size_t)chol_inv_block_smem_bytes(b);
    cudaError_t err = cudaFuncSetAttribute(chol_inv_block_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_block_kernel<<<cb, THREADS, smem, stream>>>(
        static_cast<const float*>(d), static_cast<float*>(u), static_cast<float*>(w),
        static_cast<long long*>(stamps), b);
    return (int)cudaGetLastError();
}

// d, u, w: (cb, b, b) float32, contiguous.  Returns the CUDA error code of the
// launch (0: it was accepted).
extern "C" int chol_inv_block_launch(const void* d, void* u, void* w, int cb, int b, void* stream_ptr) {
    return chol_inv_block_launch_stamped(d, u, w, nullptr, cb, b, stream_ptr);
}
