// Fused GLM log-prob + parameter gradients for a batch of chains, four families.
//
// Replaces the TPU kernel math_tpu/ops/pallas_glm.py::_glm_kernel (launched by
// _fused_forward).  For y (N,), x (N, K) row-major, alpha (C,), beta (K, C)
// row-major and, for the sigma/phi families, extra (C,), all float32:
//
//     eta    = x @ beta + alpha                  (N, C), never leaves the chip
//     logp   = sum_n lp(eta, y, extra)           (C,)
//     theta' = d lp / d eta
//     ga     = sum_n theta'                      (C,)
//     gb     = x^T @ theta'                      (K, C)
//     ge     = sum_n d lp / d extra              (C,)   sigma / phi families
//
// so x is read once for the value and every parameter gradient.  Only the
// eta-dependent part of the density is computed here; terms in (y, extra)
// alone (-N log sigma, the lgamma terms of NB-2) stay in plain PyTorch.
//
// What bounds it: operations.  The two products are 4*N*K*C flops on
// 4*(N*K + N + 2*K*C + 3*C) bytes, about 250 flops per byte at K=50, C=256,
// against about 20 flops per byte where an H100's float32 units (67 TFLOP/s
// outside the tensor cores) meet its memory (3.35 TB/s).  Products are plain
// float32 FMAs, as the TPU kernel pins float32 products: no TF32 mma.
//
// Design (what differs from the TPU kernel, whose grid runs in order and
// accumulates into its output block):
//  * Blocks run in parallel, so each block loops over many row tiles, keeps
//    its sums on chip, and writes ONE partial per block to a scratch tensor
//    the wrapper allocated; a second small kernel adds the partials over the
//    blocks in a fixed order in double.  No float atomics: the result is
//    deterministic.
//  * A (1024, C) eta tile does not fit a block's shared memory, so rows AND
//    chains are tiled, 64 x 64.  Each block stages its beta tile once, then
//    per row tile: the x tile, eta by 4x4 register tiles, the family core,
//    theta' to shared memory, and the block's gb contribution from the same
//    staged x tile.  Tiling chains means x is streamed once per chain tile
//    (4 times at C=256); a 20 MB design matrix stays in the 50 MB L2, so the
//    device memory still sees it about once.
//  * Ragged edges (N not a multiple of 64, C not a multiple of 64) are masked
//    in the kernel; nothing is padded or copied on the host side.
//  * A row of K=50 floats is 200 bytes, so rows are not 16-byte aligned; a
//    tile of 64 consecutive rows is one contiguous span and is copied flat,
//    4 bytes a thread, coalesced.
//
// Left for the change that makes it fast: wgmma with a 3xTF32 split (or
// packed FMA), TMA staging of the x tile into a ring so loads overlap the
// products, persistent blocks sized to the SM count, and a single pass over x
// for all chain tiles (a cluster sharing the x tile).  Shared memory is
// 4*(64*64 + 2*64*K + 64*K + 64) bytes (55 KB at K=50), which limits K to 280.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // rows per tile
constexpr int TC = 64;        // chains per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 register tile
constexpr int RM = 4;
constexpr int RC = 4;

enum Family { BERNOULLI_LOGIT = 0, POISSON_LOG = 1, NORMAL_ID = 2, NEG_BINOMIAL_2_LOG = 3 };

__device__ __forceinline__ float softplus_f(float t) {
    return fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)));
}

__device__ __forceinline__ float sigmoid_f(float t) {
    const float e = expf(-fabsf(t));
    const float s = 1.0f / (1.0f + e);
    return t >= 0.0f ? s : e * s;
}

// Family cores: lp(eta), theta' = dlp/deta, de = dlp/dextra.  aux is
// 1/sigma for normal_id and log(phi) for neg_binomial_2_log.
template <int F>
__device__ __forceinline__ void glm_core(float eta, float y, float extra, float aux,
                                         float& lp, float& tp, float& de) {
    if (F == BERNOULLI_LOGIT) {
        const float sign = 2.0f * y - 1.0f;
        lp = -softplus_f(-sign * eta);
        tp = y - sigmoid_f(eta);
        de = 0.0f;
    } else if (F == POISSON_LOG) {
        const float mu = expf(eta);
        lp = y * eta - mu;
        tp = y - mu;
        de = 0.0f;
    } else if (F == NORMAL_ID) {
        const float z = (y - eta) * aux;
        lp = -0.5f * z * z;
        tp = z * aux;
        de = z * z * aux;
    } else {
        // lse = log(exp(eta) + phi), overflow-safe
        const float m = fmaxf(eta, aux);
        const float lse = m + log1pf(expf(-fabsf(eta - aux)));
        lp = y * eta - (y + extra) * lse;
        tp = y - (y + extra) * sigmoid_f(eta - aux);
        de = -lse - (y + extra) * expf(-lse);
    }
}

// partials: (gridDim.x, K + 3, C); rows 0, 1, 2 are logp, ga, ge, rows 3.. are gb.
template <int F>
__global__ void __launch_bounds__(THREADS)
glm_fused_kernel(const float* __restrict__ y, const float* __restrict__ x,
                 const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ extra, float* __restrict__ partials,
                 int n, int k, int c) {
    extern __shared__ float4 smem4[];
    float* th = reinterpret_cast<float*>(smem4);  // TM * TC   theta' tile
    float* bs = th + TM * TC;                     // k * TC    beta tile
    float* gbs = bs + k * TC;                     // k * TC    this block's gb sums
    float* xs = gbs + k * TC;                     // TM * k    x tile, flat
    float* ys = xs + TM * k;                      // TM

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // chains tx*4 .. tx*4+3 of the tile
    const int ty = tid / 16;  // rows   ty*4 .. ty*4+3 of the tile
    const int c0 = blockIdx.y * TC;
    constexpr bool kHasExtra = (F == NORMAL_ID) || (F == NEG_BINOMIAL_2_LOG);

    for (int i = tid; i < k * TC; i += THREADS) {
        const int kk = i / TC;
        const int cc = c0 + i % TC;
        bs[i] = cc < c ? beta[(size_t)kk * c + cc] : 0.0f;
        gbs[i] = 0.0f;
    }

    float a[RC], e0[RC], e1[RC];
    bool cv[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
        const int cc = c0 + tx * RC + j;
        cv[j] = cc < c;
        a[j] = cv[j] ? alpha[cc] : 0.0f;
        e0[j] = (kHasExtra && cv[j]) ? extra[cc] : 1.0f;
        e1[j] = (F == NORMAL_ID) ? 1.0f / e0[j] : ((F == NEG_BINOMIAL_2_LOG) ? logf(e0[j]) : 0.0f);
    }

    float s_lp[RC], s_ga[RC], s_ge[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
        s_lp[j] = 0.0f;
        s_ga[j] = 0.0f;
        s_ge[j] = 0.0f;
    }

    const int n_tiles = (n + TM - 1) / TM;
    const long long total = (long long)n * k;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int r0 = t * TM;
        const long long base = (long long)r0 * k;
        // the previous tile's second product is done with xs and th (and, on
        // the first pass, bs and gbs are staged)
        __syncthreads();
        for (int i = tid; i < TM * k; i += THREADS) {
            xs[i] = (base + i < total) ? x[base + i] : 0.0f;
        }
        if (tid < TM) {
            ys[tid] = (r0 + tid < n) ? y[r0 + tid] : 0.0f;
        }
        __syncthreads();

        // eta = x_tile @ beta_tile, 4 rows x 4 chains a thread
        float acc[RM][RC];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
            for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
        }
        const float* xr = xs + (ty * RM) * k;
        for (int kk = 0; kk < k; ++kk) {
            const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * TC + tx * RC);
            const float b[RC] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const float xv = xr[i * k + kk];
#pragma unroll
                for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(xv, b[j], acc[i][j]);
            }
        }

        // family core; theta' to shared memory, the (C,) sums stay in registers
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int rr = ty * RM + i;
            const bool rv = (r0 + rr) < n;
            const float yv = ys[rr];
            float tpv[RC];
#pragma unroll
            for (int j = 0; j < RC; ++j) {
                float lp, tp, de;
                glm_core<F>(acc[i][j] + a[j], yv, e0[j], e1[j], lp, tp, de);
                const bool ok = rv && cv[j];
                lp = ok ? lp : 0.0f;
                tp = ok ? tp : 0.0f;
                de = ok ? de : 0.0f;
                s_lp[j] += lp;
                s_ga[j] += tp;
                s_ge[j] += de;
                tpv[j] = tp;
            }
            *reinterpret_cast<float4*>(th + rr * TC + tx * RC) =
                make_float4(tpv[0], tpv[1], tpv[2], tpv[3]);
        }
        __syncthreads();

        // gb += x_tile^T @ theta'_tile: a thread owns 4 columns of x (k0..k0+3)
        // by 4 chains; each (k, chain) of gbs has exactly one owner
        for (int k0 = ty * 4; k0 < k; k0 += 64) {
            const int kn = min(4, k - k0);
            float g[4][RC];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
                for (int j = 0; j < RC; ++j) g[q][j] = 0.0f;
            }
            for (int r = 0; r < TM; ++r) {
                const float4 t4 = *reinterpret_cast<const float4*>(th + r * TC + tx * RC);
                const float tv[RC] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float xv = q < kn ? xs[r * k + k0 + q] : 0.0f;
#pragma unroll
                    for (int j = 0; j < RC; ++j) g[q][j] = fmaf(xv, tv[j], g[q][j]);
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q < kn) {
#pragma unroll
                    for (int j = 0; j < RC; ++j) gbs[(k0 + q) * TC + tx * RC + j] += g[q][j];
                }
            }
        }
    }
    __syncthreads();

    // (C,) sums: across the 16 row groups in a fixed order; th is free now
    float* red = th;  // 3 x 16 x TC
#pragma unroll
    for (int j = 0; j < RC; ++j) {
        red[(0 * 16 + ty) * TC + tx * RC + j] = s_lp[j];
        red[(1 * 16 + ty) * TC + tx * RC + j] = s_ga[j];
        red[(2 * 16 + ty) * TC + tx * RC + j] = s_ge[j];
    }
    __syncthreads();

    float* part = partials + (size_t)blockIdx.x * (size_t)(k + 3) * c;
    if (tid < 3 * TC) {
        const int which = tid / TC;
        const int cc = tid % TC;
        float s = 0.0f;
        for (int q = 0; q < 16; ++q) s += red[(which * 16 + q) * TC + cc];
        if (c0 + cc < c) part[(size_t)which * c + c0 + cc] = s;
    }
    for (int i = tid; i < k * TC; i += THREADS) {
        const int kk = i / TC;
        const int cc = c0 + i % TC;
        if (cc < c) part[(size_t)(3 + kk) * c + cc] = gbs[i];
    }
}

// out[i] = sum over blocks of partials[b][i], in block order, in double.
__global__ void glm_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                  int row_blocks, int m) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    double s = 0.0;
    for (int b = 0; b < row_blocks; ++b) s += (double)partials[(size_t)b * m + i];
    out[i] = (float)s;
}

template <int F>
cudaError_t launch_family(const float* y, const float* x, const float* alpha, const float* beta,
                          const float* extra, float* partials, int n, int k, int c,
                          int row_blocks, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(glm_fused_kernel<F>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(row_blocks, (c + TC - 1) / TC);
    glm_fused_kernel<F><<<grid, THREADS, smem, stream>>>(y, x, alpha, beta, extra, partials, n, k, c);
    return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for k columns.
extern "C" long long glm_fused_smem_bytes(int k) {
    return (long long)sizeof(float) * ((long long)TM * TC + 2LL * k * TC + (long long)TM * k + TM);
}

// partials: (row_blocks, k + 3, c) float32 scratch; out: (k + 3, c) float32 with
// rows logp, ga, ge, gb[0..k).  extra may be null for the families without one.
// Returns the CUDA error code of the launches (0: both were accepted).
extern "C" int glm_fused_launch(int family, const void* y, const void* x, const void* alpha,
                                const void* beta, const void* extra, void* partials, void* out,
                                int n, int k, int c, int row_blocks, void* stream_ptr) {
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const float* yf = static_cast<const float*>(y);
    const float* xf = static_cast<const float*>(x);
    const float* af = static_cast<const float*>(alpha);
    const float* bf = static_cast<const float*>(beta);
    const float* ef = static_cast<const float*>(extra);
    float* pf = static_cast<float*>(partials);
    const size_t smem = (size_t)glm_fused_smem_bytes(k);
    cudaError_t err;
    switch (family) {
        case BERNOULLI_LOGIT:
            err = launch_family<BERNOULLI_LOGIT>(yf, xf, af, bf, ef, pf, n, k, c, row_blocks, smem, stream);
            break;
        case POISSON_LOG:
            err = launch_family<POISSON_LOG>(yf, xf, af, bf, ef, pf, n, k, c, row_blocks, smem, stream);
            break;
        case NORMAL_ID:
            err = launch_family<NORMAL_ID>(yf, xf, af, bf, ef, pf, n, k, c, row_blocks, smem, stream);
            break;
        case NEG_BINOMIAL_2_LOG:
            err = launch_family<NEG_BINOMIAL_2_LOG>(yf, xf, af, bf, ef, pf, n, k, c, row_blocks, smem,
                                                    stream);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const int m = (k + 3) * c;
    glm_reduce_kernel<<<(m + 255) / 256, 256, 0, stream>>>(pf, static_cast<float*>(out), row_blocks, m);
    return (int)cudaGetLastError();
}
