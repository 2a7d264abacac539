// Fused GLM log-prob + parameter gradients for a batch of chains: two of the
// port's three GLM kernels, which share their tiles, their two products and
// their second pass.  The third, the categorical logit, is in
// glm_categorical.cu (tensor cores, 3xTF32).
//
// Replaces the TPU kernels of math_tpu/ops/pallas_glm.py:
//
//   glm_fused_kernel<F>      _glm_kernel          four families, eta = x @ beta + alpha
//   glm_ordered_kernel       _ordered_kernel      ordered-logistic GLM
//
// Four families.  y (N,), x (N, K) row-major, alpha (C,), beta (K, C) row-major
// and, for the sigma/phi families, extra (C,), all float32:
//
//     logp = sum_n lp(eta, y, extra)   ga = sum_n theta'   gb = x^T theta'
//     ge   = sum_n d lp / d extra      theta' = d lp / d eta
//
// Only the eta-dependent part of the density is computed here; terms in
// (y, extra) alone (-N log sigma, the lgamma terms of NB-2) stay in PyTorch.
//
// Ordered logistic.  y (N,) int32 in 1..K, x (N, D), beta (D, C), cuts (K-1, C):
//
//     u2 = c_y - eta,  u1 = c_{y-1} - eta              c_0 = -1e4, c_K = +1e4
//     lp = u2 - sp(u2) - sp(u1) + log1m_exp(u1 - u2)   sp = softplus
//     w2 = exp(u2 - 2 sp(u2) - lp),  w1 = exp(u1 - 2 sp(u1) - lp)
//     logp = sum_n lp,  gbeta = x^T (w1 - w2),  gcuts_j = sum_{y=j} w2 - sum_{y=j+1} w1
//
// The categories are assumed valid (as the JAX dispatchers assume); y is
// clamped into 1..K only so that an invalid value cannot read outside a tile.
//
// What bounds them: operations.  The two products are 4*N*D*C flops on about
// 4*(N*D + N) bytes of data, some 250 flops per
// byte at D=50, C=256, against about 20 where an H100's float32 units
// (67 TFLOP/s outside the tensor cores) meet its memory (3.35 TB/s).  Products
// are plain float32 FMAs, as the TPU kernels pin float32 products: no TF32 mma.
//
// Design (what differs from the TPU kernels, whose grids run in order and
// accumulate into their output blocks):
//  * Blocks run in parallel, so each block loops over many row tiles, keeps
//    its sums on chip, and writes ONE partial per block to a scratch tensor the
//    wrapper allocated; reduce_partials_kernel adds the partials over the
//    blocks in a fixed order in double.  No float atomics: deterministic.
//  * Rows AND chains are tiled, 64 x 64.  Each block stages its beta tile once,
//    then per row tile: the x tile (stage_x_tile), eta by 4x4 register tiles
//    (eta_product), the likelihood core, theta' to shared memory, and the
//    block's x^T theta' from the same staged x tile (xt_theta_product).  x is
//    streamed once per chain tile; a 20 MB design matrix stays in the 50 MB L2.
//  * Ragged edges are masked in the kernels; nothing is padded on the host.
//  * The TPU kernels gather the cut pair and scatter gcuts with one-hot
//    matmuls (the MXU doing a gather); here the pair is read by index from the
//    extended cut tile, and gcuts is summed by one thread per (cut, chain)
//    walking the tile's 64 rows in order.  expm1f / log1pf come from the CUDA
//    math library (the TPU kernel carries a polynomial expm1).
//
// Shared memory per block, 4 bytes a float: kernel 1 64*64 + 2*64*K + 64*K + 64
// (55 KB at K=50); ordered 3*64*64 + 2*64*D + 2*64*K + 64*D + 64 (89 KB at D=50,
// K=5).  The wrappers refuse what does not fit.  Left for the change that makes
// them fast: wgmma with the 3xTF32 split of tf32x3.cuh and bulk-copy staging of
// the x tile into a ring, as glm_categorical.cu does, and one pass over x for
// all chain tiles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // rows per tile
constexpr int TC = 64;        // columns (chains; for the categorical, chain x class) per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 register tile
constexpr int RM = 4;
constexpr int RC = 4;
constexpr float ORD_BIG = 1e4f;  // stands in for the -/+ inf boundary cuts

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ float softplus_f(float t) {
    return fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)));
}

__device__ __forceinline__ float sigmoid_f(float t) {
    const float e = expf(-fabsf(t));
    const float s = 1.0f / (1.0f + e);
    return t >= 0.0f ? s : e * s;
}

// log(1 - exp(t)) for t < 0: the reference's two branches, split at -ln 2.
__device__ __forceinline__ float log1m_exp_f(float t) {
    t = fminf(t, -1e-20f);
    return t > -0.693147f ? logf(-expm1f(t)) : log1pf(-expf(fmaxf(t, -80.0f)));
}

// dst (rows, TC) <- columns c0 .. c0+63 of the row-major src (rows, c), zero
// past the last column.
__device__ __forceinline__ void stage_column_tile(float* dst, const float* __restrict__ src, int rows, int c, int c0) {
    for (int i = threadIdx.x; i < rows * TC; i += THREADS) {
        const int cc = c0 + i % TC;
        dst[i] = cc < c ? src[(size_t)(i / TC) * c + cc] : 0.0f;
    }
}

// The x rows r0 .. r0+63: one contiguous span of TM*d floats, copied flat, 4
// bytes a thread, coalesced (a row of 50 floats is not 16-byte aligned); zeros
// past the last row.
__device__ __forceinline__ void stage_x_tile(float* xs, const float* __restrict__ x, int r0, int n, int d) {
    const long long base = (long long)r0 * d;
    const long long total = (long long)n * d;
    for (int i = threadIdx.x; i < TM * d; i += THREADS) {
        xs[i] = (base + i < total) ? x[base + i] : 0.0f;
    }
}

// acc = x_tile @ b_tile for this thread's rows ty*4 .. ty*4+3 and columns
// tx*4 .. tx*4+3.
__device__ __forceinline__ void eta_product(float (&acc)[RM][RC], const float* xs, const float* bs, int d) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
    }
    const float* xr = xs + (ty * RM) * d;
    for (int kk = 0; kk < d; ++kk) {
        const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * TC + tx * RC);
        const float b[RC] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const float xv = xr[i * d + kk];
#pragma unroll
            for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(xv, b[j], acc[i][j]);
        }
    }
}

// gs (d, TC) += x_tile^T @ th_tile; with kOnesRow also gs row d += the column
// sums of th (x extended by a column of ones).  A thread owns 4 rows of gs
// (k0 .. k0+3) by 4 columns; each entry of gs has exactly one owner.
template <bool kOnesRow>
__device__ __forceinline__ void xt_theta_product(float* gs, const float* xs, const float* th, int d) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int rows = kOnesRow ? d + 1 : d;
    for (int k0 = ty * 4; k0 < rows; k0 += 64) {
        const int kn = min(4, rows - k0);
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
                const int col = k0 + q;
                const float xv = q < kn ? ((!kOnesRow || col < d) ? xs[r * d + col] : 1.0f) : 0.0f;
#pragma unroll
                for (int j = 0; j < RC; ++j) g[q][j] = fmaf(xv, tv[j], g[q][j]);
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q < kn) {
#pragma unroll
                for (int j = 0; j < RC; ++j) gs[(k0 + q) * TC + tx * RC + j] += g[q][j];
            }
        }
    }
}

// Sums of Q per-thread (C,) quantities over the 16 row groups of the block, in
// a fixed order, through red (Q * 16 * TC floats).  Thread tid < Q*TC gets the
// sum of quantity tid / TC at tile column tid % TC; the others get 0.
template <int Q>
__device__ __forceinline__ float row_group_sum(float* red, const float (&v)[Q][RC]) {
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int j = 0; j < RC; ++j) red[(q * 16 + ty) * TC + tx * RC + j] = v[q][j];
    }
    __syncthreads();
    float s = 0.0f;
    if (tid < Q * TC) {
        const int which = tid / TC;
        const int cc = tid % TC;
        for (int g = 0; g < 16; ++g) s += red[(which * 16 + g) * TC + cc];
    }
    return s;
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

// The first pass with its shared memory, then the second pass over the
// partials (m floats a block) into out.  Returns the first CUDA error.
template <typename Kernel, typename... Args>
cudaError_t launch_two_pass(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, float* partials, void* out,
                            long long m, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(args..., partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    reduce_partials_kernel<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(partials, static_cast<float*>(out),
                                                                              (int)grid.x, m);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 1: four families with one linear predictor per chain
// ---------------------------------------------------------------------------

enum Family { BERNOULLI_LOGIT = 0, POISSON_LOG = 1, NORMAL_ID = 2, NEG_BINOMIAL_2_LOG = 3 };

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
                 const float* __restrict__ extra, int n, int k, int c, float* __restrict__ partials) {
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

    stage_column_tile(bs, beta, k, c, c0);
    for (int i = tid; i < k * TC; i += THREADS) gbs[i] = 0.0f;

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

    float sums[3][RC];  // logp, ga, ge
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int j = 0; j < RC; ++j) sums[q][j] = 0.0f;
    }

    const int n_tiles = (n + TM - 1) / TM;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int r0 = t * TM;
        // the previous tile's second product is done with xs and th (and, on
        // the first pass, bs and gbs are staged)
        __syncthreads();
        stage_x_tile(xs, x, r0, n, k);
        if (tid < TM) {
            ys[tid] = (r0 + tid < n) ? y[r0 + tid] : 0.0f;
        }
        __syncthreads();

        float acc[RM][RC];
        eta_product(acc, xs, bs, k);

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
                sums[0][j] += lp;
                sums[1][j] += tp;
                sums[2][j] += de;
                tpv[j] = tp;
            }
            *reinterpret_cast<float4*>(th + rr * TC + tx * RC) =
                make_float4(tpv[0], tpv[1], tpv[2], tpv[3]);
        }
        __syncthreads();

        xt_theta_product<false>(gbs, xs, th, k);
    }
    __syncthreads();

    // th is free now
    const float s = row_group_sum<3>(th, sums);
    float* part = partials + (size_t)blockIdx.x * (size_t)(k + 3) * c;
    if (tid < 3 * TC && c0 + tid % TC < c) part[(size_t)(tid / TC) * c + c0 + tid % TC] = s;
    for (int i = tid; i < k * TC; i += THREADS) {
        const int cc = c0 + i % TC;
        if (cc < c) part[(size_t)(3 + i / TC) * c + cc] = gbs[i];
    }
}

// ---------------------------------------------------------------------------
// Kernel 2: ordered logistic
// ---------------------------------------------------------------------------

// partials: (gridDim.x, D + K, C); row 0 is logp, rows 1..D gbeta, rows D+1.. gcuts.
__global__ void __launch_bounds__(THREADS)
glm_ordered_kernel(const int* __restrict__ y, const float* __restrict__ x,
                   const float* __restrict__ beta, const float* __restrict__ cuts,
                   int n, int d, int c, int kcat, float* __restrict__ partials) {
    extern __shared__ float4 smem4[];
    float* th = reinterpret_cast<float*>(smem4);  // TM * TC        theta' tile
    float* w1s = th + TM * TC;                    // TM * TC        w1 tile
    float* w2s = w1s + TM * TC;                   // TM * TC        w2 tile
    float* bs = w2s + TM * TC;                    // d * TC         beta tile
    float* gbs = bs + d * TC;                     // d * TC         this block's gbeta sums
    float* ce = gbs + d * TC;                     // (kcat+1) * TC  extended cut tile
    float* gcs = ce + (kcat + 1) * TC;            // (kcat-1) * TC  this block's gcuts sums
    float* xs = gcs + (kcat - 1) * TC;            // TM * d         x tile, flat
    int* ys = reinterpret_cast<int*>(xs + TM * d);  // TM

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // chains tx*4 .. tx*4+3 of the tile
    const int ty = tid / 16;  // rows   ty*4 .. ty*4+3 of the tile
    const int c0 = blockIdx.y * TC;

    stage_column_tile(bs, beta, d, c, c0);
    for (int i = tid; i < d * TC; i += THREADS) gbs[i] = 0.0f;
    stage_column_tile(ce + TC, cuts, kcat - 1, c, c0);
    if (tid < TC) {
        ce[tid] = -ORD_BIG;
        ce[kcat * TC + tid] = ORD_BIG;
    }
    for (int i = tid; i < (kcat - 1) * TC; i += THREADS) gcs[i] = 0.0f;

    bool cv[RC];
    float s_lp[1][RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
        cv[j] = c0 + tx * RC + j < c;
        s_lp[0][j] = 0.0f;
    }

    const int n_tiles = (n + TM - 1) / TM;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int r0 = t * TM;
        // the previous tile's second product and cut sums are done with xs,
        // th, w1s, w2s and ys (and, on the first pass, the tiles are staged)
        __syncthreads();
        stage_x_tile(xs, x, r0, n, d);
        if (tid < TM) {
            ys[tid] = (r0 + tid < n) ? min(max(y[r0 + tid], 1), kcat) : 1;
        }
        __syncthreads();

        float acc[RM][RC];
        eta_product(acc, xs, bs, d);

        // the core; theta', w1, w2 to shared memory, the logp sums in registers
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int rr = ty * RM + i;
            const bool rv = (r0 + rr) < n;
            const int yv = ys[rr];
            float tpv[RC], w1v[RC], w2v[RC];
#pragma unroll
            for (int j = 0; j < RC; ++j) {
                const int cc = tx * RC + j;
                const float eta = acc[i][j];
                const float u2 = ce[yv * TC + cc] - eta;
                const float u1 = ce[(yv - 1) * TC + cc] - eta;
                const float sp2 = softplus_f(u2);
                const float sp1 = softplus_f(u1);
                float lp = u2 - sp2 - sp1 + log1m_exp_f(u1 - u2);
                float w2 = expf(u2 - 2.0f * sp2 - lp);
                float w1 = expf(u1 - 2.0f * sp1 - lp);
                const bool ok = rv && cv[j];
                lp = ok ? lp : 0.0f;
                w1 = ok ? w1 : 0.0f;
                w2 = ok ? w2 : 0.0f;
                s_lp[0][j] += lp;
                tpv[j] = w1 - w2;
                w1v[j] = w1;
                w2v[j] = w2;
            }
            *reinterpret_cast<float4*>(th + rr * TC + tx * RC) = make_float4(tpv[0], tpv[1], tpv[2], tpv[3]);
            *reinterpret_cast<float4*>(w1s + rr * TC + tx * RC) = make_float4(w1v[0], w1v[1], w1v[2], w1v[3]);
            *reinterpret_cast<float4*>(w2s + rr * TC + tx * RC) = make_float4(w2v[0], w2v[1], w2v[2], w2v[3]);
        }
        __syncthreads();

        xt_theta_product<false>(gbs, xs, th, d);

        // gcuts: one task per (cut j, chain), the tile's rows in order
        for (int i = tid; i < (kcat - 1) * TC; i += THREADS) {
            const int cut = i / TC + 1;  // 1-based cut index
            const int cc = i % TC;
            float s = 0.0f;
            for (int r = 0; r < TM; ++r) {
                const int yr = ys[r];
                s += (yr == cut ? w2s[r * TC + cc] : 0.0f) - (yr == cut + 1 ? w1s[r * TC + cc] : 0.0f);
            }
            gcs[i] += s;
        }
    }
    __syncthreads();

    // th is free now
    const float s = row_group_sum<1>(th, s_lp);
    float* part = partials + (size_t)blockIdx.x * (size_t)(d + kcat) * c;
    if (tid < TC && c0 + tid < c) part[c0 + tid] = s;
    for (int i = tid; i < d * TC; i += THREADS) {
        const int cc = c0 + i % TC;
        if (cc < c) part[(size_t)(1 + i / TC) * c + cc] = gbs[i];
    }
    for (int i = tid; i < (kcat - 1) * TC; i += THREADS) {
        const int cc = c0 + i % TC;
        if (cc < c) part[(size_t)(1 + d + i / TC) * c + cc] = gcs[i];
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// The C interface.  Each *_launch takes a float32 scratch of row_blocks
// partials and writes out; it returns the CUDA error code of its launches
// (0: both passes were accepted).
// ---------------------------------------------------------------------------

// Bytes of dynamic shared memory one block of kernel 1 needs for k columns.
extern "C" long long glm_fused_smem_bytes(int k) {
    return (long long)sizeof(float) * ((long long)TM * TC + 2LL * k * TC + (long long)TM * k + TM);
}

// partials: (row_blocks, k + 3, c); out: (k + 3, c) with rows logp, ga, ge,
// gb[0..k).  extra may be null for the families without one.
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
    const dim3 grid(row_blocks, (c + TC - 1) / TC);
    const long long m = (long long)(k + 3) * c;
    cudaError_t err;
    switch (family) {
        case BERNOULLI_LOGIT:
            err = launch_two_pass(glm_fused_kernel<BERNOULLI_LOGIT>, grid, smem, stream, pf, out, m, yf, xf, af, bf, ef, n, k, c);
            break;
        case POISSON_LOG:
            err = launch_two_pass(glm_fused_kernel<POISSON_LOG>, grid, smem, stream, pf, out, m, yf, xf, af, bf, ef, n, k, c);
            break;
        case NORMAL_ID:
            err = launch_two_pass(glm_fused_kernel<NORMAL_ID>, grid, smem, stream, pf, out, m, yf, xf, af, bf, ef, n, k, c);
            break;
        case NEG_BINOMIAL_2_LOG:
            err = launch_two_pass(glm_fused_kernel<NEG_BINOMIAL_2_LOG>, grid, smem, stream, pf, out, m, yf, xf, af, bf, ef,
                                  n, k, c);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)err;
}

// Bytes of dynamic shared memory one block of the ordered kernel needs for d
// columns and kcat categories.
extern "C" long long glm_ordered_smem_bytes(int d, int kcat) {
    return (long long)sizeof(float) *
           (3LL * TM * TC + 2LL * d * TC + 2LL * kcat * TC + (long long)TM * d + TM);
}

// partials: (row_blocks, d + kcat, c); out: (d + kcat, c) with rows logp,
// gbeta[0..d), gcuts[0..kcat-1).
extern "C" int glm_ordered_launch(const void* y, const void* x, const void* beta, const void* cuts,
                                  void* partials, void* out, int n, int d, int c, int kcat,
                                  int row_blocks, void* stream_ptr) {
    const dim3 grid(row_blocks, (c + TC - 1) / TC);
    return (int)launch_two_pass(
        glm_ordered_kernel, grid, (size_t)glm_ordered_smem_bytes(d, kcat), reinterpret_cast<cudaStream_t>(stream_ptr),
        static_cast<float*>(partials), out, (long long)(d + kcat) * c, static_cast<const int*>(y),
        static_cast<const float*>(x), static_cast<const float*>(beta), static_cast<const float*>(cuts), n, d, c, kcat);
}
