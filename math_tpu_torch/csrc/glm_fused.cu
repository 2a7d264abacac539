// Fused GLM log-prob + parameter gradients for a batch of chains: two of the
// port's three GLM kernels, which share their tiles, their two products and
// their second pass.  The third, the categorical logit, is in
// glm_categorical.cu, on the tensor cores (3xTF32) at every shape.
//
// Replaces the TPU kernels of math_tpu/ops/pallas_glm.py:
//
//   glm_fused_kernel<F>          _glm_kernel          four families, eta = x @ beta + alpha
//   glm_ordered_kernel           _ordered_kernel      ordered-logistic GLM
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
// Two routes for each.  Both compute the same function and write the same
// partials; the wrapper (ops/glm_fused.py::glm_tile_plan) picks by shape alone:
//
//   glm_tc_kernel<F, 0, W>        the four families   on the tensor cores, D <= 63
//   glm_tc_kernel<ORDERED, K, W>  ordered, K <= 8     (3xTF32), the main path's
//   glm_fused_kernel<F>           the four families   float32 FMAs, any D: the
//   glm_ordered_kernel            ordered, any K      shapes the first cannot hold
//
// What bounds them: operations.  The two products are 4*N*D*C flops on about
// 4*(N*D + N) bytes of data, some 250 flops per byte at D=50, C=256, against
// about 20 where an H100's float32 units (67 TFLOP/s outside the tensor cores)
// meet its memory (3.35 TB/s).  The TPU kernels pin float32 products, and one
// TF32 product keeps some three digits, so on the tensor cores each product is
// three TF32 products (tf32x3.cuh): 3 x 4*N*D*C flops at 495 TFLOP/s, 0.031
// ms at N=100,000, D=50, C=256, against 0.083 ms for the FMAs alone.  The
// likelihood cores (7-8 calls of exp / log a (row, chain) in the ordered one)
// then come close to the products' time on the float32 units.
//
// Design of the tensor-core kernels.  There is one linear predictor per chain,
// so both products are taken transposed, with the chains as the M dimension
// of wgmma (64 chains a pair of warpgroups, the pair's two warpgroups taking
// rows 0-31 and 32-63 of each tile; a block has two pairs, 128 chains, and
// walks its share of the 64-row tiles of x; one block an SM):
//  * Product 1, eta^T (64 chains x 32 rows) = beta^T (64 x Dp) @ x_rows^T, by
//    m64n32k8: A is beta's tile, staged once per block as hi/lo K-major tiles
//    and read by descriptor; B is the x tile in the K-major core-matrix layout
//    (x1: row x feature), hi and lo, split once per tile.  Dp/8 k8 steps of
//    three products, all in flight together: first the two small products of
//    every step, then the large ones (the tensor core's sums truncate toward
//    zero; taken per step, the small terms' truncations biased eta by up to
//    ~15 ulp, which exp(eta) carried into poisson's gradients).
//  * The core runs on the accumulator registers: element (chain, row), two
//    chains a thread (alpha, extra, the ordered cut tile's row belong to the
//    chain), 8 rows (y from the staged tile).  lp, ge and the ordered gcuts
//    are summed per thread in a fixed order, over the quad by shuffles, and the
//    tile sums go into the block's sums in double.  The cut pair is read by
//    index from the (chain x (K+1)) extended cut tile; u1 - u2 = c_{y-1} - c_y
//    does not depend on eta, so its log1m_exp is taken once per (chain,
//    category) when the block starts; gcuts is unrolled over the K-1 cuts
//    (compiled per K), selects on y, no scatter.  Splitting the rows over two
//    warpgroups gives each thread half the core and the SM twice the warps:
//    with one warpgroup a tile the warp schedulers sat idle on the core's
//    dependent chains of exp / log1p.
//  * Product 2, [gb; ga]^T (64 chains x 64 features) = theta'^T @ [x, 1] over
//    the warpgroup's 32 rows, by m64n64k8: A is
//    theta' itself, split into hi/lo in the registers that product 1 left
//    it in.  The accumulator holds columns 8j+2t, 8j+2t+1 where A's fragment
//    for k8 step j wants columns t and t+4, so product 2's B (x2: feature x
//    position, K-major, with a row of ones at feature D for ga) holds row 2t
//    of each group of 8 at position t and row 2t+1 at t+4 (k8_position).
//    theta' never touches shared memory.  D + 1 <= 64 columns: one n64
//    product; x2's rows past D are zeros, set once.  Each tile's product
//    starts from zero and is added to the block's sums by IEEE adds: the
//    tensor core's float32 sums are not rounded to nearest, and summed over a
//    block's tiles they lost the gradient tolerance (glm_categorical.cu).
//    The pair's two halves are added at the end, half 0 first.
//  * The x and y tile arrives by 1-D bulk copies (one span of 256*D bytes,
//    glm_common.cuh) into a raw buffer, which the layout pass consumes at once;
//    the next tile is asked for right after, so its copy overlaps this tile's
//    products and core.  A ragged last tile is loaded by plain loads, zeros
//    past N; ragged chains are masked at the write-out.  x is staged once per
//    tile for the block's 128 chains.  (Making the next tile's x1 while
//    product 2 runs was slower: issuing product 2's twelve wgmma stalls for
//    most of its run, and x2 then needed a pass of its own.)
//  * One partial per block, added over the blocks in block order in double by
//    reduce_partials_kernel: no atomics, deterministic.
//
// Design of the float32 kernels (they take what the tensor-core layouts
// cannot hold, at any D and K):
//  * Rows AND chains are tiled, 64 x 64, and the features come in slices of
//    DS = 64: per row tile, eta by 4x4 register tiles (eta_product) summed
//    over the slices of x and beta, the likelihood core, theta' to shared
//    memory, then x^T theta' slice by slice (xt_theta_slice, the last slice
//    first: it is still staged).  A slice's gradient sums go straight to the
//    block's own partial in device memory (stored on its first tile, added on
//    the others; one owner thread per entry, so no atomics), which the second
//    pass adds in double.  Shared memory no longer grows with D or K.  With
//    one slice (D <= 64) beta is staged once per block; with more, x is read
//    twice a row tile and beta once a slice.
//  * Ragged edges are masked in the kernels; nothing is padded on the host.
//  * The TPU kernels gather the cut pair and scatter gcuts with one-hot
//    matmuls (the MXU doing a gather); here the pair is read by index from
//    the cuts in device memory, and gcuts is summed by one thread per (cut,
//    chain) walking the tile's 64 rows in order.  expm1f / log1pf come from
//    the CUDA math library (the TPU kernel carries a polynomial expm1).
//
// What bounds the float32 kernels: their products in FP32 FMAs, 4*N*D*C at
// 67 TFLOP/s.  The inner loops take four features a step, a float4 of x per
// row and of beta per feature: 64 FMAs for eight 16-byte shared loads.
//
// Shared memory per block of the float32 kernels, 4 bytes a float: kernel 1
// 3*64*64 + 64 (49 KB); ordered 5*64*64 + 64 (80 KB).  Of the tensor-core kernels: tc_layout_of
// (204-216 KB at D=50); a shape whose block does not fit 227 KB (D = 57-63
// with K = 6-8) goes to the float32 kernels.

#include <cuda_runtime.h>
#include <math.h>

#include "glm_common.cuh"

namespace {

using namespace tf32x3;
using glm_common::request_row_tile;

constexpr int TM = 64;        // rows per tile
constexpr int TC = 64;        // columns (chains) per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 register tile
constexpr int RM = 4;
constexpr int RC = 4;
constexpr float ORD_BIG = 1e4f;  // stands in for the -/+ inf boundary cuts

// ---------------------------------------------------------------------------
// The float32 kernels' pieces
// ---------------------------------------------------------------------------

constexpr int DS = 64;  // features (columns of x) per slice: x and beta are staged DS at a time

__device__ __forceinline__ float lane_of(const float4& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The 4-aligned width of slice s of d features (the staged slice is zero past d).
__device__ __forceinline__ int slice_width(int d, int s) { return (min(DS, d - s * DS) + 3) & ~3; }

// xs (TM x DS) <- rows r0 .. r0+63 and features d0 .. d0+63 of the row-major x
// (n, d); zeros past the last row and feature.  Neighbouring threads read
// neighbouring features of a row.
__device__ __forceinline__ void stage_x_slice(float* xs, const float* __restrict__ x, int r0, int n, int d, int d0) {
    for (int i = threadIdx.x; i < TM * DS; i += THREADS) {
        const int r = r0 + i / DS;
        const int f = d0 + i % DS;
        xs[i] = (r < n && f < d) ? x[(size_t)r * d + f] : 0.0f;
    }
}

// bs (DS x TC) <- features d0 .. d0+63 of columns c0 .. c0+63 of the row-major
// beta (d, c); zeros past the last feature and column.
__device__ __forceinline__ void stage_beta_slice(float* bs, const float* __restrict__ beta, int d, int c, int d0, int c0) {
    for (int i = threadIdx.x; i < DS * TC; i += THREADS) {
        const int f = d0 + i / TC;
        const int cc = c0 + i % TC;
        bs[i] = (f < d && cc < c) ? beta[(size_t)f * c + cc] : 0.0f;
    }
}

// acc += xs @ bs over the slice's first `width` features (a multiple of 4) for
// this thread's rows ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3.  Four features
// a step: a float4 of x per row and a float4 of beta per feature, 64 FMAs for
// eight 16-byte loads.
__device__ __forceinline__ void eta_product(float (&acc)[RM][RC], const float* xs, const float* bs, int width) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const float* xr = xs + (ty * RM) * DS;
    for (int k0 = 0; k0 < width; k0 += 4) {
        float4 xv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * DS + k0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float4 b4 = *reinterpret_cast<const float4*>(bs + (k0 + kk) * TC + tx * RC);
            const float b[RC] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const float xv_i = lane_of(xv[i], kk);
#pragma unroll
                for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(xv_i, b[j], acc[i][j]);
            }
        }
    }
}

// g = xs^T @ th over the tile's TM rows for this thread's slice features
// ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3: one float4 of x and one of theta'
// a row.
__device__ __forceinline__ void xt_theta_slice(float (&g)[4][RC], const float* xs, const float* th) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < RC; ++j) g[q][j] = 0.0f;
    }
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(xs + r * DS + ty * 4);
        const float4 t4 = *reinterpret_cast<const float4*>(th + r * TC + tx * RC);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float tv[RC] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int j = 0; j < RC; ++j) g[q][j] = fmaf(xv[q], tv[j], g[q][j]);
        }
    }
}

// *p = v on the block's first row tile, *p += v on the others.  Each entry of
// a block's partial has one owner thread, the same on every tile.
__device__ __forceinline__ void put_partial(float* p, float v, bool first) { *p = first ? v : *p + v; }

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
    return glm_common::reduce_partials(partials, out, (int)grid.x, m, stream);
}

// Shared memory of the float32 kernels: the same for every D and K (x and
// beta come in slices of DS features; the cuts are read from device memory).
constexpr size_t FUSED_SMEM = sizeof(float) * (TM * TC + DS * TC + TM * DS + TM);
constexpr size_t ORDERED_SMEM = sizeof(float) * (3 * TM * TC + DS * TC + TM * DS + TM);

// eta (this thread's 4 x 4) of the row tile at r0 for the column tile at c0,
// over every slice of the d features; the last slice stays staged in xs.
// beta's slice is staged here unless there is only one (then it is staged
// once per block).
__device__ __forceinline__ void eta_over_slices(float (&acc)[RM][RC], float* xs, float* bs, const float* __restrict__ x,
                                                const float* __restrict__ beta, int r0, int n, int d, int c, int c0) {
    const int n_slices = (d + DS - 1) / DS;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
    }
    for (int s = 0; s < n_slices; ++s) {
        if (s > 0) __syncthreads();  // the previous slice's product is done with xs and bs
        stage_x_slice(xs, x, r0, n, d, s * DS);
        if (n_slices > 1) stage_beta_slice(bs, beta, d, c, s * DS, c0);
        __syncthreads();
        eta_product(acc, xs, bs, slice_width(d, s));
    }
}

// The block's gradient rows from theta' (th) and the row tile's x, slice by
// slice, last slice first (it is still staged): feature f goes to the
// partial's row row0 + f, column c0 + tx*4 + j.
__device__ __forceinline__ void gradient_over_slices(float* part, const float* th, float* xs, const float* __restrict__ x,
                                                     int r0, int n, int d, int c, int c0, int row0, bool first) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int n_slices = (d + DS - 1) / DS;
    for (int s = n_slices - 1; s >= 0; --s) {
        if (s != n_slices - 1) {
            __syncthreads();  // every thread is done with the previous slice
            stage_x_slice(xs, x, r0, n, d, s * DS);
            __syncthreads();
        }
        float g[4][RC];
        xt_theta_slice(g, xs, th);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int f = s * DS + ty * 4 + q;
#pragma unroll
            for (int j = 0; j < RC; ++j) {
                const int cc = c0 + tx * RC + j;
                if (f < d && cc < c) put_partial(part + (size_t)(row0 + f) * c + cc, g[q][j], first);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Kernel 1: four families with one linear predictor per chain
// ---------------------------------------------------------------------------

enum Family { BERNOULLI_LOGIT = 0, POISSON_LOG = 1, NORMAL_ID = 2, NEG_BINOMIAL_2_LOG = 3 };

// The scalar functions of the cores.  The float32 kernels take the CUDA math
// library's; the tensor-core kernels, whose products no longer occupy the
// float32 units, the hardware's approximations (ex2 / lg2 / rcp of the
// special-function unit: __expf within 2 + 1.2|t| ulp, __logf within 2^-21.4
// absolute on [0.5, 2], here on 1 + e with e in (0, 1]), a few instructions
// where the library takes some twenty; about 1e-7 of error a (row, chain)
// against the gates' 2e-5 of logp and 3e-4 / 1e-3*N/3000 of the gradients.
struct LibraryMath {
    static __device__ __forceinline__ float exp(float t) { return expf(t); }
    static __device__ __forceinline__ float log1p(float e) { return log1pf(e); }
    static __device__ __forceinline__ float rcp(float t) { return 1.0f / t; }
};
struct FastMath {
    static __device__ __forceinline__ float exp(float t) { return __expf(t); }
    static __device__ __forceinline__ float log1p(float e) { return __logf(1.0f + e); }
    static __device__ __forceinline__ float rcp(float t) { return __fdividef(1.0f, t); }
};

// softplus(t) = log(1 + exp(t)), overflow-safe.
template <class M = LibraryMath>
__device__ __forceinline__ float softplus_m(float t) {
    return fmaxf(t, 0.0f) + M::log1p(M::exp(-fabsf(t)));
}

// log(1 - exp(t)) for t < 0: the reference's two branches, split at -ln 2.
__device__ __forceinline__ float log1m_exp_f(float t) {
    t = fminf(t, -1e-20f);
    return t > -0.693147f ? logf(-expm1f(t)) : log1pf(-expf(fmaxf(t, -80.0f)));
}

// Family cores: lp(eta), theta' = dlp/deta, de = dlp/dextra.  aux is
// 1/sigma for normal_id and log(phi) for neg_binomial_2_log.
template <int F, class M = LibraryMath>
__device__ __forceinline__ void glm_core(float eta, float y, float extra, float aux,
                                         float& lp, float& tp, float& de) {
    if (F == BERNOULLI_LOGIT) {
        // softplus(-sign*eta) and sigmoid(eta) share exp(-|eta|)
        const float sign = 2.0f * y - 1.0f;
        const float e = M::exp(-fabsf(eta));
        const float s = M::rcp(1.0f + e);
        lp = -(fmaxf(-sign * eta, 0.0f) + M::log1p(e));
        tp = y - (eta >= 0.0f ? s : e * s);
        de = 0.0f;
    } else if (F == POISSON_LOG) {
        const float mu = M::exp(eta);
        lp = y * eta - mu;
        tp = y - mu;
        de = 0.0f;
    } else if (F == NORMAL_ID) {
        const float z = (y - eta) * aux;
        lp = -0.5f * z * z;
        tp = z * aux;
        de = z * z * aux;
    } else {
        // lse = log(exp(eta) + phi), overflow-safe; it shares exp(-|eta - aux|)
        // with sigmoid(eta - aux)
        const float e = M::exp(-fabsf(eta - aux));
        const float s = M::rcp(1.0f + e);
        const float lse = fmaxf(eta, aux) + M::log1p(e);
        lp = y * eta - (y + extra) * lse;
        tp = y - (y + extra) * (eta - aux >= 0.0f ? s : e * s);
        de = -lse - (y + extra) * M::exp(-lse);
    }
}

// partials: (gridDim.x, K + 3, C); rows 0, 1, 2 are logp, ga, ge, rows 3.. are
// gb.  The gb rows are the block's sums over its row tiles, kept in its own
// partial (stored on its first tile, added on the others); logp, ga and ge are
// summed in registers and written at the end.
template <int F>
__global__ void __launch_bounds__(THREADS)
glm_fused_kernel(const float* __restrict__ y, const float* __restrict__ x,
                 const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ extra, int n, int k, int c, float* __restrict__ partials) {
    extern __shared__ float4 smem4[];
    float* th = reinterpret_cast<float*>(smem4);  // TM * TC   theta' tile
    float* bs = th + TM * TC;                     // DS * TC   beta slice
    float* xs = bs + DS * TC;                     // TM * DS   x slice
    float* ys = xs + TM * DS;                     // TM

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // chains tx*4 .. tx*4+3 of the tile
    const int ty = tid / 16;  // rows   ty*4 .. ty*4+3 of the tile
    const int c0 = blockIdx.y * TC;
    constexpr bool kHasExtra = (F == NORMAL_ID) || (F == NEG_BINOMIAL_2_LOG);
    float* part = partials + (size_t)blockIdx.x * (size_t)(k + 3) * c;

    if (k <= DS) stage_beta_slice(bs, beta, k, c, 0, c0);  // one slice: staged once

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
        // the first pass, bs is staged)
        __syncthreads();
        if (tid < TM) {
            ys[tid] = (r0 + tid < n) ? y[r0 + tid] : 0.0f;
        }
        float acc[RM][RC];
        eta_over_slices(acc, xs, bs, x, beta, r0, n, k, c, c0);

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

        gradient_over_slices(part, th, xs, x, r0, n, k, c, c0, 3, t == (int)blockIdx.x);
    }
    __syncthreads();

    // th is free now
    const float s = row_group_sum<3>(th, sums);
    if (tid < 3 * TC && c0 + tid % TC < c) part[(size_t)(tid / TC) * c + c0 + tid % TC] = s;
}

// ---------------------------------------------------------------------------
// Kernel 2: ordered logistic
// ---------------------------------------------------------------------------

// partials: (gridDim.x, D + K, C); row 0 is logp, rows 1..D gbeta, rows D+1..
// gcuts.  gbeta and gcuts are the block's sums in its own partial, as kernel
// 1's gb; the cut pair of a (row, chain) is read from cuts in device memory.
__global__ void __launch_bounds__(THREADS)
glm_ordered_kernel(const int* __restrict__ y, const float* __restrict__ x,
                   const float* __restrict__ beta, const float* __restrict__ cuts,
                   int n, int d, int c, int kcat, float* __restrict__ partials) {
    extern __shared__ float4 smem4[];
    float* th = reinterpret_cast<float*>(smem4);  // TM * TC        theta' tile
    float* w1s = th + TM * TC;                    // TM * TC        w1 tile
    float* w2s = w1s + TM * TC;                   // TM * TC        w2 tile
    float* bs = w2s + TM * TC;                    // DS * TC        beta slice
    float* xs = bs + DS * TC;                     // TM * DS        x slice
    int* ys = reinterpret_cast<int*>(xs + TM * DS);  // TM

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // chains tx*4 .. tx*4+3 of the tile
    const int ty = tid / 16;  // rows   ty*4 .. ty*4+3 of the tile
    const int c0 = blockIdx.y * TC;
    float* part = partials + (size_t)blockIdx.x * (size_t)(d + kcat) * c;

    if (d <= DS) stage_beta_slice(bs, beta, d, c, 0, c0);  // one slice: staged once

    bool cv[RC];
    float s_lp[1][RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
        cv[j] = c0 + tx * RC + j < c;
        s_lp[0][j] = 0.0f;
    }
    // the extended cut c_j of column cc: -/+ORD_BIG at j = 0 and j = kcat
    auto cut = [&](int j, int cc) {
        return j == 0 ? -ORD_BIG : (j == kcat ? ORD_BIG : cuts[(size_t)(j - 1) * c + cc]);
    };

    const int n_tiles = (n + TM - 1) / TM;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int r0 = t * TM;
        const bool first = t == (int)blockIdx.x;
        // the previous tile's second product and cut sums are done with xs,
        // th, w1s, w2s and ys (and, on the first pass, bs is staged)
        __syncthreads();
        if (tid < TM) {
            ys[tid] = (r0 + tid < n) ? min(max(y[r0 + tid], 1), kcat) : 1;
        }
        float acc[RM][RC];
        eta_over_slices(acc, xs, bs, x, beta, r0, n, d, c, c0);

        // the core; theta', w1, w2 to shared memory, the logp sums in registers
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int rr = ty * RM + i;
            const bool rv = (r0 + rr) < n;
            const int yv = ys[rr];
            float tpv[RC], w1v[RC], w2v[RC];
#pragma unroll
            for (int j = 0; j < RC; ++j) {
                const int cc = c0 + tx * RC + j;
                const float eta = acc[i][j];
                const float u2 = (cv[j] ? cut(yv, cc) : 0.0f) - eta;
                const float u1 = (cv[j] ? cut(yv - 1, cc) : 0.0f) - eta;
                const float sp2 = softplus_m(u2);
                const float sp1 = softplus_m(u1);
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

        // gcuts: one task per (cut j, chain), the tile's rows in order
        for (int i = tid; i < (kcat - 1) * TC; i += THREADS) {
            const int cj = i / TC + 1;  // 1-based cut index
            const int cc = i % TC;
            float s = 0.0f;
            for (int r = 0; r < TM; ++r) {
                const int yr = ys[r];
                s += (yr == cj ? w2s[r * TC + cc] : 0.0f) - (yr == cj + 1 ? w1s[r * TC + cc] : 0.0f);
            }
            if (c0 + cc < c) put_partial(part + (size_t)(d + cj) * c + c0 + cc, s, first);
        }

        gradient_over_slices(part, th, xs, x, r0, n, d, c, c0, 1, first);
    }
    __syncthreads();

    // th is free now
    const float s = row_group_sum<1>(th, s_lp);
    if (tid < TC && c0 + tid < c) part[c0 + tid] = s;
}

// ---------------------------------------------------------------------------
// Kernels 1 and 2 on the tensor cores (3xTF32), the products taken transposed
// ---------------------------------------------------------------------------

constexpr int ORDERED_KIND = 4;        // the ordered kernel's kind, beside the four families
constexpr int TC_MAX_D = 63;           // [x, 1] has D + 1 <= 64 columns: one n64 product
constexpr int TC_MAX_CATEGORIES = 8;   // the ordered kernel is compiled for each K <= 8
constexpr int TC_PAIRS = 2;            // pairs of warpgroups a block, 64 chains a pair
constexpr int TC_CHAINS = 64 * TC_PAIRS;
constexpr int TC_THREADS = 256 * TC_PAIRS;
constexpr size_t TC_MAX_SMEM = 232448;  // dynamic shared memory one block may take on sm_90

struct TcLayout {
    size_t beta_hi, beta_lo, x1_hi, x1_lo, x2_hi, x2_lo, raw, yraw, ys, cuts, dsum, gsum, bar, total;
};

constexpr int GSUM_STRIDE = 33;  // floats a thread's gradient sums take in shared memory (no bank conflicts)

__host__ __device__ inline size_t tc_up128(size_t b) { return (b + 127) & ~(size_t)127; }

// Shared memory of one block (TC_CHAINS chains) for d columns and kcat
// categories (0 for the four families), each part rounded up to 128 bytes;
// mirrored by the wrapper's glm_tile_plan.
__host__ __device__ inline TcLayout tc_layout_of(int d, int kcat) {
    const size_t dp = (size_t)((d + 7) & ~7);
    const size_t chains = TC_CHAINS;
    const size_t nsum = kcat > 0 ? (size_t)kcat : 2;  // ordered: lp, gcuts; families: lp, ge
    TcLayout L;
    size_t at = 0;
    L.beta_hi = at; at += tc_up128(chains * dp * 4);
    L.beta_lo = at; at += tc_up128(chains * dp * 4);
    L.x1_hi = at;   at += tc_up128(64 * dp * 4);
    L.x1_lo = at;   at += tc_up128(64 * dp * 4);
    L.x2_hi = at;   at += tc_up128(64 * 64 * 4);
    L.x2_lo = at;   at += tc_up128(64 * 64 * 4);
    L.raw = at;     at += tc_up128(64 * (size_t)d * 4);
    L.yraw = at;    at += tc_up128(64 * 4);
    L.ys = at;      at += tc_up128(64 * 4);
    L.cuts = at;    at += tc_up128(kcat > 0 ? chains * (size_t)(2 * kcat + 1) * 4 : 0);
    L.dsum = at;    at += tc_up128(2 * chains * nsum * 8);
    L.gsum = at;    at += tc_up128((size_t)TC_THREADS * GSUM_STRIDE * 4);
    L.bar = at;     at += tc_up128(8);
    L.total = at;
    return L;
}

// KIND: a Family, or ORDERED_KIND with KC categories.  extra: sigma / phi of
// the families that have one, the cuts (KC-1, C) of the ordered kernel.
// partials: (gridDim.x, D + 3, C) for the families (rows logp, ga, ge, gb),
// (gridDim.x, D + KC, C) for the ordered kernel (logp, gbeta, gcuts).
// A block holds TC_PAIRS pairs of warpgroups; pair p owns chains 64p ..
// 64p+63 of the block's column tile, and its two warpgroups (half = 0, 1)
// split each 64-row tile: rows 32*half .. 32*half+31.  One block an SM: at
// most 128 registers a thread.
template <int KIND, int KC>
__global__ void __launch_bounds__(TC_THREADS, 1)
glm_tc_kernel(const void* __restrict__ y, const float* __restrict__ x, const float* __restrict__ alpha,
              const float* __restrict__ beta, const float* __restrict__ extra, int n, int d, int c,
              float* __restrict__ partials) {
    constexpr bool kOrdered = KIND == ORDERED_KIND;
    constexpr bool kHasExtra = KIND == NORMAL_ID || KIND == NEG_BINOMIAL_2_LOG;
    constexpr int THREADS_TC = TC_THREADS;
    constexpr int NCH = TC_CHAINS;           // chains of the block
    constexpr int NSUM = kOrdered ? KC : 2;  // double sums per chain
    constexpr int NGC = kOrdered ? KC - 1 : 1;
    constexpr int KE = kOrdered ? KC : 1;    // a chain's row of the log1m_exp terms
    extern __shared__ __align__(128) unsigned char smem[];
    const TcLayout L = tc_layout_of(d, kOrdered ? KC : 0);
    float* bhi = reinterpret_cast<float*>(smem + L.beta_hi);  // (NCH x dp) K-major, beta hi
    float* blo = reinterpret_cast<float*>(smem + L.beta_lo);  //                      beta lo
    float* x1hi = reinterpret_cast<float*>(smem + L.x1_hi);   // (64 rows x dp) K-major: product 1's B
    float* x1lo = reinterpret_cast<float*>(smem + L.x1_lo);
    float* x2hi = reinterpret_cast<float*>(smem + L.x2_hi);   // (64 features x 64 positions) K-major: product 2's B
    float* x2lo = reinterpret_cast<float*>(smem + L.x2_lo);
    float* raw = reinterpret_cast<float*>(smem + L.raw);      // (64, d) row-major: the bulk copy of the x tile
    uint32_t* yraw = reinterpret_cast<uint32_t*>(smem + L.yraw);
    uint32_t* ys = reinterpret_cast<uint32_t*>(smem + L.ys);  // this tile's y (ordered: clamped into 1..KC)
    float* cs = reinterpret_cast<float*>(smem + L.cuts);      // (NCH, KC + 1) extended cuts
    float* lm = cs + NCH * (KC + 1);                          // (NCH, KC) log1m_exp(c_{y-1} - c_y), y = 1..KC
    double* dsum = reinterpret_cast<double*>(smem + L.dsum);  // (2 halves, NSUM, NCH) the block's sums
    // the gradient sums live in shared memory (a thread's 32 at tid *
    // GSUM_STRIDE): in registers they were spilled
    float* gs = reinterpret_cast<float*>(smem + L.gsum) + threadIdx.x * GSUM_STRIDE;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int half = (tid >> 7) & 1;  // rows 32*half .. 32*half+31 of each tile
    const int pair = tid >> 8;        // chains 64*pair .. 64*pair+63 of the block
    const int ch_a = 64 * pair + 16 * (warp & 3) + g;  // this thread's chains of the block: ch_a, ch_a + 8
    const int dp = (d + 7) & ~7;
    const int c0 = blockIdx.y * NCH;
    const int n_tiles = (n + 63) / 64;
    const int full_tiles = n / 64;  // tiles 0 .. full_tiles-1 hold 64 rows and come by bulk copy

    if (tid == 0) {
        mbar_init(bar, 1);
        fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0 && (int)blockIdx.x < full_tiles) request_row_tile(raw, yraw, x, y, blockIdx.x, d, bar);

    // beta's chains as A of product 1, hi and lo, K-major (chain x feature)
    for (int i = tid; i < NCH * dp; i += THREADS_TC) {
        const int f = i / NCH;
        const int j = i % NCH;
        const float v = (f < d && c0 + j < c) ? beta[(size_t)f * c + c0 + j] : 0.0f;
        uint32_t h, l;
        split(v, h, l);
        bhi[kmajor_index(j, f, dp)] = __uint_as_float(h);
        blo[kmajor_index(j, f, dp)] = __uint_as_float(l);
    }
    // the parts of the x layouts no tile writes: x1's columns d .. dp-1 are 0;
    // x2's rows d .. 63 are 0 but for the families' row of ones at d (ga)
    for (int i = tid; i < 64 * dp; i += THREADS_TC) {
        x1hi[i] = 0.0f;
        x1lo[i] = 0.0f;
    }
    for (int i = tid; i < 64 * 64; i += THREADS_TC) {
        const int f = i / 64;
        x2hi[kmajor_index(f, i % 64, 64)] = (!kOrdered && f == d) ? 1.0f : 0.0f;
        x2lo[i] = 0.0f;
    }
    if (kOrdered) {
        for (int i = tid; i < NCH * (KC + 1); i += THREADS_TC) {
            const int j = i / (KC + 1);
            const int k = i % (KC + 1);
            float v = k == 0 ? -ORD_BIG : ORD_BIG;
            if (k > 0 && k < KC) v = c0 + j < c ? extra[(size_t)(k - 1) * c + c0 + j] : 0.0f;
            cs[i] = v;
        }
        __syncthreads();
        // u1 - u2 = c_{y-1} - c_y does not depend on eta: its log1m_exp is
        // taken once per (chain, category)
        for (int i = tid; i < NCH * KC; i += THREADS_TC) {
            const int j = i / KC;
            const int k = i % KC;
            lm[i] = log1m_exp_f(cs[j * (KC + 1) + k] - cs[j * (KC + 1) + k + 1]);
        }
    }
    for (int i = tid; i < 2 * NSUM * NCH; i += THREADS_TC) dsum[i] = 0.0;

    // the families' per-chain operands, for this thread's two chains
    bool cvalid[2];
    float a_c[2], e0_c[2], e1_c[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int cc = c0 + ch_a + 8 * s;
        cvalid[s] = cc < c;
        a_c[s] = (!kOrdered && cvalid[s]) ? alpha[cc] : 0.0f;
        e0_c[s] = (kHasExtra && cvalid[s]) ? extra[cc] : 1.0f;
        e1_c[s] = KIND == NORMAL_ID ? 1.0f / e0_c[s] : (KIND == NEG_BINOMIAL_2_LOG ? logf(e0_c[s]) : 0.0f);
    }

    // product 1: this pair's 64 chains of beta (A) against this half's 32 rows
    // of x1 (B); product 2: theta' (A) against x2's positions of those rows,
    // k8 steps 4*half .. 4*half+3
    const uint64_t dbeta_hi = kmajor_desc(bhi + (size_t)pair * 64 * dp, dp);
    const uint64_t dbeta_lo = kmajor_desc(blo + (size_t)pair * 64 * dp, dp);
    const uint64_t dx1_hi = kmajor_desc(x1hi + (size_t)half * 32 * dp, dp);
    const uint64_t dx1_lo = kmajor_desc(x1lo + (size_t)half * 32 * dp, dp);
    const uint64_t dx2_hi = kmajor_desc(x2hi, 64) + 4 * half * desc_k8_step();
    const uint64_t dx2_lo = kmajor_desc(x2lo, 64) + 4 * half * desc_k8_step();
    const int ksteps = dp / 8;

    // the x layouts' pass: a warp writes one core matrix of x1 (8 rows x 4
    // features) at a time, core matrix m = (feature quad m / 8, row group m %
    // 8); this thread's place in it is fixed
    const int n_cm = 2 * dp;  // core matrices of x1: 8 row groups x dp/4 feature quads
    const int r_in = (tid & 31) >> 2;
    const int f_in = tid & 3;
    constexpr int WARPS_TC = THREADS_TC / 32;

    // the block's sums of product 2: [gb; ga] (chain x feature) in the accumulator layout
#pragma unroll
    for (int e = 0; e < 32; ++e) gs[e] = 0.0f;

    for (int it = 0;; ++it) {
        const int tile = blockIdx.x + it * gridDim.x;
        if (tile >= n_tiles) break;
        const int r0 = tile * 64;
        // every thread is done with the previous tile's x layouts and ys (and,
        // on the first pass, the staging above is done)
        __syncthreads();
        if (tile < full_tiles) {
            mbar_wait(bar, (uint32_t)(it & 1));
        } else {
            const int rows = n - r0;
            for (int i = tid; i < 64 * d; i += THREADS_TC) raw[i] = i < rows * d ? x[(size_t)r0 * d + i] : 0.0f;
            for (int i = tid; i < 64; i += THREADS_TC) {
                yraw[i] = i < rows ? static_cast<const uint32_t*>(y)[r0 + i] : (kOrdered ? 1u : 0u);
            }
            __syncthreads();
        }

        // --- the x tile into both layouts, hi and lo: x1 (row x feature) for
        // product 1, x2 (feature x position, rows in k8 positions) for product 2
#pragma unroll 4
        for (int m = warp; m < n_cm; m += WARPS_TC) {
            const int r = 8 * (m & 7) + r_in;
            const int f = 4 * (m >> 3) + f_in;
            if (f < d) {
                uint32_t h, l;
                split(raw[r * d + f], h, l);
                const int j1 = kmajor_index(r, f, dp);
                x1hi[j1] = __uint_as_float(h);
                x1lo[j1] = __uint_as_float(l);
                const int j2 = kmajor_index(f, k8_position(r), 64);
                x2hi[j2] = __uint_as_float(h);
                x2lo[j2] = __uint_as_float(l);
            }
        }
        if (tid < 64) {
            const uint32_t v = yraw[tid];
            ys[tid] = kOrdered ? (uint32_t)min(max((int)v, 1), KC) : v;
        }
        fence_proxy_async();  // the layouts are read by wgmma next
        __syncthreads();
        // the raw tile is consumed: ask for the next one while this one is worked on
        if (tid == 0 && tile + (int)gridDim.x < full_tiles) request_row_tile(raw, yraw, x, y, tile + gridDim.x, d, bar);

        // --- product 1: eta^T (64 chains x 32 rows) = beta^T @ x_rows^T -----
        float acc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
        fence_regs(acc);
        wgmma_fence();
        // the small terms of every k8 step first, then the large ones: the
        // tensor core truncates each sum into the accumulator, so the small
        // terms go in while it is small, and eta's bias (which exp(eta) and
        // 1/sigma^2 carry into the gradients) is the large terms' alone
        for (int ks = 0; ks < ksteps; ++ks) {
            const uint64_t o = ks * desc_k8_step();
            mma_n32k8_ss(acc, dbeta_lo + o, dx1_hi + o);
            mma_n32k8_ss(acc, dbeta_hi + o, dx1_lo + o);
        }
        for (int ks = 0; ks < ksteps; ++ks) {
            const uint64_t o = ks * desc_k8_step();
            mma_n32k8_ss(acc, dbeta_hi + o, dx1_hi + o);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);

        // --- the core on the accumulator: acc[e] is (chain ch_a + 8s, row
        // 32*half + 8(e/4) + 2t + e%2) with s = (e/2)%2; theta' replaces eta
        float lp_s[2] = {0.0f, 0.0f}, ge_s[2] = {0.0f, 0.0f};
        float gc_s[2][NGC];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int q = 0; q < NGC; ++q) gc_s[s][q] = 0.0f;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            const int s = (e >> 1) & 1;
            const int row = 32 * half + 8 * (e >> 2) + 2 * t + (e & 1);
            const bool ok = (r0 + row < n) && cvalid[s];
            if constexpr (kOrdered) {
                const int yv = (int)ys[row];
                const int ch = ch_a + 8 * s;
                const float* ce = cs + ch * (KC + 1);
                const float eta = acc[e];
                const float u2 = ce[yv] - eta;
                const float u1 = ce[yv - 1] - eta;
                const float sp2 = softplus_m<FastMath>(u2);
                const float sp1 = softplus_m<FastMath>(u1);
                float lp = u2 - sp2 - sp1 + lm[ch * KE + yv - 1];
                float w2 = FastMath::exp(u2 - 2.0f * sp2 - lp);
                float w1 = FastMath::exp(u1 - 2.0f * sp1 - lp);
                lp = ok ? lp : 0.0f;
                w1 = ok ? w1 : 0.0f;
                w2 = ok ? w2 : 0.0f;
                lp_s[s] += lp;
#pragma unroll
                for (int q = 0; q < NGC; ++q) gc_s[s][q] += (yv == q + 1 ? w2 : 0.0f) - (yv == q + 2 ? w1 : 0.0f);
                acc[e] = w1 - w2;
            } else {
                float lp, tp, de;
                glm_core<KIND, FastMath>(acc[e] + a_c[s], __uint_as_float(ys[row]), e0_c[s], e1_c[s], lp, tp, de);
                lp_s[s] += ok ? lp : 0.0f;
                ge_s[s] += ok ? de : 0.0f;
                acc[e] = ok ? tp : 0.0f;
            }
        }
        // the tile's sums per chain and half: this thread's 8 rows, then the
        // quad's four lanes by shuffles, into the block's sums in double
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            float v[NSUM];
            v[0] = lp_s[s];
            if constexpr (kOrdered) {
#pragma unroll
                for (int q = 0; q < NGC; ++q) v[1 + q] = gc_s[s][q];
            } else {
                v[1] = ge_s[s];
            }
#pragma unroll
            for (int q = 0; q < NSUM; ++q) {
                v[q] += __shfl_xor_sync(0xffffffffu, v[q], 1);
                v[q] += __shfl_xor_sync(0xffffffffu, v[q], 2);
                if (t == 0) dsum[(half * NSUM + q) * NCH + ch_a + 8 * s] += (double)v[q];
            }
        }

        // --- product 2: [gb; ga]^T (64 chains x 64 features) += theta'^T @ [x, 1]
        // over this half's 32 rows.  A straight from the registers: for k8
        // step j, A's columns t and t+4 are rows 2t and 2t+1 of the group,
        // acc[4j+0] and acc[4j+1] (chain row g), acc[4j+2], acc[4j+3] (g+8);
        // x2 holds the rows at those positions (k8_position).  The tensor
        // core's sums are not rounded to nearest, so the tile's product starts
        // from zero and is added to the block's sums by IEEE adds.
        uint32_t lo[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            uint32_t h;
            split(acc[e], h, lo[e]);
            acc[e] = __uint_as_float(h);
        }
        float acc2[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc2[e] = 0.0f;
        fence_regs(acc2);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t ah[4] = {__float_as_uint(acc[4 * j]), __float_as_uint(acc[4 * j + 2]),
                                    __float_as_uint(acc[4 * j + 1]), __float_as_uint(acc[4 * j + 3])};
            const uint32_t al[4] = {lo[4 * j], lo[4 * j + 2], lo[4 * j + 1], lo[4 * j + 3]};
            const uint64_t o = j * desc_k8_step();
            mma_n64k8_rs(acc2, al, dx2_hi + o);
            mma_n64k8_rs(acc2, ah, dx2_lo + o);
            mma_n64k8_rs(acc2, ah, dx2_hi + o);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc2);
        fence_regs(acc);  // the A registers stay untouched until the products have read them
#pragma unroll
        for (int e = 0; e < 16; ++e) asm volatile("" : "+r"(lo[e])::"memory");
#pragma unroll
        for (int e = 0; e < 32; ++e) gs[e] += acc2[e];
        fence_proxy_async();  // the x layouts are written again by the next tile
    }

    // --- this block's partial: the two halves added in order, half 0 first --
    __syncthreads();
    const float* other = gs + 128 * GSUM_STRIDE;  // half 1's thread of the same (warp & 3, lane)
    float* part = partials + (size_t)blockIdx.x * (size_t)(kOrdered ? d + KC : d + 3) * c;
    for (int i = tid; i < NSUM * NCH; i += THREADS_TC) {
        const int q = i / NCH;
        const int cc = c0 + i % NCH;
        if (cc >= c) continue;
        const int row = q == 0 ? 0 : (kOrdered ? d + q : 2);  // logp; gcuts / ge
        part[(size_t)row * c + cc] = (float)(dsum[i] + dsum[NSUM * NCH + i]);
    }
    if (half == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            const int cc = c0 + ch_a + 8 * ((e >> 1) & 1);
            const int f = 8 * (e >> 2) + 2 * t + (e & 1);
            if (cc >= c || f > d || (kOrdered && f == d)) continue;
            const int row = f == d ? 1 : (kOrdered ? 1 : 3) + f;  // gb / gbeta; ga from x2's row of ones
            part[(size_t)row * c + cc] = gs[e] + other[e];
        }
    }
}

template <int KIND, int KC>
cudaError_t launch_tc(dim3 grid, size_t smem, cudaStream_t stream, const void* y, const float* x, const float* alpha,
                      const float* beta, const float* extra, int n, int d, int c, float* partials) {
    cudaError_t err =
        cudaFuncSetAttribute(glm_tc_kernel<KIND, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    glm_tc_kernel<KIND, KC><<<grid, TC_THREADS, smem, stream>>>(y, x, alpha, beta, extra, n, d, c, partials);
    return cudaGetLastError();
}

// The instantiated (KIND, KC): the four families and the ordered kernel for
// each K <= 8.  The wrapper's glm_tile_plan (ops/glm_fused.py) sends a shape
// here only where its block fits shared memory (tc_layout_of).
#define GLM_TC_INSTANCES(X) \
    X(0, 0) X(1, 0) X(2, 0) X(3, 0) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6) X(4, 7) X(4, 8)

}  // namespace

// ---------------------------------------------------------------------------
// The C interface.  Each *_launch takes a float32 scratch of row_blocks
// partials and writes out; it returns the CUDA error code of its launches
// (0: both passes were accepted).
// ---------------------------------------------------------------------------

// Whether row_blocks blocks along the rows each get at least one 64-row tile
// (each block writes its partial from its first tile on).
static bool row_blocks_ok(int n, int row_blocks) { return row_blocks >= 1 && row_blocks <= (n + TM - 1) / TM; }

// partials: (row_blocks, k + 3, c); out: (k + 3, c) with rows logp, ga, ge,
// gb[0..k).  extra may be null for the families without one.
extern "C" int glm_fused_launch(int family, const void* y, const void* x, const void* alpha,
                                const void* beta, const void* extra, void* partials, void* out,
                                int n, int k, int c, int row_blocks, void* stream_ptr) {
    if (k < 1 || c < 1 || !row_blocks_ok(n, row_blocks)) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const float* yf = static_cast<const float*>(y);
    const float* xf = static_cast<const float*>(x);
    const float* af = static_cast<const float*>(alpha);
    const float* bf = static_cast<const float*>(beta);
    const float* ef = static_cast<const float*>(extra);
    float* pf = static_cast<float*>(partials);
    const size_t smem = FUSED_SMEM;
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

// partials: (row_blocks, d + kcat, c); out: (d + kcat, c) with rows logp,
// gbeta[0..d), gcuts[0..kcat-1).
extern "C" int glm_ordered_launch(const void* y, const void* x, const void* beta, const void* cuts,
                                  void* partials, void* out, int n, int d, int c, int kcat,
                                  int row_blocks, void* stream_ptr) {
    if (d < 1 || c < 1 || kcat < 2 || !row_blocks_ok(n, row_blocks)) return (int)cudaErrorInvalidValue;
    const dim3 grid(row_blocks, (c + TC - 1) / TC);
    return (int)launch_two_pass(
        glm_ordered_kernel, grid, ORDERED_SMEM, reinterpret_cast<cudaStream_t>(stream_ptr),
        static_cast<float*>(partials), out, (long long)(d + kcat) * c, static_cast<const int*>(y),
        static_cast<const float*>(x), static_cast<const float*>(beta), static_cast<const float*>(cuts), n, d, c, kcat);
}

// Shared memory of one block of the tensor-core kernels (TC_CHAINS chains):
// d columns, kcat categories (0 for the four families).
extern "C" long long glm_tc_smem_bytes(int d, int kcat) { return (long long)tc_layout_of(d, kcat).total; }

// Chains of one block of the tensor-core kernels.
extern "C" int glm_tc_chains_per_block() { return TC_CHAINS; }

// The widest x and the most categories the tensor-core kernels take.
extern "C" int glm_tc_max_d() { return TC_MAX_D; }
extern "C" int glm_tc_max_categories() { return TC_MAX_CATEGORIES; }

// kind 0..3: the families (alpha, beta (d, c), extra as glm_fused_launch;
// kcat 0); kind 4: the ordered kernel (alpha unused, beta (d, c), extra the
// cuts (kcat-1, c)).  x and y 16-byte aligned.  partials (row_blocks, rows, c)
// and out (rows, c) with rows = d + 3 (families) or d + kcat (ordered), as the
// float32 kernels'.  Returns the CUDA error code of the two launches.
extern "C" int glm_tc_launch(int kind, int kcat, const void* y, const void* x, const void* alpha, const void* beta,
                             const void* extra, void* partials, void* out, int n, int d, int c, int row_blocks,
                             void* stream_ptr) {
    const int kc = kind == ORDERED_KIND ? kcat : 0;
    if (kind < 0 || kind > ORDERED_KIND || d < 1 || d > TC_MAX_D || (kind == ORDERED_KIND && (kc < 2 || kc > TC_MAX_CATEGORIES))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const size_t smem = tc_layout_of(d, kc).total;
    if (smem > TC_MAX_SMEM) return (int)cudaErrorInvalidValue;  // the wrapper sends such shapes to the float32 kernels
    const dim3 grid(row_blocks, (c + TC_CHAINS - 1) / TC_CHAINS);
    const float* xf = static_cast<const float*>(x);
    const float* af = static_cast<const float*>(alpha);
    const float* bf = static_cast<const float*>(beta);
    const float* ef = static_cast<const float*>(extra);
    float* pf = static_cast<float*>(partials);
    cudaError_t err = cudaErrorInvalidValue;
#define GLM_TC_CASE(KIND_, KC_)                                                   \
    if (kind == KIND_ && kc == KC_) {                                             \
        err = launch_tc<KIND_, KC_>(grid, smem, stream, y, xf, af, bf, ef, n, d, c, pf); \
    } else
    GLM_TC_INSTANCES(GLM_TC_CASE) { return (int)cudaErrorInvalidValue; }
#undef GLM_TC_CASE
    if (err != cudaSuccess) return (int)err;
    return (int)glm_common::reduce_partials(pf, out, row_blocks, (long long)(d + (kc > 0 ? kc : 3)) * c, stream);
}
