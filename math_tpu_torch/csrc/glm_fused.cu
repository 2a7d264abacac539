// Fused GLM log-prob + parameter gradients for a batch of chains: two of the
// port's three GLM kernels, which share their cores, their two products and
// their second pass.  The third, the categorical logit, is in
// glm_categorical.cu, on the tensor cores (3xTF32) at every shape.
//
// Replaces the TPU kernels of math_tpu/ops/pallas_glm.py:
//
//   glm_tc_kernel<F, 0>, tiled::value_kernel<F>     _glm_kernel        four families, eta = x @ beta + alpha
//   glm_tc_kernel<4, K>, tiled::value_kernel<4>     _ordered_kernel    ordered-logistic GLM
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
// One route on the tensor cores (3xTF32), by two kernels.  Both compute the
// same function and write the same partials; the wrapper
// (ops/glm_fused.py::glm_tile_plan) picks by shape alone:
//
//   glm_tc_kernel<F, 0>           the four families   D <= 63: one launch and
//   glm_tc_kernel<ORDERED, K>     ordered, K <= 8     its reduction (the main path's)
//   tiled::                       both, any D and K   the shapes the first cannot
//                                                     hold: five launches (below)
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
// Design of glm_tc_kernel.  There is one linear predictor per chain,
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
// The ordered kernel's cut pair is read by index (the TPU kernel gathers it
// and scatters gcuts with one-hot matmuls: the MXU doing a gather).
//
// Shared memory per block of glm_tc_kernel: tc_layout_of (204-216 KB at
// D=50); a shape whose block does not fit 227 KB (D = 57-63 with K = 6-8)
// goes to the tiled route, whose blocks take the same 196,736 bytes at every D
// and K.

#include <cuda_runtime.h>
#include <math.h>

#include "glm_common.cuh"

namespace {

using namespace tf32x3;
using glm_common::allow_smem;
using glm_common::MAX_SMEM;
using glm_common::request_row_tile;
using glm_common::RingPlace;
using glm_common::up128;

constexpr float ORD_BIG = 1e4f;  // stands in for the -/+ inf boundary cuts

// ---------------------------------------------------------------------------
// The cores: four families with one linear predictor per chain, ordered logistic
// ---------------------------------------------------------------------------

enum Family { BERNOULLI_LOGIT = 0, POISSON_LOG = 1, NORMAL_ID = 2, NEG_BINOMIAL_2_LOG = 3 };

// The scalar functions of the cores: the hardware's approximations (ex2 / lg2
// / rcp of the special-function unit: __expf within 2 + 1.2|t| ulp, __logf
// within 2^-21.4 absolute on [0.5, 2], here on 1 + e with e in (0, 1]), a few
// instructions where the CUDA math library takes some twenty; about 1e-7 of
// error a (row, chain) against the gates' 2e-5 of logp and 3e-4 / 1e-3*N/3000
// of the gradients.
struct FastMath {
    static __device__ __forceinline__ float exp(float t) { return __expf(t); }
    static __device__ __forceinline__ float log1p(float e) { return __logf(1.0f + e); }
    static __device__ __forceinline__ float rcp(float t) { return __fdividef(1.0f, t); }
};

// softplus(t) = log(1 + exp(t)), overflow-safe.
template <class M = FastMath>
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
template <int F, class M = FastMath>
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

// ---------------------------------------------------------------------------
// Kernels 1 and 2 on the tensor cores (3xTF32), the products taken transposed
// ---------------------------------------------------------------------------

constexpr int ORDERED_KIND = 4;        // the ordered kernel's kind, beside the four families
constexpr int TC_MAX_D = 63;           // [x, 1] has D + 1 <= 64 columns: one n64 product
constexpr int TC_MAX_CATEGORIES = 8;   // the ordered kernel is compiled for each K <= 8
constexpr int TC_PAIRS = 2;            // pairs of warpgroups a block, 64 chains a pair
constexpr int TC_CHAINS = 64 * TC_PAIRS;
constexpr int TC_THREADS = 256 * TC_PAIRS;

struct TcLayout {
    size_t beta_hi, beta_lo, x1_hi, x1_lo, x2_hi, x2_lo, raw, yraw, ys, cuts, dsum, gsum, bar, total;
};

constexpr int GSUM_STRIDE = 33;  // floats a thread's gradient sums take in shared memory (no bank conflicts)

// Shared memory of one block (TC_CHAINS chains) for d columns and kcat
// categories (0 for the four families), each part rounded up to 128 bytes;
// mirrored by the wrapper's glm_tile_plan.
__host__ __device__ inline TcLayout tc_layout_of(int d, int kcat) {
    const size_t dp = (size_t)((d + 7) & ~7);
    const size_t chains = TC_CHAINS;
    const size_t nsum = kcat > 0 ? (size_t)kcat : 2;  // ordered: lp, gcuts; families: lp, ge
    TcLayout L;
    size_t at = 0;
    L.beta_hi = at; at += up128(chains * dp * 4);
    L.beta_lo = at; at += up128(chains * dp * 4);
    L.x1_hi = at;   at += up128(64 * dp * 4);
    L.x1_lo = at;   at += up128(64 * dp * 4);
    L.x2_hi = at;   at += up128(64 * 64 * 4);
    L.x2_lo = at;   at += up128(64 * 64 * 4);
    L.raw = at;     at += up128(64 * (size_t)d * 4);
    L.yraw = at;    at += up128(64 * 4);
    L.ys = at;      at += up128(64 * 4);
    L.cuts = at;    at += up128(kcat > 0 ? chains * (size_t)(2 * kcat + 1) * 4 : 0);
    L.dsum = at;    at += up128(2 * chains * nsum * 8);
    L.gsum = at;    at += up128((size_t)TC_THREADS * GSUM_STRIDE * 4);
    L.bar = at;     at += up128(8);
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
    const cudaError_t err = allow_smem((const void*)glm_tc_kernel<KIND, KC>, smem);
    if (err != cudaSuccess) return err;
    glm_tc_kernel<KIND, KC><<<grid, TC_THREADS, smem, stream>>>(y, x, alpha, beta, extra, n, d, c, partials);
    return cudaGetLastError();
}

// The instantiated (KIND, KC): the four families and the ordered kernel for
// each K <= 8.  The wrapper's glm_tile_plan (ops/glm_fused.py) sends a shape
// here only where its block fits shared memory (tc_layout_of).
#define GLM_TC_INSTANCES(X) \
    X(0, 0) X(1, 0) X(2, 0) X(3, 0) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6) X(4, 7) X(4, 8)

// ===========================================================================
// The tiled route: every B1 / B2 shape glm_tc_kernel does not take
// ===========================================================================
//
// Replaces math_tpu/ops/pallas_glm.py::_glm_kernel and ::_ordered_kernel at
// the shapes whose block glm_tc_kernel cannot hold: D > 63 ([x, 1] no longer
// fits one n64 product, beta of 128 chains no longer fits shared memory
// whole), ordered K > 8 (compiled per K there), and ordered D 57-63 at K 6-8.
// Same function, same partials and tolerances, any N, D, C and K.
//
// What bounds it: the two products, 3 x 4*N*D*C flops in 3xTF32 at 495
// TFLOP/s (0.175 ms at N = 100,000, D = 282, C = 256; 0.636 ms at D = 1024).
// The likelihood cores are light beside products of 64-1024 features.
//
// Design.  A fused launch would keep [gb; ga] of every feature per chain
// (64 x (D + 1) floats a warpgroup: 262 KB at D = 1024), more than the
// registers and a block's shared memory hold; computing product 1 again per
// group of features would cost half the tensor work again.  So theta' goes
// through device memory (N x C, split hi / lo: 205 MB at N = 100,000, C =
// 256), and a call makes five launches:
//  * Launch 0, pack_kernel: beta^T split into TF32 hi / lo, K-major, per
//    (column tile of 128 chains, slice of 32 features); x likewise per (row
//    tile of 128 rows, slice), zeros past N, C and D; y over whole row tiles
//    (the ordered GLM's clamped into 1..K).  Each stage of the rings below is
//    then one or a few contiguous 1-D bulk copies, and no later launch
//    splits x.
//  * Launch 1, value_kernel<KIND>: grid (column tiles, row blocks); a block
//    is two consumer warpgroups (64 chains each: wgmma's M) and one producer
//    warp.  Per row tile of 128 rows (product 1's N), eta^T = beta^T x^T a
//    slice at a time: the producer keeps a ring of STAGES slices (beta's,
//    then x's, 32 KB each, hi then lo) filled by bulk copies across the
//    block's row tiles; each slice's 3xTF32 product (m64n128k8, both
//    operands from shared memory, the small terms of every k8 step first)
//    starts from zero and is added to eta by IEEE adds (the tensor core
//    truncates its sums).  A consumer warp frees its stage by an arrival on
//    the stage's empty barrier: no block barrier in the loop, so one
//    warpgroup's core can run beside the other's products.  The core runs on
//    the accumulators (two chains and 32 rows a thread): logp, ga, ge (the
//    families) or logp and gcuts (ordered), summed per thread in a fixed
//    order, over the quad by shuffles, into the block's sums in double in
//    device memory (one owner thread per entry).  The ordered core is a
//    rolled loop (unrolled, it missed the instruction cache and took 10x the
//    families' time): gcuts in passes of 4, 8 or 16 cuts as K allows,
//    selecting on y over the thread's rows (any K); the cut pair of a (row,
//    chain) and log1m_exp(c_{y-1} - c_y) are read by index from tables the
//    pack launch makes.  theta' goes out split hi / lo in launch 2's layout.
//  * Launch 2, grad_kernel: grid (groups of 128 features, column tiles, row
//    blocks), the same two warpgroups and producer warp.  gb (64 features x
//    128 chains a warpgroup) = x^T theta' over chunks of 32 rows: A = x^T
//    from registers (the packed hi / lo, read by index), B = theta' (K-major:
//    chains x rows) as launch 1 wrote it, by m64n128k8; each chunk's product
//    from zero, added to the block's sums in registers by IEEE adds.  ga is
//    launch 1's sum of theta' in float: no row of ones.
//  * Two reductions add the blocks' partials in block order in double
//    (launch 1's double sums, launch 2's float partials): no atomics, the
//    result repeatable bit for bit.
//
// Shared memory per block, either launch: STAGES * 64 KB of ring and the
// barriers (layout_of), the same for every D and K.

namespace tiled {

constexpr int CH = 128;                  // chains of a column tile: 64 a consumer warpgroup
constexpr int RT = 128;                  // rows of launch 1's row tile: product 1's N
constexpr int DS = 32;                   // features of a slice
constexpr int RCH = 32;                  // rows of launch 2's chunk: its K
constexpr int FG = 128;                  // features of a launch-2 block: 64 a consumer warpgroup
constexpr int STAGES = 3;                // stages of each launch's ring
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TILE_FLOATS = 4096;        // one part (hi or lo) of a K-major 128 x 32 tile
constexpr uint32_t TILE_BYTES = 2 * TILE_FLOATS * 4;  // hi then lo
constexpr size_t STAGE_BYTES = 2 * (size_t)TILE_BYTES;  // launch 1: beta, x; launch 2: theta', four x chunks
static_assert(RT == 4 * RCH && FG == 4 * DS, "a row tile is four chunks, a feature group four slices");

struct Layout {
    size_t ring, bars, total;
};

// Shared memory of one block of launch 1 or 2: the ring, then its full and
// empty barriers.  Mirrored by the wrapper's plan.
__host__ __device__ inline Layout layout_of(int stages) {
    Layout L;
    size_t at = 0;
    L.ring = at; at += (size_t)stages * STAGE_BYTES;
    L.bars = at; at += up128((size_t)2 * stages * 8);
    L.total = at;
    return L;
}

// Launch 0.  pbeta: (column tile, slice) stages of beta^T, hi then lo,
// K-major (128 chains x 32 features); px: (row tile, slice) stages of x, hi
// then lo, K-major (128 rows x 32 features); zeros past C, N and D.  py: y
// over the row tiles; the ordered GLM's (kcat > 0) int32, clamped into 1..K,
// 1 past N; the families' float32, 0 past N.  pcut (ordered): the extended
// cuts (K+1, C), c_0 = -1e4, c_K = +1e4, then log1m_exp(c_{k-1} - c_k) for
// k = 1..K (K, C): u1 - u2 does not depend on eta.  An item of x is four features
// of one row: a warp reads 64 contiguous bytes of each of 8 rows and writes
// four 128-byte runs of each part.
__global__ void __launch_bounds__(256)
pack_kernel(const void* __restrict__ y, const float* __restrict__ x, const float* __restrict__ beta,
            const float* __restrict__ cuts, int n, int d, int c, int kcat, float* __restrict__ pbeta,
            float* __restrict__ px, void* __restrict__ py, float* __restrict__ pcut) {
    const int ns = (d + DS - 1) / DS;
    const long long n_tiles = (n + RT - 1) / RT;
    const long long nb = (long long)((c + CH - 1) / CH) * ns * TILE_FLOATS;
    const long long nx = n_tiles * ns * (TILE_FLOATS / 4);
    const long long ny = n_tiles * RT;
    const long long nc = kcat > 0 ? (long long)(2 * kcat + 1) * c : 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nb + nx + ny + nc;
         i += (long long)gridDim.x * blockDim.x) {
        if (i < nb) {
            const long long stage = i / TILE_FLOATS;
            const int idx = (int)(i - stage * TILE_FLOATS);  // kmajor_index(chain, feature, DS)
            const long long ct = stage / ns;
            const int s = (int)(stage - ct * ns);
            const long long ch = ct * CH + 8 * (idx >> 8) + ((idx >> 2) & 7);
            const int f = s * DS + 4 * ((idx >> 5) & 7) + (idx & 3);
            uint32_t h, l;
            split((ch < c && f < d) ? beta[(size_t)f * c + ch] : 0.0f, h, l);
            pbeta[stage * 2 * TILE_FLOATS + idx] = __uint_as_float(h);
            pbeta[stage * 2 * TILE_FLOATS + TILE_FLOATS + idx] = __uint_as_float(l);
        } else if (i < nb + nx) {
            const long long e = i - nb;
            const int r7 = (int)(e & 7);
            const int fq = (int)((e >> 3) & 7);
            const int rg = (int)((e >> 6) & 15);
            const long long stage = e >> 10;  // (row tile, slice)
            const long long rt = stage / ns;
            const int s = (int)(stage - rt * ns);
            const long long row = rt * RT + 8 * rg + r7;
            const int f0 = s * DS + 4 * fq;
            uint32_t h[4], l[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split((row < n && f0 + q < d) ? x[row * d + f0 + q] : 0.0f, h[q], l[q]);
            float* dst = px + stage * 2 * TILE_FLOATS + 256 * rg + 32 * fq + 4 * r7;  // kmajor_index(8 rg + r7, 4 fq, DS)
            *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
            *reinterpret_cast<uint4*>(dst + TILE_FLOATS) = make_uint4(l[0], l[1], l[2], l[3]);
        } else if (i < nb + nx + ny) {
            const long long r = i - nb - nx;
            if (kcat > 0) {
                static_cast<int*>(py)[r] = r < n ? min(max(static_cast<const int*>(y)[r], 1), kcat) : 1;
            } else {
                static_cast<float*>(py)[r] = r < n ? static_cast<const float*>(y)[r] : 0.0f;
            }
        } else {
            const long long e = i - nb - nx - ny;
            const int k = (int)(e / c);
            const int cc = (int)(e - (long long)k * c);
            auto ext = [&](int kk) {
                return kk == 0 ? -ORD_BIG : (kk == kcat ? ORD_BIG : cuts[(size_t)(kk - 1) * c + cc]);
            };
            pcut[e] = k <= kcat ? ext(k) : log1m_exp_f(ext(k - kcat - 1) - ext(k - kcat));
        }
    }
}

// The barriers of a block: full[s] completes when stage s has arrived (the
// producer's expect_tx, the bulk copies' bytes), empty[s] when every
// consumer warp of the live warpgroups is done with it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int wgs) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * wgs);
        }
        fence_mbar_init();
    }
    __syncthreads();
}

// A consumer warp frees the stage it read (every lane's reads are done).
__device__ __forceinline__ void release(uint64_t* empty, RingPlace& at) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[at.st]);
    at.next();
}

// Adds v (this thread's sum for one chain) over its quad; the owner lane
// adds that to the block's double sum at p (stored on the block's first
// tile).  Every lane of the warp calls it.
__device__ __forceinline__ void add_quad_sum(float v, double* p, bool owner, bool first) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (owner) *p = (first ? 0.0 : *p) + (double)v;
}

// theta' of rows r, r + 1 of tile chain ch (r even), hi and lo, into launch
// 2's stage of (row chunk, column tile ct), where they are neighbours.
__device__ __forceinline__ void store_theta_pair(float* theta, int rt, int ct, int col_tiles, int ch, int r, float a,
                                                 float b) {
    const int idx = (ch >> 3) * 256 + ((r & 31) >> 2) * 32 + (ch & 7) * 4 + (r & 3);  // kmajor_index(ch, r % 32, 32)
    float* base = theta + ((size_t)(rt * 4 + (r >> 5)) * col_tiles + ct) * (2 * TILE_FLOATS) + idx;
    uint32_t h0, l0, h1, l1;
    split(a, h0, l0);
    split(b, h1, l1);
    *reinterpret_cast<uint2*>(base) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(base + TILE_FLOATS) = make_uint2(l0, l1);
}

// What the ordered core of launch 1 needs of the block and the thread: y of
// the row tile, the pack launch's cut tables (extended cuts (K+1, C), then
// log1m_exp(c_{k-1} - c_k) (K, C)), and the thread's two chains.
struct OrderedPlace {
    const int* yi;
    const float* cuts;
    long long r0;
    int n, c, kcat, t;
    int cc[2];
    bool cvalid[2];
};

// One pass of launch 1's ordered core over this thread's 64 elements of eta
// (eta[e]: chain ch_w + 8s, row 8(e/4) + 2t + e%2, s = (e/2)%2): w1 and w2
// of each, gcuts_j = sum_{y=j} w2 - sum_{y=j+1} w1 for the NQ cuts from q0 +
// 1 into the block's double sums at p (row 1 + q0 + i), and on the first pass
// (q0 = 0) lp and theta' = w1 - w2.  A rolled loop over pairs of row groups
// (unrolled, the core missed the instruction cache): the pair's eight
// elements are eta[0..7], and eta turns by eight after each pair, back in
// place after eight.
template <int NQ>
__device__ __forceinline__ void ordered_pass(float (&eta)[64], const OrderedPlace& o, int q0, float (&lp_s)[2],
                                             float* theta, int rt, int ct, int ch_w, double* p, bool first) {
    const float* lm = o.cuts + (size_t)(o.kcat + 1) * o.c;
    float gc[2][NQ];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < NQ; ++i) gc[s][i] = 0.0f;
#pragma unroll 1
    for (int jj = 0; jj < 8; ++jj) {
        float tp[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int s = (k >> 1) & 1;
            const int row = 8 * (2 * jj + (k >> 2)) + 2 * o.t + (k & 1);
            const int yv = __ldg(o.yi + row);
            const size_t at_y = (size_t)yv * o.c + o.cc[s];
            const float u2 = __ldg(o.cuts + at_y) - eta[k];
            const float u1 = __ldg(o.cuts + at_y - o.c) - eta[k];
            const float sp2 = softplus_m(u2);
            const float sp1 = softplus_m(u1);
            const float lp = u2 - sp2 - sp1 + __ldg(lm + at_y - o.c);
            const bool ok = (o.r0 + row < o.n) && o.cvalid[s];
            const float w2 = ok ? FastMath::exp(u2 - 2.0f * sp2 - lp) : 0.0f;
            const float w1 = ok ? FastMath::exp(u1 - 2.0f * sp1 - lp) : 0.0f;
            if (q0 == 0) lp_s[s] += ok ? lp : 0.0f;
            tp[k] = w1 - w2;
            const int i2 = yv - 1 - q0;  // w2 goes to cut y, -w1 to cut y - 1
#pragma unroll
            for (int i = 0; i < NQ; ++i) gc[s][i] += (i == i2 ? w2 : 0.0f) - (i == i2 - 1 ? w1 : 0.0f);
        }
        if (q0 == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 8 * (2 * jj + h) + 2 * o.t;
                store_theta_pair(theta, rt, ct, gridDim.x, ch_w, r, tp[4 * h], tp[4 * h + 1]);
                store_theta_pair(theta, rt, ct, gridDim.x, ch_w + 8, r, tp[4 * h + 2], tp[4 * h + 3]);
            }
        }
        float turn[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) turn[k] = eta[k];
#pragma unroll
        for (int m = 0; m < 56; ++m) eta[m] = eta[m + 8];
#pragma unroll
        for (int k = 0; k < 8; ++k) eta[56 + k] = turn[k];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const bool owner = o.t == 0 && o.cvalid[s];
        if (q0 == 0) add_quad_sum(lp_s[s], p + 8 * s, owner, first);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
            if (q0 + i >= o.kcat - 1) break;
            add_quad_sum(gc[s][i], p + 8 * s + (size_t)(1 + q0 + i) * o.c, owner, first);
        }
    }
}

// Launch 1.  grid (column tiles, row blocks).  theta: launch 2's stages of
// theta' = d lp / d eta, hi then lo, K-major (128 chains x 32 rows), at (row
// chunk * column tiles + column tile); sums (row blocks, Q, C) in double: the
// block's logp, ga, ge (the families, Q = 3) or logp, gcuts (ordered, Q = K).
// extra: sigma / phi of the families that have one; the ordered GLM's
// extended cuts and log1m_exp terms from the pack launch.
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
value_kernel(const float* __restrict__ pbeta, const float* __restrict__ px, const void* __restrict__ py,
             const float* __restrict__ alpha, const float* __restrict__ extra, int n, int d, int c, int kcat,
             float* __restrict__ theta, double* __restrict__ sums) {
    constexpr bool kOrdered = KIND == ORDERED_KIND;
    constexpr bool kHasExtra = KIND == NORMAL_ID || KIND == NEG_BINOMIAL_2_LOG;
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = layout_of(STAGES);
    unsigned char* ring = smem + L.ring;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* empty = full + STAGES;
    const int tid = threadIdx.x;
    const int ct = blockIdx.x;
    const int ns = (d + DS - 1) / DS;
    const int n_tiles = (n + RT - 1) / RT;
    const int my_tiles = (n_tiles - 1 - (int)blockIdx.y) / (int)gridDim.y + 1;
    const int wgs = ct * CH + 64 < c ? 2 : 1;  // warpgroups with a chain of the tile
    init_ring(full, empty, wgs);
    // the warpgroup, warp-uniform as the compiler sees it (a wgmma behind a
    // branch it cannot prove uniform is serialised); 2: the producer warp
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

    if (wg == CONSUMERS / 128) {  // the producer warp: one thread asks for every slice in turn
        if (tid == CONSUMERS) {
            RingPlace at(STAGES);
            for (int it = 0; it < my_tiles; ++it) {
                const long long rt = blockIdx.y + (long long)it * gridDim.y;
                for (int s = 0; s < ns; ++s) {
                    mbar_wait(&empty[at.st], at.parity ^ 1u);
                    unsigned char* dst = ring + at.st * STAGE_BYTES;
                    mbar_expect_bytes(&full[at.st], 2 * TILE_BYTES);
                    bulk_copy(dst, pbeta + ((size_t)ct * ns + s) * 2 * TILE_FLOATS, TILE_BYTES, &full[at.st]);
                    bulk_copy(dst + TILE_BYTES, px + ((size_t)rt * ns + s) * 2 * TILE_FLOATS, TILE_BYTES, &full[at.st]);
                    at.next();
                }
            }
        }
        return;
    }
    if (wg >= wgs) return;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ch_w = 64 * wg + 16 * warp + g;  // this thread's chains of the tile: ch_w, ch_w + 8
    const int q_sums = kOrdered ? kcat : 3;
    bool cvalid[2];
    int cc_s[2];
    float a_c[2], e0_c[2], e1_c[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int cc = ct * CH + ch_w + 8 * s;
        cvalid[s] = cc < c;
        cc_s[s] = cvalid[s] ? cc : c - 1;
        a_c[s] = (!kOrdered && cvalid[s]) ? alpha[cc] : 0.0f;
        e0_c[s] = (kHasExtra && cvalid[s]) ? extra[cc] : 1.0f;
        e1_c[s] = KIND == NORMAL_ID ? 1.0f / e0_c[s] : (KIND == NEG_BINOMIAL_2_LOG ? logf(e0_c[s]) : 0.0f);
    }

    RingPlace at(STAGES);
    for (int it = 0; it < my_tiles; ++it) {
        const int rt = blockIdx.y + it * gridDim.y;
        const long long r0 = (long long)rt * RT;

        // --- product 1: eta^T (64 chains x 128 rows) = beta^T x^T, a slice at a time
        float eta[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) eta[e] = 0.0f;
        for (int s = 0; s < ns; ++s) {
            mbar_wait(&full[at.st], at.parity);
            const float* stage = reinterpret_cast<const float*>(ring + at.st * STAGE_BYTES);
            const uint64_t da_hi = kmajor_desc(stage + wg * 64 * DS, DS);
            const uint64_t da_lo = kmajor_desc(stage + TILE_FLOATS + wg * 64 * DS, DS);
            const uint64_t db_hi = kmajor_desc(stage + 2 * TILE_FLOATS, DS);
            const uint64_t db_lo = kmajor_desc(stage + 3 * TILE_FLOATS, DS);
            float acc[64];
#pragma unroll
            for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < DS / 8; ++ks) {
                const uint64_t o = ks * desc_k8_step();
                mma_n128k8_ss(acc, da_lo + o, db_hi + o);
                mma_n128k8_ss(acc, da_hi + o, db_lo + o);
            }
#pragma unroll
            for (int ks = 0; ks < DS / 8; ++ks) {
                const uint64_t o = ks * desc_k8_step();
                mma_n128k8_ss(acc, da_hi + o, db_hi + o);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
            release(empty, at);
#pragma unroll
            for (int e = 0; e < 64; ++e) eta[e] += acc[e];
        }

        // --- the core on the accumulator: eta[e] is (chain ch_w + 8s, row
        // 8(e/4) + 2t + e%2) with s = (e/2)%2
        const bool first = it == 0;
        float lp_s[2] = {0.0f, 0.0f};
        if constexpr (kOrdered) {
            // gcuts in passes of NQ cuts, as few as K allows (every pass
            // takes w1 and w2 again from eta); the first also sums lp and
            // writes theta'
            const int* yi = static_cast<const int*>(py) + r0;
            double* p = sums + (size_t)blockIdx.y * q_sums * c + ct * CH + ch_w;
            const OrderedPlace at_chain{yi, extra, r0, n, c, kcat, t, {cc_s[0], cc_s[1]}, {cvalid[0], cvalid[1]}};
            if (kcat - 1 <= 4) {
                ordered_pass<4>(eta, at_chain, 0, lp_s, theta, rt, ct, ch_w, p, first);
            } else if (kcat - 1 <= 8) {
                ordered_pass<8>(eta, at_chain, 0, lp_s, theta, rt, ct, ch_w, p, first);
            } else {
                for (int q0 = 0; q0 < kcat - 1; q0 += 16) ordered_pass<16>(eta, at_chain, q0, lp_s, theta, rt, ct, ch_w, p, first);
            }
        } else {
            const float* yf = static_cast<const float*>(py) + r0;
            float ga_s[2] = {0.0f, 0.0f}, ge_s[2] = {0.0f, 0.0f};
#pragma unroll
            for (int e = 0; e < 64; ++e) {
                const int s = (e >> 1) & 1;
                const int row = 8 * (e >> 2) + 2 * t + (e & 1);
                const bool ok = (r0 + row < n) && cvalid[s];
                float lp, tp, de;
                glm_core<KIND>(eta[e] + a_c[s], __ldg(yf + row), e0_c[s], e1_c[s], lp, tp, de);
                lp_s[s] += ok ? lp : 0.0f;
                ge_s[s] += ok ? de : 0.0f;
                tp = ok ? tp : 0.0f;
                ga_s[s] += tp;
                eta[e] = tp;  // theta'
            }
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                double* p = sums + (size_t)blockIdx.y * q_sums * c + ct * CH + ch_w + 8 * s;
                const bool owner = t == 0 && cvalid[s];
                add_quad_sum(lp_s[s], p, owner, first);
                add_quad_sum(ga_s[s], p + c, owner, first);
                add_quad_sum(ge_s[s], p + 2 * (size_t)c, owner, first);
            }
            // --- theta' out
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                store_theta_pair(theta, rt, ct, gridDim.x, ch_w, 8 * j + 2 * t, eta[4 * j], eta[4 * j + 1]);
                store_theta_pair(theta, rt, ct, gridDim.x, ch_w + 8, 8 * j + 2 * t, eta[4 * j + 2], eta[4 * j + 3]);
            }
        }
    }
}

// Launch 2.  grid (groups of 128 features, column tiles, row blocks).
// partials (row blocks, D, C): the block's sums of gb = x^T theta'.
__global__ void __launch_bounds__(THREADS, 1)
grad_kernel(const float* __restrict__ px, const float* __restrict__ theta, int n, int d, int c,
            float* __restrict__ partials) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = layout_of(STAGES);
    unsigned char* ring = smem + L.ring;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* empty = full + STAGES;
    const int tid = threadIdx.x;
    const int fg = blockIdx.x;
    const int ct = blockIdx.y;
    const int ns = (d + DS - 1) / DS;
    const int n_chunks = 4 * ((n + RT - 1) / RT);
    const int my_chunks = (n_chunks - 1 - (int)blockIdx.z) / (int)gridDim.z + 1;
    const int wgs = fg * FG + 64 < d ? 2 : 1;  // warpgroups with a feature of the group
    const int nsl = min(4, ns - 4 * fg);       // slices of x the group holds
    init_ring(full, empty, wgs);
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // as in launch 1

    if (wg == CONSUMERS / 128) {  // the producer warp: theta' of the chunk, then its rows of the group's slices
        if (tid == CONSUMERS) {
            RingPlace at(STAGES);
            for (int i = 0; i < my_chunks; ++i) {
                const long long chunk = blockIdx.z + (long long)i * gridDim.z;
                const long long rt = chunk >> 2;
                mbar_wait(&empty[at.st], at.parity ^ 1u);
                unsigned char* dst = ring + at.st * STAGE_BYTES;
                mbar_expect_bytes(&full[at.st], TILE_BYTES + nsl * (TILE_BYTES / 4));
                bulk_copy(dst, theta + ((size_t)chunk * gridDim.y + ct) * 2 * TILE_FLOATS, TILE_BYTES, &full[at.st]);
                for (int q = 0; q < nsl; ++q) {
                    const float* src = px + ((size_t)rt * ns + 4 * fg + q) * 2 * TILE_FLOATS + (chunk & 3) * (TILE_FLOATS / 4);
                    unsigned char* xq = dst + TILE_BYTES + q * (TILE_BYTES / 4);
                    bulk_copy(xq, src, TILE_BYTES / 8, &full[at.st]);
                    bulk_copy(xq + TILE_BYTES / 8, src + TILE_FLOATS, TILE_BYTES / 8, &full[at.st]);
                }
                at.next();
            }
        }
        return;
    }
    if (wg >= wgs) return;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // A = x^T: this thread's features 16 warp + g and + 8 of its warpgroup's
    // 64 lie in slice fq of the group, at fs and fs + 8
    const int fq = 2 * wg + (warp >> 1);
    const int fs = 16 * (warp & 1) + g;

    float gs[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) gs[e] = 0.0f;
    RingPlace at(STAGES);
    for (int i = 0; i < my_chunks; ++i) {
        mbar_wait(&full[at.st], at.parity);
        const float* stage = reinterpret_cast<const float*>(ring + at.st * STAGE_BYTES);
        const float* xs = stage + 2 * TILE_FLOATS + fq * (TILE_FLOATS / 2);  // the slice's 32 rows: hi, then lo
        // a[0] = A[f][k] = x(row 8 ks + t, feature fs), a[1] feature fs + 8,
        // a[2], a[3] row + 4; x at kmajor_index(row, feature, 32)
        uint32_t ah[RCH / 8][4], al[RCH / 8][4];
#pragma unroll
        for (int ks = 0; ks < RCH / 8; ++ks) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 8 * ks + t + 4 * (q >> 1);
                const int f = fs + 8 * (q & 1);
                const int idx = (r >> 3) * 256 + (f >> 2) * 32 + (r & 7) * 4 + (f & 3);
                ah[ks][q] = __float_as_uint(xs[idx]);
                al[ks][q] = __float_as_uint(xs[TILE_FLOATS / 4 + idx]);
            }
        }
        const uint64_t db_hi = kmajor_desc(stage, DS);
        const uint64_t db_lo = kmajor_desc(stage + TILE_FLOATS, DS);
        float acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < RCH / 8; ++ks) {
            const uint64_t o = ks * desc_k8_step();
            mma_n128k8_rs(acc, al[ks], db_hi + o);
            mma_n128k8_rs(acc, ah[ks], db_lo + o);
        }
#pragma unroll
        for (int ks = 0; ks < RCH / 8; ++ks) mma_n128k8_rs(acc, ah[ks], db_hi + ks * desc_k8_step());
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int ks = 0; ks < RCH / 8; ++ks)
#pragma unroll
            for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(ah[ks][q]), "+r"(al[ks][q])::"memory");
        release(empty, at);
#pragma unroll
        for (int e = 0; e < 64; ++e) gs[e] += acc[e];
    }

    // --- this block's partial: gs[e] is (feature 16 warp + g + 8 ((e/2)%2),
    // chain 8(e/4) + 2t + e%2) of the warpgroup's 64 x 128
    float* part = partials + (size_t)blockIdx.z * d * c;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
        const int f = fg * FG + 64 * wg + 16 * warp + g + 8 * ((e >> 1) & 1);
        const int cc = ct * CH + 8 * (e >> 2) + 2 * t + (e & 1);
        if (f < d && cc < c) part[(size_t)f * c + cc] = gs[e];
    }
}

// Launch 1's double sums into out: the families' logp, ga, ge (rows 0, 1,
// 2), the ordered GLM's logp (row 0) and gcuts (rows d + 1 .. d + q - 1);
// the blocks in order.
__global__ void reduce_sums_kernel(const double* __restrict__ sums, float* __restrict__ out, int row_blocks, int q,
                                   int c, int d, int ordered) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)q * c) return;
    const int qq = (int)(i / c);
    const int cc = (int)(i - (long long)qq * c);
    double s = 0.0;
    for (int b = 0; b < row_blocks; ++b) s += sums[((size_t)b * q + qq) * c + cc];
    const int row = ordered ? (qq == 0 ? 0 : d + qq) : qq;
    out[(size_t)row * c + cc] = (float)s;
}

// The instantiated KIND of launch 1: the four families and the ordered GLM.
#define GLM_TILED_KINDS(X) X(0) X(1) X(2) X(3) X(4)

}  // namespace tiled

}  // namespace

// ---------------------------------------------------------------------------
// The C interface.  Each *_launch returns the CUDA error code of its launches
// (0: every launch was accepted).
// ---------------------------------------------------------------------------

// Shared memory of one block of the tensor-core kernels (TC_CHAINS chains):
// d columns, kcat categories (0 for the four families).
extern "C" long long glm_tc_smem_bytes(int d, int kcat) { return (long long)tc_layout_of(d, kcat).total; }

// Chains of one block of the tensor-core kernels.
extern "C" int glm_tc_chains_per_block() { return TC_CHAINS; }

// The widest x and the most categories the tensor-core kernels take.
extern "C" int glm_tc_max_d() { return TC_MAX_D; }
extern "C" int glm_tc_max_categories() { return TC_MAX_CATEGORIES; }

// kind 0..3: the families (alpha (c,), beta (d, c), extra (c,): sigma / phi,
// null for the families without one; kcat 0); kind 4: the ordered kernel
// (alpha unused, beta (d, c), extra the cuts (kcat-1, c)).  x and y 16-byte
// aligned.  partials (row_blocks, rows, c) and out (rows, c) with rows = d + 3
// (families: logp, ga, ge, gb) or d + kcat (ordered: logp, gbeta, gcuts).
// Returns the CUDA error code of the two launches.
extern "C" int glm_tc_launch(int kind, int kcat, const void* y, const void* x, const void* alpha, const void* beta,
                             const void* extra, void* partials, void* out, int n, int d, int c, int row_blocks,
                             void* stream_ptr) {
    const int kc = kind == ORDERED_KIND ? kcat : 0;
    if (kind < 0 || kind > ORDERED_KIND || d < 1 || d > TC_MAX_D || (kind == ORDERED_KIND && (kc < 2 || kc > TC_MAX_CATEGORIES))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const size_t smem = tc_layout_of(d, kc).total;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;  // the wrapper sends such shapes to the tiled route
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

// The tiled route's shared memory per block (either launch; the same for
// every D and K).
extern "C" long long glm_tiled_smem_bytes() { return (long long)tiled::layout_of(tiled::STAGES).total; }

// The tiled route for any shape: kind and kcat, y, x, alpha, beta, extra as
// glm_tc_launch (x and y need no alignment).  Scratch: packed, launch 0's
// stages (ceil(c / 128) * ceil(d / 32) * 8,192 floats of beta, then
// ceil(n / 128) * ceil(d / 32) * 8,192 of x, then ceil(n / 128) * 128 of y,
// then for the ordered GLM (2 kcat + 1) * c of its cut tables);
// theta, ceil(n / 128) * 4 * ceil(c / 128) * 8,192 floats; sums,
// row_blocks_value * Q * c doubles (Q = 3 for the families, kcat for the
// ordered GLM); partials, row_blocks * d * c floats.  out (rows, c) as
// glm_tc_launch's.  Five launches: pack, value (row_blocks_value row
// blocks), gradient (row_blocks), the two reductions.
extern "C" int glm_tiled_launch(int kind, int kcat, const void* y, const void* x, const void* alpha, const void* beta,
                                const void* extra, void* packed, void* theta, void* sums, void* partials, void* out,
                                int n, int d, int c, int row_blocks_value, int row_blocks, void* stream_ptr) {
    using namespace tiled;
    const int kc = kind == ORDERED_KIND ? kcat : 0;
    const long long n_tiles = (n + (long long)RT - 1) / RT;
    const long long ns = (d + (long long)DS - 1) / DS;
    const long long col_tiles = (c + (long long)CH - 1) / CH;
    const long long groups = (d + (long long)FG - 1) / FG;
    if (kind < 0 || kind > ORDERED_KIND || n < 1 || d < 1 || c < 1 || (kind == ORDERED_KIND && kc < 2) ||
        row_blocks_value < 1 || row_blocks_value > n_tiles || row_blocks_value > 65535 || row_blocks < 1 ||
        row_blocks > 4 * n_tiles || row_blocks > 65535 || col_tiles > 65535 || n_tiles * 4 * col_tiles > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = layout_of(STAGES).total;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    float* pbeta = static_cast<float*>(packed);
    float* px = pbeta + col_tiles * ns * 2 * TILE_FLOATS;
    float* py = px + n_tiles * ns * 2 * TILE_FLOATS;
    float* pcut = py + n_tiles * RT;
    const long long items = col_tiles * ns * TILE_FLOATS + n_tiles * ns * (TILE_FLOATS / 4) + n_tiles * RT +
                            (kc > 0 ? (long long)(2 * kc + 1) * c : 0);
    const long long pack_blocks = (items + 255) / 256;
    pack_kernel<<<(unsigned)(pack_blocks < 16384 ? pack_blocks : 16384), 256, 0, stream>>>(
        y, static_cast<const float*>(x), static_cast<const float*>(beta), static_cast<const float*>(extra), n, d, c, kc,
        pbeta, px, py, pcut);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const float* af = static_cast<const float*>(alpha);
    const float* ef = kc > 0 ? pcut : static_cast<const float*>(extra);
    float* th = static_cast<float*>(theta);
    double* sm = static_cast<double*>(sums);
    const dim3 grid1((unsigned)col_tiles, (unsigned)row_blocks_value);
    err = cudaErrorInvalidValue;
#define GLM_TILED_CASE(KIND_)                                                                                          \
    if (kind == KIND_) {                                                                                               \
        err = allow_smem((const void*)value_kernel<KIND_>, smem);                                                     \
        if (err == cudaSuccess) {                                                                                      \
            value_kernel<KIND_><<<grid1, THREADS, smem, stream>>>(pbeta, px, py, af, ef, n, d, c, kc, th, sm);          \
            err = cudaGetLastError();                                                                                  \
        }                                                                                                              \
    } else
    GLM_TILED_KINDS(GLM_TILED_CASE) { return (int)cudaErrorInvalidValue; }
#undef GLM_TILED_CASE
    if (err != cudaSuccess) return (int)err;
    err = allow_smem((const void*)grad_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    grad_kernel<<<dim3((unsigned)groups, (unsigned)col_tiles, (unsigned)row_blocks), THREADS, smem, stream>>>(
        px, th, n, d, c, static_cast<float*>(partials));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int q = kc > 0 ? kc : 3;
    reduce_sums_kernel<<<(unsigned)(((long long)q * c + 255) / 256), 256, 0, stream>>>(sm, static_cast<float*>(out),
                                                                                       row_blocks_value, q, c, d, kc > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)glm_common::reduce_partials(static_cast<const float*>(partials),
                                            static_cast<float*>(out) + (size_t)(kc > 0 ? 1 : 3) * c, row_blocks,
                                            (long long)d * c, stream);
}
