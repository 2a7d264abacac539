// Categorical-logit GLM log-prob + parameter gradients for a batch of chains,
// with both products on Hopper's tensor cores in 3xTF32, at every shape:
// glm_categorical_kernel (one launch and its reduction) where a chain's
// classes fit one column tile (K <= 64) and D its instances; the tiled pair
// categorical_lse_kernel / categorical_grad_kernel<MT> (further down, with a
// note of its own) for every other shape.  The wrapper's categorical_route
// (ops/glm_fused.py) picks by shape alone.
//
// Replaces the TPU kernel math_tpu/ops/pallas_glm.py::_categorical_kernel
// (launched by _categorical_forward).  y (N,) int32 in 1..K, x (N, D)
// row-major, alpha (C, K), beta (C, D, K), all float32 but y:
//
//     eta[c] = x @ beta[c] + alpha[c]   lp = eta_y - logsumexp_k eta_k
//     theta' = onehot(y) - softmax(eta)
//     logp = sum_n lp,  galpha = sum_n theta',  gbeta = x^T theta'
//
// beta is read as a (D, C*K) matrix, column c*K + k, indexed from the (C, D, K)
// tensor when it is staged (once per block), so no permuted copy is made.  The
// categories are assumed valid; y is clamped into 1..K only so that an invalid
// value cannot read outside a tile.
//
// What bounds it: the two products, 4*N*D*C*K flops on 4*(N*D + N) bytes of
// data (some 1,250 flops per byte at D=50, C=256, K=5).  Float32 FMAs on the
// CUDA cores (67 TFLOP/s) made it a 1.57 ms kernel against a 0.40 ms bound.
// The TPU kernel pins float32 products, and one TF32 product keeps only some
// three digits, so the products run as three TF32 products (tf32x3.cuh):
// 3 x 4*N*D*C*K flops at the 495 TFLOP/s of the TF32 tensor cores, a bound of
// 0.155 ms, still 2.5x under the float32 one.
//
// Design.  A block owns a column tile of whole chains and walks its share of
// the 64-row tiles of x:
//  * Column tile: 40*WGS columns, one n40 slice per warpgroup (two
//    warpgroups, 80 columns, up to D = 211), cpt = floor(80/K) whole chains
//    (16 at K=5: 16 tiles for C=256).  The slice width is fixed by the wgmma
//    shape; each warpgroup has exactly one, so no product sits on a
//    divergent path (the compiler serialises wgmma there).  At 104 KB of
//    shared memory two blocks share an SM and hide each other's latencies.
//  * Product 1, eta (64 x 40 per warpgroup) = x_tile (64 x D) @ beta_tile, by
//    wgmma.m64n40k8, A = x from registers: the hi/lo fragments are built by
//    index from the staged row-major x tile, so x is never transposed or
//    padded in memory; D is padded to a multiple of 8 by the fragment loads
//    (zeros) and by the staged beta tile.
//  * The staged beta tile is K-major (N x Dp), as wgmma needs for a 32-bit B:
//    hi and lo parts, split once per block.
//  * eta + alpha goes from the accumulator to the theta' buffer, K-major
//    (N x 64 rows).  The softmax pass reads the K logits of a (row, chain)
//    from there, writes lp, and rewrites them in place as theta' hi, theta'
//    lo beside: the K-major layout the second product's B descriptor needs,
//    with no extra eta buffer.  For K <= 8 it is compiled for each K and a
//    thread takes four consecutive rows of a chain, one 16-byte word per
//    class in that layout; larger K take a thread per (row, chain) and loop
//    over the classes.
//  * Product 2, [gbeta; galpha] (64*MT x 40 per warpgroup) += [x_tile, 1]^T
//    @ theta', A again from registers: (D + 1) rows padded to MT 64-row tiles
//    (MT = 1 up to D = 63); the row of ones gives galpha.  The tensor core's
//    float32 sums do not round to nearest: summed over a block's ~100 tiles
//    they lost two digits (gradient errors of 0.3 at the main shape).  So each
//    tile's product starts from zero (24 accumulation steps) and is added to
//    the block's sums, kept in registers, by IEEE adds.  With the small terms
//    first, 3xTF32 then keeps the float32 kernel's tolerances (logp rtol 2e-5,
//    gradients rtol 3e-4).
//  * x and y tiles arrive by 1-D bulk copies (cp.async.bulk, completion on an
//    mbarrier) into a ring of two stages: a whole 64-row tile is one
//    contiguous span of 256*D bytes, 16-byte aligned when x is (the wrapper
//    checks).  Thread 0 asks for the next tile while the block works on this
//    one.  A ragged last tile is loaded by plain loads, zeros past N.
//  * Sums are deterministic: the lp of each tile is summed in float per chain
//    (four rows by shuffles, then the 16 row groups) and the tile sums in
//    double; each block writes one partial and reduce_partials_kernel adds the
//    partials in block order in double.  No atomics.
//
// Where it departs from the design it was planned to: n40 slices, one per
// warpgroup, in place of one instruction of width cpt*K rounded to 8 (one
// wrapper, no divergent products); eta shares the theta' buffer; the column
// tile is 80 wide where 160 was planned (two blocks on an SM were faster).
//
// Shared memory per block, bytes: 2*N*Dp*4 (beta hi, lo) + 2*N*64*4 (theta'
// hi, lo) + S*64*(D + 1)*4 (the ring of x and y tiles) + N*4 (alpha) +
// 16*cpt*4 (lp by 4-row groups) + cpt*8 (lp sums) + S*8 (barriers), each
// rounded up to 128: layout_of below, mirrored by the wrapper's tile plan.

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

constexpr int TM = 64;        // rows per tile

struct Layout {
    size_t beta_hi, beta_lo, th_hi, th_lo, xs, ys, alpha, lps, lpacc, bars, total;
};

__host__ __device__ inline Layout layout_of(int ncols_, int d, int cpt, int stages) {
    const size_t ncols = (size_t)ncols_;
    const size_t dp = (size_t)((d + 7) & ~7);
    Layout L;
    size_t at = 0;
    L.beta_hi = at; at += up128(ncols * dp * 4);
    L.beta_lo = at; at += up128(ncols * dp * 4);
    L.th_hi = at;   at += up128(ncols * TM * 4);
    L.th_lo = at;   at += up128(ncols * TM * 4);
    L.xs = at;      at += up128((size_t)stages * TM * d * 4);
    L.ys = at;      at += up128((size_t)stages * TM * 4);
    L.alpha = at;   at += up128(ncols * 4);
    L.lps = at;     at += up128((size_t)(TM / 4) * cpt * 4);
    L.lpacc = at;   at += up128((size_t)cpt * 8);
    L.bars = at;    at += up128((size_t)stages * 8);
    L.total = at;
    return L;
}

// hi/lo fragments of A for one k8 step: a[0..3] = A[row(e)][col(e)] with the
// register layout of tf32x3.cuh; value(r, k) gives A's entries.
template <typename Value>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], int r, int k, Value value) {
    split(value(r, k), hi[0], lo[0]);
    split(value(r + 8, k), hi[1], lo[1]);
    split(value(r, k + 4), hi[2], lo[2]);
    split(value(r + 8, k + 4), hi[3], lo[3]);
}

// One k8 step on this warpgroup's n40 slice.
__device__ __forceinline__ void issue_k8(float (&acc)[20], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                         uint64_t desc_hi, uint64_t desc_lo) {
    wgmma_fence();
    mma3_n40k8(acc, hi, lo, desc_hi, desc_lo);
    wgmma_commit();
}

// acc = A (64 x 8*ksteps, fragments by value(r, k)) @ B (the n40 slice at
// the descriptors).  Two fragment sets alternate: a set is rewritten only
// after the group that read it has completed (wait_group 1).
template <typename Value>
__device__ __forceinline__ void product(float (&acc)[20], int ksteps, int row, int t, Value value,
                                        uint64_t desc_hi, uint64_t desc_lo) {
#pragma unroll
    for (int e = 0; e < 20; ++e) acc[e] = 0.0f;
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    for (int ks = 0; ks < ksteps; ks += 2) {
        load_a(ah0, al0, row, 8 * ks + t, value);
        fence_regs(acc);
        issue_k8(acc, ah0, al0, desc_hi + ks * desc_k8_step(), desc_lo + ks * desc_k8_step());
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (ks + 1 < ksteps) {
            load_a(ah1, al1, row, 8 * (ks + 1) + t, value);
            issue_k8(acc, ah1, al1, desc_hi + (ks + 1) * desc_k8_step(), desc_lo + (ks + 1) * desc_k8_step());
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        }
    }
    wgmma_wait_all();
    fence_regs(acc);
}

// lp and theta' of each (row, chain) of the tile from its K logits in the
// theta' buffer, in place.  K <= 8 classes: a thread takes four consecutive
// rows of one chain, which the K-major layout keeps in one 16-byte word per
// class, so the logits come in K float4 loads, the four rows are independent
// work for the thread, and theta' hi and lo go out in 2K float4 stores.  A
// warp covers four row groups (lane / 8) of eight consecutive chains (lane %
// 8): a quarter warp's 16-byte accesses fall on distinct banks at odd K.  The
// four rows' lp are added in the thread, in float, into lps (row group,
// chain).
template <int KC, int WARPS>
__device__ __forceinline__ void softmax_rows4(float* thi, float* tlo, float* lps, const int* ys, int cpt, int r0, int n,
                                              int c0, int c) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int ntasks = 4 * ((cpt + 7) / 8);
    for (int wt = warp; wt < ntasks; wt += WARPS) {
        const int rg = 4 * (wt % 4) + (lane >> 3);  // rows 4*rg .. 4*rg+3
        const int q = 8 * (wt / 4) + (lane & 7);
        if (q >= cpt) continue;
        const int4 y4 = *reinterpret_cast<const int4*>(ys + 4 * rg);
        const int yv[4] = {y4.x, y4.y, y4.z, y4.w};
        float4 e4[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) e4[k] = *reinterpret_cast<const float4*>(thi + kmajor_index(q * KC + k, 4 * rg, TM));
        float e[4][KC], ey[4];
        int yk[4];
        bool ok[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            yk[r] = min(max(yv[r], 1), KC) - 1;
            ok[r] = (r0 + 4 * rg + r < n) && (c0 + q < c);
            // the class's own logit by its own load: a select over e[] by yk
            // would be compiled into an indexed load from local memory
            ey[r] = thi[kmajor_index(q * KC + yk[r], 4 * rg + r, TM)];
#pragma unroll
            for (int k = 0; k < KC; ++k) e[r][k] = r == 0 ? e4[k].x : (r == 1 ? e4[k].y : (r == 2 ? e4[k].z : e4[k].w));
        }
        float lp = 0.0f, inv_s[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float mx = e[r][0];
#pragma unroll
            for (int k = 1; k < KC; ++k) mx = fmaxf(mx, e[r][k]);
            float se = 0.0f;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                e[r][k] = expf(e[r][k] - mx);
                se += e[r][k];
            }
            inv_s[r] = 1.0f / se;
            lp += ok[r] ? ey[r] - (mx + logf(se)) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) {
            uint32_t h[4], l[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) split(ok[r] ? (k == yk[r] ? 1.0f : 0.0f) - e[r][k] * inv_s[r] : 0.0f, h[r], l[r]);
            const int idx = kmajor_index(q * KC + k, 4 * rg, TM);
            *reinterpret_cast<uint4*>(thi + idx) = make_uint4(h[0], h[1], h[2], h[3]);
            *reinterpret_cast<uint4*>(tlo + idx) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        lps[rg * cpt + q] = lp;
    }
}

// Any K: a thread per (row, chain), serial over K.  A warp task is rows
// 4*(wt % 16) .. +3 (lane % 4) of chains 8*(wt / 16) .. +7 (lane / 4); lanes
// past the last chain idle but take part in the shuffles that add the four
// rows of a chain into lps.
template <int WARPS>
__device__ __forceinline__ void softmax_tasks_any(float* thi, float* tlo, float* lps, const int* ys, int cpt, int r0,
                                                  int n, int c0, int c, int kcls) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int ntasks = 16 * ((cpt + 7) / 8);
    for (int wt = warp; wt < ntasks; wt += WARPS) {
        const int r = (wt % 16) * 4 + (lane & 3);
        const int q = (wt / 16) * 8 + (lane >> 2);
        const bool live = q < cpt;
        float lp = 0.0f;
        if (live) {
            const bool ok = (r0 + r < n) && (c0 + q < c);
            const int yk = min(max(ys[r], 1), kcls) - 1;
            const int col0 = q * kcls;
            float mx = thi[kmajor_index(col0, r, TM)];
            for (int k = 1; k < kcls; ++k) mx = fmaxf(mx, thi[kmajor_index(col0 + k, r, TM)]);
            float se = 0.0f;
            for (int k = 0; k < kcls; ++k) se += expf(thi[kmajor_index(col0 + k, r, TM)] - mx);
            const float inv_s = 1.0f / se;
            lp = ok ? thi[kmajor_index(col0 + yk, r, TM)] - (mx + logf(se)) : 0.0f;
            for (int k = 0; k < kcls; ++k) {
                const int idx = kmajor_index(col0 + k, r, TM);
                const float tp = ok ? (k == yk ? 1.0f : 0.0f) - expf(thi[idx] - mx) * inv_s : 0.0f;
                uint32_t h, l;
                split(tp, h, l);
                thi[idx] = __uint_as_float(h);
                tlo[idx] = __uint_as_float(l);
            }
        }
        lp += __shfl_xor_sync(0xffffffffu, lp, 1);
        lp += __shfl_xor_sync(0xffffffffu, lp, 2);
        if (live && (lane & 3) == 0) lps[(wt % 16) * cpt + q] = lp;
    }
}

// partials: (gridDim.x, C*(1 + K + D*K)); logp (C), galpha (C, K), gbeta (C, D, K).
// Two blocks of the 80-column tile share an SM (the tile plan counts on it when
// shared memory allows, MT = 1): at most 128 registers a thread.
template <int WGS, int MT>
__global__ void __launch_bounds__(128 * WGS, (WGS == 2 && MT == 1) ? 2 : 1)
glm_categorical_kernel(const int* __restrict__ y, const float* __restrict__ x,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       int n, int d, int c, int kcls, int cpt, int stages, float* __restrict__ partials) {
    constexpr int NC = WGS * 40;  // columns of the tile: an n40 slice per warpgroup
    constexpr int THREADS = 128 * WGS;
    constexpr int WARPS = THREADS / 32;
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = layout_of(NC, d, cpt, stages);
    float* bhi = reinterpret_cast<float*>(smem + L.beta_hi);    // (NC x dp) K-major, beta hi
    float* blo = reinterpret_cast<float*>(smem + L.beta_lo);    //                     beta lo
    float* thi = reinterpret_cast<float*>(smem + L.th_hi);      // (NC x 64) K-major, eta, then theta' hi
    float* tlo = reinterpret_cast<float*>(smem + L.th_lo);      //                    theta' lo
    float* xring = reinterpret_cast<float*>(smem + L.xs);       // stages x (64, d) row-major x tiles
    int* yring = reinterpret_cast<int*>(smem + L.ys);           // stages x 64
    float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);  // NC
    float* lps = reinterpret_cast<float*>(smem + L.lps);        // (16, cpt) lp of each (4-row group, chain)
    double* lpacc = reinterpret_cast<double*>(smem + L.lpacc);  // cpt: the block's logp sums
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int slice = tid >> 7;             // this warpgroup's n40 slice
    const int row_a = 16 * (warp & 3) + g;  // this thread's accumulator rows: row_a, row_a + 8
    const int dp = (d + 7) & ~7;
    const int used = cpt * kcls;
    const int c0 = blockIdx.y * cpt;  // first chain of the tile
    const int n_tiles = (n + TM - 1) / TM;
    const int full_tiles = n / TM;  // tiles 0 .. full_tiles-1 hold 64 rows

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
        fence_mbar_init();
    }
    // ask for the block's j-th tile (thread 0): bulk copies into stage j % stages
    auto request = [&](int j) {
        const int tile = blockIdx.x + j * gridDim.x;
        if (tile >= full_tiles) return;  // a ragged tile is loaded by plain loads
        const int s = j % stages;
        request_row_tile(xring + (size_t)s * TM * d, yring + s * TM, x, y, tile, d, &bars[s]);
    };
    __syncthreads();  // the barriers are initialised
    if (tid == 0) {
        for (int j = 0; j < stages; ++j) request(j);
    }

    // the beta tile, hi and lo, K-major; alpha; theta' lo starts at 0 (its idle
    // columns are never written); the logp sums
    for (int i = tid; i < NC * dp; i += THREADS) {
        const int dd = i / NC;
        const int j = i % NC;
        const int q = j / kcls;
        const float v = (dd < d && j < used && c0 + q < c) ? beta[((size_t)(c0 + q) * d + dd) * kcls + j % kcls] : 0.0f;
        uint32_t h, l;
        split(v, h, l);
        bhi[kmajor_index(j, dd, dp)] = __uint_as_float(h);
        blo[kmajor_index(j, dd, dp)] = __uint_as_float(l);
    }
    for (int j = tid; j < NC; j += THREADS) {
        const int q = j / kcls;
        alpha_s[j] = (j < used && c0 + q < c) ? alpha[(size_t)(c0 + q) * kcls + j % kcls] : 0.0f;
    }
    for (int i = tid; i < NC * TM; i += THREADS) tlo[i] = 0.0f;
    for (int q = tid; q < cpt; q += THREADS) lpacc[q] = 0.0;
    fence_proxy_async();  // the staged tiles are read by wgmma

    const uint64_t dbeta_hi = kmajor_desc(bhi, dp) + slice * desc_n40_step(dp);
    const uint64_t dbeta_lo = kmajor_desc(blo, dp) + slice * desc_n40_step(dp);
    const uint64_t dth_hi = kmajor_desc(thi, TM) + slice * desc_n40_step(TM);
    const uint64_t dth_lo = kmajor_desc(tlo, TM) + slice * desc_n40_step(TM);

    float accg[MT][20];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 20; ++e) accg[m][e] = 0.0f;

    for (int it = 0;; ++it) {
        const int tile = blockIdx.x + it * gridDim.x;
        if (tile >= n_tiles) break;
        const int r0 = tile * TM;
        const int s = it % stages;
        // every thread is done with the previous tile: its stage of the ring,
        // the theta' buffers and lps may be written again
        __syncthreads();
        if (tid == 0 && it >= 1) request(it - 1 + stages);
        const float* xs = xring + (size_t)s * TM * d;
        int* ys = yring + s * TM;
        if (tile < full_tiles) {
            mbar_wait(&bars[s], (uint32_t)((it / stages) & 1));
        } else {
            float* xw = xring + (size_t)s * TM * d;
            const int rows = n - r0;
            for (int i = tid; i < TM * d; i += THREADS) xw[i] = i < rows * d ? x[(size_t)r0 * d + i] : 0.0f;
            for (int i = tid; i < TM; i += THREADS) ys[i] = i < rows ? y[r0 + i] : 1;
            __syncthreads();
        }

        // --- product 1: eta = x_tile @ beta_tile ----------------------------
        float acc[20];
        auto xval = [xs, d](int r, int k) { return k < d ? xs[r * d + k] : 0.0f; };
        product(acc, dp / 8, row_a, t, xval, dbeta_hi, dbeta_lo);
        // eta + alpha into the theta' buffer (K-major: column, then row)
#pragma unroll
        for (int e = 0; e < 20; ++e) {
            const int row = row_a + 8 * ((e >> 1) & 1);
            const int col = 40 * slice + 8 * (e >> 2) + 2 * t + (e & 1);
            thi[kmajor_index(col, row, TM)] = acc[e] + alpha_s[col];
        }
        __syncthreads();

        // --- lp and theta' of each (row, chain) from its K logits, in place --
        switch (kcls) {
            case 1: softmax_rows4<1, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 2: softmax_rows4<2, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 3: softmax_rows4<3, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 4: softmax_rows4<4, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 5: softmax_rows4<5, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 6: softmax_rows4<6, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 7: softmax_rows4<7, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            case 8: softmax_rows4<8, WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c); break;
            default: softmax_tasks_any<WARPS>(thi, tlo, lps, ys, cpt, r0, n, c0, c, kcls);
        }
        fence_proxy_async();  // theta' is read by wgmma next
        __syncthreads();

        // the tile's lp, per chain in float (four rows a warp task, then the 16
        // row groups), into the block's sums in double
        for (int q = tid; q < cpt; q += THREADS) {
            float tile_lp = 0.0f;
            for (int rg = 0; rg < TM / 4; ++rg) tile_lp += lps[rg * cpt + q];
            lpacc[q] += (double)tile_lp;
        }

        // --- product 2: [gbeta; galpha] += [x_tile, 1]^T @ theta' ------------
        // The tensor core's float32 sums are not rounded to nearest, so each
        // tile's product is taken alone (24 steps of accumulation) and added to
        // the block's sums by IEEE adds.
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            auto xtval = [xs, d](int dd, int r) { return dd < d ? xs[r * d + dd] : (dd == d ? 1.0f : 0.0f); };
            product(acc, TM / 8, 64 * m + row_a, t, xtval, dth_hi, dth_lo);
#pragma unroll
            for (int e = 0; e < 20; ++e) accg[m][e] += acc[e];
        }
        fence_proxy_async();  // theta' is written again by the next tile
    }

    // --- this block's partial ------------------------------------------------
    const size_t mtot = (size_t)c * (1 + kcls + (size_t)d * kcls);
    float* part = partials + (size_t)blockIdx.x * mtot;
    float* part_ga = part + c;
    float* part_gb = part_ga + (size_t)c * kcls;
    __syncthreads();
    for (int q = tid; q < cpt; q += THREADS) {
        if (c0 + q < c) part[c0 + q] = (float)lpacc[q];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 20; ++e) {
            const int dd = 64 * m + row_a + 8 * ((e >> 1) & 1);
            const int col = 40 * slice + 8 * (e >> 2) + 2 * t + (e & 1);
            const int cj = c0 + col / kcls;
            if (col >= used || cj >= c || dd > d) continue;
            if (dd < d) {
                part_gb[((size_t)cj * d + dd) * kcls + col % kcls] = accg[m][e];
            } else {
                part_ga[(size_t)cj * kcls + col % kcls] = accg[m][e];
            }
        }
    }
}

// The instantiated (WGS, MT): WGS warpgroups of an n40 slice each (40*WGS
// columns) and MT 64-row tiles of [gbeta; galpha], accumulators of
// (MT + 1) * 20 floats a thread.  One warpgroup only where two would not fit
// shared memory (D > 212).  The wrapper's tile plan (ops/glm_fused.py) lists
// the same set.
#define GLM_CATEGORICAL_INSTANCES(X) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(1, 4) X(1, 5)

// ===========================================================================
// The tiled kernel pair: every shape the kernel above does not take
// ===========================================================================
//
// Replaces math_tpu/ops/pallas_glm.py::_categorical_kernel at the shapes
// glm_categorical_kernel cannot hold: more than 64 classes (one chain's
// classes no longer share one column tile), or a D past its instances (beta
// staged whole no longer fits shared memory, [gbeta; galpha] no longer fits
// its registers).  Same function, same partials and tolerances, any N, D, C, K.
//
// What bounds it: the two products, 3 x 4*N*D*C*K flops in 3xTF32 at 495
// TFLOP/s (2.02 ms at N = 100,000, D = 50, C = 256, K = 65; 6.21 at K = 200;
// 1.24 at D = 400, K = 5; 5.39 at D = 212, K = 41).  The design below does
// product 1 twice, and once more for every further group of D rows, so its
// own work is (2 + G) / 2 of that count; and the N*C*K exponentials twice.
//
// Design.  The softmax needs the log-sum-exp of all K logits of a (row, chain)
// before any theta' exists, so the work is split over launches:
//  * Columns are the flat (chain, class) columns of the (D, C*K) matrix beta,
//    in tiles of NC = 80, one n40 wgmma slice per warpgroup as above.  A tile
//    holds the classes of whichever chains fall in it, so no column is idle
//    but at the end of C*K (a chain may span tiles; a tile may hold parts of
//    several chains).
//  * Launch 0, categorical_pack_kernel, lays the operands out as the ring
//    takes them: beta split once into hi / lo, K-major, per (column tile,
//    slice of DS = 32 features), 20 KB each, for launch 2's tiles and again
//    for launch 1's windows; x per (64-row tile, slice), rows XS = 36 floats
//    apart, zeros past N and D, 9 KB each.  A slice is then contiguous (x's
//    rows of a slice are not: D apart).
//  * Product 1 takes D a slice at a time, each slice's 3xTF32 product from
//    zero and added to eta by IEEE adds.  Beta's slices (and x's, where x
//    does not come whole) flow through a ring of stages filled by 1-D bulk
//    copies that complete on an mbarrier; thread 0 asks for the stage the
//    last slice freed while this slice's products run, and the ring runs on
//    across a block's windows and row tiles.  No beta tile of whole D is
//    staged, so shared memory does not grow with D.
//  * Launch 1, categorical_lse_kernel: a block owns cpb <= 16 whole chains
//    (the fewest idle columns in its windows of 80) and two blocks share an
//    SM.  Per row tile and window: eta + alpha to shared memory, then per
//    (row, chain segment) the maximum and sum of exponentials (a lane's
//    logits loaded at once, tree reductions; four lanes a segment from K = 16
//    up), merged into the running (max, sum) of the (row, chain): an online
//    log-sum-exp.  At the row tile's end it writes lse (C, N) and adds lp =
//    eta_y - lse per chain (rows in order in float, the tiles in double) into
//    the block's logp partial.  A column's eta is the same sum in launch 2,
//    bit for bit: the tile around it changes no product's order.
//  * Launch 2, categorical_grad_kernel<MT, WHOLE_X>: grid (column tile, row
//    block, D group).  Per row tile: x whole (WHOLE_X: all its packed slices
//    in one bulk copy, where shared memory holds them) or the group's window,
//    product 1 again, theta' = onehot(y) - exp(eta + alpha - lse) straight
//    from the accumulator registers, split hi/lo into the K-major theta'
//    tile, then product 2, [x, 1]^T @ theta', over the group's 64*MT rows of
//    [gbeta; galpha], each tile's product from zero and added to the block's
//    sums in registers by IEEE adds.  Groups of up to 7 row tiles (4 where a
//    window of 14 slices does not fit); MT the least instance that covers a
//    group; two blocks share an SM at MT = 1.
//  * Sums are deterministic: each block writes one partial (logp from launch
//    1, galpha and gbeta from launch 2), and reduce_partials_kernel adds each
//    set in block order in double.  A call makes five launches.
//
// Where it departs from the plan it was built to: the operands are packed
// by a launch of their own (x is read once more, beta is split once a call
// rather than once a block), so that every slice is one or two bulk copies;
// launch 1 owns whole chains rather than tiling columns, so the running
// log-sum-exp never leaves shared memory; the row blocks of the two launches
// are chosen apart (launch 1 has few blocks per row block, launch 2 many), so
// the logp and gradient partials are reduced by two launches.  What its
// clock64 stamps showed (tools/phase_clocks.py --tiled, an H100 SXM at 700
// W): a first version that staged each slice through registers behind a
// block barrier spent most of its time waiting on loads, on one block an SM;
// in this one, at N = 100,000, D = 50, C = 256, K = 65, launch 1's products
// take 35% of its clocks, the sweep 37%, the window's set-up 10% and the
// waits and barriers 14%; launch 2's products 54%, theta' 22%: the
// exponentials and the block's barriers on the CUDA cores, beside the
// tensor cores, set the time (at D = 212 and 400 the products take 55-78%).
//
// Shared memory, bytes, each part rounded up to 128: launch 1 the ring (2 *
// (20,480 + 9,216)), eta (64 * 84 * 4), two tables of chain segments, the
// running max, sum and picked logit (3 * 64 * cpb * 4), the logp sums (cpb *
// 8), alpha, y, the barriers; launch 2 the ring (2-4 stages of beta, and of
// x unless WHOLE_X), the theta' tile (2 * 80 * 64 * 4), x (ns or 2*MT packed
// slices), the tile's lse (64 * nch * 4), y, the column table, the barriers.
// lse_layout_of and grad_layout_of below, mirrored by the wrapper's plan.

namespace tiled {

constexpr int NC = 80;        // columns of a tile: an n40 slice per warpgroup
constexpr int THREADS = 256;  // two warpgroups
constexpr int DS = 32;        // features of a slice of product 1
constexpr int XS = DS + 4;    // row stride (floats) of a packed x slice: load_a's reads fall on distinct banks
constexpr int EB = NC + 4;    // row stride (floats) of launch 1's eta tile: the sweep's reads fall on distinct banks
constexpr int LSE_STAGES = 2;   // launch 1's ring of slices: two blocks share an SM
constexpr int MAX_GRAD_STAGES = 4;  // launch 2's, as its plan chooses
constexpr int MAX_CPB = 16;     // chains of a block of launch 1 at most
constexpr uint32_t BETA_SLICE_BYTES = 2 * NC * DS * 4;  // beta hi, then lo, K-major (NC x DS)
constexpr uint32_t X_SLICE_BYTES = TM * XS * 4;         // x (TM x XS), row-major
constexpr size_t STAGE_BYTES = (size_t)BETA_SLICE_BYTES + X_SLICE_BYTES;
static_assert(BETA_SLICE_BYTES % 128 == 0 && X_SLICE_BYTES % 128 == 0, "stages and slices stay 128-byte aligned");

static_assert(STAGE_BYTES % 128 == 0, "stages stay 128-byte aligned");

// The most chains a tile of NC columns touches.
__host__ __device__ inline int chains_per_tile(int kcls, int c) {
    const int most = (NC - 1) / kcls + 2;
    return c < most ? c : most;
}

struct LseLayout {
    size_t ring, eb, seg, mrun, srun, pick, lpacc, alpha, ys, bars, total;
};

__host__ __device__ inline LseLayout lse_layout_of(int cpb) {
    LseLayout L;
    size_t at = 0;
    L.ring = at;  at += LSE_STAGES * STAGE_BYTES;
    L.eb = at;    at += up128((size_t)TM * EB * 4);
    L.seg = at;   at += up128((size_t)2 * (NC + 1) * 16);
    L.mrun = at;  at += up128((size_t)TM * cpb * 4);
    L.srun = at;  at += up128((size_t)TM * cpb * 4);
    L.pick = at;  at += up128((size_t)TM * cpb * 4);
    L.lpacc = at; at += up128((size_t)cpb * 8);
    L.alpha = at; at += up128((size_t)NC * 4);
    L.ys = at;    at += up128((size_t)TM * 4);
    L.bars = at;  at += up128((size_t)LSE_STAGES * 8);
    L.total = at;
    return L;
}

struct GradLayout {
    size_t ring, th, xw, lse, ys, col, cb, bars, total;
};

// whole_x: the ring carries beta alone and x comes whole a row tile (all ns
// slices); else the ring carries both and the window holds the group's 2*mt.
__host__ __device__ inline GradLayout grad_layout_of(int mt, int nch, int stages, bool whole_x, int ns) {
    GradLayout L;
    size_t at = 0;
    L.ring = at;  at += (size_t)stages * (whole_x ? BETA_SLICE_BYTES : STAGE_BYTES);
    L.th = at;    at += up128((size_t)2 * NC * TM * 4);
    L.xw = at;    at += up128((size_t)(whole_x ? ns : 2 * mt) * X_SLICE_BYTES);
    L.lse = at;   at += up128((size_t)TM * nch * 4);
    L.ys = at;    at += up128((size_t)TM * 4);
    L.col = at;   at += up128((size_t)NC * 16);
    L.cb = at;    at += up128((size_t)NC * 8);
    L.bars = at;  at += up128((size_t)(MAX_GRAD_STAGES + 1) * 8);
    L.total = at;
    return L;
}

// --- cp.async: 4 bytes global -> shared, zeros where src_bytes is 0 ---------

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One stage of packed beta: beta's hi then lo parts of the 80 columns q0 ..
// q0+79 (those before qend), features 32s .. 32s+31, in the K-major
// core-matrix layout of tf32x3.cuh, zeros past qend and D; e is the float.
__device__ __forceinline__ float packed_beta(const float* __restrict__ beta, long long q0, long long qend, int s, int e,
                                             int d, int kcls) {
    const int idx = e % (NC * DS);  // kmajor_index(j, f - 32s, DS)
    const int w = idx & 31;
    const long long q = q0 + 8 * (idx >> 8) + (w >> 2);
    const int f = s * DS + 4 * ((idx >> 5) & 7) + (w & 3);
    float v = 0.0f;
    if (q < qend && f < d) {
        const long long cc = q / kcls;
        v = beta[(cc * d + f) * kcls + (q - cc * kcls)];
    }
    uint32_t h, l;
    split(v, h, l);
    return __uint_as_float(e < NC * DS ? h : l);
}

// Launch 0.  pbeta2: launch 2's stages, (column tile t, slice s) at t * ns +
// s, the columns 80t .. of the flat (chain, class) order.  pbeta1: launch 1's,
// (chain group g, window w, slice s) at (g * nwin1 + w) * ns + s, the columns
// 80w .. of group g's cpb chains.  px: (row tile, slice), rows XS floats
// apart, zeros past N, D and the slice.  A stage of beta is 5,120 floats, of
// x 2,304.
__global__ void __launch_bounds__(THREADS)
categorical_pack_kernel(const float* __restrict__ x, const float* __restrict__ beta, int n, int d, int c, int kcls,
                        int cpb, float* __restrict__ pbeta2, float* __restrict__ pbeta1, float* __restrict__ px) {
    const int ns = (d + DS - 1) / DS;
    const long long ncols = (long long)c * kcls;
    const int nwin1 = (cpb * kcls + NC - 1) / NC;
    const long long nb2 = (ncols + NC - 1) / NC * ns * (2 * NC * DS);
    const long long nb1 = (long long)((c + cpb - 1) / cpb) * nwin1 * ns * (2 * NC * DS);
    const long long nx = (long long)((n + TM - 1) / TM) * ns * (TM * XS);
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nb2 + nb1 + nx; i += (long long)gridDim.x * THREADS) {
        if (i < nb2) {
            const long long stage = i / (2 * NC * DS);
            const long long t = stage / ns;
            pbeta2[i] = packed_beta(beta, t * NC, ncols, (int)(stage - t * ns), (int)(i - stage * (2 * NC * DS)), d, kcls);
        } else if (i < nb2 + nb1) {
            const long long e = i - nb2;
            const long long stage = e / (2 * NC * DS);
            const long long v = stage / ns;
            const long long g = v / nwin1;
            const long long q0 = g * cpb * kcls + (v - g * nwin1) * NC;
            const long long qend = min((g + 1) * cpb, (long long)c) * kcls;
            pbeta1[e] = packed_beta(beta, q0, qend, (int)(stage - v * ns), (int)(e - stage * (2 * NC * DS)), d, kcls);
        } else {
            const long long e = i - nb2 - nb1;
            const long long stage = e / (TM * XS);
            const int w = (int)(e - stage * (TM * XS));
            const long long rt = stage / ns;
            const int s = (int)(stage - rt * ns);
            const int r = w / XS;
            const int kk = w - r * XS;
            const long long row = rt * TM + r;
            const int f = s * DS + kk;
            px[e] = (row < n && kk < DS && f < d) ? x[row * d + f] : 0.0f;
        }
    }
}

// Thread 0: packed beta stage vb, and packed x stage vx unless px is null,
// into the ring stage at dst, completing on bar.  No proxy fence: a stage is
// only ever written by these copies, and its readers (wgmma, and the loads
// of the A fragments) are done with it at the block barrier before.
__device__ __forceinline__ void request_slice(unsigned char* dst, uint64_t* bar, const float* pbeta, const float* px,
                                              long long vb, long long vx) {
    mbar_expect_bytes(bar, BETA_SLICE_BYTES + (px ? X_SLICE_BYTES : 0));
    bulk_copy(dst, pbeta + vb * (2 * NC * DS), BETA_SLICE_BYTES, bar);
    if (px) bulk_copy(dst + BETA_SLICE_BYTES, px + vx * (TM * XS), X_SLICE_BYTES, bar);
}

// Launch 1's sweep of a window: per (row, chain segment) the maximum and the
// sum of exponentials of its logits in eb (LANES threads a segment, joined
// by shuffles), the logit of y where the segment holds it, merged into the
// (chain, row)'s running sums.  The arrays are apart (__restrict__): a
// round's loads need not wait for the last round's stores.  exp by ex2.approx (__expf): each term is in
// (0, 1], so its error is ~1e-7 of the sum, far inside logp's rtol 2e-5.  seg[sg] = (first column, end column, chain
// from the group's first, the chain's class 0 column), window-relative.
// v[0] op v[1] op ... op v[N-1] as a tree, pairs of neighbours first (depth
// ceil(log2 N) rather than N - 1).
template <int N, typename Op>
__device__ __forceinline__ float tree_reduce(const float (&v)[N], Op op) {
    float u[N];
#pragma unroll
    for (int q = 0; q < N; ++q) u[q] = v[q];
#pragma unroll
    for (int w = 1; w < N; w *= 2) {
#pragma unroll
        for (int q = 0; q + w < N; q += 2 * w) u[q] = op(u[q], u[q + w]);
    }
    return u[0];
}

// MAXE: a lane's logits at most, all loaded at once, predicated (a segment
// holds at most min(K, NC) columns).
template <int LANES, int MAXE>
__device__ __forceinline__ void sweep(const float* __restrict__ eb, const int4* __restrict__ seg, int nseg,
                                      const int* __restrict__ ys, int kcls, float* __restrict__ mrun,
                                      float* __restrict__ srun, float* __restrict__ pick) {
    const int ntask = TM * nseg;
    for (int i0 = 0; i0 < ntask * LANES; i0 += THREADS) {
        const int i = i0 + threadIdx.x;
        const int task = i / LANES;
        const int sub = i % LANES;
        const bool live = task < ntask;
        const int r = task % TM;
        const int4 sg = seg[live ? task / TM : 0];
        const int lo = live ? sg.x : 0;
        const int hi = live ? sg.y : 0;
        float v[MAXE];
#pragma unroll
        for (int q = 0; q < MAXE; ++q) {
            const int j = lo + sub + q * LANES;
            v[q] = j < hi ? eb[r * EB + j] : -INFINITY;
        }
        float m = tree_reduce<MAXE>(v, [](float a, float b) { return fmaxf(a, b); });
        if (LANES == 4) {
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        }
#pragma unroll
        for (int q = 0; q < MAXE; ++q) v[q] = __expf(v[q] - m);  // exp(-inf - m) = 0 past the segment
        float sum = tree_reduce<MAXE>(v, [](float a, float b) { return a + b; });
        if (LANES == 4) {
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        }
        if (live && sub == 0) {
            const int st = sg.z * TM + r;
            const int pc = sg.w + min(max(ys[r], 1), kcls) - 1;
            if (pc >= lo && pc < hi) pick[st] = eb[r * EB + pc];
            const float m_old = mrun[st];
            const float m_new = fmaxf(m_old, m);
            srun[st] = srun[st] * __expf(m_old - m_new) + sum * __expf(m - m_new);
            mrun[st] = m_new;
        }
    }
}

// acc += A (64 x 8*KS from k8 step k0 on, fragments by value(r, k)) @ B (the
// n40 slice at the descriptors): the fragments of every step are loaded
// first, then the 3*KS products go out as one commit group, with nothing to
// wait for between them.  The caller waits (wgmma_wait_all) before reading
// acc or letting ah / al go.
template <int KS, typename Value>
__device__ __forceinline__ void mma_steps(float (&acc)[20], uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4], int row, int t,
                                          int k0, Value value, uint64_t desc_hi, uint64_t desc_lo) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(ah[ks], al[ks], row, 8 * (k0 + ks) + t, value);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        mma3_n40k8(acc, ah[ks], al[ks], desc_hi + (k0 + ks) * desc_k8_step(), desc_lo + (k0 + ks) * desc_k8_step());
    }
    wgmma_commit();
}

// eta += the product of a slice (its DS / 8 k8 steps; packed zeros past D):
// the beta stage at bhi (hi, then lo), the x slice at xs, for this thread's
// 20 accumulator entries of its warpgroup's n40 slice: from zero, added by
// IEEE adds.  Two batches of two k8 steps: 16 registers of fragments, so a
// thread of launch 2 at MT = 1 fits 128 registers without spills.
// meanwhile() runs while the first batch is in flight.
template <typename Meanwhile>
__device__ __forceinline__ void slice_product(float (&eta)[20], const float* bhi, const float* xs, Meanwhile meanwhile) {
    const int tid = threadIdx.x;
    const int row_a = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    const int slice = tid >> 7;
    auto xval = [xs](int r, int k) { return xs[r * XS + k]; };
    float acc[20];
#pragma unroll
    for (int e = 0; e < 20; ++e) acc[e] = 0.0f;
    uint32_t ah[2][4], al[2][4];
    mma_steps<2>(acc, ah, al, row_a, tid & 3, 0, xval, kmajor_desc(bhi, DS) + slice * desc_n40_step(DS),
                 kmajor_desc(bhi + NC * DS, DS) + slice * desc_n40_step(DS));
    meanwhile();
    wgmma_wait_all();
    mma_steps<2>(acc, ah, al, row_a, tid & 3, 2, xval, kmajor_desc(bhi, DS) + slice * desc_n40_step(DS),
                 kmajor_desc(bhi + NC * DS, DS) + slice * desc_n40_step(DS));
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int e = 0; e < 20; ++e) eta[e] += acc[e];
}

// Launch 1.  grid (chain groups of cpb chains, row blocks).  lse (C, N);
// partials (row blocks, C): the logp of the block's chains.  Two blocks
// share an SM (at most 128 registers a thread).
__global__ void __launch_bounds__(THREADS, 2)
categorical_lse_kernel(const int* __restrict__ y, const float* __restrict__ alpha, const float* __restrict__ pbeta1,
                       const float* __restrict__ px, int n, int d, int c, int kcls, int cpb,
                       float* __restrict__ lse, float* __restrict__ partials) {
    extern __shared__ __align__(128) unsigned char smem[];
    const LseLayout L = lse_layout_of(cpb);
    unsigned char* ring = smem + L.ring;
    float* eb = reinterpret_cast<float*>(smem + L.eb);          // (TM, EB): eta + alpha of a window, row-major
    int4* segs = reinterpret_cast<int4*>(smem + L.seg);         // chain segments of a window, by window parity
    float* mrun = reinterpret_cast<float*>(smem + L.mrun);      // (cpb, TM): running maximum of a (chain, row)
    float* srun = reinterpret_cast<float*>(smem + L.srun);      //            running sum of exp(eta - max)
    float* pick = reinterpret_cast<float*>(smem + L.pick);      //            the logit of y, then lp
    double* lpacc = reinterpret_cast<double*>(smem + L.lpacc);  // cpb: the block's logp sums
    float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);  // NC: alpha of the window's columns
    int* ys = reinterpret_cast<int*>(smem + L.ys);              // TM: y of the row tile
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int slice = tid >> 7;
    const int row_a = 16 * (warp & 3) + (lane >> 2);
    const long long c0 = (long long)blockIdx.x * cpb;
    const int nchains = (int)min((long long)cpb, c - c0);
    const int gcols = nchains * kcls;  // the group's columns (the window-relative order below)
    const long long qbeg = c0 * kcls;
    const int nwin = (gcols + NC - 1) / NC;
    const int nwin1 = (cpb * kcls + NC - 1) / NC;  // windows of a whole group in pbeta1
    const int ns = (d + DS - 1) / DS;
    const int n_tiles = (n + TM - 1) / TM;
    const int my_tiles = ((int)gridDim.y - 1 + n_tiles - (int)blockIdx.y) / (int)gridDim.y;

    // thread 0's place in the block's sequence of slices (row tile, window,
    // slice): the next to ask for
    int p_it = 0, p_w = 0, p_s = 0, p_st = 0;
    auto request_next = [&]() {
        if (p_it >= my_tiles) return;
        request_slice(ring + p_st * STAGE_BYTES, &bars[p_st], pbeta1, px, ((long long)blockIdx.x * nwin1 + p_w) * ns + p_s,
                      ((long long)blockIdx.y + (long long)p_it * gridDim.y) * ns + p_s);
        if (++p_st == LSE_STAGES) p_st = 0;
        if (++p_s == ns) {
            p_s = 0;
            if (++p_w == nwin) {
                p_w = 0;
                ++p_it;
            }
        }
    };
    if (tid == 0) {
        for (int s = 0; s < LSE_STAGES; ++s) mbar_init(&bars[s], 1);
        fence_mbar_init();
    }
    for (int q = tid; q < nchains; q += THREADS) lpacc[q] = 0.0;
    __syncthreads();  // the barriers are initialised
    if (tid == 0) {
        for (int s = 0; s < LSE_STAGES; ++s) request_next();
    }

    RingPlace at(LSE_STAGES);
    bool started = false;  // a slice has been consumed: its stage can be asked for again
    for (int it = 0; it < my_tiles; ++it) {
        const long long r0 = (long long)(blockIdx.y + it * gridDim.y) * TM;
        for (int i = tid; i < TM * nchains; i += THREADS) {
            mrun[i] = -INFINITY;
            srun[i] = 0.0f;
        }
        for (int i = tid; i < TM; i += THREADS) cp_async4(ys + i, r0 + i < n ? y + r0 + i : y, r0 + i < n ? 4 : 0);
        for (int w = 0; w < nwin; ++w) {
            const int qw = w * NC;  // the window's first column in the group
            // the window's alpha (the previous window's epilogue is done with it:
            // the barrier before its sweep) and segments (the other buffer)
            int4* seg = segs + (w & 1) * (NC + 1);
            for (int j = tid; j < NC; j += THREADS) {
                cp_async4(alpha_s + j, qw + j < gcols ? alpha + qbeg + qw + j : alpha, qw + j < gcols ? 4 : 0);
            }
            const int ca = qw / kcls;
            const int qz = min(gcols, qw + NC);
            const int nseg = (qz - 1) / kcls - ca + 1;
            for (int sg = tid; sg < nseg; sg += THREADS) {
                const int ch = ca + sg;
                seg[sg] = make_int4(max(ch * kcls, qw) - qw, min((ch + 1) * kcls, qz) - qw, ch, ch * kcls - qw);
            }
            float eta[20];
#pragma unroll
            for (int e = 0; e < 20; ++e) eta[e] = 0.0f;
            for (int s = 0; s < ns; ++s) {
                mbar_wait(&bars[at.st], at.parity);
                const float* stage = reinterpret_cast<const float*>(ring + at.st * STAGE_BYTES);
                // the stage the previous slice used (free since the barrier after it) is asked for again
                slice_product(eta, stage, stage + 2 * NC * DS, [&] {
                    if (tid == 0 && started) request_next();
                });
                started = true;
                __syncthreads();  // every thread is done with the stage (and with the previous window's sweep)
                at.next();
            }
            cp_async_wait_all();
            __syncthreads();  // alpha (and y) are in
            float a[10];  // alpha of this thread's ten columns, loaded before the stores
#pragma unroll
            for (int q = 0; q < 10; ++q) a[q] = alpha_s[40 * slice + 8 * (q >> 1) + 2 * t + (q & 1)];
#pragma unroll
            for (int e = 0; e < 20; ++e) {
                const int row = row_a + 8 * ((e >> 1) & 1);
                const int col = 40 * slice + 8 * (e >> 2) + 2 * t + (e & 1);
                eb[row * EB + col] = eta[e] + a[2 * (e >> 2) + (e & 1)];
            }
            __syncthreads();
            // the (row, chain segment) sweep
            if (kcls > 40) {
                sweep<4, NC / 4>(eb, seg, nseg, ys, kcls, mrun, srun, pick);
            } else if (kcls >= 16) {
                sweep<4, 10>(eb, seg, nseg, ys, kcls, mrun, srun, pick);
            } else if (kcls > 8) {
                sweep<1, 16>(eb, seg, nseg, ys, kcls, mrun, srun, pick);
            } else if (kcls > 4) {
                sweep<1, 8>(eb, seg, nseg, ys, kcls, mrun, srun, pick);
            } else {
                sweep<1, 4>(eb, seg, nseg, ys, kcls, mrun, srun, pick);
            }
        }
        __syncthreads();
        // lse, and lp of each (chain, row), masked past N
        for (int i = tid; i < TM * nchains; i += THREADS) {
            const int q = i / TM;
            const int r = i % TM;
            const bool ok = r0 + r < n;
            const float l = mrun[i] + logf(srun[i]);
            if (ok) lse[(c0 + q) * n + r0 + r] = l;
            pick[i] = ok ? pick[i] - l : 0.0f;
        }
        __syncthreads();
        // the tile's lp per chain, rows in order in float, into the block's sums in double
        for (int q = tid; q < nchains; q += THREADS) {
            float tile_lp = 0.0f;
            for (int r = 0; r < TM; ++r) tile_lp += pick[q * TM + r];
            lpacc[q] += (double)tile_lp;
        }
    }
    __syncthreads();
    for (int q = tid; q < nchains; q += THREADS) partials[(size_t)blockIdx.y * c + c0 + q] = (float)lpacc[q];
}

// Launch 2.  grid (column tiles, row blocks, D groups of 64*MT rows of
// [gbeta; galpha]).  partials (row blocks, C*K*(1 + D)): galpha (C, K) then
// gbeta (C, D, K).  WHOLE_X: x comes whole a row tile (product 1 reads its
// slices there), the ring carries beta alone; else the ring carries x too and
// the window holds the group's slices.  Two blocks share an SM at MT = 1 (at
// most 128 registers a thread).
template <int MT, bool WHOLE_X>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 2 : 1)
categorical_grad_kernel(const int* __restrict__ y, const float* __restrict__ alpha, const float* __restrict__ pbeta2,
                        const float* __restrict__ px, const float* __restrict__ lse, int n, int d, int c, int kcls,
                        int nch, int stages, float* __restrict__ partials) {
    constexpr int W = 64 * MT;  // rows of [gbeta; galpha] in a group
    constexpr uint32_t RING_STAGE = WHOLE_X ? BETA_SLICE_BYTES : (uint32_t)STAGE_BYTES;
    extern __shared__ __align__(128) unsigned char smem[];
    const int ns = (d + DS - 1) / DS;
    const GradLayout L = grad_layout_of(MT, nch, stages, WHOLE_X, ns);
    unsigned char* ring = smem + L.ring;
    float* thi = reinterpret_cast<float*>(smem + L.th);     // (NC x 64) K-major theta' hi
    float* tlo = thi + NC * TM;                             //                    theta' lo
    float* xw = reinterpret_cast<float*>(smem + L.xw);      // packed x slices of the row tile
    float* lse_s = reinterpret_cast<float*>(smem + L.lse);  // (nch, TM) the tile's lse
    int* ys = reinterpret_cast<int*>(smem + L.ys);
    int4* col = reinterpret_cast<int4*>(smem + L.col);          // column j: class, chain from the tile's first, valid, alpha
    long long* cb = reinterpret_cast<long long*>(smem + L.cb);  // c*D*K + k of column j (-1: none)
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // the ring's, then the window's at MAX_GRAD_STAGES
    uint64_t* wbar = bars + MAX_GRAD_STAGES;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int slice = tid >> 7;
    const int row_a = 16 * (warp & 3) + (lane >> 2);
    const long long ncols = (long long)c * kcls;
    const long long q0 = (long long)blockIdx.x * NC;
    const long long cfirst = q0 / kcls;
    const int g0 = blockIdx.z * W;
    // the window: all slices (WHOLE_X), or the group's (none: the row of ones alone)
    const int ws0 = WHOLE_X ? 0 : g0 / DS;
    const int wsl = WHOLE_X ? ns : min(2 * MT, ns - g0 / DS);
    const int n_tiles = (n + TM - 1) / TM;
    const int my_tiles = ((int)gridDim.y - 1 + n_tiles - (int)blockIdx.y) / (int)gridDim.y;

    // thread 0's place in the block's sequence of slices (row tile, slice): the next to ask for
    int p_it = 0, p_s = 0, p_st = 0;
    auto request_next = [&]() {
        if (p_it >= my_tiles) return;
        request_slice(ring + p_st * RING_STAGE, &bars[p_st], pbeta2, WHOLE_X ? nullptr : px,
                      (long long)blockIdx.x * ns + p_s, ((long long)blockIdx.y + (long long)p_it * gridDim.y) * ns + p_s);
        if (++p_st == stages) p_st = 0;
        if (++p_s == ns) {
            p_s = 0;
            ++p_it;
        }
    };
    auto request_window = [&](int it) {
        if (it >= my_tiles || wsl <= 0) return;
        const long long rt = blockIdx.y + (long long)it * gridDim.y;
        mbar_expect_bytes(wbar, wsl * X_SLICE_BYTES);  // written by these copies alone, as the ring
        bulk_copy(xw, px + (rt * ns + ws0) * (TM * XS), wsl * X_SLICE_BYTES, wbar);
    };
    for (int j = tid; j < NC; j += THREADS) {
        const long long q = q0 + j;
        const long long cc = q / kcls;
        const int k = (int)(q - cc * kcls);
        cb[j] = q < ncols ? cc * d * kcls + k : -1;
        col[j] = make_int4(k, (int)(cc - cfirst), q < ncols, __float_as_int(q < ncols ? alpha[q] : 0.0f));
    }
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
        mbar_init(wbar, 1);
        fence_mbar_init();
    }
    __syncthreads();  // the barriers are initialised, the column table written
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) request_next();
        request_window(0);
    }
    const uint64_t dth_hi = kmajor_desc(thi, TM) + slice * desc_n40_step(TM);
    const uint64_t dth_lo = kmajor_desc(tlo, TM) + slice * desc_n40_step(TM);

    float accg[MT][20];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 20; ++e) accg[m][e] = 0.0f;

    RingPlace at(stages);
    bool started = false;  // a slice has been consumed: its stage can be asked for again
    for (int it = 0; it < my_tiles; ++it) {
        const long long r0 = (long long)(blockIdx.y + it * gridDim.y) * TM;
        // the tile's lse and y: the previous tile is done with them (the barrier ending it)
        for (int i = tid; i < TM * nch; i += THREADS) {
            const int h = i / TM;
            const int r = i % TM;
            const bool ok = r0 + r < n && cfirst + h < c;
            cp_async4(lse_s + i, ok ? lse + (cfirst + h) * n + r0 + r : lse, ok ? 4 : 0);
        }
        for (int i = tid; i < TM; i += THREADS) cp_async4(ys + i, r0 + i < n ? y + r0 + i : y, r0 + i < n ? 4 : 0);
        if (WHOLE_X) mbar_wait(wbar, (uint32_t)(it & 1));

        // --- product 1: eta = x_tile @ beta_tile, a slice at a time ----------
        float eta[20];
#pragma unroll
        for (int e = 0; e < 20; ++e) eta[e] = 0.0f;
        for (int s = 0; s < ns; ++s) {
            mbar_wait(&bars[at.st], at.parity);
            const float* stage = reinterpret_cast<const float*>(ring + at.st * RING_STAGE);
            // the stage the previous slice used (free since the barrier after it) is asked for again
            slice_product(eta, stage, WHOLE_X ? xw + s * (TM * XS) : stage + 2 * NC * DS, [&] {
                if (tid == 0 && started) request_next();
            });
            started = true;
            __syncthreads();  // every thread is done with the stage
            at.next();
        }
        cp_async_wait_all();
        __syncthreads();  // the tile's lse and y are in

        // --- theta' = onehot(y) - exp(eta + alpha - lse), hi/lo, K-major -----
        // Rows past N and columns past C*K are not masked here: x is zero
        // there (and the row of ones masked in product 2), and a column past
        // C*K is never written out.  exp by ex2.approx (__expf): theta' is a
        // gradient's weight, its tolerance rtol 3e-4.
        // (every load before the stores, which the compiler cannot tell apart
        // from them: one round trip of latency, not twenty)
        const int yk0 = min(max(ys[row_a], 1), kcls) - 1;
        const int yk1 = min(max(ys[row_a + 8], 1), kcls) - 1;
        float tps[20];
#pragma unroll
        for (int e = 0; e < 20; ++e) {
            const int row = row_a + 8 * ((e >> 1) & 1);
            const int4 cj = col[40 * slice + 8 * (e >> 2) + 2 * t + (e & 1)];
            tps[e] = (cj.x == ((e >> 1) & 1 ? yk1 : yk0) ? 1.0f : 0.0f) -
                     __expf(eta[e] + __int_as_float(cj.w) - lse_s[cj.y * TM + row]);
        }
#pragma unroll
        for (int e = 0; e < 20; ++e) {
            const int row = row_a + 8 * ((e >> 1) & 1);
            const int j = 40 * slice + 8 * (e >> 2) + 2 * t + (e & 1);
            uint32_t h, l;
            split(tps[e], h, l);
            thi[kmajor_index(j, row, TM)] = __uint_as_float(h);
            tlo[kmajor_index(j, row, TM)] = __uint_as_float(l);
        }
        fence_proxy_async();  // theta' is read by wgmma next
        __syncthreads();
        if (!WHOLE_X && wsl > 0) mbar_wait(wbar, (uint32_t)(it & 1));

        // --- product 2: the group's rows of [gbeta; galpha] += [x, 1]^T @ theta'
        const float* xg = xw + (WHOLE_X ? g0 / DS : 0) * (TM * XS);  // the group's first slice
        const int rows = (int)min((long long)TM, n - r0);             // the row of ones stops at N
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            auto xtval = [xg, g0, d, rows](int dd, int r) {
                const int f = g0 + dd;
                return f < d ? xg[(dd / DS) * (TM * XS) + r * XS + dd % DS] : (f == d && r < rows ? 1.0f : 0.0f);
            };
            float acc[20];
#pragma unroll
            for (int e = 0; e < 20; ++e) acc[e] = 0.0f;
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int k0 = 0; k0 < TM / 8; k0 += 2) {
                mma_steps<2>(acc, ah, al, 64 * m + row_a, t, k0, xtval, dth_hi, dth_lo);
                wgmma_wait_all();
            }
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < 20; ++e) accg[m][e] += acc[e];
        }
        fence_proxy_async();  // theta' and the window are written again for the next tile
        __syncthreads();
        if (tid == 0) request_window(it + 1);
    }

    // --- this block's partial ------------------------------------------------
    float* part = partials + (size_t)blockIdx.y * (size_t)(ncols * (1 + d));
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 20; ++e) {
            const int dd = g0 + 64 * m + row_a + 8 * ((e >> 1) & 1);
            const int j = 40 * slice + 8 * (e >> 2) + 2 * t + (e & 1);
            const long long b = cb[j];
            if (b < 0 || dd > d) continue;
            if (dd < d) {
                part[ncols + b + (long long)dd * kcls] = accg[m][e];
            } else {
                part[q0 + j] = accg[m][e];
            }
        }
    }
}

// The instantiated (MT, WHOLE_X) of launch 2.  The wrapper's plan
// (ops/glm_fused.py) lists the same set.
#define GLM_CATEGORICAL_TILED_MT(X) X(1, true) X(2, true) X(4, true) X(7, true) X(1, false) X(2, false) X(4, false) X(7, false)

}  // namespace tiled

}  // namespace

// Chains one column tile of ncols columns holds.
extern "C" int glm_categorical_chains_per_tile(int kcls, int ncols) { return kcls < 1 ? 0 : ncols / kcls; }

// Bytes of dynamic shared memory one block needs.
extern "C" long long glm_categorical_smem_bytes(int ncols, int d, int cpt, int stages) {
    return (long long)layout_of(ncols, d, cpt, stages).total;
}

// partials: (row_blocks, c*(1 + kcls + d*kcls)); out: the same length, logp
// (c), galpha (c, kcls), gbeta (c, d, kcls).  x and y 16-byte aligned; the
// tile plan (wgs, mt, cpt, stages) from the wrapper.  Returns the CUDA error
// code of the two launches (0: both were accepted).
extern "C" int glm_categorical_launch(const void* y, const void* x, const void* alpha, const void* beta,
                                      void* partials, void* out, int n, int d, int c, int kcls,
                                      int wgs, int mt, int cpt, int stages, int row_blocks, void* stream_ptr) {
    if (kcls < 1 || cpt < 1 || cpt * kcls > 40 * wgs || (d + 1 + 63) / 64 > mt || stages < 1 || stages > 2) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const size_t smem = layout_of(40 * wgs, d, cpt, stages).total;
    const dim3 grid(row_blocks, (c + cpt - 1) / cpt);
    const int* yi = static_cast<const int*>(y);
    const float* xf = static_cast<const float*>(x);
    const float* af = static_cast<const float*>(alpha);
    const float* bf = static_cast<const float*>(beta);
    float* pf = static_cast<float*>(partials);
    cudaError_t err = cudaErrorInvalidValue;
#define GLM_CATEGORICAL_CASE(WGS_, MT_)                                                                          \
    if (wgs == WGS_ && mt == MT_) {                                                                              \
        err = allow_smem((const void*)glm_categorical_kernel<WGS_, MT_>, smem);                                  \
        if (err == cudaSuccess) {                                                                                \
            glm_categorical_kernel<WGS_, MT_><<<grid, 128 * WGS_, smem, stream>>>(yi, xf, af, bf, n, d, c, kcls, cpt, \
                                                                                 stages, pf);                    \
            err = cudaGetLastError();                                                                            \
        }                                                                                                        \
    } else
    GLM_CATEGORICAL_INSTANCES(GLM_CATEGORICAL_CASE) { return (int)cudaErrorInvalidValue; }
#undef GLM_CATEGORICAL_CASE
    if (err != cudaSuccess) return (int)err;
    const long long m = (long long)c * (1 + kcls + (long long)d * kcls);
    return (int)glm_common::reduce_partials(pf, out, row_blocks, m, stream);
}

// The tiled pair: bytes of dynamic shared memory of launch 1 (pass 1; a =
// cpb chains a block) or of launch 2 (pass 2; a = mt, b = the most chains a
// tile touches, the ring's stages, whole_x, d).
extern "C" long long glm_categorical_tiled_smem_bytes(int pass, int a, int b, int stages, int whole_x, int d) {
    return pass == 1 ? (long long)tiled::lse_layout_of(a).total
                     : (long long)tiled::grad_layout_of(a, b, stages, whole_x != 0, (d + tiled::DS - 1) / tiled::DS).total;
}

// The tiled pair for any shape: launch 0 (packs beta and x into packed:
// launch 2's beta stages, ceil(c*kcls / 80) * ceil(d / 32) * 5,120 floats,
// launch 1's, ceil(c / cpb) * ceil(cpb*kcls / 80) * ceil(d / 32) * 5,120,
// then the x stages, ceil(n / 64) * ceil(d / 32) * 2,304), launch 1 (lse (c,
// n) scratch, logp partials), launch 2 (galpha and gbeta partials), the two
// reductions into out (logp (c), galpha (c, kcls), gbeta (c, d, kcls)).
// partials: row_blocks_lse * c floats, then row_blocks * c*kcls*(1 + d).  cpb
// chains a block of launch 1 (at most 16); groups of 64*mt rows of [gbeta;
// galpha], the ring's stages (2-4) and whole_x in launch 2.  Returns the CUDA
// error code of the five launches (0: all were accepted).
extern "C" int glm_categorical_tiled_launch(const void* y, const void* x, const void* alpha, const void* beta,
                                            void* lse, void* packed, void* partials, void* out, int n, int d, int c,
                                            int kcls, int mt, int groups, int cpb, int row_blocks_lse, int row_blocks,
                                            int stages, int whole_x, void* stream_ptr) {
    using namespace tiled;
    const long long rows = (long long)d + 1;
    const long long ncols = (long long)c * kcls;
    const long long tiles = (ncols + NC - 1) / NC;
    const long long ns = (d + DS - 1) / DS;
    if (n < 1 || d < 1 || c < 1 || kcls < 1 || cpb < 1 || groups < 1 || groups > 65535 || row_blocks_lse < 1 ||
        row_blocks_lse > 65535 || row_blocks < 1 || row_blocks > 65535 || tiles > 0x7fffffffLL ||
        cpb > MAX_CPB || (long long)cpb * kcls > 0x7fffffffLL - NC || (long long)groups * 64 * mt < rows ||
        (long long)(groups - 1) * 64 * mt >= rows || stages < 2 || stages > MAX_GRAD_STAGES) {
        return (int)cudaErrorInvalidValue;
    }
    const int nch = chains_per_tile(kcls, c);
    const size_t smem1 = lse_layout_of(cpb).total;
    const size_t smem2 = grad_layout_of(mt, nch, stages, whole_x != 0, (int)ns).total;
    if (smem1 > MAX_SMEM || smem2 > MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const int* yi = static_cast<const int*>(y);
    const float* af = static_cast<const float*>(alpha);
    float* lf = static_cast<float*>(lse);
    const long long nb2 = tiles * ns * (2 * NC * DS);
    const long long nb1 = (long long)((c + cpb - 1) / cpb) * ((cpb * kcls + NC - 1) / NC) * ns * (2 * NC * DS);
    const long long nx = (long long)((n + TM - 1) / TM) * ns * (TM * XS);
    float* pbeta2 = static_cast<float*>(packed);
    float* pbeta1 = pbeta2 + nb2;
    float* px = pbeta1 + nb1;
    float* part1 = static_cast<float*>(partials);
    float* part2 = part1 + (size_t)row_blocks_lse * c;
    const long long pack_blocks = (nb2 + nb1 + nx + THREADS - 1) / THREADS;
    categorical_pack_kernel<<<(unsigned)(pack_blocks < 8192 ? pack_blocks : 8192), THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(beta), n, d, c, kcls, cpb, pbeta2, pbeta1, px);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_smem((const void*)categorical_lse_kernel, smem1);
    if (err != cudaSuccess) return (int)err;
    categorical_lse_kernel<<<dim3((c + cpb - 1) / cpb, row_blocks_lse), THREADS, smem1, stream>>>(
        yi, af, pbeta1, px, n, d, c, kcls, cpb, lf, part1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaErrorInvalidValue;
#define GLM_CATEGORICAL_TILED_CASE(MT_, WHOLE_)                                                                     \
    if (mt == MT_ && (whole_x != 0) == WHOLE_) {                                                                    \
        err = allow_smem((const void*)categorical_grad_kernel<MT_, WHOLE_>, smem2);                                   \
        if (err == cudaSuccess) {                                                                                   \
            categorical_grad_kernel<MT_, WHOLE_><<<dim3((unsigned)tiles, row_blocks, groups), THREADS, smem2, stream>>>( \
                yi, af, pbeta2, px, lf, n, d, c, kcls, nch, stages, part2);                                         \
            err = cudaGetLastError();                                                                               \
        }                                                                                                           \
    } else
    GLM_CATEGORICAL_TILED_MT(GLM_CATEGORICAL_TILED_CASE) { return (int)cudaErrorInvalidValue; }
#undef GLM_CATEGORICAL_TILED_CASE
    if (err != cudaSuccess) return (int)err;
    err = glm_common::reduce_partials(part1, out, row_blocks_lse, c, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)glm_common::reduce_partials(part2, static_cast<float*>(out) + c, row_blocks, ncols * (1 + d), stream);
}
