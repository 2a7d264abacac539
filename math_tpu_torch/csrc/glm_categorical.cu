// Categorical-logit GLM log-prob + parameter gradients for a batch of chains,
// with both products on Hopper's tensor cores in 3xTF32.
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
using glm_common::request_row_tile;

constexpr int TM = 64;        // rows per tile

struct Layout {
    size_t beta_hi, beta_lo, th_hi, th_lo, xs, ys, alpha, lps, lpacc, bars, total;
};

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~(size_t)127; }

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
        err = cudaFuncSetAttribute(glm_categorical_kernel<WGS_, MT_>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                   (int)smem);                                                                   \
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
