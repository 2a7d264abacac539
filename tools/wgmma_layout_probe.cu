// Checks the pieces of math_tpu_torch/csrc/tf32x3.cuh on the GPU and prints one
// line per check (built and run by tools/phase_clocks.py):
//  * layout: wgmma.m64n40k8 with A from registers and a K-major B without
//    swizzle, on small integers (exact in TF32), against a double product;
//    the variants with the descriptor's two byte offsets swapped and with A's
//    middle fragment registers swapped must be wrong, so the check can fail;
//  * accuracy: random operands in [-1, 1), K = 64, one TF32 product and the
//    three of the split against double, beside a float32 FMA loop;
//  * bulk copy: a 1-D cp.async.bulk of one 64 x 50 float tile with an mbarrier;
//  * transposed: the two products of glm_fused.cu's tensor-core kernels on
//    small integers (exact), two warpgroups splitting the rows: m64n32k8 with
//    A from shared memory (D1 = A1 B1^T, both K-major), then m64n64k8 with A
//    from the registers of D1 through the
//    fragment map {d[4j], d[4j+2], d[4j+1], d[4j+3]} and B's rows in
//    k8_position order (D2 = D1 M); variants with B's rows in plain order,
//    with the fragments in accumulator order, and with A's descriptor offsets
//    swapped must be wrong.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../math_tpu_torch/csrc/tf32x3.cuh"

using namespace tf32x3;

constexpr int KP = 64;
constexpr int NB = 40;

__device__ uint64_t desc_offsets_swapped(const float* p, int kp) {
    const uint64_t addr = smem_u32(p);
    return ((addr & 0x3FFFFu) >> 4) | ((uint64_t)((kp * 32) >> 4) << 16) | ((uint64_t)(128u >> 4) << 32);
}

// D (64 x NB) = A (64 x KP) B (KP x NB), both row-major in global memory.
__global__ void product_kernel(const float* A, const float* B, float* D, int desc_swap, int afrag_swap, int three) {
    extern __shared__ float sm[];
    float* bhi = sm;
    float* blo = sm + NB * KP;
    const int tid = threadIdx.x;
    for (int i = tid; i < NB * KP; i += 128) {
        const int n = i % NB, k = i / NB;
        uint32_t h, l;
        split(B[k * NB + n], h, l);
        if (!three) { h = __float_as_uint(B[k * NB + n]); l = 0; }
        bhi[kmajor_index(n, k, KP)] = __uint_as_float(h);
        blo[kmajor_index(n, k, KP)] = __uint_as_float(l);
    }
    fence_proxy_async();
    __syncthreads();
    const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    float d[20];
    for (int i = 0; i < 20; ++i) d[i] = 0.0f;
    for (int s = 0; s < KP / 8; ++s) {
        float av[4] = {A[(16 * w + g) * KP + 8 * s + t], A[(16 * w + g + 8) * KP + 8 * s + t],
                       A[(16 * w + g) * KP + 8 * s + t + 4], A[(16 * w + g + 8) * KP + 8 * s + t + 4]};
        if (afrag_swap) { const float x = av[1]; av[1] = av[2]; av[2] = x; }
        uint32_t ahi[4], alo[4];
        for (int i = 0; i < 4; ++i) {
            split(av[i], ahi[i], alo[i]);
            if (!three) { ahi[i] = __float_as_uint(av[i]); alo[i] = 0; }
        }
        const uint64_t dh = (desc_swap ? desc_offsets_swapped(bhi, KP) : kmajor_desc(bhi, KP)) + s * desc_k8_step();
        const uint64_t dl = (desc_swap ? desc_offsets_swapped(blo, KP) : kmajor_desc(blo, KP)) + s * desc_k8_step();
        wgmma_fence();
        fence_regs(d);
        if (three) {
            mma3_n40k8(d, ahi, alo, dh, dl);
        } else {
            mma_n40k8(d, ahi, dh);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(d);
    }
    for (int j = 0; j < 5; ++j) {
        D[(16 * w + g) * NB + 8 * j + 2 * t] = d[4 * j];
        D[(16 * w + g) * NB + 8 * j + 2 * t + 1] = d[4 * j + 1];
        D[(16 * w + g + 8) * NB + 8 * j + 2 * t] = d[4 * j + 2];
        D[(16 * w + g + 8) * NB + 8 * j + 2 * t + 1] = d[4 * j + 3];
    }
}

__global__ void bulk_kernel(const float* src, float* dst, int nfl) {
    extern __shared__ float sm[];
    __shared__ __align__(8) uint64_t bar;
    if (threadIdx.x == 0) {
        mbar_init(&bar, 1);
        fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_bytes(&bar, nfl * 4);
        bulk_copy(sm, src, nfl * 4, &bar);
    }
    mbar_wait(&bar, 0);
    for (int i = threadIdx.x; i < nfl; i += blockDim.x) dst[i] = sm[i];
}

// D1 (64 x 64) = A1 (64 x KT) B1^T (B1: 64 x KT), then D2 (64 x 64) = D1 M (M: 64 x 64), all row-major in
// global memory, as glm_fused.cu's tensor-core kernels take them: 3xTF32, two warpgroups, warpgroup h
// taking columns 32h .. 32h+31 of D1 (m64n32k8, A1 and B1 by descriptor) and the same 32 rows of M's K
// (m64n64k8, D1 as A from registers, k8 steps 4h .. 4h+3); the halves of D2 added in shared memory.
// variant: 0 as the kernels, 1 M's rows in plain order, 2 the fragments in accumulator order, 3 A1's
// descriptor offsets swapped.
constexpr int KT = 16;
__global__ void transposed_kernel(const float* A1, const float* B1, const float* M, float* D1, float* D2, int variant) {
    extern __shared__ float sm[];
    float* ahi = sm;                // 64 x KT K-major
    float* alo = ahi + 64 * KT;
    float* bhi = alo + 64 * KT;     // 64 x KT K-major
    float* blo = bhi + 64 * KT;
    float* mhi = blo + 64 * KT;     // 64 (N) x 64 (positions) K-major
    float* mlo = mhi + 64 * 64;
    float* half1 = mlo + 64 * 64;   // warpgroup 1's part of D2
    const int tid = threadIdx.x;
    for (int i = tid; i < 64 * KT; i += 256) {
        const int m = i / KT, k = i % KT;
        uint32_t h, l;
        split(A1[i], h, l);
        ahi[kmajor_index(m, k, KT)] = __uint_as_float(h);
        alo[kmajor_index(m, k, KT)] = __uint_as_float(l);
        split(B1[i], h, l);
        bhi[kmajor_index(m, k, KT)] = __uint_as_float(h);
        blo[kmajor_index(m, k, KT)] = __uint_as_float(l);
    }
    for (int i = tid; i < 64 * 64; i += 256) {
        const int r = i / 64, n = i % 64;  // M[r][n]: row r of the second product's K
        uint32_t h, l;
        split(M[i], h, l);
        const int pos = variant == 1 ? r : k8_position(r);
        mhi[kmajor_index(n, pos, 64)] = __uint_as_float(h);
        mlo[kmajor_index(n, pos, 64)] = __uint_as_float(l);
    }
    fence_proxy_async();
    __syncthreads();
    const int hf = tid >> 7, w = (tid >> 5) & 3, g = (tid % 32) / 4, t = tid % 4;
    const uint64_t da_hi = (variant == 3 ? desc_offsets_swapped(ahi, KT) : kmajor_desc(ahi, KT));
    const uint64_t da_lo = (variant == 3 ? desc_offsets_swapped(alo, KT) : kmajor_desc(alo, KT));
    const uint64_t db_hi = kmajor_desc(bhi + 32 * hf * KT, KT), db_lo = kmajor_desc(blo + 32 * hf * KT, KT);
    float d[16];
    for (int i = 0; i < 16; ++i) d[i] = 0.0f;
    fence_regs(d);
    wgmma_fence();
    for (int s = 0; s < KT / 8; ++s) {
        const uint64_t o = s * desc_k8_step();
        mma_n32k8_ss(d, da_lo + o, db_hi + o);
        mma_n32k8_ss(d, da_hi + o, db_lo + o);
        mma_n32k8_ss(d, da_hi + o, db_hi + o);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    for (int j = 0; j < 4; ++j) {
        D1[(16 * w + g) * 64 + 32 * hf + 8 * j + 2 * t] = d[4 * j];
        D1[(16 * w + g) * 64 + 32 * hf + 8 * j + 2 * t + 1] = d[4 * j + 1];
        D1[(16 * w + g + 8) * 64 + 32 * hf + 8 * j + 2 * t] = d[4 * j + 2];
        D1[(16 * w + g + 8) * 64 + 32 * hf + 8 * j + 2 * t + 1] = d[4 * j + 3];
    }
    uint32_t lo[16];
    for (int i = 0; i < 16; ++i) {
        uint32_t h;
        split(d[i], h, lo[i]);
        d[i] = __uint_as_float(h);
    }
    float e[32];
    for (int i = 0; i < 32; ++i) e[i] = 0.0f;
    fence_regs(e);
    wgmma_fence();
    const uint64_t dm_hi = kmajor_desc(mhi, 64) + 4 * hf * desc_k8_step();
    const uint64_t dm_lo = kmajor_desc(mlo, 64) + 4 * hf * desc_k8_step();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int i1 = variant == 2 ? 1 : 2, i2 = variant == 2 ? 2 : 1;
        const uint32_t ah[4] = {__float_as_uint(d[4 * j]), __float_as_uint(d[4 * j + i1]), __float_as_uint(d[4 * j + i2]),
                                __float_as_uint(d[4 * j + 3])};
        const uint32_t al[4] = {lo[4 * j], lo[4 * j + i1], lo[4 * j + i2], lo[4 * j + 3]};
        const uint64_t o = j * desc_k8_step();
        mma_n64k8_rs(e, al, dm_hi + o);
        mma_n64k8_rs(e, ah, dm_lo + o);
        mma_n64k8_rs(e, ah, dm_hi + o);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(e);
    fence_regs(d);
    if (hf == 1) {
        for (int i = 0; i < 32; ++i) half1[(tid - 128) * 32 + i] = e[i];
    }
    __syncthreads();
    if (hf == 0) {
        for (int i = 0; i < 32; ++i) e[i] += half1[tid * 32 + i];
        for (int j = 0; j < 8; ++j) {
            D2[(16 * w + g) * 64 + 8 * j + 2 * t] = e[4 * j];
            D2[(16 * w + g) * 64 + 8 * j + 2 * t + 1] = e[4 * j + 1];
            D2[(16 * w + g + 8) * 64 + 8 * j + 2 * t] = e[4 * j + 2];
            D2[(16 * w + g + 8) * 64 + 8 * j + 2 * t + 1] = e[4 * j + 3];
        }
    }
}

static void transposed_checks() {
    std::vector<float> A1(64 * KT), B1(64 * KT), M(64 * 64), D1(64 * 64), D2(64 * 64);
    for (int m = 0; m < 64; ++m)
        for (int k = 0; k < KT; ++k) {
            A1[m * KT + k] = (float)((m * 3 + k * 5) % 7 - 3);
            B1[m * KT + k] = (float)((m * 7 + k * 2) % 5 - 2);
        }
    for (int r = 0; r < 64; ++r)
        for (int n = 0; n < 64; ++n) M[r * 64 + n] = (float)((r * 5 + n * 3) % 9 - 4);
    std::vector<double> W1(64 * 64), W2(64 * 64);
    for (int m = 0; m < 64; ++m)
        for (int n = 0; n < 64; ++n) {
            double s = 0.0;
            for (int k = 0; k < KT; ++k) s += (double)A1[m * KT + k] * B1[n * KT + k];
            W1[m * 64 + n] = s;
        }
    for (int m = 0; m < 64; ++m)
        for (int n = 0; n < 64; ++n) {
            double s = 0.0;
            for (int r = 0; r < 64; ++r) s += W1[m * 64 + r] * M[r * 64 + n];
            W2[m * 64 + n] = s;
        }
    float *dA, *dB, *dM, *dD1, *dD2;
    cudaMalloc(&dA, A1.size() * 4);
    cudaMalloc(&dB, B1.size() * 4);
    cudaMalloc(&dM, M.size() * 4);
    cudaMalloc(&dD1, D1.size() * 4);
    cudaMalloc(&dD2, D2.size() * 4);
    cudaMemcpy(dA, A1.data(), A1.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B1.data(), B1.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dM, M.data(), M.size() * 4, cudaMemcpyHostToDevice);
    const size_t smem = (4 * 64 * KT + 2 * 64 * 64 + 128 * 32) * 4;
    cudaFuncSetAttribute(transposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const char* names[4] = {"as_in_glm_fused", "rows_in_plain_order", "fragments_in_accumulator_order",
                            "a_desc_offsets_swapped"};
    for (int v = 0; v < 4; ++v) {
        transposed_kernel<<<1, 256, smem>>>(dA, dB, dM, dD1, dD2, v);
        const cudaError_t e = cudaDeviceSynchronize();
        cudaMemcpy(D1.data(), dD1, D1.size() * 4, cudaMemcpyDeviceToHost);
        cudaMemcpy(D2.data(), dD2, D2.size() * 4, cudaMemcpyDeviceToHost);
        double e1 = 0.0, e2 = 0.0, w2 = 0.0;
        for (int i = 0; i < 64 * 64; ++i) {
            e1 = fmax(e1, fabs(D1[i] - W1[i]));
            e2 = fmax(e2, fabs(D2[i] - W2[i]));
            w2 = fmax(w2, fabs(W2[i]));
        }
        printf("{\"check\": \"transposed\", \"variant\": \"%s\", \"product1_a_from_smem_max_abs_err\": %g, "
               "\"product2_a_from_accumulator_max_abs_err\": %g, \"max_abs_want\": %g, \"cuda\": \"%s\"}\n",
               names[v], e1, e2, w2, cudaGetErrorString(e));
    }
}

static double max_err(const std::vector<float>& A, const std::vector<float>& B, const std::vector<float>& D, bool fma32,
                      double* max_want) {
    double err = 0.0;
    *max_want = 0.0;
    for (int m = 0; m < 64; ++m) {
        for (int n = 0; n < NB; ++n) {
            double s = 0.0;
            float sf = 0.0f;
            for (int k = 0; k < KP; ++k) {
                s += (double)A[m * KP + k] * B[k * NB + n];
                sf = fmaf(A[m * KP + k], B[k * NB + n], sf);
            }
            err = fmax(err, fabs(s - (fma32 ? sf : D[m * NB + n])));
            *max_want = fmax(*max_want, fabs(s));
        }
    }
    return err;
}

int main() {
    std::vector<float> A(64 * KP), B(KP * NB), D(64 * NB);
    float *dA, *dB, *dD;
    cudaMalloc(&dA, A.size() * 4);
    cudaMalloc(&dB, B.size() * 4);
    cudaMalloc(&dD, D.size() * 4);
    const size_t smem = 2 * NB * KP * 4;
    cudaFuncSetAttribute(product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    double want;
    for (int m = 0; m < 64; ++m)
        for (int k = 0; k < KP; ++k) A[m * KP + k] = (float)((m * 3 + k * 5) % 7 - 3);
    for (int k = 0; k < KP; ++k)
        for (int n = 0; n < NB; ++n) B[k * NB + n] = (float)((k * 11 + n * 2) % 5 - 2);
    cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
    for (int v = 0; v < 3; ++v) {
        product_kernel<<<1, 128, smem>>>(dA, dB, dD, v == 1, v == 2, 1);
        const cudaError_t e = cudaDeviceSynchronize();
        cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
        printf("{\"check\": \"layout\", \"variant\": \"%s\", \"max_abs_err\": %g, \"cuda\": \"%s\"}\n",
               v == 0 ? "as_in_tf32x3" : (v == 1 ? "desc_offsets_swapped" : "a_fragment_swapped"),
               max_err(A, B, D, false, &want), cudaGetErrorString(e));
    }
    srand(1);
    for (auto& a : A) a = (float)rand() / RAND_MAX * 2 - 1;
    for (auto& b : B) b = (float)rand() / RAND_MAX * 2 - 1;
    cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
    for (int three = 0; three < 2; ++three) {
        product_kernel<<<1, 128, smem>>>(dA, dB, dD, 0, 0, three);
        const cudaError_t e = cudaDeviceSynchronize();
        cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
        const double err = max_err(A, B, D, false, &want);
        printf("{\"check\": \"accuracy\", \"products\": \"%s\", \"max_abs_err\": %g, \"float32_fma_max_abs_err\": %g, "
               "\"max_abs_want\": %g, \"cuda\": \"%s\"}\n",
               three ? "3xTF32" : "1xTF32", err, max_err(A, B, D, true, &want), want, cudaGetErrorString(e));
    }
    const int nfl = 64 * 50;
    std::vector<float> S(nfl), T(nfl);
    for (int i = 0; i < nfl; ++i) S[i] = i * 0.5f;
    float *dS, *dT;
    cudaMalloc(&dS, nfl * 4);
    cudaMalloc(&dT, nfl * 4);
    cudaMemcpy(dS, S.data(), nfl * 4, cudaMemcpyHostToDevice);
    bulk_kernel<<<1, 128, nfl * 4>>>(dS, dT, nfl);
    const cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(T.data(), dT, nfl * 4, cudaMemcpyDeviceToHost);
    int bad = 0;
    for (int i = 0; i < nfl; ++i) bad += T[i] != S[i];
    printf("{\"check\": \"bulk_copy\", \"wrong_floats\": %d, \"cuda\": \"%s\"}\n", bad, cudaGetErrorString(e));
    transposed_checks();
    return 0;
}
