// Checks the pieces of math_tpu_torch/csrc/tf32x3.cuh on the GPU and prints one
// line per check (built and run by tools/phase_clocks.py):
//  * layout: wgmma.m64n40k8 with A from registers and a K-major B without
//    swizzle, on small integers (exact in TF32), against a double product;
//    the variants with the descriptor's two byte offsets swapped and with A's
//    middle fragment registers swapped must be wrong, so the check can fail;
//  * accuracy: random operands in [-1, 1), K = 64, one TF32 product and the
//    three of the split against double, beside a float32 FMA loop;
//  * bulk copy: a 1-D cp.async.bulk of one 64 x 50 float tile with an mbarrier.
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
    return 0;
}
