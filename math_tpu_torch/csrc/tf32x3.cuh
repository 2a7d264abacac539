// Float32-accurate products on Hopper's tensor cores: the 3xTF32 split, the
// wgmma wrappers (m64n40k8 with A from registers; m64n64k8 and m64n128k8 with
// A from registers or from shared memory; m64n32k8 with A from shared memory), the
// shared-memory layout and descriptor of a K-major operand, and the mbarrier
// / bulk-copy pieces that stage a tile.  Shared by the GLM kernels of this
// directory; sm_90a only.
//
// The split.  a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), both
// rounded to nearest (cvt.rna).  Then a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// the small terms first, accumulated in float32 by the tensor core.  The
// dropped lo*lo term and the rounding of lo are about 2^-22 of |a*b|: float32
// accuracy from TF32 units (one TF32 product alone keeps some 3 digits).
//
// Layouts (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"):
//  * wgmma.m64nNk8.f32.tf32.tf32 with A in registers: warp w of the
//    warpgroup holds rows 16w .. 16w+15.  Lane l, g = l / 4, t = l % 4:
//    a[0] = A[16w+g][t], a[1] = A[16w+g+8][t], a[2] = A[16w+g][t+4],
//    a[3] = A[16w+g+8][t+4].
//  * The float32 accumulator of an n40 slice: d[4j+0] = D[16w+g][8j+2t],
//    d[4j+1] = D[16w+g][8j+2t+1], d[4j+2] = D[16w+g+8][8j+2t],
//    d[4j+3] = D[16w+g+8][8j+2t+1], j = 0..4.
//  * B (N x K, K contiguous: 32-bit types have no transposed form) in the
//    layout without swizzle: 8 x 4 "core matrices" of 128 contiguous bytes,
//    the K-direction core matrices of one 8-row group next to each other
//    (leading byte offset 128), the 8-row groups kp*32 bytes apart (stride
//    byte offset), where kp is the padded K extent of the tile.  An A read
//    from shared memory (M x K, K contiguous) takes the same layout and
//    descriptor, its 8-row groups along M.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round to nearest, ties away from zero, to TF32: the float's low 13 bits are 0.
__device__ __forceinline__ uint32_t to_tf32(float a) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
    return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(a);
    lo = to_tf32(a - __uint_as_float(hi));
}

// Offset, in floats, of element (n, k) of a K-major tile whose K extent is kp
// (a multiple of 8).
__device__ __forceinline__ int kmajor_index(int n, int k, int kp) {
    return (n >> 3) * (8 * kp) + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// wgmma descriptor of a K-major tile without swizzle, starting at p.
__device__ __forceinline__ uint64_t kmajor_desc(const float* p, int kp) {
    const uint64_t addr = smem_u32(p);
    const uint64_t lbo = 128u >> 4;
    const uint64_t sbo = (uint64_t)(kp * 32) >> 4;
    return ((addr & 0x3FFFFu) >> 4) | (lbo << 16) | (sbo << 32);
}

// Descriptor steps (16-byte units) between consecutive k8 steps (two core
// matrices) and consecutive n40 slices (five 8-row groups) of a K-major tile.
__device__ __forceinline__ uint64_t desc_k8_step() { return 256u >> 4; }
__device__ __forceinline__ uint64_t desc_n40_step(int kp) { return (uint64_t)(5 * kp * 32) >> 4; }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 40) += A (64 x 8, registers) * B (8 x 40, descriptor), TF32 in, float32 out.
__device__ __forceinline__ void mma_n40k8(float (&d)[20], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
          "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The three TF32 products of one k8 step on one n40 slice, small terms first.
__device__ __forceinline__ void mma3_n40k8(float (&d)[20], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           uint64_t desc_b_hi, uint64_t desc_b_lo) {
    mma_n40k8(d, a_lo, desc_b_hi);
    mma_n40k8(d, a_hi, desc_b_lo);
    mma_n40k8(d, a_hi, desc_b_hi);
}

// --- m64n64k8, m64n32k8: the transposed GLM products of glm_fused.cu -------

#define TF32X3_D32                                                                                                 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),   \
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),    \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TF32X3_D32_LIST                                                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "   \
    "%23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (64 x 64) += A (64 x 8, registers) * B (8 x 64, descriptor).  The
// accumulator: d[4j+0] = D[16w+g][8j+2t], d[4j+1] = D[16w+g][8j+2t+1],
// d[4j+2] = D[16w+g+8][8j+2t], d[4j+3] = D[16w+g+8][8j+2t+1], j = 0..7.
__device__ __forceinline__ void mma_n64k8_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32X3_D32_LIST
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : TF32X3_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64) += A (64 x 8, descriptor of a K-major tile) * B (8 x 64, descriptor).
__device__ __forceinline__ void mma_n64k8_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32X3_D32_LIST
        "%32, %33, p, 1, 1;\n"
        "}\n"
        : TF32X3_D32
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 32) += A (64 x 8, descriptor of a K-major tile) * B (8 x 32,
// descriptor); the accumulator as above, j = 0..3.
__device__ __forceinline__ void mma_n32k8_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
          "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef TF32X3_D32
#undef TF32X3_D32_LIST

// --- m64n128k8: the tiled route of glm_fused.cu --------------------------

#define TF32X3_D64                                                                                                 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TF32X3_D64_LIST \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128) += A (64 x 8, descriptor of a K-major tile) * B (8 x 128,
// descriptor).  The accumulator as m64n64k8's, j = 0..15.
__device__ __forceinline__ void mma_n128k8_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF32X3_D64_LIST
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : TF32X3_D64
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 8, registers) * B (8 x 128, descriptor).
__device__ __forceinline__ void mma_n128k8_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF32X3_D64_LIST
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : TF32X3_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef TF32X3_D64
#undef TF32X3_D64_LIST

// Position, in its group of 8, at which a K-major B holds row r of a product
// whose A is the accumulator of an earlier m64nNk8 product (its columns now
// the K of the second): the accumulator register d[4j+0] (column 8j+2t) is
// the A fragment's a[0] (column 8j+t), d[4j+1] (column 8j+2t+1) is a[2]
// (column 8j+t+4), and likewise d[4j+2] -> a[1], d[4j+3] -> a[3].  So row 2t
// of each group of 8 sits at position t and row 2t+1 at position t+4.
__device__ __forceinline__ int k8_position(int r) { return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2); }

// --- staging: mbarrier and 1-D bulk copy ------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma operand reads, bulk copies) and the other way round.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// One thread, once per phase of bar: the bytes the phase's copies will bring.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Copies bytes global -> shared and reports them to bar.  dst and src 16-byte
// aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// One arrival on bar (its count was given at mbar_init).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}

}  // namespace tf32x3
