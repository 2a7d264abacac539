// Fixed-grid RK4 solve of the Lotka-Volterra system and its exact
// reverse-mode derivative, one thread a chain.
//
// Replaces no Pallas kernel.  It is the counterpart of the `lax.scan` of
// math_tpu/ops/ode.py:408-433 (`ode_rk4_fixed`) under
// math_tpu/models/lotka_volterra.py:70, which XLA compiles into one program;
// written as PyTorch operations it is ~40,000 launches a gradient call.
//
//   lv_rk4_forward_kernel: ys = ode_rk4_fixed(lv_rhs, z0, t0, ts, theta, S)
//     for z0 (C, 2), theta (C, 4) = (alpha, beta, gamma, delta), ts (T,), with
//     lv_rhs(t, z) = (alpha u - beta u v, -gamma v + delta u v).  The state and
//     theta stay in registers through all T*S steps; no clamping, no NaN
//     handling: inf and NaN propagate as in the plain version.
//   lv_rk4_adjoint_kernel: given gbar = dL/dys (C, T, 2), (z0bar, thetabar),
//     the exact gradient of the discrete map (what autograd through the plain
//     loop computes).  The intervals are walked in reverse: lambda += gbar[:, i];
//     the interval's S states are recomputed from its start (ys[:, i-1] or z0)
//     into a scratch buffer; the S steps are swept backwards with the RK4
//     step's adjoint.  With stage inputs s1 = y, s2 = y + h/2 k1,
//     s3 = y + h/2 k2, s4 = y + h k3 and the update y + h/6 (k1 + 2 k2 + 2 k3 + k4):
//       k4bar = k1bar = h/6 lambda, k3bar = k2bar = 2 (h/6 lambda), ybar = lambda;
//       for j = 4..1: sjbar = J_y(sj)^T kjbar, ybar += sjbar,
//         thetabar += J_theta(sj)^T kjbar, k(j-1)bar += (h or h/2) sjbar;
//       J_y = [[alpha - beta v, -beta u], [delta v, -gamma + delta u]],
//       J_theta = [[u, -u v, 0, 0], [0, 0, -v, u v]].
//
// What bounds it: the serial dependence of T*S steps a thread.  At the
// model's T = 20, S = 24 that is ~30k dependent FP32 operations a chain
// forward and a few times that backward; the FLOP/byte bound of a call at
// 512 chains (~50 MFLOP over 67 TFLOP/s, ~100 KB) is about a microsecond.
// 512 threads fill few SMs: one warp a block spreads the chains over as many
// SMs as there are warps, which is all this simple design does about it.
//
// Plain C interface, loaded with ctypes: each launcher returns the CUDA error
// code of its launch (0: accepted).  Float and double instances; the double
// one lets a check hold the kernel tightly against the float64 plain version.
// An optional `stamps` buffer (4 x u64, null when not wanted) receives chain
// 0's clock64() and %globaltimer (ns) where its serial work starts and ends,
// so a measurement can read the dependent chain's own time and cycles apart
// from the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

template <typename T>
struct Theta {
    T a, b, g, d;
};

// IEEE products and sums, one rounding each and never contracted into an
// FMA: the forward pass then does the plain version's operations (one
// PyTorch kernel per operation) in its order, and its results equal the
// plain version's in the same dtype bit for bit, inf and NaN included.
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }

// (alpha u - beta u v, -gamma v + delta u v), as lv_rhs in ops/lv_rk4.py
template <typename T>
__device__ __forceinline__ void lv_rhs(const Theta<T>& p, T u, T v, T& fu, T& fv) {
    fu = sub(mul(p.a, u), mul(mul(p.b, u), v));
    fv = add(mul(-p.g, v), mul(mul(p.d, u), v));
}

// One RK4 step of size h in place (hh = h/2, h6 = h/6), in ode_rk4_fixed's
// order: stage inputs y + hh k1, y + hh k2, y + h k3, and
// y + h6 (((k1 + 2 k2) + 2 k3) + k4).
template <typename T>
__device__ __forceinline__ void rk4_step(const Theta<T>& p, T h, T hh, T h6, T& u, T& v) {
    T k1u, k1v, k2u, k2v, k3u, k3v, k4u, k4v;
    lv_rhs(p, u, v, k1u, k1v);
    lv_rhs(p, add(u, mul(hh, k1u)), add(v, mul(hh, k1v)), k2u, k2v);
    lv_rhs(p, add(u, mul(hh, k2u)), add(v, mul(hh, k2v)), k3u, k3v);
    lv_rhs(p, add(u, mul(h, k3u)), add(v, mul(h, k3v)), k4u, k4v);
    u = add(u, mul(h6, add(add(add(k1u, mul(T(2), k2u)), mul(T(2), k3u)), k4u)));
    v = add(v, mul(h6, add(add(add(k1v, mul(T(2), k2v)), mul(T(2), k3v)), k4v)));
}

// Adjoint of one stage k = lv_rhs(s) for the cotangent kbar: adds
// J_y(s)^T kbar to ybar (returned in su, sv as well) and J_theta(s)^T kbar
// to thetabar.
template <typename T>
__device__ __forceinline__ void stage_adjoint(const Theta<T>& p, T u, T v, T kbu, T kbv, T& su, T& sv,
                                              T& ybu, T& ybv, Theta<T>& tb) {
    su = (p.a - p.b * v) * kbu + p.d * v * kbv;
    sv = -p.b * u * kbu + (-p.g + p.d * u) * kbv;
    ybu += su;
    ybv += sv;
    const T uv = u * v;
    tb.a += u * kbu;
    tb.b -= uv * kbu;
    tb.g -= v * kbv;
    tb.d += uv * kbv;
}

// stamps[at] = clock64(), stamps[2 + at] = %globaltimer; the memory clobber
// keeps the loads and stores of the work on their side of the stamp.
__device__ __forceinline__ void stamp(unsigned long long* stamps, int at) {
    unsigned long long clk, ns;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk)::"memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns)::"memory");
    stamps[at] = clk;
    stamps[2 + at] = ns;
}

template <typename T>
__device__ __forceinline__ Theta<T> load_theta(const T* theta, int i) {
    return Theta<T>{theta[4 * i], theta[4 * i + 1], theta[4 * i + 2], theta[4 * i + 3]};
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lv_rk4_forward_kernel(
    const T* __restrict__ z0, const T* __restrict__ theta, const T* __restrict__ ts, T t0,
    int c, int nt, int steps, T* __restrict__ ys, unsigned long long* __restrict__ stamps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c) return;
    const bool stamped = stamps != nullptr && i == 0;
    const Theta<T> p = load_theta(theta, i);
    T u = z0[2 * i], v = z0[2 * i + 1];
    if (stamped) stamp(stamps, 0);
    T t = t0;
    T* out = ys + (size_t)i * nt * 2;
    for (int k = 0; k < nt; ++k) {
        const T tn = ts[k];
        const T h = (tn - t) / T(steps);
        const T hh = T(0.5) * h, h6 = h / T(6);
        for (int s = 0; s < steps; ++s) rk4_step(p, h, hh, h6, u, v);
        out[2 * k] = u;
        out[2 * k + 1] = v;
        t = tn;
    }
    if (stamped) stamp(stamps, 1);
}

// states: (steps, c, 2) scratch for one interval's recomputed states.
template <typename T>
__global__ void __launch_bounds__(THREADS) lv_rk4_adjoint_kernel(
    const T* __restrict__ z0, const T* __restrict__ theta, const T* __restrict__ ts, T t0,
    int c, int nt, int steps, const T* __restrict__ ys, const T* __restrict__ gbar,
    T* __restrict__ states, T* __restrict__ z0bar, T* __restrict__ thetabar, unsigned long long* __restrict__ stamps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c) return;
    const bool stamped = stamps != nullptr && i == 0;
    const Theta<T> p = load_theta(theta, i);
    if (stamped) stamp(stamps, 0);
    const T* yi = ys + (size_t)i * nt * 2;
    const T* gi = gbar + (size_t)i * nt * 2;
    T lu = T(0), lv = T(0);
    Theta<T> tb{T(0), T(0), T(0), T(0)};
    for (int k = nt - 1; k >= 0; --k) {
        lu += gi[2 * k];
        lv += gi[2 * k + 1];
        T u = k == 0 ? z0[2 * i] : yi[2 * (k - 1)];
        T v = k == 0 ? z0[2 * i + 1] : yi[2 * (k - 1) + 1];
        const T tstart = k == 0 ? t0 : ts[k - 1];
        const T h = (ts[k] - tstart) / T(steps);
        const T hh = T(0.5) * h, h6 = h / T(6);
        for (int s = 0; s < steps; ++s) {
            T* st = states + ((size_t)s * c + i) * 2;
            st[0] = u;
            st[1] = v;
            rk4_step(p, h, hh, h6, u, v);
        }
        for (int s = steps - 1; s >= 0; --s) {
            const T* st = states + ((size_t)s * c + i) * 2;
            const T s1u = st[0], s1v = st[1];
            T k1u, k1v, k2u, k2v, k3u, k3v;
            lv_rhs(p, s1u, s1v, k1u, k1v);
            const T s2u = add(s1u, mul(hh, k1u)), s2v = add(s1v, mul(hh, k1v));
            lv_rhs(p, s2u, s2v, k2u, k2v);
            const T s3u = add(s1u, mul(hh, k2u)), s3v = add(s1v, mul(hh, k2v));
            lv_rhs(p, s3u, s3v, k3u, k3v);
            const T s4u = add(s1u, mul(h, k3u)), s4v = add(s1v, mul(h, k3v));
            const T k14u = h6 * lu, k14v = h6 * lv;  // cotangent of k1 and of k4
            T k3bu = T(2) * k14u, k3bv = T(2) * k14v;
            T k2bu = k3bu, k2bv = k3bv;
            T k1bu = k14u, k1bv = k14v;
            T ybu = lu, ybv = lv, su, sv;
            stage_adjoint(p, s4u, s4v, k14u, k14v, su, sv, ybu, ybv, tb);
            k3bu += h * su;
            k3bv += h * sv;
            stage_adjoint(p, s3u, s3v, k3bu, k3bv, su, sv, ybu, ybv, tb);
            k2bu += hh * su;
            k2bv += hh * sv;
            stage_adjoint(p, s2u, s2v, k2bu, k2bv, su, sv, ybu, ybv, tb);
            k1bu += hh * su;
            k1bv += hh * sv;
            stage_adjoint(p, s1u, s1v, k1bu, k1bv, su, sv, ybu, ybv, tb);
            lu = ybu;
            lv = ybv;
        }
    }
    z0bar[2 * i] = lu;
    z0bar[2 * i + 1] = lv;
    thetabar[4 * i] = tb.a;
    thetabar[4 * i + 1] = tb.b;
    thetabar[4 * i + 2] = tb.g;
    thetabar[4 * i + 3] = tb.d;
    if (stamped) stamp(stamps, 1);
}

inline int blocks_for(int c) { return (c + THREADS - 1) / THREADS; }

template <typename T>
int forward_launch(const void* z0, const void* theta, const void* ts, double t0, int c, int nt, int steps,
                   void* ys, void* stamps, void* stream_ptr) {
    lv_rk4_forward_kernel<T><<<blocks_for(c), THREADS, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const T*>(z0), static_cast<const T*>(theta), static_cast<const T*>(ts), T(t0), c, nt, steps,
        static_cast<T*>(ys), static_cast<unsigned long long*>(stamps));
    return (int)cudaGetLastError();
}

template <typename T>
int adjoint_launch(const void* z0, const void* theta, const void* ts, double t0, int c, int nt, int steps,
                   const void* ys, const void* gbar, void* states, void* z0bar, void* thetabar, void* stamps,
                   void* stream_ptr) {
    lv_rk4_adjoint_kernel<T><<<blocks_for(c), THREADS, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const T*>(z0), static_cast<const T*>(theta), static_cast<const T*>(ts), T(t0), c, nt, steps,
        static_cast<const T*>(ys), static_cast<const T*>(gbar), static_cast<T*>(states), static_cast<T*>(z0bar),
        static_cast<T*>(thetabar), static_cast<unsigned long long*>(stamps));
    return (int)cudaGetLastError();
}

}  // namespace

// z0 (c, 2), theta (c, 4), ts (nt,), ys (c, nt, 2): contiguous, of the
// instance's type; t0 is the start time in that type's precision; stamps
// (4,) u64 or null.
extern "C" int lv_rk4_forward_f32(const void* z0, const void* theta, const void* ts, double t0, int c, int nt,
                                  int steps, void* ys, void* stamps, void* stream_ptr) {
    return forward_launch<float>(z0, theta, ts, t0, c, nt, steps, ys, stamps, stream_ptr);
}

extern "C" int lv_rk4_forward_f64(const void* z0, const void* theta, const void* ts, double t0, int c, int nt,
                                  int steps, void* ys, void* stamps, void* stream_ptr) {
    return forward_launch<double>(z0, theta, ts, t0, c, nt, steps, ys, stamps, stream_ptr);
}

// As above, with gbar (c, nt, 2), the scratch states (steps, c, 2), and the
// outputs z0bar (c, 2), thetabar (c, 4).
extern "C" int lv_rk4_adjoint_f32(const void* z0, const void* theta, const void* ts, double t0, int c, int nt,
                                  int steps, const void* ys, const void* gbar, void* states, void* z0bar,
                                  void* thetabar, void* stamps, void* stream_ptr) {
    return adjoint_launch<float>(z0, theta, ts, t0, c, nt, steps, ys, gbar, states, z0bar, thetabar, stamps,
                               stream_ptr);
}

extern "C" int lv_rk4_adjoint_f64(const void* z0, const void* theta, const void* ts, double t0, int c, int nt,
                                  int steps, const void* ys, const void* gbar, void* states, void* z0bar,
                                  void* thetabar, void* stamps, void* stream_ptr) {
    return adjoint_launch<double>(z0, theta, ts, t0, c, nt, steps, ys, gbar, states, z0bar, thetabar, stamps,
                               stream_ptr);
}
