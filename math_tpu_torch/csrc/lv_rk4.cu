// Fixed-grid RK4 solve of the Lotka-Volterra system, its exact reverse-mode
// derivative, and both again in dual numbers (primal, tangent) for forward
// mode and second orders; the forwards one thread a chain, the adjoints a
// warp a chain.
//
// Replaces no Pallas kernel.  It is the counterpart of the `lax.scan` of
// math_tpu/ops/ode.py:408-433 (`ode_rk4_fixed`) under
// math_tpu/models/lotka_volterra.py:70, which XLA compiles into one program
// and differentiates to any order; written as PyTorch operations it is
// ~40,000 launches a gradient call.
//
//   lv_rk4_forward_kernel<R>: ys = ode_rk4_fixed(lv_rhs, z0, t0, ts, theta, S)
//     for z0 (C, 2), theta (C, 4) = (alpha, beta, gamma, delta), with
//     lv_rhs(t, z) = (alpha u - beta u v, -gamma v + delta u v) and the step
//     sizes (h, h/2, h/6) of each of the T intervals as the plain version
//     computes them on the host.  The state and theta stay in registers
//     through all T*S steps; no clamping, no NaN handling: inf and NaN
//     propagate as in the plain version.  Where the caller asks, it also
//     stores the state at the start of every step, `states` (T*S, C) of
//     (u, v): 1.97 MB at C = 512, T = 20, S = 24 in float32 (1.15 MB at the
//     300 lanes of a Laplace fit's draws; 3.9 MB in float64).  The stores
//     are issued beside the chain and never wait.
//   lv_rk4_adjoint_kernel<R>: given `states` and gbar = dL/dys (C, T, 2),
//     (z0bar, thetabar), the exact gradient of the discrete map (what autograd
//     through the plain loop computes), a warp a chain.  Walked in reverse,
//     lambda += gbar[:, k] where interval k ends; with stage inputs s1 = y,
//     s2 = y + h/2 k1, s3 = y + h/2 k2, s4 = y + h k3 and the update
//     y + h/6 (k1 + 2 k2 + 2 k3 + k4), a step's adjoint is
//       k4bar = k1bar = h/6 lambda, k3bar = k2bar = 2 (h/6 lambda), ybar = lambda;
//       for j = 4..1: sjbar = J_y(sj)^T kjbar, ybar += sjbar,
//         thetabar += J_theta(sj)^T kjbar, k(j-1)bar += (h or h/2) sjbar;
//       J_y = [[alpha - beta v, -beta u], [delta v, -gamma + delta u]],
//       J_theta = [[u, -u v, 0, 0], [0, 0, -v, u v]],
//     linear in lambda: the 32 lanes take a segment of steps each, and a scan
//     of the segments' affine maps joins them (below).
//   The <Dual<R>> instances run the same code on (primal, tangent) pairs.
//     The dual forward gives ys and its tangent for tangents on z0 and theta
//     (one launch a `jvp`), and stores the dual states (T*S, C) of
//     (u, u', v, v').  The dual adjoint sweeps those states with a dual theta
//     and a dual gbar: its primal is the adjoint, its tangent the derivative
//     of (z0bar, thetabar) along (z0', theta', gbar'), that is a
//     Hessian-vector product of <gbar, ys> plus J^T gbar'.  The primal part
//     of every dual operation is the plain operation, so the dual forward's
//     primal equals the forward's bit for bit; tangents follow PyTorch's
//     forward AD (the tangent of x y is x' y + x y').
//
// Which instance each derivative order takes (ops/lv_rk4.py): a value, the
// forward; a first-order gradient, the forward (states kept) and the
// adjoint; a first-order jvp / jacfwd, the dual forward; a second order
// (functional.hessian, a Hessian-vector product, Laplace's double backward),
// the forward, the adjoint, and one dual forward + dual adjoint pair;
// a third order, the plain version for the rule that needs it.
//
// What bounds each kernel (the work a call, ~50 MFLOP over 67 TFLOP/s and
// ~0.2 MB, is about a microsecond), measured on the card (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py's kernels_lv and tools/lv_timing.py; PERF.md
// holds the numbers; dependent FP32 add / multiply / FMA 4.1 cycles each):
//   - The forward: the serial dependence of the T*S steps a chain, one
//     thread a chain (512 chains are 16 warps, each alone on its scheduler).
//     Its chain is 21 dependent FP32 products and sums a step, each rounded
//     on its own (`__fmul_rn` / `__fadd_rn`, never contracted into an FMA)
//     so that its results equal the plain version's in the same dtype bit
//     for bit: ~86 cycles of latency, 70 instructions; ~98 cycles a step
//     without the states, ~120 with them: each global store reads u and v
//     late and the step's last writes to them wait for it (stores after
//     each step, through a second warp and shared memory, or through shared
//     memory and bulk copies of whole rows measured no better: 118-206).
//   - The adjoint no longer recomputes the solve: the forward's states are
//     read back, each copied into a lane's ring in shared memory AHEAD steps
//     before it is read.  Run serially, one thread a chain, its only serial
//     chain was the cotangent's (13 dependent operations, ~53 cycles a
//     step) and the instruction stream bound it: 143 instructions, ~176
//     cycles a step (346 with the recompute).  The recursion is affine, so
//     the warp's 32 lanes take T*S/32 steps each: a lane composes its steps'
//     maps (three step adjoints a step), a suffix scan of 2 x 2 maps over
//     the lanes (5 shuffles) gives the cotangent entering each segment, and
//     each lane runs its segment again in the sequential order, summing
//     thetabar: ~26 cycles a step of the chain's T*S, 2.2x its issue bound
//     (389 instructions a lane's step, both phases, over 15 steps; the
//     latency of the two phases' chains and the scan is 4x below it).  The
//     joins round in another order than a serial sweep (float64 within
//     5e-15 of the plain version).
//   - The dual instances run the same code on pairs: the dual forward at
//     ~210 cycles a step (a 29-deep tangent chain, 171 instructions), the
//     dual adjoint at ~46 (the scan).
//   - `chip_smoke.py` (`kernels_lv`) prints, beside the operations and bytes
//     bounds, both bounds measured on the card: the dependent operations a
//     step times their latency from `op_latency_probe`, and the SASS
//     instructions a step of the kernels' step loops (`cuobjdump -sass`).
//
// Plain C interface, loaded with ctypes: each launcher returns the CUDA error
// code of its launch (0: accepted).  Float and double instances; the double
// ones let a check hold the kernels tightly against the float64 plain
// version.  An optional `stamps` buffer (4 x u64, null when not wanted)
// receives chain 0's clock64() and %globaltimer (ns) where its serial work
// starts and ends, so a measurement can read the dependent chain's own time
// and cycles apart from the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int RING = 4;  // the adjoint's ring of states in shared memory, a lane's own slots
constexpr int AHEAD = RING - 1;  // each state is copied this many steps before its stages are computed

template <typename R>
struct Dual {
    R p, t;  // primal, tangent
};

template <typename S>
struct RealOf {
    using type = S;
};
template <typename R>
struct RealOf<Dual<R>> {
    using type = R;
};
template <typename S>
using Real = typename RealOf<S>::type;

template <typename S>
struct Theta {
    S a, b, g, d;
};

// h, h/2 and h/6 of one interval, in the working dtype
template <typename R>
struct Steps {
    R h, hh, h6;
};

// The state (u, v) at the start of a step, as stored: one vector access a thread.
template <typename S>
struct alignas(2 * sizeof(S) < 16 ? 2 * sizeof(S) : 16) State {
    S u, v;
};

// ---- the forward's operations: IEEE products and sums, one rounding each and
// never contracted into an FMA, so that the forward does the plain version's
// operations (one PyTorch kernel per operation) in its order.
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float neg(float x) { return -x; }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ double neg(double x) { return -x; }
__device__ __forceinline__ float fmadd(float x, float y, float z) { return __fmaf_rn(x, y, z); }
__device__ __forceinline__ double fmadd(double x, double y, double z) { return __fma_rn(x, y, z); }

// ... and in dual numbers: the primal the plain operation, the tangent
// PyTorch's rule (mul: x' y + x y'; a constant factor scales the tangent).
template <typename R>
__device__ __forceinline__ Dual<R> mul(Dual<R> x, Dual<R> y) {
    return {mul(x.p, y.p), add(mul(x.t, y.p), mul(x.p, y.t))};
}
template <typename R>
__device__ __forceinline__ Dual<R> mul(R c, Dual<R> y) {
    return {mul(c, y.p), mul(c, y.t)};
}
template <typename R>
__device__ __forceinline__ Dual<R> add(Dual<R> x, Dual<R> y) {
    return {add(x.p, y.p), add(x.t, y.t)};
}
template <typename R>
__device__ __forceinline__ Dual<R> sub(Dual<R> x, Dual<R> y) {
    return {sub(x.p, y.p), sub(x.t, y.t)};
}
template <typename R>
__device__ __forceinline__ Dual<R> neg(Dual<R> x) {
    return {-x.p, -x.t};
}

// ---- the adjoint's arithmetic: plain operators, which nvcc may contract into
// FMAs (the float64 checks hold it to 1e-10 of the plain version).
template <typename R>
__device__ __forceinline__ Dual<R> operator+(Dual<R> x, Dual<R> y) {
    return {x.p + y.p, x.t + y.t};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator-(Dual<R> x, Dual<R> y) {
    return {x.p - y.p, x.t - y.t};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator-(Dual<R> x) {
    return {-x.p, -x.t};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator*(Dual<R> x, Dual<R> y) {
    return {x.p * y.p, x.t * y.p + x.p * y.t};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator*(R c, Dual<R> y) {
    return {c * y.p, c * y.t};
}
template <typename R>
__device__ __forceinline__ Dual<R>& operator+=(Dual<R>& x, Dual<R> y) {
    return x = x + y;
}
template <typename R>
__device__ __forceinline__ Dual<R>& operator-=(Dual<R>& x, Dual<R> y) {
    return x = x - y;
}

// Element i of an array given as its primal part `p` and, for a dual, its tangent part `t`.
template <typename R>
__device__ __forceinline__ void get(R& x, const R* p, const R*, size_t i) {
    x = p[i];
}
template <typename R>
__device__ __forceinline__ void get(Dual<R>& x, const R* p, const R* t, size_t i) {
    x = {p[i], t[i]};
}
template <typename R>
__device__ __forceinline__ void put(R x, R* p, R*, size_t i) {
    p[i] = x;
}
template <typename R>
__device__ __forceinline__ void put(Dual<R> x, R* p, R* t, size_t i) {
    p[i] = x.p;
    t[i] = x.t;
}

template <typename S>
__device__ __forceinline__ Theta<S> load_theta(const Real<S>* theta, const Real<S>* ttheta, int i) {
    Theta<S> p;
    get(p.a, theta, ttheta, 4 * i);
    get(p.b, theta, ttheta, 4 * i + 1);
    get(p.g, theta, ttheta, 4 * i + 2);
    get(p.d, theta, ttheta, 4 * i + 3);
    return p;
}

// (alpha u - beta u v, -gamma v + delta u v), as lv_rhs in ops/lv_rk4.py
template <typename S>
__device__ __forceinline__ void lv_rhs(const Theta<S>& p, S u, S v, S& fu, S& fv) {
    fu = sub(mul(p.a, u), mul(mul(p.b, u), v));
    fv = add(mul(neg(p.g), v), mul(mul(p.d, u), v));
}

// One RK4 step in place, in ode_rk4_fixed's order: stage inputs y + hh k1,
// y + hh k2, y + h k3, and y + h6 (((k1 + 2 k2) + 2 k3) + k4).
template <typename S, typename R>
__device__ __forceinline__ void rk4_step(const Theta<S>& p, const Steps<R>& h, S& u, S& v) {
    S k1u, k1v, k2u, k2v, k3u, k3v, k4u, k4v;
    lv_rhs(p, u, v, k1u, k1v);
    lv_rhs(p, add(u, mul(h.hh, k1u)), add(v, mul(h.hh, k1v)), k2u, k2v);
    lv_rhs(p, add(u, mul(h.hh, k2u)), add(v, mul(h.hh, k2v)), k3u, k3v);
    lv_rhs(p, add(u, mul(h.h, k3u)), add(v, mul(h.h, k3v)), k4u, k4v);
    u = add(u, mul(h.h6, add(add(add(k1u, mul(R(2), k2u)), mul(R(2), k3u)), k4u)));
    v = add(v, mul(h.h6, add(add(add(k1v, mul(R(2), k2v)), mul(R(2), k3v)), k4v)));
}

// The four stage inputs of the step that starts at y, computed as the forward
// computes them, so that the adjoint differentiates the forward's own map.
template <typename S>
struct Stages {
    S u[4], v[4];
};

template <typename S, typename R>
__device__ __forceinline__ Stages<S> stages_of(const Theta<S>& p, const Steps<R>& h, const State<S>& y) {
    Stages<S> s;
    S ku, kv;
    s.u[0] = y.u;
    s.v[0] = y.v;
    lv_rhs(p, y.u, y.v, ku, kv);
    s.u[1] = add(y.u, mul(h.hh, ku));
    s.v[1] = add(y.v, mul(h.hh, kv));
    lv_rhs(p, s.u[1], s.v[1], ku, kv);
    s.u[2] = add(y.u, mul(h.hh, ku));
    s.v[2] = add(y.v, mul(h.hh, kv));
    lv_rhs(p, s.u[2], s.v[2], ku, kv);
    s.u[3] = add(y.u, mul(h.h, ku));
    s.v[3] = add(y.v, mul(h.h, kv));
    return s;
}

// Adjoint of one stage k = lv_rhs(s) for the cotangent kbar: adds
// J_y(s)^T kbar to ybar (returned in su, sv as well) and J_theta(s)^T kbar
// to thetabar.  Only kbar comes from the cotangent chain; the Jacobian's
// entries are ready when the step starts.
template <typename S>
__device__ __forceinline__ void stage_adjoint(const Theta<S>& p, S u, S v, S kbu, S kbv, S& su, S& sv,
                                              S& ybu, S& ybv, Theta<S>& tb) {
    su = (p.a - p.b * v) * kbu + p.d * v * kbv;
    sv = -p.b * u * kbu + (-p.g + p.d * u) * kbv;
    ybu += su;
    ybv += sv;
    const S uv = u * v;
    tb.a += u * kbu;
    tb.b -= uv * kbu;
    tb.g -= v * kbv;
    tb.d += uv * kbv;
}

// The adjoint of one RK4 step: (lu, lv) := (d step / d y)^T (lu, lv), and
// thetabar += (d step / d theta)^T (lu, lv).
template <typename S, typename R>
__device__ __forceinline__ void step_adjoint(const Theta<S>& p, const Steps<R>& h, const Stages<S>& s, S& lu, S& lv,
                                             Theta<S>& tb) {
    const S k14u = h.h6 * lu, k14v = h.h6 * lv;  // cotangent of k1 and of k4
    S k3bu = R(2) * k14u, k3bv = R(2) * k14v;
    S k2bu = k3bu, k2bv = k3bv;
    S k1bu = k14u, k1bv = k14v;
    S ybu = lu, ybv = lv, su, sv;
    stage_adjoint(p, s.u[3], s.v[3], k14u, k14v, su, sv, ybu, ybv, tb);
    k3bu += h.h * su;
    k3bv += h.h * sv;
    stage_adjoint(p, s.u[2], s.v[2], k3bu, k3bv, su, sv, ybu, ybv, tb);
    k2bu += h.hh * su;
    k2bv += h.hh * sv;
    stage_adjoint(p, s.u[1], s.v[1], k2bu, k2bv, su, sv, ybu, ybv, tb);
    k1bu += h.hh * su;
    k1bv += h.hh * sv;
    stage_adjoint(p, s.u[0], s.v[0], k1bu, k1bv, su, sv, ybu, ybv, tb);
    lu = ybu;
    lv = ybv;
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

// The steps of one interval; with KEEP each state is stored before its step
// (the kernel's note says what the stores cost).
template <bool KEEP, typename S, typename R>
__device__ __forceinline__ void forward_interval(const Theta<S>& p, const Steps<R>& h, int steps, int c, State<S>* st,
                                                 S& u, S& v) {
    for (int s = 0; s < steps; ++s) {
        if (KEEP) st[(size_t)s * c] = State<S>{u, v};
        rk4_step(p, h, u, v);
    }
}

// z0, theta and their tangents (null for a primal instance); hs (nt) step
// sizes; ys and its tangent (c, nt, 2); states (nt * steps, c) or null.
template <typename S>
__global__ void __launch_bounds__(THREADS) lv_rk4_forward_kernel(
    const Real<S>* __restrict__ z0, const Real<S>* __restrict__ tz0, const Real<S>* __restrict__ theta,
    const Real<S>* __restrict__ ttheta, const Steps<Real<S>>* __restrict__ hs, int c, int nt, int steps,
    Real<S>* __restrict__ ys, Real<S>* __restrict__ tys, State<S>* __restrict__ states,
    unsigned long long* __restrict__ stamps) {
    using R = Real<S>;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c) return;
    const bool stamped = stamps != nullptr && i == 0;
    const Theta<S> p = load_theta<S>(theta, ttheta, i);
    S u, v;
    get(u, z0, tz0, 2 * i);
    get(v, z0, tz0, 2 * i + 1);
    Steps<R> hn = hs[0];
    if (stamped) stamp(stamps, 0);
    for (int k = 0; k < nt; ++k) {
        const Steps<R> h = hn;
        hn = hs[k + 1 < nt ? k + 1 : k];  // the next interval's, loaded an interval ahead
        if (states != nullptr)
            forward_interval<true>(p, h, steps, c, states + (size_t)k * steps * c + i, u, v);
        else
            forward_interval<false>(p, h, steps, c, states, u, v);
        const size_t o = ((size_t)i * nt + k) * 2;
        put(u, ys, tys, o);
        put(v, ys, tys, o + 1);
    }
    if (stamped) stamp(stamps, 1);
}

// The adjoint runs a warp a chain: lane L takes the steps [L seg, (L+1)
// seg), seg = ceil(T*S / 32).  The cotangent's recursion is affine, lambda_j
// = A_j^T (lambda_(j+1) + gbar where interval k ends), A_j the step's
// Jacobian: each lane composes its steps' maps (phase 1: the step adjoint
// applied to the two columns of the map so far and to its offset), a
// suffix scan over the lanes joins them into the cotangent entering each
// lane's steps, and each lane runs its steps again from it in the
// sequential order, summing thetabar (phase 3), which 5 shuffles add up.
constexpr int CHAINS_PER_BLOCK = 4;

template <typename S>
struct Affine {  // x -> P x + q on the cotangent (u, v)
    S p00, p01, p10, p11, q0, q1;
};

// A constant as a scalar of the instance (a dual's tangent 0).
template <typename S>
struct Lift {
    __device__ static S of(S x) { return x; }
};
template <typename R>
struct Lift<Dual<R>> {
    __device__ static Dual<R> of(R x) { return {x, R(0)}; }
};

__device__ __forceinline__ float shfl_down(float x, int d) { return __shfl_down_sync(0xffffffffu, x, d); }
__device__ __forceinline__ double shfl_down(double x, int d) { return __shfl_down_sync(0xffffffffu, x, d); }
__device__ __forceinline__ float shfl_xor(float x, int d) { return __shfl_xor_sync(0xffffffffu, x, d); }
__device__ __forceinline__ double shfl_xor(double x, int d) { return __shfl_xor_sync(0xffffffffu, x, d); }
template <typename R>
__device__ __forceinline__ Dual<R> shfl_down(Dual<R> x, int d) {
    return {shfl_down(x.p, d), shfl_down(x.t, d)};
}
template <typename R>
__device__ __forceinline__ Dual<R> shfl_xor(Dual<R> x, int d) {
    return {shfl_xor(x.p, d), shfl_xor(x.t, d)};
}

// A lane's prefetch of step j's state into slot (j mod RING) of its ring in
// shared memory, one group of asynchronous copies a step (cp.async: the copy
// takes no register, so nothing waits for it until the state is read; a
// register ring's shifts waited for their loads).  A step before `lo`
// copies step lo into a slot no one reads.
template <typename S>
__device__ __forceinline__ void fetch_state(State<S> (*ring)[THREADS], int lane, const State<S>* st, int j, int lo,
                                            int c) {
    static_assert(sizeof(State<S>) % 8 == 0 && sizeof(State<S>) <= 32, "a State is one or two copies of 8 or 16 bytes");
    constexpr int piece = sizeof(State<S>) < 16 ? (int)sizeof(State<S>) : 16;
    const char* src = reinterpret_cast<const char*>(st + (size_t)(j > lo ? j : lo) * c);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&ring[j & (RING - 1)][lane]);
#pragma unroll
    for (int off = 0; off < (int)sizeof(State<S>); off += piece)
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst + off), "l"(src + off), "n"(piece) : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Step j's state from the ring, once its copy (the oldest of the AHEAD
// groups in flight) has landed.
template <typename S>
__device__ __forceinline__ State<S> ring_state(State<S> (*ring)[THREADS], int lane, int j) {
    asm volatile("cp.async.wait_group %0;" ::"n"(AHEAD - 1) : "memory");
    return ring[j & (RING - 1)][lane];
}

// The steps [lo, hi) of a lane in reverse with the step sizes and gbar of
// each interval (loaded an interval ahead); PHASE 1 composes their affine
// maps of the cotangent into F, PHASE 3 runs them on (lu, lv) and sums
// thetabar into tb.
template <int PHASE, typename S>
__device__ __forceinline__ void lane_sweep(const Theta<S>& p, const Steps<Real<S>>* __restrict__ hs,
                                           const Real<S>* __restrict__ gbar, const Real<S>* __restrict__ tgbar,
                                           State<S> (*ring)[THREADS], int lane, const State<S>* st, int i, int c,
                                           int nt, int steps, int lo, int hi, Affine<S>& F, S& lu, S& lv, Theta<S>& tb) {
    using R = Real<S>;
    if (hi <= lo) return;
    int k = (hi - 1) / steps, s = (hi - 1) - k * steps;
    const int kp0 = k > 0 ? k - 1 : 0;
    Steps<R> h = hs[k], hn = hs[kp0];
    S g0, g1, gn0, gn1;
    get(g0, gbar, tgbar, ((size_t)i * nt + k) * 2);
    get(g1, gbar, tgbar, ((size_t)i * nt + k) * 2 + 1);
    get(gn0, gbar, tgbar, ((size_t)i * nt + kp0) * 2);
    get(gn1, gbar, tgbar, ((size_t)i * nt + kp0) * 2 + 1);
#pragma unroll
    for (int q = 0; q < AHEAD; ++q) fetch_state(ring, lane, st, hi - 1 - q, lo, c);
#pragma unroll 1
    for (int j = hi - 1; j >= lo; --j) {
        const Stages<S> sj = stages_of(p, h, ring_state(ring, lane, j));
        fetch_state(ring, lane, st, j - AHEAD, lo, c);
        if (PHASE == 1) {
            S x0 = F.q0, x1 = F.q1;
            if (s == steps - 1) {
                x0 += g0;
                x1 += g1;
            }
            Theta<S> unused{};
            S a0 = F.p00, a1 = F.p10, b0 = F.p01, b1 = F.p11;
            step_adjoint(p, h, sj, a0, a1, unused);
            step_adjoint(p, h, sj, b0, b1, unused);
            step_adjoint(p, h, sj, x0, x1, unused);
            F = Affine<S>{a0, b0, a1, b1, x0, x1};
        } else {
            if (s == steps - 1) {
                lu += g0;
                lv += g1;
            }
            step_adjoint(p, h, sj, lu, lv, tb);
        }
        if (--s < 0 && j > lo) {  // into interval k - 1: its values, and the next one's loaded ahead
            s = steps - 1;
            --k;
            h = hn;
            g0 = gn0;
            g1 = gn1;
            const int kp = k > 0 ? k - 1 : 0;
            hn = hs[kp];
            get(gn0, gbar, tgbar, ((size_t)i * nt + kp) * 2);
            get(gn1, gbar, tgbar, ((size_t)i * nt + kp) * 2 + 1);
        }
    }
}

template <typename S>
__global__ void __launch_bounds__(CHAINS_PER_BLOCK * THREADS) lv_rk4_adjoint_kernel(
    const Real<S>* __restrict__ theta, const Real<S>* __restrict__ ttheta, const Steps<Real<S>>* __restrict__ hs,
    int c, int nt, int steps, const State<S>* __restrict__ states, const Real<S>* __restrict__ gbar,
    const Real<S>* __restrict__ tgbar, Real<S>* __restrict__ z0bar, Real<S>* __restrict__ tz0bar,
    Real<S>* __restrict__ thetabar, Real<S>* __restrict__ tthetabar, unsigned long long* __restrict__ stamps) {
    using R = Real<S>;
    __shared__ State<S> rings[CHAINS_PER_BLOCK][RING][THREADS];
    const int lane = threadIdx.x % THREADS, w = threadIdx.x / THREADS;
    const int i = blockIdx.x * CHAINS_PER_BLOCK + w;
    if (i >= c) return;
    State<S> (*ring)[THREADS] = rings[w];
    const bool stamped = stamps != nullptr && i == 0 && lane == 0;
    const Theta<S> p = load_theta<S>(theta, ttheta, i);
    const State<S>* st = states + i;
    const int n = nt * steps, seg = (n + THREADS - 1) / THREADS;
    const int lo = lane * seg < n ? lane * seg : n, hi = lo + seg < n ? lo + seg : n;
    if (stamped) stamp(stamps, 0);
    const S one = Lift<S>::of(R(1)), zero = Lift<S>::of(R(0));
    Affine<S> F{one, zero, zero, one, zero, zero};
    S lu{}, lv{};
    Theta<S> tb{};
    lane_sweep<1>(p, hs, gbar, tgbar, ring, lane, st, i, c, nt, steps, lo, hi, F, lu, lv, tb);
    // suffix scan over the lanes: G_L = F_L o F_(L+1) o ... o F_31
#pragma unroll
    for (int d = 1; d < THREADS; d <<= 1) {
        Affine<S> G{shfl_down(F.p00, d), shfl_down(F.p01, d), shfl_down(F.p10, d), shfl_down(F.p11, d),
                    shfl_down(F.q0, d), shfl_down(F.q1, d)};
        if (lane + d < THREADS)
            F = Affine<S>{F.p00 * G.p00 + F.p01 * G.p10, F.p00 * G.p01 + F.p01 * G.p11,
                          F.p10 * G.p00 + F.p11 * G.p10, F.p10 * G.p01 + F.p11 * G.p11,
                          F.p00 * G.q0 + F.p01 * G.q1 + F.q0, F.p10 * G.q0 + F.p11 * G.q1 + F.q1};
    }
    lu = shfl_down(F.q0, 1);  // the cotangent entering this lane's last step
    lv = shfl_down(F.q1, 1);
    if (lane == THREADS - 1) lu = lv = S{};
    lane_sweep<3>(p, hs, gbar, tgbar, ring, lane, st, i, c, nt, steps, lo, hi, F, lu, lv, tb);
    asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
    for (int d = THREADS / 2; d > 0; d >>= 1) {
        tb.a += shfl_xor(tb.a, d);
        tb.b += shfl_xor(tb.b, d);
        tb.g += shfl_xor(tb.g, d);
        tb.d += shfl_xor(tb.d, d);
    }
    if (lane == 0) {
        put(lu, z0bar, tz0bar, 2 * i);
        put(lv, z0bar, tz0bar, 2 * i + 1);
        put(tb.a, thetabar, tthetabar, 4 * i);
        put(tb.b, thetabar, tthetabar, 4 * i + 1);
        put(tb.g, thetabar, tthetabar, 4 * i + 2);
        put(tb.d, thetabar, tthetabar, 4 * i + 3);
    }
    if (stamped) stamp(stamps, 1);
}

// One thread times `n` dependent operations of one kind (0 add, 1 multiply,
// 2 FMA) in clock64() cycles: the latency that bounds a serial chain.
template <typename R, int OP>
__global__ void op_latency_kernel(R x0, R y, int n, unsigned long long* __restrict__ cycles, R* __restrict__ sink) {
    R x = x0;
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
    for (int it = 0; it < n; it += 32) {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
            if (OP == 0) x = add(x, y);
            if (OP == 1) x = mul(x, y);
            if (OP == 2) x = fmadd(x, y, y);
        }
    }
    sink[0] = x;  // the store waits for the chain; the stamp follows it
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
    cycles[0] = t1 - t0;
}

template <typename R, int OP>
int latency_launch(int n, void* cycles, void* sink, cudaStream_t stream) {
    op_latency_kernel<R, OP><<<1, 1, 0, stream>>>(R(0.5), R(OP == 0 ? 1e-7 : 0.9999999), n,
                                                  static_cast<unsigned long long*>(cycles), static_cast<R*>(sink));
    return (int)cudaGetLastError();
}

inline int blocks_for(int c) { return (c + THREADS - 1) / THREADS; }

template <typename S>
int forward_launch(const void* z0, const void* tz0, const void* theta, const void* ttheta, const void* hs, int c,
                   int nt, int steps, void* ys, void* tys, void* states, void* stamps, void* stream_ptr) {
    using R = Real<S>;
    lv_rk4_forward_kernel<S><<<blocks_for(c), THREADS, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const R*>(z0), static_cast<const R*>(tz0), static_cast<const R*>(theta),
        static_cast<const R*>(ttheta), static_cast<const Steps<R>*>(hs), c, nt, steps, static_cast<R*>(ys),
        static_cast<R*>(tys), static_cast<State<S>*>(states), static_cast<unsigned long long*>(stamps));
    return (int)cudaGetLastError();
}

template <typename S>
int adjoint_launch(const void* theta, const void* ttheta, const void* hs, int c, int nt, int steps,
                   const void* states, const void* gbar, const void* tgbar, void* z0bar, void* tz0bar,
                   void* thetabar, void* tthetabar, void* stamps, void* stream_ptr) {
    using R = Real<S>;
    lv_rk4_adjoint_kernel<S><<<(c + CHAINS_PER_BLOCK - 1) / CHAINS_PER_BLOCK, CHAINS_PER_BLOCK * THREADS, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const R*>(theta), static_cast<const R*>(ttheta), static_cast<const Steps<R>*>(hs), c, nt, steps,
        static_cast<const State<S>*>(states), static_cast<const R*>(gbar), static_cast<const R*>(tgbar),
        static_cast<R*>(z0bar), static_cast<R*>(tz0bar), static_cast<R*>(thetabar), static_cast<R*>(tthetabar),
        static_cast<unsigned long long*>(stamps));
    return (int)cudaGetLastError();
}

}  // namespace

// z0 (c, 2), theta (c, 4), hs (nt, 3) = (h, h/2, h/6) of each interval, ys
// (c, nt, 2): contiguous, of the instance's type; states (nt * steps, c, 2)
// or null; stamps (4,) u64 or null.
extern "C" int lv_rk4_forward_f32(const void* z0, const void* theta, const void* hs, int c, int nt, int steps,
                                  void* ys, void* states, void* stamps, void* stream_ptr) {
    return forward_launch<float>(z0, nullptr, theta, nullptr, hs, c, nt, steps, ys, nullptr, states, stamps,
                                 stream_ptr);
}

extern "C" int lv_rk4_forward_f64(const void* z0, const void* theta, const void* hs, int c, int nt, int steps,
                                  void* ys, void* states, void* stamps, void* stream_ptr) {
    return forward_launch<double>(z0, nullptr, theta, nullptr, hs, c, nt, steps, ys, nullptr, states, stamps,
                                  stream_ptr);
}

// theta, hs as above; states (nt * steps, c, 2) from lv_rk4_forward; gbar
// (c, nt, 2); outputs z0bar (c, 2), thetabar (c, 4).
extern "C" int lv_rk4_adjoint_f32(const void* theta, const void* hs, int c, int nt, int steps, const void* states,
                                  const void* gbar, void* z0bar, void* thetabar, void* stamps, void* stream_ptr) {
    return adjoint_launch<float>(theta, nullptr, hs, c, nt, steps, states, gbar, nullptr, z0bar, nullptr, thetabar,
                                 nullptr, stamps, stream_ptr);
}

extern "C" int lv_rk4_adjoint_f64(const void* theta, const void* hs, int c, int nt, int steps, const void* states,
                                  const void* gbar, void* z0bar, void* thetabar, void* stamps, void* stream_ptr) {
    return adjoint_launch<double>(theta, nullptr, hs, c, nt, steps, states, gbar, nullptr, z0bar, nullptr, thetabar,
                                  nullptr, stamps, stream_ptr);
}

// The dual forward: as lv_rk4_forward with the tangents tz0 (c, 2), ttheta
// (c, 4) and tys (c, nt, 2); states (nt * steps, c, 2, 2) of (u, u', v, v')
// or null.
extern "C" int lv_rk4_dual_forward_f32(const void* z0, const void* tz0, const void* theta, const void* ttheta,
                                       const void* hs, int c, int nt, int steps, void* ys, void* tys, void* states,
                                       void* stamps, void* stream_ptr) {
    return forward_launch<Dual<float>>(z0, tz0, theta, ttheta, hs, c, nt, steps, ys, tys, states, stamps,
                                       stream_ptr);
}

extern "C" int lv_rk4_dual_forward_f64(const void* z0, const void* tz0, const void* theta, const void* ttheta,
                                       const void* hs, int c, int nt, int steps, void* ys, void* tys, void* states,
                                       void* stamps, void* stream_ptr) {
    return forward_launch<Dual<double>>(z0, tz0, theta, ttheta, hs, c, nt, steps, ys, tys, states, stamps,
                                        stream_ptr);
}

// The dual adjoint: as lv_rk4_adjoint with ttheta (c, 4), the dual states of
// lv_rk4_dual_forward, tgbar (c, nt, 2), and the outputs' tangents tz0bar
// (c, 2), tthetabar (c, 4).
extern "C" int lv_rk4_dual_adjoint_f32(const void* theta, const void* ttheta, const void* hs, int c, int nt,
                                       int steps, const void* states, const void* gbar, const void* tgbar,
                                       void* z0bar, void* tz0bar, void* thetabar, void* tthetabar, void* stamps,
                                       void* stream_ptr) {
    return adjoint_launch<Dual<float>>(theta, ttheta, hs, c, nt, steps, states, gbar, tgbar, z0bar, tz0bar, thetabar,
                                       tthetabar, stamps, stream_ptr);
}

extern "C" int lv_rk4_dual_adjoint_f64(const void* theta, const void* ttheta, const void* hs, int c, int nt,
                                       int steps, const void* states, const void* gbar, const void* tgbar,
                                       void* z0bar, void* tz0bar, void* thetabar, void* tthetabar, void* stamps,
                                       void* stream_ptr) {
    return adjoint_launch<Dual<double>>(theta, ttheta, hs, c, nt, steps, states, gbar, tgbar, z0bar, tz0bar,
                                        thetabar, tthetabar, stamps, stream_ptr);
}

// `n` (a multiple of 32) dependent operations of kind `op` (0 add, 1
// multiply, 2 FMA) in float (is_double 0) or double on one thread: cycles
// (1,) u64 receives their clock64() count, sink (1,) of the type their result.
extern "C" int op_latency_probe(int op, int is_double, int n, void* cycles, void* sink, void* stream_ptr) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream_ptr);
    if (is_double) {
        if (op == 0) return latency_launch<double, 0>(n, cycles, sink, s);
        if (op == 1) return latency_launch<double, 1>(n, cycles, sink, s);
        return latency_launch<double, 2>(n, cycles, sink, s);
    }
    if (op == 0) return latency_launch<float, 0>(n, cycles, sink, s);
    if (op == 1) return latency_launch<float, 1>(n, cycles, sink, s);
    return latency_launch<float, 2>(n, cycles, sink, s);
}
