// Trust-region dogleg point solve, f32, power-law Voce kinetics (sm_90a).
//
// Replaces the TPU kernel exaconstit_tpu/solvers/dogleg_pallas.py::
// _dogleg_kernel: the f32 stage of the per-quadrature-point
// crystal-plasticity solve.  Per point it solves r(x) = 0 for
// x = [deviatoric elastic strain (5), lattice-rotation expmap (3)] with
// the CRSS g frozen: r and the analytic 8x8 Jacobian as in
// evptn_cm.residual_and_jac_cm, a row-equilibrated Gauss-Jordan Newton
// step, the Cauchy point, the dogleg blend, rho-based radius updates and
// an exit at |r| < tol or max_iter.  The plain version of the same
// function is solvers/dogleg_cuda.py::dogleg_stage_reference (which runs
// evptn_cm.dogleg_cm); this kernel follows its per-lane semantics, norms
// included (a norm of a non-finite vector reads as 0, so a lane whose
// start residual is not finite is done at its start, as in dogleg_cm).
//
// What bounds it on Hopper: f32 operations.  One residual and Jacobian
// evaluation is about 1,860 operations (12 precise logf/expf pairs, the
// rotation, the 8x8 Jacobian) and one dogleg iteration about 3,340 with
// its evaluation (the pivoted 8x8 elimination is most of the rest;
// dogleg_cuda.py counts both, FMA as 2).  Device memory moves 27 floats
// in and 72 floats (x, the final J) plus a flag and a count out per
// point, each once: at 4.4 mean iterations a point needs about twice as
// long for its operations at 67 TFLOP/s as for its bytes at 3.35 TB/s.
// Iteration counts per point run from 1 to 25, and some points of the
// main path run to max_iter.
//
// What the design does about it:
// - A group of 8 threads per point, one row of r, J and the elimination
//   matrix per thread.  The slip systems are split over the lanes
//   (s = lane and lane + 8), each lane builds its own row of J, dot
//   products are 3-step shuffle reductions, J^T r is a reduce-scatter.
//   A thread carries a few tens of live floats instead of some 250, so
//   the kernel needs no spills and 20 warps are resident per SM.
// - Gauss-Jordan without moving rows: each lane tracks its row's logical
//   position, the pivot is a group argmax over the rows at positions
//   >= col (strict >, the first largest row wins, a NaN row never wins,
//   a NaN at position col keeps its row), found by a max butterfly and
//   a ballot, with a second reduction over positions only on ties.
//   Every lane scales its own row by its own reciprocal while the
//   search runs, and the pivot lane's scaled row is broadcast.
// - Refill instead of exit: a persistent grid (resident blocks x SMs).
//   A warp takes points for its 4 groups in chunks from one global
//   counter; a group whose point is done writes it and takes the next
//   at once.  Each pass of the warp's loop evaluates one residual and
//   Jacobian per group: at the trial x for a group that is iterating, at
//   the start x0 for a group that just took a point.  So a warp idles
//   only at the end of the grid, not for its slowest point.  Every
//   shuffle sits in code that all 32 lanes run; the group flags only
//   select what is kept.
// - P C and the rows of [P^T; Q^T] sit in shared memory, laid out so
//   that the 8 lanes of a group read 8 consecutive words; P C is also
//   read from the launch parameters where all lanes read one entry.  The
//   Jacobian's kinetics block is sum_s (P[s,i] slope_s) (P C)[s,j], so no
//   25x12 and 15x12 weight tables are needed.
// - Divisions and square roots are IEEE (no --use_fast_math), as are
//   logf, expf and sincosf: the 32^3 main path's Newton solve is
//   sensitive to the stage's rounding, and with the approximate
//   reciprocal and square root it failed a schedule it passes with these.
// - An accepted step copies 8 floats of J per lane, not 64 per point.
// - Inputs and outputs are component-major (a[k*N + n]); inactive lanes
//   keep x0 and read converged after 0 iterations; a non-finite Newton
//   step is zeroed; J of the last accepted iterate is written out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (no --use_fast_math).  Entry point:
//        dogleg_voce_f32 (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#define NSLIP 12
#define THREADS 128
#define CHUNK 16  // points a warp takes from the counter at a time
#define MIN_BLOCKS 5  // resident blocks per SM asked of the compiler
#define FULL 0xffffffffu

struct DoglegParams {
    float PC[NSLIP * 5];    // P C, resolved shear per strain component
    float PQ[8 * NSLIP];    // rows of [P^T; Q^T]: PQ[i*12 + s]
    float xn;               // 1 / rate sensitivity m
    float gdot0;
    float tol;
    int max_iter;
};

// NaN-propagating max/min, as jnp.maximum / torch.clamp
__device__ __forceinline__ float nmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
    return (a < b || a != a) ? a : b;
}
// sqrt for s > 0, else 0 (NaN included), as evptn_cm._safe_sqrt
__device__ __forceinline__ float safe_sqrt(float s) {
    return s > 0.f ? sqrtf(s) : 0.f;
}
// v[i] for a run-time i < N, by selects (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
    float out = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) out = (i == j) ? v[j] : out;
    return out;
}

// ---- group-of-8 primitives (every lane of the warp must call them) ----

// sum over the group, the same bits on all 8 lanes
__device__ __forceinline__ float gsum(float v) {
    v += __shfl_xor_sync(FULL, v, 4);
    v += __shfl_xor_sync(FULL, v, 2);
    v += __shfl_xor_sync(FULL, v, 1);
    return v;
}
// lane k's value of the group
template <class T>
__device__ __forceinline__ T gget(T v, int k) {
    return __shfl_sync(FULL, v, k, 8);
}
// the group's 8 bits of a warp ballot
__device__ __forceinline__ unsigned gballot(bool p, int gbase) {
    return (__ballot_sync(FULL, p) >> gbase) & 0xffu;
}
// the whole 8-vector whose component l is on lane l
__device__ __forceinline__ void gather8(float v, float (&out)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = gget(v, i);
}
// the group's 8-vectors a (one per lane) summed; lane l gets entry l
__device__ __forceinline__ float reduce_scatter8(const float (&a)[8], int l) {
    const bool h4 = l & 4, h2 = l & 2, h1 = l & 1;
    float b[4], c[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        b[i] = (h4 ? a[i + 4] : a[i])
               + __shfl_xor_sync(FULL, h4 ? a[i] : a[i + 4], 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
        c[i] = (h2 ? b[i + 2] : b[i])
               + __shfl_xor_sync(FULL, h2 ? b[i] : b[i + 2], 2);
    return (h1 ? c[1] : c[0]) + __shfl_xor_sync(FULL, h1 ? c[0] : c[1], 1);
}

#define SQR2I 0.70710678118654752f
#define SQR6I 0.40824829046386302f
#define TINY 1.17549435e-38f  // f32 smallest normal

struct PointIn {
    float D[3][3];  // sample-frame deviatoric rate
    float w[3];     // sample-frame spin (axial)
    float qn[4];    // begin-of-substep orientation
    float en;       // this lane's begin-of-substep elastic strain (l < 5)
    float g;        // CRSS
    float dt;
};

// vecd of a 3x3 (BASIS_DEV : A)
__device__ __forceinline__ void mat_to_vecd(const float A[3][3],
                                            float (&v)[5]) {
    v[0] = SQR2I * A[0][0] - SQR2I * A[1][1];
    v[1] = -SQR6I * A[0][0] - SQR6I * A[1][1] + 2.f * SQR6I * A[2][2];
    v[2] = SQR2I * (A[0][1] + A[1][0]);
    v[3] = SQR2I * (A[0][2] + A[2][0]);
    v[4] = SQR2I * (A[1][2] + A[2][1]);
}

// slip rate and slope of slip system s (power law, f32 exponent cap 25
// with linear continuation above it)
__device__ __forceinline__ void slip_rate(const float* sPC, int s,
                                          const float (&x)[8], float g,
                                          float xn, float gdot0, float& gd,
                                          float& slope) {
    float tau = 0.f;
#pragma unroll
    for (int k = 0; k < 5; ++k) tau += sPC[k * NSLIP + s] * x[k];
    const float tau_abs = fabsf(tau);
    const float ratio = tau_abs / g;
    const bool bg = ratio > 1e-10f;
    const float lg = xn * logf(bg ? ratio : 1.f);
    const float capped = nmin(lg, 25.f);
    const float over = nmax(lg - 25.f, 0.f);
    const float mag_cap = gdot0 * expf(capped);
    const float mag = mag_cap * (1.f + over);
    const float slope_mag = (lg < 25.f) ? xn * mag : xn * mag_cap;
    const float sgn = (tau > 0.f) ? 1.f : ((tau < 0.f) ? -1.f : tau);
    gd = sgn * (bg ? mag : 0.f);
    slope = bg ? slope_mag / tau_abs : 0.f;
}

// Row l of r and J at x (x: the whole 8-vector on every lane of the
// group; x_own: its component l).  The rotation and the lattice rates are
// computed on every lane; the slip systems are split over the lanes and
// gathered by shuffles.
__device__ __forceinline__ void resjac(const DoglegParams& P,
                                       const float* sPC, const float* sPQ,
                                       const PointIn& in, const float (&x)[8],
                                       float x_own, int l, float& r,
                                       float (&J)[8]) {
    // q_end = q_n * exp(xi)
    const float xi0 = x[5], xi1 = x[6], xi2 = x[7];
    const float ang2 = xi0 * xi0 + xi1 * xi1 + xi2 * xi2;
    const bool big = ang2 > 1e-24f;
    const float ang = sqrtf(big ? ang2 : 1.f);
    float sh, ch;
    sincosf(0.5f * ang, &sh, &ch);
    const float d0 = big ? ch : 1.f - 0.125f * ang2;
    const float sinc = big ? sh / ang : 0.5f - ang2 / 48.f;
    const float d1 = xi0 * sinc, d2 = xi1 * sinc, d3 = xi2 * sinc;
    const float a0 = in.qn[0], a1 = in.qn[1], a2 = in.qn[2], a3 = in.qn[3];
    const float q0 = a0 * d0 - a1 * d1 - a2 * d2 - a3 * d3;
    const float q1 = a0 * d1 + a1 * d0 + a2 * d3 - a3 * d2;
    const float q2 = a0 * d2 - a1 * d3 + a2 * d0 + a3 * d1;
    const float q3 = a0 * d3 + a1 * d2 - a2 * d1 + a3 * d0;
    const float qbar = q0 * q0 - (q1 * q1 + q2 * q2 + q3 * q3);
    float R[3][3];
    R[0][0] = qbar + 2.f * q1 * q1;
    R[0][1] = 2.f * (q1 * q2 - q0 * q3);
    R[0][2] = 2.f * (q1 * q3 + q0 * q2);
    R[1][0] = 2.f * (q1 * q2 + q0 * q3);
    R[1][1] = qbar + 2.f * q2 * q2;
    R[1][2] = 2.f * (q2 * q3 - q0 * q1);
    R[2][0] = 2.f * (q1 * q3 - q0 * q2);
    R[2][1] = 2.f * (q2 * q3 + q0 * q1);
    R[2][2] = qbar + 2.f * q3 * q3;

    // D_lat = R^T D R, w_lat = R^T w
    float T[3][3], Dl[3][3], wl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            T[i][j] = in.D[i][0] * R[0][j] + in.D[i][1] * R[1][j]
                      + in.D[i][2] * R[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            Dl[i][j] = R[0][i] * T[0][j] + R[1][i] * T[1][j]
                       + R[2][i] * T[2][j];
        wl[i] = R[0][i] * in.w[0] + R[1][i] * in.w[1] + R[2][i] * in.w[2];
    }
    float dlat[5];
    mat_to_vecd(Dl, dlat);

    // slip systems l and l + 8 on this lane
    float gdA, slA, gdB = 0.f, slB = 0.f;
    slip_rate(sPC, l, x, in.g, P.xn, P.gdot0, gdA, slA);
    if (l < NSLIP - 8)
        slip_rate(sPC, l + 8, x, in.g, P.xn, P.gdot0, gdB, slB);

    // row l: r_l from [P^T; Q^T] gd, J_l[0:5] = dt sum_s u_s (P C)[s, :]
    // with u_s = [P^T; Q^T][l, s] slope_s
    float dp = 0.f, acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < NSLIP; ++s) {
        const float gd = gget(s < 8 ? gdA : gdB, s & 7);
        const float sl = gget(s < 8 ? slA : slB, s & 7);
        const float pq = sPQ[s * 8 + l];
        dp += pq * gd;
        const float u = pq * sl;
#pragma unroll
        for (int j = 0; j < 5; ++j) acc[j] += u * P.PC[s * 5 + j];
    }

    // kinematics: d(D_lat)/d xi_c ~ D_lat K_c - K_c D_lat with
    // (K_c)_ij = eps_icj, i.e. K_0 = [[0,0,0],[0,0,-1],[0,1,0]],
    // K_1 = [[0,0,1],[0,0,0],[-1,0,0]], K_2 = [[0,-1,0],[1,0,0],[0,0,0]]
    float kin[3][5];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float Km[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        if (c == 0) { Km[1][2] = -1.f; Km[2][1] = 1.f; }
        if (c == 1) { Km[0][2] = 1.f; Km[2][0] = -1.f; }
        if (c == 2) { Km[0][1] = -1.f; Km[1][0] = 1.f; }
        float C[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                float a = 0.f, b = 0.f;
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    a += Dl[i][m] * Km[m][j];
                    b += Km[i][m] * Dl[m][j];
                }
                C[i][j] = a - b;
            }
        mat_to_vecd(C, kin[c]);
    }

    const float dt = in.dt;
#pragma unroll
    for (int j = 0; j < 5; ++j) J[j] = dt * acc[j] + ((l == j) ? 1.f : 0.f);
    if (l < 5) {  // strain rows
        r = x_own - in.en + dt * (dp - pick(dlat, l));
#pragma unroll
        for (int c = 0; c < 3; ++c) J[5 + c] = -dt * pick(kin[c], l);
    } else {  // rows 5..7: d(w_lat)_i/d xi_j ~ sum_l eps_ilj w_lat_l
        const float w0 = dt * wl[0], w1 = dt * wl[1], w2 = dt * wl[2];
        const float wrow = (l == 5) ? wl[0] : ((l == 6) ? wl[1] : wl[2]);
        r = x_own - dt * (wrow - dp);
        J[5] = (l == 5) ? 1.f : ((l == 6) ? -w2 : w1);
        J[6] = (l == 5) ? w2 : ((l == 6) ? 1.f : -w0);
        J[7] = (l == 5) ? -w1 : ((l == 6) ? w0 : 1.f);
    }
}

// One dogleg step for the group's point from row l of J, r_l, rr = |r|^2
// and the radius.  Returns p_l; pred (the linear model's decrease) and
// |p| come back on every lane of the group.
__device__ __forceinline__ float dogleg_step(const float (&J)[8], float r,
                                             float rr, float delta, int l,
                                             int gbase, float& pred,
                                             float& p_norm) {
    // Newton step: row-equilibrated Gauss-Jordan.  Rows stay on their
    // lanes; pos is the logical position of this lane's row (a row swap
    // swaps positions only).
    float M[9];
    {
        float rmax = fabsf(J[0]);
#pragma unroll
        for (int j = 1; j < 8; ++j) rmax = nmax(rmax, fabsf(J[j]));
        const float rs = 1.f / nmax(rmax, 1e-37f);
#pragma unroll
        for (int j = 0; j < 8; ++j) M[j] = J[j] * rs;
        M[8] = r * rs;
    }
    int pos = l, src = 0;
#pragma unroll
    for (int col = 0; col < 8; ++col) {
        // pivot: of the rows at positions >= col, the largest |M[.][col]|,
        // the lowest position on ties; a NaN row never wins, and a NaN at
        // position col keeps its row (as +inf it ties with any later +inf
        // row and wins on position)
        const float a = fabsf(M[col]);
        const float v = (pos < col) ? -1.f
            : ((a == a) ? a : ((pos == col) ? __int_as_float(0x7f800000)
                                            : -1.f));
        // this row scaled by its own pivot entry, in case it is chosen
        const float inv = 1.f / M[col];
        float s[9];
#pragma unroll
        for (int j = col + 1; j < 9; ++j) s[j] = M[j] * inv;
        float vmax = fmaxf(v, __shfl_xor_sync(FULL, v, 4));
        vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, 2));
        vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, 1));
        const unsigned win = gballot(v == vmax, gbase);
        int pl;  // the pivot row's lane
        if (__any_sync(FULL, (win & (win - 1u)) != 0u)) {
            int key = (v == vmax) ? pos * 8 + l : 0x7fffffff;
#pragma unroll
            for (int m = 4; m >= 1; m >>= 1) {
                const int other = __shfl_xor_sync(FULL, key, m);
                key = other < key ? other : key;
            }
            pl = key & 7;
        } else {
            pl = __ffs(win) - 1;
        }
        const int ppos = gget(pos, pl);
        const float f = M[col];
#pragma unroll
        for (int j = col + 1; j < 9; ++j) {
            const float pj = gget(s[j], pl);
            M[j] = (l == pl) ? s[j] : M[j] - f * pj;
        }
        pos = (l == pl) ? col : ((pos == col) ? ppos : pos);
        // the row that ends at position col holds component col
        src = (l == col) ? pl : src;
    }
    // component l of the Newton step, zeroed when any component is not
    // finite
    float pn = gget(M[8], src);
    pn = (gballot(isfinite(pn), gbase) == 0xffu) ? -pn : 0.f;
    const float pn2 = gsum(pn * pn);

    // Cauchy point along g = J^T r
    float a8[8], gf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a8[j] = J[j] * r;
    const float gl = reduce_scatter8(a8, l);
    gather8(gl, gf);
    float gg = 0.f, jg = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        gg += gf[j] * gf[j];
        jg += J[j] * gf[j];
    }
    const float alpha = gg / nmax(gsum(jg * jg), TINY);
    const float pc = -alpha * gl;
    const float dd = pn - pc;
    const float pcpc = gsum(pc * pc);
    const float pcdd = gsum(pc * dd);
    const float dddd = gsum(dd * dd);

    // dogleg blend on the trust-region boundary
    const float pc_norm = safe_sqrt(pcpc);
    const float b = 2.f * pcdd;
    const float c = pcpc - delta * delta;
    const float disc = nmax(b * b - 4.f * dddd * c, 0.f);
    float beta = (-b + safe_sqrt(disc)) / nmax(2.f * dddd, TINY);
    beta = nmin(nmax(beta, 0.f), 1.f);
    const float desc = delta / nmax(safe_sqrt(gg), TINY);
    const bool use_newton = safe_sqrt(pn2) <= delta;
    const bool use_desc = pc_norm >= delta;
    const float p_tr = use_desc ? -desc * gl : pc + beta * dd;
    const float p = use_newton ? pn : p_tr;

    // decrease predicted by the linear model r + J p
    float pf[8], lin = r, pp = 0.f;
    gather8(p, pf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        lin += J[j] * pf[j];
        pp += pf[j] * pf[j];
    }
    pred = 0.5f * rr - 0.5f * gsum(lin * lin);
    p_norm = safe_sqrt(pp);
    return p;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dogleg_voce_kernel(const float* __restrict__ d_vecd,
                   const float* __restrict__ w_sm,
                   const float* __restrict__ e_n,
                   const float* __restrict__ q_n,
                   const float* __restrict__ g,
                   const float* __restrict__ dts,
                   const float* __restrict__ x0,
                   const uint8_t* __restrict__ active,
                   float* __restrict__ x_out, float* __restrict__ j_out,
                   uint8_t* __restrict__ ok_out, int* __restrict__ it_out,
                   int* __restrict__ next, int N, const DoglegParams P) {
    __shared__ float sPC[5 * NSLIP];  // sPC[k*12 + s] = (P C)[s, k]
    __shared__ float sPQ[NSLIP * 8];  // sPQ[s*8 + i] = [P^T; Q^T][i, s]
    for (int i = threadIdx.x; i < 5 * NSLIP; i += THREADS)
        sPC[(i % 5) * NSLIP + i / 5] = P.PC[i];
    for (int i = threadIdx.x; i < 8 * NSLIP; i += THREADS)
        sPQ[(i % NSLIP) * 8 + i / NSLIP] = P.PQ[i];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int l = lane & 7;        // the row this lane carries
    const int gbase = lane & ~7;   // the group's first lane
    const float tol = P.tol;
    const int max_iter = P.max_iter;

    // the group's point: inputs, state, and the flags that steer the
    // warp's loop (have: holds a point; fresh: x0 not yet evaluated)
    PointIn in = {};
    int n = 0, iters = 0;
    bool have = false, fresh = false, exhausted = false, act = false;
    float x = 0.f, r = 0.f, rr = 0.f, delta = 1.f, xt = 0.f;
    float pred = 0.f, p_norm = 0.f;
    float J[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int chunk_next = 0, chunk_end = 0;  // the warp's points in hand

    while (true) {
        // refill: each group that holds no point takes the next one
        const bool need = !have && !exhausted;
        const unsigned lead = __ballot_sync(FULL, need && l == 0);
        if (lead) {
            const int k = __popc(lead);
            const int rank = __popc(lead & ((1u << gbase) - 1u));
            const int rem = chunk_end - chunk_next;
            int base = 0;
            if (rem < k) {
                if (lane == 0) base = atomicAdd(next, CHUNK);
                base = __shfl_sync(FULL, base, 0);
                chunk_end = base + CHUNK;
            }
            if (need)
                n = (rank < rem) ? chunk_next + rank : base + (rank - rem);
            chunk_next = (rem < k) ? base + (k - rem) : chunk_next + k;
            if (need && n >= N) exhausted = true;
            if (need && n < N) {
                float dv[5];
#pragma unroll
                for (int c = 0; c < 5; ++c) dv[c] = d_vecd[c * N + n];
                // vecd_to_mat (BASIS_DEV^T t)
                in.D[0][0] = SQR2I * dv[0] - SQR6I * dv[1];
                in.D[1][1] = -SQR2I * dv[0] - SQR6I * dv[1];
                in.D[2][2] = 2.f * SQR6I * dv[1];
                in.D[0][1] = in.D[1][0] = SQR2I * dv[2];
                in.D[0][2] = in.D[2][0] = SQR2I * dv[3];
                in.D[1][2] = in.D[2][1] = SQR2I * dv[4];
#pragma unroll
                for (int c = 0; c < 3; ++c) in.w[c] = w_sm[c * N + n];
#pragma unroll
                for (int c = 0; c < 4; ++c) in.qn[c] = q_n[c * N + n];
                in.en = (l < 5) ? e_n[l * N + n] : 0.f;
                in.g = g[n];
                in.dt = dts[n];
                xt = x0[l * N + n];
                act = active[n] != 0;
                have = fresh = true;
            }
        }
        if (!__any_sync(FULL, have)) break;

        // the trial point of each iterating group (a fresh group's is x0)
        const bool iterating = have && !fresh;
        if (__any_sync(FULL, iterating)) {
            float pr_, pn_;
            const float p = dogleg_step(J, r, rr, delta, l, gbase, pr_, pn_);
            if (iterating) {
                xt = x + p;
                pred = pr_;
                p_norm = pn_;
            }
        }

        // one residual and Jacobian per group, at its trial point
        float xf[8], rt, Jt[8];
        gather8(xt, xf);
        resjac(P, sPC, sPQ, in, xf, xt, l, rt, Jt);
        const float rr_t = gsum(rt * rt);
        const bool finite = gballot(isfinite(rt), gbase) == 0xffu;

        if (have) {
            bool done;
            bool take = fresh;
            float rho = 0.f;
            if (!fresh) {
                rho = (0.5f * rr - 0.5f * rr_t) / nmax(pred, TINY);
                take = finite && rho > 1e-4f;
            }
            if (take) {
                x = xt;
                r = rt;
                rr = rr_t;
#pragma unroll
                for (int j = 0; j < 8; ++j) J[j] = Jt[j];
            }
            if (fresh) {
                delta = 1.f;
                iters = 0;
                fresh = false;
                done = (safe_sqrt(rr_t) < tol) || !act;
            } else {
                // radius: x2 (cap 1e4) on a good long step, 0.25|p| on a
                // poor one, 0.1|p| on a bad or non-finite one, floor 1e-12
                const bool grow = (rho > 0.8f) && (p_norm > 0.9f * delta);
                const bool shrink = !finite || (rho < 0.25f);
                const float factor = (!finite || rho < 0.f) ? 0.1f : 0.25f;
                float dn = grow ? nmin(2.f * delta, 1e4f) : delta;
                if (shrink) dn = nmax(factor * p_norm, 1e-12f);
                delta = dn;
                ++iters;
                done = safe_sqrt(rr) < tol;
            }
            if (done || iters >= max_iter) {
                x_out[l * N + n] = x;
#pragma unroll
                for (int j = 0; j < 8; ++j) j_out[(l * 8 + j) * N + n] = J[j];
                if (l == 0) {
                    ok_out[n] = done ? 1 : 0;
                    it_out[n] = iters;
                }
                have = false;
            }
        }
    }
}

// Persistent grid: as many blocks as are resident at once, at most one
// group per point.
static cudaError_t grid_blocks(long N, int* blocks_out, int* per_sm_out) {
    static int cached_dev = -1, sms = 0, per_sm = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != cached_dev) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, dogleg_voce_kernel, THREADS, 0);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        cached_dev = dev;
    }
    const long groups = THREADS / 8;
    const long need = (N + groups - 1) / groups;
    const long blocks = (long)per_sm * sms;
    *blocks_out = (int)(blocks < need ? blocks : need);
    if (per_sm_out) *per_sm_out = per_sm;
    return cudaSuccess;
}

// next: one int32 on the device, zero before the launch (the point
// counter the groups take their points from)
extern "C" int dogleg_voce_f32(const float* d_vecd, const float* w_sm,
                               const float* e_n, const float* q_n,
                               const float* g, const float* dts,
                               const float* x0, const uint8_t* active,
                               float* x_out, float* j_out, uint8_t* ok_out,
                               int* it_out, int* next, int N,
                               const DoglegParams* params, void* stream) {
    if (N <= 0) return 0;
    int blocks = 0;
    const cudaError_t err = grid_blocks(N, &blocks, nullptr);
    if (err != cudaSuccess) return (int)err;
    dogleg_voce_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        d_vecd, w_sm, e_n, q_n, g, dts, x0, active, x_out, j_out, ok_out,
        it_out, next, N, *params);
    return (int)cudaGetLastError();
}

extern "C" int dogleg_voce_params_size() { return (int)sizeof(DoglegParams); }

// registers per thread, local (stack and spill) bytes per thread,
// resident blocks per SM and threads per block, as the runtime reports
// them
extern "C" int dogleg_voce_build_info(int* regs, int* local_bytes,
                                      int* blocks_per_sm, int* threads) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, dogleg_voce_kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *threads = THREADS;
    int blocks = 0;
    return (int)grid_blocks(1L << 30, &blocks, blocks_per_sm);
}
