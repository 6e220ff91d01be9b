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
// What bounds it on Hopper: registers.  A point carries x, r and J plus
// the trial r and J and the 8x9 elimination matrix, some 250 live
// floats, above the 255-register ceiling, so the compiler spills to
// local memory (cached in L1).  Second, divergence: points need from a
// few to a few tens of iterations, and a warp runs until its slowest
// lane is done.  Device-memory traffic is small: 27 floats in, and 72
// floats (x and the final J) and two flags out per point, each read or
// written once.
//
// What the design does: one thread per point, everything in registers
// or spilled locals, with fully unrolled small loops so every array
// index is a compile-time constant (the pivot swap is a predicated
// select, not a dynamic index).  Each thread exits as soon as its own
// point is done, so a warp waits only for its own slowest lane rather
// than a whole tile.  Inputs are component-major (a[k*N + n]), so a
// warp's loads and stores of one component are coalesced; the ragged
// edge is masked with n < N, so no padding is needed.  The constant
// tables travel by value as launch parameters (about 2.6 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (precise expf/logf/sinf/cosf: no
//        --use_fast_math).  Entry point: dogleg_voce_f32 (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#define NSLIP 12

struct DoglegParams {
    float PC[NSLIP * 5];    // P C, resolved shear per strain component
    float PT[5 * NSLIP];    // P^T
    float QT[3 * NSLIP];    // Q^T
    float WP[25 * NSLIP];   // W_P[(5i+j), s] = P[s,i] (P C)[s,j]
    float WQ[15 * NSLIP];   // W_Q[(5i+j), s] = Q[s,i] (P C)[s,j]
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
__device__ __forceinline__ float dot8(const float* a, const float* b) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += a[i] * b[i];
    return s;
}
__device__ __forceinline__ bool finite8(const float* a) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) ok = ok && isfinite(a[i]);
    return ok;
}

#define SQR2I 0.70710678118654752f
#define SQR6I 0.40824829046386302f

struct PointIn {
    float D[3][3];  // sample-frame deviatoric rate
    float w[3];     // sample-frame spin (axial)
    float en[5];    // begin-of-substep elastic strain (vecd)
    float qn[4];    // begin-of-substep orientation
    float g;        // CRSS
    float dt;
};

// vecd of a symmetric 3x3 (BASIS_DEV : A)
__device__ __forceinline__ void mat_to_vecd(const float A[3][3], float v[5]) {
    v[0] = SQR2I * A[0][0] - SQR2I * A[1][1];
    v[1] = -SQR6I * A[0][0] - SQR6I * A[1][1] + 2.f * SQR6I * A[2][2];
    v[2] = SQR2I * (A[0][1] + A[1][0]);
    v[3] = SQR2I * (A[0][2] + A[2][0]);
    v[4] = SQR2I * (A[1][2] + A[2][1]);
}

// r (8) and J (8x8, row-major) at x
__device__ void resjac(const DoglegParams& P, const PointIn& in,
                       const float x[8], float r[8], float J[64]) {
    // q_end = q_n * exp(xi)
    const float xi0 = x[5], xi1 = x[6], xi2 = x[7];
    const float ang2 = xi0 * xi0 + xi1 * xi1 + xi2 * xi2;
    const bool big = ang2 > 1e-24f;
    const float ang = sqrtf(big ? ang2 : 1.f);
    const float d0 = big ? cosf(0.5f * ang) : 1.f - ang2 / 8.f;
    const float sinc = big ? sinf(0.5f * ang) / ang : 0.5f - ang2 / 48.f;
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

    // slip rates and slopes (power law, f32 exponent cap 25 with linear
    // continuation above it)
    float gd[NSLIP], slope[NSLIP];
#pragma unroll
    for (int s = 0; s < NSLIP; ++s) {
        float tau = 0.f;
#pragma unroll
        for (int k = 0; k < 5; ++k) tau += P.PC[s * 5 + k] * x[k];
        const float tau_abs = fabsf(tau);
        const float ratio = tau_abs / in.g;
        const bool bg = ratio > 1e-10f;
        const float lg = P.xn * logf(bg ? ratio : 1.f);
        const float capped = nmin(lg, 25.f);
        const float over = nmax(lg - 25.f, 0.f);
        const float mag_cap = P.gdot0 * expf(capped);
        const float mag = mag_cap * (1.f + over);
        const float slope_mag = (lg < 25.f) ? P.xn * mag : P.xn * mag_cap;
        const float sgn = (tau > 0.f) ? 1.f : ((tau < 0.f) ? -1.f : tau);
        gd[s] = sgn * (bg ? mag : 0.f);
        slope[s] = bg ? slope_mag / tau_abs : 0.f;
    }

    const float dt = in.dt;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        float dp = 0.f;
#pragma unroll
        for (int s = 0; s < NSLIP; ++s) dp += P.PT[k * NSLIP + s] * gd[s];
        r[k] = x[k] - in.en[k] + dt * (dp - dlat[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float wp = 0.f;
#pragma unroll
        for (int s = 0; s < NSLIP; ++s) wp += P.QT[k * NSLIP + s] * gd[s];
        r[5 + k] = x[5 + k] - dt * (wl[k] - wp);
    }

    // kinetics blocks: J_ee = I + dt W_P slope, J_xe = dt W_Q slope
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int s = 0; s < NSLIP; ++s)
                acc += P.WP[(5 * i + j) * NSLIP + s] * slope[s];
            J[i * 8 + j] = dt * acc + (i == j ? 1.f : 0.f);
        }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int s = 0; s < NSLIP; ++s)
                acc += P.WQ[(5 * i + j) * NSLIP + s] * slope[s];
            J[(5 + i) * 8 + j] = dt * acc;
        }

    // kinematics: d(D_lat)/d xi_k ~ D_lat K_k - K_k D_lat with
    // (K_k)_ij = eps_ikj, i.e. K_0 = [[0,0,0],[0,0,-1],[0,1,0]],
    // K_1 = [[0,0,1],[0,0,0],[-1,0,0]], K_2 = [[0,-1,0],[1,0,0],[0,0,0]]
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float Km[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        if (k == 0) { Km[1][2] = -1.f; Km[2][1] = 1.f; }
        if (k == 1) { Km[0][2] = 1.f; Km[2][0] = -1.f; }
        if (k == 2) { Km[0][1] = -1.f; Km[1][0] = 1.f; }
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
        float v[5];
        mat_to_vecd(C, v);
#pragma unroll
        for (int i = 0; i < 5; ++i) J[i * 8 + 5 + k] = -dt * v[i];
    }
    // d(w_lat)_i/d xi_j ~ sum_l eps_ilj w_lat_l
    J[5 * 8 + 5] = 1.f;
    J[5 * 8 + 6] = -dt * (-wl[2]);
    J[5 * 8 + 7] = -dt * (wl[1]);
    J[6 * 8 + 5] = -dt * (wl[2]);
    J[6 * 8 + 6] = 1.f;
    J[6 * 8 + 7] = -dt * (-wl[0]);
    J[7 * 8 + 5] = -dt * (-wl[1]);
    J[7 * 8 + 6] = -dt * (wl[0]);
    J[7 * 8 + 7] = 1.f;
}

// Newton step: out = A^-1 b by row-equilibrated Gauss-Jordan with partial
// pivoting (first row of largest magnitude, strict > keeps the first)
__device__ void solve8(const float A[64], const float b[8], float out[8]) {
    float M[8][9];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float rmax = fabsf(A[i * 8]);
#pragma unroll
        for (int j = 1; j < 8; ++j) rmax = nmax(rmax, fabsf(A[i * 8 + j]));
        const float rs = 1.f / nmax(rmax, 1e-37f);
#pragma unroll
        for (int j = 0; j < 8; ++j) M[i][j] = A[i * 8 + j] * rs;
        M[i][8] = b[i] * rs;
    }
#pragma unroll
    for (int col = 0; col < 8; ++col) {
        float best = fabsf(M[col][col]);
        int piv = col;
#pragma unroll
        for (int row = col + 1; row < 8; ++row) {
            const float v = fabsf(M[row][col]);
            if (v > best) { best = v; piv = row; }
        }
        // swap rows col <-> piv as predicated selects
#pragma unroll
        for (int row = col + 1; row < 8; ++row) {
            const bool sw = (row == piv);
#pragma unroll
            for (int j = col; j < 9; ++j) {
                const float a = M[col][j], c = M[row][j];
                M[col][j] = sw ? c : a;
                M[row][j] = sw ? a : c;
            }
        }
        const float pv = M[col][col];
#pragma unroll
        for (int j = col; j < 9; ++j) M[col][j] = M[col][j] / pv;
#pragma unroll
        for (int row = 0; row < 8; ++row) {
            if (row == col) continue;
            const float f = M[row][col];
#pragma unroll
            for (int j = col; j < 9; ++j) M[row][j] = M[row][j] - f * M[col][j];
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = M[i][8];
}

__global__ void __launch_bounds__(128)
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
                   int N, const DoglegParams P) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const float tiny = 1.17549435e-38f;  // f32 smallest normal

    PointIn in;
    {
        float dv[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) dv[k] = d_vecd[k * N + n];
        // vecd_to_mat (BASIS_DEV^T t)
        in.D[0][0] = SQR2I * dv[0] - SQR6I * dv[1];
        in.D[1][1] = -SQR2I * dv[0] - SQR6I * dv[1];
        in.D[2][2] = 2.f * SQR6I * dv[1];
        in.D[0][1] = in.D[1][0] = SQR2I * dv[2];
        in.D[0][2] = in.D[2][0] = SQR2I * dv[3];
        in.D[1][2] = in.D[2][1] = SQR2I * dv[4];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) in.w[k] = w_sm[k * N + n];
#pragma unroll
    for (int k = 0; k < 5; ++k) in.en[k] = e_n[k * N + n];
#pragma unroll
    for (int k = 0; k < 4; ++k) in.qn[k] = q_n[k * N + n];
    in.g = g[n];
    in.dt = dts[n];

    float x[8], r[8], J[64];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = x0[k * N + n];
    resjac(P, in, x, r, J);
    bool done = (safe_sqrt(dot8(r, r)) < P.tol) || !active[n];
    float delta = 1.f;
    int iters = 0;

    for (int it = 0; it < P.max_iter && !done; ++it) {
        // Newton step, zeroed when any component is non-finite
        float pn[8];
        solve8(J, r, pn);
        const bool pn_ok = finite8(pn);
#pragma unroll
        for (int i = 0; i < 8; ++i) pn[i] = pn_ok ? -pn[i] : 0.f;
        const float pn_norm = safe_sqrt(dot8(pn, pn));

        // Cauchy point along g = J^T r
        float gv[8], Jg[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) s += J[k * 8 + i] * r[k];
            gv[i] = s;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) s += J[i * 8 + k] * gv[k];
            Jg[i] = s;
        }
        const float alpha = dot8(gv, gv) / nmax(dot8(Jg, Jg), tiny);
        float pc[8], dd[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            pc[i] = -alpha * gv[i];
            dd[i] = pn[i] - pc[i];
        }
        const float pc_norm = safe_sqrt(dot8(pc, pc));

        // dogleg blend on the trust-region boundary
        const float a = dot8(dd, dd);
        const float b = 2.f * dot8(pc, dd);
        const float c = dot8(pc, pc) - delta * delta;
        const float disc = nmax(b * b - 4.f * a * c, 0.f);
        float beta = (-b + safe_sqrt(disc)) / nmax(2.f * a, tiny);
        beta = nmin(nmax(beta, 0.f), 1.f);
        const float desc = delta / nmax(safe_sqrt(dot8(gv, gv)), tiny);
        const bool use_newton = pn_norm <= delta;
        const bool use_desc = pc_norm >= delta;
        float p[8], xt[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float p_tr = use_desc ? -desc * gv[i] : pc[i] + beta * dd[i];
            p[i] = use_newton ? pn[i] : p_tr;
            xt[i] = x[i] + p[i];
        }

        float rt[8], Jt[64];
        resjac(P, in, xt, rt, Jt);
        const float phi = 0.5f * dot8(r, r);
        const float phi_t = 0.5f * dot8(rt, rt);
        float lin[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float s = r[i];
#pragma unroll
            for (int k = 0; k < 8; ++k) s += J[i * 8 + k] * p[k];
            lin[i] = s;
        }
        const float pred = phi - 0.5f * dot8(lin, lin);
        const float rho = (phi - phi_t) / nmax(pred, tiny);
        const bool finite = finite8(rt);
        if (finite && rho > 1e-4f) {
#pragma unroll
            for (int i = 0; i < 8; ++i) { x[i] = xt[i]; r[i] = rt[i]; }
#pragma unroll
            for (int i = 0; i < 64; ++i) J[i] = Jt[i];
        }

        // radius: x2 (cap 1e4) on a good long step, 0.25|p| on a poor
        // one, 0.1|p| on a bad or non-finite one, floor 1e-12
        const float p_norm = safe_sqrt(dot8(p, p));
        const bool grow = (rho > 0.8f) && (p_norm > 0.9f * delta);
        const bool shrink = !finite || (rho < 0.25f);
        const float factor = (!finite || rho < 0.f) ? 0.1f : 0.25f;
        float dn = grow ? nmin(2.f * delta, 1e4f) : delta;
        if (shrink) dn = nmax(factor * p_norm, 1e-12f);
        delta = dn;

        ++iters;
        done = safe_sqrt(dot8(r, r)) < P.tol;
    }

#pragma unroll
    for (int k = 0; k < 8; ++k) x_out[k * N + n] = x[k];
#pragma unroll
    for (int k = 0; k < 64; ++k) j_out[k * N + n] = J[k];
    ok_out[n] = done ? 1 : 0;
    it_out[n] = iters;
}

extern "C" int dogleg_voce_f32(const float* d_vecd, const float* w_sm,
                               const float* e_n, const float* q_n,
                               const float* g, const float* dts,
                               const float* x0, const uint8_t* active,
                               float* x_out, float* j_out, uint8_t* ok_out,
                               int* it_out, int N, const DoglegParams* params,
                               void* stream) {
    if (N <= 0) return 0;
    const int threads = 128;
    const int blocks = (N + threads - 1) / threads;
    dogleg_voce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        d_vecd, w_sm, e_n, q_n, g, dts, x0, active, x_out, j_out, ok_out,
        it_out, N, *params);
    return (int)cudaGetLastError();
}

extern "C" int dogleg_voce_params_size() { return (int)sizeof(DoglegParams); }
