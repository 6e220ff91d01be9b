// The partial-assembly (PA) operator apply y = K x on an index map, in
// two launches (sm_90a), for float and double.
//
// Replaces no TPU kernel: the JAX package leaves this apply to XLA
// (exaconstit_tpu/fem/operators.py::apply_pa_gradient_cm).  It was added
// because the port's eager apply ran at 4.4 % of its bound on the card:
// about twenty launches a call (the gather, two contractions with their
// permute copies, the 81 x nq x ne product written out whole and summed,
// the scatter's slot-by-slot adds), the card idle three quarters of the
// apply's time.  The plain version of the same function is
// fem/operators.py::apply_pa_gradient_cm followed by
// fem/space.py::IndexMap.scatter_add; fem/pa_apply_cuda.py wraps both.
//
// What it computes, for order-1 hexes (8 nodes, 2x2x2 points), with the
// point tensor D[i,s,k,t,q,e] stored component-major and contiguous
// (element fastest):
//   element pass: u[k,b] = x[k, conn_t[b, e]];  at each point q,
//     h[k,t] = sum_b u[k,b] dN[q,b,t],  t[i,s] = sum_{k,t} D[i,s,k,t] h[k,t],
//     el_y[i,a,e] = sum_q sum_s dN[q,a,s] t[i,s]   (q summed 0..7 in order);
//   node pass: y[i,n] = sum over the incidence table's slots k of
//     el_y[i, table[k,n]], slot after slot from k = 0, a pad slot
//     (index >= nen*ne) read as zero: IndexMap.scatter_add's order and
//     operations, so for a given el_y the scatter is bitwise the plain
//     one, with no atomics, and repeated calls are bitwise equal.
//
// What bounds it on Hopper: bytes.  A point needs about 450 operations
// against 81 entries of D (324 bytes in f32), far below the card's
// ridge; at 32^3 D is 85 MB in f32 (170 MB in f64), x, y and the index
// tables about 5 MB more, so the least time is some 27 us in f32 at
// 3.35 TB/s.  No tensor cores.
//
// What the design does about it:
// - One thread per element, its 8 points in a loop: the element's u is
//   gathered once into registers (24 loads through conn_t, x in L2), its
//   24 outputs summed over q in registers in a fixed order, and only
//   el_y (3 x 8 x ne) is written: none of the element's work but its
//   result goes to device memory.  dN (8 x 8 x 3) sits in shared memory.
// - D is read once, every load coalesced: the 32 lanes of a warp read 32
//   consecutive elements of one row of D, and a point's 81 rows are
//   independent loads the compiler issues ahead of their use (128 to 254
//   registers, no spills), with the streaming hint (D is too large for
//   L2 to keep between applies).  At 32^3 that is 256 blocks of 128
//   threads, two per SM, and the loads in flight are enough: measured on
//   an H100 against one thread per (point, element) with the q sum in
//   shared memory (1,024 blocks in f32), this design ran 30.8 against
//   33.6 us in f32 and 50.4 against 70.3 us in f64.
// - The node pass is one thread per node for the three components, the
//   table read once; el_y (3 MB in f32) stays in L2 between the passes.
// - Both passes launch on the caller's stream and do not synchronise;
//   each launch's error is returned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEN = 8;   // nodes of an order-1 hex
constexpr int NQ = 8;    // its 2x2x2 Gauss points
constexpr int NR = 3 * NEN;  // rows (i, a) of an element vector
constexpr int ETHREADS = 128;
constexpr int NODE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ETHREADS)
pa_element_kernel(const T* __restrict__ D, const T* __restrict__ dshape,
                  const T* __restrict__ x,
                  const long long* __restrict__ conn_t,
                  T* __restrict__ el_y, int ne, int nn) {
    __shared__ T dN[NQ * NEN * 3];
    for (int j = threadIdx.x; j < NQ * NEN * 3; j += blockDim.x)
        dN[j] = dshape[j];
    __syncthreads();
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= ne) return;
    T u[NR], y[NR];
#pragma unroll
    for (int b = 0; b < NEN; ++b) {
        const long long n = conn_t[(size_t)b * ne + e];
#pragma unroll
        for (int k = 0; k < 3; ++k) u[k * NEN + b] = x[(size_t)k * nn + n];
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) y[r] = T(0);
    const size_t stride = (size_t)NQ * ne;
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
        const T* dq = dN + q * NEN * 3;
        T h[9];
#pragma unroll
        for (int kt = 0; kt < 9; ++kt) {
            const int k = kt / 3, t = kt % 3;
            T s = T(0);
#pragma unroll
            for (int b = 0; b < NEN; ++b) s += u[k * NEN + b] * dq[b * 3 + t];
            h[kt] = s;
        }
        const T* Dp = D + (size_t)q * ne + e;
        T tt[9];
#pragma unroll
        for (int is = 0; is < 9; ++is) {
            T s = T(0);
#pragma unroll
            for (int kt = 0; kt < 9; ++kt)
                s += __ldcs(Dp + (is * 9 + kt) * stride) * h[kt];
            tt[is] = s;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int a = 0; a < NEN; ++a)
                y[i * NEN + a] += dq[a * 3] * tt[i * 3]
                    + dq[a * 3 + 1] * tt[i * 3 + 1]
                    + dq[a * 3 + 2] * tt[i * 3 + 2];
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) el_y[(size_t)r * ne + e] = y[r];
}

template <typename T>
__global__ void __launch_bounds__(NODE_THREADS)
pa_node_kernel(const T* __restrict__ el_y,
               const long long* __restrict__ table, T* __restrict__ y,
               int nn, int valence, long long nslots) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= nn) return;
    T acc[3];
    for (int k = 0; k < valence; ++k) {
        const long long idx = table[(size_t)k * nn + n];
        const bool pad = idx >= nslots;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const T v = pad ? T(0) : el_y[i * nslots + idx];
            acc[i] = k == 0 ? v : acc[i] + v;
        }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) y[(size_t)i * nn + n] = acc[i];
}

template <typename T>
int launch(const T* D, const T* dshape, const T* x, const long long* conn_t,
           const long long* table, T* el_y, T* y, int ne, int nn,
           int valence, void* stream) {
    if (ne <= 0 || nn <= 0 || valence <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    pa_element_kernel<T><<<(ne + ETHREADS - 1) / ETHREADS, ETHREADS, 0, s>>>(
        D, dshape, x, conn_t, el_y, ne, nn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pa_node_kernel<T><<<(nn + NODE_THREADS - 1) / NODE_THREADS,
                        NODE_THREADS, 0, s>>>(
        el_y, table, y, nn, valence, (long long)NEN * ne);
    return (int)cudaGetLastError();
}

template <typename K>
int info(K kernel, int threads, int* regs, int* local_bytes,
         int* shared_bytes, int* blocks_per_sm) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *shared_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, 0);
}

}  // namespace

// D (81, 8, ne) and dshape (8, 8, 3) contiguous in the type; x and y
// (3, nn); conn_t (8, ne) and table (valence, nn) int64; el_y (3, 8, ne)
// scratch the element pass writes and the node pass reads
extern "C" int pa_apply_f32(const float* D, const float* dshape,
                            const float* x, const long long* conn_t,
                            const long long* table, float* el_y, float* y,
                            int ne, int nn, int valence, void* stream) {
    return launch<float>(D, dshape, x, conn_t, table, el_y, y, ne, nn,
                         valence, stream);
}

extern "C" int pa_apply_f64(const double* D, const double* dshape,
                            const double* x, const long long* conn_t,
                            const long long* table, double* el_y, double* y,
                            int ne, int nn, int valence, void* stream) {
    return launch<double>(D, dshape, x, conn_t, table, el_y, y, ne, nn,
                          valence, stream);
}

// registers and local (stack and spill) bytes per thread, static shared
// bytes, resident blocks per SM and threads per block of one kernel, as
// the runtime reports them: which = 0 element pass f32, 1 element pass
// f64, 2 node pass f32, 3 node pass f64
extern "C" int pa_apply_build_info(int which, int* regs, int* local_bytes,
                                   int* shared_bytes, int* blocks_per_sm,
                                   int* threads) {
    switch (which) {
    case 0:
        *threads = ETHREADS;
        return info(pa_element_kernel<float>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    case 1:
        *threads = ETHREADS;
        return info(pa_element_kernel<double>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    case 2:
        *threads = NODE_THREADS;
        return info(pa_node_kernel<float>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    case 3:
        *threads = NODE_THREADS;
        return info(pa_node_kernel<double>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
