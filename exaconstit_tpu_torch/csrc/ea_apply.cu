// The element-assembled (EA) operator apply y = K x on the strided map of
// a voxel brick, in two launches (sm_90a): f32 blocks with f32 or f64
// vectors, and f64 blocks with f64 vectors.
//
// Replaces no TPU kernel: the JAX package leaves this apply to XLA
// (exaconstit_tpu/fem/operators.py::apply_ea_gradient_cm).  It was added
// because the port's eager apply ran at 2-4 % of its bound on the card:
// cuBLAS's batched GEMV took a permuted, contiguous copy of all the
// blocks at every call (75.5 MB read and written at 32^3 in f32), then
// the GEMV, 8 strided slices stacked for the gather and 8 strided adds
// for the scatter; nine such applies ran inside every V-cycle.  The plain
// version of the same function is fem/operators.py::apply_ea;
// fem/ea_apply_cuda.py wraps both.
//
// What it computes, for order-1 hexes on an (nx, ny, nz) grid with
// x-fastest node and element numbering (fem/space.py::StructuredMap), the
// blocks K[(a,i), (b,k), e] stored (24, 24, ne) contiguous (element
// fastest), dof a*3 + i for local node a = li + 2 lj + 4 lk:
//   element pass: u[b*3+k] = x[k, node(e, b)] through the grid's strides;
//     el_y[i, a, e] = sum_c K[a*3+i, c, e] u[c], the 24 columns summed
//     in order from c = 0 in double, each entry of K and u promoted
//     exactly and each product and sum rounded on its own (no fused
//     multiply-add), then rounded once to x's type: utils/tensors.py::
//     fixed_dot over the columns, bit for bit;
//   node pass: y[i, n] = sum over the local nodes a = 0..7 of the
//     elements holding n, ascending, of el_y[i, a, e], from zero in x's
//     type: StructuredMap.scatter_add's order and operations, so for a
//     given el_y the scatter is bitwise the plain one, with no atomics,
//     and repeated calls are bitwise equal.
//
// What bounds it on Hopper: bytes.  An element's 576 block entries carry
// 1,152 operations, about 0.5 an f32 byte, far below the card's ridge; at
// 32^3 the f32 blocks are 75.5 MB (151 MB in f64), the vectors under
// 1 MB, so the least time is some 22.8 us at 3.35 TB/s.  No tensor cores.
//
// What the design does about it:
// - The blocks are read in place, once, every load coalesced: a warp's
//   lanes take 32 consecutive elements, so they read 32 consecutive
//   entries of one (row, column) of K, with the streaming hint (the
//   blocks are too large for L2 to keep between applies).  No copy of
//   the blocks is made at any precision: f32 blocks meet an f64 x in
//   registers.
// - Eight threads per element, one per local node a, each summing the
//   element's three rows a*3 + i in registers: 262,144 threads at 32^3,
//   enough warps in flight per SM to keep the loads of K streaming
//   (each thread's 72 loads are independent, issued ahead of their use).
//   u is gathered by each of the eight (24 loads of x, which stays in L1
//   and L2), and only el_y (3 x 8 x ne, in L2 between the passes) goes
//   to device memory.  Measured on an H100 at 32^3 (element and node
//   pass, us, f32 / f32 blocks with f64 x / f64): this design 27.3 + 3.6
//   / 27.1 + 3.5 / 50.1 + 3.5; three threads per element (one per
//   component, eight rows each) 28.9 + 3.3 / 27.1 + 3.8 / 50.4 + 3.6;
//   one thread per element (all 24 rows, 32,768 threads) 69.2 + 3.5 /
//   57.9 + 3.9 / 75.0 + 3.8; and one pass of one thread per node
//   computing its own three rows of each element that holds it, with no
//   element scratch, 45.3 / 49.1 / 79.1.
// - The node pass is one thread per node for its three components.
// - Both passes launch on the caller's stream, allocate nothing and never
//   synchronise, so that they can be captured in a CUDA graph; each
//   launch's error is returned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEN = 8;   // nodes of an order-1 hex
constexpr int NDOF = 3 * NEN;  // rows and columns of a block
constexpr int ETHREADS = 128;
constexpr int NODE_THREADS = 256;

// the grid of an apply: elements (nx, ny, nz), nodes (nx+1, ny+1, nz+1)
struct Grid {
    int nx, ny, nz;
    __host__ __device__ int ne() const { return nx * ny * nz; }
    __host__ __device__ int nn() const {
        return (nx + 1) * (ny + 1) * (nz + 1);
    }
};

// the element pass: one thread for each (element, local node a), its
// three rows a*3 + i; blockIdx.y is a
template <typename TK, typename T>
__global__ void __launch_bounds__(ETHREADS)
ea_element_kernel(const TK* __restrict__ K, const T* __restrict__ x,
                  T* __restrict__ el_y, Grid g) {
    const int ne = g.ne();
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= ne) return;
    const int a = blockIdx.y;
    const int nxp = g.nx + 1, plane = nxp * (g.ny + 1), nn = g.nn();
    const int ex = e % g.nx, t = e / g.nx;
    const int n0 = ex + nxp * (t % g.ny) + plane * (t / g.ny);
    double u[NDOF];
#pragma unroll
    for (int b = 0; b < NEN; ++b) {
        const int n = n0 + (b & 1) + nxp * ((b >> 1) & 1) + plane * (b >> 2);
#pragma unroll
        for (int k = 0; k < 3; ++k)
            u[b * 3 + k] = (double)x[(size_t)k * nn + n];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const TK* row = K + (size_t)(a * 3 + i) * NDOF * ne + e;
        double s = __dmul_rn((double)__ldcs(row), u[0]);
#pragma unroll
        for (int c = 1; c < NDOF; ++c)
            s = __dadd_rn(s, __dmul_rn((double)__ldcs(row + (size_t)c * ne),
                                       u[c]));
        el_y[(size_t)(i * NEN + a) * ne + e] = (T)s;
    }
}

template <typename T>
__global__ void __launch_bounds__(NODE_THREADS)
ea_node_kernel(const T* __restrict__ el_y, T* __restrict__ y, Grid g) {
    const int nn = g.nn();
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= nn) return;
    const int nxp = g.nx + 1, nyp = g.ny + 1, ne = g.ne();
    const int px = n % nxp, t = n / nxp, py = t % nyp, pz = t / nyp;
    T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int a = 0; a < NEN; ++a) {
        const int ex = px - (a & 1), ey = py - ((a >> 1) & 1),
                  ez = pz - (a >> 2);
        if (ex < 0 || ex >= g.nx || ey < 0 || ey >= g.ny || ez < 0
            || ez >= g.nz)
            continue;
        const int e = ex + g.nx * (ey + g.ny * ez);
#pragma unroll
        for (int i = 0; i < 3; ++i)
            acc[i] = acc[i] + el_y[(size_t)(i * NEN + a) * ne + e];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) y[(size_t)i * nn + n] = acc[i];
}

template <typename TK, typename T>
int launch(const TK* K, const T* x, T* el_y, T* y, int nx, int ny, int nz,
           void* stream) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
    const Grid g{nx, ny, nz};
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((g.ne() + ETHREADS - 1) / ETHREADS, NEN);
    ea_element_kernel<TK, T><<<grid, ETHREADS, 0, s>>>(K, x, el_y, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ea_node_kernel<T><<<(g.nn() + NODE_THREADS - 1) / NODE_THREADS,
                        NODE_THREADS, 0, s>>>(el_y, y, g);
    return (int)cudaGetLastError();
}

template <typename Kern>
int info(Kern kernel, int threads, int* regs, int* local_bytes,
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

// K (24, 24, ne) contiguous, ne = nx*ny*nz; x and y (3, nn), nn =
// (nx+1)(ny+1)(nz+1), in x's type; el_y (3, 8, ne) scratch the element
// pass writes and the node pass reads
extern "C" int ea_apply_f32(const float* K, const float* x, float* el_y,
                            float* y, int nx, int ny, int nz, void* stream) {
    return launch<float, float>(K, x, el_y, y, nx, ny, nz, stream);
}

extern "C" int ea_apply_f32_f64(const float* K, const double* x,
                                double* el_y, double* y, int nx, int ny,
                                int nz, void* stream) {
    return launch<float, double>(K, x, el_y, y, nx, ny, nz, stream);
}

extern "C" int ea_apply_f64(const double* K, const double* x, double* el_y,
                            double* y, int nx, int ny, int nz,
                            void* stream) {
    return launch<double, double>(K, x, el_y, y, nx, ny, nz, stream);
}

// registers and local (stack and spill) bytes per thread, static shared
// bytes, resident blocks per SM and threads per block of one kernel, as
// the runtime reports them: which = 0, 1, 2 the element pass of f32
// blocks with f32 x, f32 blocks with f64 x, f64 blocks with f64 x; 3, 4
// the node pass in f32, f64
extern "C" int ea_apply_build_info(int which, int* regs, int* local_bytes,
                                   int* shared_bytes, int* blocks_per_sm,
                                   int* threads) {
    switch (which) {
    case 0:
        *threads = ETHREADS;
        return info(ea_element_kernel<float, float>, *threads, regs,
                    local_bytes, shared_bytes, blocks_per_sm);
    case 1:
        *threads = ETHREADS;
        return info(ea_element_kernel<float, double>, *threads, regs,
                    local_bytes, shared_bytes, blocks_per_sm);
    case 2:
        *threads = ETHREADS;
        return info(ea_element_kernel<double, double>, *threads, regs,
                    local_bytes, shared_bytes, blocks_per_sm);
    case 3:
        *threads = NODE_THREADS;
        return info(ea_node_kernel<float>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    case 4:
        *threads = NODE_THREADS;
        return info(ea_node_kernel<double>, *threads, regs, local_bytes,
                    shared_bytes, blocks_per_sm);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
