// Fused ARD-RBF unit gram for NVIDIA Hopper (sm_90a):
//
//     E[a, b] = exp(-1/2 * max(|u_a|^2 + |v_b|^2 - 2 u_a . v_b, 0))
//
// for row-major float32 u (A, M) and v (B, M), written to a row-major (A, B)
// output.
//
// Replaces romcomma_tpu/ops/pallas_kernels.py::_gram_kernel (the TPU tile
// kernel launched by _unit_gram_impl). As there, the row norms, the cross
// term and the exp epilogue are fused into one pass, so no (A, B) cross-term
// intermediate ever reaches device memory.
//
// What bounds it: at the main path's M = 30 the kernel does about 2M + 10
// flop for every 4-byte output, i.e. ~17 flop per byte stored. That sits near
// the H100's float32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, ~20 flop per
// byte), so the A*B*4-byte store stream is the main cost and the arithmetic a
// close second. The design keeps every input read on chip: a block stages
// 32-column chunks of its 64 u rows and 64 v rows in shared memory and each
// thread accumulates a 4x4 micro-tile of dot products plus its rows' and
// columns' squared norms in float32 FMAs on the CUDA cores. That is true
// float32, the counterpart of the TPU kernel's Precision.HIGHEST; TF32 tensor
// cores would cost about three decimal digits of the gram.
//
// Ragged A, B and M are masked inside the kernel: no padding of the inputs and
// no slicing of the output.
//
// Later work: a wgmma/TMA pipeline (3xTF32 or split-float for the cross term)
// and fusing the gram into the Cholesky's input, so the (A, B) gram is never
// stored on its own.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int TILE = 64;             // rows of u and of v per block
constexpr int CHUNK = 32;            // columns of M staged per step
constexpr int THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int SIDE = 16;
constexpr int MICRO = TILE / SIDE;   // 4

__global__ void __launch_bounds__(THREADS)
unit_gram_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 float* __restrict__ out, int A, int B, int M) {
    // Chunks are stored k-major; the +1 pad makes the transposing stores
    // conflict-free (consecutive k land in consecutive banks).
    __shared__ float us[CHUNK][TILE + 1];
    __shared__ float vs[CHUNK][TILE + 1];

    const int tx = threadIdx.x % SIDE;   // output column within the micro-grid
    const int ty = threadIdx.x / SIDE;   // output row within the micro-grid
    const int a0 = blockIdx.x * TILE;
    const int b0 = blockIdx.y * TILE;

    float uv[MICRO][MICRO];
    float uu[MICRO], vv[MICRO];
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
        uu[i] = 0.f;
        vv[i] = 0.f;
#pragma unroll
        for (int j = 0; j < MICRO; ++j) uv[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < M; k0 += CHUNK) {
        // Consecutive threads read consecutive columns of one row: coalesced.
        for (int idx = threadIdx.x; idx < TILE * CHUNK; idx += THREADS) {
            const int r = idx / CHUNK;
            const int k = idx % CHUNK;
            const int col = k0 + k;
            const int ra = a0 + r;
            const int rb = b0 + r;
            us[k][r] = (ra < A && col < M) ? u[static_cast<size_t>(ra) * M + col] : 0.f;
            vs[k][r] = (rb < B && col < M) ? v[static_cast<size_t>(rb) * M + col] : 0.f;
        }
        __syncthreads();

#pragma unroll 8
        for (int k = 0; k < CHUNK; ++k) {
            float a[MICRO], b[MICRO];
#pragma unroll
            for (int i = 0; i < MICRO; ++i) {
                a[i] = us[k][ty + SIDE * i];
                b[i] = vs[k][tx + SIDE * i];
            }
#pragma unroll
            for (int i = 0; i < MICRO; ++i) {
                uu[i] = fmaf(a[i], a[i], uu[i]);
                vv[i] = fmaf(b[i], b[i], vv[i]);
#pragma unroll
                for (int j = 0; j < MICRO; ++j) uv[i][j] = fmaf(a[i], b[j], uv[i][j]);
            }
        }
        __syncthreads();
    }

    // Neighbouring threads store neighbouring columns of one row.
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
        const int row = a0 + ty + SIDE * i;
        if (row >= A) continue;
#pragma unroll
        for (int j = 0; j < MICRO; ++j) {
            const int col = b0 + tx + SIDE * j;
            if (col < B) {
                const float sqd = fmaxf(uu[i] + vv[j] - 2.f * uv[i][j], 0.f);
                out[static_cast<size_t>(row) * B + col] = expf(-0.5f * sqd);
            }
        }
    }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess). The caller allocates `out` and has checked the shapes.
extern "C" int unit_gram_f32(const float* u, const float* v, float* out,
                             int A, int B, int M, cudaStream_t stream) {
    const dim3 grid((A + TILE - 1) / TILE, (B + TILE - 1) / TILE);
    unit_gram_kernel<<<grid, THREADS, 0, stream>>>(u, v, out, A, B, M);
    return static_cast<int>(cudaGetLastError());
}
