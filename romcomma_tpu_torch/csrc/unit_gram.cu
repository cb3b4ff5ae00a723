// Fused ARD-RBF unit gram for NVIDIA Hopper (sm_90a):
//
//     E[a, b] = exp(-1/2 * max(|u_a|^2 + |v_b|^2 - 2 u_a . v_b, 0))
//
// for row-major float32 u (A, M) and v (B, M), written to a row-major (A, B)
// output; or, in one launch, for each member of a batch of such pairs,
// u (batch, A, M) and v (batch, B, M) into (batch, A, B).
//
// Replaces romcomma_tpu/ops/pallas_kernels.py::_gram_kernel (the TPU tile
// kernel launched by _unit_gram_impl). As there, the row norms, the cross
// term and the exp epilogue are fused, so no (A, B) intermediate ever reaches
// device memory. The batch is the counterpart of the grid axis that JAX's
// vmap adds to the pallas_call: romcomma_tpu vmaps the LML over outputs and
// folds, and so builds all the training grams of a fold group in one launch.
//
// What bounds it. At the main path's shapes (A = B = 4096 or 8192, M = 30)
// the inputs are under 1 MB and the output is A*B*4 bytes: storing it takes
// 20 us at 4096^2 and 80 us at 8192^2 at the H100's 3.35 TB/s. The 2M + 10
// flop per output would take 70 us at 8192^2 on the float32 CUDA cores
// (67 TFLOP/s), right at that ridge, so an FMA cross term and the stores
// compete. The design moves the arithmetic off the CUDA cores and keeps the
// store stream busy:
//
// 1. A pack pre-pass, once per row of u and of v (not once per tile), splits
//    each input into x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
//    (cvt.rna), zero-pads M to chunks of 32, and lays each 128-row block out
//    in the wgmma core-matrix order (8 rows x 16 bytes, no swizzle).
// 2. The cross term runs on the tensor cores as 3xTF32: u.v ~ hi.hi + (hi.lo
//    + lo.hi), by wgmma.m64n128k8.f32.tf32.tf32 into two float32
//    accumulators, hi.hi in one and the small terms in the other. The dropped
//    lo.lo term is ~2^-22 of each product, the counterpart of the TPU
//    kernel's Precision.HIGHEST (a single TF32 pass keeps about three
//    digits). Any M works: the kernel loops over 32-column chunks.
//    The tensor cores truncate as they accumulate, a few float32 ulps of
//    |u.v| per wgmma. Against squared norms taken in float32 FMAs, that bias
//    survives the cancellation |u|^2 + |v|^2 - 2 u.v where u_a ~ v_b: on the
//    H100 it put the diagonal of a training gram (u is v) outside the 2e-6
//    tolerance against the plain float32 version. So the squared norms come
//    from the same MMAs: the pre-pass runs each block's diagonal tile (I, I)
//    and keeps u_a . u_a. The diagonal then cancels to exactly 0 (E = 1),
//    and near pairs cancel to an error relative to their distance.
// 3. Persistent CTAs, one per SM, each walking a contiguous run of 128x128
//    output tiles in row-major order, member after member of a batch. One producer warp brings each tile's
//    packed operands and norms into shared memory with bulk async copies
//    (cp.async.bulk on an mbarrier), and skips u's block when the tile row has
//    not changed.
//    Two consumer warpgroups each own 64 rows of the tile.
// 4. The epilogue forms max(|u|^2 + |v|^2 - 2 u.v, 0) and E with ex2.approx
//    on the pre-scaled argument (relative error ~2^-22, well inside the
//    2e-6 tolerance), writes E into a 128B-swizzled staging buffer in shared
//    memory, and hands it to a TMA store (cp.async.bulk.tensor ... bulk_group).
//    Each warpgroup has two staging buffers, so tile t's store drains while
//    tile t+1's MMA and epilogue run. Where the output rows are not 16-byte
//    multiples (B % 4 != 0) or the output is smaller than one store box, the
//    same kernel stores E from registers with masked scalar stores instead.
//
// The C entry launches the pre-pass and the kernel on the caller's stream and
// returns cudaGetLastError(); the caller allocates the output and the packed
// scratch of each operand: ceil(rows / 128) * (ceil(M / 32) * 8192 + 128)
// floats per member, the hi/lo chunks of every 128-row block and then one
// norm per padded row, the members one after the other. Every offset of a
// member into the operands, the scratch and the output is size_t.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128;                         // output rows per tile (2 warpgroups x 64)
constexpr int BN = 128;                         // output columns per tile
constexpr int KC = 32;                          // columns of M per chunk: 4 wgmma k-steps of 8
constexpr int KSTEPS = KC / 8;
constexpr int PART_FLOATS = BM * KC;            // hi (or lo) of one 128-row chunk: 16 KB
constexpr int BLOCK_FLOATS = 2 * PART_FLOATS;   // hi then lo: 32 KB
constexpr int BLOCK_BYTES = BLOCK_FLOATS * 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // 2 consumer warpgroups + 1 producer warp
constexpr int HALF_ROWS = BM / 2;               // rows of one warpgroup
constexpr int BOX_COLS = 32;                    // TMA store box: 32 floats = the 128 B swizzle span
constexpr int BOX_FLOATS = HALF_ROWS * BOX_COLS;
constexpr int STAGE_FLOATS = HALF_ROWS * BN;    // one warpgroup's half tile: 32 KB
constexpr float HALF_LOG2E = 0.72134752044448170f;

// Core-matrix layout of a packed chunk: element (row, k) of a 128-row block
// sits at ((k/8 * 2 + k/4 % 2) * 16 + row/8) * 32 + row%8 * 4 + k%4. A core
// matrix is 8 rows x 4 floats (128 B); the two K halves of one k-step are
// K_HALF_BYTES apart and neighbouring 8-row groups ROW_GROUP_BYTES apart.
constexpr uint32_t ROW_GROUP_BYTES = 128;
constexpr uint32_t K_HALF_BYTES = 16 * 128;
constexpr uint32_t KSTEP_BYTES = 2 * K_HALF_BYTES;

struct Shared {
    float out[2][2][STAGE_FLOATS];   // [warpgroup][buffer], 1024-byte aligned for the swizzle
    float u[BLOCK_FLOATS];           // hi then lo of u's 128-row block
    float v[BLOCK_FLOATS];           // hi then lo of v's 128-row block
    float uu[2][BM];                 // squared norms of the tile's u rows, by tile parity
    float vv[2][BN];                 // and of its v rows
    uint64_t full;                   // operands landed (producer -> consumers)
    uint64_t empty;                  // operands consumed (consumers -> producer)
};
constexpr size_t SHARED_BYTES = sizeof(Shared) + 1024;   // room to align the base

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// log2 E = -1/2 log2(e) * max(|u|^2 + |v|^2 - 2 u.v, 0).
__device__ __forceinline__ float unit_exp2_arg(float uv, float norms) {
    return fmaxf(fmaf(-2.f, uv, norms), 0.f) * -HALF_LOG2E;
}

// ---- mbarriers and bulk copies -------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect_bytes(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The output is written once and not read back by this kernel: mark its
// lines first to leave L2, so they do not push the operands out.
// The output is (batch, A, B): the box's third coordinate is the member.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const float* src, int col, int row,
                                          int member) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3, %4}], [%1], %5;"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(col), "r"(row),
                    "r"(member), "l"(policy)
                 : "memory");
}

__device__ __forceinline__ void store_shared2(const float* p, float a, float b) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" :: "r"(smem_addr(p)), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ float load_shared(const float* p) {
    float a;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(a) : "r"(smem_addr(p)) : "memory");
    return a;
}

__device__ __forceinline__ float2 load_shared2(const float* p) {
    float2 a;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(a.x), "=f"(a.y) : "r"(smem_addr(p)) : "memory");
    return a;
}

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between the two K halves (leading) and between 8-row groups
// (stride), all in 16-byte units.
__device__ __forceinline__ uint64_t describe(const float* p) {
    return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(K_HALF_BYTES >> 4) << 16
         | static_cast<uint64_t>(ROW_GROUP_BYTES >> 4) << 32;
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, float32, spread over the warpgroup) += A (64 x 8) . B (128 x 8)^T,
// both K-major tf32 in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// One 32-column chunk of the cross term for warpgroup g's 64 rows against all
// 128 rows of the other block, both packed in shared memory (hi part first,
// lo part PART_FLOATS after it):
//     d += hi_u . hi_v,    small += hi_u . lo_v + lo_u . hi_v,
// restarting both sums when `first`. The tensor cores truncate as they
// accumulate (a few float32 ulps of the running sum per wgmma), so hi.hi
// (|u.v| sized) has its own accumulator and the small terms (~2^-11 of it)
// theirs; the caller adds the two in round-to-nearest. Every E and every
// squared norm goes through this one function, so a row's norm carries
// exactly the rounding of its own entry on the diagonal.
__device__ __forceinline__ void mma_chunk(float (&d)[64], float (&small)[64], const float* u_hi,
                                          const float* v_hi, bool first) {
    const float* u_lo = u_hi + PART_FLOATS;
    const float* v_lo = v_hi + PART_FLOATS;
    fence_operands(d);
    fence_operands(small);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
        const int at = s * (KSTEP_BYTES / 4);
        wgmma_tf32(small, describe(u_hi + at), describe(v_lo + at), !first || s > 0);
        wgmma_tf32(small, describe(u_lo + at), describe(v_hi + at), 1);
        wgmma_tf32(d, describe(u_hi + at), describe(v_hi + at), !first || s > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    fence_operands(small);
}

// The first 64 rows of a block in shared memory belong to warpgroup 0.
__device__ __forceinline__ const float* warpgroup_rows(const float* block, int g) {
    return block + g * (HALF_ROWS / 8) * (ROW_GROUP_BYTES / 4);
}

// Floats of packed scratch per member of an operand of `blocks` 128-row
// blocks: the blocks' hi/lo chunks, then their norms.
__host__ __device__ __forceinline__ size_t member_floats(int blocks, int chunks) {
    return static_cast<size_t>(blocks) * (static_cast<size_t>(chunks) * BLOCK_FLOATS + BM);
}

// ---- the pack pre-pass ---------------------------------------------------

// One CTA of two warpgroups per 128-row block of each member of x (batch, R,
// M), the members' blocks one after the other. For each 32-column
// chunk it splits the rows into hi and lo parts in the core-matrix layout,
// zero-padded, writes them to `packed` for the gram kernel and to shared
// memory, and runs the block's diagonal tile of the cross term on them. The
// diagonal of that tile is each row's squared norm, written to `norms`
// (0 for the padding rows).
__global__ void __launch_bounds__(CONSUMER_WARPS * 32)
pack_kernel(const float* __restrict__ x, float* __restrict__ scratch, int R, int M, int blocks,
            int chunks) {
    __shared__ __align__(128) float block[BLOCK_FLOATS];
    const int member = blockIdx.x / blocks, b = blockIdx.x % blocks;
    const int g = threadIdx.x / 128, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    x += static_cast<size_t>(member) * R * M;
    float* packed = scratch + member * member_floats(blocks, chunks);
    float* norms = packed + static_cast<size_t>(blocks) * chunks * BLOCK_FLOATS;
    float d[64], small[64];
    for (int c = 0; c < chunks; ++c) {
        float* hi = packed + (static_cast<size_t>(b) * chunks + c) * BLOCK_FLOATS;
        __syncthreads();   // the previous chunk's MMAs have read `block`
#pragma unroll
        for (int i = 0; i < PART_FLOATS / (CONSUMER_WARPS * 32); ++i) {
            const int o = threadIdx.x + i * CONSUMER_WARPS * 32;
            const int row = b * BM + ((o >> 5) & 15) * 8 + ((o >> 2) & 7);
            const int k = c * KC + (o >> 10) * 8 + ((o >> 9) & 1) * 4 + (o & 3);
            const float value = (row < R && k < M) ? x[static_cast<size_t>(row) * M + k] : 0.f;
            const float h = to_tf32(value), l = to_tf32(value - h);
            hi[o] = h;
            hi[PART_FLOATS + o] = l;
            block[o] = h;
            block[PART_FLOATS + o] = l;
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // visible to wgmma
        __syncthreads();
        mma_chunk(d, small, warpgroup_rows(block, g), block, c == 0);
    }
    // Accumulator i = 4j + 2h + e holds row 64g + 16w + lane/4 + 8h and column
    // 8j + 2(lane%4) + e of the diagonal tile.
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = g * HALF_ROWS + 16 * w + lane / 4 + 8 * (i / 2);
            if (r == 8 * j + 2 * (lane % 4) + i % 2) norms[b * BM + r] = d[4 * j + i] + small[4 * j + i];
        }
}

// ---- the gram kernel -----------------------------------------------------

// E over the tiles of every member's (A, B), from the packed operands and
// squared row norms of each member in su and sv (member_floats apart). Tile
// t is member t / (tiles_a * tiles_b)'s, so a CTA's run of tiles may cross
// from one member into the next. TMA selects the epilogue at compile time (a
// branch inside its unrolled loop would keep the compiler from interleaving
// the 64 exps of a thread): the staged TMA store, or masked stores from
// registers.
template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
unit_gram_kernel(const __grid_constant__ CUtensorMap out_map,   // unused without TMA
                 const float* __restrict__ su, const float* __restrict__ sv,
                 float* __restrict__ out, int A, int B, int chunks, int tiles_a, int tiles_b,
                 int tiles) {
    extern __shared__ __align__(16) unsigned char raw[];
    Shared& sm = *reinterpret_cast<Shared*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));

    // A contiguous run of tiles in row-major order, so u's block is reused.
    // Row r of tiles is row r % tiles_a of member r / tiles_a.
    const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
    const int last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        bar_init(&sm.full, 1);
        bar_init(&sm.empty, CONSUMER_WARPS);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMER_WARPS) {
        // Producer: one lane keeps the operand stage filled. A tile's norms go
        // to buffer n % 2 with its first chunk; the consumers read buffer
        // n % 2 in tile n's epilogue, after releasing the operands.
        if (lane != 0) return;
        int parity = 1, previous = -1;
        for (int tile = first, n = 0; tile < last; ++tile, ++n) {
            const int row = tile / tiles_b, tj = tile % tiles_b;
            const int member = row / tiles_a, ti = row % tiles_a;
            const float* pu = su + member * member_floats(tiles_a, chunks);
            const float* pv = sv + member * member_floats(tiles_b, chunks);
            const float* nu = pu + static_cast<size_t>(tiles_a) * chunks * BLOCK_FLOATS;
            const float* nv = pv + static_cast<size_t>(tiles_b) * chunks * BLOCK_FLOATS;
            for (int c = 0; c < chunks; ++c) {
                bar_wait(&sm.empty, parity);
                parity ^= 1;
                const bool load_u = chunks > 1 || row != previous;
                const bool load_norms = c == 0;
                previous = row;
                bar_expect_bytes(&sm.full, (load_u ? 2 : 1) * BLOCK_BYTES + (load_norms ? (BM + BN) * 4 : 0));
                if (load_u)
                    bulk_load(sm.u, pu + (static_cast<size_t>(ti) * chunks + c) * BLOCK_FLOATS,
                              BLOCK_BYTES, &sm.full);
                bulk_load(sm.v, pv + (static_cast<size_t>(tj) * chunks + c) * BLOCK_FLOATS,
                          BLOCK_BYTES, &sm.full);
                if (load_norms) {
                    bulk_load(sm.uu[n & 1], nu + static_cast<size_t>(ti) * BM, BM * 4, &sm.full);
                    bulk_load(sm.vv[n & 1], nv + static_cast<size_t>(tj) * BN, BN * 4, &sm.full);
                }
            }
        }
        return;
    }

    // Consumers: warpgroup g owns rows [64 g, 64 g + 64) of each tile.
    const int g = warp / 4, t = threadIdx.x % 128, w = warp % 4;
    float d[64], small[64];
    int parity = 0;
    for (int tile = first, n = 0; tile < last; ++tile, ++n) {
        const int tile_row = tile / tiles_b, tj = tile % tiles_b;
        const int member = tile_row / tiles_a, ti = tile_row % tiles_a;
        for (int c = 0; c < chunks; ++c) {
            bar_wait(&sm.full, parity);
            parity ^= 1;
            mma_chunk(d, small, warpgroup_rows(sm.u, g), sm.v, c == 0);
            __syncwarp();
            if (lane == 0) bar_arrive(&sm.empty);
        }

        // Epilogue. Accumulators d[i] and small[i], i = 4j + 2h + e, hold tile
        // row 64g + 16w + lane/4 + 8h and column 8j + 2(lane%4) + e.
        const int r_local = 16 * w + lane / 4;
        const int row0 = ti * BM + g * HALF_ROWS, col0 = tj * BN;
        const float* tile_uu = sm.uu[n & 1] + g * HALF_ROWS;
        const float* tile_vv = sm.vv[n & 1];
        const float uu_rows[2] = {load_shared(tile_uu + r_local), load_shared(tile_uu + r_local + 8)};
        float* stage = sm.out[g][n & 1];
        const int swizzle = ((lane % 4) / 2) ^ (lane / 4);
        if (TMA) {
            if (t == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
            named_sync(1 + g);
        }
        float2 vv_cols[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) vv_cols[j] = load_shared2(tile_vv + 8 * j + 2 * (lane % 4));
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r_local + 8 * h;
                const float e0 = exp2_approx(
                    unit_exp2_arg(d[4 * j + 2 * h] + small[4 * j + 2 * h], uu_rows[h] + vv_cols[j].x));
                const float e1 = exp2_approx(
                    unit_exp2_arg(d[4 * j + 2 * h + 1] + small[4 * j + 2 * h + 1], uu_rows[h] + vv_cols[j].y));
                if (TMA) {
                    // Box j/4 of 64 rows x 32 columns; the 16-byte chunk
                    // (col % 32) / 4 = 2 (j % 4) + (lane % 4) / 2 is XORed with
                    // row % 8 = lane / 4.
                    const int at = (j / 4) * BOX_FLOATS + r * BOX_COLS +
                                   ((2 * (j % 4)) ^ swizzle) * 4 + 2 * (lane % 2);
                    store_shared2(stage + at, e0, e1);
                } else {
                    const int row = row0 + r;
                    const int cg = col0 + col;
                    if (row < A) {
                        float* o = out + (static_cast<size_t>(member) * A + row) * B + cg;
                        if (cg < B) o[0] = e0;
                        if (cg + 1 < B) o[1] = e1;
                    }
                }
            }
        }
        if (TMA) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            named_sync(1 + g);
            if (t == 0) {
                // One group per tile, empty where the half tile lies past A, so
                // that wait_group.read 1 above always refers to this buffer.
#pragma unroll
                for (int box = 0; box < BN / BOX_COLS; ++box)
                    if (row0 < A && col0 + box * BOX_COLS < B)
                        tma_store(&out_map, stage + box * BOX_FLOATS, col0 + box * BOX_COLS, row0,
                                  member);
                asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            }
        }
    }
    if (TMA && t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                             &found) == cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

int blocks_of(int rows) { return (rows + BM - 1) / BM; }

}  // namespace

// Packs each member of u into scratch_u and of v into scratch_v with their
// squared norms (v skipped when the scratch is the same: u is v), then
// launches the gram kernel over every member's tiles, all on `stream`.
// Returns cudaGetLastError() as an int (0 = cudaSuccess), or -1 when CUDA's
// tensor-map encoder is missing or refuses the output. The caller allocates
// `out` and both scratch buffers, keeps each scratch buffer to this stream's
// calls, and has checked the shapes: batch * ceil(A / 128) * ceil(B / 128)
// tiles, and A * M and B * M, each below 2^31.
extern "C" int unit_gram_f32(const float* u, const float* v, float* scratch_u, float* scratch_v,
                             float* out, int batch, int A, int B, int M, cudaStream_t stream) {
    static int sms = 0;
    if (sms == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        cudaFuncSetAttribute(unit_gram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SHARED_BYTES));
        cudaFuncSetAttribute(unit_gram_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SHARED_BYTES));
    }
    const int chunks = (M + KC - 1) / KC;
    const int blocks_a = blocks_of(A), blocks_b = blocks_of(B);
    pack_kernel<<<batch * blocks_a, CONSUMER_WARPS * 32, 0, stream>>>(u, scratch_u, A, M, blocks_a,
                                                                      chunks);
    if (scratch_v != scratch_u)
        pack_kernel<<<batch * blocks_b, CONSUMER_WARPS * 32, 0, stream>>>(v, scratch_v, B, M,
                                                                          blocks_b, chunks);

    // TMA stores need 16-byte output rows; tiny outputs take the masked stores.
    // The output's descriptor depends only on (out, batch, A, B), and the
    // caching allocator often hands back the same block, so the last one is
    // kept: encoding it is a few microseconds of host time per call.
    static thread_local CUtensorMap map = {};
    static thread_local const float* map_out = nullptr;
    static thread_local int map_batch = 0, map_a = 0, map_b = 0;
    const bool use_tma = B % 4 == 0 && B >= BN && A >= HALF_ROWS;
    if (use_tma && (out != map_out || batch != map_batch || A != map_a || B != map_b)) {
        const EncodeTiled encode = encode_tiled();
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(A),
                                    static_cast<cuuint64_t>(batch)};
        const cuuint64_t strides[2] = {static_cast<cuuint64_t>(B) * sizeof(float),
                                       static_cast<cuuint64_t>(A) * B * sizeof(float)};
        const cuuint32_t box[3] = {BOX_COLS, HALF_ROWS, 1};
        const cuuint32_t unit[3] = {1, 1, 1};
        CUtensorMap fresh;
        if (encode == nullptr ||
            encode(&fresh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return -1;
        map = fresh;
        map_out = out;
        map_batch = batch;
        map_a = A;
        map_b = B;
    }
    const int tiles = batch * blocks_a * blocks_b;
    const int grid = tiles < sms ? tiles : sms;
    (use_tma ? unit_gram_kernel<true> : unit_gram_kernel<false>)<<<grid, THREADS, SHARED_BYTES, stream>>>(
        map, scratch_u, scratch_v, out, A, B, chunks, blocks_a, blocks_b, tiles);
    return static_cast<int>(cudaGetLastError());
}
