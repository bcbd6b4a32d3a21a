// AV1 super-resolution: the horizontal 8-tap upscale of a frame's
// coded-width planes to the output width, every plane and source (the
// post-CDEF planes and, when loop restoration runs, the pre-CDEF
// snapshot) in one launch.
//
// Replaces dav1d_tpu/ops/superres.py `_resize_fn` (superres.py:41),
// the jitted program the TPU ran per plane and source; the math is the
// reference's resize_c (src/mc_tmpl.c:918-958), term by term as
// ops/superres.py `resize_plane_plain` computes it.
//
// A job resizes rows [0, h) of its source (columns [0, src_w) valid,
// row stride ss) into a destination of H x W (its padded plane, row
// stride W): output column ox < dst_w of row y < h is
//   clip((-sum_i bank[phase][i] * src[y][clip(src_x - 3 + i, 0,
//        src_w - 1)] + 64) >> 7, 0, 2^bd - 1),
// with T = mx0 + ox * step, src_x = (T >> 14) - 1, phase = (T & 0x3fff)
// >> 8 (the closed form of the reference's position recurrence, exact
// for mx0 < 2^14; T in 64 bits). Every other pixel of the destination
// is 0: loop restoration's stripe reads may touch those columns.
//
// Bound: memory. Each source pixel read once and each destination
// pixel written once, int32: a 1080p 4:2:0 frame from 960 columns with
// its pre-CDEF snapshot moves 39 MB, 11.6 us at 3.35 TB/s; 8
// multiply-adds an output stay well below that. No single PyTorch call
// computes this function: there is no library yardstick.
//
// Design: bytes in flight, and few instructions an output. Tiles of
// RT rows x TW output columns, one flat list over every job's
// destination, padding tiles included. Persistent blocks (as many as
// fit the card at once: 3 a SM at 71 registers) walk the list with a
// stride of the grid; each keeps the source span of its next NSTAGE - 1 tiles in
// flight in a ring of shared-memory stages, filled by cp.async (16-byte
// copies of 4 columns; the columns past either edge of the source,
// which the reference clamps, 4-byte copies of the clamped column),
// while it filters and stores the current tile. A warp stages and
// filters the same rows of each tile (rows warp + 8 j), so the warps of
// a block wait only on their own copies, never on each other. A span
// starts at a
// multiple of 4 columns: for step <= 2^14, 128 outputs read at most
// 127 + 8 columns, plus 3 of alignment: 35 vectors, SPAN = 140
// (asserted per tile; ops/superres.py `tile_spans` is the same plan in
// Python). A warp filters rows of a tile, a lane the columns lane + 32 k
// (k < 4), with its 4 phases' 32 taps set up once a tile from the
// negated bank, int32 in shared memory (lanes read different phases):
// an output is then 8 shared reads and 8 multiply-adds from the
// rounding constant, a shift and a clamp, the 4 of a lane without a
// branch between them so that their chains interleave (a branch an
// output cost a fifth more time). The lanes' taps fall on
// consecutive source columns, so the shared reads have no bank
// conflicts, and a warp's store is 128 contiguous bytes. Padding tiles
// and the zero rows and columns of a tile are written by the same
// blocks as 16-byte stores; the row strides and plane pointers are
// 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;                 // output columns per tile
constexpr int RT = 32;                  // rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 3;               // ring of staged tiles
constexpr int SPAN = 140;               // staged source columns
constexpr int MAX_JOBS = 6;
// dynamic shared memory: the bank (64 x 8 int32), then the stages
constexpr int SMEM = (64 * 8 + NSTAGE * RT * SPAN) * 4;

struct Job {
    const int32_t *src;
    int32_t *dst;
    int src_w, ss, h, dst_w, H, W, step, mx0;
    int tiles_x, first;                 // tiles a row; first tile's id
};

struct Args {
    Job job[MAX_JOBS];
    int njobs, bd, ntiles;
};

struct Tile {
    int k, r0, c0, rows, lo, nvec;      // rows: source rows (<= 0: pad)
    bool pad;
};

__constant__ int8_t c_bank[64 * 8];

__device__ __forceinline__ void cp_async16(void *s, const void *g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(s);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(void *s, const void *g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(s);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ Tile tile_of(const Args &a, int t) {
    int k = 0;
    while (k + 1 < a.njobs && t >= a.job[k + 1].first) k++;
    const Job &J = a.job[k];
    const int tt = t - J.first, ty = tt / J.tiles_x;
    Tile T;
    T.k = k;
    T.r0 = ty * RT;
    T.c0 = (tt - ty * J.tiles_x) * TW;
    T.rows = min(RT, J.h - T.r0);
    T.pad = T.rows <= 0 || T.c0 >= J.dst_w;
    T.lo = 0;
    T.nvec = 0;
    if (!T.pad) {
        const int cl = min(T.c0 + TW, J.dst_w) - 1;
        const int lo = (int)(((long long)J.mx0 +
                              (long long)T.c0 * J.step) >> 14) - 4;
        const int hi = (int)(((long long)J.mx0 +
                              (long long)cl * J.step) >> 14) + 3;
        T.lo = lo & ~3;                 // floor to a multiple of 4
        T.nvec = ((hi - T.lo) >> 2) + 1;
        if (4 * T.nvec > SPAN) __trap();
    }
    return T;
}

// issue the cp.async copies of a tile's clamped source span
__device__ __forceinline__ void stage(const Args &a, const Tile &T,
                                      int32_t (*buf)[SPAN]) {
    if (T.pad) return;
    const Job &J = a.job[T.k];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < T.rows; r += WARPS) {
        const int32_t *row = J.src + (size_t)(T.r0 + r) * J.ss;
        for (int v = lane; v < T.nvec; v += 32) {
            const int x = T.lo + 4 * v;
            int32_t *d = &buf[r][4 * v];
            if (x >= 0 && x + 3 < J.src_w) {
                cp_async16(d, row + x);
            } else {
#pragma unroll
                for (int j = 0; j < 4; j++)
                    cp_async4(d + j, row + min(max(x + j, 0), J.src_w - 1));
            }
        }
    }
}

__device__ __forceinline__ void zeros(int32_t *dst, int r_beg, int r_end,
                                      int c0, int c_end, int W) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = c0 + 4 * lane;
    if (c >= c_end) return;
    for (int r = r_beg + warp; r < r_end; r += WARPS)
        *(int4 *)(dst + (size_t)r * W + c) = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ void filter(const Args &a, const Tile &T,
                                       const int32_t (*buf)[SPAN],
                                       const int32_t (*bank)[8]) {
    const Job &J = a.job[T.k];
    const int r_end = min(T.r0 + RT, J.H);
    const int c_end = min(T.c0 + TW, J.W);
    if (T.pad) {
        zeros(J.dst, T.r0, r_end, T.c0, c_end, J.W);
        return;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int px_max = (1 << a.bd) - 1;
    int f[4][8], base[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const int ox = T.c0 + lane + 32 * k;
        const long long P = (long long)J.mx0 + (long long)ox * J.step;
        const bool on = ox < J.dst_w;
        const int ph = on ? (int)((P & 0x3fff) >> 8) : 0;
        base[k] = on ? (int)(P >> 14) - 4 - T.lo : 0;
        const int4 w0 = *(const int4 *)&bank[ph][0];
        const int4 w1 = *(const int4 *)&bank[ph][4];
        f[k][0] = w0.x; f[k][1] = w0.y; f[k][2] = w0.z; f[k][3] = w0.w;
        f[k][4] = w1.x; f[k][5] = w1.y; f[k][6] = w1.z; f[k][7] = w1.w;
    }
    // columns of the tile: filtered (< dst_w) or zero (< c_end)
    const int n_on = min(J.dst_w - T.c0 - lane + 31, 128) >> 5;
    const int n_col = min(c_end - T.c0 - lane + 31, 128) >> 5;
    // the 4 outputs of a lane without branches (off columns read the
    // span's first taps), so their chains interleave; stores predicated
    for (int r = warp; r < T.rows; r += WARPS) {
        int32_t *out = J.dst + (size_t)(T.r0 + r) * J.W + T.c0 + lane;
        const int32_t *s = buf[r];
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            const int32_t *x = s + base[k];
            int acc = 64;               // the taps are negated
#pragma unroll
            for (int i = 0; i < 8; i++) acc += f[k][i] * x[i];
            v[k] = min(max(acc >> 7, 0), px_max);
        }
#pragma unroll
        for (int k = 0; k < 4; k++)
            if (k < n_col) out[32 * k] = k < n_on ? v[k] : 0;
    }
    zeros(J.dst, T.r0 + T.rows, r_end, T.c0, c_end, J.W);
}

__global__ void __launch_bounds__(THREADS)
superres_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) int32_t smem[];
    int32_t (*bank)[8] = (int32_t (*)[8])smem;
    int32_t (*stages)[RT][SPAN] = (int32_t (*)[RT][SPAN])(smem + 64 * 8);
    for (int i = threadIdx.x; i < 64 * 8; i += THREADS)
        bank[i >> 3][i & 7] = -(int)c_bank[i];
    __syncthreads();
    const int G = gridDim.x;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; s++) {
        const int t = blockIdx.x + s * G;
        if (t < a.ntiles) stage(a, tile_of(a, t), stages[s]);
        cp_commit();
    }
    int i = 0;
    for (int t = blockIdx.x; t < a.ntiles; t += G, i++) {
        cp_wait<NSTAGE - 2>();
        __syncwarp();                   // tile t staged; stage i-1 free
        const int tn = t + (NSTAGE - 1) * G;
        if (tn < a.ntiles)
            stage(a, tile_of(a, tn), stages[(i + NSTAGE - 1) % NSTAGE]);
        cp_commit();
        filter(a, tile_of(a, t), stages[i % NSTAGE], bank);
    }
    cp_wait<0>();
}

int g_blocks[64];                       // resident blocks per device

}  // namespace

// Upload the (64, 8) int8 dav1d_resize_filter bank (once per process).
extern "C" int superres_set_filter(const int8_t *bank) {
    cudaMemcpyToSymbol(c_bank, bank, sizeof(c_bank));
    return (int)cudaGetLastError();
}

// The persistent grid of the current device: blocks a SM and SMs.
extern "C" int superres_occupancy(int *per_sm, int *sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(superres_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cudaFuncSetAttribute(superres_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, superres_kernel,
                                                  THREADS, SMEM);
    return (int)cudaGetLastError();
}

// Launch the resize of `njobs` (1..6) jobs on `stream`. ptrs: per job
// src, dst (int32, 16-byte aligned). dims: per job src_w, ss (src row
// stride, a multiple of 4), h, dst_w, H, W (dst rows and columns, its
// row stride, a multiple of 4), step, mx0.
extern "C" int superres(const void *const *ptrs, const int *dims,
                        int njobs, int bd, void *stream) {
    if (njobs < 1 || njobs > MAX_JOBS || (bd != 8 && bd != 10 && bd != 12))
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.njobs = njobs;
    a.bd = bd;
    long long tiles = 0;
    for (int k = 0; k < njobs; k++) {
        Job &J = a.job[k];
        const int *d = dims + 8 * k;
        J.src = (const int32_t *)ptrs[2 * k];
        J.dst = (int32_t *)ptrs[2 * k + 1];
        J.src_w = d[0];
        J.ss = d[1];
        J.h = d[2];
        J.dst_w = d[3];
        J.H = d[4];
        J.W = d[5];
        J.step = d[6];
        J.mx0 = d[7];
        if (!J.src || !J.dst || J.src_w < 1 || J.ss < J.src_w || J.h < 1 ||
            J.H < J.h || J.dst_w < 1 || J.W < J.dst_w || J.step < 1 ||
            J.step > (1 << 14) || J.mx0 < 0 || J.mx0 >= (1 << 14) ||
            (J.ss & 3) || (J.W & 3) || ((uintptr_t)J.src & 15) ||
            ((uintptr_t)J.dst & 15))
            return (int)cudaErrorInvalidValue;
        J.tiles_x = (J.W + TW - 1) / TW;
        J.first = (int)tiles;
        tiles += (long long)J.tiles_x * ((J.H + RT - 1) / RT);
    }
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    a.ntiles = (int)tiles;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!g_blocks[dev]) {
        int per_sm = 0, sms = 0;
        const int rc = superres_occupancy(&per_sm, &sms);
        if (rc) return rc;
        if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
        g_blocks[dev] = per_sm * sms;
    }
    const int grid = (int)(tiles < g_blocks[dev] ? tiles : g_blocks[dev]);
    superres_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
