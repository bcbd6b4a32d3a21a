// AV1 inverse transform + residual add over a class-binned table of jobs
// (one transform block each), plus the lossless 4x4 Walsh-Hadamard
// variant.
//
// Replaces the `res_{y,c}_*` and `wht_{y,c}` segments of
// dav1d_tpu/ops/mc_fused.py `_mc_program` (XLA-jitted, not Pallas),
// with the math of dav1d_tpu/ops/mc_jobs.py `res_tx_fn` / `res_jobs_fn`
// (reference src/itx_tmpl.c:43-121, src/itx_1d.c).
//
// Job row (int32, 6 columns; the launch is per plane):
//   tx, ridx, cidx, py, px, cfoff
// ridx / cidx index the 1-D kinds available at the row / column length
// (dav1d_tpu mc_jobs.res_tx_kinds: DCT, ADST, FLIPADST, IDENTITY up to
// 16 points, DCT and IDENTITY at 32, DCT at 64). The sw x sh
// coefficients (sw = min(w, 32), sh = min(h, 32)) sit x-major at cfoff
// in the frame's int32 coefficient pool.
//
// Block row (int32, 3 columns; ops/itx.py res_blocks): cls, first,
// count. The host sorts a plane's jobs by cls = tx << 4 | ridx << 2 |
// cidx and cuts each class into blocks of at most jobs_per_block(tx)
// jobs, so every block is class-uniform. Reordering is exact because
// the jobs of one pass never write the same pixel.
//
// Design. A block of 128 threads runs `count` jobs of one class. For
// each of the two passes a block-uniform switch on the pass's length N
// (W for rows, H for columns) calls one_pass<N>, so every array is
// sized at compile time, every loop unrolls and the butterflies stay in
// registers (ptxas: no stack frame at bd 8/10). Row pass: one thread
// per (job, row) applies the rect2 scale and the row 1-D transform,
// then (x + rnd) >> shift and the column-range clamp into a shared
// tile (row stride W + 1: no bank conflicts). Column pass: one thread
// per (job, column) runs the column 1-D transform, (v + 8) >> 4, adds
// to the plane and clips. A 4x4 job takes 4 threads, so one block
// holds 32 of them; a 64x64 job takes 64. The pass loop is not
// unrolled: both passes and every class run the one copy of each
// N-point code, because with a copy per (W, H) and pass the cold
// instruction fetch of the unrolled butterflies was the largest cost of
// a launch (a 64x64 block alone took 17.9 us on an H100). A column
// thread reads all its plane pixels before it writes any: a store may
// alias the next load, and interleaved they cost a round trip each.
// Arithmetic is int32 at bd 8 and 10: the decoder's coefficients and
// the inter-pass clamps keep every product below 2^31 there
// (tests/test_torch_itx.py checks it with extreme coefficients against
// int64); bd 12 instantiates the same code on int64, since its 2^19
// range overflows int32. The 1-D butterflies are native/itxnat.cpp's
// (bit-exact with dav1d_tpu/ops/itx_core.py).
//
// Bound: memory for the coefficient reads and plane read-modify-write
// (4 + 8 bytes per pixel): a 1080p s7 inter frame's ~2.8k jobs move a
// few MB, ~1.5 us at 3.35 TB/s. At that size a launch costs about its
// slowest block's latency, the one-thread-per-line 64-point DCTs.
//
// The device code (the transforms, one_pass, the per-block body and the
// WHT job) is itx_common.cuh, which csrc/ipred.cu's frame kernel
// includes for its residual step.

#include "itx_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
itx_add_kernel(const i32 *__restrict__ pool, const i32 *__restrict__ jobs,
               const i32 *__restrict__ blocks, i32 *__restrict__ dst,
               int dst_h, int dst_w, int bd) {
    __shared__ T tile[TILE_WORDS];
    itx_block<T>(pool, jobs, blocks + (size_t)blockIdx.x * B_N, dst, dst_h,
                 dst_w, bd, tile);
}

// one thread per lossless 4x4 job
__global__ void __launch_bounds__(WHT_THREADS)
itx_wht_kernel(const i32 *__restrict__ pool, const i32 *__restrict__ jobs,
               int n, i32 *__restrict__ dst, int dst_h, int dst_w, int bd) {
    const int i = blockIdx.x * WHT_THREADS + threadIdx.x;
    if (i >= n) return;
    wht_job(pool, jobs + (size_t)i * R_N, dst, dst_h, dst_w, bd);
}

}  // namespace

// Inverse transform + add of one plane on `stream`. General jobs: the
// class-sorted job table and its n_blocks block rows, int32 at bd 8/10,
// int64 at bd 12. WHT jobs (`wht` nonzero): n jobs, blocks unused.
// pool: the frame's int32 coefficient pool; dst: int32 (dst_h, dst_w)
// plane, updated in place.
extern "C" int itx_add(const i32 *pool, const i32 *jobs, int n,
                       const i32 *blocks, int n_blocks, i32 *dst, int dst_h,
                       int dst_w, int bd, int wht, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (wht) {
        if (n > 0)
            itx_wht_kernel<<<(n + WHT_THREADS - 1) / WHT_THREADS,
                             WHT_THREADS, 0, s>>>(pool, jobs, n, dst, dst_h,
                                                  dst_w, bd);
    } else if (n_blocks > 0) {
        if (bd == 12)
            itx_add_kernel<i64><<<n_blocks, THREADS, 0, s>>>(
                pool, jobs, blocks, dst, dst_h, dst_w, bd);
        else
            itx_add_kernel<i32><<<n_blocks, THREADS, 0, s>>>(
                pool, jobs, blocks, dst, dst_h, dst_w, bd);
    }
    return (int)cudaGetLastError();
}

// jobs_per_block(tx) as the kernel computes it, for the host's check
extern "C" int itx_jobs_per_block(int w, int h) {
    const int sh = h < 32 ? h : 32;
    return THREADS / (sh > w ? sh : w);
}
