// AV1 loop restoration, Wiener: the separable 7-tap filter of every
// (restoration unit x stripe) item of one plane, in one launch.
//
// Replaces dav1d_tpu/ops/lr.py `_wiener_fn` (lr.py:106), the jitted
// program the TPU ran per frame and plane; the math is the reference's
// wiener_c (src/looprestoration_tmpl.c), term by term as ops/lr.py
// `wiener_items_plain` computes it.
//
// Inputs, as the host builds them (ops/lr.py lr_planes_device): the
// pre-LR plane `src` and the pre-CDEF plane `pre`, both edge-padded to
// the same (Hp, Ws); per item a row table of hmax + 6 rows (padded rows
// -3..hmax+2; a row r >= Hp reads row r - Hp of `pre`: the stripe-edge
// redirection, the top/bottom replication are already in it), the
// first column of its linear column window in the padded planes
// (colbase), the 7 horizontal and 7 vertical taps, and where its
// ohs x ows outputs land in `dst` (oy, ox). Rows and columns come only
// from these tables.
//
// Horizontal pass: 2^(bd+6) + sum of taps x pixels, rounded by 3 (5 at
// 12 bit) and clipped to [0, 2^(bd+1+7-round) - 1]; vertical pass:
// -2^(bd+round-1) + sum, rounded by 11 (9 at 12 bit), clipped to
// [0, 2^bd - 1]. All sums fit int32 (taps sum to < 2^9 in magnitude).
//
// Design. One block of 256 threads per (item, tile of <= 64 output
// columns). (1) The (ohs + 6) x (cols + 6) window goes to shared
// memory (70 x 70 int32 at most). (2) The horizontal pass of every
// window row into shared memory (70 x 64). (3) The vertical pass, one
// output per thread and step, stored under the item's ohs x ows. 37576
// bytes of static shared memory; tiles past ows return at once.
//
// Bound: memory. Each restored pixel read and written once and the
// tables read once: a 1080p frame's Wiener items move a few MB, a few
// us at 3.35 TB/s; 28 multiply-adds a pixel stay below that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                  // output columns per block
constexpr int HMAX = 64;                // most rows an item restores
constexpr int ROWS = HMAX + 6;
constexpr int THREADS = 256;

struct Args {
    const int32_t *src, *pre;
    int32_t *dst;
    const int32_t *rowt, *colbase, *fh, *fv, *oy, *ox, *ohs, *ows;
    int Hp, Ws;             // rows and row stride of src and pre
    int Wd;                 // row stride of dst
    int hmax, wmax, bd;
};

__global__ void __launch_bounds__(THREADS)
lr_wiener_kernel(const __grid_constant__ Args a) {
    __shared__ int s_win[ROWS][TW + 6];
    __shared__ int s_hor[ROWS][TW];
    __shared__ int s_f[14];
    const int tid = threadIdx.x;
    const int item = blockIdx.x, c0 = blockIdx.y * TW;
    const int ows = a.ows[item], ohs = a.ohs[item];
    if (ohs < 0 || ohs > a.hmax || ows > a.wmax) __trap();
    if (c0 >= ows || ohs == 0) return;
    const int cw = min(TW, ows - c0);
    const int rows = ohs + 6, cols = cw + 6;
    if (tid < 7) s_f[tid] = a.fh[item * 7 + tid];
    else if (tid < 14) s_f[tid] = a.fv[item * 7 + tid - 7];
    const int32_t *rowt = a.rowt + (size_t)item * (a.hmax + 6);
    const int cb = a.colbase[item] + c0;
    for (int i = tid; i < rows * cols; i += THREADS) {
        const int r = i / cols, c = i - r * cols;
        const int R = rowt[r];
        const int32_t *row = R < a.Hp ? a.src + (size_t)R * a.Ws
                                      : a.pre + (size_t)(R - a.Hp) * a.Ws;
        s_win[r][c] = row[cb + c];
    }
    __syncthreads();

    const int rbh = a.bd == 12 ? 5 : 3;
    const int clip = (1 << (a.bd + 1 + 7 - rbh)) - 1;
    for (int i = tid; i < rows * cw; i += THREADS) {
        const int r = i / cw, j = i - r * cw;
        int s = 1 << (a.bd + 6);
#pragma unroll
        for (int t = 0; t < 7; t++) s += s_f[t] * s_win[r][j + t];
        s_hor[r][j] = min(max((s + (1 << (rbh - 1))) >> rbh, 0), clip);
    }
    __syncthreads();

    const int rbv = a.bd == 12 ? 9 : 11;
    const int px_max = (1 << a.bd) - 1;
    int32_t *dst = a.dst + (size_t)a.oy[item] * a.Wd + a.ox[item] + c0;
    for (int i = tid; i < ohs * cw; i += THREADS) {
        const int r = i / cw, j = i - r * cw;
        int s = -(1 << (a.bd + rbv - 1));
#pragma unroll
        for (int t = 0; t < 7; t++) s += s_f[7 + t] * s_hor[r + t][j];
        dst[(size_t)r * a.Wd + j] =
            min(max((s + (1 << (rbv - 1))) >> rbv, 0), px_max);
    }
}

}  // namespace

// Launch the Wiener pass of n items on `stream`. ptrs: src, pre (int32,
// (Hp, Ws) each), dst (int32, row stride Wd, written at the items'
// outputs only), rowt (n, hmax + 6), colbase (n,), fh (n, 7), fv (n, 7),
// oy, ox, ohs, ows (n,), all int32. dims: Hp, Ws, Wd, n, hmax (<= 64),
// wmax, bd.
extern "C" int lr_wiener(const void *const *ptrs, const int *dims,
                         void *stream) {
    Args a = {};
    a.src = (const int32_t *)ptrs[0];
    a.pre = (const int32_t *)ptrs[1];
    a.dst = (int32_t *)ptrs[2];
    a.rowt = (const int32_t *)ptrs[3];
    a.colbase = (const int32_t *)ptrs[4];
    a.fh = (const int32_t *)ptrs[5];
    a.fv = (const int32_t *)ptrs[6];
    a.oy = (const int32_t *)ptrs[7];
    a.ox = (const int32_t *)ptrs[8];
    a.ohs = (const int32_t *)ptrs[9];
    a.ows = (const int32_t *)ptrs[10];
    a.Hp = dims[0];
    a.Ws = dims[1];
    a.Wd = dims[2];
    const int n = dims[3];
    a.hmax = dims[4];
    a.wmax = dims[5];
    a.bd = dims[6];
    if (n < 0 || a.hmax < 1 || a.hmax > HMAX || a.wmax < 1)
        return (int)cudaErrorInvalidValue;
    if (n > 0)
        lr_wiener_kernel<<<dim3(n, (a.wmax + TW - 1) / TW), THREADS, 0,
                           (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
