// AV1 loop restoration, Wiener: the separable 7-tap filter of every
// (restoration unit x stripe) item of a frame's planes, in one launch.
//
// Replaces dav1d_tpu/ops/lr.py `_wiener_fn` (lr.py:106), the jitted
// program the TPU ran per frame and plane; the math is the reference's
// wiener_c (src/looprestoration_tmpl.c), term by term as ops/lr.py
// `wiener_items_plain` computes it.
//
// Inputs, as the host builds them (ops/lr.py frame_tables): per
// plane its pre-LR plane `src` and pre-CDEF plane `pre` (Hp rows each,
// one row stride), the restored plane `dst` and the width w that
// columns clamp to; per item a row of the item table (plane, colbase,
// oy, ox, ohs, ows, 7 horizontal and 7 vertical taps) and a row table
// of at least ohs + 6 rows (padded rows -3..ohs+2; a row r >= Hp reads
// row r - Hp of `pre`: the stripe-edge redirection and the top/bottom
// replication are already in it). The window's column c reads column
// clamp(colbase + c, 0, w - 1) of the unpadded planes (colbase = ox -
// 3): the reference's left/right edge replication. The item's ohs x ows outputs land in `dst` at (oy,
// ox).
//
// Horizontal pass: 2^(bd+6) + sum of taps x pixels, rounded by 3 (5 at
// 12 bit) and clipped to [0, 2^(bd+1+7-round) - 1] (at most 2^15 - 1:
// int16); vertical pass: -2^(bd+round-1) + sum, rounded by 11 (9 at 12
// bit), clipped to [0, 2^bd - 1]. All sums fit int32 (taps sum to
// < 2^9 in magnitude).
//
// Design. One block of 256 threads per (item, tile of <= 64 output
// columns), from a block table the host builds. (1) One warp per
// window row stages the (ohs + 6) x (cols + 6) window as int16 (its
// row-table entry and plane read once a row, the columns clamped; the
// loop unrolled, so that all of a thread's loads are in flight at
// once). (2)
// The horizontal pass of every window row into shared memory as int16.
// (3) The vertical pass: each thread slides a 7-row register window
// down a strip of one output column, one shared read an output, and
// stores under the item's ohs x ows. 19040 bytes of static shared
// memory.
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
constexpr int STRIPS = THREADS / TW;    // vertical pass: strips a column
// item table columns
enum { I_PLANE, I_COLBASE, I_OY, I_OX, I_OHS, I_OWS, I_FH, I_FV = I_FH + 7,
       NCOL = I_FV + 7 };

struct Plane {
    const int32_t *src, *pre;
    int32_t *dst;
    int Hp, ss, ds;         // rows of src and pre, their row stride, dst's
    int w, wmax;            // columns clamp to [0, w); widest item
};

struct Args {
    Plane pl[3];
    int np;
    const int32_t *items, *rowt, *blocks;   // (n, NCOL), (n, rw), (nb, 2)
    int n, rw, bd;
};

__global__ void __launch_bounds__(THREADS)
lr_wiener_kernel(const __grid_constant__ Args a) {
    __shared__ int16_t s_win[ROWS][TW + 8];
    __shared__ int16_t s_hor[ROWS][TW];
    const int tid = threadIdx.x;
    const int item = a.blocks[2 * blockIdx.x];
    const int c0 = a.blocks[2 * blockIdx.x + 1];
    if (item < 0 || item >= a.n) __trap();
    const int32_t *it = a.items + (size_t)item * NCOL;
    const int pi = it[I_PLANE];
    if (pi < 0 || pi >= a.np) __trap();
    const Plane &P = a.pl[pi];
    const int ohs = it[I_OHS], ows = it[I_OWS];
    if (ohs < 0 || ohs > HMAX || ohs + 6 > a.rw || ows > P.wmax) __trap();
    if (c0 >= ows || ohs == 0) return;
    const int cw = min(TW, ows - c0);
    const int rows = ohs + 6, cols = cw + 6;
    const int cb = it[I_COLBASE] + c0;
    const int32_t *rowt = a.rowt + (size_t)item * a.rw;
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int k = 0; k < (ROWS + 7) / 8; k++) {
        const int r = warp + 8 * k;
        if (r < rows) {
            const int R = rowt[r];
            const int32_t *row = R < P.Hp ? P.src + (size_t)R * P.ss
                                          : P.pre + (size_t)(R - P.Hp) * P.ss;
#pragma unroll
            for (int m = 0; m < 3; m++) {
                const int c = lane + 32 * m;
                if (c < cols)
                    s_win[r][c] = (int16_t)row[min(max(cb + c, 0), P.w - 1)];
            }
        }
    }
    int f[7];
#pragma unroll
    for (int t = 0; t < 7; t++) f[t] = it[I_FH + t];
    __syncthreads();

    // horizontal: column j of every window row
    const int j = tid & (TW - 1), q = tid / TW;
    const int rbh = a.bd == 12 ? 5 : 3;
    const int clip = (1 << (a.bd + 1 + 7 - rbh)) - 1;
    if (j < cw) {
        for (int r = q; r < rows; r += STRIPS) {
            int s = 1 << (a.bd + 6);
#pragma unroll
            for (int t = 0; t < 7; t++) s += f[t] * s_win[r][j + t];
            s_hor[r][j] = (int16_t)min(max((s + (1 << (rbh - 1))) >> rbh, 0),
                                       clip);
        }
    }
#pragma unroll
    for (int t = 0; t < 7; t++) f[t] = it[I_FV + t];
    __syncthreads();

    // vertical: strip q of column j, a 7-row window in registers
    const int per = (ohs + STRIPS - 1) / STRIPS;
    const int r0 = q * per, r1 = min(ohs, r0 + per);
    if (j >= cw || r0 >= r1) return;
    const int rbv = a.bd == 12 ? 9 : 11;
    const int px_max = (1 << a.bd) - 1;
    int h[7];
#pragma unroll
    for (int t = 0; t < 6; t++) h[t] = s_hor[r0 + t][j];
    int32_t *dst = P.dst + (size_t)(it[I_OY] + r0) * P.ds + it[I_OX] + c0 + j;
    for (int r = r0; r < r1; r++) {
        h[6] = s_hor[r + 6][j];
        int s = -(1 << (a.bd + rbv - 1));
#pragma unroll
        for (int t = 0; t < 7; t++) s += f[t] * h[t];
        *dst = min(max((s + (1 << (rbv - 1))) >> rbv, 0), px_max);
        dst += P.ds;
#pragma unroll
        for (int t = 0; t < 6; t++) h[t] = h[t + 1];
    }
}

}  // namespace

// Launch the Wiener pass over the items of up to 3 planes on `stream`.
// ptrs: per plane p src, pre, dst at ptrs[3 p ..] (int32; src and pre
// (Hp, ss), dst row stride ds, written at the items' outputs only),
// then the item table (n, 20), the row tables (n, rw) and the block
// table (nb, 2) of (item, first output column), a block each. dims:
// per plane Hp, ss, ds, w, wmax at dims[5 p ..], then np, n, rw, nb,
// bd.
extern "C" int lr_wiener(const void *const *ptrs, const int *dims,
                         void *stream) {
    Args a = {};
    const int *d = dims + 15;
    a.np = d[0];
    a.n = d[1];
    a.rw = d[2];
    const int nb = d[3];
    a.bd = d[4];
    if (a.np < 1 || a.np > 3 || a.n < 0 || a.rw < 7 || nb < 0)
        return (int)cudaErrorInvalidValue;
    for (int p = 0; p < a.np; p++) {
        Plane &P = a.pl[p];
        P.src = (const int32_t *)ptrs[3 * p];
        P.pre = (const int32_t *)ptrs[3 * p + 1];
        P.dst = (int32_t *)ptrs[3 * p + 2];
        P.Hp = dims[5 * p];
        P.ss = dims[5 * p + 1];
        P.ds = dims[5 * p + 2];
        P.w = dims[5 * p + 3];
        P.wmax = dims[5 * p + 4];
        if (P.w < 1 || P.wmax < 1) return (int)cudaErrorInvalidValue;
    }
    a.items = (const int32_t *)ptrs[9];
    a.rowt = (const int32_t *)ptrs[10];
    a.blocks = (const int32_t *)ptrs[11];
    if (nb > 0 && !a.blocks) return (int)cudaErrorInvalidValue;
    if (nb > 0)
        lr_wiener_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
