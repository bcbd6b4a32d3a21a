// AV1 two-reference compound prediction over a class-binned table of
// jobs: two 8-tap preps per job, then the avg / distance-weighted avg /
// seg mask / wedge mask combine.
//
// Replaces the `comp_{y,c}_*` segments of dav1d_tpu/ops/mc_fused.py
// `_mc_program` (XLA-jitted, not Pallas), with the math of
// dav1d_tpu/ops/mc_jobs.py `comp_jobs_fn` (reference src/mc_tmpl.c
// prep_8tap, avg, w_avg, mask, w_mask).
//
// Job row (int32, the native emitter's COMP layout, 25 columns):
//   plane, h, w, py, px, mode, jw, sign, mkind, clidx, mbs, msign, widx,
//   dy0, dx0, amx0, amy0, ft0, slot0, dy1, dx1, amx1, amy1, ft1, slot1
// mode: 1 w-avg, 2 avg, 3 seg, 4 mask; mkind (mask source of mode 4):
// 1 wedge (LUT key from clidx, mbs, msign, widx), 2 the seg plane.
//
// Block row (int32, 5 columns; ops/mc.py comp_blocks): cls, first,
// count, ty0, tx0. cls names the tile shape (TH, TW), both in
// {4, 8, 16, 32}: cls = (log2 TH - 2) * 4 + log2 TW - 2. A block runs
// `count` (at most jobs_per_block(TH, TW)) jobs of exactly TH x TW, or
// one TH x TW tile at (ty0, tx0) of a job larger than 32 in a
// dimension. The host sorts a plane's jobs by class; reordering is
// exact because the jobs of one pass never write the same pixel.
//
// Design. 128 threads per block. (1) Every job's two reference
// windows, (TH+7) rows of TW+7 pixels with the per-element emu-edge
// clamp to the frame's (rh, rw), go to shared memory by cp.async, all
// in flight together: a row is copied in 16-byte chunks from its
// 16-byte-aligned column at or left of the window, one cp.async per
// chunk inside the frame's columns and four clamped 4-byte ones at its
// edges; then the jobs' 8-tap rows, also by cp.async, so that no
// thread waits on a load before the windows are requested. Barrier.
// (2) Horizontal taps, 8 columns per thread item (4 at TW 4), from
// 16-byte shared loads into a (TH+7)-row intermediate per prep, rounded
// by 6 - ib. Barrier. (3) Each thread takes a 4-row x 2-column patch,
// runs the vertical taps of both preps in registers (rounded by 6,
// minus the prep bias), combines in registers (branching once on the
// job's mode) and writes the plane. Two barriers per block; each
// reference pixel comes from DRAM or L2 once per window. Phases (1) and
// (2) are templated per class (every index split by a compile-time
// constant); phase (3) is one copy for all classes, with its geometry
// as shifts, which keeps the launch's instruction footprint small.
// Luma seg jobs subsample their w_mask weights into the seg plane from
// the same registers (the patch holds whole 2x2 quads); chroma jobs
// with mkind 2 read it. The luma launch precedes the chroma launch on
// one stream, which orders producer before consumer. Wedge masks come
// from the dense per-class int8 LUTs (dav1d_tpu mc_fused._wedge_lut(16)
// and (32)).
//
// Bound: memory. Each output pixel written once, each reference window
// read once: a 1080p s7 inter frame's ~2.8k compounds move ~12.5 MB,
// ~3.7 us at 3.35 TB/s. On the H100 a block's time goes mostly to (1),
// its dependent round trips to memory (block row, job rows, windows),
// so a launch costs about its slowest block's latency
// (tools/torch_comp_phases.py measures the phases).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_REFS = 8;
constexpr int N_WEDGE = 3 * 11 * 32;
// shared words of a block, and the output pixels a block holds at most
constexpr int SMEM_WORDS = 8192;
constexpr int MAX_PX = 1024;

enum { C_PLANE, C_H, C_W, C_PY, C_PX, C_MODE, C_JW, C_SIGN, C_MKIND,
       C_CLIDX, C_MBS, C_MSIGN, C_WIDX, C_P0, C_P1 = C_P0 + 6,
       C_N = C_P1 + 6 };
// prep column offsets from C_P0 / C_P1
enum { P_DY, P_DX, P_AMX, P_AMY, P_FT, P_SLOT };
enum { COMP_WAVG = 1, COMP_AVG = 2, COMP_SEG = 3 };
enum { B_CLS, B_FIRST, B_COUNT, B_TY0, B_TX0, B_N };

// the filter bank in global memory: jobs of one warp pick different
// rows, which the L1 serves together (constant memory would serialise)
__device__ __align__(16) int g_fb[2][4][16][8];

struct Refs {
    const int32_t *p[MAX_REFS];
};

struct Args {
    Refs refs;
    int ref_w;
    const int32_t *jobs;
    const int32_t *blocks;
    int32_t *dst;
    int dst_h, dst_w;
    int32_t *seg;
    int seg_h, seg_w;
    const int8_t *wl16, *wl32;
    int rh, rw, bd, seg_mode, ss_hor, ss_ver, bs32x32;
    int vec;            // reference rows 16-byte aligned (16-byte copies)
};

// window row stride: a multiple of 4 words (16-byte rows) whose quarter
// is odd (8 neighbouring rows' 16-byte loads hit distinct banks),
// covering the row's 3 words of alignment offset and its tw + 7 pixels
__host__ __device__ constexpr int win_stride(int tw) {
    return tw == 32 ? 44 : (tw == 16 ? 28 : 20);
}

// intermediate row stride: 8 rows' 16-byte stores hit distinct banks
__host__ __device__ constexpr int mid_stride(int tw) {
    return tw == 4 ? 12 : tw + 4;
}

// shared words of one job: two windows, two intermediates, 32 taps
__host__ __device__ constexpr int job_words(int th, int tw) {
    return 2 * (th + 7) * (win_stride(tw) + mid_stride(tw)) + 32;
}

__host__ __device__ constexpr int jobs_per_block(int th, int tw) {
    return SMEM_WORDS / job_words(th, tw) < MAX_PX / (th * tw)
               ? SMEM_WORDS / job_words(th, tw)
               : MAX_PX / (th * tw);
}

// shared layout of one job: window 0 | window 1 | mid 0 | mid 1 | taps.
// Window row r holds the reference row from column x0 & ~3 on (x0 =
// dx - 3 + tx0), so the window's pixel c sits at word (x0 & 3) + c.
template <int TH, int TW> struct Geo {
    static constexpr int ROWS = TH + 7;
    static constexpr int WS = win_stride(TW);
    static constexpr int CHUNKS = (TW + 13) / 4;  // 16-byte chunks a row
    static constexpr int WIN = ROWS * WS;
    static constexpr int MIDS = mid_stride(TW);
    static constexpr int MID = ROWS * MIDS;
    static constexpr int TAPS = 2 * WIN + 2 * MID;
    static constexpr int S = TAPS + 32;
    static constexpr int J = jobs_per_block(TH, TW);
    // horizontal pass: OUT columns an item, from NQ 16-byte loads that
    // cover the alignment offset and OUT + 7 window pixels
    static constexpr int OUT = TW >= 8 ? 8 : 4;
    static constexpr int NQ = (OUT + 13) / 4;
    static_assert(S == job_words(TH, TW) && J >= 1 && J * S <= SMEM_WORDS &&
                  4 * CHUNKS <= WS && TW - OUT + 4 * NQ <= WS,
                  "shared layout");
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

__device__ __forceinline__ void cp_async4(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async16(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// Phases (1) and (2) of a TH x TW class, each ending in its barrier;
// the index splits divide by compile-time constants
template <int TH, int TW>
__device__ __forceinline__ void load_hpass(const Args &a,
                                           const int32_t *jobs, int count,
                                           int ty0, int tx0, int ib,
                                           int *smem) {
    using G = Geo<TH, TW>;
    if (count > G::J) __trap();         // the host table broke its contract
    const int tid = threadIdx.x;

    // (1) 16-byte chunks of both windows' rows: one cp.async where the
    // chunk lies inside the frame's columns (and the rows are 16-byte
    // aligned), four clamped 4-byte ones at the frame's edges
    constexpr int LI = G::ROWS * G::CHUNKS;
#pragma unroll 2
    for (int i = tid; i < count * 2 * LI; i += THREADS) {
        const int sp = i / LI, e = i - sp * LI;
        const int r = e / G::CHUNKS, q = e - r * G::CHUNKS;
        const int32_t *pq = jobs + (size_t)(sp >> 1) * C_N +
                            ((sp & 1) ? C_P1 : C_P0);
        const int y = iclip(pq[P_DY] - 3 + ty0 + r, 0, a.rh - 1);
        const int xs = ((pq[P_DX] - 3 + tx0) & ~3) + 4 * q;
        const int32_t *src = a.refs.p[pq[P_SLOT]] + (size_t)y * a.ref_w;
        int *dst = smem + (sp >> 1) * G::S + (sp & 1) * G::WIN + r * G::WS +
                   4 * q;
        if (a.vec && xs >= 0 && xs + 3 < a.rw) {
            cp_async16(dst, src + xs);
        } else {
#pragma unroll
            for (int k = 0; k < 4; k++)
                cp_async4(dst + k, src + iclip(xs + k, 0, a.rw - 1));
        }
    }
    // then each job's horizontal and vertical 8-tap rows, as two 16-byte
    // copies each (no thread waits on a load before the windows are in
    // flight)
    for (int i = tid; i < count * 8; i += THREADS) {
        const int s = i >> 3, p = (i >> 2) & 1, v = (i >> 1) & 1;
        const int32_t *j = jobs + (size_t)s * C_N;
        const int32_t *q = j + (p ? C_P1 : C_P0);
        const int ft = q[P_FT];
        const int *row = v ? g_fb[j[C_H] <= 4][(ft >> 2) & 3][q[P_AMY]]
                           : g_fb[j[C_W] <= 4][ft & 3][q[P_AMX]];
        cp_async16(smem + s * G::S + G::TAPS + p * 16 + v * 8 + (i & 1) * 4,
                   row + (i & 1) * 4);
    }
    cp_async_wait_all();
    __syncthreads();

    // (2) horizontal taps: OUT intermediate columns per item from NQ
    // 16-byte loads of the window row; neighbouring threads take
    // neighbouring rows (a window row stride of 4 x odd words: no bank
    // conflicts)
    constexpr int OUT = G::OUT, NV = OUT + 7, NQ = G::NQ;
    constexpr int HI = G::ROWS * (TW / OUT);
    for (int i = tid; i < count * 2 * HI; i += THREADS) {
        const int sp = i / HI, e = i - sp * HI;
        const int c = (e / G::ROWS) * OUT, r = e - (c / OUT) * G::ROWS;
        int *base = smem + (sp >> 1) * G::S;
        const int4 *w4 = reinterpret_cast<const int4 *>(
            base + (sp & 1) * G::WIN + r * G::WS + c);
        const int *f = base + G::TAPS + (sp & 1) * 16;
        const int off = (jobs[(size_t)(sp >> 1) * C_N +
                              ((sp & 1) ? C_P1 : C_P0) + P_DX] - 3 + tx0) & 3;
        int w[4 * NQ], v[NV], fh[8], o[OUT];
#pragma unroll
        for (int k = 0; k < NQ; k++) {
            const int4 u = w4[k];
            w[4 * k] = u.x;
            w[4 * k + 1] = u.y;
            w[4 * k + 2] = u.z;
            w[4 * k + 3] = u.w;
        }
#pragma unroll
        for (int k = 0; k < NV; k++)         // v[k] = w[off + k]
            v[k] = off == 0 ? w[k] : off == 1 ? w[k + 1]
                 : off == 2 ? w[k + 2] : w[k + 3];
#pragma unroll
        for (int k = 0; k < 8; k++) fh[k] = f[k];
#pragma unroll
        for (int u = 0; u < OUT; u++) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; k++) acc += fh[k] * v[u + k];
            o[u] = rnd(acc, 6 - ib);
        }
        int4 *m4 = reinterpret_cast<int4 *>(base + 2 * G::WIN +
                                            (sp & 1) * G::MID + r * G::MIDS +
                                            c);
#pragma unroll
        for (int u = 0; u < OUT / 4; u++)
            m4[u] = make_int4(o[4 * u], o[4 * u + 1], o[4 * u + 2],
                              o[4 * u + 3]);
    }
    __syncthreads();
}

// Phase (3) of a block of class cls = (log2 TH - 2) * 4 + log2 TW - 2:
// one copy for every class (its geometry at run time, every split a
// shift), so the largest code of the kernel stays warm in the
// instruction cache across the blocks of a launch
__device__ __forceinline__ void vpass_combine(const Args &a,
                                              const int32_t *jobs, int count,
                                              int ty0, int tx0, int cls,
                                              int ib, const int *smem) {
    const int lth = (cls >> 2) + 2, ltw = (cls & 3) + 2;
    const int tw = 1 << ltw, rows = (1 << lth) + 7;
    const int mids = mid_stride(tw);
    const int win = rows * win_stride(tw), mid = rows * mids;
    const int taps = 2 * win + 2 * mid, words = taps + 32;
    const int lpc = ltw - 1, lppj = lth - 2 + lpc;   // 4 x 2 patches
    const int pb = a.bd == 8 ? 0 : 8192;
    const int mask_sh = a.bd + ib - 4;
    const int mask_rnd = 1 << (mask_sh - 5);
    const int px_max = (1 << a.bd) - 1;
    for (int i = threadIdx.x; i < count << lppj; i += THREADS) {
        const int s = i >> lppj, e = i & ((1 << lppj) - 1);
        const int r0 = (e >> lpc) * 4, c0 = (e & ((1 << lpc) - 1)) * 2;
        const int *base = smem + s * words;
        int t[2][4][2];
#pragma unroll
        for (int p = 0; p < 2; p++) {
            const int *f = base + taps + p * 16 + 8;
            const int *m = base + 2 * win + p * mid + r0 * mids + c0;
            int fv[8];
            int2 col[11];
#pragma unroll
            for (int k = 0; k < 8; k++) fv[k] = f[k];
#pragma unroll
            for (int k = 0; k < 11; k++)
                col[k] = *reinterpret_cast<const int2 *>(m + k * mids);
#pragma unroll
            for (int rr = 0; rr < 4; rr++) {
                int a0 = 0, a1 = 0;
#pragma unroll
                for (int k = 0; k < 8; k++) {
                    a0 += fv[k] * col[rr + k].x;
                    a1 += fv[k] * col[rr + k].y;
                }
                t[p][rr][0] = rnd(a0, 6) - pb;
                t[p][rr][1] = rnd(a1, 6) - pb;
            }
        }
        const int32_t *j = jobs + (size_t)s * C_N;
        const int py = j[C_PY] + ty0 + r0, px = j[C_PX] + tx0 + c0;
        const int mode = j[C_MODE];
        // the combine, branched once per job on its mode
        int out[4][2];
        if (mode == COMP_AVG) {
#pragma unroll
            for (int rr = 0; rr < 4; rr++)
#pragma unroll
                for (int cc = 0; cc < 2; cc++)
                    out[rr][cc] = (t[0][rr][cc] + t[1][rr][cc] +
                                   ((1 << ib) + pb * 2)) >> (ib + 1);
        } else if (mode == COMP_WAVG) {
            const int jw = j[C_JW];
#pragma unroll
            for (int rr = 0; rr < 4; rr++)
#pragma unroll
                for (int cc = 0; cc < 2; cc++)
                    out[rr][cc] = (t[0][rr][cc] * jw + t[1][rr][cc] * (16 - jw) +
                                   ((8 << ib) + pb * 16)) >> (ib + 4);
        } else {
            // masks: seg (w_mask from the preps), the seg plane, a wedge
            const int h = j[C_H], w = j[C_W], sign = j[C_SIGN];
            const int mkind = j[C_MKIND];
            const int cls = max(h, w);
            // wedge masks exist for blocks up to 32x32 only (wedge.h)
            const int8_t *wlut =
                cls <= 16 ? a.wl16 : (cls <= 32 ? a.wl32 : nullptr);
            const int wc = cls <= 16 ? 16 : 32;
            const int wkey =
                iclip((iclip(j[C_CLIDX], 0, 2) * 11 +
                       iclip(j[C_MBS] - a.bs32x32, 0, 10)) * 32 +
                          iclip(j[C_MSIGN] * 16 + j[C_WIDX], 0, 31),
                      0, N_WEDGE - 1);
            int ms[4][2];
#pragma unroll
            for (int rr = 0; rr < 4; rr++) {
#pragma unroll
                for (int cc = 0; cc < 2; cc++) {
                    const int r = ty0 + r0 + rr, c = tx0 + c0 + cc;
                    const int t0 = t[0][rr][cc], t1 = t[1][rr][cc];
                    const int ts0 = sign == 1 ? t1 : t0;
                    const int ts1 = sign == 1 ? t0 : t1;
                    const int tdiff = ts0 - ts1;
                    const int m_seg =
                        min(38 + ((abs(tdiff) + mask_rnd) >> mask_sh), 64);
                    ms[rr][cc] = m_seg;
                    int m = 0;
                    if (mode == COMP_SEG) {
                        m = m_seg;
                    } else if (mkind == 2 && a.seg_mode == 2) {
                        m = a.seg[(size_t)iclip(py + rr, 0, a.seg_h - 1) *
                                      a.seg_w +
                                  iclip(px + cc, 0, a.seg_w - 1)];
                    } else if (mkind == 1 && wlut != nullptr) {
                        m = wlut[((size_t)wkey * wc + r) * wc + c];
                    }
                    out[rr][cc] = (tdiff * m + ts1 * 64 +
                                   ((32 << ib) + pb * 64)) >> (ib + 6);
                }
            }
            if (a.seg_mode == 1 && mode == COMP_SEG) {
                // the w_mask weights subsampled to chroma coordinates;
                // the patch's rows and columns start even, so it holds
                // whole quads
                const int ys = (j[C_PY] >> a.ss_ver) +
                               ((ty0 + r0) >> a.ss_ver);
                const int xs = (j[C_PX] >> a.ss_hor) +
                               ((tx0 + c0) >> a.ss_hor);
#pragma unroll
                for (int rr = 0; rr < 4; rr++) {
                    if (a.ss_ver && (rr & 1)) continue;
                    const int y = ys + (a.ss_ver ? rr >> 1 : rr);
                    if (y >= a.seg_h) continue;
                    if (a.ss_hor) {
                        const int pair0 = ms[rr][0] + ms[rr][1];
                        // rr | 1: the quad's second row (rr is even then)
                        const int v =
                            a.ss_ver ? (pair0 + ms[rr | 1][0] +
                                        ms[rr | 1][1] + 2 - sign) >> 2
                                     : (pair0 + 1 - sign) >> 1;
                        if (xs < a.seg_w) a.seg[(size_t)y * a.seg_w + xs] = v;
                    } else {
#pragma unroll
                        for (int cc = 0; cc < 2; cc++)
                            if (xs + cc < a.seg_w)
                                a.seg[(size_t)y * a.seg_w + xs + cc] =
                                    ms[rr][cc];
                    }
                }
            }
        }
#pragma unroll
        for (int rr = 0; rr < 4; rr++) {
            if (py + rr >= a.dst_h) break;
            int32_t *d = a.dst + (size_t)(py + rr) * a.dst_w + px;
#pragma unroll
            for (int cc = 0; cc < 2; cc++)
                if (px + cc < a.dst_w) d[cc] = iclip(out[rr][cc], 0, px_max);
        }
    }
}

__global__ void __launch_bounds__(THREADS) mc_comp_kernel(const Args a) {
    __shared__ __align__(16) int smem[SMEM_WORDS];
    const int32_t *b = a.blocks + (size_t)blockIdx.x * B_N;
    const int cls = b[B_CLS], count = b[B_COUNT];
    const int ty0 = b[B_TY0], tx0 = b[B_TX0];
    const int32_t *jobs = a.jobs + (size_t)b[B_FIRST] * C_N;
    const int ib = a.bd == 8 ? 4 : 14 - a.bd;
#define CLASS(k, th, tw)                                              \
    case k:                                                           \
        load_hpass<th, tw>(a, jobs, count, ty0, tx0, ib, smem);       \
        break;
    switch (cls) {
        CLASS(0, 4, 4) CLASS(1, 4, 8) CLASS(2, 4, 16) CLASS(3, 4, 32)
        CLASS(4, 8, 4) CLASS(5, 8, 8) CLASS(6, 8, 16) CLASS(7, 8, 32)
        CLASS(8, 16, 4) CLASS(9, 16, 8) CLASS(10, 16, 16) CLASS(11, 16, 32)
        CLASS(12, 32, 4) CLASS(13, 32, 8) CLASS(14, 32, 16)
        CLASS(15, 32, 32)
    default: __trap();
    }
#undef CLASS
    vpass_combine(a, jobs, count, ty0, tx0, cls, ib, smem);
}

}  // namespace

// Copy the (2, 4, 16, 8) int32 filter bank to the device; called once
// when the library is loaded.
extern "C" int mc_comp_set_filters(const int32_t *fb_host) {
    cudaMemcpyToSymbol(g_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    return (int)cudaGetLastError();
}

// Launch the compound over the n_blocks block rows of a class-sorted job
// table on `stream`. seg_mode: 0 no seg plane, 1 luma (writes seg), 2
// chroma (reads seg). wl16 / wl32: the (1056, 16, 16) and (1056, 32, 32)
// int8 wedge LUTs on the device.
extern "C" int mc_comp(const void *const *ref_ptrs, int n_refs, int ref_w,
                       const int32_t *jobs, const int32_t *blocks,
                       int n_blocks, int32_t *dst, int dst_h, int dst_w,
                       int32_t *seg, int seg_h, int seg_w, const int8_t *wl16,
                       const int8_t *wl32, int rh, int rw, int bd,
                       int seg_mode, int ss_hor, int ss_ver, int bs32x32,
                       void *stream) {
    Args a;
    for (int i = 0; i < MAX_REFS; i++)
        a.refs.p[i] = (const int32_t *)(i < n_refs ? ref_ptrs[i] : nullptr);
    a.ref_w = ref_w;
    a.jobs = jobs;
    a.blocks = blocks;
    a.dst = dst;
    a.dst_h = dst_h;
    a.dst_w = dst_w;
    a.seg = seg;
    a.seg_h = seg_h;
    a.seg_w = seg_w;
    a.wl16 = wl16;
    a.wl32 = wl32;
    a.rh = rh;
    a.rw = rw;
    a.bd = bd;
    a.seg_mode = seg_mode;
    a.ss_hor = ss_hor;
    a.ss_ver = ss_ver;
    a.bs32x32 = bs32x32;
    a.vec = ref_w % 4 == 0;
    for (int i = 0; i < n_refs; i++)
        a.vec &= ((uintptr_t)ref_ptrs[i] & 15) == 0;
    if (n_blocks > 0)
        mc_comp_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// jobs_per_block(th, tw) as the kernel computes it, for the host's check
extern "C" int mc_comp_jobs_per_block(int th, int tw) {
    return jobs_per_block(th, tw);
}
