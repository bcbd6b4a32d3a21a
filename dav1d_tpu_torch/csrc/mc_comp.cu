// AV1 two-reference compound prediction over a table of jobs: two
// 8-tap preps per block, then the avg / distance-weighted avg / seg
// mask / wedge mask combine.
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
// Design. One thread block per job walks it in 32x32 tiles. Per tile,
// each prep runs horizontal taps into a shared (32+7)x32 int32
// intermediate and vertical taps into a shared 32x32 prep tile
// (rounds 6-ib and 6, minus the prep bias), reading the reference plane
// directly with the emu-edge clamp (as csrc/mc_put.cu). The combine then
// reads both prep tiles per pixel. Wedge masks come from the dense
// per-class int8 LUTs (dav1d_tpu mc_fused._wedge_lut(16) and (32)),
// uploaded once. Luma seg jobs (seg_mode 1) keep their w_mask weights in
// shared memory and write the 4:2:0 / 4:2:2 / 4:4:4 subsampled mask into
// the seg plane at chroma coordinates; chroma jobs with mkind 2
// (seg_mode 2) read it. The luma launch precedes the chroma launch on
// one stream, which orders producer before consumer.
//
// Bound: memory. Per job the output is written once and each prep reads
// its reference window; a 1080p inter frame's compounds (~2.5k jobs on
// the s7 stream) cover well under the frame, a few MB, a few us at
// 3.35 TB/s. This first version is simple, not fast: small jobs leave
// most threads idle, and each reference pixel is read 8 times from cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_REFS = 8;
constexpr int N_WEDGE = 3 * 11 * 32;

enum { C_PLANE, C_H, C_W, C_PY, C_PX, C_MODE, C_JW, C_SIGN, C_MKIND,
       C_CLIDX, C_MBS, C_MSIGN, C_WIDX, C_P0, C_P1 = C_P0 + 6,
       C_N = C_P1 + 6 };
// prep column offsets from C_P0 / C_P1
enum { P_DY, P_DX, P_AMX, P_AMY, P_FT, P_SLOT };
enum { COMP_WAVG = 1, COMP_AVG = 2, COMP_SEG = 3 };

__constant__ int c_fb[2][4][16][8];

struct Refs {
    const int32_t *p[MAX_REFS];
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

// one 8-tap prep of tile (ty0, tx0) into out[r * TILE + c]
__device__ void prep_tile(const Refs &refs, int ref_w, const int32_t *p,
                          int h, int w, int ty0, int tx0, int th, int tw,
                          int rh, int rw, int ib, int pb, int *mid,
                          int *out) {
    const int32_t *__restrict__ ref = refs.p[p[P_SLOT]];
    const int dy = p[P_DY], dx = p[P_DX], ft = p[P_FT];
    const int *fh = c_fb[w <= 4][ft & 3][p[P_AMX]];
    const int *fv = c_fb[h <= 4][(ft >> 2) & 3][p[P_AMY]];
    for (int i = threadIdx.x; i < (th + 7) * tw; i += THREADS) {
        const int r = i / tw, c = i - r * tw;
        const int32_t *src =
            ref + (size_t)iclip(dy - 3 + ty0 + r, 0, rh - 1) * ref_w;
        const int c0 = dx - 3 + tx0 + c;
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; t++)
            acc += fh[t] * src[iclip(c0 + t, 0, rw - 1)];
        mid[r * TILE + c] = rnd(acc, 6 - ib);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < th * tw; i += THREADS) {
        const int r = i / tw, c = i - r * tw;
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 8; t++) acc += fv[t] * mid[(r + t) * TILE + c];
        out[r * TILE + c] = rnd(acc, 6) - pb;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
mc_comp_kernel(Refs refs, int ref_w, const int32_t *__restrict__ jobs,
            int32_t *__restrict__ dst, int dst_h, int dst_w,
            int32_t *__restrict__ seg, int seg_h, int seg_w,
            const int8_t *__restrict__ wl16, const int8_t *__restrict__ wl32,
            int rh, int rw, int bd, int seg_mode, int ss_hor, int ss_ver,
            int bs32x32) {
    __shared__ int mid[(TILE + 7) * TILE];
    __shared__ int t0s[TILE * TILE];
    __shared__ int t1s[TILE * TILE];
    const int32_t *j = jobs + (size_t)blockIdx.x * C_N;
    const int h = j[C_H], w = j[C_W], py = j[C_PY], px = j[C_PX];
    const int mode = j[C_MODE], jw = j[C_JW], sign = j[C_SIGN];
    const int mkind = j[C_MKIND];
    const int ib = bd == 8 ? 4 : 14 - bd;
    const int pb = bd == 8 ? 0 : 8192;
    const int px_max = (1 << bd) - 1;
    const int mask_sh = bd + ib - 4;
    const int mask_rnd = 1 << (mask_sh - 5);
    const int cls = max(h, w);
    // wedge masks exist for blocks up to 32x32 only (reference wedge.h)
    const int8_t *wlut = cls <= 16 ? wl16 : (cls <= 32 ? wl32 : nullptr);
    const int wc = cls <= 16 ? 16 : 32;
    const int wkey = iclip((iclip(j[C_CLIDX], 0, 2) * 11 +
                            iclip(j[C_MBS] - bs32x32, 0, 10)) * 32 +
                               iclip(j[C_MSIGN] * 16 + j[C_WIDX], 0, 31),
                           0, N_WEDGE - 1);
    const bool write_seg = seg_mode == 1 && mode == COMP_SEG;

    for (int ty0 = 0; ty0 < h; ty0 += TILE) {
        const int th = min(TILE, h - ty0);
        for (int tx0 = 0; tx0 < w; tx0 += TILE) {
            const int tw = min(TILE, w - tx0);
            prep_tile(refs, ref_w, j + C_P0, h, w, ty0, tx0, th, tw, rh, rw,
                      ib, pb, mid, t0s);
            prep_tile(refs, ref_w, j + C_P1, h, w, ty0, tx0, th, tw, rh, rw,
                      ib, pb, mid, t1s);
            for (int i = threadIdx.x; i < th * tw; i += THREADS) {
                const int r = i / tw, c = i - r * tw;
                const int t0 = t0s[r * TILE + c], t1 = t1s[r * TILE + c];
                const int ts0 = sign == 1 ? t1 : t0;
                const int ts1 = sign == 1 ? t0 : t1;
                const int tdiff = ts0 - ts1;
                const int y = py + ty0 + r, x = px + tx0 + c;
                const int m_seg = min(
                    38 + ((abs(tdiff) + mask_rnd) >> mask_sh), 64);
                int out;
                if (mode == COMP_AVG) {
                    out = (t0 + t1 + ((1 << ib) + pb * 2)) >> (ib + 1);
                } else if (mode == COMP_WAVG) {
                    out = (t0 * jw + t1 * (16 - jw) + ((8 << ib) + pb * 16))
                          >> (ib + 4);
                } else {
                    int m = 0;
                    if (mode == COMP_SEG) {
                        m = m_seg;
                    } else if (mkind == 2 && seg_mode == 2) {
                        m = seg[(size_t)iclip(y, 0, seg_h - 1) * seg_w +
                                iclip(x, 0, seg_w - 1)];
                    } else if (mkind == 1 && wlut != nullptr) {
                        m = wlut[((size_t)wkey * wc + ty0 + r) * wc + tx0 + c];
                    }
                    out = (tdiff * m + ts1 * 64 + ((32 << ib) + pb * 64)) >>
                          (ib + 6);
                }
                if (y < dst_h && x < dst_w)
                    dst[(size_t)y * dst_w + x] = iclip(out, 0, px_max);
                if (write_seg) mid[r * TILE + c] = m_seg;
            }
            if (write_seg) {
                __syncthreads();
                // subsample the w_mask weights to chroma coordinates
                const int tch = th >> ss_ver, tcw = tw >> ss_hor;
                for (int i = threadIdx.x; i < tch * tcw; i += THREADS) {
                    const int r = i / tcw, c = i - r * tcw;
                    int v;
                    if (ss_hor) {
                        const int *m0 = mid + (r << ss_ver) * TILE + 2 * c;
                        const int pair0 = m0[0] + m0[1];
                        if (ss_ver)
                            v = (pair0 + m0[TILE] + m0[TILE + 1] + 2 - sign) >> 2;
                        else
                            v = (pair0 + 1 - sign) >> 1;
                    } else {
                        v = mid[r * TILE + c];
                    }
                    const int y = (py >> ss_ver) + (ty0 >> ss_ver) + r;
                    const int x = (px >> ss_hor) + (tx0 >> ss_hor) + c;
                    if (y < seg_h && x < seg_w) seg[(size_t)y * seg_w + x] = v;
                }
            }
            __syncthreads();
        }
    }
}

}  // namespace

// Copy the (2, 4, 16, 8) int32 filter bank into constant memory; called
// once when the library is loaded.
extern "C" int mc_comp_set_filters(const int32_t *fb_host) {
    cudaMemcpyToSymbol(c_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    return (int)cudaGetLastError();
}

// Launch the compound over n jobs on `stream`. seg_mode: 0 no seg plane,
// 1 luma (writes seg), 2 chroma (reads seg). wl16 / wl32: the
// (1056, 16, 16) and (1056, 32, 32) int8 wedge LUTs on the device.
extern "C" int mc_comp(const void *const *ref_ptrs, int n_refs, int ref_w,
                       const int32_t *jobs, int n, int32_t *dst, int dst_h,
                       int dst_w, int32_t *seg, int seg_h, int seg_w,
                       const int8_t *wl16, const int8_t *wl32, int rh, int rw,
                       int bd, int seg_mode, int ss_hor, int ss_ver,
                       int bs32x32, void *stream) {
    Refs refs;
    for (int i = 0; i < MAX_REFS; i++)
        refs.p[i] = (const int32_t *)(i < n_refs ? ref_ptrs[i] : nullptr);
    if (n > 0)
        mc_comp_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
            refs, ref_w, jobs, dst, dst_h, dst_w, seg, seg_h, seg_w, wl16,
            wl32, rh, rw, bd, seg_mode, ss_hor, ss_ver, bs32x32);
    return (int)cudaGetLastError();
}
