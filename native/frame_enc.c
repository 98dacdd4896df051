/* Whole-frame native backend: conformant commit pass + entropy pass.
 *
 * Counterpart of the reference's Encode Pass + entropy process
 * (Source/Lib/Codec/coding_loop.c:1697 svt_aom_encode_decode,
 *  Source/Lib/Codec/ec_process.c:208 entropy_coding_kernel), redesigned
 * for this framework's split: the device produces per-block decisions
 * (modes, partitions, full-pel MVs); this file executes the *conformant*
 * per-frame tail at native speed — intra prediction from recon
 * neighbors, sub-pel refinement + 8-tap MC, exact fwd/inv transforms,
 * quantization, recon update — and then emits the full tile syntax with
 * CDF adaptation (entropy pass, frame_enc_ec.c half).
 *
 * The Python TileWriter (bitstream/tile_writer.py) remains the oracle:
 * both paths are held bit-identical by tests (SVT_TPU_PY_EC=1 and
 * SVT_TPU_PY_COMMIT=1 flip back to the Python implementations).
 *
 * Scope (v1): single tile, 64x64 superblocks, NONE/SPLIT partitions,
 * one max-rect tx block per plane per leaf, non-directional intra modes
 * (the device lattice's candidate set), single-ref inter with
 * NEAREST/NEAR/GLOBAL/NEW mapping, compound average inter
 * (NEW_NEW/GLOBAL_GLOBAL + joint NEAREST/NEAR matches). Python falls
 * back for anything wider.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- shared with ecenc.c (same .so) ---------------------------------- */
extern int32_t svt_txb_commit(const int64_t *d, const int32_t *src,
                              int src_stride, int32_t *recon, int rec_stride,
                              const int32_t *pred, int x, int y,
                              const int64_t *q10, int32_t *qcoeff,
                              int tx_enum, int plane, int is_inter,
                              int qindex);
extern void svt_intra_predict(int mode, const int32_t *above,
                              const int32_t *left, int w, int h,
                              int have_above, int have_left, int bit_depth,
                              const int32_t *sm_w, const int32_t *sm_h,
                              int32_t *out);

/* ---- block geometry tables (codec/constants.py; normative spec dims) -- */
#define N_BSIZES 22
static const uint8_t BLOCK_W4[N_BSIZES] = {1, 1, 2, 2,  2,  4, 4, 4, 8, 8, 8,
                                           16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
static const uint8_t BLOCK_H4[N_BSIZES] = {1, 2, 1, 2,  4,  2, 4, 8, 4, 8, 16,
                                           8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
static const uint8_t MAX_TX_RECT[N_BSIZES] = {0, 5, 6, 1,  7,  8,  2,  9,
                                              10, 3, 11, 12, 4,  4,  4,  4,
                                              13, 14, 15, 16, 17, 18};
#define N_TXS 19
static const uint8_t TXW[N_TXS] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                                   32, 32, 64, 4, 16, 8, 32, 16, 64};
static const uint8_t TXH[N_TXS] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                                   16, 64, 32, 16, 4, 32, 8, 64, 16};

/* leaf record layout (int32), must match native/frame_enc.py */
enum {
    LF_R = 0, LF_C, LF_BSIZE, LF_FLAGS, LF_YMODE, LF_UVMODE, LF_REF0,
    LF_MVY, LF_MVX, LF_QIDX,
    LF_SKIP, LF_EOB_Y, LF_EOB_U, LF_EOB_V,
    LF_OFF_Y, LF_OFF_U, LF_OFF_V,
    LF_MVY_OUT, LF_MVX_OUT, LF_MODE_OUT, LF_DRL_OUT,
    LF_TXS_Y, LF_TXS_UV,
    LF_REF1, LF_MVY1, LF_MVX1, LF_MVY1_OUT, LF_MVX1_OUT, LF_RSVD,
    LF_TXD, LF_EOB_Y1, LF_EOB_Y2, LF_EOB_Y3,
    LF_OFF_Y1, LF_OFF_Y2, LF_OFF_Y3,
    LEAF_I32
};
#define FLAG_INTER 1
#define FLAG_COMP 2

/* TX_MODE_SELECT depth-1 split of the square max-rect sizes
 * (codec/constants.py SPLIT_TX_SIZE; device leaves are square only) */
static const int8_t SPLIT_TX[N_TXS] = {0, 0, 1, 2, 3, -1, -1, -1, -1, -1,
                                       -1, -1, -1, -1, -1, -1, -1, -1, -1};

/* ---- commit job (pointers marshalled from Python as int64 slots) ------ */
typedef struct {
    int32_t *src[3], *recon[3];
    int stride[3];          /* aligned plane stride (elements) */
    int disp_w[3], disp_h[3]; /* display dims for MC clamp (spec 7.11.3.3) */
    int ss_x, ss_y, mono;
    int bit_depth;
    int mi_rows, mi_cols;
    const int32_t *ref_pl[8][3];
    int ref_stride[8][3], ref_w[8][3], ref_h[8][3];
    const int64_t *tx_desc[N_TXS];
    const int64_t *q10;     /* (3, 256, 10) int64 per plane x qindex */
    const int32_t *sm_weights; /* sm_weight_arrays full table */
    const int16_t *subpel8;    /* (4 filters, 16 phases, 8 taps) int16 */
    const int16_t *subpel4;
    int32_t *leaves;
    int n_leaves;
    int32_t *qcoeff;
    int64_t qcoeff_cap;
    /* TX_MODE_SELECT (tx-depth search at commit): 0 = TX_MODE_LARGEST */
    int tx_select;
    const int64_t *rdmult_tab;   /* (256,) J-multiplier per qindex */
    const int32_t *txd_intra;    /* (N_BSIZES, 2) depth symbol cost<<9 */
    const int32_t *txd_inter;    /* (N_BSIZES, 2) vartx flags cost<<9 */
} CommitJob;

static CommitJob g_job;

/* slots: see frame_enc.py _pack_job */
void svt_commit_init(const int64_t *s) {
    CommitJob *j = &g_job;
    int k = 0;
    for (int p = 0; p < 3; p++) j->src[p] = (int32_t *)s[k++];
    for (int p = 0; p < 3; p++) j->recon[p] = (int32_t *)s[k++];
    for (int p = 0; p < 3; p++) j->stride[p] = (int)s[k++];
    for (int p = 0; p < 3; p++) j->disp_w[p] = (int)s[k++];
    for (int p = 0; p < 3; p++) j->disp_h[p] = (int)s[k++];
    j->ss_x = (int)s[k++]; j->ss_y = (int)s[k++]; j->mono = (int)s[k++];
    j->bit_depth = (int)s[k++];
    j->mi_rows = (int)s[k++]; j->mi_cols = (int)s[k++];
    for (int r = 0; r < 8; r++)
        for (int p = 0; p < 3; p++) {
            j->ref_pl[r][p] = (const int32_t *)s[k++];
            j->ref_stride[r][p] = (int)s[k++];
            j->ref_w[r][p] = (int)s[k++];
            j->ref_h[r][p] = (int)s[k++];
        }
    for (int t = 0; t < N_TXS; t++) j->tx_desc[t] = (const int64_t *)s[k++];
    j->q10 = (const int64_t *)s[k++];
    j->sm_weights = (const int32_t *)s[k++];
    j->subpel8 = (const int16_t *)s[k++];
    j->subpel4 = (const int16_t *)s[k++];
    j->leaves = (int32_t *)s[k++];
    j->n_leaves = (int)s[k++];
    j->qcoeff = (int32_t *)s[k++];
    j->qcoeff_cap = s[k++];
    j->tx_select = (int)s[k++];
    j->rdmult_tab = (const int64_t *)s[k++];
    j->txd_intra = (const int32_t *)s[k++];
    j->txd_inter = (const int32_t *)s[k++];
}

/* ---- intra neighbor fill (ops/intra.py fill_neighbors) ---------------- */
/* mode needs: DC/SMOOTH/SMOOTH_V/SMOOTH_H/PAETH both; V above; H left */
static void mode_needs(int mode, int *na, int *nl) {
    *na = (mode != 2);
    *nl = (mode != 1);
}

/* returns 1 and sets *flat when the early-exit constant fill applies */
static int fill_neighbors(const int32_t *recon, int stride, int x, int y,
                          int w, int h, int have_above, int have_left,
                          int mode, int bit_depth, int32_t *above,
                          int32_t *left, int32_t *flat) {
    const int base = 1 << (bit_depth - 1);
    int na, nl;
    mode_needs(mode, &na, &nl);
    const int n_top = have_above ? w : 0;
    const int n_left = have_left ? h : 0;
    if ((!na && n_left == 0) || (!nl && n_top == 0)) {
        if (nl)
            *flat = n_top > 0 ? recon[(int64_t)(y - 1) * stride + x] : base + 1;
        else
            *flat = n_left > 0 ? recon[(int64_t)y * stride + x - 1] : base - 1;
        return 1;
    }
    if (n_left > 0)
        for (int i = 0; i < h; i++)
            left[i] = recon[(int64_t)(y + i) * stride + x - 1];
    else {
        int32_t v = n_top > 0 ? recon[(int64_t)(y - 1) * stride + x] : base + 1;
        for (int i = 0; i < h; i++) left[i] = v;
    }
    if (n_top > 0)
        memcpy(above + 1, recon + (int64_t)(y - 1) * stride + x,
               (size_t)w * sizeof(int32_t));
    else {
        int32_t v = n_left > 0 ? recon[(int64_t)y * stride + x - 1] : base - 1;
        for (int i = 0; i < w; i++) above[1 + i] = v;
    }
    if (n_top > 0 && n_left > 0)
        above[0] = recon[(int64_t)(y - 1) * stride + x - 1];
    else if (n_top > 0)
        above[0] = recon[(int64_t)(y - 1) * stride + x];
    else if (n_left > 0)
        above[0] = recon[(int64_t)y * stride + x - 1];
    else
        above[0] = base;
    return 0;
}

/* ---- sub-pel motion compensation (ops/mc.py mc_block, REGULAR only) --- */
#define FILTER_BITS 7
#define ROUND0 3

static inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int64_t rp2(int64_t x, int n) {
    return n == 0 ? x : ((x + ((int64_t)1 << (n - 1))) >> n);
}

/* gather a (h, w) patch at (x0, y0) with spec coordinate clamping */
static void mc_patch(const int32_t *ref, int stride, int rw, int rh, int x0,
                     int y0, int w, int h, int64_t *out) {
    for (int r = 0; r < h; r++) {
        const int32_t *row = ref + (int64_t)clampi(y0 + r, 0, rh - 1) * stride;
        for (int c = 0; c < w; c++)
            out[(int64_t)r * w + c] = row[clampi(x0 + c, 0, rw - 1)];
    }
}

static int64_t MC_TMP[(64 + 7) * (64 + 7)];
static int64_t MC_TMP2[(64 + 7) * (64 + 7)];

/* predict a (h, w) block at plane pos (x, y); mv in 1/8-pel luma units */
static void mc_block(const int32_t *ref, int stride, int rw, int rh, int x,
                     int y, int w, int h, int mv_row, int mv_col, int ss_x,
                     int ss_y, int bit_depth, const int16_t *f8,
                     const int16_t *f4, int32_t *out) {
    int ix, iy, subx, suby;
    if (ss_x) { ix = x + (mv_col >> 4); subx = mv_col & 15; }
    else      { ix = x + (mv_col >> 3); subx = (mv_col & 7) << 1; }
    if (ss_y) { iy = y + (mv_row >> 4); suby = mv_row & 15; }
    else      { iy = y + (mv_row >> 3); suby = (mv_row & 7) << 1; }
    const int maxv = (1 << bit_depth) - 1;

    if (subx == 0 && suby == 0) {
        for (int r = 0; r < h; r++) {
            const int32_t *row =
                ref + (int64_t)clampi(iy + r, 0, rh - 1) * stride;
            for (int c = 0; c < w; c++)
                out[(int64_t)r * w + c] = row[clampi(ix + c, 0, rw - 1)];
        }
        return;
    }
    const int16_t *ftab_x = (w <= 4) ? f4 : f8;
    const int16_t *ftab_y = (h <= 4) ? f4 : f8;
    const int16_t *kx = ftab_x + (subx & 15) * 8;
    const int16_t *ky = ftab_y + (suby & 15) * 8;

    if (suby == 0) { /* x only */
        mc_patch(ref, stride, rw, rh, ix - 3, iy, w + 7, h, MC_TMP);
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t s = 0;
                for (int k = 0; k < 8; k++)
                    s += (int64_t)kx[k] * MC_TMP[(int64_t)r * (w + 7) + c + k];
                s = rp2(s, ROUND0);
                s = rp2(s, FILTER_BITS - ROUND0);
                out[(int64_t)r * w + c] = (int32_t)clampi((int)s, 0, maxv);
            }
        return;
    }
    if (subx == 0) { /* y only */
        mc_patch(ref, stride, rw, rh, ix, iy - 3, w, h + 7, MC_TMP);
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t s = 0;
                for (int k = 0; k < 8; k++)
                    s += (int64_t)ky[k] * MC_TMP[(int64_t)(r + k) * w + c];
                s = rp2(s, FILTER_BITS);
                out[(int64_t)r * w + c] = (int32_t)clampi((int)s, 0, maxv);
            }
        return;
    }
    /* 2D */
    const int round1 = 2 * FILTER_BITS - ROUND0; /* 11 */
    const int bd = bit_depth;
    const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
    const int im_h = h + 7;
    mc_patch(ref, stride, rw, rh, ix - 3, iy - 3, w + 7, im_h, MC_TMP);
    for (int r = 0; r < im_h; r++)
        for (int c = 0; c < w; c++) {
            int64_t s = 0;
            for (int k = 0; k < 8; k++)
                s += (int64_t)kx[k] * MC_TMP[(int64_t)r * (w + 7) + c + k];
            MC_TMP2[(int64_t)r * w + c] =
                rp2(s + ((int64_t)1 << (bd + FILTER_BITS - 1)), ROUND0);
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t s = 0;
            for (int k = 0; k < 8; k++)
                s += (int64_t)ky[k] * MC_TMP2[(int64_t)(r + k) * w + c];
            int64_t res = rp2(s + ((int64_t)1 << offset_bits), round1) -
                          (((int64_t)1 << (offset_bits - round1)) +
                           ((int64_t)1 << (offset_bits - round1 - 1)));
            out[(int64_t)r * w + c] = (int32_t)clampi((int)res, 0, maxv);
        }
}

/* ---- compound MC (ops/mc.py mc_block_convbuf + compound_average) ------
 * Counterpart: svt_av1_jnt_convolve_* (inter_prediction.c:494-660),
 * compound_idx = 1 (plain average), REGULAR filter. Predictions stay in
 * the high-precision CONV domain (round_0 = 3, round_1 = 7), then the
 * pair is averaged and rounded to pixels. */
#define COMP_ROUND1 7

static int32_t CONV0[64 * 64], CONV1[64 * 64];

static void mc_convbuf(const int32_t *ref, int stride, int rw, int rh,
                       int x, int y, int w, int h, int mv_row, int mv_col,
                       int ss_x, int ss_y, int bit_depth, const int16_t *f8,
                       const int16_t *f4, int32_t *out) {
    int ix, iy, subx, suby;
    if (ss_x) { ix = x + (mv_col >> 4); subx = mv_col & 15; }
    else      { ix = x + (mv_col >> 3); subx = (mv_col & 7) << 1; }
    if (ss_y) { iy = y + (mv_row >> 4); suby = mv_row & 15; }
    else      { iy = y + (mv_row >> 3); suby = (mv_row & 7) << 1; }
    const int bd = bit_depth;
    const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
    const int64_t round_offset =
        ((int64_t)1 << (offset_bits - COMP_ROUND1)) +
        ((int64_t)1 << (offset_bits - COMP_ROUND1 - 1));
    const int16_t *ftab_x = (w <= 4) ? f4 : f8;
    const int16_t *ftab_y = (h <= 4) ? f4 : f8;
    const int16_t *kx = ftab_x + (subx & 15) * 8;
    const int16_t *ky = ftab_y + (suby & 15) * 8;

    if (subx == 0 && suby == 0) { /* jnt_convolve_2d_copy */
        const int bits = 2 * FILTER_BITS - ROUND0 - COMP_ROUND1;
        for (int r = 0; r < h; r++) {
            const int32_t *row =
                ref + (int64_t)clampi(iy + r, 0, rh - 1) * stride;
            for (int c = 0; c < w; c++)
                out[(int64_t)r * w + c] = (int32_t)(
                    ((int64_t)row[clampi(ix + c, 0, rw - 1)] << bits) +
                    round_offset);
        }
        return;
    }
    if (suby == 0) { /* jnt_convolve_x: bits = FILTER_BITS - round_1 = 0 */
        mc_patch(ref, stride, rw, rh, ix - 3, iy, w + 7, h, MC_TMP);
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t s = 0;
                for (int k = 0; k < 8; k++)
                    s += (int64_t)kx[k] * MC_TMP[(int64_t)r * (w + 7) + c + k];
                out[(int64_t)r * w + c] =
                    (int32_t)(rp2(s, ROUND0) + round_offset);
            }
        return;
    }
    if (subx == 0) { /* jnt_convolve_y */
        const int bits = FILTER_BITS - ROUND0; /* 4 */
        mc_patch(ref, stride, rw, rh, ix, iy - 3, w, h + 7, MC_TMP);
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t s = 0;
                for (int k = 0; k < 8; k++)
                    s += (int64_t)ky[k] * MC_TMP[(int64_t)(r + k) * w + c];
                out[(int64_t)r * w + c] =
                    (int32_t)(rp2(s << bits, COMP_ROUND1) + round_offset);
            }
        return;
    }
    /* 2D */
    const int im_h = h + 7;
    mc_patch(ref, stride, rw, rh, ix - 3, iy - 3, w + 7, im_h, MC_TMP);
    for (int r = 0; r < im_h; r++)
        for (int c = 0; c < w; c++) {
            int64_t s = 0;
            for (int k = 0; k < 8; k++)
                s += (int64_t)kx[k] * MC_TMP[(int64_t)r * (w + 7) + c + k];
            MC_TMP2[(int64_t)r * w + c] =
                rp2(s + ((int64_t)1 << (bd + FILTER_BITS - 1)), ROUND0);
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t s = 0;
            for (int k = 0; k < 8; k++)
                s += (int64_t)ky[k] * MC_TMP2[(int64_t)(r + k) * w + c];
            out[(int64_t)r * w + c] =
                (int32_t)rp2(s + ((int64_t)1 << offset_bits), COMP_ROUND1);
        }
}

static void comp_avg(const int32_t *b0, const int32_t *b1, int n,
                     int bit_depth, int32_t *out) {
    const int offset_bits = bit_depth + 2 * FILTER_BITS - ROUND0;
    const int64_t round_offset =
        ((int64_t)1 << (offset_bits - COMP_ROUND1)) +
        ((int64_t)1 << (offset_bits - COMP_ROUND1 - 1));
    const int round_bits = 2 * FILTER_BITS - ROUND0 - COMP_ROUND1; /* 4 */
    const int maxv = (1 << bit_depth) - 1;
    for (int i = 0; i < n; i++) {
        int64_t tmp = (((int64_t)b0[i] + b1[i]) >> 1) - round_offset;
        out[i] = (int32_t)clampi((int)rp2(tmp, round_bits), 0, maxv);
    }
}

/* ---- quarter-pel refinement (codec/md.py _subpel_refine) -------------- */
static int32_t SP_PRED[64 * 64];

static int64_t sse_at(const CommitJob *j, int ref_id, int x, int y, int w,
                      int h, int mvr, int mvc) {
    mc_block(j->ref_pl[ref_id][0], j->ref_stride[ref_id][0],
             j->ref_w[ref_id][0], j->ref_h[ref_id][0], x, y, w, h, mvr, mvc,
             0, 0, j->bit_depth, j->subpel8, j->subpel4, SP_PRED);
    const int32_t *src = j->src[0];
    const int st = j->stride[0];
    int64_t sse = 0;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t d = src[(int64_t)(y + r) * st + x + c] -
                        SP_PRED[(int64_t)r * w + c];
            sse += d * d;
        }
    return sse;
}

static void subpel_refine(const CommitJob *j, int ref_id, int x, int y,
                          int w, int h, int *mvr, int *mvc) {
    static const int DMV[5][2] = {{0, 0}, {-2, 0}, {2, 0}, {0, -2}, {0, 2}};
    int br = *mvr, bc = *mvc;
    int64_t best = -1;
    for (int round = 0; round < 2; round++) {
        int improved = 0, nr = br, nc = bc;
        for (int i = 0; i < 5; i++) {
            int cr = br + DMV[i][0], cc = bc + DMV[i][1];
            int64_t s = sse_at(j, ref_id, x, y, w, h, cr, cc);
            if (best < 0 || s < best) {
                best = s;
                nr = cr; nc = cc;
                improved = (i != 0);
            }
        }
        if (!improved) break;
        br = nr; bc = nc;
    }
    *mvr = br; *mvc = bc;
}

/* ---- per-leaf commit --------------------------------------------------- */
static int bsize_of_dims(int w4, int h4) {
    for (int b = 0; b < N_BSIZES; b++)
        if (BLOCK_W4[b] == w4 && BLOCK_H4[b] == h4) return b;
    return -1;
}

static int has_chroma(const CommitJob *j, int r, int c, int bw4, int bh4) {
    if (j->mono) return 0;
    int ok_y = (r % 2 == 1) || (bh4 % 2 == 0) || (j->ss_y == 0);
    int ok_x = (c % 2 == 1) || (bw4 % 2 == 0) || (j->ss_x == 0);
    return ok_y && ok_x;
}

static int32_t PRED[64 * 64];
static int32_t NB_ABOVE[65], NB_LEFT[64];

/* per-tx quant row: zbin/round are rounded by the tx log scale
 * (av1_get_tx_scale, area-based; ops/quant.py quantize_b) */
static void q10_for_tx(const CommitJob *j, int plane, int qindex, int tx,
                       int64_t *out) {
    const int64_t *base = j->q10 + ((int64_t)plane * 256 + qindex) * 10;
    const int pels = TXW[tx] * TXH[tx];
    const int ls = (pels > 256) + (pels > 1024);
    for (int i = 0; i < 10; i++) out[i] = base[i];
    if (ls) {
        const int64_t r = (int64_t)1 << (ls - 1);
        out[0] = (out[0] + r) >> ls;
        out[1] = (out[1] + r) >> ls;
        out[5] = (out[5] + r) >> ls;
        out[6] = (out[6] + r) >> ls;
    }
}

/* commit one tx block; returns eob. qc must hold min(w,32)*min(h,32). */
static int commit_intra_txb(const CommitJob *j, int plane, int mode, int x,
                            int y, int tx, int qindex, int32_t *qc) {
    const int w = TXW[tx], h = TXH[tx];
    int32_t flat;
    const int32_t *recon = j->recon[plane];
    const int st = j->stride[plane];
    int64_t q10[10];
    q10_for_tx(j, plane, qindex, tx, q10);
    if (fill_neighbors(recon, st, x, y, w, h, y > 0, x > 0, mode,
                       j->bit_depth, NB_ABOVE, NB_LEFT, &flat)) {
        for (int i = 0; i < w * h; i++) PRED[i] = flat;
    } else {
        svt_intra_predict(mode, NB_ABOVE, NB_LEFT, w, h, y > 0, x > 0,
                          j->bit_depth, j->sm_weights + w,
                          j->sm_weights + h, PRED);
    }
    return svt_txb_commit(j->tx_desc[tx], j->src[plane], st, j->recon[plane],
                          st, PRED, x, y, q10, qc, tx, plane, 0, qindex);
}

static int commit_inter_txb(const CommitJob *j, int plane, int ref_id, int x,
                            int y, int tx, int mvr, int mvc, int qindex,
                            int32_t *qc) {
    const int w = TXW[tx], h = TXH[tx];
    const int ss_x = plane ? j->ss_x : 0, ss_y = plane ? j->ss_y : 0;
    int64_t q10[10];
    q10_for_tx(j, plane, qindex, tx, q10);
    mc_block(j->ref_pl[ref_id][plane], j->ref_stride[ref_id][plane],
             j->ref_w[ref_id][plane], j->ref_h[ref_id][plane], x, y, w, h,
             mvr, mvc, ss_x, ss_y, j->bit_depth, j->subpel8, j->subpel4,
             PRED);
    return svt_txb_commit(j->tx_desc[tx], j->src[plane], j->stride[plane],
                          j->recon[plane], j->stride[plane], PRED, x, y, q10,
                          qc, tx, plane, 1, qindex);
}

static int commit_comp_txb(const CommitJob *j, int plane, int ref0, int ref1,
                           int x, int y, int tx, int mvr0, int mvc0,
                           int mvr1, int mvc1, int qindex, int32_t *qc) {
    const int w = TXW[tx], h = TXH[tx];
    const int ss_x = plane ? j->ss_x : 0, ss_y = plane ? j->ss_y : 0;
    int64_t q10[10];
    q10_for_tx(j, plane, qindex, tx, q10);
    mc_convbuf(j->ref_pl[ref0][plane], j->ref_stride[ref0][plane],
               j->ref_w[ref0][plane], j->ref_h[ref0][plane], x, y, w, h,
               mvr0, mvc0, ss_x, ss_y, j->bit_depth, j->subpel8, j->subpel4,
               CONV0);
    mc_convbuf(j->ref_pl[ref1][plane], j->ref_stride[ref1][plane],
               j->ref_w[ref1][plane], j->ref_h[ref1][plane], x, y, w, h,
               mvr1, mvc1, ss_x, ss_y, j->bit_depth, j->subpel8, j->subpel4,
               CONV1);
    comp_avg(CONV0, CONV1, w * h, j->bit_depth, PRED);
    return svt_txb_commit(j->tx_desc[tx], j->src[plane], j->stride[plane],
                          j->recon[plane], j->stride[plane], PRED, x, y, q10,
                          qc, tx, plane, 1, qindex);
}

/* ---- TX_MODE_SELECT depth trial (tx-depth search at commit) -----------
 * Counterpart of the reference's tx-size search (product_coding_loop.c
 * tx search levels) relocated to the conformant commit: the winning
 * candidate's residual is coded at depth 0 (max-rect) and depth 1
 * (4-way uniform split), J-compared with the device lattice's
 * coefficient-rate proxy (device/intra.py RATE_*) + the neutral-ctx
 * depth symbol cost, and the cheaper coding kept.  Integer-exact mirror
 * of codec/md_device.py _tx_depth_trial (tests hold them identical). */
static int32_t TXD_SNAP[64 * 64], TXD_D0[64 * 64], TXD_QC0[32 * 32];

static void blk_save(const int32_t *rec, int st, int x, int y, int w, int h,
                     int32_t *buf) {
    for (int r = 0; r < h; r++)
        memcpy(buf + (int64_t)r * w, rec + (int64_t)(y + r) * st + x,
               (size_t)w * sizeof(int32_t));
}

static void blk_load(int32_t *rec, int st, int x, int y, int w, int h,
                     const int32_t *buf) {
    for (int r = 0; r < h; r++)
        memcpy(rec + (int64_t)(y + r) * st + x, buf + (int64_t)r * w,
               (size_t)w * sizeof(int32_t));
}

static int64_t blk_sse_y(const CommitJob *j, int x, int y, int w, int h) {
    const int32_t *src = j->src[0], *rec = j->recon[0];
    const int st = j->stride[0];
    int64_t s = 0;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t d = src[(int64_t)(y + r) * st + x + c] -
                        rec[(int64_t)(y + r) * st + x + c];
            s += d * d;
        }
    return s;
}

static int ilog2p1(int v) { /* floor(log2(1 + v)), v >= 0 */
    int r = 0;
    v += 1;
    while (v > 1) { v >>= 1; r++; }
    return r;
}

/* device/intra.py rate proxy constants (bits<<9), integer-log variant */
static int64_t rate_proxy(const CommitJob *j, int tx, const int32_t *qc,
                          int eob) {
    if (eob == 0) return 0;
    const int32_t *scan = (const int32_t *)j->tx_desc[tx][42];
    int64_t rate = (int64_t)1946 * ilog2p1(eob);
    int nnz = 0;
    for (int i = 0; i < eob; i++) {
        int q = qc[scan[i]];
        if (q < 0) q = -q;
        if (q) { nnz++; rate += 1229 + 614 * ilog2p1(q); }
    }
    rate += (int64_t)154 * (eob - nnz);
    return rate;
}

/* luma txb commit for whichever prediction the leaf carries */
static int luma_txb(const CommitJob *j, const int32_t *L, int x, int y,
                    int tx, int mvr, int mvc, int mvr1, int mvc1, int qindex,
                    int32_t *qc) {
    if (L[LF_FLAGS] & FLAG_COMP)
        return commit_comp_txb(j, 0, L[LF_REF0], L[LF_REF1], x, y, tx, mvr,
                               mvc, mvr1, mvc1, qindex, qc);
    if (L[LF_FLAGS] & FLAG_INTER)
        return commit_inter_txb(j, 0, L[LF_REF0], x, y, tx, mvr, mvc, qindex,
                                qc);
    return commit_intra_txb(j, 0, L[LF_YMODE], x, y, tx, qindex, qc);
}

/* run the commit pass over all leaves; returns used qcoeff words, or -1 */
int64_t svt_frame_commit(void) {
    CommitJob *j = &g_job;
    int64_t off = 0;
    for (int li = 0; li < j->n_leaves; li++) {
        int32_t *L = j->leaves + (int64_t)li * LEAF_I32;
        const int r = L[LF_R], c = L[LF_C], bsize = L[LF_BSIZE];
        const int bw4 = BLOCK_W4[bsize], bh4 = BLOCK_H4[bsize];
        const int x = c * 4, y = r * 4;
        const int qindex = L[LF_QIDX];
        const int tx = MAX_TX_RECT[bsize];
        const int is_inter = L[LF_FLAGS] & FLAG_INTER;
        const int cwy = TXW[tx] > 32 ? 32 : TXW[tx];
        const int chy = TXH[tx] > 32 ? 32 : TXH[tx];
        const int bw_px = bw4 * 4, bh_px = bh4 * 4;
        if (off + (int64_t)bw_px * bh_px + 2 * 32 * 32 > j->qcoeff_cap)
            return -1;
        L[LF_TXS_Y] = tx;
        L[LF_TXD] = 0;
        int eob_y, eob_u = 0, eob_v = 0;
        int mvr = L[LF_MVY], mvc = L[LF_MVX];
        int mvr1 = L[LF_MVY1], mvc1 = L[LF_MVX1];
        const int is_comp = L[LF_FLAGS] & FLAG_COMP;
        if (is_comp) {
            if (mvr != 0 || mvc != 0)
                subpel_refine(j, L[LF_REF0], x, y, bw_px, bh_px, &mvr, &mvc);
            if (mvr1 != 0 || mvc1 != 0)
                subpel_refine(j, L[LF_REF1], x, y, bw_px, bh_px, &mvr1,
                              &mvc1);
        } else if (is_inter) {
            if (mvr != 0 || mvc != 0)
                subpel_refine(j, L[LF_REF0], x, y, bw_px, bh_px, &mvr, &mvc);
        }
        const int sub_tx = j->tx_select ? SPLIT_TX[tx] : -1;
        if (sub_tx >= 0)
            blk_save(j->recon[0], j->stride[0], x, y, bw_px, bh_px, TXD_SNAP);
        L[LF_OFF_Y] = (int32_t)off;
        eob_y = luma_txb(j, L, x, y, tx, mvr, mvc, mvr1, mvc1, qindex,
                         j->qcoeff + off);
        if (sub_tx >= 0 && eob_y >= 4) {
            /* depth-0 state aside, then try the 4-way split in place */
            const int st = j->stride[0];
            blk_save(j->recon[0], st, x, y, bw_px, bh_px, TXD_D0);
            memcpy(TXD_QC0, j->qcoeff + off, (size_t)cwy * chy * 4);
            const int64_t dist0 = blk_sse_y(j, x, y, bw_px, bh_px);
            const int64_t rate0 =
                rate_proxy(j, tx, j->qcoeff + off, eob_y);
            blk_load(j->recon[0], st, x, y, bw_px, bh_px, TXD_SNAP);
            const int sw = TXW[sub_tx], sh = TXH[sub_tx];
            const int64_t sub_area = (int64_t)sw * sh;
            int64_t rate1 = 0;
            int sub_eob[4], si = 0;
            for (int ty = 0; ty < bh_px; ty += sh)
                for (int txx = 0; txx < bw_px; txx += sw) {
                    int32_t *qc = j->qcoeff + off + si * sub_area;
                    sub_eob[si] = luma_txb(j, L, x + txx, y + ty, sub_tx,
                                           mvr, mvc, mvr1, mvc1, qindex, qc);
                    rate1 += rate_proxy(j, sub_tx, qc, sub_eob[si]);
                    si++;
                }
            const int64_t dist1 = blk_sse_y(j, x, y, bw_px, bh_px);
            const int32_t *tc =
                (is_inter ? j->txd_inter : j->txd_intra) + bsize * 2;
            const int64_t rdm = j->rdmult_tab[qindex];
            const int64_t j0 = (((rate0 + tc[0]) * rdm) >> 9) + (dist0 << 7);
            const int64_t j1 = (((rate1 + tc[1]) * rdm) >> 9) + (dist1 << 7);
            if (j0 <= j1) {
                blk_load(j->recon[0], st, x, y, bw_px, bh_px, TXD_D0);
                memcpy(j->qcoeff + off, TXD_QC0, (size_t)cwy * chy * 4);
            } else {
                L[LF_TXD] = 1;
                L[LF_TXS_Y] = sub_tx;
                eob_y = sub_eob[0];
                L[LF_EOB_Y1] = sub_eob[1];
                L[LF_EOB_Y2] = sub_eob[2];
                L[LF_EOB_Y3] = sub_eob[3];
                L[LF_OFF_Y1] = (int32_t)(off + sub_area);
                L[LF_OFF_Y2] = (int32_t)(off + 2 * sub_area);
                L[LF_OFF_Y3] = (int32_t)(off + 3 * sub_area);
                off += 4 * sub_area - (int64_t)cwy * chy; /* net below */
            }
        }
        off += (int64_t)cwy * chy;
        L[LF_MVY_OUT] = mvr;
        L[LF_MVX_OUT] = mvc;
        L[LF_MVY1_OUT] = mvr1;
        L[LF_MVX1_OUT] = mvc1;
        L[LF_EOB_Y] = eob_y;
        if (has_chroma(j, r, c, bw4, bh4)) {
            int cw_px = (bw4 * 4) >> j->ss_x;
            int ch_px = (bh4 * 4) >> j->ss_y;
            if (cw_px < 4) cw_px = 4;
            if (ch_px < 4) ch_px = 4;
            const int uv_bsize = bsize_of_dims(cw_px >> 2, ch_px >> 2);
            const int uv_tx = MAX_TX_RECT[uv_bsize];
            const int cx = x >> j->ss_x, cy = y >> j->ss_y;
            const int cwc = TXW[uv_tx] > 32 ? 32 : TXW[uv_tx];
            const int chc = TXH[uv_tx] > 32 ? 32 : TXH[uv_tx];
            L[LF_TXS_UV] = uv_tx;
            for (int p = 1; p <= 2; p++) {
                int eob;
                if (is_comp)
                    eob = commit_comp_txb(j, p, L[LF_REF0], L[LF_REF1], cx,
                                          cy, uv_tx, mvr, mvc, mvr1, mvc1,
                                          qindex, j->qcoeff + off);
                else if (is_inter)
                    eob = commit_inter_txb(j, p, L[LF_REF0], cx, cy, uv_tx,
                                           mvr, mvc, qindex, j->qcoeff + off);
                else
                    eob = commit_intra_txb(j, p, 0 /* DC */, cx, cy, uv_tx,
                                           qindex, j->qcoeff + off);
                if (p == 1) { L[LF_OFF_U] = (int32_t)off; eob_u = eob; }
                else        { L[LF_OFF_V] = (int32_t)off; eob_v = eob; }
                off += (int64_t)cwc * chc;
            }
        } else {
            L[LF_TXS_UV] = -1;
            L[LF_OFF_U] = L[LF_OFF_V] = -1;
        }
        L[LF_EOB_U] = eob_u;
        L[LF_EOB_V] = eob_v;
        int zero_y = (eob_y == 0);
        if (L[LF_TXD])
            zero_y = zero_y && L[LF_EOB_Y1] == 0 && L[LF_EOB_Y2] == 0 &&
                     L[LF_EOB_Y3] == 0;
        L[LF_SKIP] = (zero_y && eob_u == 0 && eob_v == 0);
    }
    return off;
}
