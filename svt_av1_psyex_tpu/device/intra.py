"""Batched intra mode-decision analysis on device.

One jitted call evaluates EVERY block of a frame at EVERY searched depth
(64/32/16/8) for a fixed non-directional mode set: open-loop prediction
from *source* neighbors, exact integer forward DCT, analysis-tier
quantization, exact integer inverse DCT for true reconstruction error,
and a calibrated coefficient-rate proxy. The host then runs a cheap
quadtree argmin (`pick_partition_tree`) and a conformant commit pass.

This is the batched reformulation of the reference's MD stage-0/1
(product_coding_loop.c:1791 md_stage_0, fast_loop_core:1344): where the
reference walks blocks sequentially per SB with SIMD kernels, we batch
the whole frame's candidate lattice into a handful of device matmuls and
element-wise passes (SURVEY §7 "Key design decision"). Open-loop (source
neighbor) prediction is the same approximation the reference makes in
its open-loop intra search (motion_estimation.c:3155).

Rates are estimated, not exact: mode/partition symbol costs come from
frame-initial CDF cost tables on the host; coefficient rate uses a
two-term proxy fit against the exact Python rate counter (see
tools/calibrate_rate_proxy.py).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream.tables import get as table_get
from ..codec.constants import TxType
from ..ops.jax_kernels import _run_1d_jnp, _round_shift_jnp
from ..ops import txfm as txfm_ref

# mode order of the device candidate lattice (IntraMode values)
DEVICE_MODES = (0, 1, 2, 9, 10, 11, 12)  # DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH
N_MODES = len(DEVICE_MODES)

# coefficient-rate proxy (bits<<9 fixed point), fit by
# tools/calibrate_rate_proxy.py against CoeffWriter._txb_rate_fast
RATE_NZ = 1229      # per nonzero coefficient
RATE_LOG2 = 614     # per log2(1+|q|) of each nonzero
RATE_ZERO = 154     # per zero coefficient before eob (scan order)
RATE_EOB = 1946     # per log2(1+eob)


import os

# Analysis transforms as float32 matmuls (device/matdct.py) instead of
# int32 butterfly gathers.  Decisions near RD ties
# may differ by one level; the conformant commit requantizes exactly
# either way.  SVT_TPU_INTDCT=1 restores the integer analysis networks.
_USE_MATDCT = os.environ.get("SVT_TPU_INTDCT") != "1"


def _fwd_dct2d(resid: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, n, n) int32 -> (B, cn, cn) DCT_DCT coefficients (exact integer
    network, ops/txfm semantics), cn = min(n, 32)."""
    if _USE_MATDCT:
        from .matdct import fwd_dct2d_mat

        return fwd_dct2d_mat(resid, n)
    shift = txfm_ref._FWD_SHIFT[(n, n)]
    i = int(np.log2(n)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[i][i]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[i][i]
    b = resid.shape[0]
    cols = resid.transpose(0, 2, 1).reshape(b * n, n)
    cols = _round_shift_jnp(cols, -shift[0])
    cols = _run_1d_jnp("dct", n, cols, cb_col, 0, inverse=False)
    cols = _round_shift_jnp(cols, -shift[1])
    rows = cols.reshape(b, n, n).transpose(0, 2, 1).reshape(b * n, n)
    rows = _run_1d_jnp("dct", n, rows, cb_row, 0, inverse=False)
    rows = _round_shift_jnp(rows, -shift[2])
    out = rows.reshape(b, n, n)
    cn = min(n, 32)
    return out[:, :cn, :cn]


def _inv_dct2d(coeffs: jnp.ndarray, n: int, bit_depth: int) -> jnp.ndarray:
    """(B, cn, cn) -> (B, n, n) residual (exact integer inverse)."""
    if _USE_MATDCT:
        from .matdct import inv_dct2d_mat

        return inv_dct2d_mat(coeffs, n)
    shift = txfm_ref._INV_SHIFT[(n, n)]
    opt_row = {8: 16, 10: 18, 12: 20}[bit_depth]
    opt_col = {8: 16, 10: 16, 12: 18}[bit_depth]
    b = coeffs.shape[0]
    cn = coeffs.shape[-1]
    x = coeffs
    if cn != n:
        x = jnp.pad(x, ((0, 0), (0, n - cn), (0, n - cn)))
    rows = x.reshape(b * n, n)
    rows = jnp.clip(rows, -(1 << (bit_depth + 7)), (1 << (bit_depth + 7)) - 1)
    rows = _run_1d_jnp("dct", n, rows, txfm_ref.INV_COS_BIT, opt_row, inverse=True)
    rows = _round_shift_jnp(rows, -shift[0])
    cols = rows.reshape(b, n, n).transpose(0, 2, 1).reshape(b * n, n)
    cb = max(bit_depth + 6, 16)
    cols = jnp.clip(cols, -(1 << (cb - 1)), (1 << (cb - 1)) - 1)
    cols = _run_1d_jnp("dct", n, cols, txfm_ref.INV_COS_BIT, opt_col, inverse=True)
    cols = _round_shift_jnp(cols, -shift[1])
    return cols.reshape(b, n, n).transpose(0, 2, 1)


def _predict_modes(tiles, above, left, tl, blk: int) -> jnp.ndarray:
    """Open-loop predictions for DEVICE_MODES.
    tiles (B,blk,blk); above/left (B,blk); tl (B,). -> (M,B,blk,blk)."""
    b = tiles.shape[0]
    sm = jnp.asarray(table_get("sm_weight_arrays")[blk : 2 * blk], jnp.int32)
    a3 = above[:, None, :]
    l3 = left[:, :, None]
    preds = []
    dc = (above.sum(1) + left.sum(1) + blk) // (2 * blk)
    preds.append(jnp.broadcast_to(dc[:, None, None], (b, blk, blk)))
    preds.append(jnp.broadcast_to(a3, (b, blk, blk)))  # V
    preds.append(jnp.broadcast_to(l3, (b, blk, blk)))  # H
    below = left[:, blk - 1][:, None, None]
    right = above[:, blk - 1][:, None, None]
    wv = sm[None, :, None]  # weights down the rows
    wh = sm[None, None, :]  # weights across the cols
    # SMOOTH: 9-bit dual interpolation (spec 7.11.2.6)
    p = wv * a3 + (256 - wv) * below + wh * l3 + (256 - wh) * right
    preds.append((p + 256) >> 9)
    preds.append((wv * a3 + (256 - wv) * below + 128) >> 8)  # SMOOTH_V
    preds.append((wh * l3 + (256 - wh) * right + 128) >> 8)  # SMOOTH_H
    t3 = tl[:, None, None]
    base = a3 + l3 - t3
    pa = jnp.abs(base - a3)
    pl = jnp.abs(base - l3)
    pt = jnp.abs(base - t3)
    paeth = jnp.where((pl <= pa) & (pl <= pt), jnp.broadcast_to(l3, base.shape),
                      jnp.where(pa <= pt, jnp.broadcast_to(a3, base.shape),
                                jnp.broadcast_to(t3, base.shape)))
    preds.append(paeth)
    return jnp.stack(preds)


def _block_neighbors(luma: jnp.ndarray, blk: int):
    """Source (open-loop) neighbors for every blk-aligned block:
    above/left/top-left with edge replication at frame borders."""
    h, w = luma.shape
    nby, nbx = h // blk, w // blk
    pad = jnp.pad(luma, ((1, 0), (1, 0)), mode="edge")
    above = pad[0:h:blk, 1:]                      # (nby, W)
    above = above.reshape(nby, nbx, blk).reshape(-1, blk)
    left = pad[1:, 0:w:blk]                       # (H, nbx)
    left = left.reshape(nby, blk, nbx).transpose(0, 2, 1).reshape(-1, blk)
    tl = pad[0:h:blk, 0:w:blk].reshape(-1)
    return above, left, tl


def _quantize_analysis(coeffs, deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc,
                       zbin_ac, log_scale: int):
    """Analysis-tier quantize_b: float32 reciprocal of the dequant step
    (the conformant commit pass requantizes exactly on host/C).
    coeffs (B, cn, cn) -> (qabs int32, dq int32)."""
    cn = coeffs.shape[-1]
    is_dc = (jnp.arange(cn)[:, None] == 0) & (jnp.arange(cn)[None, :] == 0)
    rnd = jnp.where(is_dc, rnd_dc, rnd_ac)
    zbin = jnp.where(is_dc, zbin_dc, zbin_ac)
    deq = jnp.where(is_dc, deq_dc, deq_ac)
    abs_c = jnp.abs(coeffs)
    scale = (1 << log_scale) / deq.astype(jnp.float32)
    qabs = jnp.floor((abs_c + rnd).astype(jnp.float32) * scale).astype(jnp.int32)
    qabs = jnp.where(abs_c >= zbin, jnp.maximum(qabs, 0), 0)
    sign = jnp.where(coeffs < 0, -1, 1).astype(jnp.int32)
    dq = sign * ((qabs * deq) >> log_scale)
    return qabs, dq


@lru_cache(maxsize=None)
def _scan_idx(n: int) -> np.ndarray:
    from ..bitstream.tables import scan_table

    # square tx sizes: TX_4X4=0, 8=1, 16=2, 32=3
    tx = {4: 0, 8: 1, 16: 2, 32: 3}[n]
    return scan_table(tx, "default").astype(np.int32)


_HAD8 = None


def _had8():
    global _HAD8
    if _HAD8 is None:
        h = np.array([[1]], np.int64)
        while h.shape[0] < 8:
            h = np.block([[h, h], [h, -h]])
        _HAD8 = h.astype(np.float32)
    return _HAD8


def psy_energy(x: jnp.ndarray, blk: int) -> jnp.ndarray:
    """(B, blk, blk) -> (B,) summed per-8x8-tile SA8D energy
    (SA8D - SAD/4 vs zero; psy_rd.c:135 svt_psy_distortion's per-tile
    term, float analysis-tier — the conformant commit never re-rates)."""
    b = x.shape[0]
    n8 = blk // 8
    t = (x.reshape(b, n8, 8, n8, 8).transpose(0, 1, 3, 2, 4)
         .reshape(-1, 8, 8).astype(jnp.float32))
    h = jnp.asarray(_had8())
    # HIGHEST: the row-pass intermediate (<= 8*1023) exceeds TF32's and
    # bf16's mantissas, so DEFAULT precision could skew the SA8D term
    tr = jnp.einsum("ij,bjk,lk->bil", h, t, h,
                    precision=jax.lax.Precision.HIGHEST)
    sa8d = jnp.floor((jnp.abs(tr).sum(axis=(1, 2)) + 2) / 4)
    sad = jnp.abs(t).sum(axis=(1, 2))
    e = sa8d - jnp.floor(sad / 4)
    return e.reshape(b, n8 * n8).sum(axis=1)


def _rate_dist(qabs, dq, resid, blk: int, bit_depth: int):
    """Coefficient-rate proxy + exact recon distortion for one mode batch.
    qabs/dq: (B, cn, cn); resid: (B, blk, blk). Also returns the inverse-
    transformed residual (for recon-domain psy)."""
    b = qabs.shape[0]
    cn = qabs.shape[-1]
    inv = _inv_dct2d(dq, blk, bit_depth)
    err = (resid - inv).astype(jnp.float32)
    dist = (err * err).sum(axis=(1, 2))
    flat = qabs.reshape(b, cn * cn)
    scan = jnp.asarray(_scan_idx(cn))
    sflat = flat[:, scan]
    nzmask = sflat != 0
    idx = jnp.arange(cn * cn)[None, :]
    eob = jnp.where(nzmask, idx + 1, 0).max(axis=1)  # scan position + 1
    nnz = nzmask.sum(axis=1)
    log2q = jnp.log2(1.0 + sflat.astype(jnp.float32))
    rate = (RATE_NZ * nnz
            + (RATE_LOG2 * jnp.where(nzmask, log2q, 0.0).sum(axis=1)).astype(jnp.int32)
            + RATE_ZERO * jnp.maximum(eob - nnz, 0)
            + (RATE_EOB * jnp.log2(1.0 + eob.astype(jnp.float32))).astype(jnp.int32))
    return dist, rate.astype(jnp.int32), eob.astype(jnp.int32), inv


def _analyze_depth(luma, blk: int, qp_row, bit_depth: int,
                   rd_row=None, psy: bool = False):
    """All blocks of one depth: -> dict of (B, M) / (B,) arrays.
    With rd_row (see intra_analysis_batch) the RD reduction happens on
    device and only (jbest, mode_best) per block are returned. With
    psy=True, the SA8D energy delta (scaled by rd_row[-1]/256) is added
    to both the coded and skip distortions (psy_rd.c full-loop hook)."""
    tiles = _extract_blocks(luma, blk)
    above, left, tl = _block_neighbors(luma, blk)
    preds = _predict_modes(tiles, above, left, tl, blk)  # (M,B,blk,blk)
    m, b = preds.shape[0], preds.shape[1]
    resid = (tiles[None] - preds).reshape(m * b, blk, blk)
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    sse = (resid.astype(jnp.float32) ** 2).sum(axis=(1, 2))
    coeffs = _fwd_dct2d(resid, blk)
    qabs, dq = _quantize_analysis(
        coeffs, qp_row[4], qp_row[9],
        _rp2(qp_row[1], log_scale), _rp2(qp_row[6], log_scale),
        _rp2(qp_row[0], log_scale), _rp2(qp_row[5], log_scale),
        log_scale)
    dist, rate, eob, inv = _rate_dist(qabs, dq, resid, blk, bit_depth)
    if psy:
        maxpix = (1 << bit_depth) - 1
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd_row[-1].astype(jnp.float32) / 256.0 * scale
        pflat = preds.reshape(m * b, blk, blk)
        recon = jnp.clip(pflat + inv, 0, maxpix)
        e_src = jnp.tile(psy_energy(tiles, blk), m)
        dist = dist + jnp.abs(e_src - psy_energy(recon, blk)) * factor
        sse = sse + jnp.abs(e_src - psy_energy(pflat, blk)) * factor
    if rd_row is None:
        return {
            "dist": dist.reshape(m, b).T,      # (B, M) f32
            "rate": rate.reshape(m, b).T,      # (B, M) i32, bits<<9
            "sse": sse.reshape(m, b).T,        # (B, M) f32 — skip distortion
            "eob": eob.reshape(m, b).T,        # (B, M) i32
        }
    # on-device RD reduction: rd_row = [rdmult, skip0, skip1,
    # mode_rate[0..M-1]] (1/512-bit costs from the frame CDFs)
    rdmult = rd_row[0].astype(jnp.float32)
    mode_rate = rd_row[3 : 3 + m].astype(jnp.float32)[:, None]
    j_coded = ((rate.reshape(m, b).astype(jnp.float32) + mode_rate
                + rd_row[1]) * rdmult / 512.0
               + dist.reshape(m, b) * 128.0)
    j_skip = ((mode_rate + rd_row[2]) * rdmult / 512.0
              + sse.reshape(m, b) * 128.0)
    j = jnp.minimum(j_coded, j_skip)  # (M, B)
    mode_best = jnp.argmin(j, axis=0)
    jbest = j.min(axis=0)
    return {"j": jbest, "mode": mode_best.astype(jnp.float32)}


def _rp2(x, n):
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def _extract_blocks(plane: jnp.ndarray, blk: int) -> jnp.ndarray:
    h, w = plane.shape
    t = plane.reshape(h // blk, blk, w // blk, blk).transpose(0, 2, 1, 3)
    return t.reshape(-1, blk, blk)


FIELDS = ("dist", "rate", "sse", "eob")


@partial(jax.jit, static_argnames=("depths", "bit_depth"))
def intra_analysis(luma: jnp.ndarray, qp_row: jnp.ndarray,
                   depths: tuple = (64, 32, 16, 8),
                   bit_depth: int = 8) -> jnp.ndarray:
    """luma: (Hp, Wp) int32, Hp/Wp multiples of max(depths).
    qp_row: (10,) int32 = (zbin, round, quant, quant_shift, dequant) x
    (dc, ac) for the luma plane at the frame qindex.

    Returns ONE packed f32 array (a single host transfer): for each depth, the
    FIELDS arrays flattened and concatenated; unpack with
    `unpack_analysis`."""
    parts = []
    for blk in depths:
        d = _analyze_depth(luma, blk, qp_row, bit_depth)
        parts.extend(d[f].astype(jnp.float32).reshape(-1) for f in FIELDS)
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("depths", "bit_depth", "psy"))
def intra_analysis_batch(lumas: jnp.ndarray, qp_rows: jnp.ndarray,
                         rd_rows: jnp.ndarray,
                         depths: tuple = (64, 32, 16, 8),
                         bit_depth: int = 8, psy: bool = False) -> jnp.ndarray:
    """Group-of-frames analysis with on-device RD reduction.

    lumas (F, Hp, Wp) uint8/uint16, qp_rows (F, 10), rd_rows (F, 3+M) =
    [rdmult, skip0_cost, skip1_cost, mode_costs...] in 1/512-bit units.
    One device call + ONE compact host fetch for the whole group:
    frames are batched like the reference's picture-level parallelism
    (SURVEY §2.1) and only (jbest, mode) per block leave the device.
    Returns (F, P) packed rows; unpack with unpack_rd_analysis."""
    lumas = lumas.astype(jnp.int32)

    def one(luma, qp_row, rd_row):
        parts = []
        for blk in depths:
            d = _analyze_depth(luma, blk, qp_row, bit_depth, rd_row, psy)
            parts.append(d["j"])
            parts.append(d["mode"])
        return jnp.concatenate(parts)

    return jax.vmap(one)(lumas, qp_rows, rd_rows)


def unpack_rd_analysis(packed: np.ndarray, hp: int, wp: int,
                       depths: tuple = (64, 32, 16, 8)) -> dict:
    """{blk: {"j": (nby, nbx) f32, "mode": (nby, nbx) int}}."""
    out = {}
    pos = 0
    for blk in depths:
        nby, nbx = hp // blk, wp // blk
        n = nby * nbx
        j = packed[pos : pos + n].reshape(nby, nbx); pos += n
        mode = packed[pos : pos + n].reshape(nby, nbx).astype(np.int32)
        pos += n
        out[blk] = {"j": j, "mode": mode}
    assert pos == packed.size
    return out


def unpack_analysis(packed: np.ndarray, hp: int, wp: int,
                    depths: tuple = (64, 32, 16, 8)) -> dict:
    """Inverse of the packing in intra_analysis: {blk: {field: (nby, nbx,
    M)}} numpy views."""
    out = {}
    pos = 0
    for blk in depths:
        nby, nbx = hp // blk, wp // blk
        n = nby * nbx * N_MODES
        d = {}
        for f in FIELDS:
            d[f] = packed[pos : pos + n].reshape(nby, nbx, N_MODES)
            pos += n
        out[blk] = d
    assert pos == packed.size
    return out


def qp_row_for(qindex: int, dc_delta: int, ac_delta: int, bit_depth: int) -> np.ndarray:
    from ..ops.quant import build_plane_quant

    pq = build_plane_quant(qindex, dc_delta, ac_delta, bit_depth)
    return np.array([pq.zbin[0], pq.round[0], pq.quant[0], pq.quant_shift[0],
                     pq.dequant[0], pq.zbin[1], pq.round[1], pq.quant[1],
                     pq.quant_shift[1], pq.dequant[1]], np.int32)
