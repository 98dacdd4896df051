"""JAX device kernels: exact integer transforms + batched intra analysis.

Device design (two tiers, per SURVEY §7):
  * analysis tier — batched over all superblocks/tx blocks of a frame,
    evaluating candidate-mode costs in parallel (this file);
  * conformant tier — the same exact integer transform networks as
    ops/txfm.py, executed as jnp gathers + weighted adds, batched
    over thousands of blocks; int32 is sufficient for encoder-produced
    coefficient ranges (the C stage-range asserts bound everything < 2^31).

No wavefronts: neighbor-dependent final decisions happen on host; device
work is frame-batched (SURVEY §5).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.constants import TxType
from . import txfm as txfm_ref


@lru_cache(maxsize=None)
def _stage_consts(net_name: str, cos_bit: int):
    """Precompute per-stage gather indices and weights as numpy consts."""
    net = txfm_ref._load_nets()[net_name]
    stages = []
    for src0, w0s, src1, w1s, kind in net.stages:
        w0 = net._weights(w0s, cos_bit).astype(np.int32)
        w1 = net._weights(w1s, cos_bit).astype(np.int32)
        is_btf = np.array([k == "btf" for k in kind])
        do_clamp = np.array([k == "raw" for k in kind])
        stages.append((src0.astype(np.int32), w0, src1.astype(np.int32), w1,
                       is_btf, do_clamp))
    return stages


def _run_net_jnp(net_name: str, x: jnp.ndarray, cos_bit: int, clamp_bit: int) -> jnp.ndarray:
    """x: (batch, N) int32."""
    rnd = 1 << (cos_bit - 1)
    for src0, w0, src1, w1, is_btf, do_clamp in _stage_consts(net_name, cos_bit):
        y = x[:, src0] * w0 + x[:, src1] * w1
        yb = (y + rnd) >> cos_bit
        y = jnp.where(is_btf, yb, y)
        if clamp_bit > 0 and do_clamp.any():
            lo, hi = -(1 << (clamp_bit - 1)), (1 << (clamp_bit - 1)) - 1
            y = jnp.where(do_clamp, jnp.clip(y, lo, hi), y)
        x = y
    return x


def _identity_jnp(x: jnp.ndarray, n: int) -> jnp.ndarray:
    if n == 4:
        return (x * txfm_ref.NEW_SQRT2 + 2048) >> 12
    if n == 8:
        return x * 2
    if n == 16:
        return (x * 2 * txfm_ref.NEW_SQRT2 + 2048) >> 12
    if n == 32:
        return x * 4
    raise ValueError(n)


def _run_1d_jnp(kind: str, n: int, x: jnp.ndarray, cos_bit: int, clamp_bit: int,
                inverse: bool) -> jnp.ndarray:
    if kind == "identity":
        return _identity_jnp(x, n)
    if kind == "adst" and n == 4:
        return _adst4_jnp(x, cos_bit, inverse)
    prefix = ("i" if inverse else "f") + ("dct" if kind == "dct" else "adst")
    return _run_net_jnp(f"{prefix}{n}", x, cos_bit, clamp_bit if inverse else 0)


def _adst4_jnp(x: jnp.ndarray, bit: int, inverse: bool) -> jnp.ndarray:
    sp = np.asarray(txfm_ref.sinpi_arr(bit), np.int32)
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    rnd = 1 << (bit - 1)
    if inverse:
        s0 = sp[1] * x0 + sp[4] * x2 + sp[2] * x3
        s1 = sp[2] * x0 - sp[1] * x2 - sp[4] * x3
        s2 = sp[3] * ((x0 - x2) + x3)
        s3 = sp[3] * x1
        o0 = s0 + s3
        o1 = s1 + s3
        o2 = s2
        o3 = (s0 + s1) - s3
    else:
        s0 = sp[1] * x0 + sp[2] * x1 + sp[4] * x3
        s1 = sp[3] * ((x0 + x1) - x3)
        s2 = sp[4] * x0 - sp[1] * x1 + sp[2] * x3
        s3 = sp[3] * x2
        o0 = s0 + s3
        o1 = s1
        o2 = s2 - s3
        o3 = (s2 - s0) + s3
    out = jnp.stack([(o0 + rnd) >> bit, (o1 + rnd) >> bit,
                     (o2 + rnd) >> bit, (o3 + rnd) >> bit], axis=1)
    return out


def _round_shift_jnp(x: jnp.ndarray, bit: int) -> jnp.ndarray:
    if bit == 0:
        return x
    if bit < 0:
        return x << (-bit)
    return (x + (1 << (bit - 1))) >> bit


@partial(jax.jit, static_argnames=("tx_w", "tx_h", "tx_type", "bit_depth"))
def forward_txfm2d_jnp(residual: jnp.ndarray, tx_w: int, tx_h: int, tx_type: int,
                       bit_depth: int = 8) -> jnp.ndarray:
    """residual: (B, h, w) int32 -> (B, min(h,32), min(w,32)) int32.
    Exact port of ops/txfm.forward_txfm2d; jit-safe (static tx params)."""
    col_kind, row_kind, ud_flip, lr_flip = txfm_ref._TX1D[TxType(tx_type)]
    shift = txfm_ref._FWD_SHIFT[(tx_w, tx_h)]
    wi = int(np.log2(tx_w)) - 2
    hi = int(np.log2(tx_h)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[wi][hi]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[wi][hi]

    b = residual.shape[0]
    x = residual.astype(jnp.int32)
    if ud_flip:
        x = x[:, ::-1, :]
    cols = x.transpose(0, 2, 1).reshape(b * tx_w, tx_h)
    cols = _round_shift_jnp(cols, -shift[0])
    cols = _run_1d_jnp(col_kind, tx_h, cols, cb_col, 0, inverse=False)
    cols = _round_shift_jnp(cols, -shift[1])
    buf = cols.reshape(b, tx_w, tx_h).transpose(0, 2, 1)
    if lr_flip:
        buf = buf[:, :, ::-1]
    rows = buf.reshape(b * tx_h, tx_w)
    rows = _run_1d_jnp(row_kind, tx_w, rows, cb_row, 0, inverse=False)
    rows = _round_shift_jnp(rows, -shift[2])
    if txfm_ref._rect_ratio1(tx_w, tx_h):
        rows = _round_shift_jnp(rows * txfm_ref.NEW_SQRT2, txfm_ref.SQRT2_BITS)
    out = rows.reshape(b, tx_h, tx_w)
    return out[:, : min(tx_h, 32), : min(tx_w, 32)]


@partial(jax.jit, static_argnames=("tx_w", "tx_h", "tx_type", "bit_depth"))
def inverse_txfm2d_jnp(coeffs: jnp.ndarray, tx_w: int, tx_h: int, tx_type: int,
                       bit_depth: int = 8) -> jnp.ndarray:
    """coeffs: (B, min(h,32), min(w,32)) int32 -> residual (B, h, w) int32."""
    col_kind, row_kind, ud_flip, lr_flip = txfm_ref._TX1D[TxType(tx_type)]
    shift = txfm_ref._INV_SHIFT[(tx_w, tx_h)]
    opt_row = {8: 16, 10: 18, 12: 20}[bit_depth]
    opt_col = {8: 16, 10: 16, 12: 18}[bit_depth]
    b = coeffs.shape[0]
    cw, ch = min(tx_w, 32), min(tx_h, 32)
    x = coeffs.astype(jnp.int32)
    if cw != tx_w or ch != tx_h:
        x = jnp.pad(x, ((0, 0), (0, tx_h - ch), (0, tx_w - cw)))
    rows = x.reshape(b * tx_h, tx_w)
    if txfm_ref._rect_ratio1(tx_w, tx_h):
        rows = _round_shift_jnp(rows * txfm_ref.NEW_INV_SQRT2, txfm_ref.SQRT2_BITS)
    rows = jnp.clip(rows, -(1 << (bit_depth + 7)), (1 << (bit_depth + 7)) - 1)
    rows = _run_1d_jnp(row_kind, tx_w, rows, txfm_ref.INV_COS_BIT, opt_row, inverse=True)
    rows = _round_shift_jnp(rows, -shift[0])
    buf = rows.reshape(b, tx_h, tx_w)
    if lr_flip:
        buf = buf[:, :, ::-1]
    cols = buf.transpose(0, 2, 1).reshape(b * tx_w, tx_h)
    cb = max(bit_depth + 6, 16)
    cols = jnp.clip(cols, -(1 << (cb - 1)), (1 << (cb - 1)) - 1)
    cols = _run_1d_jnp(col_kind, tx_h, cols, txfm_ref.INV_COS_BIT, opt_col, inverse=True)
    cols = _round_shift_jnp(cols, -shift[1])
    res = cols.reshape(b, tx_w, tx_h).transpose(0, 2, 1)
    if ud_flip:
        res = res[:, ::-1, :]
    return res


def quantize_jnp(coeffs: jnp.ndarray, pq_dc: tuple, pq_ac: tuple, log_scale: int):
    """Batched quantize_b. coeffs (B, n) raster; pq_* = (zbin, round, quant,
    quant_shift, dequant). Returns (qcoeff, dqcoeff)."""
    n = coeffs.shape[-1]
    is_dc = jnp.arange(n) == 0

    def sel(i):
        return jnp.where(is_dc, pq_dc[i], pq_ac[i])

    def rp2(x, k):
        return x if k == 0 else (x + (1 << (k - 1))) >> k

    zbin = rp2(sel(0), log_scale)
    rnd = rp2(sel(1), log_scale)
    quant = sel(2)
    qshift = sel(3)
    deq = sel(4)
    sign = jnp.where(coeffs < 0, -1, 1)
    abs_c = jnp.abs(coeffs)
    # ANALYSIS TIER: int32-safe approximation — tmp capped to 2^16-1 keeps
    # tmp*quant < 2^31 (exact for |coeff| below ~2^11; the conformant pass
    # quantizes on host / Pallas with wide arithmetic).
    tmp5 = jnp.minimum(jnp.clip(abs_c + rnd, 0, 32767), (1 << 15) - 1) << 5
    tmp32 = (((tmp5 * quant) >> 16) + tmp5) * qshift >> (16 - log_scale + 5)
    tmp32 = jnp.where(abs_c >= zbin, tmp32, 0)
    qcoeff = (tmp32 * sign).astype(jnp.int32)
    dqcoeff = (((tmp32 * deq) >> log_scale) * sign).astype(jnp.int32)
    return qcoeff, dqcoeff


# ---- batched intra analysis (MD tier) -------------------------------------------


def _extract_sb_blocks(plane: jnp.ndarray, blk: int) -> jnp.ndarray:
    """(H, W) -> (H/blk * W/blk, blk, blk) tiles."""
    h, w = plane.shape
    t = plane.reshape(h // blk, blk, w // blk, blk).transpose(0, 2, 1, 3)
    return t.reshape(-1, blk, blk)


@partial(jax.jit, static_argnames=("blk", "bit_depth"))
def frame_intra_analysis(luma: jnp.ndarray,
                         blk: int = 64, bit_depth: int = 8) -> dict:
    """Batched open-loop intra analysis over all blk x blk blocks.

    Evaluates DC/V/H/SMOOTH/PAETH predictions from *source* neighbors (the
    open-loop approximation, like the reference's OIS motion_estimation.c
    svt_aom_open_loop_intra_search_mb), computes SSE + transform-domain
    SATD proxies, and per-block 8x8 variances (for variance-boost deltaq).

    luma: (H, W) int32 (aligned dims, multiples of blk).
    Returns dict of per-block stats; argmin/mode selection on host.
    """
    h, w = luma.shape
    nby, nbx = h // blk, w // blk
    tiles = _extract_sb_blocks(luma, blk)  # (B, blk, blk)
    b = tiles.shape[0]
    base = 1 << (bit_depth - 1)

    # source neighbors: above row / left col per tile (frame edges -> base)
    padded = jnp.pad(luma, ((1, 0), (1, 0)), constant_values=base)
    above = padded[0:h:blk][:, 1:]  # rows above each tile band: (nby, W)
    above = above.reshape(nby, nbx, blk)[:, :, :].reshape(b, blk)
    left = padded[1:, 0:w:blk][:, :]  # (H, nbx) cols left of each tile band
    left = left.reshape(nby, blk, nbx).transpose(0, 2, 1).reshape(b, blk)
    tl = padded[0:h:blk, 0:w:blk].reshape(b, 1)

    preds = []
    # DC
    dc = (above.sum(1) + left.sum(1) + blk) // (2 * blk)
    preds.append(jnp.broadcast_to(dc[:, None, None], (b, blk, blk)))
    # V / H
    preds.append(jnp.broadcast_to(above[:, None, :], (b, blk, blk)))
    preds.append(jnp.broadcast_to(left[:, :, None], (b, blk, blk)))
    # SMOOTH
    from ..bitstream.tables import get

    wts = jnp.asarray(get("sm_weight_arrays")[blk : 2 * blk], jnp.int32)
    below = left[:, blk - 1][:, None, None]
    right = above[:, blk - 1][:, None, None]
    p = (wts[None, :, None] * above[:, None, :] + (256 - wts)[None, :, None] * below
         + wts[None, None, :] * left[:, :, None] + (256 - wts)[None, None, :] * right)
    preds.append((p + 256) >> 9)
    # PAETH
    a3 = above[:, None, :]
    l3 = left[:, :, None]
    t3 = tl[:, :, None]
    bse = a3 + l3 - t3
    pa, pl, pt = jnp.abs(bse - a3), jnp.abs(bse - l3), jnp.abs(bse - t3)
    paeth = jnp.where((pl <= pa) & (pl <= pt), jnp.broadcast_to(l3, bse.shape),
                      jnp.where(pa <= pt, jnp.broadcast_to(a3, bse.shape),
                                jnp.broadcast_to(t3, bse.shape)))
    preds.append(paeth)

    pred_stack = jnp.stack(preds)  # (M, B, blk, blk)
    resid = (tiles[None] - pred_stack).astype(jnp.int32)
    # 64x64 SSE fits int32 (255^2 * 4096 < 2^31)
    sse = (resid * resid).sum(axis=(2, 3))  # (M, B)
    sad = jnp.abs(resid).sum(axis=(2, 3))

    # 8x8 variances (variance boost input)
    v8 = tiles.reshape(b, blk // 8, 8, blk // 8, 8).transpose(0, 1, 3, 2, 4)
    v8 = v8.reshape(b, -1, 64)
    mean = v8.mean(axis=2, keepdims=True)
    var8 = ((v8 - mean) ** 2).mean(axis=2)

    return {"sse": sse, "sad": sad, "var8x8": var8, "pred_dc": dc}
