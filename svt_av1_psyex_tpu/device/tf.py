"""Alt-ref temporal filtering as one batched device program.

Counterpart: temporal_filtering.c (svt_av1_apply_temporal_filter_
planewise_medium + the per-block TF motion search, :1793-2136).
Redesigned as whole-frame array ops instead of per-block host loops: the block motion
search is a lax.scan over the (2R+1)^2 static offset table where each
step shifts the WHOLE neighbor frame, masks out-of-frame samples and
box-reduces |diff| / diff^2 into 16x16 block grids (same shape as the
ME lattices in device/me.py); the winning offset's SSE drives the
exp(-err/decay) block weight, and the accumulation is a whole-frame
gather + weighted sum over all neighbors for all planes.

Everything (search + weights + accumulate + normalize) is ONE jitted
call per (shape-bucket, plane-config); neighbor counts are padded to
N_BUCKETS with zero-weight slots so an encode reuses a single compiled
program (one compile per shape, see codec/tpl.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BLK = 16
SEARCH = 8          # +- full-pel window around the co-located block
WEIGHT_SCALE = 1 << 10
# padded neighbor counts (kf window / ARF nearest-6 window): the search
# vmaps over every slot, so padding waste is compile AND run time — the
# ARF bucket tracks the +-3 nearest-neighbor window (codec/tf.py)
N_BUCKETS = (4, 8)


def n_bucket(n: int) -> int:
    for b in N_BUCKETS:
        if n <= b:
            return b
    return N_BUCKETS[-1]


def _offsets() -> np.ndarray:
    n = 2 * SEARCH + 1
    g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                 axis=-1).reshape(-1, 2)
    return (g - SEARCH).astype(np.int32)


def _block_search(cy: jnp.ndarray, ny: jnp.ndarray, maxpix: int):
    """Per-16x16-block best offset vs one neighbor luma.

    cy/ny: (H, W) int32, H/W multiples of BLK. Returns (dy, dx, sse) of
    shape (H//BLK, W//BLK); sse is the winning offset's true SSE
    (out-of-frame samples never win: they are charged maxpix per px,
    matching the host search's skip of out-of-frame candidates)."""
    h, w = cy.shape
    rows = jnp.arange(h)
    cols = jnp.arange(w)
    nby, nbx = h // BLK, w // BLK
    big = jnp.int32(1 << 30)
    # Edge-pad once so each offset is a contiguous dynamic_slice (a block
    # copy) instead of a whole-frame gather; this loop runs
    # (2R+1)^2 x neighbors times.
    ny_pad = jnp.pad(ny, SEARCH, mode="edge")

    def body(carry, off):
        best_sad, best_sse, best_off = carry
        cand = jax.lax.dynamic_slice(ny_pad, (off[0] + SEARCH,
                                              off[1] + SEARCH), (h, w))
        valid = ((((rows + off[0]) >= 0) & ((rows + off[0]) < h))[:, None]
                 & (((cols + off[1]) >= 0) & ((cols + off[1]) < w))[None, :])
        ad = jnp.where(valid, jnp.abs(cy - cand), maxpix)
        sq = jnp.where(valid, (cy - cand) * (cy - cand), maxpix * maxpix)
        sad = (ad.reshape(nby, BLK, nbx, BLK).sum(axis=(1, 3)) * 16
               + jnp.abs(off).sum())          # small-motion tie-break
        sse = sq.reshape(nby, BLK, nbx, BLK).sum(axis=(1, 3))
        better = sad < best_sad
        best_sad = jnp.where(better, sad, best_sad)
        best_sse = jnp.where(better, sse, best_sse)
        best_off = jnp.where(better[None], off[:, None, None], best_off)
        return (best_sad, best_sse, best_off), None

    init = (jnp.full((nby, nbx), big), jnp.full((nby, nbx), big),
            jnp.zeros((2, nby, nbx), jnp.int32))
    (sad, sse, offs), _ = jax.lax.scan(body, init, jnp.asarray(_offsets()))
    return offs[0], offs[1], sse


def _gather_plane(ref: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray,
                  ss_y: int, ss_x: int):
    """Motion-compensate a plane by per-luma-block full-pel offsets.

    ref: (ph, pw); dy/dx: (nby, nbx) luma-block offsets. Returns
    (pred, valid): the per-pixel gathered samples (clipped indices) and
    an in-frame mask (out-of-frame pixels get zero weight, the per-pixel
    analog of the host path's block skip)."""
    ph, pw = ref.shape
    pblk_y, pblk_x = BLK >> ss_y, BLK >> ss_x
    dyp = jnp.repeat(jnp.repeat(dy >> ss_y, pblk_y, 0), pblk_x, 1)
    dxp = jnp.repeat(jnp.repeat(dx >> ss_x, pblk_y, 0), pblk_x, 1)
    ry = jnp.arange(ph)[:, None] + dyp
    cx = jnp.arange(pw)[None, :] + dxp
    valid = (ry >= 0) & (ry < ph) & (cx >= 0) & (cx < pw)
    pred = ref[jnp.clip(ry, 0, ph - 1), jnp.clip(cx, 0, pw - 1)]
    return pred, valid


@partial(jax.jit, static_argnames=("bit_depth", "planes_ss"))
def tf_filter(center: tuple, nbrs: tuple, n_valid: jnp.ndarray,
              decay_px: jnp.ndarray, bit_depth: int = 8,
              planes_ss: tuple = ((0, 0), (1, 1), (1, 1))):
    """Temporal-filter `center` using the padded neighbor stacks.

    center: per-plane (ph, pw) arrays; nbrs: per-plane (N, ph, pw)
    stacks (N = a N_BUCKETS entry; slots >= n_valid are padding);
    decay_px: scalar float32 per-pixel error decay. Returns the
    filtered planes (same integer dtypes)."""
    maxpix = (1 << bit_depth) - 1
    cy = center[0].astype(jnp.int32)
    ny = nbrs[0].astype(jnp.int32)
    n = ny.shape[0]

    dy, dx, sse = jax.vmap(lambda r: _block_search(cy, r, maxpix))(ny)
    err = sse.astype(jnp.float32) / (BLK * BLK)
    wgt = jnp.round(jnp.exp(-jnp.minimum(err / decay_px, 7.0))
                    * WEIGHT_SCALE).astype(jnp.int32)     # (N, nby, nbx)
    wgt = jnp.where(jnp.arange(n)[:, None, None] < n_valid, wgt, 0)

    out = []
    for p, (ss_y, ss_x) in enumerate(planes_ss[:len(center)]):
        src = center[p].astype(jnp.int32)
        accum = src * WEIGHT_SCALE
        count = jnp.full(src.shape, WEIGHT_SCALE, jnp.int32)
        pblk_y, pblk_x = BLK >> ss_y, BLK >> ss_x
        nby = src.shape[0] // pblk_y
        nbx = src.shape[1] // pblk_x

        def body(carry, inp, _p=p, _ssy=ss_y, _ssx=ss_x, _py=pblk_y,
                 _px=pblk_x, _nby=nby, _nbx=nbx, _src=src):
            acc, cnt = carry
            ref, dyi, dxi, wi = inp
            pred, valid = _gather_plane(ref.astype(jnp.int32), dyi, dxi,
                                        _ssy, _ssx)
            if _p > 0:
                # planewise weights (svt_av1_apply_temporal_filter_
                # planewise): chroma moves independently of luma in
                # general, so cap the luma-match weight by this plane's
                # own MC error — a luma-tracked block whose chroma
                # mismatches must not smear chroma
                d = jnp.where(valid, (_src - pred), maxpix)
                errp = ((d * d).reshape(_nby, _py, _nbx, _px)
                        .sum(axis=(1, 3)).astype(jnp.float32)
                        / (_py * _px))
                wp = jnp.round(jnp.exp(-jnp.minimum(errp / decay_px, 7.0))
                               * WEIGHT_SCALE).astype(jnp.int32)
                wi = jnp.minimum(wi, wp)
            w_px = jnp.repeat(jnp.repeat(wi, _py, 0), _px, 1)
            w_px = jnp.where(valid, w_px, 0)
            return (acc + w_px * pred, cnt + w_px), None

        (accum, count), _ = jax.lax.scan(
            body, (accum, count),
            (nbrs[p].astype(jnp.int32), dy, dx, wgt))
        filt = (accum + count // 2) // jnp.maximum(count, 1)
        out.append(jnp.clip(filt, 0, maxpix))
    return tuple(out)
