"""Fused inter-frame mode-decision analysis on device.

ONE jitted call per (frame, refs) chains, entirely on device:

  hierarchical ME (device/me.py lattices)
    -> per-depth full-pel MVs for every block
    -> motion-compensated prediction tiles (clipped gathers == spec MC
       sample clamping at full-pel)
    -> exact integer fwd DCT -> analysis quantizer -> exact inverse DCT
    -> distortion + calibrated rate proxy
    -> RD reduction against the intra candidate lattice (device/intra.py)

and returns, per depth (64/32/16/8), the winning candidate per block:
J, candidate code (intra mode | NEWMV(ref) | zero-MV(ref)), and the MV.
The host runs the quadtree argmin and a conformant commit pass
(codec/md_device.py), exactly as the intra-only device path does.

This is the batched reformulation of the reference's inter MD stages
(product_coding_loop.c md_stage_0/fast_loop_core for inter classes,
mode_decision.c candidate injection): instead of per-SB sequential
candidate walks, every block of the frame evaluates its candidate set in
a handful of batched device passes (SURVEY §7 "Key design decision").

Candidate codes in the packed output:
  0..N_MODES-1          intra (index into device.intra.DEVICE_MODES)
  10 + 2*ri             NEWMV at the ME MV against ref #ri
  11 + 2*ri             zero MV (GLOBALMV) against ref #ri
  40                    compound NEW_NEWMV: ref #0 / ref #1 ME MVs avg'd
  41                    compound zero (GLOBAL_GLOBALMV) over refs #0/#1

Compound rides a FIXED ref-slot convention (no extra program shapes):
the host places the legal (forward, backward) pair in lattice slots
0 and 1 (codec/md_device.py DeviceInterMD); frames without a legal pair
carry a prohibitive base cost in rd_row so the compound candidates never
win (same trick as the padded single-ref slots).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intra import (
    DEVICE_MODES,
    N_MODES,
    _analyze_depth,
    _fwd_dct2d,
    _inv_dct2d,
    _quantize_analysis,
    _rate_dist,
    _extract_blocks,
    _rp2,
)
from .me import R2, fullpel_lattice, geometry_best

# MV-rate proxy (1/512-bit units): base covers joint/sign/class symbols;
# the log2 term tracks the class/offset growth per component. The
# "predictor" is the containing SB's 64x64 MV — spatial MVPs almost
# always carry the neighbourhood motion, so the residual vs the SB MV is
# a good stand-in for the true DRL residual.
MV_RATE_BASE = 2048       # ~4 bits
MV_RATE_LOG2 = 1024       # ~2 bits per log2(1+|d_eighth|) per component

CAND_INTER0 = 10
CAND_COMP_NEW = 40
CAND_COMP_ZERO = 41


def _mc_tiles(ref: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray,
              blk: int) -> jnp.ndarray:
    """Full-pel MC prediction tiles: (nby, nbx) MV grids -> (B, blk, blk)
    gathered with spec sample clamping."""
    h, w = ref.shape
    nby, nbx = mv_y.shape
    y0 = (jnp.arange(nby)[:, None] * blk + mv_y).reshape(-1)   # (B,)
    x0 = (jnp.arange(nbx)[None, :] * blk + mv_x).reshape(-1)
    rows = jnp.clip(y0[:, None] + jnp.arange(blk)[None, :], 0, h - 1)
    cols = jnp.clip(x0[:, None] + jnp.arange(blk)[None, :], 0, w - 1)
    return ref[rows[:, :, None], cols[:, None, :]]


def _txrd(resid: jnp.ndarray, blk: int, qp_row, bit_depth: int):
    """Exact-DCT analysis RD of a residual batch:
    (dist, rate, sse, inv_residual)."""
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    sse = (resid.astype(jnp.float32) ** 2).sum(axis=(1, 2))
    coeffs = _fwd_dct2d(resid, blk)
    qabs, dq = _quantize_analysis(
        coeffs, qp_row[4], qp_row[9],
        _rp2(qp_row[1], log_scale), _rp2(qp_row[6], log_scale),
        _rp2(qp_row[0], log_scale), _rp2(qp_row[5], log_scale), log_scale)
    dist, rate, _eob, inv = _rate_dist(qabs, dq, resid, blk, bit_depth)
    return dist, rate, sse, inv


def _mv_rate_grid(mv_y, mv_x, sb_mv, blk: int):
    """MV-rate proxy grid vs the containing SB's 64x64 motion."""
    nh = 64 // blk
    sby = jnp.repeat(jnp.repeat(sb_mv[0], nh, 0), nh, 1)
    sbx = jnp.repeat(jnp.repeat(sb_mv[1], nh, 0), nh, 1)
    d8 = (jnp.abs(mv_y - sby) + jnp.abs(mv_x - sbx)).astype(jnp.float32) * 8
    return MV_RATE_BASE + MV_RATE_LOG2 * jnp.log2(1.0 + d8)


def _cand_j(tiles, pred, crate, blk: int, qp_row, rd_row, bit_depth: int,
            psy: bool):
    """J of one candidate batch from its prediction tiles + const rate
    (coded-vs-skip min, shared by the single-ref and compound paths)."""
    rdmult = rd_row[0].astype(jnp.float32)
    skip0 = rd_row[1].astype(jnp.float32)
    skip1 = rd_row[2].astype(jnp.float32)
    resid = tiles - pred
    dist, rate, sse, inv = _txrd(resid, blk, qp_row, bit_depth)
    if psy:
        from .intra import psy_energy

        maxpix = (1 << bit_depth) - 1
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd_row[-1].astype(jnp.float32) / 256.0 * scale
        e_src = psy_energy(tiles, blk)
        recon = jnp.clip(pred + inv, 0, maxpix)
        dist = dist + jnp.abs(e_src - psy_energy(recon, blk)) * factor
        sse = sse + jnp.abs(e_src - psy_energy(pred, blk)) * factor
    j_coded = (rate.astype(jnp.float32) + crate + skip0) \
        * rdmult / 512.0 + dist * 128.0
    j_skip = (crate + skip1) * rdmult / 512.0 + sse * 128.0
    return jnp.minimum(j_coded, j_skip)


def _inter_depth(tiles, ref, mvs, blk: int, qp_row, rd_row, ri: int,
                 bit_depth: int, sb_mv, psy: bool = False):
    """J lattice for one (depth, ref): NEWMV at the ME MV and the zero
    MV. tiles: (B, blk, blk) source; mvs: (mv_y, mv_x) grids.
    Returns (j, cand, mv_y8, mv_x8, mv_y8_1, mv_x8_1) flattened."""
    mv_y, mv_x = mvs
    base = rd_row[3 + N_MODES + ri].astype(jnp.float32)   # NEWMV base
    gbase = rd_row[3 + N_MODES + 8 + ri].astype(jnp.float32)  # zero base
    mv_rate = _mv_rate_grid(mv_y, mv_x, sb_mv, blk)

    out = []
    for cand, (my, mx, crate) in (
        (CAND_INTER0 + 2 * ri, (mv_y, mv_x, base + mv_rate.reshape(-1))),
        (CAND_INTER0 + 2 * ri + 1,
         (jnp.zeros_like(mv_y), jnp.zeros_like(mv_x),
          jnp.broadcast_to(gbase, (mv_y.size,)))),
    ):
        pred = _mc_tiles(ref, my, mx, blk)
        j = _cand_j(tiles, pred, crate, blk, qp_row, rd_row, bit_depth, psy)
        z = jnp.zeros(j.shape, jnp.float32)
        out.append((j, jnp.full(j.shape, cand, jnp.float32),
                    my.reshape(-1).astype(jnp.float32),
                    mx.reshape(-1).astype(jnp.float32), z, z))
    return out


def _comp_depth(tiles, refs, geo0, geo1, blk: int, qp_row, rd_row,
                bit_depth: int, sb_mv0, sb_mv1, psy: bool = False):
    """Compound (ref0, ref1) candidates at one depth: NEW_NEWMV at the
    two per-ref ME MVs, and the zero pair (GLOBAL_GLOBALMV). Prediction
    is the rounded average — the analysis stand-in for the spec's
    high-precision compound average (the commit pass is conformant)."""
    base = rd_row[3 + N_MODES + 16].astype(jnp.float32)
    gbase = rd_row[3 + N_MODES + 17].astype(jnp.float32)
    mv_y0, mv_x0 = geo0
    mv_y1, mv_x1 = geo1
    mv_rate = (_mv_rate_grid(mv_y0, mv_x0, sb_mv0, blk)
               + _mv_rate_grid(mv_y1, mv_x1, sb_mv1, blk))
    zeros = jnp.zeros_like(mv_y0)

    out = []
    for cand, (my0, mx0, my1, mx1, crate) in (
        (CAND_COMP_NEW,
         (mv_y0, mv_x0, mv_y1, mv_x1, base + mv_rate.reshape(-1))),
        (CAND_COMP_ZERO,
         (zeros, zeros, zeros, zeros,
          jnp.broadcast_to(gbase, (mv_y0.size,)))),
    ):
        pred = (_mc_tiles(refs[0], my0, mx0, blk)
                + _mc_tiles(refs[1], my1, mx1, blk) + 1) >> 1
        j = _cand_j(tiles, pred, crate, blk, qp_row, rd_row, bit_depth, psy)
        out.append((j, jnp.full(j.shape, cand, jnp.float32),
                    my0.reshape(-1).astype(jnp.float32),
                    mx0.reshape(-1).astype(jnp.float32),
                    my1.reshape(-1).astype(jnp.float32),
                    mx1.reshape(-1).astype(jnp.float32)))
    return out


@partial(jax.jit, static_argnames=("depths", "bit_depth", "psy"))
def inter_analysis(src: jnp.ndarray, refs: jnp.ndarray,
                   qp_row: jnp.ndarray, rd_row: jnp.ndarray,
                   depths: tuple = (64, 32, 16, 8),
                   bit_depth: int = 8, psy: bool = False) -> jnp.ndarray:
    """src (H, W) int, refs (R, H, W) int, H/W multiples of 64.

    qp_row: (10,) luma quantizer row (device.intra.qp_row_for).
    rd_row: (3 + N_MODES + 18 + 1,) int32, 1/512-bit costs:
      [rdmult, skip0, skip1,
       intra mode costs x N_MODES,
       NEWMV base cost per ref x 8 (unused slots prohibitive),
       zero-MV base cost per ref x 8,
       compound NEW_NEWMV base, compound zero base (prohibitive when
       slots 0/1 aren't a legal fwd/bwd pair),
       psy_factor<<8].

    Returns ONE packed f32 row: per depth,
    (j, cand, mv_y, mv_x, mv_y1, mv_x1) flattened grids; unpack with
    unpack_inter_analysis. MVs are in FULL-PEL units here (host
    multiplies by 8); mv_*1 is the second (backward) ref's MV for the
    compound candidates, zero otherwise."""
    src = src.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    maxpix = (1 << bit_depth) - 1

    # per-ref full-pel lattices + per-depth square MVs
    per_ref = []
    for ri in range(refs.shape[0]):
        sad8_h, sad8_z, cyf, cxf = fullpel_lattice(src, refs[ri], maxpix)
        geo = {}
        for blk in depths:
            mv_y, mv_x, _ = geometry_best(sad8_h, sad8_z, cyf, cxf,
                                          blk, blk)
            h, w = src.shape
            nby, nbx = h // 64, w // 64
            nh = 64 // blk
            # (nSB, nh, nw) -> frame grid (nby*nh, nbx*nw)
            def to_grid(a):
                return (a.reshape(nby, nbx, nh, nh).transpose(0, 2, 1, 3)
                        .reshape(nby * nh, nbx * nh))
            geo[blk] = (to_grid(mv_y), to_grid(mv_x))
        per_ref.append(geo)

    parts = []
    for blk in depths:
        tiles = _extract_blocks(src, blk)
        # intra candidates (device.intra RD reduction)
        d = _analyze_depth(src, blk, qp_row, bit_depth, rd_row, psy)
        z = jnp.zeros_like(d["j"])
        cands = [(d["j"], d["mode"], z, z, z, z)]
        for ri in range(refs.shape[0]):
            sb_mv = per_ref[ri][64] if 64 in per_ref[ri] \
                else per_ref[ri][blk]
            cands.extend(_inter_depth(tiles, refs[ri], per_ref[ri][blk],
                                      blk, qp_row, rd_row, ri, bit_depth,
                                      sb_mv, psy))
        if refs.shape[0] >= 2:
            sb0 = per_ref[0][64] if 64 in per_ref[0] else per_ref[0][blk]
            sb1 = per_ref[1][64] if 64 in per_ref[1] else per_ref[1][blk]
            cands.extend(_comp_depth(tiles, refs, per_ref[0][blk],
                                     per_ref[1][blk], blk, qp_row, rd_row,
                                     bit_depth, sb0, sb1, psy))
        js = jnp.stack([c[0] for c in cands])          # (C, B)
        sel = jnp.argmin(js, axis=0)
        take = lambda a: jnp.take_along_axis(a, sel[None], axis=0)[0]  # noqa: E731
        parts.append(js.min(axis=0))
        parts.extend(take(jnp.stack([c[i] for c in cands]))
                     for i in range(1, 6))
    return jnp.concatenate(parts)


FIELDS = ("j", "cand", "mv_y", "mv_x", "mv_y1", "mv_x1")


def unpack_inter_analysis(packed: np.ndarray, hp: int, wp: int,
                          depths: tuple = (64, 32, 16, 8)) -> dict:
    """{blk: {"j","cand","mv_y","mv_x","mv_y1","mv_x1": (nby, nbx)}};
    mv in full-pel."""
    out = {}
    pos = 0
    for blk in depths:
        nby, nbx = hp // blk, wp // blk
        n = nby * nbx
        d = {}
        for f in FIELDS:
            a = packed[pos : pos + n].reshape(nby, nbx)
            d[f] = a if f == "j" else a.astype(np.int32)
            pos += n
        out[blk] = d
    assert pos == packed.size
    return out
