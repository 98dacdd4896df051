"""Batched loop-restoration candidate scoring on device.

Counterpart: restoration_pick.c (search_wiener :1197, search_sgrproj
:560).  The host search (codec/restoration.py) spends nearly all its
time scoring candidates: 7-tap Wiener convolves per refinement step and
guided-filter runs per SGR ep, per restoration unit.  This module
batches every RU of a plane into fixed-size padded stacks and scores on
device:

  * `wiener_sse` — per-(RU, variant) integer-exact Wiener convolve
    (plain-pad semantics) + masked SSE.  int32 throughout (max
    accumulator ~2^25 << 2^31), so tap selection is identical to the
    numpy scorer; the winning taps are re-evaluated with the bit-exact
    striped apply on host, exactly as before.
  * `sgr_corr` — per-(RU, ep) guided filters and the projection LS
    correlations (h00, h11, h01, c0, c1, ss).  The host solves the 2x2
    LS, quantizes xqd, and ranks eps by closed-form SSE from the same
    correlations — no filtering per candidate at all.

RU stacks are padded to the worst-case unit extent (1.5x unit size) so
one compiled program serves every frame of an encode (one compile per
shape, see codec/tpl.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.restoration import (
    SGR_PARAMS,
    SGRPROJ_RST_BITS,
    WIENER_TAPS_MAX,
    WIENER_TAPS_MIN,
    wiener_kernel7,
)

SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12


def _round2_i(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def _round2_j(x, n: int):
    if n <= 0:
        return x
    return jax.lax.shift_right_arithmetic(x + (1 << (n - 1)), n)


@partial(jax.jit, static_argnames=("bit_depth",))
def wiener_sse(pads: jnp.ndarray, srcs: jnp.ndarray, masks: jnp.ndarray,
               hks: jnp.ndarray, vks: jnp.ndarray,
               bit_depth: int = 8) -> jnp.ndarray:
    """pads (N, H+6, W+6) i32 plain-padded RUs; srcs/masks (N, H, W);
    hks/vks (N, T, 7) i32 wiener kernels (wiener_kernel7 applied on
    host).  Returns (N, T) f32 masked SSE of the bit-exact plain-pad
    convolve (ops/restoration.py:107 semantics)."""
    bd = bit_depth
    round0 = 3 + (2 if bd == 12 else 0)
    round1 = 11 - (2 if bd == 12 else 0)
    clamp_lim = 1 << (bd + 1 + 7 - round0)
    n, hp6, wp6 = pads.shape
    h, w = hp6 - 6, wp6 - 6
    x = pads.astype(jnp.int32)
    # horizontal shifted stack (N, 7, H+6, W)
    xs = jnp.stack([x[:, :, k:k + w] for k in range(7)], axis=1)
    ctr_h = (x[:, :, 3:3 + w] << 7) + (1 << (bd + 7 - 1))
    src_f = srcs.astype(jnp.float32)
    msk = masks.astype(jnp.float32)

    def one_variant(carry, kt):
        hk, vk = kt                                  # (N, 7) each
        # int32 operands and accumulator: exact on every backend (the
        # precision setting only applies to floating-point dots)
        acc = jnp.einsum("nk,nkrw->nrw", hk, xs,
                         preferred_element_type=jnp.int32) + ctr_h
        mid = jnp.clip(_round2_j(acc, round0), 0, clamp_lim - 1)
        ms = jnp.stack([mid[:, k:k + h] for k in range(7)], axis=1)
        acc = jnp.einsum("nk,nkrw->nrw", vk, ms,
                         preferred_element_type=jnp.int32)
        acc = acc + (mid[:, 3:3 + h] << 7) - (1 << (bd + round1 - 1))
        out = jnp.clip(_round2_j(acc, round1), 0, (1 << bd) - 1)
        err = (src_f - out.astype(jnp.float32)) * msk
        return carry, (err * err).sum(axis=(1, 2))

    _, sse = jax.lax.scan(one_variant, None,
                          (hks.transpose(1, 0, 2), vks.transpose(1, 0, 2)))
    return sse.T                                     # (N, T)


def _sgr_ab_j(pad, r: int, s: int, bit_depth: int, rows):
    """jnp _sgr_ab (ops/restoration.py:151): A/B rows for radius r.
    pad (H+6, W+6) i32; rows (R,) static numpy. f32 where int32 would
    overflow (z, B products) — scoring-only precision."""
    h = pad.shape[0] - 6
    w = pad.shape[1] - 6
    nn = (2 * r + 1) * (2 * r + 1)
    x = pad.astype(jnp.float32)
    # windowed sums via cumsum (valid region)
    def box(a):
        c = jnp.cumsum(a, axis=0)
        v = jnp.concatenate([c[2 * r:2 * r + 1], c[2 * r + 1:] - c[:-2 * r - 1]])
        c = jnp.cumsum(v, axis=1)
        return jnp.concatenate(
            [c[:, 2 * r:2 * r + 1], c[:, 2 * r + 1:] - c[:, :-2 * r - 1]],
            axis=1)

    bsum = box(x)
    asum = box(x * x)
    sel_r = np.asarray(rows) + 3 - r
    sel_c = np.arange(-1, w + 1) + 3 - r
    b_raw = bsum[sel_r][:, sel_c]
    a = jnp.round(asum[sel_r][:, sel_c] / (1 << (2 * (bit_depth - 8)))
                  if bit_depth > 8 else asum[sel_r][:, sel_c])
    b = jnp.round(b_raw / (1 << (bit_depth - 8))) if bit_depth > 8 else b_raw
    p = jnp.maximum(a * nn - b * b, 0.0)
    z = jnp.floor((p * s + (1 << (SGRPROJ_MTABLE_BITS - 1)))
                  / (1 << SGRPROJ_MTABLE_BITS))
    from ..ops.restoration import _ONE_BY_X, _X_BY_XPLUS1

    A = jnp.asarray(_X_BY_XPLUS1, jnp.float32)[
        jnp.clip(z, 0, 255).astype(jnp.int32)]
    B = jnp.floor(((SGRPROJ_SGR - A) * b_raw * float(_ONE_BY_X[nn - 1])
                   + (1 << (SGRPROJ_RECIP_BITS - 1)))
                  / (1 << SGRPROJ_RECIP_BITS))
    return A, B


def _sgr_flt_j(pad, ep: int, bit_depth: int):
    """jnp sgr_flt (ops/restoration.py:178), f32 scoring precision."""
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    h = pad.shape[0] - 6
    w = pad.shape[1] - 6
    dgd = pad.astype(jnp.float32)[3:3 + h, 3:3 + w]
    flt0 = flt1 = None
    if r0 > 0:
        rows = np.arange(-1, h + 1, 2)
        A, B = _sgr_ab_j(pad, r0, s0, bit_depth, rows)
        ev = np.arange(0, h, 2)
        up = (ev + 1) // 2
        dn = up + 1
        a_mid = A[:, 1:w + 1]
        b_mid = B[:, 1:w + 1]
        a_l, a_r = A[:, 0:w], A[:, 2:w + 2]
        b_l, b_r = B[:, 0:w], B[:, 2:w + 2]
        a_e = (a_mid[up] + a_mid[dn]) * 6 + (a_l[up] + a_l[dn] + a_r[up] + a_r[dn]) * 5
        b_e = (b_mid[up] + b_mid[dn]) * 6 + (b_l[up] + b_l[dn] + b_r[up] + b_r[dn]) * 5
        od = np.arange(1, h, 2)
        own = (od + 1) // 2
        a_o = a_mid[own] * 6 + (a_l[own] + a_r[own]) * 5
        b_o = b_mid[own] * 6 + (b_l[own] + b_r[own]) * 5
        sh_e = SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS
        sh_o = SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS
        f_ev = jnp.floor((a_e * dgd[ev] + b_e + (1 << (sh_e - 1)))
                         / (1 << sh_e))
        f_od = jnp.floor((a_o * dgd[od] + b_o + (1 << (sh_o - 1)))
                         / (1 << sh_o))
        flt0 = jnp.zeros((h, w), jnp.float32).at[ev].set(f_ev).at[od].set(f_od)
    if r1 > 0:
        rows = np.arange(-1, h + 1)
        A, B = _sgr_ab_j(pad, r1, s1, bit_depth, rows)

        def cross(m):
            mid = m[1:h + 1, 1:w + 1]
            return ((mid + m[1:h + 1, 0:w] + m[1:h + 1, 2:w + 2]
                     + m[0:h, 1:w + 1] + m[2:h + 2, 1:w + 1]) * 4
                    + (m[0:h, 0:w] + m[0:h, 2:w + 2]
                       + m[2:h + 2, 0:w] + m[2:h + 2, 2:w + 2]) * 3)

        sh = SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS
        flt1 = jnp.floor((cross(A) * dgd + cross(B) + (1 << (sh - 1)))
                         / (1 << sh))
    return flt0, flt1


def _kern7_j(taps):
    """jnp wiener_kernel7: (..., 3) taps -> (..., 7) differential kernel."""
    t0 = taps[..., 0]
    t1 = taps[..., 1]
    t2 = taps[..., 2]
    return jnp.stack([t0, t1, t2, -2 * (t0 + t1 + t2), t2, t1, t0],
                     axis=-1)


def _descent_offsets(chroma: bool) -> np.ndarray:
    """Static (V, 2, 3) +-1 step table: variant 0 = keep, then one step
    per (direction, tap, sign) in the host descent's exact order."""
    first = 1 if chroma else 0
    offs = [np.zeros((2, 3), np.int32)]
    for d in range(2):
        for j in range(first, 3):
            for step in (1, -1):
                o = np.zeros((2, 3), np.int32)
                o[d, j] = step
                offs.append(o)
    return np.stack(offs)


@partial(jax.jit, static_argnames=("bit_depth", "n_rounds", "chroma"))
def wiener_descent(pads: jnp.ndarray, srcs: jnp.ndarray, masks: jnp.ndarray,
                   init_taps: jnp.ndarray, bit_depth: int, n_rounds: int,
                   chroma: bool):
    """Fused Wiener search: score the T0 initial damped-LS candidates,
    then run `n_rounds` of 13-variant +-1 steepest descent entirely on
    device (VERDICT r3 #1a: one device call instead of one per round).

    pads (N, H+6, W+6) / srcs, masks (N, H, W) — any int dtype (cast
    here; callers upload uint16/uint8 to halve the transfer).
    init_taps (N, T0, 2, 3) int32 (h, v) tap triples.
    Returns (taps (N, 2, 3) i32, best_sse (N,) f32)."""
    bd = bit_depth
    round0 = 3 + (2 if bd == 12 else 0)
    round1 = 11 - (2 if bd == 12 else 0)
    clamp_lim = 1 << (bd + 1 + 7 - round0)
    n, hp6, wp6 = pads.shape
    h, w = hp6 - 6, wp6 - 6
    x = pads.astype(jnp.int32)
    xs = jnp.stack([x[:, :, k:k + w] for k in range(7)], axis=1)
    ctr_h = (x[:, :, 3:3 + w] << 7) + (1 << (bd + 7 - 1))
    src_f = srcs.astype(jnp.float32)
    msk = masks.astype(jnp.float32)

    def score(hk, vk):
        """(N, 7) int32 h/v kernels -> (N,) masked SSE."""
        # int32 operands and accumulator: exact on every backend (the
        # precision setting only applies to floating-point dots)
        acc = jnp.einsum("nk,nkrw->nrw", hk, xs,
                         preferred_element_type=jnp.int32) + ctr_h
        mid = jnp.clip(_round2_j(acc, round0), 0, clamp_lim - 1)
        ms = jnp.stack([mid[:, k:k + h] for k in range(7)], axis=1)
        acc = jnp.einsum("nk,nkrw->nrw", vk, ms,
                         preferred_element_type=jnp.int32)
        acc = acc + (mid[:, 3:3 + h] << 7) - (1 << (bd + round1 - 1))
        out = jnp.clip(_round2_j(acc, round1), 0, (1 << bd) - 1)
        err = (src_f - out.astype(jnp.float32)) * msk
        return (err * err).sum(axis=(1, 2))

    def score_set(cands):
        """(N, T, 2, 3) -> (N, T) SSE via scan over variants."""
        hk = _kern7_j(cands[:, :, 0])
        vk = _kern7_j(cands[:, :, 1])
        _, sse = jax.lax.scan(
            lambda c, kt: (c, score(kt[0], kt[1])), None,
            (hk.transpose(1, 0, 2), vk.transpose(1, 0, 2)))
        return sse.T

    sse0 = score_set(init_taps)
    arg0 = sse0.argmin(axis=1)
    taps = jnp.take_along_axis(init_taps, arg0[:, None, None, None],
                               axis=1)[:, 0]
    best = sse0.min(axis=1)

    offs = jnp.asarray(_descent_offsets(chroma))           # (V, 2, 3)
    tmin = jnp.asarray(np.array(WIENER_TAPS_MIN, np.int32))
    tmax = jnp.asarray(np.array(WIENER_TAPS_MAX, np.int32))

    def round_body(_, carry):
        taps, best = carry
        cands = jnp.clip(taps[:, None] + offs[None], tmin, tmax)
        sse = score_set(cands)                              # (N, V)
        arg = sse.argmin(axis=1)
        sse_min = jnp.take_along_axis(sse, arg[:, None], axis=1)[:, 0]
        picked = jnp.take_along_axis(cands, arg[:, None, None, None],
                                     axis=1)[:, 0]
        impr = sse_min < best - 0.5
        taps = jnp.where(impr[:, None, None], picked, taps)
        best = jnp.where(impr, sse_min, best)
        return taps, best

    if n_rounds:
        taps, best = jax.lax.fori_loop(0, n_rounds, round_body,
                                       (taps, best))
    return taps, best


@partial(jax.jit, static_argnames=("eps", "bit_depth"))
def sgr_corr(pads: jnp.ndarray, srcs: jnp.ndarray, masks: jnp.ndarray,
             eps: tuple, bit_depth: int = 8) -> jnp.ndarray:
    """Projection-LS correlations per (RU, ep): returns (N, nEp, 6) f32
    [h00, h11, h01, c0, c1, ss] with the svt_get_proj_subspace scaling
    (restoration_pick.c:413); masked to the RU's real extent."""
    n, hp6, wp6 = pads.shape
    h, w = hp6 - 6, wp6 - 6
    msk = masks.astype(jnp.float32)

    def one_ru(pad, src, m):
        d = pad.astype(jnp.float32)[3:3 + h, 3:3 + w]
        u = d * (1 << SGRPROJ_RST_BITS)
        s = src.astype(jnp.float32) * (1 << SGRPROJ_RST_BITS) - u
        s = s * m
        rows = []
        for ep in eps:
            r0, r1, _, _ = SGR_PARAMS[ep]
            flt0, flt1 = _sgr_flt_j(pad, ep, bit_depth)
            f0 = (flt0 - u) * m if r0 else jnp.zeros_like(u)
            f1 = (flt1 - u) * m if r1 else jnp.zeros_like(u)
            rows.append(jnp.stack([
                (f0 * f0).sum(), (f1 * f1).sum(), (f0 * f1).sum(),
                (f0 * s).sum(), (f1 * s).sum(), (s * s).sum()]))
        return jnp.stack(rows)

    return jax.vmap(one_ru)(pads, srcs, masks)
