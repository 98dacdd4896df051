"""Batched hierarchical motion estimation on device.

One jitted call computes full-pel motion vectors for EVERY block of a
frame, at EVERY mode-decision geometry (64x64 .. 8x8 squares plus the
HORZ/VERT rectangles), against a stack of reference frames:

  * HME level 0 — both frames decimated 1/16; the candidate SAD field
    for a +-R0 window is computed by shifting the WHOLE decimated image
    and box-reducing into superblock tiles (no per-block loops).
    Reach: +-R0*16 full-pel (default +-256).
  * HME level 1 — 1/4 decimation; per-SB windows gathered around the
    scaled L0 winner, +-R1 refinement.
  * Level 2 — full resolution; per-SB (64 + 2*R2)^2 windows around the
    scaled L1 winner; SADs are reduced on an 8x8 lattice and then
    aggregated into every larger geometry, so each block size gets its
    own argmin over the shared window (the reference's
    ext_sad_calculation_* pyramid, motion_estimation.c:1568,3076,
    reformulated as one batched reduction).

All offset sweeps are lax.scan loops over a static offset table: compiled
program size stays O(1) in the search range while the per-step work is a
fused whole-frame abs-diff + box reduction.

The host gets ONE packed int32 array per (frame, ref): for each
geometry, (mv_y, mv_x, sad) grids. Mode decision seeds its NEWMV
candidates from these and only runs sub-pel refinement per chosen
candidate (codec/md.py), replacing the per-block Python raster search.

Counterpart: motion_estimation.c prehme_core:1568, hme_level_0:820,
hme_level_1:923, hme_level_2:1025, open-loop ME sblock:779 — redesigned
as whole-frame tensor ops per SURVEY §2.3 ("batched reductions over SB
grids") rather than a translation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# (h, w) in pixels of every geometry MD can request (squares for NONE/
# SPLIT depths, rects for HORZ/VERT partitions)
GEOMETRIES = ((64, 64), (64, 32), (32, 64), (32, 32), (32, 16), (16, 32),
              (16, 16), (16, 8), (8, 16), (8, 8))

R0 = 16  # +-range at 1/16 scale
R1 = 8   # +-range at 1/4 scale
R2 = 8   # +-range at full scale


def _decimate(plane: jnp.ndarray, f: int) -> jnp.ndarray:
    """Box-mean decimation by f (analysis-only pyramid; the exact
    downsample filter is a non-normative heuristic)."""
    h, w = plane.shape
    t = plane.reshape(h // f, f, w // f, f)
    return t.sum(axis=(1, 3)) // (f * f)


def _offset_table(rng: int, base: int = 0) -> jnp.ndarray:
    """((2*rng+1)^2, 2) row-major (dy, dx) offsets, starting at `base`."""
    n = 2 * rng + 1
    g = jnp.stack(jnp.meshgrid(jnp.arange(n), jnp.arange(n),
                               indexing="ij"), axis=-1)
    return g.reshape(-1, 2) + base


def _shift_sad_field(src: jnp.ndarray, ref: jnp.ndarray, tile: int,
                     rng: int, maxpix: int) -> jnp.ndarray:
    """(O, nty, ntx) SAD of every tile x every shift in +-rng.

    Out-of-frame shifted samples are charged the worst-case per-pixel
    diff (maxpix): the decimated HME levels must not chase spurious
    minima in edge-replicated regions (full-res level 2 uses honest
    clamped-prediction SADs instead — that IS what MC will produce)."""
    h, w = src.shape
    rows = jnp.arange(h)
    cols = jnp.arange(w)
    # pad + dynamic_slice per offset: a contiguous copy, not a
    # clipped-index whole-frame gather
    ref_pad = jnp.pad(ref, rng, mode="edge")

    def body(_, off):
        cand = jax.lax.dynamic_slice(ref_pad, (off[0] + rng, off[1] + rng),
                                     (h, w))
        valid = ((((rows + off[0]) >= 0) & ((rows + off[0]) < h))[:, None]
                 & (((cols + off[1]) >= 0) & ((cols + off[1]) < w))[None, :])
        diff = jnp.where(valid, jnp.abs(src - cand), maxpix)
        t = diff.reshape(h // tile, tile, w // tile, tile)
        # distance tie-break: flat SAD basins (smooth gradients — the
        # aperture problem) resolve toward the smallest offset
        return None, t.sum(axis=(1, 3)) * 16 + jnp.abs(off).sum()

    _, sads = jax.lax.scan(body, None, _offset_table(rng, -rng))
    return sads  # (O, nty, ntx)


def _argmin_offset(sads: jnp.ndarray, rng: int):
    """sads (O, ...) -> (dy, dx) int32 grids of the winning shift."""
    n = 2 * rng + 1
    idx = jnp.argmin(sads, axis=0).astype(jnp.int32)
    return idx // n - rng, idx % n - rng


def _gather_windows(ref: jnp.ndarray, cy: jnp.ndarray, cx: jnp.ndarray,
                    blk: int, rng: int):
    """Per-SB search windows. cy/cx: (nSBy, nSBx) center offsets in this
    scale's pixels. Returns (window, valid): (nSB, blk+2*rng, blk+2*rng)
    clipped (edge-replicating) sample gathers + in-frame mask."""
    h, w = ref.shape
    nby, nbx = cy.shape
    base_y = jnp.arange(nby)[:, None] * blk
    base_x = jnp.arange(nbx)[None, :] * blk
    y0 = (base_y + cy - rng).reshape(-1)          # (nSB,)
    x0 = (base_x + cx - rng).reshape(-1)
    span = blk + 2 * rng
    ry = y0[:, None] + jnp.arange(span)[None, :]
    cx_ = x0[:, None] + jnp.arange(span)[None, :]
    rows = jnp.clip(ry, 0, h - 1)
    cols = jnp.clip(cx_, 0, w - 1)
    valid = (((ry >= 0) & (ry < h))[:, :, None]
             & ((cx_ >= 0) & (cx_ < w))[:, None, :])
    return ref[rows[:, :, None], cols[:, None, :]], valid


def _tiles(plane: jnp.ndarray, blk: int) -> jnp.ndarray:
    h, w = plane.shape
    return (plane.reshape(h // blk, blk, w // blk, blk)
            .transpose(0, 2, 1, 3).reshape(-1, blk, blk))


def fullpel_lattice(src: jnp.ndarray, ref: jnp.ndarray, maxpix: int):
    """HME pyramid + dual-anchor full-pel search. Returns
    (sad8_h, sad8_z, cyf, cxf): 8x8-granular SAD lattices (nSB, O2, 8, 8)
    for the HME-centered and zero-centered windows, plus the full-pel
    window centers (nSB, 1, 1). Shared by the packed ME entry point and
    the fused inter-MD analysis (device/inter.py)."""
    h, w = src.shape
    nby, nbx = h // 64, w // 64
    nsb = nby * nbx

    # --- HME L0 at 1/16: whole-image shift + box reduce ------------------
    if min(h, w) >= 128:
        s16, r16 = _decimate(src, 16), _decimate(ref, 16)
        sad0 = _shift_sad_field(s16, r16, 4, R0, maxpix)  # (O, nby, nbx)
        dy0, dx0 = _argmin_offset(sad0, R0)           # 1/16-scale units
    else:
        dy0 = jnp.zeros((nby, nbx), jnp.int32)
        dx0 = jnp.zeros((nby, nbx), jnp.int32)

    # --- HME L1 at 1/4: per-SB window around scaled L0 -------------------
    s4, r4 = _decimate(src, 4), _decimate(ref, 4)
    t4 = _tiles(s4, 16)                               # (nSB, 16, 16)
    win4, val4 = _gather_windows(r4, dy0 * 4, dx0 * 4, 16, R1)

    def body1(_, off):
        cand = jax.lax.dynamic_slice(win4, (0, off[0], off[1]),
                                     (nsb, 16, 16))
        vv = jax.lax.dynamic_slice(val4, (0, off[0], off[1]),
                                   (nsb, 16, 16))
        d = jnp.where(vv, jnp.abs(t4 - cand), maxpix)
        return None, d.sum(axis=(1, 2)) * 16 + jnp.abs(off - R1).sum()

    _, sad1 = jax.lax.scan(body1, None, _offset_table(R1))  # (O1, nSB)
    dy1, dx1 = _argmin_offset(sad1, R1)               # (nSB,) 1/4 units
    cy = (dy0 * 4).reshape(-1) + dy1                  # 1/4-scale center
    cx = (dx0 * 4).reshape(-1) + dx1

    # --- L2 full-pel: per-SB windows, 8x8 SAD lattices --------------------
    # Honest clamped-prediction SADs here (edge replication is exactly
    # what spec MC sample clamping produces, 7.11.3.3). Two anchors per
    # SB — the HME center and the zero MV — mirroring the reference's
    # practice of searching around both the HME winner and the
    # co-located position; the zero window rescues SBs whose decimated
    # levels had no usable signal (flat/noisy content).
    t1 = _tiles(src, 64)                              # (nSB, 64, 64)
    n2 = 2 * R2 + 1
    zero = jnp.zeros((nby, nbx), jnp.int32)

    def lattice(cy_full, cx_full):
        win, _ = _gather_windows(ref, cy_full, cx_full, 64, R2)

        def body2(_, off):
            cand = jax.lax.dynamic_slice(win, (0, off[0], off[1]),
                                         (nsb, 64, 64))
            d = jnp.abs(t1 - cand)
            return None, d.reshape(-1, 8, 8, 8, 8).sum(axis=(2, 4))

        _, lat = jax.lax.scan(body2, None, _offset_table(R2))
        return lat.transpose(1, 0, 2, 3)              # (nSB, O2, 8, 8)

    sad8_h = lattice((cy * 4).reshape(nby, nbx), (cx * 4).reshape(nby, nbx))
    sad8_z = lattice(zero, zero)

    # window centers in full-pel units, broadcast helpers
    cyf = (cy * 4)[:, None, None]
    cxf = (cx * 4)[:, None, None]
    return sad8_h, sad8_z, cyf, cxf


def geometry_best(sad8_h, sad8_z, cyf, cxf, gh: int, gw: int):
    """Aggregate the 8x8 lattices to geometry (gh, gw) and pick the best
    (mv_y, mv_x, sad) per block over both anchors: (nSB, nh, nw) each."""
    n2 = 2 * R2 + 1
    th, tw = gh // 8, gw // 8

    def agg_min(sad8):
        agg = sad8.reshape(sad8.shape[0], n2 * n2, 8 // th, th,
                           8 // tw, tw).sum(axis=(3, 5))
        idx = jnp.argmin(agg, axis=1).astype(jnp.int32)
        return idx, jnp.min(agg, axis=1)

    idx_h, best_h = agg_min(sad8_h)
    idx_z, best_z = agg_min(sad8_z)
    use_z = best_z <= best_h
    best = jnp.where(use_z, best_z, best_h)
    mv_y = jnp.where(use_z, idx_z // n2 - R2, cyf + idx_h // n2 - R2)
    mv_x = jnp.where(use_z, idx_z % n2 - R2, cxf + idx_h % n2 - R2)
    return mv_y, mv_x, best


def _me_one_ref(src: jnp.ndarray, ref: jnp.ndarray,
                maxpix: int) -> jnp.ndarray:
    """Full-pel ME of src against one reference. Both (H, W) int32 with
    H, W multiples of 64. Returns the packed per-geometry result row."""
    h, w = src.shape
    nby, nbx = h // 64, w // 64
    sad8_h, sad8_z, cyf, cxf = fullpel_lattice(src, ref, maxpix)
    parts = []
    for gh, gw in GEOMETRIES:
        mv_y, mv_x, best = geometry_best(sad8_h, sad8_z, cyf, cxf, gh, gw)
        nh, nw = 64 // gh, 64 // gw
        for a in (mv_y, mv_x, best):
            g = a.reshape(nby, nbx, nh, nw).transpose(0, 2, 1, 3)
            parts.append(g.reshape(-1).astype(jnp.int32))
    return jnp.concatenate(parts)


from functools import partial


@partial(jax.jit, static_argnames=("bit_depth",))
def me_fullpel(src: jnp.ndarray, refs: jnp.ndarray,
               bit_depth: int = 8) -> jnp.ndarray:
    """src (H, W), refs (R, H, W); H, W multiples of 64; any int dtype.
    Returns (R, P) packed int32 rows (one host transfer)."""
    src = src.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    maxpix = (1 << bit_depth) - 1
    return jax.vmap(lambda r: _me_one_ref(src, r, maxpix))(refs)


def unpack_me(row: np.ndarray, h: int, w: int) -> dict:
    """{(gh, gw): {"mv": (gy, gx, 2) int32 full-pel, "sad": (gy, gx)}}."""
    out = {}
    pos = 0
    for gh, gw in GEOMETRIES:
        gy, gx = h // gh, w // gw
        n = gy * gx
        mv_y = row[pos : pos + n].reshape(gy, gx); pos += n
        mv_x = row[pos : pos + n].reshape(gy, gx); pos += n
        sad = row[pos : pos + n].reshape(gy, gx); pos += n
        out[(gh, gw)] = {"mv": np.stack([mv_y, mv_x], axis=-1), "sad": sad}
    assert pos == row.size
    return out


class FrameMotionField:
    """Host-side view of one frame's device ME results (per ref)."""

    def __init__(self, maps_by_ref: dict, h: int, w: int):
        self.maps = maps_by_ref  # ref name -> {(gh, gw): {...}}
        self.h = h
        self.w = w

    def lookup(self, ref_id: int, x: int, y: int, w: int, h: int):
        """Full-pel (mv_y, mv_x) for the block at pixel (x, y) of size
        (w, h); falls back to the containing square when the exact
        geometry isn't in the lattice. Returns a 1/8-pel MV tuple or
        None when no map exists for the ref."""
        m = self.maps.get(ref_id)
        if m is None:
            return None
        key = (h, w)
        if key not in m:
            side = 8
            while side < max(h, w) and side < 64:
                side *= 2
            key = (side, side)
            if key not in m:
                return None
        g = m[key]
        gy = min(y // key[0], g["mv"].shape[0] - 1)
        gx = min(x // key[1], g["mv"].shape[1] - 1)
        mv = g["mv"][gy, gx]
        return int(mv[0]) * 8, int(mv[1]) * 8


def run_device_me(src: np.ndarray, ref_planes: dict,
                  bit_depth: int = 8) -> FrameMotionField:
    """Host wrapper: pad luma planes to 64 alignment, stack refs, one
    device call, unpack. `ref_planes`: {ref name: luma ndarray}."""
    def pad64(p):
        h, w = p.shape
        hp, wp = (h + 63) & ~63, (w + 63) & ~63
        if hp != h or wp != w:
            p = np.pad(p, ((0, hp - h), (0, wp - w)), mode="edge")
        return p

    srcp = pad64(np.ascontiguousarray(src))
    names = sorted(ref_planes)
    refs = np.stack([pad64(np.ascontiguousarray(ref_planes[n]))
                     for n in names])
    rows = np.asarray(me_fullpel(jax.device_put(srcp.astype(np.int32)),
                                 jax.device_put(refs.astype(np.int32)),
                                 bit_depth=bit_depth))
    hp, wp = srcp.shape
    maps = {n: unpack_me(rows[i], hp, wp) for i, n in enumerate(names)}
    return FrameMotionField(maps, hp, wp)
