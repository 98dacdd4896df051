"""Device analysis arithmetic against the integer reference networks.

The matrix-form DCTs (device/matdct.py) run as float32 matmuls at
Precision.HIGHEST; the CDEF direction search (device/cdef._find_dir) is
decoder-visible and must be bit-exact on every backend.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from svt_av1_psyex_tpu.device.cdef import _find_dir
from svt_av1_psyex_tpu.device.matdct import fwd_dct2d_mat, inv_dct2d_mat
from svt_av1_psyex_tpu.ops.cdef import find_dir_batch
from svt_av1_psyex_tpu.ops.txfm import forward_txfm2d, inverse_txfm2d

NS = (4, 8, 16, 32, 64)


def _residuals(n: int) -> np.ndarray:
    """Random full-range 8-bit residuals plus the +-255 extremes."""
    rng = np.random.RandomState(n)
    res = rng.randint(-255, 256, (24, n, n)).astype(np.int32)
    res[:4] = 255
    res[4:8] = -255
    res[8:12] = np.where((np.arange(n)[:, None] + np.arange(n)) % 2, 255,
                         -255)
    return res


@pytest.mark.parametrize("n", NS)
def test_matdct_forward_matches_integer_network(n):
    # The integer network rounds after every butterfly stage and the
    # matrix form rounds nothing, so they differ by the accumulated stage
    # rounding: at most n/2 + 2 units of the output coefficient.
    res = _residuals(n)
    cn = min(n, 32)
    want = forward_txfm2d(res, n, n, 0)[:, :cn, :cn]
    got = np.asarray(fwd_dct2d_mat(jnp.asarray(res), n))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= n / 2 + 2


@pytest.mark.parametrize("n", NS)
def test_matdct_inverse_matches_integer_network(n):
    # Coefficients of real residuals (the range the analysis tier sees);
    # stage rounding again bounds the difference: at most 2 units.
    cn = min(n, 32)
    coeffs = forward_txfm2d(_residuals(n), n, n, 0)[:, :cn, :cn]
    want = inverse_txfm2d(coeffs, n, n, 0)
    got = np.asarray(inv_dct2d_mat(jnp.asarray(coeffs), n))
    assert got.shape == want.shape == (coeffs.shape[0], n, n)
    assert np.abs(got - want).max() <= 2


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_find_dir_bitexact_vs_numpy(bit_depth):
    maxv = (1 << bit_depth) - 1
    rng = np.random.RandomState(bit_depth)
    yy, xx = np.mgrid[0:8, 0:8]
    blocks = [np.zeros((8, 8)), np.full((8, 8), maxv),
              np.where((yy + xx) % 2, maxv, 0), np.where(yy < 4, maxv, 0),
              np.where(xx < 4, maxv, 0), np.where(yy > xx, maxv, 0),
              np.where(yy + xx > 7, maxv, 0), (xx * maxv) // 7,
              (yy * maxv) // 7, np.where((yy // 2 + xx) % 3 == 0, maxv, 0)]
    blocks += list(rng.randint(0, maxv + 1, (40, 8, 8)))
    blocks += list(np.clip(rng.randint(0, maxv + 1, (20, 1, 1))
                           + rng.randint(-3, 4, (20, 8, 8)), 0, maxv))
    blocks = np.stack(blocks).astype(np.int64)
    cs = bit_depth - 8
    want_dir, want_var = find_dir_batch(blocks, cs)
    got_dir, got_var = _find_dir(jnp.asarray(blocks, jnp.int32), cs)
    assert np.array_equal(np.asarray(got_dir), want_dir)
    assert np.array_equal(np.asarray(got_var), want_var)


def test_device_cdef_frame_matches_numpy():
    """Device CDEF search + apply (full-grid level 4) equals ops/cdef.py on
    a frame whose chroma overhang lies inside the 64x64-unit grid: the
    device writes back the coded area only."""
    from svt_av1_psyex_tpu.device.cdef import cdef_search_frame_device
    from svt_av1_psyex_tpu.ops.cdef import cdef_search_frame

    w, h = 200, 120
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:mi_rows * 4, 0:mi_cols * 4]
    luma = (128 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.int32)
    src = [luma, luma[::2, ::2].copy(), 255 - luma[::2, ::2]]
    src[1:] = [np.pad(p, ((0, 4), (0, 4)), mode="edge") for p in src[1:]]
    recon = [np.clip(p + rng.randint(-4, 5, p.shape), 0, 255).astype(np.int32)
             for p in src]
    skip_g = np.zeros((mi_rows, mi_cols), np.uint8)
    skip_g[:4, :6] = 1

    def rd(rate, dist):
        return rate * 300 / 512.0 + dist * 128.0

    dev = [p.copy() for p in recon]
    host = [p.copy() for p in recon]
    got = cdef_search_frame_device(dev, src, skip_g, mi_rows, mi_cols, 120,
                                   rd, level=4, bit_depth=8)
    want = cdef_search_frame(host, src, skip_g, mi_rows, mi_cols, 120, rd,
                             level=4, bit_depth=8)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(dev, host):
        assert np.array_equal(a, b)
