#!/usr/bin/env python3
"""Smoke test of the encoder's main path on one NVIDIA GPU.

Run from the root of a checkout, with no arguments, on a machine with a
card:

    python chip_smoke.py [--out DIR]

One process, one card. The phases run in order, and the first one that
goes wrong ends the run with a non-zero exit and no result line:

1. device: JAX must find a GPU (never the CPU); JAX's view of it and the
   card's name and power limit as nvidia-smi reports them.
2. native: the C library (entropy coder, frame commit, CDEF, MVP, RDOQ)
   and the dav1d shim are built from the committed sources or loaded; a
   build or load failure is an error, not a fallback to Python. Without
   libdav1d.so.6 on the machine, the stream gate of phases 4-5 becomes
   byte-equality with the same encode on the CPU backend, and the output
   says so.
3. device programs: every device program of config 2 (1280x720 8-bit,
   preset 8) is compiled for the card at its real shapes, its memory use
   and time are printed, and its output is compared with a plain
   reference: numpy host code for ME, CDEF and loop restoration, the
   same jitted function on the CPU for the rest. Then the same programs
   are compiled at config-3 shapes (1920x1080 10-bit, preset 6): compile
   and memory only.
4. config 1: 352x288 8-bit, preset 12, CRF 35, intra only, 8 frames,
   through the SvtAv1Encoder API; the stream passes the gate.
5. config 2: 1280x720 8-bit, preset 8, CRF 30, random access, 17 frames
   (key frame + one mini-GOP) with TF, TPL and the device mode decision;
   cold and warm passes; the stream passes the gate on every plane of
   every displayed frame.

The times printed are bring-up figures for the card named beside them,
not benchmark results. --out DIR keeps each stream and per-frame recon
hashes, for decoding elsewhere. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The analysis programs compute in float32 with every matmul at
# Precision.HIGHEST (full f32 products, no TF32). Summation order and the
# log2/exp functions still differ between backends by ulps, and the
# analysis turns a few of those ulps into whole units (a quantization
# level, a truncated rate unit, a TF weight step, and so a decision on a
# near-tie). An output entry matches its CPU counterpart when equal
# (integers) or within FLOAT_RTOL * max(1, |cpu|) (floats); at most
# MISMATCH_FRAC of a program's entries may fail to match. Programs whose
# arithmetic is integer (ME, CDEF) are held to exact equality instead.
FLOAT_RTOL = 1e-5
MISMATCH_FRAC = 1e-3
# Loop-restoration statistics against the exact numpy filters: the Wiener
# SSE is a float32 sum of exact integer squares over one restoration unit;
# the SGR correlations also come from a guided filter that keeps its B
# products in float32 (scoring precision, device/restoration.py), so a
# filtered sample may be off by one unit.
LR_WIENER_RTOL = 1e-5
LR_SGR_RTOL = 1e-3
TIMING_REPS = 5

CONFIG1 = dict(w=352, h=288, bit_depth=8, preset=12, crf=35, frames=8,
               intra=True)
CONFIG2 = dict(w=1280, h=720, bit_depth=8, preset=8, crf=30, frames=17,
               intra=False)
CONFIG3 = dict(w=1920, h=1080, bit_depth=10, preset=6, crf=30, frames=24,
               intra=False)

# backend switches that would take the encode off the path under test
_OFF_PATH_ENV = ("SVT_TPU_PY_EC", "SVT_TPU_PY_COMMIT", "SVT_TPU_PY_MVP",
                 "SVT_TPU_HOST_MD", "SVT_TPU_HOST_ME", "SVT_TPU_HOST_TF",
                 "SVT_TPU_HOST_LR", "SVT_TPU_HOST_CDEF", "SVT_TPU_INTDCT")


class SmokeError(RuntimeError):
    """A phase failed."""


def say(*parts) -> None:
    print(*parts, flush=True)


# ---- phase 1: device -------------------------------------------------------


def require_gpu(devices) -> object:
    """The first device, which must be a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise SmokeError(f"JAX found no GPU (first device: {found})")
    return devices[0]


def card_line() -> str:
    """`name, power.limit` of the card, read by nvidia-smi (no JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        raise SmokeError(f"nvidia-smi failed: {exc}") from exc
    return r.stdout.strip().splitlines()[0]


class CompileCounter:
    """Counts XLA compiles, their seconds and persistent-cache hits."""

    def __init__(self):
        import jax.monitoring as mon

        self.compiles = 0
        self.seconds = 0.0
        self.cache_hits = 0
        mon.register_event_duration_secs_listener(self._on_duration)
        mon.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1
            self.seconds += duration

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self) -> tuple:
        return self.compiles, self.seconds, self.cache_hits


# ---- phase 2: native -------------------------------------------------------


def check_native() -> str:
    """Load the C library strictly; returns the stream gate to use."""
    from svt_av1_psyex_tpu.native import commit, ecenc, frame_enc

    set_env = [k for k in _OFF_PATH_ENV if os.environ.get(k)]
    if set_env:
        raise SmokeError(f"off-path backend switches set: {set_env}")
    try:
        lib = ecenc.require_lib()
    except RuntimeError as exc:
        raise SmokeError(str(exc)) from exc
    say(f"native: C library {lib._name}")
    if not isinstance(ecenc.make_entropy_encoder(),
                      ecenc.NativeEntropyEncoder):
        raise SmokeError("entropy coder is the Python fallback")
    if not (frame_enc.available() and commit.available()):
        raise SmokeError("native commit unavailable")
    say("native: C entropy coder and C frame commit in use")
    cc = subprocess.run(["gcc", "-dumpfullversion"], capture_output=True,
                        text=True).stdout.strip()
    say(f"native: gcc {cc}")
    for so in ("libdav1d.so.6", "libaom.so.3"):
        try:
            ctypes.CDLL(so)
            say(f"native: {so} present")
        except OSError:
            say(f"native: {so} ABSENT")
    try:
        ctypes.CDLL("libdav1d.so.6")
    except OSError:
        say("gate: libdav1d.so.6 is absent, so each stream must equal, "
            "byte for byte, the same encode on the CPU backend")
        return "cpu-equality"
    from svt_av1_psyex_tpu.conformance.dav1d import dav1d_version

    say(f"native: dav1d {dav1d_version()}")
    say("gate: dav1d decode must equal the encoder's recon on every "
        "plane of every displayed frame")
    return "dav1d"


# ---- phase 3: device programs ---------------------------------------------


def make_fill(bit_depth: int, seed: int = 0):
    """fill(shape, dtype): smooth moving content plus mild noise; the
    leading axes of a stack index frames (time)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1

    def fill(shape, dtype):
        *lead, h, w = shape
        n = int(np.prod(lead)) if lead else 1
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = []
        for t in range(n):
            y = 0.5 + 0.3 * np.sin((xx + 3.0 * t) / 23.0) \
                * np.cos((yy - 2.0 * t) / 17.0)
            y = y + rng.normal(0, 0.01, (h, w))
            frames.append(np.clip(y * maxv, 0, maxv))
        return np.stack(frames).reshape(shape).astype(dtype)

    return fill


def mem_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory n/a"
    mib = 1 << 20
    return (f"args {ma.argument_size_in_bytes / mib:.1f} MiB, "
            f"out {ma.output_size_in_bytes / mib:.1f} MiB, "
            f"temp {ma.temp_size_in_bytes / mib:.1f} MiB, "
            f"code {ma.generated_code_size_in_bytes / mib:.2f} MiB")


def compare_outputs(name: str, out, ref) -> str:
    """Match `out` against `ref` leaf by leaf (see FLOAT_RTOL and
    MISMATCH_FRAC). Returns a one-line verdict; raises on failure."""
    import jax

    a_leaves = jax.tree_util.tree_leaves(out)
    b_leaves = jax.tree_util.tree_leaves(ref)
    if len(a_leaves) != len(b_leaves):
        raise SmokeError(f"{name}: {len(a_leaves)} outputs vs "
                         f"{len(b_leaves)} in the reference")
    n_diff = n_bad = n_all = 0
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise SmokeError(f"{name}: {a.shape} {a.dtype} vs reference "
                             f"{b.shape} {b.dtype}")
        n_all += b.size
        differ = a != b
        n_diff += int(differ.sum())
        if not differ.any():
            continue
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        rel = np.abs(a64 - b64) / np.maximum(1.0, np.abs(b64))
        worst = max(worst, float(rel.max()))
        if np.issubdtype(b.dtype, np.integer):
            n_bad += int(differ.sum())
        else:
            n_bad += int((rel > FLOAT_RTOL).sum())
    if n_diff == 0:
        return "bit-identical"
    verdict = (f"{n_diff} of {n_all} entries differ, {n_bad} beyond "
               f"{FLOAT_RTOL:g} relative (max {worst:.3g}); bound "
               f"{MISMATCH_FRAC:g} of entries")
    if n_bad > MISMATCH_FRAC * n_all:
        raise SmokeError(f"{name}: {verdict}")
    return verdict


def time_call(fn, args, reps: int = TIMING_REPS) -> float:
    """Median wall milliseconds of fn(*args) through block_until_ready."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def compile_and_run(label: str, fn, dyn, static: dict):
    """Compile jitted `fn` for the devices of `dyn`, run and time it.
    Returns (output, report line with compile s, ms and memory)."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(*dyn, **static).compile()
    t_comp = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*dyn))
    ms = time_call(compiled, dyn)
    return out, (f"program {label}: compile {t_comp:.2f} s, run {ms:.3f} "
                 f"ms (median of {TIMING_REPS}), {mem_line(compiled)}")


def run_program(name: str, fn, args, kw, ref_device=None):
    """Compile `fn` for the default device at these args, print its
    memory and time, and (with ref_device) compare its output with the
    same function run on ref_device. Returns (output, verdict)."""
    import jax

    out, line = compile_and_run(name, fn, jax.device_put(args), kw)
    verdict = None
    if ref_device is not None:
        with jax.default_device(ref_device):
            ref = jax.block_until_ready(fn(*args, **kw))
        verdict = compare_outputs(name, out, ref)
        line += f"; vs {ref_device.platform} jit: {verdict}"
    say(line)
    return out, verdict


class Capture:
    """Replace module.attr (a jitted function with static arguments
    `static`) for the duration of a `with`: each call is compiled for its
    args (memory printed), timed and run; (dynamic args, static kwargs,
    output) of each call are kept in `self.calls`."""

    def __init__(self, module, attr: str, label: str, static: tuple):
        self.module, self.attr, self.label = module, attr, label
        self.static = static
        self.calls: list = []

    def __enter__(self):
        import inspect

        self.orig = orig = getattr(self.module, self.attr)
        sig = inspect.signature(orig)

        def wrapper(*args, **kw):
            bound = sig.bind(*args, **kw).arguments
            dyn = [v for k, v in bound.items() if k not in self.static]
            stat = {k: v for k, v in bound.items() if k in self.static}
            out, line = compile_and_run(self.label, orig, dyn, stat)
            say(line)
            self.calls.append((dyn, stat, out))
            return out

        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def check_me(src: np.ndarray, refs: np.ndarray, bit_depth: int) -> None:
    """Device full-pel ME at real width against numpy: the reported SAD
    is the exact SAD at the reported vector (edge-clamped reference,
    spec MC clamping) and never worse than the zero vector's."""
    import jax

    from svt_av1_psyex_tpu.device.me import GEOMETRIES, me_fullpel, unpack_me

    name = "me_fullpel"
    out, _ = run_program(name, me_fullpel, (src.astype(np.int32),
                                            refs.astype(np.int32)),
                         dict(bit_depth=bit_depth))
    rows = np.asarray(jax.device_get(out))
    h, w = src.shape
    s64 = src.astype(np.int64)
    for ri in range(refs.shape[0]):
        ref = refs[ri].astype(np.int64)
        maps = unpack_me(rows[ri], h, w)
        for gh, gw in GEOMETRIES:
            m = maps[(gh, gw)]
            gy, gx = h // gh, w // gw
            y0 = (np.arange(gy) * gh)[:, None, None]
            x0 = (np.arange(gx) * gw)[None, :, None]
            ry = np.clip(y0 + m["mv"][..., 0:1] + np.arange(gh), 0, h - 1)
            rx = np.clip(x0 + m["mv"][..., 1:2] + np.arange(gw), 0, w - 1)
            patch = ref[ry[..., :, None], rx[..., None, :]]
            cur = s64.reshape(gy, gh, gx, gw).transpose(0, 2, 1, 3)
            sad = np.abs(cur - patch).sum(axis=(2, 3))
            zero = np.abs(cur - ref.reshape(gy, gh, gx, gw)
                          .transpose(0, 2, 1, 3)).sum(axis=(2, 3))
            if not np.array_equal(sad, m["sad"]):
                raise SmokeError(f"{name}: ref {ri} {gh}x{gw}: "
                                 f"{int((sad != m['sad']).sum())} SADs "
                                 "differ from numpy")
            if np.any(sad > zero):
                raise SmokeError(f"{name}: ref {ri} {gh}x{gw}: SAD worse "
                                 "than the zero vector")
    say(f"program {name}: vs numpy SAD at every reported vector: exact")


def cdef_inputs(w: int, h: int, bit_depth: int, fill):
    """(recon, src, skip_g, mi_rows, mi_cols) at an encode's plane
    shapes: luma aligned to 8, chroma with its +4 overhang."""
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    ah, aw = mi_rows * 4, mi_cols * 4
    shapes = [(ah, aw), (ah // 2 + 4, aw // 2 + 4), (ah // 2 + 4, aw // 2 + 4)]
    rng = np.random.default_rng(3)
    maxv = (1 << bit_depth) - 1
    src = [fill(s, np.int32) for s in shapes]
    recon = [np.clip(p + rng.integers(-3, 4, p.shape), 0, maxv)
             .astype(np.int32) for p in src]
    skip_g = np.zeros((mi_rows, mi_cols), np.uint8)
    return recon, src, skip_g, mi_rows, mi_cols


def check_cdef(w: int, h: int, bit_depth: int, fill, level: int,
               compare: bool = True) -> None:
    """Device CDEF search + apply on a frame, against ops/cdef.py."""
    from svt_av1_psyex_tpu.device import cdef as dcdef
    from svt_av1_psyex_tpu.ops.cdef import cdef_search_frame

    recon, src, skip_g, mi_rows, mi_cols = cdef_inputs(w, h, bit_depth,
                                                       fill)
    q = 120

    def rd(rate, dist):
        return rate * 300 / 512.0 + dist * 128.0

    dev_recon = [p.copy() for p in recon]
    tag = f"{w}x{h}"
    with Capture(dcdef, "cdef_search_kernel_batch", f"cdef_search {tag}",
                 dcdef._STATICS_S), \
            Capture(dcdef, "cdef_apply_kernel_batch", f"cdef_apply {tag}",
                    dcdef._STATICS_A):
        got = dcdef.cdef_search_frame_device(
            dev_recon, src, skip_g, mi_rows, mi_cols, q, rd, level=level,
            bit_depth=bit_depth)
    if not compare:
        return
    host_recon = [p.copy() for p in recon]
    want = cdef_search_frame(host_recon, src, skip_g, mi_rows, mi_cols, q,
                             rd, level=level, bit_depth=bit_depth)
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise SmokeError(f"cdef: result field {i} differs from numpy")
    for i, (a, b) in enumerate(zip(dev_recon, host_recon)):
        if not np.array_equal(a, b):
            raise SmokeError(f"cdef: filtered plane {i} differs from numpy "
                             f"({int((a != b).sum())} px)")
    say(f"program cdef {tag}: strengths and filtered planes vs numpy "
        "(ops/cdef.py): exact")


def check_lr(w: int, h: int, bit_depth: int, fill,
             compare: bool = True) -> None:
    """Device Wiener search and SGR statistics for one luma plane
    (preset 6, 256-px units), against the numpy filters of
    ops/restoration.py."""
    from svt_av1_psyex_tpu.codec.restoration import search_plane
    from svt_av1_psyex_tpu.device import restoration as drest
    from svt_av1_psyex_tpu.ops.restoration import (SGR_PARAMS, sgr_flt,
                                                   wiener_convolve)

    rng = np.random.default_rng(4)
    maxv = (1 << bit_depth) - 1
    src = fill((h, w), np.int32)
    cdef = np.clip(src + rng.integers(-4, 5, src.shape), 0, maxv)
    cdef = cdef.astype(np.int32)
    costs = {"switchable": np.zeros(3, np.int64),
             "wiener": np.zeros(2, np.int64),
             "sgrproj": np.zeros(2, np.int64)}
    tag = f"{w}x{h}"
    with Capture(drest, "wiener_descent", f"lr_wiener_descent {tag}",
                 ("bit_depth", "n_rounds", "chroma")) as cw, \
            Capture(drest, "sgr_corr", f"lr_sgr_corr {tag}",
                    ("eps", "bit_depth")) as cs:
        search_plane(src, cdef, cdef.copy(), w, h, 0, 256, bit_depth, 300,
                     chroma=False, preset=6, type_costs=costs)
    if not compare:
        return
    (pads, srcs, masks, _), _, (taps, best) = cw.calls[0]
    pads, srcs, masks = (np.asarray(a) for a in (pads, srcs, masks))
    taps, best = np.asarray(taps), np.asarray(best)
    sh = masks.sum(axis=1).max(axis=1)
    sw = masks.sum(axis=2).max(axis=1)
    for r in range(len(best)):
        rh, rw = int(sh[r]), int(sw[r])
        pad = pads[r, :rh + 6, :rw + 6].astype(np.int64)
        s = srcs[r, :rh, :rw].astype(np.int64)
        out = wiener_convolve(pad, tuple(taps[r, 0]), tuple(taps[r, 1]),
                              bit_depth)
        sse = float(((s - out) ** 2).sum())
        if abs(best[r] - sse) > LR_WIENER_RTOL * max(1.0, sse):
            raise SmokeError(f"lr wiener: RU {r} SSE {best[r]} vs numpy "
                             f"{sse}")
    _, stat, corr = cs.calls[0]
    eps, corr = stat["eps"], np.asarray(corr)
    for r in range(corr.shape[0]):
        rh, rw = int(sh[r]), int(sw[r])
        pad = pads[r, :rh + 6, :rw + 6].astype(np.int32)
        u = pad[3:3 + rh, 3:3 + rw].astype(np.float64) * 16
        s = srcs[r, :rh, :rw].astype(np.float64) * 16 - u
        for e, ep in enumerate(eps):
            r0, r1 = SGR_PARAMS[ep][0], SGR_PARAMS[ep][1]
            flt0, flt1 = sgr_flt(pad, ep, bit_depth)
            f0 = flt0 - u if r0 else np.zeros_like(u)
            f1 = flt1 - u if r1 else np.zeros_like(u)
            want = np.array([(f0 * f0).sum(), (f1 * f1).sum(),
                             (f0 * f1).sum(), (f0 * s).sum(),
                             (f1 * s).sum(), (s * s).sum()])
            scale = max(1.0, float(np.abs(want).max()))
            if np.abs(corr[r, e] - want).max() > LR_SGR_RTOL * scale:
                raise SmokeError(f"lr sgr: RU {r} ep {ep} correlations "
                                 "differ from numpy")
    say(f"program lr {tag}: vs numpy (ops/restoration.py): Wiener SSE "
        f"within {LR_WIENER_RTOL:g}, SGR correlations within "
        f"{LR_SGR_RTOL:g} of each (RU, ep) row's largest term")


def device_programs(cfg: dict, fill):
    """The API encoder's device program list for `cfg` (after init)."""
    from svt_av1_psyex_tpu.api import SvtAv1Encoder

    enc = SvtAv1Encoder()
    enc.set_parameter(api_config(cfg))
    os.environ["SVT_TPU_NO_WARM"] = "1"  # compiled below, one at a time
    try:
        enc.init()
    finally:
        del os.environ["SVT_TPU_NO_WARM"]
    return enc.device_programs(fill)


def phase_programs(cpu) -> None:
    """Config-2 programs on the card vs references, then config-3
    compile and memory."""
    import jax

    c = CONFIG2
    fill = make_fill(c["bit_depth"])
    say(f"phase 3: device programs at config-2 shapes "
        f"({c['w']}x{c['h']} {c['bit_depth']}-bit, preset {c['preset']})")
    for name, fn, args, kw in device_programs(c, fill):
        run_program(name, fn, args, kw, ref_device=cpu)
    hp = (c["h"] + 63) // 64 * 64
    wp = (c["w"] + 63) // 64 * 64
    frames = fill((3, hp, wp), np.uint8)
    check_me(frames[0], frames[1:], c["bit_depth"])
    # level 4: the full-grid candidate search both backends implement
    # (at levels 5 and 7 the host searches a block subsample)
    check_cdef(c["w"], c["h"], c["bit_depth"], fill, level=4)
    check_lr(c["w"], c["h"], c["bit_depth"], fill)

    c3 = CONFIG3
    say(f"phase 3: compile and memory at config-3 shapes "
        f"({c3['w']}x{c3['h']} {c3['bit_depth']}-bit, preset "
        f"{c3['preset']})")
    for name, fn, args, kw in device_programs(c3, jax.ShapeDtypeStruct):
        t0 = time.perf_counter()
        compiled = fn.lower(*args, **kw).compile()
        say(f"program {name} {c3['w']}x{c3['h']}: compile "
            f"{time.perf_counter() - t0:.2f} s, {mem_line(compiled)}")
    fill3 = make_fill(c3["bit_depth"])
    check_cdef(c3["w"], c3["h"], c3["bit_depth"], fill3, level=5,
               compare=False)
    check_lr(c3["w"], c3["h"], c3["bit_depth"], fill3, compare=False)


# ---- phases 4-5: encodes ----------------------------------------------------


def api_config(c: dict):
    from svt_av1_psyex_tpu.api import EncoderConfig

    return EncoderConfig(source_width=c["w"], source_height=c["h"],
                         encoder_bit_depth=c["bit_depth"],
                         enc_mode=c["preset"], crf=c["crf"],
                         intra_period_length=0 if c["intra"] else -2,
                         recon_enabled=True)


def clip(c: dict) -> list:
    sys.path.insert(0, str(ROOT / "tools"))
    from mkclip import synth_frame

    from svt_av1_psyex_tpu.utils.y4m import VideoFormat

    fmt = VideoFormat(c["w"], c["h"], fps=Fraction(30, 1),
                      bit_depth=c["bit_depth"])
    return [synth_frame(fmt, t, "blobs") for t in range(c["frames"])]


def encode(c: dict, frames: list) -> dict:
    """One encode through the API: TU list, display-order recons cropped
    to the picture, wall seconds and the encoder's stage seconds."""
    from svt_av1_psyex_tpu.api import SvtAv1Encoder

    t0 = time.perf_counter()
    enc = SvtAv1Encoder()
    enc.set_parameter(api_config(c))
    enc.init()
    for t, f in enumerate(frames):
        enc.send_picture(f, t)
    enc.send_picture(None)
    tus, recons = [], {}
    while (pk := enc.get_packet()) is not None:
        if not pk.is_eos:
            tus.append(pk.data)
    while (rc := enc.get_recon()) is not None:
        recons[rc.pts] = [np.array(p[:(c["h"] + s) >> s, :(c["w"] + s) >> s])
                          for p, s in zip(rc.planes, (0, 1, 1))]
    return {"tus": tus, "recons": [recons[t] for t in sorted(recons)],
            "wall": time.perf_counter() - t0,
            "timing": dict(getattr(enc._enc, "timing", None) or {})}


def save_stream(name: str, c: dict, run: dict, out_dir: Path) -> Path:
    from svt_av1_psyex_tpu.utils.ivf import IvfWriter

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.ivf"
    with open(path, "wb") as fh:
        wr = IvfWriter(fh, c["w"], c["h"])
        for i, tu in enumerate(run["tus"]):
            wr.write_frame(tu, i)
        wr.close()
    hashes = [[hashlib.md5(np.ascontiguousarray(p).tobytes()).hexdigest()
               for p in planes] for planes in run["recons"]]
    (out_dir / f"{name}_recon_md5.json").write_text(json.dumps(hashes))
    return path


def gate(name: str, c: dict, frames: list, run: dict, mode: str, cpu,
         out_dir: Path) -> None:
    """dav1d decode == recon on every plane of every displayed frame, or
    (no libdav1d) stream and recon equal to a CPU-backend encode."""
    import jax

    path = save_stream(name, c, run, out_dir)
    if mode == "dav1d":
        from svt_av1_psyex_tpu.conformance.dav1d import decode_ivf

        dec = decode_ivf(path)
        if len(dec) != len(run["recons"]):
            raise SmokeError(f"{name}: dav1d decoded {len(dec)} frames, "
                             f"recon has {len(run['recons'])}")
        for t, (d, r) in enumerate(zip(dec, run["recons"])):
            for p, (dp, rp) in enumerate(zip(d, r)):
                if not np.array_equal(dp, rp):
                    raise SmokeError(f"{name}: frame {t} plane {p}: dav1d "
                                     f"!= recon ({int((dp != rp).sum())} px)")
        say(f"{name}: dav1d decode == recon on all {len(dec)} displayed "
            "frames, every plane")
        return
    os.environ["SVT_TPU_NO_WARM"] = "1"  # no GPU warm-up thread here
    try:
        with jax.default_device(cpu):
            ref = encode(c, frames)
    finally:
        del os.environ["SVT_TPU_NO_WARM"]
    if ref["tus"] != run["tus"]:
        raise SmokeError(f"{name}: stream differs from the CPU-backend "
                         "encode")
    for t, (a, b) in enumerate(zip(run["recons"], ref["recons"])):
        for p, (ap, bp) in enumerate(zip(a, b)):
            if not np.array_equal(ap, bp):
                raise SmokeError(f"{name}: frame {t} plane {p} recon "
                                 "differs from the CPU-backend encode")
    say(f"{name}: stream ({len(b''.join(run['tus']))} bytes, "
        f"{len(run['tus'])} TUs) and all {len(run['recons'])} recons "
        f"equal the CPU-backend encode ({ref['wall']:.1f} s on the CPU)")


def phase_encodes(mode: str, cpu, card: str, counter: CompileCounter,
                  out_dir: Path) -> None:
    os.environ["SVT_TPU_TIMING"] = "1"
    c = CONFIG1
    say(f"phase 4: config 1 ({c['w']}x{c['h']} {c['bit_depth']}-bit, "
        f"preset {c['preset']}, CRF {c['crf']}, intra, {c['frames']} "
        "frames)")
    frames = clip(c)
    run = encode(c, frames)
    say(f"config1: {len(b''.join(run['tus']))} bytes, "
        f"{run['wall']:.2f} s (bring-up figure, {card})")
    gate("config1", c, frames, run, mode, cpu, out_dir)

    c = CONFIG2
    say(f"phase 5: config 2 ({c['w']}x{c['h']} {c['bit_depth']}-bit, "
        f"preset {c['preset']}, CRF {c['crf']}, random access, "
        f"{c['frames']} frames)")
    frames = clip(c)
    n0, s0, _ = counter.snapshot()
    cold = encode(c, frames)
    n1, s1, _ = counter.snapshot()
    warm = encode(c, frames)
    n2, _, _ = counter.snapshot()
    stages = {k: round(v, 3) for k, v in cold["timing"].items()}
    say(f"config2 stages (cold, s): {stages}")
    missing = [k for k in ("tf", "tpl", "device_wait")
               if cold["timing"].get(k, 0.0) <= 0.0]
    if missing:
        raise SmokeError(f"config2: stages did not run: {missing} "
                         "(tf = temporal filter, tpl = TPL, device_wait = "
                         "device mode decision)")
    if warm["tus"] != cold["tus"]:
        raise SmokeError("config2: warm pass stream differs from cold")
    nbytes = len(b"".join(cold["tus"]))
    say(f"config2 bring-up figures ({card}): {nbytes} bytes; cold "
        f"{cold['wall']:.2f} s ({n1 - n0} compiles, {s1 - s0:.2f} s "
        f"compiling); warm {warm['wall']:.2f} s ({n2 - n1} compiles)")
    gate("config2", c, frames, cold, mode, cpu, out_dir)


# ---- main --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / ".tmp" / "chip_smoke",
                    help="where streams and recon hashes are written")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import jax

    say("phase 1: device")
    say(f"jax {jax.__version__}; devices {jax.devices()}")
    dev = require_gpu(jax.devices())
    say(f"platform {dev.platform}; device_kind {dev.device_kind}")
    card = card_line()
    say(f"card: {card}")
    cpu = jax.devices("cpu")[0]

    from svt_av1_psyex_tpu.device import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    counter = CompileCounter()

    say("phase 2: native")
    mode = check_native()

    phase_programs(cpu)
    n, s, hits = counter.snapshot()
    say(f"compiles so far: {n} ({s:.2f} s), persistent-cache hits {hits}")

    phase_encodes(mode, cpu, card, counter, args.out)
    n, s, hits = counter.snapshot()
    say(f"total: {n} compiles ({s:.2f} s compiling), persistent-cache "
        f"hits {hits}; wall {time.perf_counter() - t_start:.1f} s")
    say(card)  # as nvidia-smi prints it, on the line before the result
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
