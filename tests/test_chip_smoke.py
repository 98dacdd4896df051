"""chip_smoke.py's checks, the compile-cache placement and the native build
key, on the CPU (plus one test that needs the card)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from svt_av1_psyex_tpu.device import DEFAULT_CACHE_DIR  # noqa: E402
from svt_av1_psyex_tpu.native import build  # noqa: E402


def _python(code: str, **env) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=300)


# ---- device check -------------------------------------------------------------


def test_require_gpu_refuses_cpu_backend():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.require_gpu([])


def test_script_fails_without_gpu_and_prints_no_result():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_native_failure_is_an_error(monkeypatch):
    from svt_av1_psyex_tpu.native import ecenc

    monkeypatch.setattr(ecenc, "_lib", None)
    monkeypatch.setattr(ecenc, "_lib_error", OSError("no compiler"))
    with pytest.raises(chip_smoke.SmokeError, match="no compiler"):
        chip_smoke.check_native()


# ---- stream gates -------------------------------------------------------------

_TINY = dict(w=64, h=64, bit_depth=8, preset=12, crf=35, frames=2,
             intra=True)


@pytest.mark.parametrize("mode", ["dav1d", "cpu-equality"])
def test_stream_gate_passes_and_catches_a_mismatch(mode, tmp_path):
    cpu = jax.devices("cpu")[0]
    frames = chip_smoke.clip(_TINY)
    run = chip_smoke.encode(_TINY, frames)
    chip_smoke.gate("tiny", _TINY, frames, run, mode, cpu, tmp_path)
    if mode == "dav1d":
        run["recons"][1][2][0, 0] ^= 1
    else:
        run["tus"][1] = run["tus"][1][:-1] + bytes([run["tus"][1][-1] ^ 1])
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.gate("tiny", _TINY, frames, run, mode, cpu, tmp_path)


# ---- program comparison ---------------------------------------------------


def test_compare_outputs_bounds():
    ref = (np.arange(10000, dtype=np.float32), np.arange(50, dtype=np.int32))
    assert chip_smoke.compare_outputs("x", ref, ref) == "bit-identical"
    # float entries within FLOAT_RTOL match, though not bit-identical
    near = (ref[0] * np.float32(1 + 1e-7), ref[1])
    assert "0 beyond" in chip_smoke.compare_outputs("x", near, ref)
    # a few whole-unit differences stay within MISMATCH_FRAC
    few = (ref[0].copy(), ref[1])
    few[0][:5] += 1
    assert "5 beyond" in chip_smoke.compare_outputs("x", few, ref)
    many = (ref[0] + 1, ref[1])
    with pytest.raises(chip_smoke.SmokeError, match="beyond"):
        chip_smoke.compare_outputs("x", many, ref)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.compare_outputs("x", (ref[0], ref[1][::-1].copy()), ref)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.compare_outputs("x", (ref[0],), ref)


def _tiny_programs():
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu.bitstream.headers import SequenceConfig

    enc = Av1Encoder(SequenceConfig(width=128, height=64), preset=8)
    return enc.device_programs(tpl_frames=2, tf_buckets=(4,),
                               fill=chip_smoke.make_fill(8))


def test_device_programs_cover_the_encode():
    names = [p[0] for p in _tiny_programs()]
    assert names == ["intra_analysis_batch", "tpl_group_stats",
                     "inter_analysis", "tf_filter_4"]


def test_run_program_compares_with_reference(capsys):
    cpu = jax.devices("cpu")[0]
    name, fn, args, kw = _tiny_programs()[0]
    _, verdict = chip_smoke.run_program(name, fn, args, kw, ref_device=cpu)
    assert verdict == "bit-identical"
    out = capsys.readouterr().out
    assert "program intra_analysis_batch: compile" in out
    assert "temp" in out and "vs cpu jit: bit-identical" in out


def test_me_check_against_numpy():
    fill = chip_smoke.make_fill(8)
    frames = fill((3, 128, 128), np.uint8)
    chip_smoke.check_me(frames[0], frames[1:], 8)  # raises on mismatch


@pytest.mark.gpu
def test_run_program_on_gpu_matches_cpu(gpu_device):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(gpu_device):
        for name, fn, args, kw in _tiny_programs():
            chip_smoke.run_program(name, fn, args, kw, ref_device=cpu)


# ---- compile cache -----------------------------------------------------------

_CACHE_PROBE = """
import json, os, jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from svt_av1_psyex_tpu.device import enable_compile_cache
d = enable_compile_cache()
before = set(os.listdir(d)) if os.path.isdir(d) else set()
jax.jit(lambda x: jnp.sin(x) * {k})(jnp.ones(7)).block_until_ready()
after = set(os.listdir(d))
print(json.dumps({{"dir": d, "new": sorted(after - before)}}))
"""


def test_compile_cache_honours_env_dir(tmp_path):
    r = _python(_CACHE_PROBE.format(k=3.25),
                JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["dir"] == str(tmp_path)
    assert got["new"], "no cache entry written to JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_defaults_to_checkout_dir():
    r = _python(_CACHE_PROBE.format(k=4.75))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["dir"] == str(DEFAULT_CACHE_DIR)
    assert DEFAULT_CACHE_DIR.parent == ROOT
    assert got["new"] or any(DEFAULT_CACHE_DIR.iterdir())


# ---- native build -------------------------------------------------------------


def test_native_build_key_tracks_sources_and_flags(tmp_path):
    src = tmp_path / "k.c"
    src.write_text("int k(void) { return 1; }\n")
    a = build.library_path("k", [src], ("-O2",))
    assert a == build.library_path("k", [src], ("-O2",))
    assert a.parent == build.BUILD_DIR
    assert a != build.library_path("k", [src], ("-O3",))
    src.write_text("int k(void) { return 2; }\n")
    assert a != build.library_path("k", [src], ("-O2",))


def test_native_library_builds_and_loads(tmp_path):
    import ctypes

    src = tmp_path / "seven.c"
    src.write_text("int seven(void) { return 7; }\n")
    path = build.build_library("seven", [src], ("-O2",))
    assert path.exists() and path.parent == build.BUILD_DIR
    assert ctypes.CDLL(str(path)).seven() == 7
    assert build.build_library("seven", [src], ("-O2",)) == path
    path.unlink()
