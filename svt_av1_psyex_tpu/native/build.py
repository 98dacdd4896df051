"""Build the package's C libraries from the committed sources.

Every library goes to one gitignored directory, `<checkout>/build/native`,
under a name keyed by what the binary depends on: the bytes of its
sources, the compiler flags and libraries, the compiler's version, and
the instruction set the compiler targets on this host (what
`-march=native` expands to). A library built on another machine, or from
other sources, is therefore never loaded; a matching one is reused.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CC = "gcc"


@lru_cache(maxsize=None)
def _target(flags: tuple) -> str:
    """Compiler version plus the target options `flags` expand to here."""
    ver = subprocess.run([CC, "-dumpfullversion", "-dumpmachine"],
                         capture_output=True, text=True, check=True).stdout
    drv = subprocess.run([CC, "-###", *flags, "-x", "c", "-c", os.devnull,
                          "-o", os.devnull],
                         capture_output=True, text=True, check=True).stderr
    cc1 = next((ln for ln in drv.splitlines() if "cc1" in ln), "")
    opts = sorted({t.strip("'\"") for t in cc1.split()
                   if t.strip("'\"").startswith("-m")})
    return ver + " ".join(opts)


def library_path(name: str, sources: list, flags: tuple = (),
                 libs: tuple = ()) -> Path:
    """Where the build of `sources` with `flags`/`libs` on this host
    lives (see the module docstring for the key)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).name.encode() + b"\0" + Path(src).read_bytes())
    h.update(repr((flags, libs, _target(tuple(flags)))).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: list, flags: tuple = (),
                  libs: tuple = ()) -> Path:
    """Path of the shared library, compiled first if this host has no
    build of these sources. Raises CalledProcessError (with the
    compiler's messages) when the build fails."""
    out = library_path(name, sources, flags, libs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([CC, *flags, "-shared", "-fPIC",
                        *[str(s) for s in sources], "-o", str(tmp), *libs],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    finally:
        tmp.unlink(missing_ok=True)
    return out
