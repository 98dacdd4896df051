#!/usr/bin/env python3
"""Config-1 throughput: 352x288 8-bit intra-only encode on one GPU.

Prints the device it ran on, then ONE JSON line:
{"metric", "value", "unit", "device"}.

Config mirrors driver config 1 (352x288, intra-only, CRF-35-equivalent
qindex 140, preset 12) on a synthetic clip (tools/mkclip.py). The stream
is decoded with dav1d and must match the encoder's recon bit-exactly,
else the run fails; so does a run without a GPU or without dav1d.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

import numpy as np

W, H, FRAMES, QINDEX = 352, 288, 32, 140


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: JAX found no GPU (first device: {dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"platform {dev.platform}; device_kind {dev.device_kind}; "
          f"card {card}", flush=True)

    from mkclip import synth_frame

    from svt_av1_psyex_tpu.bitstream.headers import SequenceConfig
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu.conformance.dav1d import decode_ivf
    from svt_av1_psyex_tpu.utils.ivf import IvfWriter
    from svt_av1_psyex_tpu.utils.y4m import VideoFormat

    fmt = VideoFormat(W, H, fps=Fraction(30, 1))
    frames = [synth_frame(fmt, t, "blobs") for t in range(FRAMES)]

    seq = SequenceConfig(width=W, height=H)
    enc = Av1Encoder(seq, preset=12)
    # warmup (first-use table loads + XLA compile of the group kernels)
    enc.encode_keyframes(frames, QINDEX)

    # best of 3 trials: steady-state throughput is what the metric means
    fps = 0.0
    for _ in range(3):
        enc = Av1Encoder(seq, preset=12)
        t0 = time.perf_counter()
        tus = enc.encode_keyframes(frames, QINDEX)
        dt = time.perf_counter() - t0
        fps = max(fps, FRAMES / dt)

    # conformance gate: dav1d's decode of the last frame must equal the
    # recon bit-exactly; a missing dav1d fails the run
    path = Path(".tmp/bench.ivf")
    path.parent.mkdir(exist_ok=True)
    with open(path, "wb") as fh:
        wr = IvfWriter(fh, W, H)
        for t, tu in enumerate(tus):
            wr.write_frame(tu, t)
        wr.close()
    last = decode_ivf(path)[-1][0]
    if not np.array_equal(
            last, enc.last_recon[0][: last.shape[0], : last.shape[1]]):
        sys.exit("bench: CONFORMANCE FAILURE (dav1d decode != recon)")

    print(json.dumps({
        "metric": "352x288 intra-only encode throughput (config 1), "
                  "dav1d-conformant",
        "value": round(fps, 3),
        "unit": "fps",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
