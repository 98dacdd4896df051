#!/usr/bin/env python3
"""Driver-config throughput probe (configs 2/3 of BASELINE.md).

Usage: python tools/bench_config.py [--w 1280 --h 720 --preset 8
       --crf 30 --frames 48 --bit-depth 8] [--timing] [--no-dav1d]

Encodes a synthetic blobs clip through the full API encoder (RA GOPs,
TPL, device MD where eligible) and prints fps + stage timing. With
--dav1d (default) the stream is decoded and checked against recon.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from fractions import Fraction
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--preset", type=int, default=8)
    ap.add_argument("--crf", type=int, default=30)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--bit-depth", type=int, default=8)
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--no-dav1d", action="store_true")
    ap.add_argument("--keep", default="",
                    help="save the IVF (and recon mismatch report) here")
    ap.add_argument("--repeat", action="store_true",
                    help="encode twice in-process; report the 2nd pass "
                         "(steady state: XLA compiles cached)")
    args = ap.parse_args()

    if args.timing:
        os.environ["SVT_TPU_TIMING"] = "1"

    from mkclip import synth_frame

    from svt_av1_psyex_tpu.api import EncoderConfig, SvtAv1Encoder
    from svt_av1_psyex_tpu.utils.y4m import VideoFormat

    fmt = VideoFormat(args.w, args.h, fps=Fraction(30, 1),
                      bit_depth=args.bit_depth)
    frames = [synth_frame(fmt, t, "blobs") for t in range(args.frames)]

    cfg = EncoderConfig(source_width=args.w, source_height=args.h,
                        enc_mode=args.preset, crf=args.crf,
                        encoder_bit_depth=args.bit_depth,
                        recon_enabled=not args.no_dav1d)
    for _pass in range(2 if args.repeat else 1):
        h = SvtAv1Encoder()
        h.set_parameter(cfg)
        h.init()

        t0 = time.perf_counter()
        packets = []
        recons = {}
        for t, f in enumerate(frames):
            h.send_picture(f, t)
        h.send_picture(None)
        while (pk := h.get_packet()) is not None:
            if not pk.is_eos:
                packets.append(pk)
        if not args.no_dav1d:
            while (rc := h.get_recon()) is not None:
                recons[rc.pts] = rc.planes
        dt = time.perf_counter() - t0
    fps = args.frames / dt
    nbytes = sum(len(p.data) for p in packets)

    enc = h._enc
    timing = dict(getattr(enc, "timing", {}) or {})

    ok = None
    if not args.no_dav1d:
        import tempfile

        from svt_av1_psyex_tpu.conformance.dav1d import decode_ivf
        from svt_av1_psyex_tpu.utils.ivf import IvfWriter

        if decode_ivf is not None:
            with tempfile.TemporaryDirectory() as td:
                path = Path(td) / "out.ivf"
                with open(path, "wb") as fh:
                    wr = IvfWriter(fh, args.w, args.h)
                    for i, p in enumerate(packets):
                        wr.write_frame(p.data, i)
                    wr.close()
                dec = decode_ivf(path)
                ok = len(dec) == len(recons)
                if not ok:
                    print(f"# len(dec)={len(dec)} len(recons)={len(recons)}",
                          file=sys.stderr)
                for t in range(min(len(dec), len(recons))):
                    for i in range(len(dec[t])):
                        dh, dw = dec[t][i].shape
                        if not np.array_equal(dec[t][i],
                                              recons[t][i][:dh, :dw]):
                            d = (dec[t][i].astype(np.int64)
                                 - recons[t][i][:dh, :dw])
                            print(f"# mismatch frame {t} plane {i}: "
                                  f"n={(d != 0).sum()} max={np.abs(d).max()}",
                                  file=sys.stderr)
                            ok = False
                if args.keep:
                    import shutil

                    shutil.copy(path, args.keep)
    print(json.dumps({
        "config": f"{args.w}x{args.h} p{args.preset} crf{args.crf}",
        "frames": args.frames, "fps": round(fps, 4), "bytes": nbytes,
        "dav1d_exact": ok, "timing_s": {k: round(v, 2)
                                        for k, v in timing.items()},
        "wall_s": round(dt, 2)}))


if __name__ == "__main__":
    main()
