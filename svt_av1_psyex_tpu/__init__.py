"""svt_av1_psyex_tpu — an AV1 encoder framework in JAX.

A from-scratch rebuild of the capability surface of SVT-AV1-PSYEX
(reference: C99 + x86/ARM SIMD) redesigned for an accelerator:

* device compute path (transforms, quant, prediction, ME/SAD pyramids,
  in-loop filter searches, psy metrics) in JAX, compiled by XLA and
  batched over all superblocks of a frame instead of the reference's
  wavefront threads;
* host runtime (entropy coding, OBU assembly, rate control, GOP logic,
  pipeline) in Python + C;
* public API shaped after EbSvtAv1Enc.h (svt_av1_enc_init_handle /
  set_parameter / init / send_picture / get_packet / ...), CLI shaped
  after SvtAv1EncApp.

Layout:
  bitstream/   OBU framing, AV1 range coder, CDF models, syntax writers
  ops/         spec-exact numpy references + jnp device kernels
  device/      whole-frame device analysis programs (jitted)
  codec/       encoder algorithms: partitioning, mode decision, recon loop
  api/         EbSvtAv1Enc-shaped public API + configuration
  app/         SvtAv1EncApp-shaped CLI (y4m/yuv in, IVF out)
  utils/       y4m/IVF I/O, logging, timing
  conformance/ dav1d and libaom harnesses (test oracles)
  native/      C sources (dav1d shim, host entropy fast path)
"""

__version__ = "0.1.0"

# Version string surfaced through the svt_av1_get_version-equivalent API.
SVT_VERSION = "3.0.2-B-tpu"
