"""Spec-exact integer reference kernels (numpy, batched).

These are the conformance-critical implementations and the test oracles.
The device analysis-tier counterparts live in svt_av1_psyex_tpu/device/
(jnp/XLA lattices; matmul-form DCTs in device/matdct.py).
"""
