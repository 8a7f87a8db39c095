"""ecfft-tpu: accelerator-native Elliptic Curve FFT framework (JAX, GPU).

Capability parity with the Rust ``ecfft`` crate (andrewmilson/ecfft),
re-designed for JAX/XLA/Pallas: O(n log² n) polynomial evaluation and
interpolation over any supported prime field — including fields with no
2-adic multiplicative subgroup, like secp256k1's base field.

Quick start::

    import ecfft_tpu as ec

    tree = ec.build_fftree("secp256k1", 1 << 10)   # like Fp::build_fftree
    coeffs = tree.encode([[...], [...]])           # batch of polynomials
    evals = tree.enter(coeffs)                     # coeffs -> evals (FFT)
    back = tree.exit(evals)                        # evals -> coeffs (IFFT)

Public surface (mirrors /root/reference/src/lib.rs:10-16 re-exports):
- :class:`FFTree` with enter / exit / extend / mextend / degree / redc_z0 /
  redc_z1 / modular_reduce / vanish, all batch-first
- :func:`build_fftree` per-field constructor (None when n exceeds the
  curve's two-adicity)
- ``S0`` / ``S1`` moiety constants (the reference's ``Moiety`` enum)
- :mod:`ecfft_tpu.serialize` — ark-serialize-compatible bytes
- :mod:`ecfft_tpu.find_curve` / :mod:`ecfft_tpu.schoof` — offline curve
  tooling (ECFFT-II FIND_CURVE, Schoof point counting)
"""

from ecfft_tpu.errors import (
    CurveError,
    EcfftError,
    SizeError,
    TreeConstructionError,
    UnknownFieldError,
)
from ecfft_tpu.fftree import FFTree, S0, S1, build_fftree
from ecfft_tpu.fields.registry import FIELDS

__all__ = [
    "FFTree", "S0", "S1", "build_fftree", "FIELDS",
    "EcfftError", "UnknownFieldError", "SizeError", "CurveError",
    "TreeConstructionError",
]
