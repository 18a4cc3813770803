"""Complex contraction helper.

``ceinsum`` runs a two-operand complex contraction as real einsums over the
real and imaginary parts, each at ``precision=HIGHEST``: on a GPU an f32
contraction may otherwise run in TF32, which keeps about three decimal
digits and breaks the per-bin beamformer and WPE algebra.

Elementwise/outer-product einsums (no contracted index) go through the same
path; a real einsum with no contracted index is exact at any precision.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["ceinsum"]

_HIGHEST = lax.Precision.HIGHEST


def _is_complex(x) -> bool:
    return jnp.iscomplexobj(x)


def _einsum(subscripts: str, a, b):
    return jnp.einsum(subscripts, a, b, precision=_HIGHEST)


def ceinsum(subscripts: str, a, b):
    """Two-operand einsum at full f32 precision, complex operands split
    into their real and imaginary parts."""
    if not (_is_complex(a) or _is_complex(b)):
        return _einsum(subscripts, a, b)

    ar, ai = jnp.real(a), jnp.imag(a)
    br, bi = jnp.real(b), jnp.imag(b)
    if _is_complex(a) and _is_complex(b):
        rr = _einsum(subscripts, ar, br)
        ii = _einsum(subscripts, ai, bi)
        ri = _einsum(subscripts, ar, bi)
        ir = _einsum(subscripts, ai, br)
        return lax.complex(rr - ii, ri + ir)
    if _is_complex(a):
        return lax.complex(_einsum(subscripts, ar, b), _einsum(subscripts, ai, b))
    return lax.complex(_einsum(subscripts, a, br), _einsum(subscripts, a, bi))
