"""First-order linear recurrences as associative scans.

Many of the reference's per-frame recursions are linear exponential
averages (CSD smoothing postfilter.cc:8-21, noise PSD tracking
localization.h:72-115, signal-power averaging):

    y_t = a_t * y_{t-1} + b_t

A sequential `lax.scan` serializes T steps; `jax.lax.associative_scan`
computes the same outputs in O(log T) depth instead of T tiny
launch-bound steps.  Used by the postfilters; numerics agree
with the sequential form to float tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["linear_recurrence", "ema"]


def linear_recurrence(a: jax.Array, b: jax.Array, axis: int = 0) -> jax.Array:
    """All prefix solutions of ``y_t = a_t y_{t-1} + b_t`` (y_{-1} = 0).

    ``a`` broadcasts against ``b`` along ``axis``.
    """
    a = jnp.broadcast_to(a, b.shape)

    def combine(left, right):
        al, bl = left
        ar, br = right
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a, b), axis=axis)
    return y


def ema(x: jax.Array, alpha: float, axis: int = 0, first_direct: bool = True) -> jax.Array:
    """Exponential moving average ``y_t = alpha y_{t-1} + (1-alpha) x_t``.

    With ``first_direct`` the first element initializes the state directly
    (y_0 = x_0), matching the reference's frame-0 alpha=0 convention.
    """
    if alpha <= 0.0:
        return x
    a = jnp.full(x.shape, alpha, x.dtype if not jnp.iscomplexobj(x) else jnp.float32)
    a = a.astype(x.dtype)
    b = (1.0 - alpha) * x
    if first_direct:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, 1)
        b = jnp.concatenate([x[tuple(idx)], jnp.take(b, jnp.arange(1, x.shape[axis]), axis=axis)], axis=axis)
        a0 = jnp.zeros_like(jnp.take(a, jnp.arange(1), axis=axis))
        a = jnp.concatenate([a0, jnp.take(a, jnp.arange(1, x.shape[axis]), axis=axis)], axis=axis)
    return linear_recurrence(a, b, axis=axis)
