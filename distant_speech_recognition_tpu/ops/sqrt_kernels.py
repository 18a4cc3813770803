"""Square-root (Cholesky/QR) propagation kernels.

Batched equivalents of the reference's square_root/ subsystem
(square_root/square_root.h:20-80: complex Cholesky forward/backward
substitution, rank-1 Cholesky updates, covariance/information square-root
propagation via Givens rotations).  Givens sweeps are sequential scalar
algorithms; here the same triangularizations are one batched QR/Cholesky
per bin — identical propagated factors up to unitary column phases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "forward_substitute",
    "back_substitute",
    "cholesky_rank1_update",
    "cholesky_rank1_downdate",
    "propagate_covariance_sqrt",
    "propagate_information_sqrt",
    "add_diagonal_loading",
]


def forward_substitute(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L y = b for lower-triangular (complex) L, batched."""
    return jax.scipy.linalg.solve_triangular(L, b, lower=True)


def back_substitute(L: jax.Array, y: jax.Array) -> jax.Array:
    """Solve L^H x = y, batched."""
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(jnp.conj(L), -1, -2), y, lower=False
    )


def cholesky_rank1_update(L: jax.Array, v: jax.Array, sign: float = 1.0) -> jax.Array:
    """Cholesky factor of ``L L^H + sign * v v^H`` (rank-1 update/downdate,
    square_root.h choleskyUpdate).  Batched over leading dims via a scan
    over the (small) matrix dimension — the classical hyperbolic-rotation
    recurrence."""
    n = L.shape[-1]

    def body(carry, k):
        Lc, w = carry
        lkk = jnp.real(Lc[..., k, k])
        wk = w[..., k]
        r2 = lkk**2 + sign * jnp.abs(wk) ** 2
        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        c = r / jnp.maximum(lkk, 1e-30)
        s = wk / jnp.maximum(lkk, 1e-30)
        col = Lc[..., :, k]
        col_new = (col + sign * jnp.conj(s)[..., None] * w) / c[..., None]
        w_new = c[..., None] * w - s[..., None] * col_new
        # only rows > k matter for w; row k of col_new = r
        mask = jnp.arange(n) > k
        Lc = Lc.at[..., :, k].set(jnp.where(jnp.arange(n) >= k, col_new, Lc[..., :, k]))
        w = jnp.where(mask, w_new, w)
        return (Lc, w), None

    (L_out, _), _ = jax.lax.scan(body, (L.astype(jnp.complex64), v.astype(jnp.complex64)), jnp.arange(n))
    return L_out


def cholesky_rank1_downdate(L: jax.Array, v: jax.Array) -> jax.Array:
    return cholesky_rank1_update(L, v, sign=-1.0)


def propagate_covariance_sqrt(S: jax.Array, F: jax.Array, Q_sqrt: jax.Array) -> jax.Array:
    """Covariance square-root time update: the lower-triangular factor of
    ``F S S^H F^H + Q``.  The reference triangularizes the stacked pre-array
    with Givens rotations (square_root.cc propagateCovarSquareRoot); here a
    batched QR of ``[S^H F^H; Q_sqrt^H]`` does the same in one shot."""
    FS = F @ S
    Qb = jnp.broadcast_to(Q_sqrt, FS.shape)
    pre = jnp.concatenate(
        [jnp.swapaxes(jnp.conj(FS), -1, -2), jnp.swapaxes(jnp.conj(Qb), -1, -2)],
        axis=-2,
    )
    r = jnp.linalg.qr(pre, mode="r")
    Lnew = jnp.swapaxes(jnp.conj(r), -1, -2)
    # canonicalize: make diagonal real positive
    d = jnp.diagonal(Lnew, axis1=-2, axis2=-1)
    phase = d / jnp.maximum(jnp.abs(d), 1e-30)
    return Lnew * jnp.conj(phase)[..., None, :]


def propagate_information_sqrt(Sinv: jax.Array, H: jax.Array, r_sqrt_inv: jax.Array) -> jax.Array:
    """Information square-root measurement update: factor of
    ``Sinv^H Sinv + H^H R^-1 H`` (square_root.cc propagateInfoSquareRoot,
    tracker.h lower_triangularize_) via one QR of the stacked pre-array."""
    pre = jnp.concatenate([Sinv, r_sqrt_inv[..., None, :] * H], axis=-2)
    r = jnp.linalg.qr(pre, mode="r")
    d = jnp.diagonal(r, axis1=-2, axis2=-1)
    phase = d / jnp.maximum(jnp.abs(d), 1e-30)
    return r * jnp.conj(phase)[..., :, None]


def add_diagonal_loading(L: jax.Array, load: float) -> jax.Array:
    """Square-root diagonal loading: factor of ``L L^H + load I``
    (square_root.cc add_diagonal_loading) via n rank-1 updates collapsed
    into one QR."""
    n = L.shape[-1]
    eye = jnp.sqrt(load) * jnp.eye(n, dtype=L.dtype)
    return propagate_covariance_sqrt(L, jnp.eye(n, dtype=L.dtype), eye)
