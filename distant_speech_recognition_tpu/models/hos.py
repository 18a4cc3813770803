"""Higher-order-statistics beamformers: maximum kurtosis / negentropy.

Batched reformulation of the HOS family (lib/pybeamformer.py:1331-1998 —
SubbandMEKBeamformer, SubbandNMEKBeamformer, SubbandMNBeamformerCGGD):
active GSC weights are optimized per bin to maximize a higher-order
statistic of the beamformer output over an observation buffer, restoring
the non-Gaussianity that adaptive beamforming removes.

The reference runs a scipy/pygsl conjugate-gradient per bin with
hand-written gradients (fun_hos_bf/dfun_hos_bf, pybeamformer.py:1546-1593);
here the objective is evaluated for ALL bins at once over ``[T, F, C]``
observations and jax.grad + Adam ascends every bin in parallel — the same
stationary points, batch-shaped.

Conventions (calc_gsc_output_f, pybeamformer.py:1472-1487):
  woH[s, f] = wuH[s, f] - conj(wa[s, f]) . BmH[s, f]       (active path)
  Y[t, f, s] = woH[s, f] . X[t, f]                          (unconjugated dot)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.complex_ops import ceinsum

__all__ = [
    "HOSConfig",
    "gsc_outputs",
    "empirical_kurtosis",
    "negentropy_ggd",
    "estimate_mek_weights",
    "estimate_mn_weights",
    "apply_hos_weights",
]


@dataclasses.dataclass(frozen=True)
class HOSConfig:
    alpha: float = 0.01  # regularization on |wa|^2 (pybeamformer.py:1352)
    beta: float = 3.0  # kurtosis Gaussian-term weight (MEK, :1604)
    iterations: int = 100
    learning_rate: float = 0.05
    normalize: bool = False  # NMEK/NMN: renormalize wo per step (:1840-1860)
    ggd_shape: float = 0.5  # CGGD shape f for negentropy (MN, :1853)


def gsc_outputs(waH: jax.Array, X: jax.Array, wuH: jax.Array, BmH: jax.Array) -> jax.Array:
    """GSC outputs for all sources/frames/bins.

    ``waH``: [S, F, B] (conjugate active weights); ``X``: [T, F, C];
    ``wuH``: [S, F, C]; ``BmH``: [S, F, B, C].  Returns Y [T, F, S].
    """
    woH = wuH - ceinsum("sfb,sfbc->sfc", jnp.conj(waH), BmH)
    return ceinsum("sfc,tfc->tfs", woH, X)


def empirical_kurtosis(Y: jax.Array, beta: float = 3.0) -> jax.Array:
    """Per-bin empirical kurtosis summed over sources
    (SubbandMEKBeamformer.calc_obj_func, pybeamformer.py:1637-1663):
    ``E[|Y|^4] - beta (E[|Y|^2])^2``.  Y: [T, F, S] -> [F]."""
    Y2 = jnp.abs(Y) ** 2
    exY2 = jnp.mean(Y2, axis=0)  # [F, S]
    exY4 = jnp.mean(Y2 * Y2, axis=0)
    return jnp.sum(exY4 - beta * exY2**2, axis=-1)


def negentropy_ggd(Y: jax.Array, shape: float = 0.5, beta: float = 1.0) -> jax.Array:
    """Per-bin negentropy under a complex generalized-Gaussian model
    (SubbandMNBeamformerCGGD.calc_obj_func, pybeamformer.py:1931-1940):
    ``J = H_gauss - beta * H_cggd`` with ``H_gauss = log(pi e sigma^2)`` and
    the CGGD entropy from the scale fitted by moment matching
    (E|Y|^{2f} = scale).  Y: [T, F, S] -> [F]."""
    Y2 = jnp.abs(Y) ** 2
    sigma2 = jnp.mean(Y2, axis=0)  # [F, S]
    h_gauss = jnp.log(jnp.pi * jnp.e * jnp.maximum(sigma2, 1e-20))
    # CGGD with shape f: H = log( (pi/f) Gamma(1/f) scale^{1/f} ) + 1/f,
    # scale = f * E[|Y|^{2f}]  (moment-matched; pyggd entropy form)
    f = shape
    scale = f * jnp.mean(Y2**f, axis=0)
    h_ggd = (
        jnp.log(jnp.pi / f)
        + jax.scipy.special.gammaln(1.0 / f)
        + jnp.log(jnp.maximum(scale, 1e-20)) / f
        + 1.0 / f
    )
    return jnp.sum(h_gauss - beta * h_ggd, axis=-1)


def _ascend(objective, waH0, cfg: HOSConfig):
    """Adam ascent on a per-bin objective; all bins in parallel."""
    grad = jax.grad(lambda w: jnp.sum(objective(w)))

    def step(carry, _):
        w, m, v, t = carry
        g = jnp.conj(grad(w))  # Wirtinger ascent direction for real objective
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * jnp.abs(g) ** 2
        mhat = m / (1 - 0.9**t)
        vhat = v / (1 - 0.999**t)
        w = w + cfg.learning_rate * mhat / (jnp.sqrt(vhat) + 1e-8)
        return (w, m, v, t), None

    init = (waH0, jnp.zeros_like(waH0), jnp.zeros_like(jnp.abs(waH0)), 0.0)
    (w, _, _, _), _ = jax.lax.scan(step, init, None, length=cfg.iterations)
    return w


@partial(jax.jit, static_argnums=(3,))
def estimate_mek_weights(
    X: jax.Array, wuH: jax.Array, BmH: jax.Array, cfg: HOSConfig = HOSConfig()
):
    """Maximum-empirical-kurtosis active weights (SubbandMEKBeamformer).

    ``X``: buffered observations [T, F, C] (accum_observations,
    pybeamformer.py:1385-1420); ``wuH`` [S, F, C], ``BmH`` [S, F, B, C].
    Returns ``waH [S, F, B]`` maximizing kurtosis - alpha |wa|^2.
    """

    def objective(waH):
        Y = gsc_outputs(waH, X, wuH, BmH)
        reg = cfg.alpha * jnp.sum(jnp.abs(waH) ** 2, axis=(0, -1))
        return empirical_kurtosis(Y, cfg.beta) - reg

    waH0 = jnp.zeros(BmH.shape[:-1], X.dtype)  # [S, F, B]
    return _ascend(objective, waH0, cfg)


@partial(jax.jit, static_argnums=(3,))
def estimate_mn_weights(
    X: jax.Array, wuH: jax.Array, BmH: jax.Array, cfg: HOSConfig = HOSConfig()
):
    """Maximum-negentropy active weights (SubbandMNBeamformerCGGD)."""

    def objective(waH):
        Y = gsc_outputs(waH, X, wuH, BmH)
        reg = cfg.alpha * jnp.sum(jnp.abs(waH) ** 2, axis=(0, -1))
        return negentropy_ggd(Y, cfg.ggd_shape) - reg

    waH0 = jnp.zeros(BmH.shape[:-1], X.dtype)
    return _ascend(objective, waH0, cfg)


def apply_hos_weights(waH, X, wuH, BmH, src_index: int = 0) -> jax.Array:
    """Run the HOS GSC over an utterance for the chosen source
    (SubbandHOSBatchBeamformer.__iter__, pybeamformer.py:1489-1506).
    Returns [T, F]."""
    return gsc_outputs(waH, X, wuH, BmH)[..., src_index]
