"""Perfect-reconstruction cosine-modulated filterbank tests."""

import os

import numpy as np
import pytest

from distant_speech_recognition_tpu.design.cosine_modulated import (
    design_pr_prototype,
    full_prototype,
    pclat,
)
from distant_speech_recognition_tpu.ops.pr_filterbank import (
    PRFilterbankParams,
    pr_analysis,
    pr_synthesis,
)


def test_pclat_power_complementary():
    import jax.numpy as jnp

    h0, h1 = pclat(jnp.asarray([0.7, -0.3, 0.2, 1.1]))
    # lattice outputs are jointly unit-norm by construction
    np.testing.assert_allclose(float(jnp.sum(h0**2) + jnp.sum(h1**2)), 1.0, atol=1e-6)


@pytest.mark.parametrize("M,m", [(4, 8), (8, 4)])
def test_pr_reconstruction_is_near_perfect(M, m):
    """The PR property: analysis->synthesis reconstructs exactly (the
    reference's acceptance check, tools/filterbank/test_pr_filter_prototype.py)."""
    h, _ = design_pr_prototype(M, m)
    proto = full_prototype(h)
    p = PRFilterbankParams(M=M, m=m, r=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(3000).astype(np.float32)
    Y = pr_analysis(x, proto, p)
    y = np.asarray(pr_synthesis(Y, proto, p))
    n = min(len(x), len(y))
    seg = slice(100, n - 100)
    err = y[:n][seg] - x[:n][seg]
    snr = 10 * np.log10((x[:n][seg] ** 2).mean() / max((err**2).mean(), 1e-20))
    assert snr > 60.0, snr


def test_pr_analysis_hermitian_structure():
    """Real input spectra keep the conjugate structure across the 2M bands."""
    M, m = 4, 8
    h, _ = design_pr_prototype(M, m)
    proto = full_prototype(h)
    p = PRFilterbankParams(M=M, m=m, r=0)
    x = np.random.default_rng(1).standard_normal(500).astype(np.float32)
    Y = np.asarray(pr_analysis(x, proto, p))
    assert Y.shape[-1] == 2 * M
    assert np.isfinite(Y).all()


def test_pr_prototype_stopband_decreases_with_design():
    h, energy = design_pr_prototype(4, 8)
    # random lattice params give much higher stopband energy
    assert energy < 0.5
    assert len(h) == 32


def test_pr_analysis_matches_stream():
    """Batched PR analysis == frame-by-frame ring-buffer simulation."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from reference_stream import StreamPRAnalysis

    rng = np.random.default_rng(5)
    for (M, m, r) in [(4, 4, 0), (8, 2, 1)]:
        proto = rng.standard_normal(2 * M * m) * 0.2
        p = PRFilterbankParams(M=M, m=m, r=r)
        x = rng.standard_normal(p.D * 17 + 3)
        golden = StreamPRAnalysis(proto, M, m, r).run(x)
        ours = np.asarray(pr_analysis(x.astype(np.float32), proto, p))
        assert ours.shape == golden.shape, (ours.shape, golden.shape)
        np.testing.assert_allclose(ours, golden, atol=5e-5)


def test_pr_synthesis_matches_stream():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from reference_stream import StreamPRSynthesis

    rng = np.random.default_rng(6)
    for (M, m, r) in [(4, 4, 0), (8, 2, 1)]:
        proto = rng.standard_normal(2 * M * m) * 0.2
        p = PRFilterbankParams(M=M, m=m, r=r)
        T_in = 19
        Y = (rng.standard_normal((T_in, 2 * M)) + 1j * rng.standard_normal((T_in, 2 * M)))
        golden = StreamPRSynthesis(proto, M, m, r).run(Y)
        ours = np.asarray(pr_synthesis(Y.astype(np.complex64), proto, p))
        assert ours.shape == golden.shape
        np.testing.assert_allclose(ours, golden, atol=5e-4)
