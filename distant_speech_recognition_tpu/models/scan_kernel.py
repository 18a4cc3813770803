"""Pallas kernel (Triton route) for the fused GSC-RLS + Zelinski recursion.

The recursion is the one sequential part of the adaptive chains: at every
frame each (utterance, bin) lane updates its RLS precision triangle, its
active weights and the two Zelinski CSD accumulators.  As an XLA while loop
(`adaptive_gsc.gsc_postfilter_fused`) every frame reads and writes that
state through device memory and launches several kernels.  Here one program
owns a block of lanes, runs the frame loop inside the kernel and carries the
whole state as loop values (registers); per frame only the spectrum comes in
and the filtered output goes out.

Layout (every bin a lane, Nyquist included; ``L = U * F`` lanes for ``U``
utterances of ``F = M/2 + 1`` bins, lane ``l`` belongs to utterance
``l // F``):

  X       [Tf, C, 2, L]   Re/Im planes of the channel snapshots
  energy  [Tf, U]         reference-channel frame energy per utterance
                          (a dense XLA pre-pass, so the kernel needs no
                          cross-lane reduction)
  wq, ta  [C, 2, L]       quiescent weights / postfilter alignment per lane
  bm      [Bc, C, 2, L]   blocking matrix per lane
  out     [Tf, 2, L]

Weights are per lane, so the fixed-array chain (weights tiled over the
utterances) and the steered chain (one look direction per utterance) share
the kernel.  The arithmetic follows `adaptive_gsc._rls_step_factory` and the
fused Zelinski step of `adaptive_gsc.gsc_postfilter_fused` operand for
operand.  Every speculative value (the norm-cap scale, the quadratic-
constraint root, the whole ungated update) is folded in with ``jnp.where``
selects and finite-by-construction scales: an arithmetic blend such as
``gate * new + (1 - gate) * old`` turns an inf on a lane that did not take
the branch into NaN state (near-silent bins give ``|wa|^2 ~ 1e-38`` on the
first adapted frame, where ``max_wa / |wa|^2`` overflows).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .postfilter import SPECTRAL_FLOOR

__all__ = ["gsc_rls_zelinski", "gsc_rls_zelinski_lanes", "lane_planes"]

# Lanes per program and warps per program: one lane per thread, so a block
# is a few warps and the ~1,250-frame loop runs on as many SMs as there are
# blocks.
BLOCK = 128
NUM_WARPS = 4
NUM_STAGES = 2


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cmul_conj(ar, ai, br, bi):
    """a * conj(b)"""
    return ar * br + ai * bi, ai * br - ar * bi


def _make_kernel(cfg, C: int, Bc: int, F: int, Tf: int, L: int, block: int,
                 pf_alpha: float, pf_type: int, pf_min_frames: int):
    """Kernel body for static shapes; ``cfg`` is an
    `adaptive_gsc.GSCRLSConfig` (python floats)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    pairs = [(i, j) for i in range(Bc) for j in range(i + 1, Bc)]
    pidx = {p: n for n, p in enumerate(pairs)}
    cpairs = [(i, j) for i in range(C) for j in range(i + 1, C)]
    real_mode = bool(pf_type & 0x01)
    mu, gamma, beta = float(cfg.mu), float(cfg.gamma), float(cfg.beta)
    reg = float(cfg.regularization_param)
    sil, alpha2 = float(cfg.sil_thresh), float(cfg.alpha2)
    max_wa = float(cfg.max_wa_l2norm)
    d0 = 1.0 / float(cfg.init_diagonal_load)
    e0 = float(cfg.init_diagonal_load)
    copt = int(cfg.constraint_option)
    min_frames = int(cfg.min_frames)
    a_pf = float(pf_alpha)

    def pz_matvec(d, offr, offi, vr, vi):
        """(Pz v)_i with Pz carried as its real diagonal + upper triangle:
        d_i v_i + sum_{j>i} off_ij v_j + sum_{j<i} conj(off_ji) v_j."""
        outr, outi = [], []
        for i in range(Bc):
            rr, ri = d[i] * vr[i], d[i] * vi[i]
            for j in range(i + 1, Bc):
                n = pidx[(i, j)]
                tr, ti = _cmul(offr[n], offi[n], vr[j], vi[j])
                rr, ri = rr + tr, ri + ti
            for j in range(i):
                n = pidx[(j, i)]
                tr, ti = _cmul(offr[n], -offi[n], vr[j], vi[j])
                rr, ri = rr + tr, ri + ti
            outr.append(rr)
            outi.append(ri)
        return outr, outi

    def kernel(x_ref, e_ref, wq_ref, bm_ref, ta_ref, o_ref):
        start = pl.program_id(0) * block
        lane = start + jnp.arange(block)
        mask = lane < L
        utt = lane // F
        sl = pl.ds(start, block)

        def ld(ref):
            return plgpu.load(ref, mask=mask, other=0.0)

        # loop-invariant per-lane weights
        wq = [(ld(wq_ref.at[c, 0, sl]), ld(wq_ref.at[c, 1, sl])) for c in range(C)]
        ta = [(ld(ta_ref.at[c, 0, sl]), ld(ta_ref.at[c, 1, sl])) for c in range(C)]
        bm = [[(ld(bm_ref.at[b, c, 0, sl]), ld(bm_ref.at[b, c, 1, sl]))
               for c in range(C)] for b in range(Bc)]

        def step(t, carry):
            (war, wai, d, offr, offi, en, ppr, ppi, pdg) = carry
            xr = [ld(x_ref.at[t, c, 0, sl]) for c in range(C)]
            xi = [ld(x_ref.at[t, c, 1, sl]) for c in range(C)]
            energy_t = plgpu.load(e_ref.at[t, utt], mask=mask, other=0.0)
            gate = energy_t > en / sil

            # blocking-matrix outputs Z = BmH X and the quiescent branch
            Zr, Zi = [], []
            for b in range(Bc):
                zr = zi = 0.0
                for c in range(C):
                    tr, ti = _cmul(bm[b][c][0], bm[b][c][1], xr[c], xi[c])
                    zr, zi = zr + tr, zi + ti
                Zr.append(zr)
                Zi.append(zi)
            ycr = yci = 0.0
            for c in range(C):
                tr, ti = _cmul(wq[c][0], wq[c][1], xr[c], xi[c])
                ycr, yci = ycr + tr, yci + ti

            # gain vector and precision update
            PzZr, PzZi = pz_matvec(d, offr, offi, Zr, Zi)
            ipr = ipi = 0.0
            for i in range(Bc):
                tr, ti = _cmul_conj(PzZr[i], PzZi[i], Zr[i], Zi[i])  # conj(Z) PzZ
                ipr, ipi = ipr + tr, ipi + ti
            denr, deni = mu + ipr, ipi
            s = denr * denr + deni * deni
            gzr = [(PzZr[i] * denr + PzZi[i] * deni) / s for i in range(Bc)]
            gzi = [(PzZi[i] * denr - PzZr[i] * deni) / s for i in range(Bc)]
            dK = [(d[i] - (gzr[i] * PzZr[i] + gzi[i] * PzZi[i])) / mu
                  for i in range(Bc)]
            offKr, offKi = [], []
            for n, (i, j) in enumerate(pairs):
                tr, ti = _cmul_conj(gzr[i], gzi[i], PzZr[j], PzZi[j])
                offKr.append((offr[n] - tr) / mu)
                offKi.append((offi[n] - ti) / mu)

            # active weight update
            epr, epi = ycr, yci
            for i in range(Bc):
                tr, ti = _cmul(war[i], wai[i], Zr[i], Zi[i])
                epr, epi = epr - tr, epi - ti
            nwr, nwi = [], []
            for i in range(Bc):
                tr, ti = _cmul_conj(epr, epi, gzr[i], gzi[i])  # conj(gz) ep
                nwr.append(war[i] + gamma * tr)
                nwi.append(wai[i] + gamma * ti)
            if reg > 0:
                # conj(PzK) on the old weights: conj(offK_ij) above the
                # diagonal, offK_ji below it
                for i in range(Bc):
                    rr, ri = dK[i] * war[i], dK[i] * wai[i]
                    for j in range(i + 1, Bc):
                        n = pidx[(i, j)]
                        tr, ti = _cmul(offKr[n], -offKi[n], war[j], wai[j])
                        rr, ri = rr + tr, ri + ti
                    for j in range(i):
                        n = pidx[(j, i)]
                        tr, ti = _cmul(offKr[n], offKi[n], war[j], wai[j])
                        rr, ri = rr + tr, ri + ti
                    nwr[i] = nwr[i] - rr * reg
                    nwi[i] = nwi[i] - ri * reg

            if copt > 0:
                waK2 = 0.0
                for i in range(Bc):
                    waK2 = waK2 + nwr[i] * nwr[i] + nwi[i] * nwi[i]
                if copt in (1, 3):
                    # quadratic constraint on waK = conj(waH) through PzK
                    vr, vi = pz_matvec(dK, offKr, offKi, nwr, [-w for w in nwi])
                    a = bq = 0.0
                    for i in range(Bc):
                        a = a + vr[i] * vr[i] + vi[i] * vi[i]
                        bq = bq - 2.0 * (vr[i] * nwr[i] - vi[i] * nwi[i])
                    arg = bq * bq - 4.0 * a * (waK2 - alpha2)
                    a_safe = jnp.where(a > 0, a, 1.0)
                    betaK = jnp.where(
                        arg > 0,
                        -(bq + jnp.sqrt(jnp.maximum(arg, 0.0))) / (2.0 * a_safe),
                        -bq / (2.0 * a_safe),
                    )
                    hit = waK2 > alpha2
                    for i in range(Bc):
                        nwr[i] = jnp.where(hit, nwr[i] - betaK * vr[i], nwr[i])
                        nwi[i] = jnp.where(hit, nwi[i] + betaK * vi[i], nwi[i])
                if copt >= 2:
                    # norm cap + precision reset; max(waK2, max_wa) keeps the
                    # scale finite on lanes that do not take the branch and
                    # equals sqrt(max_wa / waK2) on those that do
                    over = waK2 > max_wa
                    scale = jnp.sqrt(max_wa / jnp.maximum(waK2, max_wa))
                    for i in range(Bc):
                        nwr[i] = jnp.where(over, nwr[i] * scale, nwr[i])
                        nwi[i] = jnp.where(over, nwi[i] * scale, nwi[i])
                        dK[i] = jnp.where(over, d0, dK[i])
                    for n in range(len(pairs)):
                        offKr[n] = jnp.where(over, 0.0, offKr[n])
                        offKi[n] = jnp.where(over, 0.0, offKi[n])

            # silence gate
            d = [jnp.where(gate, dK[i], d[i]) for i in range(Bc)]
            offr = [jnp.where(gate, offKr[n], offr[n]) for n in range(len(pairs))]
            offi = [jnp.where(gate, offKi[n], offi[n]) for n in range(len(pairs))]
            war = [jnp.where(gate, nwr[i], war[i]) for i in range(Bc)]
            wai = [jnp.where(gate, nwi[i], wai[i]) for i in range(Bc)]
            en = en * beta + (1.0 - beta) * energy_t

            # GSC output with the gated weights
            yr, yi = ycr, yci
            for i in range(Bc):
                tr, ti = _cmul(war[i], wai[i], Zr[i], Zi[i])
                yr, yi = yr - tr, yi - ti
            adapted = t >= min_frames
            yr = jnp.where(adapted, yr, ycr)
            yi = jnp.where(adapted, yi, yci)

            # Zelinski: smoothed pair sum and trace of the aligned CSD
            alr, ali = [], []
            for c in range(C):
                ar_, ai_ = _cmul_conj(xr[c], xi[c], ta[c][0], ta[c][1])
                alr.append(ar_)
                ali.append(ai_)
            psr = psi = 0.0
            for i, j in cpairs:
                tr, ti = _cmul_conj(alr[i], ali[i], alr[j], ali[j])
                psr, psi = psr + tr, psi + ti
            dsum = 0.0
            for c in range(C):
                dsum = dsum + alr[c] * alr[c] + ali[c] * ali[c]
            smooth = t > 1
            ppr = jnp.where(smooth, a_pf * ppr + (1.0 - a_pf) * psr, psr)
            ppi = jnp.where(smooth, a_pf * ppi + (1.0 - a_pf) * psi, psi)
            pdg = jnp.where(smooth, a_pf * pdg + (1.0 - a_pf) * dsum, dsum)
            if real_mode:
                num = jnp.maximum(ppr, 0.0)
            else:
                num = jnp.sqrt(ppr * ppr + ppi * ppi)
            pos = pdg > 0
            ratio = jnp.where(pos, num / jnp.where(pos, pdg, 1.0), 0.0)
            W = jnp.clip(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
            apply_pf = t > pf_min_frames
            plgpu.store(o_ref.at[t, 0, sl], jnp.where(apply_pf, yr * W, yr), mask=mask)
            plgpu.store(o_ref.at[t, 1, sl], jnp.where(apply_pf, yi * W, yi), mask=mask)
            return (war, wai, d, offr, offi, en, ppr, ppi, pdg)

        zeros = jnp.zeros((block,), jnp.float32)
        init = (
            [zeros] * Bc, [zeros] * Bc,
            [jnp.full((block,), d0, jnp.float32)] * Bc,
            [zeros] * len(pairs), [zeros] * len(pairs),
            jnp.full((block,), e0, jnp.float32), zeros, zeros, zeros,
        )
        jax.lax.fori_loop(0, Tf, step, init)

    return kernel


def gsc_rls_zelinski_lanes(X, energy, wq, bm, ta, cfg, pf_alpha: float = 0.6,
                           pf_type: int = 1, pf_min_frames: int = 0,
                           interpret: bool = False, block: int = BLOCK):
    """The recursion kernel on the lane layout of the module docstring.

    ``X [Tf, C, 2, L]``, ``energy [Tf, U]`` with ``L = U * F``, weight
    planes ``wq, ta [C, 2, L]`` and ``bm [Bc, C, 2, L]`` (`lane_planes`).
    Returns ``[Tf, 2, L]``.  ``interpret=True`` runs it on the CPU.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    Tf, C, _, L = X.shape
    U = energy.shape[1]
    if L % U:
        raise ValueError(f"lane count {L} is not a multiple of {U} utterances")
    Bc = bm.shape[0]
    kernel = _make_kernel(cfg, C, Bc, L // U, Tf, L, block, pf_alpha,
                          int(pf_type), int(pf_min_frames))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((Tf, 2, L), jnp.float32),
        grid=(pl.cdiv(L, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="gsc_rls_zelinski",
    )(X.astype(jnp.float32), energy.astype(jnp.float32), wq, bm, ta)


def lane_planes(w, n_utt: int, per_utterance: bool = False) -> jax.Array:
    """Complex weights -> f32 lane planes ``[..., 2, n_utt * F]``.

    ``w``: ``[F, ...]`` shared by every utterance, or ``[n_utt, F, ...]``
    with ``per_utterance=True`` (one steering per utterance)."""
    w = jnp.asarray(w)
    if not per_utterance:
        w = jnp.broadcast_to(w[None], (n_utt,) + w.shape)
    w = jnp.moveaxis(jnp.moveaxis(w, 0, -1), 0, -1)  # [..., U, F]
    w = w.reshape(w.shape[:-2] + (-1,))
    return jnp.stack([jnp.real(w), jnp.imag(w)], axis=-2).astype(jnp.float32)


def gsc_rls_zelinski(Yr, energy, wqH, BmH, wq_manifold, cfg,
                     pf_alpha: float = 0.6, pf_type: int = 1,
                     pf_min_frames: int = 0, per_utterance: bool = False,
                     interpret: bool = False) -> jax.Array:
    """Fused GSC-RLS + Zelinski on the time-major analysis output.

    ``Yr [Tf, B, C, 2F]``: the ``[Re | Im]`` lanes of
    `ops.filterbank.analysis_half_real_tm` (``packed=False``);
    ``energy [Tf, B]``: reference-channel frame energies
    (`beamforming.frame_energy_half`).  Weights ``wqH [F, C]``,
    ``BmH [F, Bc, C]``, ``wq_manifold [F, C]`` (the postfilter alignment,
    the C++ ``ta_``), or with a leading ``[B]`` axis when
    ``per_utterance``.  Returns complex ``Y [Tf, B, F]``, equal to
    `adaptive_gsc.gsc_postfilter_fused` on the same snapshots.
    """
    Tf, B, C, F2 = Yr.shape
    F = F2 // 2
    X = Yr.reshape(Tf, B, C, 2, F).transpose(0, 2, 3, 1, 4).reshape(Tf, C, 2, B * F)
    planes = [lane_planes(w, B, per_utterance) for w in (wqH, BmH, wq_manifold)]
    Y = gsc_rls_zelinski_lanes(X, energy, *planes, cfg, pf_alpha, pf_type,
                               pf_min_frames, interpret=interpret)
    Y = Y.reshape(Tf, 2, B, F)
    return jax.lax.complex(Y[:, 0], Y[:, 1])
