"""Smoke test of the enhancement pipeline on one GPU.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --multi-gpu  # four GPUs: the sharded meshes only

Phases on one GPU (random signals made from fixed seeds):

1. the GSC-RLS + Zelinski recursion kernel, compiled at the flagship width
   and compared with the XLA scan on the same card; the near-silent-bin
   trigger;
2. the flagship through ``build_pipeline`` (M=256, m=4, r=1, 4 channels at
   16 kHz, B=256 utterances of 10 s), compared with the CPU backend's XLA
   path on 8 utterances of 2 s;
3. the fixed-weight D&S and SD-MVDR + Zelinski chains, config 4 (NLMS-AEC
   -> WPE -> GSC-RLS -> Zelinski), config 5 (72-point SRP-PHAT -> steered
   GSC-RLS + Zelinski), ``StreamingEnhancer`` at 16-frame chunks and the
   ``online_beamforming`` CLI on a generated 4-channel recording, each run at
   its bench width, checked finite and compared with the CPU on a slice;
4. ``utils.device_golden``: per-family device-vs-CPU errors.

Every comparison is printed beside its tolerance: 1e-4 for one kernel or
one short recursion, 2e-3 for an adaptive chain over many frames (any
bit-different f32 implementation of the gated RLS loop drifts apart).  Any
failed phase makes the exit code non-zero; on success the last line is
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
and prints no result.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from distant_speech_recognition_tpu.models.pipeline import build_pipeline, path_flags

CHAIN_TOL = 2e-3
KERNEL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(label: str, err: float, tol: float, finite: bool = True) -> None:
    ok = finite and err <= tol
    log(f"  {label}: rel_err={err:.3e} tol={tol:.0e} finite={finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: rel_err={err} > {tol} or not finite")


def memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys}


class Smoke:
    """One card's phases.  The CPU backend's XLA path is the reference."""

    def __init__(self):
        import jax

        from distant_speech_recognition_tpu.utils import gpu_checks as gc
        from distant_speech_recognition_tpu.utils.prototypes import load_pair

        self.jax = jax
        self.gc = gc
        self.cpu = jax.local_devices(backend="cpu")[0]
        self.cfg = gc.flagship_config()
        self.h, self.g = load_pair(256, 4, 1)
        self.mpos, self.delays = gc.array_geometry()
        self.x = gc.signals(256, 10.0)

    def on_cpu(self, build, *arrays):
        """Build with the XLA scan and run on the CPU backend."""
        jax = self.jax
        with self.gc.scan_route(False), jax.default_device(self.cpu):
            out = build()(*[jax.device_put(a, self.cpu) for a in arrays])
            return jax.tree.map(np.asarray, out)

    def route(self, cfg):
        log(f"  route: {path_flags(cfg, self.x.shape[1])}")

    def build(self, cfg):
        return build_pipeline(cfg, self.mpos, self.delays, self.h, self.g)

    def full_width(self, label, fn, *args):
        """Compile at the bench width, print the memory analysis, run once,
        check the output is finite."""
        jax = self.jax
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        log(f"  {label}: compiled in {time.perf_counter() - t0:.1f}s, memory {memory(compiled)}")
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        log(f"  {label}: ran in {time.perf_counter() - t0:.3f}s")
        y = np.asarray(out[0] if isinstance(out, tuple) else out)
        if not np.isfinite(y).all():
            raise AssertionError(f"{label}: non-finite output")
        log(f"  {label}: output {y.shape} finite")
        return y

    # -- phase 1 -------------------------------------------------------------
    def kernel(self):
        jax, gc, cfg = self.jax, self.gc, self.cfg
        from distant_speech_recognition_tpu.models.adaptive_gsc import gsc_weights
        from distant_speech_recognition_tpu.models.beamforming import (
            array_manifold,
            frame_energy_half,
        )
        from distant_speech_recognition_tpu.models.scan_kernel import gsc_rls_zelinski
        from distant_speech_recognition_tpu.ops.filterbank import analysis_half_real_tm
        from distant_speech_recognition_tpu.utils.jaxenv import host_device

        M, F = cfg.fb.M, cfg.fb.M // 2 + 1
        with host_device():
            wqH, BmH = gsc_weights(M, cfg.samplerate, self.delays, cfg.Nc)
            ta = array_manifold(M, cfg.samplerate, self.delays)
        Yr = jax.jit(lambda x: analysis_half_real_tm(x, self.h, cfg.fb))(self.x)
        e = jax.jit(lambda Yr: frame_energy_half(
            jax.lax.complex(Yr[:, :, 0, :F], Yr[:, :, 0, F:]), M))(Yr)
        kern = jax.jit(lambda Yr, e: gsc_rls_zelinski(
            Yr, e, wqH, BmH, ta, cfg.rls, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames))
        self.full_width(f"recursion kernel {tuple(Yr.shape)}", kern, Yr, e)
        del Yr, e
        r = gc.kernel_vs_xla(self.x[:8, :, : 2 * gc.FS], cfg)
        check("kernel vs XLA scan, 8 x 2 s", r["rel"], KERNEL_TOL, r["finite"])
        r = gc.kernel_vs_xla(self.x, cfg)
        check("kernel vs XLA scan, 256 x 10 s", r["rel"], CHAIN_TOL, r["finite"])
        r = gc.nan_trigger(cfg)
        check(f"near-silent-bin trigger (nan={r['nan']})", r["rel"], KERNEL_TOL, r["finite"])

    # -- phase 2 -------------------------------------------------------------
    def flagship(self):
        cfg = self.cfg
        self.route(cfg)
        fn = self.build(cfg)
        self.full_width("flagship B=256 x 10 s", fn, self.x)
        xs = self.x[:8, :, : 2 * self.gc.FS]
        y = np.asarray(fn(xs))
        ref = self.on_cpu(lambda: self.build(cfg), xs)
        check("flagship vs CPU XLA path, 8 x 2 s", self.gc.rel_err(y, ref), CHAIN_TOL,
              bool(np.isfinite(y).all()))

    # -- phase 3 -------------------------------------------------------------
    def chains(self):
        gc = self.gc
        xs = self.x[:2, :, : 2 * gc.FS]
        for bftype in ("ds", "sd_mvdr"):
            cfgf = dataclasses.replace(self.cfg, beamformer=bftype)
            log(f" fixed-weight {bftype} + zelinski")
            self.route(cfgf)
            fn = self.build(cfgf)
            self.full_width(f"{bftype} B=256 x 10 s", fn, self.x)
            ref = self.on_cpu(lambda: self.build(cfgf), xs)
            check(f"{bftype} vs CPU, 2 x 2 s", gc.rel_err(fn(xs), ref), CHAIN_TOL)

        log(" config 4: nlms aec -> wpe -> gsc_rls -> zelinski")
        cfg4 = dataclasses.replace(self.cfg, aec="nlms", wpe=True, wpe_iterations=2)
        self.route(cfg4)
        fn4 = self.build(cfg4)
        play = gc.signals(256, 10.0, seed=1, n_chan=1)[:, 0]
        self.full_width("config4 B=256 x 10 s", fn4, self.x, play)
        ps = play[:2, : 2 * gc.FS]
        ref = self.on_cpu(lambda: self.build(cfg4), xs, ps)
        check("config4 vs CPU, 2 x 2 s", gc.rel_err(fn4(xs, ps), ref), CHAIN_TOL)
        del fn4

        log(" config 5: srp_phat (72 points) -> steered gsc_rls -> zelinski")
        self.config5()

        log(" streaming: StreamingEnhancer, 16-frame chunks")
        self.streaming()

        log(" online_beamforming CLI")
        self.cli()

    def config5(self):
        gc = self.gc
        from distant_speech_recognition_tpu.models.steered import build_steered_pipeline
        from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays

        C = 4
        ang = 2 * np.pi * np.arange(C) / C
        mpos5 = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
        phis = np.deg2rad(np.arange(0.0, 360.0, 5.0))

        def build():
            return build_steered_pipeline(self.cfg, mpos5, self.h, self.g,
                                          thetas=[np.pi / 2], phis=phis)

        self.route(self.cfg)  # the steered chain takes the same kernel flag
        fn5 = build()
        self.full_width("config5 B=64 x 10 s", fn5, self.x[:64])
        # sources placed on grid directions, so the DOA argmax is unambiguous
        B, T = 4, 2 * gc.FS
        rng = np.random.default_rng(5)
        src = (rng.standard_normal((B, T + 64)) * 1500).astype(np.float32)
        xs = np.zeros((B, C, T), np.float32)
        for b in range(B):
            d = calc_ca_delays(mpos5, phis[(17 * b) % len(phis)], np.pi / 2)
            for c in range(C):
                off = int(round(float(d[c]) * gc.FS)) + 8
                xs[b, c] = src[b, off: off + T]
        y, doa = fn5(xs)
        y_ref, doa_ref = self.on_cpu(build, xs)
        if not np.array_equal(np.asarray(doa), doa_ref):
            raise AssertionError(f"config5 DOA differs: {np.asarray(doa)} vs {doa_ref}")
        log("  config5 DOA equal to the CPU's")
        check("config5 vs CPU, 4 x 2 s", gc.rel_err(y, y_ref), CHAIN_TOL)

    def streaming(self):
        jax, gc = self.jax, self.gc
        from distant_speech_recognition_tpu.models.streaming import StreamingEnhancer

        fpc = 16
        chunk = fpc * self.cfg.fb.D
        xs = self.x[0, :, : 20 * chunk]

        def run():
            enh = StreamingEnhancer(self.cfg, self.mpos, self.delays, self.h, self.g,
                                    frames_per_chunk=fpc)
            outs, lat = [], []
            for i in range(0, xs.shape[1], chunk):
                t0 = time.perf_counter()
                outs.append(np.asarray(enh.process(xs[:, i: i + chunk])))
                lat.append(time.perf_counter() - t0)
            return np.concatenate(outs), lat

        log("  route: per-chunk XLA programs with carried state (no recursion kernel)")
        y, lat = run()
        log(f"  streaming: {len(lat)} chunks of {chunk / gc.FS * 1e3:.0f} ms, "
            f"median host-to-host latency {np.median(lat[1:]) * 1e3:.2f} ms")
        with jax.default_device(self.cpu):
            y_ref, _ = run()
        check("streaming vs CPU, 20 chunks", gc.rel_err(y, y_ref), CHAIN_TOL,
              bool(np.isfinite(y).all()))

    def cli(self):
        from distant_speech_recognition_tpu.tools import online_beamforming as ob
        from distant_speech_recognition_tpu.utils.config import parse_ap_conf
        from distant_speech_recognition_tpu.utils.wavio import read_wav, write_wav

        conf = {
            "array_type": "linear",
            "microphone_positions": [[float(p[0]), 0.0, 0.0] for p in self.mpos],
            "target": {"positions": [[0.0, [float(np.pi / 3), None, None]]]},
            "beamformer": {"type": "gscrls"},
            "postfilter": {"type": "zelinski", "subtype": 2, "alpha": 0.6},
        }
        cfg, mpos, delays, extra = parse_ap_conf(conf, self.cfg.fb, float(self.gc.FS))
        self.route(cfg)
        x = np.clip(self.x[0, :, : 4 * self.gc.FS], -32000, 32000)
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
            paths = []
            for c in range(x.shape[0]):
                paths.append(os.path.join(d, f"c{c + 1}.wav"))
                write_wav(paths[-1], x[c], self.gc.FS, normalized=False)
            conf_path = os.path.join(d, "gscrls.json")
            with open(conf_path, "w") as f:
                json.dump(conf, f)
            out_path = os.path.join(d, "out.wav")
            argv = sys.argv
            sys.argv = ["online_beamforming", "-c", conf_path, "-o", out_path, "-i", *paths]
            try:
                ob.main()
            finally:
                sys.argv = argv
            y = read_wav(out_path, normalize=False)[0][0]
            xin = np.stack([read_wav(p, normalize=False)[0][0] for p in paths])
            ref = np.asarray(self.on_cpu(
                lambda: build_pipeline(cfg, mpos, delays, self.h, self.g,
                                       noise_delays=extra.get("noise_delays")),
                xin[None]))[0]
        # the CLI writes int16 PCM: half an LSB of rounding on top of the chain
        ref = np.clip(ref, -32768, 32767)
        check("CLI output (int16) vs CPU pipeline, 4 s", self.gc.rel_err(y, ref), CHAIN_TOL,
              bool(np.isfinite(y).all()))

    # -- phase 4 -------------------------------------------------------------
    def golden(self):
        from distant_speech_recognition_tpu.utils import device_golden

        r = device_golden.run()
        for k, v in r["families"].items():
            log(f"  {k}: rel_err={v} budget={r['budgets'][k]:.0e}")
        if not r["ok"]:
            raise AssertionError("device_golden: a family is over its budget")


def batch_mesh(n: int, B_per_dev: int = 256, secs: float = 10.0) -> None:
    """The flagship on the batch-only mesh of ``n`` devices at the bench
    width (B_per_dev utterances of 10 s per device), against the single-card
    run of each device's slice (<= 1e-4)."""
    import jax

    from distant_speech_recognition_tpu.parallel import make_mesh, shard_batch, snapshot_sharding
    from distant_speech_recognition_tpu.utils import gpu_checks as gc
    from distant_speech_recognition_tpu.utils.prototypes import load_pair

    cfg = gc.flagship_config()
    h, g = load_pair(256, 4, 1)
    mpos, delays = gc.array_geometry()
    mesh = make_mesh(devices=jax.devices()[:n], batch=n, freq=1)
    fn = build_pipeline(cfg, mpos, delays, h, g, bin_sharding=snapshot_sharding(mesh, batched=False))
    xs = [gc.signals(B_per_dev, secs, seed=i) for i in range(n)]
    with jax.set_mesh(mesh):
        x = shard_batch(mesh, np.concatenate(xs))
        t0 = time.perf_counter()
        compiled = fn.lower(x).compile()
        log(f"  batch mesh ({n} x {B_per_dev} x {secs:g} s): compiled in "
            f"{time.perf_counter() - t0:.1f}s, memory per device {memory(compiled)}")
        jax.block_until_ready(compiled(x))
        t0 = time.perf_counter()
        y = jax.block_until_ready(compiled(x))
        log(f"  batch mesh: ran in {time.perf_counter() - t0:.3f}s")
    y = np.asarray(y)
    del x
    fn_one = build_pipeline(cfg, mpos, delays, h, g)
    for i, xi in enumerate(xs):
        yi = y[i * B_per_dev: (i + 1) * B_per_dev]
        check(f"batch mesh device {i} slice vs single card", gc.rel_err(yi, fn_one(xi)),
              KERNEL_TOL, bool(np.isfinite(yi).all()))


def multi_gpu() -> None:
    """The batch-only mesh at the bench width, and both meshes of
    ``__graft_entry__.dryrun_multichip(4)`` on short utterances, each
    compared with the single-card run (<= 1e-4)."""
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import __graft_entry__ as ge

    if len(jax.devices()) < 4:
        raise AssertionError(f"--multi-gpu needs 4 GPUs, found {len(jax.devices())}")
    batch_mesh(4)
    # the freq-sharded mesh runs the XLA scan and the single card the
    # kernel: kept short so both agree within 1e-4 (over a full utterance
    # the two recursions drift apart to the adaptive-chain budget)
    t0 = time.perf_counter()
    errs = ge.dryrun_multichip(4, B_per_dev=16, T=4096)
    log(f"  freq-sharded (batch=1 x freq=4) vs single card: rel_err={errs['freq_sharded']:.3e} tol=1e-04")
    log(f"  batch-sharded (batch=4) vs single card: rel_err={errs['batch_sharded']:.3e} tol=1e-04")
    log(f"  short meshes: {time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    import jax

    from distant_speech_recognition_tpu.utils.jaxenv import setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}, devices {jax.devices()}")

    if args.multi_gpu:
        phases = [("multi_gpu", multi_gpu)]
    else:
        smoke = Smoke()
        phases = [("kernel", smoke.kernel), ("flagship", smoke.flagship),
                  ("chains", smoke.chains), ("device_golden", smoke.golden)]
    failed = []
    for name, fn in phases:
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"[{name}] {'FAILED' if name in failed else 'ok'} in {time.perf_counter() - t0:.1f}s")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
