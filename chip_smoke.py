"""Build the port's CUDA kernels and drive its main paths once on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and prints no
result line):

0. the card's name and power limit (nvidia-smi), torch and CUDA versions;
1. build the four kernels from nuradiomc_tpu_torch/csrc/ (sm_90a), one
   nvcc per source, started together;
2. each kernel against its plain PyTorch version on the card at its path's
   shapes, float32 and float64, with CUDA-event timings: kernel 1 also at
   s2 20 and 40 (multi-shower groups), kernel 4 at the gen2 path's shape
   and at the profiling tool's (with its no-phase variant);
3. the headline (dipole Veff) slice: 65536 groups of the bench workload
   through ``simulate_batch`` (placement + trigger kernels), held to the
   per-group ``veff_trig`` pin of tests/golden/bench_pins.npz (at most 56
   flips) and to the plain path on the same card (identical decisions),
   with its events/s;
4. the 3000-event dipole golden through ``Simulation`` on the card, read
   from the ``.npz`` export of its input (the card has no h5py): float64
   with NuRadioMC's triggered set and Veff 0.22978 km^3, float32 (bench
   settings) with at most group 1272 extra;
5. the phased-array slice: 16384 groups of the bench's phased-array
   workload (``convert.make_pa_inputs``, float32, placement + phased-array
   kernels): noiseless decisions against the ``pa_nl_trig`` pin (at most 6
   source events flip), the noisy count in [107, 249], the kernel path
   against the plain path with the same noise (at most 8 groups differ,
   each within 1e-3 of the threshold), with its events/s;
6. the Gen2 composed slice: 256 groups of the tau input, three stations,
   birefringence, float32 (``convert.make_gen2_inputs``, kernels 4 and 2):
   the per-group station counts against the ``gen2_trig`` pin (at most 8
   flips), the kernel path against the plain path, events/s at 256 and at
   2048 groups (the whole file) with peak device memory, and the whole file
   through ``Simulation`` in float64 with birefringence on (kernel 4) and
   off (the factored chain: kernel 1 at s2 20).

Every printed time carries the card's name and power limit. The line before
the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from nuradiomc_tpu.utils import units  # noqa: E402
from nuradiomc_tpu_torch import convert  # noqa: E402
from nuradiomc_tpu_torch.convert import make_headline_inputs  # noqa: E402
from nuradiomc_tpu_torch.ops import (_build, noise, pa_trigger, phased_array,  # noqa: E402
                                     placement, trigger_fused)
from nuradiomc_tpu_torch.sim import pipeline  # noqa: E402
from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000, INPUT_GEN2  # noqa: E402

N_GROUPS = 65536
FLIP_BOUND = 56          # bench.py:130, veff_trig
PIN = os.path.join(HERE, "tests", "golden", "bench_pins.npz")
E2E_GOLDEN = os.path.join(HERE, "tests", "golden", "e2e_reference.npz")
PA_GROUPS = 16384        # bench.py:390
PA_SOURCE_FLIPS = 6      # bench.py:132, pa_nl_trig, counted per source event
PA_NOISY = (107, 249)    # bench.py:80 and :197-199, 178 +- 40%
PA_CROSS_GROUPS = 8      # bench.py:451
GEN2_GROUPS = 256        # bench.py:575
GEN2_FLIPS = 8           # bench.py:135, gen2_trig
KERNELS = ("placement_chain", "irfft_trigger", "pa_trigger", "placement_reduce")
CARD = ""                # nvidia-smi name and power limit, set by main()


def _median_ms(fn, n_warm=2, n_runs=10):
    """Median of per-run CUDA-event times (ms) after warm-up."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _placement_inputs(dtype, dev, gen, G_out=N_GROUPS, s2=4):
    """Kernel-1 inputs at the headline shapes: R = 65536*1*2*2 rows,
    K_int 208, 24 sparse frequencies, K_place 816; a third of the rows are
    masked and carry NaN spectra."""
    n_int, n_base, K_int, K_place = 512, 2048, 208, 816
    R = G_out * s2
    ff = np.fft.rfftfreq(n_int, 0.5)
    sparse = pipeline._attenuation_freq_grid(tuple(ff), 16, 0.5)
    W = torch.as_tensor(pipeline._interp_matrix(tuple(sparse), tuple(ff))[:, :K_int],
                        dtype=dtype, device=dev)
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    from nuradiomc_tpu_torch.ops.antenna import build_analytic_template
    tpl = build_analytic_template("analytic_VPol", ff)[0] * (ff >= 5e-3)
    templates = torch.as_tensor(np.broadcast_to(tpl, (3, len(ff)))[:, :K_int].copy(),
                                dtype=ctype, device=dev)
    D_r, D_i = pipeline._placement_matrices(n_int, n_base)
    D_r = torch.as_tensor(D_r[:K_int, :K_place], dtype=ctype, device=dev)
    D_i = torch.as_tensor(D_i[:K_int, :K_place], dtype=ctype, device=dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    mask = torch.rand(R, generator=gen, device=dev) < 0.67
    spec_re = rnd(R, K_int)
    spec_im = rnd(R, K_int)
    spec_re[~mask] = float("nan")
    spec_im[~mask] = float("nan")
    args = (spec_re, spec_im,
            torch.rand(R, len(sparse), generator=gen, device=dev, dtype=dtype) * 0.5 + 0.5,
            rnd(R), rnd(R), mask,
            torch.randint(0, 3, (R,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand(R, generator=gen, device=dev, dtype=dtype) * 768.0,
            W, templates, D_r, D_i)
    return args, dict(s2=s2, df=2.0 / n_base)


def _trigger_inputs(dtype, dev, gen):
    """Kernel-2 inputs at the headline shapes: 65536 groups x 1 channel,
    K_base 816, n_base 2048, the high/low trigger of the bench (10-bin
    high/low window, 400-bin majority window); band-limited noise spectra,
    thresholds 2-3 sigma so groups both fire and do not."""
    n_base, K = 2048, 816
    I_r, I_i = pipeline._irfft_matrices(n_base)
    I_r = torch.as_tensor(I_r[:K], dtype=dtype, device=dev)
    I_i = torch.as_tensor(I_i[:K], dtype=dtype, device=dev)
    scale = 2.0 / np.sqrt(2.0)
    spec_re = torch.randn(N_GROUPS, K, generator=gen, device=dev, dtype=dtype)
    spec_im = torch.randn(N_GROUPS, K, generator=gen, device=dev, dtype=dtype)
    sigma = float(((spec_re[:256] @ I_r + spec_im[:256] @ I_i) * scale).std())
    th = sigma * (2.0 + 1.0 * torch.rand(N_GROUPS, 1, generator=gen, device=dev,
                                         dtype=dtype))
    trig = (trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1),)
    return (spec_re, spec_im, th, -th, I_r, I_i), dict(scale=scale, triggers=trig, C=1)


def _check_placement(label, kernel, plain, args, kw, tol, timed=True):
    """A placement kernel (1 or 4) against its plain version: the worst
    |kernel - plain| over each output row's peak must stay within ``tol``;
    returns (max abs error, kernel ms, plain ms), the times None untimed."""
    k_re, k_im = kernel(*args, **kw)
    p_re, p_im = plain(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(k_re).all() and torch.isfinite(k_im).all()):
        raise AssertionError(f"{label}: non-finite output (masked NaN rows leaked)")
    err = torch.maximum((k_re - p_re).abs(), (k_im - p_im).abs())
    peak = torch.maximum(p_re.abs(), p_im.abs()).amax(dim=1)
    row_err = err.amax(dim=1)
    rel = torch.where(peak > 0, row_err / torch.where(peak > 0, peak, 1.0), row_err)
    worst, max_abs = float(rel.max()), float(err.max())
    del k_re, k_im, p_re, p_im, err
    ms = plain_ms = None
    times = ""
    if timed:
        ms = _median_ms(lambda: kernel(*args, **kw))
        plain_ms = _median_ms(lambda: plain(*args, **kw))
        times = f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({CARD})"
    print(f"phase 2 {label}: max |kernel - plain| / row peak = {worst:.3e} "
          f"(limit {tol:g}), max abs {max_abs:.3e}{times}")
    if not worst <= tol:
        raise AssertionError(f"{label} disagrees with its plain version: {worst:.3e}")
    return max_abs, ms, plain_ms


def _reduce_inputs(dtype, dev, gen, R, s2, K_int=257, K_place=1025):
    """Kernel-4 inputs: a voltage spectrum [R, K_int] with a third of the
    rows zero (masked solutions), offsets over the time base's 768 ns of
    headroom, the 512 -> 2048 placement DFT (band limit off)."""
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    D_r, D_i = (torch.as_tensor(m[:K_int, :K_place], dtype=ctype, device=dev)
                for m in pipeline._placement_matrices(512, 2048))
    keep = (torch.rand(R, 1, generator=gen, device=dev) < 0.67).to(dtype)
    v_re = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    v_im = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    offs = torch.rand(R, generator=gen, device=dev, dtype=dtype) * 768.0
    return (v_re, v_im, offs, D_r, D_i), dict(s2=s2, df=2.0 / 2048)


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns the float32 summary."""
    summary = {}
    for dtype, tol_place, tol_amp in ((torch.float32, 1e-4, 1e-5),
                                      (torch.float64, 1e-10, 1e-12)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261016)
        tag = str(dtype).replace("torch.", "")

        args, kw = _placement_inputs(dtype, dev, gen)
        max_abs, ms, plain_ms = _check_placement(
            f"placement_chain {tag}", placement.chain_placement_reduce,
            placement.chain_placement_reduce_plain, args, kw, tol_place)
        if dtype == torch.float32:
            summary["placement_chain"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del args
        args, kw = _trigger_inputs(dtype, dev, gen)
        kf, kfirst, kamp = trigger_fused.fused_irfft_trigger(*args, **kw)
        pf, pfirst, pamp = trigger_fused.fused_irfft_trigger_plain(*args, **kw)
        torch.cuda.synchronize()
        n_fired = int(pf.sum())
        d_fired = int((kf != pf).sum())
        d_first = int((kfirst != pfirst).sum())
        amp_rel = float(((kamp - pamp).abs() / pamp.abs()).max())
        amp_abs = float((kamp - pamp).abs().max())
        ms = _median_ms(lambda: trigger_fused.fused_irfft_trigger(*args, **kw))
        plain_ms = _median_ms(lambda: trigger_fused.fused_irfft_trigger_plain(*args, **kw))
        print(f"phase 2 irfft_trigger {tag}: fired differ in {d_fired} of "
              f"{N_GROUPS} groups ({n_fired} fired), first bins differ in "
              f"{d_first}, amp max rel err {amp_rel:.3e} (limit {tol_amp:g}); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({CARD})")
        if d_fired or d_first or not amp_rel <= tol_amp:
            raise AssertionError(f"trigger kernel {tag} disagrees with the plain version")
        if dtype == torch.float32:
            summary["irfft_trigger"] = dict(max_abs_err=amp_abs, ms=ms, plain_ms=plain_ms)
        del args
        torch.cuda.empty_cache()

        for s2 in (20, 40):
            # multi-shower groups: an output row spans several row chunks
            args, kw = _placement_inputs(dtype, dev, gen, G_out=2560, s2=s2)
            _check_placement(f"placement_chain {tag} s2 {s2} ({2560 * s2} rows)",
                             placement.chain_placement_reduce,
                             placement.chain_placement_reduce_plain, args, kw, tol_place,
                             timed=False)
            del args

        R_gen2 = GEN2_GROUPS * 2 * 20
        print(f"phase 2 placement_reduce shapes: gen2 path R {R_gen2}, s2 20, "
              f"K_int 257, K_place 1025 (band limit 0); tool R 262144, s2 4")
        args, kw = _reduce_inputs(dtype, dev, gen, R_gen2, 20)
        max_abs, ms, plain_ms = _check_placement(
            f"placement_reduce {tag} gen2 shape", placement.placement_reduce,
            placement.placement_reduce_plain, args, kw, tol_place)
        if dtype == torch.float32:
            summary["placement_reduce"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del args
        args, kw = _reduce_inputs(dtype, dev, gen, 262144, 4)
        _check_placement(f"placement_reduce {tag} tool shape", placement.placement_reduce,
                         placement.placement_reduce_plain, args, kw, tol_place)
        _check_placement(f"placement_reduce {tag} tool shape, no phase (matmul_only)",
                         placement.placement_reduce, placement.placement_reduce_plain,
                         args, {**kw, "phase": False}, tol_place)
        del args
        torch.cuda.empty_cache()
    return summary


def phase_headline(dev):
    """The headline slice through the kernels, against the pin and the plain
    path; returns the launch counts of the main-path run."""
    import dataclasses

    settings, ch, batch = make_headline_inputs(N_GROUPS, 2, 1, 512, 2048,
                                               device=dev, dtype=torch.float32)
    settings = dataclasses.replace(settings, band_limit_eps=1e-2)
    pins = np.load(PIN)
    ref = pins["veff_trig"].astype(np.int64)
    if len(ref) != N_GROUPS:
        raise AssertionError(f"veff_trig pin has {len(ref)} groups, the run "
                             f"{N_GROUPS}: a stale pin is a failure")

    placement.launches = 0
    trigger_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.simulate_batch(batch, ch, settings)
    trig = out.triggered.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = {"placement_chain": placement.launches,
                "irfft_trigger": trigger_fused.launches}
    print(f"phase 3 launches in the main-path run: {launches}; first call "
          f"{first_s:.3f} s ({CARD})")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    for name in ("max_amplitude", "trigger_time", "c0"):
        t = getattr(out, name)
        ok = torch.isfinite(t).all() if name != "c0" else torch.isfinite(t[out.sol_mask]).all()
        if not bool(ok):
            raise AssertionError(f"headline output {name} is not finite")
    if tuple(out.max_amplitude.shape) != (N_GROUPS, 1) or trig.shape != (N_GROUPS,):
        raise AssertionError("headline output has the wrong shape")
    flips = int((trig.astype(np.int64) != ref).sum())
    print(f"phase 3 headline: {int(trig.sum())} of {N_GROUPS} groups triggered, "
          f"pin {int(ref.sum())}, {flips} flips (bound {FLIP_BOUND})")
    if flips > FLIP_BOUND:
        raise AssertionError(f"{flips} flips against veff_trig exceed {FLIP_BOUND}")

    plain = dataclasses.replace(settings, placement_impl="plain", trigger_impl="plain")
    trig_plain = pipeline.simulate_batch(batch, ch, plain).triggered.cpu().numpy()
    cross = int((trig_plain != trig).sum())
    print(f"phase 3 kernel path vs plain path on the card: {cross} groups differ")
    if cross:
        raise AssertionError(f"kernel and plain paths differ in {cross} groups")

    def step(s):
        out = pipeline.simulate_batch(batch, ch, s)
        out.triggered.sum().item()

    for name, s in (("kernel", settings), ("plain", plain)):
        step(s)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(s)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        print(f"phase 3 {name} path: step {wall * 1e3:.1f} ms (median of 5), "
              f"{N_GROUPS / wall:.1f} events/s ({CARD})")
    return launches


def _pa_kernel_inputs(dtype, dev, gen):
    """Kernel-3 inputs at the bench shapes: 16384 groups x 4 channels,
    K_base 512, n_base 2048, n_dec 512 (0.5 GHz ADC), n_up 1024 (x2), the 11
    beams of the 4-channel array, window 16, step 8; band-limited noise
    spectra and an ADC range of 15 counts per noise Vrms, as the workload."""
    C, K, n_base = 4, 512, 2048
    spec = noise.bandlimited_noise_spectrum(
        gen, (PA_GROUPS * C,), n_base, 2.0, torch.tensor(1e-5, dtype=dtype, device=dev),
        dtype=dtype)[:, :K]
    I_r, I_i = pipeline._device_matrices("irfft", (n_base,), K, dtype, dev)
    Dd_r, Dd_i = pipeline._device_matrices("decimate", (n_base, 5120, 10), K, dtype, dev)
    U = pipeline._device_matrices("upsample", (512, 2), None, dtype, dev)
    spec_re, spec_im = spec.real.contiguous(), spec.imag.contiguous()
    scale_dec = 5.0 / np.sqrt(2.0)
    vrms = float(((spec_re[:4096] @ Dd_r + spec_im[:4096] @ Dd_i) * scale_dec).std())
    adc_range = vrms * 255 / 15
    rolls = phased_array.beam_rolls([-197.0 - i for i in range(C)], [1051.0] * C,
                                    phased_array.default_angles, 1.75, 1.0)
    return (spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U), dict(
        scale_full=2.0 / np.sqrt(2.0), scale_dec=scale_dec, rolls=rolls, window=16,
        step=8, v_min=-adc_range / 2, lsb=adc_range / 255, n_counts=256, C=C)


def phase_pa_kernel(dev):
    """Kernel 3 vs its plain version at the bench shapes, at a threshold
    where most groups fire and one where few do; returns the float32
    summary. The plain power sum is a cumsum difference and the kernel's a
    direct sum, so a decision may differ only within 1e-4 of the threshold."""
    summary = {}
    for dtype, tol_amp in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261016)
        tag = str(dtype).replace("torch.", "")
        args, kw = _pa_kernel_inputs(dtype, dev, gen)
        max_power = pa_trigger.fused_pa_trigger_plain(*args, threshold=float("inf"), **kw)[3]
        amp_abs = 0.0
        for q in (0.3, 0.9):
            thr = float(torch.quantile(max_power, q))
            kf, kframe, kamp = pa_trigger.fused_pa_trigger(*args, threshold=thr, **kw)
            pf, pframe, pamp, pmax = pa_trigger.fused_pa_trigger_plain(*args, threshold=thr, **kw)
            torch.cuda.synchronize()
            margin = (pmax - thr).abs() / thr
            diff = kf != pf
            margins = sorted(float(m) for m in margin[diff])
            solid = (margin >= 1e-4) & kf & pf
            d_frame = int((kframe != pframe)[solid].sum())
            amp_rel = float(((kamp - pamp).abs() / pamp.abs()).max())
            amp_abs = max(amp_abs, float((kamp - pamp).abs().max()))
            print(f"phase 2 pa_trigger {tag} threshold at quantile {q}: {int(pf.sum())} of "
                  f"{PA_GROUPS} groups fire, fired differs in {len(margins)} (plain-path "
                  f"margins {['%.2e' % m for m in margins]}), frames differ in {d_frame} "
                  f"solid groups, amp max rel err {amp_rel:.3e} (limit {tol_amp:g})")
            if margins and margins[-1] >= 1e-4:
                raise AssertionError(f"pa_trigger {tag}: a decision differs at margin "
                                     f"{margins[-1]:.3e} >= 1e-4")
            if d_frame or not amp_rel <= tol_amp:
                raise AssertionError(f"pa_trigger {tag} disagrees with the plain version")
        ms = _median_ms(lambda: pa_trigger.fused_pa_trigger(*args, threshold=thr, **kw))
        plain_ms = _median_ms(lambda: pa_trigger.fused_pa_trigger_plain(
            *args, threshold=thr, **kw))
        print(f"phase 2 pa_trigger {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"(median of 10; {CARD})")
        if dtype == torch.float32:
            summary["pa_trigger"] = dict(max_abs_err=amp_abs, ms=ms, plain_ms=plain_ms)
        del args
        torch.cuda.empty_cache()
    return summary


def _triggered_groups(res):
    return set(int(g) for g in res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)])


def phase_simulation(dev):
    """The 3000-event dipole golden through ``Simulation`` on the card, from
    the .npz export of its input, float64 and float32 (bench settings)."""
    golden = np.load(E2E_GOLDEN)
    ref = set(int(g) for g in np.unique(golden["group_ids"]))
    placement.launches = trigger_fused.launches = 0
    t0 = time.perf_counter()
    res = convert.dipole_simulation(str(INPUT_1E18_N3000), chunk_size=1024, device=dev,
                                    dtype=torch.float64).run()
    wall = time.perf_counter() - t0
    mine = _triggered_groups(res)
    veff = res["veff"] / units.km ** 3
    launches = (placement.launches, trigger_fused.launches)
    print(f"phase 4 Simulation float64 on the card: {len(mine)} groups triggered "
          f"(golden {len(ref)}), {len(mine ^ ref)} differ, Veff {veff:.5f} km^3 (golden "
          f"0.22978), kernel launches {launches}, {wall:.2f} s with set-up ({CARD})")
    if mine != ref or round(veff, 5) != 0.22978 or min(launches) < 1:
        raise AssertionError("the float64 3000-event golden does not hold on the card")
    res = convert.dipole_simulation(
        str(INPUT_1E18_N3000),
        {"propagation": {"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
         "perf": {"band_limit_eps": 1e-2}},
        chunk_size=1024, device=dev, dtype=torch.float32).run()
    mine = _triggered_groups(res)
    print(f"phase 4 Simulation float32 (bench settings): missing {sorted(ref - mine)}, "
          f"extra {sorted(mine - ref)} (allowed: 1272)")
    if ref - mine or mine - ref - {1272}:
        raise AssertionError("the float32 3000-event golden does not hold on the card")


def phase_pa(dev):
    """The phased-array slice through the kernels, against the noiseless pin,
    the noisy band and the plain path; returns the launch counts of the
    main-path (noisy, kernel path) run."""
    import dataclasses

    settings, ch, batch = convert.make_pa_inputs(PA_GROUPS, device=dev, dtype=torch.float32)
    pins = np.load(PIN)
    ref = pins["pa_nl_trig"].astype(np.int64)
    g0 = int(pins["pa_g0"])
    if len(ref) != PA_GROUPS:
        raise AssertionError(f"pa_nl_trig pin has {len(ref)} groups, the run "
                             f"{PA_GROUPS}: a stale pin is a failure")
    noiseless = pipeline.simulate_batch(batch, ch, dataclasses.replace(settings, add_noise=False))
    trig_nl = noiseless.triggered.cpu().numpy().astype(np.int64)
    sources = sorted({int(i) % g0 for i in np.flatnonzero(trig_nl != ref)})
    print(f"phase 5 noiseless: {int(trig_nl.sum())} of {PA_GROUPS} groups triggered, pin "
          f"{int(ref.sum())}, source events flipped {sources} (bound {PA_SOURCE_FLIPS})")
    if len(sources) > PA_SOURCE_FLIPS:
        raise AssertionError(f"{len(sources)} source events flip against pa_nl_trig")

    def generator():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    placement.launches = pa_trigger.launches = 0
    torch.cuda.synchronize()
    out = pipeline.simulate_batch(batch, ch, settings, noise_generator=generator())
    trig = out.triggered.cpu().numpy()
    launches = {"placement_chain": placement.launches, "pa_trigger": pa_trigger.launches}
    print(f"phase 5 launches in the main-path run: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    if (tuple(out.max_amplitude.shape) != (PA_GROUPS, 4)
            or not bool(torch.isfinite(out.max_amplitude).all())
            or not bool(torch.isfinite(out.trigger_time).all())):
        raise AssertionError("phased-array output has the wrong shape or is not finite")
    count = int(trig.sum())
    print(f"phase 5 noisy: {count} of {PA_GROUPS} groups triggered (band {PA_NOISY})")
    if not PA_NOISY[0] <= count <= PA_NOISY[1]:
        raise AssertionError(f"noisy count {count} outside {PA_NOISY}")

    plain = dataclasses.replace(settings, placement_impl="plain", trigger_impl="plain")
    seen = []
    plain_fn = pa_trigger.fused_pa_trigger_plain

    def recording(*args, **kw):       # keeps the plain path's max beam power
        result = plain_fn(*args, **kw)
        seen.append((result[3], kw["threshold"]))
        return result

    pa_trigger.fused_pa_trigger_plain = recording
    trig_plain = pipeline.simulate_batch(batch, ch, plain,
                                         noise_generator=generator()).triggered.cpu().numpy()
    pa_trigger.fused_pa_trigger_plain = plain_fn
    max_power, thr = seen[0]
    margin = ((max_power - thr).abs() / thr).cpu().numpy()
    diff = np.flatnonzero(trig_plain != trig)
    print(f"phase 5 kernel path vs plain path, same noise: {len(diff)} groups differ "
          f"(bound {PA_CROSS_GROUPS}), plain-path margins "
          f"{['%.2e' % m for m in margin[diff]]}")
    if len(diff) > PA_CROSS_GROUPS or (len(diff) and margin[diff].max() >= 1e-3):
        raise AssertionError("kernel and plain phased-array paths differ beyond razor margins")

    def step(s):
        pipeline.simulate_batch(batch, ch, s, noise_generator=generator()).triggered.sum().item()

    for name, s in (("kernel", settings), ("plain", plain)):
        step(s)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(s)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        print(f"phase 5 {name} path, noisy step: {wall * 1e3:.1f} ms (median of 5), "
              f"{PA_GROUPS / wall:.1f} events/s ({CARD})")
    return launches


def _gen2_step(batch, chps, settings):
    """One gen2 step: the per-group station-count vector over the stations."""
    return sum(pipeline.simulate_batch(batch, ch, settings).triggered.long() for ch in chps)


def _median_step(fn, n=5):
    fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def phase_gen2(dev):
    """The Gen2 composed slice through kernels 4 and 2, against the pin and
    the plain path, with its events/s; returns the launch counts of the
    main-path run."""
    import dataclasses

    settings, chps, batch = convert.make_gen2_inputs(GEN2_GROUPS, device=dev,
                                                     dtype=torch.float32)
    ref = np.load(PIN)["gen2_trig"].astype(np.int64)
    if len(ref) != GEN2_GROUPS:
        raise AssertionError(f"gen2_trig pin has {len(ref)} groups, the run "
                             f"{GEN2_GROUPS}: a stale pin is a failure")
    placement.launches = placement.reduce_launches = trigger_fused.launches = 0
    torch.cuda.synchronize()
    outs = [pipeline.simulate_batch(batch, ch, settings) for ch in chps]
    vec = sum(o.triggered.long() for o in outs).cpu().numpy()
    launches = {"placement_chain": placement.launches,
                "placement_reduce": placement.reduce_launches,
                "irfft_trigger": trigger_fused.launches}
    print(f"phase 6 launches in the main-path run: {launches}")
    if min(launches["placement_reduce"], launches["irfft_trigger"]) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    for o in outs:
        if (tuple(o.max_amplitude.shape) != (GEN2_GROUPS, 2)
                or not bool(torch.isfinite(o.max_amplitude).all())
                or not bool(torch.isfinite(o.max_amp_per_solution[o.sol_mask]).all())):
            raise AssertionError("gen2 output has the wrong shape or is not finite")
    flips = np.flatnonzero(vec != ref)
    print(f"phase 6 gen2: station-count sum {int(vec.sum())} over {GEN2_GROUPS} groups, "
          f"pin {int(ref.sum())}, {len(flips)} flipped groups {flips.tolist()} "
          f"(bound {GEN2_FLIPS})")
    if len(flips) > GEN2_FLIPS:
        raise AssertionError(f"{len(flips)} flips against gen2_trig exceed {GEN2_FLIPS}")

    plain = dataclasses.replace(settings, placement_impl="plain", trigger_impl="plain")
    differ = []
    for sid, ch, o in zip((101, 102, 103), chps, outs):
        p = pipeline.simulate_batch(batch, ch, plain)
        # margin: the plain path's largest channel amplitude over the high threshold
        margin = (p.max_amplitude / ch.threshold_high.abs()).amax(dim=1) - 1.0
        for g in torch.nonzero(p.triggered != o.triggered).flatten().tolist():
            differ.append((sid, g, float(margin[g])))
    print(f"phase 6 kernel path vs plain path on the card: {len(differ)} (station, group) "
          f"decisions differ {[(a, b, '%.2e' % m) for a, b, m in differ]}")
    if any(abs(m) >= 1e-3 for _, _, m in differ):
        raise AssertionError("kernel and plain gen2 paths differ beyond razor margins")

    for name, s in (("kernel", settings), ("plain", plain)):
        wall = _median_step(lambda: _gen2_step(batch, chps, s).sum().item())
        print(f"phase 6 {name} path: step {wall * 1e3:.1f} ms (median of 5, 3 stations), "
              f"{GEN2_GROUPS / wall:.1f} events/s ({CARD})")
    del batch, outs
    torch.cuda.empty_cache()

    settings, chps, batch = convert.make_gen2_inputs(2048, device=dev, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    wall = _median_step(lambda: _gen2_step(batch, chps, settings).sum().item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_trig = int((_gen2_step(batch, chps, settings) > 0).sum())
    print(f"phase 6 kernel path at 2048 groups (the whole file): step {wall * 1e3:.1f} ms "
          f"(median of 5), {2048 / wall:.1f} events/s, peak device memory {peak:.2f} GiB, "
          f"{n_trig} groups triggered ({CARD})")
    del batch
    torch.cuda.empty_cache()

    for bire in (True, False):
        placement.launches = placement.reduce_launches = 0
        t0 = time.perf_counter()
        res = convert.gen2_simulation(
            str(INPUT_GEN2), {"propagation": {"birefringence": bire}}, chunk_size=1024,
            device=dev, dtype=torch.float64).run()
        wall = time.perf_counter() - t0
        print(f"phase 6 Simulation float64, birefringence {bire}: "
              f"{res['n_triggered']} of {len(res['triggered'])} groups triggered, Veff "
              f"{res['veff'] / units.km ** 3:.5f} km^3, launches kernel 1 "
              f"{placement.launches}, kernel 4 {placement.reduce_launches}, "
              f"{wall:.2f} s with set-up ({CARD})")
        used = placement.reduce_launches if bire else placement.launches
        if used < 1 or res["n_triggered"] < 1 or not np.isfinite(res["veff"]):
            raise AssertionError(f"the float64 gen2 Simulation (birefringence {bire}) failed")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full FP32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    global CARD
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(CARD)
    print(f"phase 0 torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
        info = _build.build_info[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"phase 1 built {name} in {info['seconds']:.1f} s: " + " | ".join(ptxas))
    print(f"phase 1 build total {time.perf_counter() - t0:.1f} s")

    summary = {**phase_kernels(dev), **phase_pa_kernel(dev)}
    launches = phase_headline(dev)
    phase_simulation(dev)
    pa_launches = phase_pa(dev)
    gen2_launches = phase_gen2(dev)
    # launches: the counts of the three main-path runs (phases 3, 5 and 6)
    for counts in (pa_launches, gen2_launches):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    replaces = {"placement_chain": "nuradiomc_tpu/ops/placement_pallas.py:452; "
                                   "nuradiomc_tpu/ops/placement_pallas.py:209",
                "irfft_trigger": "nuradiomc_tpu/ops/trigger_pallas.py:172",
                "pa_trigger": "nuradiomc_tpu/ops/pa_pallas.py:181",
                "placement_reduce": "nuradiomc_tpu/ops/placement_pallas.py:512"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"nuradiomc_tpu_torch/csrc/{name}.cu",
                "replaces": replaces[name], "launches": launches[name], **summary[name]}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
