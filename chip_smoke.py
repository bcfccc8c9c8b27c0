"""Build the port's CUDA kernels and drive its main paths once on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 2       # phases 0-1 and those named (2 to 17,
    python3 chip_smoke.py --phases 8,9     # comma-separated), no result line
    python3 chip_smoke.py --phases 10      # the production-scale campaign alone
    python3 chip_smoke.py --phases 11      # processes sharing the card, the muon campaign
    python3 chip_smoke.py --phases 12      # the in-ice reconstruction path
    python3 chip_smoke.py --phases 13      # ray solvers, noise-rate tuning, hardware modules
    python3 chip_smoke.py --phases 14      # the cosmic-ray side (LOFAR, RIT, CoREAS, cleaning)
    python3 chip_smoke.py --phases 15      # the recorded-data side (RNO-G runs, measured noise)
    python3 chip_smoke.py --phases 16      # the BGR18-weighted campaign
    python3 chip_smoke.py --phases 17      # the repository's example workflows
    python3 chip_smoke.py --phases trigger # phases 0-1 and kernel 2's part of phase 2

Phases (any failure raises, so the script exits non-zero and prints no
result line):

0. the card's name and power limit (nvidia-smi), torch and CUDA versions;
1. build the seven kernels from nuradiomc_tpu_torch/csrc/ (sm_90a), one
   nvcc per source, started together (the ray solver, the Earth's chord
   integral and the birefringence scan with -fmad=false);
2. each kernel against its plain PyTorch version on the card at its path's
   shapes, float32 and float64 (kernel 2 also at the sizes a real station
   brings: 8 columns x 24 channels, n_base 8192, 17 columns in two launches,
   and the multi-trigger path's 9 columns at 16384 x C 4, decisions equal in
   every group), with CUDA-event timings beside the kernel's
   bound (the larger of its bytes over the memory rate and its operations
   over the card's peak rate for the dtype, computed from this run's
   inputs) and, for kernels 2, 3 and 4, the time of their transforms
   through ``torch.fft`` on the same inputs (a yardstick the port never
   calls), and the launch grid of each kernel at the paths' shapes: kernel 2
   also at the gen2 path's 256 and 2048 groups x C 2 and, reported without a
   gate, at a second input seed (razor margins); kernel 1 also at s2 20 and
   40 (multi-shower groups), kernel 4 at the gen2 path's shape and at the
   profiling tool's (with its no-phase variant); kernel 3 also reports,
   without a gate, how many ADC samples take another count in the kernel
   than in the plain version (an FFT and a dense product round a sample
   near a count boundary to either side), and runs at 1024 groups x C 24
   (float64) and x C 64 (float32, float64), where a group is split over a
   thread-block cluster (the cluster size printed), decisions and first
   frames equal to the plain version's (float64: in every group); the ray
   solver (``raytrace.find_solutions``) on the dipole cell's 100,000 pairs
   a step, float32 and float64, n_bisect 96 (timed) and 28, every field of
   every slot equal to ``find_solutions_plain``'s bit for bit; the Earth's
   chord integral (``ops.earth_slant``, float64) at 2,048 (a deep
   phased-array job's) and 16,384 chords of 16,384 samples, both Earth
   models, within 1e-13 relative of the numpy copy
   (``EarthModel.slant_depth``, timed on the host as its plain version),
   two launches bit-identical; the birefringence segment scan
   (``birefringence.segment_scan``) at the gen2 cell's shapes (12,288 paths
   from the ray solver, 256 points, F 513), float32 and float64, bit-equal
   to ``segment_scan_plain`` (a difference reported against 1e-5 / 1e-14 of
   each path's largest amplitude), timed beside the plain loop and its
   bound;
3. the headline (dipole Veff) slice: 65536 groups of the bench workload
   through ``simulate_batch`` (placement + trigger kernels), held to the
   per-group ``veff_trig`` pin of tests/golden/bench_pins.npz (at most 56
   flips) and to the plain path on the same card (identical decisions),
   with its events/s and the device's busy share in a torch.profiler
   window (as phases 5 and 6);
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
   birefringence, float32 (``convert.make_gen2_inputs``, kernels 4 and 2,
   the scan kernel once a station):
   the per-group station counts against the ``gen2_trig`` pin (at most 8
   flips), the kernel path against the plain path, events/s at 256 and at
   2048 groups (the whole file) with peak device memory, and the whole file
   through ``Simulation`` in float64 with birefringence on (kernel 4 and
   the scan kernel) and off (the factored chain: kernel 1 at s2 20), held to the JAX package's
   groups and Veff;
7. the multi-trigger station (kernels 1, 2 and 3): the three-trigger station
   of ``convert.multitrigger_simulation`` through ``Simulation`` in float64,
   per-trigger sets equal to the JAX package's float64 sets and within one
   borderline group per name of NuRadioMC's; one 16384-group step
   (``convert.make_multitrigger_inputs``, float32, noise on) with an 8-rung
   high/low ladder, a threshold trigger on channels (0, 1) and the phased
   array: one launch of each kernel, the kernel path against the plain path
   with the same noise (at most 8 (group, trigger) decisions differ, each
   within 1e-3 of a threshold), its events/s and busy share, and the step
   with numeric focusing; the 3000-event dipole input behind a separate
   trigger chain in float64 with NuRadioMC's triggered set and trigger Vrms;
8. the reflective-bottom (Moore's Bay) slice: 16384 groups x 2 showers x 4
   LPDAs x 6 ray slots (``convert.make_mooresbay_inputs``: one bottom
   reflection, MB1 attenuation, three readout windows, float32, band limit
   1e-2) through ``simulate_batch``: kernels 1 (s2 12) and 2 once per
   window, the kernel path against the plain path (at most 8 groups differ,
   each within 1e-3 of a threshold), how many groups fire and how many only
   through a bounce slot, its events/s and busy share, kernels 1 and 2
   event-timed on the first window's own operands with bound and library
   time, and the first 2048 groups in float64 against the JAX package's
   float64 set (``nuradiomc_tpu_torch/data/mooresbay_jax_sets.npz``);
9. the rest of the signal chain through ``Simulation`` in float64, each held
   to the JAX package's set (the ``*_jax_sets.npz`` files the tests write):
   the 24-pulser emitter inputs (efield and voltage variant, kernel 4), the
   dipole station with a synthetic antenna table (kernel 4), ARZ2020 on the
   mini shower library (kernel 1) and GL1 attenuation (kernel 1), each with
   its triggered count and one timed step;
10. NuRadioMC's production-scale campaign (test/Veff/1e18eV) on the card,
   without files or h5py: (a) the 50,000-event seed-10 list generated in
   memory by the port's ``evtgen``, its digest equal to the golden's
   ``input_sha1``; (b) ``convert.fullscale_simulation`` in float64 with
   ``.nur`` output: the golden's 203 triggered groups, weight sum and
   Veff*4pi 5.77715 km^3 sr at rtol 1e-6, wall time from input to Veff and
   events/s, kernels 1 and 2 held to their plain versions on the run's own
   launches with time, bound and library time; (c) the same in float32 at
   the headline settings (symmetric difference printed, no gate; kernels 1
   and 2 held as in (b)); (d) the ``.nur`` of (b) read back (one 1 GHz
   event per triggered group), and the 3000-event dipole input's ``.nur``
   (kernels 1 and 2 held as in (b)): the 7 traces of NuRadioMC's waveform
   golden at 2% of peak on its readout grid, trigger times to 1 ns, and
   against the JAX package's ``keep_traces`` traces at 1e-6 of peak (5e-4
   where a refracted ray is valid) from
   ``nuradiomc_tpu_torch/data/e2e_waveforms_reference.npz``; (e) the noisy
   deep phased-array campaign (10,000 events, digest equal to its golden's)
   in float64 inside its statistical bands, kernels 1 and 3 held to their
   plain versions, its ``core_mantle_crust`` weights integrated by the chord
   kernel (one launch); (f) the Gen2 tau list regenerated with stochastic
   secondaries equal to its export;
11. processes sharing the card (``parallel.dryrun.spawn``: gloo, one rank
   per process, started after phase 1's build), each run against its
   single-process twin on the card in float64, equal bit for bit: (a) the
   3000-event dipole golden through ``Simulation(mesh=)`` on (2,1), (2,2)
   and (4,1) meshes with its triggered set and Veff 0.22978 km^3; (b) the
   ``parallel/dryrun.py`` list on (2,2), noise off and on; (c) the noisy
   phased-array campaign's first 2048 groups on (2,2), its four channels
   split over the channel axis (kernel 3 on the mesh path); (d) a ``Runner``
   streaming ``evtgen`` batches through the mesh ``Simulation`` to a trigger
   budget, stopped after two batches and resumed to the uninterrupted
   state; kernels 1, 2 and 3 held to their plain versions on recorded
   launches of the mesh runs; (e) NuRadioMC's 2500-muon Aeff campaign
   (test/atmospheric_Aeff/1e18eV) in one process, its set equal to the JAX
   package's (``nuradiomc_tpu_torch/data/surface_muons_jax_sets.npz``) and
   Aeff within 0.45027 +- 2 x 0.06549 km^2; the wall time and events/s of
   every run beside its twin's;
12. the in-ice reconstruction path (the ray solver alone; float64): (a)
   NuRadioReco's three ``.nur`` files in tests/golden read by the port's
   ``io_nur.EventReader``, the waveform golden's traces bit-equal to
   ``data/e2e_waveforms_reference.npz``, each file written by the port's
   ``eventWriter`` and read back equal; (b) examples/03's chain (fold,
   noise seed 42, band-pass, observables, unfold) on the card and the CPU,
   within 1e-9 of each trace's peak, the same noise draws; (c) the
   travel-time tables of run_reco_chain.py's 7 antenna depths at the
   package defaults (3,680,125 points each, 25.8M ray solves) with their
   seconds, solves/s, chunk and peak memory, 1/64 of each table re-solved on
   the CPU (slot validity equal but for refracted rays at the turning point,
   travel times within 1e-6 relative, those rays within 1e-5; the witness:
   the card's re-solve of the sample equal to its table, and the CPU's
   travel time at the card's own root c0 within 1e-6 for every entry), and
   the 3D vertex within tests/test_vertex.py's bounds and equal to the CPU's
   from the card's tables; (d) the neutrino direction
   at the defaults (20 x 20 x 16, two zooms, GL1) with its triples/s and 256
   chi2 values within 1e-9 of the CPU's, and on the example's 9 x 9 x 9 grid
   within tests/test_nu_direction.py's bounds; (e) the correlation and
   beam-forming fitters at their default grids giving the same direction on
   card and CPU, the IFT unfolding's 600 Adam steps at tests/test_ift_efield.py's
   135 deg (an LPDA phase-sector edge) within 1e-6 of the CPU's spectrum and
   within that test's bounds, a warm call's time and a profiled step's
   kernels, and the trigger
   modules and the RNO-G surface trigger on the events of (a) with the same
   decisions, times and channels;
13. the ray solvers beyond the analytic one, the noise-trigger-rate tuning
   and the RNO-G hardware modules (float64 unless named): (a)
   tests/test_noise_rate.py's 4-channel phased array behind its 8-bit ADC,
   2^20 noise traces in float32 (traces/s, beam windows/s, the 100 Hz
   threshold beside the reference's 30.85 Vrms^2, the rate curve
   monotone), and 8192 traces drawn on the card transformed there and on
   the CPU (maxima within 1e-9); (b) the stratified numeric solver on
   65,536 firn pairs (pair solves/s, float32 reported only), 1024 against
   the CPU (masks equal, within 1e-9; rays turning near the firn's segment
   boundary or just above the receiver within 1e-3, reported apart); (c)
   the RK4 loop in CUDA graphs equal to eager launches bit for bit, then
   tests/test_raytrace_3d.py's cases at their full settings (ds 1 m, 3000-
   6000 steps, a fan of 90, 30 bisections) against the port's analytic
   solver at that test's tolerances, and its tilted field's 6-step Newton
   polish, seconds each; (d) 100k ice-to-air pairs (solves/s) against the
   CPU within 1e-9; (e) the analytic LPDA's phase sector on its edges (135
   deg arrivals, the IFT geometry): the card's step-by-step differences
   from the CPU measured, then ``simulate_batch``'s sectors equal to the
   CPU's and the JAX package's (``data/lpda_sector_jax_sets.npz``), kernels
   1 and 2 held to their plain versions on the run's launches; (f) the
   cosmic-ray templates on the card against the CPU within 1e-10;
14. the cosmic-ray side (float64, no kernel of the five): (a) LOFAR's six
   superterp stations (48 dual-polarised antennas, 65,536 samples at 200
   MHz, a plane-wave pulse, two CW lines; ``convert.make_lofar_stations``)
   through stationRFIFilter (blocks of 8192), stationGalacticCalibrator,
   stationPulseFinder, planeWaveDirectionFitter and
   beamformingDirectionFitter (15 x 15, 4 zoom levels, chunked over
   directions), with each module's seconds, the beam search's directions/s,
   chunk and peak memory; station 0 again on the CPU: dirty channels,
   reference antenna and good antennas equal, phase stability within
   1e-12, calibrated spectra within 1e-12 of peak, pulse windows equal,
   SNRs within 1e-9, every zoom level's grid powers within 1e-10 and the
   same chosen point; every station's fits within tests/test_lofar.py's 2
   deg (plane wave) and 1.5 deg (beam search) of the injected direction;
   (b) tests/test_rit.py's line emitter at 240 antennas over +-400 m: X_RIT
   (within 30 g/cm^2 of the truth) and the shower axis at five depths
   (within 0.45 deg, the core within 60 m) with points/s, the longitudinal
   profile and one 7 x 7 lateral plane against the CPU within 1e-9 (a point
   whose summed-grid length differs between the devices printed and
   excused); (c) a 160-observer CoREAS star read through the mapping path
   onto 100 random cores (seed 3) of tests/test_coreas_readers.py's
   four-LPDA station, folded, with galactic (192 pixels) and ice thermal
   noise and the energy estimator, the first 8 cores against the CPU: the
   spectra after each adder within 1e-12 of peak from the same host draws,
   the energy within 1e-10; (d) the CW notch, stop filter and readout-window
   cutter on station 0 of (a), card against CPU within 1e-12 of peak;
15. the recorded-data side (float64, no kernel of the five; launches
   asserted 0): (a) four RNO-G runs of 1024 events x 24 channels x 2048
   samples (``convert.make_rnog_runs``: band-limited ADC noise, block
   offsets, LAB4D scrambles, PA pulses on the LT events) written as
   ``.npz`` and read back (timed apart), through ``dataProviderRNOG`` (block
   offsets and glitch statistic a chunk at a time on the card, then cable
   delays) with events/s, rows per chunk, peak memory and one chunk's
   device time and busy share; every event against the CPU's run: traces
   within 1e-12 of peak, offsets within 1e-9 of the trace's std, start
   times, fit branches and glitch flags equal (the flags also counted
   against the injected scrambles); ``stationHitFilter`` and
   ``stationCoherentlySummedWaveforms`` on the LT events, hit times and
   decisions equal, SNR, impulsivity and kurtosis within 1e-10, entropy
   within 1e-14 (an event whose summed waveform's histogram differs
   between the devices is excused and counted, and its card entropy is
   held within 1e-14 to numpy's of the card's own summed waveform); (b) ``RNOGNoiseImporter``
   (seeded) from (a)'s FORCE events onto 4096 simulated station-11 events,
   draws equal to the CPU's, noisy traces within 1e-12 of peak (the noise
   carries each device's block-offset fit), ``triggerSimulatorHighLow`` on
   channels 0-3 with equal decisions, and ``ARIANNANoiseImporter`` from a
   2048 x 8 x 256 CalibTree export onto 4096 events, draws and traces equal
   bit for bit, events/s of each; (c) the ARA and ARIANNA-Calib readers on
   300-event files and every antenna preprocessor on its raw pattern file,
   each table read by ``table_vel`` at 1000 directions x 512 frequencies on
   the card within 1e-12 of the CPU;
16. the BGR18/HEDIS cross-section path (float64): tests/test_bgr18.py's
   synthetic table (dsigma/dy = A(E) y^-0.7, 21 energies x 200 y, six
   flavors, nc/cc; ``convert.make_bgr18_table``) written to a temporary
   directory and set with ``set_bgr18_table_path``; (a) phase 10's 50,000
   events (its volume, 1e18 eV, seed 10) generated with
   ``cross_sections_model="hedis_bgr18"``: the cc fraction within 0.02 of
   the table's cc/(cc+nc) and the median inelasticity within 4 standard
   errors of 0.5^(1/(B+1)); (b) the list through
   ``convert.fullscale_simulation`` with ``hedis_bgr18`` weights: events/s,
   triggered groups, Veff, peak memory, kernels 1 and 2 launched and held
   to their plain versions on the run's own launches; (c) the first 3,000
   event groups on the card and on the CPU: triggered sets equal, Veff at
   rtol 1e-9; (d) the BGR18 weights of the list differ from its CTW
   weights and lie in [0, 1];
17. the repository's example workflows (``nuradiomc_tpu_torch.examples``,
   one module per JAX script of ``examples/``, in the registry's order) at
   the JAX scripts' default sizes on the card: 01's 10,000-event list, its
   float32 Veff and table; 02's noisy phased array and 09's five-rung
   ladder on that list; 13's webinar chain (1000 events, two triggers, noise,
   ``.nur``); 10's 24-pulser emitter sweep (kernel 4); 11's five-station
   grid at 400 events; 05 on a mesh of 8 gloo processes sharing the card;
   08's ``.nur`` round trip; 15's list; 12's flux limit; 06's deep phased
   array on 1000 events with the FLOWER board, surface trigger and cleaning
   chain; 07's SNR curves (200 trials); 14's three Nyquist zones (120
   trials); 03's chain and 04's fits at the script's settings. The card has
   no h5py: lists and outputs take the ``.npz`` route each example prints.
   Per example its wall time, events/s or trials/s, peak device memory and
   kernel launches; each run held to the same example on the CPU (a long list
   cut to its first 1000 groups): float64 noiseless runs equal (Veff rel
   1e-9; 01 and 09 rerun in float64 on those groups at every rung), float32
   decisions of 01 and 09 differing in at most 2 groups per rung, noisy
   counts and efficiencies within 4 binomial sigma (14's card trials at the
   CPU run's threshold), 14's maxima on the card's own draws within 1e-9 on
   the CPU with the same SNR50, deterministic host steps equal; 04 on card
   and CPU at the registry's quick search (20 m tables; phase 12 holds the
   default tables to the CPU). Kernels 1-4 must each launch, and each is
   held to its plain version on one of the examples' own launches.

Every printed time carries the card's name and power limit. The line before
the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from nuradiomc_tpu_torch.utils import units  # noqa: E402
from nuradiomc_tpu_torch.framework.base_trace import BaseTrace  # noqa: E402
from nuradiomc_tpu_torch import convert  # noqa: E402
from nuradiomc_tpu_torch.convert import make_headline_inputs  # noqa: E402
from nuradiomc_tpu_torch.models import ice as ice_models  # noqa: E402
from nuradiomc_tpu_torch.ops import (_build, birefringence, earth_slant,  # noqa: E402
                                     fft_plan, noise, pa_trigger, phased_array, placement,
                                     raytrace, trigger_fused)
from nuradiomc_tpu_torch.sim import pipeline  # noqa: E402
from nuradiomc_tpu_torch.sim import io_input  # noqa: E402
from nuradiomc_tpu_torch.sim.io_input import (DATA_DIR, INPUT_1E18_N3000,  # noqa: E402
                                              INPUT_EMITTER_EFIELD, INPUT_EMITTER_VOLTAGE,
                                              INPUT_GEN2, INPUT_PA_NOISELESS)

N_GROUPS = 65536
FLIP_BOUND = 56          # bench.py:130, veff_trig
PIN = os.path.join(HERE, "tests", "golden", "bench_pins.npz")
E2E_GOLDEN = os.path.join(HERE, "tests", "golden", "e2e_reference.npz")
MT_GOLDEN = os.path.join(HERE, "tests", "golden", "e2e_multitrigger_reference.npz")
TC_GOLDEN = os.path.join(HERE, "tests", "golden", "e2e_trigger_channels_reference.npz")
PA_GROUPS = 16384        # bench.py:390
PA_SOURCE_FLIPS = 6      # bench.py:132, pa_nl_trig, counted per source event
PA_NOISY = (107, 249)    # bench.py:80 and :197-199, 178 +- 40%
PA_CROSS_GROUPS = 8      # bench.py:451
GEN2_GROUPS = 256        # bench.py:575
GEN2_FLIPS = 8           # bench.py:135, gen2_trig
# the whole tau file through the JAX package's float64 Simulation: (groups
# triggered, Veff in km^3) with and without birefringence
GEN2_FILE = {True: (279, 3.17311), False: (280, 3.39605)}
# the JAX package's float64 per-trigger sets of the three-trigger station
# (written by python tests/test_torch_multitrigger.py)
MT_JAX_SETS = DATA_DIR / "multitrigger_jax_sets.npz"
MB_GROUPS = 16384        # the Moore's Bay slice
# the JAX package's float64 sets of phases 8 and 9 (each written by the test
# file of its path when run as a script)
MB_JAX_SETS = DATA_DIR / "mooresbay_jax_sets.npz"
EMITTER_JAX_SETS = DATA_DIR / "emitter_jax_sets.npz"
TABLE_JAX_SETS = DATA_DIR / "antenna_table_jax_sets.npz"
ARZ_JAX_SETS = DATA_DIR / "arz_jax_sets.npz"
GL1_JAX_SETS = DATA_DIR / "gl1_jax_sets.npz"
# NuRadioMC's production-scale campaigns (phase 10) and, for the waveforms,
# the reference's 7 traces and the JAX package's keep_traces traces (written
# by python tests/test_torch_nur_output.py)
FULLSCALE_GOLDEN = os.path.join(HERE, "tests", "golden", "veff_fullscale_reference.npz")
FULLSCALE_PA_GOLDEN = os.path.join(HERE, "tests", "golden", "veff_fullscale_pa_reference.npz")
WAVEFORMS_REF = DATA_DIR / "e2e_waveforms_reference.npz"
KERNELS = ("placement_chain", "irfft_trigger", "pa_trigger", "placement_reduce", "ray_solver",
           "earth_slant", "birefringence_scan")
# the dipole cell's pairs a step (50,000 groups x 2 showers x 1 channel)
RAY_PAIRS = 100_000
# the gen2 cell's valid paths a station and chunk, and its birefringence scan's
# points a path and frequencies
BIRE_PATHS, BIRE_POINTS, BIRE_FREQS = 12_288, 256, 513
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
            W, templates)
    return args, dict(s2=s2, df=2.0 / n_base, n_int=n_int, n_base=n_base, K_place=K_place)


def _trigger_inputs(dtype, dev, gen, G=N_GROUPS, C=1, K=816, n_base=2048, T=1):
    """Kernel-2 inputs, by default at the headline shapes: 65536 groups x 1
    channel, K_base 816, n_base 2048 (gen2: C 2, K 1025), the high/low
    trigger of both paths (10-bin high/low window, 400-bin majority window);
    band-limited noise spectra, thresholds 2-3 sigma so groups both fire and
    do not. With T > 1 the columns are a ladder (each 0.1 sigma above the
    last) of high/low triggers, every third a threshold trigger on the first
    half of the channels (the others' thresholds +inf, as the pipeline passes
    a channel subset)."""
    R = G * C
    I_r, I_i = fft_plan.irfft_dense(n_base, K, dtype, dev)
    scale = 2.0 / np.sqrt(2.0)
    spec_re = torch.randn(R, K, generator=gen, device=dev, dtype=dtype)
    spec_im = torch.randn(R, K, generator=gen, device=dev, dtype=dtype)
    sigma = float(((spec_re[:256] @ I_r + spec_im[:256] @ I_i) * scale).std())
    del I_r, I_i
    th = sigma * (2.0 + 1.0 * torch.rand(R, T, generator=gen, device=dev, dtype=dtype)
                  + 0.1 * torch.arange(T, device=dev, dtype=dtype))
    trig = []
    for t in range(T):
        if t % 3 == 2:
            trig.append(trigger_fused.TriggerSpecStatic("simple_threshold", 1, 200, min(C, 2)))
            if C > 2:
                th[(torch.arange(R, device=dev) % C) >= (C + 1) // 2, t] = float("inf")
        else:
            trig.append(trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1 + (t % 2) * (C > 1)))
    return (spec_re, spec_im, th, -th), dict(n_base=n_base, scale=scale, triggers=tuple(trig),
                                             C=C)


HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA's data sheet)
# the card's peak for each dtype (NVIDIA's data sheet, SXM): float32 on the
# CUDA cores, float64 on the FP64 tensor cores (its highest float64 rate)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def _bound(nbytes, flops, dtype):
    """(bound ms, what sets it): the larger of the bytes the function must
    move over the memory rate and its operations over the card's peak rate
    for its dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rfft_flops(n):
    """Operations of a real FFT of length n through the half-length complex
    one: 5 L log2 L for the L-point transform, ~10 per point for the
    Hermitian step."""
    L = fft_plan.complex_length(n)
    return 5 * L * math.log2(max(L, 2)) + 10 * L


def _padded_rfft_flops(n_in, n):
    """Operations of a real FFT of length n whose input is zero past its
    first n_in samples. Where n = P n_in with P even, bin P m + r is bin m of
    an n_in-point complex FFT of the input times a twiddle ramp; the real
    input makes the transforms of r and P - r conjugates, so P/2 such FFTs
    (5 n_in log2 n_in each) and their ramps (2 per sample) suffice.
    Otherwise the full transform."""
    P = n // n_in
    if n % n_in or P < 2 or P % 2:
        return _rfft_flops(n)
    return P // 2 * (5 * n_in * math.log2(n_in) + 2 * n_in)


def _placement_chain_bound(args, kw):
    """Kernel 1: every row's mask is read; an unmasked row's spectra,
    attenuation nodes, scalars and offset are read, chained, placed by a
    real inverse FFT of n_int and a forward FFT of n_base pruned to its
    n_int nonzero inputs, and phase-summed (masked rows add nothing: this
    run's data needs only the unmasked ones); W and the templates are read
    once; each output row is written once."""
    spec_re, _, att, _, _, mask, _, _, W, tpl = args
    e = spec_re.element_size()
    R, K_int = spec_re.shape
    n_sparse, K_place = att.shape[1], kw["K_place"]
    live = int(mask.sum())
    nbytes = (R + live * (2 * K_int * e + n_sparse * e + 3 * e + 4) + W.numel() * e
              + tpl.numel() * 2 * e + (R // kw["s2"]) * K_place * 2 * e)
    flops = live * (K_int * (2 * n_sparse + 14) + _rfft_flops(kw["n_int"])
                    + _padded_rfft_flops(kw["n_int"], kw["n_base"]) + 14 * K_place
                    + 20 * (32 + K_place / 32))
    return _bound(nbytes, flops, spec_re.dtype)


def _trigger_bound(args, kw):
    """Kernel 2: each row's K bins and thresholds read once, one real inverse
    FFT of n_base and the trigger logic per row, the three outputs written."""
    spec_re, _, th_hi, _ = args
    e = spec_re.element_size()
    R, K = spec_re.shape
    T, G = th_hi.shape[1], R // kw["C"]
    nbytes = R * K * 2 * e + 2 * th_hi.numel() * e + G * T * 5 + R * e
    flops = R * (_rfft_flops(kw["n_base"]) + kw["n_base"] * (2 + 6 * T))
    return _bound(nbytes, flops, spec_re.dtype)


def _reduce_bound(args, kw):
    """Kernel 4: every row read once (a zero row is known only by reading
    it), the offsets of the nonzero ones; each nonzero row placed by a real
    inverse FFT of n_int and a forward FFT of n_base pruned to its n_int
    nonzero inputs, phase-ramped (without ``phase=False``) and summed (zero
    rows add nothing: this run's data needs only the nonzero ones); each
    output row written once."""
    v_re, v_im, _ = args
    e = v_re.element_size()
    R, K_int = v_re.shape
    K_place = kw["K_place"]
    live = int(((v_re != 0) | (v_im != 0)).any(dim=1).sum())
    epilogue = 14 * K_place + 20 * (32 + K_place / 32) if kw.get("phase", True) else 2 * K_place
    nbytes = R * K_int * 2 * e + live * e + (R // kw["s2"]) * K_place * 2 * e
    flops = live * (_rfft_flops(kw["n_int"]) + _padded_rfft_flops(kw["n_int"], kw["n_base"])
                    + epilogue)
    return _bound(nbytes, flops, v_re.dtype)


def _pa_bound(args, kw):
    """Kernel 3: each row's K bins read once, the small outputs written once;
    per row a real inverse FFT of n_base and its maximum, the decimated trace
    (the fold, about 2 K adds, and a real inverse FFT of n_dec; or an inverse
    of n_hi where decim does not divide it), the ADC, a forward real FFT of
    n_dec and an inverse one of n_up; per group B beams of n_up samples from C
    channels (B n_up (C + 1): the sums and the squares) and B n_frames window
    sums of ``window`` samples."""
    spec_re = args[0]
    e = spec_re.element_size()
    R, K = spec_re.shape
    C, B = kw["C"], len(kw["rolls"])
    G = R // C
    n_base, n_hi, decim, up = kw["n_base"], kw["n_hi"], kw["decim"], kw["up"]
    n_dec = pa_trigger.n_dec_of(n_hi, decim)
    n_up = n_dec * up
    n_frames = (n_up - kw["window"]) // kw["step"]
    nbytes = R * K * 2 * e + G * 5 + R * e
    dec = 2 * K + _rfft_flops(n_dec) if n_hi % decim == 0 else _rfft_flops(n_hi)
    ups = 0 if up == 1 else _rfft_flops(n_dec) + _rfft_flops(n_up)
    flops = (R * (_rfft_flops(n_base) + n_base + dec + 6 * n_dec + ups)
             + G * B * (n_up * (C + 1) + n_frames * kw["window"]))
    return _bound(nbytes, flops, spec_re.dtype)


def _entry(max_abs, ms, plain_ms, bound, library_ms=None):
    """One kernel's line of the summary JSON."""
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], share_of_bound=bound[0] / ms, library_ms=library_ms)


def _check_placement(label, kernel, plain, args, kw, tol, bound=None, phase="phase 2"):
    """A placement kernel (1 or 4) against its plain version: the worst
    |kernel - plain| over each output row's peak must stay within ``tol``;
    returns (max abs error, kernel ms, plain ms), timed only with a bound
    (ms, what sets it) to print beside the times, else the times None."""
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
    if bound is not None:
        ms = _median_ms(lambda: kernel(*args, **kw))
        plain_ms = _median_ms(lambda: plain(*args, **kw))
        times = (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
                 f"({bound[1]}), {bound[0] / ms:.1%} of the bound ({CARD})")
    print(f"{phase} {label}: max |kernel - plain| / row peak = {worst:.3e} "
          f"(limit {tol:g}), max abs {max_abs:.3e}{times}")
    if not worst <= tol:
        raise AssertionError(f"{label} disagrees with its plain version: {worst:.3e}")
    return max_abs, ms, plain_ms


def _check_trigger(label, args, kw, tol_amp, phase="phase 2"):
    """Kernel 2 against its plain version: fired and first bins identical,
    amplitudes within ``tol_amp`` relative and exactly 0 where the plain
    version's is 0; timed beside its plain version,
    its bound and ``torch.fft.irfft`` of the same spectra (the irfft stage
    alone, a yardstick the port never calls); returns the summary entry."""
    before = trigger_fused.launches
    k, p = (f(*args, **kw) for f in (trigger_fused.fused_irfft_trigger,
                                      trigger_fused.fused_irfft_trigger_plain))
    torch.cuda.synchronize()
    n_launches = trigger_fused.launches - before
    G, T = p[0].shape
    d_fired, d_first = int((k[0] != p[0]).sum()), int((k[1] != p[1]).sum())
    # a channel without a pulse has a zero spectrum, whose inverse FFT is
    # exactly 0: there the kernel's amplitude must be 0 too, not merely small
    zero = p[2] == 0
    d_zero = int((zero & (k[2] != 0)).sum())
    den = torch.where(zero, torch.ones_like(p[2]), p[2].abs())
    amp_rel = float(((k[2] - p[2]).abs() / den)[~zero].max()) if not bool(zero.all()) else 0.0
    amp_abs = float((k[2] - p[2]).abs().max())
    ms = _median_ms(lambda: trigger_fused.fused_irfft_trigger(*args, **kw))
    plain_ms = _median_ms(lambda: trigger_fused.fused_irfft_trigger_plain(*args, **kw))
    spec_c = torch.complex(args[0], args[1]) * kw["scale"]    # scaled outside the timing
    lib_ms = _median_ms(lambda: torch.fft.irfft(spec_c, n=kw["n_base"]))
    del spec_c
    bound = _trigger_bound(args, kw)
    print(f"{phase} {label}: fired differ in {d_fired} of {G} groups x {T} triggers "
          f"({int(p[0].sum())} fired, {n_launches} launches), first bins differ in {d_first}, "
          f"amp max rel err {amp_rel:.3e} (limit {tol_amp:g}; {int(zero.sum())} rows without "
          f"a pulse, {d_zero} of them not exactly 0 in the kernel); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library irfft "
          f"{lib_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of "
          f"the bound ({CARD})")
    if d_fired or d_first or d_zero or not amp_rel <= tol_amp:
        raise AssertionError(f"{label} disagrees with the plain version")
    if T and not 0 < int(p[0].sum()) < G * T:
        raise AssertionError(f"{label}: the inputs do not exercise both decisions")
    return _entry(amp_abs, ms, plain_ms, bound, lib_ms)


def _reduce_inputs(dtype, dev, gen, R, s2, K_int=257, K_place=1025):
    """Kernel-4 inputs: a voltage spectrum [R, K_int] with a third of the
    rows zero (masked solutions), offsets over the time base's 768 ns of
    headroom, the 512 -> 2048 placement (band limit off)."""
    keep = (torch.rand(R, 1, generator=gen, device=dev) < 0.67).to(dtype)
    v_re = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    v_im = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    offs = torch.rand(R, generator=gen, device=dev, dtype=dtype) * 768.0
    return (v_re, v_im, offs), dict(s2=s2, df=2.0 / 2048, n_int=512, n_base=2048,
                                    K_place=K_place)


def _reduce_library_ms(args, kw):
    """``torch.fft`` yardstick of kernel 4: rfft(irfft(V, n_int), n_base)
    bins < K_place, without the phase and the sum (V made outside the
    timing)."""
    V = torch.complex(args[0], args[1])
    ms = _median_ms(lambda: torch.fft.rfft(torch.fft.irfft(V, n=kw["n_int"]),
                                           n=kw["n_base"])[:, :kw["K_place"]])
    del V
    return ms


def _print_grids():
    """The grids the FFT kernels launch at the paths' shapes: persistent
    blocks, as many as fit on the card, at most one per group (kernels 2
    and 3) or output row (kernels 1 and 4). A group's channels meet in one
    block's shared memory, so 256 groups launch at most 256 blocks: fewer
    than two on each of the card's SMs."""
    lib2 = _build.load("irfft_trigger")
    lib1 = _build.load("placement_chain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib2.irfft_trigger_smem_bytes.restype = ctypes.c_long
    for label, (G, C, n_base, K, T) in {
            "headline 65536 x C 1": (65536, 1, 2048, 816, 1),
            "gen2 256 x C 2": (256, 2, 2048, 1025, 1),
            "gen2 2048 x C 2": (2048, 2, 2048, 1025, 1),
            "multi-trigger 16384 x C 4, 9 columns": (PA_GROUPS, 4, 2048, 512, 9),
            "24-channel station, 8 columns": (1024, 24, 2048, 1025, 8),
            "n_base 8192 x C 4, 2 columns": (1024, 4, 8192, 4097, 2)}.items():
        grids = [lib2.irfft_trigger_grid(G, C, n_base, K, T, f64) for f64 in (0, 1)]
        smem = [lib2.irfft_trigger_smem_bytes(C, n_base, K, T, f64) for f64 in (0, 1)]
        fills = ["yes" if g >= 2 * sms else "no" for g in grids]
        print(f"phase 2 irfft_trigger grid at {label}: {grids[0]} blocks float32, "
              f"{grids[1]} float64, on {sms} SMs; at least two blocks on every SM: "
              f"{fills[0]} / {fills[1]}; shared memory {smem[0]} / {smem[1]} bytes a block")
    grids = [lib1.placement_chain_grid(65536, 208, 24, 816, 512, 2048, f64) for f64 in (0, 1)]
    print(f"phase 2 placement_chain grid at the headline's 65536 output rows: {grids[0]} "
          f"blocks float32, {grids[1]} float64, on {sms} SMs")
    lib4 = _build.load("placement_reduce")
    for label, G_out in {"gen2 path's 512": GEN2_GROUPS * 2, "tool shape's 65536": 65536}.items():
        grids = [lib4.placement_reduce_grid(G_out, 257, 1025, 512, 2048, f64) for f64 in (0, 1)]
        print(f"phase 2 placement_reduce grid at the {label} output rows: {grids[0]} blocks "
              f"float32, {grids[1]} float64, on {sms} SMs")
    lib3 = _build.load("pa_trigger")
    grids = [lib3.pa_trigger_grid(PA_GROUPS, 4, 512, 2048, 5120, 10, 2, 11, f64)
             for f64 in (0, 1)]
    smem = [lib3.pa_trigger_smem_bytes(4, 512, 2048, 5120, 10, 2, 11, f64) for f64 in (0, 1)]
    print(f"phase 2 pa_trigger grid at the phased-array path's {PA_GROUPS} groups x C 4: "
          f"{grids[0]} blocks float32, {grids[1]} float64, on {sms} SMs; shared memory "
          f"{smem[0]} / {smem[1]} bytes a block")


def _check_trigger_shapes(dtype, dev, gen, tag, tol_amp):
    """Kernel 2 against its plain version at the paths' shapes (the headline's
    and gen2's, timed with bound and library irfft) and at the sizes a real
    station brings: 8 and 17 trigger columns (17: more than one launch
    takes), 24 channels, n_base 8192, and the multi-trigger path's 9 columns
    at 16384 x C 4; returns the headline shape's summary entry."""
    args, kw = _trigger_inputs(dtype, dev, gen)
    entry = _check_trigger(f"irfft_trigger {tag}", args, kw, tol_amp)
    del args
    for G in (GEN2_GROUPS, 2048):
        args, kw = _trigger_inputs(dtype, dev, gen, G=G, C=2, K=1025)
        _check_trigger(f"irfft_trigger {tag} gen2 {G} x C 2", args, kw, tol_amp)
        del args
    # another input seed: where a trace sample lies within rounding of a
    # threshold, the FFT and the dense product may round it to either
    # side, so a decision or first bin may differ; reported, not a gate
    gen3 = torch.Generator(device=dev)
    gen3.manual_seed(3)
    args, kw = _trigger_inputs(dtype, dev, gen3)
    k, p = (f(*args, **kw) for f in (trigger_fused.fused_irfft_trigger,
                                      trigger_fused.fused_irfft_trigger_plain))
    print(f"phase 2 irfft_trigger {tag} at input seed 3 (razor margins, no gate): fired "
          f"differ in {int((k[0] != p[0]).sum())} of {N_GROUPS} groups, first bins in "
          f"{int((k[1] != p[1]).sum())}")
    del args, k, p
    torch.cuda.empty_cache()
    gen_new = torch.Generator(device=dev)
    gen_new.manual_seed(20261017)
    for label, shape in {
            "T 8, 1024 x C 24": dict(G=1024, C=24, K=1025, T=8),
            "n_base 8192, 1024 x C 4, T 2": dict(G=1024, C=4, K=4097, n_base=8192, T=2),
            "T 17 (two launches), 2048 x C 4": dict(G=2048, C=4, K=816, T=17),
            f"multi-trigger path, {PA_GROUPS} x C 4, T 9": dict(G=PA_GROUPS, C=4, K=512, T=9),
    }.items():
        args, kw = _trigger_inputs(dtype, dev, gen_new, **shape)
        _check_trigger(f"irfft_trigger {tag} {label}", args, kw, tol_amp)
        del args
        torch.cuda.empty_cache()
    return entry


def _ray_pairs(n, dtype, dev, seed=20261018):
    """(x1y, x1z, x2y, x2z) of ``raytrace.to_2d`` for n vertices of the
    dipole cell (r < 4 km, -2.7 km < z < 0) against a VPol at -100 m."""
    rng = np.random.default_rng(seed)
    r, phi = 4000.0 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    x1 = torch.as_tensor(np.stack([r * np.cos(phi), r * np.sin(phi),
                                   rng.uniform(-2700.0, 0.0, n)], -1), dtype=dtype, device=dev)
    x2 = torch.tensor([0.0, 0.0, -100.0], dtype=dtype, device=dev).expand(n, 3)
    g = raytrace.to_2d(x1, x2)
    return g.x1y, g.x1z, g.x2y, g.x2z


def _pointwise_ops(fn, *args):
    """The output elements of the ATen pointwise ops of ``fn(*args)`` (a
    transcendental, a compare, a select and a complex product count one
    each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                self.ops += (out[0] if isinstance(out, (tuple, list)) else out).numel()
            return out

    with Count() as c:
        fn(*args)
    return c.ops


@functools.lru_cache(maxsize=4)
def _ray_solver_ops(n_bisect):
    """Operations a pair of ``find_solutions_plain`` at ``n_bisect``: its
    pointwise operations (``_pointwise_ops``) over 64 pairs on the CPU, per
    pair; every loop count is fixed, so the count does not depend on the
    pairs."""
    xs = [t.cpu().double() for t in _ray_pairs(64, torch.float64, "cpu")]
    return _pointwise_ops(raytrace.find_solutions_plain, *xs, ice_models.southpole_2015,
                          n_bisect) / 64


def _ray_solver_bound(n_pairs, dtype, n_bisect):
    """The ray solver: the plain version's pointwise operations a pair
    (``_ray_solver_ops``), against its four inputs read and both slots'
    outputs (six floats, a mask byte, three int32) written once."""
    e = torch.empty((), dtype=dtype).element_size()
    return _bound(n_pairs * (4 * e + 2 * (6 * e + 1 + 3 * 4)),
                  n_pairs * _ray_solver_ops(n_bisect), dtype)


def _check_ray_solver(label, args, kw, phase="phase 2", timed=True):
    """The ray solver (``raytrace.find_solutions``, one launch) against
    ``find_solutions_plain`` on the same operands: every field of every slot
    equal bit for bit, NaN where the plain version gives NaN (the kernel is
    built without FMA contraction and writes each operation as ATen does on
    the card). With ``timed``, timed beside the plain version and its bound.
    Returns the summary entry (times None untimed)."""
    before = raytrace.launches
    k = raytrace.find_solutions(*args, **kw)
    p = raytrace.find_solutions_plain(*args, **kw)
    torch.cuda.synchronize()
    if raytrace.launches != before + 1:
        raise AssertionError(f"{label}: {raytrace.launches - before} launches, not one")
    n_pairs, dtype = p.c0.numel() // 2, p.c0.dtype
    n_bisect = args[5] if len(args) > 5 else kw.get("n_bisect", 96)
    differ, max_abs = {}, 0.0
    for name in p._fields:
        a, b = getattr(k, name), getattr(p, name)
        same = a == b
        if a.is_floating_point():
            same |= a.isnan() & b.isnan()
            if bool(p.mask.any()):
                max_abs = max(max_abs, float((a - b)[p.mask].abs().max()))
        if not bool(same.all()):
            differ[name] = int((~same).sum())
    n_valid = int(p.mask.sum())
    ms = plain_ms = None
    times = ""
    bound = _ray_solver_bound(n_pairs, dtype, n_bisect)
    if timed:
        ms = _median_ms(lambda: raytrace.find_solutions(*args, **kw))
        plain_ms = _median_ms(lambda: raytrace.find_solutions_plain(*args, **kw), n_warm=1,
                              n_runs=3)
        times = (f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
                 f"({bound[1]}: {_ray_solver_ops(n_bisect):.0f} operations a pair), "
                 f"{bound[0] / ms:.1%} of the bound ({CARD})")
    print(f"{phase} {label}: {n_pairs} pairs, {n_valid} valid slots, {dtype}, n_bisect "
          f"{n_bisect}; fields not bit-equal to the plain version's: {differ or 'none'}, max "
          f"|kernel - plain| over valid slots {max_abs:.3e}{times}")
    if differ:
        raise AssertionError(f"{label}: the ray solver differs from its plain version in "
                             f"{differ}")
    if not 0 < n_valid:
        raise AssertionError(f"{label}: no valid slot")
    return _entry(max_abs, ms, plain_ms, bound) if timed else None


def _earth_slant_ops(n_samples, n_shells):
    """Float64 operations a chord of the chord integral, counted as the
    numpy copy computes it: a sample's point (t dist, three products, three
    sums), radius (three products, two sums, a square root), shell (a
    compare a shell), density (a division, three products, three sums, a
    select); a term's difference, sum, product and halving and the running
    sum; the final product by dist."""
    return n_samples * (7 + 6 + n_shells + 8) + (n_samples - 1) * 5 + 1


def _earth_slant_bound(n_chords, n_samples, n_shells):
    """The chord integral: its operations (``_earth_slant_ops``) against a
    chord's endpoint, direction and distance read and its result written
    (64 bytes), and the sample positions read once."""
    return _bound(64 * n_chords + 8 * n_samples,
                  n_chords * _earth_slant_ops(n_samples, n_shells), torch.float64)


def _check_earth_slant(dev, phase="phase 2"):
    """The Earth's chord integral (``earth_slant.integrate``, one launch) on
    chords drawn like the deep phased-array cell's list (vertices at r < 3
    km, -2 km < z < 0, isotropic directions), 16,384 samples a chord, at
    2,048 chords (a job's) and 16,384, CORE_MANTLE_CRUST and PREM: within
    1e-13 relative of ``EarthModel.slant_depth`` on the first 2,048 chords,
    zero where it is zero, two launches bit-identical; the kernel timed by
    CUDA events beside its bound, the numpy copy on the host as its plain
    version (2,048 chords), and the host wall of the whole ``slant_depth``
    (prelude, copies, launch, read-back). Returns the summary entry of
    CORE_MANTLE_CRUST at 2,048 chords (``max_abs_err`` in the port's units
    of column density)."""
    from nuradiomc_tpu_torch.sim import earth_attenuation

    n_samples, n_check, n_max = 16384, 2048, 16384
    rng = np.random.default_rng(20261018)
    r = 3e3 * np.sqrt(rng.uniform(0, 1, n_max))
    az = rng.uniform(0, 2 * np.pi, n_max)
    vertex = np.c_[r * np.cos(az), r * np.sin(az), rng.uniform(-2e3, 0, n_max)]
    theta = np.arccos(rng.uniform(-1, 1, n_max))
    phi = rng.uniform(0, 2 * np.pi, n_max)
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    ts = torch.as_tensor(np.linspace(0.0, 1.0, n_samples), device=dev)
    entry = None
    for model in ("CORE_MANTLE_CRUST", "PREM"):
        earth = getattr(earth_attenuation, model)
        t0 = time.perf_counter()
        want = earth.slant_depth(vertex[:n_check], d[:n_check], n_samples=n_samples)
        plain_ms = (time.perf_counter() - t0) * 1e3
        zero = want == 0
        for n_chords in (n_check, n_max):
            args = [torch.as_tensor(a, device=dev)
                    for a in earth_slant.chords(earth, vertex[:n_chords], d[:n_chords])]
            before = earth_slant.launches
            got = [earth_slant.integrate(earth, *args, ts).cpu().numpy() for _ in range(2)]
            if earth_slant.launches != before + 2:
                raise AssertionError(f"earth_slant: {earth_slant.launches - before} launches, "
                                     f"not two")
            g = got[0][:n_check]
            rel = float((np.abs(g - want)[~zero] / want[~zero]).max())
            max_abs = float(np.abs(g - want).max())
            ms = _median_ms(lambda: earth_slant.integrate(earth, *args, ts))
            t0 = time.perf_counter()
            earth_slant.slant_depth(earth, vertex[:n_chords], d[:n_chords], n_samples=n_samples,
                                    device=dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            bound = _earth_slant_bound(n_chords, n_samples, len(earth.radii))
            same = got[0].tobytes() == got[1].tobytes()
            print(f"{phase} earth_slant {model} {n_chords} chords x {n_samples} samples, float64: "
                  f"worst relative difference to the numpy copy (first {n_check} chords) "
                  f"{rel:.3e}, two launches bit-identical: {same}; kernel {ms:.4f} ms, numpy "
                  f"copy {plain_ms:.1f} ms ({n_check} chords, host), slant_depth host wall "
                  f"{wall_ms:.3f} ms (prelude, copies, launch, read-back), bound "
                  f"{bound[0]:.4f} ms ({bound[1]}: "
                  f"{_earth_slant_ops(n_samples, len(earth.radii))} operations a chord), "
                  f"{bound[0] / ms:.1%} of the bound ({CARD})")
            if not same or rel > 1e-13 or not np.array_equal(g == 0, zero):
                raise AssertionError(f"earth_slant {model} {n_chords}: not within 1e-13 of the "
                                     f"numpy copy, or launches differ")
            if model == "CORE_MANTLE_CRUST" and n_chords == n_check:
                entry = _entry(max_abs, ms, plain_ms, bound)
            del args, got
    return entry


@functools.lru_cache(maxsize=4)
def _birefringence_scan_ops(n_seg, n_freq):
    """Operations a path of ``segment_scan_plain`` at ``n_seg`` segments and
    ``n_freq`` frequencies: its pointwise operations (``_pointwise_ops``) on
    one path on the CPU; every op is per path, so the count scales with the
    paths."""
    spec = torch.ones(1, n_freq, dtype=torch.complex128)
    seg = torch.full((1, n_seg), 0.5, dtype=torch.float64)
    ok = torch.ones(1, n_seg, dtype=torch.bool)
    ff = torch.linspace(0.0, 1.0, n_freq, dtype=torch.float64)
    return _pointwise_ops(birefringence.segment_scan_plain, spec, spec, seg, seg, seg, seg, seg,
                          ok, ff)


def _birefringence_scan_bound(n_paths, n_seg, n_freq, dtype):
    """The segment scan: the plain version's pointwise operations
    (``_birefringence_scan_ops``) against both spectra read and written once,
    the five real segment arrays and ``ok`` read once and the frequencies."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = n_paths * (4 * n_freq * 2 * e + n_seg * (5 * e + 1)) + n_freq * e
    return _bound(nbytes, n_paths * _birefringence_scan_ops(n_seg, n_freq), dtype)


def _check_birefringence_scan(dev, phase="phase 2"):
    """The birefringence segment scan (``birefringence.segment_scan``, one
    launch) against ``segment_scan_plain`` at the gen2 cell's shapes: 12,288
    valid paths from the ray solver to the cell's deep VPols, 256 points a
    path, F 513, float32 and float64; bit-equal, every difference reported
    against the limits 1e-5 / 1e-14 of each path's largest amplitude; timed
    beside the plain loop and the bound, with the launch grid. Returns the
    float64 summary entry (the cell's dtype)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entry = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-14)):
        tag = str(dtype).replace("torch.", "")
        path = convert.gen2_birefringence_paths(BIRE_PATHS, n_points=BIRE_POINTS, device=dev,
                                                dtype=dtype)
        args = convert.make_birefringence_scan_inputs(path, n_freq=BIRE_FREQS)
        del path
        before = birefringence.launches
        k = birefringence.segment_scan(*args)
        p = birefringence.segment_scan_plain(*args)
        torch.cuda.synchronize()
        if birefringence.launches != before + 1:
            raise AssertionError(f"birefringence_scan: {birefringence.launches - before} "
                                 f"launches, not one")
        amp = torch.maximum(p[0].abs().amax(-1), p[1].abs().amax(-1))[:, None]
        gap = max(float(((a - b).abs() / amp).max()) for a, b in zip(k, p))
        max_abs = max(float((a - b).abs().max()) for a, b in zip(k, p))
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        n_bits = sum(int((a != b).sum()) for a, b in zip(k, p))
        finite = all(bool(torch.isfinite(a).all()) for a in k)
        del k, p
        n_seg = args[2].shape[-1]
        ms = _median_ms(lambda: birefringence.segment_scan(*args))
        plain_ms = _median_ms(lambda: birefringence.segment_scan_plain(*args))
        bound = _birefringence_scan_bound(BIRE_PATHS, n_seg, BIRE_FREQS, dtype)
        smem = 6 * n_seg * torch.empty((), dtype=dtype).element_size()
        print(f"{phase} birefringence_scan {tag}: {BIRE_PATHS} paths x {n_seg} segments "
              f"({int(args[7].sum())} valid) x F {BIRE_FREQS}; bit-equal to the plain loop: "
              f"{same} ({n_bits} complex elements differ), worst |kernel - plain| over a "
              f"path's largest amplitude {gap:.3e} (limit {tol:.0e}), max abs {max_abs:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}: {_birefringence_scan_ops(n_seg, BIRE_FREQS)} operations a path), "
              f"{bound[0] / ms:.1%} of the bound; grid {BIRE_PATHS} blocks of 128 on {sms} "
              f"SMs, {smem} B shared a block ({CARD})")
        if not same or not finite:
            raise AssertionError(f"birefringence_scan {tag}: not bit-equal to the plain loop "
                                 f"({gap:.3e} of a path's largest amplitude, limit {tol:.0e}), "
                                 f"or not finite")
        if dtype == torch.float64:
            entry = _entry(max_abs, ms, plain_ms, bound)
        del args
        torch.cuda.empty_cache()
    return entry


def phase_kernels(dev):
    """Kernel vs plain version on the card, with each kernel's bound and (for
    kernel 2) the library irfft's time; returns the float32 summary (the ray
    solver's in float64, the benchmark cells' dtype)."""
    _print_grids()
    summary = {}
    for dtype, tol_place, tol_amp in ((torch.float32, 1e-4, 1e-5),
                                      (torch.float64, 1e-10, 1e-12)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261016)
        tag = str(dtype).replace("torch.", "")

        args, kw = _placement_inputs(dtype, dev, gen)
        bound = _placement_chain_bound(args, kw)
        max_abs, ms, plain_ms = _check_placement(
            f"placement_chain {tag}", placement.chain_placement_reduce,
            placement.chain_placement_reduce_plain, args, kw, tol_place, bound)
        if dtype == torch.float32:
            summary["placement_chain"] = _entry(max_abs, ms, plain_ms, bound)
        del args
        entry = _check_trigger_shapes(dtype, dev, gen, tag, tol_amp)
        if dtype == torch.float32:
            summary["irfft_trigger"] = entry

        for s2 in (20, 40):
            # multi-shower groups (tau secondaries): an output row sums s2 rows
            args, kw = _placement_inputs(dtype, dev, gen, G_out=2560, s2=s2)
            _check_placement(f"placement_chain {tag} s2 {s2} ({2560 * s2} rows)",
                             placement.chain_placement_reduce,
                             placement.chain_placement_reduce_plain, args, kw, tol_place)
            del args

        R_gen2 = GEN2_GROUPS * 2 * 20
        print(f"phase 2 placement_reduce shapes: gen2 path R {R_gen2}, s2 20, "
              f"K_int 257, K_place 1025 (band limit 0); tool R 262144, s2 4")
        args, kw = _reduce_inputs(dtype, dev, gen, R_gen2, 20)
        bound = _reduce_bound(args, kw)
        max_abs, ms, plain_ms = _check_placement(
            f"placement_reduce {tag} gen2 shape", placement.placement_reduce,
            placement.placement_reduce_plain, args, kw, tol_place, bound)
        lib_ms = _reduce_library_ms(args, kw)
        print(f"phase 2 placement_reduce {tag} gen2 shape: library rfft(irfft(V, n_int), "
              f"n_base) {lib_ms:.3f} ms ({CARD})")
        if dtype == torch.float32:
            summary["placement_reduce"] = _entry(max_abs, ms, plain_ms, bound, lib_ms)
        del args
        args, kw = _reduce_inputs(dtype, dev, gen, 262144, 4)
        _check_placement(f"placement_reduce {tag} tool shape", placement.placement_reduce,
                         placement.placement_reduce_plain, args, kw, tol_place,
                         _reduce_bound(args, kw))
        no_phase = {**kw, "phase": False}
        _check_placement(f"placement_reduce {tag} tool shape, no phase (matmul_only)",
                         placement.placement_reduce, placement.placement_reduce_plain,
                         args, no_phase, tol_place, _reduce_bound(args, no_phase))
        print(f"phase 2 placement_reduce {tag} tool shape: library rfft(irfft(V, n_int), "
              f"n_base) {_reduce_library_ms(args, kw):.3f} ms ({CARD})")
        del args
        ray_args = (*_ray_pairs(RAY_PAIRS, dtype, dev), ice_models.southpole_2015)
        entry = _check_ray_solver(f"ray_solver {tag} dipole pairs", ray_args, {"n_bisect": 96})
        _check_ray_solver(f"ray_solver {tag} dipole pairs", ray_args, {"n_bisect": 28},
                          timed=False)
        if dtype == torch.float64:
            summary["ray_solver"] = entry
        del ray_args
        torch.cuda.empty_cache()
    summary["earth_slant"] = _check_earth_slant(dev)
    summary["birefringence_scan"] = _check_birefringence_scan(dev)
    return summary


def _device_busy(step):
    """(device kernel ms, profiled wall ms, kernels) of one call of ``step``
    under torch.profiler, after one warm call; the kernel ms is None when the
    profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, wall, 0
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, wall, len(kernels)


def _print_busy(label, step, median_ms):
    dev_ms, wall, n = _device_busy(step)
    if dev_ms is None:
        print(f"{label} device busy share: not measured (the profiler saw no device "
              f"activity); profiled wall {wall:.1f} ms")
        return
    print(f"{label} device busy share: {dev_ms:.2f} ms of device kernels ({n} kernels) in a "
          f"profiled step of {wall:.1f} ms = {dev_ms / wall:.1%}; against the unprofiled "
          f"median step {median_ms:.1f} ms = {dev_ms / median_ms:.1%} ({CARD})")


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

    placement.launches = trigger_fused.launches = raytrace.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.simulate_batch(batch, ch, settings)
    trig = out.triggered.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = {"placement_chain": placement.launches,
                "irfft_trigger": trigger_fused.launches, "ray_solver": raytrace.launches}
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
        wall = _median_step(lambda: step(s))
        print(f"phase 3 {name} path: step {wall * 1e3:.1f} ms (median of 5), "
              f"{N_GROUPS / wall:.1f} events/s ({CARD})")
        if name == "kernel":
            _print_busy("phase 3 kernel path", lambda: step(s), wall * 1e3)
    return launches


def _pa_kernel_inputs(dtype, dev, gen, G=PA_GROUPS, C=4):
    """Kernel-3 inputs at the bench shapes: 16384 groups x 4 channels,
    K_base 512, n_base 2048, n_hi 5120 and decim 10 (n_dec 512, the 0.5 GHz
    ADC), x2 upsampling (n_up 1024), the 11 beams of a vertical array at 1 m
    spacing, window 16, step 8; band-limited noise spectra and an ADC range
    of 15 counts per noise Vrms, as the workload. ``G`` and ``C`` give
    other group and channel counts at the same widths."""
    K, n_base, n_hi, decim = 512, 2048, 5120, 10
    spec = noise.bandlimited_noise_spectrum(
        gen, (G * C,), n_base, 2.0, torch.tensor(1e-5, dtype=dtype, device=dev),
        dtype=dtype)[:, :K]
    spec_re, spec_im = spec.real.contiguous(), spec.imag.contiguous()
    scale_dec = 5.0 / np.sqrt(2.0)
    Dd_r, Dd_i = fft_plan.decimate_dense(n_base, n_hi, decim, K, dtype, dev)
    vrms = float(((spec_re[:4096] @ Dd_r + spec_im[:4096] @ Dd_i) * scale_dec).std())
    adc_range = vrms * 255 / 15
    rolls = phased_array.beam_rolls([-197.0 - i for i in range(C)], [1051.0] * C,
                                    phased_array.default_angles, 1.75, 1.0)
    return (spec_re, spec_im), dict(
        n_base=n_base, n_hi=n_hi, decim=decim, up=2, scale_full=2.0 / np.sqrt(2.0),
        scale_dec=scale_dec, rolls=rolls, window=16, step=8, v_min=-adc_range / 2,
        lsb=adc_range / 255, n_counts=256, C=C)


def _adc_kw(kw):
    """The keywords of ``pa_trigger.adc_plain`` among kernel 3's."""
    return {k: kw[k] for k in ("n_base", "n_hi", "decim", "scale_dec", "v_min", "lsb",
                               "n_counts")}


def _pa_library_ms(args, kw):
    """``torch.fft`` yardstick of kernel 3: its three transforms,
    irfft(X, n_base), irfft(X, n_hi)[..., ::decim] and irfft(rfft(q),
    n_up), without the ADC, the beams and the windows (X and the plain
    version's quantized trace q made outside the timing)."""
    X = torch.complex(args[0], args[1])
    q = pa_trigger.adc_plain(*args, **_adc_kw(kw))[1]
    n_up = q.shape[1] * kw["up"]

    def transforms():
        torch.fft.irfft(X, n=kw["n_base"])
        torch.fft.irfft(X, n=kw["n_hi"])[..., ::kw["decim"]]
        torch.fft.irfft(torch.fft.rfft(q), n=n_up)

    ms = _median_ms(transforms)
    del X, q
    return ms


def _pa_adc_differences(args, kw):
    """ADC samples whose count differs between the kernel (its diagnostic
    output) and the plain version, and the number of samples."""
    ref = pa_trigger.adc_plain(*args, **_adc_kw(kw))[0].to(torch.int32)
    counts = torch.empty_like(ref)
    pa_trigger.fused_pa_trigger(*args, threshold=float("inf"), adc_counts=counts, **kw)
    n = int((counts != ref).sum())
    del ref, counts
    return n, args[0].shape[0] * pa_trigger.n_dec_of(kw["n_hi"], kw["decim"])


def phase_pa_kernel(dev):
    """Kernel 3 vs its plain version at the bench shapes, at a threshold
    where most groups fire and one where few do; returns the float32
    summary. The kernel's FFTs and the plain version's dense products round
    an ADC sample near a count boundary to either side, and the plain power
    sum is a cumsum difference where the kernel's is a direct sum, so a
    decision may differ only within 1e-4 of the threshold."""
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
        n_diff, n_samples = _pa_adc_differences(args, kw)
        print(f"phase 2 pa_trigger {tag}: {n_diff} of {n_samples} ADC samples take another "
              f"count in the kernel than in the plain version (no gate)")
        ms = _median_ms(lambda: pa_trigger.fused_pa_trigger(*args, threshold=thr, **kw))
        plain_ms = _median_ms(lambda: pa_trigger.fused_pa_trigger_plain(
            *args, threshold=thr, **kw))
        lib_ms = _pa_library_ms(args, kw)
        bound = _pa_bound(args, kw)
        print(f"phase 2 pa_trigger {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"(median of 10), library transforms {lib_ms:.3f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}), {bound[0] / ms:.1%} of the bound ({CARD})")
        if dtype == torch.float32:
            summary["pa_trigger"] = _entry(amp_abs, ms, plain_ms, bound, lib_ms)
        del args
        torch.cuda.empty_cache()
    return summary


def phase_pa_large(dev):
    """Kernel 3 beyond one block's shared memory: 1024 groups x C 64 in
    float32 and float64 and x C 24 in float64, where a group's C upsampled
    traces are split over a thread-block cluster; fired and the first frame
    equal to the plain version's in every group (float32: except within
    1e-4 of the threshold, phase 2's rule, with the count printed), amp
    within phase 2's tolerance; timed beside the plain version, its bound
    and the library transforms, with the cluster size."""
    for C, dtype, tol_amp in ((24, torch.float64, 1e-12), (64, torch.float32, 1e-5),
                              (64, torch.float64, 1e-12)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261017 + C)
        tag = f"1024 x C {C} {str(dtype).replace('torch.', '')}"
        args, kw = _pa_kernel_inputs(dtype, dev, gen, G=1024, C=C)
        k = pa_trigger.cluster_size(C, args[0].shape[1], kw["n_base"], kw["n_hi"], kw["decim"],
                                    kw["up"], len(kw["rolls"]), dtype)
        lib = _build.load("pa_trigger")
        grid = lib.pa_trigger_grid(1024, C, args[0].shape[1], kw["n_base"], kw["n_hi"],
                                   kw["decim"], kw["up"], len(kw["rolls"]),
                                   int(dtype == torch.float64))
        smem = lib.pa_trigger_smem_bytes(C, args[0].shape[1], kw["n_base"], kw["n_hi"],
                                         kw["decim"], kw["up"], len(kw["rolls"]),
                                         int(dtype == torch.float64))
        print(f"phase 2 pa_trigger {tag}: a cluster of {k} blocks a group, {smem} bytes of "
              f"shared memory a block, grid {grid} blocks")
        if k < 2:
            raise AssertionError(f"pa_trigger {tag}: expected a cluster beyond one block")
        max_power = pa_trigger.fused_pa_trigger_plain(*args, threshold=float("inf"), **kw)[3]
        for q in (0.3, 0.9):
            thr = float(torch.quantile(max_power, q))
            kf, kframe, _ = pa_trigger.fused_pa_trigger(*args, threshold=thr, **kw)
            pf, pframe, _, _ = pa_trigger.fused_pa_trigger_plain(*args, threshold=thr, **kw)
            torch.cuda.synchronize()
            d_fired = int((kf != pf).sum())
            d_frame = int(((kframe != pframe) & kf & pf).sum())
            print(f"phase 2 pa_trigger {tag} threshold at quantile {q}: {int(pf.sum())} of 1024 "
                  f"fire, fired differs in {d_fired}, frames differ in {d_frame} groups")
            if dtype == torch.float64 and (d_fired or d_frame):
                raise AssertionError(f"pa_trigger {tag}: decisions differ from the plain version")
            _check_pa_call(f"pa_trigger {tag} at quantile {q}", args,
                           {**kw, "threshold": thr}, tol_amp, "phase 2")
        del args, max_power
        torch.cuda.empty_cache()


def _triggered_groups(res):
    return set(int(g) for g in res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)])


def phase_simulation(dev):
    """The 3000-event dipole golden through ``Simulation`` on the card, from
    the .npz export of its input, float64 and float32 (bench settings)."""
    golden = np.load(E2E_GOLDEN)
    ref = set(int(g) for g in np.unique(golden["group_ids"]))
    placement.launches = trigger_fused.launches = raytrace.launches = 0
    t0 = time.perf_counter()
    res = convert.dipole_simulation(str(INPUT_1E18_N3000), chunk_size=1024, device=dev,
                                    dtype=torch.float64).run()
    wall = time.perf_counter() - t0
    mine = _triggered_groups(res)
    veff = res["veff"] / units.km ** 3
    launches = (placement.launches, trigger_fused.launches, raytrace.launches)
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

    placement.launches = pa_trigger.launches = raytrace.launches = 0
    torch.cuda.synchronize()
    out = pipeline.simulate_batch(batch, ch, settings, noise_generator=generator())
    trig = out.triggered.cpu().numpy()
    launches = {"placement_chain": placement.launches, "pa_trigger": pa_trigger.launches,
                "ray_solver": raytrace.launches}
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
        wall = _median_step(lambda: step(s))
        print(f"phase 5 {name} path, noisy step: {wall * 1e3:.1f} ms (median of 5), "
              f"{PA_GROUPS / wall:.1f} events/s ({CARD})")
        if name == "kernel":
            _print_busy("phase 5 kernel path", lambda: step(s), wall * 1e3)
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
    raytrace.launches = birefringence.launches = 0
    torch.cuda.synchronize()
    outs = [pipeline.simulate_batch(batch, ch, settings) for ch in chps]
    vec = sum(o.triggered.long() for o in outs).cpu().numpy()
    launches = {"placement_chain": placement.launches,
                "placement_reduce": placement.reduce_launches,
                "irfft_trigger": trigger_fused.launches, "ray_solver": raytrace.launches,
                "birefringence_scan": birefringence.launches}
    print(f"phase 6 launches in the main-path run: {launches}")
    if min(launches["placement_reduce"], launches["irfft_trigger"],
           launches["ray_solver"]) < 1 or launches["birefringence_scan"] != len(chps):
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
        if name == "kernel":
            _print_busy("phase 6 kernel path (256 groups)",
                        lambda: _gen2_step(batch, chps, settings).sum().item(), wall * 1e3)
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
    _print_busy("phase 6 kernel path (2048 groups)",
                lambda: _gen2_step(batch, chps, settings).sum().item(), wall * 1e3)
    del batch
    torch.cuda.empty_cache()

    for bire in (True, False):
        placement.launches = placement.reduce_launches = birefringence.launches = 0
        t0 = time.perf_counter()
        res = convert.gen2_simulation(
            str(INPUT_GEN2), {"propagation": {"birefringence": bire}}, chunk_size=1024,
            device=dev, dtype=torch.float64).run()
        wall = time.perf_counter() - t0
        print(f"phase 6 Simulation float64, birefringence {bire}: "
              f"{res['n_triggered']} of {len(res['triggered'])} groups triggered, Veff "
              f"{res['veff'] / units.km ** 3:.5f} km^3, launches kernel 1 "
              f"{placement.launches}, kernel 4 {placement.reduce_launches}, scan "
              f"{birefringence.launches}, {wall:.2f} s with set-up ({CARD})")
        used = (min(placement.reduce_launches, birefringence.launches) if bire
                else placement.launches)
        want = GEN2_FILE[bire]
        got = (int(res["n_triggered"]), round(float(res["veff"] / units.km ** 3), 5))
        if used < 1 or got != want:
            raise AssertionError(f"the float64 gen2 Simulation (birefringence {bire}) gave "
                                 f"{got}, the JAX package {want}")
    return launches


def _nearest_threshold_margin(seen, trig_list, g, col, C):
    """How close group ``g``'s trigger traces come to trigger ``col``'s
    thresholds: min over its channels and samples of |v / threshold - 1|
    (both thresholds for a high/low trigger), from the spectra the plain
    fused trigger was given."""
    (spec_re, spec_im, th_hi, th_lo), kw = seen
    hl = [i for i, t in enumerate(trig_list) if t.trigger_type != "phased_array"]
    j = hl.index(col)
    rows = slice(g * C, (g + 1) * C)
    I_r, I_i = fft_plan.irfft_dense(kw["n_base"], spec_re.shape[1], spec_re.dtype,
                                    spec_re.device)
    v = (spec_re[rows] @ I_r + spec_im[rows] @ I_i) * kw["scale"]
    hi, lo = th_hi[rows, j, None], th_lo[rows, j, None]
    near = (v / hi - 1.0).abs()
    if trig_list[col].trigger_type == "high_low":
        near = torch.minimum(near, (v / lo - 1.0).abs())
    else:
        near = torch.minimum(near, (v / -hi - 1.0).abs())
    return float(near[~torch.isinf(hi[:, 0])].min())


def phase_multitrigger(dev):
    """The multi-trigger station path (kernels 1, 2 and 3); returns the launch
    counts of the main-path run (one noisy ``simulate_batch`` step)."""
    import dataclasses

    # (a) three named triggers through Simulation, float64, on the .npz input
    golden = np.load(MT_GOLDEN)
    pin = np.load(MT_JAX_SETS)
    names = [n.decode() for n in golden["trigger_names"]]
    t0 = time.perf_counter()
    sim = convert.multitrigger_simulation(str(INPUT_PA_NOISELESS), chunk_size=1024,
                                          device=dev, dtype=torch.float64)
    res = sim.run()
    wall = time.perf_counter() - t0
    if res["trigger_names"] != names:
        raise AssertionError(f"trigger names {res['trigger_names']}, the golden {names}")
    ok = res["weights"] >= 1e-5
    for i, name in enumerate(names):
        mine = set(int(g) for g in res["group_ids"][res["multiple_triggers"][:, i] & ok])
        ref = set(int(g) for g in np.unique(golden["group_ids"][golden["multiple_triggers"][:, i]]))
        jax_set = set(int(g) for g in pin[name])
        print(f"phase 7 three-trigger station float64, {name}: {len(mine)} groups; against "
              f"NuRadioMC extra {sorted(mine - ref)} missing {sorted(ref - mine)} (at most one "
              f"borderline group); against the JAX package's float64 set {len(mine ^ jax_set)} "
              f"differ")
        if len(mine ^ ref) > 1 or mine != jax_set:
            raise AssertionError(f"the multi-trigger golden does not hold for {name}")
    print(f"phase 7 three-trigger station: {wall:.2f} s with set-up ({CARD})")

    # (b) one step with an 8-rung ladder, a subset threshold and the phased array
    settings, ch, batch = convert.make_multitrigger_inputs(PA_GROUPS, device=dev,
                                                           dtype=torch.float32)
    trig_list = settings.triggers
    T, C = len(trig_list), ch.positions.shape[0]

    def generator():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    placement.launches = trigger_fused.launches = pa_trigger.launches = raytrace.launches = 0
    torch.cuda.synchronize()
    out = pipeline.simulate_batch(batch, ch, settings, noise_generator=generator())
    per = out.triggered_per.cpu().numpy()
    launches = {"placement_chain": placement.launches, "irfft_trigger": trigger_fused.launches,
                "pa_trigger": pa_trigger.launches, "ray_solver": raytrace.launches}
    print(f"phase 7 launches in the main-path run ({T} triggers: "
          f"{[t.name for t in trig_list]}): {launches}")
    if launches != {"placement_chain": 1, "irfft_trigger": 1, "pa_trigger": 1, "ray_solver": 1}:
        raise AssertionError(f"the multi-trigger step launches {launches}, not one of each")
    if (per.shape != (PA_GROUPS, T) or tuple(out.max_amplitude.shape) != (PA_GROUPS, C)
            or not bool(torch.isfinite(out.max_amplitude).all())
            or not bool(torch.isfinite(out.trigger_times_per).all())):
        raise AssertionError("multi-trigger output has the wrong shape or is not finite")
    counts = per.sum(axis=0)
    print(f"phase 7 noisy step: groups triggered per trigger {counts.tolist()} of {PA_GROUPS}")
    ladder = counts[:8]
    if not (np.all(np.diff(ladder) <= 0) and 0 < ladder[-1] < ladder[0]):
        raise AssertionError(f"the threshold ladder's counts do not fall: {ladder.tolist()}")

    plain = dataclasses.replace(settings, placement_impl="plain", trigger_impl="plain")
    seen_pa, seen_hl = [], []
    pa_plain, hl_plain = pa_trigger.fused_pa_trigger_plain, trigger_fused.fused_irfft_trigger_plain

    def recording_pa(*args, **kw):     # keeps the plain path's max beam power
        result = pa_plain(*args, **kw)
        seen_pa.append((result[3], kw["threshold"]))
        return result

    def recording_hl(*args, **kw):     # keeps the plain path's trigger spectra
        seen_hl.append((args, kw))
        return hl_plain(*args, **kw)

    pa_trigger.fused_pa_trigger_plain = recording_pa
    trigger_fused.fused_irfft_trigger_plain = recording_hl
    per_plain = pipeline.simulate_batch(
        batch, ch, plain, noise_generator=generator()).triggered_per.cpu().numpy()
    pa_trigger.fused_pa_trigger_plain = pa_plain
    trigger_fused.fused_irfft_trigger_plain = hl_plain
    max_power, thr = seen_pa[0]
    pa_margin = ((max_power - thr).abs() / thr).cpu().numpy()
    differ = []
    for g, col in np.argwhere(per_plain != per).tolist():
        if trig_list[col].trigger_type == "phased_array":
            differ.append((g, col, float(pa_margin[g])))
        else:
            differ.append((g, col, _nearest_threshold_margin(seen_hl[0], trig_list, g, col, C)))
    print(f"phase 7 kernel path vs plain path, same noise: {len(differ)} (group, trigger) "
          f"decisions differ (bound {PA_CROSS_GROUPS}), nearest-threshold margins "
          f"{[(g, c, '%.2e' % m) for g, c, m in differ]}")
    if len(differ) > PA_CROSS_GROUPS or any(m >= 1e-3 for _, _, m in differ):
        raise AssertionError("kernel and plain multi-trigger paths differ beyond razor margins")
    del seen_pa, seen_hl, max_power

    def step(s):
        pipeline.simulate_batch(batch, ch, s, noise_generator=generator()).triggered.sum().item()

    numeric = dataclasses.replace(settings, focusing_mode="numeric")
    for name, s in (("kernel", settings), ("plain", plain), ("kernel, numeric focusing", numeric)):
        wall = _median_step(lambda: step(s))
        print(f"phase 7 {name} path, noisy step: {wall * 1e3:.1f} ms (median of 5), "
              f"{PA_GROUPS / wall:.1f} events/s ({CARD})")
        if name == "kernel":
            _print_busy("phase 7 kernel path", lambda: step(s), wall * 1e3)
    del batch
    torch.cuda.empty_cache()

    # (c) a separate trigger chain through Simulation, float64
    golden = np.load(TC_GOLDEN)
    sim = convert.dipole_simulation(
        str(INPUT_1E18_N3000), chunk_size=1024, device=dev, dtype=torch.float64,
        trigger_filter_chain=convert.narrow_trigger_chain())
    res = sim.run()
    mine = _triggered_groups(res)
    ref = set(int(g) for g in np.unique(golden["group_ids"]))
    vrms_err = abs(sim.Vrms_trigger / float(golden["vrms_trigger"]) - 1.0)
    print(f"phase 7 separate trigger chain float64: {len(mine)} groups triggered (NuRadioMC "
          f"{len(ref)}), {len(mine ^ ref)} differ; trigger Vrms rel err {vrms_err:.2e} "
          f"(limit 1e-9)")
    if mine != ref or not vrms_err <= 1e-9:
        raise AssertionError("the trigger-chain golden does not hold on the card")
    return launches


def phase_mooresbay(dev):
    """The reflective-bottom slice (kernels 1 and 2 at s2 12, three readout
    windows); returns the launch counts of the main-path run."""
    import dataclasses

    settings, ch, batch = convert.make_mooresbay_inputs(MB_GROUPS, 0, device=dev,
                                                        dtype=torch.float32)
    G, S = batch.energies.shape
    C = ch.positions.shape[0]
    n_rays = 2 + 4 * settings.n_reflections
    print(f"phase 8 Moore's Bay slice: {G} groups x S {S} x C {C} x {n_rays} ray slots = "
          f"{G * S * C * n_rays} rows, s2 {S * n_rays}, {settings.n_windows} windows, "
          f"attenuation {settings.attenuation_model}, reflector at {settings.ice.refl_z} m")
    placement.launches = trigger_fused.launches = raytrace.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.simulate_batch(batch, ch, settings)
    trig = out.triggered.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = {"placement_chain": placement.launches, "irfft_trigger": trigger_fused.launches,
                "ray_solver": raytrace.launches}
    print(f"phase 8 launches in the main-path run: {launches}; first call {first_s:.3f} s "
          f"({CARD})")
    if launches != {"placement_chain": settings.n_windows, "irfft_trigger": settings.n_windows,
                    "ray_solver": 1}:
        raise AssertionError(f"the Moore's Bay step launches {launches}, not one of kernels "
                             f"1 and 2 per window and one ray solve (the base slots)")
    if (trig.shape != (G,) or tuple(out.max_amplitude.shape) != (G, C)
            or tuple(out.c0.shape) != (G, S, C, n_rays)
            or not bool(torch.isfinite(out.max_amplitude).all())
            or not bool(torch.isfinite(out.trigger_time).all())
            or not bool(torch.isfinite(out.travel_time[out.sol_mask]).all())):
        raise AssertionError("Moore's Bay output has the wrong shape or is not finite")
    per_slot = out.sol_mask.sum(dim=(0, 1, 2)).tolist()
    base = pipeline.simulate_batch(
        batch, ch, dataclasses.replace(settings, n_reflections=0, n_windows=1))
    only_bounce = int((out.triggered & ~base.triggered).sum())
    print(f"phase 8 Moore's Bay: {int(trig.sum())} of {G} groups triggered, {only_bounce} of "
          f"them only through a bounce slot ({int(base.triggered.sum())} without "
          f"reflections); valid paths per ray slot {per_slot}")
    if not 0 < only_bounce < int(trig.sum()) < G:
        raise AssertionError("the slice does not exercise direct and bounced triggers")
    del base

    # kernel path against plain path; keeps the first window's kernel operands
    plain = dataclasses.replace(settings, placement_impl="plain", trigger_impl="plain")
    seen_hl, k1_calls, k2_calls = [], [], []
    hl_plain = trigger_fused.fused_irfft_trigger_plain
    k1, k2 = placement.chain_placement_reduce, trigger_fused.fused_irfft_trigger

    def recording_hl(*args, **kw):
        seen_hl.append((args, kw))
        return hl_plain(*args, **kw)

    def recording_k1(*args, **kw):
        if not k1_calls:
            k1_calls.append((args, kw))
        return k1(*args, **kw)

    def recording_k2(*args, **kw):
        if not k2_calls:
            k2_calls.append((args, kw))
        return k2(*args, **kw)

    trigger_fused.fused_irfft_trigger_plain = recording_hl
    trig_plain = pipeline.simulate_batch(batch, ch, plain).triggered.cpu().numpy()
    trigger_fused.fused_irfft_trigger_plain = hl_plain
    # the margin of a group: its nearest over every window's plain trigger call
    differ = [(g, min(_nearest_threshold_margin(call, settings.triggers, g, 0, C)
                      for call in seen_hl))
              for g in np.flatnonzero(trig_plain != trig).tolist()]
    print(f"phase 8 kernel path vs plain path on the card: {len(differ)} groups differ "
          f"(bound {PA_CROSS_GROUPS}), nearest-threshold margins "
          f"{[(g, '%.2e' % m) for g, m in differ]}")
    if len(differ) > PA_CROSS_GROUPS or any(m >= 1e-3 for _, m in differ):
        raise AssertionError("kernel and plain Moore's Bay paths differ beyond razor margins")
    del seen_hl

    def step(s):
        pipeline.simulate_batch(batch, ch, s).triggered.sum().item()

    torch.cuda.reset_peak_memory_stats()
    wall = _median_step(lambda: step(settings))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 8 kernel path: step {wall * 1e3:.1f} ms (median of 5), "
          f"{G / wall:.1f} events/s, peak device memory {peak:.2f} GiB ({CARD})")
    placement.launches = trigger_fused.launches = raytrace.launches = 0
    _print_busy("phase 8 kernel path", lambda: step(settings), wall * 1e3)
    print(f"phase 8 launches per step: kernel 1 {placement.launches // 2}, kernel 2 "
          f"{trigger_fused.launches // 2}, ray solver {raytrace.launches // 2}")
    wall_p = _median_step(lambda: step(plain), n=3)
    print(f"phase 8 plain path: step {wall_p * 1e3:.1f} ms (median of 3), "
          f"{G / wall_p:.1f} events/s ({CARD})")

    # kernels 1 and 2 on the first window's operands of this step
    placement.chain_placement_reduce = recording_k1
    trigger_fused.fused_irfft_trigger = recording_k2
    step(settings)
    placement.chain_placement_reduce, trigger_fused.fused_irfft_trigger = k1, k2
    del batch, out
    torch.cuda.empty_cache()
    args, kw = k1_calls.pop()
    live = int(args[5].sum())
    bound = _placement_chain_bound(args, kw)
    print(f"phase 8 placement_chain operands: {args[0].shape[0]} rows ({live} unmasked), "
          f"K_int {args[0].shape[1]}, {args[2].shape[1]} sparse frequencies, K_place "
          f"{kw['K_place']}, s2 {kw['s2']}; no library call does this function")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = _build.load("placement_chain").placement_chain_grid(
        args[0].shape[0] // kw["s2"], args[0].shape[1], args[2].shape[1], kw["K_place"],
        kw["n_int"], kw["n_base"], 0)
    print(f"phase 8 placement_chain grid: {grid} blocks on {sms} SMs")
    _check_placement("placement_chain float32 Moore's Bay window 0",
                     placement.chain_placement_reduce, placement.chain_placement_reduce_plain,
                     args, kw, 1e-4, bound, phase="phase 8")
    del args
    torch.cuda.empty_cache()
    args, kw = k2_calls.pop()
    print(f"phase 8 irfft_trigger operands: {args[0].shape[0]} rows (C {kw['C']}), K "
          f"{args[0].shape[1]}, n_base {kw['n_base']}, {len(kw['triggers'])} column")
    grid = _build.load("irfft_trigger").irfft_trigger_grid(
        args[0].shape[0] // kw["C"], kw["C"], kw["n_base"], args[0].shape[1],
        len(kw["triggers"]), 0)
    print(f"phase 8 irfft_trigger grid: {grid} blocks on {sms} SMs")
    _check_trigger("irfft_trigger float32 Moore's Bay window 0", args, kw, 1e-5,
                   phase="phase 8")
    del args
    torch.cuda.empty_cache()

    # the first 2048 groups in float64 against the JAX package's float64 set
    pin = np.load(MB_JAX_SETS)["triggered"]
    s64, ch64, b64 = convert.make_mooresbay_inputs(len(pin), 0, device=dev, dtype=torch.float64)
    trig64 = pipeline.simulate_batch(b64, ch64, s64).triggered.cpu().numpy()
    flips = np.flatnonzero(trig64 != pin)
    print(f"phase 8 float64, first {len(pin)} groups: {int(trig64.sum())} triggered, the JAX "
          f"package's float64 set {int(pin.sum())}, {len(flips)} differ {flips.tolist()}")
    if len(flips):
        raise AssertionError("the float64 Moore's Bay set differs from the JAX package's")
    return launches


def _one_step_ms(sim):
    """Wall ms of one warm ``simulate_batch`` step on the first chunk of
    ``sim``'s batch, and the chunk's group count."""
    batch = sim._build_batches()[-1]
    n = min(sim.chunk_size, batch.energies.shape[0])
    chunk = pipeline.ShowerBatch(*[None if a is None else torch.as_tensor(
        np.ascontiguousarray(a[:n]), device=sim.device) for a in batch])

    def step():
        pipeline.simulate_batch(chunk, sim.channel_params, sim.settings, emitter=sim._emitter,
                                arz_library=sim.arz_library).triggered.sum().item()

    return _median_step(step, n=1) * 1e3, n


class _Recorder:
    """Wraps the five kernel wrappers for one run and keeps the operands of
    one of its launches per kernel: the first (kernels 1 and 4, the ray
    solver's first call that launched), or the first
    in which a trigger fires (kernels 2 and 3; else their first), since the
    checks need both decisions. Whether a launch fired is read without a
    sync: its flag is copied to pinned host memory behind a CUDA event and
    looked at once the event has passed, at a later launch or on exit, so
    the timed run waits on nothing the recorder adds. Restores the wrappers
    on exit; the launch counts are the wrappers' own."""

    SITES = ((placement, "chain_placement_reduce", "placement_chain"),
             (placement, "placement_reduce", "placement_reduce"),
             (trigger_fused, "fused_irfft_trigger", "irfft_trigger"),
             (pa_trigger, "fused_pa_trigger", "pa_trigger"),
             (raytrace, "find_solutions", "ray_solver"))
    FIRES = ("irfft_trigger", "pa_trigger")

    def __init__(self):
        self.calls, self.fired, self._saved = {}, set(), []
        self._pending = {name: [] for name in self.FIRES}

    def _settle(self, name, wait):
        """Takes the first pending launch of ``name`` that fired, dropping
        those that did not, as far as their events have passed (all of
        them with ``wait``)."""
        pending = self._pending[name]
        while pending and name not in self.fired:
            call, flag, event = pending[0]
            if not wait and not event.query():
                return
            event.synchronize()
            pending.pop(0)
            if bool(flag):
                self.calls[name] = call
                self.fired.add(name)
                pending.clear()

    def _wrap(self, name, fn):
        def wrapper(*args, **kw):
            before = raytrace.launches
            res = fn(*args, **kw)
            if name == "ray_solver" and raytrace.launches == before:
                return res      # CPU tensors or no pair: nothing launched
            if name not in self.FIRES:
                self.calls.setdefault(name, (args, kw))
            elif name not in self.fired:
                self.calls.setdefault(name, (args, kw))
                self._settle(name, wait=False)
                if name not in self.fired:
                    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
                    flag.copy_(res[0].any(), non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    self._pending[name].append(((args, kw), flag, event))
            return res
        return wrapper

    def __enter__(self):
        for mod, attr, name in self.SITES:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved.clear()
        for name in self.FIRES:
            self._settle(name, wait=True)


def _reset_launches():
    placement.launches = placement.reduce_launches = 0
    trigger_fused.launches = pa_trigger.launches = raytrace.launches = 0
    earth_slant.launches = birefringence.launches = 0


def _launch_counts():
    return {"placement_chain": placement.launches, "placement_reduce": placement.reduce_launches,
            "irfft_trigger": trigger_fused.launches, "pa_trigger": pa_trigger.launches,
            "ray_solver": raytrace.launches, "earth_slant": earth_slant.launches,
            "birefringence_scan": birefringence.launches}


def _check_pa_call(label, args, kw, tol_amp, phase):
    """Kernel 3 against its plain version on one launch's operands, at that
    launch's threshold: decisions equal except within 1e-4 of the threshold
    (phase 2's rule), first frames equal where both fire clear of it,
    amplitudes within ``tol_amp`` relative and exactly 0 where the plain
    version's are; timed beside the plain version, its bound and the library
    transforms."""
    k_fired, k_frame, k_amp = pa_trigger.fused_pa_trigger(*args, **kw)
    p_fired, p_frame, p_amp, p_max = pa_trigger.fused_pa_trigger_plain(*args, **kw)
    torch.cuda.synchronize()
    thr = kw["threshold"]
    margin = (p_max - thr).abs() / thr
    margins = sorted(float(m) for m in margin[k_fired != p_fired])
    solid = (margin >= 1e-4) & k_fired & p_fired
    d_frame = int((k_frame != p_frame)[solid].sum())
    zero = p_amp == 0
    d_zero = int((zero & (k_amp != 0)).sum())
    den = torch.where(zero, torch.ones_like(p_amp), p_amp.abs())
    amp_rel = float(((k_amp - p_amp).abs() / den)[~zero].max()) if not bool(zero.all()) else 0.0
    amp_abs = float((k_amp - p_amp).abs().max())
    ms = _median_ms(lambda: pa_trigger.fused_pa_trigger(*args, **kw))
    plain_ms = _median_ms(lambda: pa_trigger.fused_pa_trigger_plain(*args, **kw))
    lib_ms = _pa_library_ms(args, kw)
    bound = _pa_bound(args, kw)
    print(f"{phase} {label}: {int(p_fired.sum())} of {len(p_fired)} groups fire, fired differs "
          f"in {len(margins)} (plain-path margins {['%.2e' % m for m in margins]}), frames differ "
          f"in {d_frame} solid groups, amp max rel err {amp_rel:.3e} (limit {tol_amp:g}), {d_zero} "
          f"zero rows not 0; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library transforms "
          f"{lib_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of the "
          f"bound ({CARD})")
    if (margins and margins[-1] >= 1e-4) or d_frame or d_zero or not amp_rel <= tol_amp:
        raise AssertionError(f"{label} disagrees with the plain version")
    return _entry(amp_abs, ms, plain_ms, bound, lib_ms)


def _check_recorded(calls, label, phase):
    """Every kernel a run launched against its plain version, on the
    operands of one of the run's own launches (``_Recorder``), with its
    time, bound and, where there is one, library time."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, kernel, plain, bound_of in (
            ("placement_chain", placement.chain_placement_reduce,
             placement.chain_placement_reduce_plain, _placement_chain_bound),
            ("placement_reduce", placement.placement_reduce,
             placement.placement_reduce_plain, _reduce_bound)):
        if name not in calls:
            continue
        args, kw = calls.pop(name)
        f64 = int(args[0].dtype == torch.float64)
        R, K_int = args[0].shape
        if name == "placement_chain":
            live = int(args[5].sum())
            grid = _build.load(name).placement_chain_grid(
                R // kw["s2"], K_int, args[2].shape[1], kw["K_place"], kw["n_int"],
                kw["n_base"], f64)
        else:
            live = int(((args[0] != 0) | (args[1] != 0)).any(dim=1).sum())
            grid = _build.load(name).placement_reduce_grid(
                R // kw["s2"], K_int, kw["K_place"], kw["n_int"], kw["n_base"], f64)
        print(f"{phase} {name} operands, {label}: {R} rows ({live} live), s2 {kw['s2']}, "
              f"K_int {K_int}, K_place {kw['K_place']}, n_int {kw['n_int']}, n_base "
              f"{kw['n_base']}, {args[0].dtype}; grid {grid} blocks on {sms} SMs")
        _check_placement(f"{name} {label}", kernel, plain, args, kw,
                         1e-10 if f64 else 1e-4, bound_of(args, kw), phase=phase)
        if name == "placement_reduce":
            print(f"{phase} placement_reduce {label}: library rfft(irfft(V, n_int), n_base) "
                  f"{_reduce_library_ms(args, kw):.3f} ms ({CARD})")
    if "irfft_trigger" in calls:
        args, kw = calls.pop("irfft_trigger")
        f64 = int(args[0].dtype == torch.float64)
        R, K = args[0].shape
        grid = _build.load("irfft_trigger").irfft_trigger_grid(
            R // kw["C"], kw["C"], kw["n_base"], K, args[2].shape[1], f64)
        print(f"{phase} irfft_trigger operands, {label}: {R} rows (C {kw['C']}), K {K}, n_base "
              f"{kw['n_base']}, {args[2].shape[1]} columns, {args[0].dtype}; grid {grid} blocks "
              f"on {sms} SMs")
        _check_trigger(f"irfft_trigger {label}", args, kw, 1e-12 if f64 else 1e-5, phase=phase)
    if "pa_trigger" in calls:
        args, kw = calls.pop("pa_trigger")
        f64 = args[0].dtype == torch.float64
        print(f"{phase} pa_trigger operands, {label}: {args[0].shape[0]} rows (C {kw['C']}), "
              f"K {args[0].shape[1]}, n_base {kw['n_base']}, n_hi {kw['n_hi']}, decim "
              f"{kw['decim']}, x{kw['up']}, {len(kw['rolls'])} beams, {args[0].dtype}")
        _check_pa_call(f"pa_trigger {label}", args, kw, 1e-12 if f64 else 1e-5, phase)
    if "ray_solver" in calls:
        args, kw = calls.pop("ray_solver")
        _check_ray_solver(f"ray_solver {label}", args, kw, phase)


def phase_signal_chain(dev):
    """Emitter mode, a tabulated antenna, ARZ2020 and GL1 through
    ``Simulation`` in float64 on the card, each against the JAX package's
    set; returns the kernel launches of the four runs."""
    import tempfile

    total = {"placement_chain": 0, "placement_reduce": 0, "irfft_trigger": 0, "ray_solver": 0}

    def run(label, sim, kernel):
        """One ``Simulation`` run with its launches counted; then each kernel
        it launched held to its plain version at the run's own operands."""
        _reset_launches()
        with _Recorder() as rec:
            t0 = time.perf_counter()
            res = sim.run()
            wall = time.perf_counter() - t0
        counts = {k: v for k, v in _launch_counts().items() if k in total}
        ms, n = _one_step_ms(sim)
        print(f"phase 9 {label} float64: {res['n_triggered']} of {len(res['triggered'])} groups "
              f"triggered, launches {counts}, run {wall:.2f} s with set-up; one step of {n} "
              f"groups {ms:.1f} ms ({CARD})")
        if counts[kernel] < 1 or counts["irfft_trigger"] < 1:
            raise AssertionError(f"{label}: {kernel} was not launched: {counts}")
        if sorted(rec.calls) != sorted(name for name, c in counts.items() if c):
            raise AssertionError(f"{label}: launches {counts} but operands of {sorted(rec.calls)}")
        for name, c in counts.items():
            total[name] += c
        _check_recorded(rec.calls, label.split(" (")[0].split(",")[0], "phase 9")
        torch.cuda.empty_cache()
        return res

    pin = np.load(EMITTER_JAX_SETS)
    for variant, path in (("efield", INPUT_EMITTER_EFIELD), ("voltage", INPUT_EMITTER_VOLTAGE)):
        sim = convert.emitter_simulation(str(path), chunk_size=24, device=dev,
                                         dtype=torch.float64)
        res = run(f"emitter {variant} ({sim._emitter.model}, 4 LPDAs + 4 dipoles)", sim,
                  "placement_reduce")
        per = res["multiple_triggers"]
        print(f"phase 9 emitter {variant}: per-trigger counts {per.sum(axis=0).tolist()} "
              f"({res['trigger_names']}), the JAX package's {pin[variant].sum(axis=0).tolist()}")
        if not np.array_equal(per, pin[variant]):
            raise AssertionError(f"the emitter {variant} sets differ from the JAX package's")

    pin = np.load(TABLE_JAX_SETS)
    with tempfile.TemporaryDirectory() as models:
        res = run("synthetic antenna table (24 x 25 x 37 grid)",
                  convert.table_simulation(str(INPUT_1E18_N3000), models, chunk_size=1024,
                                           device=dev, dtype=torch.float64), "placement_reduce")
    veff_err = abs(res["veff"] / float(pin["veff"]) - 1.0)
    print(f"phase 9 antenna table: {int((res['triggered'] != pin['triggered']).sum())} groups "
          f"differ from the JAX package's set, Veff rel err {veff_err:.2e}")
    if not np.array_equal(res["triggered"], pin["triggered"]) or not veff_err <= 1e-9:
        raise AssertionError("the tabulated-antenna set differs from the JAX package's")

    pin = np.load(ARZ_JAX_SETS)
    inp = io_input.select(io_input.read_input(INPUT_1E18_N3000), pin["group_ids"])
    res = run(f"ARZ2020 on the mini shower library ({len(pin['group_ids'])} event groups)",
              convert.arz_simulation(inp, chunk_size=256, device=dev, dtype=torch.float64),
              "placement_chain")
    print(f"phase 9 ARZ2020: {int((res['triggered'] != pin['triggered']).sum())} groups differ "
          f"from the JAX package's set of {int(pin['triggered'].sum())}")
    if not np.array_equal(res["triggered"], pin["triggered"]):
        raise AssertionError("the ARZ2020 set differs from the JAX package's")

    pin = np.load(GL1_JAX_SETS)
    res = run("GL1 attenuation, the dipole golden's input",
              convert.dipole_simulation(str(INPUT_1E18_N3000),
                                        {"propagation": {"attenuation_model": "GL1"}},
                                        chunk_size=1024, device=dev, dtype=torch.float64),
              "placement_chain")
    veff_err = abs(res["veff"] / float(pin["veff"]) - 1.0)
    print(f"phase 9 GL1: {int((res['triggered'] != pin['triggered']).sum())} groups differ from "
          f"the JAX package's set of {int(pin['triggered'].sum())}, Veff rel err {veff_err:.2e}")
    if not np.array_equal(res["triggered"], pin["triggered"]) or not veff_err <= 1e-9:
        raise AssertionError("the GL1 set differs from the JAX package's")
    return total


def _campaign_run(label, make_sim, n_events, phase="phase 10"):
    """One campaign ``Simulation`` built and run on the card with its
    launches counted and one launch of each kernel recorded; returns (sim,
    results, wall seconds from input to Veff with set-up, launch counts,
    recorded operands)."""
    _reset_launches()
    torch.cuda.synchronize()
    with _Recorder() as rec:
        t0 = time.perf_counter()
        sim = make_sim()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _launch_counts()
    print(f"{phase} {label}: {res['n_triggered']} of {len(res['triggered'])} groups triggered, "
          f"{wall:.2f} s from input to Veff with set-up, {n_events / wall:.1f} events/s "
          f"end to end, launches {counts} ({CARD})")
    return sim, res, wall, counts, rec.calls


def phase_campaign(dev):
    """NuRadioMC's production-scale campaigns on the card: event lists from
    the port's generator, ``Simulation`` runs in float64 and float32, the
    ``.nur`` waveform output read back and held to the reference's waveforms
    and the JAX package's traces, the noisy phased-array campaign, and the
    Gen2 tau list; returns the kernel launches of the runs."""
    import tempfile

    from nuradiomc_tpu_torch.sim import evtgen, io_nur

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    # (a) the 50,000-event list, in memory
    golden = np.load(FULLSCALE_GOLDEN)
    t0 = time.perf_counter()
    data, attrs = convert.fullscale_event_list()
    gen_s = time.perf_counter() - t0
    digest = evtgen.list_digest(data)
    want = golden["input_sha1"].item().decode()
    print(f"phase 10a evtgen: {attrs['n_events']} events, {len(data['shower_ids'])} showers in "
          f"{gen_s:.3f} s on the host; digest {digest} (golden {want}) ({CARD})")
    if digest != want:
        raise AssertionError("the generated campaign list differs from the golden's input")

    # (b) float64 with the .nur output
    ref = set(np.unique(golden["group_ids"][golden["triggered"]]).tolist())
    gid = golden["group_ids"]
    _, first = np.unique(gid, return_index=True)
    ref_sum = golden["weights"][first][golden["triggered"][first]].sum()
    n_events = int(golden["n_events"])
    with tempfile.TemporaryDirectory() as tmp:
        nur = os.path.join(tmp, "campaign.nur")
        sim, res, wall, counts, calls = _campaign_run(
            "(b) float64, 50,000 events with .nur output",
            lambda: convert.fullscale_simulation(io_input.from_generated(data, attrs),
                                                 device=dev, dtype=torch.float64,
                                                 nur_outputfilename=nur), n_events)
        add(counts)
        sel = res["triggered"] & (res["weights"] >= 1e-5)
        mine = set(res["group_ids"][sel].tolist())
        w_sum = res["weights"][sel].sum()
        veff = float(golden["volume"]) * 4 * np.pi * w_sum / n_events
        print(f"phase 10b float64: {len(mine)} groups above the weight cut (golden {len(ref)}), "
              f"{len(mine ^ ref)} differ; weight sum {w_sum:.9g} (golden {ref_sum:.9g}); "
              f"Veff*4pi {veff / units.km ** 3:.6f} km^3 sr (golden "
              f"{float(golden['veff']) / units.km ** 3:.6f})")
        if (mine != ref or not abs(w_sum / ref_sum - 1) <= 1e-6
                or not abs(veff / float(golden["veff"]) - 1) <= 1e-6):
            raise AssertionError("the float64 campaign does not hold the golden")
        if min(counts["placement_chain"], counts["irfft_trigger"]) < 1:
            raise AssertionError(f"a kernel of the campaign was not launched: {counts}")
        _check_recorded(calls, "campaign float64", "phase 10b")
        # (d, first part) the .nur file: one event per triggered group, 1 GHz
        events = list(io_nur.EventReader(nur).run())
        ids = [e.get_id() for e in events]
        rates = {ch.get_sampling_rate() for e in events for ch in e.get_station(101).iter_channels()}
        n_samples = {ch.get_number_of_samples() for e in events
                     for ch in e.get_station(101).iter_channels()}
        want_ids = sorted(int(g) for g in res["group_ids"][res["triggered"]])
        print(f"phase 10d .nur of (b): {len(events)} events (triggered groups {len(want_ids)}), "
              f"rates {sorted(rates)} GHz, {sorted(n_samples)} samples")
        if ids != want_ids or rates != {1.0}:
            raise AssertionError("the campaign's .nur does not hold one 1 GHz event per "
                                 "triggered group")
    del sim, res, calls
    torch.cuda.empty_cache()

    # (c) float32 at the headline settings, no gate
    bench = {"propagation": {"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
             "perf": {"band_limit_eps": 1e-2}}
    _, res, _, counts, calls = _campaign_run(
        "(c) float32, headline settings",
        lambda: convert.fullscale_simulation(io_input.from_generated(data, attrs), bench,
                                             device=dev, dtype=torch.float32), n_events)
    add(counts)
    mine = set(res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)].tolist())
    print(f"phase 10c float32: symmetric difference against the golden set {len(mine ^ ref)} "
          f"groups (missing {sorted(ref - mine)}, extra {sorted(mine - ref)}; no gate) ({CARD})")
    if min(counts["placement_chain"], counts["irfft_trigger"]) < 1:
        raise AssertionError(f"a kernel of the float32 campaign was not launched: {counts}")
    _check_recorded(calls, "campaign float32", "phase 10c")
    del res, calls
    torch.cuda.empty_cache()

    # (d) the 3000-event dipole input with .nur output, against NuRadioMC's
    # waveforms and the JAX package's keep_traces traces
    pin = np.load(WAVEFORMS_REF)
    with tempfile.TemporaryDirectory() as tmp:
        nur = os.path.join(tmp, "dipole.nur")
        _, res, _, counts, calls = _campaign_run(
            "(d) float64, the 3000-event dipole input with .nur output",
            lambda: convert.dipole_simulation(str(INPUT_1E18_N3000), chunk_size=1024,
                                              device=dev, dtype=torch.float64,
                                              nur_outputfilename=nur), 3000)
        add(counts)
        events = {e.get_id(): e for e in io_nur.EventReader(nur).run()}
    if min(counts["placement_chain"], counts["irfft_trigger"]) < 1:
        raise AssertionError(f"a kernel of the dipole run was not launched: {counts}")
    _check_recorded(calls, "dipole run with .nur output", "phase 10d")
    del calls
    worst_ref = worst_jax = worst_tt = worst_tt_jax = 0.0
    for j, g in enumerate(pin["group_ids"].tolist()):
        st = events[g].get_station(101)
        ch = st.get_channel(0)
        mine, t0_mine = np.asarray(ch.get_trace()), ch.get_trace_start_time()
        tt = st.get_trigger("default_high_low").get_trigger_time()
        # on the reference's readout grid (tests/test_e2e_waveforms.py:89-105)
        ref_tr = pin["ref_traces"][j]
        bt = BaseTrace()
        bt.set_trace(mine, ch.get_sampling_rate())
        bt.resample(float(pin["ref_fs"]))
        offset = (pin["ref_t0"][j] - t0_mine) * float(pin["ref_fs"])
        start_bin = int(np.floor(offset))
        if abs(offset - start_bin) > 1e-9:
            bt.apply_time_shift(-(offset - start_bin) / float(pin["ref_fs"]))
        cut = np.asarray(bt.get_trace())[start_bin:start_bin + len(ref_tr)]
        if len(cut) != len(ref_tr):
            raise AssertionError(f"group {g}: the trace does not cover the reference's window")
        worst_ref = max(worst_ref, np.abs(cut - ref_tr).max() / np.abs(ref_tr).max())
        worst_tt = max(worst_tt, abs(tt - pin["ref_trigger_times"][j]))
        # the JAX package's keep_traces trace, resampled as the writer does
        jt = BaseTrace()
        jt.set_trace(pin["jax_traces"][j], float(pin["jax_rate"]))
        jt.resample(ch.get_sampling_rate())
        jax_tr = np.asarray(jt.get_trace())
        err = np.abs(mine - jax_tr).max() / np.abs(jax_tr).max()
        worst_jax = max(worst_jax, err / pin["jax_limits"][j])
        worst_tt_jax = max(worst_tt_jax, abs(tt - pin["jax_trigger_times"][j]),
                           abs(t0_mine - pin["jax_base_t0"][j]))
    print(f"phase 10d the golden's {len(pin['group_ids'])} waveforms: max |port - NuRadioMC| "
          f"{worst_ref:.3e} of peak (limit 2e-2), trigger times within {worst_tt:.3e} ns (limit "
          f"1); against the JAX package's keep_traces: worst error {worst_jax:.3f} of its limit "
          f"(1e-6 of peak, 5e-4 where a refracted ray is valid: the turning point), times "
          f"within {worst_tt_jax:.2e} ns (limit 1e-3)")
    if not (worst_ref <= 2e-2 and worst_tt <= 1.0 and worst_jax <= 1.0 and worst_tt_jax <= 1e-3):
        raise AssertionError("the .nur waveforms do not hold the references")
    del res
    torch.cuda.empty_cache()

    # (e) the noisy deep phased-array campaign
    pa_golden = np.load(FULLSCALE_PA_GOLDEN)
    t0 = time.perf_counter()
    pa_data, pa_attrs = convert.fullscale_event_list(convert.FULLSCALE_PA_LIST)
    pa_gen_s = time.perf_counter() - t0
    digest = evtgen.list_digest(pa_data)
    want = pa_golden["input_sha1"].item().decode()
    print(f"phase 10e evtgen: {pa_attrs['n_events']} events in {pa_gen_s:.3f} s on the host; "
          f"digest {digest} (golden {want}) ({CARD})")
    if digest != want:
        raise AssertionError("the generated phased-array list differs from the golden's input")
    n_pa = int(pa_golden["n_events"])
    _, res, _, counts, calls = _campaign_run(
        "(e) phased array, float64, 10,000 events",
        lambda: convert.fullscale_pa_simulation(io_input.from_generated(pa_data, pa_attrs),
                                                device=dev, dtype=torch.float64), n_pa)
    add(counts)
    sel = res["triggered"] & (res["weights"] >= 1e-5)
    n_mine, n_ref = len(set(res["group_ids"][sel].tolist())), int(pa_golden["n_triggered"])
    veff = float(pa_golden["volume"]) * 4 * np.pi * res["weights"][sel].sum() / n_pa
    rel = veff / float(pa_golden["veff"]) - 1
    print(f"phase 10e phased array: {n_mine} triggered (golden {n_ref}, band "
          f"{3 * np.sqrt(n_ref):.1f}), Veff*4pi {veff / units.km ** 3:.5f} km^3 sr (golden "
          f"{float(pa_golden['veff']) / units.km ** 3:.5f}), rel {rel:+.4f} (band "
          f"{2 * 2 / np.sqrt(n_ref):.4f})")
    if abs(n_mine - n_ref) > 3 * np.sqrt(n_ref) or abs(rel) >= 2 * 2 / np.sqrt(n_ref):
        raise AssertionError("the phased-array campaign is outside its statistical bands")
    if min(counts["placement_chain"], counts["pa_trigger"], counts["earth_slant"]) < 1:
        raise AssertionError(f"a kernel of the phased-array campaign was not launched: {counts}")
    _check_recorded(calls, "phased-array campaign float64", "phase 10e")
    del res, calls
    torch.cuda.empty_cache()

    # (f) the Gen2 tau list with stochastic secondaries
    t0 = time.perf_counter()
    got = io_input.from_generated(*convert.gen2_tau_event_list())
    gen_s = time.perf_counter() - t0
    ref_inp = io_input.read_input(INPUT_GEN2)
    differ = [name for name in io_input._ARRAYS if not (
        (getattr(got, name) is None and getattr(ref_inp, name) is None)
        or np.array_equal(getattr(got, name), getattr(ref_inp, name)))]
    print(f"phase 10f Gen2 tau list: {got.n_showers} showers in {gen_s:.3f} s on the host, "
          f"columns that differ from its export: {differ} ({CARD})")
    if differ:
        raise AssertionError("the Gen2 tau list differs from its export")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s; launches {total} ({CARD})")
    return total


# ---- phase 11: processes sharing the card on a mesh, and the muon campaign ------

MUON_JAX_SETS = DATA_DIR / "surface_muons_jax_sets.npz"
PA_MESH_EVENTS = 2048    # the phase 10e list cut to its first 2048 event groups
RUNNER_BATCH, RUNNER_BUDGET, RUNNER_STOP = 200, 70, 2


def _p11_pa_input():
    inp = io_input.from_generated(*convert.fullscale_event_list(convert.FULLSCALE_PA_LIST))
    return io_input.select(inp, np.unique(inp.event_group_ids)[:PA_MESH_EVENTS])


def _p11_run(kind, mesh, dev, ckpt_dir):
    """One phase-11 job on ``mesh`` (None: this process alone): a results
    dict, or the runner's states."""
    from nuradiomc_tpu_torch.parallel import dryrun
    if kind == "dipole":
        return convert.dipole_simulation(str(INPUT_1E18_N3000), chunk_size=512, device=dev,
                                         dtype=torch.float64, mesh=mesh).run()
    if kind in ("dryrun", "dryrun noise"):
        return dryrun.dryrun_simulation(mesh=mesh, device=dev, noise=kind == "dryrun noise").run()
    if kind == "pa":
        return convert.fullscale_pa_simulation(_p11_pa_input(), device=dev, dtype=torch.float64,
                                               mesh=mesh).run()
    if kind == "runner":
        return dryrun.dryrun_runner(mesh, dev, ckpt_dir, RUNNER_BATCH, RUNNER_BUDGET,
                                    RUNNER_STOP)
    raise ValueError(kind)


def _p11_timed(kind, mesh, dev, ckpt_dir, record):
    """A job with its launches counted from 0 and its wall time; with
    ``record``, one launch of each kernel it ran held to its plain version
    (``_Recorder``, ``_check_recorded``)."""
    from nuradiomc_tpu_torch.parallel import dryrun

    _reset_launches()
    torch.cuda.synchronize()
    with _Recorder() if record else contextlib.nullcontext() as rec:
        t0 = time.perf_counter()
        res = _p11_run(kind, mesh, dev, ckpt_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _launch_counts()
    if record:
        shape = "one process" if mesh is None else f"mesh {mesh.n_event}x{mesh.n_channel}"
        _check_recorded(rec.calls, f"{kind} on {shape}", "phase 11")
    if kind != "runner":
        res = {k: res[k] for k in dryrun.RESULT_KEYS}
    return res, wall, counts


def _p11_worker(rank, n_procs, card, jobs, ckpt_dir):
    """A spawned process of phase 11: each job on its ``(n_event,
    n_channel)`` mesh of the gloo group, the ranks started together; rank 0
    holds the recorded launches of the jobs marked so. Returns per job the
    results, rank 0's wall seconds and this rank's launches."""
    import torch.distributed as dist

    from nuradiomc_tpu_torch.parallel import mesh as mesh_util
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, kind, shape, record in jobs:
        mesh = mesh_util.make_mesh(*shape, device="cuda")
        dist.barrier()
        out[name] = _p11_timed(kind, mesh, mesh.device, ckpt_dir, record and rank == 0)
    return out


def phase_multiprocess(dev):
    """Meshes of 2 and 4 gloo processes sharing the card (built in phase 1,
    before any process starts), each run against its single-process twin on
    the card, float64: (a) the 3000-event dipole golden on (2,1), (2,2) and
    (4,1): the golden set and Veff 0.22978 km^3; (b) the dryrun list on
    (2,2), noise off and on; (c) the noisy phased-array campaign's first
    2048 groups on (2,2) (kernel 3 on the mesh path, four channels split
    over the channel axis); (d) a Runner streaming evtgen batches to a
    trigger budget on (2,2), stopped after two batches and resumed, its
    state equal to the uninterrupted one; every mesh result equal to the
    twin's bit for bit (Veff at rtol 1e-12); kernels 1, 2 and 3 held to
    their plain versions on recorded launches of the mesh runs; (e) the
    2500-muon Aeff campaign in one process: the JAX package's set equal and
    Aeff within NuRadioMC's 0.45027 +- 2 x 0.06549 km^2. Every run's wall
    time and events/s beside its twin's. Returns the launches of every run,
    the ranks' included."""
    import shutil
    import tempfile

    from nuradiomc_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    events = {"dipole": 3000, "dryrun": 300, "dryrun noise": 300, "pa": PA_MESH_EVENTS}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_runner_")
    try:
        twins = {}
        for kind in ("dipole", "dryrun", "dryrun noise", "pa", "runner"):
            sub = os.path.join(ckpt, "single")
            os.makedirs(sub, exist_ok=True)
            twins[kind] = _p11_timed(kind, None, dev, sub, False)
            add(twins[kind][2])
        torch.cuda.empty_cache()
        # each spawn starts with an untimed dryrun, so the first timed job
        # does not carry the processes' first-call costs (the twins ran warm)
        jobs2 = [("warm-up", "dryrun", (2, 1), False), ("dipole 2x1", "dipole", (2, 1), False)]
        jobs4 = [("warm-up", "dryrun", (2, 2), False),
                 ("dipole 2x2", "dipole", (2, 2), True), ("dipole 4x1", "dipole", (4, 1), False),
                 ("dryrun 2x2", "dryrun", (2, 2), False),
                 ("dryrun noise 2x2", "dryrun noise", (2, 2), False),
                 ("pa 2x2", "pa", (2, 2), True), ("runner 2x2", "runner", (2, 2), False)]
        runs = {}
        for n, jobs in ((2, jobs2), (4, jobs4)):
            t0 = time.perf_counter()
            ranks = dryrun.spawn(_p11_worker, n, (CARD, jobs, ckpt), backend="gloo")
            print(f"phase 11 {n} gloo processes on the card: {time.perf_counter() - t0:.1f} s "
                  f"with start-up ({CARD})")
            for name, kind, shape, _ in jobs:
                for r in ranks:
                    add(r[name][2])
                if name != "warm-up":
                    runs[name] = (kind, shape, [r[name][0] for r in ranks], ranks[0][name][1],
                                  [r[name][2] for r in ranks])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    golden = np.load(E2E_GOLDEN)
    ref_set = set(int(g) for g in np.unique(golden["group_ids"]))
    for name, (kind, shape, results, wall, counts) in runs.items():
        twin, twin_wall, twin_counts = twins[kind]
        if kind == "runner":
            states = [r[run][0] for r in results for run in ("whole", "resumed", "clock")]
            first = results[0]["first"][0]
            print(f"phase 11 (d) Runner on {shape}: uninterrupted {twin['whole'][0]} in "
                  f"{results[0]['whole'][1]:.2f} s (one process {twin['whole'][1]:.2f} s); "
                  f"stopped after {first.n_batches} batches ({first.n_triggered} triggered), "
                  f"resumed to {results[0]['resumed'][0]} ({CARD})")
            if (any(st != twin["whole"][0] for st in states) or first.n_batches != RUNNER_STOP
                    or first.n_triggered >= RUNNER_BUDGET
                    or twin["whole"][0].n_batches <= RUNNER_STOP):
                raise AssertionError("the mesh Runner's states differ from the uninterrupted "
                                     "one-process run")
            if twin["resumed"][0] != twin["whole"][0]:
                raise AssertionError("the one-process Runner does not resume to its state")
            continue
        for rank, res in enumerate(results):
            dryrun.compare(res, twin, f"{name} rank {rank}")
        if kind == "dipole":
            mine = _triggered_groups(results[0])
            if mine != ref_set or round(results[0]["veff"] / units.km ** 3, 5) != 0.22978:
                raise AssertionError(f"{name}: the golden does not hold")
        n_ev = events[kind]
        launched = {k: sum(c[k] for c in counts) for k in KERNELS if any(c[k] for c in counts)}
        print(f"phase 11 {name}: {results[0]['n_triggered']} triggered, equal to one process "
              f"bit for bit (Veff {results[0]['veff'] / units.km ** 3:.6f} km^3); "
              f"{wall:.2f} s, {n_ev / wall:.1f} events/s, one process {twin_wall:.2f} s, "
              f"{n_ev / twin_wall:.1f} events/s; launches on all ranks {launched} ({CARD})")
        if not launched:
            raise AssertionError(f"{name}: no kernel was launched")
    if not runs["pa 2x2"][4][0]["pa_trigger"]:
        raise AssertionError("kernel 3 was not launched on the mesh path")
    # what every rank of (c) repeats: the set-up and the weights (their chord
    # integral one launch on the card)
    t0 = time.perf_counter()
    sim = convert.fullscale_pa_simulation(_p11_pa_input(), device=dev, dtype=torch.float64)
    t1 = time.perf_counter()
    gids, start, count, order, _ = sim._build_batches()
    t2 = time.perf_counter()
    sim._weights(gids, start, count, order)
    t3 = time.perf_counter()
    print(f"phase 11 (c) work of the 2048 phased-array groups that every rank repeats: "
          f"Simulation set-up {t1 - t0:.2f} s, batches {t2 - t1:.2f} s, core_mantle_crust "
          f"weights (chords on the card) {t3 - t2:.4f} s ({CARD})")
    del sim

    # (e) the surface-muon Aeff campaign
    pin = np.load(MUON_JAX_SETS)
    aeff_mean, aeff_sigma = convert.SURFACE_MUON_AEFF
    t0 = time.perf_counter()
    data, attrs = convert.surface_muon_event_list()
    gen_s = time.perf_counter() - t0
    _, res, wall, counts, calls = _campaign_run(
        "(e) 2500 surface muons, float64", lambda: convert.surface_muon_simulation(
            io_input.from_generated(data, attrs), device=dev, dtype=torch.float64),
        int(attrs["n_events"]), phase="phase 11")
    add(counts)
    aeff = res["aeff"]
    differ = int((res["triggered"] != pin["triggered"]).sum())
    print(f"phase 11 (e) surface muons: list {len(data['xx'])} showers in {gen_s:.3f} s on the "
          f"host; {res['n_triggered']} of {len(res['triggered'])} groups triggered (the JAX "
          f"package's {int(pin['n_triggered'])}), {differ} differ; Aeff "
          f"{aeff / units.km ** 2:.5f} km^2 (NuRadioMC {aeff_mean / units.km ** 2:.5f} +- 2 x "
          f"{aeff_sigma / units.km ** 2:.5f}); {wall:.2f} s, {attrs['n_events'] / wall:.1f} "
          f"events/s ({CARD})")
    if (not np.array_equal(res["group_ids"], pin["group_ids"]) or differ
            or not np.all(res["weights"] == 1.0)):
        raise AssertionError("the surface-muon set differs from the JAX package's")
    if not abs(aeff - aeff_mean) < 2 * aeff_sigma:
        raise AssertionError("the surface-muon Aeff is outside NuRadioMC's band")
    if min(counts["placement_chain"], counts["irfft_trigger"]) < 1:
        raise AssertionError(f"a kernel of the muon campaign was not launched: {counts}")
    _check_recorded(calls, "surface-muon campaign float64", "phase 11")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s; launches {total} ({CARD})")
    return total


# ---- phase 12: the in-ice reconstruction path ------------------------------

RECO_FILES = {"e2e_reference_waveforms.nur": 7, "reference_events.nur": 3,
              "trigger_test_input.nur": 10}
RECO_SAMPLE = 64            # one table point in 64 re-solved on the CPU
RECO_TT_RTOL = 1e-6         # travel times, card against CPU
# a refracted ray at the turning point: the closed forms take the square root
# of a vanishing quantity there, and two devices' roots c0 move its arrival
# by up to ~1e-4 ns (ROADMAP "The turning point"); the witness holds every
# entry, these included, to RECO_TT_RTOL once the CPU takes the card's root
RECO_TT_TURNING_RTOL = 1e-5
RECO_CHI2_RTOL = 1e-9       # chi2 of 256 random triples, card against CPU
RECO_CHAIN_TOL = 1e-9       # example-03 traces and spectra, of each one's peak
RECO_IFT_RTOL = 1e-6        # the IFT spectrum after 600 steps, of its peak


def _reco_gold(name):
    return os.path.join(HERE, "tests", "golden", name)


def _p12_files(tmp):
    """(a) NuRadioReco's three files through the port's reader, the waveform
    golden's traces bit-equal to the port's copy of them, and each file
    written by the port's eventWriter and read back unchanged."""
    from nuradiomc_tpu_torch.reco.examples import assert_same_tree, event_tree
    from nuradiomc_tpu_torch.sim import io_nur, io_nur_reference

    events = {}
    for name, n in RECO_FILES.items():
        evts = list(io_nur.EventReader(_reco_gold(name)).run())
        assert len(evts) == n, (name, len(evts))
        out = os.path.join(tmp, name)
        w = io_nur_reference.eventWriter()
        w.begin(out)
        for e in evts:
            w.run(e)
        assert w.end() == n
        assert_same_tree([event_tree(e) for e in io_nur.EventReader(out).run()],
                         [event_tree(e) for e in evts])
        events[name] = evts
    pin = np.load(WAVEFORMS_REF)
    by_run = {e.get_run_number(): e.get_station(101) for e in events["e2e_reference_waveforms.nur"]}
    for i, gid in enumerate(pin["group_ids"]):
        ch = by_run[int(gid)].get_channel(0)
        assert np.array_equal(np.asarray(ch.get_trace()), pin["ref_traces"][i]), gid
        assert ch.get_trace_start_time() == pin["ref_t0"][i]
        assert ch.get_sampling_rate() == pin["ref_fs"]
    print(f"phase 12 (a) NuRadioReco's .nur: {sum(RECO_FILES.values())} events of 3 files read "
          f"by io_nur.EventReader, the waveform golden's 7 traces bit-equal to "
          f"data/e2e_waveforms_reference.npz, each file written by the port's eventWriter and "
          f"read back equal")
    return events


def _p12_example03(dev):
    """(b) simple_reconstruction.py's chain on ``dev``; returns the station
    and the noise adder's generator state."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev, parameters as fpar
    from nuradiomc_tpu_torch.reco import channel_processing as cp, efield_converters as ec
    from nuradiomc_tpu_torch.reco import examples

    det = Detector(examples.SIMPLE_DETECTOR)
    evt, st = examples.simple_event(fev, fpar)
    conv = ec.efieldToVoltageConverter(device=dev)
    conv.begin()
    conv.run(evt, st, det)
    noise = cp.channelGenericNoiseAdder(device=dev)
    noise.begin(seed=42)
    noise.run(evt, st, det, amplitude=1e-6, type="rayleigh")
    cp.channelBandPassFilter(device=dev).run(evt, st, det, passband=[0.1, 0.5],
                                             filter_type="butter", order=4)
    rec = cp.channelSignalReconstructor(device=dev)
    rec.begin()
    rec.run(evt, st, det)
    unfold = ec.voltageToEfieldConverter(device=dev)
    unfold.begin()
    unfold.run(evt, st, det, use_channels=[0, 1])
    return st, noise._rng.bit_generator.state


def _p12_chain(dev):
    t0 = time.perf_counter()
    card, card_rng = _p12_example03(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu, cpu_rng = _p12_example03("cpu")
    assert repr(card_rng) == repr(cpu_rng)        # the same numbers drawn on the host
    worst = 0.0
    pairs = [(card.get_channel(c).get_trace(), cpu.get_channel(c).get_trace()) for c in (0, 1)]
    pairs.append((card.get_electric_fields()[-1].get_frequency_spectrum(),
                  cpu.get_electric_fields()[-1].get_frequency_spectrum()))
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        for ra, rb in zip(np.atleast_2d(a), np.atleast_2d(b)):
            peak = np.max(np.abs(rb))
            if peak == 0:
                assert np.all(ra == 0)
                continue
            worst = max(worst, float(np.max(np.abs(ra - rb))) / peak)
    assert worst <= RECO_CHAIN_TOL, worst
    print(f"phase 12 (b) example-03 chain (fold, noise seed 42, band-pass, observables, "
          f"unfold) f64: card against CPU max |diff| {worst:.2e} of each trace's peak "
          f"(gate {RECO_CHAIN_TOL:g}), the noise generator's state equal; {t_card:.3f} s on "
          f"the card ({CARD})")


def _p12_turning(cpu_sols, z_pt, z_ant, ice):
    """[point, ray type]: a refracted ray (type index 1) whose turning depth
    lies within 1 m of the upper endpoint, where two correct solvers differ
    most (ROADMAP "The turning point")."""
    from nuradiomc_tpu_torch.ops import raytrace

    upper = torch.maximum(z_pt, torch.full_like(z_pt, z_ant))
    zt = raytrace.turning_depth(cpu_sols.c0, ice)
    near = ((torch.abs(zt - upper[:, None]) < 1.0)
            & (cpu_sols.sol_type == raytrace.SOL_REFRACTED)).any(dim=-1)
    out = torch.zeros((len(z_pt), 3), dtype=torch.bool)
    out[:, 1] = near
    return out


def _p12_by_type(sols):
    """[3, points] travel time of each ray type (0 where none) as
    vertex.build_travel_time_table files it (a later slot wins), and the
    slot it came from."""
    tt = torch.zeros((3, sols.c0.shape[0]), dtype=torch.float64)
    slot_of = torch.zeros((3, sols.c0.shape[0]), dtype=torch.int64)
    for slot in range(2):
        for k in range(3):
            hit = sols.mask[:, slot] & (sols.sol_type[:, slot] == k + 1)
            tt[k] = torch.where(hit, sols.travel_time[:, slot], tt[k])
            slot_of[k] = torch.where(hit, slot, slot_of[k])
    return tt, slot_of


def _p12_vertex(dev, ice, det, evt, st):
    """(c) the travel-time tables at the package defaults for each antenna
    depth, a sample of each re-solved on the CPU, and the 3D vertex on
    run_reco_chain.py's search volume at the reconstructor's default steps."""
    from nuradiomc_tpu_torch.ops import raytrace
    from nuradiomc_tpu_torch.reco import examples, vertex as vx

    truth = examples.RECO_CHAIN_TRUTH["vertex"]
    depths = sorted({round(float(p[2]), 3) for p in examples.RECO_CHAIN_POSITIONS})
    reco = vx.neutrino3DVertexReconstructor(ice, device=dev)
    gen = np.random.default_rng(12)
    n_sampled = 0
    differ_turn = differ_other = 0
    resolve_diff = 0.0
    wit_c0, wit_tt = [0.0, 0.0], [0.0, 0.0]     # [turning point, other]
    # build_travel_time_table's default grid: x 10 m-5 km, z -3 km to -50 m, 2 m
    n_grid = len(np.arange(10.0, 5000.0, 2.0)) * len(np.arange(-3000.0, -50.0, 2.0))
    chunks = []
    rel_other, rel_turn = [], []
    secs = []
    torch.cuda.reset_peak_memory_stats(dev)
    for z_ant in depths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks.append(vx.table_chunk(n_grid, dev))
        header, table = vx.build_travel_time_table(ice, z_ant, chunk=chunks[-1], device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        reco._tables[z_ant] = (header, table)
        n_pts = header["n_x"] * header["n_z"]
        pick = np.sort(gen.choice(n_pts, n_pts // RECO_SAMPLE, replace=False))
        ix, iz = pick // header["n_z"], pick % header["n_z"]
        x = torch.as_tensor(header["x_min"] + ix * header["d_x"], dtype=torch.float64)
        z = torch.as_tensor(header["z_min"] + iz * header["d_z"], dtype=torch.float64)
        x1 = torch.stack([x, torch.zeros_like(x), z], dim=-1)
        x2 = torch.tensor([0.0, 0.0, z_ant], dtype=torch.float64).expand_as(x1)
        g = raytrace.to_2d(x1, x2)
        sols = raytrace.find_solutions(g.x1y, g.x1z, g.x2y, g.x2z, ice)
        cpu, cpu_slot = _p12_by_type(sols)
        card = table.reshape(3, -1)[:, torch.as_tensor(pick, device=dev)].cpu()
        turning = _p12_turning(sols, z, z_ant, ice).T                  # [3, points]
        differ = (card > 0) != (cpu > 0)
        differ_turn += int((differ & turning).sum())
        differ_other += int((differ & ~turning).sum())
        both = (card > 0) & (cpu > 0)
        rel = torch.abs(card - cpu) / torch.where(both, cpu, 1.0)
        rel_other.append(rel[both & ~turning])
        rel_turn.append(rel[both & turning])
        # the witness of the turning-point rays: the card re-solves the sampled
        # points (the table's program on fewer points), the CPU evaluates the
        # travel time at the card's own root c0
        dev_sols = raytrace.find_solutions(*(t.to(dev) for t in (g.x1y, g.x1z, g.x2y, g.x2z)),
                                           ice)
        dev_sols = type(dev_sols)(*(t.cpu() for t in dev_sols))
        card_rs, card_slot = _p12_by_type(dev_sols)
        resolve_diff = max(resolve_diff, float(torch.abs(card_rs - card).max()))
        k_w, i_w = torch.nonzero(both, as_tuple=True)
        c0_card = dev_sols.c0[i_w, card_slot[k_w, i_w]]
        c0_cpu = sols.c0[i_w, cpu_slot[k_w, i_w]]
        t_at_card_c0 = raytrace.travel_time(c0_card, g.x1y[i_w], g.x1z[i_w], g.x2y[i_w],
                                            g.x2z[i_w], ice)
        at_turn = turning[k_w, i_w]
        rel_c0 = torch.abs(c0_card - c0_cpu) / c0_cpu
        rel_wit = torch.abs(t_at_card_c0 - card[k_w, i_w]) / card[k_w, i_w]
        for j, part in enumerate((at_turn, ~at_turn)):
            if part.any():
                wit_c0[j] = max(wit_c0[j], float(rel_c0[part].max()))
                wit_tt[j] = max(wit_tt[j], float(rel_wit[part].max()))
        n_sampled += len(pick)
        zt = raytrace.turning_depth(sols.c0, ice)
        for k, i in torch.nonzero((both & ~turning & (rel > RECO_TT_RTOL))
                                  | (differ & ~turning)).tolist()[:5]:
            slot = int(torch.nonzero(sols.sol_type[i] == k + 1).flatten()[0]) \
                if bool((sols.sol_type[i] == k + 1).any()) else 0
            print(f"phase 12 (c) depth {z_ant} m, point x {float(x[i]):.0f} z {float(z[i]):.0f} "
                  f"m, ray type {k + 1}: card {float(card[k, i]):.9f} cpu {float(cpu[k, i]):.9f} "
                  f"ns, rel {float(rel[k, i]):.2e}, CPU turning depth {float(zt[i, slot]):.4f} m")
    peak = torch.cuda.max_memory_allocated(dev)
    rel_other, rel_turn = torch.cat(rel_other), torch.cat(rel_turn)
    worst_other = float(rel_other.max())
    worst_turn = float(rel_turn.max()) if len(rel_turn) else 0.0
    n_pts = header["n_x"] * header["n_z"]
    total = sum(secs)
    print(f"phase 12 (c) travel-time tables f64 at the package defaults (x 10 m-5 km, z -3 km"
          f" to -50 m, 2 m): {len(depths)} depths x {n_pts} points = {len(depths) * n_pts} ray "
          f"solves in {total:.2f} s ({len(depths) * n_pts / total:.0f} solves/s; per table "
          + ", ".join(f"{s:.3f}" for s in secs) + f" s), chunks used {min(chunks)}-{max(chunks)} "
          f"points, peak device "
          f"memory {peak / 2**30:.2f} GiB ({CARD})")
    print(f"phase 12 (c) {n_sampled} sampled points re-solved on the CPU: slot validity differs "
          f"in {differ_turn} (point, ray type) entries where a refracted ray sits at the turning "
          f"point and in {differ_other} others (gate 0); {len(rel_other)} valid travel times "
          f"within {worst_other:.2e} relative (gate {RECO_TT_RTOL:g}), and {len(rel_turn)} of "
          f"refracted rays at the turning point within {worst_turn:.2e} (gate "
          f"{RECO_TT_TURNING_RTOL:g})")
    print(f"phase 12 (c) witness: the card's re-solve of the sampled points against its table "
          f"max |diff| {resolve_diff:.3e} ns (gate 0); the card's root c0 against the CPU's "
          f"{wit_c0[0]:.3e} relative at the turning point, {wit_c0[1]:.3e} elsewhere; the CPU's "
          f"travel time at the card's c0 against the card's {wit_tt[0]:.3e} at the turning "
          f"point, {wit_tt[1]:.3e} elsewhere (gate {RECO_TT_RTOL:g})")
    assert differ_other == 0
    assert worst_other <= RECO_TT_RTOL and worst_turn <= RECO_TT_TURNING_RTOL
    assert resolve_diff == 0.0 and max(wit_tt) <= RECO_TT_RTOL, (resolve_diff, wit_tt)
    channels = list(range(len(examples.RECO_CHAIN_POSITIONS)))
    reco.begin(1, channels, det)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = reco.run(evt, st, max_distance=1000.0, z_range=(-1000.0, -50.0))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    # the rest of the vertex path: the CPU given the card's tables
    on_cpu = vx.neutrino3DVertexReconstructor(ice, device="cpu")
    on_cpu._tables = {k: (h, t.cpu()) for k, (h, t) in reco._tables.items()}
    on_cpu.begin(1, channels, det)
    v_cpu = on_cpu.run(evt, st, max_distance=1000.0, z_range=(-1000.0, -50.0))
    assert np.array_equal(np.asarray(v), np.asarray(v_cpu)), (v, v_cpu)
    r, r_true = np.hypot(v[0], v[1]), np.hypot(truth[0], truth[1])
    d_az = abs(np.arctan2(v[1], v[0]) - np.arctan2(truth[1], truth[0]))
    print(f"phase 12 (c) 3D vertex (run_reco_chain.py's search volume, coarse_steps 24, n_zoom "
          f"3, 28 pairs x 9 ray-type pairs): {np.round(v, 1)} m against the truth {truth} m, "
          f"{t_run:.3f} s ({CARD}); the CPU given the card's tables: the same vertex")
    b = examples.VERTEX_BOUNDS
    assert d_az < np.deg2rad(b["azimuth_deg"]), v
    assert abs(v[2] / r - truth[2] / r_true) < b["slope"], v
    assert abs(r - r_true) < b["range_m"], v
    return total


def _p12_direction(dev, ice, det, evt, st, noise):
    """(d) the neutrino direction and energy at the defaults, on the card,
    chi2 of 256 random triples recomputed on the CPU."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.reco import examples, nu_direction as nd

    t = examples.RECO_CHAIN_TRUTH
    w = {"zenith_range": (t["zenith"] - np.deg2rad(10), t["zenith"] + np.deg2rad(10)),
         "azimuth_range": (t["azimuth"] - np.deg2rad(10), t["azimuth"] + np.deg2rad(10)),
         "energy_range": (t["log10_energy"] - 1, t["log10_energy"] + 1)}
    channels = list(range(len(examples.RECO_CHAIN_POSITIONS)))
    reco = nd.neutrinoDirectionReconstructor(device=dev)
    reco.begin(ice, attenuation_model="GL1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zen, az, logE = reco.run(evt, st, det, vertex=t["vertex"], use_channels=channels,
                             noise_RMS=noise, **w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_triples = sum(len(p) for p, _ in reco.grids)
    cpu = nd.neutrinoDirectionReconstructor(device="cpu")
    cpu.begin(ice, attenuation_model="GL1")
    cpu.run(evt, st, Detector(examples.RECO_CHAIN_DETECTOR), vertex=t["vertex"],
            use_channels=channels, noise_RMS=noise, coarse_steps=(2, 2, 2), n_zoom=0, **w)
    gen = np.random.default_rng(13)
    pts = np.concatenate([p for p, _ in reco.grids])
    chi2 = np.concatenate([c for _, c in reco.grids])
    pick = gen.choice(len(pts), 256, replace=False)
    ref = cpu.chi2(pts[pick]).numpy()
    worst = float(np.max(np.abs(chi2[pick] - ref) / np.abs(ref)))
    assert worst <= RECO_CHI2_RTOL, worst
    truth = np.array([[t["zenith"], t["azimuth"], t["log10_energy"]]])
    chi2_truth, chi2_fit = (float(reco.chi2(p)) for p in (truth, np.array([[zen, az, logE]])))
    print(f"phase 12 (d) neutrino direction at the defaults (20 x 20 x 16, n_zoom 2, GL1, +-10 "
          f"deg / +-1 dex, {len(channels)} channels, the true vertex): ({np.rad2deg(zen):.2f}, "
          f"{np.rad2deg(az):.2f}) deg, log10 E {logE:.3f} against (120, 35) deg, 17.5, chi2 "
          f"{chi2_fit:.1f} (at the truth {chi2_truth:.1f}); {n_triples} triples in {secs:.3f} s = "
          f"{n_triples / secs:.0f} triples/s; chi2 of 256 random triples on the CPU within "
          f"{worst:.2e} relative (gate {RECO_CHI2_RTOL:g}) ({CARD})")
    # the physics gate on run_reco_chain.py's own grid (odd steps: the
    # window's centre is a grid point; the defaults' even grid is not)
    zen, az, logE = reco.run(evt, st, det, vertex=t["vertex"], use_channels=channels,
                             noise_RMS=noise, coarse_steps=(9, 9, 9), n_zoom=2, **w)
    b = examples.DIRECTION_BOUNDS
    d_az = abs(np.mod(az - t["azimuth"] + np.pi, 2 * np.pi) - np.pi)
    assert abs(zen - t["zenith"]) < np.deg2rad(b["zenith_deg"]), zen
    assert d_az < np.deg2rad(b["azimuth_deg"]), az
    assert abs(logE - t["log10_energy"]) < b["log10_energy"], logE
    print(f"phase 12 (d) neutrino direction on the example's grid (9 x 9 x 9, n_zoom 2): "
          f"({np.rad2deg(zen):.2f}, {np.rad2deg(az):.2f}) deg, log10 E {logE:.3f}, within "
          f"tests/test_nu_direction.py's bounds of the truth")


def _p12_fitters(dev):
    """(e) the correlation and beam-forming fitters at their default grids
    and the IFT unfolding's 600 Adam steps, card against CPU."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev, parameters as fpar
    from nuradiomc_tpu_torch.reco import direction as rdir, efield_converters as ec
    from nuradiomc_tpu_torch.reco import examples, ift_efield

    stnp = fpar.stationParameters
    square = Detector(examples.SQUARE_DETECTOR)

    def vel_theta(cid, ff, zen, az):
        return ec.get_channel_vel(square, 7, cid, ff, zen, az, device="cpu")[0].numpy()

    fits = {}
    for d in (dev, "cpu"):
        out = []
        for cls, make, kw in (
                (rdir.correlationDirectionFitter, lambda: examples.plane_wave_event(fev),
                 {"n_index": 1.0}),
                (rdir.beamFormingDirectionFitter,
                 lambda: examples.beamforming_event(fev, vel_theta),
                 {"polarization": 0, "n_index": 1.0})):
            evt, st = make()
            fitter = cls(device=d)
            fitter.begin()
            t0 = time.perf_counter()
            fitter.run(evt, st, square, **kw)
            out.append((st[stnp.zenith], st[stnp.azimuth], time.perf_counter() - t0))
        fits[str(d)] = out
    for (za, aa, ta), (zb, ab, _), name in zip(fits[str(dev)], fits["cpu"],
                                              ("correlation", "beam-forming")):
        assert abs(za - zb) < 1e-9 and abs(aa - ab) < 1e-9, (name, za, zb, aa, ab)
        print(f"phase 12 (e) {name} fitter at its default grid: ({np.rad2deg(za):.3f}, "
              f"{np.rad2deg(aa):.3f}) deg on the card and the CPU, {ta:.3f} s on the card")

    mixed = Detector(examples.MIXED_DETECTOR)
    # 135 deg zenith lies exactly 45 deg off the LPDAs' axis, the edge of two
    # phase sectors: the sector the card's own arithmetic picks there, and
    # the one the reco modules take (decided on the host for every device)
    from nuradiomc_tpu_torch.ops import antenna
    zen = torch.tensor(examples.IFT_TRUTH["zenith"], dtype=torch.float64, device=dev)
    az = torch.tensor(examples.IFT_TRUTH["azimuth"], dtype=torch.float64, device=dev)
    rots = [antenna.antenna_rotation_matrix(*mixed.get_antenna_orientation(7, c))
            for c in range(4)]
    on_card = [int(antenna.analytic_vel_mix(zen, az, torch.as_tensor(r, device=dev),
                                            torch.tensor(antenna.KIND_LPDA, device=dev))[2])
               for r in rots]
    taken = [int(antenna.lpda_sector_host(zen, az, r, antenna.KIND_LPDA)) for r in rots]
    print(f"phase 12 (e) LPDA phase sector at {np.rad2deg(examples.IFT_TRUTH['zenith']):.0f} "
          f"deg zenith (a sector edge), channels 0-3: the card's own arithmetic {on_card}, "
          f"taken on every device {taken}")
    def ift_run(d, n_iterations=600):
        reco = ift_efield.iftElectricFieldReconstructor(device=d)
        reco.begin(passband=examples.IFT_TRUTH["band"], noise_rms=examples.IFT_TRUTH["noise"],
                   n_iterations=n_iterations)
        evt, st = examples.ift_event(
            fev, fpar, lambda cid, ff, z, a: [x.numpy() for x in ec.get_channel_vel(
                mixed, 7, cid, ff, z, a, device="cpu")])
        if d != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ef = reco.run(evt, st, mixed, use_channels=[0, 1, 2, 3])
        if d != "cpu":
            torch.cuda.synchronize()
        return (np.asarray(ef.get_frequency_spectrum()), time.perf_counter() - t0,
                ef[fpar.electricFieldParameters.polarization_angle])

    (sa, ta, pa), (sb, tb, _) = ift_run(dev), ift_run("cpu")
    worst = float(np.max(np.abs(sa - sb)) / np.max(np.abs(sb)))
    assert worst <= RECO_IFT_RTOL, worst
    ff = np.fft.rfftfreq(512, 1.0)
    band = (ff >= 0.08) & (ff <= 0.45)
    amp = np.sqrt(np.abs(sa[1][band]) ** 2 + np.abs(sa[2][band]) ** 2)
    true = np.abs(examples.ift_true_spectrum(ff)[band])
    good = true > 10 * examples.IFT_TRUTH["noise"]
    med = float(np.median(np.abs(amp[good] / true[good] - 1)))
    assert med < 0.25 and abs(pa - examples.IFT_TRUTH["pol"]) < 0.15, (med, pa)
    warm = ift_run(dev)[1]
    print(f"phase 12 (e) IFT unfolding (600 Adam steps, lr 0.03): spectrum card against CPU "
          f"{worst:.2e} of its peak (gate {RECO_IFT_RTOL:g}), median amplitude error "
          f"{med:.3f}, polarization {pa:.3f} (truth 0.6); on the card {ta:.2f} s the first call, "
          f"{warm:.2f} s the next, {tb:.2f} s on the CPU ({CARD})")
    steps = 50
    dev_ms, wall, n = _device_busy(lambda: ift_run(dev, steps))
    busy = "not measured" if dev_ms is None else f"{dev_ms / steps:.3f} ms"
    print(f"phase 12 (e) IFT under the profiler, {steps} steps: {n / steps:.0f} device kernels "
          f"and {busy} of device time per step, {wall / steps:.2f} ms of wall time per step "
          f"(set-up included) ({CARD})")


def _p12_triggers(dev, events):
    """(e) the trigger modules and the RNO-G surface trigger on the events
    of (a): the same decisions, times and channels on the card and the CPU."""
    import copy

    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.reco import rnog, trigger_modules as tm

    pa_det = Detector(_reco_gold("trigger_test_detector.json"))

    def run(d):
        mods = {name: getattr(tm, name)(device=d) for name in (
            "triggerSimulatorSimple", "triggerSimulatorHighLow", "triggerSimulatorMultiHighLow",
            "BeamformedPowerIntegrationTrigger")}
        mods["BeamformedPowerIntegrationTrigger"].begin()
        surface = rnog.rnogSurfaceTrigger(device=d)
        rows = []
        for name, evts in events.items():
            for evt in copy.deepcopy(evts):
                for st in evt.get_stations():
                    ids = list(st.get_channel_ids())
                    s = float(np.median([np.std(st.get_channel(c).get_trace()) for c in ids]))
                    mods["triggerSimulatorSimple"].run(evt, st, None, threshold=8 * s,
                                                       number_concidences=1)
                    mods["triggerSimulatorHighLow"].run(
                        evt, st, None, threshold_high=6 * s, threshold_low=-6 * s,
                        number_concidences=1)
                    mods["triggerSimulatorMultiHighLow"].run(
                        evt, st, None, trigger_name="multi", threshold_high=5 * s,
                        threshold_low=-5 * s, n_high_lows=2, number_concidences=1)
                    surface.run(evt, st, None, threshold=5 * s ** 2, triggered_channels=ids,
                                number_coincidences=1, temperature=300 * units.kelvin)
                    if name == "trigger_test_input.nur":
                        mods["BeamformedPowerIntegrationTrigger"].run(
                            evt, st, pa_det, Vrms=0.02 * units.mV, threshold=1.5e-8)
                    rows.append({k: (t.has_triggered(), t.get_trigger_time(),
                                     list(t.get_triggered_channels() or []))
                                 for k, t in st.get_triggers().items()})
        return rows

    t0 = time.perf_counter()
    card = run(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cpu = run("cpu")
    assert card == cpu
    fired = {}
    for row in card:
        for k, (f, _, _) in row.items():
            fired[k] = fired.get(k, 0) + int(f)
    print(f"phase 12 (e) trigger modules and the RNO-G surface trigger on the {len(card)} "
          f"stations of (a): decisions, times and channels equal on the card and the CPU; "
          f"fired {fired}; {secs:.2f} s on the card ({CARD})")


def phase_reco(dev):
    """The in-ice reconstruction path on the card (the ray solver and
    torch; none of the four other kernels): (a) NuRadioReco's files, (b)
    the example-03 chain, (c) the vertex at full size, (d) the neutrino
    direction at full size, (e) the direction fitters, the IFT unfolding
    and the trigger modules. Returns the launch counts of the path."""
    import shutil
    import tempfile

    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.reco import examples, nu_direction as nd

    t_phase = time.perf_counter()
    _reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reco_")
    try:
        events = _p12_files(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _p12_chain(dev)
    ice = ice_models.get_ice_model(examples.GREENLAND)
    det = Detector(examples.RECO_CHAIN_DETECTOR)
    forward = nd.neutrinoDirectionReconstructor(device=dev)
    forward.begin(ice, attenuation_model="GL1")
    evt, st, noise = examples.reco_chain_event(fev, forward, det)
    t_tables = _p12_vertex(dev, ice, det, evt, st)
    _p12_direction(dev, ice, det, evt, st, noise)
    _p12_fitters(dev)
    _p12_triggers(dev, events)
    counts = _launch_counts()
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s (tables {t_tables:.1f} s); "
          f"launches {counts} (the ray solver's; no other kernel) ({CARD})")
    return counts


# ---- phase 13: ray solvers beyond the analytic one, noise-rate tuning, the
# RNO-G hardware response, and the LPDA phase sector on its edges

LPDA_SECTOR_JAX_SETS = DATA_DIR / "lpda_sector_jax_sets.npz"


def _bits_differ(a, b):
    """How many elements of two tensors of one shape differ in any bit, and
    the largest difference in units in the last place."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if not a.is_floating_point():
        return int((a != b).sum()), 0
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    ia, ib = a.contiguous().view(it).to(torch.int64), b.contiguous().view(it).to(torch.int64)
    return int((ia != ib).sum()), int((ia - ib).abs().max()) if ia.numel() else 0


def _p13_sectors(dev):
    """(e) the analytic LPDA's phase sector at arrivals on its edges (135 deg
    zenith on examples.MIXED_DETECTOR's downward LPDAs, and the IFT
    geometry). Measures, step by step, where the card's float64 arithmetic
    leaves the CPU's (each step fed the CPU's own inputs): the old decision
    (angles and back, einsum rotation, vector_norm, arccos) against the one
    the port takes (``antenna.lpda_sector`` of the receive vector). Then
    ``simulate_batch`` on the card with those arrivals: its sectors equal to
    the CPU's and to the JAX package's for each arrival direction
    (``lpda_sector_jax_sets.npz``), kernels 1 and 2 against their plain
    versions on the run's own launches."""
    from nuradiomc_tpu_torch.ops import antenna, raytrace
    from nuradiomc_tpu_torch.reco import examples
    from nuradiomc_tpu_torch.utils import geometry

    with np.load(LPDA_SECTOR_JAX_SETS) as z:
        sets = {k: z[k] for k in z.files}
    f64 = torch.float64
    rots = torch.as_tensor(sets["rotations"], dtype=f64)
    A = sets["receive"].shape[0]
    lpda = torch.tensor(antenna.KIND_LPDA)
    deg45, deg90 = 45 * units.deg, 90 * units.deg

    def old_sector(theta):
        return torch.where(theta <= deg45, 0, torch.where(theta <= deg90, 1, 2))

    rec = torch.as_tensor(sets["receive"], dtype=f64)[:, None, :].expand(A, 4, 3)
    ift_zen = torch.full((4,), examples.IFT_TRUTH["zenith"], dtype=f64)
    ift_az = torch.full((4,), examples.IFT_TRUTH["azimuth"], dtype=f64)
    steps = {
        "cartesian_to_spherical (vector_norm, arccos, atan2)":
            lambda d, x: torch.stack(geometry.cartesian_to_spherical(x["rec"].to(d)), -1),
        "spherical_to_cartesian (sin, cos)":
            lambda d, x: geometry.spherical_to_cartesian(x["zen"].to(d), x["az"].to(d)),
        "einsum rotation (a batched matmul on the card)":
            lambda d, x: torch.einsum("...ij,...j->...i", x["rot"].to(d), x["v"].to(d)),
        "vector_norm": lambda d, x: torch.linalg.vector_norm(x["old_ant"].to(d), dim=-1),
        "division z / r": lambda d, x: x["old_ant"][..., 2].to(d) / x["old_r"].to(d),
        "arccos": lambda d, x: torch.arccos(torch.clamp(x["old_c"].to(d), -1.0, 1.0)),
        "old sector (<= 45, 90 deg)": lambda d, x: old_sector(x["old_theta"].to(d)),
        "antenna._rotate (emulated fused multiply-adds)":
            lambda d, x: antenna._rotate(x["rot"].to(d), x["v"].to(d)),
        "antenna._norm (emulated, rounded-to-nearest sqrt)":
            lambda d, x: antenna._norm(x["new_ant"].to(d)),
        "antenna.lpda_sector": lambda d, x: antenna.lpda_sector(lpda.to(d), x["new_ant"].to(d)),
    }

    def chain(d, zen, az, direction=None):
        """Every intermediate of both decisions on device ``d``."""
        x = {"zen": zen.to(d), "az": az.to(d), "rot": rots.to(d).expand(*zen.shape, 3, 3)}
        x["v"] = geometry.spherical_to_cartesian(x["zen"], x["az"])
        x["old_ant"] = torch.einsum("...ij,...j->...i", x["rot"], x["v"])
        x["old_r"] = torch.linalg.vector_norm(x["old_ant"], dim=-1)
        x["old_c"] = x["old_ant"][..., 2] / x["old_r"]
        x["old_theta"] = torch.arccos(torch.clamp(x["old_c"], -1.0, 1.0))
        x["new_ant"] = antenna._rotate(x["rot"], x["v"] if direction is None
                                       else direction.to(d))
        return x

    for label, make, direction, want in (
            ("edge arrivals", lambda d: geometry.cartesian_to_spherical(rec.to(d)), rec,
             sets["edge_direct"]),
            ("IFT geometry (angles)", lambda d: (ift_zen.to(d), ift_az.to(d)), None,
             sets["ift"])):
        cpu = chain("cpu", *make("cpu"), direction)
        cpu["rec"] = rec
        card = chain(dev, *make(dev), direction)
        for name, fn in steps.items():
            if name.startswith("cartesian") and direction is None:
                continue
            n, ulp = _bits_differ(fn(dev, cpu), fn("cpu", cpu))
            print(f"phase 13 (e) {label}: {name} on the card from the CPU's inputs: {n} of "
                  f"{fn('cpu', cpu).numel()} elements differ (at most {ulp} ulp)")
        old = [old_sector(x["old_theta"]).cpu() for x in (card, cpu)]
        new = [antenna.lpda_sector(lpda.to(x["v"].device), x["new_ant"]).cpu()
               for x in (card, cpu)]
        want = torch.as_tensor(want)
        print(f"phase 13 (e) {label}: whole chain, old decision (angles, einsum, vector_norm, "
              f"arccos): card and CPU differ in {int((old[0] != old[1]).sum())} of "
              f"{old[0].numel()} sectors, card and JAX package in "
              f"{int((old[0] != want).sum())}; lpda_sector of "
              f"{'the receive vector' if direction is not None else 'the angles on the device'}"
              f": card and CPU differ in {int((new[0] != new[1]).sum())}, card and JAX "
              f"package in {int((new[0] != want).sum())}")
        if direction is not None:
            assert torch.equal(new[0], new[1]) and torch.equal(new[0], want), label
            print(f"phase 13 (e) the JAX pipeline's own round trip through angles moves "
                  f"{int((torch.as_tensor(sets['edge']) != want).sum())} of {want.numel()} "
                  f"arrivals across the edge (the JAX set 'edge')")
        else:
            host = torch.stack([antenna.lpda_sector_host(ift_zen.to(dev), ift_az.to(dev), r,
                                                         antenna.KIND_LPDA)[c]
                                for c, r in enumerate(sets["rotations"])])
            print(f"phase 13 (e) {label}: lpda_sector_host (the reco modules) {host.tolist()}")
            assert torch.equal(host, want)

    # simulate_batch with the edge arrivals, card against CPU and the JAX set
    got = {}
    for d in (dev, "cpu"):
        s, ch, b, vectors = convert.make_lpda_edge_inputs(device=d)
        mix, solver_vectors, seen = antenna.analytic_vel_mix, raytrace.launch_receive_vectors, []

        def recording(*args, **kw):
            out = mix(*args, **kw)
            seen.append(out[2])
            return out

        antenna.analytic_vel_mix, raytrace.launch_receive_vectors = recording, vectors
        try:
            if d == dev:
                _reset_launches()
                with _Recorder() as rec_k:
                    out = pipeline.simulate_batch(b, ch, s)
                counts = _launch_counts()
                plain = pipeline.simulate_batch(b, ch, dataclasses.replace(
                    s, placement_impl="plain", trigger_impl="plain"))
            else:
                out = pipeline.simulate_batch(b, ch, s)
        finally:
            antenna.analytic_vel_mix, raytrace.launch_receive_vectors = mix, solver_vectors
        got[str(d)] = (seen[0].cpu(), out)
    sec_card, out_card = got[str(dev)]
    sec_cpu, out_cpu = got["cpu"]
    want = torch.as_tensor(sets["edge_direct"])[:, None, :, None].expand(sec_card.shape)
    print(f"phase 13 (e) simulate_batch, {A} groups x 2 showers x 4 LPDAs x 2 slots at the "
          f"edge arrivals (float64): sectors card vs CPU differ in "
          f"{int((sec_card != sec_cpu).sum())}, card vs the JAX package in "
          f"{int((sec_card != want).sum())} of {sec_card.numel()}; launches {counts}")
    assert torch.equal(sec_card, sec_cpu) and torch.equal(sec_card, want)
    assert torch.equal(out_card.triggered, plain.triggered)
    torch.testing.assert_close(out_card.max_amplitude, plain.max_amplitude, rtol=1e-12, atol=0)
    peak = out_cpu.max_amp_per_solution.abs().max()
    err = (out_card.max_amp_per_solution.cpu() - out_cpu.max_amp_per_solution).abs().max()
    print(f"phase 13 (e) per-solution amplitudes card vs CPU {float(err / peak):.3e} of peak")
    assert float(err) <= 1e-9 * float(peak)
    # no group fires at these arrivals, so kernel 2 is held through the step
    # (triggered and amplitudes against the plain path, above), kernel 1 on
    # its own launch
    rec_k.calls.pop("irfft_trigger", None)
    print("phase 13 (e) irfft_trigger: no group fires at the edge arrivals; held through the "
          "step's decisions and amplitudes against the plain path")
    _check_recorded(rec_k.calls, "LPDA edge arrivals", "phase 13 (e)")
    return counts


# tests/test_noise_rate.py's 4-channel deep phased array behind its ADC
P13_FS, P13_N, P13_C = 2.0, 1024, 4
P13_VRMS = 5.6749e-6
P13_REFERENCE_VRMS2 = 30.85      # the reference's 100 Hz threshold, D05phased_array_deep.py:20-22


def _p13_pa_setup():
    from nuradiomc_tpu_torch.ops import filters
    ff = np.fft.rfftfreq(P13_N, 1 / P13_FS)
    chain = [((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
             ((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1})]
    filt = filters.chain_response(ff, chain)
    bw = filters.bandwidth_integral(ff, filt)
    amp = P13_VRMS / np.sqrt(bw / (0.5 * P13_FS))
    rolls = phased_array.beam_rolls(np.array([-197.0, -198.0, -199.0, -200.0]), np.zeros(4),
                                    phased_array.default_angles, 1.75, 1.0)
    kw = dict(window=16, step=8, adc_fs=0.5, adc_nbits=8, adc_range=P13_VRMS * 255 / 15,
              upsampling=2)
    return filt, amp, rolls, kw


def _p13_noise_rate(dev):
    """(a) the noise-trigger-rate tuning: 2^20 traces in float32 on the card
    (traces/s, windows/s, the 100 Hz threshold beside the reference's, the
    rate curve monotone), then 8192 traces whose card draws go to the CPU:
    the card's and the CPU's transforms in float64 within 1e-9."""
    from nuradiomc_tpu_torch.sim import noise_rate
    filt, amp, rolls, kw = _p13_pa_setup()
    n_traces, batch = 1 << 20, 1 << 16
    duration = P13_N / P13_FS
    noise_rate.run_phased_array_tuning(batch, P13_N, P13_FS, amp, filt, rolls, P13_C, seed=9,
                                       batch=batch, device=dev, dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mp = noise_rate.run_phased_array_tuning(n_traces, P13_N, P13_FS, amp, filt, rolls, P13_C,
                                            seed=1, batch=batch, device=dev,
                                            dtype=torch.float32, **kw)
    secs = time.perf_counter() - t0
    # windows per trace: beams x power windows of the upsampled trace
    n_up = (P13_N * 5 // 2) // 10 * kw["upsampling"]
    windows = len(phased_array.default_angles) * ((n_up - kw["window"]) // kw["step"] + 1)
    thr = noise_rate.tune_threshold(100 * units.Hz, mp, duration)
    thrs = np.linspace(5, 40, 36) * P13_VRMS ** 2
    rates = noise_rate.estimate_rate_curve(thrs, mp, duration)
    print(f"phase 13 (a) noise-rate tuning, {n_traces} traces x {P13_C} channels in float32 "
          f"(batches of {batch}): {secs:.3f} s, {n_traces / secs:,.0f} traces/s, "
          f"{n_traces * windows / secs:,.0f} beam windows/s ({windows} a trace); threshold "
          f"for 100 Hz {thr / P13_VRMS ** 2:.3f} Vrms^2 (the reference's {P13_REFERENCE_VRMS2}; "
          f"no gate) ({CARD})")
    assert np.all(np.diff(rates) <= 0) and rates[0] > rates[-1]

    # card draws to the CPU: the two transforms in float64
    gen = noise_rate.chunk_generator(3, 0, dev)
    draws = noise.draw_noise(gen, (8192, P13_C), P13_N, torch.float64)
    maxima = []
    for d in (dev, "cpu"):
        spec = noise.noise_spectrum_from_draws(
            tuple(x.to(d) for x in draws), P13_N, P13_FS,
            torch.tensor(amp, dtype=torch.float64, device=d), None, P13_FS / 2)
        maxima.append(noise_rate.max_beam_power_from_spectra(
            spec, P13_N, P13_FS, filt, rolls, **kw).cpu())
    rel = float(((maxima[0] - maxima[1]).abs() / maxima[1].abs()).max())
    print(f"phase 13 (a) 8192 traces drawn on the card, float64: card vs CPU maxima {rel:.3e} "
          f"relative (gate 1e-9)")
    assert rel <= 1e-9


def _p13_numeric(dev):
    """(b) the stratified numeric solver on 65,536 firn pairs (solves/s in
    float64, float32 reported only), 1024 of them against the CPU: masks
    equal, Snell parameter, travel time and path length within 1e-9, those
    of rays turning near the firn's segment boundary or just above the
    receiver reported apart (within 1e-3, the quadrature's own error)."""
    from nuradiomc_tpu_torch.models import ice_profiles
    from nuradiomc_tpu_torch.ops import raytrace_numeric
    prof = ice_profiles.greenland_firn
    n = 65536
    rng = np.random.default_rng(13)
    z1, z2, r = rng.uniform(-1200, -200, n), rng.uniform(-150, -30, n), rng.uniform(100, 1200, n)
    out = {}
    for dtype in (torch.float64, torch.float32):
        args = [torch.as_tensor(x, dtype=dtype, device=dev) for x in (np.zeros(n), z1, r, z2)]
        raytrace_numeric.find_solutions_numeric(prof, *(a[:256] for a in args), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[dtype] = raytrace_numeric.find_solutions_numeric(prof, *args, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"phase 13 (b) numeric solver, {n} firn pairs x 2 slots, {dtype}: {secs:.3f} s, "
              f"{n / secs:,.0f} pair solves/s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              f" GiB ({CARD})")
    card = out[torch.float64]
    k = 1024
    cpu = raytrace_numeric.find_solutions_numeric(prof, np.zeros(k), z1[:k], r[:k], z2[:k],
                                                  device="cpu")
    mask = cpu.mask
    assert torch.equal(card.mask[:k].cpu(), mask) and bool(mask.any())
    # rays turning within 1 m of the firn's segment boundary (-14.9 m), where
    # n(z) steps down by 7e-4: there the turning-depth bisection has two
    # crossings to choose from, a last bit decides which, and the quadrature
    # grids (192 points up to that depth) move with it; and refracted rays
    # turning within 1 m above the receiver
    z_b = prof.z_tops[1]
    near_b = ((cpu.s >= prof.index_of_refraction(torch.tensor(z_b + 1.0, dtype=torch.float64)))
              & (cpu.s <= prof.index_of_refraction(torch.tensor(z_b - 1.0, dtype=torch.float64))))
    n_near = prof.index_of_refraction(torch.as_tensor(z2[:k]) + 1.0)[:, None]
    near_r = (cpu.sol_type == 2) & (cpu.s >= n_near)
    worst = {}
    for field in ("s", "travel_time", "path_length"):
        a, b = getattr(card, field)[:k].cpu(), getattr(cpu, field)
        rel = ((a - b).abs() / b.abs().clamp(min=1e-300))
        for label, sel in (("elsewhere", mask & ~near_b & ~near_r),
                           ("near the firn boundary", mask & near_b),
                           ("turning near the receiver", mask & near_r)):
            worst[field, label] = float(rel[sel].max()) if bool(sel.any()) else 0.0
    print(f"phase 13 (b) 1024 pairs card vs CPU (float64): masks equal ({int(mask.sum())} valid "
          f"slots, {int((mask & near_b).sum())} turning within 1 m of the firn boundary, "
          f"{int((mask & near_r).sum())} within 1 m above the receiver); relative "
          + ", ".join(f"{f} {lab} {v:.3e}" for (f, lab), v in worst.items()))
    assert all(v <= 1e-9 for (f, lab), v in worst.items() if lab == "elsewhere")
    assert all(v <= 1e-3 for v in worst.values())


def _p13_rays3d(dev):
    """(c) tests/test_raytrace_3d.py's cases at their full settings on the
    card, held to the port's analytic solver at that test's tolerances, and
    the Newton polish of its tilted field; seconds each."""
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.ops import raytrace, raytrace_3d
    ice = ice_models.southpole_simple
    f64 = torch.float64

    def strat(x, y, z):
        return torch.where(z > 0, 1.000293, ice.index_of_refraction(z))

    def blob(x, y, z):
        b = 0.05 * torch.exp(-(((x - 300.0) / 120.0) ** 2 + (y / 120.0) ** 2
                               + ((z + 450.0) / 120.0) ** 2))
        return strat(x, y, z) + torch.where(z > 0, 0.0, b)

    def tilt(x, y, z):
        return strat(x, y, z) + torch.where(z > 0, 0.0, 2e-5 * y)

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def analytic(src, rec):
        x1, x2 = torch.tensor(src, dtype=f64), torch.tensor(rec, dtype=f64)
        geom = raytrace.to_2d(x1, x2)
        sols = raytrace.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z, ice)
        launch, _ = raytrace.launch_receive_vectors(geom, sols)
        return sols, launch

    # the CUDA-graph blocks of the RK4 loop change no number: a fan and a
    # Newton evaluation (with its tangents), graphs on and off
    x1 = torch.tensor((600.0, 200.0, -800.0), dtype=f64, device=dev)
    x2 = torch.tensor((0.0, 0.0, -100.0), dtype=f64, device=dev)
    fan = torch.linspace(0.02, math.pi - 0.02, 90, dtype=f64, device=dev)
    angles = torch.stack([fan, torch.full_like(fan, 1e-3)], dim=-1)
    tangent = torch.ones_like(angles)
    runs = []
    for graph_steps in (raytrace_3d._GRAPH_STEPS, 0):
        saved, raytrace_3d._GRAPH_STEPS = raytrace_3d._GRAPH_STEPS, graph_steps
        try:
            m, rec = raytrace_3d._miss_of_zenith(strat, x1, x2, fan, 1.0, 450)
            m2, rec2 = raytrace_3d._miss2_of_angles(tilt, x1, x2, angles[:, 0], angles[:, 1],
                                                    1.0, 450, tangent=tangent)
            runs.append([m, rec["t"], rec["p"], m2, rec2["z_dot"], rec2["lat_dot"]])
        finally:
            raytrace_3d._GRAPH_STEPS = saved
    differ = sum(_bits_differ(a, b)[0] for a, b in zip(*runs))
    print(f"phase 13 (c) RK4 in CUDA graphs of {raytrace_3d._GRAPH_STEPS} steps against eager "
          f"launches (450 steps, 90 rays, with and without tangents): {differ} numbers differ")
    assert differ == 0

    for src, rec, n_steps in (((600.0, 200.0, -800.0), (0.0, 0.0, -100.0), 6000),
                              ((1200.0, -300.0, -1500.0), (0.0, 0.0, -200.0), 6000)):
        s3, secs = timed(raytrace_3d.find_solutions_3d, strat, src, rec, ds=1.0, n_steps=n_steps,
                         device=dev)
        ana, launch = analytic(src, rec)
        m3, ma = s3.mask.cpu(), ana.mask
        assert int(m3.sum()) == int(ma.sum()), (m3, ma)
        lz3 = torch.sort(s3.launch_zenith.cpu()[m3]).values
        lza = torch.sort(torch.arccos(torch.clamp(launch[ma][:, 2], -1, 1))).values
        worst = float((lz3 - lza).abs().max())
        rel = [float((torch.sort(getattr(s3, f).cpu()[m3]).values
                      / torch.sort(getattr(ana, f)[ma]).values - 1).abs().max())
               for f in ("path_length", "travel_time")]
        print(f"phase 13 (c) 3D solver, stratified {src} -> {rec}, ds 1 m, {n_steps} steps, fan 90,"
              f" 30 bisections: {secs:.2f} s; {int(m3.sum())} solutions, against the analytic "
              f"solver launch zenith {worst:.2e} rad (gate 2e-3), path {rel[0]:.2e}, time "
              f"{rel[1]:.2e} (gate 2e-3) ({CARD})")
        assert worst < 2e-3 and max(rel) < 2e-3

    src, rec = (700.0, 0.0, -300.0), (0.0, 0.0, -50.0)
    s3, secs = timed(raytrace_3d.find_solutions_3d, strat, src, rec, ds=1.0, n_steps=4000,
                     device=dev)
    ana, _ = analytic(src, rec)
    n_refl_ana = int(((ana.sol_type == raytrace.SOL_REFLECTED) & ana.mask).sum())
    n_refl_3d = int((s3.n_reflections.cpu()[s3.mask.cpu()] > 0).sum())
    print(f"phase 13 (c) 3D solver, the surface bounce {src} -> {rec}: {secs:.2f} s; bounced "
          f"solutions {n_refl_3d}, the analytic solver's reflected {n_refl_ana} ({CARD})")
    assert n_refl_3d == n_refl_ana

    src, rec = (600.0, 0.0, -800.0), (0.0, 0.0, -100.0)
    pert, secs_p = timed(raytrace_3d.find_solutions_3d, blob, src, rec, ds=1.0, n_steps=4000,
                         device=dev)
    base, secs_b = timed(raytrace_3d.find_solutions_3d, strat, src, rec, ds=1.0, n_steps=4000,
                         device=dev)
    mp, mb = pert.mask.cpu(), base.mask.cpu()
    tp = float(torch.sort(pert.travel_time.cpu()[mp]).values[0])
    tb = float(torch.sort(base.travel_time.cpu()[mb]).values[0])
    print(f"phase 13 (c) 3D solver, the blob field: {secs_p:.2f} s (base {secs_b:.2f} s); "
          f"first arrival moved {tp - tb:.3f} ns (bounds 0.05-50) ({CARD})")
    assert mp.sum() >= 1 and mb.sum() >= 1 and 0.05 < abs(tp - tb) < 50.0

    src, rec = (500.0, 0.0, -700.0), (0.0, 0.0, -100.0)
    sols, secs_f = timed(raytrace_3d.find_solutions_3d, tilt, src, rec, ds=1.0, n_steps=3000,
                         device=dev)
    (refined, beta), secs_n = timed(raytrace_3d.refine_solutions_3d, tilt, src, rec, sols,
                                    ds=1.0, n_steps=3000, device=dev)
    mr = refined.mask.cpu()
    miss, _ = raytrace_3d._miss2_of_angles(
        tilt, torch.tensor(src, dtype=f64, device=dev), torch.tensor(rec, dtype=f64, device=dev),
        refined.launch_zenith, beta, 1.0, 3000)
    worst = float(miss.cpu()[mr].abs().max())
    beta_max = float(beta.cpu()[mr].abs().max())
    print(f"phase 13 (c) Newton polish of the tilted field: find {secs_f:.2f} s, 6 Newton steps "
          f"{secs_n:.2f} s; {int(mr.sum())} solutions, miss after {worst:.2e} m (gate 0.05), "
          f"out-of-plane azimuth up to {beta_max:.2e} rad ({CARD})")
    assert int(mr.sum()) >= 1 and worst < 0.05 and beta_max > 1e-5


def _p13_ice_to_air(dev):
    """(d) 100k ice-to-air pairs on the card, solves/s, against the CPU."""
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.ops import raytrace
    ice = ice_models.southpole_2015
    n = 100_000
    rng = np.random.default_rng(17)
    pts = np.stack([np.zeros(n), rng.uniform(-1000.0, -5.0, n), rng.uniform(10.0, 3000.0, n),
                    rng.uniform(1.0, 2000.0, n)])
    args = [torch.as_tensor(x, device=dev) for x in pts]
    raytrace.find_solution_ice_to_air(*(a[:256] for a in args), ice, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = raytrace.find_solution_ice_to_air(*args, ice, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cpu = raytrace.find_solution_ice_to_air(*pts, ice, device="cpu")
    assert torch.equal(card.mask.cpu(), cpu.mask)
    m = cpu.mask
    rel = {f: float(((getattr(card, f).cpu() - getattr(cpu, f)).abs()
                     / getattr(cpu, f).abs().clamp(min=1e-300))[m].max())
           for f in ("c0", "travel_time", "path_length")}
    print(f"phase 13 (d) ice-to-air, {n} pairs (float64): {secs:.3f} s, {n / secs:,.0f} solves/s;"
          f" {int(m.sum())} reachable; card vs CPU relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (gate 1e-9) ({CARD})")
    assert max(rel.values()) <= 1e-9


P13_CR_DETECTOR = {"channels": {"1": {
    "adc_n_samples": 2048, "adc_sampling_frequency": 3.2,
    "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
    "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -2.0,
    "ant_rotation_phi": 160.0, "ant_rotation_theta": 90.0,
    "ant_type": "analytic_LPDA", "amp_type": "rno_surface",
    "cab_time_delay": 0.0, "adc_nbits": None,
    "channel_id": 0, "station_id": 101}},
    "stations": {"1": {"station_id": 101, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}}}


def _p13_templates(dev):
    """(f) tests/test_rnog.py's cosmic-ray templates on the card against the
    CPU, each within 1e-10 of its peak."""
    import pickle
    import tempfile
    from nuradiomc_tpu_torch.reco import rnog
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_templates_") as tmp:
        for d in (dev, "cpu"):
            creator = rnog.crRNOGTemplateCreator(device=d)
            creator.begin(P13_CR_DETECTOR, tmp)
            creator.set_template_parameter(
                template_run_id=(0, 0), template_event_id=(0, 1),
                template_station_id=(101, 101), template_channel_id=(0, 0),
                efield_width=(5, 2), antenna_rotation=(160, 160), cr_zenith=(55, 55),
                cr_azimuth=(0, 0))
            t0 = time.perf_counter()
            creator.run(bandpass_filter={"passband": [0.08, 0.18], "filter_type": "butter",
                                         "order": 4})
            secs[str(d)] = time.perf_counter() - t0
            with open(os.path.join(tmp, "templates_cr_station_101.pickle"), "rb") as f:
                out[str(d)] = pickle.load(f)
    zen, az = np.deg2rad(55), np.deg2rad(0)
    worst = 0.0
    for width in (5, 2):
        a = np.asarray(out[str(dev)][0][zen][az][width])
        b = np.asarray(out["cpu"][0][zen][az][width])
        worst = max(worst, float(np.max(np.abs(a - b)) / np.max(np.abs(b))))
    print(f"phase 13 (f) cosmic-ray templates (widths 5, 2): card vs CPU {worst:.3e} of peak "
          f"(gate 1e-10); {secs[str(dev)]:.2f} s on the card, {secs['cpu']:.2f} s on the CPU "
          f"({CARD})")
    assert worst <= 1e-10


def phase_rays(dev):
    """Ray solvers beyond the analytic one, noise-rate tuning, the RNO-G
    hardware response and the LPDA sector on its edges; returns the kernel
    launches of the phase (kernels 1 and 2, in (e) only)."""
    t_phase = time.perf_counter()
    _p13_noise_rate(dev)
    _p13_numeric(dev)
    _p13_rays3d(dev)
    _p13_ice_to_air(dev)
    counts = _p13_sectors(dev)
    _p13_templates(dev)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s; launches {counts} ({CARD})")
    return counts


# ---- phase 14: the cosmic-ray side (float64) --------------------------------

P14_ZEN, P14_AZI = np.deg2rad(35.0), np.deg2rad(120.0)      # tests/test_lofar.py's
P14_GUESS = (P14_ZEN + np.deg2rad(3.0), P14_AZI - np.deg2rad(4.0))
P14_UNIX = 1386848000.0
P14_LOFAR = dict(n_ant=48, n_samples=65536)    # LBA_OUTER, readLOFARData's trace length
P14_RFI_BLOCK = 8192
P14_RIT = dict(n_ant=240, n_samples=2048, half_width=400.0)
P14_RIT_DEPTHS = (450.0, 550.0, 650.0, 750.0, 850.0)
P14_COREAS_CORES = 100
P14_COREAS_CPU = 8          # the first cores repeated on the CPU
P14_PLANE_DEG, P14_BEAM_DEG = 2.0, 1.5         # tests/test_lofar.py's bounds
P14_RIT_XMAX, P14_RIT_ANGLE_DEG, P14_RIT_CORE = 30.0, 0.45, 60.0   # tests/test_rit.py's


def _p14_of_peak(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _p14_angle(zen, azi, zen0, azi0):
    u = np.array([np.sin(zen) * np.cos(azi), np.sin(zen) * np.sin(azi), np.cos(zen)])
    v = np.array([np.sin(zen0) * np.cos(azi0), np.sin(zen0) * np.sin(azi0), np.cos(zen0)])
    return np.rad2deg(np.arccos(np.clip(u @ v, -1.0, 1.0)))


def _p14_lofar_chain(events, det, device, record):
    """stationRFIFilter (blocks of 8192) -> stationGalacticCalibrator ->
    stationPulseFinder -> planeWaveDirectionFitter -> beamformingDirectionFitter
    on ``events`` (one station each); ``record`` gets each module's seconds
    and station 0's state after each step."""
    from nuradiomc_tpu_torch.framework.parameters import channelParameters as chp
    from nuradiomc_tpu_torch.framework.parameters import stationParameters as stnp
    from nuradiomc_tpu_torch.reco import lofar

    def timed(name, fn):
        t0 = time.perf_counter()
        for i, event in enumerate(events):
            fn(event)
            if i == 0:
                record.setdefault("station0", {}).update(state(name, event))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        record.setdefault("seconds", {})[name] = time.perf_counter() - t0

    rfi = lofar.stationRFIFilter(device=device)
    rfi.begin(rfi_cleaning_trace_length=P14_RFI_BLOCK)
    cal = lofar.stationGalacticCalibrator(device=device)
    cal.begin()
    finder = lofar.stationPulseFinder(device=device)
    finder.begin(window=256, noise_window=10000, cr_snr=6.5, good_channels=6)
    plane = lofar.planeWaveDirectionFitter(device=device)
    plane.begin(cr_snr=6.5)
    beam = lofar.beamformingDirectionFitter(device=device)
    beam.begin(cr_snr=6.5)

    def state(name, event):
        st = next(iter(event.get_stations()))
        if name == "rfi":
            r = rfi.last_result
            return {"dirty": np.asarray(st.get_parameter(stnp.dirty_fft_channels)),
                    "ref": r["ref_antenna"], "good": r["antenna_is_good"],
                    "stability": r["phase_stability"]}
        if name == "calibrator":
            return {"spectra": np.array([ch.get_frequency_spectrum()
                                         for ch in st.iter_channels()])}
        if name == "pulse finder":
            return {"windows": [list(ch.get_parameter(chp.signal_regions))
                                for ch in st.iter_channels()],
                    "snr": np.array([ch.get_parameter(chp.SNR) for ch in st.iter_channels()])}
        if name == "beam search":
            return {"levels": beam.levels, "chunk": beam.chunk}
        return {}

    timed("rfi", lambda e: rfi.run(e))
    timed("calibrator", lambda e: cal.run(e, det, unix_time=P14_UNIX))
    timed("pulse finder", lambda e: finder.run(e, det, P14_GUESS))
    timed("plane wave", lambda e: plane.run(e, det))
    record["plane"] = [(next(iter(e.get_stations())).get_parameter(stnp.cr_zenith),
                        next(iter(e.get_stations())).get_parameter(stnp.cr_azimuth))
                       for e in events]
    timed("beam search", lambda e: beam.run(e, det))
    record["beam"] = [(next(iter(e.get_stations())).get_parameter(stnp.cr_zenith),
                       next(iter(e.get_stations())).get_parameter(stnp.cr_azimuth))
                      for e in events]


def _p14_lofar(dev):
    """(a) the six superterp stations through the LOFAR chain on the card,
    station 0 again on the CPU; returns station 0's raw event for (d)."""
    import copy

    from nuradiomc_tpu_torch.framework import event as fev

    t0 = time.perf_counter()
    event, det = convert.make_lofar_stations(fev, P14_ZEN, P14_AZI, **P14_LOFAR)
    events = []
    for st in event.get_stations():
        one = fev.Event(0, 1)
        one.set_station(st)
        events.append(one)
    raw0 = copy.deepcopy(events[0])
    cpu_events = [copy.deepcopy(events[0])]
    make_s = time.perf_counter() - t0
    n_ch = events[0].get_station(2).get_number_of_channels()
    torch.cuda.reset_peak_memory_stats()
    card, cpu = {}, {}
    _p14_lofar_chain(events, det, dev, card)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _p14_lofar_chain(cpu_events, det, "cpu", cpu)
    c0, p0 = card["station0"], cpu["station0"]
    # station 0, card against CPU
    np.testing.assert_array_equal(c0["dirty"], p0["dirty"])
    assert len(c0["dirty"]) > 0
    assert c0["ref"] == p0["ref"]
    np.testing.assert_array_equal(c0["good"], p0["good"])
    stab = float(np.max(np.abs(c0["stability"] - p0["stability"])))
    assert stab <= 1e-12, stab
    spec = _p14_of_peak(c0["spectra"], p0["spectra"])
    assert spec <= 1e-12, spec
    assert c0["windows"] == p0["windows"]
    snr = float(np.max(np.abs(c0["snr"] - p0["snr"]) / np.abs(p0["snr"])))
    assert snr <= 1e-9, snr
    worst_power = 0.0
    for (zc, ac, pc), (zp, ap, pp) in zip(c0["levels"], p0["levels"]):
        np.testing.assert_array_equal(zc, zp)
        np.testing.assert_array_equal(ac, ap)
        worst_power = max(worst_power, float(np.max(np.abs(pc - pp) / np.abs(pp))))
        assert np.argmax(pc) == np.argmax(pp)
    assert worst_power <= 1e-10, worst_power
    # all stations on the card against the injected direction
    plane_err = [_p14_angle(z, a, P14_ZEN, P14_AZI) for z, a in card["plane"]]
    beam_zen = [abs(z - P14_ZEN) for z, _ in card["beam"]]
    beam_azi = [abs((a - P14_AZI + np.pi) % (2 * np.pi) - np.pi) for _, a in card["beam"]]
    plane_zen = [abs(z - P14_ZEN) for z, _ in card["plane"]]
    plane_azi = [abs((a - P14_AZI + np.pi) % (2 * np.pi) - np.pi) for _, a in card["plane"]]
    assert max(plane_zen + plane_azi) < np.deg2rad(P14_PLANE_DEG), (plane_zen, plane_azi)
    assert max(beam_zen + beam_azi) < np.deg2rad(P14_BEAM_DEG), (beam_zen, beam_azi)
    secs = card["seconds"]
    n_dirs = len(events) * len(c0["levels"]) * c0["levels"][0][2].size
    print(f"phase 14 (a) LOFAR superterp: {len(events)} stations x {n_ch} dipoles x "
          f"{P14_LOFAR['n_samples']} samples at 200 MHz made in {make_s:.2f} s on the host; "
          f"card seconds " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; beam search {n_dirs} directions ({len(c0['levels'])} levels of 15 x 15) in "
          f"{secs['beam search']:.3f} s = {n_dirs / secs['beam search']:.0f} directions/s, "
          f"{c0['chunk']} directions per chunk, peak device memory {peak:.2f} GiB ({CARD})")
    print(f"phase 14 (a) station 0 card vs CPU: dirty channels ({len(c0['dirty'])}), reference "
          f"antenna {c0['ref']}, good antennas equal; phase stability {stab:.2e} (gate 1e-12); "
          f"calibrated spectra {spec:.2e} of peak (gate 1e-12); pulse windows equal, SNR "
          f"{snr:.2e} (gate 1e-9); grid powers {worst_power:.2e} (gate 1e-10), chosen points "
          f"equal at every level; CPU seconds " + ", ".join(
              f"{k} {v:.2f}" for k, v in cpu["seconds"].items()) + f" ({CARD})")
    print(f"phase 14 (a) directions on the card: plane wave worst {max(plane_err):.3f} deg "
          f"(gate {P14_PLANE_DEG} in zenith and azimuth), beam search worst zenith "
          f"{np.rad2deg(max(beam_zen)):.3f} deg, azimuth {np.rad2deg(max(beam_azi)):.3f} deg "
          f"(gate {P14_BEAM_DEG})")
    # one zoom level of station 0 under the profiler; its memory traffic is
    # counted from the tensors beamformer materialises (lofar.BEAM_TRAFFIC_BYTES
    # per direction, antenna and bin), not measured
    from nuradiomc_tpu_torch.reco import base, lofar
    st = events[0].get_station(2)
    dom = [ch for ch in st.iter_channels() if ch.get_id() % 2 == 0]
    spec = base.stack_spectra(dom, dev)
    freqs = torch.as_tensor(dom[0].get_frequencies(), device=dev)
    pos = torch.as_tensor(np.array([det.get_relative_position(2, ch.get_id()) for ch in dom]),
                          device=dev)
    zg, ag, _ = c0["levels"][0]
    dev_ms, wall, n_k = _device_busy(lambda: lofar.beam_powers(spec, freqs, pos,
                                                               dom[0].get_number_of_samples(),
                                                               zg, ag))
    traffic = zg.size * ag.size * spec.numel() * lofar.BEAM_TRAFFIC_BYTES
    label = (f"phase 14 (a) one beam-search level ({zg.size * ag.size} directions x "
             f"{spec.shape[0]} antennas x {spec.shape[1]} bins):")
    if dev_ms is None:
        print(f"{label} device busy share not measured (the profiler saw no device activity); "
              f"profiled call {wall:.2f} ms ({CARD})")
    else:
        print(f"{label} {dev_ms:.2f} ms of device kernels ({n_k} kernels) in a profiled call of "
              f"{wall:.2f} ms = {dev_ms / wall:.1%} busy; {traffic / 1e9:.1f} GB of memory "
              f"traffic counted from the materialised tensors (an estimate, not measured) = "
              f"{traffic / (dev_ms / 1e3) / 1e9:.0f} GB/s against {HBM_BYTES_PER_S / 1e9:.0f} "
              f"({CARD})")
    return raw0, det


def _p14_rit(dev):
    """(b) RIT depth and axis fits at 240 antennas on the card; the profile and
    one lateral plane against the CPU."""
    from nuradiomc_tpu_torch.reco import rit

    positions, traces, times, axis, _, _ = convert.make_rit_event(**P14_RIT)
    depth = rit.efieldInterferometricDepthReco(device=dev)
    depth.begin()
    t0 = time.perf_counter()
    depths, fine, sig, sig_fine, popt = depth.reconstruct_interferometric_depth(
        traces, times, positions, axis, np.zeros(3), return_profile=True)
    t_depth = time.perf_counter() - t0
    n_depth_points = len(depths) + len(fine)
    cpu = rit.efieldInterferometricDepthReco(device="cpu")
    cpu.begin()
    t0 = time.perf_counter()
    sig_cpu = cpu.sample_longitudinal_profile(traces, times, positions, axis, np.zeros(3),
                                              depths=np.concatenate([depths, fine]))
    t_depth_cpu = time.perf_counter() - t0
    profile_points = np.concatenate([
        axis * depth._at.get_distance_xmax_geometric(np.arccos(axis[2]), d, 0.0)
        for d in np.concatenate([depths, fine])[:, None]]).reshape(-1, 3)
    len_card = depth.interferometer(traces, times, positions).grids(profile_points)[4]
    len_cpu = cpu.interferometer(traces, times, positions).grids(profile_points)[4]
    same = len_card == len_cpu
    for k in np.nonzero(~same)[0]:
        print(f"phase 14 (b) profile point {k}: summed-grid length {len_card[k]} on the card, "
              f"{len_cpu[k]} on the CPU (excused)")
    prof = np.concatenate([sig, sig_fine])
    prof_err = float(np.max(np.abs(prof - sig_cpu)[same] / np.abs(sig_cpu)[same]))
    assert prof_err <= 1e-9, prof_err
    assert abs(popt[1] - 650.0) < P14_RIT_XMAX, popt

    axis_reco = rit.efieldInterferometricAxisReco(device=dev)
    axis_reco.begin()
    zen_g = np.deg2rad(32.5)
    az = np.deg2rad(70.0)
    guess = np.array([np.sin(zen_g) * np.cos(az), np.sin(zen_g) * np.sin(az), np.cos(zen_g)])
    b_field = np.array([0.0, 18.0, -49.0])
    t0 = time.perf_counter()
    zen, azi, core = axis_reco.reconstruct_shower_axis(
        traces, times, positions, guess, np.array([60.0, 0.0, 0.0]), b_field,
        depths=P14_RIT_DEPTHS, grid_size=250.0)
    t_axis = time.perf_counter() - t0
    chunks = dict(axis_reco.last_interferometer.last_chunks)
    n_axis_points = 2 * 5 * len(P14_RIT_DEPTHS) * 49
    angle = _p14_angle(zen, azi, np.deg2rad(32.0), az)
    assert angle < P14_RIT_ANGLE_DEG and np.linalg.norm(core[:2]) < P14_RIT_CORE, (angle, core)
    # one lateral plane (7 x 7 at X 650) card against CPU
    frame = rit.shower_frame(np.deg2rad(32.0), np.deg2rad(250.0), b_field)
    xs = np.linspace(-250.0, 250.0, 7)
    p_axis = axis * depth._at.get_distance_xmax_geometric(np.arccos(axis[2]), 650.0, 0.0)
    planes = {}
    for where, mod in ((dev, axis_reco), ("cpu", rit.efieldInterferometricAxisReco(device="cpu"))):
        mod.begin()
        itf = mod.interferometer(traces, times, positions)
        pts = (p_axis + xs[:, None, None] * frame[0] + xs[None, :, None] * frame[1]).reshape(-1, 3)
        planes[str(where)] = (itf.signals(pts), itf.grids(pts)[4])
    (s_card, l_card), (s_cpu, l_cpu) = planes[str(dev)], planes["cpu"]
    same_p = l_card == l_cpu
    for k in np.nonzero(~same_p)[0]:
        print(f"phase 14 (b) lateral point {k}: summed-grid length {l_card[k]} on the card, "
              f"{l_cpu[k]} on the CPU (excused)")
    plane_err = float(np.max(np.abs(s_card - s_cpu)[same_p] / np.abs(s_cpu)[same_p]))
    # the first zoom level of an axis pass (5 depths x 7 x 7 points) under the profiler
    itf = axis_reco.interferometer(traces, times, positions)
    pts = np.concatenate([(axis * depth._at.get_distance_xmax_geometric(np.arccos(axis[2]), d, 0.0)
                           + xs[:, None, None] * frame[0] + xs[None, :, None] * frame[1])
                          .reshape(-1, 3) for d in P14_RIT_DEPTHS])
    lengths = itf.grids(pts)[4]
    dev_ms, wall, n_k = _device_busy(lambda: itf.signals(pts))
    label = (f"phase 14 (b) one lateral zoom level ({len(pts)} points x {P14_RIT['n_ant']} "
             f"antennas, summed grids of {lengths.min()}-{lengths.max()} samples, "
             f"{len(np.unique(lengths))} lengths):")
    if dev_ms is None:
        print(f"{label} device busy share not measured (the profiler saw no device activity); "
              f"profiled call {wall:.2f} ms ({CARD})")
    else:
        print(f"{label} {dev_ms:.2f} ms of device kernels ({n_k} kernels) in a profiled call "
              f"of {wall:.2f} ms = {dev_ms / wall:.1%} busy ({CARD})")
    assert plane_err <= 1e-9, plane_err
    assert same.sum() >= len(same) - 2 and same_p.sum() >= len(same_p) - 2
    print(f"phase 14 (b) RIT, {P14_RIT['n_ant']} antennas x {P14_RIT['n_samples']} samples: "
          f"X_RIT {popt[1]:.2f} g/cm^2 (truth 650, gate {P14_RIT_XMAX}) from {n_depth_points} "
          f"points in {t_depth:.3f} s = {n_depth_points / t_depth:.0f} points/s (CPU "
          f"{t_depth_cpu:.2f} s for the same profile); axis {angle:.3f} deg off (gate "
          f"{P14_RIT_ANGLE_DEG}), core {np.linalg.norm(core[:2]):.1f} m (gate {P14_RIT_CORE}) from "
          f"{n_axis_points} points in {t_axis:.3f} s = {n_axis_points / t_axis:.0f} points/s, "
          f"points per chunk {chunks}; "
          f"card vs CPU: profile {prof_err:.2e}, lateral plane {plane_err:.2e} (gate 1e-9), "
          f"{(~same).sum() + (~same_p).sum()} points excused ({CARD})")


def _p14_coreas_chain(star, cores, device):
    """readCoREASDetector onto the four-LPDA station, the fold into channel
    voltages, galactic noise, ice thermal noise and the energy estimator (on
    the station's interpolated efield; the station's four LPDAs share one
    orientation, so no unfolding) for each core: the spectra after each
    adder, the energies and the seconds of each module."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework.parameters import electricFieldParameters as efp
    from nuradiomc_tpu_torch.framework.parameters import stationParameters as stnp
    from nuradiomc_tpu_torch.framework.event import ElectricField
    from nuradiomc_tpu_torch.reco import advanced, coreas_readers, efield_converters as ec

    det = Detector(convert.coreas_lpda_detector())
    secs = {}

    def tick(name, t0):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0

    t0 = time.perf_counter()
    reader = coreas_readers.readCoREASDetector(device=device)
    reader.begin(star)
    events = list(reader.run(det, cores))
    tick("reader", t0)
    fold = ec.efieldToVoltageConverter(device=device)
    fold.begin()
    galactic = advanced.channelGalacticNoiseAdder(device=device)
    galactic.begin(n_pixels=192, seed=12)
    thermal = advanced.channelIceThermalNoiseAdder(device=device)
    thetas = np.linspace(0, np.pi, 20)
    thermal.begin({-1.0: (thetas, 250.0 + 20.0 * np.cos(thetas))}, nr_phi_bins=16, seed=13)
    energy = advanced.cosmicRayEnergyReconstructor(device=device)
    energy.begin(site="summit")
    out = {"galactic": [], "thermal": [], "energy": []}
    for evt in events:
        st = evt.get_station(7)
        t0 = time.perf_counter()
        fold.run(evt, st, det)
        tick("fold", t0)
        t0 = time.perf_counter()
        galactic.run(evt, st, det)
        tick("galactic noise", t0)
        out["galactic"].append(np.array([c.get_frequency_spectrum() for c in st.iter_channels()]))
        t0 = time.perf_counter()
        thermal.run(evt, st, det)
        tick("thermal noise", t0)
        out["thermal"].append(np.array([c.get_frequency_spectrum() for c in st.iter_channels()]))
        t0 = time.perf_counter()
        sim_ef = st.get_sim_station().get_electric_fields()[0]
        ef = ElectricField(sim_ef.get_channel_ids(), position=sim_ef.get_position())
        ef.set_trace(np.asarray(sim_ef.get_trace()), sim_ef.get_sampling_rate())
        ef[efp.cr_spectrum_slope] = -2.5            # as tests/test_misc_modules.py
        ef[efp.cr_spectrum_quadratic_term] = 0.1
        st.add_electric_field(ef)
        st[stnp.zenith] = st.get_sim_station()[stnp.zenith]
        st[stnp.azimuth] = st.get_sim_station()[stnp.azimuth]
        out["energy"].append(energy.run(evt, st))
        tick("energy", t0)
    out["seconds"] = secs
    return out


def _p14_coreas(dev):
    """(c) a 160-observer CoREAS star read through the mapping path onto 100
    cores, noise adders and the energy estimator; the first cores again on
    the CPU."""
    from nuradiomc_tpu_torch.reco import coreas_readers

    star = convert.make_coreas_star()
    cores = coreas_readers.get_random_core_positions(-150, 150, -150, 150, P14_COREAS_CORES,
                                                     seed=3)
    card = _p14_coreas_chain(star, cores, dev)
    cpu = _p14_coreas_chain(star, cores[:P14_COREAS_CPU], "cpu")
    worst = {"galactic": 0.0, "thermal": 0.0}
    for key in worst:
        for a, b in zip(card[key], cpu[key]):
            worst[key] = max(worst[key], _p14_of_peak(a, b))
        assert worst[key] <= 1e-12, (key, worst[key])
    e_err = max(abs(a - b) / abs(b) for a, b in zip(card["energy"], cpu["energy"]))
    assert e_err <= 1e-10, e_err
    energies = np.array(card["energy"])
    assert np.all(np.isfinite(energies)) and np.all(energies > 0)
    secs = card["seconds"]
    total = sum(secs.values())
    print(f"phase 14 (c) CoREAS star ({len(star['CoREAS']['observers'])} observers x 2048 "
          f"samples at 0.2 ns, mapping path) onto {len(cores)} cores of the four-LPDA station: "
          f"card seconds " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f" = {len(cores) / total:.1f} cores/s; energies {energies.min():.3e}.."
          f"{energies.max():.3e} eV; first {P14_COREAS_CPU} cores card vs CPU: spectra after "
          f"the galactic adder {worst['galactic']:.2e}, after the thermal adder "
          f"{worst['thermal']:.2e} of peak (gate 1e-12, the same host draws), energy "
          f"{e_err:.2e} (gate 1e-10) ({CARD})")


def _p14_cleaning(dev, raw0, det):
    """(d) channelCWNotchFilter, channelStopFilter and
    channelReadoutWindowCutter on station 0 of (a), card against CPU."""
    import copy

    from nuradiomc_tpu_torch.framework import event as fev
    from nuradiomc_tpu_torch.reco import cleaning

    cut_det = copy.copy(det)
    cut_det.readout_samples = P14_LOFAR["n_samples"] // 4
    out, secs = {}, {}
    for where in (dev, "cpu"):
        evt = copy.deepcopy(raw0)
        st = next(iter(evt.get_stations()))
        trig = fev.Trigger("lora", st.get_channel_ids(),
                           pre_trigger_times=cut_det.readout_samples / 2 / convert.LOFAR_FS)
        trig.set_triggered(True)
        trig.set_trigger_time(P14_LOFAR["n_samples"] / 2 / convert.LOFAR_FS)
        st.set_trigger(trig)
        t0 = time.perf_counter()
        notch = cleaning.channelCWNotchFilter(device=where)
        notch.begin(threshold_db=10.0)
        notch.run(evt, st, det)
        cleaning.channelStopFilter(device=where).run(evt, st, det)
        cleaning.channelReadoutWindowCutter(device=where).run(evt, st, cut_det)
        secs[str(where)] = time.perf_counter() - t0
        out[str(where)] = ([np.array(c.get_trace()) for c in st.iter_channels()],
                           [c.get_trace_start_time() for c in st.iter_channels()])
    (tr_card, t_card), (tr_cpu, t_cpu) = out[str(dev)], out["cpu"]
    assert t_card == t_cpu
    worst = max(_p14_of_peak(a, b) for a, b in zip(tr_card, tr_cpu))
    assert worst <= 1e-12, worst
    print(f"phase 14 (d) cleaning of station 0 ({len(tr_card)} channels: CW notch, stop "
          f"filter, readout window of {tr_card[0].shape[0]} samples): card vs CPU {worst:.2e} "
          f"of peak (gate 1e-12), start times equal; {secs[str(dev)]:.3f} s on the card, "
          f"{secs['cpu']:.3f} s on the CPU ({CARD})")


def phase_cosmic_ray(dev):
    """The cosmic-ray side on the card in float64 (no kernel of the five):
    (a) the LOFAR chain on the six superterp stations, (b) the RIT fits,
    (c) CoREAS with the noise adders and the energy estimator, (d) the
    cleaning modules. Returns the launch counts of the path (all 0)."""
    t_phase = time.perf_counter()
    _reset_launches()
    raw0, det = _p14_lofar(dev)
    _p14_rit(dev)
    _p14_coreas(dev)
    _p14_cleaning(dev, raw0, det)
    counts = _launch_counts()
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s; launches {counts} ({CARD})")
    return counts


P15_RUNS, P15_EVENTS = 4, 1024      # 4096 events x 24 channels x 2048 samples
P15_SIM = 4096                      # simulated station-11 events made noisy
P15_ARIANNA = (2048, 8, 256)        # CalibTree entries x channels x samples
P15_ARA_EVENTS = 300
P15_DIRECTIONS, P15_FREQS = 1000, 512
P15_HIGH_LOW = dict(threshold_high=25 * units.mV, threshold_low=-25 * units.mV,
                    number_concidences=2, triggered_channels=[0, 1, 2, 3])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _p15_arrays(events):
    """Traces [E, C, n], start times [E, C], block offsets [E, C, B] and
    glitch flags [E, C] of the provider's events."""
    from nuradiomc_tpu_torch.framework.parameters import channelParameters as chp
    chans = [list(e.get_station().iter_channels()) for e in events]
    return (np.array([[c.get_trace() for c in cs] for cs in chans]),
            np.array([[c.get_trace_start_time() for c in cs] for cs in chans]),
            np.array([[c[chp.block_offsets] for c in cs] for cs in chans]),
            np.array([[c[chp.glitch] for c in cs] for cs in chans]))


def _p15_provider(paths, device):
    """dataProviderRNOG over the runs on ``device``: (events, provider,
    seconds of begin (reading the runs), of the run, of its chunk passes)."""
    from nuradiomc_tpu_torch.reco import rnog_io
    det = convert.RNOGRunDetector()
    provider = rnog_io.dataProviderRNOG(device=device)
    t0 = time.perf_counter()
    provider.begin(paths, det)
    t_read = time.perf_counter() - t0
    passes = [0.0]
    real = provider.process

    def timed(*args):
        t = time.perf_counter()
        out = real(*args)
        _sync(device)
        passes[0] += time.perf_counter() - t
        return out

    provider.process = timed
    t0 = time.perf_counter()
    events = []
    for evt in provider.run():
        assert det.updated_to == evt.get_station().get_station_time()
        events.append(evt)
    _sync(device)
    return events, provider, t_read, time.perf_counter() - t0, passes[0]


def _p15_entropy_excused(dev, card_lt, cpu_lt, bad, card_entropy):
    """Events whose entropies differ between the devices. Each is excused
    only when the two devices' summed waveforms have different amplitude
    histograms (a sample within rounding of a bin edge), and the card's
    entropy must still be numpy's (``np.histogram``, ``scipy.stats.entropy``)
    of the card's own summed waveform within 1e-14; returns the worst
    relative error of that check."""
    import scipy.stats

    from nuradiomc_tpu_torch.utils import trace_stats as ts
    if len(bad) == 0:
        return 0.0

    def summed(events, where):
        st = [evt.get_station() for evt in events]
        ref = np.array([s.get_channel(0).get_trace() for s in st])
        others = np.array([[s.get_channel(c).get_trace() for c in (1, 2, 3)] for s in st])
        return ts.get_coherent_sum(torch.as_tensor(others, device=where),
                                   torch.as_tensor(ref, device=where), True).cpu().numpy()

    w_card = summed([card_lt[i] for i in bad], dev)
    w_cpu = summed([cpu_lt[i] for i in bad], "cpu")
    worst = 0.0
    for k, i in enumerate(bad):
        h_card = np.histogram(w_card[k], bins=50)[0]
        assert not np.array_equal(h_card, np.histogram(w_cpu[k], bins=50)[0]), \
            f"event {i}: entropy differs, histograms equal"
        dens = np.histogram(w_card[k], bins=50, density=True)[0]
        want = scipy.stats.entropy(dens / np.sum(dens), base=2)
        err = abs(card_entropy[i] - want) / want
        assert err <= 1e-14, f"event {i}: card entropy {card_entropy[i]!r}, numpy's {want!r}"
        worst = max(worst, float(err))
    return worst


def _p15_recorded(dev, tmp):
    """(a) four RNO-G runs through dataProviderRNOG, the hit filter and the
    coherent sums on the card and on the CPU; returns the run paths."""
    from nuradiomc_tpu_torch.reco import rnog_data, rnog_io
    t0 = time.perf_counter()
    paths, truth = convert.make_rnog_runs(tmp, P15_RUNS, P15_EVENTS, seed=15)
    t_make = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    card, prov, read_s, run_s, pass_s = _p15_provider(paths, dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cpu, prov_cpu, read_cpu, run_cpu, pass_cpu = _p15_provider(paths, "cpu")
    n_ev = len(card)
    assert n_ev == len(cpu) == P15_RUNS * P15_EVENTS
    assert [(e.get_run_number(), e.get_id()) for e in card] == \
        [(e.get_run_number(), e.get_id()) for e in cpu]
    (tr_c, t0_c, off_c, gl_c), (tr_h, t0_h, off_h, gl_h) = _p15_arrays(card), _p15_arrays(cpu)
    np.testing.assert_array_equal(t0_c, t0_h)
    trace_err = float(np.max(np.abs(tr_c - tr_h) / np.abs(tr_h).max(-1, keepdims=True)))
    assert trace_err <= 1e-12, trace_err
    off_err = float(np.max(np.abs(off_c - off_h) / tr_h.std(-1, keepdims=True)))
    assert off_err <= 1e-9, off_err
    np.testing.assert_array_equal(gl_c, gl_h)
    assert (prov.n_fitted, prov.n_glitch) == (prov_cpu.n_fitted, prov_cpu.n_glitch)
    injected = np.concatenate([t["scrambled"] for t in truth])
    hits = int((gl_c & injected).sum())
    false_pos, missed = int((gl_c & ~injected).sum()), int((~gl_c & injected).sum())
    n_ch = tr_c.shape[1] * n_ev
    print(f"phase 15 (a) RNO-G runs: {P15_RUNS} x {P15_EVENTS} events x {tr_c.shape[1]} channels "
          f"x {tr_c.shape[2]} samples (int16 ADC, {sum(os.path.getsize(p + '/mattak_export.npz') for p in paths) / 2**20:.0f} MiB compressed) "
          f"made and written in {t_make:.2f} s, read back in {read_s:.2f} s; dataProviderRNOG on "
          f"the card {run_s:.2f} s = {n_ev / run_s:.0f} events/s ({prov.reader.last_chunk} events "
          f"per chunk, the chunk passes {pass_s:.3f} s of it, the rest on the host: Event and "
          f"Channel objects, host copies, cable delays), peak device memory {peak:.2f} GiB; CPU "
          f"{run_cpu:.2f} s = {n_ev / run_cpu:.0f} events/s (chunk passes {pass_cpu:.2f} s) "
          f"({CARD})")
    print(f"phase 15 (a) card vs CPU on every event: traces {trace_err:.2e} of each channel's "
          f"peak (gate 1e-12), block offsets {off_err:.2e} of each trace's std (gate 1e-9), start "
          f"times, fit branches ({prov.n_fitted} of {n_ch} channels fitted) and glitch flags "
          f"({prov.n_glitch} set) equal; against the {int(injected.sum())} scrambled channels "
          f"injected: {hits} flagged, {missed} missed, {false_pos} flagged without a scramble")
    # one chunk's device pass under the profiler
    raw = rnog_io.NumpyDataset(paths[0]).raw_block(np.arange(prov.reader.last_chunk))
    chunk = torch.as_tensor(raw, device=dev).to(torch.float64) * rnog_io.ADC_TO_VOLT
    dev_ms, wall, n_k = _device_busy(lambda: prov.process(chunk, convert.RNOG_FS))
    label = f"phase 15 (a) one chunk's pass ({chunk.shape[0]} events, block offsets + glitches):"
    if dev_ms is None:
        print(f"{label} device busy share not measured; profiled call {wall:.2f} ms ({CARD})")
    else:
        print(f"{label} {dev_ms:.2f} ms of device kernels ({n_k} kernels) in a profiled call of "
              f"{wall:.2f} ms = {dev_ms / wall:.1%} busy; {chunk.numel() * 8 / 1e9:.2f} GB of "
              f"traces in ({CARD})")
    # the hit filter and the coherent sums on the LT events
    lt = [i for i, e in enumerate(card) if e.get_station().get_first_trigger().get_name() == "LT"]
    card_lt, cpu_lt = [card[i] for i in lt], [cpu[i] for i in lt]
    res = {}
    for where, events in ((dev, card_lt), ("cpu", cpu_lt)):
        t0 = time.perf_counter()
        hits_out = rnog_data.stationHitFilter(device=where).run_events(events)
        _sync(where)
        t_hit = time.perf_counter() - t0
        coh = rnog_data.stationCoherentlySummedWaveforms(device=where)
        coh.begin()
        t0 = time.perf_counter()
        sums = coh.run_events(events)
        _sync(where)
        res[str(where)] = (hits_out, sums, t_hit, time.perf_counter() - t0)
    (h_c, s_c, th_c, tc_c), (h_h, s_h, th_h, tc_h) = res[str(dev)], res["cpu"]
    for a, b in zip(h_c, h_h):
        np.testing.assert_array_equal(a, b)
    worst = 0.0
    for k in ("coherent_snr", "coherent_impulsivity", "coherent_kurtosis"):
        a, b = s_c[k], s_h[k]
        np.testing.assert_array_equal(a[b == 0], 0.0)      # impulsivity is clamped at 0
        worst = max(worst, float(np.max(np.abs(a - b)[b != 0] / np.abs(b[b != 0]))))
    assert worst <= 1e-10, worst
    ent = np.abs(s_c["coherent_entropy"] - s_h["coherent_entropy"]) / s_h["coherent_entropy"]
    bad = np.flatnonzero(ent > 1e-14)
    own_err = _p15_entropy_excused(dev, card_lt, cpu_lt, bad, s_c["coherent_entropy"])
    passed = h_c[0]
    print(f"phase 15 (a) {len(lt)} LT events: stationHitFilter on the card {th_c:.3f} s = "
          f"{len(lt) / th_c:.0f} events/s (CPU {th_h:.3f} s), {int(passed.sum())} pass "
          f"({int(h_c[1].sum())} by the time checker, {int(h_c[2].sum())} by a high hit), hit "
          f"times and decisions equal to the CPU's; stationCoherentlySummedWaveforms on the card "
          f"{tc_c:.3f} s = {len(lt) / tc_c:.0f} events/s (CPU {tc_h:.3f} s), SNR / impulsivity "
          f"/ kurtosis {worst:.2e} (gate 1e-10), entropy within 1e-14 in "
          f"{len(lt) - len(bad)} events, {len(bad)} excused (their summed waveforms' histograms "
          f"differ between the devices; the card's entropy of each within {own_err:.2e} of "
          f"numpy's on the card's own summed waveform, gate 1e-14) ({CARD})")
    return paths


def _p15_noise(dev, tmp):
    """(b) RNOGNoiseImporter from (a)'s runs onto 4096 simulated events and
    the high/low trigger on channels 0-3; ARIANNANoiseImporter on a
    2048 x 8 x 256 CalibTree export."""
    from nuradiomc_tpu_torch.framework import event as fev
    from nuradiomc_tpu_torch.reco import measured_noise, trigger_modules
    out = {}
    for where in (dev, "cpu"):
        pairs = convert.make_rnog_sim_stations(fev, P15_SIM, seed=16)
        imp = measured_noise.RNOGNoiseImporter(device=where)
        imp.begin(tmp, random_seed=15)
        t0 = time.perf_counter()
        draws = imp.run_events(pairs)
        _sync(where)
        t_noise = time.perf_counter() - t0
        trig = trigger_modules.triggerSimulatorHighLow(device=where)
        t0 = time.perf_counter()
        fired = [trig.run(evt, st, None, **P15_HIGH_LOW) for evt, st in pairs]
        _sync(where)
        t_trig = time.perf_counter() - t0
        traces = np.array([[c.get_trace() for c in st.iter_channels()] for _, st in pairs])
        out[str(where)] = (draws, traces, np.array(fired), t_noise, t_trig)
    (d_c, tr_c, f_c, tn_c, tt_c), (d_h, tr_h, f_h, tn_h, tt_h) = out[str(dev)], out["cpu"]
    assert d_c == d_h
    bits = float(np.mean(tr_c == tr_h))
    err = float(np.max(np.abs(tr_c - tr_h) / np.abs(tr_h).max(-1, keepdims=True)))
    assert err <= 1e-12, err
    np.testing.assert_array_equal(f_c, f_h)
    print(f"phase 15 (b) RNOGNoiseImporter: {P15_SIM} simulated station-11 events x "
          f"{tr_c.shape[1]} channels made noisy from (a)'s FORCE events ({len(set(d_c))} "
          f"distinct noise events, baseline-corrected 'auto') in {tn_c:.2f} s on the card = "
          f"{P15_SIM / tn_c:.0f} events/s (CPU {tn_h:.2f} s); the draws equal the CPU's; noisy "
          f"traces {err:.2e} of peak (gate 1e-12; {bits:.1%} of samples bit-equal: the noise "
          f"traces carry the block-offset fit's last-bit rounding of each device); "
          f"triggerSimulatorHighLow on channels 0-3: {int(f_c.sum())} of {P15_SIM} fire, "
          f"decisions equal, {tt_c:.2f} s on the card = {P15_SIM / tt_c:.0f} events/s (CPU "
          f"{tt_h:.2f} s) ({CARD})")
    n_tree, n_ch, n_s = P15_ARIANNA
    path = os.path.join(tmp, "caltree_export.npz")
    np.savez(path, amp_out=np.random.default_rng(17).standard_normal(P15_ARIANNA))
    res = {}
    for where in (dev, "cpu"):
        pairs = []
        for e in range(P15_SIM):
            evt, st = fev.Event(1, e), fev.Station(51)
            for c in range(n_ch):
                ch = fev.Channel(c)
                ch.set_trace(np.zeros(n_s), 1.0)
                st.add_channel(ch)
            evt.set_station(st)
            pairs.append((evt, st))
        imp = measured_noise.ARIANNANoiseImporter(device=where)
        imp.begin([path], random_seed=17)
        t0 = time.perf_counter()
        draws = imp.run_events(pairs)
        _sync(where)
        res[str(where)] = (draws, np.array([[c.get_trace() for c in st.iter_channels()]
                                            for _, st in pairs]), time.perf_counter() - t0)
    (d_c, tr_c, t_c), (d_h, tr_h, t_h) = res[str(dev)], res["cpu"]
    assert d_c == d_h
    np.testing.assert_array_equal(tr_c, tr_h)
    print(f"phase 15 (b) ARIANNANoiseImporter: {P15_SIM} events x {n_ch} channels x {n_s} samples "
          f"from a {n_tree} x {n_ch} x {n_s} CalibTree export in {t_c:.2f} s on the card = "
          f"{P15_SIM / t_c:.0f} events/s (CPU {t_h:.2f} s); draws equal, noisy traces equal bit "
          f"for bit ({CARD})")


def _p15_host(dev, tmp):
    """(c) the ARA and ARIANNA readers (host copies) and every antenna
    preprocessor, its table read by table_vel on the card against the CPU."""
    import logging

    from nuradiomc_tpu_torch.detector import antenna_preprocess
    from nuradiomc_tpu_torch.ops import antenna
    from nuradiomc_tpu_torch.reco import ara_io, arianna_io
    logging.getLogger("nuradiomc_tpu_torch.arianna_io").setLevel(logging.CRITICAL)
    ara = convert.make_ara_run(os.path.join(tmp, "ara.npz"), P15_ARA_EVENTS)
    t0 = time.perf_counter()
    reader = ara_io.readARAData()
    reader.begin(ara)
    ara_events = list(reader.run())
    t_ara = time.perf_counter() - t0
    assert len(ara_events) == P15_ARA_EVENTS
    n = [c.get_number_of_samples() for c in ara_events[0].get_station(2).iter_channels()]
    assert all(k % 2 == 0 and k > 0 for k in n)
    ari = convert.make_arianna_calib_file(os.path.join(tmp, "arianna.npz"), P15_ARA_EVENTS)
    t0 = time.perf_counter()
    calib = arianna_io.readARIANNADataCalib()
    calib.begin(ari)
    ari_events = list(calib.run())
    t_ari = time.perf_counter() - t0
    assert len(ari_events) + calib.skipped_events + calib.skipped_events_stop == P15_ARA_EVENTS
    print(f"phase 15 (c) readARAData: {len(ara_events)} events x 16 channels regridded in "
          f"{t_ara:.2f} s; readARIANNADataCalib: {len(ari_events)} of {P15_ARA_EVENTS} events "
          f"({calib.skipped_events} without a config row, {calib.skipped_events_stop} without "
          f"a stop sample) in {t_ari:.2f} s (host)")
    rng = np.random.default_rng(18)
    zen = rng.uniform(0, np.pi, P15_DIRECTIONS)
    az = rng.uniform(0, 2 * np.pi, P15_DIRECTIONS)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    worst, secs = {}, {}
    for kind in convert.ANTENNA_PATTERN_KINDS:
        root = os.path.join(tmp, "patterns", kind)
        os.makedirs(root)
        name, args, kwargs = convert.write_antenna_pattern(root, kind)
        t0 = time.perf_counter()
        table = antenna.load_antenna_table(getattr(antenna_preprocess, name)(*args, **kwargs))
        secs[kind] = time.perf_counter() - t0
        freqs = np.linspace(table.freqs[0], table.freqs[-1], P15_FREQS)
        vel = {}
        for where in (dev, "cpu"):
            tt = antenna.AntennaTable(*(torch.as_tensor(np.asarray(getattr(table, k)),
                                                        device=where)
                                        for k in ("freqs", "thetas", "phis", "h_theta",
                                                  "h_phi")), orientation=table.orientation)
            t_, p_ = antenna.table_vel(torch.as_tensor(zen, device=where),
                                       torch.as_tensor(az, device=where),
                                       torch.as_tensor(rot, device=where), tt,
                                       torch.as_tensor(freqs, device=where))
            vel[str(where)] = np.stack([t_.cpu().numpy(), p_.cpu().numpy()])
        a, b = vel[str(dev)], vel["cpu"]
        worst[kind] = float(np.max(np.abs(a - b)) / np.abs(b).max())
        assert worst[kind] <= 1e-12, (kind, worst[kind])
        assert np.abs(b).max() > 0
    print(f"phase 15 (c) antenna preprocessors (seconds to the loaded table): "
          + ", ".join(f"{k} {secs[k]:.3f}" for k in secs)
          + f"; table_vel at {P15_DIRECTIONS} directions x {P15_FREQS} frequencies on the card vs "
          f"the CPU, worst {max(worst.values()):.2e} of the VEL's peak (gate 1e-12) ({CARD})")


def phase_recorded(dev):
    """The recorded-data side on the card in float64 (no kernel of the five):
    (a) RNO-G runs through dataProviderRNOG, the hit filter and the coherent
    sums, (b) the measured-noise importers and the high/low trigger, (c) the
    ARA and ARIANNA readers and the antenna preprocessors. Returns the launch
    counts of the path (all 0)."""
    import tempfile
    t_phase = time.perf_counter()
    _reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rnog_") as tmp:
        _p15_recorded(dev, tmp)
        _p15_noise(dev, tmp)
        _p15_host(dev, tmp)
    counts = _launch_counts()
    assert not any(counts.values()), counts
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s; launches {counts} ({CARD})")
    return counts


# ---- phase 16: the BGR18/HEDIS cross-section path -------------------------------

P16_CPU_GROUPS = 3000    # the first event groups of the list, run on the CPU too
P16_CONFIG = {"weights": {"weight_mode": "core_mantle_crust_simple",
                          "cross_section_type": "hedis_bgr18"}}


def _p16_list():
    """(a) phase 10's campaign list drawn with the BGR18 table, held to the
    table's cc fraction and inelasticity law."""
    from nuradiomc_tpu_torch.sim import cross_sections, evtgen
    campaign = convert.FULLSCALE_LIST
    t0 = time.perf_counter()
    data, attrs = evtgen.generate_eventlist_cylinder(
        None, campaign["n_events"], 1e18 * units.eV, 1e18 * units.eV, campaign["volume"],
        seed=10, cross_sections_model="hedis_bgr18")
    gen_s = time.perf_counter() - t0
    _, first = np.unique(data["event_group_ids"], return_index=True)
    flavors, energies = data["flavors"][first], data["energies"][first]
    cc = cross_sections.get_nu_cross_section(energies, flavors, "cc", "hedis_bgr18")
    nc = cross_sections.get_nu_cross_section(energies, flavors, "nc", "hedis_bgr18")
    cc_frac = float(np.mean(data["interaction_type"][first] == "cc"))
    want_cc = float(np.mean(cc / (cc + nc)))
    y = data["inelasticity"][first]
    b1 = convert.BGR18_SLOPE + 1
    y_med = 0.5 ** (1 / b1)
    se = np.sqrt(0.25 / len(y)) / (b1 * y_med ** convert.BGR18_SLOPE)
    med = float(np.median(y))
    print(f"phase 16a evtgen hedis_bgr18: {attrs['n_events']} events, {len(data['shower_ids'])} "
          f"showers in {gen_s:.3f} s on the host; cc fraction {cc_frac:.4f} (table "
          f"{want_cc:.4f}, gate 0.02), median inelasticity {med:.5f} (closed form "
          f"{y_med:.5f}, {abs(med - y_med) / se:.2f} standard errors, gate 4) ({CARD})")
    if abs(cc_frac - want_cc) >= 0.02 or abs(med - y_med) >= 4 * se:
        raise AssertionError("the BGR18 list does not follow its table")
    return data, attrs


def _p16_campaign(dev):
    from nuradiomc_tpu_torch.sim import earth_attenuation
    data, attrs = _p16_list()
    inp = io_input.from_generated(data, attrs)
    n_events = int(attrs["n_events"])

    # (b) the campaign on the card
    torch.cuda.reset_peak_memory_stats(dev)
    _, res, wall, counts, calls = _campaign_run(
        "(b) float64, 50,000 events, BGR18 weights",
        lambda: convert.fullscale_simulation(inp, P16_CONFIG, device=dev,
                                             dtype=torch.float64), n_events, phase="phase 16")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    sel = res["triggered"] & (res["weights"] >= 1e-5)
    veff_km3 = res["veff"] / units.km ** 3
    print(f"phase 16b BGR18 campaign: {int(sel.sum())} groups above the weight cut, Veff "
          f"{veff_km3:.6f} km^3 (Veff*4pi {4 * np.pi * veff_km3:.6f} km^3 sr), "
          f"{n_events / wall:.1f} events/s in {wall:.2f} s, peak memory {peak:.2f} GiB, "
          f"launches {counts} ({CARD})")
    if min(counts["placement_chain"], counts["irfft_trigger"]) < 1:
        raise AssertionError(f"a kernel of the BGR18 campaign was not launched: {counts}")
    if not (res["n_triggered"] > 0 and np.isfinite(res["veff"]) and res["veff"] > 0):
        raise AssertionError("the BGR18 campaign gives no finite positive Veff")
    _check_recorded(calls, "BGR18 campaign float64", "phase 16")
    del calls

    # (c) the first groups on the card and on the CPU
    sub = io_input.select(inp, np.unique(inp.event_group_ids)[:P16_CPU_GROUPS])
    out = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        out[str(where)] = convert.fullscale_simulation(sub, P16_CONFIG, device=where,
                                                       dtype=torch.float64).run()
        secs = time.perf_counter() - t0
        print(f"phase 16c {P16_CPU_GROUPS} groups on {where}: {secs:.2f} s ({CARD})")
    card, cpu = out[str(dev)], out["cpu"]
    set_card = set(card["group_ids"][card["triggered"]].tolist())
    set_cpu = set(cpu["group_ids"][cpu["triggered"]].tolist())
    rel = abs(card["veff"] / cpu["veff"] - 1) if cpu["veff"] else abs(card["veff"])
    print(f"phase 16c card against CPU: {len(set_card)} / {len(set_cpu)} triggered, "
          f"{len(set_card ^ set_cpu)} differ; Veff {card['veff'] / units.km ** 3:.9f} / "
          f"{cpu['veff'] / units.km ** 3:.9f} km^3, rel {rel:.2e} (gate 1e-9)")
    if set_card != set_cpu or not len(set_cpu) or rel > 1e-9:
        raise AssertionError("the BGR18 campaign on the card differs from the CPU's")

    # (d) the BGR18 weights against the CTW weights of the same list
    args = (data["zeniths"], data["energies"], data["flavors"])
    w = earth_attenuation.get_weight(*args, mode="core_mantle_crust_simple",
                                     cross_section_type="hedis_bgr18")
    w_ctw = earth_attenuation.get_weight(*args, mode="core_mantle_crust_simple",
                                         cross_section_type="ctw")
    differ = float(np.mean(~np.isclose(w, w_ctw, rtol=1e-6, atol=0)))
    print(f"phase 16d weights: BGR18 in [{w.min():.3g}, {w.max():.3g}], mean {w.mean():.6f} "
          f"against CTW's {w_ctw.mean():.6f}; {differ:.1%} of the showers' weights differ "
          f"beyond rtol 1e-6")
    if not (np.all((w >= 0) & (w <= 1)) and np.all((res["weights"] >= 0) & (res["weights"] <= 1))
            and differ > 0):
        raise AssertionError("the BGR18 weights are outside [0, 1] or equal the CTW weights")
    return counts


def phase_bgr18(dev):
    """A BGR18-weighted dipole campaign on the card (float64) from the
    synthetic table in a temporary directory; returns the kernel launches of
    the campaign's run. The table path is restored on exit."""
    import tempfile

    from nuradiomc_tpu_torch.sim import cross_sections
    t_phase = time.perf_counter()
    old = cross_sections._BGR18_PATH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bgr18_") as tmp:
        cross_sections.set_bgr18_table_path(
            convert.make_bgr18_table(os.path.join(tmp, "bgr18_synth.npz")))
        try:
            counts = _p16_campaign(dev)
        finally:
            cross_sections.set_bgr18_table_path(old)
    torch.cuda.empty_cache()
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s; launches {counts} ({CARD})")
    return counts


# ---- phase 17: the repository's example workflows -------------------------------

P17_CPU_GROUPS = 1000     # a long list is cut to its first groups for the CPU side


def _p17_run(name, argv, device, outdir, dtype=None):
    """One example's ``main`` with its printed lines captured: (return,
    output, wall seconds ending in a device sync)."""
    from nuradiomc_tpu_torch.examples import main_of
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main_of(name)(argv, device=device, dtype=dtype, outdir=outdir)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return ret, buf.getvalue(), time.perf_counter() - t0


def _p17_groups(card_res, cpu_res):
    """The card run's rows of the CPU run's groups."""
    idx = np.searchsorted(card_res["group_ids"], cpu_res["group_ids"])
    if not np.array_equal(np.asarray(card_res["group_ids"])[idx], cpu_res["group_ids"]):
        raise AssertionError("the CPU run's groups are not the card run's")
    return idx


# The groups of example 01's list (10,000 events at seed 10; its first
# P17_CPU_GROUPS groups) whose float32 ray travel times depart from the
# float64 ones by more than 0.1 ns in the JAX package itself
# (tests/test_torch_examples_float32.py holds the list to the JAX package):
# there float32 can decide a rung far from its threshold in either package and
# on either device (PERF.md section 7). A float32 decision that differs
# between card and CPU is excused only in these groups or within 1e-3 of the
# threshold.
P17_F32_SENSITIVE = frozenset({11, 143, 292, 328, 346, 350, 405, 410, 475, 496, 603, 667,
                               677, 687, 763, 783, 835, 854, 867, 892})
P17_SCAN = np.round(np.linspace(0.8, 1.2, 81), 3)   # threshold factors of a reading


def _p17_rungs(name, cut, gids, sigmas, factors, device, dtype):
    """[groups, rungs, factors] decisions of example 01's / 09's station on
    the groups ``gids`` (ascending) of the list ``cut`` with each rung's
    thresholds scaled by each of ``factors``."""
    from nuradiomc_tpu_torch.examples.e01_veff_simulation import t02_run_simulation as t02
    from nuradiomc_tpu_torch.sim.simulation import Simulation, TriggerSpec
    triggers = [TriggerSpec(name=f"r{i}_{j}", threshold_high_sigma=s * f,
                            threshold_low_sigma=-s * f)
                for i, s in enumerate(sigmas) for j, f in enumerate(factors)]
    res = Simulation(io_input.select(io_input.read_input(cut), gids), t02.DETECTOR,
                     config=t02.CONFIG, filter_chain=t02.FILTERS, triggers=triggers,
                     chunk_size=1024, device=device, dtype=dtype).run()
    if not np.array_equal(res["group_ids"], gids):
        raise AssertionError(f"{name}: the selected groups did not come back")
    return res["multiple_triggers"].reshape(len(gids), len(sigmas), len(factors))


def _p17_reading(fired):
    """The largest threshold factor of P17_SCAN at which a group fires."""
    return f"{P17_SCAN[fired].max():.3f}" if fired.any() else f"none >= {P17_SCAN[0]}"


def _p17_ladder(name, card, cut, dev, cpu_dir):
    """Example 01's or 09's decisions on the first groups (the list ``cut``):
    float64 runs on card and CPU equal in every group and rung; the card's
    float32 run (the example's) against the CPU's float32 run: at most 2
    groups differing per rung, each within 1e-3 of its threshold (its
    float64 decision changes between 0.999 and 1.001 times the threshold)
    or one of P17_F32_SENSITIVE. Each differing group's readings are
    printed: the largest threshold factor at which it fires, in float32 and
    float64 on card and CPU."""
    from nuradiomc_tpu_torch.examples.e09_threshold_ladder import run_ladder
    sigmas = (2.0,) if name == "e01_t02" else run_ladder.SIGMAS
    f64 = {where: _p17_run(name, [cut], where, os.path.join(cpu_dir, "f64"),
                           dtype=torch.float64)[0]["results"] for where in (dev, "cpu")}
    mt_c, mt_p = f64[dev]["multiple_triggers"], f64["cpu"]["multiple_triggers"]
    if not (np.array_equal(f64[dev]["group_ids"], f64["cpu"]["group_ids"])
            and np.array_equal(mt_c, mt_p)):
        raise AssertionError(f"{name}: float64 decisions differ between card and CPU in "
                             f"{int(np.any(mt_c != mt_p, axis=1).sum())} groups")
    cpu = _p17_run(name, [cut], "cpu", cpu_dir)[0]["results"]
    idx = _p17_groups(card["results"], cpu)
    differ = card["results"]["multiple_triggers"][idx] != cpu["multiple_triggers"]
    rows = np.nonzero(differ.any(axis=1))[0]
    gids = np.asarray(cpu["group_ids"])[rows]
    readings = []
    if len(rows):
        near = _p17_rungs(name, cut, gids, sigmas, (0.999, 1.001), "cpu", torch.float64)
        near = near[..., 0] != near[..., 1]
        scans = {(w, d): _p17_rungs(name, cut, gids, sigmas, P17_SCAN, w, d)
                 for w in (dev, "cpu") for d in (torch.float32, torch.float64)}
        for k, r in zip(*np.nonzero(differ[rows])):
            gid = int(gids[k])
            why = ("within 1e-3 of the threshold" if near[k, r] else
                   "float32-sensitive in the JAX package" if gid in P17_F32_SENSITIVE else None)
            got = {key: _p17_reading(v[k, r]) for key, v in scans.items()}
            readings.append(
                f"group {gid} at {sigmas[r]:g} sigma fires to factor card f32 "
                f"{got[dev, torch.float32]} / CPU f32 {got['cpu', torch.float32]} / card f64 "
                f"{got[dev, torch.float64]} / CPU f64 {got['cpu', torch.float64]} "
                f"({why or 'NOT EXCUSED'})")
            if why is None:
                raise AssertionError(f"{name}: float32 decisions differ on card and CPU "
                                     f"beyond the excuses: {readings[-1]}")
    n_differ = differ.sum(axis=0)
    if n_differ.max() > 2:
        raise AssertionError(f"{name}: float32 decisions differ in {n_differ.tolist()} groups")
    return (f"float64 on {len(idx)} groups: every rung equal on card and CPU "
            f"({mt_p.sum(axis=0).tolist()} fired); float32: {n_differ.tolist()} groups differ "
            f"per rung (gate 2, each near its threshold or float32-sensitive), "
            f"{cpu['multiple_triggers'].sum(axis=0).tolist()} fired on the CPU"
            + "".join(f"; {r}" for r in readings))


def _p17_band(label, n_card, n_cpu, n):
    """Noisy counts of the same ``n`` groups (other draws): within 4
    binomial sigma of each other, sigma = sqrt(2 n p (1 - p)) at the pooled
    rate, at least 1; the card fires where the CPU does."""
    p = (n_card + n_cpu) / (2 * n)
    sigma = max(math.sqrt(2 * n * p * (1 - p)), 1.0)
    if abs(n_card - n_cpu) > 4 * sigma or (n_cpu and not n_card):
        raise AssertionError(f"{label}: card {n_card} and CPU {n_cpu} of {n} beyond 4 sigma "
                             f"({sigma:.2f}) or none on the card")
    return f"{label} card {n_card} / CPU {n_cpu} of {n} (4 sigma {4 * sigma:.1f})"


def _p17_same_noise(label, inp, dev, **kw):
    """A noisy example's ``Simulation`` (``kw``: its detector, configuration,
    filters, triggers and chunk size) on ``inp`` in float64 on the card and
    on the CPU with the same noise (drawn on the host, ``noise_device``):
    every trigger's fired groups equal, and each trigger fires."""
    from nuradiomc_tpu_torch.sim.simulation import Simulation
    res = [Simulation(inp, device=where, dtype=torch.float64, noise_device="cpu", **kw).run()
           for where in (dev, "cpu")]
    mt_c, mt_p = (r["multiple_triggers"] for r in res)
    if not (np.array_equal(res[0]["group_ids"], res[1]["group_ids"])
            and np.array_equal(mt_c, mt_p)):
        raise AssertionError(f"{label}: on the same noise, card and CPU decisions differ in "
                             f"{int(np.any(mt_c != mt_p, axis=1).sum())} groups")
    if not mt_c.any(axis=0).all():
        raise AssertionError(f"{label}: a trigger fired no group on the card")
    return (f"{label} on the same noise in float64: fired groups equal on card and CPU "
            f"({mt_p.sum(axis=0).tolist()} of {len(mt_p)})")


def _p17_fractions(label, p_card, p_cpu, n):
    """Per-point fractions of ``n`` trials within 4 binomial sigma."""
    p_card, p_cpu = np.asarray(p_card), np.asarray(p_cpu)
    p = (p_card + p_cpu) / 2
    sigma = np.maximum(np.sqrt(2 * p * (1 - p) / n), 1.0 / n)
    worst = float(np.max(np.abs(p_card - p_cpu) / sigma))
    if worst > 4:
        raise AssertionError(f"{label}: card and CPU efficiencies {worst:.2f} sigma apart")
    return f"{label} worst point {worst:.2f} sigma apart (gate 4)"


def _p17_lists_equal(a, b):
    ia, ib = io_input.read_input(a), io_input.read_input(b)
    for f in dataclasses.fields(ia):
        x, y = getattr(ia, f.name), getattr(ib, f.name)
        if f.name not in ("attrs", "emitter") and x is not None and not np.array_equal(x, y):
            raise AssertionError(f"{a} and {b} differ in {f.name}")


def _p17_cut(path, out):
    """The first P17_CPU_GROUPS groups of the list ``path``, exported to ``out``."""
    inp = io_input.read_input(path)
    io_input.write_input_npz(io_input.head(inp, P17_CPU_GROUPS), out)
    return out


def _p17_of_peak(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _p17_cpu(name, card, card_dir, cpu_dir, dev):
    """Holds the card run of example ``name`` against the CPU's; returns what
    was compared, or None for a host step that reads the card run's files."""
    from nuradiomc_tpu_torch.examples import EXAMPLES, _common
    from nuradiomc_tpu_torch.examples.e02_phased_array import run_pa_veff as e02
    from nuradiomc_tpu_torch.examples.e05_multichip import run_sharded_veff as e05
    from nuradiomc_tpu_torch.examples.e06_rno_g_station import run_rnog_station as e06
    from nuradiomc_tpu_torch.examples.e13_webinar import w02_run_simulation as w02
    from nuradiomc_tpu_torch.examples.e14_alias_phased_array import run_alias_snr as e14
    from nuradiomc_tpu_torch.sim import evtgen
    from nuradiomc_tpu_torch.sim.simulation import Simulation, TriggerSpec

    default = EXAMPLES[name][2]
    cut = os.path.join(cpu_dir, "cut_1e18_full.npz")
    if name in ("e01_t03", "e13_w03", "e13_w04", "e13_w05"):
        return None
    if name in ("e01_t01", "e13_w01", "e15"):
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        pairs = ([(card["path"], cpu["path"])] if name != "e13_w01" else
                 [(card["lists"][k][0], cpu["lists"][k][0]) for k in card["lists"]])
        for a, b in pairs:
            _p17_lists_equal(a, b)
        return "lists equal"
    if name in ("e01_t02", "e09", "e02"):
        if not os.path.exists(cut):
            _p17_cut(_common.event_list(os.path.join(card_dir, "1e18_full.hdf5")), cut)
        if name != "e02":
            return _p17_ladder(name, card, cut, dev, cpu_dir)
        cpu = _p17_run(name, [cut], "cpu", cpu_dir)[0]
        idx = _p17_groups(card["results"], cpu["results"])
        return (_p17_band("fired", int(card["results"]["triggered"][idx].sum()),
                          int(cpu["results"]["triggered"].sum()), len(idx)) + "; "
                + _p17_same_noise("fired", io_input.read_input(cut), dev, detector=e02.DETECTOR,
                                  config=e02.CONFIG, filter_chain=e02.FILTERS,
                                  trigger=e02.TRIGGER, chunk_size=512))
    if name == "e13_w02":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        res_c, res_p = card["results"], cpu["results"]
        idx = _p17_groups(res_c, res_p)
        return "; ".join([_p17_band(t, int(res_c["multiple_triggers"][idx, i].sum()),
                                    int(res_p["multiple_triggers"][:, i].sum()), len(idx))
                          for i, t in enumerate(res_p["trigger_names"])]
                         + [_p17_same_noise(
                             "both triggers", io_input.read_input(_common.event_list(
                                 os.path.join(card_dir, "input", "input_1e18.hdf5"))), dev,
                             detector=w02.DETECTOR, config=w02.CONFIG,
                             filter_chain=w02.FILTERS, triggers=w02.TRIGGERS,
                             antenna_replacements={"bicone_v8_inf_n1.78": "analytic_VPol"})])
    if name in ("e10_a01", "e11_a01"):
        _p17_run(name, default, "cpu", cpu_dir)
        return "written on the CPU too"
    if name == "e10_a02":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        if cpu["sweep"] != card["sweep"]:
            raise AssertionError(f"pulser sweep differs: {card['sweep']} / {cpu['sweep']}")
        return f"sweep equal ({sum(cpu['sweep'])} of {len(cpu['sweep'])} fire)"
    if name in ("e11_a02", "e08"):
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        res_c, res_p = card["results"], cpu["results"]
        rel = abs(res_c["veff"] / res_p["veff"] - 1) if res_p["veff"] else abs(res_c["veff"])
        if not np.array_equal(res_c["triggered"], res_p["triggered"]) or rel > 1e-9:
            raise AssertionError(f"{name}: card and CPU differ (Veff rel {rel:.2e})")
        text = f"triggered equal ({int(res_p['n_triggered'])}), Veff rel {rel:.2e} (gate 1e-9)"
        if name == "e11_a02":
            if card["fired"] != cpu["fired"]:
                raise AssertionError("the stations' fired groups differ")
            return text + f", every station's fired groups equal, {cpu['n_coincidences']} " \
                          f"coincidences"
        worst = max(_p17_of_peak(ca.get_trace(), cb.get_trace())
                    for a, b in zip(card["events"], cpu["events"])
                    for ca, cb in zip(a.get_station(101).iter_channels(),
                                      b.get_station(101).iter_channels()))
        if worst > 5e-4:
            raise AssertionError(f"e08: exported traces differ by {worst:.2e} of peak")
        return text + f", exported traces within {worst:.2e} of peak (gate 5e-4)"
    if name == "e05":
        data, attrs = evtgen.generate_eventlist_cylinder(None, card["n_events"], 1e18, 1e18,
                                                         e05.VOLUME, seed=21)
        res = Simulation(io_input.from_generated(data, attrs), e05.DETECTOR, config=e05.CONFIG,
                         filter_chain=e05.FILTERS,
                         trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                         chunk_size=104, device="cpu", dtype=torch.float64).run()
        rel = abs(card["veff"] / res["veff"] - 1) if res["veff"] else abs(card["veff"])
        s, ch, b = convert.make_headline_inputs(n_groups=64, n_showers=2, n_channels=4,
                                                n_internal=256, n_base=512, device="cpu",
                                                dtype=torch.float32)
        n_step = int(pipeline.simulate_batch(b, ch, s).triggered.sum())
        if (not np.array_equal(card["triggered"], res["triggered"]) or rel > 1e-9
                or abs(n_step - card["step_triggered"]) > 2):
            raise AssertionError(f"e05: the mesh run differs from one CPU process (Veff rel "
                                 f"{rel:.2e}, step {card['step_triggered']} / {n_step})")
        return (f"mesh {card['mesh']} against one CPU process: triggered equal "
                f"({res['n_triggered']}), Veff rel {rel:.2e} (gate 1e-9), step "
                f"{card['step_triggered']} / {n_step} of 64 (float32, gate 2)")
    if name == "e06":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        idx = _p17_groups(card["results"], cpu["results"])
        worst = max(_p17_of_peak(a, b) for a, b in zip(card["traces"], cpu["traces"]))
        rel = float(np.max(np.abs(card["eq_vrms"] / cpu["eq_vrms"] - 1)))
        if (worst > 1e-9 or rel > 1e-9 or card["surface_fired"] != cpu["surface_fired"]
                or card["hit_filter"] != cpu["hit_filter"]):
            raise AssertionError(f"e06: the readout chain differs ({worst:.2e}, {rel:.2e})")
        return (_p17_band("deep PA", int(card["results"]["triggered"][idx].sum()),
                          cpu["n_triggered"], len(idx)) + "; "
                + _p17_same_noise("deep PA", io_input.read_input(io_input.INPUT_RNOG), dev,
                                  detector=e06.DETECTOR, config=e06.CONFIG,
                                  filter_chain=e06.FILTERS, trigger=e06.TRIGGER,
                                  chunk_size=256)
                + f"; readout event: traces within {worst:.2e} of peak, equalized Vrms rel "
                  f"{rel:.2e} (gates 1e-9), surface trigger and hit filter equal")
    if name == "e07":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        return (f"thresholds {card['threshold_vrms2']:.3f} / {cpu['threshold_vrms2']:.3f} "
                f"Vrms^2; " + _p17_fractions("efficiency", card["efficiency"],
                                             cpu["efficiency"], card["n_trials"]))
    if name == "e14":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        # the card's trials at the CPU run's threshold: the threshold's own
        # spread (a quantile of 256 noise traces) kept out of the binomial band
        out = [_p17_fractions(
            f"zone {z} at the CPU's threshold",
            (card["max_power"][z] > cpu["thresholds"][z]).mean(axis=0), cpu["efficiency"][z],
            card["n_trials"]) for z in (1, 2, 3)]
        # zones 2 and 3 on the card's own draws: the CPU's maxima and SNR50
        for z in (2, 3):
            trials, noise = e14.draws(z, card["n_trials"], dev, torch.float64)
            got = [t.cpu().numpy() for t in e14.zone_powers(z, trials, noise)]
            ref = [t.numpy() for t in e14.zone_powers(z, trials.cpu(), noise.cpu())]
            rel = max(float(np.max(np.abs(g / r - 1))) for g, r in zip(got, ref))
            s_card = e14.snr50(e14.efficiency(*got)[0])
            s_cpu = e14.snr50(e14.efficiency(*ref)[0])
            if rel > 1e-9 or s_card != s_cpu:
                raise AssertionError(f"e14 zone {z}: maxima rel {rel:.2e}, SNR50 {s_card} / "
                                     f"{s_cpu}")
            out.append(f"zone {z} on the card's draws: maxima rel {rel:.2e} (gate 1e-9), "
                       f"SNR50 {s_card:.3f} both")
        return "; ".join(out)
    if name == "e03":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        worst = max([_p17_of_peak(a, b) for a, b in zip(card["traces"], cpu["traces"])]
                    + [_p17_of_peak(a, b) for a, b in zip(card["spectrum"], cpu["spectrum"])
                       if np.any(b != 0)])
        if worst > 1e-9:
            raise AssertionError(f"e03: card and CPU differ by {worst:.2e} of peak")
        return f"traces and unfolded spectrum within {worst:.2e} of peak (gate 1e-9)"
    if name == "e04":
        # the search cut for the CPU side as a list is (its tables at 20 m, as
        # tests/test_torch_reco_chain.py's; phase 12 holds the default
        # tables' solves to the CPU's): card and CPU at that search
        quick = EXAMPLES[name][1]
        card = _p17_run(name, quick, dev, os.path.join(cpu_dir, "card_quick"))[0]
        cpu = _p17_run(name, quick, "cpu", cpu_dir)[0]
        d_v = float(np.max(np.abs(card["vertex"] - cpu["vertex"])))
        d_dir = max(abs(a - b) for a, b in zip(card["direction"], cpu["direction"]))
        d_e = abs(card["log10_energy"] - cpu["log10_energy"])
        if d_v > 1e-6 * 1000 or d_dir > 1e-6 or d_e > 1e-6:
            raise AssertionError(f"e04: card and CPU fits differ ({d_v}, {d_dir}, {d_e})")
        return (f"at {' '.join(quick)}: vertex within {d_v:.2e} m, direction within "
                f"{d_dir:.2e} rad, log10 E within {d_e:.2e} of the CPU's")
    if name == "e12":
        cpu = _p17_run(name, default, "cpu", cpu_dir)[0]
        if cpu["n_gzk"] != card["n_gzk"]:
            raise AssertionError("e12: GZK counts differ")
        return f"GZK count equal ({cpu['n_gzk']:.4f})"
    raise ValueError(name)


def _p17_work(name, ret):
    """(count, unit) of an example's work for its rate, or None."""
    if "results" in ret:
        return len(ret["results"]["group_ids"]), "events"
    if name == "e05":
        return len(ret["group_ids"]), "events"
    if name == "e01_t01":
        return ret["n_events"], "events generated"
    if name in ("e07", "e14"):
        return (1 if name == "e07" else 3) * ret["n_trials"] * len(ret["snrs"]), "trials"
    return None


def phase_examples(dev):
    """The repository's example workflows (``nuradiomc_tpu_torch.examples``)
    at their JAX scripts' default sizes on the card, each run held to the
    same example on the CPU; returns the kernel launches of the card runs
    (with the mesh ranks' own counts for example 05)."""
    import tempfile

    from nuradiomc_tpu_torch.examples import EXAMPLES
    t_phase = time.perf_counter()
    totals = dict.fromkeys(KERNELS, 0)
    calls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        card_dir, cpu_dir = os.path.join(tmp, "card"), os.path.join(tmp, "cpu")
        for name, (_, _, default) in EXAMPLES.items():
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with _Recorder() as rec:
                ret, text, wall = _p17_run(name, default, dev, card_dir)
            for k, v in rec.calls.items():
                if k not in calls and (k not in rec.FIRES or k in rec.fired):
                    calls[k] = v
            counts = _launch_counts()
            for k, n in ret.get("launches", {}).items():
                counts[k] += n
            for k in KERNELS:
                totals[k] += counts[k]
            peak = max(torch.cuda.max_memory_allocated(dev), ret.get("peak_bytes", 0)) / 2 ** 30
            work = _p17_work(name, ret)
            rate = f", {work[0] / wall:.1f} {work[1]}/s ({work[0]} {work[1]})" if work else ""
            lines = text.strip().splitlines()
            print(f"phase 17 {name} on the card: {wall:.2f} s{rate}, peak memory {peak:.3f} GiB, "
                  f"launches {counts}: {lines[-1] if lines else ''} ({CARD})")
            t0 = time.perf_counter()
            against = _p17_cpu(name, ret, card_dir, cpu_dir, dev)
            if against is not None:
                print(f"phase 17 {name} against the CPU ({time.perf_counter() - t0:.1f} s): "
                      f"{against}")
            del ret
    # no example weighs by the path modes (they set core_mantle_crust_simple
    # or run emitters), so the chord kernel need not launch here, and none
    # turns birefringence on, so neither need the segment scan (phase 6
    # requires one scan launch a station)
    missing = [k for k in KERNELS
               if totals[k] < 1 and k not in ("earth_slant", "birefringence_scan")]
    if missing:
        raise AssertionError(f"phase 17: the examples launched no {missing}")
    _check_recorded(calls, "examples", "phase 17")
    del calls
    torch.cuda.empty_cache()
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s; launches {totals} ({CARD})")
    return totals


# the phases that ``--phases`` can name, beside ``trigger`` (kernel 2's part
# of phase 2 alone)
PHASES = {"2": (phase_kernels, phase_pa_kernel, phase_pa_large), "3": (phase_headline,),
          "4": (phase_simulation,), "5": (phase_pa,), "6": (phase_gen2,),
          "7": (phase_multitrigger,), "8": (phase_mooresbay,), "9": (phase_signal_chain,),
          "10": (phase_campaign,), "11": (phase_multiprocess,), "12": (phase_reco,),
          "13": (phase_rays,), "14": (phase_cosmic_ray,), "15": (phase_recorded,),
          "16": (phase_bgr18,), "17": (phase_examples,)}


def _phases_asked(argv):
    """The set named by ``--phases a,b,..`` (None without the option); any
    other argument is refused."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases 2,..,17|trigger]")
    only = set(argv[1].split(","))
    if not only <= set(PHASES) | {"trigger"}:
        raise SystemExit(f"--phases takes {sorted(PHASES)} and 'trigger', not {argv[1]!r}")
    return only


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

    only = _phases_asked(sys.argv[1:])
    if only is not None:
        # a subset for work on one path: phases 0-1 and the ones named, in the
        # script's order; no summary and no result line
        if "trigger" in only:
            _print_grids()
            for dtype, tol_amp in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
                gen = torch.Generator(device=dev)
                gen.manual_seed(20261016)
                _check_trigger_shapes(dtype, dev, gen, str(dtype).replace("torch.", ""), tol_amp)
        for name, phases in PHASES.items():
            if name in only:
                for phase in phases:
                    phase(dev)
        print(f"chip_smoke: phases 0-1 and {', '.join(sorted(only))} passed (--phases: no "
              f"result line)")
        return 0
    summary = {**phase_kernels(dev), **phase_pa_kernel(dev)}
    phase_pa_large(dev)
    launches = phase_headline(dev)
    phase_simulation(dev)
    pa_launches = phase_pa(dev)
    gen2_launches = phase_gen2(dev)
    mt_launches = phase_multitrigger(dev)
    mb_launches = phase_mooresbay(dev)
    chain_launches = phase_signal_chain(dev)
    campaign_launches = phase_campaign(dev)
    mesh_launches = phase_multiprocess(dev)
    reco_launches = phase_reco(dev)
    rays_launches = phase_rays(dev)
    cosmic_launches = phase_cosmic_ray(dev)
    recorded_launches = phase_recorded(dev)
    bgr18_launches = phase_bgr18(dev)
    examples_launches = phase_examples(dev)
    # launches: the counts of the main-path runs (phases 3, 5 to 17)
    for counts in (pa_launches, gen2_launches, mt_launches, mb_launches, chain_launches,
                   campaign_launches, mesh_launches, reco_launches, rays_launches,
                   cosmic_launches, recorded_launches, bgr18_launches, examples_launches):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    replaces = {"placement_chain": "nuradiomc_tpu/ops/placement_pallas.py:452; "
                                   "nuradiomc_tpu/ops/placement_pallas.py:209",
                "irfft_trigger": "nuradiomc_tpu/ops/trigger_pallas.py:172",
                "pa_trigger": "nuradiomc_tpu/ops/pa_pallas.py:181",
                "placement_reduce": "nuradiomc_tpu/ops/placement_pallas.py:512",
                "ray_solver": "none: nuradiomc_tpu/ops/raytrace.py:875 (find_solutions under "
                              "vmap; XLA fuses its fori_loops)",
                "earth_slant": "none: the JAX package computes these weights on the host too "
                               "(nuradiomc_tpu/sim/earth_attenuation.py:95, "
                               "EarthModel.slant_depth)",
                "birefringence_scan": "none: nuradiomc_tpu/ops/birefringence.py:191 "
                                      "(propagate_pulse's lax.scan over the segments, "
                                      "vmapped over the paths)"}
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
