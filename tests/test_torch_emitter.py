"""The port's emitter (pulser) mode held to the JAX package, float64.

* ``ops/emitter.py``: every analytic model's trace and spectrum against the
  JAX package's (rtol 1e-12), every measured waveform against the JAX
  package's HDF5 loader (equal) and the reference golden
  ``tests/golden/emitter_measured.npz`` (1e-12), the SPICE archive's unit
  spectra on a synthetic archive (equal).
* ``simulate_batch`` with ``EmitterParams``: the three branches (voltage
  models folded with the emitting antenna, ``efield_*`` three-component
  spectra, the ``efield_idl1_spice`` nearest-angle gather) on 6 pulser
  positions above one dipole: decisions equal, amplitudes rtol 1e-9 on
  direct rays (2e-4 where a ray turns).
* ``Simulation`` on the committed 24-pulser inputs (``.npz`` exports of
  ``tests/golden/emitter_events.hdf5`` / ``emitter_voltage_events.hdf5``)
  against the JAX ``Simulation`` on the HDF5 originals, on a surface station
  of 4 LPDAs and 4 dipoles: per-trigger sets equal, amplitudes rtol 2e-4.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_emitter.py``
writes ``nuradiomc_tpu_torch/data/emitter_jax_sets.npz``, the JAX package's
per-trigger sets of the two runs (a pin of ``chip_smoke.py`` phase 9).
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import antenna as jant, emitter as jem, filters as jfilters
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.ops import emitter as tem
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim import pipeline as tpipe

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
PIN = io_input.DATA_DIR / "emitter_jax_sets.npz"
INPUTS = {"efield": ("emitter_events.hdf5", io_input.INPUT_EMITTER_EFIELD),
          "voltage": ("emitter_voltage_events.hdf5", io_input.INPUT_EMITTER_VOLTAGE)}
N, DT = 256, 0.5


@pytest.mark.parametrize("model,kw", [
    ("delta_pulse", {}), ("cw", {"emitter_frequency": 0.23}),
    # box edges off the sample grid: on a sample, the last bit of the two
    # packages' linspace decides whether the edge sample is inside
    ("square", {"half_width": 7.2}),
    ("tone_burst", {"emitter_frequency": 0.31, "half_width": 9.2}),
    ("gaussian", {"half_width": 4.0}), ("efield_delta_pulse", {"polarization": 0.3})])
def test_analytic_models(model, kw):
    amps = np.array([0.5, 1.0, 3.0])
    got_t = tem.get_time_trace(torch.as_tensor(amps), N, DT, model, **kw).numpy()
    got_f = tem.get_frequency_spectrum(torch.as_tensor(amps), N, DT, model, **kw).numpy()
    for i, a in enumerate(amps):
        ref_t = np.asarray(jem.get_time_trace(a, N, DT, model, **kw))
        ref_f = np.asarray(jem.get_frequency_spectrum(a, N, DT, model, **kw))
        np.testing.assert_allclose(got_t[i], ref_t, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got_f[i], ref_f, rtol=1e-12, atol=1e-13)
    assert got_t.shape == ((3, 3, N) if model.startswith("efield") else (3, N))


def test_per_row_frequency_and_polarization():
    amps = torch.tensor([1.0, 2.0], dtype=torch.float64)
    fq = torch.tensor([0.2, 0.4], dtype=torch.float64)
    got = tem.get_time_trace(amps, N, DT, "cw", emitter_frequency=fq).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            got[i], np.asarray(jem.get_time_trace(float(amps[i]), N, DT, "cw",
                                                  emitter_frequency=float(fq[i]))),
            rtol=1e-12, atol=1e-13)   # the sine's argument reaches 2 pi 25
    pol = torch.tensor([0.1, 0.9], dtype=torch.float64)
    got = tem.get_time_trace(amps, N, DT, "efield_delta_pulse", polarization=pol).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            got[i], np.asarray(jem.get_time_trace(float(amps[i]), N, DT, "efield_delta_pulse",
                                                  polarization=float(pol[i]))), rtol=1e-12)
    with pytest.raises(NotImplementedError):
        tem.get_time_trace(amps, N, DT, "idl1")


@pytest.mark.parametrize("model", sorted(tem.MEASURED_MODELS))
def test_measured_waveforms(model):
    assert set(tem.MEASURED_MODELS) == set(jem.MEASURED_MODELS)
    got = tem.get_measured_time_trace(model, 2.5, 512, 0.2)
    np.testing.assert_array_equal(got, jem.get_measured_time_trace(model, 2.5, 512, 0.2))
    g = np.load(os.path.join(HERE, "golden", "emitter_measured.npz"))
    if model in g.files:
        np.testing.assert_allclose(
            tem.get_measured_time_trace(model, float(g["amplitude"]), int(g["N"]),
                                        float(g["dt"])), g[model], atol=1e-12)
    # the original HDF5 file gives the same trace through the port's loader
    hdf5 = os.path.join(os.path.dirname(jem.__file__), "..", "data", "pulser_waveforms",
                        jem.MEASURED_MODELS[model])
    np.testing.assert_array_equal(tem.load_measured_waveform(hdf5, 2.5, 512, 0.2), got)


def _spice_archive():
    rng = np.random.default_rng(4)
    t = np.arange(300) / 2.5
    pulse = np.exp(-0.5 * ((t - 40) / 3.0) ** 2) * np.sin(2 * np.pi * 0.2 * t)
    return {"sampling_rate": 2.5, "efields": {
        f"{a:.1f}": [np.stack([s * pulse * (1 + 0.1 * rng.normal(size=300)),
                               0.3 * s * np.roll(pulse, 5)]) for s in (1.0, 0.8)]
        for a in (10.0, 25.0, 40.0, 60.0)}}


def test_spice_unit_specs(tmp_path):
    import lzma
    import pickle
    arch = _spice_archive()
    for i in (0, 1):
        a_t, s_t = tem.spice_unit_specs(arch, N, DT, iN=i)
        a_j, s_j = jem.spice_unit_specs(arch, N, DT, iN=i)
        np.testing.assert_array_equal(a_t, a_j)
        np.testing.assert_array_equal(s_t, s_j)
    assert s_t.shape == (4, 2, N // 2 + 1)
    with pytest.raises(ValueError, match="out of range"):
        tem.spice_unit_specs(arch, N, DT, iN=2)
    path = tmp_path / "SPice_pulses.xz"
    with lzma.open(path, "w") as f:
        pickle.dump(arch, f)
    assert tem.load_spice_archive(str(path))["sampling_rate"] == 2.5
    with pytest.raises(FileNotFoundError):
        tem.load_spice_archive(str(tmp_path / "missing.xz"))
    v = np.random.default_rng(1).normal(size=700)
    for n in (256, 1024):
        np.testing.assert_array_equal(tem._center_component(v, n), jem._center_component(v, n))


# ---- simulate_batch in emitter mode ------------------------------------------

def _setup(n_groups=6):
    """tests/test_emitter_mode.py's geometry in numpy: pulsers at several
    depths and distances above and below one dipole at 100 m."""
    fs, n_int, n_base = 2.0, 256, 512
    freqs_int = np.fft.rfftfreq(n_int, 1 / fs)
    freqs_base = np.fft.rfftfreq(n_base, 1 / fs)
    tpl = jant.build_analytic_template("analytic_VPol", freqs_int)
    templates = np.zeros((1, 3, len(freqs_int)), dtype=complex)
    templates[0] = tpl[0]
    rot = jant.antenna_rotation_matrix(0.0, 0.0, np.pi / 2, 0.0)
    chain = [((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2})]
    ch = jpipe.ChannelParams(
        positions=np.asarray([[0.0, 0.0, -100.0]]), cable_delays=np.zeros(1),
        rot=np.asarray(rot)[None], kind=np.asarray([1]), templates=templates,
        filter_response=np.asarray(jfilters.chain_response(freqs_base, chain))[None],
        filter_response_int=np.asarray(jfilters.chain_response(freqs_int, chain))[None],
        threshold_high=np.asarray([2e-7]), threshold_low=np.asarray([-2e-7]),
        noise_amplitude=np.asarray([0.0]), min_efield_amplitude=np.asarray([0.0]))
    settings = jpipe.PipelineSettings(ice=jice.southpole_2015, n_internal=n_int,
                                      n_base=n_base, sampling_rate=fs, n_freq_attenuation=16,
                                      attenuation_steps=8, attenuation_quadrature="gauss",
                                      apply_focusing=True)
    rng = np.random.default_rng(9)
    vert = np.stack([rng.uniform(60, 600, n_groups), np.zeros(n_groups),
                     rng.uniform(-900, -30, n_groups)], -1)[:, None, :]
    batch = jpipe.ShowerBatch(
        vertices=vert, energies=np.arange(1.0, n_groups + 1)[:, None] * units.V,
        is_em=np.zeros((n_groups, 1), dtype=bool),
        shower_mask=np.ones((n_groups, 1), dtype=bool),
        prop_dir=np.tile([[[0.0, 0.0, 1.0]]], (n_groups, 1, 1)),
        k_L=rng.uniform(0.15, 0.4, (n_groups, 1)), vertex_times=np.zeros((n_groups, 1)),
        emitter_polarization=rng.uniform(0.1, 0.9, (n_groups, 1)))
    return batch, ch, settings, templates[0], rot


def _emitter(model, templates, rot):
    kw = {}
    if model in jem.MEASURED_MODELS:
        trace = jem.get_measured_time_trace(model, 1.0, 256, 0.5)
        kw["unit_spec"] = np.fft.rfft(trace) / 2.0 * np.sqrt(2.0)
    if model == "efield_idl1_spice":
        kw["spice_angles"], kw["spice_specs"] = jem.spice_unit_specs(_spice_archive(), 256, 0.5)
    return jpipe.EmitterParams(model=model, templates=templates, rot=rot, kind=1,
                               half_width=6.2, **kw)


@pytest.mark.parametrize("model", ["delta_pulse", "tone_burst", "hvsp1",
                                   "efield_delta_pulse", "efield_idl1_spice"])
def test_simulate_batch_emitter_matches_jax(model):
    batch, ch, settings, templates, rot = _setup()
    em = _emitter(model, templates, rot)
    ref = jax.jit(lambda b: jpipe.simulate_batch(b, ch, settings, emitter=em))(batch)
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    pe = convert.emitter_from_jax(em, device="cpu", dtype=torch.float64)
    assert pe.model == model and pe.kind == 1 and pe.templates.dtype == torch.complex128
    port = tpipe.simulate_batch(pb, pc, ps, emitter=pe)
    valid = np.asarray(ref.sol_mask)
    np.testing.assert_array_equal(port.sol_mask.numpy(), valid)
    # no delta_C cut: every solved ray of every pulser is kept
    np.testing.assert_array_equal(valid, np.asarray(ref.sol_type) > 0)
    np.testing.assert_array_equal(port.polarization.numpy(), 0.0)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    direct = valid & (np.asarray(ref.sol_type) == 1)
    amp_r, amp_p = np.asarray(ref.max_amp_per_solution), port.max_amp_per_solution.numpy()
    assert direct.sum() >= 3 and (valid & ~direct).sum() >= 3
    np.testing.assert_allclose(amp_p[direct], amp_r[direct], rtol=1e-9)
    # a turning ray's focusing factor carries the turning-point tolerance of
    # tests/test_torch_pa_ops.py
    np.testing.assert_allclose(amp_p[valid], amp_r[valid], rtol=5e-3)
    np.testing.assert_allclose(port.max_amplitude.numpy(), np.asarray(ref.max_amplitude),
                               rtol=5e-3)
    assert np.asarray(ref.triggered).any()
    # kernel 4 places V: the non-factored chain
    plain = tpipe.simulate_batch(pb, pc, dataclasses.replace(
        ps, placement_impl="plain", trigger_impl="plain"), emitter=pe)
    np.testing.assert_array_equal(plain.triggered.numpy(), port.triggered.numpy())


def test_emitter_runs_place_through_kernel_4(monkeypatch):
    from nuradiomc_tpu_torch.ops import placement
    batch, ch, settings, templates, rot = _setup()
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float32)
    pe = convert.emitter_from_jax(_emitter("delta_pulse", templates, rot), device="cpu",
                                  dtype=torch.float32)
    seen = []
    fn = placement.placement_reduce
    monkeypatch.setattr(placement, "placement_reduce",
                        lambda *a, **k: seen.append(k["s2"]) or fn(*a, **k))
    monkeypatch.setattr(placement, "chain_placement_reduce",
                        lambda *a, **k: pytest.fail("the factored chain ran"))
    tpipe.simulate_batch(pb, pc, ps, emitter=pe)
    assert seen == [2]
    assert convert.emitter_from_jax(None) is None


# ---- Simulation on the committed 24-pulser inputs ------------------------------

def _jax_simulation(variant, port):
    return jsim.Simulation(
        os.path.join(HERE, "golden", INPUTS[variant][0]), convert.SURFACE_DETECTOR,
        config=port.config,
        filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        triggers=[jsim.TriggerSpec(**dataclasses.asdict(t)) for t in port.triggers],
        antenna_replacements=port.antenna_replacements, chunk_size=24, dtype=jnp.float64)


@pytest.mark.parametrize("variant", ["efield", "voltage"])
def test_simulation_matches_jax(variant):
    port = convert.emitter_simulation(str(INPUTS[variant][1]), chunk_size=24, device="cpu",
                                      dtype=torch.float64)
    assert port.emitter_mode and port._emitter is not None
    assert port._emitter.model == {"efield": "efield_delta_pulse", "voltage": "hvsp1"}[variant]
    res = port.run()
    ref = _jax_simulation(variant, port).run()
    assert res["trigger_names"] == ref["trigger_names"]
    np.testing.assert_array_equal(res["multiple_triggers"], ref["multiple_triggers"])
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    np.testing.assert_array_equal(res["weights"], 1.0)
    np.testing.assert_allclose(res["max_amplitude"], ref["max_amplitude"], rtol=5e-3)
    assert 0 < res["multiple_triggers"].sum()
    pin = np.load(PIN)
    np.testing.assert_array_equal(pin[variant], ref["multiple_triggers"])
    assert not any(k.startswith("shower_realization") for k in res)


def test_emitter_inputs_are_the_exports():
    """The committed .npz inputs hold what the HDF5 reader returns."""
    from nuradiomc_tpu.sim import io_hdf5 as jio
    for name, npz in INPUTS.values():
        a = jio.read_input_hdf5(os.path.join(HERE, "golden", name))
        b = io_input.read_input(npz)
        assert b.attrs["simulation_mode"] == "emitter"
        assert set(a.emitter) == set(b.emitter)
        for k in a.emitter:
            np.testing.assert_array_equal(np.asarray(a.emitter[k]), b.emitter[k])
        for k in ("xx", "yy", "zz", "shower_energies", "event_group_ids"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_mixed_models_refused():
    inp = io_input.read_input(io_input.INPUT_EMITTER_EFIELD)
    em = dict(inp.emitter)
    em["emitter_model"] = np.array([b"efield_delta_pulse", b"delta_pulse"] * 12)
    with pytest.raises(NotImplementedError, match="mixed per-row"):
        convert.emitter_simulation(dataclasses.replace(inp, emitter=em), device="cpu")


if __name__ == "__main__":
    sets = {}
    for variant in INPUTS:
        port = convert.emitter_simulation(str(INPUTS[variant][1]), device="cpu")
        sets[variant] = _jax_simulation(variant, port).run()["multiple_triggers"]
        print(variant, sets[variant].sum(axis=0))
    np.savez_compressed(PIN, **sets)
    print(f"wrote {PIN}")
