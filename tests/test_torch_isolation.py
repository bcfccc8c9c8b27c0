"""The port stands alone: it imports nothing of jax or of the JAX package,
its copies of the JAX package's jax-free modules equal their originals, and
its entry points run on the card unless the CPU is asked for.

* Isolation: a subprocess refuses the top-level names ``jax``, ``jaxlib`` and
  ``nuradiomc_tpu`` with a meta-path hook, imports every module of
  ``nuradiomc_tpu_torch`` (``pkgutil.walk_packages``) and ``chip_smoke`` as a
  module (without running it), which imports none of h5py, matplotlib, ROOT,
  mattak and proposal (the card's machine has none of them), and reads no
  file under ``nuradiomc_tpu/``.
* Copies: units, constants, config merging, the filter responses of the
  three workloads' chains, the Earth-attenuation weights, the detector
  tables, the birefringence model arrays, the ice models, the GL3
  attenuation table, the measured pulser waveforms (``.npz`` copies of the
  HDF5 files), the exported emitter inputs, the ARZ mini shower library, the
  flux tables and fluxes, the muon and tau propagator, the event data model
  (parameters, parameter storage, BaseTrace, Event), the ``.nur`` container,
  the Veff tables, the time logger, the muon flux, the surface-muon
  generator, the job runner, the mesh's group padding, the measured
  hardware-response tables and functions, the SQL schema, the RNO-G site
  table, the template creator's pulse, the noise-rate curve and
  threshold, the LOFAR galactic calibration tables and the atmosphere
  model are held to the originals on the same inputs, exactly
  (the event generator in tests/test_torch_evtgen.py, the ``.nur`` files in
  tests/test_torch_nur_output.py, the Veff tables of a campaign's output in
  tests/test_torch_fullscale.py; the recorded-data slice's copies in their
  own files: the ARA and ARIANNA readers and the antenna preprocessors in
  tests/test_torch_ara_arianna_antenna.py, the RNO-G run writer in
  tests/test_torch_rnog_io_noise.py, and the SKA detector with its channel
  table, the ASCII event lists, the PROPOSAL stand-in and its table manager,
  the event and detector browsers, the vertex plot, the data-server
  downloads, the templates, the framework utilities, the particle names and
  the STATUS logger in tests/test_torch_host_modules.py).
* Default device: every entry point's ``device`` defaults to "cuda" (every
  reconstruction module class, through ``reco.base.Module``); with no card, a
  call that omits it raises instead of running on the CPU.
"""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from nuradiomc_tpu.detector import detector as jdetector
from nuradiomc_tpu.ops import filters as jfilters
from nuradiomc_tpu.sim import earth_attenuation as jearth
from nuradiomc_tpu.utils import config as jconfig
from nuradiomc_tpu.utils import constants as jconstants
from nuradiomc_tpu.utils import units as junits
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.detector import detector as tdetector
from nuradiomc_tpu_torch.examples import EXAMPLES, main_of
from nuradiomc_tpu_torch.ops import birefringence as tbire
from nuradiomc_tpu_torch.ops import filters as tfilters
from nuradiomc_tpu_torch.parallel import dryrun
from nuradiomc_tpu_torch.parallel import mesh as mesh_util
from nuradiomc_tpu_torch.reco import base as reco_base
from nuradiomc_tpu_torch.reco import efield_converters as reco_ec
from nuradiomc_tpu_torch.reco import trigger_modules as reco_tm
from nuradiomc_tpu_torch.reco import vertex as reco_vertex
from nuradiomc_tpu_torch.sim import earth_attenuation as tearth
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
from nuradiomc_tpu_torch.sim.simulation import Simulation
from nuradiomc_tpu_torch.detector import hardware_response as thr
from nuradiomc_tpu_torch.ops import raytrace as trt
from nuradiomc_tpu_torch.ops import raytrace_3d as t3d
from nuradiomc_tpu_torch.ops import raytrace_numeric as tnum
from nuradiomc_tpu_torch.sim import noise_rate as trate
from nuradiomc_tpu_torch.utils import config as tconfig
from nuradiomc_tpu_torch.utils import constants as tconstants
from nuradiomc_tpu_torch.utils import units as tunits
from nuradiomc_tpu_torch.reco import lofar as tlofar
from nuradiomc_tpu_torch.reco import rit as trit
from nuradiomc_tpu_torch.sim import io_coreas as tio_coreas
from nuradiomc_tpu_torch.reco import measured_noise as tnoise
from nuradiomc_tpu_torch.reco import rnog_data as trnog_data
from nuradiomc_tpu_torch.reco import rnog_io as trnog_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = textwrap.dedent("""
    import builtins, importlib, importlib.abc, importlib.util, os, pkgutil, sys
    root = sys.argv[1]
    sys.path.insert(0, root)
    banned = ("jax", "jaxlib", "nuradiomc_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in banned:
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    jax_pkg = os.path.join(root, "nuradiomc_tpu") + os.sep
    opened = []
    real_open = builtins.open

    def watching_open(file, *a, **k):
        if isinstance(file, (str, os.PathLike)) and os.path.abspath(file).startswith(jax_pkg):
            opened.append(str(file))
        return real_open(file, *a, **k)

    builtins.open = watching_open
    import numpy as np
    real_load = np.load

    def watching_load(file, *a, **k):
        if isinstance(file, (str, os.PathLike)) and os.path.abspath(file).startswith(jax_pkg):
            opened.append(str(file))
        return real_load(file, *a, **k)

    np.load = watching_load
    import nuradiomc_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(nuradiomc_tpu_torch.__path__,
                                                    "nuradiomc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(root, "chip_smoke.py"))
    importlib.util.module_from_spec(spec).__loader__.exec_module(
        importlib.util.module_from_spec(spec))
    optional = ("h5py", "matplotlib", "ROOT", "mattak", "proposal")
    imported = sorted(m for m in sys.modules if m.split(".")[0] in optional)
    assert not imported, imported
    from nuradiomc_tpu_torch.ops import birefringence
    from nuradiomc_tpu_torch import convert
    birefringence.load_model("southpole_A")
    convert.make_headline_inputs(4, 2, 2, 128, 512, device="cpu")
    # the new copies are read from the port's own data directory
    from nuradiomc_tpu_torch.ops import attenuation, emitter
    import torch
    attenuation.get_attenuation_length(torch.tensor(-100.0), torch.tensor(0.2), "GL3")
    emitter.get_measured_time_trace("idl1", 1.0, 256, 0.5)
    convert.emitter_simulation(
        os.path.join(root, "nuradiomc_tpu_torch", "data", "emitter_voltage_events.npz"),
        device="cpu")
    convert.arz_simulation(convert.mooresbay_event_input(2), device="cpu")
    convert.make_mooresbay_inputs(2, device="cpu")
    # the campaign path: the generator with a named flux (the port's flux
    # tables) and secondaries, a .nur file written and read back
    import tempfile
    from nuradiomc_tpu_torch.sim import evtgen, io_input, io_nur
    from nuradiomc_tpu_torch.framework.event import Event
    evtgen.get_energies(4, 1e16, 1e20, "GZK-1+GZK-2")
    data, attrs = convert.gen2_tau_event_list(8)
    io_input.from_generated(data, attrs)
    with tempfile.TemporaryDirectory() as tmp:
        w = io_nur.EventWriter(os.path.join(tmp, "e.nur"))
        w.run(Event(0, 1))
        w.end()
        assert [e.get_id() for e in io_nur.EventReader(os.path.join(tmp, "e.nur")).run()] == [1]
    # the multi-device slice's copies: the surface-muon generator and flux,
    # the runner and the time logger
    from nuradiomc_tpu_torch.sim import muon_flux, runner
    from nuradiomc_tpu_torch.utils import timing
    convert.surface_muon_event_list(4)
    muon_flux.MuonFlux(os.path.join(root, "unused.pkl")).get_mu_flux(1.0)
    runner.Runner(lambda i, rng: (None, None), lambda b: (b, {})).run()
    timing.pretty_time_delta(61)
    # the reconstruction slice: NuRadioReco's own .nur through the port's
    # reader, and the reco modules on the CPU
    ev = list(io_nur.EventReader(os.path.join(root, "tests", "golden",
                                              "reference_events.nur")).run())
    assert len(ev) == 3
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev, parameters as fpar
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.reco import channel_processing, examples, vertex
    evt, st = examples.simple_event(fev, fpar)
    channel_processing.channelBandPassFilter(device="cpu").run(
        evt, st, Detector(examples.SIMPLE_DETECTOR), passband=[0.1, 0.5])
    vertex.build_travel_time_table(ice_models.get_ice_model("greenland_simple"), -100.0,
                                   x_max=200.0, d_x=50.0, z_min=-300.0, d_z=50.0,
                                   device="cpu")
    # the tenth slice: the measured response tables from the port's data
    # directory, the RNO-G export and SQL detectors, the new solvers and the
    # noise-rate chain on the CPU
    from nuradiomc_tpu_torch.detector import detector_sql, hardware_response, rnog_detector
    from nuradiomc_tpu_torch.models import ice_profiles
    from nuradiomc_tpu_torch.ops import raytrace, raytrace_3d, raytrace_numeric
    from nuradiomc_tpu_torch.sim import noise_rate
    for amp in ("100", "200", "300"):
        hardware_response.get_amplifier_response([0.1, 0.3], amp)
    for amp in hardware_response.RNOG_AMPLIFIERS:
        hardware_response.load_rnog_amp_response(amp)["gain"]([0.1, 0.3])
    hardware_response.get_ara_system_response()([0.2])
    detector_sql.export_detector_to_sql(convert.DIPOLE_DETECTOR, ":memory:").buffer()
    try:
        rnog_detector.RNOGDetector()
    except NotImplementedError:
        pass
    raytrace.find_solution_ice_to_air(0.0, -100.0, 100.0, 200.0,
                                      ice_models.get_ice_model("southpole_2015"), device="cpu")
    raytrace_numeric.find_solutions_numeric(ice_profiles.greenland_firn, 0.0, -700.0, 900.0,
                                            -80.0, device="cpu")
    raytrace_3d.find_solutions_3d(lambda x, y, z: 1.78 + 0.0 * z, (300.0, 0.0, -300.0),
                                  (0.0, 0.0, -100.0), n_fan=4, n_bisect=1, ds=50.0,
                                  n_steps=12, device="cpu")
    noise_rate.run_phased_array_tuning(8, 256, 2.0, 1e-5, np.ones(129), [[0, 1]], 2, 16, 8,
                                       batch=8, device="cpu")
    # the cosmic-ray slice: the LOFAR calibration tables from the port's data
    # directory, the RIT interference, a CoREAS star read from memory, the
    # Stokes parameters of the event data model
    from nuradiomc_tpu_torch.reco import coreas_readers, lofar, rit
    assert lofar._DATA.startswith(os.path.join(root, "nuradiomc_tpu_torch") + os.sep)
    cal = lofar.stationGalacticCalibrator(device="cpu")
    cal.begin()
    ldet = convert.LofarDetector(n_ant=4)
    levt = fev.Event(0, 1)
    levt.set_station(convert.make_lofar_station(fev, ldet, 2, 0.6, 2.0, n_samples=2048))
    cal.run(levt, ldet, unix_time=1.4e9)
    pos, tr, ti, _, src, _ = convert.make_rit_event(n_ant=4, n_samples=256)
    rit.interfere_traces(src, pos, tr, ti, rit.Refractivity(rit.Atmosphere(17)), device="cpu")
    reader = coreas_readers.readCoREASDetector(device="cpu")
    reader.begin(convert.make_coreas_star(radii_cm=np.array([2000.0, 8000.0]), n_t=64))
    list(reader.run(Detector(convert.coreas_lpda_detector()), [[0.0, 0.0]]))
    field = fev.ElectricField([0])
    field.set_trace(np.random.default_rng(0).normal(size=(3, 64)), 1.0)
    field.get_stokes_parameters()
    # the recorded-data slice: RNO-G runs written and read back through the
    # data provider, the hit filter, measured noise from the runs' forced
    # triggers, the SKA channel table from the port's data directory
    from nuradiomc_tpu_torch.detector import ska
    from nuradiomc_tpu_torch.reco import measured_noise, rnog_data, rnog_io
    assert ska._CHANNEL_FILE.startswith(os.path.join(root, "nuradiomc_tpu_torch") + os.sep)
    ska.SKADetector()
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = convert.make_rnog_runs(tmp, n_runs=1, n_events=3)
        provider = rnog_io.dataProviderRNOG(device="cpu")
        provider.begin(paths, convert.RNOGRunDetector())
        recorded = list(provider.run())
        rnog_data.stationHitFilter(device="cpu").run_events(recorded)
        importer = measured_noise.RNOGNoiseImporter(device="cpu")
        importer.begin(tmp, random_seed=1)
        importer.run_events(convert.make_rnog_sim_stations(fev, 2))
    # the example workflows: every module imported above; the host-side
    # ones run on the CPU
    from nuradiomc_tpu_torch.examples import EXAMPLES, main_of
    assert {m for m, _, _ in EXAMPLES.values()} <= set(names)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("e15", "e11_a01", "e10_a01", "e12", "e03"):
            main_of(name)(EXAMPLES[name][1], device="cpu", outdir=tmp)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    assert not leaked, leaked
    assert not opened, opened
    print("modules", len(names))
""")


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ISOLATED, ROOT], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 30                      # every module of the package was imported


def convert_input(name):
    from nuradiomc_tpu_torch.sim import io_input
    return io_input.DATA_DIR / name


def _public_numbers(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(v, (int, float))}


def test_units_and_constants_equal_the_originals():
    for port, ref in ((tunits, junits), (tconstants, jconstants)):
        a, b = _public_numbers(port), _public_numbers(ref)
        assert a == b and len(a) > 0


CHAINS = {
    "dipole/gen2 butterworth": [((80e-3, 1000.0), "butter", {"order": 2}),
                                ((0, 0.5), "butter", {"order": 10})],
    "phased-array cheby1": [((96e-3, 100.0), "cheby1", {"order": 4, "rp": 0.1}),
                            ((0, 0.22), "cheby1", {"order": 7, "rp": 0.1})],
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("n", [512, 1024, 2048])
def test_filter_chain_response_equals_the_original(chain, n):
    freqs = np.fft.rfftfreq(n, 0.5)
    stages = [((lo * junits.GHz, hi * junits.GHz), kind, kw)
              for (lo, hi), kind, kw in CHAINS[chain]]
    np.testing.assert_array_equal(tfilters.chain_response(freqs, stages),
                                  jfilters.chain_response(freqs, stages))


@pytest.mark.parametrize("mode", ["core_mantle_crust_simple", "simple", "PREM", "None"])
def test_earth_attenuation_weight_equals_the_original(mode):
    rng = np.random.default_rng(4)
    n = 64
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    energy = 10 ** rng.uniform(16, 20, n) * junits.eV
    flavors = rng.choice([12, -12, 14, -14, 16, -16], n)
    vertex = np.c_[rng.uniform(-2e3, 2e3, (n, 2)), rng.uniform(-2.7e3, 0, n)]
    kw = dict(mode=mode, cross_section_type="ctw", vertex_position=vertex, phi_nu=phi)
    np.testing.assert_array_equal(tearth.get_weight(theta, energy, flavors, **kw),
                                  jearth.get_weight(theta, energy, flavors, **kw))


def test_config_merging_equals_the_original():
    user = {"sampling_rate": 3.0, "propagation": {"birefringence": True, "n_freq": 16},
            "signal": {"model": "Alvarez2009"}, "noise": True}
    assert tconfig.get_config(None) == jconfig.get_config(None)
    assert tconfig.get_config(user) == jconfig.get_config(user)
    for default in (convert.DIPOLE_CONFIG, convert.PA_CONFIG, convert.GEN2_CONFIG,
                    convert.MOORESBAY_CONFIG, convert.EMITTER_CONFIG):
        assert tconfig.merge_config(user, default) == jconfig.merge_config(user, default)


@pytest.mark.parametrize("name", ["DIPOLE_DETECTOR", "PA_DETECTOR", "GEN2_DETECTOR",
                                  "MOORESBAY_DETECTOR", "SURFACE_DETECTOR"])
def test_detector_tables_equal_the_original(name):
    det_dict = getattr(convert, name)
    port, ref = tdetector.Detector(det_dict), jdetector.Detector(det_dict)
    assert list(port.get_station_ids()) == list(ref.get_station_ids())
    for sid in ref.get_station_ids():
        a, b = port.get_station(sid), ref.get_station(sid)
        np.testing.assert_array_equal(a.absolute_position, b.absolute_position)
        assert a.site == b.site
        for field in vars(b.channels):
            va, vb = getattr(a.channels, field), getattr(b.channels, field)
            if vb is None:
                assert va is None
            else:
                np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        if b.site:
            assert port.get_site_coordinates(sid) == ref.get_site_coordinates(sid)


def test_birefringence_models_equal_the_originals():
    ref_dir = os.path.join(ROOT, "nuradiomc_tpu", "data", "birefringence_models")
    names = sorted(f for f in os.listdir(ref_dir) if f.endswith(".npy"))
    assert sorted(os.listdir(tbire._MODEL_DIR)) == names
    for f in names:
        with open(os.path.join(tbire._MODEL_DIR, f), "rb") as a, \
                open(os.path.join(ref_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    from nuradiomc_tpu.ops import birefringence as jbire
    for name in ("southpole_A", "southpole_E", "greenland_C"):
        for a, b in zip(tbire.load_model(name), jbire.load_model(name)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ice_models_equal_the_originals():
    import dataclasses
    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu_torch.models import ice as tice
    assert sorted(tice._MODELS) == sorted(jice._MODELS)
    for name in jice._MODELS:
        a, b = tice.get_ice_model(name), jice.get_ice_model(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    mb = tice.get_ice_model("mooresbay_simple")
    assert (mb.refl_z, mb.refl_coef, mb.refl_phase_shift) == (-576.0, 0.82, np.pi)
    z = np.linspace(-600.0, 5.0, 50)
    np.testing.assert_allclose(mb.index_of_refraction(torch.as_tensor(z)).numpy(),
                               np.asarray(jice.mooresbay_simple.index_of_refraction(z)),
                               rtol=1e-15)
    with pytest.raises(NotImplementedError, match="not implemented"):
        tice.get_ice_model("no_such_site")


def test_gl3_table_equals_the_original():
    with open(os.path.join(ROOT, "nuradiomc_tpu", "data", "GL3_params.csv"), "rb") as a, \
            open(os.path.join(ROOT, "nuradiomc_tpu_torch", "data", "GL3_params.csv"), "rb") as b:
        assert a.read() == b.read()


def test_pulser_waveforms_equal_the_originals():
    import h5py
    from nuradiomc_tpu.ops import emitter as jem
    from nuradiomc_tpu_torch.ops import emitter as tem
    assert {k: v[:-4] for k, v in tem.MEASURED_MODELS.items()} == \
        {k: v[:-5] for k, v in jem.MEASURED_MODELS.items()}
    assert sorted(os.listdir(tem._DATA_DIR)) == sorted(tem.MEASURED_MODELS.values())
    for model, name in jem.MEASURED_MODELS.items():
        with h5py.File(os.path.join(jem._DATA_DIR, name), "r") as f:
            with np.load(os.path.join(tem._DATA_DIR, tem.MEASURED_MODELS[model])) as z:
                assert sorted(z.files) == ["time", "voltage"]
                np.testing.assert_array_equal(z["time"], np.asarray(f["time"]))
                np.testing.assert_array_equal(z["voltage"], np.asarray(f["voltage"]))


@pytest.mark.parametrize("name", ["emitter_events", "emitter_voltage_events"])
def test_emitter_inputs_equal_the_originals(name):
    from nuradiomc_tpu.sim import io_hdf5 as jio
    from nuradiomc_tpu_torch.sim import io_input
    ref = jio.read_input_hdf5(os.path.join(ROOT, "tests", "golden", name + ".hdf5"))
    got = io_input.read_input(io_input.DATA_DIR / (name + ".npz"))
    for field in io_input._ARRAYS:
        a, b = getattr(ref, field), getattr(got, field)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=field)
    assert {k: str(v) for k, v in got.attrs.items()} == {k: str(v) for k, v in ref.attrs.items()}
    assert sorted(got.emitter) == sorted(ref.emitter)
    for k in ref.emitter:
        np.testing.assert_array_equal(got.emitter[k], np.asarray(ref.emitter[k]))


def test_rnog_example_input_equals_the_original(tmp_path):
    """``data/rnog_events_1000.npz`` against the list that
    examples/06_rno_g_station/run_rnog_station.py writes by default (its
    generator call, regenerated here: the file is not kept in git)."""
    from nuradiomc_tpu.sim import evtgen as jevtgen
    from nuradiomc_tpu.sim import io_hdf5 as jio
    from nuradiomc_tpu_torch.sim import io_input
    path = str(tmp_path / "rnog_events.hdf5")
    jevtgen.generate_eventlist_cylinder(
        path, 1000, 1e18, 1e18, {"fiducial_rmin": 0, "fiducial_rmax": 2 * junits.km,
                                 "fiducial_zmin": -2.5 * junits.km, "fiducial_zmax": 0},
        seed=42)
    ref = jio.read_input_hdf5(path)
    got = io_input.read_input(io_input.INPUT_RNOG)
    for field in io_input._ARRAYS:
        a, b = getattr(ref, field), getattr(got, field)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=field)
    assert {k: str(v) for k, v in got.attrs.items()} == {k: str(v) for k, v in ref.attrs.items()}


def test_arz_minilib_equals_the_original():
    with open(os.path.join(ROOT, "tests", "golden", "arz_minilib.pkl"), "rb") as a, \
            open(os.path.join(ROOT, "nuradiomc_tpu_torch", "data", "arz_minilib.pkl"), "rb") as b:
        assert a.read() == b.read()


def test_flux_tables_and_fluxes_equal_the_originals():
    from nuradiomc_tpu.sim import fluxes as jfluxes
    from nuradiomc_tpu_torch.sim import fluxes as tfluxes
    ref_dir = os.path.join(ROOT, "nuradiomc_tpu", "data", "fluxes")
    port_dir = os.path.join(ROOT, "nuradiomc_tpu_torch", "data", "fluxes")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    for f in os.listdir(ref_dir):
        with open(os.path.join(ref_dir, f), "rb") as a, open(os.path.join(port_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    E = 10 ** np.linspace(14, 21, 200) * junits.eV
    for name in ("ice_cube_nu_fit", "ice_cube_nu_fit_2022", "get_proton_10", "get_TAGZK_flux",
                 "get_TAGZK_flux_ICRC2021"):
        np.testing.assert_array_equal(getattr(tfluxes, name)(E), getattr(jfluxes, name)(E))
    veff = np.full(E.shape, 1e9)
    np.testing.assert_array_equal(tfluxes.get_limit_e2_flux(E, veff, 3e7),
                                  jfluxes.get_limit_e2_flux(E, veff, 3e7))


def test_muon_and_tau_propagation_equal_the_originals():
    from nuradiomc_tpu.sim import muon_propagation as jmp
    from nuradiomc_tpu_torch.sim import muon_propagation as tmp
    E = 10 ** np.linspace(17, 20, 12)
    for fn in ("propagate_muons", "propagate_taus"):
        a = getattr(tmp, fn)(E, 4000.0, rng=np.random.default_rng(np.random.Philox(3)))
        b = getattr(jmp, fn)(E, 4000.0, rng=np.random.default_rng(np.random.Philox(3)))
        assert repr(a) == repr(b), fn
    assert sum(len(x) for x in a[0]) > 0
    np.testing.assert_array_equal(tmp.csda_mean_energy(E, 1e5), jmp.csda_mean_energy(E, 1e5))


def test_event_data_model_equals_the_original():
    from nuradiomc_tpu.framework import base_trace as jbt, parameters as jpar
    from nuradiomc_tpu_torch.framework import base_trace as tbt, parameters as tpar
    for name in dir(jpar):
        enum = getattr(jpar, name)
        if isinstance(enum, type) and issubclass(enum, jpar.Enum) and enum is not jpar.Enum:
            assert [m.name for m in getattr(tpar, name)] == [m.name for m in enum], name
    trace = np.random.default_rng(1).normal(size=512)
    a, b = tbt.BaseTrace(trace, 2.0, 10.0), jbt.BaseTrace(trace, 2.0, 10.0)
    for x in (a, b):
        x.apply_time_shift(0.3)
        x.resample(1.0)
    np.testing.assert_array_equal(a.get_trace(), b.get_trace())
    np.testing.assert_array_equal(a.get_times(), b.get_times())


def test_veff_helpers_equal_the_originals():
    from nuradiomc_tpu.sim import veff as jveff
    from nuradiomc_tpu_torch.sim import veff as tveff
    for n in (0, 3, 20, 150):
        assert tveff.FC_limits(n) == jveff.FC_limits(n)
    assert tveff.get_Veff_water_equivalent(2.5) == jveff.get_Veff_water_equivalent(2.5)
    assert tveff.get_veff_output(1e9, 7.5, 100) == jveff.get_veff_output(1e9, 7.5, 100)


def test_multi_device_copies_equal_the_originals():
    import types

    from nuradiomc_tpu.parallel import mesh as jmesh
    from nuradiomc_tpu.sim import evtgen as jevtgen, muon_flux as jflux
    from nuradiomc_tpu.utils import timing as jtiming
    from nuradiomc_tpu_torch.parallel import mesh as tmesh
    from nuradiomc_tpu_torch.sim import evtgen as tevtgen, muon_flux as tflux
    from nuradiomc_tpu_torch.utils import timing as ttiming
    for sec in (0, 59, 3725, 90061):
        assert ttiming.pretty_time_delta(sec) == jtiming.pretty_time_delta(sec)
    E = 10 ** np.linspace(11, 20, 20)
    np.testing.assert_array_equal(tflux.gaisser_flux(E, 1.0), jflux.gaisser_flux(E, 1.0))
    vol = {"fiducial_rmin": 0, "fiducial_rmax": 2000.0, "fiducial_zmin": -1000.0,
           "fiducial_zmax": 0}
    for sec in ("parametrized", "stochastic"):
        a, _ = tevtgen.generate_surface_muons(None, 20, 1e17, 1e19, vol, seed=4,
                                              secondaries=sec)
        b, _ = jevtgen.generate_surface_muons(None, 20, 1e17, 1e19, vol, seed=4,
                                              secondaries=sec)
        assert tevtgen.list_digest(a) == tevtgen.list_digest(b), sec
    for n_ev in (1, 3, 4):
        port = types.SimpleNamespace(n_event=n_ev)
        ref = types.SimpleNamespace(shape={"event": n_ev})
        assert [tmesh.pad_groups(g, port) for g in range(1, 13)] == \
            [jmesh.pad_groups(g, ref) for g in range(1, 13)]


def test_hardware_response_copies_equal_the_originals():
    """The measured tables byte for byte, and the host numpy functions of
    detector/hardware_response.py on the same grids, exactly."""
    from nuradiomc_tpu.detector import hardware_response as jhr
    ref_dir = os.path.join(ROOT, "nuradiomc_tpu", "data", "hardware_responses")
    port_dir = os.path.join(ROOT, "nuradiomc_tpu_torch", "data", "hardware_responses")
    ref_files = sorted(os.path.relpath(os.path.join(d, f), ref_dir)
                       for d, _, fs in os.walk(ref_dir) for f in fs)
    port_files = sorted(os.path.relpath(os.path.join(d, f), port_dir)
                        for d, _, fs in os.walk(port_dir) for f in fs)
    assert port_files == ref_files and len(ref_files) == 14
    for f in ref_files:
        with open(os.path.join(ref_dir, f), "rb") as a, open(os.path.join(port_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    ff = np.linspace(0.0, 1.2, 601)
    for amp in ("100", "200", "300"):
        np.testing.assert_array_equal(thr.get_amplifier_response(ff, amp),
                                      jhr.get_amplifier_response(ff, amp))
    for cable in ("LMR_400", "LMR_240"):
        np.testing.assert_array_equal(thr.get_cable_response_parametrized(ff, cable, 30.0),
                                      jhr.get_cable_response_parametrized(ff, cable, 30.0))
    np.testing.assert_array_equal(thr.get_ara_system_response()(ff),
                                  jhr.get_ara_system_response()(ff))
    assert thr.RNOG_AMPLIFIERS == jhr.RNOG_AMPLIFIERS
    for amp in jhr.RNOG_AMPLIFIERS:
        a, b = thr.load_rnog_amp_response(amp), jhr.load_rnog_amp_response(amp)
        for temp in (243.15, 293.15):
            np.testing.assert_array_equal(a["gain"](ff, temp), b["gain"](ff, temp))
        np.testing.assert_array_equal(a["phase"](ff), b["phase"](ff))


def test_cosmic_ray_copies_equal_the_originals():
    """The LOFAR galactic calibration tables byte for byte, the atmosphere
    model's parameterizations and host functions exactly."""
    from nuradiomc_tpu.models import atmosphere as jatm
    from nuradiomc_tpu_torch.models import atmosphere as tatm
    ref_dir = os.path.join(ROOT, "nuradiomc_tpu", "data", "galactic_calibration")
    port_dir = os.path.join(ROOT, "nuradiomc_tpu_torch", "data", "galactic_calibration")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) and os.listdir(ref_dir)
    for f in os.listdir(ref_dir):
        with open(os.path.join(ref_dir, f), "rb") as a, open(os.path.join(port_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    assert tlofar._DATA == port_dir
    assert sorted(tatm.ATM_MODELS) == sorted(jatm.ATM_MODELS)
    for model, params in jatm.ATM_MODELS.items():
        for key, value in params.items():
            np.testing.assert_array_equal(tatm.ATM_MODELS[model][key], value)
    assert (tatm.R_EARTH, tatm.M_TO_CM) == (jatm.R_EARTH, jatm.M_TO_CM)
    a, b = tatm.Atmosphere(), jatm.Atmosphere()
    d = np.linspace(0.0, 3e4, 61)
    for zen in (0.0, 0.5, 1.3):
        np.testing.assert_array_equal(a.get_slant_depth_at_distance(d, zen, 500.0),
                                      b.get_slant_depth_at_distance(d, zen, 500.0))
        np.testing.assert_array_equal(a.height_at_distance(d, zen, 500.0),
                                      b.height_at_distance(d, zen, 500.0))


def test_detector_backend_and_tuning_copies_equal_the_originals():
    from nuradiomc_tpu.detector import detector_sql as jsql, rnog_detector as jrd
    from nuradiomc_tpu.reco import rnog as jrnog
    from nuradiomc_tpu.sim import noise_rate as jrate
    from nuradiomc_tpu_torch.detector import detector_sql as tsql, rnog_detector as trd
    from nuradiomc_tpu_torch.reco import rnog as trnog
    assert tsql.SQL_SCHEMA == jsql.SQL_SCHEMA
    assert trd.SITE_COORDINATES == jrd.SITE_COORDINATES
    x = np.linspace(0.0, 2047.0, 2048)
    np.testing.assert_array_equal(trnog._gaussian_func(x, 0.8, 1000, 4),
                                  jrnog._gaussian_func(x, 0.8, 1000, 4))
    mp = np.random.default_rng(2).exponential(size=5000)
    thr_ = np.linspace(0.0, 8.0, 33)
    np.testing.assert_array_equal(trate.estimate_rate_curve(thr_, mp, 512.0),
                                  jrate.estimate_rate_curve(thr_, mp, 512.0))
    for target in (1e-6, 1e-4, 1e-3):
        assert trate.tune_threshold(target, mp, 512.0) == jrate.tune_threshold(target, mp, 512.0)


ENTRY_POINTS = [Simulation.__init__, convert.from_jax, convert.make_headline_inputs,
                convert.make_pa_inputs, convert.make_gen2_inputs,
                convert.make_multitrigger_inputs, convert.make_mooresbay_inputs,
                convert.emitter_from_jax, convert.library_from_jax,
                mesh_util.make_mesh, dryrun.dryrun_simulation, dryrun.dryrun_multichip,
                reco_base.Module.__init__, reco_vertex.neutrino2DVertexReconstructor.__init__,
                reco_vertex.build_travel_time_table, reco_ec.get_channel_vel,
                reco_tm.get_digital_trace, trt.find_solution_ice_to_air,
                tnum.find_solutions_numeric, t3d.find_solutions_3d, t3d.refine_solutions_3d,
                trate.run_phased_array_tuning, thr.hardwareResponseIncorporator.__init__,
                thr.rnogHardwareResponseIncorporator.__init__, tlofar.find_rfi,
                trit.interfere_traces, trit.Interferometer.__init__,
                tio_coreas.coreasInterpolator.get_interp_efields]


def _reco_module_classes():
    """Every module class of the reconstruction slice (all on reco.base.Module)."""
    import importlib
    import pkgutil

    import nuradiomc_tpu_torch.reco as reco
    out = []
    for m in pkgutil.iter_modules(reco.__path__):
        mod = importlib.import_module(f"nuradiomc_tpu_torch.reco.{m.name}")
        out += [c for c in vars(mod).values()
                if isinstance(c, type) and issubclass(c, reco_base.Module)
                and c is not reco_base.Module and c.__module__ == mod.__name__]
    return out


def test_every_reco_module_takes_a_device_defaulting_to_the_card():
    classes = _reco_module_classes()
    assert len(classes) >= 30
    for cls in classes:
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_default_to_the_card(name, tmp_path):
    """Every example module's ``main`` runs on the card unless the CPU is
    asked for: without a card, omitting ``device`` raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_of(name)(EXAMPLES[name][1], outdir=str(tmp_path))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("call", ["Simulation", "dipole_simulation", "make_headline_inputs",
                                  "make_pa_inputs", "make_gen2_inputs",
                                  "make_mooresbay_inputs", "emitter_simulation",
                                  "fullscale_simulation", "fullscale_pa_simulation",
                                  "surface_muon_simulation", "dryrun_simulation",
                                  "reco_module", "travel_time_table", "ice_to_air",
                                  "numeric_solver", "solver_3d", "noise_tuning",
                                  "hardware_response", "rfi", "rit", "beam_search",
                                  "rnog_reader", "rnog_provider", "block_offsets",
                                  "noise_importer"])
def test_omitted_device_without_a_card_raises(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    calls = {
        "Simulation": lambda: Simulation(
            str(INPUT_1E18_N3000), convert.DIPOLE_DETECTOR,
            antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"}),
        "dipole_simulation": lambda: convert.dipole_simulation(str(INPUT_1E18_N3000)),
        "make_headline_inputs": lambda: convert.make_headline_inputs(4, 2, 1, 128, 512),
        "make_pa_inputs": lambda: convert.make_pa_inputs(8),
        "make_gen2_inputs": lambda: convert.make_gen2_inputs(8),
        "make_mooresbay_inputs": lambda: convert.make_mooresbay_inputs(8),
        "emitter_simulation": lambda: convert.emitter_simulation(
            str(convert_input("emitter_events.npz"))),
        "fullscale_simulation": lambda: convert.fullscale_simulation(
            io_input.from_generated(*convert.fullscale_event_list(convert.FULLSCALE_PA_LIST))),
        "fullscale_pa_simulation": lambda: convert.fullscale_pa_simulation(
            io_input.from_generated(*convert.fullscale_event_list(convert.FULLSCALE_PA_LIST))),
        "surface_muon_simulation": lambda: convert.surface_muon_simulation(
            io_input.from_generated(*convert.surface_muon_event_list(4))),
        "dryrun_simulation": lambda: dryrun.dryrun_simulation(),
        "reco_module": lambda: reco_vertex.neutrino3DVertexReconstructor(None),
        "travel_time_table": lambda: reco_vertex.build_travel_time_table(None, -100.0),
        "ice_to_air": lambda: trt.find_solution_ice_to_air(0.0, -100.0, 100.0, 200.0, None),
        "numeric_solver": lambda: tnum.find_solutions_numeric(None, 0.0, -700.0, 900.0, -80.0),
        "solver_3d": lambda: t3d.find_solutions_3d(None, (300.0, 0.0, -300.0),
                                                   (0.0, 0.0, -100.0)),
        "noise_tuning": lambda: trate.run_phased_array_tuning(8, 256, 2.0, 1e-5, None,
                                                              [[0, 1]], 2, 16, 8),
        "hardware_response": lambda: thr.rnogHardwareResponseIncorporator(),
        "rfi": lambda: tlofar.find_rfi(np.zeros((2, 16)), 0.2, 8),
        "rit": lambda: trit.efieldInterferometricAxisReco(),
        "beam_search": lambda: tlofar.beamformingDirectionFitter(),
        "rnog_reader": lambda: trnog_io.readRNOGData(),
        "rnog_provider": lambda: trnog_io.dataProviderRNOG(),
        "block_offsets": lambda: trnog_data.channelBlockOffsets(),
        "noise_importer": lambda: tnoise.ARIANNANoiseImporter(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
