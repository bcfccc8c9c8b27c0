"""The port's ARA and ARIANNA readers (reco/ara_io.py, reco/arianna_io.py)
and antenna-pattern preprocessors (detector/antenna_preprocess.py), host
copies of the JAX package's, held to the originals on the same inputs.

* Readers: tests/test_ara_arianna_io.py's fixtures (written by either
  package's writer: the same files) read by both packages: the same events,
  trees equal bit for bit (``reco.examples.assert_same_tree``), the same
  skip counters.
* Preprocessors: the small raw pattern files of
  ``convert.write_antenna_pattern`` (the formats of tests/
  test_antenna_preprocess2.py's and tests/test_antenna_table.py's fixtures:
  WIPL-D, the WIPL-D export for ARASim, ARASim, generic XFDTD, HFSS, AERA,
  LOFAR, FEKO and the RNO-G XFDTD csv pair) through both packages'
  preprocessors: each pickle
  equal, loaded by the port's ``ops/antenna.load_antenna_table`` and read by
  its ``table_vel`` within 1e-12 (relative, and of the VEL's peak over both
  components) of the JAX package's ``table_vel`` on the JAX package's
  table.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nuradiomc_tpu.detector import antenna_preprocess as japp  # noqa: E402
from nuradiomc_tpu.ops import antenna as jant  # noqa: E402
from nuradiomc_tpu.reco import ara_io as jara, arianna_io as jari  # noqa: E402
from nuradiomc_tpu_torch import convert  # noqa: E402
from nuradiomc_tpu_torch.detector import antenna_preprocess as tapp  # noqa: E402
from nuradiomc_tpu_torch.ops import antenna as tant  # noqa: E402
from nuradiomc_tpu_torch.reco import ara_io as tara, arianna_io as tari  # noqa: E402
from nuradiomc_tpu_torch.reco.examples import assert_same_tree, event_tree  # noqa: E402
from test_ara_arianna_io import _ara_fixture, _arianna_fixture  # noqa: E402


def _same_events(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert_same_tree(event_tree(a), event_tree(b))


def test_ara_reader(tmp_path):
    path, times, volts = _ara_fixture(tmp_path)
    tara.write_numpy_dataset(tmp_path / "port.npz", 42, [2] * 3, np.arange(100, 103), times,
                             volts)
    za, zb = np.load(tmp_path / "port.npz", allow_pickle=True), np.load(path, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in zb.files:
        np.testing.assert_array_equal(za[k], zb[k])
    readers = tara.readARAData(), jara.readARAData()
    assert readers[0].begin(str(tmp_path / "port.npz")) == readers[1].begin(str(path)) == 3
    _same_events(list(readers[0].run(n_channels=4)), list(readers[1].run(n_channels=4)))
    with pytest.raises(ImportError, match="AraRoot"):
        tara.readARAData().begin("/nonexistent/run.root")


@pytest.mark.parametrize("kw", [{}, {"trigger_types": ["forced"]}, {"event_ids": {7: [11]}},
                                {"run_number": 8}], ids=["all", "forced", "ids", "run"])
def test_arianna_calib_reader(tmp_path, kw):
    path, _, _ = _arianna_fixture(tmp_path)
    port, ref = tari.readARIANNADataCalib(), jari.readARIANNADataCalib()
    assert port.begin(str(path), **kw) == ref.begin(str(path), **kw)
    a, b = list(port.run()), list(ref.run())
    assert [e.get_id() for e in a] == [e.get_id() for e in b]
    for x, y in zip(a, b):
        assert_same_tree(event_tree(x), event_tree(y))
    assert (port.skipped_events, port.skipped_events_stop) == \
        (ref.skipped_events, ref.skipped_events_stop)
    with pytest.raises(ImportError, match="snowshovel"):
        tari.readARIANNADataCalib().begin("/nonexistent/file.root")


def test_arianna_basic_reader(tmp_path):
    path, wf, blocks = _arianna_fixture(tmp_path)
    tari.write_numpy_dataset(tmp_path / "port.npz", trees={"AmpOutData": wf}, **blocks)
    za, zb = np.load(tmp_path / "port.npz"), np.load(path)
    for k in zb.files:
        np.testing.assert_array_equal(za[k], zb[k])
    port, ref = tari.readARIANNAData(), jari.readARIANNAData()
    assert port.begin(str(tmp_path / "port.npz"), station_id=51) == \
        ref.begin(str(path), station_id=51)
    _same_events(list(port.run()), list(ref.run()))


# ------------------------------------------------------------ preprocessors

def _preprocess(pkg, root, kind):
    """The pickle path written by ``pkg``'s preprocessor for the raw
    pattern ``kind`` that ``convert.write_antenna_pattern`` writes under
    ``root`` (a fresh directory per package)."""
    name, args, kwargs = convert.write_antenna_pattern(root, kind)
    return getattr(pkg, name)(*args, **kwargs)


def _same_payload(a, b):
    assert len(a) == len(b) == 9
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", convert.ANTENNA_PATTERN_KINDS)
def test_preprocessor_pickle_and_table_vel(tmp_path, kind):
    roots = tmp_path / "port", tmp_path / "jax"
    for r in roots:
        r.mkdir()
    got = _preprocess(tapp, roots[0], kind)
    want = _preprocess(japp, roots[1], kind)
    with open(got, "rb") as fa, open(want, "rb") as fb:
        _same_payload(pickle.load(fa), pickle.load(fb))
    tn, tj = tant.load_antenna_table(got), jant.load_antenna_table(want)
    tt = tant.AntennaTable(*(torch.as_tensor(np.asarray(getattr(tn, k)))
                             for k in ("freqs", "thetas", "phis", "h_theta", "h_phi")),
                           orientation=tn.orientation)
    rng = np.random.default_rng(3)
    zen = rng.uniform(0, np.pi, 40)
    az = rng.uniform(0, 2 * np.pi, 40)
    freqs = np.linspace(tn.freqs[0], tn.freqs[-1], 16)
    c, s = np.cos(0.3), np.sin(0.3)          # the antenna turned about the vertical
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    ref_t, ref_p = jax.vmap(lambda z, a: jant.table_vel(z, a, jnp.asarray(rot), tj,
                                                        jnp.asarray(freqs)))(
        jnp.asarray(zen), jnp.asarray(az))
    got_t, got_p = tant.table_vel(torch.as_tensor(zen), torch.as_tensor(az),
                                  torch.as_tensor(rot), tt, torch.as_tensor(freqs))
    # of the VEL's peak over both components (a suppressed component, 1e-6
    # of the other, carries the other's rounding through the basis change)
    peak = max(np.abs(np.asarray(ref_t)).max(), np.abs(np.asarray(ref_p)).max())
    for g, r in ((got_t, ref_t), (got_p, ref_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12 * peak)
    assert np.abs(got_t.numpy()).max() + np.abs(got_p.numpy()).max() > 0


def test_wipld_export_for_ara(tmp_path):
    out = []
    for pkg, name in ((tapp, "port"), (japp, "jax")):
        (tmp_path / name).mkdir()
        _, args, _ = convert.write_antenna_pattern(tmp_path / name, "wipld")
        out.append(pkg.save_preprocessed_wipld_for_ara(*args))
    with open(out[0]) as a, open(out[1]) as b:
        assert a.read() == b.read()
    for x, y in zip(tapp.parse_ara_file(out[0]), japp.parse_ara_file(out[1])):
        np.testing.assert_array_equal(x, y)


def test_preprocessor_module_constants():
    assert (tapp._C, tapp.Z_0) == (japp._C, japp.Z_0)
    for xyz in ((0, 0, 1), (1, 0, 0), (0.3, -0.4, 0.5)):
        assert tapp.cartesian_to_spherical_np(*xyz) == japp.cartesian_to_spherical_np(*xyz)
