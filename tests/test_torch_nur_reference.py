"""The port's reader and writer of NuRadioReco's own ``.nur`` files against
the JAX package's (``sim/io_nur_reference.py``).

* The three NuRadioReco-written files in tests/golden read the same through
  ``io_nur.EventReader`` of both packages: event ids, every trace bit-equal,
  parameter dicts equal, trigger objects (their attribute dicts) equal.
* A file the port's ``eventWriter`` writes is read by the JAX package's
  reader into the same events, a file the JAX package writes by the port's,
  and each package reads its own file back unchanged.
* The header enums map by the reference's numbering, and the restricted
  unpickler refuses arbitrary classes, as in the JAX package.
"""

import os
import pickle

import numpy as np
import pytest

from nuradiomc_tpu.sim import io_nur as jnur
from nuradiomc_tpu.sim import io_nur_reference as jrio
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco.examples import assert_same_tree, event_tree
from nuradiomc_tpu_torch.sim import io_nur as tnur
from nuradiomc_tpu_torch.sim import io_nur_reference as trio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FILES = {"e2e_reference_waveforms.nur": 7, "reference_events.nur": 3,
         "trigger_test_input.nur": 10}


def _trees(nur, path):
    return [event_tree(e) for e in nur.EventReader(path).run()]


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_files_read_the_same(name):
    path = os.path.join(GOLDEN, name)
    got, ref = _trees(tnur, path), _trees(jnur, path)
    assert len(got) == FILES[name]
    assert_same_tree(got, ref)
    assert all(t["stations"] for t in got)
    io = trio.NuRadioRecoio(path)
    assert io.get_event_ids() == jrio.NuRadioRecoio(path).get_event_ids()
    assert io.get_n_events() == FILES[name]


@pytest.mark.parametrize("name", sorted(FILES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_written_files_cross_read(name, writer, tmp_path):
    """One package writes the events it read; both read the file back."""
    src = os.path.join(GOLDEN, name)
    out = str(tmp_path / "out.nur")
    wpkg, rio = (tnur, trio) if writer == "port" else (jnur, jrio)
    w = rio.eventWriter()
    w.begin(out)
    for evt in wpkg.EventReader(src).run():
        w.run(evt)
    assert w.end() == FILES[name]
    ref = _trees(jnur, src)
    assert_same_tree(_trees(tnur, out), ref)
    assert_same_tree(_trees(jnur, out), ref)


def test_header_enums_and_unpickler():
    io = trio.NuRadioRecoio(os.path.join(GOLDEN, "reference_events.nur"))
    header = io.get_header()[0]
    keys = [k for st in header["stations"].values() for k in st if not isinstance(k, str)]
    assert tpar.stationParameters.station_time in keys
    assert trio.map_param_name("stationParameters", "zenith") is tpar.stationParameters.zenith
    assert isinstance(trio.map_param_name("stationParameters", "no_such"), trio.RefParameter)
    payload = pickle.dumps(os.system)
    with pytest.raises(pickle.UnpicklingError):
        trio._loads(payload)
    arr = np.arange(12.0).reshape(3, 4)
    import struct
    packed = (b"<f" + bytes([8, 2]) + struct.pack("<2I", 3, 4) + arr.tobytes())
    np.testing.assert_array_equal(trio._unpack_fastnumpyio(packed),
                                  jrio._unpack_fastnumpyio(packed))
