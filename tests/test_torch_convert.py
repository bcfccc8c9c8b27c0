"""``convert``: the headline inputs built without jax, and the JAX-to-port
parameter conversion.

``make_headline_inputs`` must reproduce ``__graft_entry__.
_make_settings_and_inputs`` bit for bit (same default_rng(0) draw order),
for the test shape and for the bench's 1-channel shape; ``from_jax`` must
carry every array and every shared settings field over unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _make_settings_and_inputs
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim.pipeline import ChannelParams, PipelineSettings, ShowerBatch

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(8, 2, 4, 256, 512), (64, 2, 1, 512, 2048)])
def test_make_headline_inputs_matches_graft_entry(shape):
    s, ch, b = _make_settings_and_inputs(*shape)
    ps, pc, pb = convert.make_headline_inputs(*shape, device="cpu")
    for name in ChannelParams._fields:
        ref = getattr(ch, name)
        if ref is None:
            assert getattr(pc, name) is None
            continue
        port = getattr(pc, name).numpy()
        assert port.dtype == (np.int64 if name == "kind" else np.asarray(ref).dtype)
        np.testing.assert_array_equal(port, np.asarray(ref), err_msg=name)
    for name in ShowerBatch._fields:
        ref = getattr(b, name)
        if ref is None:
            assert getattr(pb, name) is None
            continue
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(ref),
                                      err_msg=name)
    for f in dataclasses.fields(PipelineSettings):
        if f.name in ("ice", "triggers", "placement_impl", "trigger_impl"):
            continue
        assert getattr(ps, f.name) == getattr(s, f.name), f.name
    assert dataclasses.asdict(ps.ice) == dataclasses.asdict(s.ice)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_jax_round_trips(dtype):
    import nuradiomc_tpu.sim.pipeline as jpipe

    s, ch, b = _make_settings_and_inputs()
    s = dataclasses.replace(s, band_limit_eps=1e-2, triggers=(
        jpipe.TriggerSettings(name="a", threshold_high=1e-5, threshold_low=-1e-5),))
    ps, pc, pb = convert.from_jax(s, ch, b, device="cpu", dtype=dtype)
    for name, ref in ch._asdict().items():
        if ref is None:
            assert getattr(pc, name) is None
            continue
        port = getattr(pc, name)
        assert port.dtype == {True: convert._ctype(dtype), False: dtype}[
            np.iscomplexobj(ref)] or name == "kind"
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(port.numpy().dtype))
    for name, ref in b._asdict().items():
        if ref is not None:
            np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                          np.asarray(ref).astype(getattr(pb, name).numpy().dtype))
    assert ps.band_limit_eps == 1e-2 and ps.n_bisect == s.n_bisect
    assert ps.triggers[0].name == "a" and ps.triggers[0].threshold_high == 1e-5
    assert ps.placement_impl == "kernel"
    with pytest.raises(ValueError):
        convert.from_jax(dataclasses.replace(s, stop_after="ray"), ch, b, device="cpu")
