"""``convert``: the headline inputs built without jax, and the JAX-to-port
parameter conversion.

``make_headline_inputs`` must reproduce ``__graft_entry__.
_make_settings_and_inputs`` bit for bit (same default_rng(0) draw order),
for the test shape and for the bench's 1-channel shape; ``from_jax`` must
carry every array and every shared settings field over unchanged, the JAX
package's single-trigger fields as the one entry of ``triggers`` and an
all-zero ``min_efield_amplitude`` (no cut) as None.
"""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _make_settings_and_inputs
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim.pipeline import (ChannelParams, PipelineSettings, ShowerBatch,
                                              TriggerSettings)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(8, 2, 4, 256, 512), (64, 2, 1, 512, 2048)])
def test_make_headline_inputs_matches_graft_entry(shape):
    s, ch, b = _make_settings_and_inputs(*shape)
    ps, pc, pb = convert.make_headline_inputs(*shape, device="cpu")
    for name in ChannelParams._fields:
        ref = getattr(ch, name)
        # the headline's min_efield_amplitude is all zeros: no cut
        if ref is None or name == "min_efield_amplitude":
            assert not np.any(ref) and getattr(pc, name) is None, name
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
    # the JAX settings name no trigger list: its single-trigger defaults
    assert s.triggers == () and ps.triggers == (TriggerSettings(),)
    assert convert.settings_from_jax(s).triggers == ps.triggers


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["trigger_list", "single_trigger"])
def test_from_jax_round_trips(dtype, form):
    import nuradiomc_tpu.sim.pipeline as jpipe

    s, ch, b = _make_settings_and_inputs()
    if form == "trigger_list":
        s = dataclasses.replace(s, band_limit_eps=1e-2, triggers=(
            jpipe.TriggerSettings(name="a", threshold_high=1e-5, threshold_low=-1e-5),))
        want = TriggerSettings(name="a", threshold_high=1e-5, threshold_low=-1e-5)
    else:
        # empty triggers: the single-trigger fields make the one trigger
        s = dataclasses.replace(s, band_limit_eps=1e-2, trigger_type="simple_threshold",
                                number_of_coincidences=2, channel_coincidence=150.0)
        want = TriggerSettings(trigger_type="simple_threshold", number_of_coincidences=2,
                               channel_coincidence=150.0)
    ps, pc, pb = convert.from_jax(s, ch, b, device="cpu", dtype=dtype)
    assert ps.triggers == (want,)
    for name, ref in ch._asdict().items():
        # the JAX package's all-zero min_efield_amplitude: no cut
        if ref is None or name == "min_efield_amplitude":
            assert not np.any(ref) and getattr(pc, name) is None, name
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
    assert ps.placement_impl == "kernel"
    # a positive threshold is a cut, carried over as it is
    cut = convert.channels_from_jax(ch._replace(min_efield_amplitude=np.full(4, 1e-6)),
                                    device="cpu", dtype=dtype).min_efield_amplitude
    assert cut.dtype == dtype
    np.testing.assert_array_equal(cut.numpy(), np.full(4, 1e-6).astype(cut.numpy().dtype))
    with pytest.raises(ValueError):
        convert.from_jax(dataclasses.replace(s, stop_after="ray"), ch, b, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_jax_carries_the_reflective_emitter_table_and_arz_fields(dtype, tmp_path):
    """numpy in, tensors out: ``n_reflections``, ``attenuation_model`` and the
    reflector of the ice; ``profile_idx`` and ``emitter_polarization`` of the
    batch; ``AntennaTableParams``; ``EmitterParams``; the ARZ ``ShowerLibrary``."""
    import os

    import nuradiomc_tpu.models.ice as jice
    import nuradiomc_tpu.ops.arz as jarz
    import nuradiomc_tpu.sim.pipeline as jpipe

    s, ch, b = _make_settings_and_inputs()
    G, S = np.asarray(b.energies).shape
    rng = np.random.default_rng(2)
    table = jpipe.AntennaTableParams(
        freqs=np.linspace(0.1, 1.0, 5), thetas=np.linspace(0, np.pi, 4),
        phis=np.linspace(0, 2 * np.pi, 3),
        h_theta=rng.normal(size=(4, 5, 4, 3)) + 1j * rng.normal(size=(4, 5, 4, 3)),
        h_phi=rng.normal(size=(4, 5, 4, 3)) + 0j)
    s = dataclasses.replace(s, ice=jice.mooresbay_simple, n_reflections=2, n_windows=5,
                            attenuation_model="MB1")
    ch = ch._replace(antenna_table=table)
    b = b._replace(profile_idx=rng.integers(0, 3, (G, S)).astype(np.int32),
                   emitter_polarization=rng.uniform(0, 1, (G, S)))
    ps, pc, pb = convert.from_jax(s, ch, b, device="cpu", dtype=dtype)
    assert (ps.n_reflections, ps.n_windows, ps.attenuation_model) == (2, 5, "MB1")
    assert dataclasses.asdict(ps.ice) == dataclasses.asdict(jice.mooresbay_simple)
    assert pb.profile_idx.dtype == torch.int64 and pb.emitter_polarization.dtype == dtype
    np.testing.assert_array_equal(pb.profile_idx.numpy(), np.asarray(b.profile_idx))
    ctype = convert._ctype(dtype)
    for name, ref in table._asdict().items():
        port = getattr(pc.antenna_table, name)
        assert port.dtype == (ctype if name.startswith("h_") else dtype)
        np.testing.assert_array_equal(port.numpy(), ref.astype(port.numpy().dtype))
    em = jpipe.EmitterParams(model="hvsp1", templates=np.ones((3, 9), dtype=complex),
                             rot=np.eye(3), kind=1, half_width=2.5,
                             unit_spec=np.arange(9) * (1 + 1j),
                             spice_angles=np.array([0.1, 0.4]),
                             spice_specs=np.ones((2, 2, 9), dtype=complex))
    pe = convert.emitter_from_jax(em, device="cpu", dtype=dtype)
    assert (pe.model, pe.kind, pe.half_width) == ("hvsp1", 1, 2.5)
    assert pe.templates.dtype == pe.unit_spec.dtype == pe.spice_specs.dtype == ctype
    assert pe.rot.dtype == pe.spice_angles.dtype == dtype
    np.testing.assert_array_equal(pe.unit_spec.numpy(), em.unit_spec.astype(pe.unit_spec.numpy().dtype))
    assert convert.emitter_from_jax(em._replace(unit_spec=None), device="cpu").unit_spec is None
    lib = jarz.load_library_pickle(os.path.join(os.path.dirname(__file__), "golden",
                                                "arz_minilib.pkl"))
    pl = convert.library_from_jax(lib, device="cpu", dtype=dtype)
    for name in lib._fields:
        assert getattr(pl, name).dtype == dtype
        np.testing.assert_allclose(getattr(pl, name).numpy(), np.asarray(getattr(lib, name)),
                                   rtol=1e-6 if dtype == torch.float32 else 0)
    assert np.all(np.isfinite(pl.depth.numpy()))          # metres: finite in float32
    assert convert.library_from_jax(None) is None
