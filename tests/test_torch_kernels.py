"""The plain versions of the port's two kernels held to the JAX Pallas
kernels they replace, on the CPU (Pallas in interpret mode, as
tests/test_trigger_pallas.py runs it).

* placement chain vs ``placement_pallas.chain_placement_reduce_v3``:
  float32, max |port - jax| <= 1e-4 of each output row's peak (the two
  evaluate the phase ramp with different factorizations, 32 vs 128 lanes,
  and sum in different orders); rows whose masked inputs carry NaN spectra
  must stay finite.
* fused trigger vs ``trigger_pallas.fused_irfft_trigger``: decisions and
  first bins exact, max amplitude rtol 1e-5 (float32 sums of 2*K terms).

Both wrappers take the plain path here because the tensors lie on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import placement_pallas, trigger_pallas
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu_torch.ops import placement, trigger_fused
from nuradiomc_tpu_torch.ops.antenna import build_analytic_template

torch.set_num_threads(1)


def _placement_case(seed=7, G_out=16, s2=4, n_int=128, n_base=512, K_int=48, K_place=200):
    rng = np.random.default_rng(seed)
    R = G_out * s2
    ff = np.fft.rfftfreq(n_int, 0.5)
    sparse = jpipe._attenuation_freq_grid(tuple(ff), 8, 0.5)
    W = jpipe._interp_matrix(tuple(sparse), tuple(ff))[:, :K_int]
    tpl = build_analytic_template("analytic_VPol", ff)[0] * (ff >= 5e-3)
    templates = np.stack([tpl, 0.5 * tpl, 2.0 * tpl])[:, :K_int].astype(np.complex64)
    D_r, D_i = jpipe._placement_matrices(n_int, n_base)
    mask = rng.uniform(size=R) < 0.6
    mask[:s2] = False                       # one output row fully masked
    spec_re = rng.normal(size=(R, K_int))
    spec_im = rng.normal(size=(R, K_int))
    spec_re[~mask] = np.nan
    spec_im[~mask] = np.nan
    f32 = np.float32
    return dict(
        spec_re=spec_re.astype(f32), spec_im=spec_im.astype(f32),
        att_sparse=rng.uniform(0.5, 1.0, (R, len(sparse))).astype(f32),
        comb_re=rng.normal(size=R).astype(f32), comb_im=rng.normal(size=R).astype(f32),
        mask=mask, tpl_idx=rng.integers(0, 3, R).astype(np.int32),
        offsets=rng.uniform(0, (n_base - n_int) * 0.5, R).astype(f32),
        W=W.astype(f32), templates=templates,
        D_r=D_r[:K_int, :K_place].astype(np.complex64),
        D_i=D_i[:K_int, :K_place].astype(np.complex64),
    ), dict(s2=s2, df=2.0 / n_base, n_int=n_int, n_base=n_base, K_place=K_place)


def test_placement_plain_matches_pallas_v3():
    a, kw = _placement_case()
    ref_re, ref_im = placement_pallas.chain_placement_reduce_v3(
        jnp.asarray(a["spec_re"]), jnp.asarray(a["spec_im"]), jnp.asarray(a["att_sparse"]),
        jnp.asarray(a["comb_re"]), jnp.asarray(a["comb_im"]),
        jnp.asarray(a["mask"].astype(np.float32)), jnp.asarray(a["tpl_idx"]),
        jnp.asarray(a["offsets"]), a["W"], jnp.asarray(a["templates"]),
        jnp.asarray(a["D_r"]), jnp.asarray(a["D_i"]), s2=kw["s2"], df=kw["df"],
        n_templates=3, phase_mode="input")
    K_place = a["D_r"].shape[1]
    ref = np.asarray(ref_re)[:, :K_place] + 1j * np.asarray(ref_im)[:, :K_place]
    out_re, out_im = placement.chain_placement_reduce(
        *[torch.as_tensor(v) for k, v in a.items() if k not in ("D_r", "D_i")], **kw)
    port = out_re.numpy() + 1j * out_im.numpy()
    assert np.isfinite(port).all()
    assert np.all(port[0] == 0)                 # the fully masked output row
    peak = np.abs(ref).max(axis=1)
    err = np.abs(port - ref).max(axis=1)
    assert np.all(err <= 1e-4 * np.maximum(peak, 1e-30)), (err / peak).max()


def test_wrappers_refuse_devices_without_a_kernel():
    a, kw = _placement_case()
    meta = [torch.as_tensor(v).to("meta") for k, v in a.items() if k not in ("D_r", "D_i")]
    with pytest.raises(ValueError, match="unsupported device"):
        placement.chain_placement_reduce(*meta, **kw)
    spec = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trigger_fused.fused_irfft_trigger(spec, spec, spec, spec, n_base=16, scale=1.0,
                                          triggers=(), C=1)


def _trigger_case(seed=8, G=16, C=2, n_base=512, K=200):
    rng = np.random.default_rng(seed)
    I_r, I_i = jpipe._irfft_matrices(n_base)
    spec_re = rng.normal(size=(G * C, K)).astype(np.float32)
    spec_im = rng.normal(size=(G * C, K)).astype(np.float32)
    v = (spec_re @ I_r[:K] + spec_im @ I_i[:K]) * (2.0 / np.sqrt(2.0))
    sigma = v.std()
    th = (sigma * rng.uniform(2.0, 3.0, (G * C, 2))).astype(np.float32)
    return (spec_re, spec_im, th, -th, I_r[:K].astype(np.float32),
            I_i[:K].astype(np.float32))


def test_trigger_plain_matches_pallas():
    spec_re, spec_im, th_hi, th_lo, I_r, I_i = _trigger_case()
    C = 2
    triggers = (("high_low", 10, 400, 1), ("simple_threshold", 1, 400, 2))
    ref = trigger_pallas.fused_irfft_trigger(
        jnp.asarray(spec_re), jnp.asarray(spec_im), jnp.asarray(th_hi), jnp.asarray(th_lo),
        I_r, I_i, scale=2.0 / np.sqrt(2.0),
        triggers=tuple(trigger_pallas.TriggerSpecStatic(*t) for t in triggers), C=C)
    port = trigger_fused.fused_irfft_trigger(
        *[torch.as_tensor(x) for x in (spec_re, spec_im, th_hi, th_lo)], n_base=I_r.shape[1],
        scale=2.0 / np.sqrt(2.0),
        triggers=tuple(trigger_fused.TriggerSpecStatic(*t) for t in triggers), C=C)
    fired, first, amp = (np.asarray(x) for x in ref)
    assert 0 < fired.sum() < fired.size             # both outcomes occur
    np.testing.assert_array_equal(port[0].numpy(), fired)
    np.testing.assert_array_equal(port[1].numpy(), first)
    np.testing.assert_allclose(port[2].numpy(), amp, rtol=1e-5)


def test_trigger_spec_fields_match_pallas():
    assert ([f.name for f in dataclasses.fields(trigger_fused.TriggerSpecStatic)]
            == [f.name for f in dataclasses.fields(trigger_pallas.TriggerSpecStatic)])


def test_trigger_plain_with_inf_columns_matches_jax_eval_trigger_on_subsets():
    """A per-trigger channel subset as the port passes it (threshold +inf on
    the channels outside the subset) against the JAX package's
    ``_eval_trigger``, which slices the subset's traces: 8 columns that
    alternate kinds and subsets, float64, decisions and first bins exact."""
    import types

    rng = np.random.default_rng(9)
    G, C, n_base, K, dt = 24, 4, 512, 200, 0.5
    scale = 2.0 / np.sqrt(2.0)
    I_r, I_i = jpipe._irfft_matrices(n_base)
    spec_re, spec_im = rng.normal(size=(2, G * C, K))
    traces = ((spec_re @ I_r[:K] + spec_im @ I_i[:K]) * scale).reshape(G, C, n_base)
    sigma = traces.std()
    subsets = [(), (0, 1), (2,), (1, 3), (), (0, 2, 3), (3,), (0, 1)]
    settings, specs, th_hi, th_lo = [], [], [], []
    for i, sub in enumerate(subsets):
        kind = "high_low" if i % 2 == 0 else "simple_threshold"
        hi = float(sigma * (2.0 + 0.15 * i))
        n_coinc = min(1 + i % 2, len(sub) or C)
        settings.append(jpipe.TriggerSettings(
            name=f"t{i}", trigger_type=kind, channels=sub, threshold_high=hi,
            threshold_low=-hi, highlow_coincidence=5.0, channel_coincidence=60.0 + 10 * i,
            number_of_coincidences=n_coinc))
        specs.append(trigger_fused.TriggerSpecStatic(
            kind, 10 if kind == "high_low" else 1, int(round((60.0 + 10 * i) / dt)), n_coinc))
        col = np.full(C, hi)
        if sub:
            col[np.setdiff1d(np.arange(C), sub)] = np.inf
        th_hi.append(np.tile(col, G))
        th_lo.append(np.full(G * C, -hi))
    fired, first, amp = trigger_fused.fused_irfft_trigger_plain(
        torch.as_tensor(spec_re), torch.as_tensor(spec_im),
        torch.as_tensor(np.stack(th_hi, axis=-1)), torch.as_tensor(np.stack(th_lo, axis=-1)),
        n_base=n_base, scale=scale, triggers=tuple(specs), C=C)
    np.testing.assert_allclose(amp.numpy(), np.abs(traces).max(axis=-1), rtol=1e-12)
    s = types.SimpleNamespace(dt=dt)
    n_fired = 0
    for i, t in enumerate(settings):
        ref_fired, ref_time = jpipe._eval_trigger(t, jnp.asarray(traces), None, 0.0, s, None,
                                                  jnp.float64)
        ref_fired = np.asarray(ref_fired)
        np.testing.assert_array_equal(fired[:, i].numpy(), ref_fired, err_msg=t.name)
        np.testing.assert_allclose(first[:, i].numpy()[ref_fired] * dt,
                                   np.asarray(ref_time)[ref_fired], rtol=0, atol=1e-12)
        n_fired += int(ref_fired.sum())
    assert 0 < n_fired < G * len(settings)
    # the subset matters: all channels would fire more often than channel 2 alone
    assert int(fired[:, 2].sum()) < int(fired[:, 0].sum())
