"""The birefringence segment scan's routing and arithmetic, on the CPU.

* a CPU run (``propagate_pulse``, and the Gen2 step through
  ``simulate_batch``) takes the plain loop: it launches nothing and counts
  no ``birefringence.kernel_paths``;
* ``segment_scan`` on CPU tensors is ``segment_scan_plain`` bit for bit, and
  ``propagate_pulse`` is the plain scan over ``segment_parameters``;
* the kernel's arithmetic (``csrc/birefringence_scan.cu``), written out on
  real tensors in its order, gives the plain loop's bits on the CPU in
  float32 and float64, skipped segments with non-finite parameters
  included; its phase product is written here as the CPU's ATen computes
  it, each product rounded, where the kernel takes the two fused
  multiply-adds that ATen's CUDA build makes of it;
* a skipped segment leaves the spectra as they are;
* ``segment_scan`` refuses, before any launch, inputs the kernel does not
  take (checked here on the meta device);
* the gen2 fixture's receivers (``convert.GEN2_DEEP_STATIONS`` and
  ``GEN2_DEEP_DEPTHS``) are the gen2 configuration's detector.

The kernel itself runs only on the card: ``tests/test_torch_gpu.py`` holds it
to the plain loop there.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.ops import birefringence
from nuradiomc_tpu_torch.sim import pipeline
from nuradiomc_tpu_torch.utils import timing

CTYPE = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _gen2_paths(dtype):
    return convert.gen2_birefringence_paths(32, n_points=64, device="cpu", dtype=dtype)


def _spectra(P, F, dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.complex(torch.randn(P, F, dtype=dtype, generator=g),
                          torch.randn(P, F, dtype=dtype, generator=g)) for _ in range(2)]


def _scan_args(dtype, P=6, S=40, F=33, seed=4):
    """Spectra and per-segment parameters with every kind of skipped segment:
    ok False with finite, NaN and infinite parameters."""
    g = torch.Generator().manual_seed(seed)
    st, sp = _spectra(P, F, dtype, seed)
    ang = torch.rand(P, S, dtype=dtype, generator=g) * 6.0
    k1 = 1 - torch.rand(P, S, dtype=dtype, generator=g) * 1e-3
    k2 = 1 - torch.rand(P, S, dtype=dtype, generator=g) * 1e-3
    dt = torch.rand(P, S, dtype=dtype, generator=g) * 0.05
    cpsi, spsi = torch.cos(ang), torch.sin(ang)
    ok = torch.rand(P, S, generator=g) > 0.2
    cpsi[~ok] = float("nan")
    dt[:, 3] = float("inf")
    ok[:, 3] = False
    ff = torch.as_tensor(np.fft.rfftfreq(2 * (F - 1), 0.5), dtype=dtype)
    return st, sp, cpsi, spsi, k1, k2, dt, ok, ff


def test_cpu_run_launches_nothing():
    paths = _gen2_paths(torch.float64)
    st, sp = _spectra(paths.shape[0], 65, torch.float64)
    ff = torch.as_tensor(np.fft.rfftfreq(128, 0.5))
    s, chps, batch = convert.make_gen2_inputs(16, device="cpu", dtype=torch.float32)
    birefringence.launches = 0
    timing.enable(False)
    timing.take()
    timing.enable()
    try:
        birefringence.propagate_pulse(st, sp, paths, ff, ice_models.southpole_2015)
        pipeline.simulate_batch(batch, chps[0], s)
        counters = timing.take()["counters"]
    finally:
        timing.enable(False)
        timing.take()
    assert birefringence.launches == 0
    assert sum(c.get("birefringence.paths", 0) for c in counters.values()) > 0
    assert sum(c.get("birefringence.kernel_paths", 0) for c in counters.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_scan_is_the_plain_loop(dtype):
    args = _scan_args(dtype)
    got = birefringence.segment_scan(*args)
    want = birefringence.segment_scan_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    paths = _gen2_paths(dtype)
    st, sp, *params, ff = convert.make_birefringence_scan_inputs(paths, n_freq=65)
    got = birefringence.propagate_pulse(st, sp, paths, ff, ice_models.southpole_2015)
    assert params[-1].dtype == torch.bool and all(p.is_contiguous() for p in params)
    assert all(p.shape == (paths.shape[0], paths.shape[1] - 1) for p in params)
    assert bool(params[-1].all()), "a valid path's segments are all taken"
    want = birefringence.segment_scan_plain(st, sp, *params, ff)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == CTYPE[dtype]


def _kernel_written_out(st, sp, cpsi, spsi, k1sq, k2sq, dt_rel, ok, ff):
    """``csrc/birefringence_scan.cu``'s segment step on real tensors, in its
    order: w = (-2 pi) dt rounded to the dtype, arg = w f, each real factor
    on the real and imaginary parts alone, the phase product as c10's
    complex product (unfused, as on the CPU); a skipped segment leaves the
    state."""
    s_r, s_i, p_r, p_i = st.real, st.imag, sp.real, sp.imag
    w = torch.tensor(-2.0 * math.pi, dtype=dt_rel.dtype) * dt_rel
    for k in range(cpsi.shape[-1]):
        c, s, k1, k2 = (t[:, k, None] for t in (cpsi, spsi, k1sq, k2sq))
        arg = w[:, k, None] * ff
        pc, ps = torch.cos(arg), torch.sin(arg)
        b0_r, b0_i = k1 * (c * s_r + s * p_r), k1 * (c * s_i + s * p_i)
        d_r, d_i = k2 * ((-s) * s_r + c * p_r), k2 * ((-s) * s_i + c * p_i)
        b1_r, b1_i = d_r * pc - d_i * ps, d_r * ps + d_i * pc
        new = (c * b0_r - s * b1_r, c * b0_i - s * b1_i, s * b0_r + c * b1_r,
               s * b0_i + c * b1_i)
        v = ok[:, k, None]
        s_r, s_i, p_r, p_i = (torch.where(v, a, b) for a, b in zip(new, (s_r, s_i, p_r, p_i)))
    return torch.complex(s_r, s_i), torch.complex(p_r, p_i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_arithmetic_written_out_gives_the_plain_bits(dtype):
    args = _scan_args(dtype, P=8, S=64, F=129)
    got = _kernel_written_out(*args)
    want = birefringence.segment_scan_plain(*args)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_skipped_segments_leave_the_spectra():
    st, sp, cpsi, spsi, k1, k2, dt, ok, ff = _scan_args(torch.float64)
    out = birefringence.segment_scan_plain(st, sp, cpsi, spsi, k1, k2, dt,
                                           torch.zeros_like(ok), ff)
    assert torch.equal(out[0], st) and torch.equal(out[1], sp)
    # the first segment alone: its rotation, damping and phase
    rows = torch.tensor([True, False, True, False, True, True])
    cpsi[~rows, 0] = float("nan")
    one = torch.zeros_like(ok)
    one[:, 0] = rows
    out = birefringence.segment_scan_plain(st, sp, cpsi, spsi, k1, k2, dt, one, ff)
    c, s = cpsi[rows, :1], spsi[rows, :1]
    a, b = st[rows], sp[rows]
    fast = k1[rows, :1] * (c * a + s * b)
    slow = k2[rows, :1] * (-s * a + c * b) * torch.exp(-2j * math.pi * dt[rows, :1] * ff)
    torch.testing.assert_close(out[0][rows], c * fast - s * slow, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out[1][rows], s * fast + c * slow, rtol=1e-12, atol=1e-12)
    assert torch.equal(out[0][~rows], st[~rows]) and torch.equal(out[1][~rows], sp[~rows])


def _meta(args):
    return [t.to("meta") for t in args]


def _mixed(args):
    args = _meta(args)
    args[4] = args[4].float()
    return args


def _non_contiguous(args):
    args = _meta(args)
    args[0] = args[0].t().contiguous().t()
    return args


def _shapes(args):
    args = _meta(args)
    args[6] = args[6][:, :-1].contiguous()
    return args


def _freq_shape(args):
    args = _meta(args)
    args[8] = args[8][:-1].contiguous()
    return args


def _several_devices(args):
    args = list(args)
    args[2] = args[2].to("meta")
    return args


def _half(args):
    args = _meta(args)
    return args[:2] + [t.half() if t.is_floating_point() else t for t in args[2:]]


@pytest.mark.parametrize("make, error, match", [
    (_meta, ValueError, "unsupported device"),
    (_mixed, ValueError, "mixed dtypes"),
    (_non_contiguous, ValueError, "contiguous"),
    (_shapes, ValueError, "shapes"),
    (_freq_shape, ValueError, "shapes"),
    (_several_devices, ValueError, "several devices"),
    (_half, TypeError, "float32/float64"),
])
def test_segment_scan_refuses_what_the_kernel_does_not_take(make, error, match):
    args = make(_scan_args(torch.float64))
    before = birefringence.launches
    with pytest.raises(error, match=match):
        birefringence.segment_scan(*args)
    assert birefringence.launches == before


def test_gen2_fixture_receivers_are_the_configurations():
    config = Path(__file__).resolve().parents[1] / "portbench/configs/gen2_birefringence.json"
    det = json.loads(config.read_text())["detector"]
    stations = sorted(det["stations"].values(), key=lambda st: int(st["station_id"]))
    assert tuple((st["pos_easting"], st["pos_northing"]) for st in stations) \
        == convert.GEN2_DEEP_STATIONS
    for st in stations:
        chans = [ch for ch in det["channels"].values() if ch["station_id"] == st["station_id"]]
        assert all(ch["ant_position_x"] == ch["ant_position_y"] == 0.0 for ch in chans)
        assert tuple(sorted((ch["ant_position_z"] for ch in chans), reverse=True)) \
            == convert.GEN2_DEEP_DEPTHS
