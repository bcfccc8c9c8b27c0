"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device (marker ``gpu``); skips elsewhere. The card's Python has
no jax, which tests/conftest.py imports, so run this file there without the
conftest:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances as in chip_smoke.py: placement (kernels 1 and 4) within 1e-4
(float32) / 1e-10 (float64) of each output row's peak; trigger decisions and first bins
exact, amplitudes rtol 1e-5 / 1e-12. The phased-array kernel's FFTs round
its ADC inputs differently from the plain version's dense products (a sample
within rounding of a count boundary may take the other count) and it sums
its power windows directly where the plain version takes a cumsum
difference, so its decisions are held on groups whose best beam power lies
more than 1e-4 from the threshold, its first frames where both fire,
amplitudes as above. The ray solver (``csrc/ray_solver.cu``) gives the plain
version's every field bit for bit (NaN where it gives NaN). The Earth's
chord integral (``csrc/earth_slant.cu``) gives the numpy copy's trapezoid
terms bit for bit and sums them in another order: slant depths within 1e-13
relative, the weights within 1e-11 (a weight's relative error is the slant's
times slant / L_int, at most ~100 here), bit-identical across launches. The
birefringence segment scan (``csrc/birefringence_scan.cu``) gives the plain
loop's bits in float32 and float64: it writes the loop's operations in their
order, with the complex product fused as ATen's CUDA build fuses it; a
difference is reported against the limits 1e-5 (float32) / 1e-14 (float64)
of each path's largest amplitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.convert import make_headline_inputs
from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.ops import (birefringence, fft_plan, noise, pa_trigger, phased_array,
                                     placement, raytrace, trigger_fused)
from nuradiomc_tpu_torch.sim import pipeline

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 1e-4, 1e-5), (torch.float64, 1e-10, 1e-12)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _placement_args(dtype, dev, G_out=300, s2=4, n_int=512, n_base=2048, K_int=208,
                    K_place=816):
    """Kernel-1 inputs: 60% of the rows unmasked, NaN spectra in the masked
    ones (select, never multiply)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    R = G_out * s2
    ff = np.fft.rfftfreq(n_int, 0.5)
    sparse = pipeline._attenuation_freq_grid(tuple(ff), 16, 0.5)
    W = torch.as_tensor(pipeline._interp_matrix(tuple(sparse), tuple(ff))[:, :K_int],
                        dtype=dtype, device=dev)
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    templates = torch.randn(3, K_int, generator=gen, device=dev, dtype=ctype)
    mask = torch.rand(R, generator=gen, device=dev) < 0.6
    spec_re = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype)
    spec_im = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype)
    spec_re[~mask] = float("nan")
    spec_im[~mask] = float("nan")
    return [spec_re, spec_im,
            torch.rand(R, len(sparse), generator=gen, device=dev, dtype=dtype),
            torch.randn(R, generator=gen, device=dev, dtype=dtype),
            torch.randn(R, generator=gen, device=dev, dtype=dtype), mask,
            torch.randint(0, 3, (R,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand(R, generator=gen, device=dev, dtype=dtype) * (n_base - n_int) * 0.5,
            W, templates], \
        dict(s2=s2, df=2.0 / n_base, n_int=n_int, n_base=n_base, K_place=K_place)


def _close_rows(k, p, tol):
    assert torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()
    err = torch.maximum((k[0] - p[0]).abs(), (k[1] - p[1]).abs()).amax(dim=1)
    peak = torch.maximum(p[0].abs(), p[1].abs()).amax(dim=1)
    assert bool((err <= tol * peak).all())


@pytest.mark.parametrize("dtype, tol, _", DTYPES)
@pytest.mark.parametrize("s2", [1, 2, 4, 6, 12, 20, 40])
def test_placement_kernel_matches_plain(dev, dtype, tol, _, s2):
    """The headline widths (K_int 208, K_place 816) at several s2: an output
    row sums s2 input rows in order (tau secondaries: 10 showers x 2 rays
    give 20; 40 doubles it; one bottom reflection: 2 showers x 6 ray slots
    give 12)."""
    args, kw = _placement_args(dtype, dev, s2=s2)
    before = placement.launches
    k = placement.chain_placement_reduce(*args, **kw)
    assert placement.launches == before + 1
    _close_rows(k, placement.chain_placement_reduce_plain(*args, **kw), tol)


def _reduce_args(dtype, dev, G_out, s2, n_int=512, n_base=2048, K_int=257, K_place=1025):
    """Kernel-4 inputs: a voltage spectrum with 60% of the rows nonzero (the
    others zero, as masked solutions are), offsets over the headroom."""
    gen = torch.Generator(device=dev).manual_seed(9)
    R = G_out * s2
    keep = (torch.rand(R, 1, generator=gen, device=dev) < 0.6).to(dtype)
    v_re = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    v_im = torch.randn(R, K_int, generator=gen, device=dev, dtype=dtype) * keep
    offs = torch.rand(R, generator=gen, device=dev, dtype=dtype) * (n_base - n_int) * 0.5
    return (v_re, v_im, offs), dict(s2=s2, df=2.0 / n_base, n_int=n_int, n_base=n_base,
                                    K_place=K_place)


@pytest.mark.parametrize("dtype, tol, _", DTYPES)
@pytest.mark.parametrize("s2", [1, 2, 20, 40])
@pytest.mark.parametrize("phase", [True, False])
def test_placement_reduce_kernel_matches_plain(dev, dtype, tol, _, s2, phase):
    """Kernel 4 on a materialized voltage spectrum at the gen2 widths (K_int
    257, K_place 1025) and 301 output rows, s2 1 to 40; ``phase=False`` is the
    profiling variant without the phase ramp."""
    args, kw = _reduce_args(dtype, dev, 301, s2)
    kw["phase"] = phase
    before = placement.reduce_launches
    k = placement.placement_reduce(*args, **kw)
    assert placement.reduce_launches == before + 1
    assert k[0].shape == (301, 1025)
    _close_rows(k, placement.placement_reduce_plain(*args, **kw), tol)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("n_int, n_base, K_int, K_place", [
    (255, 1000, 128, 400), (250, 1000, 126, 501), (128, 512, 65, 257)])
def test_placement_reduce_kernel_odd_lengths(dev, dtype, tol, n_int, n_base, K_int, K_place):
    """Kernel 4 at an odd n_int (255 = 3 5 17, the generic prime stage), an
    even n_base of 2^3 5^3 and the full internal band, s2 20."""
    args, kw = _reduce_args(dtype, dev, 50, 20, n_int, n_base, K_int, K_place)
    _close_rows(placement.placement_reduce(*args, **kw),
                placement.placement_reduce_plain(*args, **kw), tol)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_int, n_base, K_int, K_place", [
    (512, 2048, 257, 1025), (128, 512, 65, 257), (250, 1000, 126, 501), (255, 1000, 128, 400)])
@pytest.mark.parametrize("G_out, s2", [(1, 4), (7, 20), (200, 40), (200, 1)])
def test_placement_kernel_full_band_matches_plain(dev, dtype, tol, n_int, n_base, K_int,
                                                  K_place, G_out, s2):
    """Kernel 1 at the full internal band (K_int = n_int/2 + 1, so the DC and
    Nyquist bins carry an Im that the irfft drops), even and odd lengths
    (n_base 1000 = 2^3 5^3; n_int 255 = 3 5 17 takes the generic prime
    stage), few and many output rows."""
    args, kw = _placement_args(dtype, dev, G_out=G_out, s2=s2, n_int=n_int, n_base=n_base,
                               K_int=K_int, K_place=K_place)
    k = placement.chain_placement_reduce(*args, **kw)
    assert k[0].shape == (G_out, K_place)
    _close_rows(k, placement.chain_placement_reduce_plain(*args, **kw), tol * 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_placement_kernel_headline_rows(dev, dtype):
    """Kernel 1 at the headline's 65536 output rows x s2 4."""
    args, kw = _placement_args(dtype, dev, G_out=65536, s2=4)
    k = placement.chain_placement_reduce(*args, **kw)
    _close_rows(k, placement.chain_placement_reduce_plain(*args, **kw),
                DTYPES[0][1] if dtype == torch.float32 else DTYPES[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_placement_kernel_reflective_rows(dev, dtype):
    """Kernel 1 at the reflective-bottom slice's shape: 16384 groups x 4
    channels = 65536 output rows, each the sum of s2 = 12 (shower, ray slot)
    rows, 786,432 rows in all."""
    args, kw = _placement_args(dtype, dev, G_out=65536, s2=12)
    assert args[0].shape[0] == 786432
    k = placement.chain_placement_reduce(*args, **kw)
    _close_rows(k, placement.chain_placement_reduce_plain(*args, **kw),
                DTYPES[0][1] if dtype == torch.float32 else DTYPES[1][1])


def _trigger_case(dtype, dev, G, C, n_base, K, T=2):
    """Kernel-2 inputs with T trigger columns that alternate high/low and
    threshold kinds, thresholds 2-3 sigma (rising with the column, as a
    ladder); from the third column on, every third column is a channel
    subset: the channels outside it have threshold +inf."""
    gen = torch.Generator(device=dev).manual_seed(6)
    I_r, I_i = (torch.as_tensor(m[:K], dtype=dtype, device=dev)
                for m in fft_plan._irfft_matrices(n_base))
    spec_re = torch.randn(G * C, K, generator=gen, device=dev, dtype=dtype)
    spec_im = torch.randn(G * C, K, generator=gen, device=dev, dtype=dtype)
    sigma = float(((spec_re[:4096] @ I_r + spec_im[:4096] @ I_i) * 1.414).std())
    th = sigma * (2.0 + torch.rand(G * C, T, generator=gen, device=dev, dtype=dtype)
                  + 0.05 * torch.arange(T, device=dev, dtype=dtype))
    trig = []
    for t in range(T):
        if t % 2 == 0:
            trig.append(trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1 + (t // 2) % 2))
        else:
            trig.append(trigger_fused.TriggerSpecStatic("simple_threshold", 1, max(400 - 30 * t, 7),
                                                        min(C, 2)))
        if t >= 2 and t % 3 == 2 and C > 2:
            outside = (torch.arange(G * C, device=dev) % C) >= (C + 1) // 2
            th[outside, t] = float("inf")
    return (spec_re, spec_im, th, -th), dict(n_base=n_base, scale=1.414,
                                             triggers=tuple(trig), C=C)


@pytest.mark.parametrize("dtype, tol, C, n_base, K, G", [
    (torch.float32, 1e-5, 1, 2048, 816, 200), (torch.float32, 1e-5, 4, 2048, 816, 200),
    (torch.float32, 1e-5, 20, 2048, 816, 200), (torch.float32, 1e-5, 3, 1000, 501, 200),
    (torch.float64, 1e-12, 1, 2048, 816, 200), (torch.float64, 1e-12, 4, 512, 257, 200),
    (torch.float64, 1e-12, 12, 2048, 816, 200),
    (torch.float32, 1e-5, 2, 2048, 1025, 7), (torch.float64, 1e-12, 2, 2048, 1025, 1),
    (torch.float32, 1e-5, 12, 1000, 501, 7), (torch.float64, 1e-12, 20, 512, 257, 200),
    (torch.float32, 1e-5, 1, 512, 257, 65536), (torch.float64, 1e-12, 2, 1000, 501, 65536),
    (torch.float32, 1e-5, 4, 2048, 816, 16384), (torch.float64, 1e-12, 4, 2048, 816, 16384),
    (torch.float32, 1e-5, 2, 999, 500, 200),
    (torch.float32, 1e-5, 2, 4096, 2049, 200), (torch.float64, 1e-12, 2, 4096, 2049, 200),
    (torch.float32, 1e-5, 1, 4096, 1632, 7), (torch.float32, 1e-5, 2, 2187, 1094, 200),
    (torch.float64, 1e-12, 3, 2187, 900, 200), (torch.float32, 1e-5, 2, 3000, 1501, 200),
    (torch.float64, 1e-12, 1, 3000, 1200, 7)])
def test_trigger_kernel_matches_plain(dev, dtype, tol, C, n_base, K, G):
    """The inverse FFT of kernel 2 at even and odd lengths (1000 = 2^3 5^3,
    999 = 3^3 37 through the generic prime stage), the full band (K = n/2 +
    1: Im at DC and Nyquist dropped) and a cut one, C 1 to 20, G 1 to
    65536 (16384 x C 4 is the reflective-bottom slice's). Lengths above 2048 (4096, 3000 and the odd 2187 = 3^7) walk the
    trace in more than one tile of 128 x 16 samples."""
    args, kw = _trigger_case(dtype, dev, G, C, n_base, K)
    before = trigger_fused.launches
    k = trigger_fused.fused_irfft_trigger(*args, **kw)
    assert trigger_fused.launches == before + 1
    p = trigger_fused.fused_irfft_trigger_plain(*args, **kw)
    if G > 1:
        assert int(p[0].sum()) > 0
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert bool(((k[2] - p[2]).abs() <= tol * p[2].abs()).all())


@pytest.mark.parametrize("dtype, tol, C, n_base, K, G, T", [
    (torch.float64, 1e-12, 24, 2048, 1025, 64, 8),     # the production station
    (torch.float32, 1e-5, 24, 2048, 816, 64, 8),
    (torch.float32, 1e-5, 4, 8192, 4097, 64, 8), (torch.float64, 1e-12, 4, 8192, 4097, 64, 8),
    (torch.float32, 1e-5, 4, 2048, 816, 200, 17), (torch.float64, 1e-12, 3, 2048, 816, 200, 17),
    (torch.float32, 1e-5, 3, 6561, 3000, 64, 5), (torch.float64, 1e-12, 2, 2187, 1094, 64, 8),
    (torch.float32, 1e-5, 300, 512, 257, 8, 3),        # two-byte counts
    (torch.float32, 1e-5, 4, 2048, 816, 200, 0)])      # no column: the amplitudes alone
def test_trigger_kernel_lifted_limits(dev, dtype, tol, C, n_base, K, G, T):
    """More triggers than one launch takes (T 17: sliced over launches of the
    same kernel; at n_base 8192 in float64 the counts of 8 triggers do not
    fit beside the trace either), a 24-channel station in float64, n_base
    8192, odd lengths beyond one tile, more than 255 channels, channel
    subsets (+inf thresholds): decisions and first bins equal to the plain
    version's in every group."""
    args, kw = _trigger_case(dtype, dev, G, C, n_base, K, T)
    before = trigger_fused.launches
    k = trigger_fused.fused_irfft_trigger(*args, **kw)
    n_launches = trigger_fused.launches - before
    assert n_launches >= max(1, -(-T // 16))
    p = trigger_fused.fused_irfft_trigger_plain(*args, **kw)
    assert k[0].shape == (G, T) and k[1].shape == (G, T)
    if T:
        assert int(p[0].sum()) > 0
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert bool(((k[2] - p[2]).abs() <= tol * p[2].abs()).all())


def test_trigger_kernel_refuses_oversized_groups(dev):
    """A group of any size fits (the shared memory holds one trace); what is
    refused is a trace that does not fit a block beside its FFT buffer."""
    C = 32                               # 32 x 2048 x 8 bytes of traces > 227 KB
    args, kw = _trigger_case(torch.float64, dev, 16, C, 2048, 64, 1)
    k = trigger_fused.fused_irfft_trigger(*args, **kw)
    p = trigger_fused.fused_irfft_trigger_plain(*args, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    n_base = 32768                       # 256 KB of trace in float64
    spec = torch.zeros(2, 16, dtype=torch.float64, device=dev)
    th = torch.zeros(2, 1, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="shared"):
        trigger_fused.fused_irfft_trigger(
            spec, spec, th, th, n_base=n_base, scale=1.0, C=2,
            triggers=(trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1),))


def test_wrappers_refuse_non_contiguous_and_mixed_dtypes(dev):
    args, kw = _placement_args(torch.float32, dev, G_out=8)
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        placement.chain_placement_reduce(*bad, **kw)
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(ValueError):
        placement.chain_placement_reduce(*bad, **kw)
    v = args[0][:, :16].contiguous()
    kw4 = dict(s2=kw["s2"], df=kw["df"], n_int=32, n_base=128, K_place=65)
    with pytest.raises(ValueError, match="contiguous"):
        placement.placement_reduce(v.t().contiguous().t(), v, args[7], **kw4)
    with pytest.raises(ValueError):
        placement.placement_reduce(v, v.double(), args[7], **kw4)
    with pytest.raises(ValueError, match="n_int"):
        placement.placement_reduce(v, v, args[7], **{**kw4, "n_int": 16})


def ray_pairs(n=4096, seed=24):
    """(x1y, x1z, x2y, x2z) float64 CPU tensors of ``to_2d``: the dipole
    cell's vertices (r < 4 km, -2.7 km < z < 0) against a VPol at -100 m and
    the deep phased array's four channels (r < 3 km, -2 km < z < 0); sources
    within 1 m of a ray's turning depth; pairs at the shadow boundary (the
    ray that turns at the surface, +-1e-3 relative) and tangent pairs (the
    receiver at the turning depth of the lower bracket's ray, +-1e-9); r_h =
    0, x1z == x2z, surface vertices and repeated rows (the padded slots of a
    group copy its last shower)."""
    rng = np.random.default_rng(seed)
    ice = ice_models.southpole_2015

    def cyl(m, r_max, z_min):
        r, phi = r_max * np.sqrt(rng.uniform(0, 1, m)), rng.uniform(0, 2 * np.pi, m)
        return np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(z_min, 0.0, m)], -1)

    def rx(m, z):
        return np.stack([np.zeros(m), np.zeros(m), np.full(m, z)], -1)

    x1 = [cyl(n, 4000.0, -2700.0)] + [cyl(n // 4, 3000.0, -2000.0) for _ in range(4)]
    x2 = [rx(n, -100.0)] + [rx(n // 4, -197.0 - k) for k in range(4)]
    # near the turning depths of the refracted rays of the first set
    g = raytrace.to_2d(torch.as_tensor(x1[0]), torch.as_tensor(x2[0]))
    sols = raytrace.find_solutions_plain(g.x1y, g.x1z, g.x2y, g.x2z, ice)
    turn = sols.mask & (sols.sol_type == raytrace.SOL_REFRACTED)
    z_t = raytrace.turning_depth(sols.c0[turn], ice).numpy()
    r_h = (g.x2y - g.x1y)[:, None].expand_as(turn)[turn].numpy()
    m = z_t.size
    x1.append(np.stack([r_h, np.zeros(m), z_t + rng.uniform(-1.0, 1.0, m)], -1))
    x2.append(rx(m, -100.0))

    # the shadow boundary (the ray that turns at the surface) and tangent
    # rays (turning at the receiver: the lower bracket), from the closed form
    z1 = torch.as_tensor(rng.uniform(-2700.0, -150.0, n // 4))
    z2 = torch.full_like(z1, -100.0)
    c0_surf = torch.full_like(z1, 1.0 / (ice.n_ice - ice.delta_n))
    w1, w2, w0 = (raytrace._w_up(z, c0_surf, ice) for z in (z1, z2, torch.zeros_like(z1)))
    y_b = (2 * w0 - w1 - w2).numpy() * (1 + rng.uniform(-1e-3, 1e-3, z1.numel()))
    z2t = torch.as_tensor(rng.uniform(-600.0, -20.0, n // 4))
    z1t = z2t - torch.as_tensor(rng.uniform(1.0, 2000.0, n // 4))
    c0_t = raytrace._c0_from_log(raytrace._logc0_min(z2t, ice), ice.n_ice)
    y_t = (raytrace._w_up(z2t, c0_t, ice) - raytrace._w_up(z1t, c0_t, ice)).numpy()
    y_t = y_t * (1 + rng.uniform(-1e-9, 1e-9, y_t.size))
    for y, za, zb in ((y_b, z1.numpy(), z2.numpy()), (y_t, z1t.numpy(), z2t.numpy())):
        x1.append(np.stack([np.zeros_like(y), np.zeros_like(y), za], -1))
        x2.append(np.stack([y, np.zeros_like(y), zb], -1))
    # r_h = 0, x1z == x2z, surface vertices, repeated rows
    k = 64
    flat = cyl(k, 3000.0, -1.0)
    x1 += [rx(k, 0.0) + [0, 0, 1] * cyl(k, 1.0, -2700.0), flat * [1, 1, 0] + [0, 0, -100.0],
           flat * [1, 1, 0], np.repeat(x1[0][:k], 3, axis=0)]
    x2 += [rx(k, -100.0), rx(k, -100.0), rx(k, -100.0), rx(3 * k, -100.0)]
    g = raytrace.to_2d(torch.as_tensor(np.concatenate(x1)), torch.as_tensor(np.concatenate(x2)))
    return g.x1y, g.x1z, g.x2y, g.x2z


def _bit_equal(a, b):
    """Elementwise: the same value, NaN counted equal to NaN (the kernel and
    the plain version give NaN in the same invalid slots)."""
    same = a == b
    return same | (a.isnan() & b.isnan()) if a.is_floating_point() else same


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_bisect", [28, 96])
def test_ray_solver_kernel_matches_plain(dev, dtype, n_bisect):
    """Every field of every slot equal to the plain version's bit for bit:
    the kernel is built without FMA contraction and writes each operation as
    ATen computes it on the card. A field that drifts is reported with its
    worst relative difference over valid slots."""
    ice = ice_models.southpole_2015
    xs = [t.to(dev, dtype) for t in ray_pairs()]
    before = raytrace.launches
    k = raytrace.find_solutions(*xs, ice, n_bisect)
    assert raytrace.launches == before + 1
    p = raytrace.find_solutions_plain(*xs, ice, n_bisect)
    direct = p.mask & (p.sol_type == raytrace.SOL_DIRECT)
    turning = p.mask & ~direct
    assert int(direct.sum()) > 1000 and int(turning.sum()) > 1000
    for name in p._fields:
        a, b = getattr(k, name), getattr(p, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        same = _bit_equal(a, b)
        if bool(same.all()):
            continue
        msg = f"{name}: {int((~same).sum())} of {same.numel()} slots differ"
        if a.is_floating_point():
            rel = ((a - b).abs() / b.abs().clamp_min(torch.finfo(dtype).tiny))[p.mask]
            msg += f" (valid slots: worst relative difference {float(rel.max()):.3e})"
        raise AssertionError(msg)


def test_ray_solver_broadcasts_and_refuses(dev):
    """Broadcast inputs give the broadcast shape; no pair, no launch; mixed
    dtypes, mixed devices and integer inputs are refused."""
    ice = ice_models.southpole_2015
    x1y, x1z, x2y, x2z = (t[:6].to(dev) for t in ray_pairs(256))
    k = raytrace.find_solutions(x1y[:, None], x1z[:, None], x2y[None, :], x2z[0], ice)
    p = raytrace.find_solutions_plain(x1y[:, None], x1z[:, None], x2y[None, :], x2z[0], ice)
    assert k.c0.shape == p.c0.shape == (6, 6, 2)
    assert torch.equal(k.mask, p.mask)
    before = raytrace.launches
    empty = raytrace.find_solutions(*(x[:0] for x in (x1y, x1z, x2y, x2z)), ice)
    assert empty.c0.shape == (0, 2) and raytrace.launches == before
    with pytest.raises(ValueError, match="dtype"):
        raytrace.find_solutions(x1y, x1z.float(), x2y, x2z, ice)
    with pytest.raises(ValueError, match="devices"):
        raytrace.find_solutions(x1y, x1z.cpu(), x2y, x2z, ice)
    with pytest.raises(TypeError, match="float32/float64"):
        raytrace.find_solutions(*(x.long() for x in (x1y, x1z, x2y, x2z)), ice)


def earth_chords(earth, n=2048, seed=26):
    """(theta, phi, vertex, flavor) of n chords drawn like the deep
    phased-array cell's list (vertices at r < 3 km, -2 km < z < 0, isotropic
    directions), then the edges from a vertex at 1.5 km depth: near-vertical
    down- and up-going, horizontal, grazing each inner shell boundary (just
    inside, on and just outside it), and last a vertex on the surface whose
    chord has length 0."""
    rng = np.random.default_rng(seed)
    r = 3e3 * np.sqrt(rng.uniform(0, 1, n))
    az = rng.uniform(0, 2 * np.pi, n)
    vertex = np.c_[r * np.cos(az), r * np.sin(az), rng.uniform(-2e3, 0, n)]
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    r0 = earth.earth_radius - 1.5e3
    graze = [np.pi - np.arcsin(b * f / r0) for b in earth.radii[:-1]
             for f in (1 - 1e-9, 1.0, 1 + 1e-9)]
    edge = np.r_[1e-6, np.pi - 1e-6, np.pi / 2, graze]
    vertex = np.r_[vertex, np.tile([0.0, 0.0, -1.5e3], (len(edge), 1)), [[0.0, 0.0, 0.0]]]
    theta = np.r_[theta, edge, 0.2]
    phi = np.r_[phi, np.zeros(len(edge)), 1.0]
    return theta, phi, vertex, rng.choice([12, -12, 14, -14, 16, -16], len(theta))


@pytest.mark.parametrize("model, mode", [("CORE_MANTLE_CRUST", "core_mantle_crust"),
                                         ("PREM", "PREM")])
def test_earth_slant_kernel_matches_numpy(dev, model, mode):
    """The chord kernel against ``EarthModel.slant_depth`` and the weights of
    ``get_weight(..., device=card)`` against the numpy call; two launches
    bit-identical, each counting its chords and one ``weights`` read."""
    from nuradiomc_tpu_torch.ops import earth_slant
    from nuradiomc_tpu_torch.sim import earth_attenuation
    from nuradiomc_tpu_torch.utils import timing, units

    earth = getattr(earth_attenuation, model)
    theta, phi, vertex, flavors = earth_chords(earth)
    n = len(theta)
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    want = earth.slant_depth(vertex, d, n_samples=16384)
    got, counters = [], []
    before = earth_slant.launches
    timing.enable(False)
    timing.take()
    timing.enable()
    try:
        for _ in range(2):
            got.append(earth_slant.slant_depth(earth, vertex, d, n_samples=16384, device=dev))
            counters.append(timing.take()["counters"])
    finally:
        timing.enable(False)
        timing.take()
    assert earth_slant.launches == before + 2
    for c in counters:
        assert sum(j.get("weights.kernel_chords", 0) for j in c.values()) == n
        assert sum(j.get("host_syncs.weights", 0) for j in c.values()) == 1
    assert got[0].dtype == np.float64 and got[0].tobytes() == got[1].tobytes()
    zero = want == 0
    assert int(zero.sum()) == 1 and np.array_equal(got[0] == 0, zero)
    rel = np.abs(got[0] - want)[~zero] / want[~zero]
    assert rel.max() <= 1e-13, f"worst relative slant difference {rel.max():.3e}"
    energy = np.full(n, 1e18 * units.eV)
    kw = dict(mode=mode, cross_section_type="ctw", vertex_position=vertex, phi_nu=phi)
    np.testing.assert_allclose(
        earth_attenuation.get_weight(theta, energy, flavors, device=dev, **kw),
        earth_attenuation.get_weight(theta, energy, flavors, **kw), rtol=1e-11, atol=0)


def _scan_gap(k, p):
    """(worst |kernel - plain| over each path's largest plain amplitude in
    either polarization, bit-equal)."""
    amp = torch.maximum(p[0].abs().amax(-1), p[1].abs().amax(-1))[:, None]
    amp = amp.clamp_min(torch.finfo(amp.dtype).tiny)
    gap = max(float(((a - b).abs() / amp).max()) if a.numel() else 0.0 for a, b in zip(k, p))
    return gap, all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-14)])
def test_birefringence_scan_kernel_matches_plain(dev, dtype, tol):
    """The scan kernel against ``segment_scan_plain`` at the gen2 cell's
    shapes (3,072 paths from the ray solver, 256 points, F 513), one launch
    counting its paths."""
    from nuradiomc_tpu_torch.utils import timing

    args = convert.make_birefringence_scan_inputs(
        convert.gen2_birefringence_paths(3072, device=dev, dtype=dtype))
    before = birefringence.launches
    timing.enable(False)
    timing.take()
    timing.enable()
    try:
        k = birefringence.segment_scan(*args)
        counters = timing.take()["counters"]
    finally:
        timing.enable(False)
        timing.take()
    assert birefringence.launches == before + 1
    assert sum(c.get("birefringence.kernel_paths", 0) for c in counters.values()) == 3072
    p = birefringence.segment_scan_plain(*args)
    assert all(a.dtype == b.dtype and a.shape == b.shape for a, b in zip(k, p))
    gap, same = _scan_gap(k, p)
    assert same, f"{dtype}: not bit-equal; worst gap {gap:.3e} of a path's largest " \
                 f"amplitude (limit {tol:.0e})"
    assert not torch.equal(p[1], args[1]), "the scan left the spectra as they were"


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-14)])
@pytest.mark.parametrize("n_freq", [1, 100, 129, 513])
def test_birefringence_scan_kernel_edges(dev, dtype, tol, n_freq):
    """Skipped segments (zero length, NaN and infinite points, a path with
    no valid segment) leave the state as the plain loop does; F below, at
    and past the block's stride of 128."""
    path = convert.gen2_birefringence_paths(256, device=dev, dtype=dtype)
    path[:16, 11] = path[:16, 10]                 # zero-length segment 10
    path[16:32, 50, 2] = float("nan")             # segments 49 and 50
    path[32:48, 100] = float("inf")               # segments 99 and 100
    path[48] = float("nan")                       # no valid segment
    args = convert.make_birefringence_scan_inputs(path, n_freq=n_freq)
    ok = args[7]
    assert not bool(ok[:16, 10].any()) and not bool(ok[16:48].all(-1).any())
    assert not bool(ok[48].any())
    k = birefringence.segment_scan(*args)
    p = birefringence.segment_scan_plain(*args)
    gap, same = _scan_gap(k, p)
    assert same, f"not bit-equal; worst gap {gap:.3e} (limit {tol:.0e})"
    assert all(bool(torch.isfinite(a).all()) for a in k)
    assert torch.equal(k[0][48], args[0][48]) and torch.equal(k[1][48], args[1][48])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_birefringence_scan_kernel_long_paths_and_no_paths(dev, dtype):
    """2,100 segments a path (past 48 KB of shared memory in both dtypes)
    against the plain loop; P = 0 launches nothing; more segments than a
    block's shared memory holds are refused."""
    args = convert.make_birefringence_scan_inputs(
        convert.gen2_birefringence_paths(64, n_points=2101, device=dev, dtype=dtype), n_freq=65)
    before = birefringence.launches
    gap, same = _scan_gap(birefringence.segment_scan(*args),
                          birefringence.segment_scan_plain(*args))
    assert same, f"not bit-equal; worst gap {gap:.3e}"
    assert birefringence.launches == before + 1
    empty = [a[:0] for a in args[:8]] + [args[8]]
    out = birefringence.segment_scan(*empty)
    assert [tuple(o.shape) for o in out] == [(0, 65)] * 2 and birefringence.launches == before + 1
    n_max = 232448 // (6 * torch.empty((), dtype=dtype).element_size())
    big = [a[:2, :1].expand(2, n_max + 1).contiguous() for a in args[2:8]]
    with pytest.raises(ValueError, match="segments"):
        birefringence.segment_scan(args[0][:2], args[1][:2], *big, args[8])


def test_birefringence_scan_refuses(dev):
    """Non-contiguous input, mixed dtypes, mismatched shapes and inputs on
    two devices are refused on the card, before any launch."""
    args = list(convert.make_birefringence_scan_inputs(
        convert.gen2_birefringence_paths(64, n_points=32, device=dev), n_freq=33))
    before = birefringence.launches
    cases = {"contiguous": (0, args[0].t().contiguous().t()),
             "dtypes": (4, args[4].float()),
             "shapes": (6, args[6][:, :-1].contiguous()),
             "several devices": (2, args[2].cpu())}
    for match, (i, bad) in cases.items():
        with pytest.raises(ValueError, match=match):
            birefringence.segment_scan(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="shapes"):
        birefringence.segment_scan(*args[:8], args[8][:-1].contiguous())
    assert birefringence.launches == before


def test_simulate_batch_kernel_path_matches_plain_path(dev):
    s, ch, b = make_headline_inputs(512, 2, 4, 512, 2048, device=dev, dtype=torch.float32)
    s = dataclasses.replace(s, band_limit_eps=1e-2)
    out = pipeline.simulate_batch(b, ch, s)
    plain = pipeline.simulate_batch(b, ch, dataclasses.replace(
        s, placement_impl="plain", trigger_impl="plain"))
    assert torch.equal(out.triggered, plain.triggered)
    assert bool(out.triggered.any())
    torch.testing.assert_close(out.max_amplitude, plain.max_amplitude, rtol=1e-4, atol=0)


def _pa_args(dtype, dev, G, C, K=512, n_base=2048, up=2, n_bits=8, n_hi=None, decim=10):
    """Kernel-3 inputs at the bench's per-group shapes: band-limited noise
    spectra (first K bins), the decimating irfft of n_hi = 2.5 n_base to
    0.5 GHz, x``up`` upsampling, 11 beams, an ADC range of 15 noise counts per
    Vrms."""
    gen = torch.Generator(device=dev).manual_seed(8)
    spec = noise.bandlimited_noise_spectrum(gen, (G * C,), n_base, 2.0,
                                            torch.tensor(1e-5, dtype=dtype, device=dev),
                                            dtype=dtype)[:, :K]
    n_hi = n_base * 5 // 2 if n_hi is None else n_hi
    spec_re, spec_im = spec.real.contiguous(), spec.imag.contiguous()
    scale_dec = 5.0 / np.sqrt(2.0)
    Dd_r, Dd_i = fft_plan.decimate_dense(n_base, n_hi, decim, K, dtype, dev)
    vrms = float(((spec_re @ Dd_r + spec_im @ Dd_i) * scale_dec).std())
    adc_range = vrms * (2 ** n_bits - 1) / 15
    rolls = phased_array.beam_rolls([-197.0 - i for i in range(C)], [0.0] * C,
                                    phased_array.default_angles, 1.75, 0.5 * up)
    kw = dict(n_base=n_base, n_hi=n_hi, decim=decim, up=up, scale_full=2.0 / np.sqrt(2.0),
              scale_dec=scale_dec, rolls=rolls, window=16, step=8, v_min=-adc_range / 2,
              lsb=adc_range / (2 ** n_bits - 1), n_counts=2 ** n_bits, C=C)
    return (spec_re, spec_im), kw


@pytest.mark.parametrize("dtype, tol, C, K, n_base, extra", [
    (torch.float32, 1e-5, 4, 512, 2048, {}), (torch.float32, 1e-5, 20, 512, 2048, {}),
    (torch.float32, 1e-5, 4, 1025, 2048, {}), (torch.float32, 1e-5, 4, 300, 1000, {}),
    (torch.float64, 1e-12, 4, 512, 2048, {}), (torch.float64, 1e-12, 12, 512, 2048, {}),
    (torch.float64, 1e-12, 4, 1025, 2048, {}),
    (torch.float32, 1e-5, 4, 451, 900, {}),                     # n_dec 225: odd
    (torch.float32, 1e-5, 4, 512, 2048, {"decim": 7}),          # 7 does not divide 5120
    (torch.float64, 1e-12, 4, 512, 2048, {"n_hi": 5121}),       # odd n_hi, general route
    (torch.float32, 1e-5, 4, 512, 2048, {"up": 1}),
    (torch.float32, 1e-5, 4, 512, 2048, {"up": 3}),
    (torch.float32, 1e-5, 3, 451, 900, {"up": 3}),               # odd n_up 675
    (torch.float64, 1e-12, 8, 512, 2048, {}),
    (torch.float64, 1e-12, 8, 451, 900, {"decim": 7, "up": 3}),
    (torch.float64, 1e-12, 24, 512, 2048, {}),                 # a cluster of 2 blocks
    (torch.float32, 1e-5, 64, 512, 2048, {}),                  # 2 blocks
    (torch.float64, 1e-12, 64, 512, 2048, {})])                # 4 blocks
def test_pa_kernel_matches_plain(dev, dtype, tol, C, K, n_base, extra):
    """C = 20 (float32) and 12 (float64) groups; K = 1025 is the full band (no
    band limit); n_base = 1000 (n_dec 250, n_up 500); n_base 900 gives an odd
    n_dec (225); decim 7 into n_hi 5120 and the odd n_hi 5121 take the
    general route (the full inverse of n_hi read at the stride); up 1 skips
    the upsampling, up 3 with an odd n_dec gives an odd n_up. C 24 (float64)
    and 64 split each group over a thread-block cluster."""
    G = 603                       # not a multiple of the blocks
    args, kw = _pa_args(dtype, dev, G=G, C=C, K=K, n_base=n_base, **extra)
    _, _, _, max_power = pa_trigger.fused_pa_trigger_plain(*args, threshold=1.0, **kw)
    for q in (0.3, 0.8):          # most groups fire / few do
        thr = float(torch.quantile(max_power, q)) * 1.001
        before = pa_trigger.launches
        kf, kframe, kamp = pa_trigger.fused_pa_trigger(*args, threshold=thr, **kw)
        assert pa_trigger.launches == before + 1
        pf, pframe, pamp, pmax = pa_trigger.fused_pa_trigger_plain(*args, threshold=thr, **kw)
        solid = (pmax - thr).abs() / thr > 1e-4
        assert int(solid.sum()) >= G - 10
        assert torch.equal(kf[solid], pf[solid])
        both = solid & kf & pf
        assert 0 < int(both.sum()) < G
        assert torch.equal(kframe[both], pframe[both])
        assert bool((kframe[~kf] == 0).all())
        assert bool(((kamp - pamp).abs() <= tol * pamp.abs()).all())


def test_pa_kernel_adc_counts_match_plain(dev):
    """The kernel's ADC counts (the diagnostic output) against the plain
    version's, float64: equal except where a sample lies within rounding of a
    count boundary."""
    args, kw = _pa_args(torch.float64, dev, G=256, C=4)
    n_dec = pa_trigger.n_dec_of(kw["n_hi"], kw["decim"])
    counts = torch.zeros((256 * 4, n_dec), dtype=torch.int32, device=dev)
    pa_trigger.fused_pa_trigger(*args, threshold=1.0, adc_counts=counts, **kw)
    ref, _ = pa_trigger.adc_plain(*args, **{k: kw[k] for k in (
        "n_base", "n_hi", "decim", "scale_dec", "v_min", "lsb", "n_counts")})
    assert 0 < int(counts.max()) < kw["n_counts"] - 1
    assert int((counts != ref.to(torch.int32)).sum()) <= 2


def test_pa_kernel_refuses_oversized_groups(dev):
    args, kw = _pa_args(torch.float64, dev, G=2, C=4)
    kw = {**kw, "n_hi": 40960, "decim": 2, "C": 4}                 # 4 x 40960 x 8 B of traces
    with pytest.raises(ValueError, match="shared"):
        pa_trigger.fused_pa_trigger(*args, threshold=1.0, **kw)


@pytest.mark.parametrize("C, dtype, k", [
    (4, torch.float32, 1), (4, torch.float64, 1), (24, torch.float64, 2),
    (64, torch.float32, 2), (64, torch.float64, 4), (368, torch.float32, 8),
    (369, torch.float32, 0), (168, torch.float64, 8), (169, torch.float64, 0)])
def test_pa_kernel_cluster_sizes(dev, C, dtype, k):
    """The blocks a group's cluster takes at n_up 1024 and 11 beams, K 512:
    the smallest k whose ceil(C / k) upsampled traces fit a block, up to 8;
    beyond, the wrapper raises."""
    assert pa_trigger.cluster_size(C, 512, 2048, 5120, 10, 2, 11, dtype) == k
    if k == 0:
        args, kw = _pa_args(dtype, dev, G=2, C=C)
        with pytest.raises(ValueError, match="cluster of 8 blocks"):
            pa_trigger.fused_pa_trigger(*args, threshold=1.0, **kw)


def test_two_rank_gloo_mesh_on_card(dev):
    """The sharded dryrun on two gloo processes sharing the card, noise on:
    equal to the single-process run (parallel/dryrun.py raises otherwise)."""
    from nuradiomc_tpu_torch.parallel import dryrun
    out = dryrun.dryrun_multichip(2, backend="gloo", device="cuda", noise=True)
    assert out["shape"] == {"event": 1, "channel": 2} and out["n_triggered"] > 0


def test_simulate_batch_pa_kernel_path_matches_plain_path(dev):
    from nuradiomc_tpu_torch.convert import make_pa_inputs
    s, ch, b = make_pa_inputs(512, device=dev, dtype=torch.float32)
    s = dataclasses.replace(s, add_noise=False)
    out = pipeline.simulate_batch(b, ch, s)
    plain = pipeline.simulate_batch(b, ch, dataclasses.replace(s, trigger_impl="plain"))
    assert int((out.triggered != plain.triggered).sum()) <= 1
    assert bool(plain.triggered.any())
    torch.testing.assert_close(out.max_amplitude, plain.max_amplitude, rtol=1e-4, atol=0)


def test_simulate_batch_mixed_trigger_list_matches_plain_path(dev):
    """A ladder of high/low triggers, a threshold on a channel subset and the
    phased array in one list: kernel 2 once for the ten columns but one,
    kernel 3 once, every column equal to the plain path's."""
    from nuradiomc_tpu_torch.convert import make_multitrigger_inputs
    s, ch, b = make_multitrigger_inputs(512, device=dev, dtype=torch.float32)
    s = dataclasses.replace(s, add_noise=False)
    trigger_fused.launches = pa_trigger.launches = 0
    out = pipeline.simulate_batch(b, ch, s)
    assert (trigger_fused.launches, pa_trigger.launches) == (1, 1)
    plain = pipeline.simulate_batch(b, ch, dataclasses.replace(s, trigger_impl="plain"))
    assert out.triggered_per.shape == (512, 10)
    assert int((out.triggered_per != plain.triggered_per).sum()) <= 1
    assert bool(plain.triggered_per.any(dim=0).all())
    torch.testing.assert_close(out.max_amplitude, plain.max_amplitude, rtol=1e-4, atol=0)
    windows = dataclasses.replace(s, n_windows=2)
    out2 = pipeline.simulate_batch(b, ch, windows)
    plain2 = pipeline.simulate_batch(b, ch, dataclasses.replace(windows, trigger_impl="plain"))
    assert int((out2.triggered_per != plain2.triggered_per).sum()) <= 1


def test_pa_simulation_float64_on_card(dev):
    """The noisy phased-array golden's rules (tests/test_e2e_phased_array.py)
    through ``Simulation`` on the card from the .npz input, float64, full
    band (K_base 1025), through the kernels."""
    import os

    from nuradiomc_tpu_torch.convert import pa_simulation
    from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
    before = (placement.launches, pa_trigger.launches)
    res = pa_simulation(str(INPUT_1E18_N3000), chunk_size=1024, device=dev,
                        dtype=torch.float64).run()
    assert placement.launches > before[0] and pa_trigger.launches > before[1]
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "e2e_pa_reference.npz"))
    ref = set(int(g) for g in np.unique(golden["group_ids"][golden["triggered"]]))
    mine = set(int(g) for g in res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)])
    assert abs(len(mine) - len(ref)) <= 3 * np.sqrt(len(ref))
    assert len(mine & ref) >= 0.6 * len(ref)
    rel_err = 2.0 / np.sqrt(int(golden["n_triggered"]))
    assert abs(res["veff"] / float(golden["veff"]) - 1) < 2 * rel_err


def test_gen2_kernel_path_matches_plain_path(dev):
    """The Gen2 composed workload (birefringence, S 10, 3 stations) through
    kernels 4 and 2 against the plain path on the card, float32; the kernel
    path's scan is one launch a station."""
    from nuradiomc_tpu_torch.convert import make_gen2_inputs
    s, chps, b = make_gen2_inputs(256, device=dev, dtype=torch.float32)
    plain = dataclasses.replace(s, placement_impl="plain", trigger_impl="plain")
    before = placement.reduce_launches
    for ch in chps:
        scans = birefringence.launches
        out = pipeline.simulate_batch(b, ch, s)
        assert birefringence.launches == scans + 1
        ref = pipeline.simulate_batch(b, ch, plain)
        assert torch.equal(out.triggered, ref.triggered)
        torch.testing.assert_close(out.max_amplitude, ref.max_amplitude, rtol=1e-4, atol=0)
    assert placement.reduce_launches == before + 3


def test_factored_multishower_float64_on_card(dev):
    """Tau input without birefringence: the factored chain at s2 = 20 in
    float64, through kernel 1, against the plain path."""
    from nuradiomc_tpu_torch.convert import make_gen2_inputs
    s, chps, b = make_gen2_inputs(256, device=dev, dtype=torch.float64)
    s = dataclasses.replace(s, birefringence=False)
    plain = dataclasses.replace(s, placement_impl="plain", trigger_impl="plain")
    before = placement.launches
    fired = 0
    for ch in chps:
        out = pipeline.simulate_batch(b, ch, s)
        assert torch.equal(out.triggered, pipeline.simulate_batch(b, ch, plain).triggered)
        fired += int(out.triggered.sum())
    assert placement.launches == before + 3 and fired > 0


@pytest.mark.parametrize("n_reflections", [1, 2])
def test_reflective_kernel_path_matches_plain_path(dev, n_reflections):
    """The reflective-bottom station (MB1, bottom bounces, one readout window
    per bounce family) through kernels 1 (s2 = 2 (2 + 4 n_reflections)) and 2,
    once per window each, against the plain path on the card, float32."""
    from nuradiomc_tpu_torch.convert import make_mooresbay_inputs
    s, ch, b = make_mooresbay_inputs(1024, 0, device=dev, dtype=torch.float32)
    s = dataclasses.replace(s, n_reflections=n_reflections, n_windows=1 + 2 * n_reflections)
    plain = dataclasses.replace(s, placement_impl="plain", trigger_impl="plain")
    placement.launches = trigger_fused.launches = 0
    out = pipeline.simulate_batch(b, ch, s)
    assert (placement.launches, trigger_fused.launches) == (s.n_windows, s.n_windows)
    assert out.c0.shape[-1] == 2 + 4 * n_reflections
    ref = pipeline.simulate_batch(b, ch, plain)
    assert int((out.triggered != ref.triggered).sum()) <= 1
    assert bool(ref.triggered.any()) and bool(out.sol_mask[..., 2:].any())
    torch.testing.assert_close(out.max_amplitude, ref.max_amplitude, rtol=1e-4, atol=0)


def test_keep_traces_float64_on_card_matches_cpu(dev, monkeypatch):
    """``simulate_batch(keep_traces=True)`` in float64 on the card (kernels 1
    and 2 make the decisions, ``torch.fft`` the traces) against the same call
    on the CPU: decisions and trigger times equal, and in every group
    without a valid refracted ray the traces within 1e-10 of the group's
    peak (a peak below 1e-6 of the batch's largest, far under any noise
    floor, counts as 1e-6 of it).

    A refracted ray's closed form takes a square root that vanishes at the
    turning point (ROADMAP "The turning point"), so the two devices' ray
    solutions differ in their last bits there and the arrival moves. The
    test shows that this is the whole difference: every group whose traces
    differ by more than 1e-10 has a travel time that differs between the
    devices, and the CPU run given the card's ray solutions (the rest of
    the pipeline on the CPU as before) equals the card's traces within
    1e-10 of peak in every group, refracted ones included, and its
    ``base_t0`` within 1e-9 ns. Against the CPU's own solutions the
    refracted groups stay under the turning-point bound of
    tests/test_torch_nur_output.py, 5e-4 of peak."""
    from nuradiomc_tpu_torch.convert import dipole_simulation
    from nuradiomc_tpu_torch.ops import raytrace
    from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
    solve = raytrace.find_solutions_all
    card_sols = []

    def recording(*args, **kw):
        card_sols.append(solve(*args, **kw))
        return card_sols[-1]

    def replaying(*args, **kw):
        sols = card_sols.pop(0)
        return raytrace.RaySolutions(*[None if t is None else t.cpu() for t in sols])

    def run(where, find_solutions_all):
        monkeypatch.setattr(raytrace, "find_solutions_all", find_solutions_all)
        sim = dipole_simulation(str(INPUT_1E18_N3000), chunk_size=1024, device=where,
                                dtype=torch.float64)
        batch = sim._build_batches()[-1]
        b = pipeline.ShowerBatch(*[None if a is None else torch.as_tensor(
            np.ascontiguousarray(a[:1024]), device=sim.device) for a in batch])
        before = (placement.launches, trigger_fused.launches)
        out = pipeline.simulate_batch(b, sim.channel_params, sim.settings, keep_traces=True)
        launched = (placement.launches - before[0], trigger_fused.launches - before[1])
        return pipeline.PipelineOutput(*[t.cpu() if torch.is_tensor(t) else t
                                         for t in out]), launched

    card, launched = run(dev, recording)
    assert launched == (1, 1)
    cpu, _ = run("cpu", solve)
    cpu_card_rays, _ = run("cpu", replaying)
    assert not card_sols

    assert torch.equal(card.triggered, cpu.triggered) and bool(cpu.triggered.any())
    torch.testing.assert_close(card.trigger_time[cpu.triggered],
                               cpu.trigger_time[cpu.triggered], rtol=0, atol=1e-9)
    peak = cpu.traces.abs().amax(dim=(1, 2))
    scale = torch.clamp(peak, min=1e-6 * float(peak.max()))

    def rel_err(a, b):
        return (a.traces - b.traces).abs().amax(dim=(1, 2)) / scale

    err, err_same_rays = rel_err(card, cpu), rel_err(card, cpu_card_rays)
    valid = cpu.sol_mask.flatten(1)
    refracted = ((cpu.sol_type == 2) & cpu.sol_mask).flatten(1).any(dim=1)
    d_tt = torch.where(valid, (card.travel_time - cpu.travel_time).abs().flatten(1),
                       0.0).amax(dim=1)
    d_c0 = torch.where(valid, ((card.c0 - cpu.c0) / cpu.c0).abs().flatten(1), 0.0).amax(dim=1)
    d_t0 = (card.base_t0 - cpu.base_t0).abs()
    moved = err > 1e-10
    for g in torch.nonzero(moved | (refracted & (d_tt > 0))).flatten().tolist():
        print(f"group {g}: refracted {bool(refracted[g])}, peak {float(peak[g]):.3e}, trace "
              f"err {float(err[g]):.3e} of peak, {float(err_same_rays[g]):.3e} with the card's "
              f"rays; travel time moved {float(d_tt[g]):.3e} ns, c0 {float(d_c0[g]):.3e} rel, "
              f"base_t0 {float(d_t0[g]):.3e} ns")
    print(f"{int(moved.sum())} of {len(moved)} groups' traces differ by more than 1e-10 of "
          f"peak ({int(refracted.sum())} with a refracted ray), worst {float(err.max()):.3e}; "
          f"with the card's rays worst {float(err_same_rays.max()):.3e}")
    assert int((~refracted & (peak > 0)).sum()) > 100
    assert float(err[~refracted].max()) <= 1e-10
    assert bool((d_tt[moved] > 0).all())
    assert float(err[refracted].max()) <= 5e-4
    assert float(err_same_rays.max()) <= 1e-10
    torch.testing.assert_close(card.base_t0, cpu_card_rays.base_t0, rtol=0, atol=1e-9)
    torch.testing.assert_close(card.base_t0, cpu.base_t0, rtol=0, atol=1e-3)


# ---- the reconstruction path: each entry point on the card against the CPU --

def _reco_example03(where):
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev, parameters as fpar
    from nuradiomc_tpu_torch.reco import channel_processing as cp, efield_converters as ec
    from nuradiomc_tpu_torch.reco import examples

    det = Detector(examples.SIMPLE_DETECTOR)
    evt, st = examples.simple_event(fev, fpar)
    conv = ec.efieldToVoltageConverter(device=where)
    conv.begin()
    conv.run(evt, st, det)
    noise = cp.channelGenericNoiseAdder(device=where)
    noise.begin(seed=42)
    noise.run(evt, st, det, amplitude=1e-6, type="rayleigh")
    cp.channelBandPassFilter(device=where).run(evt, st, det, passband=[0.1, 0.5],
                                               filter_type="butter", order=4)
    cp.channelResampler(device=where).run(evt, st, det, sampling_rate=3.0)
    rec = cp.channelSignalReconstructor(device=where)
    rec.begin()
    rec.run(evt, st, det)
    unfold = ec.voltageToEfieldConverter(device=where)
    unfold.begin()
    unfold.run(evt, st, det, use_channels=[0, 1])
    return ([np.asarray(st.get_channel(c).get_trace()) for c in (0, 1)]
            + list(np.asarray(st.get_electric_fields()[-1].get_frequency_spectrum())))


def test_reco_channel_chain_card_equals_cpu(dev):
    """The example-03 chain (with a resampling) in float64: every trace and
    spectrum within 1e-9 of its peak."""
    for a, b in zip(_reco_example03(dev), _reco_example03("cpu")):
        scale = max(float(np.max(np.abs(b))), 1e-300)
        assert float(np.max(np.abs(a - b))) <= 1e-9 * scale


def test_reco_travel_time_table_card_equals_cpu(dev):
    """A table at 20 m steps: validity equal except a refracted ray at the
    turning point (none on this grid), travel times within 1e-6 relative."""
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.reco import vertex

    ice = ice_models.get_ice_model("greenland_simple")
    kw = dict(d_x=20.0, d_z=20.0)
    _, card = vertex.build_travel_time_table(ice, -100.0, device=dev, **kw)
    _, cpu = vertex.build_travel_time_table(ice, -100.0, device="cpu", **kw)
    card = card.cpu()
    assert torch.equal(card > 0, cpu > 0)
    ok = cpu > 0
    torch.testing.assert_close(card[ok], cpu[ok], rtol=1e-6, atol=0)


def test_reco_direction_fitters_and_ift_card_equal_cpu(dev):
    """The correlation and beam-forming fitters at their default grids give
    the same direction, the IFT spectrum after 50 steps agrees within 1e-6 of
    its peak."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev, parameters as fpar
    from nuradiomc_tpu_torch.reco import direction, efield_converters as ec, examples
    from nuradiomc_tpu_torch.reco import ift_efield

    square = Detector(examples.SQUARE_DETECTOR)
    stnp = fpar.stationParameters

    def vel_theta(cid, ff, zen, az):
        return ec.get_channel_vel(square, 7, cid, ff, zen, az, device="cpu")[0].numpy()

    for cls, make, kw in ((direction.correlationDirectionFitter,
                           lambda: examples.plane_wave_event(fev), {"n_index": 1.0}),
                          (direction.beamFormingDirectionFitter,
                           lambda: examples.beamforming_event(fev, vel_theta), {"n_index": 1.0})):
        got = []
        for where in (dev, "cpu"):
            evt, st = make()
            cls(device=where).run(evt, st, square, **kw)
            got.append((st[stnp.zenith], st[stnp.azimuth]))
        assert np.allclose(got[0], got[1], rtol=0, atol=1e-9), (cls.__name__, got)

    mixed = Detector(examples.MIXED_DETECTOR)
    specs = []
    for where in (dev, "cpu"):
        reco = ift_efield.iftElectricFieldReconstructor(device=where)
        reco.begin(passband=examples.IFT_TRUTH["band"], noise_rms=examples.IFT_TRUTH["noise"],
                   n_iterations=50)
        evt, st = examples.ift_event(fev, fpar, lambda c, f, z, a: [x.numpy() for x in (
            ec.get_channel_vel(mixed, 7, c, f, z, a, device="cpu"))])
        specs.append(np.asarray(reco.run(evt, st, mixed).get_frequency_spectrum()))
    assert float(np.max(np.abs(specs[0] - specs[1]))) <= 1e-6 * float(np.max(np.abs(specs[1])))


def test_reco_vertex_and_nu_direction_card_equal_cpu(dev):
    """run_reco_chain.py's event: the chi2 grid of a small direction fit
    within 1e-9 relative, the same fit; the 3D vertex on 20 m tables equal."""
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as fev
    from nuradiomc_tpu_torch.models import ice as ice_models
    from nuradiomc_tpu_torch.reco import examples, nu_direction, vertex

    ice = ice_models.get_ice_model(examples.GREENLAND)
    det = Detector(examples.RECO_CHAIN_DETECTOR)
    t = examples.RECO_CHAIN_TRUTH
    forward = nu_direction.neutrinoDirectionReconstructor(device="cpu")
    forward.begin(ice, attenuation_model="GL1")
    evt, st, noise = examples.reco_chain_event(fev, forward, det)
    w = dict(zenith_range=(t["zenith"] - 0.1, t["zenith"] + 0.1),
             azimuth_range=(t["azimuth"] - 0.1, t["azimuth"] + 0.1),
             energy_range=(t["log10_energy"] - 0.5, t["log10_energy"] + 0.5),
             coarse_steps=(5, 5, 5), n_zoom=1)
    fits, grids, vertices = [], [], []
    for where in (dev, "cpu"):
        reco = nu_direction.neutrinoDirectionReconstructor(device=where)
        reco.begin(ice, attenuation_model="GL1")
        fits.append(reco.run(evt, st, det, vertex=t["vertex"], use_channels=list(range(8)),
                             noise_RMS=noise, **w))
        grids.append(np.concatenate([c for _, c in reco.grids]))
        v = vertex.neutrino3DVertexReconstructor(ice, device=where, table_kwargs=dict(
            x_min=20.0, x_max=1200.0, d_x=20.0, z_min=-1100.0, z_max=-30.0, d_z=20.0))
        v.begin(1, list(range(8)), det)
        vertices.append(v.run(evt, st, max_distance=1000.0, z_range=(-1000.0, -50.0),
                              coarse_steps=12, n_zoom=3))
    np.testing.assert_allclose(grids[0], grids[1], rtol=1e-9)
    assert fits[0] == fits[1]
    np.testing.assert_array_equal(vertices[0], vertices[1])


def test_reco_triggers_card_equal_cpu(dev):
    """The trigger modules and the RNO-G surface trigger on NuRadioReco's
    trigger_test_input.nur: the same decisions, times and channels."""
    import copy
    import os

    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.reco import rnog, trigger_modules as tm
    from nuradiomc_tpu_torch.sim import io_nur
    from nuradiomc_tpu_torch.utils import units

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    events = list(io_nur.EventReader(os.path.join(golden, "trigger_test_input.nur")).run())
    det = Detector(os.path.join(golden, "trigger_test_detector.json"))
    rows = []
    for where in (dev, "cpu"):
        phased = tm.BeamformedPowerIntegrationTrigger(device=where)
        phased.begin()
        out = []
        for evt in copy.deepcopy(events):
            st = evt.get_station(1)
            tm.triggerSimulatorHighLow(device=where).run(
                evt, st, det, threshold_high=0.12 * units.mV, threshold_low=-0.12 * units.mV)
            tm.triggerSimulatorMultiHighLow(device=where).run(
                evt, st, det, threshold_high=0.1 * units.mV, threshold_low=-0.1 * units.mV,
                n_high_lows=2)
            phased.run(evt, st, det, Vrms=0.02 * units.mV, threshold=1.5e-8)
            rnog.rnogSurfaceTrigger(device=where).run(
                evt, st, det, threshold=1e-9, triggered_channels=(0, 1, 2, 3),
                temperature=300 * units.kelvin)
            out.append({k: (v.has_triggered(), v.get_trigger_time(),
                            list(v.get_triggered_channels() or []))
                        for k, v in st.get_triggers().items()})
        rows.append(out)
    assert rows[0] == rows[1]


# ---- the LPDA phase sector on its edges (simulation path) -------------------

def test_lpda_sector_on_card_matches_jax(dev, monkeypatch):
    """``simulate_batch`` in float64 on examples.MIXED_DETECTOR's downward
    LPDAs with arrivals exactly on a sector edge (135 deg zenith, 24
    azimuths; ``convert.make_lpda_edge_inputs``): the sector the card
    decides from each receive vector equals the CPU's and the JAX package's
    for that direction (``nuradiomc_tpu_torch/data/lpda_sector_jax_sets.npz``,
    written by tests/test_torch_lpda_sector.py) at every (group, shower,
    channel, slot); the IFT geometry's angles through ``lpda_sector_host``
    (the reco modules) take the JAX package's sectors from either device."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.ops import antenna, raytrace
    from nuradiomc_tpu_torch.reco import examples
    from nuradiomc_tpu_torch.sim.io_input import DATA_DIR

    with np.load(DATA_DIR / "lpda_sector_jax_sets.npz") as z:
        sets = {k: z[k] for k in z.files}
    mix = antenna.analytic_vel_mix
    solver_vectors = raytrace.launch_receive_vectors
    taken = {}
    for where in (dev, "cpu"):
        s, ch, b, vectors = convert.make_lpda_edge_inputs(device=where)
        seen = []

        def recording(*args, **kw):
            out = mix(*args, **kw)
            seen.append(out[2])
            return out

        monkeypatch.setattr(raytrace, "launch_receive_vectors", vectors)
        monkeypatch.setattr(antenna, "analytic_vel_mix", recording)
        pipeline.simulate_batch(b, ch, s)
        monkeypatch.setattr(raytrace, "launch_receive_vectors", solver_vectors)
        monkeypatch.setattr(antenna, "analytic_vel_mix", mix)
        taken[str(where)] = seen[0].cpu()
    want = torch.as_tensor(sets["edge_direct"])[:, None, :, None].expand(taken["cpu"].shape)
    assert torch.equal(taken[str(dev)], taken["cpu"])
    assert torch.equal(taken[str(dev)], want)
    for where in (dev, "cpu"):
        zen = torch.tensor(examples.IFT_TRUTH["zenith"], dtype=torch.float64, device=where)
        az = torch.tensor(examples.IFT_TRUTH["azimuth"], dtype=torch.float64, device=where)
        got = [int(antenna.lpda_sector_host(zen, az, r, antenna.KIND_LPDA))
               for r in sets["rotations"]]
        assert got == list(sets["ift"]), (where, got)


# ---- the cosmic-ray side: batched programs, card against CPU ----------------

def test_lofar_beam_search_on_card_matches_cpu(dev):
    """beamformingDirectionFitter's grid powers at every zoom level and the
    chosen direction (tests/test_lofar.py's station, 24 antennas, 8192
    samples) on the card against the CPU: powers within 1e-10, same grid
    points."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.framework import event as ev
    from nuradiomc_tpu_torch.framework.parameters import stationParameters
    from nuradiomc_tpu_torch.reco import lofar

    det = convert.LofarDetector(n_ant=24)
    levels = {}
    for where in (dev, "cpu"):
        event = ev.Event(0, 1)
        event.set_station(convert.make_lofar_station(ev, det, 2, np.deg2rad(35.0),
                                                     np.deg2rad(120.0)))
        finder = lofar.stationPulseFinder(device="cpu")
        finder.begin(window=256, noise_window=2000)
        finder.run(event, det, (np.deg2rad(38.0), np.deg2rad(116.0)))
        st = event.get_station(2)
        st.set_parameter(stationParameters.zenith, np.deg2rad(40.0))
        st.set_parameter(stationParameters.azimuth, np.deg2rad(115.0))
        fit = lofar.beamformingDirectionFitter(device=where)
        fit.begin(cr_snr=6.5)
        fit.run(event, det)
        levels[str(where)] = fit.levels
    for (zc, ac, pc), (zg, ag, pg) in zip(levels["cpu"], levels[str(dev)]):
        np.testing.assert_array_equal(zg, zc)
        np.testing.assert_array_equal(ag, ac)
        np.testing.assert_allclose(pg, pc, rtol=1e-10)


def test_rit_interference_on_card_matches_cpu(dev):
    """The batched interference (tests/test_rit.py's line emitter, 30
    antennas): a 7 x 7 lateral plane and the longitudinal profile on the
    card against the CPU within 1e-9, points whose summed-grid length
    differs excused."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.models.atmosphere import Atmosphere, Refractivity
    from nuradiomc_tpu_torch.reco import rit

    positions, traces, times, axis, source, _ = convert.make_rit_event()
    refr = Refractivity(Atmosphere(17))
    frame = rit.shower_frame(np.deg2rad(32.0), np.deg2rad(250.0), np.array([0.0, 18.0, -49.0]))
    xs = np.linspace(-250.0, 250.0, 7)
    points = (source + xs[:, None, None] * frame[0] + xs[None, :, None] * frame[1]).reshape(-1, 3)
    points = np.concatenate([points, axis * np.linspace(3e3, 9e3, 13)[:, None]])
    sig, lengths = {}, {}
    for where in (dev, "cpu"):
        itf = rit.Interferometer(traces, times, positions, refr, where)
        sig[str(where)] = itf.signals(points)
        lengths[str(where)] = itf.grids(points)[4]
    same = lengths["cpu"] == lengths[str(dev)]
    assert same.sum() >= len(points) - 2
    np.testing.assert_allclose(sig[str(dev)][same], sig["cpu"][same], rtol=1e-9)


def test_galactic_noise_on_card_matches_cpu(dev):
    """channelGalacticNoiseAdder (192 pixels, seed 7) and the ice thermal
    adder on the card against the CPU: the same host draws, spectra within
    1e-12 of peak."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.detector.detector import Detector
    from nuradiomc_tpu_torch.framework import event as ev
    from nuradiomc_tpu_torch.reco import advanced

    det = Detector(convert.coreas_lpda_detector())
    out = {}
    for where in (dev, "cpu"):
        st = ev.Station(7)
        for cid in range(4):
            ch = ev.Channel(cid)
            ch.set_trace(np.zeros(2048), 2.0)
            st.add_channel(ch)
        st.set_station_time(1.4e9)
        g = advanced.channelGalacticNoiseAdder(device=where)
        g.begin(seed=7, n_pixels=192)
        g.run(ev.Event(0, 0), st, det)
        galactic = np.array([st.get_channel(c).get_frequency_spectrum() for c in range(4)])
        thetas = np.linspace(0, np.pi, 20)
        th = advanced.channelIceThermalNoiseAdder(device=where)
        th.begin({-1.0: (thetas, np.full(20, 250.0))}, nr_phi_bins=16, seed=2)
        th.run(ev.Event(0, 0), st, det)
        out[str(where)] = (galactic,
                           np.array([st.get_channel(c).get_frequency_spectrum() for c in range(4)]))
    for a, b in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


def _rnog_chunk(n_events=256):
    """One 256-event chunk of RNO-G waveforms in volts (``convert.make_rnog_runs``,
    written to a temporary directory and read back) and its scrambles."""
    import tempfile

    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.reco import rnog_io
    with tempfile.TemporaryDirectory() as tmp:
        paths, truth = convert.make_rnog_runs(tmp, n_runs=1, n_events=n_events, seed=9)
        raw = rnog_io.NumpyDataset(paths[0]).raw_block(np.arange(n_events))
    return raw.astype(float) * rnog_io.ADC_TO_VOLT, truth[0]


def test_rnog_block_offsets_and_glitches_on_card_match_cpu(dev):
    """The data provider's chunk pass (block offsets "auto", glitch statistic)
    on a 256-event chunk: offsets within 1e-9 of each trace's standard
    deviation, corrected traces within 1e-12 of peak, the fit branch and the
    glitch flags equal; every injected scramble flagged (the statistic's cut
    at 0 may flag a clean channel too)."""
    from nuradiomc_tpu_torch.reco import rnog_io
    volts, truth = _rnog_chunk()
    out = {}
    for where in (dev, "cpu"):
        provider = rnog_io.dataProviderRNOG(device=where)
        res = provider.process(torch.as_tensor(volts, device=where), 3.2)
        out[str(where)] = [r.cpu().numpy() for r in res]
    (tr_c, off_c, fit_c, gl_c), (tr_h, off_h, fit_h, gl_h) = out[str(dev)], out["cpu"]
    peak = np.abs(tr_h).max(-1, keepdims=True)
    assert np.all(np.abs(tr_c - tr_h) <= 1e-12 * peak)
    assert np.all(np.abs(off_c - off_h) <= 1e-9 * volts.std(-1, keepdims=True))
    np.testing.assert_array_equal(fit_c, fit_h)
    np.testing.assert_array_equal(gl_c, gl_h)
    scrambled = truth["scrambled"]
    assert not np.any(scrambled & ~gl_h), "a scrambled channel was not flagged"
    assert gl_h.sum() >= scrambled.sum()


def test_rnog_hit_filter_on_card_matches_cpu(dev):
    """stationHitFilter's batched pass on the 256 events' in-ice channels:
    hit times, both checkers and the decisions equal."""
    from nuradiomc_tpu_torch.reco import rnog_data
    volts, _ = _rnog_chunk()
    traces = volts[:, rnog_data.stationHitFilter.IN_ICE_CHANNELS]
    t0 = -250.0 - 0.1 * np.arange(traces.shape[1])
    out = {}
    for where in (dev, "cpu"):
        hf = rnog_data.stationHitFilter(device=where)
        start = torch.as_tensor(np.tile(t0, (len(traces), 1)), device=where)
        fs = torch.full_like(start, 3.2)
        res = hf.apply_batch(torch.as_tensor(traces, device=where),
                             lambda i: i.to(start.dtype) / fs + start)
        out[str(where)] = [r.cpu().numpy() for r in res]
    for a, b in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert 0 < out["cpu"][0].sum() < len(traces)


def test_bgr18_campaign_on_card_matches_cpu(dev, tmp_path):
    """A 300-event dipole campaign (r < 1 km, -1 km < z < 0) drawn with the
    synthetic BGR18 table (``convert.make_bgr18_table``) and weighted with
    it, in float64 on the card and on the CPU: kernels 1 and 2 launch on the
    card, the triggered set is equal and Veff agrees at rtol 1e-9; the BGR18
    weights differ from the CTW weights of the same list and lie in [0, 1]."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.sim import cross_sections, earth_attenuation, evtgen, io_input
    from nuradiomc_tpu_torch.utils import units

    old = cross_sections._BGR18_PATH
    cross_sections.set_bgr18_table_path(convert.make_bgr18_table(str(tmp_path / "bgr18.npz")))
    try:
        volume = {"fiducial_rmin": 0, "fiducial_rmax": 1 * units.km,
                  "fiducial_zmin": -1 * units.km, "fiducial_zmax": 0}
        data, attrs = evtgen.generate_eventlist_cylinder(
            None, 300, 1e18 * units.eV, 1e18 * units.eV, volume, seed=10,
            cross_sections_model="hedis_bgr18")
        inp = io_input.from_generated(data, attrs)
        config = {"weights": {"weight_mode": "core_mantle_crust_simple",
                              "cross_section_type": "hedis_bgr18"}}
        res = {}
        for where in (dev, "cpu"):
            before = (placement.launches, trigger_fused.launches)
            res[str(where)] = convert.fullscale_simulation(
                inp, config, device=where, dtype=torch.float64).run()
            if where is dev:
                assert placement.launches > before[0] and trigger_fused.launches > before[1]
        card, cpu = res[str(dev)], res["cpu"]
        assert cpu["triggered"].sum() >= 3
        np.testing.assert_array_equal(card["group_ids"][card["triggered"]],
                                      cpu["group_ids"][cpu["triggered"]])
        np.testing.assert_allclose(card["veff"], cpu["veff"], rtol=1e-9)
        args = (data["zeniths"], data["energies"], data["flavors"])
        w = earth_attenuation.get_weight(*args, mode="core_mantle_crust_simple",
                                         cross_section_type="hedis_bgr18")
        w_ctw = earth_attenuation.get_weight(*args, mode="core_mantle_crust_simple",
                                             cross_section_type="ctw")
        assert np.all((w >= 0) & (w <= 1)) and not np.allclose(w, w_ctw, rtol=1e-3)
    finally:
        cross_sections.set_bgr18_table_path(old)
