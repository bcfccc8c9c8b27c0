"""The kernels' FFT decomposition, mirrored in plain torch, on the CPU.

``csrc/fft_common.cuh`` computes every kernel's transforms by mixed-radix
Stockham FFTs in shared memory, with Hermitian pre- and post-steps and one
float64 host twiddle table: the trigger kernel's traces (kernel 2), the
placement of kernels 1 and 4 (``csrc/placement_fft.cuh``) and the
phased-array kernel's full-rate trace, folded decimated trace and FFT
upsampling (kernel 3). A CUDA kernel cannot run here, so this file mirrors
that decomposition in torch -- the same stage radices
(``fft_plan.radices``), the same index arithmetic per stage, the same
edge-bin handling and the same host table (``fft_plan.twiddle_table``) --
and holds it to the dense matrices the plain versions multiply by
(``fft_plan._irfft_matrices`` / ``_placement_matrices`` /
``_decimating_irfft_matrices`` / ``_fft_upsample_matrix``) and to the JAX
package's copies of those, for even and odd lengths, the full band (K = n/2
+ 1, nonzero Im at DC and Nyquist, which numpy's irfft drops) and a cut
band, in float32 and float64. The mirror is test code: the port runs the
CUDA kernels or the plain versions, never this.

Tolerances: the FFT and the dense product round differently; float64 within
1e-12 and float32 within 2e-6 of each row's peak (the dense product's own
float32 error is ~1e-6), 1e-5 for the decimation and the upsampling in
float32 (longer transforms, a float64 reference).
"""

import math

import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu_torch.ops import fft_plan, pa_trigger, phased_array, placement, trigger_fused

TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


def _table(n, dtype):
    t = torch.as_tensor(fft_plan.twiddle_table(n), dtype=dtype)
    return torch.complex(t[:, 0], t[:, 1])


def _run(x, n, E, sign):
    """fftc::run: the Stockham stages over rows of x [R, L] (complex)."""
    L, stages = fft_plan.plan(n)
    tws = n // L
    E = E if sign > 0 else E.conj()
    Ns = 1
    for R in stages:
        nb = L // R
        j = torch.arange(nb)
        k = j % Ns
        d0 = (j // Ns) * Ns * R + k
        step = (L // (Ns * R)) * tws
        v = [x[:, j + r * nb] * E[r * k * step] for r in range(R)]
        dst = torch.empty_like(x)
        for q in range(R):
            dst[:, d0 + q * Ns] = sum(v[r] * E[((r * q) % R) * (L // R) * tws]
                                      for r in range(R))
        x = dst
        Ns *= R
    return x


def _irfft_pre(X, n, E, norm):
    """fftc::irfft_pre: the inverse transform's input from the one-sided
    spectrum X [R, K] (zero from K on), Im of DC / Nyquist dropped."""
    R, K = X.shape
    L = fft_plan.complex_length(n)
    full = torch.zeros((R, n // 2 + 1), dtype=X.dtype)
    full[:, :K] = X
    full[:, 0] = full[:, 0].real
    k = torch.arange(L)
    if n % 2 == 0:
        full[:, L] = full[:, L].real
        x, y = full[:, k], full[:, L - k].conj()
        Z = (x + y) + 1j * E[k] * (x - y)
    else:
        h = (n - 1) // 2
        Z = torch.where(k <= h, full[:, torch.clamp(k, max=h)],
                        full[:, torch.clamp(n - k, max=h)].conj())
    return Z * norm


def _rfft_pre(x, n):
    """fftc::rfft_pre: the forward transform's input from real samples
    x [R, n_in] padded with zeros to n."""
    R, n_in = x.shape
    pad = torch.zeros((R, n), dtype=x.dtype)
    pad[:, :n_in] = x
    if n % 2 == 0:
        return torch.complex(pad[:, 0::2], pad[:, 1::2])
    return torch.complex(pad, torch.zeros_like(pad))


def _rfft_post(Z, n, E, K):
    """fftc::rfft_post: bins k < K of the rfft from the forward transform."""
    if n % 2:
        return Z[:, :K]
    L = n // 2
    k = torch.arange(K)
    a = Z[:, torch.where(k == L, 0, k)]
    b = Z[:, torch.where(k == 0, 0, L - k)].conj()
    return (a + b) * 0.5 + (-0.5j) * (a - b) * E[k].conj()


def _trace(X, n, scale):
    """Kernel 2's trace: irfft_pre, the inverse stages, read as reals."""
    E = _table(n, X.real.dtype)
    z = _run(_irfft_pre(X, n, E, scale / n), n, E, +1)
    if n % 2 == 0:
        return torch.view_as_real(z).reshape(X.shape[0], n)
    return z.real


def _place(V, n_int, n_base, K_place):
    """Kernel 1's placement: irfft(V, n_int), then the rfft of the trace
    padded to n_base, bins < K_place."""
    dtype = V.real.dtype
    E1, E2 = _table(n_int, dtype), _table(n_base, dtype)
    x = _run(_irfft_pre(V, n_int, E1, 1.0 / n_int), n_int, E1, +1)
    x = torch.view_as_real(x).reshape(V.shape[0], n_int) if n_int % 2 == 0 else x.real
    return _rfft_post(_run(_rfft_pre(x, n_base), n_base, E2, -1), n_base, E2, K_place)


def _spectrum(rng, R, K, dtype):
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    X = rng.normal(size=(R, K)) + 1j * rng.normal(size=(R, K))   # Im at DC/Nyquist nonzero
    return torch.as_tensor(X, dtype=ctype)


def _close(got, ref, tol):
    peak = ref.abs().amax(dim=1, keepdim=True)
    assert bool(((got - ref).abs() <= tol * peak).all()), float(((got - ref).abs() / peak).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, K", [(512, 257), (1000, 501), (1024, 513), (2048, 1025),
                                  (2048, 816), (999, 500), (1000, 300), (4096, 2049),
                                  (2187, 1094)])
def test_trigger_irfft_mirror_matches_dense(n, K, dtype):
    """Kernel 2's decomposition against numpy's irfft as the dense matrices
    of the plain version (the port's copy and the JAX package's)."""
    rng = np.random.default_rng(n + K)
    X = _spectrum(rng, 6, K, dtype)
    scale = 2.0 / math.sqrt(2.0)
    got = _trace(X, n, scale)
    I_r, I_i = fft_plan.irfft_dense(n, K, dtype, torch.device("cpu"))
    ref = (X.real @ I_r + X.imag @ I_i) * scale
    _close(got, ref, TOL[dtype])
    J_r, J_i = (torch.as_tensor(m[:K], dtype=dtype) for m in jpipe._irfft_matrices(n))
    _close(got, (X.real @ J_r + X.imag @ J_i) * scale, TOL[dtype])
    # and numpy's own irfft in float64
    np_ref = np.fft.irfft(X.numpy().astype(np.complex128), n=n, axis=1) * scale
    _close(got.double(), torch.as_tensor(np_ref), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_int, n_base, K_int, K_place", [
    (512, 2048, 257, 1025), (512, 2048, 208, 816), (128, 512, 65, 257), (250, 1000, 126, 501),
    (255, 1000, 128, 400), (512, 1024, 257, 513), (100, 999, 51, 500)])
def test_placement_mirror_matches_dense(n_int, n_base, K_int, K_place, dtype):
    """Kernel 1's decomposition against the placement matrices (the port's
    copy and the JAX package's)."""
    rng = np.random.default_rng(n_int + n_base)
    V = _spectrum(rng, 5, K_int, dtype)
    got = _place(V, n_int, n_base, K_place)
    D_r, D_i = fft_plan.placement_dense(n_int, n_base, K_int, K_place, dtype,
                                        torch.device("cpu"))
    ref = V.real.to(D_r.dtype) @ D_r + V.imag.to(D_i.dtype) @ D_i
    _close(got, ref, TOL[dtype])
    J_r, J_i = (torch.as_tensor(m[:K_int, :K_place], dtype=ref.dtype)
                for m in jpipe._placement_matrices(n_int, n_base))
    _close(got, V.real.to(J_r.dtype) @ J_r + V.imag.to(J_i.dtype) @ J_i, TOL[dtype])


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 7, 8, 12, 49, 250, 256, 500, 1000, 1024, 2 * 3 * 5 * 7 * 11])
def test_radices_multiply_to_the_length(L):
    r = fft_plan.radices(L)
    assert math.prod(r) == L
    assert list(r) == sorted(r, key=lambda x: (x != 16, x != 4, x))   # 16s, 4s, ascending
    assert (16 in r) == (L >= 1024 and L % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_placement_chain_mirror_matches_plain(dtype):
    """The whole kernel-1 row pipeline in the mirror -- chain into V, skip of
    masked rows, both FFTs, the per-row 32 + ceil(K_place/32) phase factors,
    the (shower, ray) sum in row order -- against the plain version."""
    rng = np.random.default_rng(3)
    G, s2, n_int, n_base, K_int, K_place, n_sparse = 6, 20, 128, 512, 65, 200, 8
    R = G * s2
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    mask = torch.as_tensor(rng.uniform(size=R) < 0.5)
    mask[:s2] = False                                  # a fully masked output row
    spec_re = torch.as_tensor(rng.normal(size=(R, K_int)), dtype=dtype)
    spec_im = torch.as_tensor(rng.normal(size=(R, K_int)), dtype=dtype)
    spec_re[~mask] = float("nan")
    spec_im[~mask] = float("nan")
    args = [spec_re, spec_im,
            torch.as_tensor(rng.uniform(0.5, 1, (R, n_sparse)), dtype=dtype),
            torch.as_tensor(rng.normal(size=R), dtype=dtype),
            torch.as_tensor(rng.normal(size=R), dtype=dtype), mask,
            torch.as_tensor(rng.integers(0, 3, R), dtype=torch.int32),
            torch.as_tensor(rng.uniform(0, 190, R), dtype=dtype),
            torch.as_tensor(rng.uniform(size=(n_sparse, K_int)), dtype=dtype),
            _spectrum(rng, 3, K_int, dtype).to(ctype)]
    df = 2.0 / n_base
    kw = dict(s2=s2, df=df, n_int=n_int, n_base=n_base, K_place=K_place)
    ref = torch.complex(*placement.chain_placement_reduce_plain(*args, **kw))

    sr, si, att_sparse, cr, ci, m, tpl_idx, offsets, W, tpl = args
    att = att_sparse @ W
    cs = torch.complex(cr, ci)[:, None] * torch.complex(sr * att, si * att)
    V = tpl[tpl_idx.long()] * cs
    Xb = torch.zeros((R, K_place), dtype=ctype)
    Xb[m] = _place(V[m], n_int, n_base, K_place)
    theta = torch.tensor(-2 * math.pi * df, dtype=dtype) * offsets
    k = torch.arange(K_place)
    wa = torch.polar(torch.ones((), dtype=dtype), theta[:, None] * (k // 32 * 32).to(dtype))
    wb = torch.polar(torch.ones((), dtype=dtype), theta[:, None] * (k % 32).to(dtype))
    got = torch.zeros((G, K_place), dtype=ctype)
    for j in range(s2):
        rows = torch.arange(G) * s2 + j
        got = got + torch.where(m[rows, None], Xb[rows] * (wa[rows] * wb[rows]), 0)
    assert torch.isfinite(got).all() and bool((got[0] == 0).all())
    _close(got[1:], ref[1:], 20 * TOL[dtype])


def test_trigger_mirror_decisions_match_plain():
    """The mirror's traces through the plain trigger logic give the plain
    version's decisions and amplitudes (float64, full band)."""
    rng = np.random.default_rng(11)
    G, C, n = 40, 2, 1000
    K = n // 2 + 1
    X = _spectrum(rng, G * C, K, torch.float64)
    scale = 2.0 / math.sqrt(2.0)
    trace = _trace(X, n, scale)
    sigma = float(trace.std())
    th = torch.as_tensor(sigma * rng.uniform(2.0, 3.0, (G * C, 1)))
    trig = (trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1),)
    fired, first, amp = trigger_fused.fused_irfft_trigger_plain(
        X.real.contiguous(), X.imag.contiguous(), th, -th, n_base=n, scale=scale,
        triggers=trig, C=C)
    assert 0 < int(fired.sum()) < G
    torch.testing.assert_close(trace.abs().amax(dim=1).reshape(G, C), amp, rtol=1e-12, atol=0)


def _tiling(n_base, nth=128, emax=16):
    """irfft_trigger.cu's tiling_of: (samples per thread and tile, tile, tiles)."""
    es = min(-(-n_base // nth), emax)
    return es, es * nth, -(-n_base // (es * nth))


def _trigger_counts_mirror(trace, th_hi, th_lo, triggers):
    """Kernel 2's trigger logic on traces [G, C, n]: the channel loop
    outermost, one trace at a time; per trigger the packed prefix count of
    the high and low crossings (low 16 bits, high 16 bits) carried from tile
    to tile, the window's any as a difference of prefixes, the majority
    window the same way, and the row's bit added into the per-(trigger,
    sample) count; a +inf threshold skips the channel. After the last channel
    the first sample whose count reaches n_coinc. Returns (fired, first,
    counts [G, T, n])."""
    G, C, n = trace.shape
    _, tile, n_tiles = _tiling(n)
    counts = torch.zeros((G, len(triggers), n), dtype=torch.int64)
    idx = torch.arange(n)

    def prefix(x):
        """Inclusive prefix of x [G, n], tile by tile with a carry."""
        P = torch.zeros_like(x)
        carry = torch.zeros((G, 1), dtype=x.dtype)
        for k in range(n_tiles):
            part = x[:, k * tile:(k + 1) * tile]
            P[:, k * tile:(k + 1) * tile] = carry + torch.cumsum(part, dim=1)
            carry = carry + part.sum(dim=1, keepdim=True)
        return P

    def window(P, w):
        """P[n] - P[n - w], the prefix before the trace being 0."""
        back = torch.where(idx >= w, P[:, (idx - w).clamp(min=0)], torch.zeros_like(P))
        return P - back

    for c in range(C):
        v = trace[:, c]
        for t, spec in enumerate(triggers):
            hi, lo = th_hi[:, c, t, None], th_lo[:, c, t, None]
            live = ~torch.isinf(hi[:, 0])               # the kernel's `continue`
            if spec.kind == "high_low":
                d = window(prefix((v >= hi).long() + ((v <= lo).long() << 16)), spec.n_bins_hl)
                tts = ((d & 0xffff) > 0) & ((d >> 16) > 0)
            else:
                tts = v.abs() >= hi
            wide = window(prefix(tts.long()), min(spec.n_bins_maj, n)) > 0
            counts[:, t] += (wide & live[:, None]).long()
    need = torch.as_tensor([s.n_coinc for s in triggers])[None, :, None]
    ok = counts >= need
    fired = ok.any(dim=-1)
    first = torch.where(fired, ok.long().argmax(dim=-1), 0).to(torch.int32)
    return fired, first, counts


@pytest.mark.parametrize("n, C, T, G", [(2048, 3, 8, 16), (1000, 2, 3, 24), (4500, 4, 5, 12),
                                        (2100, 24, 17, 4)])
def test_trigger_count_accumulation_mirror_matches_plain(n, C, T, G):
    """The restructured kernel 2: channel-outer accumulation of per-(trigger,
    sample) counts, the tile loop with its carried prefixes (4500 and 2100
    samples: three and two tiles, the last one partial), alternating kinds,
    channel subsets as +inf thresholds and more columns than one launch
    takes: decisions and first bins equal to the plain version's."""
    rng = np.random.default_rng(13)
    K = n // 2 + 1
    X = _spectrum(rng, G * C, K, torch.float64)
    scale = 2.0 / math.sqrt(2.0)
    trace = _trace(X, n, scale)
    sigma = float(trace.std())
    th = torch.as_tensor(sigma * (rng.uniform(2.2, 3.2, (G * C, T)) + 0.05 * np.arange(T)))
    trig = []
    for t in range(T):
        if t % 2 == 0:
            trig.append(trigger_fused.TriggerSpecStatic("high_low", 10, 400, 1 + (t // 2) % 2))
        else:
            trig.append(trigger_fused.TriggerSpecStatic("simple_threshold", 1,
                                                        max(400 - 30 * t, 7), min(C, 2)))
        if t % 3 == 2 and C > 2:
            th[(torch.arange(G * C) % C) >= (C + 1) // 2, t] = float("inf")
    fired, first, amp = trigger_fused.fused_irfft_trigger_plain(
        X.real.contiguous(), X.imag.contiguous(), th, -th, n_base=n, scale=scale,
        triggers=tuple(trig), C=C)
    m_fired, m_first, counts = _trigger_counts_mirror(
        trace.reshape(G, C, n), th.reshape(G, C, T), -th.reshape(G, C, T), trig)
    assert 0 < int(fired.sum()) < fired.numel()
    assert torch.equal(m_fired, fired) and torch.equal(m_first, first)
    assert int(counts.max()) <= C                       # one byte while C <= 255
    for t in range(2, T, 3):
        if C > 2:                                       # only the subset's channels count
            assert int(counts[:, t].max()) <= (C + 1) // 2

# ---- kernel 3 (the phased-array trigger) and kernel 4 (placement) ----------

def _reals(z, n):
    """The real samples of an inverse real transform's result (fftc::Trace)."""
    return torch.view_as_real(z).reshape(z.shape[0], n) if n % 2 == 0 else z.real


def _fold(X, n_hi, n_dec):
    """fftc::FoldIn: Z_r, r <= n_dec/2, the sum of the bins k = r (mod n_dec)
    of the Hermitian extension of X (Im dropped at DC and n_hi's Nyquist)."""
    R, K = X.shape
    Kh = min(K, n_hi // 2 + 1)
    Z = torch.zeros((R, n_dec // 2 + 1), dtype=X.dtype)
    for r in range(n_dec // 2 + 1):
        for k in range(r, Kh, n_dec):
            Z[:, r] += X[:, k].real if k == 0 or 2 * k == n_hi else X[:, k]
        for j in range(n_dec if r == 0 else n_dec - r, Kh, n_dec):
            if 2 * j != n_hi:
                Z[:, r] += X[:, j].conj()
    return Z


def _decimate(X, n_hi, decim):
    """Kernel 3's decimated trace irfft(X, n_hi)[::decim]: the folded
    spectrum's inverse of n_dec when decim divides n_hi, else the inverse of
    n_hi read at the stride."""
    n_dec = pa_trigger.n_dec_of(n_hi, decim)
    dtype = X.real.dtype
    if n_hi % decim == 0:
        E = _table(n_dec, dtype)
        return _reals(_run(_irfft_pre(_fold(X, n_hi, n_dec), n_dec, E, 1.0 / n_hi),
                           n_dec, E, +1), n_dec)
    Kh = min(X.shape[1], n_hi // 2 + 1)
    return _trace(X[:, :Kh], n_hi, 1.0)[:, ::decim]


def _upsample(q, up):
    """Kernel 3's upsampling: the rfft of n_dec (Im dropped at DC and
    Nyquist), its bins through the inverse real FFT of n_up = n_dec * up,
    times up; up == 1 is q itself."""
    n_dec = q.shape[1]
    if up == 1:
        return q
    n_up = n_dec * up
    Ed, Eu = _table(n_dec, q.dtype), _table(n_up, q.dtype)
    Xq = _rfft_post(_run(_rfft_pre(q, n_dec), n_dec, Ed, -1), n_dec, Ed, n_dec // 2 + 1)
    Xq[:, 0] = Xq[:, 0].real
    if n_dec % 2 == 0:
        Xq[:, n_dec // 2] = Xq[:, n_dec // 2].real
    return _reals(_run(_irfft_pre(Xq, n_up, Eu, 1.0 / n_dec), n_up, Eu, +1), n_up)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_base, n_hi, decim, K", [
    (2048, 5120, 10, 512), (2048, 5120, 10, 1025), (1024, 2560, 10, 513),
    (900, 2250, 10, 451), (1024, 2560, 7, 300), (1000, 2501, 10, 501), (1024, 1024, 4, 513)])
def test_decimation_mirror_matches_dense(n_base, n_hi, decim, K, dtype):
    """The fold (decim divides n_hi; n_dec 512, 256 and the odd 225; n_hi ==
    n_base, where the n_base Nyquist bin is n_hi's) and the general route
    (decim 7 into 2560, decim 10 into the odd 2501) against
    ``fft_plan.decimate_dense`` and the JAX package's matrices."""
    rng = np.random.default_rng(n_hi + decim + K)
    X = _spectrum(rng, 6, K, dtype)
    got = _decimate(X, n_hi, decim)
    assert got.shape == (6, pa_trigger.n_dec_of(n_hi, decim))
    Dd_r, Dd_i = fft_plan.decimate_dense(n_base, n_hi, decim, K, torch.float64,
                                         torch.device("cpu"))
    Xd = X.to(torch.complex128)
    ref = Xd.real @ Dd_r + Xd.imag @ Dd_i
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    _close(got.double(), ref, tol)
    J_r, J_i = (torch.as_tensor(m[:K]) for m in jpipe._decimating_irfft_matrices(n_base, n_hi,
                                                                                   decim))
    _close(got.double(), Xd.real @ J_r + Xd.imag @ J_i, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_dec", [512, 250, 225, 101])
@pytest.mark.parametrize("up", [1, 2, 3])
def test_upsampling_mirror_matches_dense(n_dec, up, dtype):
    """rfft -> inverse real FFT of n_up against ``fft_plan.upsample_dense``
    (and the JAX package's matrix), even and odd n_dec and n_up."""
    rng = np.random.default_rng(n_dec * up)
    q = torch.as_tensor(rng.normal(size=(5, n_dec)), dtype=dtype)
    got = _upsample(q, up)
    assert got.shape == (5, n_dec * up)
    U = fft_plan.upsample_dense(n_dec, up, torch.float64, torch.device("cpu"))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    _close(got.double(), q.double() @ U, tol)
    _close(got.double(), q.double() @ torch.as_tensor(jpipe._fft_upsample_matrix(n_dec, up)),
           tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_int, n_base, K_int, K_place", [
    (512, 2048, 257, 1025), (255, 1000, 128, 400)])
@pytest.mark.parametrize("phase", [True, False])
def test_placement_reduce_mirror_matches_plain(n_int, n_base, K_int, K_place, dtype, phase):
    """Kernel 4's row pipeline in the mirror -- the block-wide OR that skips
    zero rows, the FFT placement, the per-row phase factors, the (shower,
    ray) sum in row order -- against ``placement_reduce_plain`` (the dense
    placement matrices) at the gen2 lengths and an odd n_int."""
    rng = np.random.default_rng(n_int + int(phase))
    G, s2 = 5, 20
    R = G * s2
    V = _spectrum(rng, R, K_int, dtype)
    keep = torch.as_tensor(rng.uniform(size=R) < 0.6)
    keep[:s2] = False                                  # an output row without pulses
    V = torch.where(keep[:, None], V, 0)
    offsets = torch.as_tensor(rng.uniform(0, (n_base - n_int) * 0.5, R), dtype=dtype)
    df = 2.0 / n_base
    kw = dict(s2=s2, df=df, n_int=n_int, n_base=n_base, K_place=K_place, phase=phase)
    ref = torch.complex(*placement.placement_reduce(V.real.contiguous(),
                                                    V.imag.contiguous(), offsets, **kw))
    live = (V != 0).any(dim=1)                         # __syncthreads_or over the bins
    Xb = torch.zeros((R, K_place), dtype=V.dtype)
    Xb[live] = _place(V[live], n_int, n_base, K_place)
    if phase:
        theta = torch.tensor(-2 * math.pi * df, dtype=dtype) * offsets
        k = torch.arange(K_place)
        one = torch.ones((), dtype=dtype)
        Xb = Xb * (torch.polar(one, theta[:, None] * (k // 32 * 32).to(dtype))
                   * torch.polar(one, theta[:, None] * (k % 32).to(dtype)))
    got = torch.zeros((G, K_place), dtype=V.dtype)
    for j in range(s2):
        got = got + Xb[torch.arange(G) * s2 + j]
    assert bool((got[0] == 0).all()) and bool((ref[0] == 0).all())
    _close(got[1:], ref[1:], 20 * TOL[dtype])


def test_pa_trigger_mirror_matches_plain():
    """Kernel 3's whole chain in the mirror, float64 -- the full-rate trace's
    maximum, the folded decimation, the ADC (a division by lsb), the FFT
    upsampling, the beams from the rolled slots, the direct window sums and
    the first frame -- against ``fused_pa_trigger_plain``: decisions and
    frames equal on groups whose best beam power lies more than 1e-9 from
    the threshold, amplitudes rtol 1e-12."""
    rng = np.random.default_rng(21)
    G, C, n_base, n_hi, decim, up, K = 40, 4, 1024, 2560, 10, 2, 400
    window, step, n_bits = 16, 8, 8
    X = _spectrum(rng, G * C, K, torch.float64) * 1e-3
    rolls = phased_array.beam_rolls([-197.0 - i for i in range(C)], [0.0] * C,
                                    phased_array.default_angles, 1.75, 0.5 * up)
    scale_full, scale_dec = 2.0 / math.sqrt(2.0), 5.0 / math.sqrt(2.0)
    dec = _decimate(X, n_hi, decim) * scale_dec
    adc_range = float(dec.std()) * (2 ** n_bits - 1) / 15
    lsb = adc_range / (2 ** n_bits - 1)
    kw = dict(n_base=n_base, n_hi=n_hi, decim=decim, up=up, scale_full=scale_full,
              scale_dec=scale_dec, rolls=rolls, window=window, step=step,
              v_min=-adc_range / 2, lsb=lsb, n_counts=2 ** n_bits, C=C)
    args = (X.real.contiguous(), X.imag.contiguous())
    max_power = pa_trigger.fused_pa_trigger_plain(*args, threshold=1.0, **kw)[3]
    thr = float(torch.quantile(max_power, 0.5)) * 1.001
    pf, pframe, pamp, pmax = pa_trigger.fused_pa_trigger_plain(*args, threshold=thr, **kw)

    amp = _trace(X, n_base, scale_full).abs().amax(dim=1).reshape(G, C)
    counts = torch.clamp(torch.floor((dec + adc_range / 2) / lsb), 0, 2 ** n_bits - 1)
    q = (counts + math.floor(-adc_range / 2 / lsb)) * lsb
    upt = _upsample(q, up).reshape(G, C, -1)
    n_up = upt.shape[-1]
    nf = (n_up - window) // step
    m = torch.arange(n_up)
    fired = torch.zeros(G, dtype=torch.bool)
    first = torch.full((G,), nf)
    for b in range(len(rolls)):
        beam = sum(upt[:, c, (m - int(rolls[b, c]) % n_up) % n_up] for c in range(C))
        pw = beam * beam
        sums = torch.stack([pw[:, f * step:f * step + window].sum(dim=1) for f in range(nf)], 1)
        above = sums / window > thr
        fired |= above.any(dim=1)
        first = torch.minimum(first, torch.where(above.any(dim=1),
                                                 torch.argmax(above.to(torch.int8), dim=1), nf))
    solid = (pmax - thr).abs() / thr > 1e-9
    assert int(solid.sum()) >= G - 1 and 0 < int(pf[solid].sum()) < int(solid.sum())
    assert torch.equal(fired[solid], pf[solid])
    both = solid & pf
    assert torch.equal(first[both].to(torch.int32), pframe[both])
    torch.testing.assert_close(amp, pamp, rtol=1e-12, atol=0)
