"""Kernel 3 at a large phased array: the plain version of
``ops/pa_trigger.py`` at C 64 channels (n_up 1024, 11 beams), the size that
needs a thread-block cluster on the card (``csrc/pa_trigger.cu``: a group's
64 upsampled traces do not fit one block's shared memory), against the JAX
package's ``pa_pallas.fused_pa_trigger`` in interpret mode, as
tests/test_pa_pallas.py runs it, on the CPU.

Rules of tests/test_torch_pa_ops.py (test_pa_pallas.py's): decisions equal on
groups whose best beam power lies more than 1e-4 from the threshold, first
frames equal where both fire, amplitudes rtol 1e-5 (float32 products in
another order). The kernel itself is held to this plain version on the card
(tests/test_torch_gpu.py, ``chip_smoke.py`` phase 2).
"""

import jax.numpy as jnp
import numpy as np
import torch

from nuradiomc_tpu.ops import phased_array as jpa
from nuradiomc_tpu.ops.pa_pallas import fused_pa_trigger as jax_fused_pa_trigger
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu_torch.ops import pa_trigger

torch.set_num_threads(1)


def test_fused_pa_plain_matches_pallas_at_64_channels():
    rng = np.random.RandomState(64)
    G, C = 6, 64
    n_base, fs, fs_hi = 2048, 2.0, 5.0
    adc_fs, nbits, up = 0.5, 8, 2
    window, step, adc_range = 16, 8, 0.04
    n_hi, decim = int(round(n_base * fs_hi / fs)), int(round(fs_hi / adc_fs))
    F = n_base // 2 + 1
    spec = (rng.randn(G * C, F) + 1j * rng.randn(G * C, F)).astype(np.complex64) * 1e-3
    I_r, I_i = jpipe._irfft_matrices(n_base)
    Dd_r, Dd_i = jpipe._decimating_irfft_matrices(n_base, n_hi, decim)
    U = jpipe._fft_upsample_matrix(Dd_r.shape[1], up)
    assert U.shape[1] == 1024
    rolls = jpa.beam_rolls([-197.0 - i for i in range(C)], [0.0] * C, jpa.default_angles,
                           1.75, adc_fs * up)
    assert rolls.shape == (11, C)
    kw = dict(scale_full=fs / np.sqrt(2.0), scale_dec=fs_hi / np.sqrt(2.0), rolls=rolls,
              window=window, step=step, v_min=-adc_range / 2,
              lsb=adc_range / (2 ** nbits - 1), n_counts=2 ** nbits, C=C)
    targs = [torch.as_tensor(a.astype(np.float32)) for a in (spec.real, spec.imag)]
    lengths = dict(n_base=n_base, n_hi=n_hi, decim=decim, up=up)
    *_, max_power = pa_trigger.fused_pa_trigger_plain(*targs, threshold=1.0, **lengths, **kw)
    max_power = max_power.numpy()
    for q in (0.3, 0.7):
        thr = float(np.quantile(max_power, q)) * 1.001
        fired, frame, amp = (np.asarray(a) for a in jax_fused_pa_trigger(
            jnp.asarray(spec.real), jnp.asarray(spec.imag), I_r, I_i, Dd_r, Dd_i, U,
            threshold=thr, row_tile=2 * C, **kw))
        pf, pframe, pamp = (a.numpy() for a in pa_trigger.fused_pa_trigger(
            *targs, threshold=thr, **lengths, **kw))   # CPU tensors: the plain version
        assert pamp.shape == (G, C)
        solid = np.abs(max_power - thr) / thr > 1e-4
        assert solid.sum() >= G - 1
        np.testing.assert_array_equal(pf[solid], fired[solid])
        both = solid & pf & fired
        assert both.any() and not pf[solid].all()
        np.testing.assert_array_equal(pframe[both], frame[both])
        assert np.all(pframe[~pf] == 0)
        np.testing.assert_allclose(pamp, amp, rtol=1e-5)
