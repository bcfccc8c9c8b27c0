"""A simple MC reconstruction chain.

Counterpart of ``examples/03_reconstruction/simple_reconstruction.py``
(NuRadioReco's examples/SimpleMCReconstruction.py): station 42's two
channels (``reco.examples.SIMPLE_DETECTOR``) and its band-limited efield at
(60, 30) deg (``reco.examples.simple_event``) folded to voltages, Rayleigh
noise (numpy seed 42, drawn on the host), a 100-500 MHz band-pass, the
channel observables, and the efield unfolded back from both channels; each
module's array work on the device, float64::

    python -m nuradiomc_tpu_torch.examples.e03_reconstruction.simple_reconstruction
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.framework import event as fev, parameters as par
from nuradiomc_tpu_torch.reco import channel_processing as cp
from nuradiomc_tpu_torch.reco import efield_converters as ec
from nuradiomc_tpu_torch.reco import examples


def main(argv=None, *, device=None, dtype=None, outdir="."):
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    device, _ = _common.setup(args, device, dtype, None, outdir)
    det = Detector(examples.SIMPLE_DETECTOR)
    evt, station = examples.simple_event(fev, par)
    conv = ec.efieldToVoltageConverter(device=device)
    conv.begin()
    conv.run(evt, station, det)
    noise = cp.channelGenericNoiseAdder(device=device)
    noise.begin(seed=42)
    noise.run(evt, station, det, amplitude=1e-6, type="rayleigh")
    bp = cp.channelBandPassFilter(device=device)
    bp.run(evt, station, det, passband=[0.1, 0.5], filter_type="butter", order=4)
    rec = cp.channelSignalReconstructor(device=device)
    rec.begin()
    rec.run(evt, station, det)
    channels = {}
    for cid in det.get_channel_ids(42):
        ch = station.get_channel(cid)
        amp = ch[par.channelParameters.maximum_amplitude]
        snr = ch[par.channelParameters.SNR]["peak_amplitude"]
        channels[cid] = (float(amp), float(snr))
        print(f"channel {cid}: max amp = {amp:.3e} V, SNR(peak) = {snr:.1f}")
    unfold = ec.voltageToEfieldConverter(device=device)
    unfold.begin()
    unfold.run(evt, station, det, use_channels=[0, 1])
    spec = station.get_electric_fields()[-1].get_frequency_spectrum()
    ratio = float(np.sum(np.abs(spec[2]) ** 2) / np.sum(np.abs(spec[1]) ** 2))
    print("reconstructed efield fluence ratio (phi/theta):", ratio)
    return {"channels": channels, "ratio": ratio, "spectrum": np.asarray(spec),
            "traces": [np.asarray(station.get_channel(c).get_trace()) for c in (0, 1)]}


if __name__ == "__main__":
    main()
