"""nuradiomc_tpu_torch — the PyTorch + CUDA port of ``nuradiomc_tpu``.

The package mirrors the JAX package's layout so each module's counterpart is
easy to find:

``utils``     units, constants, layered config, fft conventions, geometry
``models``    ice models
``detector``  the JSON detector description
``framework`` the event data model (Event, Station, Channel, Trigger,
              Shower, BaseTrace) that the ``.nur`` files carry
``ops``       ray tracing (with implicit focusing), attenuation, Askaryan
              (Alvarez2000, Alvarez2009), antenna, filters, trace, noise,
              trigger ADC, phased array, birefringence, triggers, the FFT
              tables of the kernels (``ops/fft_plan.py``) and the four
              hand-written Hopper kernels (``ops/placement.py``,
              ``ops/trigger_fused.py``, ``ops/pa_trigger.py``, sources in
              ``csrc/``)
``sim``       the event generator (``sim/evtgen.py``, with fluxes, cross
              sections and the muon/tau propagator), the batched pipeline,
              the ``Simulation`` orchestrator, Earth attenuation weights,
              HDF5 I/O, the h5py-free event-list input (``sim/io_input.py``:
              ``.npz`` exports and lists generated in memory), the ``.nur``
              waveform files (``sim/io_nur.py``), the Veff and Aeff tables
              (``sim/veff.py``), the surface-muon generator and flux
              (``sim/muon_flux.py``) and the job runner (``sim/runner.py``)
``parallel``  the ``(event, channel)`` process mesh on ``torch.distributed``
              (``parallel/mesh.py``) and multi-process runs with the
              sharded-equals-single dryrun (``parallel/dryrun.py``)
``reco``      NuRadioReco's in-ice reconstruction modules (channel
              processing, efield converters, direction fitters, vertex,
              neutrino direction, IFT unfolding, trigger and RNO-G modules),
              each module's array work on its ``device``; with
              ``sim/io_nur_reference.py`` for NuRadioReco's own ``.nur``
``data``      the ``.npz`` exports of the 3000-event 1e18 eV input and the
              Gen2 tau input, the flux tables, the birefringence ice models
              and the reference values ``chip_smoke.py`` compares with

It imports ``torch``, numpy, scipy, yaml and the standard library (h5py only
inside the functions that read or write HDF5), and nothing of ``jax`` or of
``nuradiomc_tpu``: what it shares with the JAX package it keeps as its own
copy, each marked with the file and lines it was copied from. Its entry
points (``Simulation``, ``convert.from_jax``, ``convert.make_*_inputs``,
every ``reco`` module) run on the CUDA card unless the caller passes
``device="cpu"``. Importing
this package builds no kernel: a kernel is built on its first launch on a
CUDA tensor.
"""

__version__ = "0.1.0"
