"""nuradiomc_tpu_torch — the PyTorch + CUDA port of ``nuradiomc_tpu``.

The package mirrors the JAX package's layout so each module's counterpart is
easy to find:

``utils``   fft conventions, geometry
``models``  ice models
``ops``     ray tracing (with implicit focusing), attenuation, Askaryan
            (Alvarez2000, Alvarez2009), antenna, trace, noise, trigger ADC,
            phased array, triggers, and the three hand-written Hopper
            kernels (``ops/placement.py``, ``ops/trigger_fused.py``,
            ``ops/pa_trigger.py``, sources in ``csrc/``)
``sim``     the batched pipeline, the ``Simulation`` orchestrator and the
            h5py-free ``.npz`` event-list input (``sim/io_input.py``)
``data``    the ``.npz`` export of the 3000-event 1e18 eV input

It imports ``torch`` and never ``jax``. From ``nuradiomc_tpu`` it imports only
modules that are jax-free themselves (detector, HDF5 I/O, weights, units,
config, filters). Importing this package builds no kernel: a kernel is built
on its first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
