"""The repository's example workflows (``examples/``) on the port.

One subpackage per example directory (``e01_veff_simulation`` for
``examples/01_Veff_simulation``, ...), one module per JAX script, each with
``main(argv=None, *, device=None, dtype=None, outdir=".") -> dict``: it takes
the JAX script's arguments and defaults, prints what the JAX script prints,
returns the numbers it prints, writes its files into ``outdir``, and runs on
the card unless ``device="cpu"`` (or ``--device cpu``) is given::

    python -m nuradiomc_tpu_torch.examples.e01_veff_simulation.t01_generate_event_list

``EXAMPLES`` lists them in the order their files chain (01's event list
feeds 02 and 09; the webinar's steps follow each other): name -> (module,
a small argv for a quick run, the argv of the JAX script's default run).
The modules of one directory, and 02 and 09 after 01, share ``outdir``.
Where h5py or matplotlib is missing an example says which route it took
(``_common.py``).
"""

import importlib

_P = "nuradiomc_tpu_torch.examples."
EXAMPLES = {
    "e01_t01": (_P + "e01_veff_simulation.t01_generate_event_list", ["300"], []),
    "e01_t02": (_P + "e01_veff_simulation.t02_run_simulation", [], []),
    "e01_t03": (_P + "e01_veff_simulation.t03_visualize_veff", [], []),
    "e02": (_P + "e02_phased_array.run_pa_veff", [], []),
    "e09": (_P + "e09_threshold_ladder.run_ladder", [], []),
    "e13_w01": (_P + "e13_webinar.w01_create_input", ["150"], []),
    "e13_w02": (_P + "e13_webinar.w02_run_simulation",
                ["--outputfilenameNuRadioReco", "results/NuMC_output.nur"],
                ["--outputfilenameNuRadioReco", "results/NuMC_output.nur"]),
    "e13_w03": (_P + "e13_webinar.w03_check_output", [], []),
    "e13_w04": (_P + "e13_webinar.w04_effective_volumes", [], []),
    "e13_w05": (_P + "e13_webinar.w05_electric_fields", [], []),
    "e10_a01": (_P + "e10_pulser_calibration.a01_generate_pulser_events", ["12"], []),
    "e10_a02": (_P + "e10_pulser_calibration.a02_run_simulation", [], []),
    "e11_a01": (_P + "e11_station_coincidences.a01_create_detector", ["900"], []),
    "e11_a02": (_P + "e11_station_coincidences.a02_run_and_analyze", ["150"], []),
    "e05": (_P + "e05_multichip.run_sharded_veff", ["60", "--procs", "4"], []),
    "e08": (_P + "e08_interop.run_interop", ["100"], []),
    "e15": (_P + "e15_custom_generator.generate_my_events", [], []),
    "e12": (_P + "e12_sensitivities.e2_fluxes", [], []),
    "e06": (_P + "e06_rno_g_station.run_rnog_station", ["120"], []),
    "e07": (_P + "e07_snr_curves.run_snr_curves", ["60"], []),
    "e14": (_P + "e14_alias_phased_array.run_alias_snr", ["40"], []),
    "e03": (_P + "e03_reconstruction.simple_reconstruction", [], []),
    "e04": (_P + "e04_vertex_direction_reco.run_reco_chain",
            ["--grid", "20", "--vertex-steps", "12", "--direction-steps", "5",
             "--direction-zooms", "1"], []),
}


def main_of(name):
    """The ``main`` of the example ``name``."""
    return importlib.import_module(EXAMPLES[name][0]).main
