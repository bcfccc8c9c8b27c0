"""The traffic generator: the existing mixes draw the lists they drew before
lepton secondaries came in (pinned digests), and a mix that asks for
secondaries draws the port's list, column for column."""

import numpy as np
import pytest

from portbench import harness
from portbench.traffic import generator

# list_digest of lists 0-2 of a run, before the generator took secondaries
PINNED = {
    ("nu_1e18", 5): ["a7260aa10bb669746b78d0246de8b90d76e07a8e",
                     "bcacf9bd5c1278b66baebdd02f9b43e974c0623c",
                     "f98d0ce6d608c3768b4d0429f71ed6930541410f"],
    ("nu_1e18", 3000000000): ["2ca02bf8d94cce3da1da1b4aad132ca9a4511ebc",
                              "8bdeb8058ddd5f50658840905a7b6167cea1cf24",
                              "ac0f02d6fef9d095b440d44c27fc9a9e9dbd8cdd"],
    ("nu_1e18_noise", 5): ["40323d0a52ed3c1cbe583f6baeaee6eb8ca201e0",
                           "fd0af47a09370f15dd7fc13d3eb8a0e3722ecb3c",
                           "effd453c6a5c795ca04cb5a79b53a6432d534151"],
    ("nu_1e18_noise", 3000000000): ["81ef51a02130f12784f02f754760d15d4f7abcf5",
                                    "a923eca7530c81d0eee722298fb5e0b251f151fe",
                                    "d20570cde19528b0ac4f6818fd8f3495cd0bc552"],
}


@pytest.mark.parametrize("mix, seed, job", [(m, s, k) for (m, s) in PINNED for k in range(3)])
def test_existing_mixes_draw_the_same_lists(mix, seed, job):
    data, attrs = generator.make_list(harness.load_mix(mix), seed, job)
    assert generator.list_digest(data) == PINNED[mix, seed][job]


@pytest.mark.parametrize("seed", [5, 3000000000])
def test_secondaries_match_the_port(seed):
    """The mix's list at a small size equals the port's generator with
    ``secondaries="stochastic"`` on the same seed, every column."""
    from nuradiomc_tpu_torch.sim import evtgen
    from nuradiomc_tpu_torch.utils import units
    mix = {**harness.load_mix("nutau_1e19_secondaries"), "events_per_job": 600}
    ours, attrs = generator.make_list(mix, seed, 1)
    g = mix["generator"]
    volume = {k: float(v) * units.m for k, v in g["volume_m"].items()}
    port, port_attrs = evtgen.generate_eventlist_cylinder(
        None, 600, g["energy_eV"], g["energy_eV"], volume, flavor=tuple(g["flavors"]),
        interaction_type=g["interaction_type"], seed=generator.job_seed(seed, 1),
        secondaries="stochastic")
    assert sorted(ours) == sorted(port)
    for key in port:
        assert ours[key].dtype == port[key].dtype, key
        np.testing.assert_array_equal(ours[key], port[key], err_msg=key)
    assert attrs["volume"] == port_attrs["volume"]
    # the secondaries are there: groups of several showers, later in time
    _, counts = np.unique(ours["event_group_ids"], return_counts=True)
    assert counts.max() >= 4 and len(ours["xx"]) > 600
    assert np.max(ours["vertex_times"]) > 0


def test_unknown_secondaries_are_refused():
    mix = harness.load_mix("nu_1e18_noise")
    mix = {**mix, "events_per_job": 10, "generator": {**mix["generator"], "secondaries": "proposal"}}
    with pytest.raises(ValueError, match="secondaries"):
        generator.make_list(mix, 1, 0)
