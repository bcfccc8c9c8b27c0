# copied from nuradiomc_tpu/framework/parameters.py:1-197 (the port keeps its own copy; it imports nothing of the JAX package)
"""Parameter enums of the event data model.

Mirrors NuRadioReco/framework/parameters.py:12-258 — the enum names are the
public API contract used by modules and the HDF5/event writers.
"""

from enum import Enum, auto


class stationParameters(Enum):
    nu_zenith = auto()
    nu_azimuth = auto()
    nu_energy = auto()
    nu_flavor = auto()
    ccnc = auto()
    nu_vertex = auto()
    inelasticity = auto()
    triggered = auto()
    cr_energy = auto()
    cr_zenith = auto()
    cr_azimuth = auto()
    channels_max_amplitude = auto()
    zenith = auto()
    azimuth = auto()
    zenith_cr_templatefit = auto()
    zenith_nu_templatefit = auto()
    cr_xcorrelations = auto()
    nu_xcorrelations = auto()
    station_time = auto()
    beam_direction = auto()
    cr_energy_em = auto()
    nu_inttype = auto()
    chi2_efield_time_direction_fit = auto()
    ndf_efield_time_direction_fit = auto()
    cr_xmax = auto()
    vertex_2D_fit = auto()
    distance_correlations = auto()
    shower_energy = auto()
    viewing_angles = auto()
    flagged_channels = auto()
    dirty_fft_channels = auto()
    cr_dominant_polarisation = auto()


class channelParameters(Enum):
    zenith = auto()
    azimuth = auto()
    maximum_amplitude = auto()
    SNR = auto()
    maximum_amplitude_envelope = auto()
    P2P_amplitude = auto()
    cr_xcorrelations = auto()
    nu_xcorrelations = auto()
    signal_time = auto()
    noise_rms = auto()
    signal_regions = auto()
    noise_regions = auto()
    signal_time_offset = auto()
    signal_receiving_zenith = auto()
    signal_ray_type = auto()
    signal_receiving_azimuth = auto()
    block_offsets = auto()
    glitch = auto()
    impulsivity = auto()
    entropy = auto()
    kurtosis = auto()


class stationParametersRNOG(Enum):
    coherent_snr = auto()
    coherent_impulsivity = auto()
    coherent_entropy = auto()
    coherent_kurtosis = auto()


class electricFieldParameters(Enum):
    ray_path_type = auto()
    polarization_angle = auto()
    polarization_angle_expectation = auto()
    signal_energy_fluence = auto()
    cr_spectrum_slope = auto()
    zenith = auto()
    azimuth = auto()
    signal_time = auto()
    nu_vertex_distance = auto()
    nu_vertex_propagation_time = auto()
    nu_viewing_angle = auto()
    max_amp_antenna = auto()
    max_amp_antenna_envelope = auto()
    reflection_coefficient_theta = auto()
    reflection_coefficient_phi = auto()
    cr_spectrum_quadratic_term = auto()
    energy_fluence_ratios = auto()
    launch_vector = auto()
    raytracing_solution = auto()


class showerParameters(Enum):
    zenith = auto()
    azimuth = auto()
    energy = auto()
    flavor = auto()
    interaction_type = auto()
    vertex = auto()
    vertex_time = auto()
    type = auto()
    electromagnetic_energy = auto()
    electromagnetic_radiation_energy = auto()
    radiation_energy = auto()
    primary_particle = auto()
    shower_maximum = auto()
    distance_shower_maximum_geometric = auto()
    refractive_index_at_ground = auto()
    magnetic_field_vector = auto()
    magnetic_field_rotation = auto()
    atmospheric_model = auto()
    observation_level = auto()
    charge_excess_profile_id = auto()
    k_L = auto()
    core = auto()
    interferometric_shower_maximum = auto()


class emitterParameters(Enum):
    position = auto()
    model = auto()
    amplitude = auto()
    polarization = auto()
    emitter_frequency = auto()
    half_width = auto()
    realization_id = auto()
    antenna_type = auto()
    orientation_phi = auto()
    orientation_theta = auto()
    rotation_phi = auto()
    rotation_theta = auto()
    time = auto()


class ARIANNAParameters(Enum):
    """ARIANNA data-taking parameters (parameters.py:118-126). The reference
    now stores these in the station's generic ``_parameters`` dict (its
    separate set/get_ARIANNA_parameter API is deprecated, base_station.py:
    309-357) — we do the same."""

    seq_start_time = auto()
    seq_stop_time = auto()
    seq_num = auto()
    comm_period = auto()
    comm_duration = auto()
    trigger_thresholds = auto()
    l1_supression_value = auto()
    internal_clock_time = auto()


class particleParameters(Enum):
    parent_id = auto()
    zenith = auto()
    azimuth = auto()
    energy = auto()
    flavor = auto()
    interaction_type = auto()
    vertex = auto()
    vertex_time = auto()
    inelasticity = auto()
    weight = auto()
    cc_nc = auto()
    n_interaction = auto()


class generatorAttributes(Enum):
    Emin = auto()
    Emax = auto()
    phimin = auto()
    phimax = auto()
    thetamin = auto()
    thetamax = auto()
    flavors = auto()
    n_events = auto()
    fiducial_rmin = auto()
    fiducial_rmax = auto()
    fiducial_zmin = auto()
    fiducial_zmax = auto()
    rmin = auto()
    rmax = auto()
    zmin = auto()
    zmax = auto()
    volume = auto()
    area = auto()
    start_event_id = auto()
    deposited = auto()


class eventParameters(Enum):
    sim_config = auto()
    hash_NuRadioMC = auto()
    hash_NuRadioReco = auto()
