"""CoREAS / CORSIKA-7 air-shower input pipeline (port).

Counterpart of ``nuradiomc_tpu/sim/io_coreas.py`` (NuRadioReco/modules/io/
coreas/coreas.py): angle conventions (get_angles:48), CGS -> SI field
strength (:24), observer efields into the on-sky CS
(convert_obs_to_nuradio_efield:138-184), observer positions
(convert_obs_positions_to_nuradio_on_ground:186-222), the star-shape Voronoi
weights and a star-shape interpolator for arbitrary antenna positions.

Host numpy, like the file it reads. The conversion of a file's content,
:func:`coreas_event`, takes any h5py-shaped mapping (``inputs.attrs``,
``CoREAS.attrs`` and ``CoREAS/observers/*``, each an (n_t, 4) array with
``.attrs["position"]``); :func:`read_CORSIKA7` opens an HDF5 file (h5py is
imported there) and hands it over, and ``convert.make_coreas_star`` builds
such a mapping in memory where there is no h5py. The interpolator keeps
scipy's ``LinearNDInterpolator`` / ``NearestNDInterpolator`` on the host
and scales the nearest observer pulses of many positions at once on a
device (:meth:`coreasInterpolator.get_interp_efields`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import (ElectricField, Event, SimStation, Shower,
                                                 Station)
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import units

# copied from nuradiomc_tpu/sim/io_coreas.py:22-363, the file reader split at
# read_CORSIKA7 and the batched interpolation added
# 1 statvolt/cm = c * 1e-4 uV/m in the CoREAS convention (coreas.py:24)
conversion_fieldstrength_cgs_to_SI = 2.99792458e10 * units.micro * units.volt / units.meter

efp = par.electricFieldParameters
shp = par.showerParameters
stnp = par.stationParameters


def _normalized_angle(angle):
    return np.mod(angle, 2 * np.pi)


def _spherical_to_cartesian(zenith, azimuth):
    return np.array([np.sin(zenith) * np.cos(azimuth),
                     np.sin(zenith) * np.sin(azimuth),
                     np.cos(zenith)])


def _onsky_basis(zenith, azimuth):
    st, ct = np.sin(zenith), np.cos(zenith)
    sp, cp = np.sin(azimuth), np.cos(azimuth)
    e_r = np.array([st * cp, st * sp, ct])
    e_theta = np.array([ct * cp, ct * sp, -st])
    e_phi = np.array([-sp, cp, 0.0])
    return np.array([e_r, e_theta, e_phi])


def get_angles(corsika, declination=0.0):
    """(zenith, azimuth, magnetic_field_vector) in NRR conventions
    (coreas.get_angles:48-115)."""
    zenith = corsika["inputs"].attrs["THETAP"][0] * units.deg
    azimuth = _normalized_angle(
        3 * np.pi / 2.0 + np.deg2rad(corsika["inputs"].attrs["PHIP"][0]) - declination)
    By, minBz = corsika["inputs"].attrs["MAGNET"]
    B_inclination = np.arctan2(minBz, By)
    B_strength = np.sqrt(By ** 2 + minBz ** 2) * units.micro * units.tesla
    magnetic_field_vector = B_strength * _spherical_to_cartesian(
        np.pi / 2 + B_inclination, np.pi / 2 - declination)
    return zenith, azimuth, magnetic_field_vector


def _magnetic_to_geographic(v, magnetic_field_vector):
    """Rotate about z so magnetic north maps to geographic north.

    The declination is the azimuth offset of the horizontal B component from
    geographic north (radiotools cstrafo.transform_from_magnetic_to_geographic
    semantics).
    """
    dec = np.arctan2(magnetic_field_vector[0], magnetic_field_vector[1])
    c, s = np.cos(dec), np.sin(dec)
    R = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return R @ v


def convert_obs_to_nuradio_efield(observer, zenith, azimuth, magnetic_field_vector):
    """CoREAS observer (n, 4: t, Ey, -Ex, Ez columns in CGS) -> on-sky efield
    (coreas.convert_obs_to_nuradio_efield:138-184)."""
    efield_times = observer[:, 0] * units.second
    efield = np.array([
        -observer[:, 2],   # CORSIKA y points West
        observer[:, 1],
        observer[:, 3],
    ]) * conversion_fieldstrength_cgs_to_SI
    efield_geo = _magnetic_to_geographic(efield, magnetic_field_vector)
    efield_onsky = _onsky_basis(zenith, azimuth) @ efield_geo
    return efield_onsky, efield_times


def convert_obs_positions_to_nuradio_on_ground(observer_pos, declination=0.0):
    """CORSIKA observer position (cm, magnetic CS) -> NRR ground CS (m)
    (coreas.convert_obs_positions_to_nuradio_on_ground:186-222)."""
    observer_pos = np.atleast_2d(observer_pos)
    pos = np.array([
        -observer_pos[:, 1],
        observer_pos[:, 0],
        observer_pos[:, 2],
    ]) * units.cm
    c, s = np.cos(-declination), np.sin(-declination)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return np.squeeze((R @ pos).T)


def read_CORSIKA7(input_file, declination=0.0):
    """Read a CORSIKA-7/CoREAS HDF5 file into an Event with a SimStation
    holding one on-sky ElectricField per observer (coreas.read_CORSIKA7:223);
    needs h5py."""
    import h5py

    with h5py.File(input_file, "r") as corsika:
        return coreas_event(corsika, declination)


def read_coreas(source, declination=0.0):
    """:func:`read_CORSIKA7` of a path, :func:`coreas_event` of a mapping."""
    if isinstance(source, (str, os.PathLike)):
        return read_CORSIKA7(source, declination)
    return coreas_event(source, declination)


def coreas_event(corsika, declination=0.0):
    """The Event of :func:`read_CORSIKA7` from an h5py-shaped mapping of a
    CoREAS file's content (coreas.read_CORSIKA7:223-401)."""
    zenith, azimuth, magnet = get_angles(corsika, declination)
    energy = corsika["inputs"].attrs["ERANGE"][0] * units.GeV

    evt = Event(corsika["inputs"].attrs.get("RUNNR", 0),
                corsika["inputs"].attrs.get("EVTNR", 0))
    station = Station(0)
    sim_station = SimStation(0)
    sim_station.set_is_cosmic_ray()

    sampling_rate = None
    for idx, (name, observer) in enumerate(corsika["CoREAS"]["observers"].items()):
        data = np.asarray(observer)
        efield_onsky, times = convert_obs_to_nuradio_efield(
            data, zenith, azimuth, magnet)
        pos = convert_obs_positions_to_nuradio_on_ground(
            np.asarray(observer.attrs["position"]), declination)
        if len(times) > 1:
            sampling_rate = 1.0 / (times[1] - times[0])
        n = len(times) - (len(times) % 2)
        ef = ElectricField([idx], position=pos)
        ef.set_trace(efield_onsky[:, :n], sampling_rate)
        ef.set_trace_start_time(times[0])
        ef[efp.zenith] = zenith
        ef[efp.azimuth] = azimuth
        sim_station.add_electric_field(ef)

    shower = Shower(0)
    shower[shp.zenith] = zenith
    shower[shp.azimuth] = azimuth
    shower[shp.energy] = energy
    shower[shp.magnetic_field_vector] = magnet

    # simulation-input shower parameters when present in the file
    # (coreas.create_sim_shower_from_hdf5:317-401)
    inp = corsika["inputs"].attrs
    if "PRMPAR" in inp:
        shower[shp.primary_particle] = inp["PRMPAR"]
    if "OBSLEV" in inp:
        shower[shp.observation_level] = inp["OBSLEV"] * units.cm
    if "ATMOD" in inp:
        shower[shp.atmospheric_model] = inp["ATMOD"]
    if "CoREAS" in corsika:
        ca = corsika["CoREAS"].attrs
        if "CoreCoordinateWest" in ca:
            shower[shp.core] = np.array([
                -ca["CoreCoordinateWest"],
                ca["CoreCoordinateNorth"],
                ca["CoreCoordinateVertical"]]) * units.cm
        if "DepthOfShowerMaximum" in ca:
            shower[shp.shower_maximum] = (
                ca["DepthOfShowerMaximum"] * units.g / units.cm2)
        if "DistanceOfShowerMaximum" in ca:
            shower[shp.distance_shower_maximum_geometric] = (
                ca["DistanceOfShowerMaximum"] * units.cm)
        if "GroundLevelRefractiveIndex" in ca:
            shower[shp.refractive_index_at_ground] = (
                ca["GroundLevelRefractiveIndex"])
        if "RotationAngleForMagfieldDeclination" in ca:
            shower[shp.magnetic_field_rotation] = (
                ca["RotationAngleForMagfieldDeclination"] * units.degree)
    if "highlevel" in corsika and "Eem" in corsika["highlevel"].attrs:
        shower[shp.electromagnetic_energy] = (
            corsika["highlevel"].attrs["Eem"] * units.eV)

    evt.add_sim_shower(shower)
    station.set_sim_station(sim_station)
    evt.set_station(station)
    return evt


def get_geomagnetic_angle(zenith, azimuth, magnetic_field_vector):
    """Angle between shower propagation direction and the magnetic field
    (coreas.get_geomagnetic_angle:114-136)."""
    v = -_spherical_to_cartesian(zenith, azimuth)  # propagation direction
    B = np.asarray(magnetic_field_vector, dtype=float)
    return np.arccos(np.clip(
        np.dot(v, B) / (np.linalg.norm(v) * np.linalg.norm(B)), -1.0, 1.0))


def create_sim_shower(evt, core_shift=None):
    """Copy the first SimShower of a read_CORSIKA7 event, optionally shifting
    the core (coreas.create_sim_shower:404-428)."""
    import copy

    sim_shower = copy.deepcopy(evt.get_first_sim_shower())
    if core_shift is not None:
        core = sim_shower[shp.core] if shp.core in sim_shower.get_parameters() \
            else np.zeros(3)
        sim_shower[shp.core] = np.asarray(core, dtype=float) + np.asarray(core_shift)
    return sim_shower


def create_sim_station(station_id, evt, weight=None):
    """Empty SimStation carrying the CR parameters of a read_CORSIKA7 event
    (coreas.create_sim_station:431-486)."""
    coreas_shower = evt.get_first_sim_shower()
    coreas_sim_station = evt.get_station(0).get_sim_station()

    sim_station = SimStation(station_id)
    sim_station[stnp.azimuth] = coreas_shower[shp.azimuth]
    sim_station[stnp.zenith] = coreas_shower[shp.zenith]
    sim_station[stnp.cr_energy] = coreas_shower[shp.energy]
    if shp.shower_maximum in coreas_shower.get_parameters():
        sim_station[stnp.cr_xmax] = coreas_shower[shp.shower_maximum]
    sim_station.set_magnetic_field_vector(
        coreas_shower[shp.magnetic_field_vector])
    if shp.electromagnetic_energy in coreas_shower.get_parameters():
        sim_station[stnp.cr_energy_em] = coreas_shower[shp.electromagnetic_energy]
    if coreas_sim_station.is_cosmic_ray():
        sim_station.set_is_cosmic_ray()
    sim_station.set_simulation_weight(weight)
    return sim_station


def add_electric_field_to_sim_station(sim_station, channel_ids, efield,
                                      efield_start_time, zenith, azimuth,
                                      sampling_rate, efield_position=None):
    """Attach a (3, n) efield trace to a SimStation
    (coreas.add_electric_field_to_sim_station:489-528)."""
    if not isinstance(channel_ids, (list, tuple)):
        channel_ids = [channel_ids]
    ef = ElectricField(list(channel_ids), position=efield_position)
    ef.set_trace(np.asarray(efield), sampling_rate)
    ef.set_trace_start_time(efield_start_time)
    ef[efp.ray_path_type] = "direct"
    ef[efp.zenith] = zenith
    ef[efp.azimuth] = azimuth
    sim_station.add_electric_field(ef)


def calculate_simulation_weights(positions, zenith, azimuth, site="summit",
                                 debug=False):
    """Voronoi-cell area per observer of a star-shape pattern, computed in
    the shower plane (symmetry) and projected back onto the ground
    (coreas.calculate_simulation_weights:531-630). The outermost observer of
    each of the 8 star arms gets weight 0 (its Voronoi cell is unbounded)."""
    import scipy.spatial as spatial

    from nuradiomc_tpu_torch.reco.advanced import MAGNETIC_FIELD_VECTORS
    from nuradiomc_tpu_torch.reco.rit import shower_frame

    positions = np.asarray(positions, dtype=float)
    e1, e2, v = shower_frame(zenith, azimuth, MAGNETIC_FIELD_VECTORS[site])
    basis = np.array([e1, e2, v])                 # to-shower-plane rows
    shower = positions @ basis.T                  # (n, 3) in (vxB, vxvxB, v)

    vor = spatial.Voronoi(shower[:, :2])

    # ground-plane normal in shower coordinates: project cell vertices back
    # onto z_ground = 0 through the basis columns (coreas.py:562-588)
    col3 = basis[:, 2]  # ground-z components of the three shower axes
    weights = np.zeros(len(positions))
    n_arms = 8
    length_shower = np.hypot(shower[:, 0], shower[:, 1])
    outer = np.argpartition(length_shower, -n_arms)[-n_arms:]
    for p in range(len(positions)):
        region = vor.regions[vor.point_region[p]]
        if -1 in region or len(region) == 0:
            weights[p] = 0.0
            continue
        vert2d = vor.vertices[region]
        # z in the shower plane s.t. the ground z-component vanishes
        zv = -(col3[0] * vert2d[:, 0] + col3[1] * vert2d[:, 1]) / col3[2]
        vert3d = np.column_stack([vert2d, zv])
        vert_ground = vert3d @ basis              # back to ground CS
        hull = spatial.ConvexHull(vert_ground[:, :2])
        weights[p] = hull.volume                  # 2d hull volume == area
    weights[outer] = 0.0
    return weights


def set_fluence_of_efields(function, sim_station,
                           quantity=efp.signal_energy_fluence):
    """Apply `function` to every efield trace of the SimStation and store the
    result as `quantity` (coreas.set_fluence_of_efields:632-651)."""
    for ef in sim_station.get_electric_fields():
        ef[quantity] = function(np.asarray(ef.get_trace()))


class coreasInterpolator:
    """Star-shape efield/fluence interpolation to arbitrary positions in the
    shower plane (coreasInterpolator.py:19-394 capability; fluence via linear
    barycentric interpolation, pulse shape from the nearest simulated
    observer, scaled to the interpolated fluence)."""

    def __init__(self, event: Event):
        self._efields = list(event.get_station(0).get_sim_station().get_electric_fields())
        shower = event.get_first_sim_shower()
        self._zenith = shower[shp.zenith]
        self._azimuth = shower[shp.azimuth]
        axis = _spherical_to_cartesian(self._zenith, self._azimuth)
        # shower-plane basis (vxB-like frame not needed for interpolation
        # geometry; any orthonormal basis orthogonal to the axis works)
        ref = np.array([0.0, 0.0, 1.0])
        e1 = np.cross(axis, ref)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis, e1)
        self._basis = np.array([e1, e2])
        self._axis = axis

        pos = np.array([ef.get_position() for ef in self._efields])
        self._plane_pos = pos @ self._basis.T
        self._fluence = np.array([
            np.sum(np.asarray(ef.get_trace()) ** 2) for ef in self._efields])

        from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator
        self._fluence_interp = LinearNDInterpolator(self._plane_pos, self._fluence,
                                                    fill_value=0.0)
        self._nearest = NearestNDInterpolator(self._plane_pos, np.arange(len(pos)))

    @staticmethod
    def _pad3(position):
        """2D core-relative positions are placed at the observation level
        (readCoREASDetector.py:186-189)."""
        position = np.asarray(position, dtype=float)
        if position.shape[-1] == 2:
            position = np.concatenate([position, [0.0]])
        return position

    def get_interp_fluence_value(self, position):
        p = self._pad3(position) @ self._basis.T
        return float(np.asarray(self._fluence_interp(p[None, :])).ravel()[0])

    def get_interp_efield_value(self, position):
        """Efield trace at an arbitrary position: nearest observer pulse shape
        scaled to the locally interpolated fluence."""
        p = self._pad3(position) @ self._basis.T
        idx = int(np.asarray(self._nearest(p[None, :])).ravel()[0])
        ef = self._efields[idx]
        target = self.get_interp_fluence_value(position)
        src = self._fluence[idx]
        scale = np.sqrt(target / src) if src > 0 else 0.0
        return np.asarray(ef.get_trace()) * scale, ef.get_sampling_rate()

    @property
    def sampling_rate(self):
        return self._efields[0].get_sampling_rate()

    def initialize_efield_interpolator(self, interp_lowfreq, interp_highfreq):
        """Record the interpolation band (coreasInterpolator.py
        initialize_efield_interpolator capability; the fluence weighting here
        is full-band — the band is stored for provenance)."""
        self._interp_band = (interp_lowfreq, interp_highfreq)
        return self

    def interpolation_weights(self, positions):
        """(nearest observer [K], fluence scale [K]) of K positions at once:
        the weights of :meth:`get_interp_efield_value`, by the same scipy
        interpolators on the host."""
        p = np.array([self._pad3(q) for q in positions]) @ self._basis.T
        idx = np.asarray(self._nearest(p)).ravel().astype(int)
        target = np.asarray(self._fluence_interp(p)).ravel()
        src = self._fluence[idx]
        scale = np.sqrt(target / np.where(src > 0, src, 1.0))
        return idx, np.where(src > 0, scale, 0.0)

    def get_interp_efields(self, positions, window=None, device=device_util.DEFAULT):
        """Efield traces [K, 3, n] at K positions as one gather and scale of
        the observer traces on ``device`` (times ``window`` [n] when given),
        and their start times [K]."""
        device = device_util.resolve(device)
        idx, scale = self.interpolation_weights(positions)
        traces = torch.as_tensor(np.array([ef.get_trace() for ef in self._efields]),
                                 device=device)
        out = traces[torch.as_tensor(idx, device=device)] \
            * torch.as_tensor(scale, device=device)[:, None, None]
        if window is not None:
            out = out * torch.as_tensor(window, device=device)
        starts = np.array([self._efields[i].get_trace_start_time() for i in idx])
        return out, starts

    def get_interp_efield(self, position):
        """(trace (3, n), trace_start_time) at an arbitrary position — the
        return convention of the reference's efield interpolator
        (coreasInterpolator.get_interp_efield_value)."""
        p = self._pad3(position) @ self._basis.T
        idx = int(np.asarray(self._nearest(p[None, :])).ravel()[0])
        ef = self._efields[idx]
        trace, _ = self.get_interp_efield_value(position)
        return trace, ef.get_trace_start_time()
