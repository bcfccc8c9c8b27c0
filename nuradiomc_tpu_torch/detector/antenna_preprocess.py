# copied from nuradiomc_tpu/detector/antenna_preprocess.py:1-592 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Antenna-pattern preprocessors: raw simulation output -> reference pickle.

Re-implementation of the reference preprocessors
(NuRadioReco/detector/antennapattern.py:110-1184): parse the raw simulation
exports — WIPL-D (.ad1/.ra1/.orientation), RNO-G XFDTD (gain/phase csv),
ARAsim ASCII, generic XFDTD (+yaml metadata), HFSS csv, AERA XML, LOFAR txt,
FEKO .mat — compute the realized vector effective length, and write the
standard 9-item pickle [orientation_theta, orientation_phi, rotation_theta,
rotation_phi, ff, thetas, phis, H_phi, H_theta] that
ops.antenna.load_antenna_table (and the reference's AntennaPattern) read —
so a real data-server download drops in unchanged.

Where the reference's own preprocessor no longer runs under Python 3
(preprocess_ARA calls parse_ARA_file with two arguments and unpacks nine
return values, antennapattern.py:803-833; parse_HFSS_file indexes lists with
float slice bounds, antennapattern.py:888-895) this module implements the
documented INTENT (the math of the working neighbours preprocess_XFDTD /
preprocess_RNOG_XFDTD) and notes the divergence in the docstring.
"""

from __future__ import annotations

import cmath
import csv
import os
import pickle

import numpy as np
from scipy import constants
from scipy.interpolate import interp1d

from nuradiomc_tpu_torch.utils import units


def cartesian_to_spherical_np(x, y, z):
    """(zenith, azimuth) of a cartesian direction; host numpy."""
    r = np.sqrt(x * x + y * y + z * z)
    return np.arccos(z / r), np.arctan2(y, x)


Z_0 = 119.9169 * np.pi * units.ohm     # free-space impedance
_C = constants.c * units.m / units.s


def parse_wipld_file(ad1, ra1, orientation, gen_num=1, s_parameters=None):
    """Parse the three WIPL-D export files (parse_WIPLD_file,
    antennapattern.py:214-288): .ad1 holds the S/Z parameters per frequency,
    .ra1 the complex radiated currents on the (freq, phi, theta) grid, and
    .orientation the boresight/tine vectors."""
    if s_parameters is None:
        s_parameters = [1, 1]
    boresight, tines = np.loadtxt(orientation, delimiter=",")
    orientation_theta, orientation_phi = cartesian_to_spherical_np(*boresight)
    rotation_theta, rotation_phi = cartesian_to_spherical_np(*tines)

    ad1_data = np.loadtxt(ad1, comments=">")
    mask = (ad1_data[:, 1] == s_parameters[0]) & (ad1_data[:, 2] == s_parameters[1])
    ff = ad1_data[:, 0][mask] * units.GHz
    Z = (ad1_data[:, 5][mask] + 1j * ad1_data[:, 6][mask]) * units.ohm
    S = ad1_data[:, 7][mask] + 1j * ad1_data[:, 8][mask]

    ff2, phis, thetas, Ephis, Ethetas, gains = [], [], [], [], [], []
    f = None
    skip = False
    with open(ra1) as fin:
        for line in fin.readlines():
            if line.strip().startswith(">"):
                skip = int(line.split()[3]) != gen_num
                f = float(line.split()[4])
            else:
                if skip:
                    continue
                ff2.append(f * units.GHz)
                phi, theta, re_ep, im_ep, re_et, im_et, gain, _gaindb = line.split()
                phis.append(float(phi))
                thetas.append(float(theta))
                Ephis.append(float(re_ep) + 1j * float(im_ep))
                Ethetas.append(float(re_et) + 1j * float(im_et))
                gains.append(float(gain))

    if not np.array_equal(ff, np.unique(np.array(ff2))):
        raise ValueError("frequencies of ad1 and ra1 files do not match")
    return (orientation_theta, orientation_phi, rotation_theta, rotation_phi,
            ff, Z, S, np.array(ff2), np.deg2rad(np.array(phis)),
            np.deg2rad(np.array(thetas)), np.array(Ephis), np.array(Ethetas),
            np.array(gains))


def preprocess_wipld(path, gen_num=1, s_parameters=None):
    """Realized VEL from WIPL-D currents + S-parameter matching into a 50 Ohm
    system (preprocess_WIPLD, antennapattern.py:386-461). ``path`` points
    into the folder containing <name>.ad1/.ra1/.orientation; returns the
    9-item pickle payload."""
    split = os.path.split(os.path.dirname(path))
    name = split[1]
    base = split[0]
    (orientation_theta, orientation_phi, rotation_theta, rotation_phi,
     ff, Z, S, ff2, phi, theta, Iphi, Itheta, _gains) = parse_wipld_file(
        os.path.join(base, name, f"{name}.ad1"),
        os.path.join(base, name, f"{name}.ra1"),
        os.path.join(base, name, f"{name}.orientation"),
        gen_num=gen_num, s_parameters=s_parameters)

    # WIPL-D defines theta from the x-y plane (antennapattern.py:439)
    theta = 0.5 * np.pi - theta

    index = np.lexsort((theta, phi, ff2))
    ff2 = ff2[index]
    phi = phi[index]
    theta = theta[index]
    Iphi = Iphi[index]
    Itheta = Itheta[index]

    get_S = interp1d(ff, S, kind="nearest")
    wavelength = _C / ff2
    V = 1 * units.V
    Z_L = 50 * units.ohm
    H_phi = wavelength * (1 + get_S(ff2)) * Iphi * Z_L / Z_0 / 1j / V
    # eTheta points in the opposite direction in NuRadio vs WIPL-D
    H_theta = -wavelength * (1 + get_S(ff2)) * Itheta * Z_L / Z_0 / 1j / V
    return (orientation_theta, orientation_phi, rotation_theta, rotation_phi,
            ff2, theta, phi, H_phi, H_theta)


def save_preprocessed_wipld(path):
    """preprocess_wipld + write <name>.pkl next to the raw files
    (save_preprocessed_WIPLD, antennapattern.py:464-482)."""
    payload = preprocess_wipld(path)
    split = os.path.split(os.path.dirname(path))
    name = split[1]
    out = os.path.join(split[0], name, f"{name}.pkl")
    with open(out, "wb") as fout:
        pickle.dump(list(payload), fout, protocol=4)
    return out


def save_preprocessed_wipld_for_ara(path):
    """Export the WIPL-D realized gain in the ARASim ASCII format
    (save_preprocessed_WIPLD_forARA, antennapattern.py:483-538): per
    frequency a ``freq : X MHz`` header, an SWR line, a column header, then
    ``theta phi gain_dB gain phase_theta phase_phi`` rows (the reference
    writes 0 in the dB column and the realized gain Gr = G(1-|S|^2))."""
    split = os.path.split(os.path.dirname(path))
    name = split[1]
    base = split[0]
    (_, _, _, _, ff, _Z, S, ff2, phi, theta, Iphi, Itheta,
     gains) = parse_wipld_file(
        os.path.join(base, name, f"{name}.ad1"),
        os.path.join(base, name, f"{name}.ra1"),
        os.path.join(base, name, f"{name}.orientation"))

    theta = 0.5 * np.pi - theta
    index = np.lexsort((theta, phi, ff2))
    ff2, phi, theta = ff2[index], phi[index], theta[index]
    Iphi, Itheta, gains = Iphi[index], Itheta[index], gains[index]

    get_S = interp1d(ff, S, kind="nearest")
    wavelength = _C / ff2
    V = 1 * units.V
    Z_L = 50 * units.ohm
    Gr = gains * (1 - np.abs(get_S(ff2)) ** 2)
    H_phi = wavelength * (1 + get_S(ff2)) * Iphi * Z_L / Z_0 / 1j / V
    H_theta = -wavelength * (1 + get_S(ff2)) * Itheta * Z_L / Z_0 / 1j / V

    out = os.path.join(base, name, f"{name}.ara")
    with open(out, "w") as fout:
        for f in sorted(np.unique(ff2)):
            fout.write("freq : {} MHz\n".format(f / units.MHz))
            fout.write("SWR : ???\n")
            fout.write("Theta   Phi      Gain(dB)          Gain"
                       "          Phase(deg)\n")
            m = ff2 == f
            for i in range(int(np.sum(m))):
                fout.write("{:.4f} {:.4f} {:.4g} {:.4g} {:.2f} {:.2f}\n"
                           .format(theta[m][i] / units.deg,
                                   phi[m][i] / units.deg, 0, Gr[m][i],
                                   np.angle(H_theta[m][i]) / units.deg,
                                   np.angle(H_phi[m][i]) / units.deg))
    return out


def parse_ara_file(path):
    """Parse an ARAsim ASCII antenna file (parse_ARA_file,
    antennapattern.py:741-800): blocks per frequency with
    ``theta phi gain_dB gain phase`` rows; the phi=0 rows are duplicated at
    phi=360 so the interpolation grid wraps."""
    ff, phis, thetas, gains, phases = [], [], [], [], []
    f = None
    tmp_phi0 = []
    with open(path) as fin:
        for line in fin.readlines():
            s = line.strip()
            if s.startswith("freq"):
                f = float(s.replace(" ", "").replace("freq", "")
                          .replace(":", "").replace("MHz", ""))
                continue
            if s.startswith("SWR") or s.startswith("Theta") or not s:
                continue
            theta, phi, _gaindb, gain, phase = line.split()[:5]
            ff.append(f * units.MHz)
            if float(phi) == 0:
                tmp_phi0.append(line)
            phis.append(float(phi) * units.deg)
            thetas.append(float(theta) * units.deg)
            gains.append(float(gain))
            phases.append(float(phase) * units.deg)
            if float(phi) == 355 and float(theta) == 180:
                for tline in tmp_phi0:
                    theta, phi, _gaindb, gain, phase = tline.split()[:5]
                    ff.append(f * units.MHz)
                    phis.append(360.0 * units.deg)
                    thetas.append(float(theta) * units.deg)
                    gains.append(float(gain))
                    phases.append(float(phase) * units.deg)
                tmp_phi0 = []
    return (np.array(ff), np.array(phis), np.array(thetas),
            np.array(gains), np.array(phases))


def preprocess_ara(path, output=None):
    """Realized VEL from an ARAsim gain file. The reference's own
    preprocess_ARA (antennapattern.py:803-833) no longer runs (it calls
    parse_ARA_file with two arguments and unpacks nine values); this
    implements its documented math: H_theta = lambda sqrt(50/(pi Z_0))
    sqrt(G), phases deliberately dropped ("this will screw up the
    interpolation", :825), H_phi = 1e-3 H_theta, orientation from the
    sibling <name>.orientation file when present (boresight/tines rows as
    in WIPL-D) else boresight up."""
    split = os.path.split(os.path.dirname(path))
    name = split[1]
    base = split[0]
    ff, phi, theta, gain, _phase = parse_ara_file(
        os.path.join(base, name, f"{name}.txt"))

    ori = os.path.join(base, name, f"{name}.orientation")
    if os.path.exists(ori):
        boresight, tines = np.loadtxt(ori, delimiter=",")
        orientation_theta, orientation_phi = cartesian_to_spherical_np(*boresight)
        rotation_theta, rotation_phi = cartesian_to_spherical_np(*tines)
    else:
        orientation_theta = orientation_phi = 0.0
        rotation_theta, rotation_phi = 0.5 * np.pi, 0.0

    wavelength = _C / ff
    H_theta = wavelength * (50 / (np.pi * Z_0 / units.ohm)) ** 0.5 * gain ** 0.5
    H_phi = H_theta * 1e-3

    if output is None:
        output = os.path.join(base, name, f"{name}.pkl")
    with open(output, "wb") as fout:
        pickle.dump([orientation_theta, orientation_phi, rotation_theta,
                     rotation_phi, ff, theta, phi, H_phi, H_theta],
                    fout, protocol=4)
    return output


def preprocess_xfdtd(path, output=None):
    """Generic XFDTD export: ARAsim-format <name>.txt + <name>.yaml metadata
    with boresight_direction / orientation / n / type (preprocess_XFDTD,
    antennapattern.py:949-991). Vpol puts the VEL in H_theta (H_phi
    suppressed 1e-6), Hpol the reverse."""
    import yaml

    split = os.path.split(os.path.dirname(path))
    name = split[1]
    base = split[0]
    with open(os.path.join(base, name, f"{name}.yaml")) as fin:
        info = yaml.safe_load(fin)
    orientation_theta, orientation_phi = cartesian_to_spherical_np(
        *info["boresight_direction"])
    rotation_theta, rotation_phi = cartesian_to_spherical_np(
        *info["orientation"])
    n_index = info["n"]

    ff, phi, theta, gain, phase = parse_ara_file(
        os.path.join(base, name, f"{name}.txt"))
    wavelength = _C / ff
    H = (wavelength / n_index ** 0.5
         * (50 / (4 * np.pi * Z_0 / units.ohm)) ** 0.5
         * gain ** 0.5 * np.exp(1j * phase))
    if info["type"] == "Vpol":
        H_theta, H_phi = H, H * 1e-6
    elif info["type"] == "Hpol":
        H_theta, H_phi = H * 1e-6, H
    else:
        raise NotImplementedError(
            f"antenna type {info['type']} not understood")

    if output is None:
        output = os.path.join(base, name, f"{name}.pkl")
    with open(output, "wb") as fout:
        pickle.dump([orientation_theta, orientation_phi, rotation_theta,
                     rotation_phi, ff, theta, phi, H_phi, H_theta],
                    fout, protocol=4)
    return output


def parse_hfss_file(path):
    """Parse an HFSS far-field csv (parse_HFSS_file,
    antennapattern.py:835-898): one header row naming per-column direction
    (``log10(mag(rEPhi)) ... Phi='Xdeg' Theta='Ydeg'``), one row per
    frequency. The reference's post-sort block indexes lists with float
    bounds (py2 leftover); here the flat arrays are returned unsorted and
    preprocess_hfss lexsorts them into the pickle order."""
    import re

    ff, phi, theta = [], [], []
    mag_phi, mag_theta, phase_phi, phase_theta = [], [], [], []
    with open(path) as fin:
        rows = fin.readlines()
    names = rows[0].split(",")
    for row in rows[1:]:
        arr = row.split(",")
        freq = None
        for i, nm in enumerate(names):
            if "Freq" in nm:
                freq = float(arr[i])
            elif "log10(mag(rEPhi))" in nm:
                mag_phi.append(float(arr[i]))
                ff.append(freq * units.MHz)
                p = re.search(r"Phi='(.+?)deg'", nm)
                t = re.search(r"Theta='(.+?)deg'", nm)
                phi.append(np.deg2rad(float(p.group(1))))
                theta.append(np.deg2rad(float(t.group(1))))
            elif "log10(mag(rETheta))" in nm:
                mag_theta.append(float(arr[i]))
            elif "ang_rad(rEPhi)" in nm:
                phase_phi.append(float(arr[i]))
            elif "ang_rad(rETheta)" in nm:
                phase_theta.append(float(arr[i]))
    return (np.array(ff), np.array(phi), np.array(theta), np.array(mag_phi),
            np.array(mag_theta), np.array(phase_phi), np.array(phase_theta))


def preprocess_hfss(path, n_index=1.78, output=None):
    """Realized VEL from HFSS log-magnitudes + phases (preprocess_HFSS,
    antennapattern.py:901-946): mag -> 10^(mag/10), gain = 4 pi mag^2 /
    (2 * 120 pi), H = lambda/sqrt(n) sqrt(50/(4 pi Z_0)) sqrt(gain)
    e^{i phase}."""
    split = os.path.split(os.path.dirname(path))
    name = split[1]
    base = split[0]
    ff, phi, theta, mag_phi, mag_theta, phase_phi, phase_theta = \
        parse_hfss_file(os.path.join(base, name, f"{name}.csv"))

    index = np.lexsort((theta, phi, ff))
    ff, phi, theta = ff[index], phi[index], theta[index]
    mag_phi, mag_theta = mag_phi[index], mag_theta[index]
    phase_phi, phase_theta = phase_phi[index], phase_theta[index]

    mag_theta = 10 ** (mag_theta / 10)
    mag_phi = 10 ** (mag_phi / 10)
    gain_theta = 4.0 * np.pi * mag_theta ** 2 / (2 * 120 * np.pi)
    gain_phi = 4.0 * np.pi * mag_phi ** 2 / (2 * 120 * np.pi)
    wavelength = _C / ff
    amp = (50 / (4 * np.pi * Z_0 / units.ohm)) ** 0.5
    H_theta = (wavelength / n_index ** 0.5 * amp * gain_theta ** 0.5
               * np.exp(1j * phase_theta))
    H_phi = (wavelength / n_index ** 0.5 * amp * gain_phi ** 0.5
             * np.exp(1j * phase_phi))

    if output is None:
        output = os.path.join(base, name, f"{name}.pkl")
    with open(output, "wb") as fout:
        pickle.dump([0, 0, 0, 0, ff, theta, phi, H_phi, H_theta],
                    fout, protocol=4)
    return output


def parse_aera_xml_file(path):
    """Parse an AERA antenna XML export (parse_AERA_XML_file,
    antennapattern.py:635-690): frequency/theta/phi node lists plus
    per-frequency EAH{Theta,Phi}_{amp,phase} nodes keyed by idfreq."""
    import xml.etree.ElementTree as ET

    with open(path) as fin:
        root = ET.fromstring("<antenna>" + fin.read() + "</antenna>")

    frequencies = np.array(root.find("./frequency").text.strip().split(),
                           dtype=float) * units.MHz
    thetas = np.array(root.find("./theta").text.strip().split(),
                      dtype=float) * units.deg
    phis = np.array(root.find("./phi").text.strip().split(),
                    dtype=float) * units.deg

    n_freqs, n_angles = len(frequencies), len(phis)
    theta_amps = np.zeros((n_freqs, n_angles))
    theta_phases = np.zeros((n_freqs, n_angles))
    phi_amps = np.zeros((n_freqs, n_angles))
    phi_phases = np.zeros((n_freqs, n_angles))

    for i, freq in enumerate(frequencies / units.MHz):
        fs = "%.2f" % freq
        if root.find(f"./EAHTheta_amp[@idfreq='{fs}']") is None:
            fs = "%.1f" % freq

        def node(tag):
            return np.array(root.find(f"./{tag}[@idfreq='{fs}']")
                            .text.strip().split(), dtype=float)
        theta_amps[i] = node("EAHTheta_amp") * units.m
        theta_phases[i] = np.deg2rad(node("EAHTheta_phase"))
        phi_amps[i] = node("EAHPhi_amp") * units.m
        phi_phases[i] = np.deg2rad(node("EAHPhi_phase"))

    return (frequencies, phis, thetas, phi_amps, phi_phases, theta_amps,
            theta_phases)


def preprocess_aera(path, output=None):
    """AERA XML -> pickle (preprocess_AERA, antennapattern.py:692-738).
    |H| < 0.01 entries are zeroed (the reference's guard against dividing
    by tiny VELs); orientation is an upward LPDA with tines along the
    magnetic field."""
    (frequencies, phis, thetas, phi_amps, phi_phases, theta_amps,
     theta_phases) = parse_aera_xml_file(path)

    n_freqs, n_angles = len(frequencies), len(phis)
    VEL_thetas = (theta_amps * np.exp(1j * theta_phases)).flatten()
    VEL_phis = (phi_amps * np.exp(1j * phi_phases)).flatten()

    theta = np.tile(thetas, n_freqs)
    phi = np.tile(phis, n_freqs)
    ff = np.repeat(frequencies, n_angles)

    index = np.lexsort((theta, phi, ff))
    VEL_thetas = VEL_thetas[index]
    VEL_phis = VEL_phis[index]
    theta, phi, ff = theta[index], phi[index], ff[index]

    H_phi = np.where(np.abs(VEL_phis) > 0.01, VEL_phis, 0)
    H_theta = np.where(np.abs(VEL_thetas) > 0.01, VEL_thetas, 0)

    if output is None:
        fname = os.path.basename(path).replace(".xml", "")
        output = os.path.join(os.path.dirname(path), f"{fname}.pkl")
    payload = [0.0, 0.0, 0.5 * np.pi, 0.5 * np.pi,
               ff, theta, phi, H_phi, H_theta]
    with open(output, "wb") as fout:
        pickle.dump(payload, fout, protocol=4)
    return output


def parse_lofar_txt_file(path_theta, path_phi):
    """Parse the LOFAR LBA simulation txt pair (parse_LOFAR_txt_file,
    antennapattern.py:994-1021): columns freq theta phi re im; the theta
    component carries the reference's documented extra minus sign."""
    freq, theta, phi, re_t, im_t = np.genfromtxt(path_theta, skip_header=1).T
    freq2, theta2, phi2, re_p, im_p = np.genfromtxt(path_phi, skip_header=1).T
    if (not np.all(freq == freq2) or not np.all(theta == theta2)
            or not np.all(phi == phi2)):
        raise ValueError("Values in theta and phi files do not match")
    freq = freq * units.MHz
    theta = theta * units.deg
    phi = phi * units.deg
    return freq, theta, phi, -re_t, -im_t, re_p, im_p


def preprocess_lofar_txt(directory, ant="LBA", orientation=None,
                         output=None):
    """LOFAR txt pair -> pickle (preprocess_LOFAR_txt,
    antennapattern.py:1024-1083). ``orientation='X'`` flips the sign of all
    components (the X/Y dipole convention); default returns the Y dipole.
    Stored orientation: upright LBA aligned E-W."""
    path_theta = os.path.join(directory, f"{ant}_Vout_theta.txt")
    path_phi = os.path.join(directory, f"{ant}_Vout_phi.txt")
    freq, theta, phi, re_t, im_t, re_p, im_p = parse_lofar_txt_file(
        path_theta, path_phi)
    if orientation == "X":
        re_t, im_t, re_p, im_p = -re_t, -im_t, -re_p, -im_p

    VEL_theta = re_t + 1j * im_t
    VEL_phi = re_p + 1j * im_p

    index = np.lexsort((theta, phi, freq))
    H_theta = VEL_theta[index]
    H_phi = VEL_phi[index]
    theta, phi, freq = theta[index], phi[index], freq[index]

    if output is None:
        fname = (f"LOFAR_{ant}_{orientation}" if orientation
                 else f"LOFAR_{ant}")
        output = os.path.join(directory, f"{fname}.pkl")
    with open(output, "wb") as fout:
        pickle.dump([0.5 * np.pi, 0.0, 0.0, 0.0,
                     freq, theta, phi, H_phi, H_theta], fout, protocol=4)
    return output


def preprocess_feko_mat(path, polarization="X", downscale_freq=1,
                        downscale_zenith=4, downscale_azimuth=4,
                        output=None):
    """FEKO .mat far-field export of the SKALA4 element -> pickle
    (preprocess_FEKO_mat, antennapattern.py:1086-1184): Ephi/Etheta arrays
    (phi, theta, freq) on a regular 50-350 MHz x [0,360]deg x [0,90]deg
    grid; VEL = -2i lambda Z_L / eta_0 * E (arXiv:2412.01699 Eq. 6). Grid
    extents follow the reference; node counts are taken from the stored
    array shape so downscaled exports load too."""
    from scipy import io as scipy_io

    data = scipy_io.loadmat(path)
    Ephi = data["Ephi"].transpose(2, 0, 1)    # -> (freq, phi, theta)
    Etheta = data["Etheta"].transpose(2, 0, 1)

    nf, np_, nt = Ephi.shape
    freqs_unique = np.linspace(50, 350, nf) * units.MHz
    phis_unique = np.linspace(0, 360, np_) * units.deg
    thetas_unique = np.linspace(0, 90, nt) * units.deg

    freq, phi, theta = np.meshgrid(freqs_unique, phis_unique, thetas_unique,
                                   indexing="ij")

    if not (downscale_freq == downscale_zenith == downscale_azimuth == 1):
        mask = np.zeros_like(phi, dtype=int)
        mask[np.arange(0, nf, downscale_freq), :, :] += 1
        mask[:, np.arange(0, np_, downscale_azimuth), :] += 1
        mask[:, :, np.arange(0, nt, downscale_zenith)] += 1
        mask = mask > 2
        Ephi, Etheta = Ephi[mask], Etheta[mask]
        phi, theta, freq = phi[mask], theta[mask], freq[mask]
    else:
        Ephi, Etheta = Ephi.ravel(), Etheta.ravel()
        phi, theta, freq = phi.ravel(), theta.ravel(), freq.ravel()

    lambda_0 = _C / freq
    eta_0 = np.sqrt(constants.mu_0 / constants.epsilon_0) * units.ohm
    Z_L = 50 * units.ohm
    vel_theta = -2.0j * lambda_0 * Z_L / eta_0 * Etheta
    vel_phi = -2.0j * lambda_0 * Z_L / eta_0 * Ephi

    rotation_phi = {"X": 0.5 * np.pi, "Y": np.pi}[polarization]
    if output is None:
        fname = f"SKALA_v4_{polarization}pol"
        output = os.path.join(os.path.dirname(path), f"{fname}.pkl")
    with open(output, "wb") as fout:
        pickle.dump([0.0, 0.0, 0.5 * np.pi, rotation_phi,
                     freq, theta, phi, vel_phi, vel_theta], fout, protocol=4)
    return output


def parse_rnog_xfdtd_file(path_gain, path_phases, encoding=None):
    """Parse the XFDTD gain/phase csv pair (parse_RNOG_XFDTD_file,
    antennapattern.py:110-160)."""
    ff, phis, thetas, gain_theta, gain_phi = [], [], [], [], []
    with open(path_gain, encoding=encoding) as fin:
        for i, row in enumerate(csv.reader(fin, delimiter=",")):
            if i == 0:
                continue
            ff.append(float(row[0]))
            thetas.append(float(row[1]))
            phis.append(float(row[2]))
            gain_phi.append(float(row[3]))
            gain_theta.append(float(row[4]))
    phase_phi, phase_theta = [], []
    with open(path_phases, encoding=encoding) as fin:
        for i, row in enumerate(csv.reader(fin, delimiter=",")):
            if i == 0:
                continue
            phase_phi.append(cmath.phase(float(row[3]) + 1j * float(row[4])))
            phase_theta.append(cmath.phase(float(row[5]) + 1j * float(row[6])))
    return (np.array(ff), np.array(phis), np.array(thetas),
            np.array(gain_phi), np.array(gain_theta),
            np.array(phase_phi), np.array(phase_theta))


def preprocess_rnog_xfdtd(path_gain, path_phases, outputfilename,
                          n_index=1.74, encoding=None):
    """Realized VEL from XFDTD gain+phase; frequencies rescaled f -> f/n for
    the in-ice index (preprocess_RNOG_XFDTD, antennapattern.py:163-211)."""
    (ff, phi, theta, gain_phi, gain_theta,
     phase_phi, phase_theta) = parse_rnog_xfdtd_file(path_gain, path_phases,
                                                     encoding=encoding)
    theta = np.deg2rad(theta)
    phi = np.deg2rad(phi)
    wavelength = _C / np.array(ff)
    amp = (50 / (4 * np.pi * Z_0 / units.ohm)) ** 0.5
    H_theta = wavelength * amp * gain_theta ** 0.5 * np.exp(1j * phase_theta)
    H_phi = wavelength * amp * gain_phi ** 0.5 * np.exp(1j * phase_phi)

    zen_boresight, azi_boresight = 0.0, 0.0
    zen_ori, azi_ori = 0.5 * np.pi, 0.0

    index = np.lexsort((theta, phi, ff))
    ff = np.array(ff)[index] / n_index
    phi = phi[index]
    theta = theta[index]
    H_phi = np.array(H_phi)[index]
    H_theta = np.array(H_theta)[index]

    with open(outputfilename, "wb") as fout:
        pickle.dump([zen_boresight, azi_boresight, zen_ori, azi_ori,
                     ff, theta, phi, H_phi, H_theta], fout, protocol=2)
    return outputfilename
