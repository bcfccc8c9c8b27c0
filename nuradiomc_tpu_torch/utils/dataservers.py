# copied from nuradiomc_tpu/utils/dataservers.py:1-101 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Data-server downloads with hash verification.

Re-implementation of NuRadioReco/utilities/dataservers.py +
the hash check of detector/antennapattern.get_pickle_antenna_response
(:540-634): fetch a data file (antenna pickle, shower library, BGR18
tables, ...) from the mirror list, verify its sha1 against a provided
digest, unpack tarballs. Uses urllib (no requests dependency); a
``file://`` server URL works for offline/mirror setups and tests.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import urllib.request

logger = logging.getLogger("nuradiomc_tpu_torch.dataservers")

DATASERVERS = [
    "https://rnog-data.zeuthen.desy.de",
    "https://rno-g.uchicago.edu/data/desy-mirror",
]


def sha1_of(path: str, buf_size: int = 2 ** 20) -> str:
    """sha1 hex digest of a file (antennapattern.py:592-601 chunked read)."""
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while True:
            data = f.read(buf_size)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def verify_hash(path: str, expected_sha1: str | None) -> bool:
    """True if the file matches the expected digest (None = no check,
    mirrors the 'no hash sum available, skipping up-to-date check' path)."""
    if expected_sha1 is None:
        logger.warning("no hash sum for %s available, skipping check", path)
        return True
    return sha1_of(path) == expected_sha1


def download_from_dataserver(remote_path: str, target_path: str,
                             unpack_tarball: bool = True,
                             dataservers=None,
                             expected_sha1: str | None = None,
                             timeout: float = 30.0) -> str:
    """Download ``remote_path`` from the first responsive server into
    ``target_path`` (dataservers.download_from_dataserver:33-96 semantics:
    skip when present and valid, try servers in order, unpack .tar.gz).

    ``expected_sha1`` adds the antenna-pickle-style integrity check: an
    existing file with a matching digest short-circuits; a freshly
    downloaded file failing the check is an error.
    """
    servers = DATASERVERS if dataservers is None else list(dataservers)
    folder = os.path.dirname(target_path)
    if folder and not os.path.exists(folder):
        os.makedirs(folder)

    if os.path.isfile(target_path):
        if verify_hash(target_path, expected_sha1):
            logger.info("%s already exists and is valid", target_path)
            return target_path
        logger.warning("%s exists but fails the hash check; re-downloading",
                       target_path)
        os.remove(target_path)

    last_error: Exception | None = None
    for server in servers:
        url = f"{server}/{remote_path}"
        logger.warning("downloading %s from %s ...", target_path, url)
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(target_path + ".part", "wb") as out:
                shutil.copyfileobj(r, out)
            os.replace(target_path + ".part", target_path)
            break
        except Exception as exc:   # URLError, HTTPError, timeout, ...
            last_error = exc
            logger.warning("problem downloading from %s: %s", server, exc)
    else:
        raise IOError(
            f"could not download {remote_path} from any of {servers}: "
            f"{last_error}")

    if not verify_hash(target_path, expected_sha1):
        os.remove(target_path)
        raise IOError(f"downloaded {target_path} fails the sha1 check")

    if unpack_tarball and target_path.endswith(".tar.gz"):
        target_dir = os.path.dirname(target_path)
        logger.warning("unpacking archive to %s", target_dir)
        shutil.unpack_archive(target_path, target_dir)
        os.remove(target_path)
    return target_path
