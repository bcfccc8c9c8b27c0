# copied from nuradiomc_tpu/sim/proposal_table_manager.py:1-136 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""PROPOSAL interpolation-table management CLI
(EvtGen/proposal_table_manager.py:1-124).

The in-repo lepton propagator (`sim.nuradio_proposal.ProposalFunctions`)
is table-free — its stochastic sampling needs no precalculated
interpolation tables — so for the default backend ``create`` is a no-op
that reports this. When the real PROPOSAL package is installed (it is a
pip package, not distributable here), ``create`` drives it through the
same per-flavor propagator warm-up the reference uses, and ``download``
fetches the precalculated tarballs from the NuRadioMC data servers via
`utils.dataservers` (checksummed, mirror-failover).

Usage::

    python -m nuradiomc_tpu_torch.sim.proposal_table_manager create SouthPole
    python -m nuradiomc_tpu_torch.sim.proposal_table_manager download all -t /tables
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

logger = logging.getLogger("nuradiomc_tpu_torch.proposal_table_manager")

CONFIGS = ["InfIce", "SouthPole", "MooresBay", "Greenland"]


def get_compiler():
    """proposal >= 7.5 writes tables with compiler-dependent hashes
    (proposal_table_manager.get_compiler:31-37)."""
    return "clang" if "clang" in sys.version.lower() else "gcc"


def _real_proposal():
    try:
        import proposal
        return proposal
    except ImportError:
        return None


def produce_proposal_tables(config_file, tables_path=None):
    """Warm up the per-flavor propagators so PROPOSAL writes its tables
    (proposal_table_manager.produce_proposal_tables:13-29). With the
    table-free in-repo backend there is nothing to produce."""
    if _real_proposal() is None:
        logger.warning(
            "PROPOSAL is not installed; the built-in stochastic propagator "
            "(sim.nuradio_proposal) is table-free — nothing to produce for "
            "%s", config_file)
        return False
    from .nuradio_proposal import ProposalFunctions

    proposal_func = ProposalFunctions(config_file=config_file,
                                      tables_path=tables_path,
                                      create_new=True)
    for particle_code in (-15, -13, 13, 15):
        logger.warning("producing tables for %s, particle %d",
                       config_file, particle_code)
        # reference calls the private per-flavor propagator constructor
        getter = getattr(proposal_func, "_ProposalFunctions__get_propagator",
                         None) or getattr(proposal_func, "_get_propagator")
        getter(particle_code=particle_code)
    return True


def produce_proposal_tables_tarball(config_file, tables_path=None):
    """Produce `<config>.tar.gz` under
    ``{tables_path}/v{proposal_version}/{compiler}/``
    (proposal_table_manager:39-74)."""
    proposal = _real_proposal()
    if proposal is None:
        logger.warning("PROPOSAL is not installed; no tarball produced")
        return None
    if tables_path is None:
        tables_path = "proposal_tables"
    outdir = os.path.join(tables_path,
                          f"v{proposal.__version__}", get_compiler())
    os.makedirs(outdir, exist_ok=True)
    tarball = os.path.join(outdir, config_file + ".tar.gz")
    if os.path.isfile(tarball):
        logger.error("Output tarball %s already exists.", tarball)
        raise IOError(tarball)
    target = os.path.join(outdir, config_file)
    produce_proposal_tables(config_file, target)
    logger.warning("Producing gzipped tarball")
    shutil.make_archive(target, "gztar", target)
    return tarball


def download_proposal_tables(config_file, tables_path=None):
    """Fetch the precalculated tables from the NuRadioMC data servers
    (proposal_table_manager:77-101)."""
    proposal = _real_proposal()
    if proposal is None:
        raise ImportError(
            "downloading PROPOSAL tables only makes sense with the real "
            "PROPOSAL package installed (the built-in propagator is "
            "table-free)")
    from ..utils.dataservers import download_from_dataserver

    if tables_path is None:
        tables_path = "proposal_tables"
    remote_path = (f"proposal_tables/v{proposal.__version__}/"
                   f"{get_compiler()}/{config_file}.tar.gz")
    target_path = os.path.join(tables_path, f"{config_file}.tar.gz")
    logger.warning("downloading pre-calculated proposal tables for %s. "
                   "This can take a while...", config_file)
    download_from_dataserver(remote_path, target_path, unpack_tarball=True)
    return target_path


def main(argv=None):
    parser = argparse.ArgumentParser("NuRadioProposal tables I/O")
    parser.add_argument("option", choices=["create", "download"])
    parser.add_argument("config_file",
                        help=f"one of {CONFIGS} or 'all'")
    parser.add_argument("-t", "--tables_path", default=None,
                        help="target path for table creation/download")
    args = parser.parse_args(argv)

    logger.warning("Your compiler type is %s", get_compiler())
    configs = CONFIGS if args.config_file == "all" else [args.config_file]
    for cfg in configs:
        if args.option == "create":
            produce_proposal_tables_tarball(cfg, args.tables_path)
        else:
            download_proposal_tables(cfg, args.tables_path)


if __name__ == "__main__":
    main()
