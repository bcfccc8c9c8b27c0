"""Runs of the example workflows for the tests: the JAX example scripts in
this process (``runpy``) and the port's modules on the CPU, each with its
printed lines captured."""

import contextlib
import io
import os
import runpy
import sys

from nuradiomc_tpu_torch.examples import main_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")


def run_jax(script, argv, cwd):
    """The JAX example ``script`` (relative to ``examples/``) run in this
    process in ``cwd`` with ``argv``: (its globals, its standard output)."""
    old_argv, old_cwd = sys.argv, os.getcwd()
    buf = io.StringIO()
    try:
        sys.argv = [script, *argv]
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(os.path.join(EX, script), run_name="__main__")
    finally:
        sys.argv = old_argv
        os.chdir(old_cwd)
    return g, buf.getvalue()


def run_port(name, argv, outdir, **kw):
    """The port's example ``name`` on the CPU: (its return, its output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main_of(name)(argv, device="cpu", outdir=str(outdir), **kw)
    return out, buf.getvalue()
