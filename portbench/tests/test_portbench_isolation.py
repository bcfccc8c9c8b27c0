"""What runs on the card imports neither jax nor the JAX package, and the
yardstick (reference, traffic generator, roofline arithmetic, comparison)
imports nothing of the program either; names compared whole, before the
first dot."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
NEVER = {"jax", "jaxlib", "flax", "nuradiomc_tpu"}
PROGRAM = "nuradiomc_tpu_torch"
# the yardstick: nothing of it may import the program
YARDSTICK = ["reference", "traffic", "roofline.py", "compare.py", "metrics_common.py",
             "metrics"]


def imported_top_names(path):
    """Top-level names of every import in the file, nested ones included."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def chip_modules():
    return sorted(p for p in PB.rglob("*.py") if "tests" not in p.relative_to(PB).parts)


@pytest.mark.parametrize("path", chip_modules(), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not imported_top_names(path) & NEVER


def yardstick_modules():
    out = []
    for part in YARDSTICK:
        p = PB / part
        out.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return out


@pytest.mark.parametrize("path", yardstick_modules(), ids=lambda p: str(p.relative_to(PB)))
def test_yardstick_imports_no_program(path):
    assert PROGRAM not in imported_top_names(path)


def test_prefix_is_not_the_name():
    """The port's name begins with the JAX package's: whole names only."""
    assert PROGRAM.split(".")[0] not in NEVER


def named_references():
    """The default reference and every module a configuration file names
    under ``reference``."""
    names = {"portbench.reference.job"}
    for path in sorted((PB / "configs").glob("*.json")):
        names.add(json.loads(path.read_text()).get("reference", "portbench.reference.job"))
    return sorted(names)


def test_reference_loads_no_program():
    """Importing the references, the generator with its secondaries and the
    comparison loads no module of the program, jax or the JAX package."""
    code = ("import sys, importlib; sys.path.insert(0, %r)\n"
            "for name in %r: importlib.import_module(name)\n"
            "import portbench.traffic.generator, portbench.traffic.secondaries\n"
            "import portbench.compare, portbench.roofline, portbench.control\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT), named_references()))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (NEVER | {PROGRAM})
