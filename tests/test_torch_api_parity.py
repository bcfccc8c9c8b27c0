"""The port's completeness, pinned: every public name of the JAX package has
its counterpart in ``nuradiomc_tpu_torch``.

``test_module_has_its_counterpart`` is one case for each ``.py`` module of
``nuradiomc_tpu/``. The JAX side is read with ``ast`` (no JAX import): every
public top-level function, class and constant, every public method and class
attribute of each class (with those that a class inherits from a class of
the package), and the parameter names of each function and method
(``__init__`` and ``__call__`` included). The port side is imported, so a
method that a port class inherits (``reco.base.Module.begin`` / ``end``)
counts. Each name must exist in the port's module of the same path, and each
parameter name must be in the port's signature.

A module with no counterpart is allowed only from ``NO_COUNTERPART``; every
other difference is one entry of ``DIFFERENCES``, with the port's
counterpart (or why there is none) and the reason. The test fails as well
when an entry no longer names a real difference, so the lists cannot go
stale.

The other tests hold the names that the port gained with this check (ray
miss distance, analytic focusing, edge triggers, the depth-averaged index,
the settings' frequency grids, the rFFT grid, the Askaryan model list, the
CoREAS Hann window) to their JAX originals in float64 at rtol 1e-12.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "nuradiomc_tpu"
PORT = "nuradiomc_tpu_torch"

# JAX modules with no module of the same path in the port, and why
NO_COUNTERPART = {
    "native/__init__.py": "the C++ host batch builder loaded by ctypes; the port "
                          "groups and pads showers in numpy "
                          "(sim/simulation.py _group_showers / _pad_columns)",
    "ops/placement_pallas.py": "Pallas kernels; their CUDA ports are "
                               "csrc/placement_chain.cu and csrc/placement_reduce.cu, "
                               "wrapped by ops/placement.py",
    "ops/trigger_pallas.py": "Pallas kernel; its CUDA port is csrc/irfft_trigger.cu, "
                             "wrapped by ops/trigger_fused.py",
    "ops/pa_pallas.py": "Pallas kernel; its CUDA port is csrc/pa_trigger.cu, "
                        "wrapped by ops/pa_trigger.py",
}

_GENERATOR = ("the port's `generator` / `noise_generator` argument",
              "the port draws from a torch.Generator on the device where the "
              "JAX package threads a PRNG key")
_SHARDING = ("parallel/mesh.py shard_batch / shard_channels on a torch.distributed Mesh",
             "a JAX NamedSharding object; each torch.distributed rank holds its "
             "own slice of a batch, so there is no sharding object to return")
_ONE_TRIGGER_FORM = ("PipelineSettings.triggers (TriggerSettings)",
                     "the port names every trigger in `triggers`; `convert.settings_from_jax` "
                     "maps the JAX package's single-trigger form")
_TPU_KNOB = ("PipelineSettings.placement_impl / trigger_impl ('kernel' or 'plain')",
             "a selector of the JAX package's TPU lowering; the port's CUDA "
             "kernels and their plain versions take its place")

# every other difference: "module::item" -> (port counterpart or why none, reason);
# "f(p)" is parameter p of f, "C.m" a method or attribute of class C
DIFFERENCES = {
    "ops/noise.py::bandlimited_noise_spectrum(key)": _GENERATOR,
    "ops/noise.py::bandlimited_noise_trace(key)": _GENERATOR,
    "sim/noise_rate.py::max_beam_power_batch(key)": _GENERATOR,
    "sim/pipeline.py::simulate_batch(noise_key)": _GENERATOR,
    "parallel/mesh.py::initialize_distributed": (
        "parallel/mesh.py init_distributed",
        "jax.distributed.initialize becomes torch.distributed.init_process_group"),
    "parallel/mesh.py::make_mesh(devices)": (
        "make_mesh(n_event, n_channel, device=)",
        "a JAX mesh lays out a list of devices; each torch.distributed rank "
        "owns one device"),
    "parallel/mesh.py::batch_sharding": _SHARDING,
    "parallel/mesh.py::channel_sharding": _SHARDING,
    "parallel/mesh.py::replicated": _SHARDING,
    "sim/simulation.py::Simulation.run(keep_traces)": (
        "none: Simulation(nur_outputfilename=) and simulate_batch(keep_traces=) keep traces",
        "the argument is unused in the JAX body (simulation.py:1072)"),
    "reco/rit.py::get_signal(sum_trace)": (
        "get_signal(sum_traces, tsteps)",
        "the port's signal metric is batched over beamformed traces"),
    "reco/rit.py::get_signal(tstep)": (
        "get_signal(sum_traces, tsteps)",
        "the port's signal metric is batched over beamformed traces"),
    "ops/trace.py::place_spectrum": (
        "none: removed from the port",
        "no stage of the pipeline calls it in either package"),
    "sim/pipeline.py::PipelineSettings.trigger_irfft": _TPU_KNOB,
    "sim/pipeline.py::PipelineSettings.placement_phase": _TPU_KNOB,
    "sim/pipeline.py::PipelineSettings.matmul_dtype": (
        "none: the port's transforms are FFTs, not dense DFT matrices",
        "bfloat16 inputs for the dense DFT matmuls on the TPU's matrix unit"),
    "sim/pipeline.py::PipelineSettings.trigger_type": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.highlow_coincidence": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.number_of_coincidences": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.channel_coincidence": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_rolls": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_window": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_step": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_upsampling": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_threshold": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_digitize": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_adc_fs": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_adc_nbits": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.pa_adc_range": _ONE_TRIGGER_FORM,
    "sim/pipeline.py::PipelineSettings.stop_after": (
        "chip_smoke.py's per-kernel CUDA-event timings",
        "a profiling-only truncation ladder for fori-differenced TPU timings"),
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.py"))


def _top_statements(body):
    for st in body:
        if isinstance(st, ast.If) and "__main__" in ast.unparse(st.test):
            continue
        if isinstance(st, (ast.If, ast.Try)):
            yield from _top_statements(st.body)
            for handler in getattr(st, "handlers", []):
                yield from _top_statements(handler.body)
            yield from _top_statements(st.orelse)
        else:
            yield st


def _assigned_names(st):
    targets = st.targets if isinstance(st, ast.Assign) else [st.target]
    for t in targets:
        for n in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", [])):
            if isinstance(n, ast.Name):
                yield n.id


def _public(name):
    return not name.startswith("_") or name in ("__init__", "__call__")


class _Package:
    """The JAX package read with ast: each module's statements and imports."""

    def __init__(self):
        self.trees = {rel: ast.parse((JAX_DIR / rel).read_text()) for rel in _jax_modules()}

    def _module_path(self, dotted):
        """'a.b' (relative to the package) -> 'a/b.py' or 'a/b/__init__.py'."""
        base = dotted.replace(".", "/")
        for rel in (base + ".py", base + "/__init__.py"):
            if rel in self.trees:
                return rel
        return None

    def _import_map(self, rel):
        """name -> ('module', rel) or ('name', rel, name) for the module's
        imports from within the package."""
        pkg = pathlib.PurePosixPath(rel).parent.parts
        out = {}
        for st in ast.walk(self.trees[rel]):
            if isinstance(st, ast.ImportFrom):
                if st.level:
                    parts = list(pkg[:len(pkg) - (st.level - 1)] if st.level > 1 else pkg)
                    mod = ".".join(parts + ([st.module] if st.module else []))
                elif st.module and st.module.split(".")[0] == "nuradiomc_tpu":
                    mod = st.module.partition(".")[2]
                else:
                    continue
                for alias in st.names:
                    as_module = self._module_path(f"{mod}.{alias.name}".strip("."))
                    key = alias.asname or alias.name
                    if as_module:
                        out[key] = ("module", as_module)
                    elif self._module_path(mod) is not None:
                        out[key] = ("name", self._module_path(mod), alias.name)
        return out

    def _class(self, rel, name):
        for st in _top_statements(self.trees[rel].body):
            if isinstance(st, ast.ClassDef) and st.name == name:
                return st
        return None

    def _resolve(self, rel, base):
        imports = self._import_map(rel)
        if isinstance(base, ast.Name):
            if self._class(rel, base.id) is not None:
                return rel, base.id
            hit = imports.get(base.id)
            if hit and hit[0] == "name":
                return hit[1], hit[2]
        if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name):
            hit = imports.get(base.value.id)
            if hit and hit[0] == "module":
                return hit[1], base.attr
        return None

    def members(self, rel, cls):
        """{name: FunctionDef or None (an attribute)} of a class, its bases
        within the package included (the class's own definitions win)."""
        out = {}
        for base in cls.bases:
            where = self._resolve(rel, base)
            if where and self._class(*where) is not None:
                out.update(self.members(where[0], self._class(*where)))
        for st in cls.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(st.name):
                out[st.name] = st
            elif isinstance(st, (ast.Assign, ast.AnnAssign)):
                out.update({n: None for n in _assigned_names(st) if _public(n)})
        return out


@pytest.fixture(scope="module")
def package():
    return _Package()


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _port_has(obj, name):
    if hasattr(obj, name):
        return True
    if inspect.isclass(obj):
        return any(name in getattr(c, "__annotations__", {}) for c in obj.__mro__)
    return False


def _missing_params(fn_node, port_obj):
    try:
        port_params = set(inspect.signature(port_obj).parameters)
    except (TypeError, ValueError):
        return []
    return [p for p in _params(fn_node) if p not in port_params]


def _differences(package, rel, port_mod):
    found = set()
    for st in _top_statements(package.trees[rel].body):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) and not st.name.startswith("_"):
            if not _port_has(port_mod, st.name):
                found.add(st.name)
                continue
            found |= {f"{st.name}({p})"
                      for p in _missing_params(st, getattr(port_mod, st.name))}
        elif isinstance(st, ast.ClassDef) and not st.name.startswith("_"):
            if not _port_has(port_mod, st.name):
                found.add(st.name)
                continue
            port_cls = getattr(port_mod, st.name)
            for name, node in package.members(rel, st).items():
                if not _port_has(port_cls, name):
                    found.add(f"{st.name}.{name}")
                elif node is not None and not isinstance(
                        inspect.getattr_static(port_cls, name, None), property):
                    found |= {f"{st.name}.{name}({p})"
                              for p in _missing_params(node, getattr(port_cls, name))}
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            found |= {n for n in _assigned_names(st)
                      if not n.startswith("_") and not _port_has(port_mod, n)}
    return found


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_has_its_counterpart(package, rel):
    port_file = ROOT / PORT / rel
    if rel in NO_COUNTERPART:
        assert not port_file.exists(), f"{rel} has a counterpart now: drop it from NO_COUNTERPART"
        return
    assert port_file.exists(), f"{rel} has no counterpart in the port"
    dotted = rel[:-3].replace("/", ".").removesuffix(".__init__").removesuffix("__init__")
    port_mod = importlib.import_module(f"{PORT}.{dotted}" if dotted else PORT)
    expected = {k.partition("::")[2] for k in DIFFERENCES if k.partition("::")[0] == rel}
    assert _differences(package, rel, port_mod) == expected


def test_every_entry_names_a_module_and_a_reason():
    modules = set(_jax_modules())
    assert set(NO_COUNTERPART) <= modules
    for key, (counterpart, reason) in DIFFERENCES.items():
        assert key.partition("::")[0] in modules, key
        assert counterpart and reason, key


# ---- the names ported to close the gaps, held to their JAX originals -------

F64 = torch.float64


@pytest.fixture(scope="module")
def geometry():
    """400 (source, receiver) pairs from a numpy seed, reduced to the
    propagation plane, with the JAX solver's roots."""
    import jax

    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu.ops import raytrace as jrt

    rng = np.random.default_rng(14)
    n = 400
    r = rng.uniform(50.0, 3000.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    x1 = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-2700.0, -5.0, n)], -1)
    x2 = np.stack([np.zeros(n), np.zeros(n), rng.uniform(-200.0, -5.0, n)], -1)
    g = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    sols = jax.jit(jax.vmap(lambda a, b, c, d: jrt.find_solutions(
        a, b, c, d, jice.southpole_2015)))(g.x1y, g.x1z, g.x2y, g.x2z)
    cols = [np.asarray(v)[:, None].repeat(2, axis=1) for v in (g.x1y, g.x1z, g.x2y, g.x2z)]
    return cols, np.asarray(sols.c0), np.asarray(sols.mask)


def _both(name, c0, cols, **kw):
    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu.ops import raytrace as jrt
    from nuradiomc_tpu_torch.models import ice as tice
    from nuradiomc_tpu_torch.ops import raytrace as trt

    want = np.asarray(getattr(jrt, name)(jnp.asarray(c0), *map(jnp.asarray, cols),
                                         jice.southpole_2015, **kw))
    got = getattr(trt, name)(torch.as_tensor(c0), *(torch.as_tensor(c) for c in cols),
                             tice.southpole_2015, **kw).numpy()
    return got, want


def test_delta_y(geometry):
    """The solver's miss distance at trial C0s across the logC0 axis, on
    every branch (direct, mirrored, turning point too deep). Every branch
    evaluates y at the turning point, where sqrt(gamma^2 - b gamma + c)
    vanishes: a last-bit difference in gamma_turn between the two packages'
    log and sqrt becomes up to ~1e-9 relative there (one trial C0 of these
    800 measures 9.6e-10). So 99% of the values are held at rtol 1e-12 and
    all of them at rtol 1e-8."""
    cols, _, _ = geometry
    logc0 = np.linspace(-12.0, 2.0, 2 * len(cols[0])).reshape(-1, 2)
    c0 = np.exp(logc0) + 1.0 / 1.78
    got, want = _both("delta_y", c0, cols)
    assert np.all(np.isfinite(want)) and (want > 0).any() and (want < 0).any()
    rel = np.abs(got - want) / np.abs(want)
    assert np.mean(rel <= 1e-12) >= 0.99, np.sort(rel.ravel())[-20:]
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("limit", [2.0, 1e3])
def test_focusing_factor(geometry, limit):
    """The analytic focusing factor at the roots, below and at the limit."""
    cols, c0, mask = geometry
    got, want = _both("focusing_factor", c0, cols, limit=limit)
    assert mask.sum() > 200
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("which", ["get_high_triggers", "get_low_triggers"])
def test_edge_triggers(which):
    from nuradiomc_tpu.reco import trigger_modules as jtm
    from nuradiomc_tpu_torch.reco import trigger_modules as ttm

    trace = np.random.default_rng(3).normal(0.0, 1.0, 2048)
    threshold = 1.5 if which == "get_high_triggers" else -1.5
    want = getattr(jtm, which)(trace, threshold)
    got = getattr(ttm, which)(torch.as_tensor(trace), threshold).numpy()
    assert want.sum() > 20
    np.testing.assert_array_equal(got, want)


def test_ice_model_average_index_and_bottom():
    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu_torch.models import ice as tice

    rng = np.random.default_rng(4)
    z1 = rng.uniform(-2500.0, -1.0, 300)
    z2 = np.concatenate([rng.uniform(-2500.0, -1.0, 250), z1[:50]])   # 50 equal depths
    for name in sorted(jice._MODELS):
        j, t = jice.get_ice_model(name), tice.get_ice_model(name)
        want = np.asarray(j.average_index_of_refraction(jnp.asarray(z1), jnp.asarray(z2)))
        got = t.average_index_of_refraction(torch.as_tensor(z1), torch.as_tensor(z2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
        assert t.has_reflective_bottom == j.has_reflective_bottom
    assert tice.mooresbay_simple.has_reflective_bottom
    assert not tice.southpole_2015.has_reflective_bottom


def test_frequency_grids():
    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu.sim import pipeline as jpipe
    from nuradiomc_tpu.utils import fft as jfft
    from nuradiomc_tpu_torch.models import ice as tice
    from nuradiomc_tpu_torch.sim import pipeline as tpipe
    from nuradiomc_tpu_torch.utils import fft as tfft

    for n_internal, n_base, rate in ((512, 2048, 2.0), (256, 1024, 5.0), (1000, 3001, 3.2)):
        js = jpipe.PipelineSettings(ice=jice.southpole_2015, n_internal=n_internal,
                                    n_base=n_base, sampling_rate=rate)
        ts = tpipe.PipelineSettings(ice=tice.southpole_2015, n_internal=n_internal,
                                    n_base=n_base, sampling_rate=rate)
        np.testing.assert_allclose(ts.freqs_internal, np.asarray(js.freqs_internal), rtol=1e-12)
        np.testing.assert_allclose(ts.freqs_base, np.asarray(js.freqs_base), rtol=1e-12)
        got = tfft.freqs(n_base, rate, device="cpu")
        assert got.dtype == F64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(jfft.freqs(n_base, rate)), rtol=1e-12)
    assert tfft.freqs(8, 1.0, device="cpu", dtype=torch.float32).dtype == torch.float32


def test_askaryan_models():
    from nuradiomc_tpu.ops import askaryan as jask
    from nuradiomc_tpu_torch.ops import askaryan as task

    assert task.MODELS == jask.MODELS
    shape = (3,)
    args = [torch.full(shape, 1e18, dtype=F64), torch.full(shape, 0.9, dtype=F64),
            128, 0.5, torch.ones(shape, dtype=torch.bool), torch.full(shape, 1.78, dtype=F64),
            torch.full(shape, 1000.0, dtype=F64)]
    for model in task.MODELS:
        k_L = torch.full(shape, 10.0, dtype=F64) if model == "Alvarez2009" else None
        assert task.get_frequency_spectrum(*args, model=model, k_L=k_L).shape == (3, 65)


def test_apply_hanning():
    from nuradiomc_tpu.reco import coreas_readers as jcr
    from nuradiomc_tpu_torch.reco import coreas_readers as tcr

    efield = np.random.default_rng(5).normal(size=(400, 3))
    want = jcr.apply_hanning(efield)
    np.testing.assert_allclose(tcr.apply_hanning(efield), want, rtol=1e-12)
    got = tcr.apply_hanning(torch.as_tensor(efield))
    assert isinstance(got, torch.Tensor) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
