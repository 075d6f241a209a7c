"""The port stands alone: no module of ``slam_tpu_torch``, and not
``chip_smoke.py``, imports the JAX package ``slam_tpu`` or ``jax``.

Two checks: a fresh process imports every module of the package (a
walk over it; all but ``__main__``, which runs the command line) and
loads ``chip_smoke.py`` as a module, then finds neither package, nor a
submodule of either, among the modules it loaded; and a scan of the
same files' syntax trees finds no import statement naming either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "slam_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("slam_tpu", "jax", "jaxlib")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax_package():
    code = f"""
import importlib, importlib.util, pkgutil, sys
before = set(sys.modules)
import slam_tpu_torch
# __main__ runs the command line when imported; the scan covers it.
names = [m.name for m in pkgutil.walk_packages(slam_tpu_torch.__path__,
                                               "slam_tpu_torch.")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
module.KERNELS
loaded = sorted(set(sys.modules) - before)
bad = [m for m in loaded if m.split(".")[0] in {FORBIDDEN!r}]
assert not bad, bad
print(len(names), "modules", *names)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, _, *names = proc.stdout.split()
    assert int(count) >= 20, proc.stdout
    for name in ("posegraph", "posegraph.ba", "posegraph.distributed",
                 "posegraph.synthetic", "runtime.config5", "parallel.mesh",
                 "parallel.distributed", "parallel.resampling",
                 "parallel.filter", "parallel.landmarks", "bench",
                 "quickstart", "ops.kernels.selfcheck", "runtime.anchors"):
        assert f"slam_tpu_torch.{name}" in names, name


def _imports(path: Path):
    """Every absolute module name an import statement in ``path``
    names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom slam_tpu.config import SlamConfig\n"
                     "from slam_tpu_torch import maps\n"
                     "def f():\n    import jax.numpy as jnp\n")
    assert [m for m in _imports(probe) if _forbidden(m)] == [
        "slam_tpu.config", "slam_tpu.config.SlamConfig", "jax.numpy"]


# ---------------------------------------------------------------------------
# The port's public names against the JAX package's
# ---------------------------------------------------------------------------

# What the port leaves out on purpose: the TPU mechanics (ROADMAP.md,
# North star), whole modules (None) or names.
TPU_MECHANICS = {
    "slam_tpu.ops.pallas": None,           # Pallas kernels: csrc/ instead
    "slam_tpu.ops.pallas.gather": None,
    "slam_tpu.ops.pallas.kernels": None,
    "slam_tpu.models.rbpf": {"TILE_SUB", "tile_shape"},  # [8, P/8] tiles
}
JAX_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "slam_tpu").rglob("*.py") if p.name != "__main__.py")


def _defined(path: Path) -> set:
    """The public names a module's top level defines (functions, classes
    and assignments; not what it imports)."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _source(module: str) -> Path:
    path = ROOT.joinpath(*module.split("."))
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


@pytest.mark.parametrize("module", [m for m in JAX_MODULES
                                    if TPU_MECHANICS.get(m, ()) is not None])
def test_port_module_has_the_jax_modules_names(module):
    """Each module of the JAX package has its counterpart in the port
    (``slam_tpu`` -> ``slam_tpu_torch``), which defines or imports every
    public name the JAX module defines, less the written list above;
    an ``__init__``'s ``__all__`` holds the JAX one's."""
    import importlib

    port_name = "slam_tpu_torch" + module[len("slam_tpu"):]
    port = importlib.import_module(port_name)
    want = _defined(_source(module)) - TPU_MECHANICS.get(module, set())
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{port_name} lacks {missing}"
    if _source(module).name == "__init__.py":
        jax_all = importlib.import_module(module).__dict__.get("__all__")
        if jax_all is not None:
            gap = sorted(set(jax_all) - set(getattr(port, "__all__", ())))
            assert not gap, f"{port_name}.__all__ lacks {gap}"
        for name in getattr(port, "__all__", ()):
            assert hasattr(port, name), f"{port_name}.__all__: {name}"


def test_the_written_lists_name_what_the_jax_package_has():
    """Every module and name left out still exists in the JAX package."""
    for module, names in TPU_MECHANICS.items():
        assert module in JAX_MODULES, module
        assert names is None or names <= _defined(_source(module)), module
