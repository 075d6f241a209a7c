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
                 "posegraph.synthetic", "runtime.config5"):
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
