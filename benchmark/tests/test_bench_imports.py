"""What the benchmark loads: the harness and the reference never load
jax, jaxlib, flax or the JAX package ``slam_tpu`` (top-level names
compared whole: ``slam_tpu_torch`` is not ``slam_tpu``); the reference
loads nothing of the program; no file of the harness names the JAX
package's bench or its files."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "slam_tpu"}

LOAD_ALL = """
import sys
from pathlib import Path
import benchmark.run as run
import benchmark.checks, benchmark.world, benchmark.tracing
import benchmark.recorder, benchmark.filter_cell, benchmark.control
for d in ("drivers", "metrics"):
    for p in sorted((Path("benchmark") / d).glob("*.py")):
        run.load_module(p)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import sys
import benchmark.reference.sim, benchmark.reference.fastslam
import benchmark.reference.ba, benchmark.world
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax_and_no_jax_package():
    assert not top_level(LOAD_ALL) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = top_level(LOAD_REFERENCE)
    assert not mods & (FORBIDDEN | {"slam_tpu_torch"})


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    """A cell run end to end on the CPU: ``benchmark.run`` exits 3 if any
    forbidden module is loaded once the window has closed."""
    code = ("import sys; sys.path.insert(0, 'benchmark/tests');"
            "from conftest import tiny; from benchmark import run;"
            "sys.exit(run.main(['--workload', 'config5-1m.blind', "
            "'--seed', '3', '--seconds', '0.2', '--trace', '0'], "
            "device='cpu', adjust=tiny))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]


def test_no_file_of_the_harness_names_the_jax_bench():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("bench_lines", "slam_tpu/", "import slam_tpu\n",
                     "from slam_tpu ", "slam_tpu.bench", "import jax"):
            assert word not in text, (path, word)
        assert "bench.py" not in text.replace("bench.py's", ""), path
