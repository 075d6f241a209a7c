"""The control of a cell's correctness check: one run of the cell, as
``benchmark.run`` makes it, whose check then also judges the plain
reference put in the program's place one precision down (bfloat16 for
the filter, float32 with TF32 for BA). The result line carries the
program's numbers under ``compared`` and the control's under
``control``; the control has to fail its limits:

    python -m benchmark.control --workload <cell> --seed <n> --seconds <s>

Not part of the benchmark's own runs."""

import sys

from benchmark import run

if __name__ == "__main__":
    sys.exit(run.main(control=True))
