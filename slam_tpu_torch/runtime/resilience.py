"""Recovery from a failed run (counterpart:
slam_tpu.runtime.resilience).

The reference exits on any fatal error (core.cpp:858-859,891,913): no
retry, no recovery. Here recovery is checkpoint and resume: the wrapper
runs ``Runner.run_checkpointed`` and, when it raises (out of device
memory, a lost device, any runtime failure), enters it again from the
last chunk saved. A resume is bit-exact, so a recovered run ends where
the run without the failure would have.
"""

from __future__ import annotations

import sys
import time


def run_resilient(runner, *, seed: int = 0, n_ticks: int | None = None,
                  every: int = 50, ckpt_path: str = "ckpt/run",
                  max_retries: int = 3, backoff_s: float = 5.0):
    """``runner.run_checkpointed`` that resumes after a failure, waiting
    ``backoff_s`` times the attempt's number first.

    Returns the RunResult of the run (of its last part, if it resumed).
    Raises after ``max_retries`` failures in a row."""
    attempt = 0
    while True:
        try:
            return runner.run_checkpointed(
                seed=seed, n_ticks=n_ticks, every=every,
                ckpt_path=ckpt_path, resume=attempt > 0)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 (any device failure)
            attempt += 1
            print(f"run failed ({type(e).__name__}: {e}); "
                  f"retry {attempt}/{max_retries} from checkpoint",
                  file=sys.stderr)
            if attempt > max_retries:
                raise
            time.sleep(backoff_s * attempt)
