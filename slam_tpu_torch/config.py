"""Typed configuration: re-exported from ``slam_tpu.config``.

That module is pure Python (no JAX), and ``slam_tpu/__init__.py``
imports only it and ``slam_tpu.maps``, so importing it here pulls in no
JAX. Both packages therefore read the same ``.ini`` files into the same
``SlamConfig``.
"""

from slam_tpu.config import SlamConfig, apply_cli_overrides

__all__ = ["SlamConfig", "apply_cli_overrides"]
