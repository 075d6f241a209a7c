"""Map I/O: re-exported from ``slam_tpu.maps`` (pure numpy, no JAX)."""

from slam_tpu.maps import SlamMap, read_map_file, synthetic_map, write_map_file

__all__ = ["SlamMap", "read_map_file", "synthetic_map", "write_map_file"]
