"""Build and load the CUDA kernels of ``slam_tpu_torch/csrc``.

Each ``.cu`` source is compiled by its own ``nvcc``, all of them at
once, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in
``slam_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags: editing a source rebuilds it on first use, and an
unchanged tree reuses it.

No fallback: a missing ``nvcc`` or a failed compile raises
``KernelBuildError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# No --use_fast_math: the plain twins use IEEE sin/cos/log/sqrt and
# divisions. --fmad=false keeps a*b+c as two rounded operations, as the
# twins compute it, so kernel and twin differ only by libm rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

MAX_GATHER_ARRAYS = 8  # kMaxArrays in csrc/gather.cu


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class GatherArrays(ctypes.Structure):
    """By-value argument of the gather kernels (SlamGatherArrays in
    csrc/gather.cu)."""
    _fields_ = [("src", ctypes.c_void_p * MAX_GATHER_ARRAYS),
                ("dst", ctypes.c_void_p * MAX_GATHER_ARRAYS),
                ("rows", ctypes.c_int * MAX_GATHER_ARRAYS),
                ("n_arrays", ctypes.c_int)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C signature of every exported launcher; each returns cudaGetLastError().
SIGNATURES = {
    "slam_fs1_observe": [_P] * 9 + [_F] * 3 + [_I] * 3 + [_P],
    "slam_fs1_fused_update": [_P] * 9 + [_F] * 3 + [_I] * 3 + [_P],
    "slam_fs1_fused_update_map": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "slam_fs1_resample_update": [_P] * 14 + [_F] * 3 + [_I] * 5 + [_P],
    "slam_fs1_predict_multi": [_P] * 3 + [_F] * 5 + [_I] * 3 + [_P],
    "slam_fs2_predict_multi": [_P] * 4 + [_F] * 8 + [_I] * 3 + [_P],
    "slam_fs2_predict_tick": [_P] * 6 + [_F] * 10 + [_I] * 2 + [_P],
    "slam_predict_fast_math_sweep": [_P, _P],
    "slam_fs2_refine": [_P] * 9 + [_F] * 3 + [_I] * 2 + [_P] * 2 + [_P],
    "slam_jacobians": [_P] * 6 + [_F] * 3 + [_I] * 2 + [_P] + [_P],
    "slam_sim_control_multi": ([_P] * 7 + [_F] * 9 + [_I] * 2 + [_P] * 8
                               + [_P]),
    "slam_ekf_predict": [_P] * 7 + [_D] * 3 + [_I] * 2 + [_P] * 4 + [_I, _P],
    "slam_sorted_gather": [GatherArrays, _P, _I, _I, _P],
    "slam_bounds_gather": [GatherArrays, _P, _I, _P],
    "slam_gather_max_arrays": [],
    "slam_offspring_bounds": [_P] * 3 + [_I] * 2 + [_P] + [_P],
    "slam_offspring_bounds_workspace": [_I],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header in csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def build_library(nvcc: str | None = None,
                  build_dir: Path | None = None) -> Path:
    """Compile csrc/*.cu into one shared library unless a build of the
    same sources exists; return its path."""
    build_dir = Path(build_dir or BUILD_DIR)
    lib = build_dir / f"libslam_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = nvcc or find_nvcc()
    if nvcc is None or not os.path.isfile(nvcc):
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin): the CUDA kernels of slam_tpu_torch "
            "are built from csrc/ on a machine with the CUDA toolkit")
    build_dir.mkdir(parents=True, exist_ok=True)
    # Compile and link in a private directory, then rename: concurrent
    # builders never load a half-written library.
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed (exit {proc.returncode}): "
                    f"{' '.join(cmd)}\n{out}")
        so = os.path.join(tmp, lib.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's signature."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if lib.slam_gather_max_arrays() != MAX_GATHER_ARRAYS:
        raise KernelBuildError("GatherArrays does not match csrc/gather.cu")
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
