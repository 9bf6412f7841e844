"""Build the CUDA kernels in ``ctgan_tpu_torch/csrc`` with ``nvcc`` into
shared libraries with a plain C interface, and load them with ``ctypes``.

Each source is compiled for ``sm_90a`` into
``build/ctgan_tpu_torch/<hash>/lib<stem>.so`` under the repository root,
where ``<hash>`` covers the source bytes and the flags, so an edited source
builds anew and an unchanged one is loaded as it is.  A build writes a
temporary file and renames it into place: a build that is cut off leaves no
file that a later run would wait on or load.  Nothing is built at import
time; the wrappers build on first use and ``chip_smoke.py`` builds up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE_DIR", "build_libraries", "library_path", "load_library", "nvcc_path"]

SOURCE_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ctgan_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(stem: str) -> Path:
    digest = hashlib.sha256((SOURCE_DIR / f"{stem}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{stem}.so"


def build_libraries(stems: list[str]) -> dict[str, str]:
    """Compile every source in ``stems`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns each source's ptxas report
    (registers, shared memory, spills); empty for a library already built.
    Raises if a build fails or outlasts its time limit."""
    procs = {}
    for stem in stems:
        lib = library_path(stem)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    reports = {stem: "" for stem in stems}
    failures = []
    for stem, (proc, tmp, lib) in procs.items():
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"{stem}: nvcc ran past {BUILD_TIMEOUT_S} s")
            continue
        reports[stem] = out
        if proc.returncode != 0:
            failures.append(f"{stem}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    if stem not in _loaded:
        build_libraries([stem])
        _loaded[stem] = ctypes.CDLL(str(library_path(stem)))
    return _loaded[stem]
