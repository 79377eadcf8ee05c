"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries with
a plain C interface, and loads them with ctypes.

The build runs at first use, from the sources in the package only, into
``_build/`` beside them (listed in .gitignore). Each library's file name
carries a hash of its flags and of every file under ``csrc/`` that a source
may include (``*.cu``, ``*.cuh``, ``*.h``), so an edited source or header
rebuilds and a stale library is never loaded. ``build`` starts one
``nvcc`` per source, all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# Every kernel source of the port, by stem under csrc/, with the extern "C"
# entry points its library must export.
KERNEL_SOURCES = {
    "flash_attention": (
        "flash_attention_fwd",          # K1, full causal attention
        "flash_attention_partial_fwd",  # K2, one ring step
        "flash_attention_error_string",
    ),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

build_logs: dict[str, str] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (PATH first, then CUDA_HOME/bin), or
    None where the toolkit does not have it."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / name
    return str(candidate) if candidate.exists() else None


def _nvcc() -> str:
    found = cuda_tool("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's kernels need the CUDA "
            "toolkit with sm_90a support"
        )
    return found


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library goes, named by a hash of the flags and
    of every file under csrc/ that it may include."""
    digest = hashlib.sha256(f"{name}\0{' '.join(NVCC_FLAGS)}".encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in SOURCE_SUFFIXES:
            digest.update(f"\0{path.name}\0".encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> None:
    """Compile every named source that has no current library, in parallel.
    Raises with nvcc's output if any build fails."""
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: concurrent builders race safely
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed. Raises
    if it lacks one of its KERNEL_SOURCES entry points."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        missing = [e for e in KERNEL_SOURCES.get(name, ()) if not hasattr(lib, e)]
        if missing:
            raise RuntimeError(f"csrc/{name}.cu exports no {', '.join(missing)}")
        _loaded[name] = lib
    return lib
