"""Build and load the port's hand-written GPU kernels.

CUDA C++ sources under ``midi_emotion_tpu_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` into shared libraries with a plain C interface and
loaded with ctypes. Triton kernels compile at their first launch; their
cache is pointed into the same build directory. Everything lands in
``build/`` at the repository root, which git ignores, so a fresh checkout
builds from its sources at first use.

Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit and no triton, and only the functions that launch a kernel
call into it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels build "
        "from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the file name carries a hash of
    the source, every header in ``csrc/`` and the flags, so an edited
    source or header never loads a stale build."""
    digest = hashlib.sha256()
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


# csrc/<name>.cu; the flash kernels 1 and 4 (and kernel 1's wide form)
# include csrc/hopper_sm90.cuh, both decode sources csrc/decode_attn_stacked.cuh;
# the two wide sources hold kernels 1, 4-9 and 13 past their built head widths
CUDA_SOURCES = ("flash_rel_attn_fwd", "flash_rel_attn_bwd", "flash_rel_attn_bwd_kv",
                "flash_rel_attn_bwd_q", "decode_attn_stacked", "flash_rel_attn_wide",
                "decode_attn_wide")


def _start_build(name: str):
    """Start nvcc on ``csrc/<name>.cu`` -> (process, temporary output)."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(name: str, proc, tmp: Path) -> None:
    report = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{report}")
    out = library_path(name)
    out.with_name(out.name + ".log").write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names=CUDA_SOURCES) -> None:
    """Compile every library in ``names`` whose build is missing, one nvcc
    per source, all started together. Raises RuntimeError when one fails."""
    started = [(n, *_start_build(n)) for n in names if not library_path(n).exists()]
    errors = []
    for name, proc, tmp in started:
        try:
            _finish_build(name, proc, tmp)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it.

    The compiler's report (``-Xptxas -v``) is kept beside the library as
    ``<library>.log``. Raises RuntimeError when the build fails."""
    out = library_path(name)
    if not out.exists():
        _finish_build(name, *_start_build(name))
    return ctypes.CDLL(str(out))


def import_triton():
    """Import triton with its home and compile cache inside the build
    directory."""
    os.environ.setdefault("TRITON_HOME", str(BUILD_DIR.parent))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
    import triton  # noqa: PLC0415 -- absent on CPU-only machines

    return triton
