"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, cached under ``build/kernels/`` by a
hash of that source and the flags, and loaded with ``ctypes`` by its
wrapper (``ops/csm_cuda.py``, ``ops/hit_images_cuda.py``).  Nothing is
built when a module is imported.  :func:`build` starts one ``nvcc`` per
source, all at once, so several kernels build in the time of the slowest.
:func:`sass_counts` counts an instruction in each kernel of a built
library, from the toolkit's disassembler.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is cached: the file name
    carries a hash of the source and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(*names: str) -> dict:
    """Compile every ``csrc/<name>.cu`` not built yet, all nvcc processes
    started together.  Returns ``{name: {"path", "seconds", "log",
    "cached"}}``; ``log`` holds nvcc's output, including ``-Xptxas -v``'s
    register and shared-memory report.  Raises if any build fails."""
    out, running = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            out[name] = dict(path=so, seconds=0.0, log="", cached=True)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, so, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, so, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = dict(path=so, seconds=seconds, log=log, cached=False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def sass_counts(path, opcode: str) -> dict:
    """How often the SASS instruction ``opcode`` (``F2F.F64.F32``, say;
    its variants with further suffixes too) occurs in each kernel of the
    library at ``path``: ``{mangled kernel name: count}``, from the
    toolkit's ``cuobjdump -sass`` (beside ``nvcc``)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    pattern = re.compile(rf"\b{re.escape(opcode)}\b")
    counts, kernel = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            counts[kernel] = 0
        elif kernel is not None and pattern.search(line):
            counts[kernel] += 1
    return counts
