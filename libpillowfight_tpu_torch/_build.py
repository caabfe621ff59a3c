"""Build the CUDA kernels of `csrc/` at first use and load them.

Each `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for sm_90a, then linked into one shared library with a plain C
interface, loaded with ctypes. The library's name carries a hash of the
sources, so an edit rebuilds and a stale build is never loaded. Nothing
outside this package's own `csrc/` is compiled. What ptxas reports for
each kernel (registers, shared memory, spills) is kept beside the library
and read with `resource_usage`.

Every C entry takes its pointers and the stream as `void*` and returns
`cudaGetLastError()` after its launches; `check` raises if that is not 0.
The wrappers of `ops/cuda` reach the entries through `launch` (the
kernels) and `host_size` (the two entries that size a buffer on the
host) only: `launch` makes the tensor's device the current CUDA device
around the call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
FP = ctypes.POINTER(ctypes.c_float)  # a host array of floats
IP = ctypes.POINTER(ctypes.c_int)  # a host int the entry writes
IA = ctypes.POINTER(ctypes.c_int)  # a host array of ints
# C signature of every entry: name -> argument types (return type int)
_SIGNATURES = {
    "pft_line_counts": [P, P, I, I, I, P],
    "pft_pack_rows": [P, P, I, I, I, P],
    "pft_unpack_rows": [P, P, I, I, I, P],
    "pft_flood_packed_smem": [I, I],  # returns bytes, not an error code
    "pft_flood_packed": [P, P, P, P, P, I, I, I, I, I, P],
    "pft_noise_cert": [P, P, P, I, I, I, I, I, P],
    "pft_noise_ball": [P, P, I, I, I, I, P],
    "pft_gaussian_sep": [P, P, FP, I, I, I, I, IP, P],
    "pft_ace_spray": [P, P, P, P, P, P, I, I, I, I, F, F, I, P],
    "pft_label_scratch_bytes": [I, I],  # returns bytes, not an error code
    "pft_label_links": [P, P, P, P, P, P, P, I, I, I, P],
    "pft_flood_sweep": [P, P, P, I, I, I, I, I, P],
    "pft_swt_maps": [P, P, P, P, P, P, P, I, I, I, IA, FP, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpft_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library (no-op when present).
    Processes that build at once take turns on an exclusive lock of
    `_build/build.lock` (released when its holder exits, however it
    exits): the first compiles, the others find its library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors, logs = [], []
        for src, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(tmp_so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or none


def resource_usage(source: str) -> list[str]:
    """What ptxas reported for the kernels of one source of the built
    library (for example "ace_spray.cu"): a line a kernel, its mangled
    name and its registers, shared memory and spills."""
    log = build().with_suffix(".log")
    if not log.exists():
        return []
    lines, out, name = log.read_text().splitlines(), [], None
    inside = False
    for line in lines:
        if line.startswith("== "):
            inside = line == f"== {source}"
        elif inside and "Compiling entry function" in line:
            name = line.split("'")[1]
        elif inside and name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(entry: str, t: torch.Tensor, *args) -> None:
    """Call the C entry `entry` with `args` and the current stream of t's
    device, t's device made the current CUDA device around the call, and
    raise on a CUDA error. An entry launches on, and reads the attributes
    of, the current device, and CUDA refuses a launch into the stream of
    another device: without the guard a call on a tensor of `cuda:1`
    while `cuda:0` is current would fail."""
    fn = getattr(load(), entry)
    with torch.cuda.device(t.device):
        err = fn(*args, stream_of(t))
    check(err, entry)


def host_size(entry: str, *args) -> int:
    """The bytes an entry that sizes a buffer on the host returns
    (`pft_flood_packed_smem`, `pft_label_scratch_bytes`): no launch."""
    return getattr(load(), entry)(*args)
