"""ctypes binding of the C++ reference oracle, `oracle/libpf_oracle.so`
(the port's own copy of `libpillowfight_tpu/utils/oracle.py`), and thin
wrappers of its `pf_oracle` command line.

The same functions, signatures and numpy arrays in and out as the
reference's binding, over the same library. Both the library and the
command are built with `make -C oracle` at first use. One difference:
where the reference returns None when the build or the load fails, this
binding raises RuntimeError with make's output, so that a check on the
card cannot pass by skipping the oracle. `available()` says whether it
loads. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

# the oracle's sources; its library and command are built here
ORACLE_DIR = Path(__file__).resolve().parents[2] / "oracle"
_lock = threading.Lock()
_lib = None


def _make() -> None:
    """`make -C ORACLE_DIR` under an exclusive lock on the directory, so
    that processes which load the oracle at once build it once. The
    committed `constants.h` is taken as it is (`-o constants.h`): its
    rule regenerates it from the reference package, which the port does
    not import."""
    try:
        fd = os.open(ORACLE_DIR, os.O_RDONLY)
    except OSError as e:
        raise RuntimeError(f"oracle: no directory {ORACLE_DIR}: {e}") from e
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        r = subprocess.run(["make", "-C", str(ORACLE_DIR), "-j2",
                            "-o", "constants.h"],
                           capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"oracle: make -C {ORACLE_DIR} failed: {e}") from e
    finally:
        os.close(fd)
    if r.returncode != 0:
        raise RuntimeError(f"oracle: make -C {ORACLE_DIR} exited "
                           f"{r.returncode}:\n{r.stdout}{r.stderr}")


def load() -> ctypes.CDLL:
    """The oracle library, built and loaded on first call; raises
    RuntimeError where it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _make()
        try:
            lib = ctypes.CDLL(str(ORACLE_DIR / "libpf_oracle.so"))
        except OSError as e:
            raise RuntimeError(f"oracle: cannot load the library: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i, d = ctypes.c_int, ctypes.c_double
        lib.pf_oracle_gaussian.argtypes = [u8p, u8p, i, i, d, i]
        for name in ("sobel", "canny", "blackfilter", "noisefilter",
                     "blurfilter", "grayfilter", "border", "masks"):
            getattr(lib, f"pf_oracle_{name}").argtypes = [u8p, u8p, i, i]
        lib.pf_oracle_swt.argtypes = [u8p, u8p, i, i, i]
        lib.pf_oracle_masks_multi.argtypes = [u8p, u8p, i, i, i32p, i]
        lib.pf_oracle_ace_samples.argtypes = [u8p, u8p, i, i, i32p, i32p, i,
                                              d, d]
        lib.pf_oracle_ace_pixel_samples.argtypes = [u8p, u8p, i, i, i32p, i,
                                                    d, d]
        lib.pf_oracle_ace_rand.argtypes = [u8p, u8p, i, i, i, d, d,
                                           ctypes.c_uint64]
        lib.pf_oracle_compare.argtypes = [u8p, u8p, u8p, i, i, i, i32p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the oracle builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _buf(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _run(name, page, *extra):
    lib = load()
    page = np.ascontiguousarray(page, np.uint8)
    h, w, _ = page.shape
    out = np.empty_like(page)
    getattr(lib, f"pf_oracle_{name}")(_buf(page), _buf(out), h, w, *extra)
    return out


def gaussian(page, sigma=2.0, nb_stddev=5):
    return _run("gaussian", page, ctypes.c_double(sigma), nb_stddev)


def sobel(page):
    return _run("sobel", page)


def canny(page):
    return _run("canny", page)


def blackfilter(page):
    return _run("blackfilter", page)


def noisefilter(page):
    return _run("noisefilter", page)


def blurfilter(page):
    return _run("blurfilter", page)


def grayfilter(page):
    return _run("grayfilter", page)


def border(page):
    return _run("border", page)


def masks(page):
    return _run("masks", page)


def masks_multi(page, starts):
    """Multi-start masks: starts is a sequence of (y, x) pixel points."""
    lib = load()
    page = np.ascontiguousarray(page, np.uint8)
    pts = np.ascontiguousarray(np.asarray(starts, np.int32).reshape(-1))
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_masks_multi(_buf(page), _buf(out), h, w, _i32(pts),
                              len(pts) // 2)
    return out


def swt(page, output_type=0):
    return _run("swt", page, output_type)


def ace_samples(page, sy, sx, slope=10.0, limit=1000.0):
    """ACE with the samples (sy[i], sx[i]) shared by every pixel."""
    lib = load()
    page = np.ascontiguousarray(page, np.uint8)
    sy = np.ascontiguousarray(sy, np.int32)
    sx = np.ascontiguousarray(sx, np.int32)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_samples(_buf(page), _buf(out), h, w, _i32(sy),
                              _i32(sx), len(sy), ctypes.c_double(slope),
                              ctypes.c_double(limit))
    return out


def ace_pixel_samples(page, idx, slope=10.0, limit=1000.0):
    """Per-pixel explicit samples: idx int32 [H, W, S] flat indices."""
    lib = load()
    page = np.ascontiguousarray(page, np.uint8)
    idx = np.ascontiguousarray(idx, np.int32)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_pixel_samples(_buf(page), _buf(out), h, w, _i32(idx),
                                    idx.shape[-1], ctypes.c_double(slope),
                                    ctypes.c_double(limit))
    return out


def ace_rand(page, nb_samples=100, slope=10.0, limit=1000.0, seed=0):
    """Reference-faithful fully random per-pixel ACE (xorshift stream)."""
    lib = load()
    page = np.ascontiguousarray(page, np.uint8)
    h, w, _ = page.shape
    out = np.empty_like(page)
    lib.pf_oracle_ace_rand(_buf(page), _buf(out), h, w, nb_samples,
                           ctypes.c_double(slope), ctypes.c_double(limit),
                           ctypes.c_uint64(seed))
    return out


def compare(a, b, tolerance=0):
    """(number of pixels that differ, diff image)."""
    lib = load()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    h, w, _ = a.shape
    diff = np.empty_like(a)
    n = ctypes.c_int32(0)
    lib.pf_oracle_compare(_buf(a), _buf(b), _buf(diff), h, w, tolerance,
                          ctypes.byref(n))
    return int(n.value), diff


def _bench(*args: str) -> dict:
    """One run of `pf_oracle ARGS`: its JSON line, {"mp_per_sec",
    "seconds"}; raises RuntimeError on a non-zero exit."""
    load()  # builds the command beside the library
    cmd = [str(ORACLE_DIR / "pf_oracle"), *args]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"oracle: {' '.join(cmd)} exited {r.returncode}:"
                           f"\n{r.stdout}{r.stderr}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return {"mp_per_sec": float(out["mp_per_sec"]),
            "seconds": float(out["seconds"])}


def bench_filter(name: str, h: int, w: int) -> dict:
    """Single-core C rate of one filter on the oracle's own scan-like H x W
    page (`pf_oracle bench-filter NAME H W`): names as the oracle's
    functions (`sobel`, `gaussian`, `canny`, `ace`, `swt`, `blackfilter`,
    ...)."""
    return _bench("bench-filter", name, str(h), str(w))


def bench_unpaper_chain(h: int, w: int) -> dict:
    """Single-core C rate of the six unpaper filters in the chain's order
    (`pf_oracle bench-unpaper-chain H W`)."""
    return _bench("bench-unpaper-chain", str(h), str(w))
