"""Native page IO: PNM decode/encode + threaded prefetching page source
(the port's own copy of `libpillowfight_tpu/io/__init__.py`).

The reference's native layer is its C kernel library (SURVEY.md §1); in
this package the kernels run on the card, so the native layer moves to
the host's real job — decoding and staging pages. `native/libpfio.so`
(C++, ctypes-bound, built on demand like the oracle) provides:

  * `decode_pnm` / `write_ppm` / `write_pgm` — the debug/IO path
    (ref: util.c pf_write_bitmap_to_ppm, SURVEY.md §2.1), and
  * `PnmPageSource` — a double-buffered, multi-threaded prefetcher that
    decodes + white-pads pages to a uniform [H, W] while the card chews on
    the previous chunk; plugs straight into `BatchRunner(source=...)`.

Pure-numpy fallbacks keep everything working if g++ is unavailable.
While a profiler runs, opening a page source (its path list, its decode
pool) is the span `io.open` (`utils.metrics.span`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..utils.metrics import span

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "native", "libpfio.so")
_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        try:  # build on demand (g++ is in the image)
            subprocess.run(["make", "-C", os.path.dirname(_SO)], check=True,
                           capture_output=True, timeout=300)
        except Exception:
            return None
    try:
        _lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _lib.pfio_decode_pnm.restype = u8p
    _lib.pfio_decode_pnm.argtypes = [ctypes.c_char_p, i32p, i32p]
    _lib.pfio_free.argtypes = [u8p]
    _lib.pfio_write_ppm.restype = ctypes.c_int32
    _lib.pfio_write_ppm.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int32,
                                    ctypes.c_int32]
    _lib.pfio_write_pgm.restype = ctypes.c_int32
    _lib.pfio_write_pgm.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int32,
                                    ctypes.c_int32]
    _lib.pfio_pool_new.restype = ctypes.c_void_p
    _lib.pfio_pool_new.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32]
    _lib.pfio_pool_size.restype = ctypes.c_int64
    _lib.pfio_pool_size.argtypes = [ctypes.c_void_p]
    _lib.pfio_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, u8p]
    _lib.pfio_pool_wait.restype = ctypes.c_int64
    _lib.pfio_pool_wait.argtypes = [ctypes.c_void_p]
    _lib.pfio_pool_free.argtypes = [ctypes.c_void_p]
    return _lib


def _u8(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ------------------------------------------------------------ file codecs


def decode_pnm(path: str) -> np.ndarray:
    """Decode a PNM (P2/P3/P5/P6) file to uint8 RGBA [H, W, 4]."""
    lib = _load()
    if lib is not None:
        h = ctypes.c_int32(0)
        w = ctypes.c_int32(0)
        ptr = lib.pfio_decode_pnm(path.encode(), ctypes.byref(h),
                                  ctypes.byref(w))
        if not ptr:
            raise ValueError(f"cannot decode PNM file: {path}")
        try:
            n = h.value * w.value * 4
            arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        finally:
            lib.pfio_free(ptr)
        return arr.reshape(h.value, w.value, 4)
    return _decode_pnm_py(path)


def _decode_pnm_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end : end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxv = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    pos += 1  # single whitespace after maxval
    ch = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P5", b"P6"):
        dt = ">u2" if maxv > 255 else np.uint8
        raw = np.frombuffer(data, dt, count=h * w * ch, offset=pos)
    elif magic in (b"P2", b"P3"):
        toks = data[pos:].split()
        raw = np.array([int(t) for t in toks[: h * w * ch]], dtype=np.int64)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    raw = raw.astype(np.uint32).reshape(h, w, ch)
    if maxv != 255:
        raw = (raw * 255 + maxv // 2) // maxv
    rgb = np.repeat(raw, 3, axis=-1) if ch == 1 else raw
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out


def write_ppm(path: str, arr) -> None:
    """Write RGBA/RGB/gray uint8 as binary PPM (ref: pf_write_bitmap_to_ppm)."""
    arr = _as_rgba(arr)
    lib = _load()
    if lib is not None:
        if lib.pfio_write_ppm(path.encode(), _u8(arr), arr.shape[0],
                              arr.shape[1]) != 0:
            raise OSError(f"cannot write PPM file: {path}")
        return
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(np.ascontiguousarray(arr[..., :3]).tobytes())


def write_pgm(path: str, arr) -> None:
    """Write the R/gray channel as binary PGM."""
    arr = _as_rgba(arr)
    lib = _load()
    if lib is not None:
        if lib.pfio_write_pgm(path.encode(), _u8(arr), arr.shape[0],
                              arr.shape[1]) != 0:
            raise OSError(f"cannot write PGM file: {path}")
        return
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(np.ascontiguousarray(arr[..., 0]).tobytes())


def _as_rgba(arr) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(arr), np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    elif arr.shape[-1] == 3:
        alpha = np.full(arr.shape[:2] + (1,), 255, np.uint8)
        arr = np.concatenate([arr, alpha], axis=-1)
    return np.ascontiguousarray(arr)


# ------------------------------------------------------- prefetch source


class PnmPageSource:
    """Threaded, double-buffered PNM page loader for `BatchRunner`.

    `source(indices)` returns uint8 [n, H, W, 4]; pages smaller than
    (H, W) are white-padded at the bottom/right (white is inert for the
    unpaper filters), larger ones cropped. While the caller processes a
    chunk on the card, the pool is already decoding the next sequential
    chunk into the spare buffer; a sequential access pattern therefore
    hides host decode time entirely.

    LIFETIME CONTRACT: the returned array is a *view into an internal
    double buffer* that the next `__call__` (or the background prefetch
    of the chunk after next) overwrites. Consume it — copy it to the
    device (`torch.from_numpy(...).to(device)`) or `.copy()` it — before
    requesting the next chunk. `BatchRunner` satisfies this by
    construction (it waits for each chunk's copy to the device before
    asking for another).
    """

    def __init__(self, paths, shape: tuple[int, int],
                 n_threads: int | None = None, prefetch: bool = True):
        with span("io.open"):
            self.paths = [os.fspath(p) for p in paths]
            self.shape = (int(shape[0]), int(shape[1]))
            self.prefetch = prefetch
            n_threads = n_threads or min(16, os.cpu_count() or 4)
            self._lib = _load()
            self._pool = None
            if self._lib is not None:
                joined = "\n".join(self.paths).encode()
                self._pool = self._lib.pfio_pool_new(
                    joined, n_threads, self.shape[0], self.shape[1])
        self._bufs = [None, None]   # lazily allocated per chunk size
        self._pending = None        # (start, n, buf_index)
        self.failed = 0

    def __len__(self):
        return len(self.paths)

    def _buf(self, slot: int, n: int) -> np.ndarray:
        h, w = self.shape
        if self._bufs[slot] is None or self._bufs[slot].shape[0] < n:
            self._bufs[slot] = np.empty((n, h, w, 4), np.uint8)
        return self._bufs[slot]

    def _submit(self, start: int, n: int, slot: int) -> None:
        buf = self._buf(slot, n)
        self._lib.pfio_pool_submit(self._pool, start, n, _u8(buf))
        self._pending = (start, n, slot)

    def __call__(self, indices) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        start, n = int(idx[0]), len(idx)
        if self._pool is None:
            return self._load_py(idx)
        contiguous = bool(np.all(idx == np.arange(start, start + n)))
        if self._pending and self._pending[0] == start and \
                self._pending[1] >= n and contiguous:
            _, _, slot = self._pending
        else:
            slot = 0
            if self._pending:          # drain a stale prefetch first
                self._lib.pfio_pool_wait(self._pool)
                self._pending = None
            if not contiguous:         # random access: no prefetch benefit
                return self._load_py(idx)
            self._submit(start, n, slot)
        self.failed += int(self._lib.pfio_pool_wait(self._pool))
        out = self._bufs[slot][:n]
        self._pending = None
        nxt = start + n
        if self.prefetch and nxt < len(self.paths):
            self._submit(nxt, min(n, len(self.paths) - nxt), 1 - slot)
        return out

    def _load_py(self, idx) -> np.ndarray:
        h, w = self.shape
        out = np.full((len(idx), h, w, 4), 255, np.uint8)
        for i, j in enumerate(idx):
            if not 0 <= j < len(self.paths):
                continue
            try:
                page = decode_pnm(self.paths[j])
            except (OSError, ValueError):
                self.failed += 1
                continue
            ch, cw = min(h, page.shape[0]), min(w, page.shape[1])
            out[i, :ch, :cw] = page[:ch, :cw]
        return out

    def close(self) -> None:
        if self._pool is not None:
            if self._pending:
                self._lib.pfio_pool_wait(self._pool)
            self._lib.pfio_pool_free(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode_image(path: str) -> np.ndarray:
    """Decode any scan format to uint8 RGBA [H, W, 4]: PNM via the
    native codec, everything else (JPEG/PNG/TIFF — upstream's test
    corpus is JPEG loaded via PIL, SURVEY.md §4) via Pillow."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pnm", ".ppm", ".pgm", ".pbm"):
        return decode_pnm(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


class ImagePageSource:
    """Threaded, double-buffered page loader for `BatchRunner` over ANY
    PIL-decodable corpus (JPEG/PNG/...; PNM routes through the native
    codec). Same interface and LIFETIME CONTRACT as PnmPageSource: the
    returned array is a view into a double buffer that the next call's
    prefetch overwrites — transfer or copy it before requesting the
    next chunk (BatchRunner does, by construction).

    Decoding runs in a thread pool (PIL's JPEG decoder releases the
    GIL) and the NEXT sequential chunk is prefetched while the caller
    processes the current one, so a 10k-page production run on real
    scans keeps the host-decode/compute overlap the PNM path has."""

    def __init__(self, paths, shape: tuple[int, int],
                 n_threads: int | None = None, prefetch: bool = True):
        import concurrent.futures as cf

        with span("io.open"):
            self.paths = [os.fspath(p) for p in paths]
            self.shape = (int(shape[0]), int(shape[1]))
            self.prefetch = prefetch
            self._pool = cf.ThreadPoolExecutor(
                max_workers=n_threads or min(16, os.cpu_count() or 4))
        self._bufs = [None, None]
        self._pending = None  # (start, n, slot, [futures])
        self.failed = 0

    def __len__(self):
        return len(self.paths)

    def _buf(self, slot: int, n: int) -> np.ndarray:
        h, w = self.shape
        if self._bufs[slot] is None or self._bufs[slot].shape[0] < n:
            self._bufs[slot] = np.empty((n, h, w, 4), np.uint8)
        return self._bufs[slot]

    def _decode_into(self, buf: np.ndarray, i: int, j: int) -> int:
        h, w = self.shape
        buf[i] = 255
        if not 0 <= j < len(self.paths):
            return 0
        try:
            page = decode_image(self.paths[j])
        except Exception:
            return 1
        ch, cw = min(h, page.shape[0]), min(w, page.shape[1])
        buf[i, :ch, :cw] = page[:ch, :cw]
        return 0

    def _submit(self, start: int, n: int, slot: int) -> None:
        buf = self._buf(slot, n)
        futs = [self._pool.submit(self._decode_into, buf, i, start + i)
                for i in range(n)]
        self._pending = (start, n, slot, futs)

    def _wait_pending(self) -> None:
        if self._pending:
            self.failed += sum(f.result() for f in self._pending[3])
            self._pending = None

    def __call__(self, indices) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        start, n = int(idx[0]), len(idx)
        contiguous = bool(np.all(idx == np.arange(start, start + n)))
        if self._pending and self._pending[0] == start and \
                self._pending[1] >= n and contiguous:
            _, _, slot, futs = self._pending
            self.failed += sum(f.result() for f in futs)
            self._pending = None
        else:
            self._wait_pending()
            slot = 0
            if not contiguous:  # random access: decode synchronously
                buf = self._buf(0, n)
                for i, j in enumerate(idx):
                    self.failed += self._decode_into(buf, i, int(j))
                return buf[:n]
            self._submit(start, n, slot)
            self._wait_pending2(slot)
        out = self._bufs[slot][:n]
        nxt = start + n
        if self.prefetch and nxt < len(self.paths):
            self._submit(nxt, min(n, len(self.paths) - nxt), 1 - slot)
        return out

    def _wait_pending2(self, slot: int) -> None:
        if self._pending and self._pending[2] == slot:
            self._wait_pending()

    def close(self) -> None:
        self._wait_pending()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PpmSink:
    """`BatchRunner` sink writing each processed page as out_dir/page_%06d.ppm."""

    def __init__(self, out_dir: str, fmt: str = "page_%06d.ppm"):
        self.out_dir = out_dir
        self.fmt = fmt
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, indices, pages) -> None:
        pages = np.asarray(pages)
        for i, j in enumerate(np.asarray(indices)):
            write_ppm(os.path.join(self.out_dir, self.fmt % int(j)), pages[i])


__all__ = [
    "ImagePageSource", "PnmPageSource", "PpmSink", "available",
    "decode_image", "decode_pnm", "write_pgm", "write_ppm",
]
