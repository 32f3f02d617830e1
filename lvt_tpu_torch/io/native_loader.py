"""ctypes bindings of the port's PNG decoder (``native/png_loader.cpp``).

The port's own image decoder: the machine that runs the port on the card
has no OpenCV. ``png_loader.cpp`` is a copy of lvt_tpu's (8/16-bit gray,
8-bit RGB / RGBA / palette, all five scanline filters, zlib's inflate,
no interlacing); it is built at first use with ``g++ -O3 -std=c++17
-fPIC -shared ... -lz -lpthread`` into ``build/lvt_tpu_torch/``, under a
name hashed from the source and the flags, so an edited source never
loads a stale build (no ``make``, and no ``-march=native``: the library
is shared across machines by its hash, not tuned to one). A process
builds once; concurrent builds each write their own temporary file and
rename it into place. A failed build raises with the compiler's output.

Unlike lvt_tpu's loader, nothing here returns None for a file it cannot
decode: a missing file raises ``FileNotFoundError`` and a PNG the decoder
rejects raises ``ValueError``, so a caller never falls back to another
decoder for a PNG.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "png_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "lvt_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_seconds: float | None = None   # wall time of the g++ run, if any


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblvt_png_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``png_loader.cpp`` (skipped when the library for this exact
    source exists)."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), *LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the PNG decoder failed to build "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial .so
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            handle.lvt_png_probe.argtypes = [
                ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
            handle.lvt_png_read.argtypes = [ctypes.c_char_p, u8p,
                                            ctypes.c_int64]
            handle.lvt_png_read_gray.argtypes = [ctypes.c_char_p, u8p,
                                                 ctypes.c_int64]
            handle.lvt_png_read_gray_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                ctypes.c_int64, ctypes.c_int]
            for fn in (handle.lvt_png_probe, handle.lvt_png_read,
                       handle.lvt_png_read_gray,
                       handle.lvt_png_read_gray_batch):
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def is_png(path: str) -> bool:
    """Whether ``path`` names a PNG, by its extension (as lvt_tpu's
    loaders decide)."""
    return str(path).lower().endswith(".png")


def _check(path: str, rc: int) -> None:
    if rc != 0:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        raise ValueError(f"{path}: PNG rejected by the decoder ({rc})")


def probe(path: str) -> tuple[int, int, int, int]:
    """(width, height, channels, bit_depth) of a PNG."""
    w, h, c, b = (ctypes.c_int() for _ in range(4))
    _check(path, lib().lvt_png_probe(
        os.fsencode(path), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
        ctypes.byref(b)))
    return w.value, h.value, c.value, b.value


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def imread_gray_native(path: str) -> np.ndarray:
    """uint8 [H, W] grayscale (BT.601 luma of a color PNG, the high byte of
    a 16-bit one)."""
    w, h, _, _ = probe(path)
    out = np.empty((h, w), np.uint8)
    _check(path, lib().lvt_png_read_gray(os.fsencode(path), _ptr(out),
                                         out.size))
    return out


def imread_native(path: str) -> np.ndarray:
    """The PNG as stored: uint8 or uint16, [H, W] or [H, W, C] (RGB order;
    a palette expanded to RGB)."""
    w, h, c, bits = probe(path)
    out = np.empty((h, w) if c == 1 else (h, w, c),
                   np.uint16 if bits == 16 else np.uint8)
    _check(path, lib().lvt_png_read(os.fsencode(path), _ptr(out), out.nbytes))
    return out


def imread_gray_batch(paths: list[str], width: int, height: int,
                      n_threads: int = 0) -> np.ndarray:
    """[N, H, W] uint8 grayscale, decoded by a pool of ``n_threads`` (0: one
    per core)."""
    n = len(paths)
    out = np.empty((n, height, width), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib().lvt_png_read_gray_batch(arr, n, _ptr(out), width * height,
                                       n_threads)
    if rc != 0:
        for p in paths:   # name the file at fault
            imread_gray_native(p)
        raise ValueError(f"batch decode failed ({rc})")
    return out
