"""Python side of the port's C ABI (``liblvt_c_torch.so``), and its build.

Port of lvt_tpu/capi.py. The reference ships a C interface around
``lvt_system`` (lvt/src/lvt_c.h:57-62, lvt/src/lvt_c.cpp:33-148): an
opaque handle made from a YAML config and a sensor type, tracking on raw
``unsigned char*`` grayscale buffers into R[3][3] and t[3], a status
query. ``native/lvt_c.h`` is that surface, byte for byte lvt_tpu's, and
``native/lvt_c.cpp`` embeds CPython and forwards each call here, so a C
integration of the reference or of lvt_tpu switches to the port by
relinking against ``liblvt_c_torch.so``.

The C surface has no device argument: ``create`` places the system on the
device that the environment variable ``LVT_TPU_TORCH_DEVICE`` names
(default ``cuda``; without CUDA, ``lvt_create`` returns NULL). The error
contract is the reference's: NULL on a failed create, the identity R and
t on a failed track.

:func:`build` compiles the library with ``g++`` and the flags of
``python3-config --includes`` and ``--ldflags --embed`` into
``build/lvt_tpu_torch/liblvt_c_torch.so``; nothing is built at import.
A C program links it with ``-I lvt_tpu_torch/native -L
build/lvt_tpu_torch -llvt_c_torch`` and runs with ``PYTHONPATH`` naming
the repository (``LVT_PYTHON`` may name the interpreter to embed).
"""

from __future__ import annotations

import hashlib
import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lvt_tpu_torch"
LIBRARY = BUILD_DIR / "liblvt_c_torch.so"
DEVICE_ENV = "LVT_TPU_TORCH_DEVICE"

_systems: dict[int, object] = {}
_next_handle: int = 1


def create(config_path: str, sensor_type: int) -> int:
    """A VO system from a YAML config, on ``$LVT_TPU_TORCH_DEVICE``; its
    integer handle (the C layer turns an exception into NULL)."""
    global _next_handle
    from lvt_tpu_torch.config import load_config
    from lvt_tpu_torch.core.system import SensorType, VOSystem

    vo = VOSystem.create(load_config(config_path), SensorType(sensor_type),
                         device=os.environ.get(DEVICE_ENV, "cuda"))
    handle = _next_handle
    _next_handle += 1
    _systems[handle] = vo
    return handle


def destroy(handle: int) -> None:
    _systems.pop(handle, None)


def _image(buf, n_rows: int, n_cols: int) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint8,
                         count=n_rows * n_cols).reshape(n_rows, n_cols)


def _pose_tuple(vo) -> tuple:
    """Row-major R then t, 12 floats, from one host copy of the pose."""
    from lvt_tpu_torch.io.trajectory import pose_to_rt

    r, t = pose_to_rt(vo.last_pose)
    return tuple(float(x) for x in r.reshape(-1)) + tuple(float(x) for x in t)


def track(handle: int, left, right, n_rows: int, n_cols: int) -> tuple:
    """One frame on raw grayscale buffers; returns R[3][3] and t[3] as 12
    floats (lvt_c.cpp:63-88)."""
    from lvt_tpu_torch.core.system import SensorType

    vo = _systems[handle]
    img_l = _image(left, n_rows, n_cols)
    img_r = _image(right, n_rows, n_cols)
    if vo.sensor_type == SensorType.RGBD:
        # both buffers are unsigned char in the C surface: RGB-D depth is
        # 8-bit metric depth, as a CV_8UC1 cv::Mat is (lvt_c.cpp:69-70)
        img_r = img_r.astype(np.float32)
    vo.track(img_l, img_r)
    return _pose_tuple(vo)


def track_with_external_corners(
    handle: int, left, right, n_rows: int, n_cols: int,
    corners_left, n_corners_left: int, corners_right, n_corners_right: int,
) -> tuple:
    """One stereo frame described at the caller's corners, double[N][2]
    (lvt_c.cpp:90-134)."""
    vo = _systems[handle]
    cl = np.frombuffer(corners_left, dtype=np.float64,
                       count=2 * n_corners_left).reshape(-1, 2)
    cr = np.frombuffer(corners_right, dtype=np.float64,
                       count=2 * n_corners_right).reshape(-1, 2)
    vo.track_with_external_corners(_image(left, n_rows, n_cols),
                                   _image(right, n_rows, n_cols), cl, cr)
    return _pose_tuple(vo)


def get_status(handle: int) -> int:
    """1 = not initialized, 2 = tracking, 3 = lost, 0 = no such handle
    (lvt_c.h:62)."""
    vo = _systems.get(handle)
    return 0 if vo is None else int(vo.get_state())


def reset(handle: int) -> None:
    """lvt_reset: clear the map and the state machine."""
    vo = _systems.get(handle)
    if vo is not None:
        vo.reset()


# -- the shared library --------------------------------------------------
def _python_config() -> str:
    """The python3-config of this interpreter, else the one on PATH."""
    own = Path(sys.executable).with_name(Path(sys.executable).name
                                         + "-config")
    found = str(own) if own.exists() else shutil.which("python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C ABI library "
                           "cannot be built")
    return found


def _flags(config: str, *args: str) -> list[str]:
    return shlex.split(subprocess.run([config, *args], check=True,
                                      capture_output=True,
                                      text=True).stdout)


def build() -> Path:
    """Compile ``native/lvt_c.cpp`` into ``liblvt_c_torch.so`` (skipped
    when the library was built from these exact sources and flags, which
    a stamp beside it records). Raises with the compiler's output."""
    config = _python_config()
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
           "-shared", *_flags(config, "--includes"), "-o", "{out}",
           str(NATIVE_DIR / "lvt_c.cpp"), *_flags(config, "--ldflags",
                                                  "--embed")]
    h = hashlib.sha256(" ".join(cmd).encode())
    for name in ("lvt_c.cpp", "lvt_c.h"):
        h.update((NATIVE_DIR / name).read_bytes())
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and \
            stamp.read_text() == h.hexdigest():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd[cmd.index("{out}")] = str(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"liblvt_c_torch.so failed to build "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(h.hexdigest())
    return LIBRARY


def build_example(exe) -> Path:
    """Compile ``native/lvt_c_example.c``, a C program on the C surface,
    into ``exe``, linked against the library (built first)."""
    lib = build()
    cmd = [os.environ.get("CC", "gcc"), "-O1", "-o", str(exe),
           str(NATIVE_DIR / "lvt_c_example.c"), f"-I{NATIVE_DIR}",
           f"-L{lib.parent}", "-llvt_c_torch", f"-Wl,-rpath,{lib.parent}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the C example failed to build:\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return Path(exe)


def example_env(device: str) -> dict:
    """The environment a C program on the library runs in: the embedded
    interpreter is this one (``LVT_PYTHON``), finds this repository on
    ``PYTHONPATH`` and places the system on ``device``."""
    env = dict(os.environ)
    env.update(LVT_PYTHON=sys.executable, PYTHONPATH=str(NATIVE_DIR.parent
                                                          .parent),
               **{DEVICE_ENV: device})
    return env
