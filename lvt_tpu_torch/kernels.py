"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels are plain-C-interface CUDA C++ for ``sm_90a`` (Hopper), built
with ``nvcc`` (one process per source, in parallel) into one shared library
under ``build/lvt_tpu_torch/`` at the first call that needs them and loaded
with ``ctypes``. Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.

The library name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited kernel never loads a stale
build. Each kernel launches on the stream it is
given (the wrapper passes ``torch.cuda.current_stream()``), allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lvt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    "lvt_perception": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    "lvt_brief_planes": [_P, _P, _I, _I, _I, _P],
    "lvt_describe_refine": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _P],
    "lvt_hamming_top2": [_P] * 8 + [_I, _I, _I, _F, _F, _F, _F, _I, _P, _P,
                                    _P],
    "lvt_pnp_normal_eqs": [_P, _P, _P, _I, _I, _P, _P, _P],
    "lvt_stream_sum": [_P, _I, _I, _P, _P],
    "lvt_pnp_solve": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P, _P,
                      _P, _P, _P, _P, _P],
    "lvt_pnp_shape": [_P],
    "lvt_pnp_phase": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                      _F, _P, _P, _P, _P, _P],
    "lvt_ba_refine": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                      _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    "lvt_ba_max_window": [],
    "lvt_ba_geometry": [_P],
    "lvt_ba_launches": [_P],
    "lvt_ba_scratch_per_point": [_I],
    "lvt_ba_phase": ([_I, _I] + [_P] * 7 + [_I] * 4 + [_F] * 7 + [_P] * 7
                     + [_P]),
    "lvt_ba_phase_shape": [_I, _I, _P],
    "lvt_ba_phase_launches": [_P],
    "lvt_predict_project": [_P] * 9 + [_I, _I] + [_P] * 6,
    "lvt_upkeep_pre": [_P] * 11 + [_I] * 5 + [_P] * 11,
    "lvt_staged_promote": ([_P] * 16 + [_I] * 4 + [_F, _F, _I, _I, _I]
                           + [_P] * 10),
    "lvt_triangulate_insert": ([_P] * 24 + [_I] * 5
                               + [_P, _I, _I, _I, _F, _I] + [_P] * 17),
    "lvt_track_shape": [_P],
    "lvt_track_max_clusters": [_I] * 6,
    "lvt_map_accept": [_P] * 5 + [_I] * 3 + [_F, _F, _I] + [_P] * 9,
    "lvt_ba_observe": [_P] * 21 + [_I] * 4 + [_F, _F, _I] + [_P] * 9,
    "lvt_select_geometry": [_I] * 5 + [_P],
    "lvt_select_max_clusters": [_I] * 7,
    "lvt_select_corners": ([_P, _P] + [_I] * 7 + [_F, _F] + [_I] * 6
                           + [_P] * 13),
    "lvt_step_tail": [_P] * 4 + [_I] + [_P] * 7 + [_I] * 6 + [_P],
    "lvt_copy_leaves": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                        _P],
    "lvt_tail_shape": [_P],
    "lvt_if_node": [_P, _P, _P, _P],
    "lvt_graph_node_counts": [_P, _P, _I],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the nvcc run, if any
build_report: str = ""   # nvcc's output of a verbose build (ptxas's report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblvt_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails, else return
    their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (skipped when
    the library for these exact sources exists): one nvcc per source, all
    started together, then one link. ``verbose`` adds ``-Xptxas -v`` and
    prints nvcc's report of registers and spills (also kept in
    ``build_report``)."""
    global build_seconds, build_report
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{tag}.so.tmp")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    try:
        report = _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                        str(src)] for src, obj in zip(sources, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        build_report = report
        print(report)
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial .so
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.lvt_error_string.argtypes = [ctypes.c_int]
        handle.lvt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def ptxas_report(kernel: str, report: str | None = None) -> list[str]:
    """ptxas's lines on one kernel (its mangled name holds ``kernel``) in
    a verbose build's report: the stack frame and spills, and the
    registers, barriers and shared memory it uses."""
    lines = (build_report if report is None else report).splitlines()
    out, inside = [], False
    for line in lines:
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "Used" in line):
            out.append(line.split(":", 1)[-1].strip()
                       if "Used" in line else line.strip())
    return out


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().lvt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fold_streams(info, in_dims, tensors) -> list[torch.Tensor]:
    """For a ``register_vmap`` rule of an op over a leading stream axis S:
    vmap's axis B moved to the front of every tensor (an unbatched one is
    expanded to B) and folded with S, as contiguous [B * S, ...] tensors
    that one launch takes; the rule unfolds the outputs to [B, S, ...]."""
    b = info.batch_size
    flat = []
    for x, d in zip(tensors, in_dims):
        x = x.expand(b, *x.shape) if d is None else x.movedim(d, 0)
        flat.append(x.reshape(b * x.shape[1], *x.shape[2:]).contiguous())
    return flat


def per_stream(plain, n_tensors: int, args) -> tuple:
    """The CPU kernel of an op over a leading stream axis S: ``plain``
    (flat single-stream tensors in and out) on each stream of the [S, ...]
    tensor arguments (the first ``n_tensors``), the outputs stacked."""
    s = args[0].shape[0]
    outs = [plain(*(a[i] for a in args[:n_tensors]), *args[n_tensors:])
            for i in range(s)]
    return tuple(torch.stack(o) for o in zip(*outs))


def register_stream_op(module, name: str, cpu, fake, n_tensors: int) -> None:
    """The CPU kernel, fake kernel and vmap rule of the op ``{name}_op`` of
    ``module`` over a leading stream axis (its first ``n_tensors``
    arguments are tensors): vmap's axis B and the stream axis S fold into
    one axis of B * S streams (:func:`fold_streams`), the op runs once,
    looked up on the module when the rule runs (so a wrapper patched over
    it sees the folded launch), and the outputs unfold to [B, S, ...]."""
    op = getattr(module, f"{name}_op")
    op.register_kernel("cpu")(cpu)
    op.register_fake(fake)

    def rule(info, in_dims, *args):
        b = info.batch_size
        flat = fold_streams(info, in_dims[:n_tensors], args[:n_tensors])
        outs = getattr(module, f"{name}_op")(*flat, *args[n_tensors:])
        return (tuple(x.view(b, x.shape[0] // b, *x.shape[1:]) for x in outs),
                (0,) * len(outs))

    op.register_vmap(rule)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: torch.device | None = None) -> None:
    """Wrapper-side argument checks: the kernels trust their inputs."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
