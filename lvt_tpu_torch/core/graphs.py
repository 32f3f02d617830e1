"""One device program per tracking step: the step captured in a CUDA graph
and replayed for every frame.

Port of lvt_tpu's execution model. Every tracking entry point of lvt_tpu is
one compiled device program: ``jax.jit`` of the step, a ``lax.scan`` over a
chunk's frames (lvt_tpu/core/step.py, parallel/multistream.py), and the
sharded modes' ``shard_map`` inside ``jit``. Here :class:`StepGraph`
captures one call of a step function

    ``step_fn(state, *frame) -> (state', pose, metrics)``

in a ``torch.cuda.CUDAGraph`` and replays it for every frame, so a chunk of
N frames is N replays of one graph (``jit`` of the step, as lvt_tpu's
``track_step_*``; one graph serves a chunk of any length, ``track`` and
the external corners). The state lives in static buffers between replays:
the graph ends by copying the new state into them (:func:`copy_leaves`:
on the card one launch for every leaf), so replays chain with no host
work. A frame is copied into static
input buffers (device to device) before its replay; the replay's pose and
metrics are static buffers too, which the next replay overwrites.
:meth:`StepGraph.run` copies them out per frame.

The step was built for capture: fixed shapes, no data-dependent branch, no
host sync, and every hand-written kernel launches on the current stream and
allocates nothing (kernels.py). Lazy set-up must not happen during
capture, so a warm-up call runs first, on a side stream and a deep clone
of the state (it never advances the real state): it builds the kernels,
makes the cached uploads of ops/brief.py, creates cuBLAS's and cuSOLVER's
handles and workspaces and NCCL's communicator. The warm-up takes every
branch: :func:`cond` computes both sides outside a capture, so local BA
(core/step.py::_local_ba_update) runs in it whether or not its frame is
one of BA's. Capture uses ``capture_error_mode="thread_local"``:
io/streaming.py tracks in a worker thread while the feeding thread uploads
through pinned memory. Captures in one process take turns (one lock), and
no graph is destroyed while one runs: a runner dropped meanwhile, on any
thread or by the cyclic garbage collector, leaves its graph to be
destroyed when the capture ends.

The eager step runs on the same static buffers (frame copied in, new state
copied back) when the runner's :attr:`StepGraph.mode` is ``"eager"``:

* on the CPU, always (the CPU has no graphs; this is the device the caller
  asked for, not a fallback);
* inside :func:`disable_graphs`, the counterpart of ``jax.disable_jit``;
* when the step's collectives run on a group whose backend cannot be
  captured: gloo carries CUDA tensors through the host and synchronises in
  its own threads. NCCL's all-reduce is captured.

The mode is decided before any capture, and a capture that fails raises:
nothing turns it into an eager run.

lvt_tpu's one ``lax.cond`` (local BA on its schedule) is :func:`cond`.
Where the runner's :attr:`StepGraph.if_nodes` holds (:func:`if_nodes`: a
captured step that is not vmapped), the capture puts its true branch in
a CUDA IF node on the device predicate (CUDA 12.4 or later; the node is
made by ``csrc/graph_cond.cu``, since PyTorch 2.11 has no API for it), so
a replay runs the branch only on the frames whose predicate is set, and
reads the predicate on the device, with no host sync. Everywhere else,
the eager step, the warm-up and a vmapped step (whose predicate is
batched: JAX too lowers ``cond`` to a select under ``vmap``), both sides
are computed and selected.

Launch counts: the kernel wrappers count their launches (``launches``,
and the collective's ``calls``) where Python calls them. In graph mode
that is the warm-up step and the captured one; a replay calls no Python,
so it counts nothing. What a replay ran on the card is read from a kernel
trace (``parallel/dryrun.py::device_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time

import torch
from torch.profiler import record_function

from lvt_tpu_torch.tree import leaves, tree_map

_disabled = 0
_disabled_lock = threading.Lock()
# captures take turns; graphs dropped while one runs wait in _dropped.
# _dropped_lock is re-entrant: a runner can be finalized on a thread that
# already holds it (the collector runs at an allocation there, or a graph
# freed there held the last reference to another runner)
_capture_lock = threading.Lock()
_dropped_lock = threading.RLock()
_capturing = False
_dropped: list = []


@contextlib.contextmanager
def disable_graphs():
    """Run every runner's step eagerly on its static buffers while the
    context is open (process-wide, as ``jax.disable_jit``); a graph already
    captured is kept for later."""
    global _disabled
    with _disabled_lock:
        _disabled += 1
    try:
        yield
    finally:
        with _disabled_lock:
            _disabled -= 1


def graphs_disabled() -> bool:
    return _disabled > 0


def capturable(device, group=None) -> bool:
    """Whether a step on ``device`` whose collectives run on ``group`` can
    be captured: a CUDA device, and no group or an NCCL one."""
    if torch.device(device).type != "cuda":
        return False
    if group is None:
        return True
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


def if_nodes(device, group=None, *, batched: bool = False) -> bool:
    """Whether the runner of a step on ``device`` whose collectives run on
    ``group`` captures :func:`cond` as a CUDA IF node: where the step is
    captured (:func:`capturable`) and not vmapped over streams
    (``batched``: its predicates are batched)."""
    return capturable(device, group) and not batched


# the runner whose warm-up or capture runs on this thread, if it takes
# cond() as an IF node (set only inside StepGraph._capture)
_cond = threading.local()


def cond(pred: torch.Tensor, run, otherwise: torch.Tensor) -> torch.Tensor:
    """lvt_tpu's ``lax.cond(pred, run, lambda: otherwise)`` for a tensor
    result: ``run()`` where the device scalar ``pred`` (bool) is set, else
    ``otherwise``, of ``run()``'s shape and dtype.

    Inside the capture of a runner whose :attr:`StepGraph.if_nodes` holds,
    the result is a buffer allocated before the node as a copy of
    ``otherwise``. ``run()``, followed by the copy of its result into that
    buffer, is captured as a graph of its own (a ``torch.cuda.CUDAGraph``
    in a memory pool of its own, on the runner's branch stream, never
    instantiated; the runner keeps it), and ``csrc/graph_cond.cu`` appends
    to the step's graph a kernel that sets the node's predicate from
    ``pred`` and a CUDA IF node whose body is that graph. So the graph
    after the node reads one fixed address whichever way the node went,
    and the bits are those of the select. The body may hold kernels,
    copies and fills only: no stream-ordered allocation (a library that
    makes one there, as cuSOLVER's one-system solve does, gets the node
    refused). In that runner's warm-up, ``run()`` runs on the branch
    stream and is selected, so the libraries' set-up for that stream
    (cuBLAS's workspace) is made there, outside the capture. Elsewhere
    ``run()`` is computed and selected (``torch.where``)."""
    runner = getattr(_cond, "runner", None)
    if runner is None:
        return torch.where(pred, run(), otherwise)
    step_stream = torch.cuda.current_stream()
    branch_stream = runner._branch_stream
    if not _cond.capturing:
        branch_stream.wait_stream(step_stream)
        with torch.cuda.stream(branch_stream):
            taken = run()
        step_stream.wait_stream(branch_stream)
        taken.record_stream(step_stream)
        return torch.where(pred, taken, otherwise)
    from lvt_tpu_torch import kernels

    out = otherwise.clone()
    branch = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(branch_stream):
        branch.capture_begin(capture_error_mode="thread_local")
        try:
            out.copy_(run())
        finally:
            branch.capture_end()
    runner._branches.append(branch)
    stage = ctypes.c_int(0)
    err = kernels.lib().lvt_if_node(step_stream.cuda_stream, pred.data_ptr(),
                                    branch.raw_cuda_graph(),
                                    ctypes.byref(stage))
    if err:
        counts = (ctypes.c_int * len(_NODE_TYPES))()
        kernels.lib().lvt_graph_node_counts(branch.raw_cuda_graph(), counts,
                                            len(_NODE_TYPES))
        held = {t: c for t, c in zip(_NODE_TYPES, counts) if c}
        kernels.check(err, f"if_node (step {stage.value}; the branch holds "
                           f"{held})")
    return out


# cudaGraphNodeType's names, in its order
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "semaphore_signal",
               "semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


def _unaliased(dsts, srcs) -> list:
    """``srcs``, each that shares storage with one of ``dsts`` cloned, so
    that no buffer is read after it was overwritten."""
    held = {d.untyped_storage().data_ptr() for d in dsts}
    return [s.clone() if s.untyped_storage().data_ptr() in held else s
            for s in srcs]


def copy_into(dst, src) -> None:
    """Every leaf of ``src`` into the same leaf of ``dst`` (a state's
    static buffers). A source that shares storage with a buffer is copied
    first, so no buffer is read after it was overwritten."""
    dsts = leaves(dst)
    for d, s in zip(dsts, _unaliased(dsts, leaves(src))):
        d.copy_(s)


def copy_leaves(dst, src) -> None:
    """The runner's copy of a step's new state ``src`` into its static
    buffers ``dst``: :func:`copy_into`'s contract (a source that shares
    storage with a buffer is cloned first). CUDA tensors: one launch of
    ``csrc/tail.cu``'s ``copy_leaves_kernel`` for every leaf (a table of
    pointers and sizes by value, at most ``tail_shape()[0]`` leaves; each
    leaf's dtype and shape its buffer's, both contiguous); CPU tensors:
    :func:`copy_into`."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core.tail import tail_shape

    dsts = leaves(dst)
    if dsts[0].device.type == "cpu":
        copy_into(dst, src)
        return
    pairs = list(zip(dsts, _unaliased(dsts, leaves(src))))
    for d, s in pairs:
        kernels.require(d, "copy_leaves dst", d.dtype)
        kernels.require(s, "copy_leaves src", d.dtype, d.shape, d.device)
    if len(pairs) > tail_shape()[0]:
        raise ValueError(f"copy_leaves: {len(pairs)} leaves exceed the "
                         f"kernel's {tail_shape()[0]}")
    ptrs = (ctypes.c_void_p * (2 * len(pairs)))(*(
        t.data_ptr() for d, s in pairs for t in (s, d)))
    nbytes = (ctypes.c_longlong * len(pairs))(*(
        d.numel() * d.element_size() for d, _ in pairs))
    with torch.cuda.device(dsts[0].device):
        err = kernels.lib().lvt_copy_leaves(ptrs, nbytes, len(pairs),
                                            kernels.stream_ptr(dsts[0]))
    kernels.check(err, "copy_leaves")
    copy_leaves.launches += 1


copy_leaves.launches = 0


class StepGraph:
    """``step_fn(state, *frame) -> (state', pose, metrics)`` run frame by
    frame on static buffers: replayed from a CUDA graph captured at the
    first frame, or called eagerly (module docstring).

    ``state``: the state's buffers, written in place and never rebound
    (several runners of one system share them). ``example_inputs``: one
    frame's per-frame inputs (a frame pair, a depth image, corner arrays);
    each gets a static buffer of its shape and dtype. Fixed inputs (the
    rectification maps) are held by ``step_fn`` as they are. ``group``:
    the process group of the step's collectives, if any. ``batched``: the
    step is vmapped over streams (:func:`if_nodes`)."""

    def __init__(self, step_fn, state, example_inputs, *, group=None,
                 batched: bool = False):
        self.step_fn = step_fn
        self.state = state
        self.device = leaves(state)[0].device
        self.capturable = capturable(self.device, group)
        self.if_nodes = if_nodes(self.device, group, batched=batched)
        self.inputs = tuple(torch.empty_like(x, memory_format=torch
                                             .contiguous_format)
                            for x in example_inputs)
        self.capture_seconds: float | None = None
        self.replays = 0
        self._graph = None
        self._out = None
        self._branches: list = []   # the IF nodes' bodies (cond)
        self._branch_stream = None

    @property
    def mode(self) -> str:
        """``"graph"`` where the next frame replays the captured graph,
        ``"eager"`` where it calls ``step_fn``."""
        return ("graph" if self.capturable and not graphs_disabled()
                else "eager")

    def _step(self):
        new, pose, metrics = self.step_fn(self.state, *self.inputs)
        with record_function("step_tail"):
            copy_leaves(self.state, new)
        return pose, metrics

    def _capture(self) -> None:
        global _capturing
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        if self.if_nodes:
            self._branch_stream = torch.cuda.Stream(self.device)
            _cond.runner, _cond.capturing = self, False
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                scratch = tree_map(torch.clone, self.state)
                copy_leaves(scratch, self.step_fn(scratch, *self.inputs)[0])
                del scratch
        finally:
            _cond.runner = None
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            with _dropped_lock:
                _capturing = True
            # the cyclic collector stays off as well: on the card a
            # capture was invalidated when it freed, mid-capture, a dropped
            # system holding a graph of its own
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    if self.if_nodes:
                        _cond.runner, _cond.capturing = self, True
                    try:
                        out = self._step()
                    finally:
                        _cond.runner = None
                        graph.capture_end()
            finally:
                if gc_was_on:
                    gc.enable()
                with _dropped_lock:
                    _capturing = False
                    _dropped.clear()
        self._graph, self._out = graph, out
        self.capture_seconds = time.perf_counter() - t0

    def __del__(self):
        # a graph is not destroyed while a capture runs: it waits in
        # _dropped until the capture ends (at interpreter exit this
        # module's globals may already be None)
        if _dropped_lock is None:
            return
        with _dropped_lock:
            if _capturing and getattr(self, "_graph", None) is not None:
                _dropped.append(self._graph)
                _dropped.extend(self._branches)
            self._graph = None
            self._branches = []

    def replay(self, *frame):
        """One frame: its inputs copied into the static buffers, then the
        graph replayed (captured first if this is its first frame) or the
        step called. Returns (pose, metrics); in graph mode these are
        static buffers that the next replay overwrites."""
        for buf, x in zip(self.inputs, frame):
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"frame input {tuple(x.shape)} {x.dtype}, "
                                 f"the runner's {tuple(buf.shape)} "
                                 f"{buf.dtype}")
            buf.copy_(x)
        if self.mode == "eager":
            return self._step()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        return self._out

    def run(self, *xs):
        """The frames along the leading axis of ``xs``, in order (lvt_tpu's
        ``lax.scan``); returns (poses [N], metrics [N]) in new tensors."""
        n = xs[0].shape[0]
        out = None
        for i in range(n):
            step_out = self.replay(*(x[i] for x in xs))
            if out is None:
                out = tuple(tree_map(lambda y: y.new_empty((n, *y.shape)), o)
                            for o in step_out)
            for o, s in zip(out, step_out):
                tree_map(lambda d, y: d[i].copy_(y), o, s)
        return out


def runner(runners: dict, kind: str, make_step, state, xs, *,
           group=None, batched: bool = False) -> StepGraph:
    """The runner in ``runners`` (a system's) of entry point ``kind`` for
    frames shaped as the leading-axis slices of ``xs`` (their dtypes and
    shapes), made on first use with the step function ``make_step()``
    returns."""
    key = (kind, *((x.dtype, tuple(x.shape[1:])) for x in xs))
    if key not in runners:
        runners[key] = StepGraph(make_step(), state, [x[0] for x in xs],
                                 group=group, batched=batched)
    return runners[key]
