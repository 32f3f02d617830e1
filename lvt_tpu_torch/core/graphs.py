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
the external corners). The state lives in static buffers between replays,
the frame's inputs in static input buffers, and a chunk's poses and
metrics in its own new tensors (rows [N, ...]): the frame ends on the
device (:class:`Epilogue`), so replays chain with no host work. A chunk
starts with one launch (``copy_leaves``: the chunk's table on the device,
a counter at 0, frame 0 copied into the input buffers); then each frame
is one replay, whose last launch writes the new state into the buffers,
the pose and metrics into row i of the chunk's tensors and frame i + 1
into the input buffers, and advances the counter: on the card the step's
tail itself (core/tail.py, ``step_tail``), where the step has no group;
with one, ``copy_leaves`` after the tail's torch ops; on the CPU torch
ops (``index_copy_`` by the same counter).

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

The eager step runs on the same static buffers, the same table and the
same counter when the runner's :attr:`StepGraph.mode` is ``"eager"``:

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

import bisect
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


def overlapping(dsts, srcs) -> list[bool]:
    """For each of ``srcs``, whether it overlaps one of the buffers
    ``dsts`` other than as the buffer it goes to (``srcs[i]`` to
    ``dsts[i]``: the same address and size)."""
    spans = sorted((d.data_ptr(), d.data_ptr() + d.numel() * d.element_size())
                   for d in dsts if d.numel())
    starts = [a for a, _ in spans]
    out = []
    for i, src in enumerate(srcs):
        nbytes = src.numel() * src.element_size()
        p = src.data_ptr() if nbytes else 0
        own = dsts[i] if i < len(dsts) else None
        j = bisect.bisect_left(starts, p + nbytes) - 1
        hit = nbytes > 0 and j >= 0 and spans[j][1] > p
        same = (own is not None and p == own.data_ptr()
                and nbytes == own.numel() * own.element_size())
        out.append(hit and not same)
    return out


def unaliased(dsts, srcs) -> list:
    """``srcs``, each that :func:`overlapping` finds cloned, so that no
    buffer is read after it was overwritten by a copy that writes every
    buffer (a unit of a leaf is read before it is written,
    csrc/tail.cu)."""
    return [s.clone() if hit else s
            for s, hit in zip(srcs, overlapping(dsts, srcs))]


def copy_into(dst, src) -> None:
    """Every leaf of ``src`` into the same leaf of ``dst`` (a state's
    static buffers), torch copies. A source that overlaps another buffer
    is copied first, so no buffer is read after it was overwritten."""
    dsts = leaves(dst)
    for d, s in zip(dsts, unaliased(dsts, leaves(src))):
        d.copy_(s)


# copy_leaves_kernel's modes (csrc/tail.cu)
PLAIN, START, FRAME = 0, 1, 2


def _rows_of(outputs) -> list:
    """The leaves of one frame's (pose, metrics) pair, in order."""
    return [x for tree in outputs for x in leaves(tree)]


def copy_leaves(dst, src, *, rows=None, epilogue=None) -> None:
    """The runner's copy of a step's new state ``src`` into its static
    buffers ``dst``: :func:`copy_into`'s contract (a source that overlaps
    another buffer is cloned first). With the runner's chunked
    ``epilogue`` (:class:`Epilogue`) also the frame's end: ``rows`` (the
    frame's (pose, metrics)) into row i of the chunk's tensors, frame i + 1
    into the input buffers, the counter advanced. CUDA tensors: one launch
    of ``csrc/tail.cu``'s ``copy_leaves_kernel`` (a table of pointers and
    sizes by value, at most ``tail_shape()[0]`` leaves and rows; each
    leaf's dtype and shape its buffer's, both contiguous); CPU tensors:
    :func:`copy_into` (the rows: :meth:`Epilogue.finish`)."""
    from lvt_tpu_torch import kernels
    from lvt_tpu_torch.core.tail import tail_shape

    dsts = leaves(dst)
    if dsts[0].device.type == "cpu":
        copy_into(dst, src)
        return
    pairs = list(zip(dsts, unaliased(dsts, leaves(src))))
    for d, s in pairs:
        kernels.require(d, "copy_leaves dst", d.dtype)
        kernels.require(s, "copy_leaves src", d.dtype, d.shape, d.device)
    chunk = None if epilogue is None else epilogue.table
    row_srcs = _rows_of(rows) if chunk is not None else []
    for x in row_srcs:
        kernels.require(x, "copy_leaves row", x.dtype, device=dsts[0].device)
    if len(pairs) + len(row_srcs) > tail_shape()[0]:
        raise ValueError(f"copy_leaves: {len(pairs) + len(row_srcs)} leaves "
                         f"exceed the kernel's {tail_shape()[0]}")
    n = len(pairs) + len(row_srcs)
    ptrs = (ctypes.c_void_p * (2 * n))(*(
        [t.data_ptr() for d, s in pairs for t in (s, d)]
        + [p for x in row_srcs for p in (x.data_ptr(), None)]))
    nbytes = (ctypes.c_longlong * n)(*(
        [d.numel() * d.element_size() for d, _ in pairs]
        + [x.numel() * x.element_size() for x in row_srcs]))
    row_of = (ctypes.c_int * n)(*([-1] * len(pairs) + list(range(len(
        row_srcs)))))
    if chunk is None:
        _copy_launch(dsts[0], ptrs, nbytes, row_of, n, PLAIN)
    else:
        _copy_launch(dsts[0], ptrs, nbytes, row_of, n, FRAME, epilogue,
                     row_bytes=[x.numel() * x.element_size()
                                for x in row_srcs])


def _copy_launch(like, ptrs, nbytes, row_of, n, mode, epilogue=None,
                 row_bytes=(), chunk_rows=None, chunk_in=(),
                 n_frames=0) -> None:
    """One launch of ``lvt_copy_leaves`` (csrc/tail.cu) in ``mode``."""
    from lvt_tpu_torch import kernels

    inputs = () if epilogue is None else epilogue.inputs
    in_dst = (ctypes.c_void_p * max(len(inputs), 1))(*(
        x.data_ptr() for x in inputs))
    in_bytes = (ctypes.c_longlong * max(len(inputs), 1))(*(
        x.numel() * x.element_size() for x in inputs))
    rb = (ctypes.c_longlong * 16)(*row_bytes)
    with torch.cuda.device(like.device):
        err = kernels.lib().lvt_copy_leaves(
            ptrs, nbytes, row_of, n,
            None if epilogue is None else epilogue.table.data_ptr(), rb,
            in_dst, in_bytes, len(inputs), chunk_rows,
            (ctypes.c_void_p * max(len(chunk_in), 1))(*chunk_in), n_frames,
            mode, kernels.stream_ptr(like))
    kernels.check(err, "copy_leaves")
    copy_leaves.launches += 1


copy_leaves.launches = 0

# the runner whose frame runs on this thread (set only inside
# StepGraph._step)
_frame = threading.local()


def active_epilogue(state):
    """The :class:`Epilogue` of the runner whose frame runs on this thread,
    where ``state`` is its state (the same tensors): the step's tail then
    ends the frame; else None."""
    epilogue = getattr(_frame, "epilogue", None)
    if epilogue is None or epilogue.state.status is not state.status:
        return None
    return epilogue


class Epilogue:
    """The end of a runner's frame, on the device: the step's new state
    into the buffers ``state``, the frame's pose and metrics into row i of
    the chunk's tensors, frame i + 1 into the input buffers ``inputs``, a
    counter i advanced; a stream LOST after the frame reset to ``reset``
    (one stream's initial state, its pose kept: ``tail.reset_lost``)
    where the runner resets. ``outputs``: one frame's (pose, metrics)
    example, for the rows (None: a VOState's, ``tail.row_templates``).
    On the card the frame index (a ticket a block of each launch) and the
    chunk's pointers live in ``table`` (csrc/tail.cu's Chunk, its first 8
    bytes the frames ended), written once a chunk by :meth:`start`; the
    step's tail ends the frame where it can (``fused``), else
    :meth:`finish` does; on the CPU the index is ``counter``, a tensor.
    ``chunked`` False: a warm-up's, which writes the state only."""

    def __init__(self, state, inputs, *, reset=None, outputs=None,
                 chunked: bool = True):
        self.state = state
        self.inputs = tuple(inputs)
        self.reset = reset
        self.outputs = outputs
        self.chunked = chunked
        self.device = leaves(state)[0].device
        self.fused = False
        self.table = None          # on the card, made at the first chunk
        self.counter = (None if self.device.type == "cuda" else
                        torch.zeros((), dtype=torch.int64))
        self._rows = self._chunk = None

    def scratch(self, state) -> "Epilogue":
        """A warm-up's epilogue on ``state``: the state only."""
        return Epilogue(state, self.inputs, reset=self.reset,
                        outputs=self.outputs, chunked=False)

    def _templates(self) -> tuple:
        if self.outputs is not None:
            return self.outputs
        from lvt_tpu_torch.core.tail import row_templates

        return row_templates(self.state)

    def start(self, xs) -> tuple:
        """A chunk of frames ``xs`` (each [N, ...], a frame a static
        input's shape): its rows, new tensors (poses, metrics) [N, ...]
        that the frames fill; on the card its table written and frame 0
        copied into the input buffers in one launch, on the CPU torch
        copies. The chunk and its rows are kept until the next chunk."""
        n = xs[0].shape[0]
        for buf, x in zip(self.inputs, xs):
            if x.device != buf.device:
                raise ValueError(f"a runner's chunk input on {x.device}, "
                                 f"its buffers on {buf.device}")
        pose, metrics = self._templates()
        grow = lambda y: y.new_empty((n, *y.shape))  # noqa: E731
        rows = tuple(tree_map(grow, x) if isinstance(x, tuple) else grow(x)
                     for x in (pose, metrics))
        xs = [x.contiguous() for x in xs]
        self._rows, self._chunk = rows, xs
        if self.device.type != "cuda":
            self.counter.zero_()
            for buf, x in zip(self.inputs, xs):
                buf.copy_(x[0])
            return rows
        from lvt_tpu_torch.core.tail import tail_shape

        if self.table is None:
            self.table = torch.zeros(tail_shape()[1], dtype=torch.uint8,
                                     device=self.device)
        flat = _rows_of(rows)
        if len(flat) > 16 or len(xs) > tail_shape()[3]:
            raise ValueError(f"a runner's chunk: {len(flat)} rows, "
                             f"{len(xs)} inputs exceed the kernel's 16, "
                             f"{tail_shape()[3]}")
        _copy_launch(self.table, None, None, None, 0, START, self,
                     chunk_rows=(ctypes.c_void_p * 16)(*(
                         x.data_ptr() for x in flat)),
                     chunk_in=[x.data_ptr() for x in xs], n_frames=n)
        return rows

    def finish(self, new, pose, metrics) -> None:
        """The end of a frame whose tail did not end it (the CPU, a
        group, a step without the tail): the reset, the new state into the
        buffers, and with a chunk the rows, the next frame and the counter
        (on the card one ``copy_leaves`` launch; on the CPU torch ops by
        the same counter)."""
        if self.reset is not None:
            from lvt_tpu_torch.core.tail import reset_lost

            new = reset_lost(new, self.reset)
        if self.device.type == "cuda":
            copy_leaves(self.state, new, rows=(pose, metrics),
                        epilogue=self if self.chunked else None)
        else:
            self.finish_plain(new, pose, metrics)

    def finish_plain(self, new, pose, metrics) -> None:
        """:meth:`finish`'s copies as torch ops on any device (the CPU's;
        on the card the plain version chip_smoke.py times, which gives the
        epilogue a ``counter`` there): the new state into the buffers, and
        with a chunk ``index_copy_`` into row i (i the ``counter``, kept
        within the chunk), frame i + 1 into the input buffers and the
        counter advanced."""
        copy_into(self.state, new)
        if not self.chunked or self._rows is None:
            return
        last = self._chunk[0].shape[0] - 1
        i = torch.clamp(self.counter.view(1), max=last)
        for row, x in zip(_rows_of(self._rows), _rows_of((pose, metrics))):
            row.index_copy_(0, i, x[None])
        nxt = torch.clamp(i + 1, max=last)
        for buf, x in zip(self.inputs, self._chunk):
            buf.copy_(x.index_select(0, nxt)[0])
        self.counter += 1


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
                 batched: bool = False, reset=None, outputs=None):
        self.step_fn = step_fn
        self.state = state
        self.device = leaves(state)[0].device
        self.capturable = capturable(self.device, group)
        self.if_nodes = if_nodes(self.device, group, batched=batched)
        self.inputs = tuple(torch.empty_like(x, memory_format=torch
                                             .contiguous_format)
                            for x in example_inputs)
        self.epilogue = Epilogue(state, self.inputs, reset=reset,
                                 outputs=outputs)
        self.capture_seconds: float | None = None
        self.replays = 0
        self._graph = None
        self._branches: list = []   # the IF nodes' bodies (cond)
        self._branch_stream = None

    @property
    def mode(self) -> str:
        """``"graph"`` where the next frame replays the captured graph,
        ``"eager"`` where it calls ``step_fn``."""
        return ("graph" if self.capturable and not graphs_disabled()
                else "eager")

    def _step(self, epilogue) -> None:
        """One call of the step on ``epilogue``'s state and the input
        buffers, ended by the step's tail or by ``epilogue.finish``."""
        epilogue.fused = False
        _frame.epilogue = epilogue
        try:
            new, pose, metrics = self.step_fn(epilogue.state, *self.inputs)
        finally:
            _frame.epilogue = None
        if not epilogue.fused:
            with record_function("step_tail"):
                epilogue.finish(new, pose, metrics)

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
                self._step(self.epilogue.scratch(scratch))
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
                        self._step(self.epilogue)
                    finally:
                        _cond.runner = None
                        graph.capture_end()
            finally:
                if gc_was_on:
                    gc.enable()
                with _dropped_lock:
                    _capturing = False
                    _dropped.clear()
        self._graph = graph
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

    def frame(self) -> None:
        """One frame of the current chunk: the graph replayed (captured
        first if this is its first frame) or the step called. On the card
        nothing else is launched from the host."""
        if self.mode == "eager":
            self._step(self.epilogue)
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1

    def run(self, *xs):
        """The frames along the leading axis of ``xs``, in order (lvt_tpu's
        ``lax.scan``): the chunk started (:meth:`Epilogue.start`), then one
        :meth:`frame` each. Returns (poses [N], metrics [N]) in new
        tensors."""
        for buf, x in zip(self.inputs, xs):
            if x.shape[1:] != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"frame input {tuple(x.shape[1:])} "
                                 f"{x.dtype}, the runner's "
                                 f"{tuple(buf.shape)} {buf.dtype}")
        rows = self.epilogue.start(xs)
        for _ in range(xs[0].shape[0]):
            self.frame()
        return rows


def runner(runners: dict, kind: str, make_step, state, xs, *,
           group=None, batched: bool = False,
           make_reset=None) -> StepGraph:
    """The runner in ``runners`` (a system's) of entry point ``kind`` for
    frames shaped as the leading-axis slices of ``xs`` (their dtypes and
    shapes), made on first use with the step function ``make_step()``
    returns and, where ``make_reset`` is given, the initial state a stream
    it loses is reset to, ``make_reset()`` (one stream's;
    :class:`Epilogue`)."""
    key = (kind, *((x.dtype, tuple(x.shape[1:])) for x in xs))
    if key not in runners:
        runners[key] = StepGraph(
            make_step(), state, [x[0] for x in xs], group=group,
            batched=batched,
            reset=None if make_reset is None else make_reset())
    return runners[key]
