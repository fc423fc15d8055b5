"""CUDA graphs of the odometry's window step.

``window_scan_step`` launches some ten thousand small kernels a scan, and the
host's Python and ATen dispatch of them, not the card, sets the odometry's
pace. Its shapes are static (the W-state ring, the scan and map capacities,
the IMU window) and its data-dependent choices stay on the device, so one
scan's launches can be captured once and replayed on every later scan: the
port's counterpart of the JAX package's one ``jax.jit`` program.

``WindowGraphRunner`` is called in the step's place. On CPU tensors it calls
``window_scan_step`` as it is. On CUDA tensors it keys a captured program by
what the call can observe (the device, the structure, shapes and dtypes of
every tensor argument, which covers W, the scan, IMU and map capacities and
levels and whether ``vel_reg`` is given, and the static keywords). A key's
first ``WARMUP_CALLS`` calls run eagerly, so cuBLAS / cuSOLVER handles and the
caching allocator are warm; the next call captures on a side stream
(``capture_error_mode="thread_local"``: the sub-mapping and global workers
keep launching on their own threads meanwhile) and every call from then on
replays on the caller's current stream:

- the arguments are copied into the program's static input buffers (the
  window, the scan, the IMU upload, every tensor of the map levels, which
  keyframe inserts replace between scans, and the constants), every call,
  in one ``_foreach_copy_``;
- the segments replay in capture order. In GICP mode the graph breaks at each
  of the step's ``nn_search`` calls: the search runs eagerly between two
  segments on the static tensors the segment before it left, through this
  module's ``window_estimator.nn_search`` (so its launch count, and a wrapper
  put there, see every call), and its results are copied into the buffers the
  next segment reads. VGICP calls no search and is one segment;
- every output leaf is cloned (``clone_all``), so no returned frame
  field or window state aliases the program's memory, which the next replay
  overwrites.

The scopes ``window_graph/capture`` and ``window_graph/replay`` (inside the
caller's ``window_scan_step`` scope) count the captures and replays. A capture
that fails raises with ``strict``; otherwise it is logged, that call runs
eagerly, and the key is captured again on a later call (at most
``MAX_CAPTURE_ATTEMPTS`` times in all).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from glim_tpu_torch.odometry import window_estimator
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope

logger = create_module_logger("odom")

WARMUP_CALLS = 2           # eager calls of a key before its capture
MAX_CAPTURE_ATTEMPTS = 3


# -- argument trees ---------------------------------------------------------


def flatten(obj, leaves: List[torch.Tensor]):
    """Append the tensors of ``obj`` (tensors, dataclasses, tuples, lists,
    dicts and None, nested) to ``leaves`` in a fixed order and return its
    spec: the structure with each tensor's shape and dtype, hashable, for
    ``unflatten`` and for a program's key."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("t", tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj):
        return (type(obj), tuple(flatten(getattr(obj, f.name), leaves)
                                 for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(flatten(x, leaves) for x in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, flatten(v, leaves)) for k, v in obj.items()))
    if obj is None:
        return ("none",)
    raise TypeError(f"window graph: cannot carry a {type(obj).__name__} argument")


def unflatten(spec, leaves):
    """The structure of ``spec`` with its tensors taken in order from the
    iterator ``leaves``."""
    kind = spec[0]
    if kind == "t":
        return next(leaves)
    if kind == "none":
        return None
    if kind is dict:
        return {k: unflatten(s, leaves) for k, s in spec[1]}
    children = [unflatten(s, leaves) for s in spec[1]]
    return kind(*children) if dataclasses.is_dataclass(kind) else kind(children)


# -- programs ---------------------------------------------------------------


class Search:
    """One eager ``nn_search`` between two segments: it reads the static
    tensors ``args`` (queries and their mask, which the segment before it
    wrote, and the map's points and mask) and writes ``out`` (idx, d2), which
    the segment after it reads."""

    def __init__(self, args, out):
        self.args, self.out = args, out

    def __call__(self):
        torch._foreach_copy_(self.out, window_estimator.nn_search(*self.args))
        return self.out


def clone_all(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """A copy of each tensor in new memory, in one torch call. Each torch
    call hands the interpreter lock to the other workers: in the async
    pipeline ~110 single copies in and clones out took ~20 ms a scan on an
    H100 host, one call each ~1.6 ms. torch 2.11 has no ``_foreach_clone``;
    max(x, x) selects an operand, so it is x bit for bit (-0.0, NaN and
    denormals kept), in every dtype."""
    return torch._foreach_maximum(tensors, tensors)


def search_buffers(queries: torch.Tensor):
    """The static (idx, d2) a search writes for ``queries``: nn_search's
    int32 indices and float32 squared distances, one a query (zeros until
    the first search: index 0 is in range for any map)."""
    Q = queries.shape[0]
    return [torch.zeros(Q, dtype=torch.int32, device=queries.device),
            torch.zeros(Q, dtype=torch.float32, device=queries.device)]


class GraphProgram:
    """A captured step: CUDA graph segments of one memory pool and the
    searches between them; ``outputs`` are the static output tree."""

    def __init__(self, segments, searches, outputs):
        self.segments, self.searches, self.outputs = segments, searches, outputs

    def replay(self) -> None:
        for i, segment in enumerate(self.segments):
            segment.replay()
            if i < len(self.searches):
                self.searches[i]()


def capture_cuda(fn: Callable, device: torch.device) -> GraphProgram:
    """Capture ``fn(search)`` (the step on static inputs) on a side stream as
    graph segments that share one pool, breaking the capture at each call of
    ``search``, which returns the static buffers the next segment reads."""
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    segments: List[torch.cuda.CUDAGraph] = []
    searches: List[Search] = []
    capturing = [False]

    def begin():
        g = torch.cuda.CUDAGraph()
        pool = segments[0].pool() if segments else None
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        segments.append(g)
        capturing[0] = True

    def end():
        capturing[0] = False
        segments[-1].capture_end()

    def search(queries, query_mask, targets, target_mask):
        end()
        with torch.cuda.stream(caller):
            out = search_buffers(queries)
        searches.append(Search((queries, query_mask, targets, target_mask), out))
        begin()
        return out

    with torch.cuda.device(device), torch.cuda.stream(side):
        begin()
        try:
            outputs = fn(search)
        except BaseException:
            if capturing[0]:
                try:
                    end()
                except RuntimeError:
                    pass        # the capture is broken already: fn's error says why
            raise
        end()
    caller.wait_stream(side)
    return GraphProgram(segments, searches, outputs)


class _Entry:
    """One key's state: its eager calls so far, its capture attempts, and
    once captured, the static inputs and the program."""

    def __init__(self):
        self.calls = 0
        self.attempts = 0
        self.inputs: Optional[List[torch.Tensor]] = None
        self.program = None
        self.outputs: List[torch.Tensor] = []
        self.out_spec = None


class WindowGraphRunner:
    """``window_scan_step`` with the same arguments and results, replayed
    from a captured program on CUDA tensors (module docstring).

    ``capture(fn, device)`` makes a program from ``fn(search)``; it defaults
    to ``capture_cuda``, which engages on CUDA tensors only. A capture given
    here engages on every device (the CPU tests give one that runs ``fn``).
    ``strict`` raises where a capture fails."""

    def __init__(self, capture: Optional[Callable] = None, strict: bool = False):
        self.strict = strict
        self._capture = capture or capture_cuda
        self._any_device = capture is not None
        self._entries: Dict[tuple, _Entry] = {}

    def __call__(self, win, vms, *args, vel_reg=None, W: int, outer_iters: int = 2,
                 inner_iters: int = 2, compute_covs: bool = False,
                 matching: str = "vgicp", full_connection: int = 2):
        static = dict(W=W, outer_iters=outer_iters, inner_iters=inner_iters,
                      compute_covs=compute_covs, matching=matching,
                      full_connection=full_connection)
        device = args[0].device
        if not (self._any_device or device.type == "cuda"):
            return window_estimator.window_scan_step(win, vms, *args, vel_reg=vel_reg,
                                                     **static)
        leaves: List[torch.Tensor] = []
        spec = flatten((win, vms, args, vel_reg), leaves)
        key = (str(device), spec, tuple(sorted(static.items())))
        entry = self._entries.setdefault(key, _Entry())
        if entry.program is None:
            entry.calls += 1
            if entry.calls <= WARMUP_CALLS or entry.attempts >= MAX_CAPTURE_ATTEMPTS \
                    or not self._try_capture(entry, spec, leaves, static, device):
                return window_estimator.window_scan_step(win, vms, *args, vel_reg=vel_reg,
                                                         **static)
        with profile_scope("window_graph/replay"):
            torch._foreach_copy_(entry.inputs, leaves)
            entry.program.replay()
            return unflatten(entry.out_spec, iter(clone_all(entry.outputs)))

    def _try_capture(self, entry: _Entry, spec, leaves, static, device) -> bool:
        entry.attempts += 1
        inputs = [t.clone() for t in leaves]
        win, vms, args, vel_reg = unflatten(spec, iter(inputs))

        def fn(search):
            return window_estimator.window_scan_step(win, vms, *args, vel_reg=vel_reg,
                                                     search=search, **static)
        try:
            with profile_scope("window_graph/capture"):
                program = self._capture(fn, device)
        except Exception:
            if self.strict:
                raise
            logger.exception("window step capture failed (attempt %d of %d); this step "
                             "runs eagerly", entry.attempts, MAX_CAPTURE_ATTEMPTS)
            return False
        entry.inputs, entry.program = inputs, program
        entry.out_spec = flatten(program.outputs, entry.outputs)
        return True
