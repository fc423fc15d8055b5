"""CUDA graphs of the continuous-time odometry's scan step.

``_ct_scan_step`` launches some eleven thousand small kernels a scan (eight
damped 12-dof solves, their priors' Jacobians, the model update), and the
host's dispatch of them, not the card, sets the CT odometry's pace. Past the
bootstrap its shapes are static (the scan, the bounded point model) and its
data-dependent choices stay on the device, so one step's launches are
captured once and replayed on every later step, as ``window_graph.py`` does
for the window step, whose helpers this module uses unchanged.

``CTGraphRunner`` is what ``_ct_scan_step`` hands the step to when given one
(``graph=``). It calls the step's ops directly on CPU tensors, for the
``vgicp`` model (its voxel-map insert takes the step as a host int), and on
the steps that take a host branch: the first (whose solve is discarded) and
the bootstrap's (every point kept); ``_replay_bootstrap``'s steps are among
them. Every other step is keyed by what it can observe: the device, the
shapes and dtypes of every tensor argument (the scan and the model's
capacity), the four floats (the correspondence distance, the two prior
weights, the twist's damping) and the static keywords. A key's first
``WARMUP_CALLS`` calls run eagerly; the next captures two programs in one
go, and every call from then on replays them on the caller's stream:

- the arguments are copied into the static inputs in one ``_foreach_copy_``:
  the poses, twist, scan, model tensors, ``dt``, the update's uniforms and
  the step as a 0-dim int64 tensor, which the model update reads for its LRU
  ages (a step frozen at capture would stop them, and no point would expire);
- the solve: graph segments with the step's four ``nn_search`` lookups run
  eagerly between them, each inside a ``ct/lookup`` span, through this
  module's ``odometry_estimation_ct.nn_search`` (so a wrapper put there sees
  every call), writing the buffers the next segment reads;
- the model update, a program of its own, replayed inside ``ct/model_insert``;
- every output is cloned (``clone_all``): no returned pose, frame field or
  model aliases the programs' memory, which the next replay overwrites.

The scopes ``ct_graph/capture`` and ``ct_graph/replay`` (inside the caller's
``ct_scan_step``) count captures and replays. A capture that fails raises
with ``strict``; otherwise it is logged, that call runs eagerly, and the key
is captured again on a later call (at most ``MAX_CAPTURE_ATTEMPTS`` times).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from glim_tpu_torch.odometry import odometry_estimation_ct as ct
from glim_tpu_torch.odometry.window_graph import (MAX_CAPTURE_ATTEMPTS, WARMUP_CALLS,
                                                  Search, capture_cuda, clone_all,
                                                  flatten, unflatten)
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope

logger = create_module_logger("odom")


class Lookup(Search):
    """One of the solve's model lookups between two segments, inside a
    ``ct/lookup`` span."""

    def __call__(self):
        with profile_scope("ct/lookup"):
            torch._foreach_copy_(self.out, ct.nn_search(*self.args))
        return self.out


class _Entry:
    """One key's state: its eager calls so far, its capture attempts, and
    once captured, the static inputs, the two programs and the outputs."""

    def __init__(self):
        self.calls = 0
        self.attempts = 0
        self.inputs: List[torch.Tensor] = []
        self.solve = None
        self.insert = None
        self.outputs: List[torch.Tensor] = []
        self.out_spec = None


class CTGraphRunner:
    """``_ct_scan_step``'s ops with the same arguments and results, replayed
    from captured programs on CUDA tensors (module docstring).

    ``capture(fn, device)`` makes a program from ``fn(search)``; it defaults
    to ``window_graph.capture_cuda``, which engages on CUDA tensors only. A
    capture given here engages on every device (the CPU tests give one that
    runs ``fn``). ``strict`` raises where a capture fails."""

    def __init__(self, capture: Optional[Callable] = None, strict: bool = False):
        self.strict = strict
        self._capture = capture or capture_cuda
        self._any_device = capture is not None
        self._entries: Dict[tuple, _Entry] = {}

    def __call__(self, *args, **static):
        (T_prev_e, twist_prev, step, model, pts, times, mask, neighbors, dt, uniforms,
         *floats) = args
        device = pts.device
        if not (self._any_device or device.type == "cuda") or static["model_kind"] != "ivox" \
                or step == 0 or step < static["bootstrap_frames"]:
            return ct._ct_ops(*args, **static)
        step_t = torch.full((), step, dtype=torch.int64, device=device)
        leaves: List[torch.Tensor] = []
        spec = flatten(((T_prev_e, twist_prev, model, pts, times, mask, neighbors, dt,
                         uniforms), step_t), leaves)
        key = (str(device), spec, tuple(floats), tuple(sorted(static.items())))
        entry = self._entries.setdefault(key, _Entry())
        if entry.solve is None:
            entry.calls += 1
            if entry.calls <= WARMUP_CALLS or entry.attempts >= MAX_CAPTURE_ATTEMPTS \
                    or not self._try_capture(entry, spec, leaves, step, floats, static,
                                             device):
                return ct._ct_ops(*args, **static)
        with profile_scope("ct_graph/replay"):
            torch._foreach_copy_(entry.inputs, leaves)
            entry.solve.replay()
            with profile_scope("ct/model_insert"):
                entry.insert.replay()
            return unflatten(entry.out_spec, iter(clone_all(entry.outputs)))

    def _try_capture(self, entry: _Entry, spec, leaves, step, floats, static,
                     device) -> bool:
        entry.attempts += 1
        inputs = [t.clone() for t in leaves]
        tensors, step_t = unflatten(spec, iter(inputs))
        T_prev_e, twist_prev, model, *frame = tensors

        def solve_fn(search):
            return ct._ct_solve(T_prev_e, twist_prev, step, model, *frame, *floats,
                                search=search, **static)
        try:
            with profile_scope("ct_graph/capture"):
                solve = self._capture(solve_fn, device)
                *_, w_pts, keep, covs_w = solve.outputs
                insert = self._capture(lambda search: ct._ct_model_insert(
                    model, "ivox", w_pts, keep, covs_w, step_t), device)
        except Exception:
            if self.strict:
                raise
            logger.exception("CT step capture failed (attempt %d of %d); this step runs "
                             "eagerly", entry.attempts, MAX_CAPTURE_ATTEMPTS)
            return False
        solve.searches[:] = [Lookup(s.args, s.out) for s in solve.searches]
        T_b, T_e, twist, deskewed, covs, normals, errs = solve.outputs[:7]
        entry.inputs, entry.solve, entry.insert = inputs, solve, insert
        entry.out_spec = flatten((T_b, T_e, twist, insert.outputs, deskewed, covs, normals,
                                  errs), entry.outputs)
        return True
