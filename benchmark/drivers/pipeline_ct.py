"""Pipeline cells of the continuous-time odometry: ``drivers/pipeline.py``'s
run, unchanged, with the CT scan step checked against the plain reference.

Around that run, the program's ``odometry_estimation_ct._ct_scan_step`` is
wrapped, as ``pipeline._nn_recording`` wraps ``nn_search``: of the steps the
odometry takes while the window is open, ``ct_check_steps`` are drawn
uniformly from ``--seed`` (a reservoir, decided before each step), and
their inputs and the poses and twist they returned are cloned on the card
(device copies, no sync). After the run, with the program's state freed,
``benchmark/reference/ct_step.py`` works each of them out again on the card
in float32 without TF32, and the run's checks gain, over those steps:

- ``ct_step_trans_err_m``: the largest distance between the program's and
  the reference's begin or end position;
- ``ct_step_rot_err_deg``: the largest angle between their begin or end
  rotations;
- ``ct_twist_err``: the largest difference of a twist component (rad/s, m/s).

The window opens and closes where ``pipeline.run``'s recorder turns its
``window_on`` flag. A program without the step (or a cell that runs no CT
step) leaves the three checks out, and the check fails on them.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import pipeline
from benchmark.reference import ct_step as ref_ct

MODEL_FIELDS = ("points", "covs", "mask", "age", "min_dist", "lru_horizon")
# _ct_scan_step's positional arguments after the model, by name.
ARG_NAMES = ("T_prev_e", "twist_prev", "step", "model", "pts", "times", "mask", "neighbors",
             "dt", "uniforms", "max_dist", "loc_weight", "cv_weight", "damping")


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class StepSampler:
    """A uniform sample of ``n`` of the CT steps taken while ``on``, with
    their inputs and outputs, drawn from ``seed``; thread-safe (the steps
    run on the odometry worker)."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng([seed, 0xC7])
        self.lock = threading.Lock()
        self.on = False
        self.seen = 0
        self.kept: Dict[int, dict] = {}

    def slot(self):
        """The reservoir slot of the next step, or None to skip it."""
        with self.lock:
            if not self.on:
                return None
            self.seen += 1
            if len(self.kept) < self.n:
                return len(self.kept)
            j = int(self.rng.integers(0, self.seen))
            return j if j < self.n else None

    def wrap(self, step_fn):
        def wrapper(*args, **kw):
            slot = self.slot()
            if slot is None:
                return step_fn(*args, **kw)
            inputs = dict(zip(ARG_NAMES, args), **kw)
            inputs = {k: _clone(v) for k, v in inputs.items() if k != "model"}
            model = args[3]
            inputs["model"] = ({f: _clone(getattr(model, f)) for f in MODEL_FIELDS}
                               if hasattr(model, "lru_horizon") else None)
            out = step_fn(*args, **kw)
            with self.lock:
                self.kept[slot] = dict(inputs=inputs, T_b=_clone(out[0]), T_e=_clone(out[1]),
                                       twist=_clone(out[2]))
            return out
        return wrapper

    def samples(self) -> List[dict]:
        with self.lock:
            return [self.kept[k] for k in sorted(self.kept)]


def _angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    D = Ra.T @ Rb
    vee = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.degrees(np.arctan2(np.linalg.norm(vee), 0.5 * (np.trace(D) - 1.0))))


def reference_step(inputs: dict) -> dict:
    """The reference's step on a sample's inputs (the preset's path: the
    ``ivox`` point model, no rigid refinement, the begin pose free)."""
    if inputs["model"] is None or inputs.get("model_kind") != "ivox" \
            or inputs.get("rigid_refine") or inputs.get("anchor_begin"):
        raise ValueError("the CT reference covers the ivox model without rigid_refine "
                         "or anchor_begin")
    a = inputs
    return ref_ct.ct_step(
        a["T_prev_e"], a["twist_prev"], int(a["step"]), a["model"], a["pts"], a["times"],
        a["mask"], a["neighbors"], a["dt"], a["uniforms"], max_dist=float(a["max_dist"]),
        loc_weight=float(a["loc_weight"]), cv_weight=float(a["cv_weight"]),
        damping=float(a["damping"]), iters=int(a["iters"]),
        bootstrap_frames=int(a["bootstrap_frames"]), update_budget=int(a["update_budget"]))


def step_errors(sample: dict) -> List[float]:
    """[translation m, rotation deg, twist] of one sample against the
    reference: the larger of the begin and end poses' differences, and the
    largest difference of a twist component (float64 on the host)."""
    want = reference_step(sample["inputs"])
    trans, rot = 0.0, 0.0
    for k in ("T_b", "T_e"):
        a = sample[k].double().cpu().numpy()
        b = want[k].double().cpu().numpy()
        trans = max(trans, float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
        rot = max(rot, _angle_deg(a[:3, :3], b[:3, :3]))
    twist = float(np.abs(sample["twist"].double().cpu().numpy()
                         - want["twist"].double().cpu().numpy()).max())
    return [trans, rot, twist]


def step_checks(errors: List[List[float]]) -> dict:
    """The three step checks: the largest of each error over the samples."""
    if not errors:
        return {}
    trans, rot, twist = zip(*errors)
    return dict(ct_step_trans_err_m=max(trans), ct_step_rot_err_deg=max(rot),
                ct_twist_err=max(twist))


def run(ctx) -> dict:
    from glim_tpu_torch.odometry import odometry_estimation_ct as ct_mod

    sampler = StepSampler(int(ctx.traffic["ct_check_steps"]), ctx.seed)

    class Recorder(pipeline.Recorder):
        """The pipeline's recorder; its window flag also opens and closes
        the sample."""

        @property
        def window_on(self):
            return self._window_on

        @window_on.setter
        def window_on(self, on):
            self._window_on = on
            with sampler.lock:
                sampler.on = bool(on)

    step_fn, recorder = ct_mod._ct_scan_step, pipeline.Recorder
    ct_mod._ct_scan_step = sampler.wrap(step_fn)
    pipeline.Recorder = Recorder
    try:
        out = pipeline.run(ctx)
    finally:
        ct_mod._ct_scan_step = step_fn
        pipeline.Recorder = recorder

    samples = sampler.samples()
    errors = [step_errors(smp) for smp in samples]
    checks = step_checks(errors)
    out["checks"].update(checks)
    out["info"].update(ct_steps_in_window=sampler.seen,
                       ct_checked_steps=[int(s["inputs"]["step"]) for s in samples],
                       ct_step_errors=errors)
    ctx.log(f"CT steps: {sampler.seen} in the window, {len(samples)} checked: {checks}")
    return out
