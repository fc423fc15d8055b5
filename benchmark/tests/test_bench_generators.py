"""CPU tests of the benchmark's traffic generators and plain references: the
torch copies against the port's originals at a tiny size, and the seed's
control over the inputs."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import glim_config  # noqa: E402
from benchmark.generators import landmark_scans  # noqa: E402
from benchmark.reference import preprocess as ref_pre  # noqa: E402
from benchmark.reference import trajectory as ref_traj  # noqa: E402


def traffic(name, **edits):
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{name}.json")) as f:
        return dict(json.load(f), **edits)


def tiny_circle():
    return traffic("circle", scan_points=512, scene={"points": 4000, "extent": 30.0})


def test_circle_matches_the_port_generator():
    """Same trajectory, scan stamps, point counts and IMU rows as
    glim_tpu_torch.io.synthetic.generate_sequence for the same arguments."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    t = tiny_circle()
    n = 12
    seq = landmark_scans.generate(t, 5, n, "cpu")
    orig = generate_sequence(duration=n / t["scan_hz"], scan_hz=t["scan_hz"],
                             imu_hz=t["imu_hz"], n_scan_points=t["scan_points"],
                             max_range=t["max_range"], noise=t["range_noise"],
                             radius=t["path"]["radius"],
                             omega=t["path"]["speed"] / t["path"]["radius"], seed=5,
                             scene_points=t["scene"]["points"])
    assert np.allclose(seq.stamps, orig.stamps)
    assert np.allclose(seq.gt_poses, np.stack(orig.gt_poses), atol=1e-12)
    assert [len(p) for p in seq.points] == [s.size for s in orig.scans]
    assert seq.imu.shape == orig.imu.shape
    assert np.allclose(seq.imu, orig.imu, atol=1e-9)
    for p, tt, s in zip(seq.points, seq.times, orig.scans):
        assert p.dtype == np.float32 and tt.dtype == np.float32
        assert np.all(np.diff(tt) >= 0) and tt.min() >= 0 and tt.max() < 1 / t["scan_hz"]
        assert abs(float(tt.mean()) - float(np.mean(s.times))) < 0.02


def test_circle_points_lie_on_the_scene():
    """Each point, put back into the world by the pose of its capture time,
    is a landmark within the range noise."""
    t = tiny_circle()
    seq = landmark_scans.generate(t, 9, 3, "cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(9)
    scene = landmark_scans.make_scene(gen, t["scene"]["points"], t["scene"]["extent"],
                                      "cpu").numpy()
    period = 1 / t["scan_hz"]
    for i, (p, tt) in enumerate(zip(seq.points, seq.times)):
        g = np.minimum((tt / period * t["time_groups"]).astype(int), t["time_groups"] - 1)
        tg = seq.stamps[i] + (g + 0.5) / t["time_groups"] * period
        T = ref_traj.true_poses(t, tg)
        w = np.einsum("nij,nj->ni", T[:, :3, :3], p.astype(np.float64)) + T[:, :3, 3]
        d = np.min(np.linalg.norm(w[:, None] - scene[None], axis=2), axis=1)
        assert np.max(d) < 8 * t["range_noise"]


def test_reference_truth_is_the_generators():
    t = tiny_circle()
    seq = landmark_scans.generate(t, 1, 8, "cpu")
    assert np.allclose(ref_traj.true_poses(t, seq.stamps), seq.gt_poses, atol=1e-12)


def test_same_seed_same_inputs():
    t = tiny_circle()
    a, b = (landmark_scans.generate(t, 2 ** 33 + 7, 3, "cpu") for _ in range(2))
    c = landmark_scans.generate(t, 2 ** 33 + 8, 3, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.points, b.points))
    assert not np.array_equal(a.points[0], c.points[0])


def test_pose_errors():
    T = ref_traj.circle_pose(np.arange(20) * 0.1, 10.0, 0.3, 0.5, 0.7)
    e = ref_traj.pose_errors(T, T)
    assert max(e.values()) < 1e-9
    # A rigid motion of the whole estimate is fitted away, and the motion
    # between poses does not see it; a moved pose is seen by both.
    M = np.eye(4)
    M[:3, :3] = ref_traj.circle_pose(np.array([2.0]), 1.0, 0.4, 0.0, 0.0)[0, :3, :3]
    M[:3, 3] = [3.0, -1.0, 0.5]
    e = ref_traj.pose_errors(M @ T, T)
    assert e["ate"] < 1e-9 and e["rpe"] < 1e-9 and e["rpe_rot_deg"] < 1e-6
    bad = T.copy()
    bad[7, 0, 3] += 0.5
    e = ref_traj.pose_errors(bad, T)
    assert e["max_err"] > 0.4 and e["rpe"] == pytest.approx(0.5 * np.sqrt(2 / 19))
    assert e["rpe_med"] < 1e-9                # one pose moves two steps of 19
    # Every step 5% too long: the median step error is 5% of a step.
    scaled = T.copy()
    scaled[:, :3, 3] *= 1.05
    step = np.linalg.norm(T[1, :3, 3] - T[0, :3, 3])
    assert ref_traj.pose_errors(scaled, T)["rpe_med"] == pytest.approx(0.05 * step, rel=0.01)
    # A turn of 0.01 rad added to each step reads about 0.573 degrees a step.
    turned = T.copy()
    for i in range(1, len(T)):
        c, s = np.cos(0.01 * i), np.sin(0.01 * i)
        turned[i, :3, :3] = T[i, :3, :3] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    assert ref_traj.pose_errors(turned, T)["rpe_rot_med_deg"] == pytest.approx(
        np.degrees(0.01), rel=1e-3)
    assert ref_traj.pose_errors(T[:2], T[:2])["ate"] == float("inf")
    # A turn shows; a rotation made orthonormal again, or a moved position,
    # does not.
    skew = T.copy()
    skew[:, :3, :3] *= 1.0 + 1e-4
    assert ref_traj.turned(turned, T)[1:] == pytest.approx(0.01 * np.arange(1, 20), rel=1e-6)
    assert ref_traj.turned(skew, T).max() < 1e-9 and ref_traj.turned(bad, T).max() < 1e-9


def test_preprocess_reference_against_the_port():
    """The port's preprocessor on the CPU gives no violation; dropping half of
    a scan's points before it, or moving one output point, does."""
    from glim_tpu_torch.preprocess.cloud_preprocessor import CloudPreprocessor
    from glim_tpu_torch.types import RawPoints
    with open(os.path.join(ROOT, "benchmark", "configs", "default_gpu.json")) as f:
        params = glim_config.preprocess_params(json.load(f))
    t = traffic("circle", scan_points=16384, scene={"points": 60000, "extent": 30.0})
    seq = landmark_scans.generate(t, 11, 3, "cpu")
    pre = CloudPreprocessor(device="cpu")
    for i in range(3):
        raw = seq.points[i]
        f = pre.preprocess(RawPoints(stamp=float(seq.stamps[i]), points=raw,
                                     times=seq.times[i]))
        args = (f.device_points, f.device_mask, f.device_times, params)
        assert ref_pre.violations(raw, *args) == 0
        half = pre.preprocess(RawPoints(stamp=float(seq.stamps[i]), points=raw[::2],
                                        times=seq.times[i][::2]))
        assert ref_pre.violations(raw, half.device_points, half.device_mask,
                                  half.device_times, params) > 0
        moved = f.device_points.clone()
        moved[0, 0] += 0.05
        assert ref_pre.violations(raw, moved, *args[1:]) > 0
