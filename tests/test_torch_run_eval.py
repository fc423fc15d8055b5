"""The port's accuracy runner (``tools/run_eval.py``) and ``tools/evaluate``.

One short raycast sequence (2 s, 16 channels x 256 azimuth steps, made from
a seed) goes through both packages' ``run_sequence`` (the flagship
odometry, sub-mapping and the matching-cost global mapping) and the
odometry ATE must agree within 10% or 2 mm; the pose-graph back-end's row
runs on the same sequence. The registry matrix runs all 16 rows, each
beside EVAL.md's, and lets any exception through; the report goes to its
own file, headed by the device. ``evaluate`` gives the JAX tool's numbers on
the same TUM files.
"""

import json

import numpy as np
import pytest
import torch

from glim_tpu.io.synthetic import generate_raycast_sequence as j_generate
from glim_tpu.tools import run_eval as j_run_eval
from glim_tpu_torch.io import synthetic as t_synthetic
from glim_tpu_torch.io.evaluation import evaluate_trajectory
from glim_tpu_torch.tools import run_eval as t_run_eval

ATE_REL, ATE_ABS = 0.10, 0.002
SEQ = dict(duration=2.0, n_channels=16, n_azimuth=256, imu_noise=0.02,
           imu_bias=t_run_eval.IMU_BIAS, seed=42, **t_run_eval.SEQUENCES["figure8_room"])


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def test_sequence_generator_is_the_jax_one():
    a, b = t_synthetic.generate_raycast_sequence(**SEQ), j_generate(**SEQ)
    assert len(a.scans) == len(b.scans) == 20
    for sa, sb in zip(a.scans, b.scans):
        np.testing.assert_array_equal(sa.points, sb.points)
        np.testing.assert_array_equal(sa.times, sb.times)
    np.testing.assert_array_equal(a.imu, b.imu)
    assert t_run_eval.SEQUENCES == j_run_eval.SEQUENCES


def test_run_sequence_matches_jax():
    seq = t_synthetic.generate_raycast_sequence(**SEQ)
    m_t, _, sps, extra = t_run_eval.run_sequence(seq, downsample=2000, device="cpu")
    m_j, _, _, extra_j = j_run_eval.run_sequence(seq, downsample=2000)
    assert m_t.n_poses == m_j.n_poses >= 15
    assert abs(m_t.ate_rmse - m_j.ate_rmse) <= max(ATE_REL * m_j.ate_rmse, ATE_ABS), \
        (m_t.ate_rmse, m_j.ate_rmse)
    assert extra["n_submaps"] == extra_j["n_submaps"] >= 1 and sps > 0
    # The pose-graph row: the same odometry, the pose-graph back-end's map.
    m_p, g_p, _, extra_p = t_run_eval.run_sequence(seq, downsample=2000, pose_graph=True,
                                                   device="cpu")
    assert m_p.n_poses == m_t.n_poses and extra_p["n_submaps"] == extra["n_submaps"]
    assert abs(m_p.ate_rmse - m_t.ate_rmse) <= ATE_ABS
    assert g_p is not None and np.isfinite(g_p.ate_rmse) and g_p.ate_rmse < 0.1


def test_matrix_rows_and_report(tmp_path, monkeypatch):
    """--matrix on a stubbed run_sequence: all 16 rows run (the pose-graph
    rows too), each beside EVAL.md's row, and a fault in a row
    propagates."""
    seq = t_synthetic.generate_raycast_sequence(**SEQ)
    m = evaluate_trajectory(seq.gt_poses, seq.gt_poses)
    calls = []

    def fake(seq, odom_params=None, pose_graph=False, odometry="flagship",
             sub_mapping="full", device="cuda"):
        calls.append((odometry, sub_mapping, pose_graph))
        return m, m, 1.0, dict(n_submaps=2, n_scans=len(seq.scans))

    monkeypatch.setattr(t_run_eval, "run_sequence", fake)
    out = tmp_path / "EVAL_TORCH.md"
    res = t_run_eval.main(["--device", "cpu", "--quick", "--matrix", "--sequences",
                           "figure8_room", "--out", str(out), "--channels", "16",
                           "--azimuth", "256"])
    assert len(calls) == 1 + 16 and len(res["matrix"]) == 16
    assert sum(pg for _, _, pg in calls) == 8
    text = out.read_text()
    assert "not ported" not in text
    assert "host CPU" in text and "| figure8_room |" in text and "0.0138" in text
    assert text.count(" / pose_graph |") == 8
    assert "| flagship / full / pose_graph | 0.0000 | 0.0179 | 0.0000 | 0.0179 |" in text

    def broken(*a, **k):
        raise ValueError("a fault in the pipeline")
    monkeypatch.setattr(t_run_eval, "run_sequence", broken)
    with pytest.raises(ValueError, match="a fault"):
        t_run_eval.main(["--device", "cpu", "--quick", "--matrix", "--sequences",
                         "figure8_room", "--out", str(out), "--channels", "16",
                         "--azimuth", "256"])


def test_evaluate_matches_jax(tmp_path, capsys):
    from glim_tpu.tools import evaluate as j_evaluate
    from glim_tpu_torch.io.evaluation import save_tum
    from glim_tpu_torch.tools import evaluate as t_evaluate

    rng = np.random.default_rng(0)
    seq = t_synthetic.generate_sequence(duration=3.0, n_scan_points=100, scene_points=1000)
    est = []
    for T in seq.gt_poses:
        E = T.copy()
        E[:3, 3] += rng.normal(size=3) * 0.01
        est.append(E)
    save_tum(str(tmp_path / "gt.tum"), seq.stamps, seq.gt_poses)
    dump = tmp_path / "dump"
    dump.mkdir()
    save_tum(str(dump / "traj_lidar.txt"), seq.stamps, est)
    outs = []
    for tool in (t_evaluate, j_evaluate):
        assert tool.main([str(dump), str(tmp_path / "gt.tum"), "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0]["n_poses"] == len(seq.stamps)
    assert 0.005 < outs[0]["ate_rmse_m"] < 0.03
