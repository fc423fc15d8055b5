"""The port's back-end diagnosis tools on the CPU: ``tools/debug_backend``
(capture, sweep, its ATE helpers against the JAX tool's) and
``tools/profile_e2e``, with chip_smoke.py phases 13b and 13c rehearsed at a
tiny size.

Sizes: city_loop cut to 2-3 s (20-30 raycast scans at the tool's 32 x 512
rays, one or two submaps), profile_e2e at 2 s (two passes of 20 scans of
20,000 points). On the CPU the plain nn_search runs, so its calls are
counted by wrapping the port's ``ops.gicp.nn_search``.
"""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from glim_tpu.ops import lie_np


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


class _NumpyOnly(pickle.Unpickler):
    """Refuses every class outside numpy and the builtins."""

    def find_class(self, module, name):
        if module.split(".")[0] not in ("numpy", "builtins", "copyreg", "_codecs"):
            raise pickle.UnpicklingError(f"{module}.{name} in a numpy-only state")
        return super().find_class(module, name)


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    from glim_tpu_torch.tools import debug_backend

    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("debug_backend") / "state.pkl")
    assert debug_backend.main(["capture", "--seq", "city_loop", "--duration", "2",
                               "--out", path, "--device", "cpu"]) == 0
    return path


def test_capture_writes_a_numpy_only_state(captured):
    from glim_tpu_torch.tools import debug_backend

    with open(captured, "rb") as f:
        state = _NumpyOnly(f).load()
    assert len(state["gt_stamps"]) == 20 and len(state["ests"]) >= 10
    assert state["imu"].shape[1] == 7 and state["submaps"]
    d = state["submaps"][0]
    assert d["points"].dtype == np.float32 and d["mask"].dtype == bool and d["frames"]
    assert "T_world_origin_pre" in d["custom_data"]
    sm = debug_backend.submap_from_numpy(d, "cpu")
    again = debug_backend.submap_to_numpy(sm)
    for k in ("points", "mask", "covs", "T_world_origin"):
        np.testing.assert_array_equal(again[k], d[k])
    for a, b in zip(again["frames"], d["frames"]):
        assert a["stamp"] == b["stamp"] and a["frame_id"] == b["frame_id"]
        for k in ("T_world_lidar", "T_world_imu", "v_world_imu", "imu_bias"):
            np.testing.assert_array_equal(a[k], b[k])


def test_sweep_gives_finite_ates(captured, capsys):
    from glim_tpu_torch.tools import debug_backend

    assert debug_backend.main(["sweep", "--state", captured, "--which", "no_opt,default",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[sweep] no_opt: global ATE" in out and "[sweep] default: global ATE" in out
    res = debug_backend.sweep(captured, "no_opt,default", "cpu")
    assert set(res) == {"no_opt", "default"}
    for gm, m, seconds in res.values():
        assert np.isfinite(m.ate_rmse) and m.ate_rmse < 0.08 and seconds > 0
        assert all(np.all(np.isfinite(T)) for T in gm.poses)


def test_ate_helpers_match_jax():
    """_odom_ate and _global_ate on the same numpy poses through both
    packages' evaluation (submap frames re-anchored through the optimized
    poses and T_world_origin_pre)."""
    from glim_tpu.tools import debug_backend as j_db
    from glim_tpu.types import EstimationFrame as JFrame
    from glim_tpu.types import SubMap as JSubMap
    from glim_tpu_torch.tools import debug_backend as t_db
    from glim_tpu_torch.types import EstimationFrame as TFrame
    from glim_tpu_torch.types import SubMap as TSubMap

    rng = np.random.default_rng(5)
    stamps = np.round(np.arange(30) * 0.1, 4)
    gt = [lie_np.se3_exp(np.array([0, 0, 0.05 * k, 0.8 * k, 0.1 * k * k / 30, 0]))
          for k in range(30)]
    noisy = [T @ lie_np.se3_exp(rng.normal(size=6) * 0.01) for T in gt]
    state = dict(gt_stamps=stamps, gt_poses=np.stack(gt),
                 ests=[(s + 1e-6, T) for s, T in zip(stamps, noisy)])
    m_j, m_t = j_db._odom_ate(state), t_db._odom_ate(state)
    assert m_t.n_poses == m_j.n_poses == 30
    for k in ("ate_rmse", "ate_max", "rot_rmse_deg", "length_m"):
        assert getattr(m_t, k) == pytest.approx(getattr(m_j, k), rel=1e-9)

    def backend(Frame, SubMap):
        submaps, poses = [], []
        for i in range(3):
            pre = noisy[10 * i]
            frames = [Frame(id=k, stamp=float(stamps[k]), T_world_lidar=noisy[k])
                      for k in range(10 * i, 10 * i + 10)]
            submaps.append(SubMap(id=i, T_world_origin=pre, frames=frames,
                                  custom_data={"T_world_origin_pre": pre}))
            poses.append(gt[10 * i] @ lie_np.se3_exp(rng_b.normal(size=6) * 0.005))
        return SimpleNamespace(submaps=submaps, poses=poses)

    rng_b = np.random.default_rng(9)
    g_j = j_db._global_ate(backend(JFrame, JSubMap), state)
    rng_b = np.random.default_rng(9)
    g_t = t_db._global_ate(backend(TFrame, TSubMap), state)
    assert g_t.n_poses == g_j.n_poses == 30
    for k in ("ate_rmse", "ate_max", "rot_rmse_deg"):
        assert getattr(g_t, k) == pytest.approx(getattr(g_j, k), rel=1e-9)


def test_between_sweep_searches_six_times_a_refinement(monkeypatch):
    """chip_smoke.py phase 13b rehearsed: a 3 s capture (two submaps), the
    sweep of no_opt, default and between with its checks, and the between
    configuration's nn_search calls: 6 a refinement, one refinement a
    submap after the first."""
    import chip_smoke
    from glim_tpu_torch.ops import gicp

    calls = []
    real = gicp.nn_search
    monkeypatch.setattr(gicp, "nn_search", lambda *a: calls.append(1) or real(*a))
    res = chip_smoke.run_debug_backend("cpu", duration=3.0)
    chip_smoke.check_debug_backend(res, launches_per_refinement=0)
    assert res["submaps"] >= 2 and set(res["configs"]) == {"no_opt", "default", "between"}
    b = res["configs"]["between"]
    assert b["between_refinements"] == res["submaps"] - 1
    assert len(calls) == 6 * b["between_refinements"]


def test_profile_e2e_reports_every_worker_and_the_drain(capsys):
    from glim_tpu_torch.tools import profile_e2e

    res = profile_e2e.run(2.0, 10.0, "cpu")
    out = capsys.readouterr().out
    assert "warm pass ..." in out and "timed pass ..." in out and "[drain]" in out
    assert res["device"] == "cpu" and res["scans"] == 4
    assert np.isfinite(res["scans_per_s"]) and np.isfinite(res["with_drain_scans_per_s"])
    assert res["sustained_s"] > 0 and res["drain_s"] > 0
    # The scans of 2 s reach sub-mapping only in the drain (the 5 s window).
    spans = set(res["scopes"]) | set(res["drain_scopes"])
    assert {"preprocess", "odometry", "sub_mapping", "global_mapping"} <= spans
    assert res["drain_scopes"]
