"""``utils/profiling.device_trace``, the twin of JAX's ``device_trace``:
a no-op unless GLIM_TPU_TORCH_TRACE_DIR is set; set, a Chrome trace of the
enclosed work (host ops and the pipeline's spans, and on a card its
kernels) in ``$GLIM_TPU_TORCH_TRACE_DIR/<name>/trace.json``. Also a CPU
rehearsal of chip_smoke.py's phase 14 (the GICP slice traced in a process
of its own, with its log files) and, on a card, the kernel events against
nn_search's launch count.
"""

import json
import os

import pytest
import torch

from torch_parity import SMALL_DEFAULT_OVERRIDES

SLICE_TINY = dict(n_scan_points=1500, scene_points=20000, seed=53,
                  odometry_overrides=dict(window_size=6, initialization_window_size=0.3,
                                          model_capacity=8192),
                  preprocess_overrides=dict(random_downsample_target=1000,
                                            downsample_resolution=0.4),
                  sub_mapping_overrides=dict(max_num_keyframes=4))


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_without_the_variable_does_nothing(tmp_path, monkeypatch):
    from glim_tpu_torch.utils.profiling import device_trace

    monkeypatch.delenv("GLIM_TPU_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace("unset", "cpu"):
        assert not torch._C._autograd._profiler_enabled()
        torch.ones(8).sum()
    with device_trace("unset", "cuda"):          # no card needed when it is off
        pass
    assert os.listdir(tmp_path) == []


def test_device_trace_holds_a_cpu_pipeline_run(tmp_path, monkeypatch):
    """A short GlimTorch(device="cpu") run under device_trace: the trace
    loads as JSON and holds the pipeline's profile_scope spans, each stage
    once a scan."""
    import chip_smoke
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.profiling import device_trace

    monkeypatch.setenv("GLIM_TPU_TORCH_TRACE_DIR", str(tmp_path / "traces"))
    seq = generate_sequence(duration=0.5, n_scan_points=1500, scene_points=20000, seed=53)
    glim = GlimTorch(chip_smoke.config_dir(SMALL_DEFAULT_OVERRIDES), async_mode=False,
                     device="cpu")
    with device_trace("pipeline", "cpu"):
        chip_smoke._feed(glim, seq)
    events = _events(tmp_path / "traces" / "pipeline" / "trace.json")
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    n = len(seq.scans)
    for scope in ("preprocess", "odometry", "sub_mapping", "global_mapping"):
        assert spans.count(scope) == n, (scope, spans.count(scope), n)
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_device_trace_on_a_missing_card_raises(tmp_path, monkeypatch):
    from glim_tpu_torch.utils.profiling import device_trace

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("GLIM_TPU_TORCH_TRACE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace("card", "cuda"):
            pass
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("traced", [True, False])
def test_chip_smoke_device_trace_rehearsal_on_cpu(traced):
    """chip_smoke.py's phase 14 (and, untraced, ``--trace-cost``'s other
    run) at a tiny size on the CPU: the slice in a fresh process with the
    trace opened before scan 2, ahead of the first window step; a
    window_scan_step span for each of the run's window steps, no kernel
    events (the plain nn_search runs), and the log files in the config's
    log_dir."""
    import chip_smoke

    res = chip_smoke.run_device_trace("cpu", n_scans=8, trace_from=2, traced=traced,
                                      **SLICE_TINY)
    chip_smoke.check_device_trace(res, min_window_steps=4)
    assert res["kernel_launches"] == 0
    assert res["covered_s"] > 0
    assert sorted(res["log_files"]) == sorted(chip_smoke.LOG_FILES)
    assert res["log_files"]["glim_global.log"] > 0
    if traced:
        assert res["search_events"] == 0 and res["trace_events"] > 0
    else:
        assert "trace_bytes" not in res


@pytest.mark.gpu
def test_device_trace_counts_the_search_kernel_on_the_card(tmp_path, monkeypatch):
    """On the card: one search_split_kernel event for every nn_search launch
    counted inside the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn_search kernel has no CPU mode)")
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.utils.profiling import device_trace

    monkeypatch.setenv("GLIM_TPU_TORCH_TRACE_DIR", str(tmp_path))
    g = torch.Generator().manual_seed(0)
    q, t = torch.randn(4096, 3, generator=g).cuda(), torch.randn(8192, 3, generator=g).cuda()
    qm, tm = torch.ones(4096, dtype=torch.bool).cuda(), torch.ones(8192, dtype=torch.bool).cuda()
    nn_search.kernel_launches = 0
    with device_trace("nn", "cuda"):
        for _ in range(3):
            nn_search(q, qm, t, tm)
        launches = nn_search.kernel_launches
    names = [e["name"] for e in _events(tmp_path / "nn" / "trace.json")
             if e.get("cat") == "kernel"]
    assert launches == 3
    assert sum("search_split_kernel" in n for n in names) == launches
