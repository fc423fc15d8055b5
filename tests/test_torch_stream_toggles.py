"""The watch page's toggles show the back-end's state: the runner's viewer
stream carries the back-end's ``global_optimization`` and
``loop_detection`` flags in each line's stats (read as the ``status``
command reads them), a ``set_enabled`` shows in the lines after it, and
the page sets its toggles from the newest line rather than a constant.
"""

import json
import os
import re
import threading
import time

import pytest
import torch

from torch_parity import SMALL_DEFAULT_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_runner_stream_carries_the_backend_flags(tmp_path):
    """A runner run with enable_optimization false: the stream's lines say
    so from the first; a set_enabled command appended once the stream has
    a line turns it on, and the last line says so. Loop detection stays on.
    Every line keeps the JAX schema plus the two flags."""
    import chip_smoke
    from glim_tpu_torch.tools import glim_runner

    n_scans, flip_at = 30, 10
    seq = chip_smoke._sequence(n_scans, 1500, 20000, 53)
    data, stream, commands = (str(tmp_path / n) for n in ("data", "s.jsonl", "c.jsonl"))
    glim_runner.save_dataset(data, seq.imu, [(s.stamp, s.points, s.times) for s in seq.scans])
    cfg = chip_smoke.config_dir(SMALL_DEFAULT_OVERRIDES + [
        ("config_global_mapping", "global_mapping", "enable_optimization", False)])
    open(stream, "w").close()

    def on_scan(i):
        if i == flip_at:                  # the flip lands between two lines
            t_end = time.monotonic() + 120.0
            while not _lines(stream) and time.monotonic() < t_end:
                time.sleep(0.05)
            with open(commands, "a") as f:
                f.write(json.dumps({"cmd": "set_enabled", "target": "global_optimization",
                                    "value": True}) + "\n")

    run = glim_runner.main([data, "--dump", str(tmp_path / "dump"), "--device", "cpu",
                            "--config", cfg, "--viewer-stream", stream, "--commands", commands],
                           on_scan=on_scan)
    assert [c["cmd"] for c, _ in run["command_results"]] == ["set_enabled"]
    assert run["command_results"][0][1]["previous"] is False
    lines = _lines(stream)
    flags = [(ln["stats"]["global_optimization"], ln["stats"]["loop_detection"]) for ln in lines]
    assert flags[0] == (False, True) and flags[-1] == (True, True), flags
    assert flags == sorted(flags), flags                     # off, then on, never back
    assert chip_smoke.stream_schema_errors(stream, flags=True) == []
    assert chip_smoke.stream_schema_errors(stream) != []     # the JAX keys alone no longer
    assert run["glim"].global_backend.params.enable_optimization is True


def test_status_and_the_stream_read_the_same_flags():
    """``backend_flags`` is what ``status`` reports, before and after each
    ``set_enabled``."""
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
    from glim_tpu_torch.viewer.interactive_viewer import (InteractiveViewer, backend_flags,
                                                          execute_command)

    gm = GlobalMapping(GlobalMappingParams(enable_optimization=False), device="cpu")
    viewer = InteractiveViewer(gm, live=True, lock=threading.Lock())
    for cmd in (None, ("loop_detection", False), ("global_optimization", True),
                ("loop_detection", True)):
        if cmd:
            out = execute_command(viewer, {"cmd": "set_enabled", "target": cmd[0],
                                           "value": cmd[1]})
            assert out["ok"] and out["value"] is cmd[1]
        status = execute_command(viewer, {"cmd": "status"})
        assert {k: status[k] for k in backend_flags(gm)} == backend_flags(gm)
    assert backend_flags(gm) == dict(global_optimization=True, loop_detection=True)


def test_watch_page_sets_its_toggles_from_the_stream():
    """String checks of the page's script: no toggle starts from a constant
    state; each reads its flag from a stream line's stats, is refreshed
    after every poll, and a click posts the negation of the shown state."""
    with open(os.path.join(REPO, "glim_tpu_torch", "viewer", "watch.html")) as f:
        page = f.read()
    assert not re.search(r"\bon\s*:\s*(true|false)", page)
    assert 'target:"global_optimization"' in page and 'target:"loop_detection"' in page
    assert re.search(r"lines\[i\]\.stats", page) and "typeof s[target]===\"boolean\"" in page
    assert re.search(r"parse\(await r\.text\(\)\);[^}]*\n\s*showToggles\(\);", page)
    assert "value:!on" in page
    assert ">opt ?</button>" in page and ">loops ?</button>" in page
