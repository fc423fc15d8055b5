"""GlimTorch applies config_logging.json as GlimTPU does: the same log files
in ``log_dir`` for the same settings, and none with ``save_logs`` false.

Each package builds its pipeline once, synchronously, on the default
configuration, in a Python process of its own: a module logger takes its
file sink once, when it is first made, so the set of files depends on what
the process imported before the pipeline applied the settings, and the
test's own process (and its xdist worker) has imported both packages.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = """
import json, os, sys, tempfile
pkg, log_dir, save_logs = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
if pkg == "jax":
    from glim_tpu.pipeline import GlimTPU as Pipeline
    from glim_tpu.utils.config import create_default_config_dir
    kwargs = {}
else:
    from glim_tpu_torch.pipeline import GlimTorch as Pipeline
    from glim_tpu_torch.utils.config import create_default_config_dir
    kwargs = {"device": "cpu"}
cfg = create_default_config_dir(tempfile.mkdtemp(dir=os.path.dirname(log_dir)))
path = os.path.join(cfg, "config_logging.json")
with open(path) as f:
    logging_cfg = json.load(f)
logging_cfg["logging"].update(log_dir=log_dir, save_logs=save_logs)
with open(path, "w") as f:
    json.dump(logging_cfg, f)
Pipeline(cfg, async_mode=False, **kwargs)
print(json.dumps(sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []))
"""


def _log_files(pkg, tmp_path, save_logs):
    log_dir = str(tmp_path / pkg / "logs")
    os.makedirs(os.path.dirname(log_dir))
    r = subprocess.run([sys.executable, "-c", _BUILD, pkg, log_dir, "1" if save_logs else "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("save_logs", [True, False])
def test_log_files_match_jax(tmp_path, save_logs):
    """The port writes the JAX package's log files, less
    glim_precompile.log (mapping/precompile.py is not ported); with
    save_logs false neither package writes one."""
    jax_files = _log_files("jax", tmp_path, save_logs)
    port_files = _log_files("torch", tmp_path, save_logs)
    assert port_files == [f for f in jax_files if f != "glim_precompile.log"]
    if save_logs:
        assert {"glim_global.log", "glim_sub.log", "glim_validator.log"} <= set(port_files)
    else:
        assert jax_files == port_files == []


def test_default_log_dir_is_the_temporary_directory(tmp_path):
    """The default config_logging's log_dir, "/tmp", is read as the
    directory tempfile.gettempdir() names: with TMPDIR set, the port's log
    files go there, so runs with temporary directories of their own keep
    their log files apart."""
    tmpdir = tmp_path / "tmpdir"
    tmpdir.mkdir()
    code = ("import tempfile\n"
            "from glim_tpu_torch.pipeline import GlimTorch\n"
            "from glim_tpu_torch.utils.config import create_default_config_dir\n"
            "GlimTorch(create_default_config_dir(tempfile.mkdtemp()), async_mode=False, "
            "device='cpu')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmpdir)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert {"glim_global.log", "glim_sub.log", "glim_validator.log"} <= set(os.listdir(tmpdir))
