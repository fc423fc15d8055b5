"""Every public name of glim_tpu/ has a twin in glim_tpu_torch/.

An ``ast`` walk (neither package is imported) lists, module by module, the
public top-level functions and classes and the public methods of those
classes. A name of ``glim_tpu/<path>`` is twinned when the port's
``glim_tpu_torch/<path>`` defines it, or re-exports it by importing it from
the port, or it stands in one of the lists below. The lists are checked
too: nothing in them may have a twin after all, so none outlives its
reason.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "glim_tpu")
PORT_ROOT = os.path.join(REPO, "glim_tpu_torch")

# Modules the port drops on purpose, with the reason.
DROPPED = {
    "mapping/precompile.py": "XLA's background compiles of the next shape buckets; torch "
                             "runs its ops eagerly and has no program to compile ahead",
    "ops/pallas_knn.py": "the Pallas kernel; its port is csrc/nn_search.cu behind "
                         "ops/nn_search.py's nn_search",
}
# Names the port carries under another name: (path, JAX name) -> (path, port name).
# A renamed class's methods follow it.
RENAMED = {
    ("pipeline.py", "GlimTPU"): ("pipeline.py", "GlimTorch"),
    ("types.py", "EstimationFrame.prefetch"): ("types.py", "HostCopy"),
    ("types.py", "PointBatch.to_numpy"): ("types.py", "to_numpy"),
}
# Methods the port's class inherits: (path, JAX name) -> (path, base's name).
INHERITED = {
    ("common/imu_validation.py", "IMUValidatorExtension.ok"):
        ("utils/extension_module.py", "ExtensionModule.ok"),
    ("common/imu_validation.py", "IMUValidatorExtension.needs_wait"):
        ("utils/extension_module.py", "ExtensionModule.needs_wait"),
}


def _modules(root):
    return sorted(os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".py"))


def _public_names(path, package=None):
    """Public top-level functions and classes, ``Class.method`` for their
    public methods, and, with ``package``, the names imported from it."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names, bases = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            bases[node.name] = [ast.unparse(b) for b in node.bases]
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                         and not m.name.startswith("_"))
        if package and isinstance(node, ast.ImportFrom) and node.level == 0 \
                and (node.module or "").split(".")[0] == package:
            names.update(a.asname or a.name for a in node.names)
    return names, bases


def _port_names(rel):
    path = os.path.join(PORT_ROOT, rel)
    return _public_names(path, "glim_tpu_torch") if os.path.exists(path) else (set(), {})


def _twin(rel, name):
    """(path, name) where the port must hold ``name`` of glim_tpu/``rel``."""
    if (rel, name) in RENAMED:
        return RENAMED[rel, name]
    cls, _, method = name.partition(".")
    if method and (rel, cls) in RENAMED:
        new_rel, new_cls = RENAMED[rel, cls]
        return new_rel, f"{new_cls}.{method}"
    return INHERITED.get((rel, name), (rel, name))


JAX_MODULES = [m for m in _modules(JAX_ROOT) if m not in DROPPED]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_twin(rel):
    names, _ = _public_names(os.path.join(JAX_ROOT, rel))
    missing = sorted(n for n in names if _twin(rel, n)[1] not in _port_names(_twin(rel, n)[0])[0])
    assert not missing, f"glim_tpu/{rel}: no twin in glim_tpu_torch for {missing}"


def test_the_exceptions_are_still_needed():
    """Each dropped module exists in glim_tpu/ and not in the port; each
    renamed or inherited name lacks a same-named twin and its stand-in
    exists; an inherited method's class derives from the base named."""
    for rel in DROPPED:
        assert os.path.exists(os.path.join(JAX_ROOT, rel)), rel
        assert not os.path.exists(os.path.join(PORT_ROOT, rel)), rel
    for (rel, name), (new_rel, new_name) in {**RENAMED, **INHERITED}.items():
        assert name in _public_names(os.path.join(JAX_ROOT, rel))[0], (rel, name)
        assert name not in _port_names(rel)[0], f"{rel}: {name} has a twin; unlist it"
        assert new_name in _port_names(new_rel)[0], (new_rel, new_name)
    for (rel, name), (base_rel, base_name) in INHERITED.items():
        cls = name.split(".")[0]
        assert base_name.split(".")[0] in _port_names(rel)[1][cls], (rel, cls)
