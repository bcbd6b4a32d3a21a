"""The PyTorch port stands alone: no module of dav1d_tpu_torch, and not
chip_smoke.py, imports jax or anything of the dav1d_tpu package (the
port keeps its own copies of the host modules it needs)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dav1d_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """Top-level module names of every absolute import in the file;
    relative imports stay inside the package by construction."""
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_dav1d_tpu_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "dav1d_tpu"}
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_port_has_no_importlib_escape():
    """No dynamic import path around the AST check."""
    for path in _sources():
        src = open(path).read()
        assert "importlib" not in src, path


def test_sharded_modules_are_checked():
    """The sharded decode's modules (ROADMAP item 10) are among the
    sources the import rule walks."""
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for path in ("dav1d_tpu_torch/parallel/sharded.py",
                 "dav1d_tpu_torch/recon/sharded_stageb.py"):
        assert path in rel
        assert not _imported_roots(os.path.join(ROOT, path)) & \
            {"jax", "jaxlib", "dav1d_tpu"}
