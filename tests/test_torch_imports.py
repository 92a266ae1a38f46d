"""The port package stands alone: importing it pulls in no JAX."""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "cpu_ray_tracing_implementation_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_import_leaves_jax_out():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'cpu_ray_tracing_implementation_tpu.')) or "
            "m == 'cpu_ray_tracing_implementation_tpu')\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PKG))
                                         for p in PKG.rglob("*.py")))
def test_no_jax_import_in_source(path):
    src = (PKG / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", src, re.M)
    # the JAX package is named in docs only, never imported
    assert not re.search(r"^\s*(import|from)\s+cpu_ray_tracing_implementation_tpu\b"
                         r"(?!_torch)", src, re.M)
