"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor any module of the JAX package ``repro``.

Runs in a fresh interpreter, since this test process has both loaded.
"""
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any 'import jax' now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not leaked, leaked
assert "jaxlib" not in sys.modules
# the round engine and its counter-mode jitter are among them
assert {"repro_torch.serving.engine_torch", "repro_torch.core.threefry"} <= set(names)
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 80  # every module was walked
