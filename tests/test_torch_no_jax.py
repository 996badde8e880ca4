"""The port imports neither jax nor the JAX package."""
import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "sparsefusion_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sparsefusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "sparsefusion_tpu"))
print(len(names), " ".join(names), bad)
assert not bad, bad
"""


def test_port_loads_no_jax_in_a_fresh_process():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          capture_output=True, text=True, timeout=120,
                          cwd=PKG.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules, *names = proc.stdout.split()[:-1]
    assert int(n_modules) >= 20
    # the last slices' modules among them
    for name in ("render.mesh", "tools.make_toy_fixture",
                 "tools.parity_sweep", "nn.layers", "train.fused",
                 "utils.graphs"):
        assert f"sparsefusion_tpu_torch.{name}" in names, name


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|sparsefusion_tpu)\b",
        re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
