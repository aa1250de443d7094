"""The PyTorch port imports neither JAX nor the JAX package.

Two checks: a fresh interpreter imports every port module and finds neither
``jax`` nor ``or_gym_inventory_tpu`` in ``sys.modules``; a static scan of the
port's sources finds no import of either. No numeric tolerances apply.
"""

import ast
import pathlib
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parents[1] / "or_gym_inventory_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_fresh_import_pulls_in_no_jax():
    mods = list(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('or_gym_inventory_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PORT.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "flax", "or_gym_inventory_tpu"):
                    offenders.append(f"{path.name}: {name}")
    assert not offenders, offenders
    mods = set(_port_modules())
    assert len(mods) >= 29
    assert {"or_gym_inventory_torch.core.config", "or_gym_inventory_torch.envs.inv_management",
            "or_gym_inventory_torch.envs.newsvendor",
            "or_gym_inventory_torch.ops.episode_kernels",
            "or_gym_inventory_torch.agents.recurrent_ppo",
            "or_gym_inventory_torch.agents.networks",
            "or_gym_inventory_torch.vector.fast_episodes"} <= mods
