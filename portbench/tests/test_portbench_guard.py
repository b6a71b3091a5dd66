"""The import guard, and the reference's independence from the port."""

import ast
import os
import subprocess
import sys

from portbench import guard
from portbench.tests.micro import ROOT

HERE = os.path.join(ROOT, "portbench")


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["mmgclip_tpu_torch", "mmgclip_tpu_torch.ops", "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "mmgclip_tpu.models"]) == ["jax", "mmgclip_tpu"]
    assert guard.forbidden_loaded(["flaxen", "optax_x", "jaxlib"]) == ["jaxlib"]


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_port():
    folder = os.path.join(HERE, "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            for module in _imports(os.path.join(folder, name)):
                top = module.lstrip(".").split(".")[0]
                assert top not in ("mmgclip_tpu_torch", "mmgclip_tpu", "jax", "flax", "optax"), (name, module)
                assert not module.startswith("..") or module.startswith("..reference"), (name, module)


def test_reference_loads_no_port_module():
    code = ("import sys, portbench.reference.convnext, portbench.reference.resnet, "
            "portbench.reference.text, portbench.reference.clip; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mmgclip_tpu_torch', 'mmgclip_tpu', 'jax', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_harness_never_imports_jax():
    for folder, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py") and "tests" not in folder:
                for module in _imports(os.path.join(folder, name)):
                    top = module.lstrip(".").split(".")[0]
                    assert top not in guard.FORBIDDEN, (folder, name, module)
