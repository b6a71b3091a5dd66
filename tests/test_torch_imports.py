"""The port stands alone: no JAX, no ``mmgclip_tpu``, nothing the card's
machine lacks.

An AST check over every module of ``mmgclip_tpu_torch`` and ``chip_smoke.py``
refuses imports of the JAX package and of packages that machine does not
have, and a subprocess with those packages blocked in ``sys.modules`` imports
every port module and runs the micro serving path on the CPU.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mmgclip_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmgclip_tpu", "yaml", "msgpack", "PIL",
             "pandas", "transformers", "triton", "ninja")


def port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in paths)


@pytest.mark.parametrize("path", port_sources())
def test_no_forbidden_imports(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_port_runs_with_the_missing_packages_blocked(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None  # any import of it now raises ImportError
        import importlib, json, os, pkgutil, base64
        sys.path.insert(0, {REPO!r})
        import mmgclip_tpu_torch
        for info in pkgutil.walk_packages(mmgclip_tpu_torch.__path__, "mmgclip_tpu_torch."):
            importlib.import_module(info.name)
        import chip_smoke
        import numpy as np
        from mmgclip_tpu_torch.serving import InferenceEngine
        from mmgclip_tpu_torch.serve import handle
        run = os.path.join({REPO!r}, "outputs", "demo", "run")
        engine = InferenceEngine.from_experiment(run, device="cpu")
        png = os.path.join({str(tmp_path)!r}, "view.png")
        chip_smoke.write_png16(png, chip_smoke.synthetic_mammogram(64, 48, seed=0))
        feats = np.asarray(handle(engine, {{"op": "encode", "paths": [png]}})["features"], np.float32)
        assert feats.shape == (1, 768) and np.isfinite(feats).all()
        out = handle(engine, {{"op": "classify", "paths": [png], "class_list": ["a mass.", "no mass."]}})
        assert abs(sum(out["classes_similarities"][0]) - 1) < 1e-5
        b64 = base64.b64encode(feats.tobytes()).decode()
        report = handle(engine, {{"op": "report", "features_b64": b64}})["reports"]
        assert len(report) == 1 and report[0]
        engine.close()
        blocked = [m for m in {FORBIDDEN!r} if sys.modules.get(m) is not None]
        assert not blocked, blocked
        print("OK")
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    assert result.stdout.strip().splitlines()[-1] == "OK"


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
