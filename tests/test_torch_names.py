"""Every public name of the JAX package, its root scripts and its tools has a
counterpart in the port.

An ``ast`` walk of both source trees (nothing is imported).  For every
module ``mmgclip_tpu/<path>``, each public top-level name it defines (a
function, a class, an assignment target) must be bound at the top level of
``mmgclip_tpu_torch/<path>``, or stand in ``COUNTERPARTS`` below with the
port's counterpart (``path::name``, checked to exist) or ``None`` and the
reason.  A package's ``__init__.py`` is a facade: each name it binds,
imports included, must be bound in the port's ``__init__.py`` or in a
module of the port's package (the port's subpackages import nothing
eagerly, which keeps their modules free of import cycles).

The table is checked too: every entry names a JAX name that exists and has
no same-named counterpart, so a name ported later leaves the table.

The root scripts of the JAX system (``train.py`` ... ``bench.py``) map to
``mmgclip_tpu_torch/<name>.py`` and each ``tools/<name>.py`` to
``mmgclip_tpu_torch/tools/<name>.py``: each public name a script defines
must be defined in its counterpart too, or stand in ``SCRIPT_COUNTERPARTS``
with the reason.  Every ``.py`` file at the repository's root is one of
those scripts, one of the port's own root scripts, or in ``NOT_PORTED``
with the reason, so a new script fails here until it is placed.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "mmgclip_tpu")
PORT_ROOT = os.path.join(REPO, "mmgclip_tpu_torch")

PALLAS = "a Pallas / TPU tiling constant or switch; the CUDA kernels in csrc/ keep their own"
CONSTRUCTOR = "flax's init returns (module, params); the port's nn.Module builds its params"

# (JAX module, name) -> (the port's counterpart "path::name" or None, why).
# Name "*": the whole module.
COUNTERPARTS = {
    ("models/bert.py", "init_bert"): ("models/bert.py::BertEncoder", CONSTRUCTOR),
    ("models/bert.py", "bert_embeddings"): (
        "models/bert.py::BertEncoder",
        "the embedding block outside the module, for the pipelined forward: "
        "BertEncoder.embed, which parallel/pipeline.py calls"),
    ("models/bert.py", "load_hf_weights"): (
        "models/bert.py::hf_tree",
        "an HF state dict to the flax tree (hf_tree), loaded by weights.py::load_flax_tree"),
    ("models/convnext.py", "init_convnext"): ("models/convnext.py::ConvNeXt", CONSTRUCTOR),
    ("models/convnext.py", "load_torchvision_weights"): (
        "models/convnext.py::torchvision_tree",
        "a torchvision state dict to the flax tree (torchvision_tree), loaded by "
        "weights.py::load_flax_tree"),
    ("models/gpt.py", "init_gpt"): ("models/gpt.py::CausalTextEncoder", CONSTRUCTOR),
    ("models/resnet.py", "init_resnet50"): ("models/resnet.py::ResNet50Encoder", CONSTRUCTOR),
    ("ops/banding.py", "*"): (
        None, "VMEM budgets and tile heuristics for the Pallas kernels' TPU grids; the CUDA "
        "kernels plan their own tiles against shared memory (csrc/fused_block.cu)"),
    ("ops/depthwise_conv.py", "K"): (None, PALLAS),
    ("ops/depthwise_conv.py", "HALO"): (None, PALLAS),
    ("ops/fused_block.py", "K"): (None, PALLAS),
    ("ops/fused_block.py", "HALO"): (None, PALLAS),
    ("ops/fused_block.py", "FORCE_INTERPRET"): (
        None, "Pallas interpret mode; a CPU tensor runs the plain version instead"),
    ("ops/fused_downsample.py", "FORCE_INTERPRET"): (
        None, "Pallas interpret mode; a CPU tensor runs the plain version instead"),
    ("ops/fused_stem.py", "FORCE_INTERPRET"): (
        None, "Pallas interpret mode; a CPU tensor runs the plain version instead"),
    ("ops/fused_downsample.py", "kernel_available"): (
        None, "whether the backend runs the Pallas kernel; the port's wrapper launches its "
        "kernel on every CUDA tensor or raises"),
    ("ops/fused_stem.py", "kernel_available"): (
        None, "whether the backend runs the Pallas kernel; the port's wrapper launches its "
        "kernel on every CUDA tensor or raises"),
    ("parallel/multihost.py", "global_batch_from_local"): (
        "parallel/mesh.py::shard_batch",
        "a global jax.Array from each process's rows; a rank holds only its rows "
        "(mesh.shard_batch / put_global)"),
    ("parallel/multihost.py", "replicated_global"): (
        "parallel/mesh.py::replicate",
        "a replicated global jax.Array; every rank holds the whole value (mesh.replicate)"),
    ("training/checkpoint.py", "save_checkpoint_orbax"): (
        None, "not ported: orbax's OCDBT / zarr3 format goes through tensorstore and JAX, "
        "which the card's machine lacks; no entry point, config or tool calls it (the "
        "checkpoints of every run are training/checkpoint.py::save_checkpoint's)"),
    ("training/checkpoint.py", "load_checkpoint_orbax"): (
        None, "not ported: orbax's OCDBT / zarr3 format goes through tensorstore and JAX, "
        "which the card's machine lacks; no entry point, config or tool calls it"),
}


# the JAX system's root scripts; each has mmgclip_tpu_torch/<name>.py
JAX_SCRIPTS = ("train", "encode_images", "encode_studies", "evaluate_clip", "evaluate_cnn",
               "generate_report", "serve", "bench")
# the port's own root scripts (the card's smoke run and kernel timing tools)
PORT_SCRIPTS = ("chip_smoke", "kernel_ab", "block_sweep", "stem_sweep")
NOT_PORTED = {
    "__graft_entry__.py": (
        "the JAX driver's compile check and multi-chip dry run; its rehearsals have "
        "counterparts in parallel/multihost.py::run_*_dryrun and chip_smoke.py phase 21"),
}
TOOLS_ROOT = os.path.join(REPO, "tools")
SCRIPT_ROOT = "a script's repository root, put on sys.path to run it as a file; the port's " \
    "tools run as package modules (python -m) and find configs/ through cli.DEFAULT_CONFIG_DIR"
# (script path from the repo root, name) -> (the port's counterpart "path::name" or None, why)
SCRIPT_COUNTERPARTS = {
    ("tools/compare_runs.py", "REPO"): (None, SCRIPT_ROOT),
    ("tools/data_efficiency.py", "REPO"): (None, SCRIPT_ROOT),
    ("tools/eda.py", "REPO"): (None, SCRIPT_ROOT),
    ("tools/demo_run.py", "DEMO"): (
        "tools/demo_run.py::main",
        "the JAX demo's fixed outputs/demo tree; the port writes under --out (default "
        "outputs/demo_torch) and refuses outputs/demo, which holds the JAX tool's run"),
    ("tools/demo_run.py", "RUN"): ("tools/demo_run.py::main", "<--out>/run, see DEMO"),
    ("tools/demo_run.py", "DATA"): ("tools/demo_run.py::main", "<--out>/data, see DEMO"),
    ("tools/make_vocab_fixture.py", "OUT"): (
        "tools/make_vocab_fixture.py::main",
        "the JAX script's fixed tests/data path; the port's main takes --out"),
}


def bound_names(path, imports=True):
    """Public names bound at the top level of a source file (definitions,
    assignment targets and, with ``imports``, imported names)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                names |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def jax_modules():
    out = []
    for root, _dirs, files in os.walk(JAX_ROOT):
        out += [os.path.relpath(os.path.join(root, f), JAX_ROOT) for f in files if f.endswith(".py")]
    return sorted(out)


def port_package_names(package_dir):
    """Every public name bound in any module of a port package, and the
    names of its modules."""
    names = set()
    for root, _dirs, files in os.walk(os.path.join(PORT_ROOT, package_dir)):
        for f in files:
            if f.endswith(".py"):
                names |= bound_names(os.path.join(root, f)) | {f[:-3]}
    return names


def missing_names(module):
    """The JAX module's public names with no same-named counterpart."""
    jax_path, port_path = os.path.join(JAX_ROOT, module), os.path.join(PORT_ROOT, module)
    facade = os.path.basename(module) == "__init__.py"
    ours = bound_names(jax_path, imports=facade)
    if not os.path.exists(port_path):
        return ours | {"*"}
    theirs = bound_names(port_path)
    if facade:
        theirs |= port_package_names(os.path.dirname(module))
    return ours - theirs


def listed(module, name):
    if (module, name) in COUNTERPARTS or (module, "*") in COUNTERPARTS:
        return True
    if os.path.basename(module) == "__init__.py":  # a facade re-exports a listed name
        package = os.path.dirname(module)
        return any(m.startswith(package) and n == name for m, n in COUNTERPARTS)
    return False


@pytest.mark.parametrize("module", jax_modules())
def test_every_jax_name_has_a_counterpart(module):
    unlisted = sorted(n for n in missing_names(module) if not listed(module, n))
    assert not unlisted, (f"mmgclip_tpu/{module}: {unlisted} have no counterpart in "
                          f"mmgclip_tpu_torch/{module} and no entry in COUNTERPARTS")


@pytest.mark.parametrize("key", sorted(COUNTERPARTS), ids=lambda k: f"{k[0]}::{k[1]}")
def test_every_table_entry_is_needed_and_points_somewhere(key):
    module, name = key
    counterpart, reason = COUNTERPARTS[key]
    assert reason
    if name == "*":
        assert os.path.exists(os.path.join(JAX_ROOT, module))
        assert not os.path.exists(os.path.join(PORT_ROOT, module))
    else:
        assert name in bound_names(os.path.join(JAX_ROOT, module), imports=False)
        assert name in missing_names(module), f"{module}::{name} now has a same-named counterpart"
    if counterpart is not None:
        path, target = counterpart.split("::")
        assert target in bound_names(os.path.join(PORT_ROOT, path)), counterpart


def scripts():
    """Repo-relative paths of the JAX system's scripts."""
    tools = sorted(f for f in os.listdir(TOOLS_ROOT) if f.endswith(".py"))
    return [f"{name}.py" for name in JAX_SCRIPTS] + [f"tools/{f}" for f in tools]


def test_every_root_script_is_placed():
    root = {f for f in os.listdir(REPO) if f.endswith(".py")}
    ours = {f"{name}.py" for name in JAX_SCRIPTS} | {f"{name}.py" for name in PORT_SCRIPTS}
    assert root - ours == set(NOT_PORTED), "root scripts neither mapped, the port's nor listed"
    assert ours <= root, sorted(ours - root)


@pytest.mark.parametrize("script", scripts())
def test_every_script_name_has_a_counterpart(script):
    port_path = os.path.join(PORT_ROOT, script)
    assert os.path.exists(port_path), f"{script} has no counterpart mmgclip_tpu_torch/{script}"
    missing = bound_names(os.path.join(REPO, script), imports=False) - bound_names(port_path)
    unlisted = sorted(n for n in missing if (script, n) not in SCRIPT_COUNTERPARTS)
    assert not unlisted, (f"{script}: {unlisted} have no counterpart in "
                          f"mmgclip_tpu_torch/{script} and no entry in SCRIPT_COUNTERPARTS")


@pytest.mark.parametrize("key", sorted(SCRIPT_COUNTERPARTS), ids=lambda k: f"{k[0]}::{k[1]}")
def test_every_script_table_entry_is_needed(key):
    script, name = key
    counterpart, reason = SCRIPT_COUNTERPARTS[key]
    assert reason
    assert name in bound_names(os.path.join(REPO, script), imports=False)
    assert name not in bound_names(os.path.join(PORT_ROOT, script)), f"{script}::{name} is ported"
    if counterpart is not None:
        path, target = counterpart.split("::")
        assert target in bound_names(os.path.join(PORT_ROOT, path)), counterpart
