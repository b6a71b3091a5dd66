"""The C entry points of ``mmgclip_tpu_torch/csrc`` against the ctypes
signatures their wrappers register, and the build's keying on the headers.

ctypes takes a signature on trust: an argument too many or of the wrong kind
goes unnoticed until the kernel reads garbage on the card.  These tests
parse every ``extern "C"`` prototype of ``csrc/*.cu`` and hold its argument
count and kinds (pointer, int, long long, unsigned, float) against the
``_SIGNATURES`` entry of the module whose ``_SOURCE`` it is, here on the CPU.
"""

import ctypes
import os
import re

import pytest

import block_sweep
import stem_sweep
from mmgclip_tpu_torch.ops import _build, depthwise_conv, dropout, flash_attention, fused_block
from mmgclip_tpu_torch.ops import fused_downsample, fused_stem, kda, mla_attention, moe_experts
from mmgclip_tpu_torch.ops import png_unfilter, rms_norm
from mmgclip_tpu_torch.parallel import collectives

MODULES = (fused_block, flash_attention, fused_stem, fused_downsample, depthwise_conv, collectives,
           dropout, png_unfilter, moe_experts, mla_attention, kda, rms_norm)
_PROTOTYPE = re.compile(r"^int\s+(mmg_\w+)\s*\(([^)]*)\)\s*\{", re.MULTILINE)
_C_KINDS = {"int": "int", "long long": "long long", "unsigned": "unsigned",
            "unsigned int": "unsigned", "float": "float"}
_CTYPES_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long",
                 ctypes.c_uint: "unsigned", ctypes.c_float: "float"}


def c_kind(argument: str) -> str:
    """One C parameter (``const float* __restrict__ ns``) -> its kind."""
    if "*" in argument:
        return "pointer"
    words = [w for w in argument.split() if w not in ("const", "__restrict__")]
    return _C_KINDS[" ".join(words[:-1])]  # drop the parameter's name


def ctypes_kind(argtype) -> str:
    if isinstance(argtype, type) and issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return _CTYPES_KINDS[argtype]


def prototypes(source: str) -> dict:
    """``extern "C"`` entry points of a source -> [kinds of their arguments]."""
    with open(os.path.join(_build.CSRC_DIR, source)) as fh:
        text = re.sub(r"//[^\n]*", "", fh.read())
    text = text[text.index('extern "C" {'):]
    return {name: [c_kind(a.strip()) for a in args.split(",")]
            for name, args in _PROTOTYPE.findall(text)}


def test_every_source_has_one_registering_module():
    assert sorted(m._SOURCE for m in MODULES) == sorted(_build.SOURCES)


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m._SOURCE)
def test_prototypes_match_the_ctypes_signatures(module):
    ours = prototypes(module._SOURCE)
    assert ours, f"no extern \"C\" entry point parsed from {module._SOURCE}"
    assert set(ours) == set(module._SIGNATURES)
    for name, kinds in ours.items():
        registered = [ctypes_kind(t) for t in module._SIGNATURES[name]]
        assert registered == kinds, f"{name}: ctypes {registered} vs C {kinds}"


def test_the_png_unfilter_prototype_matches_its_ctypes_signature():
    """The host C source has no ``extern "C"`` block (it is C): every
    ``int mmg_*(...) {`` definition of it against ``png_reader._SIGNATURES``."""
    from mmgclip_tpu_torch.ingest import png_reader

    assert _build.HOST_SOURCES == (png_reader._SOURCE,)
    with open(os.path.join(_build.CSRC_DIR, png_reader._SOURCE)) as fh:
        text = re.sub(r"/\*.*?\*/", "", fh.read(), flags=re.DOTALL)
    ours = {name: [c_kind(a.strip()) for a in args.split(",")]
            for name, args in _PROTOTYPE.findall(text)}
    assert ours == {"mmg_png_unfilter": ["int", "long long", "int", "pointer"]}
    for name, kinds in ours.items():
        assert [ctypes_kind(t) for t in png_reader._SIGNATURES[name]] == kinds


def test_the_block_entry_point_takes_the_workspace():
    kinds = prototypes("fused_block.cu")["mmg_fused_block"]
    assert kinds[:13] == ["int"] + ["pointer"] * 12 and len(kinds) == 20


def test_the_int8_block_entry_point_takes_the_workspace():
    """x, dwk, dwb, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma, out and the
    fp32 workspace of the depthwise front half, as ``mmg_fused_block``."""
    kinds = prototypes("fused_block.cu")["mmg_fused_block_int8"]
    assert kinds[:15] == ["int"] + ["pointer"] * 14 and len(kinds) == 22
    assert kinds[15:] == ["int"] * 4 + ["float", "int", "pointer"]


def test_a_header_change_rebuilds_every_library(tmp_path, monkeypatch):
    """``_library_path`` keys each library on every ``csrc/*.cuh``: editing
    ``depthwise_tile.cuh`` rebuilds both the depthwise and the block library
    (both include it), and the rest too."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in os.listdir(_build.CSRC_DIR):
        (csrc / name).write_bytes(open(os.path.join(_build.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {s: _build._library_path(s) for s in _build.SOURCES}
    assert '#include "depthwise_tile.cuh"' in (csrc / "fused_block.cu").read_text()
    assert '#include "depthwise_tile.cuh"' in (csrc / "depthwise_conv.cu").read_text()
    with open(csrc / "depthwise_tile.cuh", "a") as fh:
        fh.write("\n// edited\n")
    after = {s: _build._library_path(s) for s in _build.SOURCES}
    assert all(before[s] != after[s] for s in _build.SOURCES)


@pytest.mark.parametrize("variant", sorted(block_sweep.VARIANTS))
def test_block_sweep_variants_match_the_source(variant):
    """Each variant of ``block_sweep.py`` finds its lines in ``fused_block.cu``
    as many times as it expects, so the sweep times what it names."""
    with open(os.path.join(_build.CSRC_DIR, "fused_block.cu")) as fh:
        text = fh.read()
    changed = block_sweep.variant_source(text, variant)
    assert (changed == text) == (variant == "base")


@pytest.mark.parametrize("variant", sorted(stem_sweep.VARIANTS))
def test_stem_sweep_variants_match_the_source(variant):
    """Each variant of ``stem_sweep.py`` finds its lines in ``fused_stem.cu``
    as many times as it expects, so the sweep times what it names."""
    with open(os.path.join(_build.CSRC_DIR, "fused_stem.cu")) as fh:
        text = fh.read()
    changed = stem_sweep.variant_source(text, variant)
    assert (changed == text) == (variant == "base")
