"""The port's ConvNeXt knobs and masked (``valid_hw``) tower against the JAX
package's, on carried-across parameters.

Every knob combination of the encode presets (fused blocks, int8, fused stem
and downsample, the standalone depthwise kernel) runs on the same micro-tower
parameters and inputs in both packages, exact-shape and masked, with the JAX
Pallas kernels in interpret mode (``FORCE_INTERPRET``); on the CPU the port
runs each kernel's plain version.  Tolerances: fp32 1e-4 relative to the
largest feature (``test_torch_models.py``); int8 the bounds of
``tests/test_quant.py`` (cosine > 0.99, relative error < 0.2), because the
two packages partition the int8 activation scales differently.  Bucketed
features must equal exact-shape features to relative L2 < 1e-5, as
``tests/test_bucket_rounding.py`` holds the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgclip_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from mmgclip_tpu.models.convnext import ConvNeXtConfig as JaxConvNeXtConfig
from mmgclip_tpu.models.convnext import init_convnext
from mmgclip_tpu.ops import fused_block as jax_fb
from mmgclip_tpu.ops import fused_downsample as jax_fd
from mmgclip_tpu_torch.config import Config
from mmgclip_tpu_torch.ingest.encode import _Encoder
from mmgclip_tpu_torch.models.convnext import ConvNeXt, ConvNeXtConfig
from mmgclip_tpu_torch.ops import launch_counts
from mmgclip_tpu_torch.weights import load_flax_tree

KNOBS = {
    "plain": {},
    "fused": {"use_fused_blocks": True},
    "fused_glue": {"use_fused_blocks": True, "fuse_stem": True, "fuse_downsample": True},
    "fused_glue_tanh": {"use_fused_blocks": True, "fuse_stem": True, "fuse_downsample": True,
                        "gelu": "tanh"},
    "fused_int8_glue": {"use_fused_blocks": True, "quant": "int8", "fuse_stem": True,
                        "fuse_downsample": True},
    "unfused_int8": {"quant": "int8"},
    "pallas_dwconv": {"use_pallas_dwconv": True},
    "glue_without_fused_blocks": {"fuse_stem": True, "fuse_downsample": True},
}
SIZES = [(100, 120), (70, 90), (130, 158), (33, 47), (255, 129)]


@pytest.fixture(scope="module")
def micro_params():
    cfg = dataclasses.replace(JaxConvNeXtConfig.micro(), layer_scale_init=0.5, in_channels=1)
    _module, params = init_convnext(cfg, seed=11, image_size=32)
    return cfg, jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_tower(jcfg, params, **knobs):
    port = ConvNeXt(ConvNeXtConfig(depths=jcfg.depths, dims=jcfg.dims, in_channels=1,
                                   **knobs)).eval()
    load_flax_tree(port, params["params"])
    return port


def features_close(out, ref, int8):
    if int8:
        cos = (out * ref).sum(1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
        assert cos.min() > 0.99, cos
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.2
    else:
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knobs_match_jax_exact_and_masked(monkeypatch, micro_params, name):
    jcfg, params = micro_params
    knobs = KNOBS[name]
    monkeypatch.setattr(jax_fb, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_fd, "FORCE_INTERPRET", True)
    jmodule = JaxConvNeXt(dataclasses.replace(jcfg, **knobs))
    port = port_tower(jcfg, params, **knobs)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, size=(2, 37, 29, 1)).astype(np.float32)
    canvas = np.zeros((2, 48, 40, 1), np.float32)
    canvas[0, :37, :29] = x[0]
    canvas[1, :30, :40] = rng.uniform(-1, 1, size=(30, 40, 1))
    valid = np.asarray([[37, 29], [30, 40]], np.int32)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
        masked = port(torch.from_numpy(canvas), valid_hw=torch.from_numpy(valid)).numpy()
    ref = np.asarray(jax.jit(jmodule.apply)(params, jnp.asarray(x)))
    ref_masked = np.asarray(jax.jit(lambda p, a, v: jmodule.apply(p, a, valid_hw=v))(
        params, jnp.asarray(canvas), jnp.asarray(valid)))
    int8 = knobs.get("quant") == "int8"
    features_close(out, ref, int8)
    features_close(masked, ref_masked, int8)


@pytest.mark.parametrize("name", ["plain", "fused_glue", "fused_int8_glue", "pallas_dwconv"])
def test_masked_tower_equals_exact_shape_runs(micro_params, name):
    """Each image on a shared canvas encodes as its own exact-shape run.  The
    int8 scales are per pixel, so the int8 tower holds this bound too."""
    jcfg, params = micro_params
    port = port_tower(jcfg, params, **KNOBS[name])
    rng = np.random.default_rng(13)
    sizes = [(40, 33), (29, 40), (17, 21)]
    canvas = np.zeros((3, 40, 40, 1), np.float32)
    exact = []
    with torch.no_grad():
        for i, (h, w) in enumerate(sizes):
            img = rng.uniform(-1, 1, size=(1, h, w, 1)).astype(np.float32)
            canvas[i, :h, :w] = img[0]
            exact.append(port(torch.from_numpy(img)).numpy())
        got = port(torch.from_numpy(canvas), valid_hw=torch.tensor(sizes)).numpy()
    exact = np.concatenate(exact)
    rel = np.linalg.norm(exact - got, axis=1) / np.linalg.norm(exact, axis=1)
    assert rel.max() < 1e-5, rel


@pytest.fixture(scope="module")
def encoder():
    cfg = Config({
        "networks": {"image_encoder": {
            "name": "ConvNextTiny", "image_features_dimension": 768,
            "convnext_tiny_clf_path": "", "config": {"micro": True, "in_channels": 1}}},
        "dataset": {"config": {}},
    })
    return _Encoder(cfg, batch_size=4, bucket_rounding=32, device="cpu")


def test_bucketed_features_equal_exact_shape_features(encoder):
    """The port's counterpart of tests/test_bucket_rounding.py."""
    exact = encoder._encode_fn()
    masked = encoder._masked_encode_fn()
    rng = np.random.default_rng(0)
    for h, w in SIZES:
        px = rng.integers(0, 256, size=(2, h, w), dtype=np.uint8)
        e = exact(torch.from_numpy(px)).numpy()
        canvas = np.zeros((2, -(-h // 32) * 32, -(-w // 32) * 32), np.uint8)
        canvas[:, :h, :w] = px
        m = masked(torch.from_numpy(canvas), torch.tensor([[h, w]] * 2, dtype=torch.int32)).numpy()
        rel = np.linalg.norm(e - m, axis=1) / np.linalg.norm(e, axis=1)
        assert rel.max() < 1e-5, f"{h}x{w}: rel_l2={rel.max():.2e}"


def test_glue_kernels_gated_as_in_jax(micro_params):
    """fuse_* route through the glue ops only with use_fused_blocks, and the
    fused downsample only on unmasked runs: on the CPU both routes run the
    same plain math, so the test reads which functions ran."""
    jcfg, params = micro_params
    calls = []
    import mmgclip_tpu_torch.models.convnext as cn

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    x = torch.zeros(1, 16, 16, 1)
    for knobs, valid, expected in (
            (KNOBS["fused_glue"], None, ["stem", "down", "down", "down"]),
            (KNOBS["fused_glue"], torch.tensor([[16, 16]]), ["stem"]),
            (KNOBS["glue_without_fused_blocks"], None, [])):
        calls.clear()
        port = port_tower(jcfg, params, **knobs)
        orig = cn.fused_stem, cn.fused_ln_downsample
        cn.fused_stem, cn.fused_ln_downsample = spy("stem", orig[0]), spy("down", orig[1])
        try:
            with torch.no_grad():
                port(x, valid_hw=valid)
        finally:
            cn.fused_stem, cn.fused_ln_downsample = orig
        assert calls == expected, (knobs, valid, calls)
    assert set(launch_counts()) >= {"fused_stem", "fused_ln_downsample", "depthwise_conv7x7",
                                    "fused_convnext_block_int8"}
