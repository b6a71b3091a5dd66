"""The plain reference against the port's plain path at micro sizes (CPU,
float32).  The reference is written from the equations; these tests hold it
to the port so that a disagreement on the card is the program's."""

import numpy as np
import pytest
import torch

from portbench.data import vocab, weights
from portbench.reference import clip as ref_clip
from portbench.reference.convnext import ConvNeXt
from portbench.reference.resnet import ResNet50
from portbench.reference.text import Bert, WordPiece

SEED = 2 ** 31 + 3


def test_convnext_matches_the_port_plain_tower():
    from mmgclip_tpu_torch.ingest.encode import build_encode_program
    from mmgclip_tpu_torch.models.convnext import ConvNeXt as PortConvNeXt, ConvNeXtConfig
    from mmgclip_tpu_torch.weights import load_flax_tree

    depths, dims = (1, 1, 2, 1), (8, 16, 32, 64)
    tree, _ = weights.convnext_tree(depths, dims, 1, 2, 0.1).make(SEED, "cpu")
    port = PortConvNeXt(ConvNeXtConfig(depths=depths, dims=dims, in_channels=1))
    load_flax_tree(port, tree)
    pixels = np.random.default_rng(0).integers(0, 4096, size=(37, 29)).astype(np.uint16)
    got = build_encode_program(port.eval(), 1)(torch.from_numpy(pixels[None]))[0]
    want = ConvNeXt(tree, "cpu").features(pixels)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bert_and_wordpiece_match_the_port(tmp_path):
    from mmgclip_tpu_torch.data.tokenizer import Tokenizer
    from mmgclip_tpu_torch.models.bert import BertConfig, BertEncoder, eos_pool
    from mmgclip_tpu_torch.weights import load_flax_tree

    texts = ["BIRADS score of 4.", "Finding suggesting malignant.", "Mass revealed, xyz-q!"]
    path = vocab.write_vocab(str(tmp_path / "v.txt"), texts[:2], 400)
    ours = WordPiece(path)(texts, 16)
    theirs = Tokenizer.from_pretrained(path, sequence_length=16)(texts, max_length=16)
    assert np.array_equal(ours["input_ids"], theirs["input_ids"])
    assert np.array_equal(ours["attention_mask"], theirs["attention_mask"])
    cfg = dict(vocab_size=400, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)
    tree, _ = weights.bert_tree(**cfg).make(SEED, "cpu")
    port = BertEncoder(BertConfig(**cfg))
    load_flax_tree(port, tree)
    ids, mask = (torch.as_tensor(ours[k]) for k in ("input_ids", "attention_mask"))
    with torch.no_grad():
        got = eos_pool(port(ids, attention_mask=mask), mask)
    assert torch.allclose(got, Bert(tree, "cpu").pooled(ours["input_ids"], ours["attention_mask"]),
                          rtol=1e-4, atol=1e-5)


def test_resnet_matches_the_port_tower():
    from mmgclip_tpu_torch.models.resnet import ResNet50Encoder, ResNetConfig
    from mmgclip_tpu_torch.weights import load_flax_tree

    tree, _ = weights.resnet_tree((1, 1, 1, 1), 8).make(SEED, "cpu")
    port = ResNet50Encoder(ResNetConfig.micro())
    load_flax_tree(port, tree)
    feats = torch.randn(3, 40, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port(feats)
    assert torch.allclose(got, ResNet50(tree, "cpu", (1, 1, 1, 1))(feats), rtol=1e-4, atol=1e-5)


def test_adamw_and_loss_match_the_port():
    from mmgclip_tpu_torch.losses.losses import clip_loss
    from mmgclip_tpu_torch.training.optim import AdamW as PortAdamW

    gen = torch.Generator().manual_seed(2)
    p0 = torch.randn(5, 3, generator=gen)
    grads = [torch.randn(5, 3, generator=gen) for _ in range(3)]
    port_p = torch.nn.Parameter(p0.clone())
    port = PortAdamW({"w": port_p}, 5e-5, 1e-4)
    ours_p = p0.clone()
    ours = ref_clip.AdamW({"w": ours_p}, 5e-5, 1e-4)
    for g in grads:
        port_p.grad = g.clone()
        port.step()
        ours.step({"w": g})
    assert torch.allclose(port_p.detach(), ours_p, rtol=0, atol=1e-7)
    img, txt = ref_clip.l2n(torch.randn(6, 4, generator=gen)), ref_clip.l2n(torch.randn(6, 4, generator=gen))
    scale = torch.tensor(2.6)
    logits = torch.exp(scale) * img @ txt.T
    want = clip_loss(logits_per_image=logits, logits_per_text=logits.T)[0]
    assert ref_clip.clip_loss(img, txt, scale) == pytest.approx(float(want), rel=1e-6)
