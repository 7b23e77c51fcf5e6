"""The seeded weights: the program's tree layout, the init rule, one tree a seed."""

import json
import math

import torch

import weights
from dia_tts_prune_tpu_torch.config import DiaConfig, dia_1_6b_config
from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_decoder_params
from dia_tts_prune_tpu_torch.models.dia import param_shapes
from conftest import BENCH, FIXTURES


def configs():
    return [json.loads(p.read_text()) for p in sorted((BENCH / "configs").glob("*.json"))]


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def test_configs_are_the_published_model():
    want = json.loads(dia_1_6b_config().model_dump_json())
    for cfg in configs():
        assert DiaConfig.model_validate(cfg["dia"]) == dia_1_6b_config()
        assert cfg["dia"] == want
        assert cfg["dac"]["decoder_rates"] == list(DACConfig().decoder_rates)


def test_dia_shapes_match_the_program():
    for cfg in configs() + [json.loads(p.read_text())
                            for p in sorted((FIXTURES / "configs").glob("*.json"))]:
        ours = dict(leaves(weights.dia_shapes(cfg["dia"])))
        theirs = dict(leaves(param_shapes(DiaConfig.model_validate(cfg["dia"]))))
        assert list(ours) == list(theirs)
        assert all(tuple(ours[k]) == tuple(theirs[k]) for k in ours)


def test_tiny_tree_keys_shapes_dtypes():
    cfg = json.loads((FIXTURES / "configs" / "dia-1.6b-bf16.json").read_text())
    tree = weights.dia_weights(cfg["dia"], 3, torch.bfloat16, "cpu")
    want = dict(leaves(param_shapes(DiaConfig.model_validate(cfg["dia"]))))
    got = dict(leaves(tree))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k]) and t.dtype == torch.bfloat16


def test_dac_tree_matches_the_program():
    cfg = json.loads((FIXTURES / "configs" / "dia-1.6b-bf16.json").read_text())
    dac = cfg["dac"]
    dc = DACConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in dac.items()})
    theirs = dict(leaves(init_dac_decoder_params(dc, 0, "cpu")))
    ours = dict(leaves(weights.dac_weights(dac, 0, "cpu")))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype == torch.float32
    full = dict(leaves(weights.dac_decoder_shapes(configs()[0]["dac"])))
    dc = DACConfig()
    assert full[("decoder", "stem", "weight")] == (dc.decoder_dim, dc.latent_dim, 7)


def test_scales_follow_the_rule():
    """Kernels normal / sqrt(fan_in) (two axes for o_proj), embeddings x 0.02,
    norm scales ones; codec kernels / sqrt(in x k), zero biases, unit alphas."""
    cfg = json.loads((FIXTURES / "configs" / "dia-1.6b-bf16.json").read_text())
    tree = dict(leaves(weights.dia_weights(cfg["dia"], 5, torch.float32, "cpu")))
    for path, t in tree.items():
        if path[-1] == "scale":
            assert torch.equal(t, torch.ones_like(t))
            continue
        lead = 1 if "layers" in path else 0
        want = 0.02 if path[-1] == "embedding" else 1 / math.sqrt(
            math.prod(t.shape[lead:lead + (2 if "o_proj" in path else 1)]))
        assert abs(t.std().item() / want - 1) < 0.1, path
        assert abs(t.mean().item()) < 0.1 * want, path
    dac = dict(leaves(weights.dac_weights(cfg["dac"], 5, "cpu")))
    for path, t in dac.items():
        if path[-1] == "alpha":
            assert torch.equal(t, torch.ones_like(t))
        elif path[-1] == "bias":
            assert not t.any()
        elif path[-1] == "weight" and t.numel() > 400:
            fan_in = (t.shape[0] if "conv_t" in path else t.shape[1]) * t.shape[2]
            assert abs(t.std().item() * math.sqrt(fan_in) - 1) < 0.15, path


def test_one_seed_one_tree():
    cfg = json.loads((FIXTURES / "configs" / "dia-1.6b-bf16.json").read_text())
    a = dict(leaves(weights.dia_weights(cfg["dia"], 2**31 + 5, torch.bfloat16, "cpu")))
    b = dict(leaves(weights.dia_weights(cfg["dia"], 2**31 + 5, torch.bfloat16, "cpu")))
    c = dict(leaves(weights.dia_weights(cfg["dia"], 2**31 + 6, torch.bfloat16, "cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    kernels = [k for k in a if k[-1] == "kernel"]
    assert not any(torch.equal(a[k], c[k]) for k in kernels)
    d1 = dict(leaves(weights.dac_weights(cfg["dac"], 9, "cpu")))
    d2 = dict(leaves(weights.dac_weights(cfg["dac"], 9, "cpu")))
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
