"""The port's pruning tools against the JAX package's, on the CPU.

* Masks, element for element, and the pruned weights and sparsity reports
  they give, for every mode: global unstructured, per-layer structured along
  every dimension with the L1 and L2 norms, block masks with both rankings
  and block sizes that do and do not divide the kernels.
* ``shrink_heads`` / ``shrink_ffn``: the new weights and configs equal, and
  greedy tokens of the shrunk trained fixture equal the JAX package's (the
  attention kernels' plain versions at the new head counts: one KV head with
  a group of two).
* The ``offline_prune`` CLI in all five modes writes the JAX CLI's files —
  the same tensors, config and report — and the result generates the JAX
  package's tokens; ``finetune --prune-before`` starts training from the
  weights the JAX CLI prunes to.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import prune as jprune
from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import prune as tprune
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_test_config()
    jp = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_trees_equal(out, ref):
    """Same structure; every leaf equal exactly (``None`` beside ``None``)."""
    assert set(out) == set(ref)
    n = 0
    for k in ref:
        if isinstance(ref[k], dict):
            n += _assert_trees_equal(out[k], ref[k])
        elif ref[k] is None:
            assert out[k] is None, k
        else:
            a, b = out[k].numpy(), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)
            n += 1
    return n


def _check_masks(jp, tp, ref_masks, masks):
    assert _assert_trees_equal(masks, ref_masks) == 17  # every dense kernel of the tiny model
    ref_pruned, pruned = jprune.apply_masks(jp, ref_masks), tprune.apply_masks(tp, masks)
    _assert_trees_equal(pruned, ref_pruned)
    assert tprune.sparsity_report(pruned) == jprune.sparsity_report(ref_pruned)


@pytest.mark.parametrize("amount", [0.0, 0.3, 0.6])
def test_unstructured_masks_match_jax(tiny, amount):
    jp, tp = tiny
    _check_masks(jp, tp, jprune.unstructured_masks(jp, amount),
                 tprune.unstructured_masks(tp, amount))


@pytest.mark.parametrize("dim", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2])
def test_structured_masks_match_jax(tiny, dim, n):
    """Dimension 3 exists only in the 3-axis kernels (q/k/v, o_proj, the
    fused MLP input); the others are kept whole, as in the reference."""
    jp, tp = tiny
    _check_masks(jp, tp, jprune.structured_masks(jp, 0.4, dim, n),
                 tprune.structured_masks(tp, 0.4, dim, n))


@pytest.mark.parametrize("scope", ["global", "module"])
@pytest.mark.parametrize("block", [(32, 64), (8, 16), (24, 40)])
def test_block_masks_match_jax(tiny, scope, block):
    """(24, 40) divides none of the tiny model's 64-wide kernels: ragged
    blocks at both edges."""
    jp, tp = tiny
    _check_masks(jp, tp, jprune.block_masks(jp, 0.5, block, scope),
                 tprune.block_masks(tp, 0.5, block, scope))


def test_amount_checks(tiny):
    _, tp = tiny
    for fn in (tprune.unstructured_masks, tprune.block_masks):
        with pytest.raises(ValueError, match="amount"):
            fn(tp, 1.0)
    with pytest.raises(ValueError, match="keep_fraction"):
        tprune.shrink_ffn(tp, tcfg.tiny_test_config(), 0.0)


@pytest.mark.parametrize("name", ["shrink_heads", "shrink_ffn"])
def test_shrink_matches_jax_and_generates_its_tokens(name):
    jd = JaxDia.from_pretrained(str(SMALL))
    dia = Dia.from_pretrained(SMALL, device="cpu")
    ref_params, ref_cfg = getattr(jprune, name)(jd.params, jd.config, 0.5)
    params, cfg = getattr(tprune, name)(dia.params, dia.config, 0.5)
    assert cfg.model_dump() == ref_cfg.model_dump()
    _assert_trees_equal(params, ref_params)
    dec = cfg.model.decoder
    if name == "shrink_heads":
        assert (dec.kv_heads, dec.gqa_query_heads, dec.cross_query_heads) == (1, 2, 2)
    else:
        assert (cfg.model.encoder.n_hidden, dec.n_hidden) == (256, 512)
    kw = dict(max_tokens=64, temperature=0.0)
    text = "[S1] The birch canoe slid. [S2]"
    ref = np.asarray(JaxDia(ref_cfg, ref_params).generate_codes(text, **kw))
    out = Dia(cfg, params, device="cpu").generate_codes(text, **kw)
    assert out.shape[0] > 0
    np.testing.assert_array_equal(out, ref)


CLI_MODES = [("unstructured", []), ("structured", ["--prune-dim", "1", "--prune-norm", "1"]),
             ("block", ["--block-size", "32", "64"]), ("shrink-ffn", []), ("shrink-heads", [])]


@pytest.mark.parametrize("mode,extra", CLI_MODES, ids=[m for m, _ in CLI_MODES])
def test_offline_prune_cli_matches_jax(tmp_path, mode, extra):
    from dia_tts_prune_tpu.offline_prune import main as jax_main
    from dia_tts_prune_tpu_torch.offline_prune import main

    args = ["--model-path", str(SMALL), "--prune-mode", mode, "--prune-amount", "0.5", *extra]
    assert jax_main([*args, "--output-dir", str(tmp_path / "jax")]) == 0
    assert main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for name in ("config.json", "prune_report.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == json.loads(
            (tmp_path / "jax" / name).read_text()), name
    ref, out = (torch.load(tmp_path / d / "pytorch_model.bin", weights_only=True)
                for d in ("jax", "port"))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k
    report = json.loads((tmp_path / "port" / "prune_report.json").read_text())
    assert report["sparsity"] > 0.2 if mode in ("unstructured", "structured", "block") else True

    kw = dict(max_tokens=48, temperature=0.0)
    text = "[S1] Pruned offline. [S2]"
    ref_codes = np.asarray(JaxDia.from_pretrained(str(tmp_path / "jax")).generate_codes(text, **kw))
    dia = Dia.from_pretrained(tmp_path / "port", device="cpu")
    np.testing.assert_array_equal(dia.generate_codes(text, **kw), ref_codes)
    if mode == "block":  # its zero blocks serve sparse, with the same tokens
        assert min(dia.sparsify_block((32, 64)).values()) < 1.0
        np.testing.assert_array_equal(dia.generate_codes(text, **kw), ref_codes)


def test_offline_prune_safetensors_and_argument_checks(tmp_path):
    from dia_tts_prune_tpu_torch.offline_prune import main

    out = tmp_path / "st"
    assert main(["--model-path", str(SMALL), "--output-dir", str(out), "--prune-mode",
                 "unstructured", "--prune-amount", "0.3", "--save-format", "safetensors",
                 "--device", "cpu"]) == 0
    assert {p.name for p in out.iterdir()} == {"config.json", "prune_report.json",
                                               "model.safetensors"}
    assert Dia.from_pretrained(out, device="cpu").generate_codes(
        "[S1] Hi.", max_tokens=20, temperature=0.0).shape[1] == 9
    with pytest.raises(SystemExit):
        main(["--model-path", str(SMALL), "--output-dir", str(out), "--prune-mode", "block",
              "--prune-amount", "1.0"])


@pytest.mark.parametrize("kind,extra", [("unstructured", []),
                                        ("structured", ["--prune-dim", "1"])])
def test_finetune_prune_before_matches_jax(tmp_path, monkeypatch, kind, extra):
    """The weights the trainer starts from are the JAX CLI's pruned weights
    (its finetune.py:119-128 calls, on the same checkpoint), and one step
    runs."""
    import dia_tts_prune_tpu_torch.train as ttrain
    from dia_tts_prune_tpu_torch.api import write_wav
    from dia_tts_prune_tpu_torch.finetune import main

    data = tmp_path / "data"
    (data / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(9)
    for i in range(2):
        write_wav(data / "wavs" / f"a{i}.wav", (0.3 * rng.normal(size=6000)).astype(np.float32))
    (data / "metadata.csv").write_text("a0.wav|[S1] Hello.\na1.wav|[S2] Hi there.\n")

    started, steps = [], []

    class Recording(ttrain.Trainer):
        def __init__(self, params, *a, **kw):
            started.append(params)
            super().__init__(params, *a, **kw)

        def step(self, batch):
            steps.append(super().step(batch))
            return steps[-1]

    monkeypatch.setattr(ttrain, "Trainer", Recording)
    rc = main(["--model-path", str(SMALL), "--dataset-dir", str(data), "--output-dir",
               str(tmp_path / "out"), "--device", "cpu", "--compute-dtype", "float32",
               "--prune-before", kind, "--prune-amount", "0.4", *extra, "--save-steps", "0"])
    assert rc == 0 and len(started) == 1 and len(steps) == 1
    assert np.isfinite(steps[0]["loss"])

    jp = JaxDia.from_pretrained(str(SMALL)).params
    masks = (jprune.unstructured_masks(jp, 0.4) if kind == "unstructured"
             else jprune.structured_masks(jp, 0.4, dim=1))
    _assert_trees_equal(started[0], jprune.apply_masks(jp, masks))
