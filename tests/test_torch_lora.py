"""The port's LoRA adapters against the JAX package's (CPU, fp32): the same
A/B factors, carried across as numpy, give the same merged weights; an
adapter directory written by either package loads in the other, in the native
format and in the torch-peft layout; ``Dia.load_adapter_weights`` fuses and
``unload_adapter`` restores.  Tolerance 1e-6: one fp32 ``A @ B`` per kernel
in each package, summed in another order.
"""

import jax
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import lora as jlora
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models.dia import init_params
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import lora as tlora
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax, params_to_numpy
from dia_tts_prune_tpu_torch.ops import quant
from dia_tts_prune_tpu_torch.train import _flatten

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

TARGETS = ("q_proj", "v_proj", "o_proj", "wi_fused", "logits_dense")


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_test_config()
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    j_adapter = jlora.init_lora(jparams, jlora.LoraConfig(r=4, alpha=8.0, target_modules=TARGETS),
                                jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)  # B starts at zero: give it values
    j_adapter["weights"] = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        j_adapter["weights"])
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    t_adapter = {"config": dict(j_adapter["config"]),
                 "weights": params_from_jax(j_adapter["weights"], device="cpu")}
    return jparams, j_adapter, tparams, t_adapter


def _assert_trees_close(t_tree, j_tree, atol=1e-6):
    t_flat = _flatten(params_to_numpy(t_tree))
    j_flat = _flatten(jax.tree.map(np.asarray, j_tree))
    assert list(t_flat) == list(j_flat)
    for name in t_flat:
        np.testing.assert_allclose(t_flat[name], j_flat[name], rtol=0, atol=atol, err_msg=name)


def test_init_lora_structure_and_zero_delta(setup):
    jparams, _, tparams, _ = setup
    cfg = tlora.LoraConfig(r=4, alpha=8.0, target_modules=TARGETS)
    t = tlora.init_lora(tparams, cfg, torch.Generator().manual_seed(0))
    j = jlora.init_lora(jparams, jlora.LoraConfig(r=4, alpha=8.0, target_modules=TARGETS),
                        jax.random.PRNGKey(0))
    assert t["config"] == j["config"]
    t_flat, j_flat = _flatten(t["weights"]), _flatten(jax.tree.map(np.asarray, j["weights"]))
    assert {n: tuple(v.shape) for n, v in t_flat.items()} == {
        n: v.shape for n, v in j_flat.items()}
    assert all(float(v.abs().max()) == 0 for n, v in t_flat.items() if n.endswith(".b"))
    assert tlora.lora_param_count(t) == jlora.lora_param_count(j)
    _assert_trees_close(tlora.merge_lora(tparams, t), jparams, atol=0)  # B = 0: no change
    again = tlora.init_lora(tparams, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(t_flat.values(),
                                                 _flatten(again["weights"]).values()))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_merge_lora_matches_jax(setup, sign):
    jparams, j_adapter, tparams, t_adapter = setup
    _assert_trees_close(tlora.merge_lora(tparams, t_adapter, sign=sign),
                        jlora.merge_lora(jparams, j_adapter, sign=sign))


def test_merge_then_unmerge_restores_the_weights(setup):
    _, _, tparams, t_adapter = setup
    back = tlora.merge_lora(tlora.merge_lora(tparams, t_adapter), t_adapter, sign=-1.0)
    _assert_trees_close(back, params_to_numpy(tparams), atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("fmt", ["native", "peft"])
def test_adapter_saved_by_one_package_loads_in_the_other(setup, tmp_path, writer, fmt):
    _, j_adapter, _, t_adapter = setup
    # peft has no key for the unstacked logits head in the JAX exporter's layout either
    save = {("jax", "native"): lambda p: jlora.save_adapter(p, j_adapter),
            ("jax", "peft"): lambda p: jlora.save_peft_adapter(p, j_adapter),
            ("torch", "native"): lambda p: tlora.save_adapter(p, t_adapter),
            ("torch", "peft"): lambda p: tlora.save_peft_adapter(p, t_adapter)}[writer, fmt]
    save(tmp_path / "adapter")
    t_loaded = tlora.load_adapter(tmp_path / "adapter")
    j_loaded = jlora.load_adapter(tmp_path / "adapter")
    _assert_trees_close(t_loaded["weights"], j_loaded["weights"], atol=0)
    _assert_trees_close(t_loaded["weights"], j_adapter["weights"], atol=0)
    assert t_loaded["config"]["r"] == 4 and t_loaded["config"]["alpha"] == 8.0
    assert sorted(t_loaded["config"]["target_modules"]) == sorted(TARGETS)


def test_peft_bin_directory_loads(setup, tmp_path):
    """``adapter_model.bin`` (torch.save of the peft keys) instead of safetensors."""
    from safetensors.numpy import load_file

    _, _, _, t_adapter = setup
    tlora.save_peft_adapter(tmp_path / "st", t_adapter)
    tensors = load_file(str(tmp_path / "st" / "adapter_model.safetensors"))
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "adapter_config.json").write_text(
        (tmp_path / "st" / "adapter_config.json").read_text())
    torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
               tmp_path / "bin" / "adapter_model.bin")
    loaded = tlora.load_adapter(tmp_path / "bin")
    _assert_trees_close(loaded["weights"], params_to_numpy(t_adapter["weights"]), atol=0)
    _assert_trees_close(loaded["weights"], jlora.load_adapter(tmp_path / "bin")["weights"],
                        atol=0)


def test_dia_adapter_api(setup, tmp_path):
    _, j_adapter, tparams, t_adapter = setup
    jlora.save_adapter(tmp_path / "one", j_adapter)  # written by the JAX package
    other = {"config": t_adapter["config"],
             "weights": jax.tree.map(lambda w: -0.5 * w, t_adapter["weights"])}
    tlora.save_adapter(tmp_path / "two", other)
    dia = Dia(tcfg.tiny_test_config(), tparams, device="cpu")
    dia.load_adapter_weights(tmp_path / "one")
    _assert_trees_close(dia.params, params_to_numpy(tlora.merge_lora(tparams, t_adapter)))
    assert dia.generator.params is dia.params
    dia.set_adapter(tmp_path / "two")  # unloads the first, fuses the second
    _assert_trees_close(dia.params, params_to_numpy(tlora.merge_lora(tparams, other)), atol=2e-6)
    dia.unload_adapter()
    _assert_trees_close(dia.params, params_to_numpy(tparams), atol=2e-6)
    with pytest.raises(NotImplementedError):
        dia.load_adapter_weights(tmp_path / "one", fuse=False)


def test_adapter_into_a_packed_model_raises(setup, tmp_path):
    """The JAX package fails here too (its merge adds an array to a packed
    kernel); the port says why."""
    _, _, tparams, t_adapter = setup
    tlora.save_adapter(tmp_path / "a", t_adapter)
    dia = Dia(tcfg.tiny_test_config(), tparams, device="cpu")
    dia.quantize_int8()
    with pytest.raises(TypeError, match="packed kernel"):
        dia.load_adapter_weights(tmp_path / "a")
    assert isinstance(dia.params["decoder"]["layers"]["mlp"]["wo"]["kernel"],
                      quant.QuantizedKernel)
