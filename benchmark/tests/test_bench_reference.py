"""The plain reference against the program's plain path at the tiny widths
on the CPU.  Only this file imports both.

Tolerances: float32 on both sides, the same weights, so a served greedy
token's guided logit lies at most float32 rounding below the reference's
best (the program's eager CPU loop and the reference's whole-sequence pass
add in other orders): 1e-3 on logits of order 10.  The int8 route: the same
packing and cache rounding on both sides, so the same bound.  The codec:
1e-5 absolute on a tanh output."""

import json

import numpy as np
import pytest
import torch

import correctness
import harness
import traffic
import weights
from conftest import FIXTURES
from dia_tts_prune_tpu_torch.models.dac import decode_codes
from dia_tts_prune_tpu_torch.ops.delay import apply_audio_delay_np, revert_audio_delay_np
from dia_tts_prune_tpu_torch.ops.quant import dequantize, quantize_int8
from dia_tts_prune_tpu_torch.state import prepare_audio_prompt
from dia_tts_prune_tpu_torch.tokenizer import build_effective_text, encode_cfg_batch
from reference import dac as ref_dac
from reference import dia as ref_dia
from reference import text as ref_text

TOL_LOGIT = 1e-3


def cfg(name):
    return json.loads((FIXTURES / "configs" / f"{name}.json").read_text())


def greedy_gaps(config, route, seed, texts, kv_int8, max_tokens=90):
    dia = harness.build_dia(config, seed, torch.device("cpu"), route)
    W = ref_dia.float_weights(weights.dia_weights(config["dia"], seed, torch.float32, "cpu"),
                              config["reference"]["weights"])
    out = []
    for text in texts:
        codes = dia.generate_codes(text, max_tokens=max_tokens, temperature=0.0)
        out.append(correctness.token_gaps(W, config["dia"], text, codes, 3.0, kv_int8, "cpu"))
    return out


TEXTS = ["[S1] Hello there my friend. [S2] Hi, how are you today?",
         "[S2] One two three four five six seven eight. [S1] Nine ten eleven twelve thirteen "
         "fourteen fifteen sixteen seventeen eighteen nineteen twenty. [S2] Done."]


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_float_route_serves_the_reference_choice(seed):
    c = cfg("dia-1.6b-bf16")
    for g in greedy_gaps(c, c["route"], seed, TEXTS, False):
        assert g.size > 0 and g.max() <= TOL_LOGIT


def test_int8_route_serves_the_reference_choice():
    c = cfg("dia-1.6b-int8-fused")
    route = dict(c["route"], fused=False)  # the packed tree the batcher's lanes run
    for g in greedy_gaps(c, route, 4, TEXTS, True):
        assert g.size > 0 and g.max() <= TOL_LOGIT


def test_a_wrong_token_reads_a_gap():
    c = cfg("dia-1.6b-bf16")
    dia = harness.build_dia(c, 1, torch.device("cpu"))
    codes = dia.generate_codes(TEXTS[0], max_tokens=80, temperature=0.0)
    W = ref_dia.float_weights(weights.dia_weights(c["dia"], 1, torch.float32, "cpu"), "bf16")
    bad = codes.copy()
    bad[40, 3] = (bad[40, 3] + 1) % 1024
    g = correctness.token_gaps(W, c["dia"], TEXTS[0], bad, 3.0, False, "cpu")
    assert g.max() > 10 * TOL_LOGIT


def test_int8_packing_is_the_program_s():
    w = torch.randn(3, 64, 4, 16)
    for n_in, x in ((1, w[0].reshape(64, 64)), (2, w[1])):
        ours = ref_dia.int8_columns(x, n_in)
        theirs = dequantize(quantize_int8(x, n_in=n_in)).reshape(x.shape)
        assert torch.equal(ours, theirs)


def test_codec_is_the_program_s():
    c = cfg("dia-1.6b-bf16")
    params = weights.dac_weights(c["dac"], 3, "cpu")
    codes = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (70, 9)))
    ours = ref_dac.decode(params, c["dac"], codes)
    theirs = decode_codes(params, harness.build_dia(c, 3, torch.device("cpu")).dac_config,
                          codes[None])[0]
    assert ours.shape == theirs.shape
    assert (ours - theirs).abs().max().item() <= 1e-5


def test_text_and_rows_are_the_program_s():
    data = cfg("dia-1.6b-bf16")["dia"]["data"]
    mix = json.loads((FIXTURES / "traffic" / "solo.json").read_text())
    reqs = traffic.requests(mix, 17)
    for _ in range(6):
        text = next(reqs).text
        row = encode_cfg_batch(build_effective_text(text), data["text_length"])[1]
        ids = ref_text.text_ids(text, data["text_length"])
        assert np.array_equal(row[: len(ids)], ids) and not row[len(ids):].any()
    delayed, _ = prepare_audio_prompt_template(data)
    assert np.array_equal(ref_text.template(data), delayed[:15])
    # rows from codes: the program's own delay of the loop's rows, reverted and re-applied
    rng = np.random.default_rng(1)
    T = 60
    gen = rng.integers(0, 1024, (T, 9))  # delayed rows 1..T as the loop wrote them
    rows = np.concatenate([ref_text.template(data), gen[14:]])  # rows 0..T
    reverted = revert_audio_delay_np(rows[None, 1:], 1025, tuple(data["delay_pattern"]), T)[0]
    codes = reverted[: T - 15]
    got, missing = ref_text.input_rows(codes, data)
    assert missing == [(15, 8)]
    for r in range(got.shape[0]):
        for ch in range(9):
            if (r, ch) not in missing:
                assert got[r, ch] == rows[r, ch], (r, ch)
    r, ch, tok = ref_text.served_positions(codes, data)
    assert all(rows[a, b] == t for a, b, t in zip(r, ch, tok))
    assert apply_audio_delay_np is not None


def prepare_audio_prompt_template(data):
    from dia_tts_prune_tpu_torch.config import DiaConfig

    c = cfg("dia-1.6b-bf16")["dia"]
    return prepare_audio_prompt(DiaConfig.model_validate(c), None)
