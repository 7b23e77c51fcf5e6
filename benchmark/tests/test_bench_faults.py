"""A run of each cell, with the chip's look skipped (the CPU and the tiny
widths), sees ``correct`` come out true on the sound program and false with
the timed path broken underneath, once for each fault a served model can
have: a token altered where it is sampled, the decode step leaving its
cache state unchanged, the codec's output altered.  And the control (the
program's own path one precision step below the configuration's) comes out
not correct under the configuration's own limits: the bf16 configuration's
mean gap, the int8 one's widest gap."""

import time

import pytest

import control
import harness

CELLS = ["bf16-solo", "int8-fused-solo"]


def run(tiny, cell, seed=3, seconds=2):
    spec, traffic = tiny
    result, shown = harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                                spec_path=spec, traffic_dir=traffic, log=lambda m: None)
    return result, shown


def alter_token(monkeypatch):
    import dia_tts_prune_tpu_torch.generate as gen

    inner = gen.sample_streams

    def sample_streams(*args, **kwargs):
        pred = inner(*args, **kwargs)
        pred[:, 3] = (pred[:, 3] + 1) % 1024
        return pred

    monkeypatch.setattr(gen, "sample_streams", sample_streams)


def keep_cache(monkeypatch):
    import dia_tts_prune_tpu_torch.models.dia as dia

    monkeypatch.setattr(dia, "_commit", lambda *a, **k: None)


def alter_audio(monkeypatch):
    import dia_tts_prune_tpu_torch.api as api

    inner = api.decode_codes
    monkeypatch.setattr(api, "decode_codes", lambda *a, **k: inner(*a, **k) * 0.999)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result, shown = run(tiny, cell)
    assert result["correct"], shown
    assert list(result)[-1] == "check" and result["failed"] == 0


@pytest.mark.parametrize("fault", [alter_token, keep_cache, alter_audio],
                         ids=["token_altered", "state_unchanged", "audio_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    fault(monkeypatch)
    result, shown = run(tiny, cell)
    assert not result["correct"], shown


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_under_the_configurations_limits(tiny, cell):
    spec, traffic = tiny
    check = harness.load_cell(cell, spec, traffic).config["check"]
    sound = control.readings(cell, 5, 2, False, "cpu", spec, traffic)
    ctrl = control.readings(cell, 5, 2, True, "cpu", spec, traffic)
    assert sound["correct"] and not ctrl["correct"], (sound, ctrl)
    for name in check:
        if name != "wave_diff":
            assert ctrl[name] > check[name] > sound[name], name
