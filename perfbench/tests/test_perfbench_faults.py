"""A run with the timed path broken underneath it comes out not correct;
a sound run and the control behave as the limits say.  The harness runs
whole at the tiny sizes on the CPU, past its look for a card."""

import time

import pytest
import torch

from perfbench.harness import session
from perfbench.tests.faults import FAILS, FAULTS
from perfbench.tests.tiny import tiny_config, tiny_mix

SEED = 2**31 + 4242


def _run(lm="int8", control=()):
    opts = session.Options(device="cpu", lm_dtype=torch.float32, control=control)
    return session.run(tiny_config(lm), tiny_mix(), SEED, 2.5, False, opts,
                       time.perf_counter())["verdict"]


def test_a_sound_run_is_correct():
    v = _run()
    assert v["correct"], v
    assert v["numbers"]["greedy_tokens"] > 0 and v["numbers"]["codec_samples"] > 0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    v = _run()
    assert not v["correct"], v
    assert v["numbers"][FAILS[fault]] > v["limits"][FAILS[fault]], v


def test_the_lm_control_fails_its_number():
    """The int8 configuration served by the int4 path."""
    sound, ctl = _run(), _run(control=("lm",))
    assert sound["numbers"]["lm_gap"] <= sound["limits"]["lm_gap"]
    assert ctl["numbers"]["lm_gap"] > ctl["limits"]["lm_gap"], ctl


@pytest.mark.cuda
def test_the_codec_control_fails_its_number():
    """The reference's TF32 rendering in the served audio's place: TF32 is
    a card's, so this runs on one (at the tiny sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA card")
    opts = session.Options(device="cuda", lm_dtype=torch.float32, control=("codec",))
    v = session.run(tiny_config("int8"), tiny_mix(), SEED, 2.5, False, opts,
                    time.perf_counter())["verdict"]
    assert v["numbers"]["wave_err"] > v["limits"]["wave_err"], v
