"""The traffic draws repeat exactly for a seed and differ across seeds."""

import numpy as np
import pytest
import torch

import traffic

BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits
MIX = {"lengths": [2048, 2560, 3072, 3584, 4096]}


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_train_tokens_are_the_ports_stream(seed):
    """A copy of the port's synthetic stream, value for value."""

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, DataState, _batch_tokens

    cfg = get_smoke_config("granite_3_2b")
    for step in (1, 2, 9):
        ours = traffic.train_tokens(seed, step, 4, 32, cfg.vocab_size)
        theirs = _batch_tokens(DataConfig(4, 32, seed=seed), cfg, DataState(seed, step))
        np.testing.assert_array_equal(ours, theirs)


def test_train_tokens_repeat_and_differ():
    a = traffic.train_tokens(BIG, 1, 4, 64, 49155)
    np.testing.assert_array_equal(a, traffic.train_tokens(BIG, 1, 4, 64, 49155))
    assert (a != traffic.train_tokens(BIG + 1, 1, 4, 64, 49155)).mean() > 0.9
    assert (a != traffic.train_tokens(BIG, 2, 4, 64, 49155)).mean() > 0.9
    assert len({r.tobytes() for r in a}) == 4  # every row of a step differs
    assert a.min() >= 0 and a.max() < 49155


def test_prefill_lengths_same_sizes_for_every_seed():
    a = traffic.prefill_lengths(MIX, BIG, 50)
    assert a == traffic.prefill_lengths(MIX, BIG, 50)
    b = traffic.prefill_lengths(MIX, BIG + 1, 50)
    assert a != b
    for seq in (a, b):  # each block of five holds each length once
        for i in range(0, 50, 5):
            assert sorted(seq[i:i + 5]) == MIX["lengths"]


def test_prompts_repeat_and_differ():
    cpu = torch.device("cpu")
    a = traffic.prompts(BIG, 3, 2, 64, 64000, cpu)
    assert torch.equal(a, traffic.prompts(BIG, 3, 2, 64, 64000, cpu))
    assert not torch.equal(a, traffic.prompts(BIG + 1, 3, 2, 64, 64000, cpu))
    assert not torch.equal(a, traffic.prompts(BIG, 4, 2, 64, 64000, cpu))
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 64000


def test_sample_is_drawn_from_the_seed():
    assert traffic.sample(BIG, 1, 100, 4) == traffic.sample(BIG, 1, 100, 4)
    assert traffic.sample(BIG, 1, 100, 4) != traffic.sample(BIG + 1, 1, 100, 4)
    assert len(set(traffic.sample(5, 2, 10, 4))) == 4
    assert traffic.sample(5, 2, 3, 8) == [0, 1, 2]
