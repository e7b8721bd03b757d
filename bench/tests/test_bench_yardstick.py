"""The FLOP, byte and live-pair counts against hand counts at small
shapes."""

import math

import pytest

import dims
import harness
import weights
import yardstick
from conftest import TINY

SMALL = dict(TINY, hidden_size=64, intermediate_size=128, num_hidden_layers=2, vocab_size=251)
D = harness.sized(dims.from_json("tiny", SMALL))  # 4 heads of 16 over 2


def test_live_pairs_by_hand():
    assert yardstick.live_pairs(4, 4, True, None) == 1 + 2 + 3 + 4
    assert yardstick.live_pairs(4, 4, False, None) == 16
    assert yardstick.live_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert yardstick.live_pairs(2, 6, True, None, q_offset=4) == 5 + 6
    for S in (1, 7, 64):
        assert yardstick.causal_pairs(S) == yardstick.live_pairs(S, S, True, None)


def test_flash_bound_by_hand():
    B, S, H, KV, hd = 1, 4, 2, 1, 16
    pairs = 2 * 10
    t_bytes = (2 * 4 * 2 * 16 + 2 * 4 * 1 * 16) * 2 / 3.35e12
    t_ops = 4 * 16 * pairs / 989e12
    t_exp = pairs / (16 * 132 * 1830e6)
    assert yardstick.flash_bound_s(B, S, S, H, KV, hd) == pytest.approx(max(t_bytes, t_ops, t_exp))
    # yi-6b's 4 x 2048 prefill call, PR 16's bound: 0.139 ms, operations
    assert yardstick.flash_bound_s(4, 2048, 2048, 32, 4, 128) * 1e3 == pytest.approx(0.13904, rel=1e-3)


@pytest.mark.parametrize("tied", [False, True])
def test_parameter_counts_by_hand(tied):
    d = harness.sized(dims.from_json("tiny", dict(SMALL, tie_word_embeddings=tied)))
    per_layer = 64 * (4 + 2 * 2) * 16 + 4 * 16 * 64 + 3 * 64 * 128
    assert yardstick.layer_matmul_params(d) == per_layer
    assert yardstick.head_params(d) == 64 * 251  # tied or not, the head's product is model work
    # the leaves the weights module makes: the products, the padded table(s), the norms
    n = sum(math.prod(s) for _, s, _ in weights.leaf_specs(d))
    assert n == 2 * per_layer + (1 if tied else 2) * 512 * 64 + (2 * 2 + 1) * 64


def test_step_flops_and_bytes_by_hand():
    B, S = 2, 8
    n = 2 * yardstick.layer_matmul_params(D) + 64 * 251
    attn = 4 * 16 * 4 * B * (8 * 9 // 2) * 2
    assert yardstick.attention_fwd_flops(D, B, S) == attn
    assert yardstick.train_step_flops(D, B, S) == 6 * n * B * S + 3 * attn
    assert yardstick.prefill_flops(D, B, S) == (2 * 2 * yardstick.layer_matmul_params(D) * B * S
                                               + 2 * 64 * 251 * B + attn)
    kv_row = 2 * 2 * 16 * 2 * 2  # K and V, 2 heads of 16, bf16, 2 layers
    assert yardstick.decode_step_bytes(D, B, 10) == n * 2 + B * 64 * 2 + 5 * 64 * 4 + B * 10 * kv_row + B * kv_row


def test_train_flops_of_the_cell():
    """granite-3-2b at 4 x 2048: 2.53e9 product weights, 1.33e14 a step."""

    import harness

    d = harness.load_cell("granite-3-2b.train-4x2048").dims
    n = d.num_layers * yardstick.layer_matmul_params(d) + yardstick.head_params(d)
    assert n == pytest.approx(2.533e9, rel=1e-3)
    assert yardstick.train_step_flops(d, 4, 2048) == pytest.approx(1.327e14, rel=1e-3)
