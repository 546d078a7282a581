"""``cardbench/flops.py`` against counts made by hand."""
import pytest
import torch

from cardbench import flops, harness
from cardbench.tests import smoke


def cfg_of(name):
    return harness.model_config(harness.load_json(
        smoke.ROOT / "cardbench" / "configs" / f"{name}.json"))


@pytest.mark.parametrize("seq,window", [(4, 0), (8, 3), (8, 8), (9, 100),
                                        (33, 5)])
def test_visible_pairs_count_the_mask(seq, window):
    i = torch.arange(seq)[:, None]
    j = torch.arange(seq)[None, :]
    seen = j <= i
    if window:
        seen &= j > i - window
    assert flops.visible_pairs(seq, window) == int(seen.sum())


def test_granite_train_step_by_hand():
    cfg = cfg_of("granite-3-2b")
    per_layer = (2 * 2048 * 32 * 64 + 2 * 2048 * 8 * 64 + 3 * 2048 * 8192)
    assert flops.product_weights(cfg) == 40 * per_layer == 2_432_696_320
    tokens = 4 * 4096
    pairs = 4096 * 4097 // 2
    want = (6 * (2_432_696_320 + 2048 * 49155) * tokens
            + 14 * 64 * pairs * 32 * 4 * 40)
    assert flops.train_ops(cfg, 4, 4096) == want
    assert 2.8e14 < want < 2.9e14


def test_danube_prefill_and_eval_by_hand():
    cfg = cfg_of("h2o-danube-3-4b")
    per_layer = (2 * 3840 * 32 * 120 + 2 * 3840 * 8 * 120
                 + 3 * 3840 * 10240)
    assert flops.product_weights(cfg) == 24 * per_layer
    # 8,192 positions, window 4,096: 4096·4097/2 + 4096·4096 pairs
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    want = (2 * 24 * per_layer * 4 * 8192 + 2 * 3840 * 32000 * 4
            + 4 * 120 * pairs * 32 * 4 * 24)
    assert flops.forward_ops(cfg, 4, 8192, 4) == want
    doc = (2 * 24 * per_layer * 512 + 2 * 3840 * 32000 * 512
           + 4 * 120 * (512 * 513 // 2) * 32 * 24)
    assert flops.forward_ops(cfg, 1, 512, 512) == doc


def test_attention_bounds_by_hand():
    cfg = cfg_of("h2o-danube-3-4b")
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    ops = 4 * 120 * pairs * 32 * 4
    nbytes = 2 * 4 * 8192 * 120 * (2 * 32 + 2 * 8)
    assert ops / 989e12 > nbytes / 3.35e12
    assert flops.attention_fwd_bound_s(cfg, 4, 8192) == pytest.approx(
        24 * ops / 989e12)
    g = cfg_of("granite-3-2b")
    bwd = 10 * 64 * (4096 * 4097 // 2) * 32 * 4 / 989e12
    assert flops.attention_bwd_bound_s(g, 4, 4096) == pytest.approx(40 * bwd)


def test_layers_without_a_count_raise():
    import dataclasses
    cfg = dataclasses.replace(cfg_of("granite-3-2b"),
                              layer_pattern=("rglru",))
    with pytest.raises(NotImplementedError):
        flops.product_weights(cfg) and flops.attention_pairs(cfg, 1, 8)
