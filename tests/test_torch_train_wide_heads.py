"""Training at the head dims past 128, the ones kernel 12's backward takes
on its wide route on the card (gemma3-27b's 168, recurrentgemma-2b's 256),
against the JAX package on the CPU.

One ``make_train_step`` of the port against the JAX package's in f32
compute, on the gemma3-27b and recurrentgemma-2b smoke configs with
``head_dim`` set to 168 and 256 in both packages (everything else stays
narrow), at the smoke depth and at the depth phase 18's leg 3 cuts each
family to (gemma3-27b's two remainder layers, below one pattern group;
recurrentgemma-2b's one group): the plain backward at these head dims
against ``jax.vjp`` through the JAX package's blockwise path, with
tests/test_torch_train.py's helpers and tolerances (see its docstring).
Then the plan of leg 3 (``chip_smoke.wide_plan``): every published width
of each family kept and only the depth cut, the heads past 128, the
peak reckoned by ``train_reckoning`` with the chunked CE's terms at the
leg's batch under 70e9 bytes (and those terms against what the chunked CE
saves for its backward),
the launches a step it expects, and the slice its card == CPU check takes
holding the first attention layer.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_grad_step, make_train_step
from test_torch_train import (OPT, JAdamW, _batch, _close_params,
                              _close_tree, _configs, _states)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: (arch, head_dim, n_layers: None for the smoke depth)
WIDE = [("gemma3-27b", 168, None), ("gemma3-27b", 168, 2),
        ("recurrentgemma-2b", 256, None), ("recurrentgemma-2b", 256, 3)]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch,head_dim,n_layers", WIDE,
                         ids=[f"{a}-d{d}-L{n}" for a, d, n in WIDE])
def test_wide_head_train_step_matches_jax(arch, head_dim, n_layers):
    jcfg, cfg = _configs(arch, "float32")
    cut = dict(head_dim=head_dim)
    if n_layers is not None:
        cut["n_layers"] = n_layers
    jcfg = dataclasses.replace(jcfg, **cut)
    cfg = dataclasses.replace(cfg, **cut)
    assert cfg.head_dim_ == jcfg.head_dim_ == head_dim > 128
    jstate, state = _states(jcfg, JAdamW(**OPT))
    jb, tb = _batch(cfg)
    jnew, jm = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT)))(jstate, jb)
    new, m = make_train_step(cfg, AdamWConfig(**OPT))(state, tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            1e-5 * abs(float(jm[key])), key
    _close_params(new.params, jnew.params, OPT["lr"], 1e-3)
    _close_tree(new.opt.m, jnew.opt.m, 3e-5)
    _close_tree(new.opt.v, jnew.opt.v, 3e-5)


def test_wide_leg_keeps_the_published_widths():
    cs = _chip_smoke()
    plan = cs.wide_plan()
    assert [c.name for c, *_ in plan] == ["gemma3-27b", "recurrentgemma-2b"]
    for cfg, batch, n, reck in plan:
        full = get_config(cfg.name)
        assert cfg == dataclasses.replace(full, n_layers=cfg.n_layers)
        assert cfg.n_layers < full.n_layers
        for f in ("d_model", "n_heads", "n_kv_heads", "head_dim_", "d_ff",
                  "vocab", "window", "layer_pattern", "compute_dtype",
                  "remat"):
            assert getattr(cfg, f) == getattr(full, f), (cfg.name, f)
        assert cfg.head_dim_ > 128
        assert reck == cs.train_reckoning(cfg, n, batch, chunked_ce=True)
        assert reck["total"] < cs.WIDE_PEAK_LIMIT == 70e9
    (gemma, gb, _, _), (rg, rb, _, _) = plan
    assert (gemma.head_dim_, gemma.n_groups, gemma.rem_pattern, gb) == \
        (168, 0, ("local", "local"), 1)
    assert (rg.head_dim_, rg.n_groups, rg.rem_pattern, rb) == \
        (256, 1, (), 4)
    # gemma3-27b's remainder layers run outside remat: one forward each
    assert cs.wide_step_launches(gemma) == {"flash_attention": 2,
                                            "flash_attention_bwd": 2}
    assert cs.wide_step_launches(rg) == {"flash_attention": 2,
                                         "flash_attention_bwd": 1}


@pytest.mark.parametrize("arch,n_layers", [("gemma3-27b", 2),
                                           ("recurrentgemma-2b", 3)])
def test_wide_leg_slice_holds_the_first_attention_layer(arch, n_layers):
    """``chip_smoke.attention_slice`` on the smoke config cut as leg 3 cuts
    the full one: the first remainder layer (gemma3-27b) or the first
    pattern group (recurrentgemma-2b), whose grad step runs and whose
    leaves are the model's own."""
    from repro_torch.models.decoder import init_params
    from repro_torch.optim.adamw import tree_leaves
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              n_layers=n_layers)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    one, p = cs.attention_slice(cfg, params)
    kinds = one.layer_pattern * one.n_groups + one.rem_pattern
    assert "local" in kinds and one.n_layers <= n_layers
    full = dict(tree_leaves(params))
    for path, t in tree_leaves(p):
        if path.startswith("/groups/"):
            assert torch.equal(t, full[path][:1]), path
        else:
            assert torch.equal(t, full[path]), path
    _, tb = _batch(one)
    grads, gnorm, loss = make_grad_step(one)(p, tb)
    assert torch.isfinite(loss) and float(gnorm) > 0


def test_chunked_ce_reckoning_counts_what_the_ce_saves():
    """``train_reckoning(..., chunked_ce=True)`` against the chunked CE
    itself: on a smoke config with a loss_chunk of 8 over 32 positions, the
    f32 (B, loss_chunk, padded_vocab) tensors that ``_chunked_ce`` saves
    for its backward are the two f32 (tokens, padded_vocab) tensors the
    reckoning counts (``logits`` and ``ce_gathered_logits``), and the
    weight copies are one a chunk, ceil(S / loss_chunk) (bf16 on the card;
    here, in f32 compute, the weight itself).  Leg 1's reckoning
    (granite-3-2b) keeps its terms without them."""
    from repro_torch.models import decoder
    from repro_torch.models.decoder import init_params
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("gemma3-27b", smoke=True),
                              loss_chunk=8)
    b, s = 2, 32
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {k: v.requires_grad_(True) if torch.is_tensor(v)
              and v.is_floating_point() else v for k, v in params.items()}
    h = torch.randn(b, s, cfg.d_model, requires_grad=True)
    labels = torch.randint(0, cfg.vocab, (b, s))
    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        decoder._chunked_ce(cfg, params, h, labels)
    chunk_shape = (b, cfg.loss_chunk, cfg.padded_vocab)
    logit_bytes = sum(t.untyped_storage().nbytes() for t in saved.values()
                      if tuple(t.shape) == chunk_shape
                      and t.dtype == torch.float32)
    assert logit_bytes == 2 * b * s * cfg.padded_vocab * 4
    wide = cs.train_reckoning(cfg, 1, 1, chunked_ce=True)
    assert wide["logits"] + wide["ce_gathered_logits"] == \
        2 * cs.TRAIN_S * cfg.padded_vocab * 4
    assert wide["ce_weight_copies"] == -(-cs.TRAIN_S // cfg.loss_chunk) \
        * cfg.padded_vocab * cfg.d_model * 2
    leg1 = cs.train_reckoning(get_config(cs.TRAIN_ARCH), 2_000_000_000)
    assert set(leg1) == {"params", "grads", "m_v", "remat_inputs",
                         "group_recompute", "logits", "second_grads",
                         "total"}


def test_wide_card_cpu_halves_on_cpu_tensors():
    """``chip_smoke.wide_card_cpu`` end to end on the CPU, the "card" side
    on CPU tensors too: on the smoke configs cut as leg 3 cuts the full
    ones, the bf16 kernel-against-plain comparison comes back at once and
    the CPU's half, called later (as from the thread beside phase 8),
    holds the two sides and reports both comparisons."""
    from repro_torch.models.decoder import init_params
    cs = _chip_smoke()
    for arch, n_layers, compute in (("gemma3-27b", 2, "bfloat16"),
                                    ("recurrentgemma-2b", 3, "float32")):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  n_layers=n_layers)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out, half = cs.wide_card_cpu(torch, cfg, params, compute,
                                     cs.TRAIN_CPU_SHARE)
        assert set(out) == ({"kernel_vs_plain"} if compute == "bfloat16"
                            else set())
        res = half()
        assert res["grad_share"] <= 1e-6 and res["share_max"] == 2e-2
        assert ("kernel_vs_plain" in res) == (compute == "bfloat16")
