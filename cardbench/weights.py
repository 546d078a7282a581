"""The weights and inputs of a run, made by the benchmark from the seed.

``make_params`` lays the weights out as the port takes them (its params
tree: the stacked pattern groups, ``rem`` for a remainder) and draws them
on the device with one ``torch.Generator`` a run, one call a leaf (a
stacked leaf holds every layer's tensor), in the type they are served
in.  The law: a dense weight normal · fan_in^-0.5; the embedding normal ·
d^-0.5 with the padding rows zero (padded ids are inert); every norm
scale normal · 0.1, so that a norm that ignored its scale would show (the
norms multiply by 1 + scale).  The reference takes the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict

from cardbench.harness import derive

NORM_STD = 0.1


def generator(torch, device: str, seed: int, *tags):
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def _block(cfg, kind: str, lead, draw) -> Dict[str, Any]:
    from cardbench.flops import layer_window
    layer_window(cfg, kind)            # raises for kinds without a count
    d, hq, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.d_ff)
    return {
        "attn_norm": draw(lead + (d,), None),
        "attn": {"wq": draw(lead + (d, hq, dh), d),
                 "wk": draw(lead + (d, hkv, dh), d),
                 "wv": draw(lead + (d, hkv, dh), d),
                 "wo": draw(lead + (hq, dh, d), hq * dh)},
        "mlp_norm": draw(lead + (d,), None),
        "mlp": {"w_gate": draw(lead + (d, f), d),
                "w_up": draw(lead + (d, f), d),
                "w_down": draw(lead + (f, d), f)},
    }


def make_params(torch, cfg, seed: int, device: str) -> Dict[str, Any]:
    """The run's weights; the same seed gives the same tensors."""
    gen = generator(torch, device, seed, "weights")
    dtype = getattr(torch, cfg.param_dtype)

    def draw(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device)
        t.mul_(NORM_STD if fan_in is None else fan_in ** -0.5)
        return t.to(dtype)

    d, vp = cfg.d_model, cfg.padded_vocab
    emb = draw((vp, d), d)
    emb[cfg.vocab:] = 0.0
    params: Dict[str, Any] = {"embedding": emb,
                              "final_norm": draw((d,), None)}
    if not cfg.tie_embeddings:
        out = draw((d, vp), d)
        out[:, cfg.vocab:] = 0.0
        params["out_proj"] = out
    if cfg.n_groups > 0:
        params["groups"] = {str(i): _block(cfg, k, (cfg.n_groups,), draw)
                            for i, k in enumerate(cfg.layer_pattern)}
    if cfg.rem_pattern:
        params["rem"] = {str(i): _block(cfg, k, (), draw)
                         for i, k in enumerate(cfg.rem_pattern)}
    return params


def tokens(torch, cfg, seed: int, device: str, shape, *tags):
    """Token ids drawn uniformly from the published vocabulary, int64."""
    gen = generator(torch, device, seed, "tokens", *tags)
    return torch.randint(0, cfg.vocab, tuple(shape), generator=gen,
                         device=device)
