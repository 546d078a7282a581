"""The language model: embeddings + block groups + chunked CE loss, with the
prefill/decode serving paths (ring KV caches, recurrent cells' state), as
in the JAX package's ``repro/models/decoder.py``.

Params keep the JAX package's layout: ``groups`` holds each block of the
cyclic layer pattern with its tensors stacked on a leading ``n_groups``
axis, and ``rem`` the remainder layers unstacked.  A loop over the groups
takes the place of ``lax.scan``: each group reads its layer of every
stacked leaf through one ``unbind`` a leaf (``_layers``), whose backward
stacks the layers' gradients once; indexing ``t[g]`` would instead add a
zero tensor of the whole stacked leaf into its gradient for every layer,
O(L²) traffic and a transient of the leaf's size each time.  Caches are
stacked the same way.  In a training forward (train mode with gradients
on) and ``cfg.remat`` set, each pattern group, of the decoder and of the
encoder, runs under ``torch.utils.checkpoint`` (non-reentrant), as the
JAX package wraps the scan body in ``jax.checkpoint``: only the group's
input is kept, and the backward recomputes the group.  Entry points run
on the card unless the caller passes ``device="cpu"`` (init) or CPU
tensors.

The VLM (``xattn`` layers) and the encoder-decoder (``dec`` layers) take
``aux`` (B, Ta, d_model): the image's patch embeddings, or the audio's
frame embeddings, which ``encode`` turns into the ``enc_out`` the decoder's
cross-attention reads (the frontends are stubs, as in the JAX package).

On a mesh (DTensor params, caches and batches placed by
``launch/sharding.distribute_tree``) the same functions run: ``hint``
pins the stream's batch axis at each block's input and after the
embedding, and the logits' vocab axis in the loss, as the JAX package's
three sites do; the blocks, the embedding, the logits and the loss's
cross-rank max and sums go through ``models/sharded.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models.act_shard import hint
from repro_torch.models.blocks import (apply_block, init_block,
                                       init_block_cache, sublayer_input)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharded import is_dtensor

Params = Dict[str, Any]


def tree_map(fn, *trees):
    """Map ``fn`` over the tensors of matching nested dicts (params and
    caches); None leaves stay None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_group(cfg: ModelConfig, pattern, generator, device,
                lead=()) -> Params:
    return {str(i): init_block(cfg, kind, generator, device, lead)
            for i, kind in enumerate(pattern)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random params by the JAX package's init law: dense weights normal ·
    fan_in^-0.5, norm scales 0, the embedding normal · d^-0.5 with the
    padding rows zeroed, all in ``param_dtype``.  The draws come from
    ``generator`` (default: seed 0 on ``device``) and are not the JAX
    package's (carry its params across with ``interop.params_from_numpy``
    for parity).  Cross-attention gates start at zero, as there."""
    dev = resolve_device(device)
    gen = generator
    if gen is None and dev.type != "meta":     # meta: shapes, no draws
        gen = torch.Generator(device=dev).manual_seed(0)
    pd = L._pdtype(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    emb = torch.randn((vp, d), generator=gen, device=dev).mul_(d ** -0.5)
    emb[cfg.vocab:] = 0.0          # padded ids are inert
    params: Params = {"embedding": emb.to(pd),
                      "final_norm": torch.zeros((d,), dtype=pd, device=dev)}
    del emb
    if not cfg.tie_embeddings:
        params["out_proj"] = L.dense_init((d, vp), d, pd, gen, dev)
    if cfg.n_groups > 0:
        params["groups"] = _init_group(cfg, cfg.layer_pattern, gen, dev,
                                       lead=(cfg.n_groups,))
    if cfg.rem_pattern:
        params["rem"] = _init_group(cfg, cfg.rem_pattern, gen, dev)
    if cfg.is_encdec:
        params["encoder"] = {
            "groups": _init_group(cfg, ("enc",), gen, dev,
                                  lead=(cfg.enc_layers,)),
            "final_norm": torch.zeros((d,), dtype=pd, device=dev),
        }
    return params


def init_serve_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     device=None) -> Params:
    """Cache tree matching the prefill output / decode input."""
    dev = resolve_device(device)

    def group_cache(pattern):
        return {str(i): init_block_cache(cfg, kind, batch, cache_len, dev)
                for i, kind in enumerate(pattern)}

    cache: Params = {}
    if cfg.n_groups > 0:
        gc = group_cache(cfg.layer_pattern)
        cache["groups"] = tree_map(
            lambda x: x.unsqueeze(0).repeat((cfg.n_groups,) + (1,) * x.ndim),
            gc)
    if cfg.rem_pattern:
        cache["rem"] = group_cache(cfg.rem_pattern)
    if cfg.is_encdec:
        cache["enc_out"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                       dtype=L._cdtype(cfg), device=dev)
    return cache


def num_params(params: Params) -> Tuple[int, int]:
    """(parameter count, bytes) of a params tree."""
    leaves = []
    tree_map(leaves.append, params)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _group_fn(cfg, pattern, gp, x, *, positions, gcache, aux, mode,
              cache_len=None):
    ncs = {}
    for i, kind in enumerate(pattern):
        x = hint(x, ("batch", None, None))
        x, nc = apply_block(
            cfg, kind, gp[str(i)], x, positions=positions,
            cache=None if gcache is None else gcache[str(i)], aux=aux,
            mode=mode, cache_len=cache_len)
        ncs[str(i)] = nc
    return x, ncs


def _layers(stacked: Params, n: int):
    """The ``n`` layers of a stacked group's params, as views: one
    ``unbind`` a leaf."""
    per = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda u: u[g], per) for g in range(n)]


def _remat(cfg: ModelConfig, mode: str) -> bool:
    return mode == "train" and cfg.remat and torch.is_grad_enabled()


def _train_group(cfg, pattern, gp, x, positions, aux):
    return _group_fn(cfg, pattern, gp, x, positions=positions, gcache=None,
                     aux=aux, mode="train")[0]


def _run_group(cfg, pattern, gp, x, *, positions, gcache, aux, mode,
               cache_len=None):
    """One pattern group; under remat (``_remat``) through the
    non-reentrant checkpoint, which keeps only its inputs."""
    if _remat(cfg, mode):
        return checkpoint(_train_group, cfg, pattern, gp, x, positions, aux,
                          use_reentrant=False,
                          preserve_rng_state=False), None
    return _group_fn(cfg, pattern, gp, x, positions=positions,
                     gcache=gcache, aux=aux, mode=mode, cache_len=cache_len)


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               positions, caches, aux, mode: str,
               cache_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    pattern = cfg.layer_pattern
    new_caches: Params = {}
    if cfg.n_groups > 0:
        gcs = []
        for g, gp in enumerate(_layers(params["groups"], cfg.n_groups)):
            gc_in = (None if mode != "decode" else
                     tree_map(lambda t: t[g], caches["groups"]))
            x, gc = _run_group(cfg, pattern, gp, x, positions=positions,
                               gcache=gc_in, aux=aux, mode=mode,
                               cache_len=cache_len)
            gcs.append(gc)
        if mode == "prefill":
            new_caches["groups"] = tree_map(lambda *ts: torch.stack(ts),
                                            *gcs)
        elif mode == "decode":      # written in place through the views
            new_caches["groups"] = caches["groups"]
    if cfg.rem_pattern:
        x, rc = _group_fn(
            cfg, cfg.rem_pattern, params["rem"], x, positions=positions,
            gcache=None if mode != "decode" else caches["rem"], aux=aux,
            mode=mode, cache_len=cache_len)
        if mode != "train":
            new_caches["rem"] = rc
    return x, (new_caches if mode != "train" else None)


def encode(cfg: ModelConfig, params: Params, audio_embeds: torch.Tensor
           ) -> torch.Tensor:
    """Whisper-style encoder over stub frontend embeddings (B, Ta, d): the
    ``enc`` blocks (non-causal self-attention, kernel 12 on the card) in
    train mode at positions 0..Ta-1 (remat as the decoder's groups), then
    the encoder's final norm."""
    enc = params["encoder"]
    dev = params["embedding"].device
    if is_dtensor(audio_embeds):
        x = audio_embeds.to(L._cdtype(cfg))
    else:
        x = audio_embeds.to(device=dev, dtype=L._cdtype(cfg))
    positions = torch.arange(x.shape[1], device=dev)
    for gp in _layers(enc["groups"], cfg.enc_layers):
        x, _ = _run_group(cfg, ("enc",), gp, x, positions=positions,
                          gcache=None, aux=None, mode="train")
    return _final_norm(cfg, x, enc["final_norm"])


def _final_norm(cfg: ModelConfig, x, scale):
    if is_dtensor(x):
        return sharded.rms_norm(cfg, x, scale)
    return L.rms_norm(x, scale, cfg.norm_eps)


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    emb = params["embedding"]
    if is_dtensor(emb):
        return hint(sharded.embed(cfg, emb, tokens), ("batch", None, None))
    return emb[tokens.to(device=emb.device, dtype=torch.int64)].to(
        L._cdtype(cfg))


def logits_from_hidden(cfg: ModelConfig, params: Params, h: torch.Tensor
                       ) -> torch.Tensor:
    """(…, d) -> (…, padded_vocab) f32, padding columns at -1e30."""
    if is_dtensor(h):
        return sharded.logits(cfg, params["embedding"] if cfg.tie_embeddings
                              else params["out_proj"], h,
                              cfg.tie_embeddings)
    w = (params["embedding"] if cfg.tie_embeddings
         else params["out_proj"].T)
    cd = L._cdtype(cfg)
    logits = L.project(h.to(cd), w.to(cd).T, torch.float32)
    pad_mask = torch.where(
        torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab, 0.0,
        -1e30)
    return logits + pad_mask


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, aux=None, mode: str = "train",
                   caches: Optional[Params] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    if cfg.is_encdec and mode != "decode":
        aux = encode(cfg, params, aux)
    elif cfg.is_encdec and mode == "decode":
        aux = caches["enc_out"]
    x = embed(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)
    x, new_caches = _run_stack(cfg, params, x, positions=positions,
                               caches=caches, aux=aux, mode=mode,
                               cache_len=cache_len)
    x = _final_norm(cfg, x, params["final_norm"])
    if mode == "prefill" and cfg.is_encdec:
        new_caches["enc_out"] = aux
    return x, new_caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _row_max(logits: torch.Tensor) -> torch.Tensor:
    """The max over the vocab, held constant (the JAX package's
    ``logsumexp`` stops its gradient)."""
    return torch.amax(logits, dim=-1).detach()


def _row_sumexp(logits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.exp(logits - m[..., None]).sum(dim=-1)


def _gold(logits: torch.Tensor, labels: torch.Tensor, v0: int = 0
          ) -> torch.Tensor:
    """The labels' logits, where the vocab columns at hand are v0, v0 + 1,
    ... (a rank's slice on a mesh); 0 for a label outside them (and for a
    negative label, which the loss masks)."""
    r = labels - v0
    inside = (r >= 0) & (r < logits.shape[-1])
    g = torch.gather(logits, -1, r.clamp(0, logits.shape[-1] - 1)[..., None])
    return torch.where(inside, g[..., 0], 0.0)


def _ce_parts(logits: torch.Tensor, labels: torch.Tensor):
    """(logz, gold): logsumexp as the JAX package computes it, log(sum(
    exp(l - max))) + max, and the labels' logits; on a mesh the max and the
    sums run across the vocab split (``sharded.ce_parts``)."""
    if is_dtensor(logits):
        return sharded.ce_parts(logits, labels)
    m = _row_max(logits)
    return torch.log(_row_sumexp(logits, m)) + m, _gold(logits, labels)


def _chunked_ce(cfg: ModelConfig, params: Params, h: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE with the vocab-logit working set capped at
    (B, loss_chunk, padded_vocab).  Returns (ce (B,S), valid (B,S))."""
    b, s, _ = h.shape
    c = cfg.loss_chunk if cfg.loss_chunk else s
    c = min(c, s)
    # the output weight read once for every chunk: gathered once on a
    # mesh, and an alias here, so that both paths sum the chunks'
    # gradients before the embedding lookup's
    name = "embedding" if cfg.tie_embeddings else "out_proj"
    if is_dtensor(h):
        labels = sharded.rows_like(labels, h).to(torch.int64)
        w = sharded.gather(params[name], name, sharded.embed_dims(h))
    else:
        labels = labels.to(device=h.device, dtype=torch.int64)
        w = sublayer_input(params[name])
    params = dict(params, **{name: w})
    ces, valids = [], []
    for c0 in range(0, s, c):
        logits = logits_from_hidden(cfg, params, h[:, c0:c0 + c])
        logits = hint(logits, ("batch", None, "vocab"))
        li = labels[:, c0:c0 + c]
        logz, gold = _ce_parts(logits, li)
        valid = (li >= 0).to(torch.float32)
        ces.append((logz - gold) * valid)
        valids.append(valid)
    return torch.cat(ces, dim=1), torch.cat(valids, dim=1)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h, _ = forward_hidden(cfg, params, batch["tokens"],
                          aux=batch.get("aux"), mode="train")
    ce, valid = _chunked_ce(cfg, params, h, batch["labels"])
    count = torch.clamp_min(_total(valid), 1.0)
    loss = _total(ce) / count
    if is_dtensor(loss):            # replicated: every rank's is the loss
        loss, count = loss.to_local(), count.to_local()
    return loss, {"loss": loss, "tokens": count}


def _total(t: torch.Tensor) -> torch.Tensor:
    return sharded.total(t) if is_dtensor(t) else t.sum()


def per_example_loss(cfg: ModelConfig, params: Params,
                     batch: Dict[str, Any]) -> torch.Tensor:
    """(B,) mean loss per example — the earl_eval statistic."""
    h, _ = forward_hidden(cfg, params, batch["tokens"],
                          aux=batch.get("aux"), mode="train")
    ce, valid = _chunked_ce(cfg, params, h, batch["labels"])
    return ce.sum(dim=-1) / torch.clamp_min(valid.sum(dim=-1), 1.0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            aux=None, cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Returns (last-token logits (B, Vp), cache).  ``cache_len`` reserves
    extra KV-cache capacity for subsequent decode steps."""
    h, caches = forward_hidden(cfg, params, tokens, aux=aux, mode="prefill",
                               cache_len=cache_len)
    logits = logits_from_hidden(cfg, params, h[:, -1])
    return logits, caches


def decode_step(cfg: ModelConfig, params: Params, caches: Params,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) ints; pos: the absolute position (an int or a
    one-element tensor).

    Returns (logits (B, Vp), updated caches).  The caches are updated in
    place and returned (the JAX package returns new ones): the old caches
    are the new."""
    dev = params["embedding"].device
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1).to(device=dev, dtype=torch.int64)
    else:
        positions = torch.full((1,), int(pos), dtype=torch.int64, device=dev)
    h, new_caches = forward_hidden(cfg, params, token, mode="decode",
                                   caches=caches, positions=positions)
    if cfg.is_encdec:
        new_caches["enc_out"] = caches["enc_out"]
    logits = logits_from_hidden(cfg, params, h[:, 0])
    return logits, new_caches
