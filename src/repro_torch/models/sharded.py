"""The model stack on a mesh: params, caches and batches as DTensors
(``launch/sharding.distribute_tree``), the blocks run on each rank's
local shards, with the products a rank runs in the JAX package's program
compiled by GSPMD under the same shardings.  Which layout a sublayer
takes follows the placement of the activation entering it:

* **the batch split over the data axes** (training, batched serving):
  each product gathers its FSDP-sharded weight (``gather``: every split
  of a dim whose logical axis is not one of ``KEEP``, such as "embed"
  over data, becomes ``Replicate``, an all-gather) and keeps the model
  split of heads, ``mlp``, ``vocab``, ``expert`` and ``rnn``;
* **no data split of the batch** (batch 1: a decode, a prefill): the
  FSDP split of "embed" is kept, as XLA keeps it.  The embedding looks up
  each rank's columns of d, so the residual stream is ``Shard`` of d
  over the data axes (``embed_dims``); every weight keeps its "embed"
  split there (``gather(keep=)``).  A product that contracts d runs on
  the rank's columns and its partial sums are summed by one all-reduce
  before the next nonlinearity; a product whose output is d writes the
  rank's columns; the norms sum their squares by one all-reduce
  (``layers.EmbedSplit``, whose collectives run inside the sublayer's
  ``local_map``).  The logits' partial sums are summed by one all-reduce.
  No weight is gathered;
* **the gspmd MoE** (``_moe_global``), whatever the stream's split: each
  data rank routes its own tokens on whole rows of d, the experts over
  the model axes; the choices of every rank reach every rank exactly
  (zero-filled slices, one all-reduce: ``_rejoin``) and every rank sorts
  the same token-slots, so the kept slots are the unsharded route's; the
  tokens go into an (E_local, C, d / data) dispatch by one all-to-all
  and the experts keep their "embed" split as above.  ``moe_impl=
  "shard_map"`` keeps its group-local routing over f-split experts.

In every layout a sublayer (its norm, its products, kernel 12, the
recurrent scans, the in-place cache writes) runs in one ``local_map``
(``run_local``; the gspmd MoE in one a stage) on the local tensors,
with the placements of its outputs written at its call site: ``Partial``
over the mesh axes that split its contraction over heads, ``mlp``,
experts or ``rnn``, the batch's ``Shard(0)`` and d's ``Shard`` as the
stream's.  That partial sum is summed by one all-reduce in the output
product's dtype (the JAX package's all-reduce of the dot output) where
the residual adds it (``residual``), then cast to the stream's dtype.
Where a route rejoins a split activation or a small weight (the MoE's
router and norm scale, its choices) it writes each rank's slice into
zeros and sums them by one all-reduce, which is exact; where tokens
change split it uses an all-to-all (``_AllToAll``).  So batch-1 serving
and the gspmd MoE issue no all-gather where one mesh axis splits the
batch or d (the 2 x 2 and 16 x 16 meshes; with the batch over pod and
data the MoE gathers its tokens).

Gradients: an input replicated over a mesh axis that splits the sublayer
gets its gradient as ``Partial`` there (each rank's share), which
DTensor's redistribute backward sums (the FSDP gather's backward is a
reduce-scatter, a replicated weight's an all-reduce); over the axes of a
kept split of d the sublayer's own collectives sum it (``EmbedSplit``'s
``use``), and a weight that keeps its split gets its gradient locally.

Decode also takes the flash-decoding layout: at batch 1 ``SERVE_RULES``
puts the cache's ring slots (``cache_seq``) over the data axes, which the
batch cannot use.  Each rank then attends over its own slots (its
partial max, sum and weighted V), the ranks combine them by all-reduces
only (the max, then the sums), and only the rank that holds slot
``pos % cache_len`` writes the new K/V (``_decode_cache``, ``_seq_split``
and ``layers.SeqSplit``).

On a mesh of one rank every collective is one rank's copy and every local
op is the unsharded op, so the steps are bitwise the unsharded ones.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.partitioning import PARAM_AXES

#: logical axes whose split a sublayer keeps (the model split); every other
#: split of a weight is gathered before use
KEEP = frozenset(("heads", "kv_heads", "mlp", "expert", "rnn", "vocab"))
_CELL_KINDS = ("rglru", "mlstm", "slstm")
_CROSS = ("xattn", "dec")


def _dt():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_of(t):
    """A DTensor's local tensor; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _shard_dims(t) -> set:
    _, _, _, Shard = _dt()
    return {m for m, p in enumerate(t.placements) if isinstance(p, Shard)}


def sum_over_shards(s: torch.Tensor, like) -> torch.Tensor:
    """A rank's partial value ``s`` of a sum over the elements of the
    DTensor ``like``, summed over the mesh axes that split ``like`` (an
    all-reduce); over an axis that replicates it, ``s`` is already whole."""
    DTensor, Partial, Replicate, Shard = _dt()
    mesh = like.device_mesh
    places = []
    for p in like.placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"a leaf placed {like.placements}: only Shard "
                             f"and Replicate leaves are summed")
        places.append(Partial() if isinstance(p, Shard) else Replicate())
    if not any(isinstance(p, Partial) for p in places):
        return s
    return DTensor.from_local(s, mesh, places, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def shard_offset(t, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` (0 for
    a plain tensor): the splits of ``dim``, outermost mesh dim first."""
    if not is_dtensor(t):
        return 0
    _, _, _, Shard = _dt()
    dim %= t.ndim
    coord = t.device_mesh.get_coordinate()
    n, off = t.shape[dim], 0
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim % t.ndim == dim:
            n //= t.device_mesh.size(m)
            off += coord[m] * n
    return off


def _axes(t, name: str) -> tuple:
    axes = PARAM_AXES[name]
    return ("layers",) * (t.ndim - len(axes)) + tuple(axes)


def embed_dims(x) -> frozenset:
    """The mesh dims that split the stream's model dim d (its last dim):
    the FSDP split of "embed" kept where the batch does not split."""
    if not is_dtensor(x):
        return frozenset()
    _, _, _, Shard = _dt()
    return frozenset(m for m, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1)


def _embed_splits(t, name: str) -> frozenset:
    """The mesh dims that split the "embed" dim of weight ``t``."""
    _, _, _, Shard = _dt()
    full = _axes(t, name)
    return frozenset(m for m, p in enumerate(t.placements)
                     if isinstance(p, Shard) and full[p.dim % t.ndim]
                     == "embed")


def gather(t, name: str, keep=frozenset()):
    """The weight leaf ``t`` (registered as ``name`` in ``PARAM_AXES``)
    with every split of a dim outside ``KEEP`` gathered (``Replicate``),
    except its "embed" dim on the mesh dims ``keep`` (the stream's
    ``embed_dims``), where it is kept split, or split where ``t``
    replicates it (a local slice); always through ``redistribute``, whose
    backward brings the gradient back to ``t``'s placements."""
    _, _, Replicate, Shard = _dt()
    full = _axes(t, name)
    edim = full.index("embed") if "embed" in full else None
    target = []
    for m, p in enumerate(t.placements):
        if m in keep and edim is not None:
            if isinstance(p, Replicate) or (isinstance(p, Shard)
                                            and p.dim % t.ndim == edim):
                target.append(Shard(edim))
                continue
            raise ValueError(f"weight {name!r} placed {t.placements}: mesh "
                             f"dim {m} splits the stream's d, not its "
                             f"\"embed\" dim")
        if isinstance(p, Shard):
            target.append(p if full[p.dim % t.ndim] in KEEP else Replicate())
        elif isinstance(p, Replicate):
            target.append(p)
        else:
            raise ValueError(f"weight {name!r} placed {t.placements}")
    return t.redistribute(t.device_mesh, target)


# ---------------------------------------------------------------------------
# collectives inside a sublayer's local function
# ---------------------------------------------------------------------------
def _all_reduce(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh dims ``dims`` (one
    functional all-reduce a dim)."""
    from torch.distributed import _functional_collectives as funcol
    t = t.contiguous()
    for m in sorted(dims):
        t = funcol.all_reduce(t, "sum", (mesh, m))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _SumAcross(torch.autograd.Function):
    """Partial sums summed across ranks; the gradient passes as it is
    (what follows runs alike on every rank)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return _all_reduce(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _UseAcross(torch.autograd.Function):
    """A tensor every rank holds whole, fed to the rank's share of a
    product: the identity, whose gradient (a share a rank) is summed."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.dims), None, None


def _embed_split(x, dims) -> Optional[L.EmbedSplit]:
    """``layers.EmbedSplit`` over the mesh dims ``dims`` that split the
    stream ``x``'s d, else None.  ``sum`` sums each dtype's tensors in
    one all-reduce."""
    if not dims:
        return None
    mesh = x.device_mesh

    def total(*ts):
        out = list(ts)
        groups: Dict[torch.dtype, list] = {}
        for i, t in enumerate(ts):
            groups.setdefault(t.dtype, []).append(i)
        for idx in groups.values():
            if len(idx) == 1:
                out[idx[0]] = _SumAcross.apply(ts[idx[0]], mesh, dims)
                continue
            flat = torch.cat([ts[i].reshape(-1) for i in idx])
            parts = _SumAcross.apply(flat, mesh, dims).split(
                [ts[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view(ts[i].shape)
        return tuple(out)

    return L.EmbedSplit(x.shape[-1], total,
                        lambda t: _UseAcross.apply(t, mesh, dims))


def _all_to_all(t: torch.Tensor, mesh, m: int, split_dim: int,
                cat_dim: int) -> torch.Tensor:
    """``t`` cut into the mesh dim ``m``'s size of chunks along
    ``split_dim``, chunk j sent to the rank at coordinate j, and the
    chunks received joined along ``cat_dim`` in coordinate order (one
    all-to-all)."""
    from torch.distributed import _functional_collectives as funcol
    send = torch.stack(t.chunk(mesh.size(m), dim=split_dim)).contiguous()
    recv = funcol.all_to_all_single(send, None, None, (mesh, m))
    if isinstance(recv, funcol.AsyncCollectiveTensor):
        recv = recv.wait()
    return torch.cat(recv.unbind(0), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    """``_all_to_all``, whose gradient goes back by the inverse one."""

    @staticmethod
    def forward(ctx, t, mesh, m, split_dim, cat_dim):
        ctx.args = (mesh, m, cat_dim, split_dim)
        return _all_to_all(t, mesh, m, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, *ctx.args),) + (None,) * 4


def _rejoin(t, dim: int, dims):
    """The DTensor ``t`` with its splits of ``dim`` over the mesh dims
    ``dims`` rejoined (``Replicate``) exactly, as ``embed`` sums the
    vocab: each rank's slice written into zeros, one all-reduce (no
    all-gather)."""
    _, Partial, Replicate, Shard = _dt()
    dim %= t.ndim
    dims = [m for m in dims if t.placements[m] == Shard(dim)]
    if not dims:
        return t
    off, whole = shard_offset(t, dim), t.shape[dim]

    def fill(tl):
        shape = list(tl.shape)
        pieces = []
        for n in (off, whole - off - tl.shape[dim]):
            shape[dim] = n
            pieces.append(tl.new_zeros(shape))
        return (torch.cat([pieces[0], tl, pieces[1]], dim=dim),)

    mid = tuple(Partial() if m in dims else p
                for m, p in enumerate(t.placements))
    out = run_local(fill, [t], [mid])[0]
    return out.redistribute(t.device_mesh, [Replicate() if m in dims else p
                                            for m, p in enumerate(mid)])


def run_local(fn, args: Sequence[torch.Tensor], outs: Sequence,
              whole=frozenset()) -> tuple:
    """``local_map`` of ``fn`` over ``args`` (DTensors, or plain tensors
    every rank holds whole) -> the tuple of its outputs as DTensors, with
    ``outs`` their placements.  An input's gradient keeps its ``Shard``s
    and is ``Partial`` over each mesh axis that splits some input but
    replicates this one (the sublayer's split: that rank's gradient is a
    share), else ``Replicate``; over the mesh axes ``whole`` (an
    ``EmbedSplit``'s, whose collectives inside ``fn`` make each replicated
    input's gradient whole on every rank) ``Replicate``."""
    from torch.distributed.tensor.experimental import local_map
    DTensor, Partial, Replicate, Shard = _dt()
    dts = [a for a in args if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    split = set().union(*(_shard_dims(a) for a in dts))
    in_places, in_grads = [], []
    for a in args:
        if not isinstance(a, DTensor):
            in_places.append(None)
            in_grads.append(None)
            continue
        grad = []
        for m, p in enumerate(a.placements):
            if isinstance(p, Shard):
                grad.append(p)
            elif isinstance(p, Replicate):
                grad.append(Partial() if m in split and m not in whole
                            else Replicate())
            else:
                raise ValueError(f"a sublayer's input placed {a.placements}"
                                 f": sum it (redistribute) first")
        in_places.append(tuple(a.placements))
        in_grads.append(tuple(grad))
    out = local_map(fn, out_placements=tuple(list(o) for o in outs),
                    in_placements=tuple(in_places),
                    in_grad_placements=tuple(in_grads),
                    device_mesh=mesh)(*args)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


# ---------------------------------------------------------------------------
# placements of a sublayer's outputs
# ---------------------------------------------------------------------------
def _check_stream(x) -> None:
    """The residual stream (B, S, d) may split its batch or its d."""
    _, _, Replicate, Shard = _dt()
    for p in x.placements:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in (0, x.ndim - 1))):
            raise ValueError(f"the residual stream must be Shard(0), "
                             f"Shard({x.ndim - 1}) or Replicate on each "
                             f"mesh axis, got {x.placements}")


def _batch_split(x, m: int) -> bool:
    _, _, _, Shard = _dt()
    p = x.placements[m]
    return isinstance(p, Shard) and p.dim == 0


def _model_split(x, weights) -> set:
    """The mesh axes that split a sublayer's weights; a mesh axis may not
    split both the batch and a weight."""
    dims = set().union(*(_shard_dims(w) for w in weights))
    both = [m for m in dims if _batch_split(x, m)]
    if both:
        names = [x.device_mesh.mesh_dim_names[m] for m in both]
        raise ValueError(f"mesh axes {names} split both the batch and a "
                         f"weight of one sublayer")
    return dims


def _sum_out(x, split: set, d_out: bool = True) -> tuple:
    """A (B, ..., d) output: the batch and d split as x's, Partial over
    ``split``; with ``d_out=False`` an output of another last dim,
    replicated where x splits d."""
    _, Partial, Replicate, Shard = _dt()
    kd = embed_dims(x)
    return tuple(Shard(0) if _batch_split(x, m)
                 else (x.placements[m] if d_out else Replicate()) if m in kd
                 else Partial() if m in split else Replicate()
                 for m in range(x.device_mesh.ndim))


def _split_out(x, w, wdim: int, tdim: int) -> tuple:
    """An output whose dim ``tdim`` follows dim ``wdim`` of weight ``w``
    (a cache's heads, a state's rnn width), the batch as x's."""
    _, _, Replicate, Shard = _dt()
    out = []
    for m in range(x.device_mesh.ndim):
        p = w.placements[m]
        if _batch_split(x, m):
            out.append(Shard(0))
        elif isinstance(p, Shard) and p.dim % w.ndim == wdim % w.ndim:
            out.append(Shard(tdim))
        else:
            out.append(Replicate())
    return tuple(out)


def _replicated(x) -> tuple:
    _, _, Replicate, _ = _dt()
    return tuple(Replicate() for _ in range(x.device_mesh.ndim))


def residual(x, y):
    """x + y, y summed over its Partial axes and placed as x (one
    all-reduce in y's dtype), then cast to x's dtype."""
    return x + y.redistribute(x.device_mesh, x.placements).to(x.dtype)


def _check_cache(name: str, t, want: tuple) -> None:
    if not is_dtensor(t) or tuple(t.placements) != tuple(want):
        raise ValueError(
            f"decode's cache leaf {name!r} must be placed {want} (the "
            f"prefill's, which follows the weights and the batch), got "
            f"{getattr(t, 'placements', 'a plain tensor')}")


def _decode_cache(cache, kv_want) -> tuple:
    """(the cache, the placements of its k, v and slot_pos after the step,
    the caller's slot_pos where it was gathered, else None) for a decode's
    self-attention: k and v placed as the prefill's (``kv_want``), except
    that on a mesh dim where those replicate, k and v may split their
    ring's slots (dim 2) with slot_pos split alike (the flash-decoding
    layout: ``SERVE_RULES``' ``cache_seq`` over the data axes when the
    batch cannot split).  slot_pos, which has no batch dim, may also be
    split where k and v are not (the same rules resolve it alone); it is
    gathered there for the step (one all-gather of the ring's positions,
    as XLA's partitioner would) and the step's write copied back
    (``_attention``).  Raises, naming the leaf, for any other placement."""
    _, _, Replicate, Shard = _dt()
    k, sp = cache["k"], cache["slot_pos"]
    dims = {m for m, p in enumerate(getattr(k, "placements", ()))
            if isinstance(p, Shard) and p.dim == 2
            and isinstance(kv_want[m], Replicate)}
    kv = tuple(Shard(2) if m in dims else p for m, p in enumerate(kv_want))
    want_sp = tuple(Shard(0) if m in dims else Replicate()
                    for m in range(len(kv_want)))
    for n in ("k", "v"):
        _check_cache(n, cache[n], kv)
    split = None
    if is_dtensor(sp) and tuple(sp.placements) != want_sp and all(
            p == want_sp[m] or (m not in dims and p == Shard(0))
            for m, p in enumerate(sp.placements)):
        split, sp = sp, sp.redistribute(sp.device_mesh, want_sp)
    _check_cache("slot_pos", sp, want_sp)
    return dict(cache, slot_pos=sp), [kv, kv, want_sp], split


def _seq_split(cache) -> Optional[L.SeqSplit]:
    """``layers.SeqSplit`` of a cache placed by ``_decode_cache``
    whose slots are split, else None: this rank's first slot, the ring's
    length and an all-reduce over the mesh dims that split the slots (one
    functional all-reduce a dim, as DTensor's Partial -> Replicate)."""
    _, _, _, Shard = _dt()
    sp = cache["slot_pos"]
    dims = [m for m, p in enumerate(sp.placements) if isinstance(p, Shard)]
    if not dims:
        return None
    from torch.distributed import _functional_collectives as funcol
    mesh = sp.device_mesh

    def all_reduce(t, op):
        for m in dims:
            t = funcol.all_reduce(t, op, (mesh, m))
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
        return t
    return L.SeqSplit(shard_offset(sp, 0), sp.shape[0], all_reduce)


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------
def rms_norm(cfg: ModelConfig, x, scale, name: str = "final_norm"):
    """``layers.rms_norm`` of the stream with a gathered scale (a split of
    d kept: the squares' sum summed across it)."""
    kd = embed_dims(x)
    es = _embed_split(x, kd)
    s = gather(scale, name, kd)
    return run_local(lambda xl, sl: (L.rms_norm(xl, sl, cfg.norm_eps, es),),
                     [x, s], [x.placements], kd)[0]


def _weights(p, names, x):
    """(the sublayer's weights gathered, keeping the stream's split of d;
    the mesh dims that split d; its ``EmbedSplit`` or None; the model
    split of the weights)."""
    kd = embed_dims(x)
    w = {k: gather(p[k], k, kd) for k in names}
    return w, kd, _embed_split(x, kd), _model_split(x, w.values()) - kd


def _attention(cfg, kind, norm, p, x, *, positions, cache, mode,
               cache_len):
    w, kd, es, split = _weights(p, ("wq", "wk", "wv", "wo"), x)
    s = gather(norm, "attn_norm", kd)
    q0, kv0 = shard_offset(w["wq"], -2), shard_offset(w["wk"], -2)
    window = cfg.window if kind in ("swa", "local") else 0
    kv_out = _split_out(x, w["wk"], -2, 1)
    names = ("k", "v", "slot_pos")
    outs = [_sum_out(x, split)]
    args = [x, s, w["wq"], w["wk"], w["wv"], w["wo"]]
    if mode != "train":
        outs += [kv_out, kv_out, _replicated(x)]
    seq_split = split_pos = None
    if mode == "decode":
        cache, outs[1:], split_pos = _decode_cache(cache, outs[1])
        seq_split = _seq_split(cache)
        args += [cache[n] for n in names]

    def local(xl, sl, wq, wk, wv, wo, *c):
        h = L.rms_norm(xl, sl, cfg.norm_eps, es)
        y, kv = L.self_attention(
            cfg, {"wq": wq, "wk": wk, "wv": wv, "wo": wo}, h, window=window,
            positions=positions, causal=kind != "enc",
            cache=dict(zip(names, c)) if c else None, mode=mode,
            cache_len=cache_len, q_head0=q0, kv_head0=kv0, cast=False,
            seq_split=seq_split, esplit=es)
        return (y,) if kv is None else (y,) + tuple(kv[n] for n in names)

    res = run_local(local, args, outs, kd)
    if mode == "train":
        return res[0], None
    kv = dict(zip(names, res[1:]))
    if split_pos is not None:       # the step's slot into the caller's shard
        mine = split_pos.to_local()
        mine.copy_(kv["slot_pos"].to_local().narrow(
            0, shard_offset(split_pos, 0), mine.shape[0]))
        kv["slot_pos"] = split_pos
    return res[0], kv


def _cross_attention(cfg, norm, p, x, aux, *, cache, mode):
    w, kd, es, split = _weights(p, ("wq", "wk", "wv", "wo", "gate"), x)
    s = gather(norm, "x_norm", kd)
    q0, kv0 = shard_offset(w["wq"], -2), shard_offset(w["wk"], -2)
    kv_out = _split_out(x, w["wk"], -2, 1)
    args = [x, s] + [w[k] for k in ("wq", "wk", "wv", "wo", "gate")]
    if mode == "decode":
        for n in ("k", "v"):
            _check_cache(n, cache[n], kv_out)
        args += [cache["k"], cache["v"]]
    else:
        if not is_dtensor(aux) or tuple(aux.placements) != tuple(
                x.placements):
            raise ValueError(
                f"cross-attention's aux must be a DTensor placed as the "
                f"stream ({x.placements}), got "
                f"{getattr(aux, 'placements', 'a plain tensor')}")
        args.append(aux)
    outs = [_sum_out(x, split)] + ([kv_out, kv_out] if mode == "prefill"
                                   else [])

    def local(xl, sl, wq, wk, wv, wo, gate, *rest):
        h = L.rms_norm(xl, sl, cfg.norm_eps, es)
        pp = {"wq": wq, "wk": wk, "wv": wv, "wo": wo, "gate": gate}
        if mode == "decode":
            y, _ = L.cross_attention(cfg, pp, h, None,
                                     cache={"k": rest[0], "v": rest[1]},
                                     mode=mode, q_head0=q0, kv_head0=kv0,
                                     cast=False, esplit=es)
            return (y,)
        y, kv = L.cross_attention(cfg, pp, h, rest[0], mode=mode,
                                  q_head0=q0, kv_head0=kv0, cast=False,
                                  esplit=es)
        return (y,) if kv is None else (y, kv["k"], kv["v"])

    res = run_local(local, args, outs, kd)
    if mode == "decode":
        return res[0], cache
    return res[0], ({"k": res[1], "v": res[2]} if mode == "prefill"
                    else None)


def _mlp(cfg, norm, p, x, norm_name="mlp_norm"):
    w, kd, es, split = _weights(p, ("w_gate", "w_up", "w_down"), x)
    s = gather(norm, norm_name, kd)

    def local(xl, sl, wg, wu, wd):
        h = L.rms_norm(xl, sl, cfg.norm_eps, es)
        return (L.mlp(cfg, {"w_gate": wg, "w_up": wu, "w_down": wd}, h,
                      cast=False, esplit=es),)

    return run_local(local, [x, s, w["w_gate"], w["w_up"], w["w_down"]],
                     [_sum_out(x, split)], kd)[0]


def _moe_shard_map_dims(cfg, x):
    """The model mesh dims of ``moe_ffn_shard_map``'s group-local routing
    (the batch split over the context's batch axes), or None where the
    JAX package falls back to ``moe_ffn`` (no context, no "mlp" entry, the
    batch not split so, or d_ff not divisible by the model ways)."""
    from repro_torch.models.act_shard import current_mapping
    mapping = current_mapping()
    if cfg.moe_impl != "shard_map" or not mapping or "mlp" not in mapping:
        return None
    names = list(x.device_mesh.mesh_dim_names)
    bdims = [names.index(n) for n, _ in mapping.get("batch", ())
             if n in names]
    mdims = [names.index(n) for n, _ in mapping["mlp"] if n in names]
    ways = 1
    for m in mdims:
        ways *= x.device_mesh.size(m)
    batch_ok = all(_batch_split(x, m) for m in bdims) and all(
        not _batch_split(x, m) for m in range(len(names)) if m not in bdims)
    if not mdims or not batch_ok or cfg.d_ff % ways:
        return None
    return mdims


def _moe(cfg, norm, p, x):
    """The MoE FFN's output (f32), placed as x.  ``moe_impl="shard_map"``
    (with the context it needs): group-local routing of each data shard's
    tokens through f-slices of every expert (the weights redistributed to
    split d_ff over the model axes), one Partial sum.  Else the JAX
    package's global routing (``_moe_global``); the dense residual is a
    ``_mlp`` of its own."""
    DTensor, Partial, Replicate, Shard = _dt()
    mesh = x.device_mesh
    mdims = _moe_shard_map_dims(cfg, x)
    if mdims is not None:
        s = gather(norm, "mlp_norm")
        router = p["router"].redistribute(mesh, _replicated(x))

        def fsplit(t, dim):
            return t.redistribute(mesh, [Shard(dim) if m in mdims
                                         else Replicate()
                                         for m in range(mesh.ndim)])
        w = [fsplit(p["we_gate"], -1), fsplit(p["we_up"], -1),
             fsplit(p["we_down"], -2)]
        if cfg.dense_residual:
            d = p["dense"]
            w += [fsplit(d["w_gate"], -1), fsplit(d["w_up"], -1),
                  fsplit(d["w_down"], -2)]

        def local(xl, sl, rl, wg, wu, wd, *dense):
            h = L.rms_norm(xl, sl, cfg.norm_eps)
            y = L._moe_route_compute(cfg, {"router": rl, "we_gate": wg,
                                           "we_up": wu, "we_down": wd}, h)
            if dense:
                y = y + L._mlp_partial(cfg, dict(zip(
                    ("w_gate", "w_up", "w_down"), dense)), h)
            return (y,)
        return run_local(local, [x, s, router] + w,
                         [_sum_out(x, set(mdims))])[0]

    y = _moe_global(cfg, norm, p, x)
    if cfg.dense_residual:          # mlp's output in x's dtype, then f32
        y = y + _mlp(cfg, norm, p["dense"], x).redistribute(
            mesh, x.placements).to(x.dtype).to(torch.float32)
    return y


def _moe_global(cfg, norm, p, x):
    """The JAX package's global routing on a mesh, with the products of
    its partitioned program: each data rank routes its own tokens (the
    norm and the router on whole rows of d, the experts over the model
    axes), every rank's top-k choices reach every rank exactly (zeros
    filled around them, one all-reduce), and every rank sorts the same
    token-slots (``layers.route_of``), so the kept slots are the unsharded
    route's.  The tokens go by one all-to-all into an (E_local, C, d/data)
    dispatch: the experts keep the FSDP split of "embed", gate and up sum
    their partial products over data before the SiLU, down writes the
    rank's columns.  The combine adds each token's k values onto a zero
    row (exact at k = 2), the partial sums over the model axes are summed
    by one all-reduce, and the result returns to x's split by one
    all-to-all (where x splits the batch) or as it is (where x splits d).
    Another layout (a batch or d split over several mesh axes, or tokens
    that do not divide) rejoins the tokens on every rank and slices d
    locally."""
    _, Partial, Replicate, Shard = _dt()
    mesh = x.device_mesh
    n = mesh.ndim
    b, s, d = x.shape
    t = b * s
    kd = embed_dims(x)
    bd = {m for m in range(n) if _batch_split(x, m)}
    we = [p[k] for k in ("we_gate", "we_up", "we_down")]
    ed = _embed_splits(we[0], "we_gate")
    w = [gather(wt, k, ed) for wt, k in zip(we, ("we_gate", "we_up",
                                                  "we_down"))]
    md = set().union(*(_shard_dims(wt) for wt in w)) - ed
    e0 = shard_offset(w[0], -3)
    es = _embed_split(x, ed)
    m0 = next(iter(ed)) if len(ed) == 1 else None
    if m0 is not None and not kd and bd == ed:
        how = "batch"                  # x splits the batch: its own rows
    elif m0 is not None and not bd and kd == ed and t % mesh.size(m0) == 0:
        how = "d"                      # x splits d: rows by an all-to-all
    else:
        how, m0 = "rejoin", None
    td = {m0} if m0 is not None else set()

    def pl(tok=None, col=None, model=None):
        """Placements: Shard(tok) over td, Shard(col) over ed, ``model``
        over md, Replicate elsewhere."""
        out = []
        for m in range(n):
            if tok is not None and m in td:
                out.append(Shard(tok))
            elif col is not None and m in ed:
                out.append(Shard(col))
            elif model is not None and m in md:
                out.append(model)
            else:
                out.append(Replicate())
        return tuple(out)

    # 1. each data rank's tokens, whole rows of d
    if how == "batch":
        rows = run_local(lambda xl: (xl.reshape(-1, d),), [x], [pl(tok=0)])[0]
    elif how == "d":
        rows = run_local(lambda xl: (_AllToAll.apply(
            xl.reshape(t, -1), mesh, m0, 0, 1),), [x], [pl(tok=0)])[0]
    else:
        xr = _rejoin(x, -1, kd)
        if bd:
            xr = xr.redistribute(mesh, [Replicate() if m in bd else q
                                        for m, q in enumerate(xr.placements)])
        rows = run_local(lambda xl: (xl.reshape(t, d),), [xr], [pl()])[0]
    # 2. the norm and the router on whole rows, the experts over the model
    scale = _rejoin(norm, -1, _embed_splits(norm, "mlp_norm"))
    router = _rejoin(p["router"], -2, _embed_splits(p["router"], "router"))
    h = run_local(lambda rl, sl: (L.rms_norm(rl, sl, cfg.norm_eps),),
                  [rows, scale], [pl(tok=0)])[0]
    rdims = _shard_dims(router)
    lg = run_local(lambda hl, rl: (L.router_logits(cfg, {"router": rl}, hl),),
                   [h, router], [tuple(Shard(1) if m in rdims else q
                                       for m, q in enumerate(pl(tok=0)))])[0]
    lg = _rejoin(lg, 1, rdims)

    # 3. each token's choices, rejoined exactly on every rank
    def choose(ll):
        probs, eidx, gate = L.choose_experts(cfg, ll)
        return (torch.cat([eidx.to(torch.float32), gate, ll, probs], 1),)
    table = _rejoin(run_local(choose, [lg], [pl(tok=0)])[0], 0, td)
    k, e = cfg.top_k, cfg.num_experts
    # 4. the dispatch's rows: every token, the rank's columns of d
    if how == "rejoin":
        xd = h.redistribute(mesh, pl(col=1))
    else:
        xd = run_local(lambda hl: (_AllToAll.apply(hl, mesh, m0, 1, 0),),
                       [h], [pl(col=1)])[0]

    # 5. the experts and the combine: partial over md
    def experts(xl, tab, wg, wu, wd):
        r = L.route_of(cfg, tab[:, 2 * k:2 * k + e], tab[:, 2 * k + e:],
                       tab[:, :k].to(torch.int64), tab[:, k:2 * k])
        pp = {"we_gate": wg, "we_up": wu, "we_down": wd}
        return (L.moe_experts(cfg, pp, xl, r, e0, es),)
    y = run_local(experts, [xd, table] + w, [pl(col=1, model=Partial())],
                  ed)[0]
    y = y.redistribute(mesh, pl(col=1))        # the sum over the experts
    # 6. back to x's split
    if how == "batch":
        return run_local(lambda yl: (_AllToAll.apply(
            yl, mesh, m0, 0, 1).reshape(-1, s, d),), [y], [x.placements])[0]
    y = run_local(lambda yl: (yl.reshape(b, s, -1),), [y],
                  [tuple(Shard(2) if m in ed else Replicate()
                         for m in range(n))])[0]
    return y.redistribute(mesh, x.placements)


def _rglru(cfg, norm, p, x, *, cache, mode):
    """The RG-LRU in two local halves: the gates' pre-activations u·w_a
    and u·w_i, partial over the rnn split, are summed and split again by
    one reduce-scatter before the sigmoids."""
    names = ("w_x", "w_y", "conv", "w_a", "w_i", "lam", "w_out")
    w, kd, es, split = _weights(p, names, x)
    s = gather(norm, "norm", kd)
    u_out = _split_out(x, w["w_x"], -1, 2)
    gate_sum = _sum_out(x, _shard_dims(w["w_a"]), d_out=False)
    conv_out = _split_out(x, w["conv"], -1, 2)
    lru_out = _split_out(x, w["lam"], -1, 1)
    args = [x, s, w["w_x"], w["w_y"], w["conv"], w["w_a"], w["w_i"]]
    if mode == "decode":
        _check_cache("conv_state", cache["conv_state"], conv_out)
        _check_cache("lru", cache["lru"], lru_out)
        args.append(cache["conv_state"])

    def first(xl, sl, wx, wy, conv, wa, wi, *state):
        h = L.rms_norm(xl, sl, cfg.norm_eps, es)
        pp = {"w_x": wx, "w_y": wy, "conv": conv, "w_a": wa, "w_i": wi}
        return L.rglru_in(cfg, pp, h, state[0] if state else None, es)

    u, gb, new_conv, ra, ia = run_local(
        first, args, [u_out, u_out, conv_out, gate_sum, gate_sum], kd)
    ra = ra.redistribute(x.device_mesh, u_out)
    ia = ia.redistribute(x.device_mesh, u_out)
    args = [u, gb, ra, ia, w["lam"], w["w_out"], new_conv]
    if mode == "decode":
        args += [cache["lru"], cache["conv_state"]]

    def second(ul, gl, ral, ial, lam, wout, conv_new, *state):
        y, new_h = L.rglru_out(cfg, {"lam": lam, "w_out": wout}, ul, gl,
                               ral, ial, state[0] if state else None, mode,
                               es)
        if state:                 # decode: the state written in place
            state[0].copy_(new_h)
            state[1].copy_(conv_new)
        return y, new_h

    y, new_h = run_local(second, args, [_sum_out(x, split), lru_out], kd)
    if mode == "train":
        return y, None
    if mode == "decode":
        return y, cache
    return y, {"lru": new_h, "conv_state": new_conv}


def _xlstm(cfg, kind, norm, p, x, *, cache, mode):
    if kind == "mlstm":
        names, hw, hdim = ("wq", "wk", "wv", "wi", "wf", "wo"), "wq", -2
        state = ("mC", "mn", "mm")
        block = L.mlstm_block
    else:
        names, hw, hdim = ("wx", "r", "wo"), "wx", -2
        state = ("sc", "sn", "sh", "sm")
        block = L.slstm_block
    w, kd, es, split = _weights(p, names, x)
    s = gather(norm, "norm", kd)
    st_out = _split_out(x, w[hw], hdim, 1)
    args = [x, s] + [w[k] for k in names]
    if mode == "decode":
        for n in state:
            _check_cache(n, cache[n], st_out)
        args += [cache[n] for n in state]

    def local(xl, sl, *rest):
        h = L.rms_norm(xl, sl, cfg.norm_eps, es)
        pp = dict(zip(names, rest[:len(names)]))
        c = dict(zip(state, rest[len(names):])) or None
        y, nc = block(cfg, pp, h, cache=c, mode=mode, cast=False, esplit=es)
        return (y,) if nc is None else (y,) + tuple(nc[n] for n in state)

    outs = [_sum_out(x, split)] + ([st_out] * len(state)
                                   if mode != "train" else [])
    res = run_local(local, args, outs, kd)
    if mode == "train":
        return res[0], None
    return res[0], dict(zip(state, res[1:]))


def apply_block(cfg: ModelConfig, kind: str, p, x, *, positions,
                cache: Optional[Dict[str, Any]], aux=None, mode: str,
                cache_len: Optional[int] = None):
    """``blocks.apply_block`` on a mesh: each sublayer in its own
    ``local_map``, its partial output summed into the stream."""
    _check_stream(x)
    new_cache: Dict[str, Any] = {}
    if kind in _CELL_KINDS:
        c = None if cache is None else cache["cell"]
        if kind == "rglru":
            y, cc = _rglru(cfg, p["norm"], p["cell"], x, cache=c, mode=mode)
        else:
            y, cc = _xlstm(cfg, kind, p["norm"], p["cell"], x, cache=c,
                           mode=mode)
        x = residual(x, y)
        if cc is not None:
            new_cache["cell"] = cc
    else:
        y, kv = _attention(cfg, kind, p["attn_norm"], p["attn"], x,
                           positions=positions,
                           cache=None if cache is None else cache["attn"],
                           mode=mode, cache_len=cache_len)
        x = residual(x, y)
        if kv is not None:
            new_cache["attn"] = kv
        if kind in _CROSS:
            y, xc = _cross_attention(
                cfg, p["x_norm"], p["xattn"], x, aux,
                cache=None if cache is None else cache["xattn"], mode=mode)
            x = residual(x, y)
            if xc is not None:
                new_cache["xattn"] = xc
    if cfg.d_ff:
        if cfg.num_experts and kind not in _CELL_KINDS:
            x = residual(x, _moe(cfg, p["mlp_norm"], p["mlp"], x))
        else:
            x = residual(x, _mlp(cfg, p["mlp_norm"], p["mlp"], x))
    return x, (new_cache or None)


# ---------------------------------------------------------------------------
# embedding, logits, loss
# ---------------------------------------------------------------------------
def _as_dtensor(t, like):
    """A plain tensor every rank holds whole, as a replicated DTensor on
    ``like``'s mesh."""
    if is_dtensor(t):
        return t
    DTensor, _, Replicate, _ = _dt()
    mesh = like.device_mesh
    return DTensor.from_local(t.to(like.device), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def embed(cfg: ModelConfig, emb, tokens):
    """The embedding lookup with the vocab split kept: each rank looks up
    the tokens in its rows (zero elsewhere), one all-reduce sums them, the
    sum is cast to the compute dtype."""
    _, Partial, Replicate, Shard = _dt()
    tokens = _as_dtensor(tokens, emb)
    # the "embed" split kept where the tokens do not split the batch
    kd = frozenset(m for m in _embed_splits(emb, "embedding")
                   if not _batch_split(tokens, m))
    e = gather(emb, "embedding", kd)
    v0 = shard_offset(e, 0)

    def local(tok, el):
        t = tok.to(torch.int64)
        if el.shape[0] == cfg.padded_vocab:
            return (el[t],)
        r = t - v0
        inside = (r >= 0) & (r < el.shape[0])
        rows = el[r.clamp(0, el.shape[0] - 1)]
        return (torch.where(inside[..., None], rows, 0.0),)

    mesh = e.device_mesh
    split = _shard_dims(e) - kd
    out = tuple(Shard(0) if _batch_split(tokens, m) else Shard(2) if m in kd
                else Partial() if m in split else Replicate()
                for m in range(mesh.ndim))
    x = run_local(local, [tokens, e], [out])[0]
    stream = tuple(Shard(0) if _batch_split(tokens, m)
                   else Shard(2) if m in kd else Replicate()
                   for m in range(mesh.ndim))
    return x.redistribute(mesh, stream).to(L._cdtype(cfg))


def logits(cfg: ModelConfig, w, h, tied: bool):
    """(…, d) -> (…, padded_vocab) f32 with the vocab split kept (w the
    embedding, or ``out_proj`` when not ``tied``), padding columns of this
    rank's slice at -1e30.  Where h splits d, each rank's product is a
    partial sum over its columns, summed by one all-reduce before the
    padding is added."""
    _, Partial, Replicate, Shard = _dt()
    kd = embed_dims(h)
    name, vdim = ("embedding", 0) if tied else ("out_proj", 1)
    wg = gather(w, name, kd)
    v0 = shard_offset(wg, vdim)
    cd = L._cdtype(cfg)

    def product(hl, wl):
        wv = wl if tied else wl.T                        # (V, d)
        return L.project(hl.to(cd), wv.to(cd).T, torch.float32)

    def pad(out):
        cols = torch.arange(v0, v0 + out.shape[-1], device=out.device)
        return out + torch.where(cols < cfg.vocab, 0.0, -1e30)

    vsplit = _shard_dims(wg) - kd
    out = tuple(Shard(0) if _batch_split(h, m)
                else Shard(h.ndim - 1) if m in vsplit else Replicate()
                for m in range(h.device_mesh.ndim))
    if not kd:
        return run_local(lambda hl, wl: (pad(product(hl, wl)),), [h, wg],
                         [out])[0]
    part = tuple(Partial() if m in kd else p for m, p in enumerate(out))
    y = run_local(lambda hl, wl: (product(hl, wl),), [h, wg], [part])[0]
    return run_local(lambda yl: (pad(yl),),
                     [y.redistribute(h.device_mesh, out)], [out])[0]


def ce_parts(logits_, labels):
    """(logz, gold) of each row of vocab-split logits: the row max, the sum
    of exp(l - max) and the gold logit each a rank's partial (max or sum)
    over its vocab slice, summed across the split by one all-reduce each;
    the same ops as ``decoder._ce_parts`` on one rank."""
    DTensor, Partial, Replicate, Shard = _dt()
    mesh = logits_.device_mesh
    v0 = shard_offset(logits_, -1)
    vsplit = {m for m, p in enumerate(logits_.placements)
              if isinstance(p, Shard) and p.dim % logits_.ndim
              == logits_.ndim - 1}
    rows = tuple(Shard(0) if _batch_split(logits_, m) else Replicate()
                 for m in range(mesh.ndim))

    def part(kind):
        return tuple(Shard(0) if _batch_split(logits_, m)
                     else Partial(kind) if m in vsplit else Replicate()
                     for m in range(mesh.ndim))

    from repro_torch.models.decoder import _gold, _row_max, _row_sumexp
    m = run_local(lambda l: (_row_max(l),), [logits_], [part("max")])[0]
    m = m.redistribute(mesh, rows)
    se = run_local(lambda l, ml: (_row_sumexp(l, ml),), [logits_, m],
                   [part("sum")])[0].redistribute(mesh, rows)
    gold = run_local(lambda l, lab: (_gold(l, lab, v0),), [logits_, labels],
                     [part("sum")])[0].redistribute(mesh, rows)
    return torch.log(se) + m, gold


def rows_like(t, h):
    """``t`` (a batch's labels: a DTensor, or a plain tensor every rank
    holds whole) with its batch split as ``h``'s and replicated
    elsewhere."""
    _, _, Replicate, Shard = _dt()
    t = _as_dtensor(t, h)
    return t.redistribute(h.device_mesh, [
        Shard(0) if _batch_split(h, m) else Replicate()
        for m in range(h.device_mesh.ndim)])


def total(t):
    """The sum of every element of a batch-split DTensor, replicated."""
    _, _, Replicate, _ = _dt()
    return t.sum().redistribute(t.device_mesh,
                                [Replicate()] * t.device_mesh.ndim)


__all__ = ["KEEP", "apply_block", "ce_parts", "embed", "embed_dims",
           "gather", "is_dtensor", "local_of", "logits", "residual",
           "rms_norm", "rows_like", "run_local", "shard_offset",
           "sum_over_shards", "total"]
