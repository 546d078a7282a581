"""Multi-pod dry run: every (arch × shape × mesh) cell's step traced with
fake tensors over a fake process group, and its roofline terms recorded,
the counterpart of the JAX package's ``repro/launch/dryrun.py``.

The JAX package lowers and compiles each cell with ``ShapeDtypeStruct``
inputs over 512 forced host devices and reads the partitioned HLO.
PyTorch has no HLO, so the port runs its real steps (``make_train_step``,
``make_prefill_step``, ``make_decode_step``) on the production mesh
without allocating anything:

* a ``"fake"`` process group of 256 (16 × 16) or 512 (2 × 16 × 16) ranks
  (``torch.testing._internal.distributed.fake_pg``; this process is rank
  0), on which ``launch/mesh.make_production_mesh`` builds the mesh and
  every collective returns at once;
* ``FakeTensorMode``: the state, batch and cache are fake tensors of the
  global shapes (``configs.input_specs``, ``init_train_state``,
  ``decoder.init_params``), placed by ``distribute_tree`` under the rule
  tables, so each rank's local shards have their real shapes;
* ``layers.card_route()``: the layers take the card's route whatever the
  device (bf16 products with an f32 output, every expert's product), so
  a record on ``"cpu"`` is the card's; kernels 12 and 12b are operators
  with fake implementations and FLOP formulas
  (``kernels/flash_attention/ops.py``);
* counters below DTensor's dispatch (``hlo_flops.DotFlops``,
  ``hlo_analysis.CollectiveBytes``, ``PeakBytes``), which see one rank's
  local products, collectives and allocations.

The record has the JAX package's keys.  ``lower_s`` is the fake run's
seconds.  ``compile_s``, ``cost_analysis`` and ``memory.
generated_code_bytes`` are null: nothing is compiled.  ``flops`` is the
products' FLOPs (``dot_flops_per_chip``; XLA's cost analysis also counts
elementwise ops, without trip counts) and ``bytes_accessed`` each local
op's tensor inputs and outputs once (views and collectives excluded).
``memory.temp_bytes`` is the step's peak above its arguments on this
rank (the storages it allocates alive at once, ``PeakBytes``),
``argument_bytes`` the arguments' local bytes and ``output_bytes``
the outputs' (the train step updates its state in place and returns
it).  ``num_while_loops`` and ``max_trip_count`` are 0: the port's loops
are Python loops, counted in full (``hlo_analysis``).  ``model_params``
and ``model_active_params`` are ``ModelConfig.num_params()`` and
``num_active_params()``, as the JAX package records them (the leaves hold
``num_params() + uncounted_params()``); ``state_bytes_global`` sums the
fake leaves.  Extra keys: ``dot_flops_attention_per_chip`` (kernels 12
and 12b alone), ``dot_flops_by_op``, ``collective_counts_per_chip``,
``leaf_params`` (the
parameter leaves' own count) and ``local_shapes`` (each leaf's local
shape, by path).

Records go to ``artifacts/dryrun_torch/``.  A ``--device cuda`` run needs
a card (fake CUDA tensors need PyTorch built with CUDA).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multi-pod] [--device cpu] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_is_supported)
from repro_torch.launch import sharding as sh
from repro_torch.launch.hlo_analysis import CollectiveBytes
from repro_torch.launch.hlo_flops import DotFlops, in_shape_propagation
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import SERVE_RULES, TRAIN_RULES
from repro_torch.models import decoder
from repro_torch.models.act_shard import (activation_sharding,
                                          mapping_from_mesh)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import card_route
from repro_torch.models.partitioning import (batch_axes, cache_axes,
                                             param_axes)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import (init_train_state, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     train_state_axes)

OUT_DIR = os.path.join("artifacts", "dryrun_torch")


def _cfg_overrides(cfg: ModelConfig, overrides: Optional[Dict[str, Any]]
                   ) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _with_overrides(rules, rule_overrides):
    if not rule_overrides:
        return rules
    return dict(rules, **{k: tuple(v) if isinstance(v, list) else v
                          for k, v in rule_overrides.items()})


def leaves(tree: Any, path: str = ""):
    """(path, leaf) of every tensor of nested dicts (keys sorted) and
    dataclasses (fields in order), as ``jax.tree_util`` flattens them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{path}/{f.name}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaves(t, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _fake_like(tree, device):
    """``meta`` stand-ins (``input_specs``) as zero tensors of the same
    shapes and dtypes on ``device`` (fake under FakeTensorMode)."""
    return sh._map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                         device=device), tree)


def _place(tree, axes, mesh, rules):
    return sh.distribute_tree(tree, sh.resolve_tree(tree, axes, mesh, rules),
                              mesh)


class PeakBytes:
    """A dispatch mode that follows the storages the ops create while it is
    entered: each new storage's bytes from its creation until it is freed
    (a weak reference's callback), and their peak; the storages of
    ``known`` tensors are not new, and DTensor's own shape computations
    (``hlo_flops.in_shape_propagation``) are no rank's.  Sizes are the
    storages' own, unrounded, so that a record does not depend on the
    device (the card's caching allocator rounds to 512-byte blocks)."""

    def __init__(self, known=()):
        import weakref
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self
        self.live = self.peak = 0
        #: storage -> its weak reference; ``known`` tensors' storages (the
        #: arguments, which in-place ops return) are not counted
        self.refs = {t.untyped_storage()._cdata: None for t in known}

        def track(t) -> None:
            st = t.untyped_storage()
            key = st._cdata
            if key in outer.refs:
                return
            n = st.nbytes()

            def freed(_, key=key, n=n):
                outer.refs.pop(key, None)
                outer.live -= n
            outer.refs[key] = weakref.ref(st, freed)
            outer.live += n
            outer.peak = max(outer.peak, outer.live)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if func.is_view or in_shape_propagation():
                    return out              # a storage already followed
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    if isinstance(t, torch.Tensor):
                        track(t)
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _peak_above(fn, args) -> tuple:
    """(fn's outputs, the peak bytes of the storages fn allocates on this
    rank while it runs, the arguments' local bytes)."""
    arg_leaves = [_local(t) for _, t in leaves(args)]
    with PeakBytes(arg_leaves) as pb:
        out = fn()
    arg_bytes = sum(_nbytes(t) for t in {
        t.untyped_storage()._cdata: t for t in arg_leaves}.values())
    return out, int(pb.peak), arg_bytes


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules_train=TRAIN_RULES, rules_serve=SERVE_RULES,
               fake: bool = True) -> Dict[str, Any]:
    """The analyses of one cell's step on ``mesh`` (any ``DeviceMesh``
    over a started process group), the record's keys but arch, shape,
    mesh and status.  The state, batch and cache are built as global
    tensors on the mesh's device and placed by ``distribute_tree``; with
    ``fake`` (the dry run) under FakeTensorMode and ``card_route()``,
    else real (params from seed 0, zero batch and cache) on the route of
    their device, so that a real process group's run of the same step can
    be held against the dry run's counts."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = None if fake else torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    rules = rules_train if shape.kind == "train" else rules_serve
    with contextlib.ExitStack() as stack:
        if fake:
            stack.enter_context(FakeTensorMode())
            stack.enter_context(card_route())
        specs = _fake_like(input_specs(cfg, shape), dev)
        if shape.kind == "train":
            opt_cfg = AdamWConfig(state_dtype=cfg.adam_dtype)
            glob = init_train_state(gen, cfg, opt_cfg, device=dev)
            glob_params = glob.params
            state = _place(glob, train_state_axes(glob), mesh, rules)
            batch = _place(specs, batch_axes(specs), mesh, rules)
            step = make_train_step(cfg, opt_cfg)
            named = {"state": state, "batch": batch}
            args = (state, batch)
        else:
            glob = glob_params = decoder.init_params(cfg, gen, dev)
            state = _place(glob, param_axes(glob), mesh, rules)
            if shape.kind == "prefill":
                batch = _place(specs, batch_axes(specs), mesh, rules)
                step = make_prefill_step(cfg)
                named = {"state": state, "batch": batch}
                args = (state, batch)
            else:
                cache = _place(specs["cache"], cache_axes(specs["cache"]),
                               mesh, rules)
                tok = _place({"token": specs["token"]},
                             batch_axes({"token": specs["token"]}), mesh,
                             rules)["token"]
                step = make_decode_step(cfg)
                named = {"state": state, "cache": cache, "token": tok}
                args = (state, cache, tok, specs["pos"])
        n_state_bytes = sum(_nbytes(t) for _, t in leaves(glob))
        n_leaf_params = sum(t.numel() for _, t in leaves(glob_params))
        del glob, glob_params
        local_shapes = {f"{name}{p}": list(_local(t).shape)
                        for name, tree in named.items()
                        for p, t in leaves(tree)}
        with activation_sharding(mapping_from_mesh(mesh, rules), mesh), \
                DotFlops() as dots, CollectiveBytes() as coll:
            out, temp_bytes, arg_bytes = _peak_above(lambda: step(*args),
                                                     args)
        out_bytes = sum(_nbytes(_local(t)) for _, t in leaves(out))
    lower_s = time.perf_counter() - t0
    chips = int(mesh.size())
    return dict(
        chips=chips,
        lower_s=round(lower_s, 2),
        compile_s=None,
        flops=float(dots.flops),
        bytes_accessed=float(dots.bytes_accessed),
        cost_analysis=None,
        memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                    temp_bytes=temp_bytes, generated_code_bytes=None),
        collective_bytes_per_chip=coll.totals(),
        collective_counts_per_chip=dict(coll.counts),
        dot_flops_per_chip=float(dots.flops),
        dot_bytes_per_chip=float(dots.dot_bytes),
        dot_flops_attention_per_chip=float(dots.attention_flops),
        dot_flops_by_op={k: v[1] for k, v in sorted(dots.by_op.items())},
        num_dots=dots.num_dots,
        num_while_loops=0,
        max_trip_count=0,
        state_bytes_global=n_state_bytes,
        state_bytes_per_chip=n_state_bytes / chips,
        leaf_params=n_leaf_params,
        model_params=cfg.num_params(),
        model_active_params=cfg.num_active_params(),
        local_shapes=local_shapes,
    )


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None,
               rules_train=TRAIN_RULES, rules_serve=SERVE_RULES,
               rule_overrides: Optional[Dict[str, Any]] = None,
               device=None) -> Dict[str, Any]:
    """Trace one cell on the production mesh over a fake process group of
    256 or 512 ranks (this process rank 0) on ``device`` (the card unless
    ``"cpu"``); return the §Dry-run/§Roofline record."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = _cfg_overrides(get_config(arch), overrides)
    rules_train = _with_overrides(rules_train, rule_overrides)
    rules_serve = _with_overrides(rules_serve, rule_overrides)
    shape = SHAPES[shape_name]
    record: Dict[str, Any] = dict(arch=arch, shape=shape_name,
                                  mesh="2x16x16" if multi_pod else "16x16")
    reason = shape_is_supported(cfg, shape)
    if reason is not None:
        record.update(status="skipped", reason=reason)
        return record
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device="cuda" if device is None
                                    else str(device))
        record.update(status="ok", **trace_step(cfg, shape, mesh,
                                                rules_train, rules_serve))
    finally:
        dist.destroy_process_group()
    return record


def cell_name(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    tagpart = f".{tag}" if tag else ""
    return f"{arch}.{shape}.{'pod2' if multi_pod else 'pod1'}{tagpart}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch, shape) for both meshes")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    ap.add_argument("--rule-overrides", default=None,
                    help="JSON dict of sharding-rule overrides (perf exps)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (cuda needs a card)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.overrides) if args.overrides else None
    rule_overrides = (json.loads(args.rule_overrides)
                      if args.rule_overrides else None)
    if args.all:
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES
                 for mp in (False, True)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape, args.multi_pod)]

    for arch, shape, mp in cells:
        name = cell_name(arch, shape, mp, args.tag)
        path = os.path.join(args.out, name)
        if os.path.exists(path) and args.all:
            print(f"[skip existing] {name}")
            continue
        print(f"[dryrun] {arch} × {shape} × "
              f"{'2x16x16' if mp else '16x16'} ...", flush=True)
        try:
            rec = lower_cell(arch, shape, mp, overrides,
                             rule_overrides=rule_overrides,
                             device=args.device)
        except Exception as e:
            rec = dict(arch=arch, shape=shape,
                       mesh="2x16x16" if mp else "16x16",
                       status="error", error=str(e),
                       traceback=traceback.format_exc())
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        extra = ""
        if rec["status"] == "ok":
            extra = (f" dot_flops/chip={rec['dot_flops_per_chip']:.3e}"
                     f" coll/chip={rec['collective_bytes_per_chip']['total']:.3e}B"
                     f" temp={rec['memory']['temp_bytes']:.3e}B"
                     f" lower={rec['lower_s']}s")
        print(f"[{rec['status']}] {name}{extra}", flush=True)


if __name__ == "__main__":
    main()
