"""Repairs of the port against the JAX package: the tiled scan for keyed
custom statistics and groups with keyed or custom members, the public
signatures in the JAX package's order, and the rules a mesh is held to.

The tiled scan (``fused_poisson_tiled``) runs on the CPU here, against
the JAX package's ``fused_poisson_tiled`` and ``backend="scan"``: w_tot
bitwise, dots within 1e-5·Σw|x| per entry.  Its card run (kernel 1 from
an n-tile offset) is held in tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ft as jft
import repro_torch.core as tcore
import repro_torch.ft as tft
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import GroupedStatistic as JGrouped
from repro.core import MomentState as JMomentState
from repro.core import Statistic as JStatistic
from repro.kernels.fused_multi import ops as jfm
from repro.kernels.weighted_stats import ops as jws
from repro_torch.core import (EarlSession, GroupedStatistic, MomentState,
                              PoissonDelta, Statistic, poisson_weights)
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.core.bootstrap import fused_resample_states
from repro_torch.kernels.fused_multi.ops import fused_poisson_tiled
from repro_torch.kernels.poisson_counts.ops import poisson_tiles
from repro_torch.kernels.poisson_counts.ref import (weight_block,
                                                    weight_tile_blocks)
from repro_torch import random as trandom

torch.set_num_threads(1)
# the packages' ``core.ssabe`` attribute is the function, not the module
jssabe = importlib.import_module("repro.core.ssabe")
tssabe = importlib.import_module("repro_torch.core.ssabe")
#: the training slice's modules, JAX package and port
TRAINING = [(importlib.import_module(f"repro.{m}"),
             importlib.import_module(f"repro_torch.{m}"), names)
            for m, names in (
                ("optim.adamw", ("adamw_init", "adamw_update",
                                 "AdamWConfig", "opt_state_axes")),
                ("optim.adaptive_accum", ("gradient_cv",
                                          "earl_accumulate_gradients")),
                ("optim.compression", ("error_feedback_compress",)),
                ("data.pipeline", ("TokenBatchPipeline",)),
                ("train.steps", ("init_train_state", "make_train_step",
                                 "make_grad_step", "train_state_axes")),
                ("models.partitioning", ("param_axes",)),
                ("models.act_shard", ("hint",)),
                ("launch.sharding", ("resolve_spec", "resolve_tree")),
                ("launch.mesh", ("make_production_mesh",)),
                ("configs", ("input_specs",)))]

G, SEED = 3, 77


class _AbsSum(Statistic):
    """A user statistic with its own vectorized tile math: Σw and Σw|x|."""

    def init_state(self, dim, device="cpu"):
        z = torch.zeros(dim, device=device)
        return MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

    def update(self, state, values, weights=None):
        x = values.to(torch.float32)
        w = torch.ones(x.shape[0], device=x.device) if weights is None \
            else weights
        return MomentState(w=state.w + w.sum(), s1=state.s1 + w @ x.abs(),
                           s2=state.s2)

    def tile_update(self, states, x_tile, w_tile):
        return MomentState(w=states.w + w_tile.sum(dim=1),
                           s1=states.s1 + w_tile @ x_tile.abs(),
                           s2=states.s2)

    def finalize(self, state):
        return state.s1 / torch.clamp_min(state.w.unsqueeze(-1), 1.0)


class _JAbsSum(JStatistic):
    """``_AbsSum`` in the JAX package (the default vmapped tile update)."""

    def init_state(self, dim):
        z = jnp.zeros((dim,), jnp.float32)
        return JMomentState(w=jnp.zeros((), jnp.float32), s1=z, s2=z)

    def update(self, state, values, weights=None):
        x = jnp.asarray(values, jnp.float32)
        w = jnp.ones(x.shape[0]) if weights is None else weights
        return JMomentState(w=state.w + jnp.sum(w),
                            s1=state.s1 + w @ jnp.abs(x), s2=state.s2)

    def finalize(self, state):
        return state.s1 / jnp.maximum(state.w[..., None], 1.0)


def _keyed(n, d, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    gid = rng.integers(0, G, size=n).astype(np.float32)
    return np.concatenate([x, gid[:, None]], axis=1), x, gid


@pytest.mark.parametrize("B,n,d,n_valid,hole", [
    (8, 300, 1, None, False), (32, 1700, 2, 1650, True),
    (130, 700, 1, None, True)])
def test_tiled_scan_of_a_keyed_custom_statistic_matches_jax(B, n, d,
                                                            n_valid, hole):
    vals, x, gid = _keyed(n, d)
    mask = None
    if hole:
        mask = (np.random.default_rng(9).random(n) > 0.25).astype(np.float32)
    got = fused_resample_states(
        GroupedStatistic(_AbsSum(), G), SEED, torch.from_numpy(vals), B,
        n_valid=n_valid, valid_mask=None if mask is None
        else torch.from_numpy(mask))
    want = jfm.fused_poisson_tiled(
        JGrouped(_JAbsSum(), G, backend="scan"), SEED, jnp.asarray(vals), B,
        n_valid=n_valid, valid_mask=None if mask is None
        else jnp.asarray(mask))
    w = np.asarray(jws.implicit_weights(SEED, B, n), np.float64)
    w[:, (n if n_valid is None else n_valid):] = 0.0
    if mask is not None:
        w *= mask[None, :]
    keys = (gid[None, :] == np.arange(G)[:, None]).astype(np.float64)
    bound = np.einsum("bn,gn,nd->bgd", w, keys, np.abs(x.astype(np.float64)))
    assert got.w.shape == (B, G) and got.s1.shape == (B, G, d)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    assert np.all(np.abs(got.s1.numpy() - np.asarray(want.s1))
                  <= 1e-5 * bound)


def test_tiled_scan_feeds_every_weight_once():
    """Σw from the tiled scan is the total of the implicit weight matrix:
    every tile is drawn once, none is skipped or repeated."""
    vals, _, _ = _keyed(2000, 1)
    st = fused_poisson_tiled(_AbsSum(), SEED, torch.from_numpy(vals), 16)
    w = np.asarray(jws.implicit_weights(SEED, 16, 2000))
    np.testing.assert_array_equal(st.w.numpy(), w.sum(axis=1))


@pytest.mark.parametrize("t0,t1", [(0, 1), (2, 5), (7, 8)])
def test_poisson_tiles_on_the_cpu_is_the_weight_block(t0, t1):
    """The chunk drawer of the tiled scan: on the CPU the plain
    ``weight_block`` of n-tiles [t0, t1), masks included."""
    bb, bn = weight_tile_blocks(16, 4000)
    valid = torch.from_numpy(
        (np.random.default_rng(t0).random((t1 - t0) * bn) > 0.5)
        .astype(np.float32))
    got = poisson_tiles(SEED, 3900, 16, bb, bn, t0, t1, valid=valid)
    want = weight_block(SEED, 3900, 16, bb, bn, t0, t1, valid=valid)
    assert torch.equal(got, want)
    full = np.asarray(jws.implicit_weights(SEED, 16, 8 * bn))
    np.testing.assert_array_equal(
        poisson_tiles(SEED, 8 * bn, 16, bb, bn, t0, t1).numpy(),
        full[:, t0 * bn:t1 * bn])


# ---------------------------------------------------------------------------
# public signatures
# ---------------------------------------------------------------------------
#: Parameters the port drops on purpose (ROADMAP.md §3): ``backend=`` on
#: statistics and kernel wrappers, where the device decides.
DROPS = {"KMeansStep": {"backend"}, "Quantile": {"backend"},
         "Median": {"backend"}, "StatisticGroup": {"backend"},
         "kmeans_fit": {"backend"}}

ENTRY_POINTS = [
    (jcore, tcore, n) for n in (
        "bootstrap", "bootstrap_chunked", "bootstrap_streaming",
        "poisson_weights", "weights_for", "multinomial_counts",
        "poisson_delta_init", "PoissonDelta", "EarlSession",
        "MultinomialDeltaBootstrap", "shared_base_bootstrap", "ssabe",
        "kmeans_fit", "Quantile", "Median", "KMeansStep", "StatisticGroup",
        "GroupedStatistic", "sharded_fused_states", "DistributedEarl",
        "build_bootstrap_step", "shard_values")] + [
    (jssabe, tssabe, n) for n in ("estimate_B", "estimate_n")] + [
    (jft, tft, n) for n in ("estimate_with_failures", "failure_mask",
                            "DeadlineReducer", "elastic_estimate")] + [
    (JManager, TManager, "restore")] + [
    (jm, tm, n) for jm, tm, names in TRAINING for n in names]
#: a JAX key that the port takes as a torch.Generator (the documented
#: drop of the init functions)
RENAMES = {"init_train_state": {"key": "generator"}}


def _params(obj):
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("jmod,tmod,name", ENTRY_POINTS,
                         ids=[e[2] for e in ENTRY_POINTS])
def test_public_signatures_follow_the_jax_order(jmod, tmod, name):
    """Names and order as the JAX package has them, minus the documented
    drops, with the port's ``device`` last where it has one."""
    want = [RENAMES.get(name, {}).get(p, p)
            for p in _params(getattr(jmod, name))
            if p not in DROPS.get(name, ())]
    got = _params(getattr(tmod, name))
    if got and got[-1] == "device":
        got = got[:-1]
    assert got == want


def test_a_mesh_is_a_device_mesh_on_the_fused_backend_and_checkpoints_work():
    """A mesh that is not a ``DeviceMesh`` raises TypeError naming what a
    mesh must be; ``mesh=`` without ``backend="fused_rng"`` raises the
    JAX package's ValueError, whatever the mesh."""
    key = trandom.PRNGKey(0)

    def session(backend):
        return EarlSession(None, tcore.Mean(), mesh=object(),
                           backend=backend, device="cpu")

    def boot(backend):
        return tcore.bootstrap(np.ones(4), tcore.Mean(), 2, key,
                               backend=backend, mesh=object(), device="cpu")

    def delta(backend):
        return PoissonDelta(stat=tcore.Mean(), key=key, states=None,
                            est_state=None, B=2, n=0, step=0,
                            backend=backend, mesh=object(), device="cpu")

    for make in (session, boot, delta):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make("fused_rng")
        with pytest.raises(ValueError,
                           match="mesh= requires backend='fused_rng'"):
            make(None)
    with pytest.raises(ValueError, match="mesh= requires backend='fused_rng'"):
        jcore.EarlSession(None, jcore.Mean(), mesh=object())
    with pytest.raises(ValueError, match="mesh= requires backend='fused_rng'"):
        jcore.bootstrap(jnp.ones(4), jcore.Mean(), 2, None, mesh=object())
    # the checkpoint branch is ported: the constructor takes one
    s = EarlSession(None, tcore.Mean(), checkpoint="ck", checkpoint_every=2,
                    device="cpu")
    assert (s.checkpoint, s.checkpoint_every) == ("ck", 2)


def test_poisson_weights_takes_the_dtype_fourth():
    key = trandom.PRNGKey(4)
    w32 = poisson_weights(key, 3, 50, torch.float32, device="cpu")
    w16 = poisson_weights(key, 3, 50, torch.bfloat16, device="cpu")
    wi = poisson_weights(key, 3, 50, torch.int32, device="cpu")
    assert (w16.dtype, wi.dtype) == (torch.bfloat16, torch.int32)
    assert torch.equal(w16.to(torch.float32), w32)
    assert torch.equal(wi.to(torch.float32), w32)
