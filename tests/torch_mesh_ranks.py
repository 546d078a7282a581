"""The rank program of tests/test_torch_mesh.py's gloo world, and the data
and statistics the test shares with it.  Imports no jax: each rank is a
fresh interpreter running

    python -c "import torch_mesh_ranks as r; r.main(RANK, WORLD, STORE, OUT)"

with this directory and src/ on its path.  Every rank computes the mesh
path's results over the same global data and writes them to
OUT/rank<RANK>.npz (tensors) and OUT/rank<RANK>.json (scalars); the test
holds them against the port's ``nshards=`` oracle in its own process.
"""
import json
import os

import numpy as np
import torch

# x (N, D) with N ragged against NSHARDS; B resamples; the seed of the
# fused streams; CHUNK rows a chunked call; STEP a delta extend's counter
N, D, B, SEED, NSHARDS, CHUNK, STEP = 4097, 2, 48, 1234, 4, 1024, 2
G, K, NBINS, LO, HI = 8, 5, 64, 0.0, 25.0
# the two delta extends split x here
DELTA_SPLIT = 2500
FAMILIES = ("mean", "var", "std", "median", "group", "grouped", "kmeans")
VARIANTS = {"one": {}, "chunk": {"chunk": CHUNK, "with_estimate": True},
            "step": {"step": STEP}}
# the sessions: the quickstart's law at 200,000 rows and sigma 0.002,
# where the group's session iterates on the CPU.  Four shards draw other
# streams than one, so SSABE's fit moves: under the mesh, keys 0 to 3 and
# 5 send the group to the exact job, and key 4 iterates (7 rounds, B = 4)
SESSION_N, SESSION_SIGMA, SESSION_KEY = 200_000, 0.002, 4
# DistributedEarl: its key, and the ft path's shards lost out of 16
EARL_KEY, FT_SHARDS, FT_LOST = 7, 16, (0, 3, 7)
# the elastic reduce on the world of 4: shard 1 lost, shard 3 late
ELASTIC_LOST, ELASTIC_DONE_S, ELASTIC_DEADLINE_S = (1,), (0.1, 0.2, 0.3,
                                                          9.0), 1.0


def data(name: str) -> np.ndarray:
    """The family's (N, ·) f32 values: two normal columns (the quickstart's
    law), [value, key] for the keyed family, 2-d blobs for k-means."""
    if name == "kmeans":
        from repro_torch.data import synthetic_clusters
        return synthetic_clusters(N, k=K, dim=D, seed=3)[0]
    rng = np.random.default_rng(0)
    x = rng.normal(10.0, 2.0, size=(N, D)).astype(np.float32)
    if name == "grouped":
        x[:, 1] = rng.integers(0, G, size=N).astype(np.float32)
    return x


def centroids() -> np.ndarray:
    """k-means centroids near the blobs' centers."""
    from repro_torch.data import synthetic_clusters
    centers = synthetic_clusters(N, k=K, dim=D, seed=3)[1]
    rng = np.random.default_rng(4)
    return (centers + rng.normal(0, 0.1, centers.shape)).astype(np.float32)


def port_stat(name: str):
    from repro_torch.core import (GroupedStatistic, KMeansStep, Mean,
                                  Quantile, StatisticGroup, Std, Var)
    return {
        "mean": Mean, "var": Var, "std": Std,
        "median": lambda: Quantile(0.5, nbins=NBINS, lo=LO, hi=HI),
        "group": lambda: StatisticGroup(
            (Mean(), Quantile(0.5, nbins=NBINS, lo=LO, hi=HI), Std())),
        "grouped": lambda: GroupedStatistic(Mean(), G),
        "kmeans": lambda: KMeansStep(torch.from_numpy(centroids())),
    }[name]()


def flat(tree, prefix: str) -> dict:
    """{prefix + leaf path: numpy array} of a state tree."""
    from repro_torch.checkpoint.manager import _leaves
    return {prefix + p: t.detach().cpu().numpy() for p, t in _leaves(tree)}


def delta_states(stat, x: torch.Tensor, mesh):
    """(states, est_state) of a fused PoissonDelta over ``mesh`` after two
    extends, x[:DELTA_SPLIT] then the rest."""
    from repro_torch import random as trandom
    from repro_torch.core import poisson_delta_extend, poisson_delta_init
    pd = poisson_delta_init(stat, B, x.shape[1], trandom.PRNGKey(SEED),
                            backend="fused_rng", mesh=mesh, device="cpu")
    pd = poisson_delta_extend(pd, x[:DELTA_SPLIT])
    pd = poisson_delta_extend(pd, x[DELTA_SPLIT:])
    return pd.states, pd.est_state


def session_group():
    from repro_torch.core import Mean, Quantile, StatisticGroup, Std
    return StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))


def session_sampler():
    from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric
    rows = synthetic_numeric(SESSION_N, mean=10.0, std=2.0, seed=0)
    return PreMapSampler(ShardedStore.from_array(rows, split_size=65_536),
                         seed=1, device="cpu")


class Killed(Exception):
    """The simulated crash of every rank."""


class DyingSampler:
    """A sampler whose ``die_at``-th ``take`` raises on every rank: with
    the pilot's take first, the third take is round 2's, after round 1's
    snapshot."""

    def __init__(self, inner, die_at: int):
        self.inner, self.die_at, self.takes = inner, die_at, 0
        self.N = inner.N

    def take(self, start: int, stop: int):
        self.takes += 1
        if self.takes == self.die_at:
            raise Killed(f"take #{self.takes}")
        return self.inner.take(start, stop)


def session(mesh, sampler=None, checkpoint=None):
    from repro_torch.core import EarlSession
    return EarlSession(sampler or session_sampler(), session_group(),
                       sigma=SESSION_SIGMA, backend="fused_rng", mesh=mesh,
                       checkpoint=checkpoint, device="cpu")


def session_summary(r) -> dict:
    return dict(B=r.B, n_used=r.n_used, iterations=r.iterations,
                fell_back=r.fell_back, cv=r.cv,
                rows=[e["n"] for e in r.history],
                cvs=[e["cv"] for e in r.history])


def session_arrays(r, prefix: str) -> dict:
    return flat((r.result, r.ci_lo, r.ci_hi), prefix)


def earl_runs(mesh, res: dict, scalars: dict) -> None:
    """DistributedEarl over the world: both backends, estimate and
    estimate_with_loss_mask, and the elastic reduce."""
    from repro_torch import random as trandom
    from repro_torch.core import DistributedEarl
    from repro_torch.ft import (FailurePolicy, ShardEvents, elastic_estimate,
                                failure_mask)
    x = torch.from_numpy(data("mean"))
    key = trandom.PRNGKey(EARL_KEY)
    for name in ("mean", "median"):
        for backend in (None, "fused_rng"):
            earl = DistributedEarl(mesh, port_stat(name), B,
                                   backend=backend, device="cpu")
            r = earl.estimate(x, key)
            res.update(flat((r.thetas, r.estimate),
                            f"earl/{name}/{backend}/"))
            m = failure_mask(N, FT_SHARDS, FT_LOST)
            r = earl.estimate_with_loss_mask(x, m, key)
            res.update(flat((r.thetas, r.estimate),
                            f"earl_mask/{name}/{backend}/"))
    earl = DistributedEarl(mesh, port_stat("group"), B, backend="fused_rng",
                           device="cpu")
    events = ShardEvents(n_shards=NSHARDS, lost=ELASTIC_LOST,
                         completion_s=ELASTIC_DONE_S)
    er = elastic_estimate(earl, x, key, events,
                          FailurePolicy(deadline_s=ELASTIC_DEADLINE_S))
    mask = failure_mask(N, NSHARDS, sorted(set(ELASTIC_LOST) | set(er.late)))
    direct = earl.estimate_with_loss_mask(x, mask, key,
                                          p=er.report.p_surviving)
    res.update(flat((er.report.result, er.report.ci_lo, er.report.ci_hi),
                    "elastic/"))
    res.update(flat((direct.estimate, direct.report.ci_lo,
                     direct.report.ci_hi), "elastic_direct/"))
    scalars["elastic"] = dict(
        lost=list(er.lost), late=list(er.late), decision=er.decision,
        p=er.report.p_surviving, shards_lost=er.report.shards_lost,
        cv=er.report.cv, direct_cv=direct.cv)


def checkpoint_runs(mesh, out: str, rank: int, res: dict,
                    scalars: dict) -> None:
    """A mesh session killed on every rank after round 1's snapshot and
    resumed (the snapshot written by the writer rank only), and a state
    restored with shardings onto the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager

    class Counting(CheckpointManager):
        saves = 0

        def save(self, *a, **kw):
            Counting.saves += 1
            super().save(*a, **kw)

    root = os.path.join(out, "ckpt")
    killed = False
    try:
        session(mesh, DyingSampler(session_sampler(), 3),
                Counting(root, async_save=False)).run(
                    trandom.PRNGKey(SESSION_KEY))
    except Killed:
        killed = True
    resumed = session(mesh, checkpoint=Counting(root, async_save=False)).run(
        trandom.PRNGKey(SESSION_KEY), resume=True)
    res.update(session_arrays(resumed, "resumed/"))
    scalars["resumed"] = session_summary(resumed)
    scalars["killed"] = killed
    scalars["saves"] = Counting.saves

    state = {"a": torch.arange(24, dtype=torch.float32).reshape(8, 3)}
    mgr = CheckpointManager(os.path.join(out, "elastic"), async_save=False)
    if rank == 0:
        mgr.save(1, state)
    dist.barrier()
    for kind, placements in (("replicate", [Replicate()]),
                             ("shard", [Shard(0)])):
        got, _ = mgr.restore({"a": torch.zeros(8, 3)},
                             shardings={"a": (mesh, placements)})
        res[f"restore/{kind}"] = got["a"].to_local().numpy()
        scalars[f"restore_{kind}"] = [str(p) for p in got["a"].placements]


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import random as trandom
    from repro_torch.core import bootstrap, bootstrap_chunked, ssabe
    from repro_torch.core.bootstrap import sharded_fused_states
    from repro_torch.ft import mesh_for_devices

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", list(range(world)),
                          mesh_dim_names=("data",))
        res, scalars = {}, {}
        for name in FAMILIES:
            x = torch.from_numpy(data(name))
            for variant, kw in VARIANTS.items():
                res.update(flat(sharded_fused_states(
                    port_stat(name), SEED, x, B, mesh=mesh, **kw),
                    f"{name}/{variant}"))
            res.update(flat(delta_states(port_stat(name), x, mesh),
                            f"{name}/delta"))
        x = torch.from_numpy(data("group"))
        key = trandom.PRNGKey(SEED)
        for entry, run in (("bootstrap", bootstrap),
                           ("chunked", bootstrap_chunked)):
            kw = {"chunk": CHUNK} if entry == "chunked" else {}
            r = run(x, port_stat("group"), B, key, backend="fused_rng",
                    mesh=mesh, device="cpu", **kw)
            res.update(flat((r.thetas, r.estimate), f"{entry}/"))
        pilot = session_sampler().take(0, 8192)
        est = ssabe(pilot, session_group(), SESSION_SIGMA, 0.01,
                    trandom.PRNGKey(SESSION_KEY), backend="fused_rng",
                    mesh=mesh, device="cpu")
        scalars["ssabe"] = dict(B=est.B, n=est.n,
                                cv_B=[c for _, c in est.cv_history_B],
                                cv_n=[c for _, c in est.cv_history_n])
        r = session(mesh).run(trandom.PRNGKey(SESSION_KEY))
        res.update(session_arrays(r, "session/"))
        scalars["session"] = session_summary(r)
        earl_runs(mesh, res, scalars)
        checkpoint_runs(mesh, out, rank, res, scalars)
        m4 = mesh_for_devices(world, device_type="cpu")
        scalars["mesh_for_devices"] = dict(
            shape=list(m4.shape), names=list(m4.mesh_dim_names))
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(scalars, f)
    finally:
        dist.destroy_process_group()
