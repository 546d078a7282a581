"""The port's mesh path on the CPU: ``psum_state``, sharded fused states,
``mesh=`` through the bootstrap, delta, SSABE and the session,
``DistributedEarl`` and the ft/ shard-loss reports.

* The port's sequential oracle, ``sharded_fused_states(nshards=4)``,
  against the JAX package's (``backend="scan"`` on the CPU), at x
  (4097, 2) and B = 48, plain, chunked and with a step: w_tot, histogram
  and k-means counts bitwise, s1 and k-means sums within 1e-5·Σw|x| per
  entry, s2 within 1e-5·Σw·x² and inertia within 1e-5 of itself.
* A gloo world of 4 ranks (fresh interpreters running
  tests/torch_mesh_ranks.py, started once for the module): every rank
  bitwise the oracle for every family, chunked and over two delta
  extends, and bitwise each other on SSABE and the session; the session
  killed after a snapshot that only rank 0 wrote and resumed, bitwise;
  ``DistributedEarl`` on both backends bitwise its per-shard oracle; the
  elastic reduce bitwise ``estimate_with_loss_mask``; a restore onto the
  mesh with replicated and ``Shard(0)`` placements.
* A world of 1 in this process: the mesh run bitwise the unsharded one.
* ``DistributedEarl`` against the JAX package's on a 1-device mesh here,
  and at 4 shards against a JAX subprocess on 4 host devices: the
  materialized weights bitwise, the histogram's thetas bitwise, the
  mean's within 1e-5 of the data's largest |x| (the sums' bound over a
  count).  The ft reports' fields equal the JAX package's.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.ft as jft
import torch_mesh_ranks as R
from repro.core import DistributedEarl as JEarl
from repro.core import GroupedStatistic as JGrouped
from repro.core import KMeansStep as JKMeans
from repro.core import Mean as JMean
from repro.core import Quantile as JQuantile
from repro.core import StatisticGroup as JGroup
from repro.core import Std as JStd
from repro.core import Var as JVar
from repro.core.bootstrap import sharded_fused_states as j_sharded
from repro.core.distributed import _poisson_for_shard as j_poisson_for_shard
from repro.ft.elastic import mesh_for_devices as j_mesh_for_devices
from repro_torch import ft as tft
from repro_torch import random as trandom
from repro_torch.checkpoint.manager import _leaves
from repro_torch.core import (DistributedEarl, GroupedStatistic, Mean,
                              bootstrap, bootstrap_chunked,
                              fused_resample_states, poisson_delta_extend,
                              poisson_delta_init, sharded_fused_states)
from repro_torch.core.bootstrap import _block, offset_seed, seed_from_key
from repro_torch.core.distributed import _poisson_for_shard

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
RANK_TIMEOUT_S = 300


def _env(**extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(PYTHONPATH=os.pathsep.join([SRC, TESTS]), OMP_NUM_THREADS="1",
               **extra)
    return env


def jax_stat(name):
    return {
        "mean": JMean, "var": JVar, "std": JStd,
        "median": lambda: JQuantile(0.5, nbins=R.NBINS, lo=R.LO, hi=R.HI),
        "group": lambda: JGroup(
            (JMean(), JQuantile(0.5, nbins=R.NBINS, lo=R.LO, hi=R.HI),
             JStd())),
        "grouped": lambda: JGrouped(JMean(), R.G),
        "kmeans": lambda: JKMeans(jnp.asarray(R.centroids())),
    }[name]()


def _x(name):
    return torch.from_numpy(R.data(name))


# ---------------------------------------------------------------------------
# the port's nshards= oracle against the JAX package's
# ---------------------------------------------------------------------------
def _abs_bound(name, kw):
    """Σw|x| per entry under the same streams: the moments of |x| (per
    key for the keyed family), as (states, est) like the compared call."""
    x = _x(name)
    if name == "grouped":
        x = torch.stack([x[:, 0].abs(), x[:, 1]], 1)
        stat = GroupedStatistic(Mean(), R.G)
    else:
        x, stat = x.abs(), Mean()
    return sharded_fused_states(stat, R.SEED, x, R.B, nshards=R.NSHARDS,
                                **kw)


def _s1(tree):
    """The s1 leaves of a moments state tree, in leaf order."""
    return [t for p, t in _leaves(tree) if p.endswith(".s1")]


def _hold_state(got, want, bound1):
    """got (port) against want (JAX): integer leaves and lo/hi bitwise,
    s1 and sums within 1e-5·bound1, s2 within 1e-5·s2 (Σw·x²), inertia
    within 1e-5 of itself."""
    want = jax.tree_util.tree_leaves(want)
    got = list(_leaves(got))
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        field = path.rsplit(".", 1)[-1]
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        if field in ("w", "counts", "lo", "hi"):
            np.testing.assert_array_equal(g, w, err_msg=path)
            continue
        if field in ("s1", "sums"):
            b = bound1.numpy()
            if g.ndim == b.ndim + 1:
                b = b[..., None, :]
        else:
            b = np.abs(w)
        assert np.all(np.abs(g.astype(np.float64) - w)
                      <= 1e-5 * b + 1e-30), path


def test_kmeans_data_has_no_boundary_points():
    """Each point's two nearest centroids are well apart, so both packages
    assign every point alike and k-means counts must be bitwise."""
    x = R.data("kmeans").astype(np.float64)
    c = R.centroids().astype(np.float64)
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    scale = (x * x).sum(1) + (c * c).sum(1)[d2.argmin(1)]
    assert not np.any(two[:, 1] - two[:, 0] < 1e-5 * scale)


@pytest.mark.parametrize("variant", list(R.VARIANTS))
@pytest.mark.parametrize("name", R.FAMILIES)
def test_oracle_matches_jax(name, variant):
    kw = R.VARIANTS[variant]
    got = sharded_fused_states(R.port_stat(name), R.SEED, _x(name), R.B,
                               nshards=R.NSHARDS, **kw)
    want = j_sharded(jax_stat(name), R.SEED, jnp.asarray(R.data(name)), R.B,
                     nshards=R.NSHARDS, **kw)
    bound = _abs_bound(name, kw)
    if kw.get("with_estimate"):
        (gs, ge), (ws, we), (bs, be) = got, want, bound
        _hold_state(gs, ws, _s1(bs)[0])
        _hold_state(ge, we, _s1(be)[0])
    else:
        _hold_state(got, want, _s1(bound)[0])


def test_mesh_and_step_with_chunk_raise_as_in_jax():
    x = _x("mean")
    with pytest.raises(ValueError, match="mutually exclusive"):
        sharded_fused_states(Mean(), 1, x, 4, nshards=2, chunk=64, step=1)
    with pytest.raises(ValueError, match="mesh= or nshards="):
        sharded_fused_states(Mean(), 1, x, 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded_fused_states(Mean(), 1, x, 4, mesh=object())

    class Unmergeable(Mean):
        mergeable = False

    with pytest.raises(ValueError, match="mergeable"):
        sharded_fused_states(Unmergeable(), 1, x, 4, nshards=2)


# ---------------------------------------------------------------------------
# the gloo world of 4 ranks
# ---------------------------------------------------------------------------
_JAX4_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import torch_mesh_ranks as R
from repro.core import DistributedEarl, Mean, Quantile
from repro.ft.elastic import mesh_for_devices
assert jax.device_count() == 4
mesh = Mesh(np.array(jax.devices()), ("data",))
out, x = {}, jnp.asarray(R.data("mean"))
stats = {"mean": Mean, "median": lambda: Quantile(0.5, nbins=R.NBINS,
                                                 lo=R.LO, hi=R.HI)}
for name, make in stats.items():
    for backend in (None, "fused_rng"):
        r = DistributedEarl(mesh, make(), R.B, backend=backend).estimate(
            x, jax.random.PRNGKey(R.EARL_KEY))
        out[f"{name}/{backend}/thetas"] = np.asarray(r.thetas).tolist()
        out[f"{name}/{backend}/estimate"] = np.asarray(r.estimate).tolist()
m4 = mesh_for_devices(4)
out["mesh4"] = dict(shape=list(m4.devices.shape), names=list(m4.axis_names))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Starts, with the module, the gloo world's four ranks and the JAX
    package's DistributedEarl and mesh_for_devices(4) on 4 forced host
    devices: five fresh interpreters that run while the in-process tests
    do.  Yields (output directory, processes); kills what is left."""
    out = tmp_path_factory.mktemp("world4")
    store = str(out / "store")
    procs = []
    try:
        for rank in range(R.NSHARDS):
            code = (f"import torch_mesh_ranks as r; "
                    f"r.main({rank}, {R.NSHARDS}, {store!r}, {str(out)!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=_env(), cwd=TESTS,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JAX4_SCRIPT, str(out / "jax4.json")],
            cwd=TESTS, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu")))
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def spawned(launched):
    """Each rank's (arrays, scalars), and the JAX subprocess's results;
    fails if any of the five exited nonzero or outlived its timeout."""
    out, procs = launched
    logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{log}"
    ranks = []
    for rank in range(R.NSHARDS):
        with np.load(out / f"rank{rank}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(out / f"rank{rank}.json") as f:
            ranks.append((arrays, json.load(f)))
    with open(out / "jax4.json") as f:
        return ranks, json.load(f)


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def jax4(spawned):
    return spawned[1]


def _oracle_delta(name):
    stat, x = R.port_stat(name), _x(name)
    base = seed_from_key(trandom.PRNGKey(R.SEED))
    states = stat.init_batch(x.shape[1], R.B, "cpu")
    est = stat.init_state(x.shape[1], "cpu")
    for step, part in enumerate((x[:R.DELTA_SPLIT], x[R.DELTA_SPLIT:])):
        states = stat.merge(states, sharded_fused_states(
            stat, base, part, R.B, nshards=R.NSHARDS, step=step))
        est = stat.update(est, part)
    return states, est


def _bitwise_on_every_rank(world4, want: dict, prefix: str):
    assert want
    for arrays, _ in world4:
        for k, v in want.items():
            np.testing.assert_array_equal(arrays[prefix + k], v,
                                          err_msg=prefix + k)


@pytest.mark.parametrize("variant", list(R.VARIANTS) + ["delta"])
@pytest.mark.parametrize("name", R.FAMILIES)
def test_world4_is_bitwise_the_oracle(world4, name, variant):
    if variant == "delta":
        want = _oracle_delta(name)
    else:
        want = sharded_fused_states(R.port_stat(name), R.SEED, _x(name),
                                    R.B, nshards=R.NSHARDS,
                                    **R.VARIANTS[variant])
    _bitwise_on_every_rank(world4, R.flat(want, ""), f"{name}/{variant}")


@pytest.mark.parametrize("entry", ["bootstrap", "chunked"])
def test_world4_bootstrap_entry_points_are_the_oracle(world4, entry):
    stat, x = R.port_stat("group"), _x("group")
    base = seed_from_key(trandom.PRNGKey(R.SEED))
    if entry == "chunked":
        states, est = sharded_fused_states(stat, base, x, R.B,
                                           nshards=R.NSHARDS, chunk=R.CHUNK,
                                           with_estimate=True)
        estimate = stat.finalize(est)
    else:
        states = sharded_fused_states(stat, base, x, R.B, nshards=R.NSHARDS)
        estimate = stat(x)
    want = (stat.finalize_batch(states), estimate)
    _bitwise_on_every_rank(world4, R.flat(want, ""), f"{entry}/")


def _same_on_every_rank(world4, prefix: str, key: str):
    a0, s0 = world4[0]
    for arrays, scalars in world4[1:]:
        assert scalars[key] == s0[key]
        for k in a0:
            if k.startswith(prefix):
                np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


def test_world4_ssabe_and_session_agree_across_ranks_and_iterate(world4):
    _same_on_every_rank(world4, "session/", "session")
    assert all(s["ssabe"] == world4[0][1]["ssabe"] for _, s in world4)
    got = world4[0][1]["session"]
    local = R.session(None).run(trandom.PRNGKey(R.SESSION_KEY))
    assert not got["fell_back"] and got["iterations"] >= 2
    assert not local.fell_back
    assert got["B"] == local.B and got["n_used"] == local.n_used
    assert got["cv"] <= R.SESSION_SIGMA


def test_world4_checkpoint_is_written_by_rank_0_and_resumes_bitwise(world4):
    for rank, (arrays, scalars) in enumerate(world4):
        assert scalars["killed"]
        assert (scalars["saves"] > 0) == (rank == 0)
        assert scalars["resumed"] == scalars["session"]
        for k in arrays:
            if k.startswith("session/"):
                np.testing.assert_array_equal(
                    arrays["resumed/" + k[len("session/"):]], arrays[k])


def _earl_oracle(name, backend, mask):
    """DistributedEarl over NSHARDS shards in one process: each shard's
    states from its own stream and mask block, merged in shard order."""
    stat, x = R.port_stat(name), _x("mean")
    key = trandom.PRNGKey(R.EARL_KEY)
    m = -(-R.N // R.NSHARDS)
    states = est = None
    for i in range(R.NSHARDS):
        xi = _block(x, i * m, m)
        mi = _block(mask[:, None], i * m, m)[:, 0]
        if backend == "fused_rng":
            si = fused_resample_states(
                stat, offset_seed(seed_from_key(key), i), xi, R.B,
                valid_mask=mi)
        else:
            w = _poisson_for_shard(key, i, R.B, m, device="cpu") * mi
            si = stat.update_batch(stat.init_batch(R.D, R.B, "cpu"), xi, w)
        ei = stat.update(stat.init_state(R.D, "cpu"), xi, mi)
        states = si if states is None else stat.merge(states, si)
        est = ei if est is None else stat.merge(est, ei)
    return stat.finalize_batch(states), stat.finalize(est)


@pytest.mark.parametrize("kind", ["earl", "earl_mask"])
@pytest.mark.parametrize("backend", [None, "fused_rng"])
@pytest.mark.parametrize("name", ["mean", "median"])
def test_world4_distributed_earl_is_its_oracle(world4, name, backend, kind):
    mask = (torch.ones(R.N) if kind == "earl"
            else tft.failure_mask(R.N, R.FT_SHARDS, R.FT_LOST))
    want = _earl_oracle(name, backend, mask)
    _bitwise_on_every_rank(world4, R.flat(want, ""),
                           f"{kind}/{name}/{backend}/")


def test_world4_elastic_reduce_is_the_loss_mask_run(world4):
    _same_on_every_rank(world4, "elastic/", "elastic")
    for arrays, scalars in world4:
        e = scalars["elastic"]
        assert (e["lost"], e["late"], e["shards_lost"]) == ([1], [3], 2)
        m = tft.failure_mask(R.N, R.NSHARDS, [1, 3])
        assert e["p"] == float(m.mean()) and e["cv"] == e["direct_cv"]
        for k in arrays:
            if k.startswith("elastic/"):
                np.testing.assert_array_equal(
                    arrays[k], arrays["elastic_direct/" + k[8:]])


def test_world4_restore_onto_the_mesh(world4):
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, (arrays, scalars) in enumerate(world4):
        assert scalars["restore_replicate"] == ["R"]
        assert scalars["restore_shard"] == ["S(0)"]
        np.testing.assert_array_equal(arrays["restore/replicate"], full)
        np.testing.assert_array_equal(arrays["restore/shard"],
                                      full[2 * rank:2 * rank + 2])


# ---------------------------------------------------------------------------
# a world of 1 in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    from torch.distributed.device_mesh import DeviceMesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("world1") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", [0], mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _bitwise(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, u), (_, v) in zip(la, lb):
        assert torch.equal(u, v), p


@pytest.mark.parametrize("name", R.FAMILIES)
def test_world1_is_the_unsharded_path(mesh1, name):
    x = _x(name)
    got = sharded_fused_states(R.port_stat(name), R.SEED, x, R.B, mesh=mesh1)
    _bitwise(got, fused_resample_states(R.port_stat(name), R.SEED, x, R.B))
    got = sharded_fused_states(R.port_stat(name), R.SEED, x, R.B, mesh=mesh1,
                               step=3)
    _bitwise(got, fused_resample_states(R.port_stat(name),
                                        offset_seed(R.SEED, 3), x, R.B))


@pytest.mark.parametrize("entry", [bootstrap, bootstrap_chunked])
def test_world1_bootstrap_entry_points(mesh1, entry):
    kw = {"chunk": R.CHUNK} if entry is bootstrap_chunked else {}
    x, key = _x("group"), trandom.PRNGKey(R.SEED)
    got = entry(x, R.port_stat("group"), R.B, key, backend="fused_rng",
                mesh=mesh1, device="cpu", **kw)
    want = entry(x, R.port_stat("group"), R.B, key, backend="fused_rng",
                 device="cpu", **kw)
    _bitwise((got.thetas, got.estimate), (want.thetas, want.estimate))


def test_world1_delta_and_session(mesh1):
    x = _x("group")

    def delta(mesh):
        pd = poisson_delta_init(R.port_stat("group"), R.B, R.D,
                                trandom.PRNGKey(R.SEED), backend="fused_rng",
                                mesh=mesh, device="cpu")
        for part in (x[:R.DELTA_SPLIT], x[R.DELTA_SPLIT:]):
            pd = poisson_delta_extend(pd, part)
        return pd.states, pd.est_state

    _bitwise(delta(mesh1), delta(None))
    key = trandom.PRNGKey(R.SESSION_KEY)
    got, want = R.session(mesh1).run(key), R.session(None).run(key)
    assert R.session_summary(got) == R.session_summary(want)
    _bitwise((got.result, got.ci_lo, got.ci_hi),
             (want.result, want.ci_lo, want.ci_hi))


def test_mesh_for_devices_has_the_jax_shapes(mesh1, world4, jax4):
    jm = j_mesh_for_devices(1)
    tm = tft.mesh_for_devices(1, device_type="cpu")
    assert (tuple(tm.shape), tm.mesh_dim_names) == \
        (tuple(jm.devices.shape), jm.axis_names)
    four = jax4["mesh4"]
    got = world4[0][1]["mesh_for_devices"]
    assert (got["shape"], got["names"]) == (four["shape"], four["names"])


# ---------------------------------------------------------------------------
# DistributedEarl and the ft reports against the JAX package
# ---------------------------------------------------------------------------
def _jmesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _hold_thetas(got, want, name):
    """Histogram thetas bitwise; the mean's within 1e-5 of max |x|."""
    for (path, g), w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        if name == "median":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            bound = 1e-5 * np.abs(R.data("mean")).max()
            assert np.all(np.abs(g - w) <= bound), path


def test_materialized_shard_weights_are_bitwise_jax():
    m = -(-R.N // R.NSHARDS)
    for i in range(R.NSHARDS):
        got = _poisson_for_shard(trandom.PRNGKey(R.EARL_KEY), i, R.B, m,
                                 device="cpu")
        want = j_poisson_for_shard(jax.random.PRNGKey(R.EARL_KEY), i, R.B, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", [None, "fused_rng"])
@pytest.mark.parametrize("name", ["mean", "median"])
def test_world1_distributed_earl_matches_jax(mesh1, name, backend, masked):
    x = R.data("mean")
    earl = DistributedEarl(mesh1, R.port_stat(name), R.B, backend=backend,
                           device="cpu")
    jearl = JEarl(_jmesh1(), jax_stat(name), R.B, backend=backend)
    key, jkey = trandom.PRNGKey(R.EARL_KEY), jax.random.PRNGKey(R.EARL_KEY)
    if masked:
        mask = tft.failure_mask(R.N, R.FT_SHARDS, R.FT_LOST)
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jft.failure_mask(R.N, R.FT_SHARDS,
                                                      R.FT_LOST)))
        got = earl.estimate_with_loss_mask(torch.from_numpy(x), mask, key)
        want = jearl.estimate_with_loss_mask(jnp.asarray(x),
                                             jnp.asarray(mask.numpy()), jkey)
    else:
        got = earl.estimate(torch.from_numpy(x), key)
        want = jearl.estimate(jnp.asarray(x), jkey)
    assert got.n == want.n and got.B == want.B
    _hold_thetas((got.thetas, got.estimate), (want.thetas, want.estimate),
                 name)


@pytest.mark.parametrize("backend", [None, "fused_rng"])
@pytest.mark.parametrize("name", ["mean", "median"])
def test_world4_distributed_earl_matches_jax_on_4_devices(world4, jax4,
                                                         name, backend):
    jx = jax4
    want = (np.asarray(jx[f"{name}/{backend}/thetas"], np.float32),
            np.asarray(jx[f"{name}/{backend}/estimate"], np.float32))
    arrays = world4[0][0]
    prefix = f"earl/{name}/{backend}/"
    got = [torch.from_numpy(arrays[k]) for k in sorted(arrays)
           if k.startswith(prefix)]
    assert len(got) == 2
    _hold_thetas(tuple(got), want, name)


@pytest.fixture(scope="module")
def ft_earls(mesh1):
    """The port's and the JAX package's Mean estimators (B = 64) over one
    device, and tests/test_checkpoint_ft.py's data."""
    from repro_torch.data import synthetic_numeric
    data = synthetic_numeric(32_768, 10, 2, seed=1)
    return (DistributedEarl(mesh1, Mean(), 64, device="cpu"),
            JEarl(_jmesh1(), JMean(), 64), data)


def _same_report(got, want):
    assert (got.shards_total, got.shards_lost, got.meets_bound,
            got.recommendation) == (want.shards_total, want.shards_lost,
                                    want.meets_bound, want.recommendation)
    assert got.p_surviving == float(want.p_surviving)


@pytest.mark.parametrize("lost,sigma", [((0, 3, 7), 0.05),
                                        (tuple(range(15)), 0.001)])
def test_estimate_with_failures_matches_jax(ft_earls, lost, sigma):
    earl, jearl, data = ft_earls
    got = tft.estimate_with_failures(earl, data, list(lost), 16, sigma,
                                     trandom.PRNGKey(0))
    want = jft.estimate_with_failures(jearl, jnp.asarray(data), list(lost),
                                      16, sigma, jax.random.PRNGKey(0))
    _same_report(got, want)


def test_deadline_reducer_matches_jax(ft_earls):
    earl, jearl, data = ft_earls
    done = [0.1 * i for i in range(8)]
    got = tft.DeadlineReducer(earl, 8, sigma=0.05).reduce(
        data, done, 0.45, trandom.PRNGKey(1))
    want = jft.DeadlineReducer(jearl, 8, sigma=0.05).reduce(
        jnp.asarray(data), done, 0.45, jax.random.PRNGKey(1))
    assert (got.on_time, got.late, got.deadline_s) == \
        (want.on_time, want.late, want.deadline_s) == (5, 3, 0.45)
    _same_report(got.report, want.report)


@pytest.mark.parametrize("sigma", [0.05, 1e-4])
def test_elastic_estimate_matches_jax(ft_earls, sigma):
    earl, jearl, data = ft_earls
    ev = dict(n_shards=8, lost=(2,), completion_s=(0.1,) * 7 + (5.0,))
    got = tft.elastic_estimate(
        earl, data, trandom.PRNGKey(2), tft.ShardEvents(**ev),
        tft.FailurePolicy(sigma=sigma, deadline_s=1.0))
    want = jft.elastic_estimate(
        jearl, jnp.asarray(data), jax.random.PRNGKey(2),
        jft.ShardEvents(**ev), jft.FailurePolicy(sigma=sigma,
                                                 deadline_s=1.0))
    assert (got.lost, got.late, got.decision, got.can_restart) == \
        (want.lost, want.late, want.decision, want.can_restart)
    _same_report(got.report, want.report)


@pytest.mark.parametrize("n,shards,lost", [(100, 10, [0, 9]),
                                           (103, 10, [9]), (103, 10, [4]),
                                           (4097, 16, [0, 3, 7])])
def test_failure_mask_is_bitwise_jax(n, shards, lost):
    got = tft.failure_mask(n, shards, lost)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jft.failure_mask(n, shards, lost)))
