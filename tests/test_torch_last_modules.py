"""The port's last modules against the JAX package: ``configs/
earl_analytics.py``, ``data/sampler.PostMapSampler`` and the dry run's
signature; and kernels 12 and 12b as ``torch.library`` operators
(``kernels/flash_attention/ops.py``): the CPU route bitwise the plain
versions it calls, ``torch.library.opcheck`` on the CPU implementations,
and a fake call that launches nothing.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.configs import earl_analytics as jcfg
from repro.data.sampler import PostMapSampler as JPost
from repro.data.sampler import PreMapSampler as JPre
from repro.data.store import ShardedStore as JStore
from repro.data.synthetic import synthetic_numeric
from repro_torch.configs import earl_analytics as tcfg
from repro_torch.data import PostMapSampler, PreMapSampler, ShardedStore
from repro_torch.kernels.flash_attention import ops as fa

torch.set_num_threads(1)


def test_analytics_config_is_the_jax_packages():
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jcfg.AnalyticsConfig)]
    tf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tcfg.AnalyticsConfig)]
    assert tf == jf
    assert dataclasses.asdict(tcfg.CONFIG) == dataclasses.asdict(jcfg.CONFIG)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.CONFIG.N = 1


def _stores(rows=20_000, split=1024):
    data = synthetic_numeric(rows, 10, 2, seed=5)
    return (JStore.from_array(data, split, seed=7),
            ShardedStore.from_array(data, split, seed=7))


def test_post_map_sampler_is_the_jax_packages():
    js, ts = _stores()
    jpost = JPost(js, seed=9, num_buckets=64)
    tpost = PostMapSampler(ts, seed=9, num_buckets=64, device="cpu")
    assert tpost.kv_count is None
    a = np.asarray(jpost.take(0, 500))
    b = tpost.take(0, 500)
    assert b.device.type == "cpu"
    np.testing.assert_array_equal(b.numpy(), a)
    assert tpost.kv_count == jpost.kv_count == ts.N
    np.testing.assert_array_equal(tpost.bucket_of, jpost.bucket_of)
    np.testing.assert_array_equal(tpost.take(500, 2000).numpy(),
                                  np.asarray(jpost.take(500, 2000)))


def test_post_map_reads_everything_once_and_takes_pre_maps_rows():
    _, ts = _stores()
    post = PostMapSampler(ts, seed=3, device="cpu")
    post.take(0, 1000)
    assert ts.stats.rows_read == ts.N
    before = ts.stats.rows_read
    post.take(1000, 2000)                       # cached: no re-read
    assert ts.stats.rows_read == before
    _, ts2 = _stores()
    pre = PreMapSampler(ts2, seed=3, device="cpu")
    np.testing.assert_array_equal(post.take(0, 3000).numpy(),
                                  pre.take(0, 3000).numpy())
    js, _ = _stores()
    np.testing.assert_array_equal(np.asarray(JPre(js, seed=3).take(0, 3000)),
                                  pre.take(0, 3000).numpy())


def test_post_map_sampler_signature_follows_the_jax_order():
    want = [p for p in inspect.signature(JPost.__init__).parameters
            if p != "self"]
    got = [p for p in inspect.signature(PostMapSampler.__init__).parameters
           if p != "self"]
    assert got == want + ["device"]


def test_lower_cell_signature_follows_the_jax_order():
    """The JAX module forces 512 host devices when imported, so its
    signature is read from its source."""
    import ast
    import os
    import repro.launch.sharding as jsh
    from repro_torch.launch import dryrun
    with open(os.path.join(os.path.dirname(jsh.__file__), "dryrun.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "lower_cell")
    want = [a.arg for a in fn.args.args]
    assert list(inspect.signature(dryrun.lower_cell).parameters) == \
        want + ["device"]


# ---------------------------------------------------------------------------
# kernels 12 and 12b as operators
# ---------------------------------------------------------------------------
OP_CASES = [((2, 4, 37, 16), (2, 2, 37, 16), True, None, 0),
            ((1, 4, 8, 32), (1, 1, 40, 32), True, 16, 32),
            ((2, 2, 19, 8), (2, 2, 23, 8), False, None, 0)]


def _qkv(qs, ks, seed=0, grad=False):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, requires_grad=grad)
                 for s in (qs, ks, ks))


@pytest.mark.parametrize("qs,ks,causal,window,off", OP_CASES)
def test_cpu_route_is_bitwise_the_plain_versions(qs, ks, causal, window,
                                                 off):
    kw = dict(causal=causal, window=window, kv_offset=off, block_q=16,
              block_k=16)
    q, k, v = _qkv(qs, ks)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v, **kw),
                           fa.flash_attention_plain(q, k, v, **kw))
    q, k, v = _qkv(qs, ks, grad=True)
    out = fa.flash_attention(q, k, v, **kw)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(do)
    with torch.no_grad():
        want, lse = fa.flash_attention_plain_lse(q, k, v, **kw)
        grads = fa.flash_attention_backward_plain(q, k, v, want, lse, do,
                                                  **kw)
    assert torch.equal(out.detach(), want)
    for got, g in zip((q.grad, k.grad, v.grad), grads):
        assert torch.equal(got, g)


@pytest.mark.parametrize("qs,ks,causal,window,off", OP_CASES[:2])
def test_opcheck_passes_on_the_cpu_implementations(qs, ks, causal, window,
                                                   off):
    q, k, v = _qkv(qs, ks)
    args = (causal, window, qs[-1] ** -0.5, off, 16, 16)
    ops = torch.ops.repro_torch
    torch.library.opcheck(ops.flash_attention.default, (q, k, v) + args)
    torch.library.opcheck(ops.flash_attention_lse.default, (q, k, v) + args)
    o, lse = ops.flash_attention_lse(q, k, v, *args)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
    torch.library.opcheck(ops.flash_attention_backward.default,
                          (q, k, v, o, lse, do) + args)


def test_a_fake_call_launches_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = (fa.flash_attention.launches,
              fa.flash_attention_backward_cuda.launches,
              fa.flash_attention_backward_cuda.tc_launches)
    with FakeTensorMode():
        q = torch.empty((2, 8, 64, 32), requires_grad=True)
        k = torch.empty((2, 2, 64, 32), requires_grad=True)
        out = fa.flash_attention(q, k, k)
        assert out.shape == q.shape and out.dtype == q.dtype
        out.sum().backward()
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        o, lse = torch.ops.repro_torch.flash_attention_lse(
            q, k, k, True, None, 1.0, 0, 16, 16)
        assert lse.shape == (16, 64) and lse.dtype == torch.float32
    assert (fa.flash_attention.launches,
            fa.flash_attention_backward_cuda.launches,
            fa.flash_attention_backward_cuda.tc_launches) == before
