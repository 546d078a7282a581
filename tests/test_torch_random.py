"""The port's threefry key derivation, held bitwise against jax.random.

Keys, fold-ins, splits, 32-bit bits and randint of ``repro_torch.random``
must equal jax's (with ``jax_threefry_partitionable``, which the weights of
every fused path depend on), and so must the seed helpers of
``repro_torch.core.bootstrap``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bootstrap import offset_seed as j_offset_seed
from repro.core.bootstrap import seed_from_key as j_seed_from_key
from repro_torch import random as trandom
from repro_torch.core.bootstrap import offset_seed, seed_from_key

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 7, 12345, 99991, 2 ** 30, 2 ** 31 - 3, 2 ** 31 - 2,
         2 ** 31 - 1] + [int(s) for s in
                         np.random.default_rng(5).integers(0, 2 ** 31 - 1,
                                                           20)]


def test_partitionable_threefry_is_on():
    # the reference weights are the partitionable stream
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_ops_bitwise(seed):
    kj = jax.random.PRNGKey(seed)
    kt = trandom.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    for data in (0, 1, 0xEA, 2 ** 31 - 1, seed):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(kj, data)),
                                      trandom.fold_in(kt, data).numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, num)),
                                      trandom.split(kt, num).numpy())
    for shape in ((), (7,), (3, 5), (8, 300)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(
                np.int64),
            trandom.bits(kt, shape, device="cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS[::2])
@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (-5, 1000), (3, 4),
                                   (7, 7), (-(2 ** 31), 2 ** 31 - 1)])
def test_randint_bitwise(seed, lo, hi):
    kj = jax.random.PRNGKey(seed)
    kt = trandom.PRNGKey(seed)
    for shape in ((), (4, 3)):
        want = np.asarray(jax.random.randint(kj, shape, lo, hi,
                                             dtype=jnp.int32))
        got = trandom.randint(kt, shape, lo, hi, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_from_key_bitwise(seed):
    for k in (jax.random.PRNGKey(seed),
              jax.random.fold_in(jax.random.PRNGKey(seed), 2)):
        assert int(j_seed_from_key(k)) == seed_from_key(
            np.asarray(k))


@pytest.mark.parametrize("base", [0, 1, 12345, 2 ** 31 - 3, 2 ** 31 - 2])
@pytest.mark.parametrize("i", [0, 1, 2, 17, 2 ** 30, 2 ** 31 - 2])
def test_offset_seed_bitwise_and_in_range(base, i):
    want = int(j_offset_seed(base, i))
    got = offset_seed(base, i)
    assert got == want
    assert 0 <= got < 2 ** 31 - 1


def test_key_data_rejects_bad_shapes():
    with pytest.raises(ValueError):
        trandom.key_data(np.zeros(3, np.uint32))
    with pytest.raises(ValueError):
        trandom.PRNGKey(2 ** 31)


@pytest.mark.parametrize("draw", [
    lambda k, **kw: trandom.bits(k, (4,), **kw),
    lambda k, **kw: trandom.uniform(k, (4,), **kw),
    lambda k, **kw: trandom.poisson(k, 1.0, (4,), **kw),
    lambda k, **kw: trandom.randint(k, (4,), 0, 9, **kw),
    lambda k, **kw: trandom.permutation(k, 4, **kw),
], ids=["bits", "uniform", "poisson", "randint", "permutation"])
def test_draws_default_to_the_card(draw):
    """As ``jax.random`` draws on the default device, a draw without
    ``device=`` lands on the card; with no card it raises instead of
    running on the host."""
    key = trandom.PRNGKey(5)
    assert draw(key, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert draw(key).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            draw(key)
