"""The port's copy of what tpusim draws from jax.random
(tpusim_torch/ops/prng.py) against jax.random itself, bit for bit: the
root keys, split, uniform over several lengths, the threefry hash on
tensors and on integers, and the per-event key chain of tpusim's table
engine over 1,000 steps; and the partitionable setting the copy assumes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_types_trace  # noqa: F401 (one torch thread)
from tpusim_torch.ops import prng

SEEDS = [0, 42, 233, -1, 2**31 + 7, 2**33 + 5]


def test_partitionable_setting_matches_jax():
    """A JAX upgrade that changes the default shows here, not as a silent
    divergence of every randomized replay."""
    assert jax.config.jax_threefry_partitionable == \
        prng.THREEFRY_PARTITIONABLE
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_root_key_matches_jax(seed):
    assert prng.prng_key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed)))
    got = prng.split(prng.prng_key(seed))
    assert [list(k) for k in got] == want.tolist()


@pytest.mark.parametrize("n", [1, 8, 1213, 4097])
@pytest.mark.parametrize("seed", [0, 42, 7])
def test_uniform_matches_jax(seed, n):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = prng.uniform(tuple(int(w) for w in np.asarray(key)), n).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    bits = np.asarray(jax.random.bits(key, (n,)))
    assert np.array_equal(
        prng.random_bits(tuple(int(w) for w in np.asarray(key)), n).numpy(),
        bits.astype(np.int64))


def test_threefry_on_tensors_and_integers():
    """The hash on int64 tensors equals the one on Python integers, at the
    extremes of both words."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint64)
    words[0] = 0
    words[1] = 2**32 - 1
    k0, k1, x0, x1 = (torch.as_tensor(words[:, i].astype(np.int64))
                      for i in range(4))
    y0, y1 = prng.threefry2x32(k0, k1, x0, x1)
    for i in range(64):
        a, b = prng.threefry2x32(*(int(w) for w in words[i]))
        assert (a, b) == (int(y0[i]), int(y1[i]))


@pytest.mark.parametrize("seed", [42, 2**31 + 7])
def test_event_chain_matches_table_engine_discipline(seed):
    """1,000 steps of key, sub = split(key); k_rand, k_sel = split(sub), as
    tpusim's table engine and sequential oracle take them per event."""
    def step(key, _):
        key, sub = jax.random.split(key)
        k_rand, k_sel = jax.random.split(sub)
        return key, (k_rand, k_sel)

    _, (want_rand, want_sel) = jax.lax.scan(
        step, jax.random.PRNGKey(seed), None, length=1000)
    got_rand, got_sel = prng.event_keys(prng.prng_key(seed), 1000)
    assert np.array_equal(got_rand.numpy(), np.asarray(want_rand))
    assert np.array_equal(got_sel.numpy(), np.asarray(want_sel))
    # a draw from the 600th event's k_rand, as RandomScore takes it
    u = jax.random.uniform(want_rand[600], (1213,))
    assert np.array_equal(
        prng.uniform(got_rand[600].tolist(), 1213).numpy().view(np.uint32),
        np.asarray(u).view(np.uint32))


def test_uniform_of_a_padded_axis_keeps_its_prefix():
    """Partitionable counters: the draw over more entries extends the draw
    over fewer."""
    key = prng.split(prng.prng_key(9))[0]
    assert torch.equal(prng.uniform(key, 1280)[:1213],
                       prng.uniform(key, 1213))
    assert jnp.array_equal(
        jax.random.uniform(jnp.asarray(key, jnp.uint32), (1280,))[:1213],
        jax.random.uniform(jnp.asarray(key, jnp.uint32), (1213,)))
