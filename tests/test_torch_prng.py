"""`mcpt_tpu_torch.prng` against `jax.random` (threefry2x32, partitionable):
`key`, `split`, `fold_in` and `uniform` must be BITWISE equal for several
seeds, split counts, fold-in values and shapes, including the wavefront's
(B, 4) and (S·B, 4) draws and the key chains its renders use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt_tpu_torch import prng

SEEDS = (0, 1, 7, 123456789, 2**31 - 1)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert str(jax.config.jax_default_prng_impl) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    for n in (1, 2, 3, 8, 33):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(), _data(jax.random.split(jk, n)))
    for data in (0, 1, 2, 5, 16, 1000, 65535, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(), _data(jax.random.fold_in(jk, data))
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (7, 4), (384, 4), (4 * 384, 4), (3, 5, 4)])
def test_uniform_bitwise(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed)
    for k_j, k_t in ((jk, tk), (jax.random.fold_in(jk, 3), prng.fold_in(tk, 3))):
        want = np.asarray(jax.random.uniform(k_j, shape, dtype=jnp.float32))
        got = prng.uniform(k_t, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_range_within_one_ulp():
    """Off [0, 1) XLA's CPU backend contracts f·(max − min) + min into one
    FMA, the port rounds the product first: they differ by at most one
    float32 ULP of the product (|f·5.5| < 5.5). The wavefront draws only
    [0, 1), where both are exact."""
    jk, tk = jax.random.key(5), prng.key(5)
    want = np.asarray(jax.random.uniform(jk, (64,), jnp.float32, -2.0, 3.5))
    got = prng.uniform(tk, (64,), -2.0, 3.5).numpy()
    assert np.abs(got - want).max() <= np.spacing(np.float32(5.5))


def test_render_key_chain_bitwise():
    """The chain of a wavefront render: fold_in per (tile, chunk), split per
    sample, split into camera and path keys, fold_in per bounce and use
    site, then the (B, 4) vertex draw and the (S·B, 4) light draw."""
    jk, tk = jax.random.key(42), prng.key(42)
    jc = jax.random.fold_in(jax.random.fold_in(jk, 3), 1)
    tc = prng.fold_in(prng.fold_in(tk, 3), 1)
    for js, ts in zip(jax.random.split(jc, 4), prng.split(tc, 4)):
        j1, j2 = jax.random.split(js)
        t1, t2 = prng.split(ts)
        np.testing.assert_array_equal(t1.numpy(), _data(j1))
        jd, td = jax.random.fold_in(j2, 2), prng.fold_in(t2, 2)
        for use, shape in ((0, (96, 4)), (1, (4 * 96, 4))):
            want = jax.random.uniform(jax.random.fold_in(jd, use), shape, dtype=jnp.float32)
            got = prng.uniform(prng.fold_in(td, use), shape)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
