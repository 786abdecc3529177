"""kubeai_tpu_torch.engine.sampling against jax.random and
kubeai_tpu.engine.sampling: threefry keys, fold_in and random bits bit for
bit; uniforms bit for bit; Gumbel noise to 1 ulp (the two frameworks' f32
log differ in the last bit on ~15% of inputs); categorical draws and
`sample` token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import sampling as js
from kubeai_tpu_torch.engine import sampling as ts

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 300


def _seeds_positions(seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    seeds[:3] = [0, 1, 2**32 - 1]
    pos = rng.integers(0, 1 << 20, N).astype(np.int32)
    pos[:3] = [0, 1, 2**31 - 1]
    return seeds, pos


def _torch_key(seeds, pos):
    return ts.fold_in(
        ts.prng_key(torch.from_numpy(seeds.astype(np.int64))),
        torch.from_numpy(pos.astype(np.int64)),
    )


def _jax_key(s, p):
    return jax.random.fold_in(jax.random.PRNGKey(s), p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_and_random_bits_bit_equal(seed):
    seeds, pos = _seeds_positions(seed)
    jk = np.asarray(jax.vmap(lambda s, p: jax.random.key_data(_jax_key(s, p)))(
        jnp.asarray(seeds), jnp.asarray(pos)))
    tk = _torch_key(seeds, pos)
    np.testing.assert_array_equal(tk[0].numpy(), jk[:, 0].astype(np.int64))
    np.testing.assert_array_equal(tk[1].numpy(), jk[:, 1].astype(np.int64))
    jb = np.asarray(jax.vmap(lambda s, p: jax.random.bits(_jax_key(s, p), (64,)))(
        jnp.asarray(seeds), jnp.asarray(pos)))
    np.testing.assert_array_equal(ts.random_bits(tk, 64).numpy(), jb.astype(np.int64))


def test_prng_key_matches_jax():
    seeds = np.array([0, 7, 2**31, 2**32 - 1], np.uint32)
    jk = np.asarray(jax.vmap(lambda s: jax.random.key_data(jax.random.PRNGKey(s)))(
        jnp.asarray(seeds)))
    k0, k1 = ts.prng_key(torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(k0.numpy(), jk[:, 0])
    np.testing.assert_array_equal(k1.numpy(), jk[:, 1])


def test_uniform_bit_equal_and_gumbel_within_an_ulp():
    seeds, pos = _seeds_positions(3)

    def draw(s, p):
        k = _jax_key(s, p)
        return (jax.random.uniform(k, (64,), minval=jnp.finfo(jnp.float32).tiny),
                jax.random.gumbel(k, (64,)))

    ju, jg = (np.asarray(a) for a in jax.vmap(draw)(jnp.asarray(seeds), jnp.asarray(pos)))
    tk = _torch_key(seeds, pos)
    tu = ts.uniform_from_bits(ts.random_bits(tk, 64)).numpy()
    np.testing.assert_array_equal(tu, ju)
    tg = ts.gumbel(tk, 64).numpy()
    np.testing.assert_allclose(tg, jg, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("seed", [4, 5])
def test_categorical_draws_equal(seed):
    seeds, pos = _seeds_positions(seed)
    logits = np.random.default_rng(seed).standard_normal((N, 64)).astype(np.float32)
    logits[::7, 10:] = -np.inf  # masked candidates, as sample() makes them
    jc = np.asarray(jax.vmap(lambda s, p, l: jax.random.categorical(_jax_key(s, p), l))(
        jnp.asarray(seeds), jnp.asarray(pos), jnp.asarray(logits)))
    tc = ts.categorical(_torch_key(seeds, pos), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_sample_token_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    B, V = 256, 512
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[:40, :6] = logits[:40, :6].max() + 1.0  # tied top logits
    logits[40:60] = np.round(logits[40:60])  # many ties across the pool
    seeds, pos = _seeds_positions(seed)
    seeds, pos = seeds[:B], pos[:B]
    temp = rng.choice([0.0, 0.3, 1.0, 1.7], B).astype(np.float32)
    topk = rng.choice([0, 1, 5, 40, 64, 200], B).astype(np.int32)
    topp = rng.choice([1.0, 0.95, 0.5, 0.0], B).astype(np.float32)
    want = np.asarray(jax.jit(js.sample)(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(pos),
        jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp)))
    got = ts.sample(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(pos), torch.from_numpy(temp), torch.from_numpy(topk),
        torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_and_top1_rows():
    logits = torch.tensor([[0.0, 5.0, 5.0, 1.0], [3.0, 1.0, 3.0, 0.0]])
    seeds = torch.tensor([1, 2])
    pos = torch.tensor([0, 0])
    # Greedy takes the first maximum; top_k=1 and top_p=0 keep the top-1
    # candidate, the lower index of a tie.
    out = ts.sample(logits, seeds, pos, torch.tensor([0.0, 0.0]),
                    torch.tensor([0, 0]), torch.tensor([1.0, 1.0]))
    assert out.tolist() == [1, 0]
    out = ts.sample(logits, seeds, pos, torch.tensor([1.0, 1.0]),
                    torch.tensor([1, 0]), torch.tensor([1.0, 0.0]))
    assert out.tolist() == [1, 0]
