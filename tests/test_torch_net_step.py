"""The three episode kernels' plain PyTorch versions (ops/net_step.py) against
the JAX package, and the Philox generator they share with the CUDA kernels.

The JAX side runs as its own tests run it: the Pallas stream-in kernel in
interpret mode, and the XLA step chain under vmap. Tolerances:

- plain K1 against JAX interpret ``episode_returns``: ``rtol=1e-5, atol=1e-3``
  (f32 sums in another order);
- plain K2 against plain K1 on plain K3's streams: exact, since both run the
  same PyTorch arithmetic on the same values;
- plain K3's streams through JAX (interpret kernel and step chain) against
  plain K2: ``rtol=1e-4, atol=1e-2``, the tolerance of bench.py:156;
- Philox words: bit for bit against Random123's known-answer vectors;
- the 24-bit uniforms: chi-square over 64 bins at p > 1e-4.

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py makes the same checks at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = "cpu"
STEPS, B = 30, 16
ACT_HI = 1700.0


@pytest.fixture(scope="module")
def params():
    jp = jnet.default_params(num_periods=STEPS)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), STEPS,
                                       jp.backlog, jp.alpha)
    return jp, tp


@pytest.fixture(scope="module")
def jax_kernel(params):
    """JAX's interpret-mode stream-in kernel at (30, n, 16), compiled once."""
    jp, _ = params
    return jax.jit(lambda a, d: pns.episode_returns(jp, a, d, block=8,
                                                    interpret=True))


def _jax_chain(jp):
    @jax.jit
    def run(actions, demands):
        def one_env(acts, dems):
            state, _ = jnet.reset(jp)

            def body(state, ad):
                state, ts = jnet.step_with_demand(jp, state, ad[0], ad[1])
                return state, ts.reward

            _, rew = jax.lax.scan(body, state, (acts, dems))
            return jnp.sum(rew)

        return jax.vmap(one_env, in_axes=(2, 2))(actions, demands)

    return run


def test_plain_k1_matches_jax_interpret(params, jax_kernel):
    jp, tp = params
    T = jp.topology
    rng_np = np.random.default_rng(0)
    acts = rng_np.uniform(0.0, 150.0, (STEPS, T.n_reorder, B)).astype(np.float32)
    dems = rng_np.poisson(20.0, (STEPS, T.n_retail, B)).astype(np.float32)
    ref = np.asarray(jax_kernel(jnp.asarray(acts), jnp.asarray(dems)))
    mine = tns.episode_returns(tp, torch.from_numpy(acts), torch.from_numpy(dems))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("graph,backlog,alpha", [
    ("default_topology", False, 1.0), ("default_topology", True, 0.9),
    ("custom_topology", True, 1.0)])
def test_plain_k1_matches_jax_step_chain(graph, backlog, alpha):
    from or_gym_inventory_tpu.envs import topology as jtopo
    steps, b = 12, 8
    jp = jnet.default_params(topology=getattr(jtopo, graph)(steps),
                             num_periods=steps, backlog=backlog, alpha=alpha)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), steps,
                                       backlog, alpha)
    T = jp.topology
    rng_np = np.random.default_rng(1)
    acts = rng_np.uniform(0.0, 150.0, (steps, T.n_reorder, b)).astype(np.float32)
    dems = rng_np.poisson(20.0, (steps, T.n_retail, b)).astype(np.float32)
    ref = np.asarray(_jax_chain(jp)(jnp.asarray(acts), jnp.asarray(dems)))
    mine = tns.episode_returns(tp, torch.from_numpy(acts), torch.from_numpy(dems))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("E,dump_range", [(1, None), (4, (1, 3))])
def test_plain_k2_matches_k1_on_k3_streams(params, E, dump_range):
    _, tp = params
    seed, b = 2024, 48
    ret = tns.episode_returns_fully_fused(tp, seed, ACT_HI, b,
                                          episodes_per_lane=E, device=CPU)
    acts, dems = tns.sample_streams_debug(tp, seed, ACT_HI, b, episodes_per_lane=E,
                                          dump_range=dump_range, device=CPU)
    if E == 1:
        assert ret.shape == (b,) and acts.shape == (STEPS, 11, b)
        torch.testing.assert_close(ret, tns.episode_returns(tp, acts, dems),
                                   rtol=0, atol=0)
        return
    e0, e1 = dump_range
    assert ret.shape == (E, b) and acts.shape == (STEPS, e1 - e0, 11, b)
    for e in range(e0, e1):
        per = tns.episode_returns(tp, acts[:, e - e0].contiguous(),
                                  dems[:, e - e0].contiguous())
        torch.testing.assert_close(ret[e], per, rtol=0, atol=0)
    # a dump range writes exactly the matching slice of the full dump
    full = tns.sample_streams_debug(tp, seed, ACT_HI, b, episodes_per_lane=E,
                                    device=CPU)[0]
    assert torch.equal(full[:, e0:e1], acts)


def test_k3_streams_reproduce_k2_through_jax(params, jax_kernel):
    jp, tp = params
    seed = 77
    ret = tns.episode_returns_fully_fused(tp, seed, ACT_HI, B, device=CPU).numpy()
    acts, dems = tns.sample_streams_debug(tp, seed, ACT_HI, B, device=CPU)
    a, d = jnp.asarray(acts.numpy()), jnp.asarray(dems.numpy())
    np.testing.assert_allclose(np.asarray(jax_kernel(a, d)), ret, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(_jax_chain(jp)(a, d)), ret,
                               rtol=1e-4, atol=1e-2)
    # the streams have the random policy's and the spec's support
    assert float(acts.min()) >= 0 and float(acts.max()) < ACT_HI
    assert torch.equal(dems, dems.round()) and float(dems.min()) >= 0


def test_streams_are_seed_and_episode_specific(params):
    _, tp = params
    a1 = tns.sample_streams_debug(tp, 5, ACT_HI, 8, episodes_per_lane=2, device=CPU)[0]
    a2 = tns.sample_streams_debug(tp, 6, ACT_HI, 8, episodes_per_lane=2, device=CPU)[0]
    assert not torch.equal(a1, a2)
    assert not torch.equal(a1[:, 0], a1[:, 1])


# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,out", KAT)
def test_philox_known_answers(ctr, key, out):
    words = rng.philox4x32_10(*ctr, *key)
    assert tuple(int(w) for w in words) == out
    # batched: the same counter in a tensor of lanes gives the same words
    lanes = torch.full((3,), ctr[0], dtype=torch.int64)
    assert all(int(w[i]) == o for w, o in zip(
        rng.philox4x32_10(lanes, *ctr[1:], *key), out) for i in range(3))


def test_u24_stream_is_uniform():
    lanes = torch.arange(16384, dtype=torch.int64)
    words = torch.cat(rng.period_words(123, lanes, 0, 0, 12)
                      + rng.period_words(123, lanes, 3, 29, 12))
    u24 = words >> 8
    assert int(u24.min()) >= 0 and int(u24.max()) < (1 << 24)
    counts = torch.bincount(u24 >> 18, minlength=64).numpy()
    p = stats.chisquare(counts).pvalue
    assert p > 1e-4, p
    # and the low bits that the uniform keeps are no less uniform
    p_low = stats.chisquare(torch.bincount(u24 & 63, minlength=64).numpy()).pvalue
    assert p_low > 1e-4, p_low


def test_wrappers_on_cpu_run_plain_without_counting(params):
    _, tp = params
    counts = (tns.episode_returns.launches, tns.episode_returns_fully_fused.launches,
              tns.sample_streams_debug.launches)
    acts, dems = tns.sample_streams_debug(tp, 1, ACT_HI, 4, device=CPU)
    tns.episode_returns(tp, acts, dems)
    tns.episode_returns_fully_fused(tp, 1, ACT_HI, 4, device=CPU)
    assert counts == (tns.episode_returns.launches,
                      tns.episode_returns_fully_fused.launches,
                      tns.sample_streams_debug.launches)


def test_wrappers_check_their_inputs(params):
    _, tp = params
    acts = torch.zeros((STEPS, 11, 4))
    with pytest.raises(ValueError):
        tns.episode_returns(tp, acts, torch.zeros((STEPS, 2, 4)))
    with pytest.raises(TypeError):
        tns.episode_returns(tp, acts.double(), torch.zeros((STEPS, 1, 4)).double())
    with pytest.raises(ValueError):
        tns.sample_streams_debug(tp, 1, ACT_HI, 4, episodes_per_lane=2,
                                 dump_range=(1, 3), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tns.episode_returns_fully_fused(tp, 1, ACT_HI, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(params, cuda):
    _, tp = params
    seed, b = 9, 3000   # not a multiple of the block: the tail is masked
    acts, dems = tns.sample_streams_debug(tp, seed, ACT_HI, b, episodes_per_lane=3,
                                          dump_range=(1, 3), device=cuda)
    pa, pd = tns._sample_streams_plain(tp, seed, ACT_HI, b, STEPS, 1, 3, cuda)
    assert torch.equal(acts, pa) and torch.equal(dems, pd)
    a1, d1 = acts[:, 0].contiguous(), dems[:, 0].contiguous()
    torch.testing.assert_close(tns.episode_returns(tp, a1, d1),
                               tns._episode_returns_plain(tp, a1, d1),
                               rtol=1e-5, atol=1e-3)
    ret = tns.episode_returns_fully_fused(tp, seed, ACT_HI, b, episodes_per_lane=3,
                                          device=cuda)
    torch.testing.assert_close(ret, tns._episode_returns_fully_fused_plain(
        tp, seed, ACT_HI, b, STEPS, 3, cuda), rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(ret[1], tns.episode_returns(tp, a1, d1),
                               rtol=1e-5, atol=1e-3)
