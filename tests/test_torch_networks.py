"""The port's actor-critic and Gaussian helpers (agents/networks.py) against
the flax module and the JAX helpers, on parameters carried across by
``utils.interop.ppo_params_from_numpy``.

Inputs come from NumPy seeds; the JAX side runs on the CPU. Tolerance
``rtol=1e-5, atol=1e-5`` (f32 matmuls summed in another order), except the
bf16 forward: ``rtol=1e-4, atol=1e-4`` (both sides round the same inputs to
bf16 and sum in f32, in another order), and ``squash_action`` at a box of
1,700: ``atol=1e-4`` (an ulp of tanh there is 5e-5). The orthogonal initialisation is
held to WᵀW = gain² I within 1e-5, with W in flax's (in, out) layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import networks as tnw
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import networks as jnw
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

OBS, ACT = 10, 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(activation="tanh", pi=(32, 16), vf=(24,)):
    """A flax MLPActorCritic's parameters (seeded) and the port's model
    carrying them."""
    module = jnw.MLPActorCritic(action_dim=ACT, pi_arch=pi, vf_arch=vf,
                                activation=activation)
    jparams = module.init(jax.random.PRNGKey(7), jnp.zeros((1, OBS)))
    # non-zero biases and log_std, so that every parameter is carried
    r = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + r.normal(0, 0.1, np.shape(a)).astype(np.float32),
        jparams)
    model = tnw.MLPActorCritic(OBS, ACT, pi_arch=pi, vf_arch=vf, activation=activation)
    model.load_state_dict(interop.ppo_params_from_numpy(jparams, device="cpu"))
    return module, jparams, model


def _obs(n=64, seed=0):
    return np.random.default_rng(seed).normal(0, 2, (n, OBS)).astype(np.float32)


@pytest.mark.parametrize("activation", ["tanh", "relu", "gelu"])
def test_forward_matches_flax(activation):
    module, jparams, model = _pair(activation)
    obs = _obs()
    jm, jls, jv = module.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        m, ls, v = model(torch.from_numpy(obs))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(jls), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("dtype,tol", [(None, TOL), ("bfloat16", dict(rtol=1e-4, atol=1e-4))])
def test_apply_actor_critic_matches_jax(dtype, tol):
    _, jparams, model = _pair()
    obs = _obs()
    jcfg = jppo.PPOConfig(pi_arch=(32, 16), vf_arch=(24,))
    tcfg = tppo.PPOConfig(pi_arch=(32, 16), vf_arch=(24,))
    jm, _, jv = jppo.apply_actor_critic(jparams, jnp.asarray(obs), jcfg, dtype)
    with torch.no_grad():
        m, _, v = tppo.apply_actor_critic(model, torch.from_numpy(obs), tcfg, dtype)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **tol)


def test_gaussian_helpers_match_jax():
    r = np.random.default_rng(1)
    raw = r.normal(0, 3, (50, ACT)).astype(np.float32)
    raw[0] = [12.0, -12.0, 0.0]        # the tanh correction's far tails
    mean = r.normal(0, 1, (50, ACT)).astype(np.float32)
    log_std = np.array([-12.0, 0.3, 3.0], np.float32)   # both clip ends
    t = torch.from_numpy
    np.testing.assert_allclose(
        tnw.gaussian_log_prob(t(raw), t(mean), t(log_std)).numpy(),
        np.asarray(jnw.gaussian_log_prob(raw, mean, log_std)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tnw.entropy_bonus(t(log_std)).numpy(),
                               np.asarray(jnw.entropy_bonus(log_std)), **TOL)
    low, high = np.zeros(ACT, np.float32), np.array([10.0, 20.0, 1700.0], np.float32)
    # an ulp of tanh (6e-8 near +-1) is 5e-5 at a box of 1,700
    np.testing.assert_allclose(tnw.squash_action(t(raw), t(low), t(high)).numpy(),
                               np.asarray(jnw.squash_action(raw, low, high)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tek.clipped_std(t(log_std)).numpy(),
                               np.asarray(jek.clipped_std(log_std)), **TOL)


@pytest.mark.parametrize("pi,vf", [((64, 64), (64, 64)), ((32, 16), (24,))])
def test_orthogonal_init(pi, vf):
    model = tnw.MLPActorCritic(68, 11, pi_arch=pi, vf_arch=vf,
                               generator=torch.Generator().manual_seed(0))
    layers = ([(l, 2.0 ** 0.5) for l in model.pi] + [(model.mean, 0.01)]
              + [(l, 2.0 ** 0.5) for l in model.vf] + [(model.value, 1.0)])
    for layer, gain in layers:
        K = layer.weight.detach().double().T            # flax layout (in, out)
        n_in, n_out = K.shape
        gram = K.T @ K if n_out <= n_in else K @ K.T
        torch.testing.assert_close(gram, gain ** 2 * torch.eye(min(n_in, n_out),
                                                               dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        assert not layer.bias.any()
    assert not model.log_std.any()
    # the generator decides the weights
    again = tnw.MLPActorCritic(68, 11, pi_arch=pi, vf_arch=vf,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.pi[0].weight, model.pi[0].weight)


def test_gaussian_sample_uses_the_generator():
    mean, log_std = torch.zeros(4000, ACT), torch.tensor([-1.0, 0.0, 5.0])
    a = tnw.gaussian_sample(torch.Generator().manual_seed(2), mean, log_std)
    b = tnw.gaussian_sample(torch.Generator().manual_seed(2), mean, log_std)
    assert torch.equal(a, b)
    std = a.std(dim=0)
    expect = torch.exp(torch.clamp(log_std, -10.0, 2.0))
    torch.testing.assert_close(std, expect, rtol=0.05, atol=0)
