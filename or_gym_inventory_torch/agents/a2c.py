"""A2C as a configuration of the PPO machinery (port of
``or_gym_inventory_tpu/agents/a2c.py:17-37``): one epoch, one minibatch,
RMSprop (SB3's A2C default), no clipping in effect and no LR anneal.
``A2CAgent`` waits for the agents slice (ROADMAP.md A11).
"""

from __future__ import annotations

from typing import Tuple

from or_gym_inventory_torch.agents.ppo import PPOConfig


def A2CConfig(num_envs: int = 256, rollout_steps: int = 8, lr: float = 7e-4,
              gamma: float = 0.99, gae_lambda: float = 1.0,
              ent_coef: float = 0.0, vf_coef: float = 0.5,
              max_grad_norm: float = 0.5,
              pi_arch: Tuple[int, ...] = (64, 64),
              vf_arch: Tuple[int, ...] = (64, 64),
              normalize_obs: bool = True, optimizer: str = "rmsprop",
              **kw) -> PPOConfig:
    """SB3-A2C-shaped defaults expressed as a PPOConfig. Any PPOConfig field
    may be overridden through ``kw``."""
    fields = dict(
        num_envs=num_envs, rollout_steps=rollout_steps, lr=lr, gamma=gamma,
        gae_lambda=gae_lambda, clip_eps=10.0,  # effectively unclipped
        update_epochs=1, num_minibatches=1, ent_coef=ent_coef,
        vf_coef=vf_coef, max_grad_norm=max_grad_norm, pi_arch=pi_arch,
        vf_arch=vf_arch, anneal_lr=False, normalize_obs=normalize_obs,
        optimizer=optimizer)
    fields.update(kw)
    return PPOConfig(**fields)
