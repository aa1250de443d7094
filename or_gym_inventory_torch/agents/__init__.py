"""Learners of the PyTorch port (port of ``or_gym_inventory_tpu/agents``).

Ported so far: ``base`` (the agent protocol, ``RandomAgent``,
``PolicyAgent`` and the checkpoint metadata), ``networks`` (the MLP and LSTM
actor-critics and their Gaussian helpers), ``ppo`` (PPO on the fused
policy+env update or the trajectory kernels of the three families, and
``PPOAgent``), ``a2c`` (its config and ``A2CAgent``), ``recurrent_ppo``
(recurrent PPO and the A2C_LSTM config on the fused policy+env update or
the InvManagement LSTM trajectory kernel, ``RecurrentPPOAgent`` and
``A2CLSTMAgent``) and ``off_policy`` (SAC, TD3 and DDPG with
``collect="kernel"``, through the trajectory kernels' off-policy heads on
all three families).

The agents and configs are exported by name (``from
or_gym_inventory_torch.agents import PPOAgent``), each module imported at
the first use of one of its names, so that importing one module does not
pull in the others.
"""

import importlib

_EXPORTS = {
    "BaseAgent": "base", "RandomAgent": "base", "PolicyAgent": "base",
    "PPOAgent": "ppo", "PPOConfig": "ppo",
    "A2CAgent": "a2c", "A2CConfig": "a2c",
    "RecurrentPPOAgent": "recurrent_ppo", "RecurrentPPOConfig": "recurrent_ppo",
    "A2CLSTMAgent": "recurrent_ppo", "A2CLSTMConfig": "recurrent_ppo",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
