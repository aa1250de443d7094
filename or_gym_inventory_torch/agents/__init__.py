"""Learners of the PyTorch port (port of ``or_gym_inventory_tpu/agents``).

Ported so far: ``networks`` (the MLP actor-critic and its Gaussian helpers),
``ppo`` (PPO trained through the NetInvMgmt trajectory kernel) and ``a2c``
(its config). Nothing is imported here, so that importing one module does
not pull in the others.
"""
