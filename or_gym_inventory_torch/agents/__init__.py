"""Learners of the PyTorch port (port of ``or_gym_inventory_tpu/agents``).

Ported so far: ``networks`` (the MLP and LSTM actor-critics and their
Gaussian helpers), ``ppo`` (PPO trained through the trajectory kernels of
the three families), ``a2c`` (its config) and ``recurrent_ppo`` (recurrent
PPO and the A2C_LSTM config, trained through the InvManagement LSTM
trajectory kernel). Nothing is imported here, so that importing one module
does not pull in the others.
"""
