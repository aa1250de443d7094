from or_gym_inventory_torch.parallel.mesh import (  # noqa: F401
    Mesh, initialize_multihost, make_mesh, shard_batch, sharded_evaluate,
    sharded_policy_episode_returns, sharded_random_episode_returns, sharded_rollout)
