"""Batched rollouts and random-policy episode returns."""
