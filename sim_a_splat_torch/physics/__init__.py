"""Planar rigid-body physics and the pushT task, batched over envs."""
