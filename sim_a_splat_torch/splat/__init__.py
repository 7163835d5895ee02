"""Gaussian splat scene container."""
