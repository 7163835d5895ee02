"""Articulated splat scene graph."""
