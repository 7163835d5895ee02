"""Typed pose structs: the viewer-message schema analogue."""
