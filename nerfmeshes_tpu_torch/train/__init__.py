"""Rendering and training of the port."""
