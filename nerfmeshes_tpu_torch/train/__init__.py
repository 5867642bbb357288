"""Rendering and (from slice 2) training of the port."""
