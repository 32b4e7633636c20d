"""Checkpoints of the port."""
