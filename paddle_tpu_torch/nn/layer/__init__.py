"""Layers of the port (`common`, `norm`, `transformer`)."""
