"""fluid.layers.utils module path (ref: fluid/layers/utils.py; the port
of `paddle_tpu/fluid/layers_utils.py`) — the nest utilities (flatten /
pack_sequence_as / map_structure) that 1.x RNN and decoder code imports
directly. Lists, tuples and dicts (in sorted key order, as the
reference's pytrees) nest; anything else is a leaf.
"""
from __future__ import annotations


def _is_nest(x):
    return isinstance(x, (list, tuple, dict))


def _children(x):
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else list(x)


def flatten(nest):
    """Flatten a nested structure into a list of leaves (ref: utils.py
    flatten)."""
    if not _is_nest(nest):
        return [nest]
    out = []
    for c in _children(nest):
        out.extend(flatten(c))
    return out


def _pack(structure, it):
    if not _is_nest(structure):
        return next(it)
    if isinstance(structure, dict):
        return type(structure)((k, _pack(structure[k], it))
                               for k in sorted(structure))
    vals = [_pack(c, it) for c in structure]
    if isinstance(structure, tuple) and hasattr(structure, "_fields"):
        return type(structure)(*vals)
    return type(structure)(vals)


def pack_sequence_as(structure, flat_sequence):
    """Pack a flat list back into `structure`'s shape (ref:
    utils.py:167)."""
    flat = list(flat_sequence)
    if len(flat) != len(flatten(structure)):
        raise ValueError(f"the structure has {len(flatten(structure))} "
                         f"leaves, the sequence {len(flat)}")
    return _pack(structure, iter(flat))


def map_structure(func, *structures):
    """Apply func leaf-wise across parallel structures (ref:
    utils.py:189)."""
    flats = [flatten(s) for s in structures]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("the structures differ in their leaves")
    return pack_sequence_as(structures[0],
                            [func(*leaves) for leaves in zip(*flats)])


__all__ = ["flatten", "pack_sequence_as", "map_structure"]
