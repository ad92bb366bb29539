"""Carry persistent state between ``repro`` and ``repro_torch``.

The two packages write the same bytes for the same operations, so an arena
image moves between them as it is: a path-backed arena file opens in
either package with ``open_arena(path, layout)``.  For in-memory images,
``arena_from_image`` builds a port arena from a reference arena's raw
persistent bytes and its layout (the reference's ``Arena._mm`` and
``Arena._meta``), and ``image_of`` returns a port arena's bytes.  An
image with integrity sidecars (``.integ`` regions) builds an arena with
integrity on, whose sidecars land where the layout puts them.  A sharded
arena moves by its files (``{path}.s{k}``, their ``.layout`` sidecars and
``{path}.manifest``): either package opens the other's with
``open_arena(path, layout, n_shards=N)``.

A train state moves as numpy leaves: ``state_from_numpy`` carries a
TrainState whose leaves are numpy arrays (the reference's, through
``np.asarray``) into the port, ``state_to_numpy`` back.  A parameter tree
moves the same way: ``params_from_numpy`` takes the reference's tree as
``jax.tree.map(np.asarray, params)``, so both packages compute the same
function; ``params_to_numpy`` goes back.  Checkpoints need no carrier:
both packages write and read the same files.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import Arena, resolve_device
from repro_torch.core.policy import tree_map
from repro_torch.train.state import TrainState

__all__ = ["arena_from_image", "image_of", "params_from_numpy",
           "params_to_numpy", "state_from_numpy", "state_to_numpy"]


def arena_from_image(image: np.ndarray, layout: dict, device,
                     commit_mode: str = "barrier") -> Arena:
    """A port arena holding ``image`` (uint8 bytes of a reference arena
    committed by ``commit_mode``) laid out as ``layout`` (``{name:
    {"dtype", "shape", "offset"}}``, the reference's ``_meta`` and
    ``.layout`` sidecar), reopened: its volatile regions are loaded onto
    ``device`` (through the committed shadow bank, for a shadow image) and
    its generation is the committed one.  Raises ValueError if the layout
    does not place the regions where the port would."""
    sidecars = [n for n in layout if n.endswith(".integ")]
    # finalize() appends the sidecars itself, after the declared regions
    a = Arena(None, device=device, integrity=bool(sidecars),
              commit_mode=commit_mode)
    for name, spec in layout.items():
        if name not in sidecars:
            a.region(name, np.dtype(spec["dtype"]), tuple(spec["shape"]))
    a.finalize()
    if sorted(a.regions) != sorted(layout):
        raise ValueError(f"layout names {sorted(layout)}, the port builds "
                         f"{sorted(a.regions)}")
    for name, spec in layout.items():
        r = a.regions[name]
        if r.offset != int(spec["offset"]) or \
                list(r.shape) != list(spec["shape"]):
            raise ValueError(
                f"region {name!r}: the image has shape {spec['shape']} at "
                f"offset {spec['offset']}, the port {list(r.shape)} at "
                f"{r.offset}")
    image = np.asarray(image, np.uint8).reshape(-1)
    if image.size != a._mm.size:
        raise ValueError(f"image holds {image.size} bytes, layout needs "
                         f"{a._mm.size}")
    a._mm[:] = image
    a.reopen()
    return a


def image_of(arena) -> np.ndarray:
    """A copy of the arena's persistent bytes: a sharded arena's are its
    shards' images in shard order, then the manifest, the bytes of its
    ``{path}.s{k}`` files and ``{path}.manifest``."""
    if hasattr(arena, "shards"):
        return np.concatenate([np.asarray(sh._mm, np.uint8)
                               for sh in arena.shards]
                              + [np.asarray(arena._man, np.uint8)])
    return np.array(arena._mm, np.uint8)


def _tensor(a, device) -> torch.Tensor:
    """A copy of numpy array ``a`` on ``device``, its dtype kept: a
    bfloat16 array (the reference's, from ml_dtypes, which numpy itself
    lacks) moves as its 2-byte words."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """A parameter tree (nested dicts of numpy arrays) as torch tensors on
    ``device`` (None means the GPU), dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), tree)


def params_to_numpy(tree):
    """A tree of torch tensors as host numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def state_from_numpy(tree, device=None) -> TrainState:
    """A port TrainState on ``device`` (None means the GPU) holding copies
    of ``tree``'s numpy leaves (any NamedTuple with TrainState's fields,
    the reference's included); dtypes are kept, uint32 and bfloat16
    included."""
    device = resolve_device(device)
    return TrainState(**{k: tree_map(lambda a: _tensor(a, device), v)
                         for k, v in tree._asdict().items()})


def state_to_numpy(state: TrainState) -> TrainState:
    """``state`` with every leaf copied to a host numpy array."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
