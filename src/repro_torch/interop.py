"""Carry persistent state between ``repro`` and ``repro_torch``.

The two packages write the same bytes for the same operations, so an arena
image moves between them as it is: a path-backed arena file opens in
either package with ``open_arena(path, layout)``.  For in-memory images,
``arena_from_image`` builds a port arena from a reference arena's raw
persistent bytes and its layout (the reference's ``Arena._mm`` and
``Arena._meta``), and ``image_of`` returns a port arena's bytes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.arena import Arena, not_ported

__all__ = ["arena_from_image", "image_of"]


def arena_from_image(image: np.ndarray, layout: dict, device) -> Arena:
    """A port arena holding ``image`` (uint8 bytes of a reference arena)
    laid out as ``layout`` (``{name: {"dtype", "shape", "offset"}}``, the
    reference's ``_meta`` and ``.layout`` sidecar), reopened: its volatile
    regions are loaded onto ``device`` and its generation is the committed
    one.  Raises ValueError if the layout does not place the regions
    where the port would, and NotImplementedError for an image that
    carries integrity sidecars."""
    if any(name.endswith(".integ") for name in layout):
        raise not_ported("integrity sidecars")
    # the layout lists every region the image holds, sidecars excluded
    a = Arena(None, device=device, integrity=False)
    for name, spec in layout.items():
        r = a.region(name, np.dtype(spec["dtype"]), tuple(spec["shape"]))
        if r.offset != int(spec["offset"]):
            raise ValueError(f"region {name!r}: image offset "
                             f"{spec['offset']} != port offset {r.offset}")
    a.finalize()
    image = np.asarray(image, np.uint8).reshape(-1)
    if image.size != a._mm.size:
        raise ValueError(f"image holds {image.size} bytes, layout needs "
                         f"{a._mm.size}")
    a._mm[:] = image
    a.reopen()
    return a


def image_of(arena: Arena) -> np.ndarray:
    """A copy of the arena's persistent bytes."""
    return np.array(arena._mm, np.uint8)
