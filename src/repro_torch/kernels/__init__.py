"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel wrapper counts its launches in a ``launches`` attribute and
their sizes in a ``sizes`` histogram (``_build.note_launch``); the two
that loop inside a launch (``gather_next``'s hops, ``jump_double``'s
rounds) also keep ``steps``, a histogram of those by size.
``launch_counts``, ``launch_sizes`` and ``launch_steps`` read them and
``reset_launch_counts`` clears them all, so a run can show which kernels
its main path went through, at what sizes and how deep.
"""
from typing import Dict

from repro_torch.kernels import (chain_order, flash_attention, hash_probe,
                                 pack_flush, quant_pack)

WRAPPERS = {
    "pack_rows": pack_flush.pack_rows,
    "jump_double": chain_order.jump_double,
    "walk_segments": chain_order.walk_segments,
    "expand_segments": chain_order.expand_segments,
    "gather_next": chain_order.gather_next,
    "quantize_blockwise": quant_pack.quantize_blockwise,
    "dequantize_blockwise": quant_pack.dequantize_blockwise,
    "scatter_rows": pack_flush.scatter_rows_,
    "flash_attention": flash_attention.flash_attention,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,
    "probe": hash_probe.probe,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_sizes() -> Dict[str, Dict[int, int]]:
    """Launches of each kernel by the power of two its main dimension
    rounds up to (pack_rows: rows of the launch; the chain kernels, probe:
    lanes or queries; the quantize kernels: rows; flash and its backward:
    query length)."""
    return {name: dict(sorted(fn.sizes.items()))
            for name, fn in WRAPPERS.items()}


def launch_steps() -> Dict[str, Dict[int, Dict[int, int]]]:
    """Launches of each looping kernel by size (as ``launch_sizes``), then
    by the hops or rounds the launch ran."""
    return {name: {size: dict(sorted(by.items()))
                   for size, by in sorted(fn.steps.items())}
            for name, fn in WRAPPERS.items() if hasattr(fn, "steps")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.sizes = {}
        if hasattr(fn, "steps"):
            fn.steps = {}
