"""Persistence policy: the paper's essential/redundant field classification
lifted to training state trees.  The port of ``repro.core.policy``.

Every leaf of a state tree is classified as:

* ESSENTIAL    — must be persisted (params, step, data-order seed).
* DERIVABLE    — never persisted; reconstructed exactly on restore (the
                 RNG key from seed and step, schedule, pipeline cursor).
* APPROXIMABLE — tolerably reconstructible (Adam moments); per policy
                 "persist" (bit-exact), "quantize8" (int8 blockwise, 4x
                 fewer bytes, bounded error) or "drop" (re-warm from
                 zeros).

The reference walks JAX pytrees; the port walks torch trees with
``tree_flatten_with_path``, in JAX's order: dicts by sorted key,
NamedTuple fields and list/tuple items in order, ``None`` an empty
subtree, anything else a leaf.  A path is a tuple of keys (dict keys and
field names as str, sequence positions as ``"[i]"``), joined by
``path_str`` into ``"params/blocks/pos0/attn/wq"``.  Leaf dtypes are
reported as numpy dtypes, the manifest's names, and bf16 as
``BFLOAT16``: numpy has no bfloat16 of its own (the reference's comes
from ``ml_dtypes``, which the port does not use), so that object stands
for it where a plan or a manifest needs its name and width.
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["Kind", "BFLOAT16", "DEFAULT_RULES", "NUMPY_DTYPES",
           "TORCH_DTYPES", "manifest_dtype", "quantizable",
           "PersistPolicy", "FULLY_PERSISTENT", "PARTLY_PERSISTENT",
           "PARTLY_Q8", "PARTLY_DROP", "LeafPlan",
           "classify", "leaf_dtype", "path_str", "persisted_bytes", "plan",
           "tree_flatten_with_path", "tree_map", "tree_unflatten"]


class Kind(enum.Enum):
    ESSENTIAL = "essential"
    DERIVABLE = "derivable"
    APPROXIMABLE = "approximable"


# Path-suffix rules (matched against "/".join(path keys)).
DEFAULT_RULES: Tuple[Tuple[str, Kind], ...] = (
    ("params/*", Kind.ESSENTIAL),
    ("step", Kind.ESSENTIAL),
    ("data_seed", Kind.ESSENTIAL),
    ("mu/*", Kind.APPROXIMABLE),
    ("nu/*", Kind.APPROXIMABLE),
    ("rng", Kind.DERIVABLE),
    ("schedule/*", Kind.DERIVABLE),
    ("pipeline/*", Kind.DERIVABLE),
    ("cache/*", Kind.DERIVABLE),
    ("paging/*", Kind.DERIVABLE),
)

class _BFloat16:
    """bfloat16 as a plan and a manifest name it: ``str`` gives the
    manifest's ``"bfloat16"``, ``itemsize`` its 2 bytes.  Its leaves
    persist as raw 2-byte words (``ckpt/manager.py``)."""
    name = "bfloat16"
    itemsize = 2

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return "BFLOAT16"


BFLOAT16 = _BFloat16()

# the dtypes a persisted leaf may have, torch -> numpy (the manifest's name)
NUMPY_DTYPES = {torch.float32: np.dtype("float32"),
                torch.int32: np.dtype("int32"),
                torch.uint32: np.dtype("uint32"),
                torch.bfloat16: BFLOAT16}
TORCH_DTYPES = {v: k for k, v in NUMPY_DTYPES.items()}


def manifest_dtype(name: str):
    """The dtype a manifest names: ``BFLOAT16`` or a numpy dtype."""
    return BFLOAT16 if name == BFLOAT16.name else np.dtype(name)


def quantizable(dtype) -> bool:
    """Whether PARTLY_Q8 quantizes a leaf of this dtype: a numpy floating
    type.  The reference asks ``np.issubdtype(dtype, np.floating)``, which
    is False for ml_dtypes' bfloat16, so bf16 moments persist raw."""
    return dtype is not BFLOAT16 and np.issubdtype(dtype, np.floating)


# ------------------------------------------------------------------ trees

def _children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a container in JAX's flatten order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def tree_flatten_with_path(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in JAX's flatten order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _flatten_into(out, tree, ())
    return out


# The walks below are module functions, not closures that call themselves:
# a nested recursive function is a reference cycle (the function, its
# cell), which keeps whatever its cells hold (the flattened leaves, the
# unflattened ones' iterator) alive until the garbage collector runs, so
# a train step's old parameters and gradients outlived it.
def _flatten_into(out: list, node, path) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, c in kids:
        _flatten_into(out, c, path + (k,))


def tree_unflatten(skeleton, leaves):
    """A tree shaped as ``skeleton`` holding ``leaves`` (in flatten
    order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def tree_map(fn: Callable, tree, with_path: bool = False):
    """``tree`` with every leaf replaced by ``fn(leaf)`` (``fn(path,
    leaf)`` with ``with_path``), containers rebuilt as they were."""
    return _map(fn, tree, (), with_path)


def _map(fn: Callable, node, path, with_path: bool):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return fn(path, node) if with_path else fn(node)
    if isinstance(node, dict):       # rebuilt in sorted order, as JAX
        return {k: _map(fn, node[k], path + (str(k),), with_path)
                for k in sorted(node)}
    vals = [_map(fn, c, path + (k,), with_path) for k, c in kids]
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def path_str(path) -> str:
    if isinstance(path, str):
        return path
    return "/".join(str(k) for k in path)


def leaf_dtype(leaf):
    """A leaf's dtype as numpy names it (``BFLOAT16`` for bf16, also for
    an ml_dtypes array of the reference's); NotImplementedError for a
    dtype the checkpoint format does not carry yet."""
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        if dt not in NUMPY_DTYPES:
            raise NotImplementedError(
                f"{dt} leaves are not ported to repro_torch's checkpoint "
                f"yet (supported: float32, bfloat16, int32, uint32)")
        return NUMPY_DTYPES[dt]
    dt = np.dtype(dt)
    if dt.name == BFLOAT16.name:
        return BFLOAT16
    if dt not in TORCH_DTYPES:
        raise NotImplementedError(f"{dt} leaves are not ported to "
                                  f"repro_torch's checkpoint yet")
    return dt


# --------------------------------------------------------------- policies

def classify(path, rules=DEFAULT_RULES) -> Kind:
    p = path_str(path)
    for pat, kind in rules:
        if fnmatch.fnmatch(p, pat) or fnmatch.fnmatch(p, pat + "/*") or \
                fnmatch.fnmatch(p, "*/" + pat):
            return kind
    return Kind.ESSENTIAL  # unknown leaves default to safe


@dataclasses.dataclass(frozen=True)
class PersistPolicy:
    """What gets written at a checkpoint."""
    name: str                      # "full" | "partly"
    approx: str = "persist"        # persist | quantize8 | drop
    rules: Tuple[Tuple[str, Kind], ...] = DEFAULT_RULES

    def persisted_kinds(self) -> Tuple[Kind, ...]:
        if self.name == "full":
            return (Kind.ESSENTIAL, Kind.DERIVABLE, Kind.APPROXIMABLE)
        if self.approx == "drop":
            return (Kind.ESSENTIAL,)
        return (Kind.ESSENTIAL, Kind.APPROXIMABLE)


FULLY_PERSISTENT = PersistPolicy("full")
PARTLY_PERSISTENT = PersistPolicy("partly", approx="persist")
PARTLY_Q8 = PersistPolicy("partly", approx="quantize8")
PARTLY_DROP = PersistPolicy("partly", approx="drop")


@dataclasses.dataclass
class LeafPlan:
    path: str
    kind: Kind
    shape: Tuple[int, ...]
    dtype: Any                     # numpy dtype, or BFLOAT16
    nbytes: int
    persisted: bool
    quantized: bool


def plan(state: Any, policy: PersistPolicy) -> List[LeafPlan]:
    """Per-leaf persistence plan + byte accounting, in flatten order."""
    out: List[LeafPlan] = []
    kinds = policy.persisted_kinds()
    for path, leaf in tree_flatten_with_path(state):
        kind = classify(path, policy.rules)
        quant = (policy.name == "partly" and policy.approx == "quantize8"
                 and kind == Kind.APPROXIMABLE)
        persisted = kind in kinds
        shape = tuple(int(d) for d in leaf.shape)
        dtype = leaf_dtype(leaf)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        # quantized: int8 payload + f32 scale per 256-block
        nbytes = n + 4 * ((n + 255) // 256) if quant else n * dtype.itemsize
        out.append(LeafPlan(path_str(path), kind, shape, dtype,
                            nbytes if persisted else 0, persisted, quant))
    return out


def persisted_bytes(state: Any, policy: PersistPolicy) -> int:
    return sum(p.nbytes for p in plan(state, policy))
