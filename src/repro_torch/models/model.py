"""Model: config -> train, prefill and decode programs over a parameter
tree, the port of ``repro.models.model``.

Plain functions over the reference's parameter dictionary tree (the tree
``CheckpointManager`` and ``interop`` already carry), not ``nn.Module``s.
The superblock ``lax.scan`` of the reference is a Python loop over the
stacked leading dim: superblock j's parameters and caches are views
``leaf[j]``, and the per-layer caches of a prefill or decode are stacked
back on that dim.  Programs run on the device their parameters live on.
``compute_dtype`` defaults to bf16 as in the reference.

``loss`` is the training program: a full-sequence forward with no caches,
each superblock under the backbone's ``REMAT`` policy (its superblock
parameters unbound once, so their gradient is one stack, not one
full-size scatter per superblock), then the LM loss in sequence chunks of
``loss_chunk`` so that the (B, chunk, V) logits, not (B, S, V), are the
live working set; each chunk is recomputed in the backward
(``torch.utils.checkpoint``), as the reference remats it.

The ``vlm`` and ``audio`` families attend to a context (``_context``):
``batch["context"]`` (B, context_seq, d), image-patch embeddings, or the
encoder's output over ``batch["frames"]`` (B, encoder_seq, d), whose
bidirectional layers run in train mode, under the same remat policy
whenever a gradient is wanted (``_encode``).  The context goes to the
remat-wrapped superblock body as an argument, so its gradient (and the
encoder's) flows under every policy.  Decode takes no context: the cross
layers read the keys and values their prefill cached.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import (tree_flatten_with_path, tree_map,
                                     tree_unflatten)
from repro_torch.models import backbone as B
from repro_torch.models.layers import rms_norm

PyTree = Any


def _mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    vp = logits.shape[-1]
    if vp == vocab:
        return logits
    ids = torch.arange(vp, device=logits.device)
    return torch.where(ids < vocab, logits,
                       torch.finfo(logits.dtype).min)


def _unbind_blocks(blocks: PyTree, n_super: int):
    """The superblock parameter tree (leaves stacked on dim 0) as a list
    of ``n_super`` trees of views, one ``unbind`` per leaf."""
    flat = [leaf.unbind(0) for _, leaf in tree_flatten_with_path(blocks)]
    return [tree_unflatten(blocks, [views[j] for views in flat])
            for j in range(n_super)]


def _stack_caches(per_super, views=None, stacked=None) -> PyTree:
    """A list of per-superblock cache dicts -> one dict of stacked
    leaves.  A leaf every superblock passed on unchanged (each the same
    tensor as its ``views`` entry, superblock j's view of ``stacked``) is
    ``stacked``'s leaf itself, not a copy: decode's cross caches."""
    def leaf(pos, name):
        if views is not None and all(
                c[pos][name] is v[pos][name]
                for c, v in zip(per_super, views)):
            return stacked[pos][name]
        return torch.stack([c[pos][name] for c in per_super])
    return {pos: {name: leaf(pos, name) for name in per_super[0][pos]}
            for pos in per_super[0]}


class Model:
    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 loss_chunk: int = 512):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.loss_chunk = loss_chunk

    # ---------------- parameters ----------------
    def param_specs(self) -> PyTree:
        return B.param_specs(self.cfg)

    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> PyTree:
        return B.init_params(self.cfg, generator, device, dtype)

    def cache_specs(self, batch: int, s_max: int) -> PyTree:
        return B.cache_specs(self.cfg, batch, s_max, self.compute_dtype)

    def init_cache(self, batch: int, s_max: int, device=None) -> PyTree:
        return B.init_cache(self.cfg, batch, s_max, self.compute_dtype,
                            device)

    # ---------------- forward pieces ----------------
    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        e = params["embed"]
        return e[tokens.to(e.device, torch.int64)].to(self.compute_dtype)

    def _context(self, params: PyTree, batch: Dict[str, torch.Tensor],
                 mode: str) -> Optional[torch.Tensor]:
        """The cross layers' context: a vlm's ``batch["context"]`` in the
        compute dtype, an audio model's encoded ``batch["frames"]``
        (outside decode), else None."""
        cfg = self.cfg
        dev = params["embed"].device
        if cfg.family == "vlm":
            return torch.as_tensor(batch["context"]).to(dev,
                                                        self.compute_dtype)
        if cfg.family == "audio" and mode != "decode":
            return self._encode(params, torch.as_tensor(batch["frames"]))
        return None

    def _encode(self, params: PyTree, frames: torch.Tensor) -> torch.Tensor:
        """Whisper-style encoder over precomputed frame embeddings (the
        frontend is a stub): its bidirectional layers in train mode, each
        under the remat policy when a gradient is wanted (the reference
        remats them in every mode; without a gradient that changes no
        value, and serving skips the checkpoint's cost), then the final
        norm."""
        cfg = self.cfg
        x = frames.to(params["embed"].device, self.compute_dtype)
        blocks = params["enc_blocks"]["pos0"]

        def body(y, bp):
            return B.apply_layer(cfg, "dense:bidir", bp, y, mode="train")[0]
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for _, t in tree_flatten_with_path(blocks))):
            body = B.remat_wrap(body)
        for bp in _unbind_blocks(blocks, cfg.encoder_layers):
            x = body(x, bp)
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    def _stack(self, params: PyTree, x: torch.Tensor,
               ctx: Optional[torch.Tensor], mode: str,
               cache: Optional[PyTree] = None, pos: Optional[int] = None,
               s_max: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[PyTree]]:
        if mode == "train":
            return self._stack_train(params, x, ctx), None
        cfg = self.cfg
        pattern, n_super, rem = cfg.pattern_plan()
        new_cache: Dict[str, Any] = {}
        if n_super:
            per_super, views = [], []
            for j in range(n_super):
                bp = tree_map(lambda t: t[j], params["blocks"])
                bc = tree_map(lambda t: t[j], cache["blocks"]) \
                    if mode == "decode" else None
                views.append(bc)
                caches = {}
                for i, tag in enumerate(pattern):
                    x, caches[f"pos{i}"] = B.apply_layer(
                        cfg, tag, bp[f"pos{i}"], x, mode=mode, ctx=ctx,
                        cache=bc[f"pos{i}"] if bc is not None else None,
                        pos=pos, s_max=s_max)
                per_super.append(caches)
            new_cache["blocks"] = _stack_caches(per_super, views, cache[
                "blocks"]) if mode == "decode" else _stack_caches(per_super)
        if rem:
            rem_caches = {}
            for i, tag in enumerate(rem):
                x, rem_caches[f"rem{i}"] = B.apply_layer(
                    cfg, tag, params["rem"][f"rem{i}"], x, mode=mode,
                    ctx=ctx, cache=cache["rem"][f"rem{i}"]
                    if mode == "decode" else None, pos=pos, s_max=s_max)
            new_cache["rem"] = rem_caches
        return x, (new_cache or None)

    def _stack_train(self, params: PyTree, x: torch.Tensor,
                     ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        pattern, n_super, rem = cfg.pattern_plan()
        if n_super:
            # ctx is an argument of the checkpointed body, not a closure:
            # its gradient then flows under every remat policy
            def body(y, bp, c):
                for i, tag in enumerate(pattern):
                    y, _ = B.apply_layer(cfg, tag, bp[f"pos{i}"], y,
                                         mode="train", ctx=c)
                return y
            body = B.remat_wrap(body)
            for bp in _unbind_blocks(params["blocks"], n_super):
                x = body(x, bp, ctx)
        for i, tag in enumerate(rem):
            x, _ = B.apply_layer(cfg, tag, params["rem"][f"rem{i}"], x,
                                 mode="train", ctx=ctx)
        return x

    def _head(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d) -> logits (..., Vp) f32."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = params["embed"].to(self.compute_dtype).t()   # (d, Vp)
        else:
            w = params["lm_head"].to(self.compute_dtype)
        logits = torch.matmul(x, w).float()
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(
                logits / cfg.final_softcap)
        return logits

    # ---------------- public programs ----------------
    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean next-token cross entropy of batch["tokens"] (B, S) against
        batch["labels"] (B, S): the sum over all positions, in chunks of
        ``loss_chunk`` (the whole sequence when that does not divide S),
        divided by B * S.  A 0-d f32 tensor on the parameters' device."""
        cfg = self.cfg
        ctx = self._context(params, batch, "train")
        x = self._embed(params, batch["tokens"])
        labels = batch["labels"].to(x.device, torch.int64)
        x, _ = self._stack(params, x, ctx, "train")
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        b, s, _ = x.shape
        chunk = min(self.loss_chunk, s)
        if s % chunk:
            chunk = s
        n_chunks = s // chunk

        def ce_chunk(x_c, y_c):
            logits = _mask_padded_vocab(self._head(params, x_c), cfg.vocab)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y_c[..., None])[..., 0]
            return torch.sum(lse - gold)

        if n_chunks == 1:
            total = ce_chunk(x, labels)
        else:
            # recompute each chunk's (B, chunk, V) logits in the backward
            # from x_c instead of keeping them (one matmul)
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                total = total + checkpoint(ce_chunk, x[:, sl], labels[:, sl],
                                           use_reentrant=False)
        return total / (b * s)

    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """batch["tokens"]: (B, S).  s_max: decode-cache capacity to
        allocate (>= S; defaults to S).  A vlm's batch also holds
        "context" (B, context_seq, d), an audio model's "frames" (B,
        encoder_seq, d).  Returns (last-position logits (B, vocab_padded)
        f32, caches)."""
        ctx = self._context(params, batch, "prefill")
        x = self._embed(params, batch["tokens"])
        x, kv = self._stack(params, x, ctx, "prefill", s_max=s_max)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = self._head(params, x[:, -1])
        return _mask_padded_vocab(logits, self.cfg.vocab), kv

    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, PyTree]:
        """tokens: (B,) ints; pos: the position being written.  Returns
        (logits (B, vocab_padded) f32, new caches); ``cache`` is left as
        it was."""
        x = self._embed(params, tokens[:, None])
        x, kv = self._stack(params, x, None, "decode", cache=cache,
                            pos=int(pos))
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = self._head(params, x[:, 0])
        return _mask_padded_vocab(logits, self.cfg.vocab), kv


def build(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg, **kw)
