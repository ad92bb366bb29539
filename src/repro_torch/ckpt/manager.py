"""Checkpoint manager: persistence policies applied to TrainState, the
port of ``repro.ckpt.manager``.

The paper's discipline, end to end:

* plan: classify every leaf (core.policy) — ESSENTIAL / DERIVABLE /
  APPROXIMABLE — and compute the flush plan (bytes to persist).
* flush: APPROXIMABLE leaves under ``PARTLY_Q8`` are block-quantized to
  int8 on the card (``kernels/quant_pack.py``); every persisted tensor is
  copied to the host before ``save`` returns, then written as one ``.npz``
  per leaf, by a background thread with ``blocking=False``.
* commit protocol: leaf files are fully written and fsync'd BEFORE the
  manifest is atomically renamed into place (manifest-last: a crash
  mid-write leaves the previous checkpoint valid).
* restore: read the manifest, load persisted leaves (int8 payloads and
  scales go to the card and are dequantized there), RECONSTRUCT every
  DERIVABLE leaf (``rng`` from seed and step) and re-warm dropped moments
  from zeros.  ``restore(warmup="background")`` hands back host
  placeholders for dropped moments at once and materializes them on the
  card in a thread; ``finish_warmup(state)`` swaps them in.
* incremental mode: leaves whose content digest is unchanged since the
  previous checkpoint are not rewritten.

The files are the reference's: the same manifest (json key order
included), ``_leaf_file`` names, ``.npz`` keys ``q``/``s``/``x`` and md5
digests of the host bytes, so a checkpoint written by either package
restores in the other.  A bf16 leaf is written as the reference writes
its ml_dtypes array: the raw 2-byte words under an ``.npy`` header whose
descr is ``'<V2'`` (``_savez_words``; numpy alone would write ``'|V2'``),
manifest dtype ``"bfloat16"``, never quantized.  The port restores such a
leaf from its words; the reference cannot (its ``astype`` from ``'|V2'``
raises), a departure pinned in ROADMAP Queue 3.  Stage names and
details of the ``RecoveryReport`` are the reference's too.  Restoring
onto a mesh (``shardings=``) is not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import policy as pol
from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import not_ported, resolve_device
from repro_torch.core.recovery import RecoveryReport
from repro_torch.core.writeset import DigestWriteSet
from repro_torch.kernels import ops as kops
from repro_torch.train.state import TrainState

__all__ = ["CheckpointManager", "SaveReport"]


@dataclasses.dataclass
class SaveReport:
    step: int
    bytes_written: int
    bytes_skipped_derivable: int
    bytes_skipped_unchanged: int
    n_leaves_written: int
    seconds: float
    quantized: bool


def _leaf_file(path_str: str) -> str:
    h = hashlib.md5(path_str.encode()).hexdigest()[:16]
    return f"leaf_{h}.npz"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor that the caller
    may update while a background write runs)."""
    return t.detach().to("cpu", copy=True).contiguous().numpy()


def _words(t: torch.Tensor) -> np.ndarray:
    """A host copy of a bf16 tensor's 2-byte words."""
    return _host(t.view(torch.int16))


def _savez_words(f, host: Dict[str, np.ndarray]) -> None:
    """``np.savez(f, **host)`` for arrays of bf16 words: the same zip
    (stored, zip64 entries, numpy's fixed timestamps) and ``.npy``
    headers, with the descr ``'<V2'`` that ml_dtypes' bfloat16 gives."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": "<V2", "fortran_order": False,
                          "shape": val.shape})
                fid.write(memoryview(np.ascontiguousarray(val)).cast("B"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CheckpointManager:
    def __init__(self, directory: str, policy: pol.PersistPolicy,
                 incremental: bool = False, use_pack_kernel: bool = False):
        self.dir = directory
        self.policy = policy
        self.incremental = incremental
        # the reference stores this flag and reads it nowhere; kept for its
        # argument order, it changes no file
        self.use_pack_kernel = use_pack_kernel
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        # leaf-granularity write set: digests decide which leaves are
        # dirty this checkpoint ("don't persist what didn't change")
        self._writeset = DigestWriteSet()
        self.last_report: Optional[SaveReport] = None
        self.last_recovery: Optional[RecoveryReport] = None
        # background APPROXIMABLE warmup (restore(warmup="background"))
        self._warmer: Optional[threading.Thread] = None
        self._warm_result: Dict[int, Any] = {}
        self._warm_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, state: TrainState, blocking: bool = True) -> SaveReport:
        t0 = time.perf_counter()
        self.wait()
        sd = state.as_dict()
        plans = pol.plan(sd, self.policy)
        leaves = {pol.path_str(p): l
                  for p, l in pol.tree_flatten_with_path(sd)}

        to_write: Dict[str, Tuple[Dict[str, np.ndarray], dict]] = {}
        bytes_written = 0
        bytes_skipped_deriv = 0
        bytes_skipped_unchanged = 0
        quantized_any = False
        manifest: Dict[str, Any] = {"step": int(state.step),
                                    "policy": self.policy.name,
                                    "approx": self.policy.approx,
                                    "leaves": {}}

        for p in plans:
            leaf = leaves[p.path]
            raw_bytes = int(np.prod(p.shape or (1,))) * p.dtype.itemsize
            if not p.persisted:
                bytes_skipped_deriv += raw_bytes
                continue
            entry = {"shape": list(p.shape), "dtype": str(p.dtype),
                     "kind": p.kind.value, "file": _leaf_file(p.path),
                     "quantized": False}
            if p.quantized and pol.quantizable(p.dtype):
                q, s = kops.quantize_leaf(leaf)
                host = {"q": _host(q), "s": _host(s)}
                entry["quantized"] = True
                quantized_any = True
            elif p.dtype is pol.BFLOAT16:
                host = {"x": _words(leaf)}
            else:
                host = {"x": _host(leaf)}
            nbytes = sum(v.nbytes for v in host.values())
            md5 = hashlib.md5()
            for v in host.values():
                md5.update(v)             # the bytes of v.tobytes(), uncopied
            digest = md5.hexdigest()
            entry["digest"] = digest
            if self.incremental:
                present = os.path.exists(
                    os.path.join(self.dir, entry["file"]))
                if not self._writeset.dirty(p.path, digest, present):
                    bytes_skipped_unchanged += nbytes
                    manifest["leaves"][p.path] = entry
                    continue
            else:
                self._writeset.note(p.path, digest)
            to_write[p.path] = (host, entry)
            manifest["leaves"][p.path] = entry
            bytes_written += nbytes

        def write():
            for host, entry in to_write.values():
                fp = os.path.join(self.dir, entry["file"])
                with open(fp + ".tmp", "wb") as f:
                    if entry["dtype"] == pol.BFLOAT16.name \
                            and not entry["quantized"]:
                        _savez_words(f, host)
                    else:
                        np.savez(f, **host)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(fp + ".tmp", fp)
            # manifest-last commit (the paper's flag bit)
            mtmp = os.path.join(self.dir, "manifest.json.tmp")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(self.dir, "manifest.json"))

        def write_in_background():
            try:
                write()
            except BaseException as e:      # re-raised by wait()
                self._write_error = e

        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write_in_background,
                                            daemon=True)
            self._writer.start()

        report = SaveReport(
            step=manifest["step"], bytes_written=bytes_written,
            bytes_skipped_derivable=bytes_skipped_deriv,
            bytes_skipped_unchanged=bytes_skipped_unchanged,
            n_leaves_written=len(to_write),
            seconds=time.perf_counter() - t0, quantized=quantized_any)
        self.last_report = report
        return report

    def wait(self) -> None:
        """Join a background save; a failure inside it re-raises here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    # --------------------------------------------------------------- restore
    def valid(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "manifest.json"))

    def restore(self, state_spec: TrainState, shardings=None, device=None,
                warmup: str = "inline") -> TrainState:
        """state_spec: a TrainState of tensors (``meta`` ones will do)
        giving the target structure, shapes and dtypes.  Leaves land on
        ``device`` (None means the GPU).  DERIVABLE leaves are
        reconstructed, not read.

        warmup: "inline" re-warms dropped APPROXIMABLE leaves on the
        restore critical path; "background" returns host placeholders for
        them at once and materializes the device tensors in a thread —
        call ``finish_warmup(state)`` to join and swap them in.  The
        warmup stage is timed into the report either way (detail
        ``background=True`` marks the off-critical-path variant)."""
        if shardings is not None:
            raise not_ported("restore onto a mesh (shardings=)")
        if warmup not in ("inline", "background"):
            raise ValueError(f"warmup must be 'inline' or 'background', "
                             f"got {warmup!r}")
        device = resolve_device(device)
        self.wait()
        self.wait_warmup()
        if self._warm_result:
            # splicing THIS restore's indices into a state produced by a
            # previous one would corrupt it silently — refuse loudly
            raise RuntimeError(
                "unclaimed background warmup from a previous restore — "
                "call finish_warmup(state) on that state first")
        t_all = time.perf_counter()
        report = RecoveryReport()
        t0 = time.perf_counter()
        with open(os.path.join(self.dir, "manifest.json")) as f:
            manifest = json.load(f)
        step = manifest["step"]
        report.add("manifest", time.perf_counter() - t0, step=step)
        report.generation = step
        sd = state_spec._asdict()
        flat = pol.tree_flatten_with_path(sd)
        # first pass: the essential scalar reconstruction needs
        ent = manifest["leaves"].get("data_seed")
        seed = 0 if ent is None else int(
            self._load_leaf(ent, (), np.dtype(np.int32), device))

        out = []
        times = {"load_persisted": 0.0, "reconstruct_derivable": 0.0,
                 "rewarm_approximable": 0.0, "device_put": 0.0}
        counts = {k: 0 for k in times}
        deferred: Dict[int, Tuple[Tuple[int, ...], torch.dtype]] = {}
        for i, (pth, spec) in enumerate(flat):
            pstr = pol.path_str(pth)
            kind = pol.classify(pth, self.policy.rules)
            ent = manifest["leaves"].get(pstr)
            shape = tuple(int(d) for d in spec.shape)
            dtype = pol.leaf_dtype(spec)
            tdtype = pol.TORCH_DTYPES[dtype]
            t0 = time.perf_counter()
            if ent is not None:
                arr = self._load_leaf(ent, shape, dtype, device)
                stage = "load_persisted"
            elif kind == pol.Kind.DERIVABLE:
                arr = self._reconstruct_leaf(pstr, seed, step, shape, tdtype)
                stage = "reconstruct_derivable"
            elif kind == pol.Kind.APPROXIMABLE:
                # drop policy: re-warm from zeros
                arr = torch.zeros(shape, dtype=tdtype)
                stage = "rewarm_approximable"
                if warmup == "background":
                    # hand back the host placeholder now; the device
                    # tensor materializes off the critical path
                    deferred[i] = (shape, tdtype)
                    times[stage] += time.perf_counter() - t0
                    counts[stage] += 1
                    out.append(arr)
                    continue
            else:
                raise KeyError(f"essential leaf {pstr} missing from "
                               f"checkpoint")
            _sync(device)
            times[stage] += time.perf_counter() - t0
            counts[stage] += 1
            t0 = time.perf_counter()
            arr = arr.to(device)
            _sync(device)
            times["device_put"] += time.perf_counter() - t0
            counts["device_put"] += 1
            out.append(arr)
        for stage, secs in times.items():
            report.add(stage, secs, leaves=counts[stage],
                       background=(stage == "rewarm_approximable"
                                   and warmup == "background"))
        report.total_seconds = time.perf_counter() - t_all
        self.last_recovery = report
        if deferred:
            self._start_warmup(report, deferred, t_all, device)
        return TrainState(**pol.tree_unflatten(sd, out))

    # ------------------------------------------- background warmup stage
    def _start_warmup(self, report: RecoveryReport,
                      deferred: Dict[int, Tuple], t_anchor: float,
                      device: torch.device) -> None:
        self._warm_result = {}
        self._warm_error = None

        def warm():
            try:
                t0 = time.perf_counter()
                warmed: Dict[int, Any] = {
                    idx: torch.zeros(shape, dtype=dtype, device=device)
                    for idx, (shape, dtype) in deferred.items()}
                _sync(device)
                secs = time.perf_counter() - t0
                st = report.add("warmup_approximable", secs,
                                leaves=len(warmed), background=True)
                st.t_start = t0 - t_anchor
                st.t_end = st.t_start + secs
                self._warm_result = warmed
            except BaseException as e:   # surfaced by wait_warmup()
                self._warm_error = e

        self._warmer = threading.Thread(target=warm, daemon=True)
        self._warmer.start()

    def wait_warmup(self) -> None:
        """Join the background warmup thread; a failure inside it (an
        allocation on the card that fails) re-raises HERE rather than
        dying silently in the daemon thread."""
        if self._warmer is not None:
            self._warmer.join()
            self._warmer = None
        err, self._warm_error = self._warm_error, None
        if err is not None:
            raise err

    def finish_warmup(self, state: TrainState) -> TrainState:
        """Join the background warmup thread and swap the warmed device
        tensors into the restored state (leaf order matches restore's
        flatten order).  A no-op for inline restores."""
        self.wait_warmup()
        if not self._warm_result:
            return state
        sd = state.as_dict()
        leaves = [l for _, l in pol.tree_flatten_with_path(sd)]
        for idx, arr in self._warm_result.items():
            leaves[idx] = arr
        self._warm_result = {}
        return TrainState(**pol.tree_unflatten(sd, leaves))

    def _load_leaf(self, entry: dict, shape, dtype,
                   device: torch.device) -> torch.Tensor:
        """A persisted leaf: dequantized on ``device`` when quantized,
        else a host tensor (``device_put`` moves it).  A bf16 leaf's
        file holds its 2-byte words (``'<V2'``), read back as they are."""
        with np.load(os.path.join(self.dir, entry["file"])) as z:
            if entry.get("quantized"):
                q = torch.from_numpy(z["q"]).to(device)
                s = torch.from_numpy(z["s"]).to(device)
                return kops.dequantize_leaf(
                    q, s, tuple(entry["shape"]),
                    pol.TORCH_DTYPES[pol.manifest_dtype(entry["dtype"])])
            x = z["x"].reshape(shape)
            if dtype is pol.BFLOAT16:
                if x.dtype.itemsize == 2 and x.dtype.kind in "Vui":
                    return torch.from_numpy(
                        x.view(np.int16).copy()).view(torch.bfloat16)
                return torch.from_numpy(x).to(torch.bfloat16)
            return torch.from_numpy(x.astype(dtype, copy=False))

    def _reconstruct_leaf(self, pstr: str, seed: int, step: int, shape,
                          dtype: torch.dtype) -> torch.Tensor:
        if pstr == "rng":
            key, _ = rec.run("rng", seed, step)
            return key
        # unknown derivable leaves default to zeros (caches, cursors held
        # host-side are rebuilt by their owners)
        return torch.zeros(shape, dtype=dtype)
