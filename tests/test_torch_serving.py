"""repro_torch serving engine, paged-KV allocator and twin-protocol
recovery, on the CPU against the JAX reference.

* The port's engine and the reference's take the same requests on the
  reduced llama3.2-3b (f32, the reference's parameters carried over):
  identical tokens at every step, byte-identical engine arena files and
  equal FlushStats (``journal_lines`` and ``snapshot_lines`` included),
  before and after a crash and recovery, journal on and off.  The two
  steps feed the last token at different positions (the port at its own,
  p-1; the reference at p); this model's greedy tokens repeat its last
  input, so both give the same tokens.  Where tokens vary (the reduced
  model's weights scaled 30-fold), every step of the port's engine,
  before and after a crash, is held against the reference model's
  prefill and decode_step at the port's positions: tokens equal, logits
  within 1e-4 of the largest |logit|.
* Twin protocol (``repro_torch.serve_recover.run``): a crashed and
  recovered engine against one that never crashed: caches equal within
  1e-4 of the largest |k|, |v|, logits within 1e-4 relative, tokens equal,
  at recovery concurrency 1 and 2.
* Duplicate admission, per-group admission events, ``PagedAllocator``
  parity and recovery, and the axes the port does not have.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models.model import build as jbuild
from repro.serve import engine as RE
from repro.serve.kvcache import PagedAllocator as RPA
from repro.serve.kvcache import PagedConfig as RPC
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.interop import image_of, params_from_numpy
from repro_torch.kernels import launch_counts
from repro_torch.models.model import build as tbuild
from repro_torch.serve import engine as TE
from repro_torch.serve.journal import DuplicateRequestError
from repro_torch.serve.kvcache import PagedAllocator as TPA
from repro_torch.serve.kvcache import PagedConfig as TPC
from repro_torch.serve_recover import run

TIMING = {"first_admission_s", "last_admission_s"}


@pytest.fixture(autouse=True)
def _no_integrity(monkeypatch):
    # integrity pinned off in both packages: these tests hold the
    # integrity-free bytes (tests/test_torch_integrity.py holds the rest)
    monkeypatch.setenv("REPRO_INTEGRITY", "0")


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jbase.reduced(jreg.get("llama3.2-3b")),
                compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tbuild(tbase.reduced(treg.get("llama3.2-3b")),
                compute_dtype=torch.float32)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engines(models, tmp_path, **ec):
    jm, jp, tm, tp = models
    kw = dict(max_batch=3, s_max=24, max_requests=16, **ec)
    ref = RE.ServingEngine(jm, jp, RE.EngineConfig(**kw),
                           arena_path=str(tmp_path / "ref"))
    port = TE.ServingEngine(tm, tp, TE.EngineConfig(**kw),
                            arena_path=str(tmp_path / "port"), device="cpu")
    return ref, port


def _same_state(ref, port, tmp_path):
    assert (tmp_path / "ref").read_bytes() == (tmp_path / "port").read_bytes()
    assert dataclasses.asdict(port.arena.stats) == \
        dataclasses.asdict(ref.arena.stats)
    assert dataclasses.asdict(port.paging.arena.stats) == \
        dataclasses.asdict(ref.paging.arena.stats)
    assert np.array_equal(image_of(port.paging.arena),
                          np.asarray(ref.paging.arena._mm))
    assert np.array_equal(port.pos, ref.pos)
    assert np.array_equal(port.slot_rid, ref.slot_rid)


def _drive(ref, port, tmp_path, steps=3):
    for e in (ref, port):
        e.add_request(101, np.array([1, 2, 3, 4], np.int64))
        e.add_request(202, np.array([9, 8, 7], np.int64))
    toks = []
    for _ in range(steps):
        toks.append((ref.step(), port.step()))
    for e in (ref, port):
        assert e.finish_request(101) == 4 + steps
        e.add_request(303, np.array([5, 6, 7, 8, 9], np.int64))
    for _ in range(steps):
        toks.append((ref.step(), port.step()))
    _same_state(ref, port, tmp_path)
    for e in (ref, port):
        e.crash()
        e.recover()
    rst, pst = ref.last_recovery.stages, port.last_recovery.stages
    assert [s.name for s in pst] == [s.name for s in rst]
    for rs, ps in zip(rst, pst):
        assert {k: v for k, v in ps.detail.items() if k not in TIMING} \
            == {k: v for k, v in rs.detail.items() if k not in TIMING}
    for _ in range(steps):
        toks.append((ref.step(), port.step()))
    _same_state(ref, port, tmp_path)
    return toks


@pytest.mark.parametrize("journal", [True, False])
def test_engine_matches_reference(models, tmp_path, journal):
    ref, port = _engines(models, tmp_path, journal=journal)
    assert (port.journal is None) == (not journal)
    toks = _drive(ref, port, tmp_path)
    assert all(r == p for r, p in toks)
    st = port.arena.stats
    assert (st.journal_lines > 0) == journal and st.snapshot_lines > 0
    assert launch_counts()["scatter_rows"] == 0     # CPU: plain versions


def test_recovery_matches_twin_where_tokens_vary(models, tmp_path):
    """Where greedy tokens change from step to step, the port's recovered
    engine still equals its uninterrupted twin (caches, logits, tokens),
    while the reference's does not: its step feeds token p-1 at position
    p, so a re-prefill caches different tokens than decoding did (ROADMAP
    Queue 3).  The port's step feeds it at p-1."""
    cfg = dataclasses.replace(tbase.reduced(treg.get("llama3.2-3b")),
                              d_model=256, n_heads=8, n_kv_heads=4,
                              head_dim=32, d_ff=512, vocab=8192)
    out = run(cfg, "cpu", prompt_lens=(20, 20, 12, 7), max_batch=4,
              s_max=48, steps=4, max_requests=16)
    assert out["cache"]["rel_err"] <= 1e-4
    assert out["distinct_tokens"] > 5          # not just the 5 echoes
    # the reference at weights that do not echo: twin and recovered
    # engine part ways after the crash
    jm, jp, _, _ = models
    jp = jax.tree.map(lambda x: x * 30.0 if x.ndim > 1 and
                      x.shape[0] != jm.cfg.vocab_padded else x, jp)
    engines = []
    for name in ("twin", "crashed"):
        e = RE.ServingEngine(jm, jp, RE.EngineConfig(max_batch=2, s_max=24,
                                                     max_requests=16),
                             arena_path=str(tmp_path / name))
        e.add_request(101, np.array([1, 2, 3, 4], np.int64))
        e.add_request(202, np.array([9, 8, 7], np.int64))
        for _ in range(6):
            e.step()
        engines.append(e)
    engines[1].crash()
    engines[1].recover()
    assert [engines[0].step() for _ in range(3)] != \
        [engines[1].step() for _ in range(3)]


def _reference_decode(jm, jp, prompt, steps, s_max):
    """Greedy tokens and logits of one request through the reference
    model's prefill of every prompt token but the last and decode_step,
    each step feeding the last token at its own position p - 1 (the port
    engine's convention)."""
    log = [int(t) for t in prompt]
    _, kv = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None, :-1],
                                                  jnp.int32)},
                       s_max=s_max)
    logits = []
    for _ in range(steps):
        lg, kv = jm.decode_step(jp, kv, jnp.asarray([log[-1]], jnp.int32),
                                jnp.int32(len(log) - 1))
        logits.append(np.asarray(lg[0], np.float32))
        log.append(int(np.argmax(logits[-1])))
    return log[len(prompt):], logits


def test_engine_logits_match_reference_where_tokens_vary(models, tmp_path):
    """On weights whose greedy tokens do not echo the input, every step of
    the port's engine (before and after a crash and recovery) gives the
    reference model's tokens, and its logits within 1e-4 of the largest
    |logit|, computed by ``Model.prefill`` and ``decode_step`` of the JAX
    package at the port's positions."""
    jm, jp, tm, _ = models
    jp = jax.tree.map(lambda x: x * 30.0 if x.ndim > 1 and
                      x.shape[0] != jm.cfg.vocab_padded else x, jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    s_max, steps = 24, 4
    prompts = {101: np.array([1, 2, 3, 4], np.int64),
               202: np.array([9, 8, 7], np.int64)}
    want = {rid: _reference_decode(jm, jp, pr, 3 * steps, s_max)
            for rid, pr in prompts.items()}
    eng = TE.ServingEngine(tm, tp, TE.EngineConfig(max_batch=2, s_max=s_max,
                                                   max_requests=16),
                           arena_path=str(tmp_path / "port"), device="cpu")
    for rid, pr in prompts.items():
        eng.add_request(rid, pr)
    n = 0
    for phase in range(3):
        if phase == 2:
            eng.crash()
            eng.recover()
        for _ in range(steps):
            got = eng.step()
            for rid, tok in got.items():
                toks, logits = want[rid]
                assert tok == toks[n], (rid, n)
                ref = logits[n]
                err = np.abs(eng.step_logits[rid].numpy() - ref).max()
                assert err <= 1e-4 * np.abs(ref).max(), (rid, n, err)
            n += 1
    assert len({t for toks, _ in want.values() for t in toks}) > 5


@pytest.mark.parametrize("concurrency", [1, 2])
def test_twin_protocol_recovers_caches(concurrency):
    cfg = tbase.reduced(treg.get("llama3.2-3b"))
    out = run(cfg, "cpu", prompt_lens=(12, 12, 8, 5), max_batch=4, s_max=32,
              steps=3, max_requests=16, concurrency=concurrency)
    assert out["cache"]["rel_err"] <= 1e-4
    assert out["logit_rel_err"]["after"] <= 1e-4
    assert out["engine_detail"]["prefill_groups"] == 3   # tlen 18, 14, 11
    assert [g["tokens"] for g in sorted(out["groups"],
                                        key=lambda g: g["tokens"])] == \
        [11, 14, 18]
    assert out["stats"]["journal_lines"] > 0


def test_duplicate_request_error(models, tmp_path):
    _, port = _engines(models, tmp_path)
    port.add_request(7, np.array([1, 2, 3], np.int64))
    with pytest.raises(DuplicateRequestError):
        port.add_request(7, np.array([1, 2, 3], np.int64))
    port.step()
    port.finish_request(7)
    with pytest.raises(DuplicateRequestError):
        port.add_request(7, np.array([4], np.int64))
    with pytest.raises(KeyError):
        port.finish_request(7)
    port.crash()
    port.recover()
    assert 7 not in port.slot_rid.tolist()
    with pytest.raises(DuplicateRequestError):
        port.add_request(7, np.array([4], np.int64))
    port.readmit([7])                     # already completed: no entry
    assert port.journal.state_of(7) == "completed"


@pytest.mark.parametrize("concurrency", [1, 4])
def test_engine_admits_slots_per_prefill_group(models, tmp_path,
                                               concurrency):
    _, _, tm, tp = models
    eng = TE.ServingEngine(tm, tp, TE.EngineConfig(max_batch=3, s_max=16,
                                                   max_requests=16),
                           arena_path=str(tmp_path / "a"), device="cpu")
    eng.add_request(7, np.array([1, 2, 3], np.int64))        # plen 3
    eng.add_request(8, np.array([4, 5, 6, 9, 2], np.int64))  # plen 5
    eng.step()
    eng.crash()
    assert not eng.slot_ready.any()
    events = []
    lock = threading.Lock()

    def on_ready(slots, tlen, admitted_s):
        with lock:
            events.append((sorted(int(s) for s in slots), tlen,
                           eng.slot_ready.copy()))

    eng.on_slot_ready = on_ready
    eng.recover(concurrency=concurrency)
    eng.on_slot_ready = None
    assert len(events) == 2
    assert {e[1] for e in events} == {4, 6}    # tlen = plen + 1 step
    for slots, _tlen, bitmap in events:
        assert bitmap[slots].all()
    assert all(e[2][2] for e in events)        # the empty slot, at the scan
    assert eng.slot_ready.all()
    det = eng.last_recovery.stage("engine").detail
    assert det["prefill_groups"] == 2
    assert 0 < det["first_admission_s"] <= det["last_admission_s"]


def test_engine_refuses_journal_table_divergence(models, tmp_path):
    _, port = _engines(models, tmp_path)
    port.add_request(7, np.array([1, 2, 3], np.int64))
    port.crash()
    # the journal's persisted HEAD (word 4 of the table's header line)
    # forgets the admission: the two records now disagree
    port.journal.header._pview()[0, 4] = 0
    with pytest.raises(RuntimeError, match="divergence"):
        port.recover()


def test_paged_allocator_matches_reference_and_recovers(tmp_path):
    ref = RPA(RPC(n_pages=16, page_tokens=4), path=str(tmp_path / "r"))
    port = TPA(TPC(n_pages=16, page_tokens=4), path=str(tmp_path / "p"),
               device="cpu")
    for pa in (ref, port):
        pa.alloc(1, 6)
        pa.alloc(2, 6)
        assert len(pa.pages_free) == 4
        pa.alloc(3, 8)                 # exhaustion: LRU-evicts request 1
        assert (pa.owner == 3).sum() == 8
    assert np.array_equal(port.owner, ref.owner)
    assert np.array_equal(port.pages_free, ref.pages_free)
    owner, free = port.owner.copy(), sorted(port.pages_free)
    for pa in (ref, port):
        pa.arena.commit()
        pa.arena.crash()
        assert pa.recover() >= 0
    assert (tmp_path / "r").read_bytes() == (tmp_path / "p").read_bytes()
    assert np.array_equal(port.owner, owner)
    assert sorted(port.pages_free) == free
    assert port.page_of_node == ref.page_of_node
    for pa in (ref, port):
        pa.free_request(3)
        assert (pa.owner == 3).sum() == 0
    assert np.array_equal(port.pages_free, ref.pages_free)
    assert dataclasses.asdict(port.arena.stats) == \
        dataclasses.asdict(ref.arena.stats)


def _drive_sharded(ref, port, tmp_path):
    """``_drive`` for engines on sharded arenas: every shard file and the
    manifest, both arenas' FlushStats (aggregate and per shard) and the
    page pool's shard images, before and after a crash and recovery."""
    def files(prefix):
        return {f.name[len(prefix):]: f.read_bytes()
                for f in sorted(tmp_path.iterdir())
                if f.name.startswith(prefix + ".")}

    def same():
        assert files("ref") == files("port")
        for pa, ra in ((port.arena, ref.arena),
                       (port.paging.arena, ref.paging.arena)):
            assert dataclasses.asdict(pa.stats) == \
                dataclasses.asdict(ra.stats)
            assert [dataclasses.asdict(x) for x in pa.shard_stats()] == \
                [dataclasses.asdict(x) for x in ra.shard_stats()]
        assert np.array_equal(image_of(port.paging.arena), np.concatenate(
            [np.asarray(sh._mm) for sh in ref.paging.arena.shards]
            + [np.asarray(ref.paging.arena._man)]))
        assert np.array_equal(port.pos, ref.pos)
        assert np.array_equal(port.slot_rid, ref.slot_rid)

    toks = []
    for e in (ref, port):
        e.add_request(101, np.array([1, 2, 3, 4], np.int64))
        e.add_request(202, np.array([9, 8, 7], np.int64))
    for _ in range(3):
        toks.append((ref.step(), port.step()))
    for e in (ref, port):
        e.finish_request(101)
        e.add_request(303, np.array([5, 6, 7, 8, 9], np.int64))
    toks.append((ref.step(), port.step()))
    same()
    for e in (ref, port):
        e.crash()
        e.recover()
    for rs, ps in zip(ref.last_recovery.stages, port.last_recovery.stages):
        assert ps.name == rs.name
        assert {k: v for k, v in ps.detail.items() if k not in TIMING} \
            == {k: v for k, v in rs.detail.items() if k not in TIMING}
    toks.append((ref.step(), port.step()))
    same()
    return toks


@pytest.mark.parametrize("kw", [
    # sharding is ported in both commit modes: the engine at two shards
    # under shadow commit serves, crashes and recovers as the reference's
    pytest.param({"n_shards": 2, "commit_mode": "shadow"},
                 id="{'n_shards': 2}"),
    {"commit_mode": "shadow"}, {"paged": True}], ids=str)
def test_engine_unported_axes_raise(models, kw, tmp_path):
    if kw == {"commit_mode": "shadow"}:
        # shadow commit on one arena is ported: the engine serves, crashes
        # and recovers as the reference's, with its files and FlushStats
        ref, port = _engines(models, tmp_path, **kw)
        assert port.arena.commit_mode == "shadow"
        assert all(r == p for r, p in _drive(ref, port, tmp_path))
        return
    if kw.get("n_shards") == 2:
        ref, port = _engines(models, tmp_path, **kw)
        for a in (port.arena, port.paging.arena):
            assert a.commit_mode == "shadow" and a.n_shards == 2
        assert all(r == p for r, p in _drive_sharded(ref, port, tmp_path))
        return
    # paging is ported: on small blocks the token log, the request table
    # and the LRU's node slab page, and the engine serves, crashes and
    # recovers as the reference's, with its files, FlushStats, recovery
    # details (block_faults included) and the caches' counters
    ref, port = _engines(models, tmp_path, block_bytes=256, cache_blocks=4,
                         n_pages=64, **kw)
    assert port.paging.arena.regions["lru.nodes"].is_paged
    assert port.arena.regions["tokens"].is_paged
    assert all(r == p for r, p in _drive(ref, port, tmp_path))
    for rs, ps in zip(ref.last_recovery.stages, port.last_recovery.stages):
        assert ("block_faults" in ps.detail) == (rs.name != "reopen")
    names = ("faults", "hits", "evictions", "spills", "over_budget",
             "peak_resident_bytes")
    for ra, pa in ((ref.arena, port.arena),
                   (ref.paging.arena, port.paging.arena)):
        assert {k: getattr(pa.cache, k) for k in names} == \
            {k: getattr(ra.cache, k) for k in names}


def test_engine_salvage_and_device_checks(models, tmp_path):
    ref, port = _engines(models, tmp_path)
    # salvage is ported: with nothing corrupt it recovers as the reference
    for e in (ref, port):
        e.add_request(5, np.array([1, 2, 3], np.int64))
        e.crash()
        e.recover(salvage=True)
        assert e.quarantined_rids == set()
    for rs, ps in zip(ref.last_recovery.stages, port.last_recovery.stages):
        assert (ps.name, ps.quarantined, ps.degraded) == \
            (rs.name, rs.quarantined, rs.degraded)
        assert {k: v for k, v in ps.detail.items() if k not in TIMING} \
            == {k: v for k, v in rs.detail.items() if k not in TIMING}
    _, _, tm, tp = models
    with pytest.raises(ValueError):
        TE.ServingEngine(tm, tp, TE.EngineConfig(), device="meta")
