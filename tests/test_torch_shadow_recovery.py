"""repro_torch recovery under shadow commit on one arena (DESIGN.md §9), on
the CPU against the JAX reference: the suites the reference's CI reruns
under ``REPRO_COMMIT_MODE=shadow``, each as a two-package test.

* Boundary sweeps (``tests/test_async_recovery.py``): a mixed DLL / B+Tree
  / hashmap arena crashed at every epoch boundary, on power loss and torn
  (the drain done, the flip not), recovered at concurrency 1 and 4; both
  packages' images, FlushStats, reports and recovered state equal, and the
  committed generation's state restored.  The commit modes recover the
  same logical state.
* Order snapshots (``tests/test_snapshot_recovery.py``'s shadow
  ``MODES``): images and FlushStats after every commit, the torn-record
  sweep, suffix replay and a torn epoch.
* The request journal's scenarios (``tests/test_journal.py``) on a shadow
  arena.
* The feature store at the ``("shadow", 1)`` point of ``FS_GRID``: the
  exactly-once oracle at every boundary, files and FlushStats request by
  request, cross-recovery; the serving engine's files, FlushStats and
  tokens through a crash and recovery.

Integer and byte results, compared exactly (tolerance 0).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_integrity as TI
import test_torch_journal as TJT
import test_torch_snapshot as TS
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models.model import build as jbuild
from repro.serve import engine as RE
from repro.serve.feature_store import FeatureConfig as JConfig
from repro.serve.feature_store import FeatureStore as JStore
from repro_torch import feature_recover as FR
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build as tbuild
from repro_torch.serve import engine as TE
from repro_torch.serve.feature_store import FeatureConfig as TConfig
from repro_torch.serve.feature_store import FeatureStore as TStore

PKG = TI.PKG
SHADOW = {"commit_mode": "shadow"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("REPRO_PAGED", raising=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------- boundary sweeps

def _crashed(pkg, ops, boundary, torn, mode, **kw):
    """A mixed arena that committed ops[0..boundary], then crashed inside
    op boundary + 1 (torn: after its drain)."""
    a, d, t, h = TI._mixed(pkg, None, mode, **kw)
    TI._run(a, d, t, h, ops[: boundary + 1])
    want = TI._fingerprint(d, t, h)
    if boundary + 1 < len(ops):
        with a.epoch():
            TI._apply(d, t, h, ops[boundary + 1])
            if torn:
                a.writeset.flush(include_meta=False)
            a.crash()
    else:
        a.crash()
    return (a, d, t, h), want


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("concurrency", [1, 4])
def test_crash_fuzz_every_boundary_shadow(monkeypatch, mode, torn,
                                          concurrency):
    """``test_crash_fuzz_every_boundary`` under shadow commit: the
    committed generation's state comes back at every boundary, and both
    packages agree on every byte, counter and report."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = TI._script(8, seed=3)
    for boundary in range(len(ops)):
        out = {}
        for pkg in PKG:
            (a, d, t, h), want = _crashed(pkg, ops, boundary, torn, mode,
                                          **SHADOW)
            rep = TI._manager(pkg, a, d, t, h).recover(
                concurrency=concurrency)
            assert rep.valid and rep.generation == boundary + 1
            got = TI._fingerprint(d, t, h)
            assert got == want, (pkg, boundary)
            out[pkg] = (TI._report(rep), got, TI._image(a), TI._stats(a))
        assert out["port"] == out["ref"], boundary


@pytest.mark.parametrize("torn", [False, True])
def test_commit_modes_recover_identical_logical_state(monkeypatch, torn):
    """DESIGN.md §9: the shadow commit changes where uncommitted bytes
    live, never what recovery rebuilds.  At every boundary the port's
    barrier and shadow arenas recover the same structure state, and the
    shadow one that of the reference's shadow arena; a crashed B+Tree
    epoch leaves none of its keys behind under shadow."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = TI._script(6, seed=5)
    for boundary in range(len(ops)):
        state = {}
        for pkg, cm in (("port", "barrier"), ("port", "shadow"),
                        ("ref", "shadow")):
            (a, d, t, h), _ = _crashed(pkg, ops, boundary, torn, "partly",
                                       commit_mode=cm)
            rep = TI._manager(pkg, a, d, t, h).recover(concurrency=2)
            assert rep.valid and rep.generation == boundary + 1
            fp = TI._fingerprint(d, t, h)
            state[pkg, cm] = {k: fp[k] for k in ("dll", "bt.keys",
                                                 "hm.keys", "hm.values")}
            if cm == "shadow" and boundary + 1 < len(ops) \
                    and ops[boundary + 1][0] == "bt":
                ok, _ = t.find_batch(ops[boundary + 1][1])
                assert not _host(ok).any()
        if not torn:
            assert state["port", "barrier"] == state["port", "shadow"]
        else:
            # a torn barrier B+Tree epoch may surface its keys in place
            for k in ("dll", "hm.keys", "hm.values"):
                assert state["port", "barrier"][k] == \
                    state["port", "shadow"][k]
        assert state["port", "shadow"] == state["ref", "shadow"]


# ------------------------------------------------------------ snapshots

@pytest.mark.parametrize("mode", ["partly", "full"])
def test_snapshot_images_and_stats_after_every_commit_shadow(mode):
    """``test_images_and_stats_identical_after_every_commit`` on shadow
    arenas: records sealed at commits and at plain drains, a crash and
    snapshot adoption, then more steps on the resumed providers."""
    sides = {pkg: TS._build(pkg, mode, **SHADOW) for pkg in PKG}
    ops = {pkg: TS._Ops(21) for pkg in PKG}
    snaps = {pkg: [] for pkg in PKG}
    for phase in range(2):
        for i in range(20):
            for pkg, (a, d, h) in sides.items():
                ops[pkg].step(d, h, i)
                if i % 3 != 1:
                    a.commit()
                    snaps[pkg].append((TS._image(a), TS._stats(a)))
        for pkg, (a, d, h) in sides.items():
            a.crash()
            a.reopen()
            snaps[pkg].append(TS._reconstruct(pkg, d, h))
    assert snaps["port"][-1][1]["chain"] == "snapshot"
    for want, got in zip(snaps["ref"], snaps["port"]):
        if isinstance(want[0], np.ndarray):
            np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    TS._assert_same(TS._state(*sides["ref"][1:], ops["ref"].keys),
                    TS._state(*sides["port"][1:], ops["port"].keys))


@pytest.mark.parametrize("tear", ["record", "all"])
def test_torn_snapshot_record_sweep_shadow(tear):
    """Crash mid-snapshot-append at every commit boundary of a shadow
    arena: both packages recover the committed state with equal stage
    detail, by an older record and a suffix replay or the fallback."""
    ops = TS._script(12)
    for boundary in range(len(ops)):
        out = {}
        for pkg in PKG:
            a, d, h = TS._build(pkg, dll_cap=256, **SHADOW)
            hm_keys, dll_ids = [], []
            for i in range(boundary + 1):
                TS._apply(d, h, ops[i], dll_ids)
                if ops[i][0] == "hm":
                    hm_keys.extend(ops[i][1].tolist())
                a.commit()
            want = TS._state(d, h, hm_keys)
            a.crash()
            a.reopen()
            TS._tear(d, h, tear)
            det = TS._reconstruct(pkg, d, h)
            got = TS._state(d, h, hm_keys)
            TS._assert_same(TS._logical(want), TS._logical(got))
            out[pkg] = (det, got)
        assert out["port"][0] == out["ref"][0], boundary
        TS._assert_same(out["ref"][1], out["port"][1])


def test_suffix_replay_and_torn_epoch_shadow():
    """Tear the newest record: both packages replay exactly the rows
    committed after the previous one.  Then a torn epoch: the drained but
    unflipped bank is never read."""
    dets = {}
    for pkg in PKG:
        a, d, h = TS._build(pkg, "partly", dll_cap=256, **SHADOW)
        d.append_batch(np.arange(280).reshape(40, 7).astype(np.int64))
        a.commit()
        k = np.arange(50, dtype=np.int64)
        h.insert_batch(k, np.tile(k[:, None], (1, 7)))
        a.commit()
        d.append_batch(np.ones((9, 7), np.int64))
        a.commit()
        h.insert_batch(k + 100, np.zeros((50, 7), np.int64))
        a.commit()
        keys = k.tolist() + (k + 100).tolist()
        want = TS._state(d, h, keys)
        a.crash()
        a.reopen()
        TS._tear(d, h, "record")
        first = TS._reconstruct(pkg, d, h)
        TS._assert_same(TS._logical(want), TS._logical(TS._state(d, h,
                                                                 keys)))
        with a.epoch():
            d.append_batch(np.ones((6, 7), np.int64))
            h.insert_batch(np.arange(300, 310), np.ones((10, 7), np.int64))
            a.writeset.flush(include_meta=False)
            a.crash()
        a.reopen()
        second = TS._reconstruct(pkg, d, h)
        TS._assert_same(TS._logical(want), TS._logical(TS._state(d, h,
                                                                 keys)))
        dets[pkg] = (first, second, TS._image(a).tobytes())
    assert dets["port"] == dets["ref"]
    assert dets["port"][0][0]["chain"] == "snapshot"
    assert dets["port"][0][0]["replayed"] == 9
    assert dets["port"][0][1]["replayed"] == 50


# -------------------------------------------------------------- journal

REF = SimpleNamespace(**{**vars(TJT.REF), "kw": dict(SHADOW)})
PORT = SimpleNamespace(**{**vars(TJT.PORT),
                          "kw": {"device": "cpu", **SHADOW}})


@pytest.mark.parametrize("scenario", TJT.SCENARIOS, ids=lambda f: f.__name__)
def test_journal_matches_reference_shadow(monkeypatch, scenario):
    """Every journal scenario on a shadow arena: the same events, classes,
    head and tail, the same image and the same flush counters."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ra, rj, rev = scenario(REF)
    ta, tj, tev = scenario(PORT)
    assert ta.commit_mode == ra.commit_mode == "shadow"
    assert tev == rev
    assert tj.classify() == rj.classify()
    assert tj.must_retry() == rj.must_retry()
    assert (tj.head, tj.tail, tj.space()) == (rj.head, rj.tail, rj.space())
    assert np.array_equal(REF.image(ra), PORT.image(ta))
    assert dataclasses.asdict(ta.stats) == dataclasses.asdict(ra.stats)


# --------------------------------------------------------- feature store

def _store_cfg(cls, **kw):
    return cls(n_keys=64, dim=3, n_samples=512, commit_mode="shadow", **kw)


@pytest.mark.parametrize("torn", [False, True])
def test_feature_store_exactly_once_every_boundary_shadow(monkeypatch,
                                                          torn):
    """The ``("shadow", 1)`` point of ``FS_GRID``: a crash at every epoch
    boundary (torn inside a request, or clean between), recover, replay
    the whole script; completed requests are refused, the rest apply once,
    and the effects equal the uninterrupted twin's, which equal the
    reference's shadow store's."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = FR.oracle_script(6, seed=13)
    cfg = dataclasses.replace(FR.oracle_config(), **SHADOW)
    want = FR.run_twin(cfg, ops, "cpu")
    ref = JStore(_store_cfg(JConfig, journal=True))
    for op in ops:
        assert ref.apply(*op)
    np.testing.assert_array_equal(want["effects"]["vectors"],
                                  ref.lookup(np.arange(64)))
    np.testing.assert_array_equal(want["effects"]["counts"], ref.counts)
    assert want["effects"]["classify"] == ref.journal.classify()
    assert want["stats"] == dataclasses.asdict(
        ref.arena.stats.delta(type(ref.arena.stats)()))
    last = len(ops) if not torn else len(ops) - 1
    for boundary in range(last + 1):
        out = FR.twin(cfg, ops, boundary, torn=torn, device="cpu",
                      concurrency=2, want=want)
        assert out["refused"] == boundary


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("journal", [True, False])
def test_feature_store_files_and_recovery_shadow(monkeypatch, tmp_path, mode,
                                                 journal):
    """Files and FlushStats after every request, recovery stage details
    and state after a crash, then more requests: both packages' shadow
    stores."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    kw = dict(mode=mode, journal=journal)
    ref = JStore(_store_cfg(JConfig, **kw), str(tmp_path / "ref"))
    port = TStore(_store_cfg(TConfig, **kw), str(tmp_path / "port"),
                  device="cpu")
    ops = FR.oracle_script(16, seed=3)

    def same():
        assert (tmp_path / "ref").read_bytes() == \
            (tmp_path / "port").read_bytes()
        assert dataclasses.asdict(port.arena.stats) == \
            dataclasses.asdict(ref.arena.stats)
        keys = np.arange(72)
        np.testing.assert_array_equal(port.lookup(keys).numpy(),
                                      ref.lookup(keys))
        assert port.next_sample == ref.next_sample

    for op in ops[:10]:
        assert ref.apply(*op) == port.apply(*op) is True
        same()
    ref.apply(*ops[10], _torn_crash=True)
    port.apply(*ops[10], _torn_crash=True)
    rr, pr = ref.recover(concurrency=2), port.recover(concurrency=2)
    strip = {"seconds", "t_start", "t_end", "ready_at"}
    assert [(s.name, {k: v for k, v in s.detail.items() if k not in strip})
            for s in pr.stages] == \
        [(s.name, {k: v for k, v in s.detail.items() if k not in strip})
         for s in rr.stages]
    same()
    for op in ops[10:]:
        assert port.apply(*op) == ref.apply(*op)
    same()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_feature_store_cross_recovery_shadow(monkeypatch, tmp_path, writer):
    """A shadow store written by either package, its last request torn,
    recovers in the other to the writer's committed state."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = FR.oracle_script(12, seed=7)
    path = str(tmp_path / "store")
    w = JStore(_store_cfg(JConfig, journal=True), path) if writer == "ref" \
        else TStore(_store_cfg(TConfig, journal=True), path, device="cpu")
    for op in ops[:8]:
        assert w.apply(*op)
    w.apply(*ops[8], _torn_crash=True)
    r = TStore(_store_cfg(TConfig, journal=True), path, device="cpu") \
        if writer == "ref" else JStore(_store_cfg(JConfig, journal=True),
                                       path)
    r.recover()
    w.recover()
    np.testing.assert_array_equal(_host(r.lookup(np.arange(64))),
                                  _host(w.lookup(np.arange(64))))
    assert r.journal.classify() == w.journal.classify()
    assert [r.apply(*op) for op in ops] == [False] * 8 + [True] * 4


# -------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def models():
    jm = jbuild(jbase.reduced(jreg.get("llama3.2-3b")),
                compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tbuild(tbase.reduced(treg.get("llama3.2-3b")),
                compute_dtype=torch.float32)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("journal", [True, False])
def test_engine_matches_reference_shadow(monkeypatch, models, tmp_path,
                                         journal):
    """The serving engine with both arenas on shadow commit: tokens, the
    engine's file, both arenas' FlushStats and images, before and after a
    crash and recovery, and a torn admission epoch."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    jm, jp, tm, tp = models
    kw = dict(max_batch=3, s_max=24, max_requests=16, journal=journal,
              **SHADOW)
    ref = RE.ServingEngine(jm, jp, RE.EngineConfig(**kw),
                           arena_path=str(tmp_path / "ref"))
    port = TE.ServingEngine(tm, tp, TE.EngineConfig(**kw),
                            arena_path=str(tmp_path / "port"), device="cpu")
    assert port.arena.commit_mode == port.paging.arena.commit_mode == \
        "shadow"

    def same():
        assert (tmp_path / "ref").read_bytes() == \
            (tmp_path / "port").read_bytes()
        for pa, ra in ((port.arena, ref.arena),
                       (port.paging.arena, ref.paging.arena)):
            assert dataclasses.asdict(pa.stats) == dataclasses.asdict(
                ra.stats)
            assert np.array_equal(np.asarray(pa._mm), np.asarray(ra._mm))
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
    for _ in range(2):
        toks.append((ref.step(), port.step()))
    same()
    for e in (ref, port):
        e.crash()
        e.recover()
    for rs, ps in zip(ref.last_recovery.stages, port.last_recovery.stages):
        assert ps.name == rs.name
        assert {k: v for k, v in ps.detail.items()
                if not k.endswith("_s")} == \
            {k: v for k, v in rs.detail.items() if not k.endswith("_s")}
    for _ in range(2):
        toks.append((ref.step(), port.step()))
    same()
    assert all(r == p for r, p in toks)
