"""repro_torch's feature store, sample index and serving launcher, on the
CPU against the JAX reference.

* The same request script through both packages' ``FeatureStore``, both
  modes, journal on and off (and order snapshots off): byte-identical
  backing files and equal FlushStats after every request, equal
  ``lookup``, ``counts`` and ``next_sample``, and after a crash equal
  recovery stage details and state.
* Cross-recovery both ways: a store file written by either package
  recovers in the other to the writer's state.
* The duplicate-admission oracle of ``tests/test_async_recovery.py`` at
  its ("barrier", 1) grid point, through ``repro_torch.feature_recover``:
  a crash at every epoch boundary, torn and clean, recover, replay the
  whole script; the effects equal the uninterrupted twin's, which equal
  the reference's.
* ``journal_report``'s line, epoch and journal-line columns at the
  bench's own size equal ``benchmarks/recovery_bench.py``'s.
* ``SampleIndex``: the reference's recovery test, and parity with the
  JAX index.
* ``python -m repro_torch.launch.serve``: a dense arch and the xLSTM arch
  serve, crash and recover on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import recovery_bench as jbench
from repro.data.index import SampleIndex as JIndex
from repro.serve.feature_store import FeatureConfig as JConfig
from repro.serve.feature_store import FeatureStore as JStore
from repro_torch import feature_recover as FR
from repro_torch.core.arena import QuarantinedError
from repro_torch.data.index import SampleIndex as TIndex
from repro_torch.launch import serve as tserve
from repro_torch.serve.feature_store import FS_CURSOR
from repro_torch.serve.feature_store import FeatureConfig as TConfig
from repro_torch.serve.feature_store import FeatureStore as TStore

TIMING = {"seconds", "t_start", "t_end", "ready_at"}


@pytest.fixture(autouse=True)
def _no_integrity(monkeypatch):
    # integrity pinned off in both packages: these tests hold the
    # integrity-free bytes (tests/test_torch_integrity.py holds the rest)
    monkeypatch.setenv("REPRO_INTEGRITY", "0")


def _stores(tmp_path, **cfg):
    kw = dict(n_keys=64, dim=3, n_samples=512, **cfg)
    ref = JStore(JConfig(**kw), str(tmp_path / "ref"))
    port = TStore(TConfig(**kw), str(tmp_path / "port"), device="cpu")
    return ref, port


def _same(ref, port, tmp_path):
    assert (tmp_path / "ref").read_bytes() == \
        (tmp_path / "port").read_bytes()
    assert dataclasses.asdict(port.arena.stats) == \
        dataclasses.asdict(ref.arena.stats)
    keys = np.arange(ref.cfg.n_keys + 8)              # absent keys too
    np.testing.assert_array_equal(port.lookup(keys).numpy(),
                                  ref.lookup(keys))
    np.testing.assert_array_equal(port.counts.numpy(), ref.counts)
    np.testing.assert_array_equal(port.vectors.numpy(), ref.vectors)
    assert port.next_sample == ref.next_sample
    if ref.journal is not None:
        assert port.journal.classify() == ref.journal.classify()


def _details(report):
    return [(st.name, {k: v for k, v in st.detail.items()
                       if k not in TIMING}) for st in report.stages]


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("journal,snapshot", [(True, None), (False, None),
                                              (True, False)])
def test_store_matches_reference(tmp_path, mode, journal, snapshot):
    ref, port = _stores(tmp_path, mode=mode, journal=journal,
                        snapshot=snapshot)
    assert (port.journal is None) == (not journal)
    ops = FR.oracle_script(24, seed=3)
    for op in ops[:16]:
        assert ref.apply(*op) == port.apply(*op) is True
        _same(ref, port, tmp_path)
    for s in (ref, port):
        s.crash()
    rr, pr = ref.recover(concurrency=2), port.recover(concurrency=2)
    assert _details(pr) == _details(rr)
    assert pr.valid == rr.valid and pr.generation == rr.generation
    _same(ref, port, tmp_path)
    for op in ops:                      # the first 16 again, then 8 new
        got = port.apply(*op)
        assert got == ref.apply(*op)
        assert got == (op[0] >= 16 or not journal)
    _same(ref, port, tmp_path)
    assert int(port.table.header.vol[0, FS_CURSOR]) == port.next_sample


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_recovery(tmp_path, writer):
    ops = FR.oracle_script(12, seed=7)
    kw = dict(n_keys=64, dim=3, n_samples=512, journal=True)
    path = str(tmp_path / "store")
    if writer == "ref":
        w = JStore(JConfig(**kw), path)
    else:
        w = TStore(TConfig(**kw), path, device="cpu")
    for op in ops[:9]:
        assert w.apply(*op)
    assert w.apply(*ops[9], _torn_crash=True) is False   # torn, lost
    r = TStore(TConfig(**kw), path, device="cpu") if writer == "ref" else \
        JStore(JConfig(**kw), path)
    r.recover()
    twin = JStore(JConfig(**kw))
    for op in ops[:9]:
        twin.apply(*op)
    keys = np.arange(64)
    got = r.lookup(keys)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, twin.lookup(keys))
    assert r.next_sample == twin.next_sample
    assert r.journal.classify() == twin.journal.classify()
    assert [r.apply(*op) for op in ops] == [False] * 9 + [True] * 3


@pytest.mark.parametrize("torn", [False, True])
def test_exactly_once_every_boundary(torn):
    ops = FR.oracle_script(6, seed=13)
    cfg = FR.oracle_config()
    want = FR.run_twin(cfg, ops, "cpu")
    ref = JStore(JConfig(n_keys=64, dim=3, n_samples=512, journal=True))
    for op in ops:
        assert ref.apply(*op)
    np.testing.assert_array_equal(want["effects"]["vectors"],
                                  ref.lookup(np.arange(64)))
    np.testing.assert_array_equal(want["effects"]["counts"], ref.counts)
    assert want["effects"]["classify"] == ref.journal.classify()
    last = len(ops) if not torn else len(ops) - 1
    for boundary in range(last + 1):
        out = FR.twin(cfg, ops, boundary, torn=torn, device="cpu",
                      concurrency=2, want=want)
        assert out["refused"] == boundary


def test_exactly_once_catches_a_double_apply(monkeypatch):
    """The oracle fails when a completed request is not refused."""
    from repro_torch.serve.journal import ST_NEVER, RequestJournal
    monkeypatch.setattr(RequestJournal, "state_of",
                        lambda self, rid: ST_NEVER)
    with pytest.raises(AssertionError, match="replay refused 0"):
        FR.twin(FR.oracle_config(), FR.oracle_script(4, seed=13), 2,
                torn=False, device="cpu")


def test_journal_report_matches_reference():
    cols = ("journal", "n_ops", "epochs", "lines", "lines_per_epoch",
            "journal_lines", "journal_lines_per_epoch", "commit_mode",
            "n_shards", "arena_bytes", "block_bytes", "cache_blocks",
            "peak_resident_bytes", "integrity", "integrity_lines")
    got = FR.journal_report(repeats=1, device="cpu")["rows"]
    want = jbench.journal_report(repeats=1)["rows"]
    assert [{k: r[k] for k in cols} for r in got] == \
        [{k: r[k] for k in cols} for r in want]
    assert set(got[0]) == set(want[0])


def test_feature_recover_entry_point(capsys):
    FR.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == '{"device": "cpu", "kind": "cpu"}'
    assert "13 crash points" in out[-1]


def test_store_quarantine_gate():
    fs = TStore(TConfig(n_keys=64, dim=3, n_samples=64), device="cpu")
    ref = JStore(JConfig(n_keys=64, dim=3, n_samples=64))
    for s in (fs, ref):
        s.quarantined_keys = {5}
    d = np.ones((2, 3), np.int64)
    with pytest.raises(QuarantinedError):
        fs.apply(0, [1, 5], d)
    with pytest.raises(QuarantinedError):
        fs.lookup([5])
    for s in (fs, ref):
        s.readmit([5])
        assert s.apply(0, [1, 5], d)
    np.testing.assert_array_equal(fs.lookup([1, 5]).numpy(),
                                  ref.lookup([1, 5]))


def test_store_rejects_what_is_not_ported(tmp_path):
    # shadow commit on a sharded arena is ported: every shard file, the
    # manifest and FlushStats (aggregate and per shard) are the
    # reference's, request by request, and through a torn request's
    # recovery
    kw = dict(n_keys=64, dim=3, n_samples=512, n_shards=2,
              commit_mode="shadow")
    ref = JStore(JConfig(**kw), str(tmp_path / "sref"))
    port = TStore(TConfig(**kw), str(tmp_path / "sport"), device="cpu")
    assert port.arena.n_shards == 2 and port.arena.commit_mode == "shadow"
    ops = FR.oracle_script(8, seed=5)

    def files(prefix):
        return {f.name[len(prefix):]: f.read_bytes()
                for f in sorted(tmp_path.iterdir())
                if f.name.startswith(prefix + ".")}

    def same_sharded():
        assert files("sref") == files("sport")
        assert [dataclasses.asdict(st) for st in port.arena.shard_stats()] \
            == [dataclasses.asdict(st) for st in ref.arena.shard_stats()]
        assert dataclasses.asdict(port.arena.stats) == \
            dataclasses.asdict(ref.arena.stats)
        keys = np.arange(72)
        np.testing.assert_array_equal(port.lookup(keys).numpy(),
                                      ref.lookup(keys))
    for op in ops[:6]:
        assert ref.apply(*op) == port.apply(*op) is True
        same_sharded()
    for s in (ref, port):
        s.apply(*ops[6], _torn_crash=True)
    assert _details(port.recover()) == _details(ref.recover())
    same_sharded()
    assert [port.apply(*op) for op in ops] == \
        [ref.apply(*op) for op in ops] == [False] * 6 + [True] * 2
    same_sharded()
    # shadow commit on one arena is ported: the store's file and
    # FlushStats are the reference's, request by request
    ref, port = _stores(tmp_path, commit_mode="shadow")
    assert port.arena.commit_mode == "shadow"
    for op in FR.oracle_script(8, seed=5):
        assert ref.apply(*op) == port.apply(*op) is True
        _same(ref, port, tmp_path)
    fs = TStore(TConfig(), device="cpu")
    # salvage is ported: a store that never committed salvages to the
    # reference's report
    got = _details(fs.recover(salvage=True))
    assert got == _details(JStore(JConfig()).recover(salvage=True))
    assert not fs.quarantined_keys
    with pytest.raises(ValueError):
        fs.apply(0, [3, 3], np.zeros((2, 4), np.int64))


def test_sample_index_recover(tmp_path):
    idx = TIndex(str(tmp_path / "idx"), 4096, device="cpu")
    ids = np.arange(1000, dtype=np.int64)
    idx.add(ids, ids % 7, ids * 64, np.full(1000, 64, np.int64))
    idx.arena.crash()
    sec = idx.recover()
    assert sec >= 0
    assert idx.last_recovery.stage("index") is not None
    ok, shard, off, ln = idx.lookup(ids[::13])
    assert bool(ok.all())
    np.testing.assert_array_equal(shard.numpy(), ids[::13] % 7)
    np.testing.assert_array_equal(off.numpy(), ids[::13] * 64)
    np.testing.assert_array_equal(ln.numpy(), np.full(ids[::13].size, 64))


@pytest.mark.parametrize("mode", ["partly", "full"])
def test_sample_index_matches_reference(tmp_path, mode):
    rng = np.random.default_rng(2)
    ref = JIndex(str(tmp_path / "ref"), 2048, mode=mode)
    port = TIndex(str(tmp_path / "port"), 2048, mode=mode, device="cpu")
    for _ in range(3):
        ids = rng.choice(4000, 300, replace=False).astype(np.int64)
        args = (ids, ids % 5, ids * 3, rng.integers(1, 99, 300))
        ref.add(*args)
        port.add(*args)
        assert (tmp_path / "ref").read_bytes() == \
            (tmp_path / "port").read_bytes()
        assert dataclasses.asdict(port.arena.stats) == \
            dataclasses.asdict(ref.arena.stats)
    for i in (ref, port):
        i.arena.crash()
        i.recover()
    q = np.arange(4000)
    for a, b in zip(port.lookup(q), ref.lookup(q)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert _details(port.last_recovery) == _details(ref.last_recovery)


def test_launch_serve_dense_runs_with_crash(capsys):
    assert tserve.main(["--arch", "llama3.2-3b", "--crash", "--device",
                        "cpu", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] recovered in" in out and "[serve] step 3:" in out


def test_launch_serve_moe_raises(capsys):
    # MoE archs serve now (tests/test_torch_moe_model.py), and so do
    # hymba (tests/test_torch_hybrid_model.py) and xLSTM, the last
    # family: the launcher serves its reduced config and recovers
    assert tserve.main(["--arch", "xlstm-1.3b", "--crash", "--device",
                        "cpu", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] recovered in" in out and "[serve] step 3:" in out
