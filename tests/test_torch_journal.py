"""repro_torch request journal vs the reference's, as two-package parity.

Each case of ``tests/test_journal.py`` (barrier commit, one shard; the
port has neither shadow commit nor sharding) runs the same operations
through both packages on a standalone journal, and the results must be
equal: the raised errors, the recovered classification, HEAD/TAIL, the
reconstructor's detail, ``FlushStats.journal_lines`` and every byte of
the arena image (ring and header line).  Integer results, tolerance 0.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import arena as RA
from repro.core import recovery as RR
from repro.serve import journal as RJ
from repro_torch.core import arena as TA
from repro_torch.core import recovery as TR
from repro_torch.interop import image_of
from repro_torch.serve import journal as TJ

REF = SimpleNamespace(open_arena=RA.open_arena, Manager=RR.RecoveryManager,
                      J=RJ, image=lambda a: np.array(a._mm, np.uint8),
                      kw={})
PORT = SimpleNamespace(open_arena=TA.open_arena, Manager=TR.RecoveryManager,
                       J=TJ, image=image_of, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _no_integrity(monkeypatch):
    # integrity pinned off in both packages: these tests hold the
    # integrity-free bytes (tests/test_torch_integrity.py holds the rest)
    monkeypatch.setenv("REPRO_INTEGRITY", "0")


def _jr(pkg, cap=64):
    a = pkg.open_arena(None, pkg.J.RequestJournal.layout(
        cap, name="jr", standalone=True), **pkg.kw)
    return a, pkg.J.RequestJournal(a, cap, name="jr")


def _recover(pkg, a, j):
    a.reopen()
    mgr = pkg.Manager(a)
    mgr.add("journal", "serve.journal", j,
            regions=("jr.jrnl", "jr.jrnlheader"))
    rep = mgr.recover()
    assert rep.valid
    return rep.stage("journal").detail


def _try(log, fn, *args, **kw):
    """Run fn, logging the exception type it raised (or None)."""
    try:
        fn(*args, **kw)
        log.append(None)
    except (RuntimeError, KeyError, ValueError, MemoryError,
            AssertionError) as e:
        log.append(type(e).__name__)


# --------------------------------------------------------------- scenarios
# each takes a package namespace and returns (arena, journal, events)

def roundtrip(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    with a.epoch():
        j.log(J.OP_ADMIT, 1, digest=J.args_digest([1, 2, 3]))
        j.log(J.OP_ADMIT, 2)
        a.commit()
    with a.epoch():
        j.log(J.OP_COMPLETE, 1)
        j.log(J.OP_APPLY, 3)
        a.commit()
    a.crash()
    return a, j, [_recover(pkg, a, j)]


def duplicates(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    ev = []
    with a.epoch():
        j.log(J.OP_ADMIT, 5)
        _try(ev, j.log, J.OP_COMPLETE, 7)       # never admitted
        _try(ev, j.log, 0, 1)                   # unknown op
        a.commit()
    with a.epoch():
        _try(ev, j.log, J.OP_ADMIT, 5)
        _try(ev, j.log, J.OP_APPLY, 5)
        j.log(J.OP_COMPLETE, 5)
        _try(ev, j.log, J.OP_ADMIT, 5)
        _try(ev, j.log, J.OP_COMPLETE, 5)
        a.commit()
    _try(ev, j.log, J.OP_ADMIT, 9)              # outside an epoch
    return a, j, ev


def torn_append(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    with a.epoch():
        j.log(J.OP_ADMIT, 1)
        a.commit()
    with a.epoch():
        j.log(J.OP_ADMIT, 2)
        a.writeset.flush(include_meta=False)
        a.crash()
    ev = [_recover(pkg, a, j), j.state_of(2)]
    with a.epoch():
        j.log(J.OP_ADMIT, 2)                    # the retry is no duplicate
        a.commit()
    return a, j, ev


def uncommitted_epoch(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    with a.epoch():
        j.log(J.OP_ADMIT, 1)
        a.commit()
    with a.epoch():
        j.log(J.OP_ADMIT, 2)
        j.log(J.OP_COMPLETE, 1)
        a.crash()
    return a, j, [_recover(pkg, a, j)]


def recover_twice(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    with a.epoch():
        j.log(J.OP_ADMIT, 1)
        j.log(J.OP_APPLY, 2)
        a.commit()
    a.crash()
    d1 = _recover(pkg, a, j)
    c1 = (dict(j.classify()), j.head, j.tail)
    d2 = _recover(pkg, a, j)
    assert (d1, c1) == (d2, (dict(j.classify()), j.head, j.tail))
    return a, j, [d1]


def ring_wrap(pkg):
    J = pkg.J
    a, j = _jr(pkg, cap=4)
    ev = []
    for rid in range(4):
        with a.epoch():
            j.log(J.OP_APPLY, rid)
            a.commit()
    with a.epoch():
        _try(ev, j.log, J.OP_ADMIT, 4)          # ring full
        _try(ev, j.retire_completed)            # inside an epoch
        a.commit()
    ev += [j.space(), j.retire_completed(), j.space()]
    with a.epoch():
        j.log(J.OP_ADMIT, 5)                    # seq 4 wraps onto slot 0
        a.commit()
    with a.epoch():                             # torn second-lap append
        j.log(J.OP_ADMIT, 6)
        a.writeset.flush(include_meta=False)
        a.crash()
    ev.append(_recover(pkg, a, j))
    return a, j, ev


def sealing_rule(pkg):
    J = pkg.J
    a, j = _jr(pkg, cap=4)
    with a.epoch():
        j.log(J.OP_ADMIT, 0)
        j.log(J.OP_ADMIT, 1)
        a.commit()
    with a.epoch():
        j.log(J.OP_COMPLETE, 0)
        j.log(J.OP_COMPLETE, 1)
        a.commit()
    j.retire_completed()
    with a.epoch():
        j.log(J.OP_ADMIT, 5)                    # overwrites rid 0's ADMIT
        a.writeset.flush(include_meta=False)
        a.crash()
    return a, j, [_recover(pkg, a, j)]


def checksum(pkg):
    J = pkg.J
    a, j = _jr(pkg)
    with a.epoch():
        j.log(J.OP_ADMIT, 1)
        j.log(J.OP_ADMIT, 2)
        a.commit()
    # flip one digest word of entry 0 in persistent memory
    row = np.array(j.ring.read_rows([0])[0])
    assert row[0] == J.JR_MAGIC
    row[4] ^= 1
    j.ring.write_rows([0], row[None])
    j.ring.persist_rows(np.array([0]))
    a.crash()
    return a, j, [_recover(pkg, a, j)]


SCENARIOS = [roundtrip, duplicates, torn_append, uncommitted_epoch,
             recover_twice, ring_wrap, sealing_rule, checksum]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_journal_matches_reference(scenario):
    ra, rj, rev = scenario(REF)
    ta, tj, tev = scenario(PORT)
    assert tev == rev
    assert tj.classify() == rj.classify()
    assert tj.must_retry() == rj.must_retry()
    assert (tj.head, tj.tail, tj.space()) == (rj.head, rj.tail, rj.space())
    assert np.array_equal(REF.image(ra), PORT.image(ta))
    rs, ts = dataclasses.asdict(ra.stats), dataclasses.asdict(ta.stats)
    for k in ("lines", "bytes", "calls", "journal_lines", "marks",
              "dedup_rows", "saved_lines", "epochs", "fences"):
        assert ts[k] == rs[k], k


def test_journal_lines_stay_out_of_data_counters():
    """A standalone journal's ring line and its own ``.jrnlheader`` line
    both land in journal_lines; lines, bytes and marks stay zero."""
    a, j = _jr(PORT)
    with a.epoch():
        j.log(TJ.OP_ADMIT, 1)
        a.commit()
    st = a.stats
    assert st.journal_lines == 2
    assert st.lines == st.bytes == st.marks == 0


@pytest.mark.parametrize("arr", [[], [0], [0, 0], [1, 2, 3], [3, 2, 1],
                                 list(range(-5, 300, 7)), [2 ** 62, -1]])
def test_args_digest_matches_reference(arr):
    assert TJ.args_digest(arr) == RJ.args_digest(arr)
    assert TJ.args_digest(np.asarray(arr, np.int64)) == RJ.args_digest(arr)


def test_journal_env_default(monkeypatch):
    assert TA.journal_enabled(True) and not TA.journal_enabled(False)
    monkeypatch.setenv("REPRO_JOURNAL", "0")
    assert not TA.journal_enabled(None)
    assert TA.journal_enabled(True)
    monkeypatch.delenv("REPRO_JOURNAL")
    assert TA.journal_enabled(None) == RA.journal_enabled(None) is True
