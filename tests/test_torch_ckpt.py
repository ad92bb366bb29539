"""repro_torch's checkpoint slice vs the JAX reference.

The same train state, made with numpy from a seed, is checkpointed by
``repro.ckpt.manager`` (the reference, its quantize kernels in interpret
mode on the CPU) and by ``repro_torch.ckpt.manager`` on CPU tensors, where
the kernel wrappers take their plain versions.  Manifests and leaf files
must be byte-identical, save reports and restore reports equal (timing
aside), and restored leaves equal (tolerance 0); each package restores
the other's checkpoint.  Also: the leaf quantizer, the rng reconstructor,
the policy plan, the config/param-shape copies and the bench's byte
columns, each against the reference.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import ckpt_bench as jbench
from repro.ckpt import manager as JM
from repro.configs import registry as jreg
from repro.core import policy as jpol
from repro.kernels import ops as jops
from repro.models import backbone as jbb
from repro.train.state import TrainState as JState
from repro.train.state import new_state as j_new_state
from repro_torch import ckpt_bench as tbench
from repro_torch.ckpt import manager as TM
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import policy as tpol
from repro_torch.core import reconstruct as trec
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.models import backbone as tbb
from repro_torch.optim.adamw import AdamWConfig, init_moments
from repro_torch.train.state import TrainState, new_state

POLICIES = ["FULLY_PERSISTENT", "PARTLY_PERSISTENT", "PARTLY_Q8",
            "PARTLY_DROP"]


# ---------------------------------------------------------------- states

def np_state(seed=0, step=42, data_seed=7):
    """A TrainState of numpy leaves; its dicts are built in unsorted key
    order, moments nonzero, rng = fold_in(PRNGKey(data_seed), step)."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {
            "w": (rng.standard_normal((32, 300)) * scale).astype(np.float32),
            "b": (rng.standard_normal(16) * scale).astype(np.float32),
            "blocks": {"pos0": {
                "wq": (rng.standard_normal((2, 24, 4, 8)) * scale
                       ).astype(np.float32),
                "ln1": np.zeros((2, 24), np.float32)}},
            "a": (rng.standard_normal((37,)) * scale).astype(np.float32),
        }
    key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(data_seed), step))
    return JState(params=tree(1.0), mu=tree(1e-3), nu=tree(1e-6),
                  step=np.asarray(step, np.int32),
                  data_seed=np.asarray(data_seed, np.int32), rng=key)


def jax_state(st):
    return jax.tree.map(jnp.asarray, st)


def jax_spec(st):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jax_state(st))


def port_state(st):
    return state_from_numpy(st, "cpu")


def port_leaves(state):
    return [np.asarray(x) for _, x in
            tpol.tree_flatten_with_path(state_to_numpy(state).as_dict())]


def ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state.as_dict())]


def assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8) if x.ndim else x,
                                      y.view(np.uint8) if y.ndim else y)


def dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def report_fields(rep):
    out = dataclasses.asdict(rep)
    out.pop("seconds")
    return out


def stage_details(report):
    return [(s.name, s.detail) for s in report.stages]


# ----------------------------------------------------------- quantize leaf

@pytest.mark.parametrize("shape", [(), (1,), (37,), (1000, 37), (4097,),
                                   (64, 300), (3, 5000)])
def test_quantize_leaf_matches_reference(shape):
    rng = np.random.default_rng(len(shape) + sum(shape))
    x = np.asarray(rng.standard_normal(shape)
                   * 10.0 ** rng.uniform(-8, 2), np.float32)
    qj, sj = jops.quantize_leaf(jnp.asarray(x))
    qt, st = tops.quantize_leaf(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    dj = np.asarray(jops.dequantize_leaf(qj, sj, shape, np.float32))
    dt = tops.dequantize_leaf(qt, st, shape, torch.float32).numpy()
    assert dt.shape == shape
    np.testing.assert_array_equal(np.ascontiguousarray(dt).view(np.uint32),
                                  np.ascontiguousarray(dj).view(np.uint32))
    # rows are a multiple of 8; a leaf wider than 16 groups is 4096 wide
    assert qt.shape[0] % 8 == 0
    if x.size > 16 * 256:
        assert qt.shape[1] == 4096


# ------------------------------------------------------------------- rng

@pytest.mark.parametrize("seed,step", [(0, 0), (7, 42), (7, 120),
                                       (123456, 99999), (2 ** 31 - 1, 3),
                                       (1, 2 ** 31 - 1)])
def test_rebuild_rng_matches_fold_in(seed, step):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), step))
    got = trec.rebuild_rng(seed, step)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), want)
    key, secs = trec.run("rng", seed, step)
    assert torch.equal(key, got) and secs >= 0
    assert "rng" in trec.names()


# ---------------------------------------------------------------- policy

@pytest.mark.parametrize("policy", POLICIES)
def test_plan_matches_reference(policy):
    st = np_state()
    jp = jpol.plan(jax_state(st).as_dict(), getattr(jpol, policy))
    tp = tpol.plan(port_state(st).as_dict(), getattr(tpol, policy))
    assert [p.path for p in tp] == [p.path for p in jp]
    assert [p.kind.value for p in tp] == [p.kind.value for p in jp]
    assert [(p.shape, np.dtype(p.dtype), p.nbytes, p.persisted, p.quantized)
            for p in tp] == \
        [(p.shape, np.dtype(p.dtype), p.nbytes, p.persisted, p.quantized)
         for p in jp]
    assert tpol.persisted_bytes(port_state(st).as_dict(),
                                getattr(tpol, policy)) == \
        jpol.persisted_bytes(jax_state(st).as_dict(), getattr(jpol, policy))
    assert "params/blocks/pos0/wq" in [p.path for p in tp]


def test_policy_classification_and_bytes():
    sd = port_state(np_state()).as_dict()
    plans = {p.path: p for p in tpol.plan(sd, tpol.PARTLY_PERSISTENT)}
    assert plans["params/w"].kind == tpol.Kind.ESSENTIAL
    assert plans["mu/w"].kind == tpol.Kind.APPROXIMABLE
    assert plans["rng"].kind == tpol.Kind.DERIVABLE
    assert not plans["rng"].persisted and plans["params/w"].persisted
    full, partly, drop, q8 = (tpol.persisted_bytes(sd, getattr(tpol, p))
                              for p in POLICIES[:2] + POLICIES[3:]
                              + POLICIES[2:3])
    assert drop < q8 < partly < full


def test_unsupported_leaf_dtype_raises():
    # bf16 leaves are carried now (tests/test_torch_gemma.py); f16 is not
    sd = {"params": {"w": torch.zeros(4, dtype=torch.float16)}}
    with pytest.raises(NotImplementedError):
        tpol.plan(sd, tpol.PARTLY_Q8)


# ------------------------------------------------ files and reports parity

@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_files_byte_identical(tmp_path, policy, incremental):
    st = np_state()
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jm = JM.CheckpointManager(jd, getattr(jpol, policy),
                              incremental=incremental)
    tm = TM.CheckpointManager(td, getattr(tpol, policy),
                              incremental=incremental)
    # a first save, then one at the next step with params changed
    st2 = st._replace(step=np.asarray(43, np.int32),
                      params={**st.params, "b": st.params["b"] + 1})
    for s in (st, st2):
        rj = jm.save(jax_state(s))
        rt = tm.save(port_state(s))
        assert report_fields(rt) == report_fields(rj)
        assert dir_bytes(td) == dir_bytes(jd)
    with open(os.path.join(td, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 43
    assert ("rng" in manifest["leaves"]) == (policy == "FULLY_PERSISTENT")
    if incremental:
        assert rt.bytes_skipped_unchanged > 0


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cross_restore(tmp_path, policy, direction):
    st = np_state()
    d = str(tmp_path)
    writer = (JM.CheckpointManager(d, getattr(jpol, policy))
              if direction == "ref_to_port"
              else TM.CheckpointManager(d, getattr(tpol, policy)))
    writer.save(jax_state(st) if direction == "ref_to_port"
                else port_state(st))
    jm = JM.CheckpointManager(d, getattr(jpol, policy))
    tm = TM.CheckpointManager(d, getattr(tpol, policy))
    got_j = jm.restore(jax_spec(st))
    got_t = tm.restore(port_state(st), device="cpu")
    assert_leaves_equal(port_leaves(got_t), ref_leaves(got_j))
    assert stage_details(tm.last_recovery) == stage_details(jm.last_recovery)
    assert tm.last_recovery.generation == 42
    # params always come back bit-exact; rng is rebuilt exactly
    np.testing.assert_array_equal(got_t.params["w"].numpy(), st.params["w"])
    np.testing.assert_array_equal(got_t.rng.numpy(), st.rng)
    assert int(got_t.step) == 42 and int(got_t.data_seed) == 7


def test_restore_takes_meta_spec(tmp_path):
    st = port_state(np_state())
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_Q8)
    mgr.save(st)
    spec = tpol.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), st)
    got = mgr.restore(spec, device="cpu")
    assert_leaves_equal(port_leaves(got)[-4:], port_leaves(st)[-4:])
    assert got.mu["w"].device.type == "cpu"


# ------------------------------------------- the reference's ckpt tests

def tiny_state():
    st = np_state()
    return port_state(st._replace(mu=jax.tree.map(np.zeros_like, st.mu),
                                  nu=jax.tree.map(np.zeros_like, st.nu)))


@pytest.mark.parametrize("policy", ["FULLY_PERSISTENT",
                                    "PARTLY_PERSISTENT"])
def test_save_restore_bitexact(tmp_path, policy):
    st = port_state(np_state())
    mgr = TM.CheckpointManager(str(tmp_path), getattr(tpol, policy))
    rep = mgr.save(st)
    assert rep.step == 42 and rep.bytes_written > 0
    got = mgr.restore(st, device="cpu")
    assert_leaves_equal(port_leaves(got), port_leaves(st))


def test_quantized_moments_bounded_error(tmp_path):
    st = port_state(np_state())
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_Q8)
    assert mgr.save(st).quantized
    got = mgr.restore(st, device="cpu")
    assert torch.equal(got.params["w"], st.params["w"])
    for key in ("w", "b", "a"):
        err = float((got.mu[key] - st.mu[key]).abs().max())
        assert err <= float(st.mu[key].abs().max()) / 127 * 1.01


def test_drop_policy_rewarms_moments(tmp_path):
    st = tiny_state()
    st = st._replace(nu=tpol.tree_map(lambda x: x + 3.0, st.nu))
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_DROP)
    mgr.save(st)
    got = mgr.restore(st, device="cpu")
    assert float(got.nu["w"].abs().sum()) == 0.0


def test_manifest_last_commit(tmp_path):
    """A crash before the manifest rename leaves the PREVIOUS checkpoint
    fully valid (the paper's flag-bit ordering)."""
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)
    mgr.save(st)
    st2 = st._replace(step=torch.tensor(43, dtype=torch.int32),
                      params=tpol.tree_map(lambda x: x + 1, st.params))
    # simulate a crash mid-write: leaf tmp files written, manifest NOT renamed
    for pth, leaf in tpol.tree_flatten_with_path(st2.as_dict()):
        pstr = tpol.path_str(pth)
        if pstr.startswith("params"):
            fp = os.path.join(str(tmp_path), TM._leaf_file(pstr) + ".tmp")
            with open(fp, "wb") as f:
                np.savez(f, x=leaf.numpy())
    got = mgr.restore(st, device="cpu")
    assert int(got.step) == 42                 # previous checkpoint intact
    assert torch.equal(got.params["w"], st.params["w"])


def test_incremental_skips_unchanged(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT,
                               incremental=True)
    r1 = mgr.save(st)
    assert r1.bytes_skipped_unchanged == 0
    st2 = st._replace(step=torch.tensor(43, dtype=torch.int32))
    r2 = mgr.save(st2)
    assert r2.bytes_skipped_unchanged > 0
    assert r2.bytes_written < r1.bytes_written
    got = mgr.restore(st2, device="cpu")
    assert torch.equal(got.params["w"], st.params["w"])
    assert int(got.step) == 43


def test_async_save_equivalent(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)
    mgr.save(st, blocking=False)
    # save copied every persisted tensor to the host before returning: an
    # in-place update now cannot reach the files
    want = st.params["w"].clone()
    st.params["w"].add_(1.0)
    mgr.wait()
    got = mgr.restore(st, device="cpu")
    assert torch.equal(got.params["w"], want)


def test_async_save_failure_surfaces(tmp_path, monkeypatch):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)

    def boom(*a, **k):
        raise OSError("synthetic write failure")

    monkeypatch.setattr(TM.np, "savez", boom)
    mgr.save(st, blocking=False)
    with pytest.raises(OSError, match="synthetic write"):
        mgr.wait()
    monkeypatch.undo()
    mgr.wait()                               # the error is consumed
    assert not mgr.valid()


def test_restore_refuses_shardings(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)
    mgr.save(st)
    with pytest.raises(NotImplementedError, match="shardings"):
        mgr.restore(st, shardings={}, device="cpu")
    with pytest.raises(ValueError):
        mgr.restore(st, device="cpu", warmup="later")


def test_restore_shardings_names_the_queue_only(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)
    mgr.save(st)
    with pytest.raises(NotImplementedError) as err:
        mgr.restore(st, shardings={}, device="cpu")
    msg = str(err.value)
    assert "shardings=" in msg and "ROADMAP Queue 1" in msg
    assert "Slice" not in msg and "item" not in msg


# ---------------------------------------- background warmup (async tests)

def _drop_ckpt(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_DROP)
    mgr.save(st)
    return st, mgr


def test_ckpt_background_warmup_matches_inline(tmp_path):
    st, mgr = _drop_ckpt(tmp_path)
    inline = mgr.restore(st, device="cpu")
    bg = mgr.finish_warmup(mgr.restore(st, device="cpu",
                                       warmup="background"))
    assert_leaves_equal(port_leaves(bg), port_leaves(inline))


def test_ckpt_background_warmup_reports_stage(tmp_path):
    st, mgr = _drop_ckpt(tmp_path)
    got = mgr.restore(st, device="cpu", warmup="background")
    mgr.wait_warmup()
    warm = mgr.last_recovery.stage("warmup_approximable")
    assert warm is not None and warm.detail["background"]
    assert warm.detail["leaves"] == 10         # mu/nu x {a, b, ln1, wq, w}
    assert warm.seconds >= 0
    assert mgr.last_recovery.stage("rewarm_approximable").detail[
        "background"]
    # the placeholder state is already usable (host zeros for moments)
    assert float(got.mu["w"].abs().sum()) == 0.0
    mgr.finish_warmup(got)


def test_ckpt_background_warmup_report_matches_reference(tmp_path):
    st = np_state()
    jm = JM.CheckpointManager(str(tmp_path / "ref"), jpol.PARTLY_DROP)
    tm = TM.CheckpointManager(str(tmp_path / "port"), tpol.PARTLY_DROP)
    jm.save(jax_state(st))
    tm.save(port_state(st))
    gj = jm.finish_warmup(jm.restore(jax_spec(st), warmup="background"))
    gt = tm.finish_warmup(tm.restore(port_state(st), device="cpu",
                                     warmup="background"))
    assert stage_details(tm.last_recovery) == stage_details(jm.last_recovery)
    assert_leaves_equal(port_leaves(gt), ref_leaves(gj))


def test_ckpt_unclaimed_warmup_refuses_next_restore(tmp_path):
    st, mgr = _drop_ckpt(tmp_path)
    got = mgr.restore(st, device="cpu", warmup="background")
    with pytest.raises(RuntimeError, match="unclaimed background warmup"):
        mgr.restore(st, device="cpu")
    got = mgr.finish_warmup(got)               # claim it
    mgr.restore(st, device="cpu")              # now fine
    assert got.step is not None


def test_ckpt_warmup_thread_failure_surfaces(tmp_path, monkeypatch):
    st, mgr = _drop_ckpt(tmp_path)
    real = TM.torch.zeros

    def boom(*a, **k):
        # fail only in the warmup worker — restore's main thread stays real
        if threading.current_thread() is not threading.main_thread():
            raise ValueError("synthetic warmup failure")
        return real(*a, **k)

    monkeypatch.setattr(TM.torch, "zeros", boom)
    got = mgr.restore(st, device="cpu", warmup="background")
    with pytest.raises(ValueError, match="synthetic warmup"):
        mgr.finish_warmup(got)
    monkeypatch.undo()
    mgr.restore(st, device="cpu")              # the manager is reusable


# ------------------------------------------------- state, configs, bench

def test_new_state_and_moments_match_reference():
    params = {"w": torch.ones(3, 4), "b": torch.zeros(4)}
    mu, nu = init_moments(params, AdamWConfig())
    st = new_state(params, mu, nu, seed=11, device="cpu")
    ref = j_new_state({"w": jnp.ones((3, 4)), "b": jnp.zeros(4)},
                      None, None, seed=11)
    np.testing.assert_array_equal(st.rng.numpy(), np.asarray(ref.rng))
    assert st.rng.dtype == torch.uint32
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.data_seed.dtype == torch.int32 and int(st.data_seed) == 11
    assert tuple(TrainState._fields) == tuple(JState._fields)
    assert float(mu["w"].abs().sum()) == 0 and nu["b"].shape == (4,)


def test_entry_points_default_to_the_gpu(tmp_path):
    st = tiny_state()
    mgr = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_PERSISTENT)
    mgr.save(st)
    if torch.cuda.is_available():
        assert mgr.restore(st).params["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(st)
    with pytest.raises(RuntimeError, match="CUDA"):
        new_state({}, {}, {}, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(np_state())


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_param_specs_match_reference(arch):
    for cfg_t, cfg_j in ((treg.get(arch), jreg.get(arch)),
                         (tbase.reduced(treg.get(arch)),
                          jreg.base.reduced(jreg.get(arch)))):
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        tj = [(jpol.path_str(p), tuple(s.shape)) for p, s in
              jax.tree_util.tree_flatten_with_path(jbb.param_specs(cfg_j))[0]]
        tt = [(tpol.path_str(p), tuple(s.shape)) for p, s in
              tpol.tree_flatten_with_path(tbb.param_specs(cfg_t))]
        assert tt == tj
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.model_flops_per_token(4096, True) == \
            cfg_j.model_flops_per_token(4096, True)


def test_init_params_follows_reference_rule():
    cfg = tbase.reduced(treg.get("hymba-1.5b"))
    g = torch.Generator().manual_seed(0)
    p = tbb.init_params(cfg, g, "cpu")
    ref = jbb.init_params(jreg.base.reduced(jreg.get("hymba-1.5b")),
                          jax.random.PRNGKey(0))
    got = dict((tpol.path_str(k), v) for k, v in
               tpol.tree_flatten_with_path(p))
    want = dict((jpol.path_str(k), np.asarray(v)) for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0])
    assert list(got) == list(want)
    for path, v in got.items():
        w = want[path]
        assert tuple(v.shape) == w.shape and v.dtype == torch.float32
        if v.dim() <= 1 or any(k in path for k in
                               ("a_log", "dt_bias", "d_skip")):
            # deterministic leaves: zeros and the SSM special inits
            np.testing.assert_array_equal(v.numpy(), w)
        else:
            bound = min(0.02, (1.0 / v.shape[0]) ** 0.5)
            assert 0 < float(v.std()) <= 1.5 * bound


def test_ckpt_bench_bytes_match_reference():
    keys = ("policy", "bytes_1st", "bytes_2nd", "skipped_derivable",
            "vs_fully")
    got = [{k: r[k] for k in keys} for r in tbench.ckpt_policies(
        device="cpu")]
    want = [{k: r[k] for k in keys} for r in jbench.ckpt_policies()]
    assert got == want
    assert got[-1]["bytes_2nd"] == 0                  # incremental
    rows = tbench.restore_reconstruct(device="cpu")
    assert [r["leaves"] for r in rows] == [
        r["leaves"] for r in jbench.restore_reconstruct()]


def test_ckpt_bench_entry_point(capsys):
    tbench.main(["--device", "cpu", "--layers", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"device": "cpu", "kind": "cpu"}
    assert [r["policy"] for r in lines[1:6]] == [
        "fully", "partly", "partly+q8", "partly+drop", "partly+incr"]
    assert launch_counts()["quantize_blockwise"] == 0
