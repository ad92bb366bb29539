"""repro_torch kernel modules vs the JAX reference kernels.

The port's kernels run only on the card; here, on CPU tensors, every
wrapper takes its plain version, which is held against the reference's
Pallas kernel in interpret mode and its jnp oracle.  All results are
integers, compared for exact equality (tolerance 0).  ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card.
The quantize kernels' results are floats and int8, also compared for
exact equality: the plain versions repeat the reference's arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recovery as R
from repro.kernels import chain_order as jco
from repro.kernels import ops as jops
from repro.kernels import pack_flush as jpf
from repro.kernels import quant_pack as jqp
from repro.kernels import ref
from repro_torch.core import recovery as TR
from repro_torch.kernels import chain_order as tco
from repro_torch.kernels import launch_counts, pack_flush as tpf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as tqp


# ---------------------------------------------------------------- pack

@pytest.mark.parametrize("rowbytes", [64, 128, 256])
def test_pack_rows_plain_matches_pallas_and_oracle(rowbytes):
    rng = np.random.default_rng(rowbytes)
    n, m = 96, 40
    src = rng.integers(-(1 << 62), 1 << 62, (n, rowbytes // 8),
                       dtype=np.int64)
    idx = rng.integers(-1, n, m).astype(np.int32)   # includes -1 sentinels
    idx[:3] = -1
    got = tpf.pack_rows(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.dtype == torch.int64 and got.shape == (m, rowbytes // 8)
    got_words = got.numpy().view(np.uint32)
    # the reference kernels run on uint32 words, D padded to 128 lanes
    words = src.view(np.uint32)
    pad = np.zeros((n, 128 * -(-words.shape[1] // 128)), np.uint32)
    pad[:, :words.shape[1]] = words
    want = np.asarray(jpf.pack_rows(jnp.asarray(pad), jnp.asarray(idx),
                                    block_d=128, interpret=True))
    oracle = np.asarray(ref.pack_rows_ref(jnp.asarray(words),
                                          jnp.asarray(idx)))
    np.testing.assert_array_equal(got_words, want[:, :words.shape[1]])
    np.testing.assert_array_equal(got_words, oracle)
    assert (got_words[:3] == 0).all()


def test_pack_rows_wrapper_dispatch_and_checks():
    src = torch.arange(32, dtype=torch.int64).reshape(4, 8)
    idx = torch.tensor([3, -1, 0], dtype=torch.int32)
    before = launch_counts()["pack_rows"]
    out = tpf.pack_rows(src, idx)
    # CPU tensors take the plain version: no kernel launch is counted
    assert launch_counts()["pack_rows"] == before
    np.testing.assert_array_equal(out.numpy(),
                                  tpf.pack_rows_plain(src, idx).numpy())
    with pytest.raises(TypeError):
        tpf.pack_rows(src, idx.long())
    with pytest.raises(ValueError):
        tpf.pack_rows(src.reshape(-1), idx)


def test_pack_rows_index_past_end_departs_from_reference():
    # A recorded departure (no write set produces such an index): for an
    # index >= n the reference's interpret mode clamps to the last row, the
    # port gives a zero row, on the CPU and on the card alike.
    src = np.arange(4 * 128, dtype=np.float32).reshape(4, 128)
    idx = np.array([0, 4, 1], np.int32)
    got = tops.pack_rows(torch.from_numpy(src), torch.from_numpy(idx))
    want = np.asarray(jops.pack_rows(jnp.asarray(src), jnp.asarray(idx)))
    np.testing.assert_array_equal(want[0], src[0])
    np.testing.assert_array_equal(want[1], src[3])
    np.testing.assert_array_equal(want[2], src[1])
    np.testing.assert_array_equal(got.numpy()[0], src[0])
    np.testing.assert_array_equal(got.numpy()[1], np.zeros(128, np.float32))
    np.testing.assert_array_equal(got.numpy()[2], src[1])


def _pallas_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The reference's Pallas pack_rows (interpret mode) on ``src``'s rows
    as uint32 words, D padded to 128 lanes as its ops wrapper pads.  The
    reference's contract gives zero rows for -1 only; the port's for every
    index outside [0, n), so those go in as -1."""
    n = src.shape[0]
    words = src.reshape(n, -1).view(np.uint32)
    pad = np.zeros((n, 128 * -(-words.shape[1] // 128)), np.uint32)
    pad[:, :words.shape[1]] = words
    safe = np.where((idx >= 0) & (idx < n), idx, -1).astype(np.int32)
    if safe.size == 0:
        return np.zeros((0, words.shape[1]), np.uint32)
    got = np.asarray(jpf.pack_rows(jnp.asarray(pad), jnp.asarray(safe),
                                   block_d=128, interpret=True))
    return got[:, :words.shape[1]]


# region kinds: (row bytes, dtype): 64 B nodes and entries, 128 B rows,
# 8 B snapshot rings and chains, 4 B rows
_KINDS = {64: np.int64, 128: np.int32, 8: np.int64, 4: np.int32}


def _grouped_case(case: str):
    """(sources, per-region indices) for one grouped-gather case."""
    rng = np.random.default_rng(len(case))
    if case == "mixed":
        widths, ms = [64, 8, 128, 4, 64], [40, 33, 7, 65, 1]
    elif case == "bad_indices":
        widths, ms = [64, 8, 4], [37, 50, 20]
    elif case == "empty_regions":
        widths, ms = [8, 64, 4, 128, 64], [0, 12, 0, 5, 0]
    else:                                   # more than MAX_GROUPS regions
        widths, ms = [64, 8, 4, 128, 8], [3, 0, 17, 32, 1]
    srcs, idxs = [], []
    for w, m in zip(widths, ms):
        dt = np.dtype(_KINDS[w])
        n = int(rng.integers(20, 90))
        srcs.append(rng.integers(-(1 << 30), 1 << 30, (n, w // dt.itemsize))
                    .astype(dt))
        idx = rng.integers(0, n, m).astype(np.int32)
        if case == "bad_indices":
            idx[::5] = -1
            idx[1::7] = n                   # one past the end
            idx[2::11] = 2 ** 31 - 1
            idx[3::13] = -(2 ** 31)
        idxs.append(idx)
    if case == "more_than_max_groups":      # five regions, 70 times over
        pick = [i % 5 for i in range(tpf.MAX_GROUPS + 6)]
        srcs, idxs = [srcs[i] for i in pick], [idxs[i] for i in pick]
    return srcs, idxs


@pytest.mark.parametrize("case", ["mixed", "bad_indices", "empty_regions",
                                  "more_than_max_groups"])
def test_pack_rows_grouped_plain_matches_pallas_per_region(case):
    """Each region's segment of the grouped staging buffer equals the
    reference's Pallas kernel run on that region alone (exact); segments
    sit at group_layout's 16-byte-aligned offsets and the pad between
    them is zero."""
    srcs, idxs = _grouped_case(case)
    tsrcs = [torch.from_numpy(s) for s in srcs]
    counts = [i.size for i in idxs]
    idx = torch.from_numpy(np.concatenate(idxs))
    buf = tpf.pack_rows_grouped_plain(tsrcs, idx, counts).numpy()
    offs, total = tpf.group_layout(tsrcs, counts)
    assert buf.dtype == np.uint8 and buf.shape == (total,)
    assert total % tpf.SEG_ALIGN == 0
    assert all(o % tpf.SEG_ALIGN == 0 for o in offs)
    np.testing.assert_array_equal(
        tpf.pack_rows_grouped(tsrcs, idx, counts).numpy(), buf)
    covered = np.zeros(total, bool)
    memo = {}
    for src, ix, off in zip(srcs, idxs, offs):
        rowbytes = src.shape[1] * src.itemsize
        seg = buf[off:off + ix.size * rowbytes].view(np.uint32)
        key = (id(src), ix.tobytes())
        if key not in memo:
            memo[key] = _pallas_rows(src, ix)
        np.testing.assert_array_equal(seg.reshape(ix.size, rowbytes // 4),
                                      memo[key])
        covered[off:off + ix.size * rowbytes] = True
    assert (buf[~covered] == 0).all()


def test_pack_rows_grouped_wrapper_dispatch_and_checks():
    srcs = [torch.arange(32, dtype=torch.int64).reshape(4, 8),
            torch.arange(6, dtype=torch.int32).reshape(6, 1)]
    idx = torch.tensor([3, -1, 0, 5, 9], dtype=torch.int32)
    before = launch_counts()["pack_rows"]
    out = tpf.pack_rows_grouped(srcs, idx, [3, 2])
    # CPU tensors take the plain version: no kernel launch is counted
    assert launch_counts()["pack_rows"] == before
    np.testing.assert_array_equal(
        out.numpy(), tpf.pack_rows_grouped_plain(srcs, idx, [3, 2]).numpy())
    assert tpf.group_layout(srcs, [3, 2]) == ([0, 192], 208)
    assert out[192:200].view(torch.int32).tolist() == [5, 0]
    # a caller's buffer: the same bytes, written into its first 208
    buf = torch.full((300,), 7, dtype=torch.uint8)
    got = tpf.pack_rows_grouped(srcs, idx, [3, 2], out=buf)
    assert got.data_ptr() == buf.data_ptr() and got.shape == (208,)
    np.testing.assert_array_equal(buf[:208].numpy(), out.numpy())
    assert (buf[208:] == 7).all()
    for bad in (torch.zeros(200, dtype=torch.uint8),          # too small
                torch.zeros(208, dtype=torch.int32),
                torch.zeros((208, 1), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            tpf.pack_rows_grouped(srcs, idx, [3, 2], out=bad)
    with pytest.raises(ValueError):
        tpf.pack_rows_grouped(srcs, idx, [3, 1])        # counts != len
    with pytest.raises(ValueError):
        tpf.pack_rows_grouped(srcs, idx, [6, -1])
    with pytest.raises(ValueError):
        tpf.pack_rows_grouped(srcs[:1], idx, [3, 2])
    with pytest.raises(TypeError):
        tpf.pack_rows_grouped(srcs, idx.long(), [3, 2])
    with pytest.raises(ValueError):                     # 2 B rows
        tpf.pack_rows_grouped([torch.zeros((4, 1), dtype=torch.int16)],
                              idx[:2], [2])
    # a device with no kernel raises instead of taking the plain version
    meta = [s.to("meta") for s in srcs]
    with pytest.raises(RuntimeError):
        tpf.pack_rows_grouped(meta, idx.to("meta"), [3, 2])
    with pytest.raises(RuntimeError):
        tpf.pack_rows(meta[0], idx[:3].to("meta"))


def test_pack_rows_grouped_host_needs_a_card():
    """The drain's host-index form launches the kernel or raises: CPU
    sources take no plain version and count no launch."""
    srcs = [torch.arange(32, dtype=torch.int64).reshape(4, 8)]
    buf = torch.zeros(64, dtype=torch.uint8)
    before = launch_counts()["pack_rows"]
    with pytest.raises(RuntimeError, match="no kernel"):
        tpf.pack_rows_grouped_host(srcs, [2], buf, buf.clone(),
                                   stream=None)
    assert launch_counts()["pack_rows"] == before
    tpf.pack_rows_grouped_host([], [], buf, buf, stream=None)  # nothing


def test_launch_size_histogram_and_reset():
    from repro_torch.kernels import _build, launch_sizes, reset_launch_counts

    def fake():
        pass

    fake.launches, fake.sizes = 0, {}
    for size in (1, 2, 3, 8192, 8193, 131073, 0):
        _build.note_launch(fake, size)
    assert fake.launches == 7
    assert fake.sizes == {1: 2, 2: 1, 4: 1, 8192: 1, 16384: 1, 262144: 1}
    sizes = launch_sizes()
    assert set(sizes) == set(launch_counts())
    reset_launch_counts()
    assert all(v == 0 for v in launch_counts().values())
    assert all(v == {} for v in launch_sizes().values())


# ------------------------------------------------------------ doubling

def _chain_with_faults(n, seed):
    """A random permutation chain with NULL cuts, out-of-range values and a
    short cycle, as int32."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nxt = np.full(n, -1, np.int64)
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[n // 3]] = -1                       # NULL cut
    nxt[perm[n // 2]] = n + 7                    # out of range
    nxt[perm[2 * n // 3]] = 2 ** 31 - 1          # out of range, int32 max
    a, b = perm[-3], perm[-2]
    nxt[b] = a                                   # cycle a -> b -> a
    return nxt.astype(np.int32)


@pytest.mark.parametrize("n", [8, 61, 256, 512])
def test_jump_double_plain_matches_pallas_and_oracle(n):
    nxt = _chain_with_faults(n, n)
    cnt = np.random.default_rng(n + 1).integers(1, 5, n).astype(np.int32)
    jump_t = torch.from_numpy(nxt)
    cnt_t = torch.from_numpy(cnt.astype(np.int64))
    jump_j, cnt_j = jnp.asarray(nxt), jnp.asarray(cnt)
    for _ in range(3):   # several rounds, as the tables are built
        gj, gc = tco.jump_double(jump_t, cnt_t)
        wj, wc = jco.jump_double(jump_j, cnt_j, interpret=True)
        np.testing.assert_array_equal(gj.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        # the oracle does not sanitize: compare on an already-sane input
        sane = jnp.where((jump_j >= 0) & (jump_j < n), jump_j, -1)
        oj, oc = ref.jump_double_ref(sane, cnt_j)
        np.testing.assert_array_equal(gj.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(oc))
        jump_t, cnt_t, jump_j, cnt_j = gj, gc, wj, wc
    nj, none = tco.jump_double(jump_t)
    assert none is None
    np.testing.assert_array_equal(nj.numpy(), tco.jump_double(jump_t,
                                                              cnt_t)[0])


def test_chain_kernel_wrappers_reject_wrong_types():
    j = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        tco.jump_double(j)
    with pytest.raises(TypeError):
        tco.walk_segments(j, j, k=2, head=0, n_mult=2, promoted=False,
                          budget=4)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tco.expand_segments(z, z, z, z[:1], 2)


# --------------------------------------------------------- contraction

def _perm_chain(n, live, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)[:live]
    nxt = np.full(n, -1, np.int64)
    nxt[perm[:-1]] = perm[1:]
    return nxt, perm


@pytest.mark.parametrize("n,live,k,pallas", [
    (96, 71, 4, True), (64, 64, 8, True),      # interpret mode is slow:
    (96, 71, 32, False), (512, 512, 8, False),  # small chains only
    (300, 1, 7, False)])
def test_contraction_pipeline_matches_host_and_pallas(n, live, k, pallas):
    """walk_segments/expand_segments plain versions under the port's
    contraction driver vs the host primitive and the reference's device
    pipeline (per-hop cascade: the fused Pallas walk cannot run on this
    jax)."""
    nxt, perm = _perm_chain(n, live, n + k)
    head = int(perm[0])
    got = TR.chain_order(torch.from_numpy(nxt), head, method="contract",
                         k=k).numpy()
    np.testing.assert_array_equal(got, perm)
    np.testing.assert_array_equal(got, R.chain_order(nxt, head,
                                                     method="contract", k=k))
    if pallas:
        np.testing.assert_array_equal(
            got, jco.chain_order_device(nxt, head, method="contract", k=k,
                                        fuse=False, interpret=True))
    # with the committed count: the path the DLL reconstructor takes
    c = max(1, live // 2)
    np.testing.assert_array_equal(
        TR.chain_order(torch.from_numpy(nxt), head, c, method="contract",
                       k=k).numpy(),
        R.chain_order(nxt, head, c, method="contract", k=k))


def test_walk_and_expand_plain_step_semantics():
    # 0 -> 5 -> 6 -> 7 -> 4 -> 9 -> NULL, k = 4: spine {0, 4, 8}
    nxt = torch.tensor([5, -1, -1, -1, 9, 6, 7, 4, -1, -1], dtype=torch.int32)
    starts = torch.tensor([0, 4, 8, -1], dtype=torch.int32)
    cur, sp, w = tco.walk_segments(nxt, starts, k=4, head=-1, n_mult=3,
                                   promoted=False, budget=8)
    assert cur.tolist() == [4, -1, -1, -1]
    assert sp.tolist() == [1, -1, -1, -1]
    assert w.tolist() == [4, 2, 1, 0]
    # a budget too small leaves the lane walking
    cur, sp, w = tco.walk_segments(nxt, starts[:1], k=4, head=-1, n_mult=3,
                                   promoted=False, budget=2)
    assert (cur.tolist(), sp.tolist(), w.tolist()) == ([6], [-1], [2])
    # a promoted head and a spine_pos table agree
    spos = torch.full((10,), -1, dtype=torch.int32)
    spos[torch.tensor([0, 4, 8, 6])] = torch.tensor([0, 1, 2, 3],
                                                    dtype=torch.int32)
    a = tco.walk_segments(nxt, starts[:1], k=4, head=6, n_mult=3,
                          promoted=True, budget=8)
    b = tco.walk_segments(nxt, starts[:1], k=4, head=6, n_mult=3,
                          promoted=True, budget=8, spine_pos=spos)
    assert [x.tolist() for x in a] == [x.tolist() for x in b] \
        == [[6], [3], [2]]
    out = tco.expand_segments(nxt, torch.tensor([0, 4], dtype=torch.int32),
                              torch.tensor([0, 4], dtype=torch.int32),
                              torch.tensor([4, 2], dtype=torch.int32), 6)
    assert out.tolist() == [0, 5, 6, 7, 4, 9]


# --------------------------------------------------------- gather_next

def test_gather_next_returns_stored_value_like_pallas():
    """The Pallas kernel range-checks ids at their own width and returns
    the gathered value as stored, out of range or not."""
    nxt = np.array([1, 2, -1, 7, 0], np.int32)
    ids = np.array([0, 1, 2, 3, 2 ** 32 + 3, -1], np.int64)
    want = np.asarray(jco.gather_next(jnp.asarray(nxt), ids, interpret=True))
    got = tco.gather_next(torch.from_numpy(nxt), torch.from_numpy(ids))
    assert want.tolist() == [1, 2, -1, 7, -1, -1]
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()


@pytest.mark.parametrize("ids_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("n,lanes", [(1, 7), (97, 130), (300, 512)])
def test_gather_next_plain_matches_pallas(ids_dtype, n, lanes):
    """Unsanitized nxt (out-of-range values, negatives) and ids with NULL,
    negatives and, at 64 bits, 2**32 + 3."""
    rng = np.random.default_rng(n * lanes)
    nxt = rng.integers(-1, n, n).astype(np.int32)
    nxt[::7] = n + 5
    nxt[1::11] = -9
    ids = rng.integers(-3, n + 3, lanes).astype(np.int64)
    ids[:3] = [-1, n, 0]
    if ids_dtype == np.int64:
        ids[3:6] = [2 ** 32 + 3, 2 ** 40, -(2 ** 33)]
    ids = ids.astype(ids_dtype)
    want = np.asarray(jco.gather_next(jnp.asarray(nxt), ids, interpret=True))
    got = tco.gather_next(torch.from_numpy(nxt), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tco.gather_next_plain(torch.from_numpy(nxt),
                              torch.from_numpy(ids)).numpy(), want)


def test_gather_next_wrapper_dispatch_and_checks():
    nxt = torch.tensor([1, -1], dtype=torch.int32)
    before = launch_counts()["gather_next"]
    assert tco.gather_next(nxt, torch.tensor([0, 1, 5])).tolist() == [1, -1,
                                                                       -1]
    assert launch_counts()["gather_next"] == before   # plain version on CPU
    assert tco.gather_next(nxt[:0], torch.tensor([0])).tolist() == [-1]
    with pytest.raises(TypeError):
        tco.gather_next(nxt.long(), torch.tensor([0]))
    with pytest.raises(TypeError):
        tco.gather_next(nxt, torch.tensor([0.0]))
    with pytest.raises(ValueError):
        tco.gather_next(nxt, torch.tensor([0, 1, 0, 1])[::2])
    # the packed layout is ported: one shard is the global layout, and
    # offsets that do not span the column raise
    assert tco.gather_next(nxt, torch.tensor([0]), segments=[0, 2],
                           seg_rows=64).tolist() == [1]
    with pytest.raises(ValueError, match="segments"):
        tco.gather_next(nxt, torch.tensor([0]), segments=[0, 3], seg_rows=64)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["auto", "double", "contract"])
def test_chain_walk_rounds_match_host(seed, method):
    """chain_walk's level-synchronous rounds go through gather_next; on
    random bucket-like chains (many short, a NULL head, torn pointers)
    the member matrix equals the host primitive's."""
    rng = np.random.default_rng(seed)
    n = 400
    perm = rng.permutation(n)
    cuts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
    nxt = np.full(n, -1, np.int64)
    heads = []
    for seg in np.split(perm, cuts):
        nxt[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
    nxt[perm[cuts[3] - 1]] = 2 ** 32 + 3          # torn: ends that chain
    hs = np.asarray(heads + [-1], np.int64)
    want = R.chain_walk(nxt, hs, method=method, k=8)
    got = TR.chain_walk(torch.from_numpy(nxt), hs, method=method, k=8)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ quantize

def _quant_rows(n, d, seed):
    """Rows with per-row magnitudes from 1e-8 to 1e2, signed values, an
    all-zero group and a group holding a single nonzero value."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-8, 2, (n, 1))
    x = (rng.standard_normal((n, d)) * mag).astype(np.float32)
    x[n // 2, :256] = 0.0
    x[-1, -256:] = 0.0
    x[-1, -1] = -3.5
    return x


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("n,d", [(8, 256), (64, 1024), (40, 4096),
                                 (16, 768)])
def test_quantize_blockwise_plain_matches_pallas(n, d):
    x = _quant_rows(n, d, n + d)
    qt, st = tqp.quantize_blockwise(torch.from_numpy(x))
    qj, sj = jqp.quantize_blockwise(jnp.asarray(x), interpret=True)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == (n, d // 256)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(np.asarray(sj)))
    got = tqp.dequantize_blockwise(qt, st)
    want = jqp.dequantize_blockwise(qj, sj, interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
    # the int8 payload spans the group: its absmax lane quantizes to +-127
    assert int(qt.abs().max()) == 127


def test_quantize_zero_group_scale_is_the_floor():
    x = np.zeros((8, 512), np.float32)
    x[:, 256:] = 1.0
    q, s = tqp.quantize_blockwise(torch.from_numpy(x))
    floor = np.float32(1e-12) * np.float32(1.0 / 127.0)
    assert (s[:, 0].numpy() == floor).all()
    assert (q[:, :256] == 0).all() and (q[:, 256:] == 127).all()
    _, sj = jqp.quantize_blockwise(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(sj)))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_quantize_non_finite_group_matches_reference(bad):
    # x[0] non-finite, x[1] = 0.5, the rest 0 in the first group; the
    # second group finite.  Reference (interpret mode): scale NaN (NaN) or
    # inf (+-inf) and q all 0 in that group.  Tolerance 0.
    x = np.zeros((8, 512), np.float32)
    x[:, 0] = bad
    x[:, 1] = 0.5
    x[:, 256:] = np.linspace(-3, 3, 256, dtype=np.float32)
    qt, st = tqp.quantize_blockwise(torch.from_numpy(x))
    qj, sj = jqp.quantize_blockwise(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(np.asarray(sj)))
    want_scale = np.nan if np.isnan(bad) else np.inf
    np.testing.assert_array_equal(st[:, 0].numpy(),
                                  np.full(8, want_scale, np.float32))
    assert (qt[:, :256] == 0).all()
    assert int(qt[:, 256:].abs().max()) == 127
    # and through the leaf wrapper the checkpoint calls
    leaf = np.zeros(256, np.float32)
    leaf[0], leaf[1] = bad, 0.5
    ql, sl = tops.quantize_leaf(torch.from_numpy(leaf))
    qr, sr = jops.quantize_leaf(jnp.asarray(leaf))
    np.testing.assert_array_equal(ql.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(_bits(sl.numpy()), _bits(np.asarray(sr)))
    assert (ql.numpy() == 0).all()


def test_quant_wrappers_dispatch_and_checks():
    x = torch.from_numpy(_quant_rows(8, 256, 3))
    before = launch_counts()
    q, s = tqp.quantize_blockwise(x)
    tqp.dequantize_blockwise(q, s)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launch_counts() == before
    with pytest.raises(TypeError):
        tqp.quantize_blockwise(x.double())
    with pytest.raises(ValueError):
        tqp.quantize_blockwise(x[:, :200])
    with pytest.raises(ValueError):
        tqp.quantize_blockwise(x.t())
    with pytest.raises(ValueError):
        tqp.dequantize_blockwise(q, s[:, :0])
    with pytest.raises(TypeError):
        tqp.dequantize_blockwise(q.to(torch.int16), s)


# ------------------------------------------------------------- scatter

@pytest.mark.parametrize("n,d", [(16, 128), (40, 300), (7, 3), (64, 896)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_scatter_rows_plain_matches_reference(n, d, dtype):
    """-1 and out-of-range rows skipped, duplicate indices resolved as the
    reference's sequential scatter resolves them (the last row wins); D
    not a multiple of 128 goes through the reference's padding wrapper."""
    from repro.kernels import ops
    rng = np.random.default_rng(n * d)
    m = n + 5
    dst = (rng.standard_normal((n, d)) * 100).astype(dtype)
    packed = (rng.standard_normal((m, d)) * 100).astype(dtype)
    idx = rng.integers(0, n, m).astype(np.int32)     # duplicates included
    idx[::4] = -1
    idx[1] = n                                       # out of range
    want = np.asarray(ops.scatter_rows(jnp.asarray(dst), jnp.asarray(packed),
                                       jnp.asarray(idx)))
    np.testing.assert_array_equal(want, np.asarray(ref.scatter_rows_ref(
        jnp.asarray(dst), jnp.asarray(packed), jnp.asarray(idx))))
    t_dst = torch.from_numpy(dst.copy())
    got = tpf.scatter_rows(t_dst, torch.from_numpy(packed),
                           torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(t_dst.numpy(), dst)        # functional: a copy
    out = tpf.scatter_rows_(t_dst, torch.from_numpy(packed),
                            torch.from_numpy(idx))
    assert out is t_dst
    np.testing.assert_array_equal(t_dst.numpy(), want)


def test_scatter_rows_roundtrip_with_pack_rows():
    """scatter(pack(x)) restores exactly the selected rows, as the
    reference's round-trip test checks."""
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32))
    idx = torch.from_numpy(rng.choice(40, 20, replace=False).astype(np.int32))
    got = tpf.scatter_rows(torch.zeros_like(src), tpf.pack_rows(src, idx),
                           idx)
    assert torch.equal(got[idx.long()], src[idx.long()])
    keep = torch.ones(40, dtype=torch.bool)
    keep[idx.long()] = False
    assert not got[keep].any()


def test_scatter_rows_wrapper_checks():
    dst, packed = torch.zeros(8, 4), torch.ones(3, 4)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(TypeError):
        tpf.scatter_rows_(dst, packed, idx.long())
    with pytest.raises(TypeError):
        tpf.scatter_rows_(dst, packed.double(), idx)
    with pytest.raises(ValueError):
        tpf.scatter_rows_(dst, torch.ones(3, 5), idx)
    with pytest.raises(ValueError):
        tpf.scatter_rows_(dst.t(), torch.ones(3, 8), idx)
    tpf.scatter_rows_(dst, packed, idx)
    assert launch_counts()["scatter_rows"] == 0      # CPU: plain version
