"""The fused dense-score top-k kernels (#1 and #2, csrc/topk.cu), checked on
the CPU.

The kernels run only on the card; what surrounds them is held here. The
launch plan (``topk_plan``): row groups cover the queries once, the column
blocks of a group cover the corpus once in whole 128-column tiles, the
block's shared memory fits. A numpy model of the kernels' selection, run
under that plan (per block and query row a ranked list of KP pairs whose
k-th entry is the threshold, a buffer of KP candidates that a score enters
only if it ranks before the threshold by (score, index), 32 columns at a
time, a buffer that would overflow merged into the list first; k
candidates a block, the block's first tile sorted whole into the list;
then per row the merge's warps (eight in a second launch, the last
block's four under the last-block route) over strided shares of the
candidates at or before the best of the blocks' k-th entries, their lists
combined pairwise), equals
``rank_topk`` and the JAX kernels in interpret mode on adversarial inputs:
every score equal, duplicates straddling tile and block boundaries, every
column masked, k = 128 above the live count, b in {1, 3, 9}. Integer-valued
vectors make every dot exact, so all three see the same scores.

The int8 kernel's fragments (ldmatrix.trans byte pairs, two PRMTs, the
queries staged in the permuted k order) and its in-kernel quantizer are
modelled bit for bit; a stand-in library records what the wrappers pass
to the C entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import topk as jtopk
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import topk
from test_torch_kernel_plans import H100_SMS, _EntryRecorder
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

TILE = topk._TILE
SENTINEL = (-np.inf, 2**31 - 1)

# (n, b, sms, d, k, kind): chip_smoke.py's S1-S3, then tiny shapes
PLAN_SHAPES = [(16384, 1, H100_SMS, 384, 20, "bf16"), (1 << 20, 1, H100_SMS, 384, 20, "bf16"),
               (65536, 256, H100_SMS, 384, 10, "bf16"), (65536, 256, H100_SMS, 384, 10, "int8"),
               (1 << 20, 8, H100_SMS, 384, 128, "int8"), (16384, 64, H100_SMS, 1024, 128, "bf16"),
               (16384, 64, H100_SMS, 1024, 128, "f32"), (1024, 1, 1, 8, 1, "bf16"),
               (2048, 3, 4, 32, 5, "int8"), (2048, 9, 3, 32, 128, "f32"),
               (1024, 130, H100_SMS, 16, 10, "bf16"), (3072, 65, 7, 384, 64, "int8")]


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b,sms,d,k,kind", PLAN_SHAPES)
def test_topk_plan_covers_rows_and_columns_once(n, b, sms, d, k, kind):
    """Row groups of 8-64 rows cover b once; each group's column blocks
    cover the tiles once, in order, each a non-empty run of whole tiles; a
    block's shared memory fits; a single query takes the last-block merge."""
    plan = topk.topk_plan(n, b, sms, d, k, kind)
    assert plan.rows in (8, 16, 32, 64) and plan.tiles * TILE == n
    assert plan.rows * (plan.groups - 1) < b <= plan.rows * plan.groups
    assert plan.rows == 8 or plan.rows < 2 * b  # no n-tile more than b needs
    assert topk.topk_smem(plan.rows, d, k, kind) <= topk._SMEM_BLOCK
    assert 1 <= plan.blocks <= plan.tiles
    assert plan.merge == ("last_block" if b == 1 else "launch")
    ranges = [topk.topk_block_tiles(plan, p) for p in range(plan.blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.tiles
    assert all(t0 < t1 for t0, t1 in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))


def test_topk_plan_on_the_h100_at_the_timed_shapes():
    """S1 fills the card with one tile a block; S2 two blocks an SM; S3
    four groups of 64 rows (the corpus read 4 times, not the 32 times of
    8-row groups), one block an SM; k = 128 at d = 1024 halves the rows. A
    single query (S1, S2) is merged by the last block, more by a second
    launch."""
    assert topk.topk_plan(16384, 1, H100_SMS) == (8, 1, 128, 128, "last_block")
    assert topk.topk_plan(1 << 20, 1, H100_SMS) == (8, 1, 264, 8192, "last_block")
    assert topk.topk_plan(65536, 256, H100_SMS, 384, 10) == (64, 4, 33, 512, "launch")
    assert topk.topk_plan(65536, 256, H100_SMS, 384, 10, "int8") == (64, 4, 33, 512, "launch")
    assert topk.topk_plan(16384, 2, H100_SMS).merge == "launch"
    assert topk.topk_plan(16384, 64, H100_SMS, 1024, 128).rows == 32
    assert topk.topk_kp(1) == topk.topk_kp(32) == 32
    assert topk.topk_kp(33) == 64 and topk.topk_kp(128) == 128


def _cu_smem():
    """csrc/topk.cu's score_smem as a Python function of (rows, d, kp,
    itemsize), evaluated from the source with its constants, q_row_bytes
    and sel_bytes."""
    import os
    import re
    with open(os.path.join(kernels.CSRC, "topk.cu")) as f:
        src = f.read()
    ns = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        ns[name] = eval(expr, {}, ns)

    def body(fn):  # the return expression of `fn`, as Python
        expr = re.search(fn + r"\(.*?\{.*?return ([^;]+);", src, re.S).group(1)
        expr = expr.replace("(size_t)", "").replace("(int)sizeof(T)", "itemsize")
        return " ".join(expr.replace("<T>", "").replace("/", "//").split())

    q_row = body("q_row_bytes")
    sel = body("sel_bytes")
    total = body("score_smem")
    d64 = re.search(r"score_smem\(.*?const int d64 = ([^;]+);", src, re.S).group(1)

    def smem(rows, d, kp, itemsize):
        env = dict(ns, rows=rows, d=d, kp=kp, itemsize=itemsize)
        env["d64"] = eval(d64.replace("/", "//"), {}, env)
        env["q_row_bytes"] = lambda d64: eval(q_row, {}, dict(env, d64=d64))
        env["sel_bytes"] = lambda rows, kp: eval(sel, {}, dict(env, rows=rows, kp=kp))
        return eval(total, {}, env)
    return src, ns, smem


def test_topk_smem_mirrors_the_kernel_source():
    """ops/topk.py's copy of the scoring kernel's shared-memory layout
    (which chooses the rows a block) equals csrc/topk.cu's score_smem and
    kp_of at every rows, k and dtype the plan can pick, read from the
    source: a drift would otherwise show only when cudaFuncSetAttribute
    refuses on the card."""
    src, ns, smem = _cu_smem()
    assert ns["kTile"] == topk._TILE
    assert ns["kStages"] * ns["kStageBytes"] == topk._RING_BYTES
    assert "return k <= 32 ? 32 : (k <= 64 ? 64 : 128);" in src  # kp_of, as topk_kp
    for kind, itemsize in topk._ITEMSIZE.items():
        for rows in (8, 16, 32, 64):
            for d in (8, 64, 384, 1000, 1024):
                for k in (1, 20, 32, 33, 64, 65, 128):
                    assert topk.topk_smem(rows, d, k, kind) == smem(rows, d, topk.topk_kp(k),
                                                                   itemsize)


# ---------------------------------------------------------------------------
# a numpy model of the kernels' selection
# ---------------------------------------------------------------------------

def _key(e):
    return (-e[0], e[1])


class _RowSel:
    """One query row's selection, owned by one warp, as csrc/topk.cu's
    RowSel and offer(): a ranked list of kp pairs, a buffer of kp."""

    def __init__(self, k, kp):
        self.k, self.kp = k, kp
        self.list = [SENTINEL] * kp
        self.buf = []
        self.merges = 0

    def passes(self, e):
        return _key(e) < _key(self.list[self.k - 1])

    def merge(self):
        self.list = sorted(self.list + self.buf, key=_key)[:self.kp]
        self.buf = []
        self.merges += 1

    def offer(self, batch):
        """A warp's 32 lanes offer `batch` (None where a lane offers
        nothing): what passes the threshold enters the buffer; a buffer
        that would overflow is merged first and the batch tested again."""
        want = [e for e in batch if e is not None and self.passes(e)]
        if want and len(self.buf) + len(want) > self.kp:
            self.merge()
            want = [e for e in want if self.passes(e)]
        self.buf += want

    def finish(self):
        if self.buf:
            self.merge()
        return self.list[:self.k]


def _emit(e):
    return (topk.NEG_INF, -1) if e[0] <= topk.NEG_INF else e


MERGE_WARPS = {"launch": 8, "last_block": 4}  # the merge kernel's warps; the score kernel's


def _merge_row(cands, k, kp, warps=8, loads=8):
    """csrc/topk.cu's merge_candidates on one row's blocks x k candidates."""
    cut = min((cands[p + k - 1] for p in range(0, len(cands), k)), key=_key)
    sels = [_RowSel(k, kp) for _ in range(warps)]
    for w, sel in enumerate(sels):
        for base in range(w * 32, len(cands), loads * warps * 32):
            for u in range(loads):
                js = [base + u * warps * 32 + lane for lane in range(32)]
                sel.offer([cands[j] if j < len(cands) and _key(cands[j]) <= _key(cut) else None
                           for j in js])
        sel.finish()
    half = warps // 2
    while half:  # warp w takes in warp w + half's best k
        for w in range(half):
            for t0 in range(0, k, 32):
                sels[w].offer(sels[w + half].list[t0:min(t0 + 32, k)])
            sels[w].finish()
        half //= 2
    return sels[0].list[:k]


def model_topk(scores: np.ndarray, k: int, plan, merge=None) -> tuple:
    """The kernels' result on f32 scores (b, n) = queries @ corpus + mask:
    per block and query row, the first tile's best kp as the list, each
    later tile offered 32 columns at a time; then the merge over the
    blocks' k candidates a row, by the warps of the `merge` route (by
    default the plan's)."""
    b, n = scores.shape
    kp = topk.topk_kp(k)
    cands = [[] for _ in range(b)]  # per row, each block's k candidates in block order
    for grp in range(plan.groups):
        rows = range(grp * plan.rows, min(b, (grp + 1) * plan.rows))
        for p in range(plan.blocks):
            t0, t1 = topk.topk_block_tiles(plan, p)
            for row in rows:
                sel = _RowSel(k, kp)  # the first tile sorted whole into the list
                first = [(float(scores[row, c]), c) for c in range(t0 * TILE, (t0 + 1) * TILE)]
                sel.list = sorted(first, key=_key)[:kp]
                for c0 in range((t0 + 1) * TILE, t1 * TILE, 32):
                    sel.offer([(float(scores[row, c]), c) for c in range(c0, c0 + 32)])
                cands[row] += sel.finish()
    warps = MERGE_WARPS[merge or plan.merge]
    best = [cands[row] if plan.blocks == 1 else _merge_row(cands[row], k, kp, warps)
            for row in range(b)]
    out = [[_emit(e) for e in r] for r in best]
    return (np.array([[e[0] for e in r] for r in out], np.float32),
            np.array([[e[1] for e in r] for r in out], np.int32))


def _integer_case(seed, n, d, b, *, all_equal=False, live=None):
    """Integer-valued columns and queries (every dot exact in f32, in any
    order) with duplicates of column 5 at both sides of the first tile
    boundary, of a middle block boundary and of the last tile boundary,
    and 40 dead columns (or only `live` live ones)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, (n, d)).astype(np.float32)
    if all_equal:
        c[:] = c[0]
    q = rng.integers(-3, 4, (b, d)).astype(np.float32)
    mid = n // 2
    c[[TILE - 1, TILE, mid - 1, mid, n - TILE - 1, n - TILE]] = c[5]
    q[0] = c[5]
    mask = np.zeros((1, n), np.float32)
    if live is None:
        mask[0, rng.choice(n, 40, replace=False)] = topk.NEG_INF
    else:
        mask[:] = topk.NEG_INF
        mask[0, rng.choice(n, live, replace=False)] = 0.0
    return q, c, mask


CASES = {  # name: (seed, n, d, b, k, sms, kwargs)
    "b1": (0, 2048, 16, 1, 20, 3, {}),
    "b3 all equal": (1, 2048, 16, 3, 10, 4, {"all_equal": True}),
    "b9 one block": (2, 1024, 16, 9, 5, 1, {}),
    "b9 every column masked": (3, 2048, 16, 9, 7, 5, {"live": 0}),
    "b3 k128 above the live": (4, 2048, 16, 3, 128, 3, {"live": 100}),
}


@pytest.mark.parametrize("merge", topk.MERGE_ROUTES)
@pytest.mark.parametrize("name", list(CASES))
def test_selection_model_equals_rank_topk_and_jax(name, merge):
    """The model under the plan, on either merge route, equals rank_topk on
    the plain scores, and its ids equal the JAX kernel's (interpret mode)
    with scores within 1e-6 (they are integers there)."""
    seed, n, d, b, k, sms, kw = CASES[name]
    q, c, mask = _integer_case(seed, n, d, b, **kw)
    plan = topk.topk_plan(n, b, sms, d, k)
    assert plan.blocks > 1 or name == "b9 one block"
    scores = (torch.from_numpy(q) @ torch.from_numpy(c.T.copy())) + torch.from_numpy(mask)
    ms, mi = model_topk(scores.numpy(), k, plan, merge)
    ts, ti = topk.dense_topk(torch.from_numpy(q), torch.from_numpy(c.T.copy()), k,
                             mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(mi, ti.numpy())
    np.testing.assert_array_equal(ms, ts.numpy())
    js, ji = jtopk.dense_topk(jnp.asarray(q), jnp.asarray(c.T), k, mask=jnp.asarray(mask))
    np.testing.assert_array_equal(mi, np.asarray(ji))
    np.testing.assert_allclose(ms, np.asarray(js), rtol=0, atol=1e-6)
    if kw.get("live") == 0:
        assert (mi == -1).all() and (ms == topk.NEG_INF).all()
    if kw.get("live") == 100:
        assert (mi[:, 100:] == -1).all() and (mi[:, :100] >= 0).all()


@pytest.mark.parametrize("merge", topk.MERGE_ROUTES)
@pytest.mark.parametrize("k", [20, 128])
def test_selection_model_over_many_blocks_equals_rank_topk(k, merge):
    """At S1's plan on 132 SMs (128 one-tile blocks, so the merge's warps
    each take several 32-candidate loads, at k = 128 more than one pass)
    with ties in f32 scores rounded to 1/64, the model equals rank_topk on
    either merge route."""
    rng = np.random.default_rng(k)
    n = 16384
    scores = np.round(rng.standard_normal((1, n)) * 64).astype(np.float32) / 64
    scores[0, rng.choice(n, 300, replace=False)] = topk.NEG_INF
    plan = topk.topk_plan(n, 1, H100_SMS, 384, k)
    assert plan.blocks * k > 2048 or k == 20
    ms, mi = model_topk(scores, k, plan, merge)
    rs, ri = topk._rank_scores(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(mi, ri.numpy())
    np.testing.assert_array_equal(ms, rs.numpy())


@pytest.mark.parametrize("b", [1, 3, 9])
def test_int8_selection_model_equals_jax(b):
    """Over int8 codes with per-column scales (the int8 index), the model
    on the plain version's scores equals the plain version and JAX's int8
    kernel (interpret mode), ids exact and scores equal."""
    rng = np.random.default_rng(10 + b)
    n, d, k = 2048, 32, 16
    c = rng.standard_normal((n, d)).astype(np.float32)
    c[[TILE - 1, TILE, n // 2 - 1, n // 2]] = c[7]
    ci8, cs = jtopk.quantize_int8(jnp.asarray(c), axis=1)
    ci8, cs = np.asarray(ci8).T.copy(), np.asarray(cs).T.copy()
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] = c[7]
    mask = np.zeros((1, n), np.float32)
    mask[0, rng.choice(n, 30, replace=False)] = topk.NEG_INF
    plan = topk.topk_plan(n, b, 4, d, k, "int8")
    assert plan.blocks > 1
    qi8, qs = topk.quantize_int8(torch.from_numpy(q), axis=1)
    scores = (qi8.float() @ torch.from_numpy(ci8).float()) * qs * torch.from_numpy(cs)
    scores = scores + torch.from_numpy(mask)
    ms, mi = model_topk(scores.numpy(), k, plan)
    ts, ti = topk.dense_topk_int8(torch.from_numpy(q), torch.from_numpy(ci8),
                                  torch.from_numpy(cs), k, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(mi, ti.numpy())
    np.testing.assert_array_equal(ms, ts.numpy())
    js, ji = jtopk.dense_topk_int8(jnp.asarray(q), jnp.asarray(ci8), jnp.asarray(cs), k,
                                   mask=jnp.asarray(mask))
    np.testing.assert_array_equal(mi, np.asarray(ji))
    np.testing.assert_array_equal(ms, np.asarray(js))


def test_selection_model_merges_full_buffers_and_drops_losers():
    """128 rising scores offered 32 at a time into a 32-slot buffer merge
    three times; entries that fall behind the refreshed threshold are
    dropped, not buffered; among ties the lowest indices stay."""
    sel = _RowSel(20, 32)
    for c0 in range(0, 128, 32):
        sel.offer([(float(i), i) for i in range(c0, c0 + 32)])
    assert sel.merges == 3 and len(sel.buf) == 32
    assert sel.finish() == [(float(i), i) for i in range(127, 107, -1)]
    sel = _RowSel(4, 32)
    sel.offer([(1.0, i) for i in range(32)])
    sel.offer([(1.0, i) for i in range(32, 40)] + [None] * 24)
    assert sel.merges == 1 and sel.buf == []
    assert sel.finish() == [(1.0, i) for i in range(4)]


# ---------------------------------------------------------------------------
# #2's fragments and quantizer, modelled bit for bit
# ---------------------------------------------------------------------------

def _int8_kpos(p):
    """csrc/topk.cu int8_kpos: the logical k of physical k row p."""
    return (p & ~15) + 4 * ((p & 7) >> 1) + (p & 1) + (((p >> 3) & 1) << 1)


def _byte_perm(x, y, sel):
    pool = list(int(x).to_bytes(4, "little")) + list(int(y).to_bytes(4, "little"))
    return bytes(pool[(sel >> (4 * i)) & 7] for i in range(4))


def _ldmatrix_trans_b16(tile_bytes, rows, b16_col):
    """What lane 4 g + c receives of one 8x8 b16 matrix at k rows `rows`
    (8 of them) and b16 column block `b16_col` with .trans: memory rows 2c
    and 2c + 1 at b16 column g, low half first."""
    regs = {}
    for g in range(8):
        for c in range(4):
            lo = tile_bytes[rows[2 * c], 2 * (b16_col + g):2 * (b16_col + g) + 2]
            hi = tile_bytes[rows[2 * c + 1], 2 * (b16_col + g):2 * (b16_col + g) + 2]
            regs[(g, c)] = int.from_bytes(bytes(lo) + bytes(hi), "little")
    return regs


def test_int8_fragments_compute_the_exact_dot():
    """A 32-row k-block of 16 int8 columns through ldmatrix.trans and the
    two PRMTs, times the queries staged in int8_kpos order, through
    mma.sync m16n8k32's fragment layout: fragment row g is column 2g, row
    g + 8 column 2g + 1, and every dot equals the int32 dot of the
    original codes."""
    rng = np.random.default_rng(3)
    tile = rng.integers(-127, 128, (32, 16)).astype(np.int8)  # k-major: 32 k rows x 16 columns
    q = rng.integers(-127, 128, (8, 32)).astype(np.int8)
    staged = np.zeros_like(q)
    for p in range(32):
        staged[:, _int8_kpos(p)] = q[:, p]
    assert sorted(_int8_kpos(p) for p in range(32)) == list(range(32))
    mats = [_ldmatrix_trans_b16(tile.view(np.uint8), list(range(8 * j, 8 * j + 8)), 0)
            for j in range(4)]
    a = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for g in range(8):
        for c in range(4):
            r0, r1, r2, r3 = (m[(g, c)] for m in mats)
            frags = [_byte_perm(r0, r1, 0x6420), _byte_perm(r0, r1, 0x7531),
                     _byte_perm(r2, r3, 0x6420), _byte_perm(r2, r3, 0x7531)]
            for reg, (row, kb) in zip(frags, ((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
                a[row, kb + 4 * c:kb + 4 * c + 4] = np.frombuffer(reg, np.int8)
            bm[4 * c:4 * c + 4, g] = staged[g, 4 * c:4 * c + 4]
            bm[16 + 4 * c:16 + 4 * c + 4, g] = staged[g, 16 + 4 * c:16 + 4 * c + 4]
    out = a @ bm                                            # (16 fragment rows, 8 queries)
    want = tile.astype(np.int64).T @ q.astype(np.int64).T   # (16 columns, 8 queries)
    for g in range(8):
        np.testing.assert_array_equal(out[g], want[2 * g])
        np.testing.assert_array_equal(out[g + 8], want[2 * g + 1])


def test_in_kernel_quantizer_equals_quantize_int8():
    """The kernel's quantizer (scale = max(amax, 1e-8) / 127 and x / scale
    correctly rounded in f32, rint half to even, clamp to +-127) equals
    quantize_int8 and JAX's, on rows with values at half a step and an
    all-zero row."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 384)).astype(np.float32)
    x[1, :40] = (np.arange(40, dtype=np.float32) - 20 + 0.5) * (np.abs(x[1]).max() / 127)
    x[2] = 0.0
    x[3, 0] = 1e-12
    amax = np.abs(x).max(axis=1, keepdims=True)
    scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    tq, ts = topk.quantize_int8(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(codes, tq.numpy())
    np.testing.assert_array_equal(scale, ts.numpy())
    jq, js = jtopk.quantize_int8(jnp.asarray(x), axis=1)
    np.testing.assert_array_equal(codes, np.asarray(jq))
    np.testing.assert_array_equal(scale, np.asarray(js))


# ---------------------------------------------------------------------------
# what the wrappers pass to the library
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: H100_SMS)
    kernels.reset_counts()
    yield rec
    kernels.reset_counts()


@pytest.mark.parametrize("b,n,k,qdtype,cdtype", [
    (1, 16384, 20, torch.float32, torch.bfloat16), (256, 65536, 10, torch.bfloat16, torch.bfloat16),
    (8, 2048, 128, torch.float32, torch.float32), (3, 1024, 5, torch.float16, torch.bfloat16)])
def test_dense_topk_wrapper_passes_the_plan(recorder, b, n, k, qdtype, cdtype):
    """rk_topk gets f32 queries (the kernel casts them to the corpus
    dtype; f32 queries pass without a copy), the corpus dtype, the plan's
    rows and blocks, and one topk count a call."""
    d = 384
    q = torch.zeros(b, d, dtype=qdtype)
    corpus = torch.zeros(d, n, dtype=cdtype)
    s, i = topk._dense_topk_cuda(q, corpus, k, torch.zeros(1, n))
    assert s.shape == i.shape == (b, k)
    (name, args), = recorder.calls
    plan = topk.topk_plan(n, b, H100_SMS, d, k, "bf16" if cdtype == torch.bfloat16 else "f32")
    assert name == "rk_topk"
    assert (args[0] == q.data_ptr()) == (qdtype == torch.float32)
    assert args[2] == (1 if cdtype == torch.bfloat16 else 0)
    assert args[4:10] == (b, d, n, k, plan.rows, plan.blocks)
    ticket = args[14]
    assert (ticket is None) == (plan.blocks == 1 or plan.merge == "launch")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0) | {"topk": 1}


@pytest.mark.parametrize("merge", topk.MERGE_ROUTES)
def test_merge_route_passes_a_ticket_a_row_group(recorder, merge):
    """The last-block route passes zeroed words, at least one a row group,
    kept per stream and reused by the next call (the kernel leaves them
    zero); a larger batch gets a larger buffer and the old one stays held
    (a captured graph may point at it). The launch route passes none."""
    topk._TICKETS.clear()
    d, n = 384, 65536
    corpus = torch.zeros(d, n, dtype=torch.bfloat16)
    for b in (1, 1, 256, 8192):
        topk._dense_topk_cuda(torch.zeros(b, d), corpus, 10, torch.zeros(1, n), merge)
    tickets = [args[14] for _, args in recorder.calls]
    if merge == "launch":
        assert tickets == [None] * 4 and not topk._TICKETS
        return
    (held,) = topk._TICKETS.values()
    assert [t.numel() for t in held] == [64, 128]
    assert all((t == 0).all() for t in held)
    assert tickets[0] == tickets[1] == tickets[2] == held[0].data_ptr()
    assert tickets[3] == held[1].data_ptr()  # 8192 rows: 128 groups of 64
    topk._TICKETS.clear()


@pytest.mark.parametrize("b,n,k", [(1, 16384, 20), (256, 65536, 10), (9, 2048, 128)])
def test_dense_topk_int8_wrapper_quantizes_nothing_on_the_host(recorder, monkeypatch, b, n, k):
    """rk_topk_int8 gets the f32 queries themselves (the kernel quantizes
    them: no quantize_int8 and no host scalar in a call), the plan's rows
    and blocks, and one topk_int8 count a call."""
    def refuse(*args, **kwargs):
        raise AssertionError("the int8 CUDA route quantized on the host")
    monkeypatch.setattr(topk, "quantize_int8", refuse)
    monkeypatch.setattr(topk, "divide_exactly", refuse)
    d = 384
    q = torch.zeros(b, d, dtype=torch.bfloat16)
    corpus = torch.zeros(d, n, dtype=torch.int8)
    s, i = topk._dense_topk_int8_cuda(q, corpus, torch.ones(1, n), k, torch.zeros(1, n))
    assert s.shape == i.shape == (b, k)
    (name, args), = recorder.calls
    plan = topk.topk_plan(n, b, H100_SMS, d, k, "int8")
    assert name == "rk_topk_int8" and args[4:10] == (b, d, n, k, plan.rows, plan.blocks)
    assert (args[14] is None) == (plan.blocks == 1 or plan.merge == "launch")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0) | {"topk_int8": 1}
