"""The hot-tier CUDA kernels against their plain versions, on a card.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu``, so it runs on a machine
without them (``pytest --noconftest -m cuda``). Tolerance: bitwise — the
plain versions are the oracle, and the kernels sum duplicates in the
same occurrence order from 0.0 and apply the same f32-sealed rule. The
plain push and merge run on the CPU copy of the inputs (the plain merge
on the card would sum with atomics).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim
from paddle_tpu_torch.ps.device_hash import DynamicDeviceKeyMap, split_keys
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from test_torch_hot_kernels_emulated import PROBE_GROUP, tie_wrap_map, tier

RULES = ["naive", "adagrad", "std_adagrad", "adam"]
C, DIM = 1024, 8


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _state(rng, es, xs, adam):
    f = np.float32
    st = {"show": np.abs(rng.normal(size=C)).astype(f),
          "click": np.abs(rng.normal(size=C)).astype(f),
          "embed_w": rng.normal(size=(C, 1)).astype(f),
          "embed_state": np.abs(rng.normal(size=(C, es))).astype(f),
          "embedx_w": rng.normal(size=(C, DIM)).astype(f),
          "embedx_state": np.abs(rng.normal(size=(C, xs))).astype(f),
          "has_embedx": (rng.random(C) > 0.5).astype(f)}
    if adam:  # beta-power columns in (0, 1) like real rows
        st["embed_state"][:, 2:] = 0.9
        st["embedx_state"][:, 2 * DIM:] = 0.9
    return {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("banks", [1, 4])
def test_probe_gather_kernel_matches_plain(banks):
    _cuda()
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(1, 2**63, 900).astype(np.uint64))[:600]
    m = DynamicDeviceKeyMap(C, device="cpu", banks=banks)
    rows, nxt = np.zeros(len(keys), np.int32), [0] * banks
    for i, b in enumerate(m.bank_of(keys)):  # a key's row in its bank's block
        rows[i] = b * (C // banks) + nxt[b]
        nxt[b] += 1
    m.insert(keys, rows)
    hi, lo = split_keys(np.concatenate([keys, rng.integers(1, 2**63, 300).astype(np.uint64)]))
    th, tl = torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32))
    state = _state(rng, 1, 1, False)
    ms = m.device_state()
    want = hk.hot_probe_gather(ms, th, tl, state, probe_buckets=2, banks=banks)
    before = hk.hot_probe_gather.launches
    got = hk.hot_probe_gather({k: v.cuda() for k, v in ms.items()}, th.cuda(), tl.cuda(),
                              {k: v.cuda() for k, v in state.items()},
                              probe_buckets=2, banks=banks)
    torch.cuda.synchronize()
    assert hk.hot_probe_gather.launches == before + 1
    assert (want[0][:len(keys)].numpy() == rows).all()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("banks", [1, 4, 8])
def test_probe_kernel_matches_plain(banks):
    """B3 (probe only) against ``dynamic_map_lookup``, bitwise, and
    against B2's rows: the two kernels share one probe function."""
    _cuda()
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(1, 2**63, 900).astype(np.uint64))[:600]
    m = DynamicDeviceKeyMap(C, device="cpu", banks=banks)
    rows, nxt = np.zeros(len(keys), np.int32), [0] * banks
    for i, b in enumerate(m.bank_of(keys)):
        rows[i] = b * (C // banks) + nxt[b]
        nxt[b] += 1
    m.insert(keys, rows)
    m.remove(keys[::7])
    hi, lo = split_keys(np.concatenate([keys, rng.integers(1, 2**63, 301).astype(np.uint64)]))
    th, tl = torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32))
    ms = m.device_state()
    want = hk.hot_probe(ms, th, tl, probe_buckets=2, banks=banks)
    cms = {k: v.cuda() for k, v in ms.items()}
    before = hk.hot_probe.launches
    got = hk.hot_probe(cms, th.cuda(), tl.cuda(), probe_buckets=2, banks=banks)
    torch.cuda.synchronize()
    assert hk.hot_probe.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert (want[::7][:len(keys[::7])] == -1).all() and (want >= 0).sum() > 400
    fused, _ = hk.hot_probe_gather(cms, th.cuda(), tl.cuda(),
                                   {k: v.cuda() for k, v in _state(rng, 1, 1, False).items()},
                                   probe_buckets=2, banks=banks)
    assert torch.equal(fused, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, PROBE_GROUP + 5])
@pytest.mark.parametrize("bslots,banks", [(4, 1), (8, 1), (4, 4), (8, 4)])
def test_probes_on_the_tie_wrap_map(bslots, banks, dim):
    """B3 and B2 on the hand-built map of the emulated tests (ties inside
    and across buckets, freed slots, wrapped windows, a clamped row; 1001
    keys), bitwise against their plain versions on the CPU."""
    _cuda()
    ms, kh, kl, want = tie_wrap_map(bslots + banks, bslots, banks)
    state = tier(128, dim)
    plain = hk.hot_probe_gather(ms, kh, kl, state, probe_buckets=2, banks=banks)
    cms = {k: v.cuda() for k, v in ms.items()}
    rows = hk.hot_probe(cms, kh.cuda(), kl.cuda(), probe_buckets=2, banks=banks)
    got = hk.hot_probe_gather(cms, kh.cuda(), kl.cuda(), {k: v.cuda() for k, v in state.items()},
                              probe_buckets=2, banks=banks)
    torch.cuda.synchronize()
    assert (rows.cpu().numpy() == want).all()
    assert torch.equal(rows.cpu(), plain[0]) and torch.equal(got[0].cpu(), plain[0])
    assert torch.equal(got[1].cpu().view(torch.int32), plain[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
def test_scatter_apply_and_merge_kernels_match_plain(rule):
    _cuda()
    rng = np.random.default_rng(3)
    n = 4001
    es, xs = rule_state_dim(rule, 1), rule_state_dim(rule, DIM)
    rows = np.concatenate([rng.integers(0, C, n - 1200), np.full(1000, 7),  # a heavy row
                           np.full(100, C), -rng.integers(1, 5, 100)])
    rng.shuffle(rows)
    args = [torch.from_numpy(a) for a in (
        rows.astype(np.int32), rng.normal(size=(n, 1 + DIM)).astype(np.float32),
        rng.integers(1, 3, n).astype(np.float32), (rng.random(n) > 0.6).astype(np.float32))]
    cfg = CacheConfig(capacity=C, embedx_dim=DIM, embed_rule=rule, embedx_rule=rule,
                      embedx_threshold=1.5)
    state = _state(rng, es, xs, rule == "adam")
    want = hk.hot_scatter_apply({k: v.clone() for k, v in state.items()}, *args, cfg)
    before = hk.hot_scatter_apply.launches
    got = hk.hot_scatter_apply({k: v.cuda() for k, v in state.items()},
                               *[a.cuda() for a in args], cfg)
    torch.cuda.synchronize()
    assert hk.hot_scatter_apply.launches == before + 1
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    rows64 = [args[0].to(torch.int64), *args[1:]]
    mw = hk.merge_sparse_grads(*rows64, C)
    mg = hk.merge_sparse_grads(*[a.cuda() for a in rows64], C)
    for g, w in zip(mg, mw):
        assert torch.equal(g.cpu(), w)


def _sort_rows_np(kind, n, rng):
    """Row batches for the sort: the hot path's, one shard's owner push
    (most of it the sentinel), the heavy-hitter batch's mix, all equal."""
    if kind == "hot":
        return rng.integers(0, 260_000, n)
    if kind == "owner":
        r = np.full(n, 131_072)
        for b in range(4):  # four routed buckets, each sorted rows then padding
            r[b * (n // 4):b * (n // 4) + n // 10] = np.sort(rng.integers(0, 131_072, n // 10))
        return r
    if kind == "heavy":
        r = rng.integers(0, 1 << 19, n)
        u = rng.random(n)
        r[u < 0.1] = rng.integers(0, 32, int((u < 0.1).sum()))
        r[u < 0.02] = 7
        r[u > 0.99] = 1 << 19
        r[u > 0.995] = -1 - rng.integers(0, 4, int((u > 0.995).sum()))
        return r
    return np.full(n, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("heavy", 0), ("heavy", 1), ("heavy", 255), ("heavy", 4097),
                                    ("heavy", 10001), ("owner", 53_248), ("hot", 106_496),
                                    ("heavy", 106_496), ("equal", 9000)])
def test_radix_sort_is_torch_sort(kind, n):
    """The radix sort is bit-identical to ``torch.sort(stable=True)``:
    full mode on the rows, bounded mode on the rows mapped to the bound
    (every row outside [0, bound) made the bound), int32 and int64 rows
    and outputs."""
    _cuda()
    r = _sort_rows_np(kind, n, np.random.default_rng(n))
    for bound in (None, 1 << 19, 131_072):
        for dtype in (torch.int32, torch.int64):
            rows = torch.from_numpy(r).to(dtype).cuda()
            keys = rows if bound is None else torch.where((rows >= 0) & (rows < bound), rows, bound)
            want_rows, want_perm = torch.sort(keys, stable=True)
            for index_dtype in (torch.int32, torch.int64):
                before = hk._sort_rows.launches
                srows, perm = hk._sort_rows(rows, bound, index_dtype)
                torch.cuda.synchronize()
                assert hk._sort_rows.launches == before + (n > 0)
                assert torch.equal(srows.to(torch.int64), want_rows.to(torch.int64)), (bound, dtype)
                assert torch.equal(perm.to(torch.int64), want_perm), (bound, dtype)


@pytest.mark.cuda
def test_radix_sort_raises_instead_of_falling_back():
    _cuda()
    with pytest.raises(Exception, match="int32 or int64"):
        hk._sort_rows(torch.zeros(8, dtype=torch.float32, device="cuda"))
    with pytest.raises(Exception, match="bound"):
        hk._sort_rows(torch.zeros(8, dtype=torch.int32, device="cuda"), 2**31)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 5])
@pytest.mark.parametrize("rule", RULES)
def test_walk_paths_match_plain(rule, dim):
    """B4 and the merge bitwise against their plain versions on the CPU,
    through every path of the walk: short segments (one thread), a
    segment crossing a tile edge, warp-long ones (32 to 255 entries), one
    past the block threshold (2,351 entries), dropped rows; dim 8 (the
    fixed-width instance) and 5 (the run-time width)."""
    _cuda()
    rng = np.random.default_rng(5 + dim)
    es, xs = rule_state_dim(rule, 1), rule_state_dim(rule, dim)
    parts = [rng.integers(0, C, 6000), np.full(2351, 7), np.full(40, 9), np.full(100, 11),
             np.full(31, 12), np.full(300, C), -rng.integers(1, 5, 100)]
    rows = np.concatenate(parts)
    rng.shuffle(rows)
    n = len(rows)
    grads = (rng.normal(size=(n, 1 + dim)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    args = [torch.from_numpy(a) for a in (
        rows.astype(np.int32), grads, rng.integers(1, 3, n).astype(np.float32),
        (rng.random(n) > 0.6).astype(np.float32))]
    cfg = CacheConfig(capacity=C, embedx_dim=dim, embed_rule=rule, embedx_rule=rule,
                      embedx_threshold=1.5)
    f = np.float32
    state = {"show": np.abs(rng.normal(size=C)).astype(f),
             "click": np.abs(rng.normal(size=C)).astype(f),
             "embed_w": rng.normal(size=(C, 1)).astype(f),
             "embed_state": np.abs(rng.normal(size=(C, es))).astype(f),
             "embedx_w": rng.normal(size=(C, dim)).astype(f),
             "embedx_state": np.abs(rng.normal(size=(C, xs))).astype(f),
             "has_embedx": (rng.random(C) > 0.5).astype(f)}
    if rule == "adam":
        state["embed_state"][:, 2:] = 0.9
        state["embedx_state"][:, 2 * dim:] = 0.9
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    want = hk.hot_scatter_apply({k: v.clone() for k, v in state.items()}, *args, cfg)
    for rows_dtype in (torch.int32, torch.int64):
        got = hk.hot_scatter_apply({k: v.cuda() for k, v in state.items()},
                                   args[0].to(rows_dtype).cuda(), *[a.cuda() for a in args[1:]],
                                   cfg)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (k, rows_dtype)
        merged = [args[0].to(rows_dtype), *args[1:]]
        mw = hk.merge_sparse_grads(*merged, C)
        mg = hk.merge_sparse_grads(*[a.cuda() for a in merged], C)
        for g, w in zip(mg, mw):
            assert torch.equal(g.cpu(), w)
