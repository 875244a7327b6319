"""B1 (``ctr_sparse_rows.cu``) in both forms against its plain versions,
on a card.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu``, so it runs on a machine
without them (``pytest --noconftest -m cuda``). Tolerance: bitwise — both
sides apply the same f32-sealed rule, and the plain versions (run on the
card) are the oracle.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ops import sparse_optimizer as so

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kw(pair, cag):
    return dict(embed_rule=pair[0], embedx_rule=pair[1], create_applies_grad=cag, **CS.HYPER)


@pytest.mark.cuda
@pytest.mark.parametrize("cag", [True, False])
@pytest.mark.parametrize("pair", CS.RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 13])
def test_rows_kernel_matches_plain(dim, pair, cag):
    """Rows in, rows out: 39 whole tiles and a short one."""
    dev = _cuda()
    rng = np.random.default_rng(dim + CS.RULE_PAIRS.index(pair) * 2 + cag)
    cols, deltas = CS.rows_inputs(rng, 39 * 128 + 37, dim, *pair, dev)
    before = so.ctr_sparse_rows.launches
    got = so.ctr_sparse_rows(cols, *deltas, **_kw(pair, cag))
    torch.cuda.synchronize()
    assert so.ctr_sparse_rows.launches == before + 1
    want = CS.plain(cols, deltas, *pair, cag)
    assert CS.bitwise_cols(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cag", [True, False])
@pytest.mark.parametrize("pair", CS.RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 13])
def test_rows_at_kernel_matches_plain(dim, pair, cag):
    """In place by index: padding and negative rows in random order, int32
    and int64 rows, a short last tile; untouched rows keep their bits."""
    dev = _cuda()
    i = CS.RULE_PAIRS.index(pair) * 2 + cag
    rng = np.random.default_rng(100 + dim + i)
    C = 20_000
    state, uniq, ds, dc, g = CS.at_inputs(rng, C, 39 * 128 + 37, dim, *pair, dev,
                                          (torch.int32, torch.int64)[i % 2])
    got = tuple(c.clone() for c in state)
    before = so.ctr_sparse_rows.launches
    assert so.ctr_sparse_rows_at(got, uniq, ds, dc, g, capacity=C, **_kw(pair, cag)) is got
    torch.cuda.synchronize()
    assert so.ctr_sparse_rows.launches == before + 1
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                       capacity=C, **_kw(pair, cag))
    assert CS.bitwise_cols(got, want)
    untouched = torch.ones(C, dtype=torch.bool, device=dev)
    untouched[uniq[(uniq >= 0) & (uniq < C)].long()] = False
    assert CS.bitwise_cols([c[untouched] for c in got], [c[untouched] for c in state])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128])
def test_rows_at_all_sentinels_and_small(n):
    """An all-sentinel batch changes nothing; n below and at one tile."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    C, pair = 300, ("adam", "adam")
    state, _, ds, dc, g = CS.at_inputs(rng, C, n + 10, 8, *pair, dev)
    ds, dc, g = ds[:n], dc[:n], g[:n].contiguous()
    uniq = torch.from_numpy(rng.choice(C, n, replace=False)).to(dev)
    sentinel = torch.where(torch.arange(n, device=dev) % 2 == 0, C, -3)
    got = tuple(c.clone() for c in state)
    so.ctr_sparse_rows_at(got, sentinel, ds, dc, g, capacity=C, **_kw(pair, True))
    torch.cuda.synchronize()
    assert CS.bitwise_cols(got, state)
    so.ctr_sparse_rows_at(got, uniq, ds, dc, g, capacity=C, **_kw(pair, True))
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                       capacity=C, **_kw(pair, True))
    assert CS.bitwise_cols(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", CS.RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 13])
def test_rows_at_on_a_shard_of_125_rows(dim, pair):
    """Shard 1 of a 4-shard cache of 500 rows (``shard_state``: each
    column a view from row 125, so the 1-wide columns start on 4 bytes and
    Adam's 18-float rows on 8) with 130 entries (a whole tile and a short
    one): bitwise against ``ctr_sparse_rows_at_plain`` on the same shard;
    the other shards keep their bits."""
    from paddle_tpu_torch.ps.sharded_cache import shard_state

    dev = _cuda()
    i = CS.RULE_PAIRS.index(pair)
    rng = np.random.default_rng(300 + dim * 10 + i)
    K, per = 4, 125
    full, _ = CS.rows_inputs(rng, K * per, dim, *pair, dev)
    kept = tuple(c.clone() for c in full)
    shard = shard_state(dict(zip(CS.COLUMNS, full)), K)[1]
    _, uniq, ds, dc, g = CS.at_inputs(rng, per, 130, dim, *pair, dev,
                                      (torch.int32, torch.int64)[i % 2])
    cols = tuple(shard[k] for k in CS.COLUMNS)
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in cols), uniq, ds, dc, g,
                                       capacity=per, **_kw(pair, True))
    so.ctr_sparse_rows_at(cols, uniq, ds, dc, g, capacity=per, **_kw(pair, True))
    torch.cuda.synchronize()
    assert CS.bitwise_cols(cols, want)
    rest = lambda cs: [torch.cat([c[:per], c[2 * per:]]) for c in cs]
    assert CS.bitwise_cols(rest(full), rest(kept))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [("adagrad", "adagrad"), ("adam", "adam")],
                         ids=lambda p: "/".join(p))
def test_misaligned_columns_match_plain(pair):
    """Every column and delta starting 4 bytes past a 16-byte boundary
    launches (4-byte pieces, entries from global memory) and equals the
    plain version bitwise."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    state, uniq, ds, dc, g = CS.at_inputs(rng, 1000, 500, 8, *pair, dev)

    def off_by_one_float(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                       capacity=1000, **_kw(pair, True))
    got = tuple(off_by_one_float(c) if c.numel() else c for c in state)
    so.ctr_sparse_rows_at(got, uniq, *(off_by_one_float(t) for t in (ds, dc, g)),
                          capacity=1000, **_kw(pair, True))
    torch.cuda.synchronize()
    assert CS.bitwise_cols(got, want)


@pytest.mark.cuda
def test_pass_push_launches_the_merge_and_b1_once():
    """``cache_push_sparse`` on the card: one merge and one B1 launch, and
    the same state as the push on the CPU copy."""
    from paddle_tpu_torch.ps.embedding_cache import cache_push_sparse

    dev = _cuda()
    rng = np.random.default_rng(9)
    cols, _ = CS.rows_inputs(rng, 5000, 8, "adagrad", "adagrad", dev)
    state = dict(zip(CS.COLUMNS, cols))
    push = [t[:3000] for t in CS.pass_push(rng, dev)]
    push[0] = push[0] % 5000
    cfg = CS.hot_cfg("adagrad", "adagrad", True)
    want = cache_push_sparse({k: v.cpu() for k, v in state.items()}, *(t.cpu() for t in push),
                             cfg)
    before = (hk.merge_sparse_grads.launches, so.ctr_sparse_rows.launches)
    cache_push_sparse(state, *push, cfg)
    torch.cuda.synchronize()
    assert (hk.merge_sparse_grads.launches, so.ctr_sparse_rows.launches) == (
        before[0] + 1, before[1] + 1)
    assert CS.bitwise_cols([state[k].cpu() for k in CS.COLUMNS], [want[k] for k in CS.COLUMNS])
