"""The compressed sparse wires in the port (``TableConfig.pull_wire_dtype``
and ``push_wire_dtype``), the test of ``tests/test_sparse_wire.py`` for
test, and across the packages.

- the per-table byte counters count the encoded wire: int8 moves at
  least 3x fewer push bytes than fp32 at embedx 64 (fp16 in between);
- the server's dequantization equals the client's bit for bit;
- int8 error-feedback residuals live per (table, key) on the client,
  fold into the key's next push, merge with duplicates first, drain at
  ``Communicator.quiesce()`` (no residual left after it) and drain
  themselves past ``FLAGS_ps_push_ef_max_rows``; the int8 wire's rows
  stay within 2e-3 of the fp32 wire's (the JAX test's tolerance);
- a backup that replays the tapped quantized frames converges bitwise;
- a malformed quantized frame is rejected whole (kErrBadSize);
- ragged and multi-block rows quantize within half a scale step.

Across the packages: ``_quant_push_int8``/``_dequant_push_int8`` equal
JAX's bitwise on seeded inputs (all-zero blocks, extremes, ragged
tails); an fp16 pull is bitwise equal between the packages and equals
``torch.from_numpy(fp32).half().float()``; a JAX client's int8 push on
port servers and a port client's on JAX servers end with equal digests.
"""

import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.obs import registry as _reg
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.communicator import SyncCommunicator
from paddle_tpu_torch.ps.rpc import (_PUSH_SPARSE, _PUSH_WIRE_BLOCK_SHIFT, _PUSH_WIRE_I8,
                                     RpcPsClient, _dequant_push_int8, _quant_push_int8)
from paddle_tpu_torch.ps.table import TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

MASK = 0xFFFFFFFFFFFFFFFF


def _acc(xd=64, th=0.0):
    # embedx_threshold 0: embedx initializes on the first push, so the
    # quantized gradient block lands in the embedx weights
    return AccessorConfig(embedx_dim=xd, embedx_threshold=th)


def _mk_cluster(n=2, mod=rpc):
    srvs = [mod.NativePsServer() for _ in range(n)]
    return srvs, [f"127.0.0.1:{s.port}" for s in srvs]


def _stop(srvs):
    for s in srvs:
        s.stop()
        s.close()


def _pushes(cli, tid, keys, gd, steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        push = np.zeros((len(keys), 3 + gd), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = rng.normal(0, 0.1, (len(keys), gd)).astype(np.float32)
        cli.push_sparse(tid, keys, push)


def _push_bytes(tid):
    fam = _reg.REGISTRY.snapshot()["metrics"].get("ps_client_wire_bytes", {"series": []})
    return sum(s["value"] for s in fam["series"]
               if s["labels"].get("dir") == "push" and s["labels"].get("table") == str(tid))


def test_push_wire_byte_ratio_int8_ge_3x():
    """The per-table counters on one workload: int8 moves at least 3x fewer
    push bytes than fp32, fp16 sits between, and each equals the encoded
    payload's formula (8 B key + 12 B head + the gradient block)."""
    got = {}
    for tid, wire in ((1, "fp32"), (2, "fp16"), (3, "int8")):
        srvs, eps = _mk_cluster()
        try:
            cli = RpcPsClient(eps)
            cli.create_sparse_table(tid, TableConfig(table_id=tid, accessor_config=_acc(64),
                                                     seed=5, push_wire_dtype=wire))
            keys = np.arange(1, 301, dtype=np.uint64)
            cli.pull_sparse(tid, keys)
            before = _push_bytes(tid)
            _pushes(cli, tid, keys, 65, steps=4)
            got[wire] = _push_bytes(tid) - before
            cli.close()
        finally:
            _stop(srvs)
    assert got["fp32"] >= 3.0 * got["int8"], got
    assert got["int8"] < got["fp16"] < got["fp32"], got
    rows = 4 * 300
    assert got == {"fp32": rows * (8 + 12 + 65 * 4), "fp16": rows * (8 + 12 + 65 * 2),
                   "int8": rows * (8 + 12 + 65 + 4)}


def test_server_dequant_matches_client_dequant_bitwise():
    digs = []
    rng = np.random.default_rng(3)
    keys = rng.integers(1, 1 << 40, 200).astype(np.uint64)
    grads = [rng.normal(0, 0.2, (len(keys), 9)).astype(np.float32) for _ in range(3)]
    for mode in ("int8", "predequantized_fp32"):
        srvs, eps = _mk_cluster()
        try:
            cli = RpcPsClient(eps)
            cli.create_sparse_table(0, TableConfig(
                accessor_config=_acc(8), seed=9,
                push_wire_dtype="int8" if mode == "int8" else "fp32",
                push_error_feedback=False))
            cli.pull_sparse(0, keys)
            for g in grads:
                push = np.zeros((len(keys), 12), np.float32)
                push[:, 1] = 1.0
                if mode == "int8":
                    push[:, 3:] = g
                else:
                    q, sc = _quant_push_int8(g, 9)
                    push[:, 3:] = _dequant_push_int8(q, sc, 9)
                cli.push_sparse(0, keys, push)
            digs.append(sum(cli.digest(0)) & MASK)
            cli.close()
        finally:
            _stop(srvs)
    assert digs[0] == digs[1]


def test_error_feedback_survives_and_drains_at_quiesce():
    results = {}
    for wire in ("fp32", "int8"):
        srvs, eps = _mk_cluster()
        try:
            cli = RpcPsClient(eps)
            comm = SyncCommunicator(cli)
            comm.start()
            cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=11,
                                                   push_wire_dtype=wire))
            keys = np.arange(1, 129, dtype=np.uint64)
            cli.pull_sparse(0, keys)
            rng = np.random.default_rng(1)
            for _ in range(20):
                push = np.zeros((len(keys), 12), np.float32)
                push[:, 1] = 1.0
                push[:, 3:] = rng.normal(0, 0.05, (len(keys), 9)).astype(np.float32)
                comm.send_sparse(0, keys, push)
            if wire == "int8":
                assert cli.push_residual_rows(0) == len(keys)
            comm.quiesce()
            assert cli.push_residual_rows() == 0
            k, v = cli.snapshot_items(0)
            results[wire] = v[np.argsort(k)]
            comm.stop()
            cli.close()
        finally:
            _stop(srvs)
    a, b = results["fp32"], results["int8"]
    # the JAX test's stated tolerance: block int8 with error feedback and
    # the closing drain tracks the fp32 wire to ~1e-3 on these magnitudes
    np.testing.assert_allclose(b[:, 5], a[:, 5], atol=2e-3)
    np.testing.assert_allclose(b[:, 8:17], a[:, 8:17], atol=2e-3)
    assert not np.array_equal(b, a)


def test_merge_dedup_folds_one_residual_per_key():
    srvs, eps = _mk_cluster(1)
    try:
        cli = RpcPsClient(eps)
        cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=2,
                                               push_wire_dtype="int8"))
        keys = np.array([7, 7, 9, 9, 9, 11], np.uint64)
        cli.pull_sparse(0, keys)
        push = np.zeros((len(keys), 12), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = np.random.default_rng(0).normal(0, 0.1, (len(keys), 9)).astype(np.float32)
        cli.push_sparse(0, keys, push)
        assert cli.push_residual_rows(0) == 3
        cli.close()
    finally:
        _stop(srvs)


def test_ef_store_overflow_drains_itself():
    srvs, eps = _mk_cluster(1)
    try:
        cli = RpcPsClient(eps)
        cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=2,
                                               push_wire_dtype="int8"))
        keys = np.arange(1, 65, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        set_flags({"ps_push_ef_max_rows": 16})
        try:
            push = np.zeros((len(keys), 12), np.float32)
            push[:, 1] = 1.0
            push[:, 3:] = 0.01
            cli.push_sparse(0, keys, push)
            assert cli.push_residual_rows(0) == 0
        finally:
            set_flags({"ps_push_ef_max_rows": 1 << 20})
        cli.close()
    finally:
        _stop(srvs)


def test_quantized_frames_replicate_bit_identically():
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4,
                                               accessor_config=_acc(8),
                                               push_wire_dtype="int8"))
        keys = np.arange(1, 201, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        _pushes(cli, 0, keys, 9, steps=4, seed=4)
        assert cli.drain_push_residuals() == len(keys)
        c.drain()
        for shard in range(2):
            dg = c.digests(0, shard)
            assert len(set(dg.values())) == 1, dg


def test_malformed_quantized_frame_rejects_whole():
    srvs, eps = _mk_cluster(1)
    try:
        cli = RpcPsClient(eps)
        cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=2))
        keys = np.arange(1, 9, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        dig0 = cli.digest(0)
        conn = cli._conns[0]
        bad = np.zeros((len(keys), 12), np.float32)
        aux = _PUSH_WIRE_I8 | (128 << _PUSH_WIRE_BLOCK_SHIFT)
        status, _ = conn.call(_PUSH_SPARSE, 0, n=len(keys), aux=aux, payload=(keys, bad))
        assert status == -3
        status, _ = conn.call(_PUSH_SPARSE, 0, n=len(keys), aux=_PUSH_WIRE_I8,
                              payload=(keys, bad))
        assert status == -3
        status, _ = conn.call(_PUSH_SPARSE, 0, n=1 << 31, aux=aux, payload=keys)
        assert status == -3
        assert cli.digest(0) == dig0
        cli.close()
    finally:
        _stop(srvs)


@pytest.mark.parametrize("block", [4, 7, 9, 128])
def test_ragged_block_and_multi_block_rows(block):
    srvs, eps = _mk_cluster(1)
    try:
        cli = RpcPsClient(eps)
        cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=2,
                                               push_wire_dtype="int8", push_wire_block=block,
                                               push_error_feedback=False))
        keys = np.arange(1, 33, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        g = np.random.default_rng(block).normal(0, 0.1, (len(keys), 9)).astype(np.float32)
        push = np.zeros((len(keys), 12), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = g
        cli.push_sparse(0, keys, push)
        blk = min(block, 9)
        q, sc = _quant_push_int8(g, blk)
        deq = _dequant_push_int8(q, sc, blk)
        np.testing.assert_allclose(deq, g, atol=float(np.abs(g).max()) / 254 * 1.01)
        cli.close()
    finally:
        _stop(srvs)


def test_wire_config_is_checked_at_create():
    srvs, eps = _mk_cluster(1)
    try:
        cli = RpcPsClient(eps)
        for bad in (dict(pull_wire_dtype="int8"), dict(push_wire_dtype="bf16"),
                    dict(push_wire_dtype="int8", push_wire_block=0),
                    dict(push_wire_dtype="int8", push_wire_block=1 << 16)):
            with pytest.raises(Exception, match="wire"):
                cli.create_sparse_table(0, TableConfig(accessor_config=_acc(8), **bad))
        cli.close()
    finally:
        _stop(srvs)


# -- across the packages -----------------------------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(17)
    yield "random", rng.normal(0, 0.3, (64, 9)).astype(np.float32), 9
    zeros = rng.normal(0, 1, (16, 20)).astype(np.float32)
    zeros[::2, :8] = 0.0  # all-zero blocks: scale 0, q 0
    yield "zero_blocks", zeros, 8
    big = rng.uniform(-1, 1, (32, 13)).astype(np.float32)
    big[0, 0], big[1, 3], big[2, 12] = 3.0e38, -3.0e38, 1e-38  # finite extremes
    yield "extremes", big, 5
    yield "ragged_tail", rng.normal(0, 1, (33, 65)).astype(np.float32), 128
    yield "ragged_multi", rng.normal(0, 1, (33, 65)).astype(np.float32), 7
    yield "ties", (np.arange(-127, 128, dtype=np.float32) / 2.0).reshape(1, -1)[:, :255], 255


@pytest.mark.parametrize("name,grad,block", list(_quant_inputs()),
                         ids=[n for n, _, _ in _quant_inputs()])
def test_quant_dequant_equal_jax_bitwise(name, grad, block):
    q, sc = _quant_push_int8(grad, block)
    jq, jsc = jax_rpc._quant_push_int8(grad, block)
    assert q.dtype == jq.dtype == np.int8 and sc.dtype == jsc.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    assert sc.tobytes() == jsc.tobytes()
    d = _dequant_push_int8(q, sc, block)
    assert d.tobytes() == jax_rpc._dequant_push_int8(jq, jsc, block).tobytes()
    assert np.isfinite(d).all()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_fp16_pull_is_bitwise_across_packages(server_pkg):
    """Pulls of the same rows over the fp16 wire by a port client and a JAX
    client are bitwise equal, and equal the fp32 pull rounded to half and
    widened (round to nearest even)."""
    srvs, eps = _mk_cluster(2, rpc if server_pkg == "port" else jax_rpc)
    try:
        writer = RpcPsClient(eps)
        writer.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=3))
        rng = np.random.default_rng(5)
        keys = rng.integers(1, 1 << 40, 500).astype(np.uint64)
        writer.pull_sparse(0, keys)
        _pushes(writer, 0, keys, 9, steps=3, seed=6)
        fp32 = writer.pull_sparse(0, keys, create=False)
        tc = RpcPsClient(eps)
        tc.create_sparse_table(0, TableConfig(accessor_config=_acc(8), seed=3,
                                              pull_wire_dtype="fp16"))
        jc = jax_rpc.RpcPsClient(eps)
        jc.create_sparse_table(0, JaxTableConfig(accessor_config=JaxAccessorConfig(
            embedx_dim=8, embedx_threshold=0.0), seed=3, pull_wire_dtype="fp16"))
        t16, j16 = tc.pull_sparse(0, keys, create=False), jc.pull_sparse(0, keys, create=False)
        assert t16.tobytes() == j16.tobytes()
        assert t16.tobytes() == torch.from_numpy(fp32).half().float().numpy().tobytes()
        assert not np.array_equal(t16, fp32)
        for c in (writer, tc, jc):
            c.close()
    finally:
        _stop(srvs)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_int8_push_digests_equal_across_packages(client_pkg):
    """A JAX client's int8 pushes (with error feedback and the closing
    drain) on port servers and a port client's on JAX servers: both equal
    the port-on-port run's digests."""

    def run(client_mod, server_mod, cfg_cls, acc_cls):
        srvs, eps = _mk_cluster(2, server_mod)
        try:
            cli = client_mod.RpcPsClient(eps)
            cli.create_sparse_table(0, cfg_cls(accessor_config=acc_cls(
                embedx_dim=8, embedx_threshold=0.0), seed=4, push_wire_dtype="int8",
                push_wire_block=4))
            keys = np.arange(1, 257, dtype=np.uint64)
            cli.pull_sparse(0, keys)
            _pushes(cli, 0, keys, 9, steps=5, seed=8)
            assert cli.drain_push_residuals() == len(keys)
            out = cli.digest(0)
            cli.close()
            return out
        finally:
            _stop(srvs)

    want = run(rpc, rpc, TableConfig, AccessorConfig)
    if client_pkg == "jax":
        got = run(jax_rpc, rpc, JaxTableConfig, JaxAccessorConfig)
    else:
        got = run(rpc, jax_rpc, TableConfig, AccessorConfig)
    assert got == want
