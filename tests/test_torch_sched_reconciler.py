"""The explorer's reconciler miniature
(``paddle_tpu_torch.testing.models.reconciler_model``: proposers × two
actuator passes × a lease-expiry failover, under ``ps/reconcile.py``'s and
``ps/spec.py``'s lock names) against the JAX repo's, on the CPU: the
reconciler cases of ``tests/test_sched.py``, compared as in
``tests/test_torch_sched.py`` (failures, shrunk schedules, sweep sizes,
exhaustion, observed lock edges, seeded decision logs).

Tolerance: exact.
"""

from test_torch_sched import both, dfs, failure, replay, walk


def _reconciler_unserialized(p):
    ex, rec = dfs(p, p.models.reconciler_model(serialized=False, with_np_proposer=False), 2,
                  max_schedules=20000)
    f = ex.explore_dfs(bound=2, max_schedules=20000)[0]
    rec["small"] = failure(ex.shrink(f))
    return rec


def test_reconciler_unserialized_actuation_found():
    got = both(_reconciler_unserialized)
    assert got["failure"]["kind"] == "invariant"
    assert "stale transition" in got["failure"]["message"]
    assert got["small"]["kind"] == "invariant"


def _reconciler_pb2(p):
    return dfs(p, p.models.reconciler_model(with_np_proposer=False), 2, max_schedules=50000)[1]


def test_reconciler_fixed_protocol_pb2_exhausts_clean():
    got = both(_reconciler_pb2)
    assert got["failure"] is None and got["exhausted"] and got["schedules"] > 1000


def _reconciler_walk(p):
    ex, rec = walk(p, p.models.reconciler_model(), 400, 20260807)
    rec["traces"] = [replay(ex, seed=s)["log"] for s in (1, 2, 3)]
    return rec


def test_reconciler_random_walk_two_proposers_clean():
    got = both(_reconciler_walk)
    assert got["failure"] is None and got["schedules"] == 400
