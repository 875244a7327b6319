"""The serving fleet and phase 19 of ``chip_smoke.py`` on the card (``cuda``;
skipped without one).

- A two-member fleet: each member's read-only tier lives on the card
  behind a ``CachedLookup``; the router serves raw rows that equal the
  primary's bit for bit (the tier's gather moves f32 rows, no arithmetic),
  a warm join through the handoff misses nothing on the working set, and a
  rollout's sink puts each version on the card, where a rollback restores
  v1 crc32c-identical.
- Phase 19 small (1,024 lines, batch 128, a tier of 2^14 rows, short arms),
  on the card and on the CPU: each holds leg A bitwise against its own
  oracle and leg B's checks; across the two, leg A's table size equals and
  its per-step losses agree at rtol 1e-5 and its rows at rtol 1e-4 / atol
  1e-5 (``tests/test_torch_reshard_cuda.py``'s).

Run on a card: ``python -m pytest -q -p no:cacheprovider --noconftest -m cuda
tests/test_torch_serving_fleet_cuda.py``.
"""

import os
import random
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the members' tiers live on the card")
    return torch.device("cuda")


def test_two_member_fleet_on_the_card(card):
    from paddle_tpu_torch.io.fs import crc32c
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.ha import HACluster
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import TableConfig
    from paddle_tpu_torch.serving import (CachedLookup, DenseModel, FleetConfig, FleetMember,
                                          FrontendConfig, RolloutManager, RouterConfig,
                                          ServingFleet, ServingFrontend, ServingReplica,
                                          ServingRouter)

    cfg = TableConfig(shard_num=4, accessor_config=AccessorConfig(
        embedx_dim=8, embedx_threshold=0.0, sgd=SGDRuleConfig(initial_range=0.01)))
    keys = np.arange(4096, dtype=np.uint64)
    flat1 = np.arange(32, dtype=np.float32)
    with HACluster(num_shards=1, replication=1, sync=True) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, cfg)
        cli.pull_sparse(0, keys)
        push = np.zeros((len(keys), cli._dims(0)[1]), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = np.random.default_rng(0).normal(0, 0.1, (len(keys), push.shape[1] - 3))
        cli.push_sparse(0, keys, push)

        def build():
            rep = ServingReplica(cluster.store, cluster.job_id, shard=0, hb_interval=0.05,
                                 hb_ttl=0.4)
            serve = rep.client()
            view = rep.serve_view(0, cfg, client=serve)
            prim = cluster.primary(0).endpoint
            deadline = time.monotonic() + 30
            while cluster.digests(0, 0).get(prim) != serve.digest(0)[0]:
                assert time.monotonic() < deadline, "a replica never caught up"
                time.sleep(0.01)
            tier = HotEmbeddingTier(view, HotTierConfig(capacity=1 << 14, create_on_miss=False),
                                    device=card)
            live = {}
            model = DenseModel(lambda f: torch.from_numpy(f), flat1,
                               sink=lambda t: live.__setitem__("p", t.to(card)))
            fe = ServingFrontend(CachedLookup(tier, replica=rep, freshness_budget_s=30.0),
                                 config=FrontendConfig(max_batch=16, max_delay_us=200),
                                 replica_label=rep.endpoint)
            m = FleetMember(rep, fe.lookup, fe, model=model)
            m.live = live
            return m

        router = ServingRouter(RouterConfig(), rng=random.Random(0))
        fleet = ServingFleet(cluster.store, cluster.job_id, build, router,
                             config=FleetConfig(poll_s=0.05))
        try:
            (seed,) = fleet.add(1, warm=False)
            assert seed.lookup.tier.device.type == card.type
            for lo in range(0, len(keys), 512):
                seed.lookup.lookup(keys[lo:lo + 512])
            (joiner,) = fleet.add(1, warm=True)
            m0 = joiner.lookup.tier.counters["misses"]
            want = cli.pull_sparse(0, keys, create=False)[:, 2:]
            for lo in range(0, len(keys), 8):
                got = router.submit(keys[lo:lo + 8], deadline_ms=5000).result(10)
                np.testing.assert_array_equal(got.reshape(8, -1), want[lo:lo + 8])
            assert joiner.lookup.tier.counters["misses"] == m0
            assert router.stats()["errors"] == 0 and len(router.endpoints()) == 2
            mgr = RolloutManager(lambda: fleet.members(), router)
            v1 = mgr.register_baseline(flat1)
            mgr.begin_canary(flat1 + 1.0, fraction=0.5)
            mgr.promote()
            assert all(torch.equal(m.live["p"].cpu(), torch.from_numpy(flat1 + 1.0))
                       for m in fleet.members())
            mgr.rollback()
            dg1 = crc32c(flat1.tobytes())
            assert set(mgr.fleet_versions().values()) == {(v1, dg1)}
            assert all(m.live["p"].device.type == card.type
                       and torch.equal(m.live["p"].cpu(), torch.from_numpy(flat1))
                       for m in fleet.members())
        finally:
            fleet.stop()
            router.stop()


@pytest.fixture
def chip_smoke(monkeypatch, card):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    # 8 steps an epoch: the densify arms from 4 samples inside epoch 1
    for name, v in (("HA_LINES", 1024), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14), ("FLEET_CAP", 1 << 14), ("FLEET_REF", 100),
                    ("FLEET_STEADY", 200), ("FLEET_CHAOS", 150), ("FLEET_CHUNK", 60),
                    ("FLEET_CHECKED", 64)):
        monkeypatch.setattr(cs, name, v)
    return cs


def test_phase19_small_on_the_card_and_the_cpu(chip_smoke):
    cs = chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    a_card, b_card = cs.phase_obs_fleet(torch.device("cuda"), "cuda")
    a_cpu, _ = cs.phase_obs_fleet(torch.device("cpu"), "cpu")
    assert [e["to"] for e in a_card["events"]] == ["collective", "ps"]
    assert a_card["size"] == a_cpu["size"]
    np.testing.assert_allclose(a_card["losses"], a_cpu["losses"], rtol=1e-5)
    np.testing.assert_allclose(a_card["pulled"], a_cpu["pulled"], rtol=1e-4, atol=1e-5)
    assert b_card["warm_curve"][-1] < b_card["cold_curve"][-1] and b_card["rollback_ok"]
