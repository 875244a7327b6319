"""The sharded parameter-server paths over a mesh whose ranks are
processes, on the CPU: each process holds its own ``C/K``-row block.

One module fixture runs this file as a 2-process gloo job through the
port's own launcher (``paddle_tpu_torch.testing.multiprocess.run_job``);
each process builds the same host-side state from the same seeds (the
JAX multi-process test's "identical host-side state on every rank"),
keeps its own row block, and writes what it computed to an ``.npz``.
The tests hold that against:

- JAX's ``shard_map`` on 2 CPU devices for routed and gathered pull and
  push, bitwise (compiled with the algebraic simplifier off, as in
  ``test_torch_sharded_cache.py``);
- the port's mesh of logical ranks in this process, bitwise: the pull and
  push, and 3 steps of the sharded hot step and the sharded CTR step (at
  K = 2 gloo's sum of two operands is the thread mesh's bit for bit);
- ``select_routing`` of the JAX package with ``jax.process_count``
  patched to 2.
"""

import os
import sys

import numpy as np
import pytest
import torch

K = 2
C, DIM, N = 1 << 9, 4, 128              # pull/push: capacity, dim, rows a call (all ranks)
MODES = {"routed-dedup": (True, True), "routed-raw": (True, False), "gathered": (False, True)}
S, D, B = 3, 2, 32                      # the steps: slots, dense, batch (all ranks)
STEP_C = 1 << 8
STEPS = 3
ROUTINGS = ("alltoall", "allgather")


def _state_np(capacity, dim, rng):
    f = np.float32
    return {"show": rng.uniform(0, 5, capacity).astype(f),
            "click": rng.uniform(0, 2, capacity).astype(f),
            "embed_w": rng.normal(size=(capacity, 1)).astype(f),
            "embed_state": rng.uniform(0, 1, (capacity, 1)).astype(f),
            "embedx_w": rng.normal(size=(capacity, dim)).astype(f),
            "embedx_state": rng.uniform(0, 1, (capacity, 1)).astype(f),
            "has_embedx": (rng.random(capacity) < 0.5).astype(f)}


def _batch(rng, capacity, n, dim):
    """Rows with cross-rank duplicates, miss markers and sentinels."""
    rows = rng.integers(0, capacity, n).astype(np.int32)
    rows[:n // 8] = rows[n // 8:n // 4]
    rows[::5] = -1
    rows[3::11] = capacity
    rng.shuffle(rows)
    return (rows, rng.normal(size=(n, 1 + dim)).astype(np.float32),
            np.ones(n, np.float32), (rng.random(n) < 0.4).astype(np.float32))


def _pull_push_inputs(mode):
    rng = np.random.default_rng(40 + list(MODES).index(mode))
    state = _state_np(C, DIM, rng)
    return state, [_batch(rng, C, N, DIM) for _ in range(3)]


def _cfg():
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig

    return CacheConfig(capacity=C, embedx_dim=DIM, embedx_threshold=2.0)


def _block(state, r, K_):
    """Rank r's row block of a whole numpy state (``convert``'s rank-local
    form, as a process takes its part of a JAX state)."""
    from paddle_tpu_torch.convert import cache_state_from_jax

    return cache_state_from_jax(state, "cpu", rank=r, shards=K_)


def _step_setup():
    """The steps' model weights, tier/cache state, key map and batches,
    the same in every process (seeds)."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.ps.device_hash import (DeviceKeyMap, DynamicDeviceKeyMap,
                                                 map_state_to_device)

    model = DeepFM(CtrConfig(S, D, DIM, (8,)), generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(50)
    pool = (rng.integers(0, 1 << 20, size=(40, S)).astype(np.uint64)
            + (np.arange(S, dtype=np.uint64) << np.uint64(32)))
    keys = np.unique(pool.reshape(-1))
    m = DynamicDeviceKeyMap(STEP_C, device="cpu", banks=K)
    bank = m.bank_of(keys).astype(np.int64)
    counts = np.bincount(bank, minlength=K)
    order = np.argsort(bank, kind="stable")
    pos = np.empty(len(keys), np.int64)
    pos[order] = np.arange(len(keys)) - np.repeat(np.cumsum(counts) - counts, counts)
    rows = (bank * (STEP_C // K) + pos).astype(np.int32)
    m.insert(keys, rows)
    maps = {"hot": m.device_state(),
            "ctr": map_state_to_device(DeviceKeyMap.build_host(keys, rows), torch.device("cpu"))}
    state = _state_np(STEP_C, DIM, rng)
    idx = rng.integers(0, len(pool), size=(STEPS, B))
    lo = [torch.from_numpy((pool[i] & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))
          for i in idx]
    dense = [torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)) for _ in range(STEPS)]
    labels = [torch.from_numpy((rng.random(B) < 0.4).astype(np.int32)) for _ in range(STEPS)]
    return model, maps, state, lo, dense, labels


def _run_steps(kind, routing, mesh, state):
    """STEPS steps of the sharded hot step or the sharded CTR step from
    keys over ``mesh`` on ``state`` (the whole state, or a process's
    block): (losses, params, state)."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.hot_tier import make_sharded_hot_train_step
    from paddle_tpu_torch.ps.sharded_cache import (check_route_overflow,
                                                   make_sharded_ctr_train_step_from_keys)

    model, maps, _, lo, dense, labels = _step_setup()
    cfg = CacheConfig(capacity=STEP_C, embedx_dim=DIM, embedx_threshold=0.0)
    opt = Adam(learning_rate=1e-2)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt_state = opt.init(params)
    if kind == "hot":
        step = make_sharded_hot_train_step(model, opt, cfg, mesh, np.arange(S), routing=routing,
                                           banks=K)
    else:
        step = make_sharded_ctr_train_step_from_keys(model, opt, cfg, mesh, np.arange(S),
                                                     routing=routing)
    losses = []
    for t in range(STEPS):
        params, opt_state, state, loss, ov = step(params, opt_state, state, maps[kind], lo[t],
                                                  dense[t], labels[t])
        check_route_overflow(ov)
        losses.append(loss.reshape(1))
    return torch.cat(losses), params, state


def _worker(out_dir):
    from paddle_tpu_torch.core.mesh import make_process_mesh
    from paddle_tpu_torch.distributed import collective as C_
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.ps import sharded_cache as tsc

    C_.init_parallel_env()
    rank = C_.get_rank()
    mesh = make_process_mesh({"ps": K}, device="cpu")
    res = {"process_mesh_device": np.asarray(str(mesh.device))}
    cfg = _cfg()
    for mode, (routed, pre_dedup) in MODES.items():
        state, batches = _pull_push_inputs(mode)
        block = _block(state, rank, K)
        res[f"{mode}_block_rows"] = np.asarray(block["embed_w"].shape[0])
        for it, (rows, grads, shows, clicks) in enumerate(batches):
            mine = [torch.from_numpy(a.reshape(K, -1, *a.shape[1:])[rank].copy())
                    for a in (rows, grads, shows, clicks)]

            def rank_fn(r):
                if routed:
                    vals, ov1 = tsc.routed_cache_pull(block, mine[0], 2.0, pre_dedup, axis="ps")
                    ov2 = tsc.routed_cache_push(block, *mine, cfg, 2.0, pre_dedup, axis="ps")
                    return vals, int(ov1) + int(ov2)
                vals = tsc.sharded_cache_pull(block, mine[0], axis="ps")
                tsc.sharded_cache_push(block, *mine, cfg, axis="ps")
                return vals, 0

            vals, ov = coll.run_ranks(mesh, rank_fn)[0]
            res[f"{mode}_pull{it}"] = vals.numpy()
            res[f"{mode}_overflow{it}"] = np.asarray(ov)
        for k, v in block.items():
            res[f"{mode}_state_{k}"] = v.numpy()
    for kind in ("hot", "ctr"):
        for routing in ROUTINGS:
            _, _, state, *_ = _step_setup()
            losses, params, block = _run_steps(kind, routing, mesh, _block(state, rank, K))
            res[f"{kind}_{routing}_losses"] = losses.numpy()
            for k, v in params.items():
                res[f"{kind}_{routing}_param_{k}"] = v.numpy()
            for k, v in block.items():
                res[f"{kind}_{routing}_state_{k}"] = v.numpy()
    for mode in ("dense", "sparse"):
        for k in (2, 4):
            res[f"routing_{mode}_{k}"] = np.asarray(tsc.select_routing(1024, 1 << 14, k, mode))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    print("WORKER_OK", rank, flush=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from paddle_tpu_torch.testing.multiprocess import run_job

    work = tmp_path_factory.mktemp("mp_sharded")
    run_job([os.path.abspath(__file__), "--worker", str(work)], K, str(work), timeout=120)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(K)]


def _thread_pull_push(mode):
    """The same calls on the port's mesh of logical ranks: (pulls, state)."""
    from paddle_tpu_torch.ps import sharded_cache as tsc

    routed, pre_dedup = MODES[mode]
    state, batches = _pull_push_inputs(mode)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    shards, cfg, pulls = tsc.shard_state(tstate, K), _cfg(), []
    for rows, grads, shows, clicks in batches:
        split = lambda a: list(torch.from_numpy(a).chunk(K))
        if routed:
            vals, _ = tsc.routed_cache_pull(shards, split(rows), 2.0, pre_dedup)
            tsc.routed_cache_push(shards, split(rows), split(grads), split(shows),
                                  split(clicks), cfg, 2.0, pre_dedup)
        else:
            vals = tsc.sharded_cache_pull(shards, split(rows))
            tsc.sharded_cache_push(shards, split(rows), split(grads), split(shows),
                                   split(clicks), cfg)
        pulls.append(torch.cat(vals).numpy())
    return pulls, {k: v.numpy() for k, v in tstate.items()}


def _joined(results, key, cols):
    return {k: np.concatenate([res[f"{key}_{k}"] for res in results]) for k in cols}


def test_each_process_holds_its_row_block(results):
    for res in results:
        assert str(res["process_mesh_device"]) == "cpu"
        for mode in MODES:
            assert int(res[f"{mode}_block_rows"]) == C // K


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pull_push_over_processes_equals_jax(results, mode):
    import jax.numpy as jnp

    from paddle_tpu.ps import embedding_cache as jec
    from test_torch_sharded_cache import _jax_fns

    routed, pre_dedup = MODES[mode]
    state, batches = _pull_push_inputs(mode)
    pull, push, put = _jax_fns(K, jec.CacheConfig(capacity=C, embedx_dim=DIM,
                                                  embedx_threshold=2.0), routed,
                               pre_dedup=pre_dedup)
    jstate = put(state)
    for it, (rows, grads, shows, clicks) in enumerate(batches):
        jvals = pull(jstate, jnp.asarray(rows))
        out = push(jstate, *(jnp.asarray(a) for a in (rows, grads, shows, clicks)))
        jvals, jstate = (jvals[0], out[0]) if routed else (jvals, out)
        got = np.concatenate([res[f"{mode}_pull{it}"] for res in results])
        np.testing.assert_array_equal(got, np.asarray(jvals), err_msg=f"pull {it}")
        assert all(int(res[f"{mode}_overflow{it}"]) == 0 for res in results)
    got = _joined(results, f"{mode}_state", state)
    for k in state:
        np.testing.assert_array_equal(got[k], np.asarray(jstate[k]), err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pull_push_over_processes_equals_the_thread_mesh(results, mode):
    pulls, want = _thread_pull_push(mode)
    for it, p in enumerate(pulls):
        np.testing.assert_array_equal(
            np.concatenate([res[f"{mode}_pull{it}"] for res in results]), p)
    got = _joined(results, f"{mode}_state", want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("kind", ["hot", "ctr"])
def test_sharded_steps_over_processes_equal_the_thread_mesh(results, kind, routing):
    from paddle_tpu_torch.core.mesh import make_mesh

    _, _, state, *_ = _step_setup()
    whole = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    losses, params, tstate = _run_steps(kind, routing, make_mesh({"ps": K}, device="cpu"),
                                        whole)
    for res in results:
        np.testing.assert_array_equal(res[f"{kind}_{routing}_losses"], losses.numpy())
        for k, v in params.items():
            np.testing.assert_array_equal(res[f"{kind}_{routing}_param_{k}"], v.numpy(),
                                          err_msg=k)
    got = _joined(results, f"{kind}_{routing}_state", tstate)
    for k, v in tstate.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert not np.array_equal(got["embedx_w"], state["embedx_w"])


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_select_routing_on_a_multiprocess_world_matches_jax(results, mode, monkeypatch):
    import jax

    from paddle_tpu.ps import sharded_cache as jsc

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for k in (2, 4):
        want = jsc.select_routing(1024, 1 << 14, k, mode)
        for res in results:
            assert tuple(res[f"routing_{mode}_{k}"].tolist()) == want, (mode, k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
