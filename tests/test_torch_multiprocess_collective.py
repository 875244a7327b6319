"""The port's process-level collective API and its axis-form collectives
over a mesh whose ranks are processes, on the CPU.

One module fixture runs this file as a 2-process gloo job through the
port's own launcher (``paddle_tpu_torch.testing.multiprocess.run_job``:
``launch_local``, a ``file://`` store under ``tmp_path``); each process
writes what it computed to an ``.npz`` and the tests below hold it
against the JAX package (the eager API's values, ``ProcessGroup`` on a
2-device JAX mesh) and against the port's mesh of logical ranks in this
process (every axis-form collective, bitwise: at K = 2 a sum of two
operands commutes, so gloo's sum is the thread mesh's bit for bit).
"""

import os
import sys

import numpy as np
import pytest
import torch

K = 2
N = 6


def _inputs(dtype="float32", seed=3):
    """[K, 4, N] values, block r for rank r (random floats: the sums are
    held bitwise)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, 4, N)).astype(np.float32)
    if dtype == "int8":
        return rng.integers(-100, 100, size=(K, 4, N)).astype(np.int8)
    return x


def _cases():
    """name → (dtype, fn(x, axis)) of one rank's value."""
    from paddle_tpu_torch.ops import collectives as coll

    R = coll.ReduceOp
    return {
        "psum": ("float32", lambda a, ax: coll.psum(a, ax)),
        "psum_bf16": ("bfloat16", lambda a, ax: coll.psum(a, ax)),
        "pmax": ("float32", lambda a, ax: coll.pmax(a, ax)),
        "psum_scatter_0": ("float32", lambda a, ax: coll.psum_scatter(a, ax, 0)),
        "psum_scatter_1": ("float32", lambda a, ax: coll.psum_scatter(a, ax, 1)),
        "all_gather_0": ("float32", lambda a, ax: coll.all_gather(a, ax, 0)),
        "all_gather_1": ("float32", lambda a, ax: coll.all_gather(a, ax, 1)),
        "all_gather_int8": ("int8", lambda a, ax: coll.all_gather(a, ax, 0)),
        "all_to_all_0_1": ("float32", lambda a, ax: coll.all_to_all(a, ax, 0, 1)),
        "all_to_all_1_0": ("float32", lambda a, ax: coll.all_to_all(a, ax, 1, 0)),
        "all_to_all_int8": ("int8", lambda a, ax: coll.all_to_all(a, ax, 0, 0)),
        "shift": ("float32", lambda a, ax: coll.shift(a, ax, 1)),
        "ppermute_partial": ("float32", lambda a, ax: coll.ppermute(a, ax, [(0, 1)])),
        "broadcast_root1": ("float32", lambda a, ax: coll.broadcast(a, ax, root=1)),
        "reduce_root1": ("float32", lambda a, ax: coll.reduce(a, ax, root=1)),
        "reduce_max": ("float32", lambda a, ax: coll.reduce(a, ax, root=0, op=R.MAX)),
        "reduce_min": ("float32", lambda a, ax: coll.reduce(a, ax, root=1, op=R.MIN)),
        "reduce_prod": ("float32", lambda a, ax: coll.reduce(a, ax, root=0, op=R.PROD)),
        "reduce_avg": ("float32", lambda a, ax: coll.reduce(a, ax, root=1, op=R.AVG)),
        "axis_index": ("float32", lambda a, ax: a * 0 + coll.axis_index(ax) * 10
                       + coll.axis_size(ax)),
        "barrier": ("float32", lambda a, ax: (coll.barrier(ax), a.clone())[1]),
    }


def _tensor(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


AXES = ("dp", "mp")
PG_X = np.arange(8, dtype=np.float32)


def _pg_calls(x):
    """ProcessGroup("x")'s methods on this rank's block of PG_X."""
    from paddle_tpu_torch.ops import collectives as coll

    pg = coll.ProcessGroup("x")
    return {"formula": pg.all_reduce(x) + float(pg.rank()),
            "avg": pg.all_reduce(x, coll.ReduceOp.AVG),
            "max": pg.all_reduce(x, coll.ReduceOp.MAX),
            "gather": pg.all_gather(x), "scatter": pg.reduce_scatter(x),
            "a2a": pg.all_to_all(x), "bcast": pg.broadcast(x, root=1),
            "reduce": pg.reduce(x, root=1), "size": x * 0 + pg.size(),
            "barrier": (pg.barrier(), x)[1]}


FLAGS = ("none", "gradient_merge", "dgc", "fp16_allreduce", "localsgd", "lamb")


def _fleet_updates(mesh, flag):
    """3 updates of ``fleet.distributed_optimizer``'s chain for ``flag``
    (with a ``DpGradReducer`` over dp), each held rank with its own
    gradients: the held ranks' params after them."""
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed.comm_fusion import DpGradReducer
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.optimizer import Momentum

    f = tdist.Fleet().init(tdist.UserDefinedRoleMaker())
    strategy = tdist.DistributedStrategy(**({} if flag == "none" else {flag: True}))
    opt = f.distributed_optimizer(Momentum(0.1), strategy,
                                  reducer=DpGradReducer(("dp",), (K,)))
    rng = np.random.default_rng(9)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}

    def grads(r, i):
        g = np.random.default_rng(10 + 7 * r + 100 * i)
        return {k: torch.from_numpy(g.normal(size=v.shape).astype(np.float32))
                for k, v in p0.items()}

    def rank_fn(r):
        p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        st = opt.init(p)
        for i in range(3):
            p, st = opt.update(grads(r, i), st, p)
        return p

    return coll.run_ranks(mesh, rank_fn)


def _worker(out_dir):
    from paddle_tpu_torch.core.mesh import make_process_mesh
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import collectives as coll

    env = C.init_parallel_env()
    rank, world = C.get_rank(), C.get_world_size()
    res = {"rank": np.asarray(rank), "world": np.asarray(world),
           "initialized": np.asarray(C.is_initialized()),
           "env_rank": np.asarray(env.rank), "env_world": np.asarray(env.nranks)}
    # the eager API (numpy in, numpy out)
    res["eager_sum"] = C.all_reduce(np.asarray([1.0 + rank, 10.0]), op="sum")
    vec = np.asarray([1.5 + rank, -2.0 * rank, 3.0], np.float64)
    for op in ("sum", "avg", "max", "min", "prod"):
        res[f"eager_op_{op}"] = C.all_reduce(vec, op=op)
    res["eager_bcast"] = C.broadcast(np.asarray([rank * 7.0]), src=1)
    res["eager_gather"] = np.stack(C.all_gather(np.asarray([float(rank)])))
    C.barrier()
    res["eager_scatter"] = C.scatter([np.full(3, 10.0 * rank + i) for i in range(world)], src=1)
    res["eager_alltoall"] = np.stack(C.alltoall([np.full(2, 10.0 * rank + j)
                                                 for j in range(world)]))
    g = C.new_group([1])
    res["group_sum"] = C.all_reduce(np.asarray([1.0 + rank]), group=g)
    res["group_gather"] = np.stack(C.all_gather(np.asarray([2.0 + rank]), group=g))
    res["group_bcast_own"] = C.broadcast(np.asarray([rank + 0.5]), src=0, group=g)
    res["group_bcast"] = C.broadcast(np.asarray([rank + 0.25]), src=1, group=g)
    got = C.scatter([np.asarray([5.0 + rank])], src=1, group=g)
    res["group_scatter_none"] = np.asarray(got is None)
    res["group_scatter"] = np.asarray([-1.0]) if got is None else got
    res["group_alltoall"] = np.stack(C.alltoall([np.asarray([3.0 + rank])], group=g))
    # ProcessGroup over a process mesh
    m = make_process_mesh({"x": world}, device="cpu")
    blk = torch.from_numpy(PG_X.reshape(world, -1)[rank].copy())
    for k, v in coll.run_ranks(m, lambda r: _pg_calls(blk))[0].items():
        res[f"pg_{k}"] = v.numpy()
    # every axis-form collective over a one-axis process mesh of each name
    for axis in AXES:
        m = make_process_mesh({axis: world}, device="cpu")
        for name, (dtype, fn) in _cases().items():
            x = _tensor(_inputs(dtype)[rank], dtype)
            res[f"{axis}_{name}"] = _as_np(coll.run_ranks(m, lambda r: fn(x, axis))[0])
    m = make_process_mesh({"dp": world}, device="cpu")
    for flag in FLAGS:
        for k, v in _fleet_updates(m, flag)[0].items():
            res[f"fleet_{flag}_{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    print("WORKER_OK", rank, flush=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from paddle_tpu_torch.testing.multiprocess import run_job

    work = tmp_path_factory.mktemp("mp_collective")
    run_job([os.path.abspath(__file__), "--worker", str(work)], K, str(work), timeout=120)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(K)]


def test_init_parallel_env_reads_the_launcher_env(results):
    for r, res in enumerate(results):
        assert int(res["rank"]) == r and int(res["world"]) == K
        assert int(res["env_rank"]) == r and int(res["env_world"]) == K
        assert bool(res["initialized"])


def test_eager_values_match_the_jax_multiprocess_test(results):
    # the values tests/test_multiprocess_collective.py asserts, at world 2
    for res in results:
        assert res["eager_sum"].tolist() == [sum(1.0 + r for r in range(K)), 10.0 * K]
        assert res["eager_bcast"].tolist() == [7.0]
        assert res["eager_gather"].tolist() == [[0.0], [1.0]]


@pytest.mark.parametrize("op", ["sum", "avg", "max", "min", "prod"])
def test_eager_reduce_ops(results, op):
    vecs = np.stack([np.asarray([1.5 + r, -2.0 * r, 3.0]) for r in range(K)])
    want = {"sum": vecs.sum(0), "avg": vecs.mean(0), "max": vecs.max(0), "min": vecs.min(0),
            "prod": vecs.prod(0)}[op]
    for res in results:
        np.testing.assert_array_equal(res[f"eager_op_{op}"], want)


def test_eager_scatter_and_alltoall(results):
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["eager_scatter"], np.full(3, 10.0 * 1 + r))
        np.testing.assert_array_equal(res["eager_alltoall"],
                                      np.stack([np.full(2, 10.0 * s + r) for s in range(K)]))


def test_subgroup_scopes_the_result_not_who_takes_part(results):
    a, b = results           # rank 0 is outside the group [1]
    for res in results:
        assert res["group_sum"].tolist() == [2.0]
        assert res["group_gather"].tolist() == [[3.0]]
    assert a["group_bcast_own"].tolist() == [0.5] and b["group_bcast_own"].tolist() == [1.5]
    # JAX's rule: a source inside the group reaches every caller (the
    # group scopes which source counts); one outside leaves each its own
    assert a["group_bcast"].tolist() == [1.25] and b["group_bcast"].tolist() == [1.25]
    assert bool(a["group_scatter_none"]) and not bool(b["group_scatter_none"])
    assert b["group_scatter"].tolist() == [6.0]
    assert a["group_alltoall"].tolist() == [[3.0]] and b["group_alltoall"].tolist() == [[4.0]]


def test_process_group_matches_jax(results):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.core.mesh import make_mesh as jax_make_mesh
    from paddle_tpu.ops import collectives as jcoll

    jm = jax_make_mesh({"x": K}, devices=jax.devices()[:K])
    pg = jcoll.ProcessGroup("x")
    f = jax.jit(shard_map(lambda x: pg.all_reduce(x) + pg.rank().astype(jnp.float32), mesh=jm,
                          in_specs=P("x"), out_specs=P("x")))
    want = np.asarray(f(jnp.asarray(PG_X))).reshape(K, -1)
    blocks = PG_X.reshape(K, -1)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["pg_formula"], want[r])
        np.testing.assert_array_equal(res["pg_avg"], blocks.sum(0) / K)
        np.testing.assert_array_equal(res["pg_max"], blocks.max(0))
        np.testing.assert_array_equal(res["pg_gather"], PG_X)
        np.testing.assert_array_equal(res["pg_scatter"], blocks.sum(0).reshape(K, -1)[r])
        np.testing.assert_array_equal(
            res["pg_a2a"], np.concatenate([blocks[s].reshape(K, -1)[r] for s in range(K)]))
        np.testing.assert_array_equal(res["pg_bcast"], blocks[1])
        np.testing.assert_array_equal(res["pg_reduce"],
                                      blocks.sum(0) if r == 1 else np.zeros_like(blocks[0]))
        np.testing.assert_array_equal(res["pg_size"], np.full_like(blocks[0], K))
        np.testing.assert_array_equal(res["pg_barrier"], blocks[r])


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", sorted(_cases()))
def test_axis_collective_over_processes_equals_the_thread_mesh(results, axis, name):
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.ops import collectives as coll

    dtype, fn = _cases()[name]
    x = _inputs(dtype)
    m = make_mesh({axis: K}, device="cpu")
    want = coll.run_ranks(m, lambda r: fn(_tensor(x[r], dtype), axis))
    for r, res in enumerate(results):
        got, w = res[f"{axis}_{name}"], _as_np(want[r])
        assert got.dtype == w.dtype and got.shape == w.shape, (got.dtype, got.shape, w.shape)
        np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8))


@pytest.mark.parametrize("flag", FLAGS)
def test_fleet_reducer_chain_over_processes_equals_the_thread_mesh(results, flag):
    from paddle_tpu_torch.core.mesh import make_mesh

    want = _fleet_updates(make_mesh({"dp": K}, device="cpu"), flag)
    for r, res in enumerate(results):
        for k, v in want[r].items():
            np.testing.assert_array_equal(res[f"fleet_{flag}_{k}"], v.numpy(), err_msg=k)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
