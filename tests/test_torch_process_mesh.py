"""The process mesh's and the process-level API's own checks, in this
process (no spawn): a ``torch.distributed`` job of one on gloo, joined
through ``init_parallel_env`` with a ``file://`` store and left again
after each test."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import (InvalidArgumentError, PreconditionNotMetError,
                                           UnavailableError)
from paddle_tpu_torch.core.mesh import make_mesh, make_process_mesh
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.ops import transport


@pytest.fixture
def job_of_one(tmp_path, monkeypatch):
    import torch.distributed as dist

    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "RANK", "WORLD_SIZE",
              "PADDLE_MASTER", "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(C, "_parallel_state", {"initialized": False, "env": None})
    env = C.init_parallel_env(f"file://{tmp_path / 'store'}", backend="gloo")
    try:
        yield env
    finally:
        dist.destroy_process_group()


def test_a_job_of_one_joins_when_given_an_address(job_of_one):
    import torch.distributed as dist

    assert C.is_initialized() and dist.is_initialized() and dist.get_backend() == "gloo"
    assert (C.get_rank(), C.get_world_size()) == (0, 1)
    assert C.init_parallel_env() is job_of_one      # a second call returns the first's


def test_process_mesh_size_must_equal_the_world(job_of_one):
    with pytest.raises(InvalidArgumentError, match="hold 2 ranks, the job has 1"):
        make_process_mesh({"dp": 2}, device="cpu")
    m = make_process_mesh({"dp": 1, "mp": 1}, device="cpu")
    assert m.is_process_mesh and m.process_rank == 0 and m.local_ranks == (0,)
    assert m.device == torch.device("cpu") and m.shape == {"dp": 1, "mp": 1}


def test_process_mesh_without_a_gpu_and_without_device_raises(job_of_one, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="device='cpu'"):
        make_process_mesh({"dp": 1})


def test_process_mesh_needs_a_job(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(PreconditionNotMetError, match="init_parallel_env"):
        make_process_mesh({"dp": 1}, device="cpu")


@pytest.mark.parametrize("cards,ranks", [(0, 2), (1, 4), (2, 4)])
def test_nccl_with_fewer_cards_than_ranks_raises(monkeypatch, cards, ranks):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(InvalidArgumentError, match=f"{ranks} ranks on this host, {cards} card"):
        C.choose_backend("nccl", ranks)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert C.choose_backend(None, 4) == "gloo" and C.choose_backend("gloo", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert C.choose_backend(None, 4) == "nccl" and C.choose_backend("gloo", 4) == "gloo"
    with pytest.raises(InvalidArgumentError, match="'nccl' or 'gloo'"):
        C.choose_backend("mpi", 1)


def test_collectives_on_a_world_of_one_equal_their_definitions(job_of_one):
    """Every mapping runs on the real communicator (the world group) and
    gives what the thread mesh gives one rank."""
    pm = make_process_mesh({"dp": 1}, device="cpu")
    tm = make_mesh({"dp": 1}, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32))

    def fn(r):
        return [coll.psum(x, "dp"), coll.pmax(x, "dp"), coll.psum_scatter(x, "dp", 1),
                coll.all_gather(x, "dp", 1), coll.all_to_all(x, "dp", 0, 1),
                coll.shift(x, "dp", 1), coll.broadcast(x, "dp"), coll.reduce(x, "dp"),
                coll.ProcessGroup("dp").all_reduce(x, coll.ReduceOp.AVG),
                (coll.barrier("dp"), x)[1]]

    for got, want in zip(coll.run_ranks(pm, fn)[0], coll.run_ranks(tm, fn)[0]):
        assert torch.equal(got, want)


def test_gloo_stages_cuda_tensors_only(job_of_one):
    g = make_process_mesh({"dp": 1}, device="cpu").group(("dp",))
    before = (transport.stage_through_host.bytes, transport.stage_through_host.calls)
    transport.all_reduce(g, torch.ones(8))
    assert (transport.stage_through_host.bytes, transport.stage_through_host.calls) == before


def test_cache_state_from_jax_takes_a_row_block():
    from paddle_tpu_torch.convert import cache_state_from_jax

    rng = np.random.default_rng(0)
    state = {"show": rng.random(8).astype(np.float32),
             "embedx_w": rng.normal(size=(8, 3)).astype(np.float32)}
    whole = cache_state_from_jax(state, "cpu")
    for r in range(4):
        part = cache_state_from_jax(state, "cpu", rank=r, shards=4)
        for k in state:
            assert torch.equal(part[k], whole[k][2 * r:2 * r + 2])
    with pytest.raises(InvalidArgumentError, match="do not cut into 3 blocks"):
        cache_state_from_jax(state, "cpu", rank=0, shards=3)


def test_launch_local_ends_the_job_at_the_first_failing_trainer(tmp_path):
    """A trainer that exits non-zero ends the job at once: the others, which
    would wait on it in a collective, are terminated, and its code returns."""
    import time

    from paddle_tpu_torch.testing.multiprocess import run_job

    script = tmp_path / "job.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
                      "    sys.exit(3)\n"
                      "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="exit code 3"):
        run_job([str(script)], 2, str(tmp_path / "work"), timeout=60)
    assert time.monotonic() - t0 < 30
