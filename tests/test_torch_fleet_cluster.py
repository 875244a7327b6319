"""A PaddleRec-style job of the port in real processes, on the CPU.

``python -m paddle_tpu_torch.distributed.launch --servers 2
--nproc_per_node 2`` starts 2 server and 2 trainer processes of one job
script, wired only by the env the launcher sets (the
``tests/test_ps_rpc.py`` cluster pattern): ``fleet.init()`` picks the rpc
transport from the role env, the servers ``init_server``/``run_server``,
the trainers ``init_worker`` and
- push to a table on both servers and read both pushes back after the
  PS barrier;
- ``fleet.util.all_reduce`` (sum and max) across the two processes;
- load their ``get_file_shard`` of the part files with one reader thread,
  ``global_shuffle(util=fleet.util)`` through the store, and save the
  result as a SlotRecord file: each worker's records are bitwise those of
  an in-process oracle (the same datasets shuffled through an in-process
  exchange), and no record is lost or doubled;
- train ``CtrStreamTrainer(communicator=fleet.communicator)`` on
  ``device="cpu"`` for one pass, stop the worker, pass the closing
  barrier; trainer 0 checks that the servers hold the data's distinct
  keys and stops them.
A trainer that exits non-zero makes the launcher return its code.

Every launcher run has a 120 s ``communicate`` timeout. Tolerance: exact
(counts, records, reductions of small integers).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from test_torch_data_feed import _Exchange, _assert_batches_equal, _all, _records

from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
try:
    import chip_smoke  # ps_job_ports: the launcher's and the store's free ports
finally:
    sys.path.remove(ROOT)
S, D, N_FILES, LINES = 3, 2, 5, 120

_JOB = textwrap.dedent('''
    import json, sys
    import numpy as np
    from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.table import TableConfig

    out_dir, files = sys.argv[1], sys.argv[2:]
    fleet.init(strategy=DistributedStrategy(a_sync=True))
    assert fleet.transport == "rpc", fleet.transport
    if fleet.is_server():
        fleet.init_server()
        fleet.run_server()
        sys.exit(0)
    fleet.init_worker()
    rank = fleet.worker_index()
    fleet.register_sparse_table(0, TableConfig(table_id=0, shard_num=4))
    fleet.register_sparse_table(1, TableConfig(table_id=1, shard_num=4))
    keys = np.arange(1, 51, dtype=np.uint64)
    push = np.zeros((50, 12), np.float32)
    push[:, 1] = 1.0
    fleet.client.push_sparse(1, keys, push)
    fleet.client.barrier()
    shows = fleet.client.pull_sparse(1, keys, create=False)[:, 0]
    summed = fleet.util.all_reduce(np.arange(4, dtype=np.float32) * (rank + 1), "sum")
    top = fleet.util.all_reduce(np.asarray([rank], np.int64), "max")
    slots = ([SlotDesc(f"s{i}") for i in range(__S__)]
             + [SlotDesc(f"d{i}", is_float=True) for i in range(__D__)]
             + [SlotDesc("label", is_float=True)])
    ds = InMemoryDataset(slots, seed=10 + rank)
    ds.set_filelist(fleet.util.get_file_shard(files))
    loaded = ds.load_into_memory(num_threads=1)
    ds.global_shuffle(util=fleet.util)
    ds.save_slot_record(f"{out_dir}/worker{rank}.ptsr")
    names = dict(sparse_slots=[f"s{i}" for i in range(__S__)],
                 dense_slots=[f"d{i}" for i in range(__D__)], label_slot="label")
    trainer = CtrStreamTrainer(DeepFM(CtrConfig(__S__, __D__, 8, (8,))), Adam(1e-2), None,
                               communicator=fleet.communicator, table_id=0, embedx_dim=8,
                               device="cpu", **names)
    res = trainer.train_from_dataset(ds, batch_size=32, drop_last=False)
    fleet.stop_worker()
    fleet.client.barrier()  # closing barrier: every push has landed
    size = fleet.client.size(0)
    fleet.client.barrier()  # nobody stops the servers under a reader
    if rank == 0:
        fleet.client.stop_servers()
    fleet.client.close()
    json.dump({"shows": shows.tolist(), "sum": summed.tolist(), "max": top.tolist(),
               "loaded": loaded, "records": ds.num_records, "loss": res["loss"],
               "steps": res["steps"], "size": size}, open(f"{out_dir}/worker{rank}.json", "w"))
''').replace("__S__", str(S)).replace("__D__", str(D))


def _slots():
    return ([SlotDesc(f"s{i}") for i in range(S)]
            + [SlotDesc(f"d{i}", is_float=True) for i in range(D)]
            + [SlotDesc("label", is_float=True)])


def _launch(args, env=None, timeout=120):
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, **(env or {})))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"the launcher ran past {timeout} s:\n{out}")
    return proc.returncode, out


def _logs(log_dir):
    return "\n".join(f"== {n}\n{open(os.path.join(log_dir, n)).read()[-3000:]}"
                     for n in sorted(os.listdir(log_dir)))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One run of the job: (part files, the out dir, each trainer's readings)."""
    d = tmp_path_factory.mktemp("job")
    rng = np.random.default_rng(3)
    files = []
    for f in range(N_FILES):
        ids = rng.integers(0, 40, (LINES, S))
        dense = rng.normal(size=(LINES, D))
        path = d / f"part-{f:05d}"
        path.write_text("".join(
            " ".join([f"1 {v}" for v in ids[i]] + [f"1 {v:.4f}" for v in dense[i]]
                     + [f"1 {int(dense[i, 0] > 0)}"]) + "\n" for i in range(LINES)))
        files.append(str(path))
    script = d / "job.py"
    script.write_text(_JOB)
    log_dir = str(d / "logs")
    master_port, store_port = chip_smoke.ps_job_ports(2, 2)
    rc, out = _launch(["--servers", "2", "--nproc_per_node", "2", "--master_port",
                       str(master_port), "--log_dir", log_dir, str(script), str(d), *files],
                      env={"PADDLE_UTIL_STORE_PORT": str(store_port), "OMP_NUM_THREADS": "1",
                           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert rc == 0, f"{out}\n{_logs(log_dir)}"
    readings = [json.load(open(d / f"worker{r}.json")) for r in range(2)]
    return files, d, readings


def test_launch_wires_servers_and_trainers_from_the_env(job):
    _, _, readings = job
    for r in readings:
        assert r["shows"] == [2.0] * 50  # both trainers' pushes, on both servers


def test_fleet_util_all_reduce_across_processes(job):
    _, _, readings = job
    for r in readings:
        assert r["sum"] == [0.0, 3.0, 6.0, 9.0] and r["max"] == [1]


def test_global_shuffle_across_processes_matches_the_oracle(job):
    files, d, readings = job
    oracle = []
    for rank in range(2):
        ds = InMemoryDataset(_slots(), seed=10 + rank)
        ds.set_filelist(files[rank::2])
        ds.load_into_memory(num_threads=1)
        oracle.append(ds)
    ex = _Exchange(2)
    threads = [threading.Thread(target=oracle[r].global_shuffle, args=(ex.fn(r), r, 2))
               for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    got = []
    for rank in range(2):
        ds = InMemoryDataset(_slots())
        ds.load_slot_record(str(d / f"worker{rank}.ptsr"))
        _assert_batches_equal(_all(ds), _all(oracle[rank]))
        assert readings[rank]["records"] == ds.num_records
        got.append(ds)
    assert sum(r["loaded"] for r in readings) == sum(g.num_records for g in got) \
        == N_FILES * LINES
    whole = InMemoryDataset(_slots())
    whole.set_filelist(files)
    whole.load_into_memory(num_threads=1)
    assert sorted(_records(got[0]) + _records(got[1])) == _records(whole)


def test_stream_training_over_the_cluster(job):
    files, _, readings = job
    whole = InMemoryDataset(_slots())
    whole.set_filelist(files)
    whole.load_into_memory(num_threads=1)
    from paddle_tpu_torch.ps.ps_trainer import _slot_tagged_keys

    (batch,) = _all(whole)
    want = len(np.unique(_slot_tagged_keys(batch, [f"s{i}" for i in range(S)])))
    for r in readings:
        assert np.isfinite(r["loss"]) and r["steps"] == -(-r["records"] // 32)
        assert r["size"] == want


def test_launch_returns_a_failed_trainers_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(textwrap.dedent('''
        import os, sys, time
        if os.environ["TRAINING_ROLE"] == "PSERVER":
            time.sleep(60)  # the launcher stops the servers after the trainers
        sys.exit(3 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
    '''))
    rc, out = _launch(["--servers", "1", "--nproc_per_node", "2", "--master_port",
                       str(chip_smoke.ps_job_ports(2, 1)[0]), str(script)], timeout=60)
    assert rc == 3, out
    rc, out = _launch([], timeout=60)
    assert rc == 2 and "missing training script" in out


def test_chip_smoke_ps_job_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 14 at a small size on ``device="cpu"``: its
    ``--ps-job`` processes run from a directory where ``jax`` and
    ``paddle_tpu`` cannot be imported (each raises), so the job's code
    paths import neither; legs A (async), B (gpubox) and C (the dense
    executor) pass their checks (B's launch counts and B1 check need the
    card and are skipped on the CPU by the phase itself)."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    # the job's script runs chip_smoke.py with the blockers ahead of the
    # checkout on sys.path (the checkout's own paths, so no library rebuilds)
    (run_dir / "job.py").write_text(
        f"import runpy, sys\nsys.path.append({ROOT!r})\n"
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, run_name='__main__')\n")
    for blocked in ("jax", "paddle_tpu"):
        (run_dir / blocked).mkdir()
        (run_dir / blocked / "__init__.py").write_text(
            f"raise ImportError('{blocked} must not be imported by the job')\n")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the job's 5 processes share the test's cores
    for name, value in (("PSJOB_LINES", 2048), ("PSJOB_FILES", 4), ("PSJOB_BATCH", 128),
                        ("CAPACITY", 1 << 17), ("PSJOB_TIMEOUT", 100),
                        # 2048 records: the shuffle's split spreads ~2 % (phase 14's
                        # bound at 131,072 records is 2 %, ~7 sigma)
                        ("PSJOB_BALANCE", 0.1),
                        ("PSJOB_SCRIPT", str(run_dir / "job.py"))):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_ps_job(torch.device("cpu"), "cpu")
    assert out["steps"] == 16 and out["size"] == out["keys"] > 0 and out["b1"] is None
