"""``SpmdTrainer`` over a mesh whose ranks are processes, on the CPU: a
small ERNIE through the fused path (fp32, and int8 with error feedback)
and the stage-2 path over 2 gloo processes.

The module fixture makes the weights with the JAX package (``pt.seed(0)``,
converted by ``convert.ernie_params_from_jax``) and a JAX snapshot of the
fused ZeRO-2 rung after its first steps, then runs this file as a 2-process
job through the port's own launcher (``testing.multiprocess.run_job``);
each process writes its losses, the gathered params, a ``save`` and the
resumed runs to an ``.npz`` or a snapshot file. The tests hold them
against:

- the port's mesh of logical ranks in this process, bitwise (K = 2: gloo's
  sum of two operands is the thread mesh's bit for bit), saves array for
  array;
- the JAX ``SpmdTrainer`` on a 2-device mesh at ``test_torch_spmd.py``'s
  ERNIE bounds (the port's ``attn_impl="flash"``, plain B5–B7 with bf16
  operands, against JAX's einsum trainer): losses rtol 2e-4, each tensor's
  update within 5e-2 of JAX's by norm, the key bias left out.
"""

import os
import sys

import numpy as np
import pytest
import torch

K = 2
SMALL = dict(vocab_size=64, hidden_size=32, num_heads=2, ffn_size=64, num_layers=2,
             max_seq_len=16, dropout=0.0)
STEPS = 3
LR = 0.5
# name → (ZeRO stage, comm config or None (the stage-2 path), mesh, optimizer)
RUNGS = {"fp32_fused": (0, {}, {"dp": K}, ("SGD", LR)),
         "int8_fused": (0, dict(quant="int8", block_size=64, max_buckets=4), {"dp": K},
                        ("SGD", LR)),
         "stage2": (2, None, {"sharding": K}, ("Momentum", LR))}
SAVED = ("int8_fused", "stage2")
RESUME = (2, {}, {"dp": K}, ("Momentum", LR))   # the JAX snapshot's rung: fused ZeRO-2
LOSS_RTOL, UPDATE_TOL = 2e-4, 5e-2


def _batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, SMALL["vocab_size"], (8, 16)).astype(np.int64)
    labels = rng.integers(0, SMALL["vocab_size"], (8, 16)).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _loss(out, lab):
    return torch.nn.functional.cross_entropy(out.reshape(-1, out.shape[-1]), lab.reshape(-1))


def _opt(spec):
    from paddle_tpu_torch import optimizer as topt

    name, lr = spec
    return topt.Momentum(lr, 0.9) if name == "Momentum" else getattr(topt, name)(lr)


def _trainer(weights, rung, mesh):
    from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
    from paddle_tpu_torch.models import ernie
    from paddle_tpu_torch.parallel import SpmdTrainer

    stage, comm, _, opt = rung
    model = ernie.Ernie(ernie.ErnieConfig(**SMALL, attn_impl="flash"))
    model.load_state_dict(weights)
    return SpmdTrainer(model, _opt(opt), _loss, mesh, zero_stage=stage,
                       comm=None if comm is None else CommFusionConfig(**comm), device="cpu")


def _params(tr):
    return {k: v.numpy() for k, v in tr.full_state()[0]["params"].items()}


def _weights(work):
    z = np.load(os.path.join(work, "weights.npz"))
    return {k: torch.from_numpy(z[k]) for k in z.files}


def _worker(work):
    from paddle_tpu_torch.convert import (ernie_params_from_jax, spmd_opt_state_from_jax,
                                          spmd_state_from_jax)
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.core.mesh import make_process_mesh
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.io.checkpoint import load_train_state

    torch.set_num_threads(1)
    C.init_parallel_env()
    rank = C.get_rank()
    weights = _weights(work)
    ids, labels = _batch()
    res = {}
    for name, rung in RUNGS.items():
        tr = _trainer(weights, rung, make_process_mesh(rung[2], device="cpu"))
        res[f"{name}_losses"] = np.asarray([float(tr.train_step(ids, labels))
                                            for _ in range(STEPS)])
        for k, v in _params(tr).items():
            res[f"{name}_param_{k}"] = v
        if name in SAVED:
            path = os.path.join(work, f"{name}_process.snap")
            tr.save(path)
            res[f"{name}_next"] = np.asarray(float(tr.train_step(ids, labels)))
            other = _trainer({k: v * 0 for k, v in weights.items()}, rung,
                             make_process_mesh(rung[2], device="cpu"))
            other.load(path)
            res[f"{name}_loaded_next"] = np.asarray(float(other.train_step(ids, labels)))
    # the JAX snapshot into each process's part (convert's rank= forms)
    snap = load_train_state(os.path.join(work, "jax.snap"))
    tr = _trainer(weights, RESUME, make_process_mesh(RESUME[2], device="cpu"))
    tr.restore(spmd_state_from_jax(snap["state"], params_from_jax=ernie_params_from_jax,
                                   rank=rank),
               spmd_opt_state_from_jax(snap["opt"], tr, snap["state"]["params"],
                                       params_from_jax=ernie_params_from_jax, rank=rank),
               snap["step"], local=True)
    res["resume_losses"] = np.asarray([float(tr.train_step(ids, labels))
                                       for _ in range(STEPS)])
    for k, v in _params(tr).items():
        res[f"resume_param_{k}"] = v
    try:
        _trainer(weights, (0, None, {"dp": K}, ("SGD", LR)),
                 make_process_mesh({"dp": K}, device="cpu"))
        res["gspmd_error"] = np.asarray("")
    except UnavailableError as e:
        res["gspmd_error"] = np.asarray(f"{type(e).__name__}: {e}")
    np.savez(os.path.join(work, f"rank{rank}.npz"), **res)
    print("WORKER_OK", rank, flush=True)


def _jax_setup():
    import jax

    import paddle_tpu as pt
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.core import mesh as jmesh
    from paddle_tpu.distributed import comm_fusion as jcf
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu.parallel import SpmdTrainer as JSpmd

    def jloss(out, lab):
        return jnn.functional.cross_entropy(out.reshape(-1, out.shape[-1]), lab.reshape(-1))

    def jtrainer(rung):
        stage, comm, shape, (name, lr) = rung
        pt.seed(0)
        jm = jernie.Ernie(jernie.ErnieConfig(**SMALL))
        opt = jopt.Momentum(lr, 0.9) if name == "Momentum" else getattr(jopt, name)(lr)
        return jm, JSpmd(jm, opt, jloss, jmesh.make_mesh(shape, devices=jax.devices()[:K]),
                         zero_stage=stage,
                         comm=None if comm is None else jcf.CommFusionConfig(**comm))

    return jtrainer


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from paddle_tpu_torch.convert import ernie_params_from_jax
    from paddle_tpu_torch.testing.multiprocess import run_job

    work = tmp_path_factory.mktemp("mp_spmd")
    jtrainer = _jax_setup()
    jm, jtr = jtrainer(RESUME)
    w0 = {k: np.asarray(v) for k, v in jm.named_parameters()}
    np.savez(work / "weights.npz",
             **{k: v.numpy() for k, v in ernie_params_from_jax(w0).items()})
    ids, labels = (t.numpy().astype(np.int32) for t in _batch())
    for _ in range(STEPS):
        jtr.train_step(ids, labels)
    jtr.save(str(work / "jax.snap"))
    run_job([os.path.abspath(__file__), "--worker", str(work)], K, str(work), timeout=150)
    return {"work": work, "w0": w0, "jtrainer": jtrainer, "jax_resumed": jtr,
            "ranks": [dict(np.load(work / f"rank{r}.npz")) for r in range(K)]}


@pytest.fixture(scope="module")
def thread_runs(run):
    """Each rung on the port's mesh of logical ranks, in this process."""
    from paddle_tpu_torch.core.mesh import make_mesh

    weights, (ids, labels), out = _weights(str(run["work"])), _batch(), {}
    for name, rung in RUNGS.items():
        tr = _trainer(weights, rung, make_mesh(rung[2], device="cpu"))
        losses = np.asarray([float(tr.train_step(ids, labels)) for _ in range(STEPS)])
        out[name] = (losses, _params(tr))
        if name in SAVED:
            tr.save(str(run["work"] / f"{name}_thread.snap"))
            out[f"{name}_next"] = float(tr.train_step(ids, labels))
    return out


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_rung_over_processes_equals_the_thread_mesh(run, thread_runs, name):
    losses, params = thread_runs[name]
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[f"{name}_losses"], losses)
        for k, v in params.items():
            np.testing.assert_array_equal(res[f"{name}_param_{k}"], v, err_msg=k)


def _key_bias_dropped(k, d):
    from test_torch_ernie import _key_bias_dropped as drop

    return drop(k, d, SMALL)


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_rung_over_processes_follows_jax(run, name):
    import jax

    ids, labels = (t.numpy().astype(np.int32) for t in _batch())
    _, jtr = run["jtrainer"](RUNGS[name])
    jl = [float(jtr.train_step(ids, labels)) for _ in range(STEPS)]
    jend = jax.device_get(jtr.state["params"])
    for res in run["ranks"]:
        np.testing.assert_allclose(res[f"{name}_losses"], jl, rtol=LOSS_RTOL)
        for k, p0 in run["w0"].items():
            got = res[f"{name}_param_{k}"]
            want = _key_bias_dropped(k, np.asarray(jend[k]) - p0)
            mine = _key_bias_dropped(k, got - p0)
            assert np.linalg.norm(mine - want) <= UPDATE_TOL * np.linalg.norm(want), k


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


@pytest.mark.parametrize("name", SAVED)
def test_save_over_processes_equals_the_thread_mesh_save(run, thread_runs, name):
    """Rank 0 writes the global layout after the gather: the file equals the
    thread mesh's array for array; a trainer that loads it continues as
    the saving one does."""
    from paddle_tpu_torch.io.checkpoint import load_train_state

    got = load_train_state(str(run["work"] / f"{name}_process.snap"))
    want = load_train_state(str(run["work"] / f"{name}_thread.snap"))
    a, b = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg="/".join(path))
    for res in run["ranks"]:
        assert float(res[f"{name}_loaded_next"]) == float(res[f"{name}_next"]) \
            == thread_runs[f"{name}_next"]


def test_jax_snapshot_carries_into_each_process_part(run):
    """The JAX fused ZeRO-2 trainer's snapshot, each process taking its own
    part (``convert``'s ``rank=`` forms, ``restore(local=True)``): the next
    steps follow JAX (the bounds above) and equal the thread mesh's whole
    restore bitwise."""
    import jax

    from paddle_tpu_torch.convert import (ernie_params_from_jax, spmd_opt_state_from_jax,
                                          spmd_state_from_jax)
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.io.checkpoint import load_train_state

    ids, labels = _batch()
    jtr = run["jax_resumed"]
    start = jax.device_get(jtr.state["params"])
    jl = [float(jtr.train_step(ids.numpy().astype(np.int32), labels.numpy().astype(np.int32)))
          for _ in range(STEPS)]
    jend = jax.device_get(jtr.state["params"])
    snap = load_train_state(str(run["work"] / "jax.snap"))
    tr = _trainer(_weights(str(run["work"])), RESUME, make_mesh(RESUME[2], device="cpu"))
    tr.restore(spmd_state_from_jax(snap["state"], params_from_jax=ernie_params_from_jax),
               spmd_opt_state_from_jax(snap["opt"], tr, snap["state"]["params"],
                                       params_from_jax=ernie_params_from_jax), snap["step"])
    tl = np.asarray([float(tr.train_step(ids, labels)) for _ in range(STEPS)])
    tp = _params(tr)
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["resume_losses"], tl)
        np.testing.assert_allclose(res["resume_losses"], jl, rtol=LOSS_RTOL)
        for k, v in tp.items():
            np.testing.assert_array_equal(res[f"resume_param_{k}"], v, err_msg=k)
            p0 = np.asarray(start[k])
            want = _key_bias_dropped(k, np.asarray(jend[k]) - p0)
            mine = _key_bias_dropped(k, res[f"resume_param_{k}"] - p0)
            assert np.linalg.norm(mine - want) <= UPDATE_TOL * np.linalg.norm(want), k


def test_gspmd_path_on_a_process_mesh_raises(run):
    for res in run["ranks"]:
        msg = str(res["gspmd_error"])
        assert msg.startswith("UnavailableError") and "item 7b" in msg, msg


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
