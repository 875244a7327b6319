"""The port's ``HybridParallelTrainer`` against the JAX package's on the CPU.

Each JAX trainer (one a module fixture) builds its weights; the port's
trainer takes them name for name (``convert.hybrid_params_from_jax``)
and both step on the same numpy-seeded batches. Tolerances:

- The first loss on ``{"dp": 1, "pp": 2, "cp": 2, "mp": 2}`` (encoder and
  causal): rtol 1e-5 (f32; psums, the ring's merges and the matmuls sum
  in other orders).
- One ``SGD(1.0)`` step there: the delta of every parameter is its
  gradient, atol 5e-6 against JAX's delta (the bound of the JAX
  package's own serial-gradient test, ``tests/test_hybrid.py``).
- 3 ``Adam(1e-2)`` steps on ``{"dp": 2, "pp": 2, "cp": 1, "mp": 2}``, dense
  and with 4 experts (ep riding dp): losses rtol 1e-5, every parameter
  within 1e-5 of its tensor's largest absolute value — except the key
  bias, whose true gradient is 0 (a constant added to every key of a row
  leaves its softmax unchanged): Adam divides its rounding noise by
  sqrt(v) and moves it by up to lr whatever the noise's sign, in both
  packages, so it is compared by its size instead (both below 3 steps of
  lr). Save, load and resume: the resumed losses rtol 1e-5, the
  parameters as above. Two port runs of the same steps are bitwise equal
  (``test_adam_steps_repeat_bitwise_on_the_cpu``).
- ``attn_impl="flash"`` (the plain versions of B5–B7 on the CPU, bf16
  operands) against JAX's einsum trainer: first loss rtol 2e-4 (seen:
  3.5e-5), the SGD delta within 2e-2 of each tensor's largest (seen:
  9e-3).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.models.ernie import ErnieConfig as JCfg
from paddle_tpu.parallel.hybrid import HybridParallelTrainer as JTrainer
from paddle_tpu_torch.convert import hybrid_opt_state_from_jax, hybrid_params_from_jax
from paddle_tpu_torch.core.enforce import InvalidArgumentError, UnavailableError
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer, flatten_tree

CFG = dict(vocab_size=32, hidden_size=16, num_heads=4, ffn_size=32, num_layers=2,
           max_seq_len=64)
MESH_A = {"dp": 1, "pp": 2, "cp": 2, "mp": 2}
MESH_B = {"dp": 2, "pp": 2, "cp": 1, "mp": 2}


def _data(batch, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], size=(batch, seq)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], size=(batch, seq)).astype(np.int32))


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _jax_run(cfg_kw, shape, opt, steps, batch, seed):
    """A JAX trainer's params before and after each of ``steps`` steps."""
    pt.seed(seed)
    tr = JTrainer(JCfg(**cfg_kw), jmesh.make_mesh(shape, devices=jax.devices()[:8]), opt,
                  num_micro=2)
    ids, labels = _data(batch)
    start, start_opt = jax.device_get(tr.params), jax.device_get(tr.opt_state)
    losses = [float(tr.train_step(ids, labels)) for _ in range(steps)]
    return {"start": start, "start_opt": start_opt, "losses": losses,
            "end": _np(tr.params), "ids": ids, "labels": labels}


def _port(cfg_kw, shape, opt, run):
    tr = HybridParallelTrainer(ErnieConfig(**cfg_kw), make_mesh(shape, device="cpu"), opt,
                               device="cpu")
    tr.params = hybrid_params_from_jax(run["start"], "cpu")
    tr.opt_state = hybrid_opt_state_from_jax(run["start_opt"], opt, "cpu")
    return tr, torch.from_numpy(run["ids"]), torch.from_numpy(run["labels"])


@pytest.fixture(scope="module", params=[False, True], ids=["encoder", "causal"])
def sgd_run(request):
    kw = {**CFG, "causal": request.param}
    return kw, _jax_run(kw, MESH_A, jopt.SGD(1.0), 1, 4, seed=0)


def _sgd_check(kw, run, impl, loss_rtol, delta_tol):
    tr, ids, labels = _port({**kw, "attn_impl": impl}, MESH_A, SGD(1.0), run)
    start = {k: v.clone() for k, v in flatten_tree(tr.params).items()}
    loss = float(tr.train_step(ids, labels))
    np.testing.assert_allclose(loss, run["losses"][0], rtol=loss_rtol)
    jstart = _np(run["start"])
    end = flatten_tree(tr.params)
    assert set(end) == set(run["end"])
    for k, v in end.items():
        want = jstart[k] - run["end"][k]
        got = (start[k] - v).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=delta_tol(want), err_msg=k)
    return tr


def test_first_loss_and_sgd_delta_match_jax(sgd_run):
    kw, run = sgd_run
    tr = _sgd_check(kw, run, "einsum", 1e-5, lambda w: 5e-6)
    assert tr.global_step == 1


def test_flash_path_first_loss_and_sgd_delta(sgd_run):
    kw, run = sgd_run
    _sgd_check(kw, run, "flash", 2e-4, lambda w: 2e-2 * max(np.abs(w).max(), 1e-6))


def test_first_loss_matches_the_serial_model(sgd_run):
    """The serial port Ernie assembled from the trainer's params computes
    the hybrid step's first loss (the check chip_smoke makes on the card)."""
    kw, run = sgd_run
    tr, ids, labels = _port(kw, MESH_A, SGD(1.0), run)
    m = Ernie(ErnieConfig(**kw))
    m.load_state_dict(tr.serial_state_dict())
    with torch.no_grad():
        serial = float(m.loss(ids, labels))
    np.testing.assert_allclose(float(tr.train_step(ids, labels)), serial, rtol=1e-5)


def _params_close(params, want, steps, lr):
    """Every parameter within 1e-5 of its tensor's largest |value|; the
    key bias (true gradient 0) by its size: at most ``steps`` moves of
    ``lr`` in either run."""
    H, D = CFG["num_heads"], CFG["hidden_size"] // CFG["num_heads"]
    for k, v in flatten_tree(params).items():
        got, ref = v.detach().numpy(), want[k]
        if k.endswith("attn.qkv_b"):            # head-major [pp, H, 3, D]
            for a in (got, ref):
                assert np.abs(a.reshape(-1, H, 3, D)[:, :, 1]).max() <= steps * lr + 1e-6
            got, ref = (a.reshape(-1, H, 3, D)[:, :, [0, 2]] for a in (got, ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1e-6),
                                   err_msg=k)


@pytest.fixture(scope="module", params=[0, 4], ids=["dense", "moe"])
def adam_run(request):
    kw = {**CFG, "num_experts": request.param}
    return kw, _jax_run(kw, MESH_B, jopt.Adam(1e-2), 3, 8, seed=1 + request.param)


def test_adam_steps_match_jax(adam_run):
    kw, run = adam_run
    opt = Adam(1e-2)
    tr, ids, labels = _port(kw, MESH_B, opt, run)
    losses = [float(tr.train_step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    _params_close(tr.params, run["end"], steps=3, lr=1e-2)
    if kw["num_experts"]:
        assert tr.cfg.ep_axis == "dp" and np.isfinite(tr.last_aux_loss)


def test_save_load_resume_follows_the_same_trajectory(adam_run, tmp_path):
    kw, run = adam_run
    opt = Adam(1e-2)
    a, ids, labels = _port(kw, MESH_B, opt, run)
    a.train_step(ids, labels)
    a.save(str(tmp_path / "snap"))
    la = [float(a.train_step(ids, labels)) for _ in range(2)]
    b = HybridParallelTrainer(ErnieConfig(**kw), make_mesh(MESH_B, device="cpu"), Adam(1e-2),
                              seed=7, device="cpu")
    b.load(str(tmp_path / "snap"))
    assert b.global_step == 1
    lb = [float(b.train_step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    _params_close(b.params, {k: v.numpy() for k, v in flatten_tree(a.params).items()},
                  steps=3, lr=1e-2)


def test_out_of_slice_layouts_raise():
    cfg = ErnieConfig(**CFG)
    with pytest.raises(UnavailableError, match="item 7"):
        HybridParallelTrainer(cfg, make_mesh({**MESH_A, "sh": 2}, device="cpu"), SGD(0.1),
                              device="cpu")
    with pytest.raises(InvalidArgumentError, match="lacks axis 'cp'"):
        HybridParallelTrainer(cfg, make_mesh({"dp": 2, "pp": 2, "mp": 2}, device="cpu"),
                              SGD(0.1), device="cpu")
    with pytest.raises(InvalidArgumentError, match="mesh lives on"):
        HybridParallelTrainer(cfg, make_mesh(MESH_A, device="cpu"), SGD(0.1), device="meta")
    # sh of size 1 is the layout without it
    tr = HybridParallelTrainer(cfg, make_mesh({**MESH_A, "sh": 1}, device="cpu"), SGD(0.1),
                               device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _data(4))
    assert np.isfinite(float(tr.train_step(ids, labels)))


def test_dropout_draws_from_the_trainers_generator():
    """At dropout > 0, a trainer's seed fixes its steps: the same seed
    gives the same losses, another seed does not."""
    cfg = ErnieConfig(**CFG, dropout=0.2)
    ids, labels = (torch.from_numpy(a) for a in _data(8))

    def run(seed):
        tr = HybridParallelTrainer(cfg, make_mesh(MESH_B, device="cpu"), Adam(1e-2),
                                   seed=0, device="cpu")
        tr._gen.manual_seed(seed)
        return [float(tr.train_step(ids, labels)) for _ in range(2)]

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert a != c


def test_adam_steps_repeat_bitwise_on_the_cpu():
    """Two runs of the same 3 Adam steps on ``{"dp": 2, "pp": 2, "cp": 1,
    "mp": 2}`` from the same weights give the same bits: a collective runs
    on its group's first rank, so the autograd nodes it records, and the
    order in which the one backward sums the ranks' gradients, do not
    depend on which rank arrived last (``ops.collectives.run_ranks``)."""
    ids, labels = (torch.from_numpy(a) for a in _data(8))

    def run():
        tr = HybridParallelTrainer(ErnieConfig(**CFG), make_mesh(MESH_B, device="cpu"),
                                   Adam(1e-2), seed=3, device="cpu")
        losses = [tr.train_step(ids, labels) for _ in range(3)]
        return losses, flatten_tree(tr.params)

    (la, pa), (lb, pb) = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
