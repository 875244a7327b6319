"""The port's ``hapi.Model``, vision datasets, ``DataLoader`` and metrics
against the JAX package's.

On the CPU, from the same numpy seeds and the same converted weights.
Tolerances: datasets and batch order bit-equal; metrics exact or 1e-12
(float64 on both sides), the on-device accuracy 1e-6 (an f32 mean); hapi
losses at O0 rtol 1e-5 (f32 products in another order), at O1/O2 rtol
2e-3 (the port rounds the backward's cotangent to bf16, ROADMAP Queue C).
"""

import gzip
import pickle
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import hapi as jhapi
from paddle_tpu import metrics as jmetrics
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.data import loader as jloader
from paddle_tpu.data import vision as jvision
from paddle_tpu.nn.layer import get_state
from paddle_tpu_torch import hapi, metrics
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import vision_params_from_jax
from paddle_tpu_torch.executor import amp_level
from paddle_tpu_torch.core.enforce import InvalidArgumentError, PreconditionNotMetError
from paddle_tpu_torch.data import loader, vision
from paddle_tpu_torch.nn import functional as tF


def _pair(hidden=16):
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, hidden), jnn.ReLU(), jnn.Linear(hidden, 2))
    tm = tnn.Sequential(tnn.Linear(8, hidden), tnn.ReLU(), tnn.Linear(hidden, 2))
    tm.load_state_dict(vision_params_from_jax(get_state(jm)))
    return jm, tm


@pytest.mark.parametrize("amp_cfg,level", [
    (None, "O0"), ("O0", "O0"), (False, "O0"), ("O1", "O1"), (True, "O1"),
    ({"level": "O2"}, "O2"), ({"init_loss_scaling": 1024.0}, "O1")],
    ids=["none", "O0", "false", "O1", "true", "dict-O2", "dict-no-level"])
def test_hapi_prepare_amp_configs_train_like_jax(amp_cfg, level):
    """The reference's amp_configs spellings: O2 stores bf16 params with
    f32 masters, the others f32; 10 train_batch losses as JAX's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8, 2))).argmax(-1).astype(np.int64)
    jm, tm = _pair()
    jmod, tmod = jhapi.Model(jm), hapi.Model(tm, device="cpu")
    jmod.prepare(jopt.Adam(1e-2), jnn.functional.cross_entropy, amp_configs=amp_cfg)
    tmod.prepare(topt.Adam(1e-2), tF.cross_entropy, amp_configs=amp_cfg)
    assert amp_level(amp_cfg) == level
    jl = [jmod.train_batch(x, y)["loss"] for _ in range(10)]
    tl = [tmod.train_batch(x, y)["loss"] for _ in range(10)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if level == "O0" else 2e-3)
    assert tl[-1] < tl[0]
    dt = torch.bfloat16 if level == "O2" else torch.float32
    assert all(p.dtype == dt for p in tmod.state["params"].values())
    if level == "O2":
        assert isinstance(tmod._trainer.optimizer, topt.MasterWeights)
        for k, p in tmod.state["params"].items():
            assert torch.equal(p, tmod._trainer.opt_state["master"][k].to(torch.bfloat16))


def test_hapi_rejects_unknown_levels_and_unported_io(tmp_path):
    m = hapi.Model(tnn.Linear(8, 2), device="cpu")
    with pytest.raises(InvalidArgumentError, match="O0/O1/O2"):
        m.prepare(topt.Adam(1e-2), tF.cross_entropy, amp_configs="o1")
    with pytest.raises(PreconditionNotMetError, match="prepare"):
        m.predict_batch(np.zeros((1, 8), np.float32))
    m.prepare(topt.Adam(1e-2), tF.cross_entropy)
    with pytest.raises(InvalidArgumentError, match="io/checkpoint.py"):
        m.save(str(tmp_path / "x"))
    with pytest.raises(InvalidArgumentError, match="io/inference.py"):
        m.save(str(tmp_path / "x"), training=False)
    with pytest.raises(InvalidArgumentError, match="io/checkpoint.py"):
        m.load(str(tmp_path / "x"))


class _Recorder(hapi.Callback):
    def __init__(self):
        self.events = []

    def on_train_begin(self, model):
        self.events.append("begin")

    def on_epoch_end(self, model, epoch, logs):
        self.events.append(("epoch", epoch, sorted(logs)))

    def on_batch_end(self, model, step, logs):
        if step == 3:
            model.stop_training = True


def test_hapi_fit_evaluate_predict_match_jax():
    """fit over a DataLoader, evaluate with Accuracy, predict_batch: the
    same history and metrics as JAX's hapi (O0), and early stop by a
    callback ends the epoch."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(96, 8)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    jm, tm = _pair(32)
    jmod, tmod = jhapi.Model(jm), hapi.Model(tm, device="cpu")
    jmod.prepare(jopt.SGD(0.1), jnn.functional.cross_entropy, [jmetrics.Accuracy()])
    tmod.prepare(topt.SGD(0.1), tF.cross_entropy, [metrics.Accuracy()])
    jd = jloader.DataLoader(jloader.TensorDataset(x, y), 16, shuffle=True, seed=3)
    td = loader.DataLoader(loader.TensorDataset(x, y), 16, shuffle=True, seed=3)
    jh = jmod.fit(jd, jd, epochs=3, verbose=0)
    th = tmod.fit(td, td, epochs=3, verbose=0)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    je = jmod.evaluate(jloader.DataLoader(jloader.TensorDataset(x, y), 32))
    te = tmod.evaluate(loader.DataLoader(loader.TensorDataset(x, y), 32))
    assert sorted(te) == ["accuracy", "eval_loss"] and te["accuracy"] == je["accuracy"]
    np.testing.assert_allclose(te["eval_loss"], je["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(tmod.predict_batch(x[:5]).numpy(),
                               np.asarray(jmod.predict_batch(x[:5])), rtol=1e-5, atol=1e-6)
    rec = _Recorder()
    h = tmod.fit(td, epochs=2, callbacks=[rec], verbose=0)
    assert len(h["loss"]) == 1 and rec.events[0] == "begin"
    assert rec.events[1] == ("epoch", 0, ["loss"])
    # prepare without an optimizer evaluates the module's own weights
    ev = hapi.Model(tm, device="cpu")
    ev.prepare(loss=tF.cross_entropy, metrics=[metrics.Accuracy()])
    assert "accuracy" in ev.evaluate(td)
    with pytest.raises(PreconditionNotMetError, match="optimizer"):
        ev.train_batch(x[:4], y[:4])


# -- datasets and the loader --------------------------------------------------------

@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_bit_equal_to_jax(name, mode):
    j = getattr(jvision, name)(mode=mode, synthetic_size=300, seed=4)
    t = getattr(vision, name)(mode=mode, synthetic_size=300, seed=4)
    assert len(t) == len(j) == 300
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.images.dtype == np.float32 and t.labels.dtype == np.int64
    ti, tl = t[np.arange(3)]
    np.testing.assert_array_equal(ti, j.images[:3])


def test_idx_and_pickle_files_load_like_jax(tmp_path):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (6, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 6, dtype=np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 28, 28) + imgs.tobytes())
    (tmp_path / "t10k-labels-idx1-ubyte").write_bytes(struct.pack(">II", 2049, 6)
                                                       + labels.tobytes())
    j = jvision.MNIST("test", image_path=str(tmp_path))
    t = vision.MNIST("test", image_path=str(tmp_path))
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, labels.astype(np.int64))
    with pytest.raises(InvalidArgumentError, match="no IDX"):
        vision.MNIST("train", image_path=str(tmp_path), backend="idx")
    with pytest.raises(InvalidArgumentError, match="mode"):
        vision.MNIST("valid")
    data = rng.integers(0, 256, (4, 3 * 32 * 32), dtype=np.uint8)
    with open(tmp_path / "test_batch", "wb") as f:
        pickle.dump({b"data": data, b"labels": [1, 2, 3, 4]}, f)
    with open(tmp_path / "test", "wb") as f:
        pickle.dump({b"data": data, b"fine_labels": [9, 8, 7, 6]}, f)
    for name in ("Cifar10", "Cifar100"):
        j = getattr(jvision, name)("test", data_path=str(tmp_path))
        t = getattr(vision, name)("test", data_path=str(tmp_path))
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_dataloader_batch_order_matches_jax(shuffle, drop_last):
    x = np.arange(70, dtype=np.float32).reshape(35, 2)
    y = np.arange(35, dtype=np.int64)
    jd = jloader.DataLoader(jloader.TensorDataset(x, y), 8, shuffle, drop_last, seed=7)
    td = loader.DataLoader(loader.TensorDataset(x, y), 8, shuffle, drop_last, seed=7)
    assert len(td) == len(jd)
    for _ in range(2):  # a second epoch reshuffles the same way
        jb, tb = list(jd), list(td)
        assert len(tb) == len(jb)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    with pytest.raises(InvalidArgumentError, match="leading"):
        loader.TensorDataset(x, y[:3])


# -- metrics ------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(50, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 50)
    for k in (1, 3):
        # an f32 mean of 50 hits (the two libraries round it differently)
        np.testing.assert_allclose(
            float(metrics.accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k)),
            float(jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels), k)), rtol=1e-6)
        ja, ta = jmetrics.Accuracy(k), metrics.Accuracy(k)
        for sl in (slice(0, 20), slice(20, 50)):
            ja.update(logits[sl], labels[sl])
            ta.update(logits[sl], labels[sl])
        assert ta.accumulate() == ja.accumulate()
    preds = rng.random(400)
    bins = (rng.random(400) < preds).astype(np.int64)
    mask = (rng.random(400) < 0.8).astype(np.float32)
    ja, ta = jmetrics.AUC(256), metrics.AUC(256)
    ja.update(preds, bins, mask)
    ta.update(preds, bins, mask)
    assert ta.accumulate() == ja.accumulate()
    jb = jmetrics.auc_update_buckets(jnp.zeros((2, 64), jnp.float32), jnp.asarray(preds,
                                     jnp.float32), jnp.asarray(bins), jnp.asarray(mask))
    tb = metrics.auc_update_buckets(torch.zeros(2, 64), torch.from_numpy(preds).float(),
                                    torch.from_numpy(bins), torch.from_numpy(mask))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    uids = rng.integers(0, 9, 400)
    for cls in ("MAE", "RMSE"):
        j, t = getattr(jmetrics, cls)(), getattr(metrics, cls)()
        j.update(preds, bins, mask)
        t.update(preds, bins, mask)
        np.testing.assert_allclose(t.accumulate(), j.accumulate(), rtol=1e-12)
    j, t = jmetrics.WuAUC(), metrics.WuAUC()
    j.update(uids, preds, bins)
    t.update(uids, preds, bins)
    np.testing.assert_allclose(t.accumulate(), j.accumulate(), rtol=1e-12)
    t2 = metrics.WuAUC()
    t2.merge(t.state)
    np.testing.assert_allclose(t2.accumulate(), t.accumulate(), rtol=1e-12)
