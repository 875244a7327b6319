"""``io.inference`` of the port (``torch.export``) against the JAX
package's export (``jax.export``), on the CPU.

The port counterparts of ``tests/test_inference_model.py``'s seven tests
(round trip and param swap, values-only reload, frozen export,
cross-process serving, ``hapi.Model.save(training=False)``, the CTR
serving export, the family exports), each also holding the port's
predictions against the JAX export's on the same weights; then the GRU4Rec
and DSSM tower exports (``tests/test_gru4rec.py``, ``tests/test_dssm.py``)
and ``CtrPassTrainer.save_inference_model``, fused and not. The family
export runs DCN and xDeepFM, and DIN with ``with_real`` over the same
pass; ESMM's and MMoE's exports are in ``tests/test_torch_multitask.py``,
DIN's own in ``tests/test_torch_din.py``. Tolerances: a loaded program
against the in-process forward of the same package rtol 1e-6 (the same
ops); the port's predictions against the JAX export's rtol 1e-5 / atol
1e-6 (f32 products in another order).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.io import inference as jinf
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import din as jdin
from paddle_tpu.models import dssm as jdssm
from paddle_tpu.models import gru4rec as jgru
from paddle_tpu.models.lenet import LeNet as JLeNet
from paddle_tpu.nn.layer import get_state
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch import hapi
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (ctr_params_from_jax, recsys_params_from_jax,
                                      vision_params_from_jax)
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.io import inference as tinf
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import din as tdin
from paddle_tpu_torch.models import dssm as tdssm
from paddle_tpu_torch.models import gru4rec as tgru
from paddle_tpu_torch.models.lenet import LeNet
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_ctr import Pair
from test_torch_ctr_families import D, DIM, S, FamilyPair
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

CPU = "cpu"
XTOL = dict(rtol=1e-5, atol=1e-6)


def _lenet():
    """The same LeNet in both packages, its eval forward as ``predict``."""
    pt.seed(0)
    jm = JLeNet(num_classes=10)
    tm = LeNet(num_classes=10)
    tm.load_state_dict(vision_params_from_jax(get_state(jm)))
    tm.eval()
    state = {"params": {k: v.detach() for k, v in tm.named_parameters()}, "buffers": {}}

    def predict(st, x):
        return torch.func.functional_call(tm, {**st["params"], **st["buffers"]}, (x,))

    def jpredict(st, x):
        out, _ = jnn.functional_call(jm, st, x, training=False)
        return out

    x = np.random.default_rng(0).normal(size=(2, 1, 28, 28)).astype(np.float32)
    return jm, tm, state, predict, jpredict, x


def _halved(state):
    return {"params": {k: v * 0.5 for k, v in state["params"].items()},
            "buffers": state["buffers"]}


def test_roundtrip_and_param_swap(tmp_path):
    jm, tm, state, predict, jpredict, x = _lenet()
    want = predict(state, torch.from_numpy(x)).numpy()
    tinf.save_inference_model(str(tmp_path / "m"), predict, state, (torch.from_numpy(x),))
    pred = tinf.load_inference_model(str(tmp_path / "m"), device=CPU)
    np.testing.assert_allclose(pred(x).numpy(), want, rtol=1e-6)
    # the JAX export of the same weights serves the same predictions
    jinf.save_inference_model(str(tmp_path / "j"), jpredict, get_state(jm), (jnp.asarray(x),))
    np.testing.assert_allclose(pred(x).numpy(),
                               np.asarray(jinf.load_inference_model(str(tmp_path / "j"))(x)),
                               **XTOL)
    # any batch size serves (the batch dimension is dynamic), 1 included
    x5 = np.random.default_rng(1).normal(size=(5, 1, 28, 28)).astype(np.float32)
    for xb in (x5, x5[:1]):
        np.testing.assert_allclose(pred(xb).numpy(), predict(state, torch.from_numpy(xb)).numpy(),
                                   rtol=1e-6)
    # newer params swap in without re-export
    state2 = _halved(state)
    pred.set_params(state2)
    got2 = pred(x).numpy()
    assert not np.allclose(got2, want)
    np.testing.assert_allclose(got2, predict(state2, torch.from_numpy(x)).numpy(), rtol=1e-6)
    man = json.load(open(tmp_path / "m" / "manifest.json"))
    assert man["freeze"] is False and man["device"] == "cpu" and man["format"] == "torch.export"
    assert man["inputs"] == [{"shape": ["b", "1", "28", "28"], "dtype": "torch.float32"}]
    assert sorted(os.listdir(tmp_path / "m")) == ["manifest.json", "model.pt2",
                                                  "params.meta.json", "params.npz"]


def test_reload_params_values_only(tmp_path):
    jm, tm, state, predict, jpredict, x = _lenet()
    tinf.save_inference_model(str(tmp_path / "m"), predict, state, (torch.from_numpy(x),))
    pred = tinf.load_inference_model(str(tmp_path / "m"), device=CPU)
    want = pred(x).numpy()
    state2 = _halved(state)
    tinf.refresh_inference_params(str(tmp_path / "m"), state2)
    np.testing.assert_allclose(pred(x).numpy(), want, rtol=1e-6)  # stale until reloaded
    pred.reload_params()
    got = pred(x).numpy()
    assert not np.allclose(got, want)
    np.testing.assert_allclose(got, predict(state2, torch.from_numpy(x)).numpy(), rtol=1e-6)
    tinf.save_inference_model(str(tmp_path / "f"), predict, state, (torch.from_numpy(x),),
                              freeze=True)
    frozen = tinf.load_inference_model(str(tmp_path / "f"), device=CPU)
    with pytest.raises(Exception, match="frozen"):
        frozen.reload_params()
    with pytest.raises(Exception, match="frozen"):
        tinf.refresh_inference_params(str(tmp_path / "f"), state2)
    with pytest.raises(Exception, match="save_inference_model first"):
        tinf.refresh_inference_params(str(tmp_path / "nowhere"), state2)


def test_frozen_export(tmp_path):
    jm, tm, state, predict, jpredict, x = _lenet()
    want = predict(state, torch.from_numpy(x)).numpy()
    tinf.save_inference_model(str(tmp_path / "f"), predict, state, (torch.from_numpy(x),),
                              freeze=True)
    pred = tinf.load_inference_model(str(tmp_path / "f"), device=CPU)
    np.testing.assert_allclose(pred(x).numpy(), want, rtol=1e-6)
    jinf.save_inference_model(str(tmp_path / "j"), jpredict, get_state(jm), (jnp.asarray(x),),
                              freeze=True)
    np.testing.assert_allclose(pred(x).numpy(),
                               np.asarray(jinf.load_inference_model(str(tmp_path / "j"))(x)),
                               **XTOL)
    assert not any(f.startswith("params") for f in os.listdir(tmp_path / "f"))
    with pytest.raises(Exception):
        pred.set_params(state)


def test_predictor_serves_on_its_device_only(tmp_path):
    """``device=None`` means the card (raises here); the program serves
    on the device it was traced on, and takes its inputs' count."""
    jm, tm, state, predict, jpredict, x = _lenet()
    tinf.save_inference_model(str(tmp_path / "m"), predict, state, (torch.from_numpy(x),))
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="device='cpu'"):
            tinf.InferencePredictor(str(tmp_path / "m"))
    with open(tmp_path / "m" / "manifest.json") as f:
        man = json.load(f)
    man["device"] = "cuda"
    with open(tmp_path / "m" / "manifest.json", "w") as f:
        json.dump(man, f)
    with pytest.raises(InvalidArgumentError, match="traced on cuda"):
        tinf.InferencePredictor(str(tmp_path / "m"), device=CPU)


def test_cross_process_serving(tmp_path):
    """The artifact loads and serves in a FRESH process that imports the
    port alone (no jax, no paddle_tpu)."""
    jm, tm, state, predict, jpredict, x = _lenet()
    want = predict(state, torch.from_numpy(x)).numpy()
    tinf.save_inference_model(str(tmp_path / "m"), predict, state, (torch.from_numpy(x),))
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "want.npy", want)
    script = tmp_path / "serve.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        import numpy as np
        from paddle_tpu_torch.io.inference import load_inference_model
        pred = load_inference_model({str(tmp_path / 'm')!r}, device="cpu")
        got = pred(np.load({str(tmp_path / 'x.npy')!r})).numpy()
        np.testing.assert_allclose(got, np.load({str(tmp_path / 'want.npy')!r}), rtol=1e-6)
        assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
        print("SERVE_OK")
    """))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SERVE_OK" in out.stdout


def test_hapi_model_save_inference(tmp_path):
    """``hapi.Model.save(path, training=False)`` exports the eval forward."""
    jm, tm, state, predict, jpredict, x = _lenet()
    m = hapi.Model(tm, device=CPU)
    m.prepare(topt.Adam(1e-3), tF.cross_entropy)
    want = m.predict_batch(x).numpy()
    m.save(str(tmp_path / "serve"), training=False, example_inputs=(x,))
    np.testing.assert_allclose(tinf.load_inference_model(str(tmp_path / "serve"), CPU)(x).numpy(),
                               want, rtol=1e-6)
    m.save(str(tmp_path / "serve2"), training=False, example_inputs=x)  # a bare array
    np.testing.assert_allclose(tinf.load_inference_model(str(tmp_path / "serve2"),
                                                         CPU)(x).numpy(), want, rtol=1e-6)
    with pytest.raises(Exception):
        m.save(str(tmp_path / "bad"), training=False)


# -- the CTR serving export -------------------------------------------------------------

def _valued_pair(family, rng):
    """A FamilyPair whose cache tables hold the same random values."""
    p = FamilyPair(family)
    for col in ("embed_w", "embedx_w"):
        v = rng.normal(size=tuple(p.tcache.state[col].shape)).astype(np.float32)
        p.jcache.state[col] = jnp.asarray(v)
        p.tcache.state[col].copy_(torch.from_numpy(v))
    p.tmodel.load_state_dict(p.tparams)
    return p


def _graph_is_plain_torch(dirname):
    """Every call in the exported program is a torch op: no kernel
    wrapper (a ctypes call cannot be traced, and the serving path reaches
    none)."""
    ep = torch.export.load(os.path.join(dirname, "model.pt2"))
    calls = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    other = [t for t in calls if not isinstance(t, torch._ops.OpOverload)
             and getattr(t, "__module__", None) != "_operator"]  # size arithmetic of "b"
    assert calls and not other, other


@pytest.mark.parametrize("freeze", [False, True])
def test_ctr_serving_export(tmp_path, freeze):
    """``export_ctr_inference`` of DeepFM: the loaded program matches the
    in-process probe → pull → forward → sigmoid and the JAX export of the
    same weights and tables; out-of-pass keys pull zeros; the export
    carries the pruned tables only; ``refresh_only`` rewrites the values
    and not the program."""
    rng = np.random.default_rng(0)
    p = Pair()
    for col in ("embed_w", "embedx_w"):
        v = rng.normal(size=tuple(p.tcache.state[col].shape)).astype(np.float32)
        p.jcache.state[col] = jnp.asarray(v)
        p.tcache.state[col].copy_(torch.from_numpy(v))
    p.tmodel.load_state_dict(p.tparams)
    out = str(tmp_path / "serve")
    tctr.export_ctr_inference(out, p.tmodel, p.tcache, slot_ids=np.arange(S), num_dense=D,
                              freeze=freeze)
    pred = tinf.load_inference_model(out, device=CPU)
    _graph_is_plain_torch(out)
    lo32 = (p.pool[:8] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    dense = rng.normal(size=(8, D)).astype(np.float32)
    got = pred(lo32, dense).numpy()
    rows = torch.from_numpy(p.tcache.lookup(p.pool[:8].reshape(-1)).astype(np.int64))
    emb = tec.cache_pull(p.tcache.state, rows).reshape(8, S, -1)
    with torch.no_grad():
        want = torch.sigmoid(p.tmodel(emb, torch.from_numpy(dense))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got > 0) & (got < 1)).all()
    jctr.export_ctr_inference(str(tmp_path / "j"), p.jmodel, p.jcache, slot_ids=np.arange(S),
                              num_dense=D, freeze=freeze)
    jgot = np.asarray(jinf.load_inference_model(str(tmp_path / "j"))(jnp.asarray(lo32),
                                                                     jnp.asarray(dense)))
    np.testing.assert_allclose(got, jgot, **XTOL)
    # out-of-pass keys → the sentinel → zero embeddings
    miss = pred(np.full((2, S), 0xFFFFFF, np.uint32), np.zeros((2, D), np.float32)).numpy()
    with torch.no_grad():
        zero = torch.sigmoid(p.tmodel(torch.zeros(2, S, 1 + DIM), torch.zeros(2, D))).numpy()
    np.testing.assert_allclose(miss, zero, rtol=1e-6, atol=1e-7)
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert man["freeze"] is freeze and "int64" in man["notes"]["inputs"]
    if freeze:
        with pytest.raises(Exception, match="refresh_only applies to unfrozen"):
            tctr.export_ctr_inference(out, p.tmodel, p.tcache, slot_ids=np.arange(S),
                                      num_dense=D, freeze=True, refresh_only=True)
        return
    from paddle_tpu_torch.io.checkpoint import load
    saved = load(os.path.join(out, "params"))["model"]
    assert set(saved["tables"]) == {"embed_w", "embedx_w"}
    assert set(saved) == {"map", "model", "tables"}
    prog = os.path.join(out, "model.pt2")
    before, mtime = open(prog, "rb").read(), os.path.getmtime(prog)
    p.tcache.state["embed_w"].mul_(2.0)
    tctr.export_ctr_inference(out, p.tmodel, p.tcache, slot_ids=np.arange(S), num_dense=D,
                              refresh_only=True)
    assert open(prog, "rb").read() == before and os.path.getmtime(prog) == mtime
    got2 = tinf.load_inference_model(out, device=CPU)(lo32, dense).numpy()
    emb2 = tec.cache_pull(p.tcache.state, rows).reshape(8, S, -1)
    with torch.no_grad():
        want2 = torch.sigmoid(p.tmodel(emb2, torch.from_numpy(dense))).numpy()
    np.testing.assert_allclose(got2, want2, rtol=1e-6, atol=1e-7)
    assert not np.allclose(got2, got)
    with pytest.raises(Exception, match="refresh"):
        tctr.export_ctr_inference(str(tmp_path / "nowhere"), p.tmodel, p.tcache,
                                  slot_ids=np.arange(S), num_dense=D, refresh_only=True)


@pytest.mark.parametrize("family", ["DCN", "XDeepFM"])
def test_family_serving_exports(tmp_path, family):
    """The export across the family: DCN and xDeepFM against their JAX
    exports on the same weights and tables, at batch 1 and 8."""
    rng = np.random.default_rng(1)
    p = _valued_pair(family, rng)
    tctr.export_ctr_inference(str(tmp_path / "t"), p.tmodel, p.tcache, slot_ids=np.arange(S),
                              num_dense=D)
    jctr.export_ctr_inference(str(tmp_path / "j"), p.jmodel, p.jcache, slot_ids=np.arange(S),
                              num_dense=D)
    pred = tinf.load_inference_model(str(tmp_path / "t"), device=CPU)
    jpred = jinf.load_inference_model(str(tmp_path / "j"))
    for n in (1, 8):
        lo32 = (p.pool[:n] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        dense = rng.normal(size=(n, D)).astype(np.float32)
        np.testing.assert_allclose(pred(lo32, dense).numpy(),
                                   np.asarray(jpred(jnp.asarray(lo32), jnp.asarray(dense))),
                                   **XTOL)
    # with_real over the same pass: DIN on the three columns (one target,
    # two behaviours), its last key of every row outside the pass
    pt.seed(1)
    jdin_m = jdin.DIN(1, S - 1, D, DIM, dnn_hidden=(8,), att_hidden=4)
    tdin_m = tdin.DIN(1, S - 1, D, DIM, dnn_hidden=(8,), att_hidden=4)
    tdin_m.load_state_dict(ctr_params_from_jax(
        {k: np.asarray(v) for k, v in jdin_m.named_parameters()}))
    tctr.export_ctr_inference(str(tmp_path / "tdin"), tdin_m, p.tcache, slot_ids=np.arange(S),
                              num_dense=D, with_real=True)
    jctr.export_ctr_inference(str(tmp_path / "jdin"), jdin_m, p.jcache, slot_ids=np.arange(S),
                              num_dense=D, with_real=True)
    pred = tinf.load_inference_model(str(tmp_path / "tdin"), device=CPU)
    jpred = jinf.load_inference_model(str(tmp_path / "jdin"))
    for n in (1, 8):
        lo32 = (p.pool[:n] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        lo32[:, -1] = 0xFFFFFF                            # not in the pass
        dense = rng.normal(size=(n, D)).astype(np.float32)
        np.testing.assert_allclose(pred(lo32, dense).numpy(),
                                   np.asarray(jpred(jnp.asarray(lo32), jnp.asarray(dense))),
                                   **XTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_pass_trainer_save_inference_model(tmp_path, fused):
    """``CtrPassTrainer.save_inference_model``: the dense graph (pulled
    embeddings, dense → pctr) or, fused, the whole program over a pass
    begun on ``keys``; both against the trainer's own forward."""
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer

    pt.seed(0)
    torch.manual_seed(0)
    model = tctr.DCN(tctr.CtrConfig(S, D, DIM, (8,)))
    tr = CtrPassTrainer(model, topt.Adagrad(1e-2),
                        MemorySparseTable(TableConfig(shard_num=2, accessor_config=AccessorConfig(
                            embedx_dim=DIM, embedx_threshold=0.0))),
                        tec.CacheConfig(capacity=256, embedx_dim=DIM, embedx_threshold=0.0),
                        sparse_slots=[f"s{i}" for i in range(S)],
                        dense_slots=[f"d{i}" for i in range(D)], label_slot="label", device=CPU)
    rng = np.random.default_rng(2)
    keys = (rng.integers(1, 500, size=(16, S)).astype(np.uint64)
            + (np.arange(S, dtype=np.uint64) << np.uint64(32)))
    dense = rng.normal(size=(16, D)).astype(np.float32)
    out = str(tmp_path / "m")
    tr.save_inference_model(out, fused=fused, keys=keys.reshape(-1) if fused else None)
    pred = tinf.load_inference_model(out, device=CPU)
    pulled = tr.table.pull_sparse(keys.reshape(-1), create=False)
    emb = torch.from_numpy(np.ascontiguousarray(pulled[:, -(1 + DIM):].reshape(16, S, 1 + DIM)))
    with torch.no_grad():
        want = torch.sigmoid(torch.func.functional_call(model, tr.params,
                                                        (emb, torch.from_numpy(dense))))
    if fused:
        assert tr.cache.state is not None  # the pass begun on `keys` stays active
        got = pred((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), dense)
    else:
        got = pred(emb.numpy(), dense)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


# -- the recsys tower exports ---------------------------------------------------------

def _caches(keys, rng):
    """Both packages' caches (with the key map) over the same pass, the
    same random table values."""
    acc = dict(embedx_dim=DIM, embedx_threshold=0.0)
    ckw = dict(capacity=256, embedx_dim=DIM, embedx_threshold=0.0)
    jc = jec.HbmEmbeddingCache(JaxTable(JaxTableConfig(
        shard_num=2, backend="python", accessor_config=JaxAccessorConfig(**acc))),
        jec.CacheConfig(**ckw), device_map=True)
    tc = tec.HbmEmbeddingCache(MemorySparseTable(TableConfig(
        shard_num=2, backend="python", accessor_config=AccessorConfig(**acc))), tec.CacheConfig(**ckw),
        device=CPU, device_map=True)
    jc.begin_pass(keys)
    tc.begin_pass(keys)
    for col in ("embed_w", "embedx_w"):
        v = rng.normal(scale=0.5, size=tuple(tc.state[col].shape)).astype(np.float32)
        jc.state[col] = jnp.asarray(v)
        tc.state[col].copy_(torch.from_numpy(v))
    np.testing.assert_array_equal(tc.lookup(keys), jc.lookup(keys))
    return jc, tc


def test_gru4rec_tower_exports(tmp_path):
    """The session tower (keys + lengths → the normalized session vector,
    the GRU inside the program) and the item tower against the JAX
    exports on the same weights; padding past ``lengths`` and
    out-of-pass ids change nothing; ``refresh_only`` swaps values only."""
    rng = np.random.default_rng(3)
    T, n_items = 5, 40
    jc, tc = _caches(tgru.item_keys(np.arange(1, n_items + 1)), rng)
    pt.seed(0)
    jm = jgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=6)
    tm = tgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=6)
    tm.load_state_dict(recsys_params_from_jax({k: np.asarray(v)
                                               for k, v in jm.named_parameters()}))
    tgru.export_gru4rec_towers(str(tmp_path / "t"), tm, tc, max_len=T)
    jgru.export_gru4rec_towers(str(tmp_path / "j"), jm, jc, max_len=T)
    seq = rng.integers(1, n_items + 1, size=(6, T)).astype(np.uint32)
    lengths = rng.integers(1, T + 1, size=6).astype(np.int32)
    s_t = tinf.load_inference_model(str(tmp_path / "t" / "session"), CPU)(seq, lengths).numpy()
    s_j = np.asarray(jinf.load_inference_model(str(tmp_path / "j" / "session"))(
        jnp.asarray(seq), jnp.asarray(lengths)))
    np.testing.assert_allclose(s_t, s_j, **XTOL)
    items = np.arange(1, 9, dtype=np.uint32)[:, None]
    i_t = tinf.load_inference_model(str(tmp_path / "t" / "item"), CPU)(items).numpy()
    i_j = np.asarray(jinf.load_inference_model(str(tmp_path / "j" / "item"))(jnp.asarray(items)))
    np.testing.assert_allclose(i_t, i_j, **XTOL)
    # positions past the length are frozen out: garbage there changes nothing
    junk = seq.copy()
    junk[np.arange(T)[None, :] >= lengths[:, None]] = 0xFFFFFF
    sess = tinf.load_inference_model(str(tmp_path / "t" / "session"), CPU)
    np.testing.assert_array_equal(sess(junk, lengths).numpy(), s_t)
    prog = tmp_path / "t" / "session" / "model.pt2"
    before = prog.read_bytes()
    tc.state["embedx_w"].mul_(2.0)
    tgru.export_gru4rec_towers(str(tmp_path / "t"), tm, tc, max_len=T, refresh_only=True)
    assert prog.read_bytes() == before
    sess.reload_params()
    assert not np.allclose(sess(seq, lengths).numpy(), s_t)


def test_dssm_tower_export(tmp_path):
    """Query and doc towers export as separate programs; each against the
    JAX export on the same weights, and against the port's own forward."""
    rng = np.random.default_rng(4)
    SQ, SD = 2, 2
    q = rng.integers(1, 60, size=(24, SQ)).astype(np.uint64)
    d = rng.integers(1, 60, size=(24, SD)).astype(np.uint64) + (np.uint64(1) << np.uint64(32))
    keys = np.unique(np.concatenate([q, d], axis=1).reshape(-1))
    jc, tc = _caches(keys, rng)
    pt.seed(0)
    jm = jdssm.DSSM(SQ, SD, DIM, hidden=(8,), out_dim=6)
    tm = tdssm.DSSM(SQ, SD, DIM, hidden=(8,), out_dim=6)
    params = recsys_params_from_jax({k: np.asarray(v) for k, v in jm.named_parameters()})
    tm.load_state_dict(params)
    qs, ds = np.zeros(SQ, np.uint32), np.ones(SD, np.uint32)
    tdssm.export_dssm_towers(str(tmp_path / "t"), tm, tc, qs, ds)
    jdssm.export_dssm_towers(str(tmp_path / "j"), jm, jc, query_slot_ids=qs, doc_slot_ids=ds)
    lo_q = (q[:8] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lo_d = (d[:8] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got_q = tinf.load_inference_model(str(tmp_path / "t" / "query"), CPU)(lo_q).numpy()
    got_d = tinf.load_inference_model(str(tmp_path / "t" / "doc"), CPU)(lo_d).numpy()
    np.testing.assert_allclose(got_q, np.asarray(jinf.load_inference_model(
        str(tmp_path / "j" / "query"))(jnp.asarray(lo_q))), **XTOL)
    np.testing.assert_allclose(got_d, np.asarray(jinf.load_inference_model(
        str(tmp_path / "j" / "doc"))(jnp.asarray(lo_d))), **XTOL)
    rows = torch.from_numpy(tc.lookup(np.concatenate([q[:8], d[:8]], axis=1).reshape(-1))
                            .astype(np.int64))
    emb = tec.cache_pull(tc.state, rows).reshape(8, SQ + SD, -1)
    with torch.no_grad():
        wq, wd = tm(emb, torch.zeros(8, 1))
    np.testing.assert_allclose(got_q, wq.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_d, wd.numpy(), rtol=1e-6, atol=1e-7)
