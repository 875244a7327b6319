"""Item 8's first half on a card, against the CPU: the pipeline schedules,
DeepWalk's step and walks, the heter pipeline with a step on the card.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu`` (``pytest --noconftest -m
cuda`` runs it on a machine without them). The CPU side runs the plain
versions (flash attention's, B1's, the merge's).

Tolerances: the pipelines at ``chip_smoke.py`` phase 24's small size
(HYB_SMALL's widths, 4 layers, ``{"dp": 1, "pp": 2}``), 2 steps card vs
CPU from the same weights: losses rtol 1e-4, under SGD each tensor's
update within 5e-2 of the CPU's in norm, the key bias left out (phase
21's ``HYB_TOL``); under the GradientMerge chain over Adam the moments
within 1e-2 of their norm and the update within 1e-3·lr where the
gradient is not within rounding of 0.
DeepWalk, one step on the same injected walks and negatives: the loss
rtol 1e-5, every cache column rtol 1e-5 / atol 1e-6 (the SGNS sums
reduce in another order; B1 and the merge are bitwise against their
plain versions in phase 24). The heter pipeline: bitwise equal to the
serial replay on the same card.
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models import DeepWalkConfig, make_deepwalk_train_step
from paddle_tpu_torch.models import graph_embedding as ge
from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieEmbedding, ErnieHead, ErnieStage
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.device_graph import DeviceGraph
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.parallel import LayerDesc, PipelineLayer, PipelineTrainer
from paddle_tpu_torch.parallel.heter_pipeline import HeterPipelineTrainer, SectionConfig
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
from paddle_tpu_torch.ps.graph_table import GraphTable
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

SMALL = dict(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128, num_layers=4,
             max_seq_len=64)
TOL = {"loss": 1e-4, "update": 5e-2}


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _lm_loss(out, labels):
    return F.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1))


def _pipe_run(device, schedule, make_opt, batches):
    cfg = ErnieConfig(**SMALL, attn_impl="flash")
    g = torch.Generator().manual_seed(5)
    if schedule == "interleave":
        model, V = PipelineLayer([LayerDesc(ErnieStage, cfg, 1, g) for _ in range(4)],
                                 embed=ErnieEmbedding(cfg, g), head=ErnieHead(cfg, g)), 2
    else:
        model, V = PipelineLayer([LayerDesc(ErnieStage, cfg, 2, g) for _ in range(2)],
                                 embed=ErnieEmbedding(cfg, g), head=ErnieHead(cfg, g)), 1
    tr = PipelineTrainer(model, make_opt(), _lm_loss, make_mesh({"dp": 1, "pp": 2}, device=device),
                         2, schedule=schedule, num_virtual=V, device=device)
    start = {k: v.cpu().clone() for k, v in tr.flat_params().items()}
    losses = [float(tr.train_step(i.to(device), y.to(device))) for i, y in batches]
    return (np.asarray(losses), start, {k: v.cpu() for k, v in tr.flat_params().items()},
            tr.opt_state)


def _gm_adam():
    from paddle_tpu_torch.distributed import DistributedStrategy, Fleet, UserDefinedRoleMaker

    return Fleet().init(UserDefinedRoleMaker()).distributed_optimizer(
        Adam(1e-3), DistributedStrategy(gradient_merge=True, gradient_merge_configs={"k_steps": 2}))


def _batches():
    rng = np.random.default_rng(64)
    return [tuple(torch.from_numpy(rng.integers(0, SMALL["vocab_size"], (4, 64)))
                  for _ in range(2)) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["f_then_b", "1f1b", "interleave"])
def test_pipeline_card_matches_cpu(schedule):
    """SGD(0.1), 2 steps: an update is the gradient's, so it agrees to
    rounding (Adam's first step is ±lr, see the GradientMerge test)."""
    gl, w0, gp, _ = _pipe_run(torch.device("cuda"), schedule, lambda: SGD(0.1), _batches())
    cl, c0, cp, _ = _pipe_run(torch.device("cpu"), schedule, lambda: SGD(0.1), _batches())
    assert all(torch.equal(w0[k], c0[k]) for k in w0)
    np.testing.assert_allclose(gl, cl, rtol=TOL["loss"])
    H, D = SMALL["num_heads"], SMALL["hidden_size"] // SMALL["num_heads"]
    for k, s in w0.items():
        dg, dc = gp[k] - s, cp[k] - s
        if k.endswith("attn.qkv_b"):
            dg, dc = (d.reshape(-1, H, 3, D)[:, :, [0, 2]] for d in (dg, dc))
        if float(dc.norm()) > 0:
            assert float((dg - dc).norm() / dc.norm()) <= TOL["update"], k


@pytest.mark.cuda
def test_gradient_merge_chain_card_matches_cpu():
    """fleet's GradientMerge chain (k 2) over Adam(1e-3) under 1f1b: a held
    step, then an apply step; Adam's moments within 1e-2 of their norm (the
    gradients differ by up to 2.1e-3 of theirs under SGD on the H100), the
    update within 1e-3·lr where |m| is at least 1e-3 of its tensor's
    largest (an element whose gradient is within rounding of 0 may move
    by ±lr either way)."""
    gl, w0, gp, gs = _pipe_run(torch.device("cuda"), "1f1b", _gm_adam, _batches())
    cl, c0, cp, cs = _pipe_run(torch.device("cpu"), "1f1b", _gm_adam, _batches())
    np.testing.assert_allclose(gl, cl, rtol=TOL["loss"])
    for k, s in w0.items():
        for slot in ("m", "v"):
            a, b = gs["inner"][slot][k].cpu(), cs["inner"][slot][k]
            assert float((a - b).norm()) <= 1e-2 * float(b.norm()), (k, slot)
        m = cs["inner"]["m"][k]
        big = m.abs() >= 1e-3 * m.abs().max()
        assert float(((gp[k] - s) - (cp[k] - s))[big].abs().max()) <= 1e-3 * 1e-3, k


def _graph():
    """Two 6-cliques and a bridge, the path 12 → 13 → 14 (a sink) and the
    isolated node 15: (the table, the nodes, the adjacency)."""
    g = GraphTable(shard_num=4, seed=0)
    k = 6
    src = [b + i for b in (0, k) for i in range(k) for j in range(k) if i != j] + [0, k, 12, 13]
    dst = [b + j for b in (0, k) for i in range(k) for j in range(k) if i != j] + [k, 0, 13, 14]
    g.add_graph_node(list(range(16)))
    g.add_edges(src, dst)
    adj = {}
    for a, b in zip(src, dst):
        adj.setdefault(a, set()).add(b)
    return g, np.arange(16, dtype=np.uint64), adj


def _dw_cache(device, nodes):
    sgd = SGDRuleConfig(learning_rate=0.3, initial_g2sum=1.0)
    table = MemorySparseTable(TableConfig(shard_num=4, accessor_config=AccessorConfig(
        embedx_dim=16, embedx_threshold=0.0, sgd=sgd)))
    cfg = CacheConfig(capacity=1 << 7, embedx_dim=16, embedx_threshold=0.0, sgd=sgd)
    ge.init_node_embeddings(table, nodes, np.random.default_rng(11), scale=0.1)
    cache = HbmEmbeddingCache(table, cfg, device=device, device_map=True)
    cache.begin_pass(np.concatenate([ge.tag_center(nodes), ge.tag_context(nodes)]))
    return table, cache, cfg


@pytest.mark.cuda
def test_deepwalk_step_card_matches_cpu_on_the_same_draws(monkeypatch):
    g, nodes, _ = _graph()
    cpu_graph = DeviceGraph.from_graph_table(g, 8, device="cpu")
    B, L, W, K = 32, 6, 2, 3
    starts = torch.from_numpy(np.random.default_rng(1).integers(0, 16, B))
    walk = DeviceGraph.random_walk(cpu_graph.state, torch.Generator().manual_seed(2),
                                   torch.zeros_like(starts), starts, L)
    neg = torch.from_numpy(np.random.default_rng(3).integers(0, 16, (B * L * 2 * W, K)))
    got = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        monkeypatch.setattr(DeviceGraph, "random_walk",
                            staticmethod(lambda *a, d=dev: tuple(t.to(d) for t in walk)))
        monkeypatch.setattr(ge, "_negative_indices", lambda gen, n, k, p, d: neg.to(d))
        _, cache, cfg = _dw_cache(dev, nodes)
        start = {k: v.cpu().clone() for k, v in cache.state.items()}
        step = make_deepwalk_train_step(DeviceGraph.from_graph_table(g, 8, device=dev), cfg,
                                        DeepWalkConfig(L, W, K, 16),
                                        pool_lo=nodes.astype(np.uint32))
        cache.state, loss = step(cache.state, cache.device_map.state, starts.to(dev),
                                 torch.Generator(dev).manual_seed(0))
        got[name] = {"start": start, "loss": float(loss),
                     "state": {k: v.cpu() for k, v in cache.state.items()}}
    assert all(torch.equal(got["cuda"]["start"][k], v) for k, v in got["cpu"]["start"].items())
    np.testing.assert_allclose(got["cuda"]["loss"], got["cpu"]["loss"], rtol=1e-5)
    for k, v in got["cpu"]["state"].items():
        np.testing.assert_allclose(got["cuda"]["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_walks_on_the_card_follow_edges_and_freeze():
    g, nodes, adj = _graph()
    dg = DeviceGraph.from_graph_table(g, 8, device="cuda")
    starts = torch.arange(16, device="cuda")
    wh, wl, live = DeviceGraph.random_walk(dg.state, torch.Generator("cuda").manual_seed(0),
                                           torch.zeros_like(starts), starts, 12)
    wl, live = wl.cpu().numpy(), live.cpu().numpy()
    assert (wh.cpu().numpy() == 0).all()
    for w, lv in zip(wl, live):
        for t in range(12):
            assert (w[t + 1] in adj.get(w[t], ())) if lv[t + 1] else (w[t + 1] == w[t])
    assert not live[14, 1:].any() and not live[15, 1:].any()   # the sink and the isolated node


@pytest.mark.cuda
def test_heter_pipeline_with_a_card_step_equals_a_serial_replay():
    def workload():
        table = MemorySparseTable(TableConfig(shard_num=4,
                                              accessor_config=AccessorConfig(embedx_dim=4)))
        lin = torch.nn.Linear(25, 1).cuda()
        torch.nn.init.constant_(lin.weight, 0.01)
        torch.nn.init.zeros_(lin.bias)
        order, lock = [], threading.Lock()

        def pull(b):
            i, keys, y = b
            with lock:
                p = table.pull_sparse(keys.ravel())
                order.append(("pull", i))
            return i, keys, p[:, 2:].reshape(len(keys), 25), y

        def step(x):
            i, keys, emb, y = x
            e = torch.from_numpy(np.ascontiguousarray(emb)).cuda().requires_grad_(True)
            loss = ((lin(e)[:, 0] - torch.from_numpy(y).cuda()) ** 2).mean()
            g = torch.autograd.grad(loss, [e, *lin.parameters()])
            with torch.no_grad():
                for p, gp in zip(lin.parameters(), g[1:]):
                    p -= 0.1 * gp
            return i, keys, g[0].cpu().numpy()

        def push(x):
            i, keys, ge_ = x
            vals = np.zeros((keys.size, 8), np.float32)
            vals[:, 1] = 1.0
            vals[:, 3:] = ge_.reshape(keys.size, 5)
            with lock:
                table.push_sparse(keys.ravel(), vals)
                order.append(("push", i))
            return i

        return (pull, step, push), table, lin, order

    rng = np.random.default_rng(0)
    batches = [(i, rng.integers(1, 300, (64, 5)).astype(np.uint64),
                rng.random(64).astype(np.float32)) for i in range(10)]
    fns, table, lin, order = workload()
    out = HeterPipelineTrainer([SectionConfig(f) for f in fns], channel_capacity=2).run(batches)
    assert out == list(range(10))
    s_fns, s_table, s_lin, _ = workload()
    pulled, trained = {}, 0
    for op, i in order:
        if op == "pull":
            pulled[i] = s_fns[0](batches[i])
            continue
        while trained <= i:
            pulled[trained] = s_fns[1](pulled[trained])
            trained += 1
        s_fns[2](pulled[i])
    keys = np.unique(np.concatenate([b[1].ravel() for b in batches]))
    np.testing.assert_array_equal(table.export_full(keys)[0], s_table.export_full(keys)[0])
    for p, q in zip(lin.parameters(), s_lin.parameters()):
        assert torch.equal(p, q)
