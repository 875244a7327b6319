"""The port's auto-parallel (``paddle_tpu_torch.distributed.auto_parallel``)
against the JAX package's on the 8-device CPU mesh: ``choose_strategy``'s
candidate lists field for field (an MLP, a conv chain, a two-tower model,
ERNIE small and at ``chip_smoke.ERNIE_CFG``'s width traced on ``meta``
tensors against ``jax.ShapeDtypeStruct``), ``plan_strategy``,
``estimate_plan_cost``, ``Engine.fit`` losses with weights carried across
(replicated, hinted, ``plan="auto"``, stage 1, save/load into another
mesh, the pp > 1 refusal), and the plan bridge's first loss against the
serial model. Both packages get the JAX package's ``ClusterSpec`` values
and the same budgets. A ``Linear`` weight's dims map ``[in, out]`` ↔
``[out, in]`` (``test_torch_completion.py``'s helpers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import auto_parallel as jauto
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import ernie_params_from_jax, recsys_params_from_jax
from paddle_tpu_torch.core.enforce import EnforceNotMet, UnavailableError
from paddle_tpu_torch.distributed import auto_parallel as tauto
from paddle_tpu_torch.nn import functional as TF
from test_torch_completion import _canon, build, jax_dm_for_port, port_spec_as_jax

#: the JAX package's ClusterSpec defaults, given to both packages
JAX_CLUSTER = dict(ici_gbytes_per_s=90.0, dcn_gbytes_per_s=6.0, device_tflops=197.0)
ERNIE_CFG = dict(vocab_size=32768, hidden_size=1024, num_heads=16, ffn_size=4096,
                 num_layers=8, max_seq_len=512)
# Engine losses: the JAX test's tolerance (GSPMD over 8 CPU devices against
# one process: the sums of the dp-sharded batch run in another order)
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)


def _clusters(**kw):
    return jauto.ClusterSpec(**JAX_CLUSTER, **kw), tauto.ClusterSpec(**JAX_CLUSTER, **kw)


def _pbytes(model):
    return sum(int(np.prod(p.shape)) * 4 for _, p in model.named_parameters())


def _jax_ernie(**cfg):
    from paddle_tpu.models.ernie import Ernie, ErnieConfig

    pt.seed(0)
    return Ernie(ErnieConfig(**cfg, mp_axis=None, cp_axis=None, ep_axis=None))


def _port_ernie(device="cpu", **cfg):
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig

    with torch.device(device):
        return Ernie(ErnieConfig(**cfg, mp_axis=None, cp_axis=None, ep_axis=None))


ODD_ERNIE = dict(vocab_size=101, hidden_size=33, num_heads=3, ffn_size=55, num_layers=4,
                 max_seq_len=16, dropout=0.0)


def _pair(kind, **kw):
    jm, jins, _ = build(kind, True, **kw)
    tm, tins, lin = build(kind, False, **kw)
    return jm, jins, tm, tins, lin


def _plan_case(name):
    """(JAX model, JAX inputs or None, port model, port inputs or None,
    Linear names, choose_strategy kwargs)."""
    if name in ("ernie_full_width", "ernie_odd_pp"):
        cfg = ERNIE_CFG if name == "ernie_full_width" else ODD_ERNIE
        seq = 512 if name == "ernie_full_width" else 16
        jm = _jax_ernie(**cfg)
        tm = _port_ernie("meta", **cfg)
        jins = [jax.ShapeDtypeStruct((4, seq), np.int32)]
        tins = [torch.empty(4, seq, dtype=torch.int64, device="meta")]
        kw = dict(batch_tokens=4 * seq, per_device_bytes=_pbytes(jm) * 4.0 / 2 * 1.01,
                  allow_sh=False)
        return jm, jins, tm, tins, set(), kw
    kind, mkw, traced, kw = {
        "mlp_roomy": ("mlp", {}, False, dict(batch_tokens=4096, per_device_bytes=16e9)),
        "mlp_tight": ("mlp", {}, False, dict(batch_tokens=64, per_device_bytes="x2.5")),
        "mlp_nothing_fits": ("mlp", {}, False, dict(batch_tokens=64, per_device_bytes=1.0)),
        "mlp_nothing_fits_no_sh": ("mlp", {}, False, dict(batch_tokens=64, per_device_bytes=1.0,
                                                         allow_sh=False)),
        "mlp_traced_tight": ("mlp", {}, True, dict(batch_tokens=64, per_device_bytes="x2.5")),
        "conv_traced": ("conv8", {}, True,
                        dict(batch_tokens=4096, per_device_bytes="x2.5")),
        "two_tower_traced": ("two_tower", {}, True, dict(batch_tokens=256,
                                                         per_device_bytes="x2.5")),
        "stacked_odd_pp": ("stacked33", {}, True,
                           dict(batch_tokens=64, per_device_bytes="x2.02", allow_sh=False)),
        "ernie_small_traced": ("ernie", {}, True, dict(batch_tokens=32,
                                                        per_device_bytes="x2.5")),
    }[name]
    jm, jins, tm, tins, lin = _pair(kind, **mkw)
    budget = kw["per_device_bytes"]
    if isinstance(budget, str):
        kw = dict(kw, per_device_bytes=_pbytes(jm) * float(budget[1:]))
    return jm, jins if traced else None, tm, tins if traced else None, lin, kw


PLAN_CASES = ["mlp_roomy", "mlp_tight", "mlp_nothing_fits", "mlp_nothing_fits_no_sh",
              "mlp_traced_tight", "conv_traced", "two_tower_traced", "stacked_odd_pp",
              "ernie_small_traced", "ernie_odd_pp", "ernie_full_width"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_choose_strategy_candidates_match_jax(case):
    jm, jins, tm, tins, lin, kw = _plan_case(case)
    jcl, tcl = _clusters()
    jmesh, jann, jc = jauto.choose_strategy(jm, n_devices=8, cluster=jcl,
                                            example_inputs=jins, **kw)
    tmesh, tann, tc = tauto.choose_strategy(tm, n_devices=8, cluster=tcl,
                                            example_inputs=tins, **kw)
    assert tc == jc
    assert (tuple(tmesh.shape), list(tmesh.dim_names)) == (tuple(jmesh.shape),
                                                           list(jmesh.dim_names))
    assert list(tann) == list(jann)
    assert {k: jax_dm_for_port(k, v, lin) for k, v in tann.items()} == \
        {k: list(v) for k, v in jann.items()}


def test_full_width_ernie_plan_pipelines_under_the_split_budget():
    _, _, tm, tins, _, kw = _plan_case("ernie_full_width")
    mesh, ann, cands = tauto.choose_strategy(tm, n_devices=4, example_inputs=tins, **kw)
    dims = dict(zip(mesh.dim_names, mesh.shape))
    assert dims["pp"] >= 2 and ann == {} or dims["mp"] >= 2, dims
    assert sum(bool(c.get("chosen")) for c in cands) == 1
    assert all(p.device.type == "meta" for p in tm.parameters())


@pytest.mark.parametrize("case", ["roomy", "tight", "six_devices", "unshardable", "embedding"])
def test_plan_strategy_matches_jax(case):
    if case == "unshardable":
        jm, _, tm, _, lin = _pair("mlp", d=7, h=9, out=3)
    elif case == "embedding":
        jm, _, tm, _, lin = _pair("emb")
    else:
        jm, _, tm, _, lin = _pair("mlp")
    budget = {"roomy": 1e9, "unshardable": 1.0}.get(case, _pbytes(jm) * 2.5)
    if case == "six_devices":
        budget = _pbytes(jm)
    n = 6 if case == "six_devices" else 8
    jmesh, jann = jauto.plan_strategy(jm, n_devices=n, per_device_bytes=budget)
    tmesh, tann = tauto.plan_strategy(tm, n_devices=n, per_device_bytes=budget)
    assert tuple(tmesh.shape) == tuple(jmesh.shape)
    assert {k: jax_dm_for_port(k, v, lin) for k, v in tann.items()} == \
        {k: list(v) for k, v in jann.items()}


COST_CASES = {
    "lone_col": ("mlp", (4, 2), ("dp", "mp"), {"fc2.weight": [-1, 1]}, {}),
    "paired": ("mlp", (4, 2), ("dp", "mp"), {"fc2.weight": [-1, 1], "fc3.weight": [1, -1]}, {}),
    "row_batch_6400": ("mlp", (4, 2), ("dp", "mp"), {"fc2.weight": [1, -1]},
                       dict(batch_tokens=6400)),
    "dp_axis_shard": ("mlp", (4, 2), ("dp", "mp"), {"fc2.weight": [0, -1]}, {}),
    "conv_pair": ("conv8", (2, 4), ("dp", "mp"), {"c1.weight": [1, -1, -1, -1],
                                                 "c2.weight": [-1, 1, -1, -1]}, {}),
    "cross_host": ("mlp", (8, 1), ("dp", "mp"), {}, dict(hosts=2)),
    "sh3_recompute": ("mlp", (8, 1, 1), ("dp", "mp", "pp"), {}, dict(sh=3, recompute=True)),
    "sh2": ("mlp", (8, 1, 1), ("dp", "mp", "pp"), {}, dict(sh=2)),
    "bubble_2": ("stacked", (2, 1, 4), ("dp", "mp", "pp"), {}, dict(microbatches=2)),
    "bubble_32": ("stacked", (2, 1, 4), ("dp", "mp", "pp"), {}, dict(microbatches=32)),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_estimate_plan_cost_matches_jax(case):
    kind, shape, names, ann, kw = COST_CASES[case]
    jm, _, tm, _, lin = _pair(kind)
    kw = dict(kw)
    batch = kw.pop("batch_tokens", 4096)
    jcl, tcl = _clusters(hosts=kw.pop("hosts", 1))
    want = jauto.estimate_plan_cost(jm, jauto.ProcessMesh(shape=shape, dim_names=names), ann,
                                    batch, cluster=jcl, **kw)
    got = tauto.estimate_plan_cost(tm, tauto.ProcessMesh(shape=shape, dim_names=names),
                                   {k: jax_dm_for_port(k, v, lin) for k, v in ann.items()},
                                   batch, cluster=tcl, **kw)
    assert got == want


def test_cluster_defaults_are_the_h100s():
    c = tauto.ClusterSpec()
    assert (c.ici_gbytes_per_s, c.dcn_gbytes_per_s, c.device_tflops) == (450.0, 50.0, 989.0)
    assert tauto.H100_MEMORY_BYTES == 80e9


# -- Engine -------------------------------------------------------------------------


def _carry(jmodel, tmodel, ernie=False):
    named = {k: np.asarray(v) for k, v in jmodel.named_parameters()}
    conv = ernie_params_from_jax if ernie else recsys_params_from_jax
    tmodel.load_state_dict(conv(named), strict=True)
    return tmodel


def _mlp_data(n=4, seed=0, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, d)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    return [((x,), (y,))] * n


def _engines(jkw, tkw, kind="mlp", jopt_=lambda: jopt.SGD(0.1), topt_=lambda: topt.SGD(0.1),
             jloss=None, tloss=None):
    if kind == "ernie":
        jm = _jax_ernie(**ERNIE_SMALL_E)
        tm = _carry(jm, _port_ernie(**ERNIE_SMALL_E), ernie=True)
    else:
        jm, _, tm, _, _ = _pair(kind)
        _carry(jm, tm)
    je = jauto.Engine(jm, jloss or jnn.functional.cross_entropy, jopt_(), **jkw)
    te = tauto.Engine(tm, tloss or TF.cross_entropy, topt_(), device="cpu", **tkw)
    return je, te


ERNIE_SMALL_E = dict(vocab_size=128, hidden_size=32, num_heads=4, ffn_size=64, num_layers=2,
                     max_seq_len=16)


def _jlm(out, lbl):
    return jnn.functional.cross_entropy(out.reshape(-1, out.shape[-1]), lbl.reshape(-1))


def _tlm(out, lbl):
    return TF.cross_entropy(out.reshape(-1, out.shape[-1]), lbl.reshape(-1))


def _pm(jax_side, shape, names):
    return (jauto if jax_side else tauto).ProcessMesh(shape=shape, dim_names=names)


def test_engine_replicated_and_hinted_losses_match_jax():
    data = _mlp_data()
    je, te = _engines(dict(process_mesh=_pm(True, (2, 4), ("dp", "mp")),
                           batch_dim_mesh_axis="dp"),
                      dict(process_mesh=_pm(False, (2, 4), ("dp", "mp")),
                           batch_dim_mesh_axis="dp"))
    ref = je.fit(data)
    np.testing.assert_allclose(te.fit(data), ref, **LOSS_TOL)
    je, te = _engines(dict(process_mesh=_pm(True, (2, 4), ("dp", "mp")),
                           batch_dim_mesh_axis="dp", annotations={"fc2.weight": [-1, 1]}),
                      dict(process_mesh=_pm(False, (2, 4), ("dp", "mp")),
                           batch_dim_mesh_axis="dp", annotations={"fc2.weight": [1, -1]}))
    np.testing.assert_allclose(je.fit(data), ref, **LOSS_TOL)
    np.testing.assert_allclose(te.fit(data), ref, **LOSS_TOL)
    # the planned layouts: the column pair, its bias, the row partner
    specs = te.completion(data[0][0], data[0][1])["param_specs"]
    assert (specs["fc2.weight"], specs["fc2.bias"], specs["fc3.weight"]) == (
        ("mp",), ("mp",), (None, "mp"))
    assert te.completion()["input_shardings"][0]["params"] == specs


def test_engine_plan_auto_matches_jax():
    data = _mlp_data()
    je, te = _engines(dict(plan="auto", example_inputs=[jax.ShapeDtypeStruct((16, 16),
                                                                             np.float32)]),
                      dict(plan="auto", n_devices=8,
                           example_inputs=[torch.empty(16, 16, device="meta")]))
    assert tuple(te.process_mesh.shape) == tuple(je.process_mesh.shape)
    assert te.sharding_stage == je.sharding_stage
    np.testing.assert_allclose(te.fit(data), je.fit(data), **LOSS_TOL)
    with pytest.raises(Exception, match="auto"):
        tauto.Engine(te.model, TF.cross_entropy, topt.SGD(0.1), plan="auto", device="cpu",
                     process_mesh=_pm(False, (8,), ("dp",)))
    with pytest.raises(Exception, match="plan"):
        tauto.Engine(te.model, TF.cross_entropy, topt.SGD(0.1), plan="semi", device="cpu")


def test_engine_stage1_matches_jax_and_records_sharded_slots():
    data = _mlp_data(5)
    kw = dict(batch_dim_mesh_axis="dp", sharding_stage=1)
    je, te = _engines(dict(process_mesh=_pm(True, (8,), ("dp",)), **kw),
                      dict(process_mesh=_pm(False, (8,), ("dp",)), **kw),
                      jopt_=lambda: jopt.Adam(1e-2), topt_=lambda: topt.Adam(1e-2))
    np.testing.assert_allclose(te.fit(data), je.fit(data), **LOSS_TOL)
    slots = te.completion()["slot_specs"]
    assert "dp" in slots["fc1.weight"] and te.completion()["param_specs"]["fc1.weight"] == ()
    with pytest.raises(Exception, match="stage"):
        tauto.Engine(te.model, TF.cross_entropy, topt.SGD(0.1), sharding_stage=2, device="cpu")


def test_engine_ernie_two_hints_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
    labels = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
    data = [((ids,), (labels,))] * 3
    hints = {"blocks.0.attn.qkv_w": [-1, 1], "blocks.0.ffn.w_in": [-1, 1]}
    je, te = _engines(
        dict(process_mesh=_pm(True, (2, 4), ("dp", "mp")), batch_dim_mesh_axis="dp",
             annotations=hints, example_inputs=[jax.ShapeDtypeStruct((2, 16), np.int32)]),
        dict(process_mesh=_pm(False, (2, 4), ("dp", "mp")), batch_dim_mesh_axis="dp",
             annotations=hints, example_inputs=[torch.empty(2, 16, dtype=torch.int64,
                                                            device="meta")]),
        kind="ernie", jopt_=lambda: jopt.SGD(0.05), topt_=lambda: topt.SGD(0.05),
        jloss=_jlm, tloss=_tlm)
    np.testing.assert_allclose(te.fit(data), je.fit(data), **LOSS_TOL)
    assert te.param_specs["blocks.1.ffn.w_out"] == ("mp",)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_engine_save_load_into_another_mesh_matches_jax(tmp_path):
    """A replicated engine's snapshot loads into an engine with hints on
    another mesh in both packages; the predictions carry over and the two
    packages' trajectories agree before and after."""
    x, y = _mlp_data(1, seed=1)[0]
    adam = dict(jopt_=lambda: jopt.Adam(1e-2), topt_=lambda: topt.Adam(1e-2))
    src = _engines(dict(process_mesh=_pm(True, (8,), ("dp",))),
                   dict(process_mesh=_pm(False, (8,), ("dp",))), **adam)
    dst = _engines(dict(process_mesh=_pm(True, (2, 4), ("dp", "mp")), batch_dim_mesh_axis="dp",
                        annotations={"fc2.weight": [-1, 1]}),
                   dict(process_mesh=_pm(False, (2, 4), ("dp", "mp")), batch_dim_mesh_axis="dp",
                        annotations={"fc2.weight": [1, -1]}), **adam)
    first = [e.fit([(x, y)] * 2) for e in src]
    np.testing.assert_allclose(first[1], first[0], **LOSS_TOL)
    for e, d, tag in zip(src, dst, ("jax", "port")):
        e.save(str(tmp_path / tag / "snap"))
        d.load(str(tmp_path / tag / "snap"))
        np.testing.assert_allclose(_np(d.predict(x)), _np(e.predict(x)), atol=1e-5)
    assert dst[1].param_specs["fc2.weight"] == ("mp",)
    np.testing.assert_allclose(dst[1].fit([(x, y)] * 2), dst[0].fit([(x, y)] * 2), **LOSS_TOL)


def test_engine_save_load_resumes_the_same_trajectory(tmp_path):
    data = _mlp_data(3)

    def build():
        _, te = _engines({}, dict(process_mesh=_pm(False, (2, 4), ("dp", "mp")),
                                  batch_dim_mesh_axis="dp", annotations={"fc2.weight": [1, -1]}),
                         jopt_=lambda: jopt.Adam(1e-2), topt_=lambda: topt.Adam(1e-2))
        return te

    e = build()
    e.fit(data)
    e.save(str(tmp_path / "snap"))
    cont = e.fit(data)
    e2 = build()
    e2.load(str(tmp_path / "snap"))
    assert e2.completion()["param_specs"] == e.completion()["param_specs"]
    assert e2.fit(data) == cont   # bitwise: the same ops on the same state
    assert np.isfinite(e2.evaluate(data))


def test_engine_rejects_pp_mesh_loudly():
    _, te = _engines({}, dict(process_mesh=_pm(False, (2, 1, 4), ("dp", "mp", "pp")),
                              batch_dim_mesh_axis="dp"))
    with pytest.raises(EnforceNotMet, match="pipeline"):
        te.prepare()


# -- the plan bridge ------------------------------------------------------------------


def test_plan_bridge_first_loss_matches_the_serial_model():
    """An ERNIE whose dims mp cannot shard gets a pp plan (the same from
    both packages); ``hybrid_trainer_from_plan`` runs it over logical
    ranks and its first loss equals the serial model's on the trainer's
    own weights (rtol 1e-5); training proceeds."""
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig

    _, jins, tm, tins, _, kw = _plan_case("ernie_odd_pp")
    jm = _jax_ernie(**ODD_ERNIE)
    kw = dict(kw, batch_tokens=64)
    jmesh, _, _ = jauto.choose_strategy(jm, n_devices=8, example_inputs=jins, **kw)
    mesh, ann, _ = tauto.choose_strategy(tm, n_devices=8, example_inputs=tins, **kw)
    dims = dict(zip(mesh.dim_names, mesh.shape))
    assert tuple(mesh.shape) == tuple(jmesh.shape)
    assert dims["pp"] >= 2 and dims["mp"] == 1 and ann == {}, dims
    trainer = tauto.hybrid_trainer_from_plan(ErnieConfig(**ODD_ERNIE), mesh, topt.Adam(3e-3),
                                             num_micro=2, device="cpu")
    rng = np.random.default_rng(0)
    batch = 2 * dims["dp"]
    ids = torch.from_numpy(rng.integers(0, ODD_ERNIE["vocab_size"], (batch, 16)))
    labels = torch.from_numpy(rng.integers(0, ODD_ERNIE["vocab_size"], (batch, 16)))
    serial = Ernie(ErnieConfig(**ODD_ERNIE))
    serial.load_state_dict(trainer.serial_state_dict())
    with torch.no_grad():
        want = float(serial.loss(ids, labels))
    first = float(trainer.train_step(ids, labels))
    np.testing.assert_allclose(first, want, rtol=1e-5)
    losses = [first] + [float(trainer.train_step(ids, labels)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    with pytest.raises(UnavailableError, match="item 7"):
        tauto.hybrid_trainer_from_plan(ErnieConfig(**ODD_ERNIE), mesh, topt.Adam(3e-3),
                                       sh=2, device="cpu")


# -- shard_tensor and its kin ---------------------------------------------------------


def test_shard_ops_record_named_sharding_layouts():
    pm = tauto.ProcessMesh(shape=(2, 4), dim_names=("dp", "mp"), device="cpu")
    x = tauto.shard_tensor(np.zeros((16, 4), np.float32), pm, [0, None])
    assert tauto.layout_of(x) == ("dp", None) and x.device.type == "cpu"
    assert tauto.layout_of(tauto.shard_tensor(np.zeros(4), pm, [-1])) == (None,)
    fn = tauto.shard_op(lambda t: (t + 1, t * 2), pm, [[None, 1], [0, None]])
    a, b = fn(torch.zeros(8, 2))
    assert (tauto.layout_of(a), tauto.layout_of(b)) == ((None, "mp"), ("dp", None))
    assert torch.equal(a, torch.ones(8, 2))
    other = tauto.ProcessMesh(shape=(2, 2), dim_names=("p", "q"), device="cpu")
    v = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    moved = tauto.reshard(tauto.shard_tensor(v, pm, [0, None]), other, [1, 0])
    assert tauto.layout_of(moved) == ("q", "p") and torch.equal(moved, v)
    with pytest.raises(Exception):
        tauto.annotate(v, pm, [5, None])
    assert tauto.ProcessMesh(shape=(2, 4), dim_names=("x", "y"), device="cpu").mesh.shape == {
        "x": 2, "y": 4}
