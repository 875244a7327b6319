"""The port's ERNIE slice (model, functional ops, Trainer) against the JAX
package, on the CPU.

Inputs and token ids come from numpy seeds; the port's weights are the
JAX model's, converted name for name (``convert.ernie_params_from_jax``).
The JAX flash kernels run in interpret mode, the port's as their plain
versions. Tolerances, each with its reason:

- f32 paths (einsum attention, the layers, CE): 2e-6 absolute on
  activations and loss (the frameworks' f32 matmuls sum in other orders),
  rtol 1e-4 on gradients.
- ``attn_impl="flash"`` (bf16 operands, P and dS rounded to bf16): where
  a P or dS value sits at a bf16 rounding boundary the two frameworks
  can round it apart by 2^-8 of itself, so activations agree to 1e-4 and
  gradients to 1e-2 of their largest element.
- Trainer trajectories (3 steps of Adam from the same weights and
  batches): losses to rtol 1e-6 (einsum) / 1e-4 (flash). Adam divides by
  sqrt(v), so an element whose true gradient is near zero moves by up to
  lr whatever the sign of its rounding noise: parameters are compared by
  the update they received, ||Δport − Δjax|| / ||Δjax|| per tensor,
  5e-3 (einsum) / 5e-2 (flash), with the key bias left out — adding a
  constant to every key of a row leaves its softmax unchanged, so that
  bias has a true gradient of 0 and trains on rounding noise alone in
  both packages. The Adam slots leave it out the same way (rtol 2e-3);
  instead its slots must be noise in both: below 1e-6 of the tensor's
  largest |slot| value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.executor import Trainer as JaxTrainer
from paddle_tpu.models import ernie as jernie
from paddle_tpu_torch.convert import adam_state_from_jax, ernie_params_from_jax
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.models import ernie
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam

SMALL = dict(vocab_size=64, hidden_size=32, num_heads=4, ffn_size=64, num_layers=2,
             max_seq_len=16)
B, L = 2, 16


def _pair(seed=0, **over):
    """(JAX Ernie, port Ernie with the same weights, numpy weights)."""
    cfg = {**SMALL, **over}
    pt.seed(seed)
    jm = jernie.Ernie(jernie.ErnieConfig(**cfg))
    w = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = ernie.Ernie(ernie.ErnieConfig(**cfg))
    tm.load_state_dict(ernie_params_from_jax(w))
    return jm, tm, w


def _batch(rng, vocab=SMALL["vocab_size"]):
    return (rng.integers(0, vocab, (B, L)).astype(np.int32),
            rng.integers(0, vocab, (B, L)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64) if np.asarray(a).dtype.kind == "i"
                            else np.asarray(a))


# -- functional ops ------------------------------------------------------------


def test_functional_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 7, 16)).astype(np.float32) * 3
    w, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(F.gelu(_t(x)).numpy(), np.asarray(jnn.functional.gelu(x)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(F.layer_norm(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jnn.functional.layer_norm(x, w, b)), rtol=0, atol=2e-6)
    logits = rng.normal(size=(12, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 12).astype(np.int32)
    labels[[1, 5]] = -100                                   # ignored tokens
    for red in ("mean", "sum", "none"):
        got = F.cross_entropy(_t(logits), _t(labels), reduction=red).numpy()
        want = np.asarray(jnn.functional.cross_entropy(logits, labels, reduction=red))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, err_msg=red)
    soft = np.abs(rng.normal(size=(12, 10))).astype(np.float32)
    np.testing.assert_allclose(
        F.cross_entropy(_t(logits), _t(soft), soft_label=True).numpy(),
        np.asarray(jnn.functional.cross_entropy(logits, soft, soft_label=True)),
        rtol=0, atol=2e-6)


def test_dropout_draws_from_its_generator():
    x = torch.ones(4096)
    assert F.dropout(x, 0.0, training=True) is x
    assert F.dropout(x, 0.5, training=False) is x
    with pytest.raises(InvalidArgumentError, match="Generator"):
        F.dropout(x, 0.5, training=True)
    a = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    b = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03   # 4096 draws: ~4.5 sigma
    d = Dropout(0.25)
    d.generator = torch.Generator().manual_seed(3)
    assert torch.equal(d(x), a)
    assert torch.equal(d.eval()(x), x)
    ln = LayerNorm(16)
    assert ln.epsilon == 1e-5 and [n for n, _ in ln.named_parameters()] == ["weight", "bias"]


# -- modules and the whole model -----------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_modules_match_jax(causal):
    """Embedding, each block (einsum and flash attention), head and the
    per-token CE, forward, from the same weights and activations."""
    jm, tm, _ = _pair(causal=causal)
    ids, labels = _batch(np.random.default_rng(1))
    x = np.asarray(jm.embed(jnp.asarray(ids)))
    np.testing.assert_allclose(tm.embed(_t(ids)).detach().numpy(), x, rtol=0, atol=2e-6)
    for impl, tol in (("einsum", 2e-6), ("flash", 1e-4)):
        for jb, tb in zip(jm.blocks, tm.blocks):
            jb.attn.cfg.attn_impl = impl
            tb.attn.cfg.attn_impl = impl
            np.testing.assert_allclose(tb(_t(x)).detach().numpy(), np.asarray(jb(jnp.asarray(x))),
                                       rtol=0, atol=tol, err_msg=impl)
    logits = np.asarray(jm.head(jnp.asarray(x)))
    np.testing.assert_allclose(tm.head(_t(x)).detach().numpy(), logits, rtol=0, atol=2e-6)
    ce = ernie.parallel_cross_entropy(_t(logits), _t(labels), SMALL["vocab_size"]).numpy()
    np.testing.assert_allclose(
        ce, np.asarray(jernie.parallel_cross_entropy(logits, labels, SMALL["vocab_size"])),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_model_loss_and_grads_match_jax_grad(impl):
    jm, tm, w = _pair(attn_impl=impl)
    ids, labels = _batch(np.random.default_rng(2))

    def jloss(params):
        logits, _ = jnn.functional_call(jm, {"params": params, "buffers": {}}, jnp.asarray(ids))
        return jnp.mean(jernie.parallel_cross_entropy(logits, jnp.asarray(labels),
                                                      SMALL["vocab_size"]))

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in w.items()})
    loss = tm.loss(_t(ids), _t(labels))
    names = [k for k, _ in tm.named_parameters()]
    tg = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6 if impl == "einsum" else 1e-5)
    for k in names:
        g, want = tg[k].numpy(), np.asarray(jg[k])
        if impl == "einsum":
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-7, err_msg=k)
        else:
            assert np.abs(g - want).max() <= 1e-2 * np.abs(want).max() + 1e-7, k


def _key_bias_dropped(name, a, cfg):
    if not name.endswith("attn.qkv_b"):
        return a.ravel()
    H, D = cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"]
    return a.reshape(H, 3, D)[:, [0, 2], :].ravel()       # head-major q/k/v: drop k


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_trainer_three_steps_match_jax_trainer(impl, causal):
    """3 Trainer steps of Adam(1e-3) on lm_loss, from the same weights and
    batches, against the JAX Trainer; then predict and state_dict."""
    lr = 1e-3
    jm, tm, w0 = _pair(attn_impl=impl, causal=causal)

    def jax_lm_loss(out, labels):
        return jnn.functional.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1))

    def lm_loss(out, labels):
        return F.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1))

    jt = JaxTrainer(jm, jopt.Adam(lr), jax_lm_loss)
    tt = Trainer(tm, Adam(lr), lm_loss, device="cpu")
    rng = np.random.default_rng(3)
    jl, tl = [], []
    for _ in range(3):
        ids, labels = _batch(rng)
        jl.append(float(jt.train_step(jnp.asarray(ids), jnp.asarray(labels))))
        loss = tt.train_step(_t(ids), _t(labels))
        assert loss.device.type == "cpu" and loss.dim() == 0
        tl.append(float(loss))
    assert tt.global_step == 3 and int(tt.opt_state["step"]) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-6 if impl == "einsum" else 1e-4)
    tol = 5e-3 if impl == "einsum" else 5e-2
    for k, p0 in w0.items():
        want = _key_bias_dropped(k, np.asarray(jt.state["params"][k]) - p0, SMALL)
        got = _key_bias_dropped(k, tt.state["params"][k].numpy() - p0, SMALL)
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), k
    ids, _ = _batch(rng)
    np.testing.assert_allclose(tt.predict(_t(ids)).numpy(), np.asarray(jt.predict(jnp.asarray(ids))),
                               rtol=0, atol=2e-4 if impl == "einsum" else 1e-2)
    sd = tt.state_dict()
    assert set(sd) == set(w0) and torch.equal(sd["head.w"], tt.state["params"]["head.w"])
    # the JAX Adam state converts name for name, untransposed (ERNIE's x @ w)
    st = adam_state_from_jax(jt.opt_state, params_from_jax=ernie_params_from_jax)
    assert int(st["step"]) == 3
    for k in w0:
        assert tuple(st["m"][k].shape) == w0[k].shape == tuple(tt.opt_state["m"][k].shape)
    if impl == "einsum":
        for slot in ("m", "v"):
            for k in w0:
                ref, got = st[slot][k].numpy(), tt.opt_state[slot][k].numpy()
                np.testing.assert_allclose(_key_bias_dropped(k, ref, SMALL),
                                           _key_bias_dropped(k, got, SMALL),
                                           rtol=2e-3, atol=1e-9, err_msg=f"{slot} {k}")
                if k.endswith("attn.qkv_b"):
                    # the key bias's gradient is 0 in exact arithmetic
                    # (softmax ignores a constant added to a query row's
                    # scores): its slots are rounding noise in both packages
                    H = SMALL["num_heads"]
                    for a in (ref, got):
                        key = a.reshape(H, 3, -1)[:, 1, :]
                        assert np.abs(key).max() <= 1e-6 * np.abs(a).max(), f"{slot} {k}"


def test_out_of_slice_options_raise():
    with pytest.raises(InvalidArgumentError, match="MoE"):
        ernie.Ernie(ernie.ErnieConfig(**SMALL, num_experts=4))
    with pytest.raises(InvalidArgumentError, match="attn_impl"):
        ernie.Ernie(ernie.ErnieConfig(**SMALL, attn_impl="ring"))
    with pytest.raises(InvalidArgumentError, match="vocab-sharded"):
        ernie.parallel_cross_entropy(torch.zeros(2, 8), torch.zeros(2, dtype=torch.int64), 16)
    with pytest.raises(InvalidArgumentError, match="not ported"):
        ernie.partition_spec("head.w", None, None)
    model = ernie.Ernie(ernie.ErnieConfig(**SMALL))
    # amp is ported: True/"O1"/"O2" are accepted, an unknown level raises
    with pytest.raises(InvalidArgumentError, match="amp"):
        Trainer(model, Adam(), lambda o, y: o.sum(), amp="O3", device="cpu")
    tr = Trainer(model, Adam(), lambda o, y: o.sum(), device="cpu")
    with pytest.raises(InvalidArgumentError, match="data_feed"):
        tr.train_from_dataset(None)


def test_trainer_owns_the_dropout_generator():
    """Dropout draws from the trainer's seeded generator: two trainers with
    the same seed take the same steps, another seed does not."""
    cfg = ernie.ErnieConfig(**SMALL, dropout=0.1)
    ids, labels = (_t(a) for a in _batch(np.random.default_rng(5)))

    def run(seed):
        m = ernie.Ernie(cfg, generator=torch.Generator().manual_seed(0))
        tr = Trainer(m, Adam(1e-3), lambda o, y: F.cross_entropy(o.reshape(-1, o.shape[-1]),
                                                                y.reshape(-1)),
                     seed=seed, device="cpu")
        assert all(d.generator is tr.generator for d in m.modules() if isinstance(d, Dropout))
        return [float(tr.train_step(ids, labels)) for _ in range(2)]

    assert run(7) == run(7)
    assert run(7) != run(8)

