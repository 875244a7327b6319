"""The port's recurrent layers (``paddle_tpu_torch.nn.rnn``) against the
JAX package's ``nn.GRU``/``nn.LSTM``, on the CPU: the RNN half of
``tests/test_metrics_accuracy_rnn.py`` and the layer test of
``tests/test_gru4rec.py``.

The same weights (JAX ``[in, gates*H]`` layout, carried name for name by
``convert.recsys_params_from_jax``) and the same numpy inputs go through
both. Tolerances: outputs, final states and gradients (``jax.grad``
against ``torch.autograd``) within 1e-5 absolute; masking exact (padded
positions are exactly zero, a masked row's prefix equals the unmasked
run's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.nn.rnn import import_paddle_rnn_weight as jax_import
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import recsys_params_from_jax
from paddle_tpu_torch.nn.rnn import import_paddle_rnn_weight

TOL = 1e-5


def _pair(kind, D, H, layers, seed=0):
    pt.seed(seed)
    jm = getattr(jnn, kind)(D, H, num_layers=layers)
    tm = getattr(tnn, kind)(D, H, num_layers=layers)
    tm.load_state_dict(recsys_params_from_jax(
        {k: np.asarray(v) for k, v in jm.named_parameters()}))
    return jm, tm


def _state(jm):
    return {"params": dict(jm.named_parameters()), "buffers": {}}


def _flat(out):
    if isinstance(out, tuple):
        return [a for o in out for a in _flat(o)]
    return [out]


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_rnn_outputs_match_jax(kind, layers, masked):
    rng = np.random.default_rng(layers * 10 + masked)
    B, T, D, H = 4, 6, 5, 7
    jm, tm = _pair(kind, D, H, layers)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([6, 2, 0, 4]) if masked else None
    want = jm(jnp.asarray(x), None if lengths is None else jnp.asarray(lengths))
    got = tm(torch.from_numpy(x), None if lengths is None else torch.from_numpy(lengths))
    for w, g in zip(_flat(want), _flat(got)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_rnn_grads_match_jax(kind):
    """d(sum(out * c) + sum(h_n))/d(params, x) against ``jax.grad``."""
    rng = np.random.default_rng(5)
    B, T, D, H = 3, 5, 4, 6
    jm, tm = _pair(kind, D, H, 2, seed=1)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    c = rng.normal(size=(B, T, H)).astype(np.float32)
    lengths = np.array([5, 1, 3])

    def jloss(state, x):
        (out, fin), _ = jnn.functional_call(jm, state, x, jnp.asarray(lengths))
        h = fin if kind == "GRU" else fin[0]
        return jnp.sum(out * c) + jnp.sum(h)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(_state(jm), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, fin = tm(tx, torch.from_numpy(lengths))
    h = fin if kind == "GRU" else fin[0]
    loss = (out * torch.from_numpy(c)).sum() + h.sum()
    names = [k for k, _ in tm.named_parameters()]
    *gp, gx = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()] + [tx])
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg_x), atol=TOL, rtol=0)
    for k, g in zip(names, gp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p["params"][k]), atol=TOL, rtol=0,
                                   err_msg=k)


def test_gru_masking_and_shapes():
    """tests/test_gru4rec.py's layer test, on the port."""
    rng = np.random.default_rng(0)
    gru = tnn.GRU(4, 8, num_layers=2, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(3, 6, 4)).astype(np.float32))
    out, h = gru(x, torch.tensor([6, 2, 4]))
    assert out.shape == (3, 6, 8) and h.shape == (2, 3, 8)
    o = out.detach().numpy()
    assert (o[1, 2:] == 0).all() and (o[2, 4:] == 0).all()
    # the final state is the last real step's output
    np.testing.assert_array_equal(h.detach().numpy()[1][1], o[1, 1])
    lstm = tnn.LSTM(4, 8)
    o2, (h2, c2) = lstm(x, torch.tensor([6, 2, 4]))
    assert o2.shape == (3, 6, 8) and h2.shape == c2.shape == (1, 3, 8)
    assert (o2.detach().numpy()[1, 2:] == 0).all()


@pytest.mark.parametrize("kind,gates", [("GRU", 3), ("LSTM", 4)])
def test_rnn_shapes_and_state(kind, gates):
    B, T, D, H = 4, 6, 8, 10
    rnn = getattr(tnn, kind)(D, H, num_layers=2)
    out, _ = rnn(torch.from_numpy(np.random.default_rng(0).normal(size=(B, T, D))
                                  .astype(np.float32)))
    assert out.shape == (B, T, H)
    # the JAX package's [in, gates*H] layout
    assert rnn.w_ih_0.shape == (D, gates * H) and rnn.w_ih_1.shape == (H, gates * H)
    assert rnn.w_hh_0.shape == (H, gates * H) and rnn.b_ih_0.shape == (gates * H,)
    bound = 1.0 / np.sqrt(H)
    assert float(rnn.w_hh_1.detach().abs().max()) <= bound
    assert float(rnn.b_hh_0.detach().abs().max()) == 0.0


def test_rnn_length_mask_contract():
    """Positions at or past a length output zeros and carry the last real
    state; a masked row's prefix equals the unmasked run; length 0 keeps
    the zero state (cuDNN's packed sequences refuse it)."""
    B, T, D, H = 3, 5, 4, 6
    rnn = tnn.GRU(D, H, num_layers=1, generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32))
    out, h = rnn(x, lengths=torch.tensor([3, 5, 0]))
    assert (out[0, 3:] == 0).all() and (out[2] == 0).all() and (h[0, 2] == 0).all()
    assert float(out[1, 3:].abs().sum()) > 0
    out_full, _ = rnn(x)
    torch.testing.assert_close(out[0, :3], out_full[0, :3], rtol=0, atol=0)
    torch.testing.assert_close(h[0, 0], out_full[0, 2], rtol=0, atol=0)


def test_import_paddle_rnn_weight_roundtrip():
    """A reference-layout [gates*H, in] weight imports to the JAX
    package's result exactly and drives the same outputs in both."""
    D, H = 4, 6
    rng = np.random.default_rng(2)
    w_ref = rng.normal(size=(3 * H, D)).astype(np.float32)
    native = import_paddle_rnn_weight(w_ref)
    assert native.shape == (D, 3 * H)
    np.testing.assert_array_equal(native, jax_import(w_ref))
    np.testing.assert_array_equal(import_paddle_rnn_weight(native), w_ref)
    jm, tm = _pair("GRU", D, H, 1)
    jm._parameters["w_ih_0"] = jnp.asarray(native)
    with torch.no_grad():
        tm.w_ih_0.copy_(torch.from_numpy(native))
    x = rng.normal(size=(2, 3, D)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x))[0].detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))[0]), atol=TOL, rtol=0)
    with pytest.raises(Exception, match="2-D"):
        import_paddle_rnn_weight(np.zeros(3))
