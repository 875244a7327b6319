"""DSSM, the two-tower recall model over the sparse PS path: the port of
``paddle_tpu.models.dssm``.

PaddleRec models/recall/dssm: a query tower and a doc tower embed their
own slot groups into one space; training scores the in-batch cosine
similarities with a softmax over negatives (every other doc of the batch).
The step takes ONE ``[B, Sq+Sd]`` row block (query slots first) through
the CTR family's shared body (``models.ctr._ctr_step_body``: pull, dense
update, push), so both towers' embedding gradients go out in one push: the
merge and the ``ctr_sparse_rows_at`` kernel on the card.

Params are the model's ``named_parameters()`` dict (``Linear`` weights
``[out, in]``; ``convert.recsys_params_from_jax`` carries the JAX
package's across); the module supplies the forward
(``torch.func.functional_call``). ``export_dssm_towers`` exports the
two towers for serving (``io.inference``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import enforce
from ..ps.embedding_cache import CacheConfig
from .ctr import _DNN, _check_device, _ctr_step_body, _weighted_mean

__all__ = ["DSSM", "make_dssm_train_step", "export_dssm_towers", "make_dssm_ranker"]

Device = Optional[Union[str, torch.device]]


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Smoothed L2 normalize, ``x * rsqrt(‖x‖² + 1e-6)``: bounded gradient
    at the near-zero outputs of a cold tower, unit vectors once trained."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-6)


def _sub_params(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of a model's params dict under ``prefix.``, renamed
    relative to that sub-module (what ``functional_call`` on it takes)."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class DSSM(nn.Module):
    """forward(emb [B, Sq+Sd, 1+dim], dense_x) → (q [B, out], d [B, out]),
    both L2-normalized. The towers read each slot's full vector (embed_w
    ++ embedx): lazily created embedx is all zero, and a purely bilinear
    objective over zeros sits at a saddle."""

    def __init__(self, num_query_slots: int, num_doc_slots: int, embedx_dim: int,
                 hidden: Tuple[int, ...] = (64, 32), out_dim: int = 16,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.sq, self.sd = num_query_slots, num_doc_slots
        self.query_tower = _DNN(num_query_slots * (1 + embedx_dim), hidden, out_dim=out_dim,
                                generator=generator)
        self.doc_tower = _DNN(num_doc_slots * (1 + embedx_dim), hidden, out_dim=out_dim,
                              generator=generator)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = emb.shape[0]
        q = self.query_tower(emb[:, :self.sq, :].reshape(B, -1))
        d = self.doc_tower(emb[:, self.sq:, :].reshape(B, -1))
        return _l2_normalize(q), _l2_normalize(d)

    @staticmethod
    def loss_vec(outputs, labels, temperature: float = 0.1, weights=None) -> torch.Tensor:
        """In-batch softmax over negatives: row i's positive is doc i
        (labels unused: the pairing is the supervision). ``weights`` ([B]
        0/1 tail-padding mask): padded doc columns get -1e30 so they are
        no row's negative, then each padded row's own diagonal gets +1e30
        back so it stays finite (its loss is masked downstream). Per-example
        loss [B]."""
        q, d = outputs
        logits = (q @ d.T) / temperature
        if weights is not None:
            pad = 1.0 - weights.to(torch.float32)
            logits = logits + (-1e30) * pad[None, :]
            logits = logits + torch.diag(1e30 * pad)
        return -torch.log_softmax(logits, dim=-1).diagonal()


def make_dssm_train_step(model: DSSM, optimizer, cache_cfg: CacheConfig,
                         temperature: float = 0.1, device: Device = None) -> Callable:
    """The two-tower in-batch-negatives step over the device cache:

    step(params, opt_state, cache_state, rows [B, Sq+Sd], dense_x, labels
         [B], weights=None) → (params, opt_state, cache_state, loss)

    ``labels`` feed only the accessor's click statistic. ``device``
    defaults to ``"cuda"`` (raises without a GPU)."""
    dev = resolve_device(device)

    def loss_builder(model_, dense_x, labels, weights):
        def loss_fn(params, emb):
            out = functional_call(model_, params, (emb, dense_x))
            return _weighted_mean(DSSM.loss_vec(out, labels, temperature, weights), weights)

        return loss_fn

    def step(params, opt_state, cache_state, rows, dense_x, labels, weights=None):
        _check_device(rows, dev, "rows")
        B, S = rows.shape
        return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state, cache_state,
                              rows.reshape(-1), B, S, dense_x, labels, weights,
                              loss_builder=loss_builder)

    return step


def export_dssm_towers(dirname: str, model: DSSM, cache, query_slot_ids, doc_slot_ids,
                       refresh_only: bool = False) -> None:
    """The two-tower deployment split: ``<dirname>/query`` serves the
    ONLINE tower (query lo32 [b, Sq] int64 → the normalized query vector)
    and ``<dirname>/doc`` the OFFLINE one (doc lo32 [b, Sd] → normalized
    doc vectors for the ANN index build). Each is an ``io.inference``
    export (``torch.export``, ``b`` dynamic) with the PRUNED serving
    tables (``embed_w``/``embedx_w`` and the pass's key map) and its own
    tower's params only. ``*_slot_ids`` are the columns' key high halves.

    ``refresh_only=True`` overwrites only the serving values of both
    existing exports (no trace)."""
    import os

    from ..io.inference import refresh_inference_params, save_inference_model
    from .ctr import serving_pull

    enforce(cache.state is not None, "begin_pass first")
    enforce(cache.device_map is not None,
            "export_dssm_towers needs device_map=True on the cache")
    state = {k: v.detach() for k, v in model.named_parameters()}
    dev = cache.state["embed_w"].device
    tables = {"embed_w": cache.state["embed_w"], "embedx_w": cache.state["embedx_w"]}
    map_state = dict(cache.device_map.state)

    for which, slot_ids, tower in (("query", query_slot_ids, model.query_tower),
                                   ("doc", doc_slot_ids, model.doc_tower)):
        slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
        serving = {"model": {"params": _sub_params(state, f"{which}_tower"), "buffers": {}},
                   "tables": tables, "map": map_state}
        if refresh_only:
            refresh_inference_params(os.path.join(dirname, which), serving)
            continue

        def fn(p, lo32, tower=tower, slot_hi=slot_hi):
            emb = serving_pull(p["tables"], p["map"], slot_hi, lo32)
            return _l2_normalize(functional_call(tower, p["model"]["params"],
                                                 (emb.reshape(emb.shape[0], -1),)))

        save_inference_model(os.path.join(dirname, which), fn, serving,
                             (torch.zeros((2, len(slot_hi)), dtype=torch.int64, device=dev),),
                             notes={"lo32": "uint32 key halves carried as int64 in [0, 2^32)"})


def make_dssm_ranker(model: DSSM, params: Optional[Dict[str, torch.Tensor]] = None,
                     device: Device = None) -> Callable:
    """The serving pipeline's ranker, two-tower face: ``rank(hist_emb [B, H,
    1+dim], lengths [B], cand_emb [B, K, 1+dim]) → scores [B, K]`` (numpy
    in and out; the towers run on ``device``, default ``"cuda"``). The H
    history rows are the query slots (H must equal ``num_query_slots``),
    each candidate a one-slot doc (``num_doc_slots`` must be 1);
    ``lengths`` is unused (the contract's). ``params``: the model's params
    dict (default: its own parameters, read at each call). Each tower runs
    through ``functional_call`` on its sub-module. Batches are not padded:
    a row's scores do not depend on the others'."""
    dev = resolve_device(device)
    msg = (f"make_dssm_ranker: model towers are (sq={model.sq}, sd={model.sd}); the "
           f"ranker contract needs H == sq history rows and sd == 1")
    if model.sd != 1:
        raise ValueError(msg)

    def rank(hist_emb, lengths, cand_emb) -> np.ndarray:
        del lengths
        state = params if params is not None else dict(model.named_parameters())
        state = {k: v.detach().to(dev) for k, v in state.items()}
        hist = torch.from_numpy(np.ascontiguousarray(hist_emb, np.float32)).to(dev)
        cand = torch.from_numpy(np.ascontiguousarray(cand_emb, np.float32)).to(dev)
        if hist.shape[1] != model.sq:
            raise ValueError(msg + f" (got H={hist.shape[1]})")
        B, K, d = cand.shape
        with torch.no_grad():
            q = _l2_normalize(functional_call(model.query_tower, _sub_params(
                state, "query_tower"), (hist.reshape(B, -1),)))
            v = _l2_normalize(functional_call(model.doc_tower, _sub_params(
                state, "doc_tower"), (cand.reshape(B * K, d),))).reshape(B, K, -1)
            return torch.einsum("bo,bko->bk", q, v).cpu().numpy()

    return rank
