"""1F1B and interleaved-1F1B pipeline schedules.

Port of ``paddle_tpu.parallel.pipeline_1f1b`` (the reference's
``SectionWorker`` 1F1B walk, section_worker.cc:139-189, and dygraph
``PipelineParallel``'s interleave, pipeline_parallel.py:30). What
matters is MEMORY: each rank keeps at most O(S) in-flight activations,
not the O(M) of all-forwards-then-all-backwards.

Each rank walks global ticks. At every tick it
- forwards one (micro, chunk) work item with no autograd graph, stashes
  the item's input (detached) and sends the output +1 over pp, and
- backwards one work item: the stage's forward is recomputed from the
  stashed input, and ``torch.autograd.grad`` gives the chunk's parameter
  gradients (accumulated a chunk) and the input gradient, sent −1 over
  pp.

No autograd graph spans two ticks: a backward item's graph is built,
used and dropped within its tick. That is the difference from the
F-then-B schedule, and what bounds the memory.

Schedule arithmetic (the JAX module's; rank r, tick t, S ranks, V chunks
a rank — V = 1 is plain 1F1B, V > 1 Megatron-style interleave; logical
stage l = v·S + r lives on rank l mod S):

  forward   u = t − r            chunk v = (u div S) mod V
            micro f = (u mod S) + S·(u div SV)         valid: 0 ≤ u < MV
  backward  for the unique chunk j with w = t + (r+Sj) − (2SV−2)
            satisfying w mod SV < S:  micro f_b = (w mod SV) + S·(w div SV)
            valid: 0 ≤ w < MV
  stash     forward item u sits in ring slot u mod 2SV; the backward of
            (l, f_b) reads slot (w + S·j) mod 2SV. The in-flight span is
            2SV − 2 − 2Sj − 2r < 2SV, so slots never collide.

The final logical stage seeds the backward in the tick of its forward
(the head and loss gradients); the backward of logical stage 0 feeds the
embed's gradient (its forward recomputed). Total ticks: MpV + 2SV − 2.
For V > 1 the micro count is padded to Mp = ceil(M/S)·S.

Divergence: a phantom item (micro id ≥ M) is SKIPPED — nothing is
computed or stashed for it, and a rank sends None where it has nothing
(the receiving item is a phantom too). The JAX function computes it
under a mask; the values are the same. Dropout replay: the caller's
``reseed(micro, chunk, part)`` seeds the rank's generator before every
forward and its recompute, so both draw the same mask.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.enforce import enforce
from ..ops import collectives as coll

__all__ = ["pipeline_1f1b_fn"]

Tree = Dict[str, Any]
_STAGE, _EMBED, _HEAD = 0, 1, 2


def _leaves(state: Tree) -> Tree:
    """The state with its parameters as fresh leaves that require grad."""
    return {"params": {k: t.detach().requires_grad_(True) for k, t in state["params"].items()},
            "buffers": state.get("buffers", {})}


def _accumulate(acc: Optional[Dict[str, torch.Tensor]], names, grads):
    if acc is None:
        return {k: g for k, g in zip(names, grads)}
    for k, g in zip(names, grads):
        acc[k] = acc[k] + g
    return acc


def pipeline_1f1b_fn(stage_apply: Callable[[Tree, torch.Tensor], torch.Tensor],
                     num_stages: int, num_virtual: int, num_micro: int,
                     loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     pp_axis: str = "pp",
                     embed_apply: Optional[Callable[[Tree, torch.Tensor], torch.Tensor]] = None,
                     head_apply: Optional[Callable[[Tree, torch.Tensor], torch.Tensor]] = None,
                     reseed: Optional[Callable[..., None]] = None):
    """The per-rank 1F1B step, for use inside ``run_ranks``:
    ``fn(chunk_states, aux_state, x_micro, y_micro) -> (loss, chunk_grads,
    aux_grads, max_stash)``. ``chunk_states`` is this rank's list of V
    chunk states (``{"params", "buffers"}``; chunk v is logical stage
    v·S + r), ``aux_state`` ``{"embed": …, "head": …}``, ``x_micro`` /
    ``y_micro`` [M, micro, ...]. Gradients are summed over micro-batches
    ({param name: grad} a chunk, and a part of the aux); the caller
    divides by M. ``loss`` is the micro mean on the final logical stage's
    rank, 0 elsewhere. ``max_stash``: the most inputs stashed at once."""
    S, V, M = num_stages, num_virtual, num_micro
    SV = S * V
    R = 2 * SV
    Mp = M if V == 1 else -(-M // S) * S
    MVp = Mp * V
    total_ticks = MVp + 2 * SV - 2

    def seed(*item):
        if reseed is not None:
            reseed(*item)

    def fn(chunk_states: List[Tree], aux_state: Tree, x_micro, y_micro):
        r = coll.axis_index(pp_axis)
        emb_state, head_state = aux_state.get("embed"), aux_state.get("head")
        stash: Dict[int, torch.Tensor] = {}
        max_stash = 0
        fwd_buf = bwd_buf = None
        loss = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        g_chunks: List[Optional[Dict[str, torch.Tensor]]] = [None] * V
        g_emb = g_head = None

        def embed(f, state):
            seed(f, 0, _EMBED)
            return embed_apply(state, x_micro[f])

        for t in range(total_ticks):
            # ---------------- forward work item ----------------
            out = g_seed = None
            u = t - r
            if 0 <= u < MVp:
                v = (u // S) % V
                f = (u % S) + S * (u // SV)
                if f < M:
                    with torch.no_grad():
                        if r == 0 and v == 0:
                            x_in = embed(f, emb_state) if embed_apply is not None else x_micro[f]
                        else:
                            enforce(fwd_buf is not None, f"1f1b: rank {r} tick {t} has no input")
                            x_in = fwd_buf
                        seed(f, v, _STAGE)
                        out = stage_apply(chunk_states[v], x_in)
                    enforce(u % R not in stash, f"1f1b: stash slot {u % R} collides")
                    stash[u % R] = x_in.detach()
                    max_stash = max(max_stash, len(stash))
                    if r == S - 1 and v == V - 1:   # the loss seed at the final logical stage
                        with torch.enable_grad():
                            o = out.detach().requires_grad_(True)
                            if head_apply is not None:
                                hs = _leaves(head_state)
                                seed(f, v, _HEAD)
                                lval = loss_fn(head_apply(hs, o), y_micro[f])
                                names = list(hs["params"])
                                got = torch.autograd.grad(lval, [hs["params"][k] for k in names]
                                                          + [o])
                                g_head = _accumulate(g_head, names, got[:-1])
                                g_seed = got[-1]
                            else:
                                lval = loss_fn(o, y_micro[f])
                                (g_seed,) = torch.autograd.grad(lval, o)
                        loss = loss + lval.detach() / M

            # ---------------- backward work item ----------------
            g_x = None
            for j in range(V):
                w = t + r + S * j - (2 * SV - 2)
                if 0 <= w < MVp and w % SV < S and (w % SV) + S * (w // SV) < M:
                    break
            else:
                j = None
            if j is not None:
                f_b = (w % SV) + S * (w // SV)
                l_b = r + S * j
                x_st = stash.pop((w + S * j) % R)
                g_in = g_seed if l_b == SV - 1 else bwd_buf
                enforce(g_in is not None, f"1f1b: rank {r} tick {t} has no incoming gradient")
                need_x = l_b != 0 or embed_apply is not None
                with torch.enable_grad():
                    cs = _leaves(chunk_states[j])
                    x = x_st.requires_grad_(need_x)
                    seed(f_b, j, _STAGE)
                    out_b = stage_apply(cs, x)
                    names = list(cs["params"])
                    got = torch.autograd.grad(out_b, [cs["params"][k] for k in names]
                                              + ([x] if need_x else []), g_in)
                g_chunks[j] = _accumulate(g_chunks[j], names, got[:len(names)])
                if need_x:
                    g_x = got[-1]
                if l_b == 0 and embed_apply is not None:
                    with torch.enable_grad():
                        es = _leaves(emb_state)
                        e_out = embed(f_b, es)
                        names_e = list(es["params"])
                        got_e = torch.autograd.grad(e_out, [es["params"][k] for k in names_e],
                                                    g_x)
                    g_emb = _accumulate(g_emb, names_e, got_e)
                    g_x = None

            # ---------------- ring rotations (detached) ----------------
            fwd_buf = coll.shift(out, pp_axis, 1)
            bwd_buf = coll.shift(g_x, pp_axis, -1)

        enforce(not stash, f"1f1b: rank {r} ended with {len(stash)} stashed inputs")
        zeros = lambda st: {k: torch.zeros_like(p) for k, p in st["params"].items()}  # noqa: E731
        g_chunks = [g if g is not None else zeros(chunk_states[v]) for v, g in enumerate(g_chunks)]
        g_aux = {}
        if emb_state is not None:
            g_aux["embed"] = g_emb if g_emb is not None else zeros(emb_state)
        if head_state is not None:
            g_aux["head"] = g_head if g_head is not None else zeros(head_state)
        return loss, g_chunks, g_aux, max_stash

    return fn
