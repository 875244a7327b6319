#!/usr/bin/env python3
"""How far apart two correct runs of the small ResNet's training steps are.

    python3 vision_parity_probe.py [BATCH ...]

Needs one CUDA device. For the two models of ``chip_smoke``'s
card-vs-CPU phase (``Trainer`` with ``Momentum(0.01, 0.9,
weight_decay=1e-4)``): the ResNet of one bottleneck a stage at 64x64, at
each batch size given (default 8 and 32), and LeNet at batch 8; for
three seeds (data seed 70+i, weight seed 7+i), in f32 and O1, it runs
the same 3 steps four times: on the card twice, on the CPU, and on the
CPU with oneDNN off (another conv algorithm). It prints
``chip_smoke.parity_metrics`` (loss, update over all params, worst
tensor's update, running stats) after 1 step and after 3 for:

- ``card_vs_cpu``: what ``chip_smoke`` bounds in f32;
- ``card_vs_card``: the card's own run-to-run spread;
- ``cpu_vs_cpu``: oneDNN off against on, a reference spread with no
  card and no extra rounding in it;
- ``card_vs_oracle`` (O1): the card against the CPU run inside
  ``amp.card_conv_rounding``, whose convs round their output to bf16 as
  cuDNN does: what ``chip_smoke`` bounds in O1;
- ``o1_vs_f32_cpu``: O1 against f32 on the CPU, what amp itself changes.

The same comparisons are made of the ResNet's ``chip_smoke.eval_mode_grad``,
one loss's gradient with BatchNorm on its running stats (``eval_grad``).
It also prints, per batch and BatchNorm mode (train, eval), how far the
f32 gradient of one loss lies from the f64 one on the CPU
(``conditioning``): the size of the difference that f32 rounding alone
makes in the gradient.

One JSON line a reading, then the card's name and power limit. Exits
non-zero without a CUDA device.
"""

import json
import sys

import numpy as np
import torch

import chip_smoke as cs

SEEDS = ((70, 7), (71, 8), (72, 9))


def grad_vector(weights, x, y, train, dtype):
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.nn import functional as F

    m = ResNet(BottleneckBlock, [1, 1, 1, 1], 10)
    m.load_state_dict(weights)
    m.to(dtype).train(train)
    loss = F.cross_entropy(m(x.to(dtype)), y)
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return torch.cat([g.flatten().double() for g in grads])


def conditioning(batch):
    weights, batches = cs.vision_parity_inputs("resnet", batch)
    x, y = batches[0]
    for train in (True, False):
        g32 = grad_vector(weights, x, y, train, torch.float32)
        g64 = grad_vector(weights, x, y, train, torch.float64)
        print(json.dumps({"conditioning": {"batch": batch, "bn": "train" if train else "eval",
                                           "f32_vs_f64": float((g32 - g64).norm() / g64.norm()),
                                           "grad_norm": float(g64.norm())}}), flush=True)


def emit(**reading):
    print(json.dumps(reading), flush=True)


def emit_steps(kind, batch, seed, amp, what, weights, a, b):
    for steps in (1, 3):
        (al, ast), (bl, bst) = a[steps - 1], b[steps - 1]
        loss, upd, worst, stat = cs.parity_metrics(weights, al, ast, bl, bst)
        emit(kind=kind, batch=batch, seed=seed, amp=amp, steps=steps, what=what, loss=loss,
             updates=upd, worst_tensor=worst, running_stats=stat)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def main(argv):
    if not torch.cuda.is_available():
        print("vision_parity_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cases = [("resnet", int(a)) for a in argv or (8, 32)] + [("lenet", 8)]
    for kind, batch in cases:
        for seed, wseed in SEEDS:
            weights, batches = cs.vision_parity_inputs(kind, batch, seed, wseed)
            host_runs, host_grads = {}, {}
            for amp in (False, "O1"):
                name = amp or "f32"
                card = cs.small_vision_run(dev, kind, weights, amp, batches)
                card2 = cs.small_vision_run(dev, kind, weights, amp, batches)
                host = cs.small_vision_run(cpu, kind, weights, amp, batches)
                with torch.backends.mkldnn.flags(enabled=False):
                    host2 = cs.small_vision_run(cpu, kind, weights, amp, batches)
                host_runs[amp] = host
                pairs = [("card_vs_cpu", card, host), ("card_vs_card", card2, card),
                         ("cpu_vs_cpu", host2, host)]
                if amp:
                    with cs.cpu_oracle(amp):
                        oracle = cs.small_vision_run(cpu, kind, weights, amp, batches)
                    pairs.append(("card_vs_oracle", card, oracle))
                for what, a, b in pairs:
                    emit_steps(kind, batch, seed, name, what, weights, a, b)
                if kind != "resnet":
                    continue
                g = [cs.eval_mode_grad(d, weights, batches[0], amp) for d in (dev, dev, cpu)]
                with torch.backends.mkldnn.flags(enabled=False):
                    g.append(cs.eval_mode_grad(cpu, weights, batches[0], amp))
                with cs.cpu_oracle(amp):
                    g.append(cs.eval_mode_grad(cpu, weights, batches[0], amp))
                host_grads[amp] = g[2]
                for what, a, b in (("card_vs_cpu", 0, 2), ("card_vs_card", 1, 0),
                                   ("cpu_vs_cpu", 3, 2), ("card_vs_oracle", 0, 4)):
                    if what == "card_vs_oracle" and not amp:
                        continue
                    emit(kind=kind, batch=batch, seed=seed, amp=name, what=what,
                         eval_grad=rel(g[a], g[b]))
            # what amp itself changes: O1 against f32, both on the CPU
            emit_steps(kind, batch, seed, "O1", "o1_vs_f32_cpu", weights, host_runs["O1"],
                       host_runs[False])
            if kind == "resnet":
                emit(kind=kind, batch=batch, seed=seed, amp="O1", what="o1_vs_f32_cpu",
                     eval_grad=rel(host_grads["O1"], host_grads[False]))
        if kind == "resnet":
            conditioning(batch)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main(sys.argv[1:]))
