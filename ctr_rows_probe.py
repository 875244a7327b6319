#!/usr/bin/env python3
"""Where the time of B1 (``ctr_sparse_rows``) goes.

    python3 ctr_rows_probe.py [VARIANT ...]

Needs one CUDA device and ``nvcc``. Builds variants of
``paddle_tpu_torch/ops/csrc/ctr_sparse_rows.cu`` (all of them, or those
named; into ``paddle_tpu_torch/_build/``, in parallel) and times them with
``chip_smoke``'s protocol (CUDA events, L2 flushed, median of 25), in two
interleaved rounds, at phase 2's shapes (adagrad/adagrad, dim 8): in place
on one pass-path step's merged push into the 2^21-row cache (``at_ms``),
and rows in, rows out at n = 106,496 (``rows_ms``: the call, with its
copies of the rows). Each variant that is right is checked bitwise
against the plain versions. The variants:

- ``as_built``: the source as it is (tiles of 128 entries by bulk copies,
  each row's pieces by ``cp.async``, compile-time widths at dim 8);
- ``tile64``, ``tile256``: 64- or 256-entry tiles (threads a block);
- ``runtime_widths``: the run-time-width instance at dim 8 too;
- ``empty``: the kernel returns at once (the launch floor; the outputs
  are wrong).

Prints one JSON line per variant and round, then the card's name and
power limit. Exits non-zero without a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "paddle_tpu_torch", "ops", "csrc")
SRC = os.path.join(CSRC, "ctr_sparse_rows.cu")
FIXED_DIM = "  if (dim == 8 && natural) {"
NEVER_DIM = "  if (dim == -8 && natural) {"  # a width no call has: the run-time instance always


def variants(src):
    """{name: (source, whether its outputs are right)}. Raises if an edit
    no longer matches the source."""
    def sub(text, pattern, repl, count=1):
        out, n = re.subn(pattern, repl, text)
        if n != count:
            raise ValueError(f"{pattern!r}: {n} matches, expected {count}")
        return out

    def const(text, name, value):
        return sub(text, rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};")

    heads = r"(__global__ void ctr_rows_at_kernel\(const AtArgs a\) \{\n)"
    return {"as_built": (src, True),
            "tile64": (const(src, "kTile", 64), True),
            "tile256": (const(src, "kTile", 256), True),
            "runtime_widths": (sub(src, re.escape(FIXED_DIM), NEVER_DIM), True),
            "empty": (sub(src, heads, r"\1  if (a.n > 0) return;\n"), False)}


def build(name, text):
    from paddle_tpu_torch.ops import sparse_optimizer as so
    from paddle_tpu_torch.ops._build import BUILD_DIR, build_shared_library, find_nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"ctr_rows_probe_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    headers = [os.path.join(CSRC, h) for h in ("ctr_rule.cuh", "async_copy.cuh")]

    def command(out):  # the port's flags (ops/_build.py), the headers from csrc
        return [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC, "-o", out, cu]

    path = build_shared_library(f"ctr_rows_probe_{name}", (cu, *headers), command)
    return so.bind_kernel(ctypes.CDLL(path))


def main(argv):
    if not torch.cuda.is_available():
        print("ctr_rows_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ops import sparse_optimizer as so

    with open(SRC) as f:
        srcs = variants(f.read())
    unknown = set(argv) - set(srcs)
    if unknown:
        print(f"ctr_rows_probe: no variant {sorted(unknown)}; variants: {list(srcs)}",
              file=sys.stderr)
        return 2
    if argv:
        srcs = {k: v for k, v in srcs.items() if k in argv}
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(kv[0], kv[1][0]), srcs.items())))
    dev = torch.device("cuda")
    n = cs.BATCH * cs.SLOTS
    kw = dict(embed_rule="adagrad", embedx_rule="adagrad", **cs.HYPER)
    cols, deltas = cs.rows_inputs(np.random.default_rng(1), n, cs.DIM, "adagrad", "adagrad",
                                  dev)
    want_rows = cs.plain(cols, deltas, "adagrad", "adagrad", True)
    rng = np.random.default_rng(2)
    state, _ = cs.rows_inputs(rng, cs.CAPACITY, cs.DIM, "adagrad", "adagrad", dev)
    merged = hk.merge_sparse_grads(*cs.pass_push(rng, dev), cs.CAPACITY)
    want_at = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), *merged,
                                          capacity=cs.CAPACITY, **kw)
    work = tuple(c.clone() for c in state)  # the timed calls update it in place
    built = so._KLIB
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                so._KLIB = lib
                line = {"variant": name, "round": rnd}
                if srcs[name][1]:
                    got = tuple(c.clone() for c in state)
                    so.ctr_sparse_rows_at(got, *merged, capacity=cs.CAPACITY, **kw)
                    line["equal"] = (cs.bitwise_cols(so.ctr_sparse_rows(cols, *deltas, **kw),
                                                     want_rows)
                                     and cs.bitwise_cols(got, want_at))
                line["rows_ms"] = cs.time_cuda(lambda: so.ctr_sparse_rows(cols, *deltas,
                                                                          **kw))[0]
                line["at_ms"] = cs.time_cuda(lambda: so.ctr_sparse_rows_at(
                    work, *merged, capacity=cs.CAPACITY, **kw))[0]
                print(json.dumps(line), flush=True)
    finally:
        so._KLIB = built
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
