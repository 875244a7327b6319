#!/usr/bin/env python3
"""Where the time of B4 (``hot_scatter_apply``) and its radix sort goes.

    python3 hot_scatter_probe.py

Needs one CUDA device and ``nvcc``. Builds variants of
``paddle_tpu_torch/ops/csrc/hot_kernels.cu`` (into
``paddle_tpu_torch/_build/``, in parallel) and times, with
``chip_smoke``'s protocol (CUDA events, L2 flushed, median of 25), the
bounded sort (3 passes) and the full sort (4 passes) of the hot path's
batch (n = 106,496) and, where the variant's sort is still right (B4
walks its output), B4 on the hot path's batch and on the heavy-hitter
batch, in two interleaved rounds:

- ``as_built``: the source as it is;
- ``no_pdl``: every kernel launched without programmatic dependent
  launch (each waits for the one before it to finish before it starts);
- ``empty``: every sort kernel returns at once (the floor of the
  launches; the outputs are wrong);
- ``count_only``: the scatter kernels return at once (the count kernel
  as built);
- ``no_prologue``: the scatter kernels skip the scan of the count matrix
  (every digit starts at 0; the outputs are wrong);
- ``no_next_counts``: the scatter kernels add no counts for the next
  pass (the later passes see zeros; the outputs are wrong);
- ``no_writes``: the scatter kernels write no keys, values or rows;
- ``no_rule``: the walk sums each segment but writes only its show sum,
  never reading or writing the rest of the row (the outputs are wrong);
- ``tile1024``, ``tile4096``: 1024-key tiles ranked by 256 threads and
  4096-key tiles by 1024 threads, 4 keys a thread as built (the outputs
  are right);
- ``block64``, ``block128``, ``block512``, ``warps_only``: the walk's
  block threshold (``kWalkBlockMin``, 256 as built) at 64, 128, 512 and
  never, so every segment of 32 or more goes to a warp (the outputs are
  right).

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
SRC = os.path.join(CSRC, "hot_kernels.cu")
NEVER = "n < 0 && "  # a runtime condition the compiler cannot fold


def variants(src):
    """{name: (source, whether its sort is right)}; raises if an edit no
    longer matches."""
    def sub(text, pattern, repl, count):
        out, n = re.subn(pattern, repl, text)
        if n != count:
            raise ValueError(f"{pattern!r}: {n} matches, expected {count}")
        return out

    count_head = r"(radix_count_kernel\([^)]*\) \{\n)"
    scatter_head = r"(radix_scatter_kernel\([^)]*\) \{\n)"
    empty = sub(src, count_head, r"\1  if (n > 0) return;\n", 1)
    empty = sub(empty, scatter_head, r"\1  if (n > 0) return;\n", 1)
    no_writes = sub(src, r"if \(valid\) \{\n(\s+)(keys_out|const int32_t row)",
                    rf"if ({NEVER}valid) {{\n\1\2", 2)
    no_rule = sub(src, r"(__device__ __forceinline__ void apply_row\([^)]*\) \{\n)",
                  r"\1  if (n_rule_never(a)) { a.show[r] = ds; return; }\n", 1)
    no_rule = sub(no_rule, r"\ntemplate <int DIM>\n__device__ __forceinline__ void apply_row",
                  "\n__device__ __forceinline__ bool n_rule_never(const WalkArgs& a) "
                  "{ return a.n > 0; }\n\ntemplate <int DIM>\n"
                  "__device__ __forceinline__ void apply_row", 1)
    def tile(keys, threads):
        out = sub(src, r"constexpr int kSortTile = 2048;", f"constexpr int kSortTile = {keys};", 1)
        return sub(out, r"constexpr int kSortThreads = 512;",
                   f"constexpr int kSortThreads = {threads};", 1)

    def block_min(value):
        return sub(src, r"constexpr int kWalkBlockMin = 256;",
                   f"constexpr int kWalkBlockMin = {value};", 1)

    return {"as_built": (src, True),
            "no_pdl": (sub(src, r"programmaticStreamSerializationAllowed = 1;",
                           "programmaticStreamSerializationAllowed = 0;", 1), True),
            "empty": (empty, False),
            "count_only": (sub(src, scatter_head, r"\1  if (n > 0) return;\n", 1), False),
            "no_prologue": (sub(src, r"for \(int u = 0; u < tiles; \+\+u\) \{",
                                "for (int u = 0; u < 0; ++u) {", 1), False),
            "no_next_counts": (sub(src, r"if \(valid && lane == __ffs\(peers\) - 1\)\n",
                                   f"if ({NEVER}valid && lane == __ffs(peers) - 1)\n", 1),
                               False),
            "no_writes": (no_writes, False),
            "no_rule": (no_rule, True),
            "tile1024": (tile(1024, 256), True),
            "tile4096": (tile(4096, 1024), True),
            "block64": (block_min(64), True),
            "block128": (block_min(128), True),
            "block512": (block_min(512), True),
            "warps_only": (block_min(1 << 30), True)}


def build(name, text):
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ops._build import BUILD_DIR, build_shared_library, find_nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"hot_scatter_probe_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    rule = os.path.join(CSRC, "ctr_rule.cuh")

    def command(out):  # the port's flags (ops/_build.py), the rule header from csrc
        return [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC, "-o", out, cu]

    path = build_shared_library(f"hot_scatter_probe_{name}", (cu, rule), command)
    return hk.bind_hot_kernels(ctypes.CDLL(path))


def main():
    if not torch.cuda.is_available():
        print("hot_scatter_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import hot_kernels as hk

    with open(SRC) as f:
        srcs = variants(f.read())
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(kv[0], kv[1][0]), srcs.items())))
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    heavy = cs.hot_push_inputs(rng, cs.BATCH * cs.SLOTS, cs.HOT_CAP, dev)
    hot = cs.hot_path_push(rng, dev)
    cfg = cs.hot_cfg("adagrad", "adagrad", True)
    tier = cs.tier_columns(np.random.default_rng(12), "adagrad", "adagrad", dev)
    want = hk._sort_rows_plain(hot[0], cs.HOT_CAP)
    built = hk._LIB
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                hk._LIB = lib
                line = {"variant": name, "round": rnd,
                        "sort_bounded_ms": cs.time_cuda(
                            lambda: hk._sort_rows(hot[0], cs.HOT_CAP))[0],
                        "sort_full_ms": cs.time_cuda(lambda: hk._sort_rows(hot[0]))[0]}
                if srcs[name][1]:  # B4 walks the sort's output: only a right sort is safe
                    got = hk._sort_rows(hot[0], cs.HOT_CAP)
                    line["sort_equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
                    line["b4_hot_ms"] = cs.time_cuda(
                        lambda: hk.hot_scatter_apply(tier, *hot, cfg))[0]
                    line["b4_heavy_ms"] = cs.time_cuda(
                        lambda: hk.hot_scatter_apply(tier, *heavy, cfg))[0]
                print(json.dumps(line), flush=True)
    finally:
        hk._LIB = built
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
