#!/usr/bin/env python3
"""Where the time of the backward flash kernels (B6 dQ, B7 dK/dV) goes.

    python3 flash_bwd_probe.py

Needs one CUDA device and ``nvcc``. Builds variants of
``paddle_tpu_torch/ops/csrc/flash_attention.cu`` (into
``paddle_tpu_torch/_build/``) and times B6 and B7 of each at ERNIE's call
(f32 [8, 512, 16, 64], non-causal, "default") with ``chip_smoke``'s
protocol (CUDA events, L2 flushed, median of 25), in two interleaved
rounds:

- ``as_built``: the source as it is;
- ``stages3``: a three-stage ring;
- ``no_products``: every tensor-core product skipped (the ring, the
  conversion, exp and the stores still run; the outputs are wrong);
- ``no_refill``: the ring's refills and conversions after the prologue
  skipped (the products run on stale tiles; the outputs are wrong).

Prints one JSON line per variant and round (with the variant's max
absolute error against the plain versions), then the card's name and
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
SRC = os.path.join(ROOT, "paddle_tpu_torch", "ops", "csrc", "flash_attention.cu")
NEVER = "H < 0 && "  # a runtime condition the compiler cannot fold


def variants(src):
    """{name: source}; raises if an edit no longer matches the source."""
    def sub(text, pattern, repl, count):
        out, n = re.subn(pattern, repl, text)
        if n != count:
            raise ValueError(f"{pattern!r}: {n} matches, expected {count}")
        return out

    no_products = sub(src, r"\n(\s+)(wgmma_n(?:32_rs|32_ss|d_rs_t<NT>))\(",
                      r"\n\1if (H < 0) \2(", 7)
    no_refill = sub(src, r"if \((j \+ kStages < n)\) issue\(", rf"if ({NEVER}\1) issue(", 2)
    no_refill = sub(no_refill, r"if \((j \+ 1 < n)\) convert\(", rf"if ({NEVER}\1) convert(", 2)
    return {"as_built": src,
            "stages3": sub(src, r"constexpr int kStages = 2;", "constexpr int kStages = 3;", 1),
            "no_products": no_products,
            "no_refill": no_refill}


def build(name, text):
    from paddle_tpu_torch.ops._build import BUILD_DIR, build_shared_library, find_nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"flash_probe_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)

    def command(out):  # the port's flags (ops/_build.py)
        return [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o", out, cu]

    lib = ctypes.CDLL(build_shared_library(f"flash_probe_{name}", (cu,), command))
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 10 + [f32, p]
    lib.flash_bwd_dq_launch.restype = i32
    lib.flash_bwd_dq_launch.argtypes = [p] * 7 + tail
    lib.flash_bwd_dkv_launch.restype = i32
    lib.flash_bwd_dkv_launch.argtypes = [p] * 8 + tail
    return lib


def main():
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa

    with open(SRC) as f:
        srcs = variants(f.read())
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(*kv), srcs.items())))
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=cs.FA_SHAPE).astype(np.float32)).cuda()
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do * out).sum(-1).contiguous()
    bw = (q, k, v, do, lse, delta)
    want = (fa.flash_attention_bwd_dq_plain(*bw), *fa.flash_attention_bwd_dkv_plain(*bw))
    built = fa._LIB
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                fa._LIB = lib
                got = (fa.flash_attention_bwd_dq(*bw), *fa.flash_attention_bwd_dkv(*bw))
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                print(json.dumps({"variant": name, "round": rnd,
                                  "dq_ms": cs.time_cuda(lambda: fa.flash_attention_bwd_dq(*bw))[0],
                                  "dkv_ms": cs.time_cuda(lambda: fa.flash_attention_bwd_dkv(*bw))[0],
                                  "max_abs_err": err}), flush=True)
    finally:
        fa._LIB = built
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
