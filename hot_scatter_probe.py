#!/usr/bin/env python3
"""Where the time of the hot tier's kernels goes: the probes B3
(``hot_probe``) and B2 (``hot_probe_gather``), and B4
(``hot_scatter_apply``) with its radix sort.

    python3 hot_scatter_probe.py [VARIANT ...]

Needs one CUDA device and ``nvcc``. Builds variants of
``paddle_tpu_torch/ops/csrc/hot_kernels.cu`` (all of them, or those
named; into ``paddle_tpu_torch/_build/``, in parallel) and times them with
``chip_smoke``'s protocol (CUDA events, L2 flushed, median of 25), in two
interleaved rounds.

The probe variants are timed at phase 2's shapes: B2 on the hot path's
batch (n = 106,496 keys, ~20 % absent, banks 1) and B3 on one shard's
slice (n = 26,624, banks 4) and on the whole batch (banks 4), each
checked against its plain version where the variant is right:

- ``as_built``: the source as it is (a group of 8 lanes takes 4 keys;
  a bucket's slots are loaded, compared and reduced before the next
  bucket's are, and only for keys still missing; 256-thread blocks);
- ``probe_empty``: the probe kernels return at once (the launch floor;
  the outputs are wrong);
- ``both_buckets``: both probe buckets of every key loaded before any
  compare;
- ``group4``, ``group16``: 4 or 16 lanes a key;
- ``keys1``, ``keys2``, ``keys8``: a group takes 1, 2 or 8 keys;
- ``block1024``: 1024-thread blocks;
- ``one_thread``: the earlier design: one thread a key, the slots of a
  bucket loaded one by one, row first, hi and lo only behind a live row,
  the second bucket only after a miss.

The sort and B4 variants are timed on the bounded sort (3 passes) and the
full sort (4 passes) of the hot path's batch and, where the variant's
sort is right (B4 walks its output), B4 on the hot path's batch and on
the heavy-hitter batch (``as_built`` is timed both ways):

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
PROBE_VARIANTS = ("as_built", "probe_empty", "both_buckets", "group4", "group16", "keys1",
                  "keys2", "keys8", "block1024", "one_thread")

# The earlier probe, one thread a key, in place of the source's probe
# section (one_thread).
ONE_THREAD = """// -- the probe: one thread a key --
constexpr int kProbeThreads = 256;

unsigned probe_blocks(int64_t n) {
  return static_cast<unsigned>((n + kProbeThreads - 1) / kProbeThreads);
}

__device__ __forceinline__ int32_t probe_row(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, uint32_t seed, uint32_t hi,
    uint32_t lo, int64_t nbuckets, int bslots, int probe_buckets, int banks) {
  const uint32_t nbpb = static_cast<uint32_t>(nbuckets / banks);
  const uint32_t local_mask = nbpb - 1u;
  uint32_t base = 0u;
  if (banks > 1)
    base = (mix32(hi, lo, kBankSeed) & static_cast<uint32_t>(banks - 1)) * nbpb;
  const uint32_t b0 = mix32(hi, lo, seed) & local_mask;
  int32_t found = -1;
  for (int t = 0; t < probe_buckets && found < 0; ++t) {
    const int64_t b = static_cast<int64_t>(base + ((b0 + t) & local_mask));
    const int64_t s0 = b * bslots;
    int32_t hit = -1;
    for (int l = 0; l < bslots; ++l) {
      const int32_t r = map_row[s0 + l];
      if (r >= 0 && static_cast<uint32_t>(map_hi[s0 + l]) == hi &&
          static_cast<uint32_t>(map_lo[s0 + l]) == lo)
        hit = r > hit ? r : hit;
    }
    found = hit;
  }
  return found;
}

__global__ void hot_probe_gather_kernel(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, const int32_t* __restrict__ seed_p,
    const int32_t* __restrict__ keys_hi, const int32_t* __restrict__ keys_lo,
    const float* __restrict__ embed_w, const float* __restrict__ embedx_w,
    int32_t* __restrict__ o_rows, float* __restrict__ o_pull, int64_t n,
    int64_t nbuckets, int bslots, int probe_buckets, int banks, int64_t C,
    int dim) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t found = probe_row(
      map_hi, map_lo, map_row, static_cast<uint32_t>(*seed_p),
      static_cast<uint32_t>(keys_hi[i]), static_cast<uint32_t>(keys_lo[i]),
      nbuckets, bslots, probe_buckets, banks);
  o_rows[i] = found;
  float* out = o_pull + i * (1 + dim);
  if (found >= 0) {
    const int64_t r = found < C ? found : C - 1;
    out[0] = embed_w[r];
    const float* x = embedx_w + r * dim;
    for (int d = 0; d < dim; ++d) out[1 + d] = x[d];
  } else {
    for (int d = 0; d <= dim; ++d) out[d] = 0.0f;
  }
}

__global__ void hot_probe_kernel(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, const int32_t* __restrict__ seed_p,
    const int32_t* __restrict__ keys_hi, const int32_t* __restrict__ keys_lo,
    int32_t* __restrict__ o_rows, int64_t n, int64_t nbuckets, int bslots,
    int probe_buckets, int banks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  o_rows[i] = probe_row(
      map_hi, map_lo, map_row, static_cast<uint32_t>(*seed_p),
      static_cast<uint32_t>(keys_hi[i]), static_cast<uint32_t>(keys_lo[i]),
      nbuckets, bslots, probe_buckets, banks);
}

"""


def variants(src):
    """{name: (source, whether the kernels it is timed on are right)}: for
    the probe variants the probes, for the others the sort (B4 walks its
    output). Raises if an edit no longer matches."""
    def sub(text, pattern, repl, count):
        out, n = re.subn(pattern, repl, text)
        if n != count:
            raise ValueError(f"{pattern!r}: {n} matches, expected {count}")
        return out

    def const(name, value):
        return sub(src, rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", 1)

    probe_head = r"(hot_probe(?:_gather)?_kernel\([^)]*\) \{\n)"
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
    one_thread = sub(src, r"(?s)// -- the probe: B3 .*?(?=// -- the stable radix sort)",
                     lambda m: ONE_THREAD, 1)

    def tile(keys, threads):
        out = sub(src, r"constexpr int kSortTile = 2048;", f"constexpr int kSortTile = {keys};", 1)
        return sub(out, r"constexpr int kSortThreads = 512;",
                   f"constexpr int kSortThreads = {threads};", 1)

    return {"as_built": (src, True),
            "probe_empty": (sub(src, probe_head, r"\1  if (n > 0) return;\n", 2), False),
            "both_buckets": (const("kProbeAhead", 2), True),
            "group4": (const("kProbeGroup", 4), True),
            "group16": (const("kProbeGroup", 16), True),
            "keys1": (const("kProbeKeys", 1), True),
            "keys2": (const("kProbeKeys", 2), True),
            "keys8": (const("kProbeKeys", 8), True),
            "block1024": (const("kProbeThreads", 1024), True),
            "one_thread": (one_thread, True),
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
            "block64": (const("kWalkBlockMin", 64), True),
            "block128": (const("kWalkBlockMin", 128), True),
            "block512": (const("kWalkBlockMin", 512), True),
            "warps_only": (const("kWalkBlockMin", 1 << 30), True)}


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


def main(argv):
    if not torch.cuda.is_available():
        print("hot_scatter_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ps.device_hash import dynamic_map_lookup

    with open(SRC) as f:
        srcs = variants(f.read())
    unknown = set(argv) - set(srcs)
    if unknown:
        print(f"hot_scatter_probe: no variant {sorted(unknown)}; variants: {list(srcs)}",
              file=sys.stderr)
        return 2
    if argv:
        srcs = {k: v for k, v in srcs.items() if k in argv}
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(kv[0], kv[1][0]), srcs.items())))
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    heavy = cs.hot_push_inputs(rng, cs.BATCH * cs.SLOTS, cs.HOT_CAP, dev)
    hot = cs.hot_path_push(rng, dev)
    cfg = cs.hot_cfg("adagrad", "adagrad", True)
    tier = cs.tier_columns(np.random.default_rng(12), "adagrad", "adagrad", dev)
    want = hk._sort_rows_plain(hot[0], cs.HOT_CAP)
    # phase 2's probes: B2 at banks 1 on the batch, B3 at banks 4 on one
    # shard's slice and on the batch
    resident, _, th, tl, ptier = cs.probe_batch(dev)
    ms = {banks: cs.banked_map(cs.HOT_CAP, banks, resident, dev)[0].device_state()
          for banks in (1, 4)}
    b2 = lambda: hk.hot_probe_gather(ms[1], th, tl, ptier, probe_buckets=2, banks=1)
    b3 = {"b3_shard": lambda: hk.hot_probe(ms[4], th[:cs.SHARD_N], tl[:cs.SHARD_N],
                                           probe_buckets=2, banks=4),
          "b3_batch": lambda: hk.hot_probe(ms[4], th, tl, probe_buckets=2, banks=4)}
    want_b2 = hk.hot_probe_gather_plain(ms[1], th, tl, ptier, probe_buckets=2, banks=1)
    want_b3 = dynamic_map_lookup(ms[4], th, tl, 2, 4)
    built = hk._LIB
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                hk._LIB = lib
                right = srcs[name][1]
                line = {"variant": name, "round": rnd}
                if name in PROBE_VARIANTS:
                    if right:
                        got = b2()
                        line["probe_equal"] = (
                            all(cs.bitwise_equal(g, w) for g, w in zip(got, want_b2))
                            and cs.bitwise_equal(b3["b3_batch"](), want_b3)
                            and cs.bitwise_equal(b3["b3_shard"](), want_b3[:cs.SHARD_N]))
                    line["b2_ms"] = cs.time_cuda(b2)[0]
                    for k, fn in b3.items():
                        line[f"{k}_ms"] = cs.time_cuda(fn)[0]
                if name not in PROBE_VARIANTS[1:]:
                    line["sort_bounded_ms"] = cs.time_cuda(
                        lambda: hk._sort_rows(hot[0], cs.HOT_CAP))[0]
                    line["sort_full_ms"] = cs.time_cuda(lambda: hk._sort_rows(hot[0]))[0]
                    if right:  # B4 walks the sort's output: only a right sort is safe
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
    sys.exit(main(sys.argv[1:]))
