#!/usr/bin/env python3
"""How far apart two correct runs of phase 20's recsys train steps are, by
the host table their rows come from.

    python3 recsys_parity_probe.py [SEED ...]

Needs one CUDA device. For each family of ``chip_smoke``'s phase 20 leg A
(GRU4Rec, DSSM, TDM) and each seed given (default 0), it runs the
``RS_STEPS`` steps at phase 20's shapes over three host tables, which create
the pass's rows:

- ``python``: the Python shards at shard_num 4, the table phase 20 holds to
  ``RS_TOL``;
- ``native4``: the native engine at shard_num 4, the port's default table.
  It seeds a new row from ``key ^ (seed + key % shard_num)``, so at seed 0
  every aligned block of 4 keys starts from one embed_w;
- ``native1``: the native engine at shard_num 1, whose per-key draws are
  all distinct.

For each it prints the share of distinct embed_w among the pass's rows and
the readings phase 20 bounds (loss relative, params and cache columns as a
share of each tensor's largest magnitude) for:

- ``card_vs_cpu``: what phase 20 bounds;
- ``card_vs_card``: the card's own run-to-run spread;
- ``cpu_vs_cpu_ulp``: the CPU against the CPU with every embedx input moved
  by one ulp, the difference that f32 rounding alone makes on these rows.

One JSON line a reading, then the card's name and power limit. Exits
non-zero without a CUDA device.
"""

import json
import sys

import numpy as np
import torch

import chip_smoke as cs

TABLES = (("python", "python", 4), ("native4", "native", 4), ("native1", "native", 1))


def readings(a, b):
    """Phase 20's three readings of run ``a`` against run ``b``."""
    return {"loss": max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a[0], b[0])),
            "params": max(cs.rs_share(a[1][k], b[1][k]) for k in b[1]),
            "cache": max(cs.rs_share(a[2][k], b[2][k]) for k in b[2])}


def main(argv):
    if not torch.cuda.is_available():
        print("recsys_parity_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    for seed in [int(a) for a in argv] or [0]:
        for family in ("gru4rec", "dssm", "tdm"):
            inp = cs.rs_family_inputs(family, seed)
            model = cs.rs_model(family, seed)
            for name, backend, shards in TABLES:
                table, cfg, caches = cs.rs_caches(inp, (dev, dev, cpu, cpu), backend, shards)
                try:
                    nudged = caches[3].state["embedx_w"]
                    rows = torch.from_numpy(caches[3].lookup(inp["keys"]))
                    nudged[rows] = torch.nextafter(nudged[rows], torch.tensor(np.inf))
                    embed_w = table.export_full(inp["keys"])[0][:, 5]
                    runs = [cs.rs_run_family(family, inp, model, cfg, c, d)
                            for c, d in zip(caches, (dev, dev, cpu, cpu))]
                finally:
                    table.close()
                for what, a, b in (("card_vs_cpu", 0, 2), ("card_vs_card", 1, 0),
                                   ("cpu_vs_cpu_ulp", 3, 2)):
                    print(json.dumps({"family": family, "seed": seed, "table": name,
                                      "distinct_embed_w": len(np.unique(embed_w)) / len(embed_w),
                                      "what": what, **readings(runs[a], runs[b])}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
