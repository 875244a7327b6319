#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU (H100) and check it.

    python3 chip_smoke.py

Needs one CUDA device, ``g++`` and ``nvcc``; builds the host library and
the CUDA kernel from the checkout at first use (into
``paddle_tpu_torch/_build/``). Exits non-zero, with no result line, when
there is no CUDA device, when the package is missing, or when any phase
fails. Phases:

1. device: the card's name and power limit, build seconds;
2. kernel vs plain: ``ctr_sparse_rows`` on the card against its plain
   PyTorch version on the same inputs at the main path's shape
   (n = 4096·26 rows, dim 8) over the rule matrix, bitwise; kernel and
   plain times (CUDA events, L2 flushed before each launch) beside the
   HBM byte bound;
3. main path at full width: DeepFM (26 slots, 13 dense, dim 8, DNN
   400³) GPUPS pass training over a 16-shard host table and a 2^21-row
   device cache, batch 4096, slab 8, 6 slabs (1 warm-up): losses finite
   and falling, one kernel launch per step, samples/s; then a predict
   batch through ``serving_pull`` and the flush back to the host table;
4. card vs CPU: the same small run on ``cuda`` and ``cpu`` from the same
   weights, and the key hash bit-equal on both;
5. the ``kernels`` JSON line, then the card line, then the result line.

``--profile DIR`` also runs two more main-path slabs under
torch.profiler (after the launch count is read) and prints where the
step's time goes; the chrome trace goes to DIR.
"""

import concurrent.futures
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor f32, NVIDIA data sheet
RULE_PAIRS = [("naive", "naive"), ("adagrad", "adagrad"),
              ("std_adagrad", "std_adagrad"), ("adam", "adam"),
              ("adagrad", "adam"), ("naive", "std_adagrad")]
HYPER = dict(lr=0.05, initial_g2sum=3.0, weight_bounds=(-10.0, 10.0), beta1=0.9,
             beta2=0.999, eps=1e-8, nonclk_coeff=0.1, click_coeff=1.0,
             embedx_threshold=1.5)
BATCH, SLOTS, DENSE, DIM, SLAB = 4096, 26, 13, 8, 8
PASS_KEYS, CAPACITY, N_SLABS = 1 << 20, 1 << 21, 6  # 1 warm-up slab


def log(msg):
    print(msg, flush=True)


def card_line():
    """`name, power.limit` as nvidia-smi prints them (or a note why not)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def build_all():
    """Build the host library and the kernel, in parallel; seconds each."""
    from paddle_tpu_torch.ops.sparse_optimizer import load_kernel
    from paddle_tpu_torch.ps.native import load_native

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        host, kern = ex.submit(timed, load_native), ex.submit(timed, load_kernel)
        return host.result(), kern.result()


# -- phase 2: the kernel against its plain version ---------------------------

def rows_inputs(rng, n, dim, embed_rule, embedx_rule, dev):
    from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim

    es, xs = rule_state_dim(embed_rule, 1), rule_state_dim(embedx_rule, dim)
    f = np.float32
    st = [rng.uniform(0, 4, n).astype(f), rng.uniform(0, 1, n).astype(f),
          rng.normal(size=(n, 1)).astype(f), rng.uniform(0, 1, (n, es)).astype(f),
          rng.normal(size=(n, dim)).astype(f), rng.uniform(0, 1, (n, xs)).astype(f),
          (rng.random(n) < 0.5).astype(f)]
    if embed_rule == "adam":
        st[3][:, -2:] = 0.9
    if embedx_rule == "adam":
        st[5][:, -2:] = rng.uniform(0.5, 0.99, (n, 2)).astype(f)
    deltas = [rng.integers(0, 3, n).astype(f), (rng.random(n) < 0.4).astype(f),
              rng.normal(size=(n, 1)).astype(f), rng.normal(size=(n, dim)).astype(f)]
    to = lambda a: torch.from_numpy(a).to(dev)
    return tuple(to(a) for a in st), [to(a) for a in deltas]


def plain(cols, deltas, embed_rule, embedx_rule, create_applies_grad):
    from paddle_tpu_torch.ops.sparse_optimizer import fused_row_update

    h = HYPER
    return fused_row_update(
        *cols, *deltas, embed_rule=embed_rule, embedx_rule=embedx_rule,
        dim=cols[4].shape[1], lr=h["lr"], initial_g2sum=h["initial_g2sum"],
        wmin=h["weight_bounds"][0], wmax=h["weight_bounds"][1], beta1=h["beta1"],
        beta2=h["beta2"], eps=h["eps"], nonclk_coeff=h["nonclk_coeff"],
        click_coeff=h["click_coeff"], embedx_threshold=h["embedx_threshold"],
        create_applies_grad=create_applies_grad)


def ulp_diff(a, b):
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def time_cuda(fn, reps=25):
    """(device ms, call ms): medians over ``reps`` calls of ``fn``, each
    after a write of 256 MB that evicts the 50 MB L2 (the main path's
    rows arrive cold).

    Device ms: a ~10 ms spin kernel runs before the start event, so the
    host has enqueued all of ``fn``'s launches before the card reaches
    them and the events bracket device work only. Call ms: the same
    events with the card idle at the call, so the host's time to issue
    the launches shows too (the cost a step pays when the host is the
    bottleneck)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def one(hide_host):
        flush.fill_(1.0)
        if hide_host:
            torch.cuda._sleep(20_000_000)  # cycles: ~10 ms at 1.98 GHz
        else:
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    dev = [one(True) for _ in range(reps + 3)][3:]
    call = [one(False) for _ in range(reps + 3)][3:]
    return float(np.median(dev)), float(np.median(call))


def kernel_bytes(n, dim, es, xs):
    """Bytes the function must move: each input read once (7 state
    columns + 4 delta columns), each output written once (7 columns)."""
    row_in = (1 + 1 + 1 + es + dim + xs + 1) + (1 + 1 + 1 + dim)
    row_out = 1 + 1 + 1 + es + dim + xs + 1
    return 4 * n * (row_in + row_out)


def kernel_ops(n, dim, embed_rule, embedx_rule):
    """f32 operations of the formulas per row (m32 counts 3: the product
    and its `t + 0*t` seal), for the rules this run uses."""
    per_rule = {"naive": lambda d: 6 * d,
                "adagrad": lambda d: 5 + 14 * d,
                "std_adagrad": lambda d: 13 * d,
                "adam": lambda d: 6 + 24 * d}
    return n * (14 + per_rule[embed_rule](1) + per_rule[embedx_rule](dim))


def phase_kernel(dev):
    from paddle_tpu_torch.ops.sparse_optimizer import ctr_sparse_rows, rule_state_dim

    n = BATCH * SLOTS
    rng = np.random.default_rng(0)
    max_abs = 0.0
    for embed_rule, embedx_rule in RULE_PAIRS:
        for cag in (True, False):
            cols, deltas = rows_inputs(rng, n, DIM, embed_rule, embedx_rule, dev)
            got = ctr_sparse_rows(cols, *deltas, embed_rule=embed_rule,
                                  embedx_rule=embedx_rule, create_applies_grad=cag,
                                  **HYPER)
            torch.cuda.synchronize()
            want = plain(cols, deltas, embed_rule, embedx_rule, cag)
            created = int(((want[6] > 0) & (cols[6] == 0)).sum())
            diffs = [(float((g - w).abs().nan_to_num(0.0).max()) if g.numel() else 0.0,
                      ulp_diff(g, w)) for g, w in zip(got, want)]
            bitwise = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                          for g, w in zip(got, want) if g.numel())
            mabs = max(d[0] for d in diffs)
            max_abs = max(max_abs, mabs)
            log(f"kernel ctr_sparse_rows {embed_rule}/{embedx_rule} "
                f"create_applies_grad={cag}: n={n} created={created} "
                f"bitwise={bitwise} max_abs={mabs} max_ulp={max(d[1] for d in diffs)} "
                f"(stated bound: bitwise, 0 ulp)")
            if not bitwise:
                raise AssertionError(f"kernel disagrees with plain for "
                                     f"{embed_rule}/{embedx_rule} cag={cag}")

    # times at the main path's configuration (adagrad/adagrad, dim 8)
    cols, deltas = rows_inputs(np.random.default_rng(1), n, DIM, "adagrad", "adagrad", dev)
    kw = dict(embed_rule="adagrad", embedx_rule="adagrad", **HYPER)
    ms, call_ms = time_cuda(lambda: ctr_sparse_rows(cols, *deltas, **kw))
    plain_ms, plain_call_ms = time_cuda(lambda: plain(cols, deltas, "adagrad", "adagrad", True))
    es, xs = rule_state_dim("adagrad", 1), rule_state_dim("adagrad", DIM)
    nbytes = kernel_bytes(n, DIM, es, xs)
    nops = kernel_ops(n, DIM, "adagrad", "adagrad")
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops}


# -- phase 3: the main path at full width -------------------------------------

def phase_main_path(dev, card, profile_dir=None):
    from paddle_tpu_torch.models.ctr import (CtrConfig, DeepFM, make_ctr_train_step_slab,
                                             make_random_packs, serving_pull)
    from paddle_tpu_torch.ops.sparse_optimizer import ctr_sparse_rows
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    rng = np.random.default_rng(0)
    cfg = CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400))
    table = MemorySparseTable(TableConfig(
        shard_num=16, accessor_config=AccessorConfig(embedx_dim=DIM)))
    try:
        cache = HbmEmbeddingCache(table, CacheConfig(capacity=CAPACITY, embedx_dim=DIM,
                                                     embedx_threshold=0.0),
                                  device=dev, device_map=True)
        pool = rng.integers(0, PASS_KEYS // SLOTS + 1, size=(PASS_KEYS, SLOTS)).astype(np.uint64)
        pool += np.arange(SLOTS, dtype=np.uint64) << np.uint64(32)
        t0 = time.perf_counter()
        n_uniq = cache.begin_pass(pool.reshape(-1))
        log(f"main path: begin_pass {pool.size} keys -> {n_uniq} uniques in "
            f"{time.perf_counter() - t0:.2f} s (host)")

        model = DeepFM(cfg, generator=torch.Generator().manual_seed(0))
        opt = Adam(learning_rate=1e-3)
        params = {k: v.detach().to(dev) for k, v in model.named_parameters()}
        opt_state = opt.init(params)
        step = make_ctr_train_step_slab(model, opt, cache.config, np.arange(SLOTS),
                                        BATCH, DENSE, SLAB, device=dev)
        n_slabs, warm = N_SLABS, 1
        slabs = [torch.from_numpy(np.stack(make_random_packs(rng, pool, BATCH, DENSE, SLAB))).to(dev)
                 for _ in range(n_slabs)]
        first_pack = slabs[0][0].cpu().numpy()
        touched = (first_pack[:BATCH * SLOTS * 4].view(np.uint32).astype(np.uint64)
                   .reshape(BATCH, SLOTS) + (np.arange(SLOTS, dtype=np.uint64) << np.uint64(32)))
        sample = np.unique(touched.reshape(-1))[:512]
        before, _ = table.export_full(sample)
        torch.cuda.synchronize()

        ctr_sparse_rows.launches = 0
        losses = []
        state, map_state = cache.state, cache.device_map.state
        for i, packed in enumerate(slabs):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            params, opt_state, state, slab_losses = step(params, opt_state, state,
                                                         map_state, packed)
            losses.append(slab_losses)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ctr_sparse_rows.launches
        steps = n_slabs * SLAB
        losses = torch.stack(losses).cpu().numpy()
        sps = BATCH * SLAB * (n_slabs - warm) / dt
        log(f"main path: {steps} steps, ctr_sparse_rows launches={launches}, "
            f"slab mean losses={[round(float(x), 5) for x in losses.mean(axis=1)]}")
        log(f"main path: {sps:.1f} samples/s (batch {BATCH}, slab {SLAB}, "
            f"{n_slabs - warm} timed slabs, {dt:.4f} s) on {card}")
        assert np.isfinite(losses).all(), "non-finite loss"
        assert losses[-1].mean() < losses[0].mean(), "loss did not fall"
        assert launches == steps, f"kernel launches {launches} != steps {steps}"
        if profile_dir is not None:
            params, opt_state, state = profile_slabs(
                step, params, opt_state, state, map_state, slabs[1:3], profile_dir)

        # predict: serving_pull + forward -> sigmoid, one batch
        pk = slabs[-1][0]
        lo32 = pk[:BATCH * SLOTS * 4].view(torch.int32).reshape(BATCH, SLOTS)
        dense_x = pk[BATCH * SLOTS * 4:BATCH * SLOTS * 4 + BATCH * DENSE * 2] \
            .view(torch.float16).reshape(BATCH, DENSE).float()
        with torch.no_grad():
            emb = serving_pull(state, map_state, torch.arange(SLOTS, device=dev), lo32)
            pred = torch.sigmoid(torch.func.functional_call(model, params, (emb, dense_x)))
        assert pred.shape == (BATCH,) and bool(torch.isfinite(pred).all()), "bad predictions"
        log(f"predict: {BATCH} sigmoid outputs, finite, mean {float(pred.mean()):.5f}")

        cache.end_pass()
        after, found = table.export_full(sample)
        changed = (after != before).any(axis=1)
        assert found.all() and changed.all(), \
            f"flush-back: {int((~changed).sum())} of {len(sample)} touched rows unchanged"
        log(f"end_pass: {len(sample)} touched keys read back from the table, all changed "
            f"(show {before[:, 3].mean():.3f} -> {after[:, 3].mean():.3f})")
        return launches, sps
    finally:
        table.close()


def profile_slabs(step, params, opt_state, state, map_state, slabs, out_dir):
    """``--profile DIR``: run ``slabs`` more main-path slabs under
    torch.profiler; print device time by kernel, host time by op and the
    card's busy share of the window, and write a chrome trace to DIR."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for packed in slabs:
            params, opt_state, state, _ = step(params, opt_state, state, map_state, packed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "main_path_trace.json"))
    evs = prof.key_averages()
    n_steps = len(slabs) * SLAB
    # kernel events carry the device time once; an op's self device time
    # is the time of the kernels it launched (the same time again)
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels) / n_steps
    log(f"profile: {n_steps} steps, wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% busy, {100 - 100 * busy_ms / wall_ms:.1f}% idle), "
        f"{n_kernels:g} device kernels/step")
    ops = sorted((e for e in evs if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    for e in ops[:12]:
        log(f"profile device by op: {e.self_device_time_total / 1e3 / n_steps:.4f} ms/step "
            f"x{e.count / n_steps:g}/step {e.key[:80]}")
    host = sorted((e for e in evs if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        log(f"profile host: {e.self_cpu_time_total / 1e3 / n_steps:.4f} ms/step "
            f"x{e.count / n_steps:g}/step {e.key[:80]}")
    return params, opt_state, state


# -- phase 4: the same small run on the card and on the CPU --------------------

def small_run(device, weights):
    from paddle_tpu_torch.models.ctr import (CtrConfig, DeepFM, make_ctr_train_step_packed,
                                             make_random_packs)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    S, D, B = 2, 4, 64
    table = MemorySparseTable(TableConfig(shard_num=2,
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    try:
        cache = HbmEmbeddingCache(table, CacheConfig(capacity=4096, embedx_dim=4,
                                                     embedx_threshold=0.0),
                                  device=device, device_map=True)
        rng = np.random.default_rng(3)
        pool = rng.integers(1, 1 << 18, size=(200, S)).astype(np.uint64)
        pool += np.arange(S, dtype=np.uint64) << np.uint64(32)
        cache.begin_pass(pool.reshape(-1))
        model = DeepFM(CtrConfig(S, D, 4, (16, 16)))
        opt = Adam(1e-2)
        params = {k: v.to(device) for k, v in weights.items()}
        opt_state = opt.init(params)
        step = make_ctr_train_step_packed(model, opt, cache.config, np.arange(S), B, D,
                                          device=device)
        losses = []
        state = cache.state
        for pk in make_random_packs(rng, pool, B, D, 4, p_click=0.4):
            params, opt_state, state, loss = step(params, opt_state, state,
                                                  cache.device_map.state,
                                                  torch.from_numpy(pk).to(device))
            losses.append(float(loss))
        return np.asarray(losses), {k: v.cpu().numpy() for k, v in state.items()}, \
            {k: v.cpu().numpy() for k, v in params.items()}
    finally:
        table.close()


def phase_parity(dev):
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.ps.device_hash import _mix32

    # the int64 hash emulation on the card: low-bit keys, all-ones halves
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(1, 1 << 30, 4096, dtype=np.uint64),
                           rng.integers(0, 1 << 64, 4096, dtype=np.uint64),
                           np.asarray([0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0], np.uint64)])
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    for seed in (0x1234ABCD, 0xFFFFFFFF):
        c, g = _mix32(hi, lo, seed), _mix32(hi.to(dev), lo.to(dev), seed).cpu()
        assert torch.equal(c, g), "key hash differs between card and CPU"
    log(f"parity: key hash bit-equal on card and CPU over {len(keys)} keys")

    weights = {k: v.detach() for k, v in
               DeepFM(CtrConfig(2, 4, 4, (16, 16)),
                      generator=torch.Generator().manual_seed(1)).named_parameters()}
    gl, gs, gp = small_run(dev, weights)
    cl, cs, cp = small_run(torch.device("cpu"), weights)
    # tolerances: cuBLAS vs CPU BLAS matmul order, and CUDA index_add_
    # atomics summing duplicate rows in no fixed order
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    for k in cs:
        np.testing.assert_allclose(gs[k], cs[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in cp:
        np.testing.assert_allclose(gp[k], cp[k], rtol=1e-4, atol=1e-6, err_msg=k)
    log(f"parity: card vs CPU, 4 steps, losses {gl.tolist()} vs {cl.tolist()} "
        f"(rtol 1e-5), cache and params within rtol 1e-4 atol 1e-6")


def main(argv):
    profile_dir = None
    if argv[:1] == ["--profile"] and len(argv) == 2:
        profile_dir = argv[1]
    elif argv:
        print("usage: chip_smoke.py [--profile DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls for parity
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    host_s, kern_s = build_all()
    log(f"build: host library {host_s:.2f} s, ctr_sparse_rows kernel {kern_s:.2f} s "
        f"(g++ and nvcc in parallel)")

    k = phase_kernel(dev)
    log(f"kernel ctr_sparse_rows adagrad/adagrad n={BATCH * SLOTS}: device {k['ms']} ms, "
        f"plain {k['plain_ms']} ms, bound {k['bound_ms']} ms; per call from an idle "
        f"card (host issue included) {k['call_ms']} ms, plain {k['plain_call_ms']} ms "
        f"({k['bound_by']}: {k['bytes']} B, {k['ops']} f32 ops) on {card}")
    launches, _ = phase_main_path(dev, card, profile_dir)
    phase_parity(dev)

    kernels = [{"name": "ctr_sparse_rows", "route": "cuda",
                "source": "paddle_tpu_torch/ops/csrc/ctr_sparse_rows.cu",
                "replaces": "paddle_tpu/ops/sparse_optimizer.py:203",
                "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
