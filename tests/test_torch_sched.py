"""The port's deterministic concurrency explorer
(``paddle_tpu_torch.testing.sched``) and its protocol harnesses
(``paddle_tpu_torch.testing.models``, ``testing.run``) against the JAX
package's (``paddle_tpu.testing.sched`` over the repo's JAX harness models
and gate), on the CPU: the cases of ``tests/test_sched.py``.

Each scenario is a function of a namespace (``sync``, ``sched``,
``models``, ``run``), run through the JAX side and through the port, and
the records compared with ``==``: a failure's kind, message and choice
list, its replay seed, shrunk schedules, the number of schedules a sweep
ran and whether it exhausted its space, the lock edges it observed, and
whole decision logs (every runnable set and pick) of seeded random walks
— equal seeds give equal choice traces on the shared models. The port's
copy of the ``LOCK ORDER``/``LOCK LEAF`` grammar is held against the JAX
repo's lint parsers line for line. The harness models over real classes
(the fleet's drain, the checkpoint writer) and the SSD miniature are in
``tests/test_torch_sched_models.py``, the reconciler's miniature in
``tests/test_torch_sched_reconciler.py``.

Tolerance: exact.
"""

import importlib
import importlib.util
import json
import os
import queue
import subprocess
import sys
import threading
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_side():
    # the JAX repo's harness models import `paddle_tpu` from the checkout
    models = _load(os.path.join(REPO, "tools", "sched", "models.py"), "jax_sched_models")
    if os.path.join(REPO, "tools", "sched") not in sys.path:
        sys.path.insert(0, os.path.join(REPO, "tools", "sched"))
    sys.modules.setdefault("models", models)
    run = _load(os.path.join(REPO, "tools", "sched", "run.py"), "jax_sched_run")
    return types.SimpleNamespace(
        name="jax", sync=importlib.import_module("paddle_tpu.core.sync"),
        sched=importlib.import_module("paddle_tpu.testing.sched"), models=models, run=run,
        decl_files=[os.path.join(REPO, f) for f in models.DECL_FILES],
        cli=[sys.executable, os.path.join(REPO, "tools", "sched", "run.py")])


def _port_side():
    models = importlib.import_module("paddle_tpu_torch.testing.models")
    return types.SimpleNamespace(
        name="port", sync=importlib.import_module("paddle_tpu_torch.core.sync"),
        sched=importlib.import_module("paddle_tpu_torch.testing.sched"), models=models,
        run=importlib.import_module("paddle_tpu_torch.testing.run"),
        decl_files=list(models.DECL_FILES),
        cli=[sys.executable, "-m", "paddle_tpu_torch.testing.run"])


JAX = _jax_side()
PORT = _port_side()


def both(scenario, *args):
    """The scenario's record through the JAX side, then the port's; they
    must be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


def decls(p):
    return p.sched.load_lock_order(p.decl_files)


def failure(f):
    if f is None:
        return None
    return {"kind": f.kind, "message": f.message, "choices": list(f.choices), "seed": f.seed}


def dfs(p, model, bound, max_schedules=200_000, with_decls=True):
    ex = p.sched.Explorer(model, order_decls=decls(p) if with_decls else None)
    f, exhausted = ex.explore_dfs(bound=bound, max_schedules=max_schedules)
    return ex, {"failure": failure(f), "exhausted": exhausted,
                "schedules": ex.schedules_run, "edges": sorted(ex.observed_edges)}


def walk(p, model, n, seed, with_decls=True):
    ex = p.sched.Explorer(model, order_decls=decls(p) if with_decls else None)
    f = ex.explore_random(n, base_seed=seed)
    return ex, {"failure": failure(f), "schedules": ex.schedules_run,
                "edges": sorted(ex.observed_edges)}


def replay(ex, choices=None, seed=None):
    s = ex.replay_choices(choices) if choices is not None else ex.replay_seed(seed)
    return {"failure": failure(s.failure), "log": list(s.decision_log)}


# -- the sync layer's pass-through ---------------------------------------------------


def _passthrough(p):
    s = p.sync
    assert s.current_scheduler() is None
    t = s.Thread(target=lambda: None, name="smoke")
    t.start()
    t.join()
    return [isinstance(s.Lock(), type(threading.Lock())),
            isinstance(s.RLock(), type(threading.RLock())),
            isinstance(s.Condition(), threading.Condition), isinstance(s.Event(), threading.Event),
            isinstance(s.Semaphore(2), threading.Semaphore),
            isinstance(s.Queue(maxsize=3), queue.Queue), isinstance(t, threading.Thread)]


def test_shim_passthrough_returns_raw_primitives():
    assert both(_passthrough) == [True] * 7


# -- toy protocols -------------------------------------------------------------------


def _abba(p):
    def model(sched):
        a = p.sync.Lock(name="a_mu")
        b = p.sync.Lock(name="b_mu")

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        sched.spawn(t1, "t1")
        sched.spawn(t2, "t2")

    return model


def _abba_walk(p):
    ex, rec = walk(p, _abba(p), 200, 7, with_decls=False)
    seed = rec["failure"]["seed"]
    rec["replays"] = [replay(ex, seed=seed), replay(ex, seed=seed)]
    return rec


def test_random_walk_finds_abba_deadlock_and_seed_replays():
    got = both(_abba_walk)
    assert got["failure"]["kind"] == "deadlock" and got["failure"]["seed"] is not None
    r1, r2 = got["replays"]
    assert r1["failure"]["kind"] == "deadlock" and r1 == r2


def _abba_dfs(p):
    ex, rec = dfs(p, _abba(p), 2, with_decls=False)
    f = ex.explore_dfs(bound=2)[0]
    small = ex.shrink(f)
    rec["small"] = failure(small)
    rec["again"] = replay(ex, choices=small.choices)
    return rec


def test_dfs_finds_abba_deadlock_and_shrinks():
    got = both(_abba_dfs)
    assert got["failure"]["kind"] == "deadlock" and got["small"]["kind"] == "deadlock"
    assert len(got["small"]["choices"]) <= 3
    assert got["again"]["failure"]["kind"] == "deadlock"


def _clean(p):
    def model(sched):
        mu = p.sync.Lock(name="mu")
        box = []

        def worker(i):
            with mu:
                box.append(i)

        for i in range(2):
            sched.spawn(lambda i=i: worker(i), f"w{i}")
        sched.on_finish(lambda: sched.check(sorted(box) == [0, 1], "lost increment"))

    return dfs(p, model, 2, with_decls=False)[1]


def test_dfs_exhausts_clean_protocol():
    got = both(_clean)
    assert got["failure"] is None and got["exhausted"] and got["schedules"] > 1


def _lossy(p):
    def model(sched):
        mu = p.sync.Lock(name="mu")
        cv = p.sync.Condition(mu, name="cv")
        state = {"ready": False}

        def waiter():
            with mu:
                while not state["ready"]:
                    cv.wait()

        def setter():
            with mu:
                state["ready"] = True  # the bug: no cv.notify()

        sched.spawn(waiter, "waiter")
        sched.spawn(setter, "setter")

    return dfs(p, model, 2, with_decls=False)[1]


def test_lost_wakeup_detected():
    assert both(_lossy)["failure"]["kind"] == "lost-wakeup"


def _nest(p, decl, inner_first):
    def model(sched):
        x = p.sync.Lock(name="leaf_mu" if not inner_first else "inner_mu")
        y = p.sync.Lock(name="other_mu" if not inner_first else "outer_mu")

        def t():
            with x:
                with y:
                    pass

        sched.spawn(t, "t")

    ex = p.sched.Explorer(model, order_decls=decl)
    f, _ = ex.explore_dfs(bound=0)
    return failure(f)


def test_dynamic_lock_order_leaf_violation():
    got = both(_nest, ({}, {"leaf_mu"}), False)
    assert got["kind"] == "lock-order" and "LEAF" in got["message"]


def test_dynamic_lock_order_inversion():
    got = both(_nest, ({"outer_mu": {"inner_mu"}, "inner_mu": set()}, set()), True)
    assert got["kind"] == "lock-order" and "inversion" in got["message"]


# -- the three-way harness: checkpoint gate × reshard cutover × failover ---------------

#: the torn-cut schedule the explorer found in the gate that did not suspend
#: the failover coordinator: four choices, shrunk by the explorer
TORN_CUT_SCHEDULE = ["gate", "gate", "gate", "failover"]


def _torn_cut(p):
    ex, rec = dfs(p, p.models.three_way_model(gate_suspends=False, with_writer=False), 2,
                  max_schedules=5000)
    f = ex.explore_dfs(bound=2, max_schedules=5000)[0]
    rec["small"] = failure(ex.shrink(f))
    rec["pinned"] = replay(ex, choices=TORN_CUT_SCHEDULE)
    return rec


def test_three_way_prefix_bug_found_and_pins():
    got = both(_torn_cut)
    assert got["failure"]["kind"] == "invariant" and "torn cut" in got["failure"]["message"]
    assert len(got["small"]["choices"]) <= len(TORN_CUT_SCHEDULE)
    assert "torn cut" in got["pinned"]["failure"]["message"]


def _naive_suspend(p):
    return dfs(p, p.models.three_way_model(depth_counted=False, with_writer=False), 2,
               max_schedules=20000)[1]


def test_three_way_naive_suspend_clobbers_routing():
    got = both(_naive_suspend)
    assert got["failure"]["kind"] == "invariant" and "clobber" in got["failure"]["message"]


def _three_way_pb2(p):
    ex, rec = dfs(p, p.models.three_way_model(with_writer=False), 2, max_schedules=50000)
    rec["pinned"] = replay(ex, choices=TORN_CUT_SCHEDULE)
    return rec


def test_three_way_fixed_protocol_pb2_exhausts_clean():
    got = both(_three_way_pb2)
    assert got["failure"] is None, got["failure"]
    assert got["exhausted"] and got["schedules"] > 1000
    assert got["pinned"]["failure"] is None


def _three_way_walk(p):
    ex, rec = walk(p, p.models.three_way_model(), 400, 20260807)
    rec["traces"] = [replay(ex, seed=s)["log"] for s in (1, 2, 3)]
    return rec


def test_three_way_random_walk_with_writer_clean():
    got = both(_three_way_walk)
    assert got["failure"] is None and got["schedules"] == 400


# -- dynamic lock-order observations against the declarations ---------------------------


def _observed(p):
    ex, rec = walk(p, p.models.three_way_model(), 200, 3)
    rec["violations"] = p.run.cross_check(ex.observed_edges, decls(p))
    return rec


def test_observed_edges_agree_with_declarations():
    got = both(_observed)
    assert got["edges"], "the harness observed no lock nesting at all"
    assert got["violations"] == []


def _cross(p):
    d = ({"a_mu": {"b_mu"}, "b_mu": set()}, {"leaf_mu"})
    return p.run.cross_check({("leaf_mu", "x_mu"), ("b_mu", "a_mu")}, d), \
        p.run.cross_check({("a_mu", "b_mu"), ("x_mu", "leaf_mu")}, d)


def test_cross_check_catches_leaf_and_inversion():
    bad, ok = both(_cross)
    assert len(bad) == 2 and any("LEAF" in v for v in bad) and any("inverts" in v for v in bad)
    assert ok == []


def _lint_parsers():
    lint = os.path.join(REPO, "tools", "lint")
    if lint not in sys.path:
        sys.path.insert(0, lint)
    return importlib.import_module("py_locks"), importlib.import_module("lock_order")


#: declaration lines the two grammars must read the same way, well- and
#: ill-formed, in both comment forms
_GRAMMAR_LINES = [
    "# LOCK ORDER: a_mu < b_mu < c_mu", "# LOCK LEAF: x_mu y_mu", "#LOCK LEAF:z_mu",
    "    self._mu = _sync.Lock()  # LOCK LEAF: _mu", "# LOCK ORDER: a_mu", "# LOCK LEAF: a-b",
    "# LOCK ORDER: a_mu < b-c", "// LOCK ORDER: s < t < u", "//   LOCK LEAF: io_mu",
    "// LOCK ORDER: s <", "x = 1  # plain comment", "# LOCK: tagged_mu",
]


def test_load_lock_order_matches_py_locks_grammar():
    """The port's copy of the grammar against the JAX repo's lint parsers,
    on every declaration file of both packages and on the lines above; then
    the JAX test's checks on the port's declarations."""
    py_locks, lock_order = _lint_parsers()
    parse = PORT.sched.parse_lock_decls
    files = JAX.decl_files + [os.path.join(REPO, f) for f in PORT.decl_files]
    for path in files:
        lines = open(path, encoding="utf-8").read().splitlines()
        leader = "//" if path.endswith((".cc", ".h")) else "#"
        ref = (lock_order._parse_order if leader == "//" else py_locks._parse_decls)(lines, path)
        e, l, bad = parse(lines, leader)
        assert (e, l) == ref[:2], path
        assert [d.line for d in ref[2]] == [int(b.split(":")[0].split()[1]) for b in bad], path
    for leader, ref_parse in (("#", py_locks._parse_decls), ("//", lock_order._parse_order)):
        e, l, bad = parse(_GRAMMAR_LINES, leader)
        ref = ref_parse(_GRAMMAR_LINES, "lines")
        assert (e, l) == ref[:2], leader
        assert [d.line for d in ref[2]] == [int(b.split(":")[0].split()[1]) for b in bad]
    edges, leaves = decls(PORT)
    assert "_mu" in edges.get("control_mu", set())
    assert {"_mu", "_step_mu", "_susp_mu"} <= leaves
    # the port's declarations read the same as the JAX package's
    assert decls(PORT) == decls(JAX)


# -- the CLI gate --------------------------------------------------------------------


def _cli_gate(p, root):
    out_json = os.path.join(root, f"{p.name}.json")
    out = subprocess.run(p.cli + ["--harness", "fleet", "--seed", "11", "--json", out_json],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.load(open(out_json))
    h = summary["harnesses"]["fleet"]
    for part in ("dfs", "random"):
        h[part].pop("wall_ms")
    summary.pop("wall_ms")
    return summary


def test_sched_cli_gate_fleet_harness(tmp_path):
    got = both(_cli_gate, str(tmp_path))
    assert got["ok"]
    h = got["harnesses"]["fleet"]
    assert h["dfs"]["exhausted"] and h["random"]["base_seed"] == 11
    assert "observed_edges" in h


def _cli_replay(p):
    out = subprocess.run(p.cli + ["--replay", "three_way", "--seed", "123456"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_sched_cli_replay_seed():
    got = both(_cli_replay)
    assert "ran clean" in got
