"""The obs wire's server side in the port: the trace context a traced client
stamps into every PS frame, the server spans and per-table wire counters
the ``kObsSnap`` command returns (``paddle_tpu_torch.obs.aggregate``), the
job-wide merge and the chrome-trace stitching. The server-side cases of
``tests/test_obs.py``, held against the JAX package.

- The frame header: the port's server-span and wire records have the JAX
  package's struct formats, and ``ha._HDR`` is the 28 legacy bytes plus
  the 16-byte context field.
- A traced pull fans out to both shards and each shard records one span
  against the client's pull span; untraced frames carry (0, 0) and the
  servers record nothing; the server wire rows per direction count what
  the client moved; a failover replay keeps its span id, is marked
  retried, and the promoted server holds the one span.
- Across the packages (both native services take the same frames): a
  traced port client against JAX servers, a traced JAX client against
  port servers, and each package against its own, make the same
  operations; the records each package's ``fetch_server_obs`` parses
  (command, table, request and response bytes, link to the client span;
  the server wire counters) are equal in all four.
- ``merge_snapshots`` and ``server_spans_to_chrome`` give the JAX
  functions' results on the same input.
- ``tools/timeline.py`` (imports neither package) merges the port's
  client trace with the servers' spans: lanes apart, and each server span
  inside the client span it served once both are on the wall clock.
"""

import json
import os
import sys

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu.obs import aggregate as jax_aggregate
from paddle_tpu.obs import registry as jax_registry
from paddle_tpu.obs import trace as jax_trace
from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.obs import aggregate, registry, trace
from paddle_tpu_torch.obs.registry import Registry
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.table import TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = dict(rpc=rpc, trace=trace, aggregate=aggregate, cfg=TableConfig)
JAX = dict(rpc=jax_rpc, trace=jax_trace, aggregate=jax_aggregate, cfg=JaxTableConfig)


def _cfg(tid=0):
    return TableConfig(table_id=tid, shard_num=4, accessor="ctr")


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    for t in (trace, jax_trace):
        t.stop_tracing()
        t.drain_spans()


class _Cluster:
    """Two servers of one package and a client of either."""

    def __init__(self, server_pkg, client_pkg, n=2):
        self.servers = [server_pkg["rpc"].NativePsServer(n_trainers=1) for _ in range(n)]
        self.client = client_pkg["rpc"].RpcPsClient(
            [f"127.0.0.1:{s.port}" for s in self.servers])
        self.client.create_sparse_table(0, client_pkg["cfg"](table_id=0, shard_num=4))

    def close(self):
        self.client.close()
        for s in self.servers:
            s.stop()
            s.close()


@pytest.fixture()
def cluster2():
    c = _Cluster(PORT, PORT)
    try:
        yield c.servers, c.client
    finally:
        c.close()


# -- the wire format and the merge ---------------------------------------------------


def test_wire_struct_contract():
    # the fixed header: 28 legacy bytes + the 16-byte context field, as the
    # service's ReqHeader, ha._HDR and the obs structs agree byte-wise
    assert trace.WIRE_CONTEXT_BYTES == 16
    assert ha._HDR.size == 28 + trace.WIRE_CONTEXT_BYTES == rpc._REQ_HEADER_BYTES
    assert trace.SERVER_SPAN_STRUCT.size == 64
    assert trace.SERVER_WIRE_STRUCT.size == 48
    assert trace.SERVER_SPAN_STRUCT.format == jax_trace.SERVER_SPAN_STRUCT.format
    assert trace.SERVER_WIRE_STRUCT.format == jax_trace.SERVER_WIRE_STRUCT.format
    assert rpc._OBS_SNAP == jax_rpc._OBS_SNAP == 43


def _registry_ops(pkg_registry):
    r1, r2 = pkg_registry.Registry(), pkg_registry.Registry()
    r1.set_role("a")
    r2.set_role("b")
    r1.counter("fam", t="0").inc(2)
    r2.counter("fam", t="0").inc(3)
    r2.counter("fam", t="1").inc(7)
    r1.histogram("lat", buckets=(1.0,)).observe(0.5)
    r2.histogram("lat", buckets=(1.0,)).observe(2.0)
    r1.gauge("g", t="0").set(4.0)
    r2.gauge("g", t="0").set(1.0)
    return [r1.snapshot(), r2.snapshot()]


def test_merge_snapshots_sums_counters_and_lists_processes():
    job = aggregate.merge_snapshots(_registry_ops(registry))
    assert [p["role"] for p in job["processes"]] == ["a", "b"]
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in job["metrics"]["fam"]["series"]}
    assert series[(("t", "0"),)] == 5 and series[(("t", "1"),)] == 7
    lat = job["metrics"]["lat"]["series"][0]
    assert lat["count"] == 2 and lat["buckets"] == [1, 1]
    want = jax_aggregate.merge_snapshots(_registry_ops(jax_registry))
    assert job["metrics"] == want["metrics"]
    assert [p["role"] for p in want["processes"]] == ["a", "b"]


def _bounds_conflict(pkg_registry, merge):
    r1, r2 = pkg_registry.Registry(), pkg_registry.Registry()
    r1.histogram("lat", buckets=(1.0,)).observe(0.5)
    r2.histogram("lat", buckets=(2.0, 4.0)).observe(0.5)
    return merge([r1.snapshot(), r2.snapshot()])["metrics"]


def test_merge_histogram_bounds_conflict_marked_not_corrupted():
    """Different bucket ladders across processes: the first ladder stays
    consistent (sum(buckets) == count) and the conflict is marked."""
    got = _bounds_conflict(registry, aggregate.merge_snapshots)
    s = got["lat"]["series"][0]
    assert s["bounds_conflict"] is True
    assert s["count"] == 1 and sum(s["buckets"]) == s["count"]
    assert got == _bounds_conflict(jax_registry, jax_aggregate.merge_snapshots)


def test_server_spans_to_chrome_flow_finish():
    spans = [{"trace_id": 1, "span_id": 42, "cmd": 3, "table_id": 0, "ts_us": 1000,
              "dur_us": 50, "gate_us": 10, "req_bytes": 64, "resp_bytes": 256},
             {"trace_id": 1, "span_id": 43, "cmd": 99, "table_id": 2, "ts_us": 2000,
              "dur_us": 0, "gate_us": 0, "req_bytes": 8, "resp_bytes": 0}]
    evs = aggregate.server_spans_to_chrome(spans, pid=0, process_name="shard0")
    fl = [e for e in evs if e.get("ph") == "f"]
    assert [e["id"] for e in fl] == [42, 43]
    x = [e for e in evs if e.get("ph") == "X" and e["name"] != "gate_wait"]
    assert x[0]["args"]["resp_bytes"] == 256 and x[1]["name"] == "ps_server_cmd99"
    assert sum(e["name"] == "gate_wait" for e in evs) == 1
    assert evs == jax_aggregate.server_spans_to_chrome(spans, pid=0, process_name="shard0")


# -- the RPC end to end (the port's client and servers) -------------------------------


def test_trace_context_reaches_server_and_links(cluster2):
    servers, client = cluster2
    keys = np.arange(1, 101, dtype=np.uint64)
    client.pull_sparse(0, keys)  # untraced warm-up
    for s in range(2):
        aggregate.fetch_server_obs(client, s, drain=True)
    trace.start_tracing(sample=1.0)
    with trace.span("step"):
        client.pull_sparse(0, keys)
        client.push_sparse(0, keys, np.ones((100, 12), np.float32))
    trace.stop_tracing()
    spans = {s.name: s for s in trace.drain_spans()}
    pull, push = spans["pserver_client_pull_sparse"], spans["pserver_client_push_sparse"]
    assert pull.attrs["rpc"] and pull.attrs["tx_bytes"] > 0 and pull.attrs["rx_bytes"] > 0
    assert pull.parent_id == spans["step"].span_id
    srv = []
    for s in range(2):
        _, sp = aggregate.fetch_server_obs(client, s, drain=True)
        srv.extend(sp)
    pull_srv = [s for s in srv if s["cmd"] == rpc._PULL_SPARSE]
    # the fan-out: both shards served a slice of THE SAME client span
    assert len(pull_srv) == 2 and {s["span_id"] for s in pull_srv} == {pull.span_id}
    assert {s["span_id"] for s in srv if s["cmd"] == rpc._PUSH_SPARSE} == {push.span_id}
    assert all(s["trace_id"] == pull.trace_id for s in srv)
    assert all(s["dur_us"] >= 0 and s["req_bytes"] > 0 for s in srv)


def test_untraced_requests_record_no_server_spans(cluster2):
    servers, client = cluster2
    for s in range(2):
        aggregate.fetch_server_obs(client, s, drain=True)
    client.pull_sparse(0, np.arange(1, 50, dtype=np.uint64))
    trace.start_tracing(sample=0.0)  # on, but the root is not sampled
    with trace.span("step"):
        client.pull_sparse(0, np.arange(1, 50, dtype=np.uint64))
    for s in range(2):
        _, spans = aggregate.fetch_server_obs(client, s, drain=True)
        assert spans == []  # the wire counters still accumulate
    snap, _ = aggregate.fetch_server_obs(client, 0)
    assert any(r["value"] > 0 for r in snap["metrics"]["ps_server_wire_bytes"]["series"])
    assert snap["process"]["role"] == "ps_shard_0"


def _rows_by_dir(snap):
    out: dict = {}
    for r in snap["metrics"]["ps_server_wire_rows"]["series"]:
        out[r["labels"]["dir"]] = out.get(r["labels"]["dir"], 0) + r["value"]
    return out


def test_server_wire_accounting_rows_and_directions(cluster2):
    servers, client = cluster2
    base = _rows_by_dir(aggregate.job_snapshot(client))
    keys = np.arange(1, 201, dtype=np.uint64)
    client.pull_sparse(0, keys)
    client.push_sparse(0, keys, np.ones((200, 12), np.float32))
    job = aggregate.job_snapshot(client)
    rows = _rows_by_dir(job)
    assert rows["out"] - base.get("out", 0) == 200  # pulled
    assert rows["in"] - base.get("in", 0) == 200  # pushed
    dens = job["metrics"]["ps_client_density"]["series"]
    assert any(0 < r["value"] <= 1.0 for r in dens)
    assert len(job["processes"]) >= 3  # this process and two shards


def test_op_counts_shim_exact_and_independent(cluster2):
    servers, client = cluster2
    client.reset_op_counts()
    keys = np.arange(1, 10, dtype=np.uint64)
    client.pull_sparse(0, keys)
    client.pull_sparse(0, keys)
    client.push_sparse(0, keys, np.ones((9, 12), np.float32))
    assert client.op_counts == {"pull_sparse": 2, "push_sparse": 1}
    assert client.reset_op_counts() == {"pull_sparse": 2, "push_sparse": 1}
    assert client.reset_op_counts() == {}
    other = rpc.RpcPsClient([client._conns[0].endpoint])
    try:
        other._sparse_dims[0] = client._sparse_dims[0]
        other.pull_sparse(0, keys)
        assert other.op_counts == {"pull_sparse": 1} and client.op_counts == {}
    finally:
        other.close()


def test_failover_replay_marks_span_retried_no_duplicate_ids():
    """The replayed pull keeps ITS span id (marked retried) and exactly one
    server span exists for it, on the promoted replacement."""
    sA, sB = rpc.NativePsServer(n_trainers=1), rpc.NativePsServer(n_trainers=1)
    epA, epB = f"127.0.0.1:{sA.port}", f"127.0.0.1:{sB.port}"

    class StubRouter:
        def routing(self):
            return 0, [epB]

        def allow(self, endpoint):
            return True

        def record(self, endpoint, ok):
            pass

        def failover(self, shard, bad):
            return epB

    was = get_flags(["pserver_max_retry", "pserver_timeout_ms"])
    set_flags({"pserver_max_retry": 1, "pserver_timeout_ms": 2000})
    cli = rpc.RpcPsClient([epA], router=StubRouter())
    cliB = rpc.RpcPsClient([epB])
    try:
        cli.create_sparse_table(0, _cfg())
        cliB.create_sparse_table(0, _cfg())
        keys = np.arange(1, 50, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        sA.stop()  # the primary dies under the client
        trace.start_tracing(sample=1.0)
        with trace.span("step"):
            cli.pull_sparse(0, keys)  # dies on A, replays on B
        trace.stop_tracing()
        spans = trace.drain_spans()
        pulls = [s for s in spans if s.name == "pserver_client_pull_sparse"]
        assert len(pulls) == 1 and pulls[0].attrs.get("retried") is True
        assert len({s.span_id for s in spans}) == len(spans)
        # read over the client's own (swapped) connection to B: B handles it
        # after it accounted the replayed pull on that connection
        assert cli._conns[0].endpoint == epB
        _, srv = aggregate.fetch_server_obs(cli, 0, drain=True)
        served = [s for s in srv if s["span_id"] == pulls[0].span_id]
        assert len(served) == 1 and served[0]["cmd"] == rpc._PULL_SPARSE
    finally:
        set_flags(was)
        cli.close()
        cliB.close()
        for s in (sA, sB):
            s.stop()
            s.close()


def test_prefetched_pull_carries_the_step_span(cluster2):
    """A communicator's pull issued ahead runs on a pull worker: the worker
    adopts the submitting thread's span, so the frames carry the step's
    context and each shard records the client pull span under the step."""
    from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator

    servers, client = cluster2
    comm = HalfAsyncCommunicator(client)
    comm.start()
    try:
        keys = np.arange(1, 65, dtype=np.uint64)
        trace.start_tracing(sample=1.0)
        with trace.span("step") as step:
            comm.pull_sparse_async(0, keys).result(10)
        trace.stop_tracing()
        pull = next(s for s in trace.drain_spans() if s.name == "pserver_client_pull_sparse")
        assert pull.parent_id == step.span_id and pull.trace_id == step.trace_id
        for s in range(2):
            _, spans = aggregate.fetch_server_obs(client, s, drain=True)
            assert [x["span_id"] for x in spans] == [pull.span_id]
    finally:
        comm.stop()


def test_disabled_metrics_skip_wire_accounting_entirely():
    """``FLAGS_obs_metrics=0`` at table create: no per-table handle binds
    (no density scan runs), no density series exists, and the op counts
    stay exact."""
    was = get_flags(["obs_metrics"])["obs_metrics"]
    set_flags({"obs_metrics": False})
    server = client = None
    try:
        server = rpc.NativePsServer(n_trainers=1)
        client = rpc.RpcPsClient([f"127.0.0.1:{server.port}"])
        client.create_sparse_table(0, _cfg())
        assert client._tbl_obs == {} and client.density_series(0) is None
        keys = np.arange(1, 10, dtype=np.uint64)
        client.pull_sparse(0, keys)
        client.push_sparse(0, keys, np.ones((9, 12), np.float32))
        assert client.op_counts == {"pull_sparse": 1, "push_sparse": 1}
    finally:
        set_flags({"obs_metrics": was})
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
            server.close()


# -- across the packages --------------------------------------------------------------


def _cross_scenario(server_pkg, client_pkg):
    """Traced pull + push of the same rows, then each package's parser reads
    the servers: (span records, wire deltas) with span ids replaced by the
    client span they link to."""
    c = _Cluster(server_pkg, client_pkg)
    try:
        cli, tr = c.client, client_pkg["trace"]
        keys = np.arange(1, 301, dtype=np.uint64)
        push = np.ones((300, 12), np.float32)
        cli.pull_sparse(0, keys)
        tr.start_tracing(sample=1.0)
        with tr.span("step"):
            cli.pull_sparse(0, keys)
            cli.push_sparse(0, keys, push)
        tr.stop_tracing()
        names = {s.span_id: s.name for s in tr.drain_spans()}
        # a server writes a frame's response before it accounts the frame;
        # a kObsSnap on the same connection is handled after that accounting,
        # so this read orders the readers' below after every frame above
        for s in range(2):
            client_pkg["aggregate"].fetch_server_obs(cli, s, drain=False)
        out = {}
        for pkg_name, pkg in (("port", PORT), ("jax", JAX)):
            # a client of the parsing package, to read with its own parser
            reader = pkg["rpc"].RpcPsClient([f"127.0.0.1:{s.port}" for s in c.servers])
            try:
                recs = []
                for s in range(2):
                    snap, spans = pkg["aggregate"].fetch_server_obs(reader, s, drain=False)
                    wire = {k: sorted((tuple(sorted(r["labels"].items())), r["value"])
                                      for r in snap["metrics"][k]["series"])
                            for k in ("ps_server_wire_bytes", "ps_server_wire_rows",
                                      "ps_server_requests")}
                    recs.append((wire, sorted(
                        (sp["cmd"], sp["table_id"], sp["req_bytes"], sp["resp_bytes"],
                         names.get(sp["span_id"], "orphan")) for sp in spans)))
                out[pkg_name] = recs
            finally:
                reader.close()
        assert out["port"] == out["jax"], "the two parsers read the servers differently"
        return out["port"]
    finally:
        c.close()


def test_fetch_server_obs_records_equal_across_the_packages():
    recs = {(s, c): _cross_scenario(*pkgs) for (s, c), pkgs in {
        ("port", "port"): (PORT, PORT), ("jax", "jax"): (JAX, JAX),
        ("jax", "port"): (JAX, PORT), ("port", "jax"): (PORT, JAX)}.items()}
    want = recs[("jax", "jax")]
    for k, got in recs.items():
        assert got == want, k
    linked = [n for _, spans in want for *_, n in spans]
    assert sorted(set(linked)) == ["pserver_client_pull_sparse", "pserver_client_push_sparse"]


# -- the timeline merge on the port's traces -----------------------------------------


def _traced_run(tmp_path):
    """A traced pull through the port's 2-server cluster: the client trace
    file (the port's exporter) and one file of both shards' server spans,
    as two pid lanes."""
    c = _Cluster(PORT, PORT)
    try:
        keys = np.arange(1, 65, dtype=np.uint64)
        c.client.pull_sparse(0, keys)
        for s in range(2):
            aggregate.fetch_server_obs(c.client, s, drain=True)
        trace.start_tracing(sample=1.0)
        with trace.span("step"):
            c.client.pull_sparse(0, keys)
        trace.stop_tracing()
        client_path = trace.export_chrome_trace(str(tmp_path / "trainer.json"),
                                                process_name="trainer")
        events = []
        for s in range(2):
            _, spans = aggregate.fetch_server_obs(c.client, s, drain=True)
            events += aggregate.server_spans_to_chrome(spans, pid=s, process_name=f"shard{s}")
        # server ts are wall microseconds already: the anchor is 0
        server_path = str(tmp_path / "servers.json")
        with open(server_path, "w") as f:
            json.dump({"traceEvents": events, "clockSyncUs": 0.0}, f)
        return client_path, server_path
    finally:
        c.close()


def _timeline():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import timeline

    return timeline


def test_timeline_merge_aligns_clocks_and_deconflicts_pids(tmp_path):
    """The client trace's raw perf-counter stamps and the servers' wall
    stamps land on one axis: every server span inside its client pull
    span (a 2 ms allowance for the anchor's read), lanes apart."""
    client_path, server_path = _traced_run(tmp_path)
    out = str(tmp_path / "merged.json")
    _timeline().merge_traces([client_path, server_path], out)
    evs = json.load(open(out))["traceEvents"]
    pull = next(e for e in evs if e["name"] == "pserver_client_pull_sparse")
    served = [e for e in evs if e["name"] == "ps_server_pull_sparse"]
    assert len(served) == 2
    for e in served:
        assert e["pid"] != pull["pid"]
        assert pull["ts"] - 2000 <= e["ts"]
        assert e["ts"] + e["dur"] <= pull["ts"] + pull["dur"] + 2000
    assert min(e["ts"] for e in evs if "ts" in e) == 0.0  # the re-zeroed axis
    starts = {e["id"] for e in evs if e.get("ph") == "s"}
    assert {e["id"] for e in evs if e.get("ph") == "f"} <= starts  # every flow finishes


def test_timeline_merge_preserves_multi_pid_files(tmp_path):
    """The servers' file carries two lanes (pid 0 and 1): both survive the
    merge apart from each other and from the client's lane."""
    client_path, server_path = _traced_run(tmp_path)
    out = str(tmp_path / "merged.json")
    _timeline().merge_traces([client_path, server_path], out)
    evs = json.load(open(out))["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert sorted(names.values()) == ["shard0", "shard1", "trainer"]
    lanes = {e["pid"] for e in evs if e["name"] == "ps_server_pull_sparse"}
    assert len(lanes) == 2
