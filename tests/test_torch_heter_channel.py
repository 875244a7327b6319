"""``parallel.heter_channel`` against the JAX package, on the CPU.

The frame format is JAX's byte for byte: ``_encode`` gives the same bytes
for the same item, a frame from the JAX ``ChannelClient`` decodes in the
port's ``ChannelServer`` and the reverse (exact). The port's channel
builds from its own ``csrc/tensor_channel.cc``. The two-process test is
kept cheap (a child that only sends) and named apart from JAX's ``slow``
one."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import heter_channel as jhc
from paddle_tpu_torch.parallel import heter_channel as thc
from paddle_tpu_torch.parallel.heter_channel import (STOP, ChannelClient, ChannelServer,
                                                     channel_source)
from paddle_tpu_torch.parallel.heter_pipeline import HeterPipelineTrainer, SectionConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")


def _item(rng):
    return {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "u64": rng.integers(0, 1 << 60, size=7, dtype=np.uint64),
            "i32scalar": np.asarray(-3, np.int32),
            "empty": np.zeros((0, 4), np.float32),
            "fortran": np.asfortranarray(rng.normal(size=(2, 3)))}


def _assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape


def test_frames_are_jax_frames_byte_for_byte(rng):
    item = _item(rng)
    assert thc._encode(item) == jhc._encode(item)
    assert thc._encode(thc.STOP) == jhc._encode(jhc.STOP)
    _assert_items_equal(thc._decode(jhc._encode(item)), item)
    # torch tensors cross as their numpy arrays
    t = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    assert thc._encode(t) == jhc._encode({"t": t["t"].numpy()})


def test_jax_client_to_port_server_and_back(rng):
    item = _item(rng)
    srv = ChannelServer(capacity=4)
    jcli = jhc.ChannelClient("127.0.0.1", srv.port)
    jcli.send(item)
    _assert_items_equal(srv.recv(timeout=10), item)
    jcli.send_stop()
    assert srv.recv(timeout=10) is STOP
    jsrv = jhc.ChannelServer(capacity=4)
    cli = ChannelClient("127.0.0.1", jsrv.port)
    cli.send(item)
    _assert_items_equal(jsrv.recv(timeout=10), item)
    for h in (srv, jcli, jsrv, cli):
        h.close()


def test_roundtrip_to_a_named_device_and_scalars(rng):
    srv = ChannelServer(capacity=2)
    cli = ChannelClient("127.0.0.1", srv.port)
    cli.send({"s": np.asarray(7, np.int64), "v": torch.tensor([7]), "x": rng.normal(size=4)})
    got = srv.recv(timeout=10, device="cpu")
    assert isinstance(got["s"], torch.Tensor) and got["s"].shape == () and int(got["s"]) == 7
    assert got["v"].shape == (1,) and got["x"].dtype == torch.float64
    with pytest.raises(TimeoutError):
        srv.recv(timeout=0.05)
    srv.close()
    cli.close()


def test_stop_terminates_source():
    srv = ChannelServer(capacity=4)
    cli = ChannelClient("127.0.0.1", srv.port)
    for i in range(5):
        cli.send({"i": np.asarray(i)})
    cli.send_stop()
    assert [int(x["i"]) for x in channel_source(srv, timeout=10)] == list(range(5))
    srv.close()
    cli.close()


_SENDER = textwrap.dedent("""
    import sys
    import numpy as np
    from paddle_tpu_torch.parallel.heter_channel import ChannelClient

    cli = ChannelClient("127.0.0.1", int(sys.argv[1]))
    rng = np.random.default_rng(0)
    for i in range(8):
        cli.send({"idx": np.asarray(i), "x": rng.normal(size=(4, 8)).astype(np.float32)})
    cli.send_stop()
    cli.close()
""")


def test_port_child_streams_micro_batches_into_a_pipeline(tmp_path):
    """A child process sends 8 micro-batches; this process runs them
    through ``HeterPipelineTrainer`` from ``channel_source`` as tensors,
    in order; the child exits 0."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = tmp_path / "sender.py"
    script.write_text(_SENDER)
    srv = ChannelServer(capacity=4)
    child = subprocess.Popen([sys.executable, str(script), str(srv.port)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tr = HeterPipelineTrainer([SectionConfig(lambda it: (int(it["idx"]), it["x"] * 2.0)),
                                   SectionConfig(lambda t: (t[0], float(t[1].sum())))])
        out = tr.run(channel_source(srv, timeout=120, device="cpu"))
    finally:
        _, err = child.communicate(timeout=120)
        srv.close()
    assert child.returncode == 0, err[-2000:]
    rng = np.random.default_rng(0)
    want = [(i, float(torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).mul(2.0).sum()))
            for i in range(8)]
    assert out == want
