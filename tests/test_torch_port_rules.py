"""Rules of the port that the code itself must keep.

- ``paddle_tpu_torch``, ``chip_smoke.py`` and the probes import neither jax/jaxlib
  nor anything of ``paddle_tpu`` (checked on the syntax tree, so a lazy
  import inside a function counts too).
- Entry points default to CUDA: without a GPU they raise unless the
  caller passes ``device="cpu"`` — nothing carries on silently on the
  CPU.
- A CUDA-only check (skipped without a card) that the kernel wrapper
  launches and counts on a CUDA tensor (the hot-tier kernels have theirs
  in ``tests/test_torch_hot_kernels_cuda.py``, the flash-attention ones in
  ``tests/test_torch_flash_attention_cuda.py``).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "ctr_rows_probe.py", ROOT / "flash_bwd_probe.py",
    ROOT / "hot_scatter_probe.py", ROOT / "vision_parity_probe.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and m.split(".")[0] != "paddle_tpu_torch"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_import_is_detected(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from paddle_tpu.ps import table\n    import jax.numpy\n")
    assert list(_imported_modules(f)) == ["paddle_tpu.ps", "jax.numpy"]


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")


def test_step_factory_without_device_raises_without_gpu():
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.models.ctr import (CtrConfig, DeepFM,
                                             make_ctr_train_step_packed,
                                             make_ctr_train_step_slab)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig

    model = DeepFM(CtrConfig(2, 3, 4, (8,)))
    cfg = CacheConfig(capacity=64, embedx_dim=4)
    with pytest.raises(UnavailableError, match="device='cpu'"):
        make_ctr_train_step_packed(model, Adam(), cfg, np.arange(2), 8, 3)
    with pytest.raises(UnavailableError):
        make_ctr_train_step_slab(model, Adam(), cfg, np.arange(2), 8, 3, slab=2)
    # asking for the CPU explicitly works
    make_ctr_train_step_packed(model, Adam(), cfg, np.arange(2), 8, 3, device="cpu")


def test_cache_without_device_raises_without_gpu():
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    table = MemorySparseTable(TableConfig(shard_num=2,
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    try:
        with pytest.raises(UnavailableError):
            HbmEmbeddingCache(table)
        HbmEmbeddingCache(table, device="cpu")
    finally:
        table.close()


def test_hot_tier_entry_points_without_device_raise_without_gpu():
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.device_hash import DynamicDeviceKeyMap
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.hot_tier import (HotEmbeddingTier, HotTierConfig,
                                              make_hot_ctr_train_step)
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    with pytest.raises(UnavailableError, match="device='cpu'"):
        DynamicDeviceKeyMap(64)
    DynamicDeviceKeyMap(64, device="cpu")
    table = MemorySparseTable(TableConfig(shard_num=2))
    try:
        with pytest.raises(UnavailableError):
            HotEmbeddingTier(table, HotTierConfig(capacity=64))
        HotEmbeddingTier(table, HotTierConfig(capacity=64), device="cpu")
        names = dict(sparse_slots=["a", "b"], dense_slots=["d"], label_slot="y")
        with pytest.raises(UnavailableError):
            CtrStreamTrainer(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), table, **names)
        with pytest.raises(UnavailableError):
            CtrStreamTrainer(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), table,
                             hot_tier=HotTierConfig(capacity=64), **names)
        CtrStreamTrainer(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), table,
                         hot_tier=HotTierConfig(capacity=64), device="cpu", **names)
        with pytest.raises(UnavailableError):
            make_hot_ctr_train_step(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(),
                                    CacheConfig(capacity=64), np.arange(2))
    finally:
        table.close()


def test_stream_trainer_over_a_communicator_without_device_raises_without_gpu():
    """The the_one_ps rung: ``CtrStreamTrainer(communicator=...)`` (RPC-only
    and over the hot tier) and the tier over a ``RemoteSparseTable`` run on
    the card unless the caller asks for the CPU; the servers, the client
    and the communicator are host objects."""
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator, SyncCommunicator
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.rpc import NativePsServer, RemoteSparseTable, RpcPsClient
    from paddle_tpu_torch.ps.table import TableConfig

    server = NativePsServer()
    client = RpcPsClient([f"127.0.0.1:{server.port}"])
    try:
        cfg = TableConfig(table_id=0, shard_num=2)
        client.create_sparse_table(0, cfg)
        names = dict(sparse_slots=["a", "b"], dense_slots=["d"], label_slot="y")
        for comm in (SyncCommunicator(client), HalfAsyncCommunicator(client)):
            for hot in (None, HotTierConfig(capacity=64)):
                args = (DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), None)
                kw = dict(communicator=comm, embedx_dim=8, hot_tier=hot, **names)
                with pytest.raises(UnavailableError, match="device='cpu'"):
                    CtrStreamTrainer(*args, **kw)
                CtrStreamTrainer(*args, device="cpu", **kw)
        remote = RemoteSparseTable(client, 0, cfg)
        with pytest.raises(UnavailableError):
            HotEmbeddingTier(remote, HotTierConfig(capacity=64))
        HotEmbeddingTier(remote, HotTierConfig(capacity=64), device="cpu")
    finally:
        client.close()
        server.close()


def test_mesh_without_device_raises_without_gpu():
    """A mesh defaults to the card too; the sharded tier and trainer take
    their device from the caller and must match the mesh's."""
    _no_gpu()
    from paddle_tpu_torch.core.enforce import EnforceNotMet, UnavailableError
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    with pytest.raises(UnavailableError, match="device='cpu'"):
        make_mesh({"ps": 2})
    cfg = HotTierConfig(capacity=64, mesh=make_mesh({"ps": 2}, device="cpu"))
    table = MemorySparseTable(TableConfig(shard_num=2))
    try:
        with pytest.raises(UnavailableError):
            HotEmbeddingTier(table, cfg)
        assert HotEmbeddingTier(table, cfg, device="cpu").stats()["shards"] == 2
        names = dict(sparse_slots=["a", "b"], dense_slots=["d"], label_slot="y")
        with pytest.raises(UnavailableError):
            CtrStreamTrainer(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), table, hot_tier=cfg,
                             **names)
        CtrStreamTrainer(DeepFM(CtrConfig(2, 1, 8, (8,))), Adam(), table, hot_tier=cfg,
                         device="cpu", **names)
        with pytest.raises(EnforceNotMet, match="mesh lives on"):
            HotEmbeddingTier(table, HotTierConfig(capacity=64, mesh=make_mesh(
                {"ps": 2}, device="meta")), device="cpu")
    finally:
        table.close()


def test_trainer_without_device_raises_without_gpu():
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam

    model = Ernie(ErnieConfig(vocab_size=32, hidden_size=16, num_heads=2, ffn_size=32,
                              num_layers=1, max_seq_len=8))
    with pytest.raises(UnavailableError, match="device='cpu'"):
        Trainer(model, Adam(), lambda out, y: out.sum())
    Trainer(model, Adam(), lambda out, y: out.sum(), device="cpu")


def test_flash_attention_on_cuda_builds_its_kernel_or_raises():
    """A CUDA tensor goes to the kernel, never to the plain version: with
    no card the tensor cannot exist; without nvcc the kernel library does
    not build and the wrapper's loader raises (no fallback)."""
    _no_gpu()
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops._build import BuildError, find_nvcc

    with pytest.raises((AssertionError, RuntimeError)):
        torch.zeros(1, 8, 2, 8, device="cuda")
    try:
        find_nvcc()
    except BuildError:
        with pytest.raises(BuildError, match="nvcc"):
            fa.load_flash_kernels()


def test_ernie_auto_attention_on_cpu_is_the_einsum_path():
    """``attn_impl="auto"`` on a CPU tensor runs ``local_attention`` (the
    JAX rule, with the card in the TPU's place): the same logits as
    ``"einsum"`` and no flash launch."""
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.ops import flash_attention as fa

    kw = dict(vocab_size=32, hidden_size=16, num_heads=2, ffn_size=32, num_layers=1,
              max_seq_len=8)
    auto = Ernie(ErnieConfig(**kw), generator=torch.Generator().manual_seed(0))
    einsum = Ernie(ErnieConfig(**kw, attn_impl="einsum"))
    einsum.load_state_dict(auto.state_dict())
    ids = torch.randint(0, 32, (2, 8), generator=torch.Generator().manual_seed(1))
    before = fa.flash_attention_fwd.launches
    assert torch.equal(auto(ids), einsum(ids))
    assert fa.flash_attention_fwd.launches == before


@pytest.mark.cuda
def test_kernel_launches_and_counts_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import sparse_optimizer as tso

    n, dim = 1000, 8
    g = torch.Generator().manual_seed(0)
    cols = (torch.rand(n, generator=g), torch.rand(n, generator=g),
            torch.randn(n, 1, generator=g), torch.rand(n, 1, generator=g),
            torch.randn(n, dim, generator=g), torch.rand(n, 1, generator=g),
            (torch.rand(n, generator=g) < 0.5).float())
    deltas = (torch.ones(n), torch.zeros(n), torch.randn(n, 1, generator=g),
              torch.randn(n, dim, generator=g))
    kw = dict(embed_rule="adagrad", embedx_rule="adagrad", lr=0.05, initial_g2sum=3.0,
              weight_bounds=(-10.0, 10.0), beta1=0.9, beta2=0.999, eps=1e-8,
              nonclk_coeff=0.1, click_coeff=1.0, embedx_threshold=0.0)
    want = tso.ctr_sparse_rows(cols, *deltas, **kw)
    before = tso.ctr_sparse_rows.launches
    got = tso.ctr_sparse_rows(tuple(c.cuda() for c in cols),
                              *[d.cuda() for d in deltas], **kw)
    torch.cuda.synchronize()
    assert tso.ctr_sparse_rows.launches == before + 1
    for w, o in zip(want, got):
        torch.testing.assert_close(o.cpu(), w, rtol=0, atol=0)


def test_vision_entry_points_without_device_raise_without_gpu():
    _no_gpu()
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    with pytest.raises(UnavailableError, match="device='cpu'"):
        Model(LeNet())
    with pytest.raises(UnavailableError):
        Trainer(LeNet(), Momentum(0.1), F.cross_entropy, amp="O2")
    with pytest.raises(UnavailableError, match="device='cpu'"):
        GradScaler().init()
    assert GradScaler().init("cpu").loss_scale.device.type == "cpu"
    Model(LeNet(), device="cpu").prepare(Momentum(0.1), F.cross_entropy, amp_configs="O1")


def test_pass_trainer_entry_points_without_device_raise_without_gpu(tmp_path):
    """``CtrPassTrainer`` over either table, and ``load_checkpoint``, run on
    the card unless the caller asks for the CPU."""
    _no_gpu()
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from paddle_tpu_torch.models.ctr import CtrConfig, WideDeep
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, SsdSparseTable, TableConfig

    cfg = TableConfig(shard_num=2, accessor_config=AccessorConfig(embedx_dim=4))
    names = dict(sparse_slots=["a", "b"], dense_slots=["d"], label_slot="y")
    for table in (MemorySparseTable(cfg), SsdSparseTable(str(tmp_path / "ssd"), cfg)):
        try:
            args = (WideDeep(CtrConfig(2, 1, 4, (8,))), Adam(), table,
                    CacheConfig(capacity=64, embedx_dim=4))
            with pytest.raises(UnavailableError, match="device='cpu'"):
                CtrPassTrainer(*args, **names)
            assert CtrPassTrainer(*args, device="cpu", **names).params["wide.weight"].is_cpu
        finally:
            table.close()
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(2)})
    with pytest.raises(UnavailableError, match="device='cpu'"):
        load_checkpoint(str(tmp_path / "ck"))
    assert load_checkpoint(str(tmp_path / "ck"), device="cpu")["model"]["w"].is_cpu


def test_amp_is_not_torch_autocast():
    """The port's amp casts only linear and conv2d, as the JAX package's
    does; PyTorch's autocast (every matmul, softmax, reductions) is used
    nowhere in the port."""
    for path in PORT_FILES:
        src = path.read_text()
        assert "torch.autocast" not in src and "torch.cuda.amp" not in src, path
