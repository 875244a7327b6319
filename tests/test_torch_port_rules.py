"""Rules of the port that the code itself must keep.

- ``paddle_tpu_torch`` and ``chip_smoke.py`` import neither jax/jaxlib
  nor anything of ``paddle_tpu`` (checked on the syntax tree, so a lazy
  import inside a function counts too).
- Entry points default to CUDA: without a GPU they raise unless the
  caller passes ``device="cpu"`` — nothing carries on silently on the
  CPU.
- A CUDA-only check (skipped without a card) that the kernel wrapper
  launches and counts on a CUDA tensor.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
