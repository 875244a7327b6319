"""``Trainer.train_from_dataset`` over a ``QueueDataset`` on the card
(``cuda``; jax-free, so it runs on the card's machine): the parameters
live on the card and the per-epoch losses are within rtol 1e-4 of the
same trainer's on the CPU from the same weights (cuBLAS and the CPU BLAS
sum the products in another order; TF32 off)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.data.dataset import QueueDataset, SlotDesc
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.optimizer import Adam

D = 4


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.l1 = nn.Linear(D, 16, generator=g)
        self.l2 = nn.Linear(16, 1, generator=g)

    def forward(self, x):
        return self.l2(nn.functional.relu(self.l1(x)))[..., 0]


def _feed(batch):
    dense = np.concatenate([batch[f"d{i}"][0] for i in range(D)], axis=1)
    return dense.astype(np.float32), batch["label"][0][:, 0].astype(np.float32)


def _queue(path):
    ds = QueueDataset([SlotDesc(f"d{i}", is_float=True) for i in range(D)]
                      + [SlotDesc("label", is_float=True)])
    ds.set_filelist([str(path)])
    return ds


@pytest.mark.cuda
def test_trainer_train_from_dataset_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, D))
    path = tmp_path / "part-0"
    path.write_text("".join(" ".join(f"1 {v:.5f}" for v in row) + f" 1 {int(row[0] > 0)}\n"
                            for row in x))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = Trainer(_MLP(), Adam(1e-2), nn.functional.binary_cross_entropy_with_logits,
                         device=dev)
            runs[dev] = tr.train_from_dataset(_queue(path), _feed, batch_size=128, epochs=2)
            assert all(p.device.type == dev for p in tr.state["params"].values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert runs["cuda"][1] < runs["cuda"][0]
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)
