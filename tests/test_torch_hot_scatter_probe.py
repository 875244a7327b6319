"""``hot_scatter_probe.py`` edits the kernel source by pattern: each edit
must still match ``hot_kernels.cu`` exactly as often as the probe
expects, so a change to the source cannot leave the probe timing the
wrong thing. The probe variants also run in the SIMT emulator of
``test_torch_hot_kernels_emulated.py``: each one that the probe counts as
right gives the plain probe's answers."""

import ctypes
import importlib.util
import pathlib
import shutil

import pytest
import torch

from paddle_tpu_torch.ops import hot_kernels as hk
from test_torch_hot_kernels_emulated import build_emulated, tie_wrap_map, tier

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _probe():
    spec = importlib.util.spec_from_file_location("hot_scatter_probe",
                                                  ROOT / "hot_scatter_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_variants_apply_to_the_kernel_source():
    probe = _probe()
    src = pathlib.Path(probe.SRC).read_text()
    out = probe.variants(src)
    assert list(out) == ["as_built", "probe_empty", "both_buckets", "group4", "group16",
                         "keys1", "keys2", "keys8", "block1024", "one_thread", "no_pdl", "empty", "count_only", "no_prologue",
                         "no_next_counts", "no_writes", "no_rule", "tile1024", "tile4096",
                         "block64", "block128", "block512", "warps_only"]
    assert list(out)[:len(probe.PROBE_VARIANTS)] == list(probe.PROBE_VARIANTS)
    assert out["as_built"] == (src, True)
    assert len({text for text, _ in out.values()}) == len(out)
    assert out["probe_empty"][0].count("  if (n > 0) return;\n") == 2
    assert "constexpr int kProbeAhead = 2;" in out["both_buckets"][0]
    assert "constexpr int kProbeGroup = 16;" in out["group16"][0]
    assert "constexpr int kProbeKeys = 1;" in out["keys1"][0]
    assert "constexpr int kProbeThreads = 1024;" in out["block1024"][0]
    one = out["one_thread"][0]
    assert "probe_group(" not in one and "kProbeGroup" not in one
    assert one.count("__global__ void hot_probe") == 2
    assert out["empty"][0].count("  if (n > 0) return;\n") == 2
    assert "constexpr int kSortTile = 1024;" in out["tile1024"][0]
    assert "constexpr int kSortTile = 4096;" in out["tile4096"][0]
    assert f"constexpr int kWalkBlockMin = {1 << 30};" in out["warps_only"][0]
    assert [k for k, v in out.items() if not v[1]] == ["probe_empty", "empty", "count_only",
                                                       "no_prologue", "no_next_counts",
                                                       "no_writes"]


def test_probe_refuses_a_source_it_does_not_match():
    probe = _probe()
    with pytest.raises(ValueError, match="matches, expected"):
        probe.variants("constexpr int kSortTile = 2048;\n")


@pytest.mark.parametrize("name", ["as_built", "probe_empty", "both_buckets", "group4",
                                  "group16", "keys1", "keys2", "keys8", "block1024",
                                  "one_thread"])
def test_probe_variant_in_the_emulator(name, tmp_path, monkeypatch):
    """A probe variant builds and launches; one the probe counts as right
    gives ``hot_probe_gather_plain``'s rows and values on the hand-built
    tie/wrap map (banks 4, 8 slots)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    text, right = _probe().variants(pathlib.Path(_probe().SRC).read_text())[name]
    lib = hk.bind_hot_kernels(ctypes.CDLL(str(build_emulated(tmp_path, text))))
    monkeypatch.setattr(hk, "_stream", lambda t: None)
    ms, kh, kl, want = tie_wrap_map(5, 8, 4)
    state = tier(128, 8)
    rows = hk._probe(lib, ms, kh, kl, 2, 4)
    got = hk._probe_gather(lib, ms, kh, kl, state, 2, 4)
    if right:
        plain = hk.hot_probe_gather_plain(ms, kh, kl, state, probe_buckets=2, banks=4)
        assert (rows.numpy() == want).all() and torch.equal(got[0], plain[0])
        assert torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32))
