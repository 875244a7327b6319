"""``hot_scatter_probe.py`` edits the kernel source by pattern: each edit
must still match ``hot_kernels.cu`` exactly as often as the probe
expects, so a change to the source cannot leave the probe timing the
wrong thing."""

import importlib.util
import pathlib

import pytest

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
    assert list(out) == ["as_built", "no_pdl", "empty", "count_only", "no_prologue",
                         "no_next_counts", "no_writes", "no_rule", "tile1024", "tile4096",
                         "block64", "block128", "block512", "warps_only"]
    assert out["as_built"] == (src, True)
    assert len({text for text, _ in out.values()}) == len(out)
    assert out["empty"][0].count("  if (n > 0) return;\n") == 2
    assert "constexpr int kSortTile = 1024;" in out["tile1024"][0]
    assert "constexpr int kSortTile = 4096;" in out["tile4096"][0]
    assert f"constexpr int kWalkBlockMin = {1 << 30};" in out["warps_only"][0]
    assert [k for k, v in out.items() if v[1]] == ["as_built", "no_pdl", "no_rule", "tile1024",
                                                   "tile4096", "block64", "block128", "block512",
                                                   "warps_only"]


def test_probe_refuses_a_source_it_does_not_match():
    probe = _probe()
    with pytest.raises(ValueError, match="matches, expected"):
        probe.variants("constexpr int kSortTile = 2048;\n")
