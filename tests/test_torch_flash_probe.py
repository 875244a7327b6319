"""``flash_bwd_probe.py`` edits the kernel source by pattern: each edit must
still match the source as it is, exactly as often as the probe expects,
so a change to ``flash_attention.cu`` cannot leave the probe timing the
wrong thing."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _probe():
    spec = importlib.util.spec_from_file_location("flash_bwd_probe", ROOT / "flash_bwd_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_variants_apply_to_the_kernel_source():
    probe = _probe()
    src = pathlib.Path(probe.SRC).read_text()
    out = probe.variants(src)
    assert list(out) == ["as_built", "stages3", "no_products", "no_refill"]
    assert out["as_built"] == src
    assert len({*out.values()}) == 4
    assert out["no_products"].count("if (H < 0) wgmma_") == 9


def test_probe_refuses_a_source_it_does_not_match():
    probe = _probe()
    with pytest.raises(ValueError, match="matches, expected"):
        probe.variants("constexpr int kStages = 2;\n")
