"""``ctr_rows_probe.py`` edits the kernel source by pattern: each edit must
still match ``ctr_sparse_rows.cu`` exactly as often as the probe expects,
so a change to the source cannot leave the probe timing the wrong thing.
Every variant also runs in the SIMT emulator of
``test_torch_ctr_rows_emulated.py``: each one that the probe counts as
right gives the plain versions' answers in both forms."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest

from paddle_tpu_torch.ops import sparse_optimizer as so
from test_torch_ctr_rows_emulated import CS, build_emulated, launch_at, launch_rows, rule_kw

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ["as_built", "tile64", "tile256", "runtime_widths", "empty"]


def _probe():
    spec = importlib.util.spec_from_file_location("ctr_rows_probe", ROOT / "ctr_rows_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_variants_apply_to_the_kernel_source():
    probe = _probe()
    src = pathlib.Path(probe.SRC).read_text()
    out = probe.variants(src)
    assert list(out) == NAMES
    assert out["as_built"] == (src, True)
    # every variant is a source of its own
    assert len({text for text, _ in out.values()}) == len(out)
    rt = out["runtime_widths"][0]
    assert probe.NEVER_DIM in rt and probe.FIXED_DIM not in rt
    assert "constexpr int kTile = 64;" in out["tile64"][0]
    assert "constexpr int kTile = 256;" in out["tile256"][0]
    assert out["empty"][0].count("  if (a.n > 0) return;\n") == 1
    assert [k for k, v in out.items() if not v[1]] == ["empty"]


def test_probe_refuses_a_source_it_does_not_match():
    with pytest.raises(ValueError, match="matches, expected"):
        _probe().variants("constexpr int kTile = 128;\n")


@pytest.mark.parametrize("name", NAMES)
def test_probe_variant_in_the_emulator(name, tmp_path, monkeypatch):
    """A variant builds and launches both forms; one the probe counts as
    right equals the plain versions bitwise (dim 8, adagrad/adam, a short
    last tile, padding and negative rows)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    text, right = _probe().variants(pathlib.Path(_probe().SRC).read_text())[name]
    lib = build_emulated(tmp_path, text)
    monkeypatch.setattr(so, "_stream", lambda t: None)
    rng = np.random.default_rng(4)
    pair, kw = ("adagrad", "adam"), rule_kw("adagrad", "adam", True)
    cols, deltas = CS.rows_inputs(rng, 2 * 256 + 37, 8, *pair, "cpu")
    got_rows = launch_rows(lib, cols, deltas, kw)
    C = 900
    state, uniq, ds, dc, g = CS.at_inputs(rng, C, 2 * 256 + 37, 8, *pair, "cpu")
    got = tuple(c.clone() for c in state)
    launch_at(lib, got, uniq, ds, dc, g, C, kw)
    if right:
        assert CS.bitwise_cols(got_rows, so.ctr_sparse_rows(cols, *deltas, **kw))
        want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                           capacity=C, **kw)
        assert CS.bitwise_cols(got, want)
