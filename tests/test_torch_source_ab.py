"""The A/B scripts at the root of the checkout (``flash_ab.py``,
``conv_ab.py``, ``slab_ab.py``) on the CPU: every variant's edits still
apply to the kernel sources as they are, and the shared timer takes the
variants in turns, forward and back. Building and timing the variants needs the card."""
import importlib.util
from pathlib import Path

import pytest

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.tools import source_ab

ROOT = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / ("%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool", ["flash_ab", "conv_ab", "slab_ab"])
def test_every_variant_edits_the_sources_as_they_are(tool, tmp_path):
    """Each variant's copy differs from the sources exactly where its edits
    say, below the tool's anchor (``namespace sm90 {`` unless it names
    another); as_built is the sources unchanged."""
    mod = _tool(tool)
    anchor = getattr(mod, "ANCHOR", "namespace sm90 {")
    dirs = source_ab.write_variants(tmp_path, mod.SOURCES, mod.VARIANTS, anchor)
    assert set(dirs) == set(mod.VARIANTS)
    for name, edits in mod.VARIANTS.items():
        for f in mod.SOURCES:
            text, orig = (dirs[name] / f).read_text(), (_build.CSRC / f).read_text()
            mine = [(old, new) for src, old, new in edits if src == f]
            assert (text == orig) == (not mine), (name, f)
            for old, new in mine:
                assert new in text.partition(anchor)[2], (name, old)


def test_a_missing_edit_stops_the_run(tmp_path):
    with pytest.raises(SystemExit):
        source_ab.write_variants(tmp_path, ("conv_bwd.cu",),
                                 {"gone": [("conv_bwd.cu", "no such text", "")]})


def test_conv_ab_rules_name_its_variants():
    """conv_ab's split rules belong to variants it has, and are arguments
    of kernels.wgrad_splits_sm90."""
    from mxnet_tpu_torch.ops import kernels

    mod = _tool("conv_ab")
    assert set(mod.RULES) <= set(mod.VARIANTS)
    for rule in mod.RULES.values():
        splits, per = kernels.wgrad_splits_sm90(256, 256, 9, 128, 132, **rule)
        assert (splits - 1) * per < 128 <= splits * per


def test_in_turns_takes_the_variants_forward_and_back():
    seen = []

    def time_variant(name):
        seen.append(name)
        return {"k": float(len(seen))}

    ms, median = source_ab.in_turns(["a", "b", "c"], 2, time_variant)
    assert seen == ["a", "b", "c", "c", "b", "a"] * 2
    assert ms["a"]["k"] == [1.0, 6.0, 7.0, 12.0] and median["a"]["k"] == 6.5
