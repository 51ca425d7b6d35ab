"""``tools/flash_bwd_variants.py`` changes one design choice of the bf16
flash backward by exact edits of ``csrc/flash_attention_bwd.cu``: each edit
must still match the source once, so that the tool times what its variant
names say.  The build and the timing need the card; this checks the edits
on the CPU."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "flash_bwd_variants", ROOT / "tools" / "flash_bwd_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["split1", "split2", "split4",
                                     "two_blocks_an_sm"])
def test_variant_edits_match_the_kernel_source(variant):
    tool = _tool()
    sources = tool.variant_sources()
    assert set(sources) == {"kernel", *tool.VARIANTS}
    kernel, changed = sources["kernel"], sources[variant]
    assert changed != kernel
    # each edit changed its choice and nothing else
    assert len(changed) - len(kernel) == sum(
        len(new) - len(old) for old, new in tool.VARIANTS[variant])


def test_variants_time_the_backwards_timed_shapes():
    tool = _tool()
    names = {shape[0] for shape in tool.cs.BWD_SHAPES}
    assert set(tool.cs.BWD_TIMED) <= set(tool.SHAPES) <= names


def test_parent_source_is_added_as_given(tmp_path):
    parent = tmp_path / "flash_attention_bwd.cu"
    parent.write_text("// another kernel\n")
    assert _tool().variant_sources(parent)["parent"] == "// another kernel\n"
