"""``tools/ssd_ablation.py`` removes the SSD kernel's phases by exact edits of
``csrc/ssd_scan.cu``: each edit must still match the source once, so that
the tool times what its variant names say.  The build and the timing need
the card; this checks the edits on the CPU."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "ssd_ablation", ROOT / "tools" / "ssd_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["no_cht", "no_intra", "no_state",
                                     "no_products", "no_products_y_out",
                                     "skeleton"])
def test_ablation_edits_match_the_kernel_source(variant):
    tool = _tool()
    sources = tool.variant_sources()
    assert set(sources) == {"kernel", *tool.ABLATIONS}
    kernel, ablated = sources["kernel"], sources[variant]
    assert ablated != kernel
    # each edit removed its phase and nothing else
    assert len(kernel) - len(ablated) == sum(
        len(old) - len(new) for old, new in tool.ABLATIONS[variant])
    # only the P = N = 64 instance is dispatched
    assert "dispatch_n<16>" not in kernel and "dispatch_n<64>" in kernel


def test_parent_source_is_added_as_given(tmp_path):
    parent = tmp_path / "ssd_scan.cu"
    parent.write_text("// another kernel\n")
    assert _tool().variant_sources(parent)["parent"] == "// another kernel\n"
