"""``tools/scan_bwd_variants.py`` builds PR 23's scalar design of the scans'
backward as a bf16 instance by one exact edit of ``csrc/wkv6_scan_bwd.cu``
/ ``csrc/ssd_scan_bwd.cu`` (the float32 entry also dispatches bfloat16):
the edit must still match the source once, so that the tool times what its
variant names say, and the entries it calls must keep their arguments.  The
build and the timing need the card; this checks the edits on the CPU."""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "scan_bwd_variants", ROOT / "tools" / "scan_bwd_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scan", ["wkv6_scan_bwd", "ssd_scan_bwd"])
def test_variant_edit_matches_the_kernel_source(scan):
    tool = _tool()
    sources = tool.variant_sources(scan)
    assert set(sources) == {"kernel", "scalar"}
    kernel, scalar = sources["kernel"], sources["scalar"]
    old, new = tool.EDITS[scan]
    assert scalar != kernel and "__nv_bfloat16>(p" in new
    assert len(scalar) - len(kernel) == len(new) - len(old)
    # each entry the tool calls takes the arguments it passes
    for kind in ("tc", "scalar"):
        name, n_ptr, n_int = tool.ENTRIES[scan, kind]
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", kernel,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        assert sum(p.startswith(("void*", "const void*"))
                   for p in params) == n_ptr + 1  # + the stream
        assert sum(p.startswith("int ") for p in params) == n_int


def test_variants_time_the_timed_shapes():
    tool = _tool()
    for shapes, timed in ((tool.cs.WKV_BWD_SHAPES, tool.cs.WKV_BWD_TIMED),
                          (tool.cs.SSD_BWD_SHAPES, tool.cs.SSD_BWD_TIMED)):
        names = {shape[0] for shape in shapes}
        assert set(timed) <= names
        assert any("4096" in name for name in timed)


def test_head_sweep_reaches_the_dry_runs_training_microbatch():
    """``--heads`` times SSD's head groups at batched microbatches up to the
    dry run's zamba2-1.2b train_4k microbatch (16 x 4096), where the rule
    ``ssd_scan.heads_a_block`` is held to the measurement."""
    tool = _tool()
    assert (16, 4096) in {(B, S) for _, B, S in tool.HEAD_SHAPES}
    assert all(B > 1 for _, B, S in tool.HEAD_SHAPES)
