"""Run a reference test module's cases against the port.

``reference_cases(name, leave_out, edits)`` reads ``tests/<name>.py``,
renames the package ``repro`` to ``repro_torch`` (imports, ``-m repro...``
subprocess commands), makes the ``edits`` (``(old, new)`` pairs of source
text, for what the port must be told, such as ``device="cpu"``), executes
the result as a module of its own and returns its tests, fixtures and
marks, to be bound into the calling ``test_torch_*`` module's namespace.
The cases then run against the port's copies, under the reference's
markers.  ``leave_out`` maps the names of the cases not run to the reason.
A name that is not in the module, or an edit whose text is not in the
source, raises, so neither list can go stale silently.
"""
from __future__ import annotations

import re
import types
from pathlib import Path
from typing import Dict, Sequence, Tuple

TESTS = Path(__file__).resolve().parent


def reference_cases(name: str, leave_out: Dict[str, str],
                    edits: Sequence[Tuple[str, str]] = ()
                    ) -> Dict[str, object]:
    path = TESTS / f"{name}.py"
    src = re.sub(r"\brepro\b", "repro_torch", path.read_text())
    for old, new in edits:
        if old not in src:
            raise KeyError(f"{name} has no text {old!r}")
        src = src.replace(old, new)
    mod = types.ModuleType(f"{name}__on_repro_torch")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    unknown = sorted(set(leave_out) - set(mod.__dict__))
    if unknown:
        raise KeyError(f"{name} has no cases {unknown}")
    return {k: v for k, v in mod.__dict__.items()
            if not k.startswith("__") and k not in leave_out}
