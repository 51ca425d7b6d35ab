"""Device ms a training step idle while the host was inside one of the
program's spans on any thread: the port's Python between launches
(``lib/spans.py``)."""
from portbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    j = spans.join(ctx)
    return None if j is None else j.idle_in_program_ms()
