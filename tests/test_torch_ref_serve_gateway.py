"""The nine cases of ``tests/test_serve_gateway.py`` against the port's
gateway (see ``_torch_cases``), with the port's snapshot and the
``merlin-serve`` CLI told to run on the CPU."""
from _torch_cases import reference_cases

EDITS = [
    ("SurrogateSnapshot(root, n_members=2, hidden=16, steps=40)",
     "SurrogateSnapshot(root, n_members=2, hidden=16, steps=40, "
     "device=\"cpu\")"),
    ('"--members", "2", "--hidden", "16", "--steps", "40"]',
     '"--members", "2", "--hidden", "16", "--steps", "40", '
     '"--device", "cpu"]'),
]
globals().update(reference_cases("test_serve_gateway", {}, EDITS))
