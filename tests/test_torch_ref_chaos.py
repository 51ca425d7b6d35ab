"""The cases of ``tests/test_chaos.py`` against the port's copies (see
``_torch_cases``)."""
from _torch_cases import reference_cases

globals().update(reference_cases("test_chaos", {}))
