"""The cases of ``tests/test_shmring.py`` against the port's copies (see
``_torch_cases``), but those that hinge on wall-clock races."""
from _torch_cases import reference_cases

LEAVE_OUT = {
    "test_prefetch_close_hands_stash_back":
        "gives the speculative leases a 3 s wall-clock window to settle; the "
        "reference's own case fails now and then under parallel load",
}
globals().update(reference_cases("test_shmring", LEAVE_OUT))
