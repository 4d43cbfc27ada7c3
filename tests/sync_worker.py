"""A process function for ``tests/test_torch_sync.py`` (the standard
library only: a ``spawn`` child imports the module that defines its
function)."""
import time


def arrive(barrier, delay: float, path: str) -> None:
    """Sleep ``delay`` s, wait at ``barrier``, write the time it let go."""
    time.sleep(delay)
    barrier.barrier(timeout=60)
    with open(path, "w") as f:
        f.write(repr(time.time()))
