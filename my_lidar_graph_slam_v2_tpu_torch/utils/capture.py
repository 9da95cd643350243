"""What a CUDA graph capture needs from the host: the cyclic garbage
collector paused for its length (:func:`collector_paused`).  The LM
(``graph/optimizer.py``) and the fused matcher's search
(``models/fused_matcher.py``) capture under it."""
from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def collector_paused():
    """The cyclic garbage collector off for the block: a CUDA graph that it
    frees inside a capture (an optimizer dropped in a reference cycle)
    would be destroyed there, which is not permitted during a capture and
    invalidates it."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
