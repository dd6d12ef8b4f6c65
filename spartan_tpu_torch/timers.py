"""Wall-clock spans, the counterpart of ``spartan_tpu/utils/timers.py``.

``span(label)`` adds the elapsed seconds to ``SPANS[label]``. Work on a
CUDA device is asynchronous: a span measures what the host waited for, so
callers that need device time synchronize inside the span. Each span is
also a ``torch.profiler.record_function`` range of the same label (the JAX
package's spans are profiler annotations too), so a profile can tell what
ran inside a span: ``chip_smoke.py`` counts the copies to the host inside
the sumcheck phases that way.
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager

from torch.profiler import record_function

SPANS: collections.defaultdict = collections.defaultdict(float)


def reset() -> None:
    SPANS.clear()


@contextmanager
def span(label: str):
    t0 = time.perf_counter()
    try:
        with record_function(label):
            yield
    finally:
        SPANS[label] += time.perf_counter() - t0
