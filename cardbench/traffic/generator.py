"""The one traffic generator: it reads a mix's data file
(``cardbench/traffic/<traffic>.json``) and makes the requests of a run.

A mix file holds:

* ``loop``: ``"closed"``, the one kind the harness drives: ``clients``
  callers, each sending its next request when its last one has come back;
* ``clients``: the number of callers;
* ``rows``: ``{rows: share}``, the images a request carries;
* ``pool_images``: the distinct images a run draws its requests from.

The seed picks each request's size (in the given shares) and which pool
images it carries; the amount of work a caller offers does not depend on it.
"""

from __future__ import annotations

import numpy as np

LOOPS = ("closed",)


class ClosedRequests:
    """The next request of a closed loop: its size and first pool image,
    drawn from the seed as the loop asks for them."""

    def __init__(self, traffic: dict, rng: np.random.Generator) -> None:
        if traffic["loop"] not in LOOPS:
            raise ValueError(f"traffic loop {traffic['loop']!r} is not one "
                             f"of {LOOPS}")
        self.sizes = np.array(sorted(int(k) for k in traffic["rows"]))
        w = np.array([float(traffic["rows"][str(s)]) for s in self.sizes])
        self.p = w / w.sum()
        self.pool = traffic["pool_images"]
        self.clients = traffic["clients"]
        self.rng = rng

    def next(self) -> tuple[int, int]:
        rows = int(self.rng.choice(self.sizes, p=self.p))
        return rows, int(self.rng.integers(0, self.pool - rows + 1))
