"""The order of a closed loop's items, drawn from the seed.

Each cycle is a fresh permutation of the whole pool, so after any
number of items every item has had an equal share to within one, and
seeds differ only in the order: the work a window holds is the same
whatever the seed.
"""
from __future__ import annotations

import random


def cycles(items, seed: int):
    """Yield the items forever, one seeded permutation of them a cycle."""
    items = list(items)
    if not items:
        raise ValueError("an empty pool")
    rng = random.Random(int(seed))
    while True:
        order = list(items)
        rng.shuffle(order)
        yield from order
