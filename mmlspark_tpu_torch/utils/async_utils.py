"""Bounded-concurrency future helpers.

A copy of the reference's `utils/async_utils.py` (which imports no JAX):
map work over an iterator keeping at most `concurrency` items in flight,
yielding results in input order. `data.pool.WorkerPool.imap_rows` streams
its chunks through `bounded_map`.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def buffered_await(futures: Iterable, concurrency: int,
                   timeout: Optional[float] = None) -> Iterator:
    """Consume an iterator of already-submitted futures with a sliding
    window: at most `concurrency` unresolved at once, results in
    submission order."""
    window: collections.deque = collections.deque()
    it = iter(futures)
    exhausted = False
    while True:
        while not exhausted and len(window) < concurrency:
            try:
                window.append(next(it))
            except StopIteration:
                exhausted = True
        if not window:
            return
        yield window.popleft().result(timeout=timeout)


def bounded_map(fn: Callable[[T], R], items: Iterable[T], concurrency: int,
                timeout: Optional[float] = None) -> Iterator[R]:
    """Lazily map `fn` over `items` with at most `concurrency` in flight,
    yielding in input order. The executor lives only for the iteration."""
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        def submit_all():
            for x in items:
                yield pool.submit(fn, x)
        yield from buffered_await(submit_all(), concurrency, timeout=timeout)
