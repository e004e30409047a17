"""PowerBI streaming-dataset writer.

A copy of the reference's `io/powerbi.py`, which imports no JAX (role:
io/powerbi/PowerBIWriter.scala: rows -> JSON batches POSTed to a
push-dataset URL, with mini-batching, bounded concurrency and hard
failure on non-200 responses), on the port's `stages/batching.py`,
`utils/async_utils.bounded_map` and `io/http.py`."""
from __future__ import annotations

import json

import numpy as np

from ..core import Table
from ..stages.batching import FixedMiniBatchTransformer
from ..utils.async_utils import bounded_map
from .http import HTTPRequest, advanced_handler


class PowerBIWriteError(RuntimeError):
    pass


def _rows_json(t: Table, lo: int, hi: int) -> bytes:
    cols = t.columns
    rows = []
    for i in range(lo, hi):
        row = {}
        for c in cols:
            v = t[c][i]
            if isinstance(v, np.generic):
                v = v.item()
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            row[c] = v
        rows.append(row)
    return json.dumps(rows).encode()


def write(t: Table, url: str, batch_size: int = 10, concurrency: int = 1,
          timeout: float = 60.0, retry_times: int = 3) -> int:
    """POST the table to a PowerBI push-dataset URL in row batches
    (reference: PowerBIWriter.write). Returns the number of batches sent;
    raises PowerBIWriteError on any non-200 (the reference throws
    HttpResponseException, PowerBIWriter.scala:77-86)."""
    bounds = FixedMiniBatchTransformer(batch_size=batch_size)._bounds(len(t))
    reqs = [HTTPRequest(url=url, method="POST",
                        headers={"Content-Type": "application/json"},
                        body=_rows_json(t, lo, hi)) for lo, hi in bounds]

    def send(req):
        return advanced_handler(req, timeout=timeout, retry_times=retry_times)

    for resp in bounded_map(send, reqs, concurrency):
        if resp.status != 200:
            raise PowerBIWriteError(
                f"Request failed with code: {resp.status}, "
                f"reason: {resp.reason}, content: {resp.text}")
    return len(reqs)
