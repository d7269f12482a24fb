"""Background scan prefetcher for sequence pipelines (a copy of the JAX
package's ``io/prefetch.py``, which imports no JAX).

Device programs leave the host idle during each pair's registration; this
loader overlaps the NEXT scans' disk reads (+ decompression — the LZF codec
runs on the host) with device compute, the data-loader role PCL's blocking
``loadPCDFile`` fills in the reference CLI
(src/prob_point_cloud_registration_ex.cc:111-126) without any overlap.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np


class ScanPrefetcher:
    """Read-ahead loader over a scan sequence.

    Args:
      scans: items accepted by ``loader`` (paths or arrays).
      loader: item -> (n, 3) array; defaults to models.odometry's scan
        loader (PCD / KITTI .bin / ndarray passthrough).
      depth: how many scans to keep in flight ahead of the cursor.
    """

    def __init__(
        self,
        scans: Sequence,
        loader: Optional[Callable] = None,
        *,
        depth: int = 2,
    ):
        if loader is None:
            from ..models.odometry import _load_scan

            loader = _load_scan
        self._scans = list(scans)
        self._loader = loader
        self._depth = max(1, depth)
        self._pool = ThreadPoolExecutor(max_workers=self._depth)
        self._futures: dict[int, Future] = {}

    def __len__(self) -> int:
        return len(self._scans)

    def _ensure(self, index: int) -> None:
        if 0 <= index < len(self._scans) and index not in self._futures:
            self._futures[index] = self._pool.submit(self._loader, self._scans[index])

    def get(self, index: int) -> np.ndarray:
        """Blocking fetch of scan ``index``; schedules the read-ahead."""
        self._ensure(index)
        for ahead in range(1, self._depth + 1):
            self._ensure(index + ahead)
        result = self._futures[index].result()
        # Drop far-behind cache entries (keep the previous scan: it is the
        # next pair's target).
        for k in [k for k in self._futures if k < index - 1]:
            del self._futures[k]
        return result

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
