"""Row compaction for static-capacity lists (port of
``nnpops_tpu.ops.compaction``).

"The valid entries of each row, in order, padded to capacity" as a per-row
prefix sum plus a batched binary search: the position of the j-th valid
entry is the first index whose running count reaches j + 1. No sort, and
the result is the JAX package's exactly (stable and deterministic).
"""
from __future__ import annotations

from typing import Tuple

import torch


def compact_rows(valid: torch.Tensor,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the indices of the first ``capacity`` True entries, in order.

    Args:
      valid: [N, K] bool.
      capacity: static slot count (may exceed K).

    Returns:
      (indices [N, capacity] int32: positions on the K axis, clamped to K - 1
      for padded slots; kept [N, capacity] bool: which slots hold a real
      entry).
    """
    n, k = valid.shape
    counts = torch.cumsum(valid.to(torch.int32), 1, dtype=torch.int32)
    targets = torch.arange(1, capacity + 1, dtype=torch.int32,
                           device=valid.device)
    idx = torch.searchsorted(counts, targets.expand(n, capacity).contiguous(),
                             side='left', out_int32=True)
    kept = targets[None, :] <= counts[:, -1:]
    return torch.clamp(idx, max=k - 1), kept
