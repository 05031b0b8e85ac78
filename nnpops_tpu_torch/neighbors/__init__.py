from .cell_list import CellList, NeighborList, neighbor_list_to_pairs
from .blocked import (BlockedLayout, BlockedPayload, BlockedSelection,
                      build_blocked_payload, payload_from_blocked,
                      plan_blocked_layout, select_blocked)
