from .cell_list import CellList
from .blocked import (BlockedLayout, BlockedPayload, BlockedSelection,
                      payload_from_blocked, plan_blocked_layout,
                      select_blocked)
