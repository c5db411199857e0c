from repro_torch.core.ir.dag import (  # noqa: F401
    Expand, GetVertex, GroupCount, Limit, LogicalPlan, OrderBy, Param, Pred,
    Project, Scan, Select, BinExpr, PropRef, Const, Agg, With,
)
from repro_torch.core.ir.rbo import apply_rbo  # noqa: F401
from repro_torch.core.ir.cbo import Catalog, apply_cbo  # noqa: F401
from repro_torch.core.ir.parser import parse_cypher, parse_gremlin  # noqa: F401
