"""Names of the ``CALL algo.*`` procedures, for the parser.

The GRAPE analytics engine that runs them is not part of this package
yet; a plan that calls one parses, and raises ``NotImplementedError``
when it executes.
"""

from __future__ import annotations

from typing import Dict

# parser-facing: default YIELD score column per algorithm
RESULT_NAMES: Dict[str, str] = {
    "pagerank": "rank",
    "sssp": "dist",
    "bfs": "depth",
    "wcc": "comp",
    "degree_centrality": "centrality",
    "gnn.infer": "score",
}


def normalize_proc_name(name: str) -> str:
    """Strip the ``algo.`` namespace; validate against the known names."""
    short = name[5:] if name.startswith("algo.") else name
    if short not in RESULT_NAMES:
        raise KeyError(f"unknown procedure {name!r}; available: "
                       f"{sorted(RESULT_NAMES)}")
    return short
