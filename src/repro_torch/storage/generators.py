"""Synthetic graph generators: R-MAT (Graph500-style) and an LDBC-SNB-ish
labeled property graph (persons / items / posts with typed edges)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.storage.csr import CSRStore

# LDBC-SNB-ish schema (label codes)
V_PERSON, V_ITEM, V_POST = 0, 1, 2
E_KNOWS, E_BUY, E_REVIEW, E_LIKES = 0, 1, 2, 3

LABEL_NAMES = {"Person": V_PERSON, "Account": V_PERSON, "Item": V_ITEM,
               "Post": V_POST}
EDGE_NAMES = {"KNOWS": E_KNOWS, "BUY": E_BUY, "REVIEW": E_REVIEW,
              "LIKES": E_LIKES}


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT: 2^scale vertices, edge_factor·2^scale edges."""
    rng = np.random.default_rng(seed)
    n_bits = scale
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab = a + b
    cn = c / (1 - ab) if ab < 1 else 0.5
    for bit in range(n_bits):
        r1 = rng.random(m)
        r2 = rng.random(m)
        go_right_src = r1 > ab
        go_right_dst = np.where(go_right_src, r2 > cn, r2 > (b / ab))
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    return src, dst


def rmat_store(scale: int, edge_factor: int = 16, seed: int = 0,
               weighted: bool = True) -> CSRStore:
    src, dst = rmat_edges(scale, edge_factor, seed)
    n = 1 << scale
    rng = np.random.default_rng(seed + 1)
    eprops = {"weight": rng.random(len(src)).astype(np.float32)} if weighted else {}
    return CSRStore(n, src, dst, edge_props=eprops)


def snb_store(n_persons: int = 2000, n_items: int = 1000, n_posts: int = 500,
              seed: int = 0) -> CSRStore:
    """Small LDBC-SNB-flavoured property graph.

    Vertices: persons, items, posts (labels); props: ``credits`` (person),
    ``price`` (item), ``region`` (person), ``is_fraud_seed`` (person).
    Edges: KNOWS (person-person, zipf), BUY (person→item, with ``date``),
    REVIEW (person→item), LIKES (person→post)."""
    rng = np.random.default_rng(seed)
    n = n_persons + n_items + n_posts
    P, I = n_persons, n_items

    def zipf_targets(size, hi):
        t = (rng.zipf(1.6, size) - 1) % hi
        return t.astype(np.int64)

    # KNOWS: preferential within persons
    k_src = rng.integers(0, P, 8 * P)
    k_dst = zipf_targets(8 * P, P)
    keep = k_src != k_dst
    k_src, k_dst = k_src[keep], k_dst[keep]
    # symmetric
    k_src, k_dst = (np.concatenate([k_src, k_dst]),
                    np.concatenate([k_dst, k_src]))

    b_src = rng.integers(0, P, 12 * P)
    b_dst = P + zipf_targets(12 * P, I)

    r_src = rng.integers(0, P, 3 * P)
    r_dst = P + zipf_targets(3 * P, I)

    l_src = rng.integers(0, P, 2 * P)
    l_dst = P + I + zipf_targets(2 * P, n_posts)

    src = np.concatenate([k_src, b_src, r_src, l_src])
    dst = np.concatenate([k_dst, b_dst, r_dst, l_dst])
    elab = np.concatenate([
        np.full(len(k_src), E_KNOWS, np.int32),
        np.full(len(b_src), E_BUY, np.int32),
        np.full(len(r_src), E_REVIEW, np.int32),
        np.full(len(l_src), E_LIKES, np.int32),
    ])
    date = rng.integers(0, 365, len(src)).astype(np.int32)
    rating = rng.integers(1, 6, len(src)).astype(np.int32)

    vlab = np.concatenate([
        np.full(P, V_PERSON, np.int32),
        np.full(I, V_ITEM, np.int32),
        np.full(n_posts, V_POST, np.int32),
    ])
    vprops = {
        "id": np.arange(n, dtype=np.int64),
        "credits": rng.integers(0, 1000, n).astype(np.int32),
        "price": np.where(vlab == V_ITEM,
                          rng.integers(1, 500, n), 0).astype(np.int32),
        "region": rng.integers(0, 8, n).astype(np.int32),
        "is_fraud_seed": (rng.random(n) < 0.01).astype(np.int32),
    }
    return CSRStore(n, src, dst, vertex_props=vprops,
                    edge_props={"date": date, "rating": rating},
                    vertex_labels=vlab, edge_labels=elab)
