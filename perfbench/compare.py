"""The comparison that decides ``correct``: the embeddings the timed path
returned against the plain reference's, row by row."""

from __future__ import annotations

import numpy as np


def row_gaps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's cosine distance (1 - cos), in float64; infinite where a
    row is not finite."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    return np.where(np.isfinite(cos), 1.0 - cos, np.inf)


def numbers(got: np.ndarray, ref: np.ndarray) -> dict[str, float]:
    """Over the compared rows: ``cos_gap_max`` and ``cos_gap_mean``, the
    largest and the mean cosine distance (1 - cos) between a served
    embedding and the reference's, the measure retrieval ranks by; and
    ``emb_err_max`` / ``emb_err_mean``, the L2 distance of the unit
    vectors (sqrt(2 cos_gap)). A row that is not finite counts as
    infinitely far."""
    gap = row_gaps(got, ref)
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.linalg.norm(got - ref, axis=-1)
    err = np.where(np.isfinite(err), err, np.inf)
    return {"cos_gap_max": float(gap.max()),
            "cos_gap_mean": float(gap.mean()),
            "emb_err_max": float(err.max()),
            "emb_err_mean": float(err.mean())}


def judge(values: dict[str, float], limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number the cell's limits file
    compares; a value passes when it is at most its limit."""
    return {name: {"value": values[name], "limit": limit}
            for name, limit in limits["compare"].items()}


def passed(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
