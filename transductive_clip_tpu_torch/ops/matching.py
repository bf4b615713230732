"""Cluster -> class matching for the zero-shot clustering accuracy path
(counterpart of transductive_clip_tpu/ops/matching.py; reference:
src/utils.py:380-417).

* ``hungarian_matching`` — optimal one-to-one assignment of the clusters
  present in the predictions to classes, maximising total prototype
  probability, per task on a rectangular cost [n_present <= n_query, K].
  The LAP solver is ``native.lap_solve``: the C++ shortest-augmenting-path
  solver (``native/lapjv.cpp``), with scipy's as the fallback, as in the JAX
  package.
* ``basic_matching`` — per-cluster argmax-probability matching.

These run on the host once per task batch, outside the EM loops.
"""

from __future__ import annotations

import numpy as np

from ..native import lap_solve
from .common import EPS


def cluster_prototypes(u_or_preds_one_hot, query, eps: float = EPS):
    """Mean query feature of each predicted cluster (numpy, [N, K, d]).

    preds_one_hot: [N, n, K]; query: [N, n, d].
    Empty clusters get all-zero prototypes (reference: em_dirichlet.py:61-70).
    """
    one_hot = np.asarray(u_or_preds_one_hot, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    counts = one_hot.sum(axis=1)                        # [N, K]
    protos = np.einsum("tnk,tnd->tkd", one_hot, query)
    protos /= np.maximum(counts, eps)[..., None]
    protos *= (counts > eps)[..., None]
    return protos


def _present_clusters(preds_t):
    """Distinct clusters of one task in order of first appearance (the
    reference's row order)."""
    clusters, first_idx = np.unique(preds_t, return_index=True)
    return clusters[np.argsort(first_idx)]


def hungarian_matching(preds, probs):
    """Optimal cluster->class matching per task.

    preds: [N, n] int cluster ids; probs: [N, K, C] prototype class
    probabilities. Returns new_preds [N, n] with clusters renamed to their
    matched classes.
    """
    preds = np.asarray(preds)
    probs = np.asarray(probs)
    new_preds = np.zeros_like(preds)
    for t in range(preds.shape[0]):
        clusters = _present_clusters(preds[t])
        _, matched_cols = lap_solve(-probs[t, clusters, :])
        lut = np.zeros(probs.shape[1], dtype=preds.dtype)
        lut[clusters] = matched_cols
        new_preds[t] = lut[preds[t]]
    return new_preds


def basic_matching(preds, probs):
    """Per-cluster argmax-probability matching (reference: utils.py:408-417)."""
    preds = np.asarray(preds)
    probs = np.asarray(probs)
    matched = probs.argmax(axis=-1)                     # [N, K]
    return np.take_along_axis(matched, preds, axis=1)


# ---- compressed-row variants ------------------------------------------------
# The prototype path (methods/base.py:_proto_rows_device) returns class
# probabilities only for the top-R clusters by population, R = min(K,
# n_query): preds holds at most n_query distinct clusters, each with count
# >= 1, so the top-R rows always contain all of them — exact.


def hungarian_matching_rows(preds, row_idx, row_probs, n_class):
    """``hungarian_matching`` over compressed prototype rows.

    preds: [N, n]; row_idx: [N, R] cluster ids of the rows; row_probs:
    [N, R, C] their class probabilities.
    """
    preds = np.asarray(preds)
    row_idx = np.asarray(row_idx)
    row_probs = np.asarray(row_probs)
    new_preds = np.zeros_like(preds)
    for t in range(preds.shape[0]):
        clusters = _present_clusters(preds[t])
        pos = np.full(n_class, -1, np.int64)
        pos[row_idx[t]] = np.arange(row_idx.shape[1])
        _, matched_cols = lap_solve(-row_probs[t, pos[clusters], :])
        lut = np.zeros(n_class, dtype=preds.dtype)
        lut[clusters] = matched_cols
        new_preds[t] = lut[preds[t]]
    return new_preds


def scatter_matching_rows(preds, row_idx, matched_cols, n_class):
    """Rename clusters to classes given per-row matched columns:
    lut[row_idx] = matched_cols; preds -> lut[preds]."""
    preds = np.asarray(preds)
    row_idx = np.asarray(row_idx)
    lut = np.zeros((preds.shape[0], n_class), preds.dtype)
    np.put_along_axis(lut, row_idx, np.asarray(matched_cols, preds.dtype), axis=1)
    return np.take_along_axis(lut, preds, axis=1)
