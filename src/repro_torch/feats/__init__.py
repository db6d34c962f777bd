"""``repro_torch.feats``: tiered node-feature storage (see ``store.py``), as
``repro.feats``.

Every layer builds a store through ``make_feature_store``; consumers
duck-type against ``FeatureStore`` (``gather`` / ``host_rows`` /
``full_table`` / ``device_bytes``), and ``gather_input`` is the one rule
for a batch's input features.
"""
import numpy as np
import torch

from repro_torch.feats.store import (CachedFeatureStore,      # noqa: F401
                                     DeviceFeatureStore, FeatureStore,
                                     HostFeatureStore, make_feature_store,
                                     ready, split_budget)

__all__ = [
    "FeatureStore", "DeviceFeatureStore", "HostFeatureStore",
    "CachedFeatureStore", "make_feature_store", "split_budget",
    "is_feature_store", "gather_input", "ready",
]


def is_feature_store(obj) -> bool:
    """Duck-typed store check (anything exposing the gather protocol)."""
    return hasattr(obj, "gather") and hasattr(obj, "host_rows")


def gather_input(feats_or_store, mb, read_only: bool = False):
    """A batch's input features, ready on the current stream: the
    loader-attached ``mb.feats`` win (the prefetch already paid for them),
    else a store gathers the block's input rows, else the raw table is
    indexed on its device.

    ``read_only=True`` (evaluation, tuning, profiling) leaves a store's
    state and counters alone: its rows are read on the host through
    ``host_rows`` and copied to the store's device."""
    pre = getattr(mb, "feats", None)
    if pre is not None:
        return ready(pre)
    if is_feature_store(feats_or_store):
        if read_only:
            ids = getattr(mb, "host_input_ids", None)
            rows = feats_or_store.host_rows(
                mb.input_ids if ids is None else ids)
            return {"feature": torch.from_numpy(
                np.ascontiguousarray(rows)).to(feats_or_store.device)}
        return ready(feats_or_store.gather(mb.input_ids, step=mb.step))
    table = torch.as_tensor(feats_or_store)
    return {"feature": table[mb.input_ids.to(table.device).long()]}
