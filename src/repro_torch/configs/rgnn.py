"""The paper's own model configs (RGCN / RGAT / HGT on the Table-3
datasets), beside the LM architecture registry: the port's copy of
``repro.configs.rgnn``, with the same names and fields. ``program()``
builds the layer through ``repro_torch.models`` and ``graph()`` the
synthetic Table-3 graph through ``repro_torch.core.graph``."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.graph import HeteroGraph, table3_graph
from repro_torch.models import hgt_program, rgat_program, rgcn_program


@dataclasses.dataclass(frozen=True)
class RGNNConfig:
    name: str
    model: str              # rgcn | rgat | hgt
    dataset: str            # Table-3 dataset name
    in_dim: int = 64        # the paper's evaluation setting (§4.1)
    out_dim: int = 64
    scale: float = 1.0      # dataset scale factor (1.0 = published stats)

    def program(self):
        fn: Callable = {"rgcn": rgcn_program, "rgat": rgat_program,
                        "hgt": hgt_program}[self.model]
        return fn(self.in_dim, self.out_dim)

    def graph(self, seed: int = 0) -> HeteroGraph:
        return table3_graph(self.dataset, scale=self.scale, seed=seed)


RGNN_CONFIGS = {
    f"{m}-{ds}": RGNNConfig(name=f"{m}-{ds}", model=m, dataset=ds)
    for m in ("rgcn", "rgat", "hgt")
    for ds in ("aifb", "am", "bgs", "biokg", "fb15k", "mag", "mutag",
               "wikikg2")
}


def get_rgnn_config(name: str) -> RGNNConfig:
    return RGNN_CONFIGS[name]
