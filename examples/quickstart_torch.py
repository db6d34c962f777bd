"""Quickstart on the PyTorch/CUDA port: author an RGNN in the
Python-embedded DSL, compile it with ``hector_torch.compile()``, inspect
the generated plans, and run every execution mode (the workflow of
``examples/quickstart.py``, through ``hector_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

import hector_torch
from repro_torch.core.graph import synthetic_heterograph


# the model is a plain function over edge/node proxies; tracing it emits
# the inter-operator IR, validated with source-located diagnostics at
# trace time
@hector_torch.model
def rgat(g, e, n, in_dim, out_dim, slope=0.01):
    W = g.weight("W_rel", (in_dim, out_dim), indexed_by="etype")
    w_s = g.weight("w_att_src", (out_dim,), indexed_by="etype")
    w_t = g.weight("w_att_dst", (out_dim,), indexed_by="etype")
    e["hs"] = e.src["feature"] @ W
    e["atts"] = hector_torch.dot(e["hs"], w_s)
    e["attt"] = hector_torch.dot(e.dst["feature"] @ W, w_t)
    e["att_raw"] = hector_torch.leaky_relu(e["atts"] + e["attt"], slope)
    e["att"] = hector_torch.edge_softmax(e["att_raw"])
    n["h_out"] = hector_torch.aggregate(e["hs"], scale=e["att"])
    return n["h_out"]


@hector_torch.model
def broken(g, e, n, in_dim, out_dim):
    W = g.weight("W", (in_dim, out_dim), indexed_by="etype")
    e["hs"] = e.src["feature"] @ W
    n["h_out"] = hector_torch.aggregate(e["hs"], scale=e["att"])  # no 'att'
    return n["h_out"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--edges", type=int, default=8000)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # a small heterogeneous graph: 5 node types, 12 relation types
    graph = synthetic_heterograph(num_nodes=args.nodes, num_edges=args.edges,
                                  num_ntypes=5, num_etypes=12, seed=0)
    print(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges, "
          f"entity compaction ratio {graph.entity_compaction_ratio:.2f}")
    print("\ntraced program:")
    print(rgat(64, 64).describe())

    # one call: trace -> reorder/compact -> lower -> executors + sampler
    compiled = hector_torch.compile(rgat, graph, layers=2, dim=64, hidden=64,
                                    classes=16, sample=5, device=dev)
    print("\ngenerated plans:")
    print(compiled.describe())

    params = compiled.init(0)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(graph.num_nodes, 64)), dtype=torch.float32, device=dev)

    # full-graph forward
    logits = compiled.apply(params, x)
    print(f"\nfull-graph logits: {tuple(logits.shape)} "
          f"finite={bool(torch.isfinite(logits).all())}")
    assert bool(torch.isfinite(logits).all())

    # sampled mini-batch forward + one train step over the same stack
    labels = np.random.default_rng(1).integers(0, 16, graph.num_nodes)
    loader = compiled.make_loader(
        lambda step: np.arange(32, dtype=np.int32), num_batches=args.batches,
        depth=1)
    state = compiled.init_state(params)
    losses = []
    try:
        for mb in loader:
            batch_logits = compiled.apply_blocks(params, mb, x)
            state, metrics = compiled.train_step(
                state, mb, mb.seq.slice_labels(labels), x)
            losses.append(float(metrics["loss"]))
            print(f"batch {mb.step}: sampled logits "
                  f"{tuple(batch_logits.shape)}, train loss {losses[-1]:.4f}")
    finally:
        loader.close()
    assert len(losses) == args.batches and all(np.isfinite(losses))

    # malformed models are rejected at trace time with the offending line
    try:
        broken(64, 64)
    except hector_torch.ProgramValidationError as err:
        print(f"\nvalidation catches authoring bugs:\n  {err}")
    else:
        raise AssertionError("the broken model was not rejected")
    return losses


if __name__ == "__main__":
    main()
