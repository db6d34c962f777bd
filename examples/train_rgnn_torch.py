"""End-to-end RGNN training on the PyTorch/CUDA port: a 2-layer RGAT node
classifier trained full-graph on a synthetic heterograph with AdamW, a
cosine learning rate and checkpointing (the workflow of
``examples/train_rgnn.py``, through ``hector_torch`` and
``repro_torch.train.FullGraphTrainer``: each step is the captured
executor's forward, cross-entropy, backward and AdamW update).

    PYTHONPATH=src python examples/train_rgnn_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_rgnn_torch.py --device cpu
"""
import argparse
import tempfile

import numpy as np
import torch

import hector_torch
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import FullGraphTrainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=16000)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    graph = synthetic_heterograph(args.nodes, args.edges, num_ntypes=4,
                                  num_etypes=16, seed=0,
                                  target_compaction=0.5)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(graph.num_nodes, args.dim)),
                        dtype=torch.float32, device=dev)
    labels = np.asarray(rng.integers(0, args.classes, graph.num_nodes))

    engine = hector_torch.compile("rgat", graph, layers=2, dim=args.dim,
                                  hidden=args.dim, classes=args.classes,
                                  device=dev)
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 20, args.steps),
                weight_decay=0.01)
    trainer = FullGraphTrainer(engine, x, labels,
                               np.arange(graph.num_nodes), opt=opt)
    state = trainer.init_state(engine.init(1))
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="train_rgnn_torch-")
    ckpt = Checkpointer(ckpt_dir)

    losses = []
    for i in range(0, args.steps, 50):
        state, chunk = trainer.train(state, steps=min(50, args.steps - i))
        losses.extend(chunk)
        ckpt.save(i + len(chunk), state)
        print(f"step {len(losses):4d}  loss {losses[-1]:.4f}")
    ckpt.wait()
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(acc proxy: {np.exp(-losses[-1]):.2%} vs chance "
          f"{1/args.classes:.2%}); checkpoints in {ckpt_dir}")
    assert losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    main()
