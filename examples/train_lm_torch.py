"""LM pre-training on the PyTorch/CUDA port with the fault-tolerance
drill: trains a reduced config of any assigned architecture with async
checkpoints, simulates a host failure mid-run and recovers (the workflow
of ``examples/train_lm.py``; wraps ``repro_torch.launch.train``).

    PYTHONPATH=src python examples/train_lm_torch.py --arch moonshot-v1-16b-a3b
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 6
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args, rest = ap.parse_known_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_torch-")
    losses = train_main(["--arch", args.arch, "--reduced",
                         "--steps", str(args.steps), "--batch", "8",
                         "--seq", "64", "--ckpt-dir", ckpt_dir,
                         "--ckpt-every", str(max(1, args.steps // 3)),
                         "--simulate-failure", str(args.steps // 2),
                         "--device", args.device, *rest])
    print(f"{len(losses)} steps (the drill's repeats included): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoints in {ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
