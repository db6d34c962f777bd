"""Batched LM serving on the PyTorch/CUDA port with a reduced
architecture: prefill + greedy decode into a preallocated KV cache, K10
(``csrc/flash_attention.cu``) on the card (the workflow of
``examples/serve_lm.py``; wraps ``repro_torch.launch.serve``).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch jamba-v0.1-52b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args, rest = ap.parse_known_args(argv)
    tokens = serve_main(["--arch", args.arch, "--reduced", "--batch", "4",
                         "--prompt-len", "32", "--gen", "16", "--device",
                         args.device, *rest])
    print(f"generated tokens {tuple(tokens.shape)}")
    return tokens


if __name__ == "__main__":
    main()
