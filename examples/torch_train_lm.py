"""LM-framework example on the PyTorch/CUDA port: train a reduced model a
few hundred steps with checkpointing and fault-tolerant supervision
(float32 master weights, the config's compute dtype), on the card.

    PYTHONPATH=src python examples/torch_train_lm.py [--arch xlstm-125m] \
        [--device cpu]

``--device cpu`` trains on the CPU instead.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="llama3.2-1b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

print(f"training a reduced {args.arch} on {args.device}")
with tempfile.TemporaryDirectory() as ckpt_dir:
    train_main([
        "--arch", args.arch, "--tiny", "--layers", "4",
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
        "--device", args.device,
    ])
