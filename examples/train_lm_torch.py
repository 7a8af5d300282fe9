"""End-to-end training example on the PyTorch port: train a (reduced) LM
for a few hundred steps with checkpointing, the watchdog and prefetching,
through ``repro_torch.launch.train``.  Any of the ten architectures works
via --arch.  It trains on the card; pass ``--device cpu`` to train on the
CPU.

    PYTHONPATH=src python examples/train_lm_torch.py --arch rwkv6-3b \\
        --steps 200 --device cpu
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "qwen3-8b"]
    if "--steps" not in argv:
        argv += ["--steps", "200"]
    train.main(["--smoke", "--checkpoint-every", "50", "--global-batch",
                "16", "--seq-len", "64", *argv])


if __name__ == "__main__":
    main()
