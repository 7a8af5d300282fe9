"""Serving example on the PyTorch port: batched request scheduling with
prefill + decode against a KV cache (a reduced config), through
``repro_torch.launch.serve``.  It serves on the card; pass ``--device cpu``
to serve on the CPU with the plain versions.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-2b \\
        --device cpu
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "gemma2-2b"]
    serve.main(["--smoke", "--requests", "8", "--slots", "4",
                "--max-new", "8", *argv])


if __name__ == "__main__":
    main()
